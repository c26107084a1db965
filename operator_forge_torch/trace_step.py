"""Where the time of the port's steps goes on the card, eager and captured.

    python -m operator_forge_torch.trace_step

Runs ``train_entry()``'s SGD step and ``entry()``'s forward on the card,
then the wide step (one SGD step at ``DemoConfig(vocab=32000,
seq_len=2048, batch=2)``, whose logits take 262 MB in bf16), then
``sharded_train_step`` on the (1, 1) mesh of an NCCL group of one rank (a
``file://`` rendezvous in a temporary directory), each eagerly
(``name``), and then each captured once by ``jit.jit`` and replayed
(``name_captured``), each call on the same parameters and tokens and
ending in ``torch.cuda.synchronize()``.  For each it first times ``CALLS``
calls (``WIDE_CALLS`` for the wide step) on the host's clock without the
profiler, then times as many again under ``torch.profiler``, and prints
one JSON line: the host's median time per call in each of the two runs,
the device's busy time per call in the profiled run (the union of the
intervals of the CUDA kernels the profiler recorded), the device's idle
share of that same run's host median, the kernels a call (for a captured
call: the graph's kernels and the copies in and out), the peak device
memory allocated during one call (all the process holds then, and the
rise over what it held before the call), the peak reserved during one call after
the allocator's cache is released (a captured call's holds the graph's
private pool, every intermediate of the step, for good), the kernels
ranked by device time per call, and the host's operators ranked by their
own time per call in the profiled run, with the sum over all of them (the
rest of that run's host median is Python and waiting).  It prints the
card's name and power limit first.  It fails where there is no card, and
where the profiler records no device time.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist
from torch.autograd import DeviceType

from . import demo
from .entry import entry, train_entry
from .jit import jit

CALLS = 20
WIDE_CALLS = 5
WIDE = dict(vocab=32000, seq_len=2048, batch=2)
TOP = 40
TOP_HOST = 30


def _host_ms(call, calls: int) -> float:
    """Median host time of ``calls`` calls, each ending in a synchronize."""
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def _busy_us(spans: list) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def profile(call, calls: int = CALLS) -> dict:
    for _ in range(3):  # warm: the kernels' builds, cuBLAS, the allocator, a capture
        call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    peak_reserved = torch.cuda.max_memory_reserved()
    host_ms = _host_ms(call, calls)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        profiled_ms = _host_ms(call, calls)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    by_name: dict[str, list] = {}
    for e in kernels:
        total = by_name.setdefault(e.name, [0.0, 0])
        total[0] += e.time_range.elapsed_us()
        total[1] += 1
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3 / calls
    ranked = sorted(by_name.items(), key=lambda item: -item[1][0])
    host_ops = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)
    return {
        "calls": calls,
        "host_median_ms": host_ms,
        "profiled_host_median_ms": profiled_ms,
        "device_busy_ms_per_call": busy_ms,
        "device_idle_share": 1.0 - busy_ms / profiled_ms,
        "kernel_launches_per_call": len(kernels) / calls,
        "peak_allocated_bytes": peak,
        "call_peak_bytes": peak - before,
        "peak_reserved_bytes": peak_reserved,
        "host_ops_self_ms_per_call": sum(e.self_cpu_time_total for e in host_ops) / 1e3 / calls,
        "top_kernels": [
            {"name": name[:96], "ms_per_call": us / 1e3 / calls, "launches_per_call": n / calls}
            for name, (us, n) in ranked[:TOP]
        ],
        "top_host_ops": [
            {"name": e.key[:96], "self_ms_per_call": e.self_cpu_time_total / 1e3 / calls,
             "count_per_call": e.count / calls}
            for e in host_ops[:TOP_HOST]
        ],
    }


def main() -> None:
    step, (params, tokens) = train_entry()
    forward, (_, fwd_tokens) = entry()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    config = demo.DemoConfig(**WIDE)

    def wide_args() -> tuple:
        tokens = torch.randint(0, config.vocab, (config.batch, config.seq_len + 1),
                               generator=torch.Generator().manual_seed(1))
        return demo.init_params(config, torch.Generator().manual_seed(0), "cuda"), tokens.cuda()

    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "rendezvous"),
                                rank=0, world_size=1)
        try:
            mesh = demo.make_mesh(1)
            sharded = demo.sharded_train_step(mesh, demo.DemoConfig()).fn
            local = demo.shard_params(params, demo.DemoConfig(), mesh)
            # the wide step's parameters (34 MB) are made at its row, as
            # before the captured rows were added, so that the eager peaks
            # before it hold what they held
            paths = [
                ("train_step", step, lambda: (params, tokens), CALLS),
                ("forward", forward, lambda: (params, fwd_tokens), CALLS),
                ("wide_step", lambda p, t: demo.train_step(p, t, config), wide_args, WIDE_CALLS),
                ("sharded_step", sharded, lambda: (local, tokens), CALLS),
            ]
            # every eager path before any capture: a capture's stream keeps
            # cuBLAS's workspace of its own, which the peaks after it hold
            for i, (name, fn, make, calls) in enumerate(paths):
                args = make()
                paths[i] = (name, fn, args, calls)
                print(json.dumps({name: profile(lambda: fn(*args), calls)}), flush=True)
            for name, fn, args, calls in paths:
                jitted = jit(fn)
                print(json.dumps({f"{name}_captured": profile(lambda: jitted(*args), calls)}),
                      flush=True)
                del jitted
        finally:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
