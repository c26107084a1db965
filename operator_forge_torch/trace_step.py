"""Where the time of the port's train step and forward goes on the card.

    python -m operator_forge_torch.trace_step

Runs ``train_entry()``'s SGD step and ``entry()``'s forward on the card,
then the wide step (one SGD step at ``DemoConfig(vocab=32000,
seq_len=2048, batch=2)``, whose logits take 262 MB in bf16), each call on
the same parameters and tokens and ending in ``torch.cuda.synchronize()``.
For each path it first times ``CALLS`` calls (``WIDE_CALLS`` for the wide
step) on the host's clock without the profiler, then times as many again
under ``torch.profiler``, and prints one JSON line: the host's median time
per call in each of the two runs, the device's busy time per call in the
profiled run (the union of the intervals of the CUDA kernels the profiler
recorded), the device's idle share of that same run's host median, the
peak device memory allocated during one call, and the kernels ranked by
device time per call.  It prints the card's name
and power limit first.  It fails where there is no card, and where the
profiler records no device time.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch
from torch.autograd import DeviceType

from . import demo
from .entry import entry, train_entry

CALLS = 20
WIDE_CALLS = 5
WIDE = dict(vocab=32000, seq_len=2048, batch=2)
TOP = 40


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
    for _ in range(3):  # warm: the kernels' builds, cuBLAS, the allocator
        call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
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
    return {
        "calls": calls,
        "host_median_ms": host_ms,
        "profiled_host_median_ms": profiled_ms,
        "device_busy_ms_per_call": busy_ms,
        "device_idle_share": 1.0 - busy_ms / profiled_ms,
        "kernel_launches_per_call": len(kernels) / calls,
        "peak_allocated_bytes": peak,
        "top_kernels": [
            {"name": name[:96], "ms_per_call": us / 1e3 / calls, "launches_per_call": n / calls}
            for name, (us, n) in ranked[:TOP]
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
    print(json.dumps({"train_step": profile(lambda: step(params, tokens))}))
    print(json.dumps({"forward": profile(lambda: forward(params, fwd_tokens))}))
    config = demo.DemoConfig(**WIDE)
    wide = demo.init_params(config, torch.Generator().manual_seed(0), "cuda")
    wide_tokens = torch.randint(0, config.vocab, (config.batch, config.seq_len + 1),
                                generator=torch.Generator().manual_seed(1)).cuda()
    print(json.dumps({"wide_step": profile(lambda: demo.train_step(wide, wide_tokens, config),
                                           WIDE_CALLS)}))


if __name__ == "__main__":
    main()
