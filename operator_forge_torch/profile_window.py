"""How often ``torch.profiler`` keeps a one-kernel call's kernel on the card,
by the margin the call is given inside the profiler's window.

Run on a machine with a CUDA card, from the root of a checkout:

    python -m operator_forge_torch.profile_window [--sessions N]

For each margin (none, before the call, after it, both) it opens N
profiler sessions around one call of a function that launches one kernel
(the ring step's backward on a later block, whose blocks return at once,
and RMSNorm's backward) and counts the sessions whose trace holds no
kernel, as ``tests/test_torch_cuda.py::_cuda_kernels`` counts them, and
of those the ones that hold the launch call itself.  Then,
over sessions with no margin, it reads the exported trace: how far each
launch call starts after the window opens, and how far its kernel starts
after the launch call, both on the host's clock, to which the profiler
converts the card's.  Prints the card's name and power limit, then one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import tempfile
import time

import torch
from torch.autograd import DeviceType

from .kernels import ring_attention as ra
from .kernels import rmsnorm

# (before the call, after it), seconds; 0.01 is the card tests' margin
MARGINS_S = {"none": (0.0, 0.0), "before": (0.01, 0.0), "after": (0.0, 0.01),
             "both": (0.01, 0.01)}


def one_kernel_calls(device) -> dict:
    """Calls that each launch one kernel, on seeded inputs."""
    g = torch.Generator().manual_seed(0)
    b, h, s, d = 8, 4, 16, 32

    def normal(*shape):
        return torch.randn(shape, generator=g).to(device)

    q, k, v, dout = (normal(b, h, s, d) for _ in range(4))
    m, den, big_d = normal(b, h, s, 1), normal(b, h, s, 1).abs() + 1, normal(b, h, s, 1)
    acc = [normal(b, h, s, d) for _ in range(3)]
    x, dy, gain = normal(512, 128), normal(512, 128), normal(128)
    return {
        # query block 0 against key block 1: every key masked
        "ring_step_bwd_later": lambda: ra.ring_step_bwd(q, k, v, dout, m, den, big_d, 0, 1, *acc),
        "rmsnorm_bwd": lambda: rmsnorm.rmsnorm_bwd(x, gain, dy),
    }


def session(fn, before: float, after: float, trace: str | None = None) -> tuple[int, int]:
    """The device activities and the launch calls the profiler records in
    one call of ``fn`` made ``before`` seconds into its window, which stays
    open ``after`` seconds past the call's end."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        time.sleep(before)
        fn()
        torch.cuda.synchronize()
        time.sleep(after)
    if trace:
        prof.export_chrome_trace(trace)
    events = prof.events()
    return (sum(e.device_type == DeviceType.CUDA for e in events),
            sum("LaunchKernel" in e.name for e in events))


def offsets_us(trace: str) -> tuple[float, float] | None:
    """(launch call's start after the window opens, kernel's start after
    the launch call's), in microseconds, from an exported trace."""
    events = json.load(open(trace))["traceEvents"]
    opened = [e["ts"] for e in events if e.get("ph") == "i" and "Iteration Start" in e["name"]]
    launches = [e["ts"] for e in events if e.get("cat") == "cuda_runtime" and "Launch" in e["name"]]
    kernels = [e["ts"] for e in events if e.get("cat") == "kernel"]
    if not (opened and launches and kernels):
        return None
    return launches[0] - opened[0], kernels[0] - launches[0]


def quantiles(xs: list[float]) -> dict:
    xs = sorted(xs)
    return {"n": len(xs), **{f"p{q}": xs[min(len(xs) - 1, math.floor(q / 100 * len(xs)))]
                             for q in (0, 1, 50, 99, 100)}} if xs else {"n": 0}


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sessions", type=int, default=1000)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: profile_window measures the card's traces")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    calls = one_kernel_calls("cuda")
    for fn in calls.values():  # the build and the first launch, outside any trace
        fn()
    torch.cuda.synchronize()
    empty = {}
    for name, fn in calls.items():
        for margin, (before, after) in MARGINS_S.items():
            found = [session(fn, before, after) for _ in range(args.sessions)]
            # traces with no kernel, and of them those that hold the launch call
            empty[f"{name}, margin {margin}"] = {
                "empty": sum(n == 0 for n, _ in found),
                "launch_recorded": sum(n == 0 and launched > 0 for n, launched in found)}
    launch_after_open, kernel_after_launch = [], []
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        for _ in range(args.sessions):
            if session(calls["rmsnorm_bwd"], 0.0, 0.0, trace)[0] and (found := offsets_us(trace)):
                launch_after_open.append(found[0])
                kernel_after_launch.append(found[1])
    print(json.dumps({
        "sessions_each": args.sessions, "margins_s": MARGINS_S, "empty_traces": empty,
        "launch_after_window_opens_us": quantiles(launch_after_open),
        "kernel_after_launch_us": quantiles(kernel_after_launch),
    }))


if __name__ == "__main__":
    main()
