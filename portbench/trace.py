"""A traced stretch of the window: ``torch.profiler`` over whole calls, read
into device busy time, time and calls by kernel class, and the breakdown.

The profiler session opens ``GUARD_S`` before the stretch's first call and
closes ``GUARD_S`` after its last call has finished.  The profiler's clock
for the device can place a kernel's start before the host call that
launched it, so a session opened at the first call's issue could lose the
head of the stretch's first kernels; nothing is launched during either
guard and the last call ends synchronised, so every kernel recorded is the
stretch's.  The stretch's time is the host's, from the first call's issue
to the last call's end.  Busy time is the union of the intervals of the
device kernels recorded: time in which at least one kernel ran, kernels
that overlap counted once.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType

from . import spec

GUARD_S = 0.01
TOP = 10
NAME_CHARS = 96


def _merged(spans: list) -> list:
    """The union of (start, end) intervals as disjoint intervals, in order:
    the device's busy time is their total length."""
    out: list = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


@dataclass
class Reading:
    """What a traced stretch gives the per-layer readers."""

    calls: int
    window_s: float
    busy_s: float
    class_s: dict = field(default_factory=dict)       # device seconds by kernel class
    class_calls: dict = field(default_factory=dict)   # wrapper calls by name, counted by kernel
    device_ops: list = field(default_factory=list)    # [[kernel, seconds]], most first
    idle_gaps: list = field(default_factory=list)     # [[host activity, seconds]], most first
    glue_kernels: list = field(default_factory=list)  # [[kernel, seconds]] in no named class


class Stretch:
    """``with Stretch() as s: ... s.done(calls)`` around whole calls that
    end synchronised; then ``s.read(classes)``."""

    def __enter__(self):
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.__enter__()
        time.sleep(GUARD_S)
        self.started = time.perf_counter()
        return self

    def done(self, calls: int) -> None:
        self.window_s = time.perf_counter() - self.started
        self.calls = calls

    def __exit__(self, *exc):
        time.sleep(GUARD_S)
        return self.prof.__exit__(*exc)

    def read(self, classes: list) -> Reading:
        events = self.prof.events()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        if not kernels:
            raise RuntimeError("the profiler recorded no device time in the traced stretch")
        busy = _merged([(e.time_range.start, e.time_range.end) for e in kernels])
        reading = Reading(self.calls, self.window_s, sum(end - start for start, end in busy) / 1e6)
        by_kernel: dict = defaultdict(float)
        class_s: dict = defaultdict(float)
        class_calls: dict = defaultdict(int)
        glue: dict = defaultdict(float)
        for e in kernels:
            seconds = e.time_range.elapsed_us() / 1e6
            kind, call = spec.classify(e.name, classes)
            # a library's kernel by its whole name (CUTLASS's are all
            # ``Kernel2<...>``), the others by their function's
            name = e.name[:NAME_CHARS] if kind == "library" else spec.function_name(e.name)
            by_kernel[name] += seconds
            class_s[kind] += seconds
            if call:
                class_calls[call] += 1
            if kind == "glue":
                glue[name] += seconds
        reading.class_s = dict(class_s)
        reading.class_calls = dict(class_calls)
        reading.device_ops = _top(by_kernel)
        reading.glue_kernels = _top(glue)
        reading.idle_gaps = _idle_by_host(busy, [e for e in events if e.device_type == DeviceType.CPU])
        return reading


def _top(totals: dict) -> list:
    return [[name, seconds] for name, seconds in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def _idle_by_host(busy: list, host: list) -> list:
    """The device's idle gaps between its first and last kernel, each put
    to what the host was doing at the gap's middle (its innermost recorded
    operation, or ``python`` where none was open), summed by that name."""
    host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in host), key=lambda t: t[0])
    starts = [h[0] for h in host]
    totals: dict = defaultdict(float)
    for (_, end), (start, _) in zip(busy, busy[1:]):
        middle = (end + start) / 2
        i = bisect.bisect_right(starts, middle)
        # the innermost open operation: the latest-started one still open
        name = next((h[2] for h in reversed(host[max(0, i - 2000):i]) if h[1] >= middle), "python")
        totals[name] += (start - end) / 1e6
    return _top(totals)
