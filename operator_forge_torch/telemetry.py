"""The port's one registry of counters, spans and device marks, for the
whole process.

Tracing is on exactly while a ``torch.profiler`` session is open; there is
no other switch.  With it off a span is one check and a shared null
context, and counters count all the same (each an integer add).

- **Counters** (``count``): always on.  ``jit`` counts ``jit.calls``,
  ``jit.replays``, ``jit.captures``, ``jit.copy_bytes`` (bytes copied in
  and out, summed over calls) and the host seconds ``jit.warmup_s`` and
  ``jit.capture_s`` of each capture; each kernel wrapper counts its eager
  launches under ``kernels.<wrapper>`` (a call of two launches counts
  once).  A replay raises no wrapper's counter: no Python runs in it.
- **Spans** (``span``): ranges on the profiler's timeline, opened only
  while tracing is on, so that they share its clock with the device's
  kernels: ``jit.call`` (its input the call's sequence number) with ``jit.copy_in``, ``jit.replay``, ``jit.copy_out`` or
  ``jit.capture`` (and its ``jit.warmup``) inside it, and the phases
  ``step.forward``, ``step.backward`` and ``step.update`` (``phase``).
- **Device marks**: a replayed graph runs no Python, so no span sees its
  phases.  While ``jit`` captures a graph (``capturing``), each ``phase``
  also records a pair of timing events on the capture stream, which the
  graph keeps as event-record nodes and records again at every replay.
  ``jit`` hands a replay's marks to ``pending`` while tracing is on, with
  the events it records around its copies (``jit.copy``).  They are read
  lazily (``settle``: at ``jit``'s next replay, once its copy-in is
  launched, and at ``snapshot``), without a synchronize: a mark not yet
  complete is counted under ``skipped``, not waited for.  The device totals sum each
  name's seconds and the replays read.

``snapshot()`` returns the counters and the device totals; ``reset()``
clears them.  The registry is not locked: the port calls it from one
thread.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

_NULL = contextlib.nullcontext()


def tracing() -> bool:
    """Whether a ``torch.profiler`` session is open (about 0.2 us)."""
    return torch._C._autograd._profiler_enabled()


class Registry:
    """Counters, device totals and the marks waiting to be read."""

    def __init__(self):
        self.counters: dict = defaultdict(int)
        self.device: dict = defaultdict(lambda: [0.0, 0])   # name -> [seconds, reads]
        self.skipped = 0
        self.pending: list = []    # (name, [(start, end), ...]), one read each
        self.marks: list | None = None   # a capture's marks while it is captured


REGISTRY = Registry()


def count(name: str, n: float = 1) -> float:
    """Raise the counter ``name`` by ``n``; return its new value."""
    REGISTRY.counters[name] += n
    return REGISTRY.counters[name]


def value(name: str) -> float:
    """The counter ``name`` (0 where it never counted)."""
    return REGISTRY.counters.get(name, 0)


def span(name: str, arg: int | None = None):
    """A profiler range ``name`` while tracing is on (``arg`` its one input,
    which a profile that records shapes keeps), else a shared null context.

    The range has an operator's scope, as ``torch.compile``'s calls do
    (``_RecordFunctionFast``), not a user annotation's: the profiler draws a
    user annotation (``record_function``) a second time on the device, over
    the kernels launched inside it, and a reader of the device's activities
    would count that copy as a kernel of its whole length."""
    if not tracing():
        return _NULL
    if arg is None:
        return torch._C._profiler._RecordFunctionFast(name)
    return torch._C._profiler._RecordFunctionFast(name, [arg])


def phase(name: str):
    """``span(name)``, and while ``jit`` captures a graph also a pair of
    device marks around it, kept for the capture (``capturing``)."""
    if REGISTRY.marks is None:
        return span(name)
    return _marked(name)


@contextlib.contextmanager
def _marked(name: str):
    start = torch.cuda.Event(enable_timing=True, external=True)
    end = torch.cuda.Event(enable_timing=True, external=True)
    start.record()
    with span(name):
        yield
    end.record()
    REGISTRY.marks.append((name, [(start, end)]))


@contextlib.contextmanager
def capturing():
    """Collect the marks of every ``phase`` inside; yields their list."""
    outer, REGISTRY.marks = REGISTRY.marks, []
    try:
        yield REGISTRY.marks
    finally:
        REGISTRY.marks = outer


def pending(marks: list) -> None:
    """Queue ``marks`` (``(name, [(start, end), ...])`` each) for reading."""
    REGISTRY.pending.extend(marks)


def settle() -> None:
    """Read every pending mark whose events are complete; count the rest as
    skipped.  Each entry's pairs sum to one read of its name."""
    if not REGISTRY.pending:
        return
    queued, REGISTRY.pending = REGISTRY.pending, []
    for name, pairs in queued:
        if all(start.query() and end.query() for start, end in pairs):
            total = REGISTRY.device[name]
            total[0] += sum(start.elapsed_time(end) for start, end in pairs) / 1e3
            total[1] += 1
        else:
            REGISTRY.skipped += 1


def snapshot() -> dict:
    """``{"counters": {name: value}, "device": {name: {"seconds", "reads"}},
    "skipped": n}``, the pending marks read first; a copy."""
    settle()
    return {
        "counters": dict(REGISTRY.counters),
        "device": {name: {"seconds": s, "reads": n} for name, (s, n) in REGISTRY.device.items()},
        "skipped": REGISTRY.skipped,
    }


def reset() -> None:
    """Clear the counters, the device totals and the pending marks."""
    REGISTRY.counters.clear()
    REGISTRY.device.clear()
    REGISTRY.pending.clear()
    REGISTRY.skipped = 0
