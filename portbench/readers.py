"""The arithmetic the metric readers under ``metrics/`` share.  Each reader
takes the run's ``Record`` and returns its number, or None where the run
holds nothing for it (a metric of another entry, or no trace).  What a
model's operations and a kernel class's calls cost, the cell's
architecture says (``run.cell.model``: ``model_flops`` and ``CALLS``)."""

from __future__ import annotations

import math

from . import counts


def entry(run) -> str:
    return run.cell.traffic["entry"]


def shapes(run) -> tuple[dict, int, int]:
    return run.cell.config, run.cell.traffic["batch"], run.cell.traffic["seq"]


def tokens_per_s(run, kind: str):
    if entry(run) != kind or run.trace is not None or not run.calls:
        return None
    return run.calls * run.tokens_per_call / run.window_s


def p95_ms(run, kind: str):
    """The nearest-rank 95th percentile of every call's latency."""
    if entry(run) != kind or run.trace is not None or not run.latencies_s:
        return None
    ordered = sorted(run.latencies_s)
    return 1e3 * ordered[math.ceil(0.95 * len(ordered)) - 1]


def mfu(run, kind: str):
    """The model's operations for the traced stretch's calls over the
    stretch's time on the host's clock (the first call's issue to the last
    call's end), as a share of the card's bf16 peak, in %: the cell's rate
    under the profiler times the operations a token."""
    if entry(run) != kind or run.trace is None:
        return None
    cfg, batch, seq = shapes(run)
    flops = run.cell.model.model_flops(cfg, batch, seq, kind) * run.trace.calls
    return 100.0 * flops / run.trace.window_s / counts.PEAK_FLOPS


def roofline(run, klass: str, kind: str):
    """The least time of the class's calls seen in the trace (each layer's
    call counted from the kernel that marks it, each call's operations and
    bytes from the architecture's ``CALLS``) over the class's device time,
    in %."""
    if entry(run) != kind or run.trace is None or not run.trace.class_s.get(klass):
        return None
    cfg, batch, seq = shapes(run)
    least = 0.0
    for call, cost in run.cell.model.CALLS.get(klass, {}).items():
        seen = run.trace.class_calls.get(call, 0)
        if seen:
            least += seen * counts.bound_s(*cost(cfg, batch, seq, kind, call))
    if not least:
        return None
    return 100.0 * least / run.trace.class_s[klass]


def glue_share(run, kind: str):
    """Device time in no named kernel class over the device's busy time, in %."""
    if entry(run) != kind or run.trace is None:
        return None
    return 100.0 * run.trace.class_s.get("glue", 0.0) / run.trace.busy_s


def idle_share(run, kind: str):
    """1 - busy time over the traced stretch's time, in %."""
    if entry(run) != kind or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
