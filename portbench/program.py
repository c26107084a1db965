"""What the program records of itself, as the per-layer readers under
``metrics/`` take it: ``operator_forge_torch.telemetry.snapshot()``.

A program without that module (a tree before it) records nothing, and
every reader here then returns None, as it does for a run of another entry
or a run with no trace.  The device marks are read only from replays made
while a profiler session was open, which in a run is the traced stretch:
their means are over its calls.
"""

from __future__ import annotations

from . import readers


def snapshot():
    """The program's counters and device totals, or None where it keeps
    none."""
    try:
        from operator_forge_torch import telemetry
    except ImportError:
        return None
    return telemetry.snapshot()


def device_ms(run, kind: str, name: str):
    """The mean device time of the mark ``name`` over the replays read, in
    ms."""
    if readers.entry(run) != kind or run.trace is None:
        return None
    snap = snapshot()
    total = snap and snap["device"].get(name)
    if not total or not total["reads"]:
        return None
    return 1e3 * total["seconds"] / total["reads"]


def capture_s(run):
    """The host seconds of the capture's warm-up calls and of the capture
    itself, which first waits for the warm-ups' device work."""
    if run.trace is None:
        return None
    snap = snapshot()
    counters = snap["counters"] if snap else {}
    if "jit.warmup_s" not in counters or "jit.capture_s" not in counters:
        return None
    return counters["jit.warmup_s"] + counters["jit.capture_s"]
