"""The readers of what the program records of itself (``program.py`` and
the metrics that read it) against stand-in snapshots of
``operator_forge_torch.telemetry``."""

import sys
from types import SimpleNamespace

import pytest

from portbench import program, spec

SNAPSHOT = {
    "counters": {"jit.calls": 40, "jit.replays": 39, "jit.captures": 1, "jit.warmup_s": 1.25,
                 "jit.capture_s": 0.5, "jit.copy_bytes": 10**9},
    "device": {"step.forward": {"seconds": 1.0, "reads": 8}, "step.backward": {"seconds": 2.4, "reads": 8},
               "step.update": {"seconds": 0.08, "reads": 8}, "jit.copy": {"seconds": 0.06, "reads": 8}},
    "skipped": 0,
}


def run_of(entry: str, traced: bool = True):
    return SimpleNamespace(cell=SimpleNamespace(traffic={"entry": entry}), trace=object() if traced else None)


@pytest.fixture
def snapshot(monkeypatch):
    """Make ``program.snapshot`` return the dict the test puts in ``box``."""
    box = {"snap": SNAPSHOT}
    monkeypatch.setattr(program, "snapshot", lambda: box["snap"])
    return box


@pytest.mark.parametrize("name, entry, want", [
    ("step_forward_ms.train", "train", 125.0),
    ("step_backward_ms.train", "train", 300.0),
    ("step_update_ms.train", "train", 10.0),
    ("jit_copy_ms.train", "train", 7.5),
    ("jit_copy_ms.forward", "forward", 7.5),
])
def test_device_metrics_are_means_over_the_replays_read(snapshot, name, entry, want):
    read = spec.metric_reader(name)
    assert read(run_of(entry)) == pytest.approx(want)
    other = "forward" if entry == "train" else "train"
    assert read(run_of(other)) is None
    assert read(run_of(entry, traced=False)) is None


def test_a_mark_never_read_gives_no_number(snapshot):
    snapshot["snap"] = {**SNAPSHOT, "device": {"step.forward": {"seconds": 0.0, "reads": 0}}}
    assert program.device_ms(run_of("train"), "train", "step.forward") is None
    assert program.device_ms(run_of("train"), "train", "step.update") is None


def test_capture_s_is_the_warm_up_and_the_capture(snapshot):
    read = spec.metric_reader("capture_s")
    assert read(run_of("train")) == pytest.approx(1.75)
    assert read(run_of("forward")) == pytest.approx(1.75)
    assert read(run_of("train", traced=False)) is None
    snapshot["snap"] = {**SNAPSHOT, "counters": {"jit.calls": 3}}
    assert read(run_of("train")) is None


def test_a_program_without_telemetry_gives_none_and_does_not_raise(snapshot):
    snapshot["snap"] = None
    for name in ("step_forward_ms.train", "jit_copy_ms.forward", "capture_s"):
        assert spec.metric_reader(name)(run_of("forward" if "forward" in name else "train")) is None


def test_snapshot_is_none_where_the_program_has_no_telemetry_module(monkeypatch):
    import operator_forge_torch

    monkeypatch.delattr(operator_forge_torch, "telemetry", raising=False)
    monkeypatch.setitem(sys.modules, "operator_forge_torch.telemetry", None)
    assert program.snapshot() is None


def test_snapshot_reads_the_programs_registry():
    from operator_forge_torch import telemetry

    telemetry.reset()
    telemetry.count("jit.warmup_s", 0.5)
    telemetry.count("jit.capture_s", 0.25)
    try:
        assert program.snapshot()["counters"] == {"jit.warmup_s": 0.5, "jit.capture_s": 0.25}
        assert program.capture_s(run_of("train")) == pytest.approx(0.75)
    finally:
        telemetry.reset()
