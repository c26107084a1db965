"""The port's registry of counters, spans and device marks
(``operator_forge_torch.telemetry``) on the CPU: tracing only while a
profiler session is open, the spans ``jit`` and the model open, the
counters, the bytes ``jit`` copies, and the lazy reading of device marks
(against stand-in events: a CPU run records none).  The card's half is in
``tests/test_torch_cuda.py``."""

import functools

import pytest
import torch

from operator_forge_torch import demo, telemetry
from operator_forge_torch.jit import _flatten, jit, nbytes

TINY = demo.DemoConfig(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, seq_len=8, batch=2)
ACTIVITIES = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def fresh():
    telemetry.reset()
    yield
    telemetry.reset()


def _inputs(config=TINY):
    params = demo.init_params(config, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, config.vocab, (config.batch, config.seq_len + 1),
                           generator=torch.Generator().manual_seed(1))
    return params, tokens


def _step():
    return jit(functools.partial(demo.train_step, config=TINY))


def _ranges(prof) -> dict:
    """Each span of the port in a profile: name -> [(start, end)]."""
    out: dict = {}
    for e in prof.events():
        if e.name.startswith(("jit.", "step.")):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


class FakeEvent:
    """A timing event that is complete or not, recorded at ``at`` ms."""

    def __init__(self, at: float = 0.0, done: bool = True):
        self.at, self.done = at, done

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, end: "FakeEvent") -> float:
        assert self.done and end.done, "read before it was complete"
        return end.at - self.at


def _refuse(*args, **kwargs):
    raise AssertionError("called with no profiler session open")


def test_without_a_profiler_no_range_is_opened_and_no_event_made(monkeypatch):
    """With no profiler session, a jitted train step and forward never open
    a profiler range (of either kind) and never make a CUDA event."""
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    params, tokens = _inputs()
    step = _step()
    for _ in range(2):
        params, loss = step(params, tokens)
    logits = jit(functools.partial(demo.forward, config=TINY))(params, tokens[:, :-1])
    assert bool(torch.isfinite(loss)) and logits.shape == (TINY.batch, TINY.seq_len, TINY.vocab)
    assert telemetry.value("jit.calls") == 3


def test_a_span_with_tracing_off_is_one_shared_null_context():
    assert not telemetry.tracing()
    assert telemetry.span("jit.call", 1) is telemetry.span("step.forward")
    assert telemetry.phase("step.update") is telemetry.span("jit.copy_in")
    with telemetry.span("jit.call") as inside:
        assert inside is None


def test_a_profiled_train_step_nests_its_phases_in_jit_call():
    """Inside a session the trace holds ``jit.call`` enclosing
    ``step.forward``, ``step.backward`` and ``step.update``, in that order
    and apart."""
    params, tokens = _inputs()
    step = _step()
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        assert telemetry.tracing()
        step(params, tokens)
    ranges = _ranges(prof)
    assert sorted(ranges) == ["jit.call", "step.backward", "step.forward", "step.update"]
    [(start, end)] = ranges["jit.call"]
    phases = [ranges[name][0] for name in ("step.forward", "step.backward", "step.update")]
    assert all(start <= a <= b <= end for a, b in phases)
    assert phases[0][1] <= phases[1][0] and phases[1][1] <= phases[2][0]
    assert not telemetry.tracing()


def test_a_profiled_forward_nests_its_phase_in_jit_call():
    params, tokens = _inputs()
    fwd = jit(functools.partial(demo.forward, config=TINY))
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        fwd(params, tokens[:, :-1])
    ranges = _ranges(prof)
    assert sorted(ranges) == ["jit.call", "step.forward"]
    [(start, end)], [(a, b)] = ranges["jit.call"], ranges["step.forward"]
    assert start <= a <= b <= end


def test_jit_call_carries_its_sequence_number():
    """``jit.call``'s input is the call's sequence number, the counter
    ``jit.calls`` after it, kept in a profile that records shapes:
    successive calls, of any jitted function, get successive numbers."""
    params, tokens = _inputs()
    step, fwd = _step(), jit(functools.partial(demo.forward, config=TINY))
    telemetry.count("jit.calls", 6)
    with torch.profiler.profile(activities=ACTIVITIES, record_shapes=True) as prof:
        step(params, tokens)
        fwd(params, tokens[:, :-1])
        step(params, tokens)
    calls = sorted((e.time_range.start, e.concrete_inputs) for e in prof.events() if e.name == "jit.call")
    assert [inputs for _, inputs in calls] == [[7], [8], [9]]
    assert telemetry.value("jit.calls") == 9


def test_spans_are_operator_ranges_not_user_annotations():
    """The spans have an operator's scope: a user annotation
    (``record_function``) would be drawn again on the device over the
    kernels inside it, where the benchmark counts device activities as
    kernels."""
    params, tokens = _inputs()
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        _step()(params, tokens)
    spans = [e for e in prof.events() if e.name.startswith(("jit.", "step."))]
    assert len(spans) == 4 and not any(e.is_user_annotation for e in spans)


def test_counters_count_read_and_reset():
    assert telemetry.value("jit.replays") == 0
    assert telemetry.count("jit.replays") == 1
    assert telemetry.count("jit.copy_bytes", 4096) == 4096
    assert telemetry.count("jit.warmup_s", 0.25) == 0.25
    assert telemetry.count("jit.copy_bytes", 4096) == 8192
    snap = telemetry.snapshot()
    assert snap == {"counters": {"jit.replays": 1, "jit.copy_bytes": 8192, "jit.warmup_s": 0.25},
                    "device": {}, "skipped": 0}
    telemetry.reset()
    assert telemetry.snapshot() == {"counters": {}, "device": {}, "skipped": 0}
    assert telemetry.value("jit.copy_bytes") == 0


def test_a_snapshot_is_a_copy():
    telemetry.count("jit.calls")
    telemetry.pending([("step.update", [(FakeEvent(1.0), FakeEvent(3.0))])])
    snap = telemetry.snapshot()
    snap["counters"]["jit.calls"] = 99
    snap["device"]["step.update"]["reads"] = 99
    assert telemetry.snapshot() == {"counters": {"jit.calls": 1},
                                    "device": {"step.update": {"seconds": 0.002, "reads": 1}},
                                    "skipped": 0}


def test_a_cpu_step_counts_its_calls_and_no_launch_replay_or_capture():
    """The kernel wrappers count only launches of their CUDA kernels, as
    the module globals they replace did: the plain versions a CPU step
    takes count nothing, and ``jit`` on the CPU neither captures nor
    replays."""
    params, tokens = _inputs()
    step = _step()
    for _ in range(3):
        params, _ = step(params, tokens)
    counters = telemetry.snapshot()["counters"]
    assert counters == {"jit.calls": 3}


def test_every_launch_counter_is_raised_by_one_wrapper():
    """Each counter ``chip_smoke.COUNTERS`` reads is raised in exactly one
    kernel module, once, under ``kernels.<name>``."""
    import pathlib

    import chip_smoke

    sources = [p.read_text() for p in
               pathlib.Path(telemetry.__file__).parent.joinpath("kernels").glob("*.py")]
    for name in chip_smoke.COUNTERS:
        call = f'telemetry.count("kernels.{name}")'
        assert sum(text.count(call) for text in sources) == 1, name


def test_copy_bytes_of_a_tree_of_mixed_dtypes():
    """``jit`` copies every leaf of the arguments in and every leaf of the
    outputs out: the bytes are each leaf's elements times its element
    size, whatever its dtype, shape or place in the tree."""
    tree = ({"w": torch.zeros(3, 5), "g": [torch.zeros(7, dtype=torch.bfloat16),
                                          torch.zeros((), dtype=torch.float64)]},
            (torch.zeros(2, 4, dtype=torch.int64), torch.zeros(0, 9), torch.zeros(6, dtype=torch.bool)))
    leaves: list = []
    _flatten(tree, leaves)
    assert nbytes(leaves) == 3 * 5 * 4 + 7 * 2 + 8 + 2 * 4 * 8 + 0 + 6
    params, tokens = _inputs()
    leaves = []
    _flatten(((params, tokens), {}), leaves)
    assert nbytes(leaves) == 4 * sum(p.numel() for p in demo.tree_leaves(params)) + 8 * tokens.numel()


def test_the_lazy_read_skips_an_incomplete_mark():
    """A mark whose events are not complete is counted as skipped and
    dropped, never waited for; complete ones are read."""
    telemetry.pending([
        ("step.forward", [(FakeEvent(0.0), FakeEvent(5.0))]),
        ("step.backward", [(FakeEvent(5.0), FakeEvent(15.0, done=False))]),
    ])
    snap = telemetry.snapshot()
    assert snap["device"] == {"step.forward": {"seconds": 0.005, "reads": 1}}
    assert snap["skipped"] == 1
    assert telemetry.snapshot() == snap   # nothing is left pending


def test_a_calls_pairs_sum_to_one_read():
    """``jit.copy``'s two pairs (copy in, copy out) are one read of their
    summed time; reads accumulate over replays."""
    for base in (0.0, 100.0):
        telemetry.pending([("jit.copy", [(FakeEvent(base), FakeEvent(base + 1.5)),
                                         (FakeEvent(base + 9.0), FakeEvent(base + 9.5))])])
        telemetry.settle()
    assert telemetry.snapshot()["device"] == {"jit.copy": {"seconds": pytest.approx(0.004), "reads": 2}}


def test_phases_record_device_marks_only_while_capturing(monkeypatch):
    """Outside a capture a phase makes no event; inside ``capturing`` each
    phase records a pair around its body, kept in order, and the capture's
    end (or its failure) stops the marking."""
    recorded = []

    class Recording(FakeEvent):
        def __init__(self, **kwargs):
            assert kwargs == {"enable_timing": True, "external": True}
            super().__init__()

        def record(self):
            recorded.append(self)

    monkeypatch.setattr(torch.cuda, "Event", Recording)
    with telemetry.phase("step.forward"):
        pass
    assert recorded == []
    with telemetry.capturing() as marks:
        for name in ("step.forward", "step.backward", "step.update"):
            with telemetry.phase(name):
                assert len(recorded) % 2 == 1   # the start is recorded before the body
    assert [name for name, _ in marks] == ["step.forward", "step.backward", "step.update"]
    assert [event for _, [(start, end)] in marks for event in (start, end)] == recorded
    with pytest.raises(RuntimeError):
        with telemetry.capturing():
            raise RuntimeError("capture failed")
    assert telemetry.REGISTRY.marks is None
    with telemetry.phase("step.update"):
        pass
    assert len(recorded) == 6
