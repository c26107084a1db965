"""The comparison that decides ``correct`` fails what it should, at a size
the CPU holds, under the limits of the cells it stands for
(``tiny.LIMITS_OF``): the lower-precision control (the plain reference with
every product's operands in fp8, put in the program's place), and the
program's timed path broken underneath in each way a one-card cell can be:
a step that returns its state unchanged, half of each batch left out (the
mean over the rest), an answer altered where it is produced (a train step's
update of one leaf taken twice; a forward call's top logit at one position
sent to the bottom).  One card has no exchange between cards to leave out.
The sound run is correct under the same limits."""

import time

import pytest
import torch

from operator_forge_torch import demo
from portbench import calibrate, check, run, spec
from portbench.tests import tiny

SEEDS = [1, 2**31 + 11, 5_000_000_003]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    root, bench = tiny.tree(tmp_path_factory.mktemp("tiny"))
    return {name: spec.find_cell(name, bench, root) for name in ("tiny.train", "tiny.forward")}


def correct(cell, seed) -> bool:
    return run.run(cell, seed, 0.3, False, "cpu", time.perf_counter())["result"]["correct"]


@pytest.mark.parametrize("name", ["tiny.train", "tiny.forward"])
@pytest.mark.parametrize("seed", SEEDS)
def test_sound_runs_are_correct(cells, name, seed):
    assert correct(cells[name], seed)


@pytest.mark.parametrize("name", ["tiny.train", "tiny.forward"])
@pytest.mark.parametrize("seed", SEEDS)
def test_the_fp8_control_is_not_correct(cells, name, seed):
    cell = cells[name]
    cpu = torch.device("cpu")
    entry, pool, _ = run.start(cell, seed, cpu)
    if cell.traffic["entry"] == "forward":
        for i in range(max(entry.checked) + 1):
            entry.call(i)
    calls = sorted(entry.free())
    control = run.reference_outputs(cell, seed, pool, cpu, calls, precision="fp8")
    numbers = run.compare(cell, seed, pool, cpu, [control])[0]
    assert not check.judge(numbers, cell.limits)[0], numbers


def unchanged(step):
    def broken(params, tokens, config):
        _, loss = step(params, tokens, config)
        return params, loss
    return broken


def half_batch(step):
    def broken(params, tokens, config):
        return step(params, tokens[: tokens.shape[0] // 2], config)
    return broken


def update_twice(step):
    def broken(params, tokens, config):
        new, loss = step(params, tokens, config)
        layer, was = new["layers"][0], params["layers"][0]["wo"]
        layer["wo"] = was + 2 * (layer["wo"] - was)
        return new, loss
    return broken


def top_logit_to_bottom(forward):
    def broken(params, tokens, config):
        out = forward(params, tokens, config).clone()
        row = out[0, -1]
        row[row.argmax()] = row.min()
        return out
    return broken


@pytest.mark.parametrize("fault", [unchanged, half_batch, update_twice], ids=lambda f: f.__name__)
def test_a_broken_train_step_is_not_correct(cells, monkeypatch, fault):
    monkeypatch.setattr(demo, "train_step", fault(demo.train_step))
    assert not correct(cells["tiny.train"], SEEDS[1])


def test_an_altered_forward_answer_is_not_correct(cells, monkeypatch):
    monkeypatch.setattr(demo, "forward", top_logit_to_bottom(demo.forward))
    assert not correct(cells["tiny.forward"], SEEDS[1])


def test_calibrates_readings_fail_the_control_and_the_half_batch_fault(cells):
    cell = cells["tiny.train"]
    got = calibrate.readings(cell, SEEDS[0], torch.device("cpu"), control=True)
    assert check.judge(got["program"], cell.limits)[0], got
    for name in ("control_fp8", "fault_half_batch"):
        assert not check.judge(got[name], cell.limits)[0], (name, got[name])
