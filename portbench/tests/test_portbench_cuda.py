"""On the card: a cell runs end to end and is correct, its traced run reads
every per-layer metric of the cell, and the fp8 control at the cell's own
size is not correct.  Each test decides inside itself whether a card is
there, and skips where none is.

    python -m pytest --noconftest -p no:cacheprovider portbench/tests/test_portbench_cuda.py -q
"""

import time

import pytest
import torch

from portbench import check, run, spec

pytestmark = pytest.mark.cuda
CELL = "gpt2-medium.train.s128"


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_a_cell_runs_correct_and_its_trace_reads_every_per_layer_metric():
    card()
    cell = spec.find_cell(CELL)
    plain = run.run(cell, 6_000_000_001, 2.0, False, "cuda", time.perf_counter())["result"]
    assert plain["correct"] is True, plain["checks"]
    assert {m["name"] for m in cell.end_to_end} == set(plain["metrics"])
    traced = run.run(cell, 6_000_000_002, 4.0, True, "cuda", time.perf_counter())["result"]
    assert traced["correct"] is True, traced["checks"]
    assert {m["name"] for m in cell.per_layer} == set(traced["metrics"])
    assert 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
    units = {m["name"]: m["unit"] for m in cell.per_layer}
    for name, metric in traced["metrics"].items():
        assert metric["value"] > 0, name
        if units[name] == "%":
            assert metric["value"] <= 100, name
    assert traced["breakdown"]["device_ops"] and len(traced["breakdown"]["device_ops"]) <= 10


def test_the_fp8_control_at_the_cells_size_is_not_correct():
    device = card()
    cell = spec.find_cell(CELL)
    seed = 6_000_000_003
    entry, pool, _ = run.start(cell, seed, device)
    entry.free()
    del entry
    torch.cuda.empty_cache()
    control = run.reference_outputs(cell, seed, pool, device, precision="fp8")
    numbers = run.compare(cell, seed, pool, device, [control])[0]
    assert not check.judge(numbers, cell.limits)[0], numbers
