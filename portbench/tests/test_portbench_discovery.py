"""A later cell, traffic mix and metric are files and entries only: the
harness finds throwaway ones under a temporary root and runs them."""

import json
import time

import torch

from portbench import run, spec
from portbench.tests import tiny

READER = '''"""A throwaway metric: calls in the window."""


def read(run):
    return float(run.calls) if run.trace is None else None
'''


def test_discovery_finds_new_config_traffic_metric_and_kernel_class(tmp_path):
    root, bench = tiny.tree(tmp_path)
    (root / "metrics" / "calls_seen.py").write_text(READER)
    (root / "kernels" / "thrown.json").write_text(json.dumps({"names": {"thrown_kernel": "thrown"}}))
    bench["end_to_end"].append({"name": "calls_seen", "unit": "calls", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["tiny.train"]})
    cell = spec.find_cell("tiny.train", bench, root)
    assert cell.config["d_model"] == tiny.TINY["d_model"] and cell.traffic == tiny.TRAIN
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "train_tokens_per_s", "calls_seen"]
    classes = spec.kernel_classes(root)
    assert spec.classify("void thrown_kernel<1>(int)", classes) == ("thrown", "thrown")
    out = run.run(cell, 7_000_000_001, 0.5, False, "cpu", time.perf_counter())
    metrics = out["result"]["metrics"]
    assert metrics["calls_seen"]["value"] == out["result"]["attempted"] > 0
    assert metrics["train_tokens_per_s"]["value"] > 0
    assert out["result"]["correct"] is True


def test_forward_cell_runs_on_the_cpu_and_keeps_drawn_calls(tmp_path):
    root, bench = tiny.tree(tmp_path)
    cell = spec.find_cell("tiny.forward", bench, root)
    out = run.run(cell, 2**33 + 5, 0.5, False, "cpu", time.perf_counter())
    result = out["result"]
    assert result["correct"] is True
    assert {"setup_s", "forward_tokens_per_s", "forward_ms_p95"} == set(result["metrics"])
    assert out["notes"]["numbers"]["calls_checked"] >= 2
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {"logit_max_gap", "logit_rms_gap"}


def test_same_seed_same_inputs_other_seed_other_inputs():
    from portbench import inputs

    cfg = tiny.config()
    cpu = torch.device("cpu")
    a, b = inputs.make_params(cfg, 2**31 + 9, cpu), inputs.make_params(cfg, 2**31 + 9, cpu)
    c = inputs.make_params(cfg, 2**31 + 10, cpu)
    assert torch.equal(a["layers"][1]["w2"], b["layers"][1]["w2"])
    assert not torch.equal(a["layers"][1]["w2"], c["layers"][1]["w2"])
    assert torch.equal(inputs.make_group(cfg, 2**31 + 9, "w2", cpu)[1], a["layers"][1]["w2"])
    pool = inputs.token_pool(cfg, tiny.TRAIN, 2**31 + 9, cpu)
    assert pool.shape == (8, 4, tiny.TRAIN["seq"] + 1) and torch.equal(pool, inputs.token_pool(cfg, tiny.TRAIN, 2**31 + 9, cpu))
    assert int(pool.min()) >= 0 and int(pool.max()) < cfg["vocab"]
    # Zipf: the most frequent id is far above the mean share
    counts = torch.bincount(pool.flatten(), minlength=cfg["vocab"])
    assert int(counts.max()) > 10 * pool.numel() / cfg["vocab"]
