"""A throwaway benchmark tree for the CPU tests: a copy of ``portbench/``'s
data and readers under a temporary root, with a configuration of the
demo block at a size the CPU runs in seconds, a train and a forward traffic
mix, and ``BENCHMARK.json``'s entries for them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench import spec

# Pythia-like heads of 128 over 12 layers: the smallest size at which the
# fp8 control fails the full cells' limits on every seed tried
TINY = dict(vocab=4096, d_model=256, n_heads=2, head_dim=128, n_layers=12, d_ff=1024)
TRAIN = {"entry": "train", "batch": 4, "seq": 64,
         "zipf_exponent": 1.0, "pool": 8}
FORWARD = {"entry": "forward", "batch": 2, "seq": 64,
           "zipf_exponent": 1.0, "pool": 8, "checked_calls": 2, "checked_from_first": 4}
# the cells whose limits the tiny cells are held to
LIMITS_OF = {"tiny.train": "pythia-1.4b.train.s2048", "tiny.forward": "pythia-1.4b.forward.s2048"}


def config() -> dict:
    """The tiny configuration: Pythia's file at ``TINY``'s sizes."""
    return {**spec.load_json(spec.ROOT / "configs" / "pythia-1.4b.json"), **TINY}


def write(path: Path, data: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=1))


def tree(tmp: Path) -> tuple[Path, dict]:
    """``(root, bench)``: the benchmark's folder under ``tmp`` with the tiny
    cells added, and the benchmark dict that names them."""
    root = tmp / "portbench"
    shutil.copytree(spec.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    write(root / "configs" / "tiny.json", config())
    write(root / "traffic" / "train.tiny.json", TRAIN)
    write(root / "traffic" / "forward.tiny.json", FORWARD)
    for cell, real in LIMITS_OF.items():
        shutil.copy(spec.ROOT / "limits" / f"{real}.json", root / "limits" / f"{cell}.json")
    bench = spec.benchmark()
    bench = {**bench,
             "configs": bench["configs"] + [{"name": "tiny", "file": "portbench/configs/tiny.json"}],
             "workloads": bench["workloads"] + [
                 {"name": "tiny.train", "config": "tiny", "traffic": "train.tiny", "chips": 1},
                 {"name": "tiny.forward", "config": "tiny", "traffic": "forward.tiny", "chips": 1}]}
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            kind = "tiny.train" if any(".train." in w for w in metric["workloads"]) else "tiny.forward"
            metric["workloads"] = metric["workloads"] + [kind]
    return root, bench
