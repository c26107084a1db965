"""Where a run finds its parts: ``BENCHMARK.json`` and, by the names in it,
each configuration, traffic mix, metric reader, kernel class and cell's
limits.  A later cell, metric or kernel class is a new file and a new entry,
never an edit here.  ``root`` is the benchmark's folder (``portbench/``);
paths in ``BENCHMARK.json`` are relative to the folder above it."""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path = ROOT


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root.parent / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json`` by default) with
    its configuration, traffic, limits and the metrics it reports."""
    bench = bench if bench is not None else benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       + ", ".join(w["name"] for w in bench["workloads"]))
    work = found[0]
    config = next(c for c in bench["configs"] if c["name"] == work["config"])
    return Cell(
        name=name,
        chips=int(work["chips"]),
        config_name=config["name"],
        config=load_json(root.parent / config["file"]),
        traffic_name=work["traffic"],
        traffic=load_json(root / "traffic" / f"{work['traffic']}.json"),
        limits=load_json(root / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        root=root,
    )


def metric_reader(name: str, root: Path = ROOT):
    """``read`` of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{re.sub(r'\W', '_', name)}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass(frozen=True)
class KernelClass:
    """Device kernels of one class: by their function's name (each mapped
    to the call it marks, or None), or by a pattern on the whole name."""

    name: str
    names: dict
    patterns: tuple
    backward_flag: str | None


def kernel_classes(root: Path = ROOT) -> list[KernelClass]:
    out = []
    for path in sorted((root / "kernels").glob("*.json")):
        data = load_json(path)
        out.append(KernelClass(path.stem, data.get("names", {}),
                               tuple(re.compile(p) for p in data.get("patterns", ())),
                               data.get("backward_flag")))
    return out


FUNCTION = re.compile(r"(\w+)[<(]")


def function_name(kernel: str) -> str:
    """``mlp_kernel`` for ``void (anonymous namespace)::mlp_kernel<...>(...)``."""
    found = FUNCTION.search(kernel.replace("(anonymous namespace)::", ""))
    return found.group(1) if found else kernel


def classify(kernel: str, classes: list[KernelClass]) -> tuple[str, str | None]:
    """``(class, call)`` of a device kernel's name: the class whose names
    hold its function's name, else the first whose pattern it matches, else
    ``glue``; ``call`` is the wrapper call it marks, or None."""
    func = function_name(kernel)
    for kc in classes:
        if func in kc.names:
            call = kc.names[func]
            if call and kc.backward_flag and kc.backward_flag in kernel:
                call += "_bwd"
            return kc.name, call
    for kc in classes:
        if any(p.search(kernel) for p in kc.patterns):
            return kc.name, None
    return "glue", None
