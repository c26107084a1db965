"""No module of JAX or of the JAX package is loaded by the benchmark, and the
reference loads nothing of the program.  Each check imports in a fresh
process, so that what this test process has loaded does not count."""

import ast
import json
import subprocess
import sys

import pytest

from portbench import spec

REPO = spec.ROOT.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "operator_forge"}


def loaded(code: str) -> set:
    """Top-level names of the modules loaded after running ``code``."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport json, sys\nprint(json.dumps(sorted(sys.modules)))"],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
    return {name.split(".")[0] for name in json.loads(out.stdout.strip().splitlines()[-1])}


def test_the_benchmark_and_every_reader_load_no_jax():
    code = ("import portbench.run, portbench.calibrate, portbench.trace, portbench.check\n"
            "import portbench.reference.demo_block\n"
            "from portbench import spec\n"
            "for m in spec.benchmark()['end_to_end'] + spec.benchmark()['per_layer']:\n"
            "    spec.metric_reader(m['name'])\n"
            "import operator_forge_torch.demo, operator_forge_torch.jit, operator_forge_torch.entry\n")
    names = loaded(code)
    assert "operator_forge_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = loaded("import portbench.reference.demo_block")
    assert not names & (FORBIDDEN | {"operator_forge_torch"})


@pytest.mark.parametrize("path", sorted((spec.ROOT / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_source_imports_only_torch_and_the_standard_library(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops = {(node.module or "").split(".")[0]} if node.level == 0 else {"."}
        else:
            continue
        assert tops <= {"torch", "math", "__future__"}, (path.name, tops)


def test_a_run_refuses_where_a_jax_module_is_loaded(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert run.forbidden_modules() == ["jaxlib.fake"]
    # whole top-level names: the port's own name begins with the JAX package's
    monkeypatch.delitem(sys.modules, "jaxlib.fake")
    assert "operator_forge_torch" not in {n.split(".")[0] for n in run.forbidden_modules()}


def test_the_command_exits_non_zero_without_a_card_or_without_the_program(tmp_path):
    import shutil

    shutil.copytree(spec.ROOT, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    cell = spec.benchmark()["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", cell, "--seed", "5000000000",
                          "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert not out.stdout.strip()
