"""Architectures are found by file: a configuration names one
(``"architecture"``, ``demo_block`` where absent), and the harness loads
``models/<name>.py`` and ``reference/<name>.py`` under the cell's root.

- The demo block's weights and check numbers at ``tiny.TINY`` are pinned to
  the bits the harness gave before the block moved into its own files.
- A throwaway architecture written only as new files under a temporary
  root runs through ``run.run`` and is correct, and ``mfu`` counts its
  operations; an unknown one fails at once, naming both files.
- Every kernel of the port's sources that an architecture names lands in a
  kernel class (``kernels/*.json``), not silently in ``glue``.
"""

import hashlib
import re
import time
from types import SimpleNamespace

import pytest
import torch
from operator_forge_torch.kernels import build

from portbench import counts, run, spec
from portbench.tests import tiny

SEED = 2**31 + 9
CPU = torch.device("cpu")
# the parent's bits, on one CPU thread
PARAMS_SHA256 = "059f25dba81c5a87c70250160bdf9c18b09266b218694942fd6c624d614f4a4a"
NUMBERS = {
    "tiny.train": {"loss_gap": 2.86102294921875e-06, "grad_gap": 0.0007136314916971703,
                   "change_gap": 0.0008399681804775473},
    "tiny.forward": {"logit_max_gap": 0.03085309539020372, "logit_rms_gap": 0.005741363210200372,
                     "calls_checked": 2},
}

BIGRAM_MODEL = '''"""A throwaway architecture: logits = embed[tokens] @ unembed, in f32,
trained by plain SGD."""

import torch

from portbench import inputs

SOURCES = {"train": (), "forward": ()}
CALLS = {}


def program(cfg, traffic, entry):
    lr = cfg["learning_rate"]

    def forward(params, tokens):
        return params["embed"][tokens] @ params["unembed"]

    def train_step(params, tokens):
        live = {k: p.detach().requires_grad_() for k, p in params.items()}
        logits = forward(live, tokens[:, :-1])
        loss = torch.nn.functional.cross_entropy(logits.flatten(0, 1), tokens[:, 1:].flatten())
        grads = torch.autograd.grad(loss, list(live.values()))
        return {k: p.detach() - lr * g for (k, p), g in zip(live.items(), grads)}, loss.detach()

    return {"train": train_step, "forward": forward}[entry]


def vocab(cfg):
    return cfg["vocab"]


def make_params(cfg, seed, device):
    v, d = cfg["vocab"], cfg["d_model"]
    return {name: torch.randn(shape, generator=inputs.generator(seed, name, device), device=device)
            .mul_(cfg["init_std"]) for name, shape in (("embed", (v, d)), ("unembed", (d, v)))}


def leaves(params):
    return [params["embed"], params["unembed"]]


def change_norms(params, cfg, seed, device):
    start = make_params(cfg, seed, device)
    return [float(torch.linalg.vector_norm(p - p0)) for p, p0 in zip(leaves(params), leaves(start))]


def model_flops(cfg, batch, seq, entry):
    return {"train": 6.0, "forward": 2.0}[entry] * cfg["d_model"] * cfg["vocab"] * batch * seq


def parameters(cfg):
    return 2 * cfg["vocab"] * cfg["d_model"]
'''

BIGRAM_REFERENCE = '''"""The throwaway architecture from its equation, in float32."""

import torch


def logits(params, tokens, mm):
    return mm(params["embed"][tokens], params["unembed"])


def sgd_steps(params, batches, cfg, mm):
    lr = cfg["learning_rate"]
    live = [params["embed"], params["unembed"]]
    start = [p.clone() for p in live]
    losses, first = [], None
    for step, batch in enumerate(batches):
        for p in live:
            p.requires_grad_(True)
        logp = torch.log_softmax(logits(params, batch[:, :-1], mm), dim=-1)
        loss = -logp.gather(-1, batch[:, 1:, None]).mean()
        grads = torch.autograd.grad(loss, live)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for p in live:
                p.requires_grad_(False)
            new = [p - lr * g for p, g in zip(live, grads)]
            if step == 0:
                first = [float(torch.linalg.vector_norm(p - n)) / lr for p, n in zip(live, new)]
            for p, n in zip(live, new):
                p.copy_(n)
    change = [float(torch.linalg.vector_norm(p - p0)) for p, p0 in zip(live, start)]
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def forward_logits(params, tokens, cfg, mm):
    with torch.no_grad():
        return list(logits(params, tokens, mm))
'''

BIGRAM = {"architecture": "bigram", "vocab": 512, "d_model": 64, "learning_rate": 0.5, "init_std": 0.02}


@pytest.fixture
def one_thread():
    """One CPU thread, so that sums are taken in one order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_demo_blocks_weights_are_the_parents_bits():
    model, reference = spec.architecture("demo_block")
    digest = hashlib.sha256()
    for leaf in reference.leaves(model.make_params(tiny.config(), SEED, CPU)):
        digest.update(leaf.contiguous().numpy().tobytes())
    assert digest.hexdigest() == PARAMS_SHA256


@pytest.mark.parametrize("name", list(NUMBERS))
def test_the_demo_blocks_check_numbers_are_the_parents_bits(tmp_path, one_thread, name):
    root, bench = tiny.tree(tmp_path)
    cell = spec.find_cell(name, bench, root)
    assert cell.architecture == "demo_block"
    entry, pool, _ = run.start(cell, SEED, CPU)
    if cell.traffic["entry"] == "forward":
        for i in range(max(entry.checked) + 1):
            entry.call(i)
    assert run.compare(cell, SEED, pool, CPU, [entry.free()])[0] == NUMBERS[name]


def bigram_tree(tmp_path):
    """The tiny tree with the throwaway architecture, a configuration of it
    and a train and a forward cell, all new files and entries."""
    root, bench = tiny.tree(tmp_path)
    (root / "models" / "bigram.py").write_text(BIGRAM_MODEL)
    (root / "reference" / "bigram.py").write_text(BIGRAM_REFERENCE)
    tiny.write(root / "configs" / "bigram.json", BIGRAM)
    bench["configs"].append({"name": "bigram", "file": "portbench/configs/bigram.json"})
    for kind in ("train", "forward"):
        cell = f"bigram.{kind}"
        bench["workloads"].append({"name": cell, "config": "bigram", "traffic": f"{kind}.tiny", "chips": 1})
        (root / "limits" / f"{cell}.json").write_text((root / "limits" / f"tiny.{kind}.json").read_text())
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if f"tiny.{kind}" in metric.get("workloads", ()):
                metric["workloads"] = metric["workloads"] + [cell]
    return root, bench


@pytest.mark.parametrize("kind", ["train", "forward"])
def test_a_new_architecture_is_new_files_only_and_runs_correct(tmp_path, kind):
    root, bench = bigram_tree(tmp_path)
    cell = spec.find_cell(f"bigram.{kind}", bench, root)
    assert cell.architecture == "bigram" and cell.model.parameters(cell.config) == 2 * 512 * 64
    out = run.run(cell, 7_000_000_003, 0.3, False, "cpu", time.perf_counter())
    result = out["result"]
    assert result["correct"] is True, result["checks"]
    assert f"{kind}_tokens_per_s" in result["metrics"]
    # mfu counts the architecture's own operations
    record = run.Record(cell, trace=SimpleNamespace(calls=5, window_s=2.0))
    flops = {"train": 6, "forward": 2}[kind] * 64 * 512 * cell.traffic["batch"] * cell.traffic["seq"]
    assert spec.metric_reader(f"mfu.{kind}", root)(record) == pytest.approx(100.0 * flops * 5 / 2.0 / counts.PEAK_FLOPS)
    # no kernel class has calls of this architecture: no roofline
    record.trace = SimpleNamespace(calls=5, window_s=2.0, class_s={"attention": 1.0}, class_calls={})
    assert spec.metric_reader(f"attention_roofline.{kind}", root)(record) is None


def test_an_unknown_architecture_fails_naming_both_files(tmp_path):
    root, bench = tiny.tree(tmp_path)
    tiny.write(root / "configs" / "tiny.json", {**tiny.config(), "architecture": "no_such_block"})
    with pytest.raises(FileNotFoundError) as failed:
        spec.find_cell("tiny.train", bench, root)
    assert str(root / "models" / "no_such_block.py") in str(failed.value)
    assert str(root / "reference" / "no_such_block.py") in str(failed.value)


def global_functions(source: str) -> list:
    """The names of the ``__global__`` functions of a CUDA source."""
    source = re.sub(r"//[^\n]*|/\*.*?\*/", "", source, flags=re.S)
    names = []
    for found in re.finditer(r"\b__global__\b", source):
        rest = re.sub(r"^\s*void\s+", "", source[found.end():])
        if rest.startswith("__launch_bounds__"):
            depth, end = 0, 0
            for end, char in enumerate(rest):
                depth += {"(": 1, ")": -1}.get(char, 0)
                if char == ")" and depth == 0:
                    break
            rest = rest[end + 1:]
        names.append(re.match(r"\s*(\w+)", rest).group(1))
    return names


def test_global_functions_reads_names_past_nested_launch_bounds():
    source = ("// __global__ void not_this(int)\n"
              "template <int A>\n__global__ void __launch_bounds__(f(g(A), 2), 1)\nfirst_kernel(int a) {}\n"
              "__global__ void second_kernel<1>(int) {}\n")
    assert global_functions(source) == ["first_kernel", "second_kernel"]


def architectures() -> list:
    return sorted(p.stem for p in (spec.ROOT / "models").glob("*.py") if p.stem != "__init__")


@pytest.mark.parametrize("name", architectures())
def test_every_kernel_of_an_architectures_sources_lands_in_a_class(name):
    model, _ = spec.architecture(name)
    classes = spec.kernel_classes()
    sources = sorted({source for entry in model.SOURCES.values() for source in entry})
    assert sources
    for source in sources:
        kernels = global_functions((build.CSRC / f"{source}.cu").read_text())
        assert kernels, source
        for kernel in kernels:
            kind, _ = spec.classify(f"void (anonymous namespace)::{kernel}<0>(int)", classes)
            assert kind != "glue", f"{source}.cu: {kernel} is in no kernel class (portbench/kernels/*.json)"


def test_a_configuration_without_the_key_is_the_demo_block():
    for work in spec.benchmark()["workloads"]:
        cell = spec.find_cell(work["name"])
        assert "architecture" not in cell.config and cell.architecture == "demo_block"
