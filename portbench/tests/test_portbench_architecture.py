"""Architectures are found by file: a configuration names one
(``"architecture"``, ``demo_block`` where absent), and the harness loads
``models/<name>.py`` and ``reference/<name>.py`` under the cell's root.

- The demo block's weights and check numbers at ``tiny.TINY`` are pinned to
  the bits the harness gave before the block moved into its own files.
- A throwaway architecture written only as new files under a temporary
  root runs through ``run.run`` and is correct, and ``mfu`` counts its
  operations; an unknown one fails at once, naming both files.
- A tree with a cut configuration of that architecture, and one with a cell
  on four chips among four, keep every rule of ``rules.py``; a tree that
  breaks one of them fails that rule.
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
from portbench.tests import rules, tiny

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
    return cfg["vocab_size"]


def make_params(cfg, seed, device):
    v, d = cfg["vocab_size"], cfg["hidden_size"]
    return {name: torch.randn(shape, generator=inputs.generator(seed, name, device), device=device)
            .mul_(cfg["init_std"]) for name, shape in (("embed", (v, d)), ("unembed", (d, v)))}


def leaves(params):
    return [params["embed"], params["unembed"]]


def change_norms(params, cfg, seed, device):
    start = make_params(cfg, seed, device)
    return [float(torch.linalg.vector_norm(p - p0)) for p, p0 in zip(leaves(params), leaves(start))]


def model_flops(cfg, batch, seq, entry):
    return {"train": 6.0, "forward": 2.0}[entry] * cfg["hidden_size"] * cfg["vocab_size"] * batch * seq


def parameters(cfg):
    return 2 * cfg["vocab_size"] * cfg["hidden_size"]
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

# a cut configuration: the published vocabulary of 4096 cut to 512, as a
# slice of it, and none of the demo block's keys
BIGRAM = {"architecture": "bigram", "source": "a throwaway architecture of the harness's tests",
          "published": {"vocab_size": 4096, "hidden_size": 64}, "vocab_size": 512, "hidden_size": 64,
          "reduced": ["vocab_size"], "learning_rate": 0.5, "init_std": 0.02}


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
    """The tiny tree with the throwaway architecture, a cut configuration
    of it and a train and a forward cell, all new files and entries."""
    root, bench = tiny.tree(tmp_path)
    (root / "models" / "bigram.py").write_text(BIGRAM_MODEL)
    (root / "reference" / "bigram.py").write_text(BIGRAM_REFERENCE)
    tiny.write(root / "configs" / "bigram.json", BIGRAM)
    bench["configs"].append({"name": "bigram", "source": BIGRAM["source"], "file": "portbench/configs/bigram.json",
                             "reduced": ["vocab_size"], "why": "another architecture, cut"})
    for kind in ("train", "forward"):
        cell = f"bigram.{kind}"
        bench["workloads"].append({"name": cell, "config": "bigram", "traffic": f"{kind}.tiny", "chips": 1,
                                   "why": f"the cut configuration's {kind}"})
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


def four_chip_tree(tmp_path):
    """The bigram tree cut to its four cells of the tiny and the bigram
    configurations, with ``bigram.train`` on four chips."""
    root, bench = bigram_tree(tmp_path)
    kept = ("tiny.train", "tiny.forward", "bigram.train", "bigram.forward")
    bench["workloads"] = [{**w, "chips": 4 if w["name"] == "bigram.train" else 1}
                          for w in bench["workloads"] if w["name"] in kept]
    bench["configs"] = [c for c in bench["configs"] if c["name"] in ("tiny", "bigram")]
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = [w for w in metric["workloads"] if w in kept]
    return root, bench


@pytest.mark.parametrize("tree", [bigram_tree, four_chip_tree])
def test_a_cut_configuration_of_another_architecture_keeps_every_rule(tmp_path, tree):
    root, bench = tree(tmp_path)
    cfg = spec.find_cell("bigram.train", bench, root).config
    assert cfg["reduced"] and not {"head_dim", "n_heads", "d_model"} & set(cfg)
    rules.check(bench, root)


def _rewrite(root, bench, **changes):
    """The bigram configuration's file with ``changes``, and its entry's
    ``reduced`` the file's."""
    cfg = {**BIGRAM, **changes}
    tiny.write(root / "configs" / "bigram.json", cfg)
    next(c for c in bench["configs"] if c["name"] == "bigram")["reduced"] = cfg["reduced"]


def _reduced_differs(root, bench):
    next(c for c in bench["configs"] if c["name"] == "bigram")["reduced"] = []


def _second_four_chip_cell(root, bench):
    next(w for w in bench["workloads"] if w["name"] == "bigram.forward")["chips"] = 4


def _a_why_on_a_metric(root, bench):
    bench["per_layer"][0]["why"] = "a key that no metric has"


def _a_configuration_no_cell_uses(root, bench):
    bench["workloads"] = [w for w in bench["workloads"] if w["config"] != "bigram"]
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = [w for w in metric["workloads"] if not w.startswith("bigram.")]


def _reduced(bench, root):
    rules.config_lists_each_cut_in_reduced(bench, root, "bigram")


# each way of breaking a tree: (the tree, the break, the rule it breaks,
# held on what it broke, and what that rule says)
BROKEN = {
    "reduced_differs_from_the_file": (
        bigram_tree, _reduced_differs, _reduced,
        r"reduced in BENCHMARK.json \[\] is not the file's \['vocab_size'\]"),
    "reduced_names_no_published_key": (
        bigram_tree, lambda root, bench: _rewrite(root, bench, reduced=["vocab"], vocab=512),
        _reduced, "'vocab' in reduced is no key of the published block"),
    "a_listed_key_keeps_its_published_value": (
        bigram_tree, lambda root, bench: _rewrite(root, bench, vocab_size=4096),
        _reduced, "'vocab_size' is in reduced but the file keeps its published value 4096"),
    "a_cut_left_out_of_reduced": (
        bigram_tree, lambda root, bench: _rewrite(root, bench, reduced=[]),
        _reduced, "'vocab_size' is 512 against the published 4096 and not in reduced"),
    "a_width_in_reduced": (
        bigram_tree, lambda root, bench: _rewrite(root, bench, reduced=["vocab_size", "hidden_size"],
                                                  hidden_size=32),
        _reduced, "'hidden_size' is a width"),
    "an_architecture_with_no_files": (
        bigram_tree, lambda root, bench: _rewrite(root, bench, architecture="trigram"),
        lambda bench, root: rules.cell_runs_the_architecture_its_file_names(bench, root, "bigram.train"),
        "architecture 'trigram' names no file"),
    "a_second_cell_on_four_chips_among_four": (
        four_chip_tree, _second_four_chip_cell, rules.at_most_a_quarter_of_the_cells_take_four_chips,
        r"2 cells on 4 chips among 4, at most 1"),
    "an_entry_with_a_key_of_its_own": (
        bigram_tree, _a_why_on_a_metric,
        lambda bench, root: rules.entry_within_the_allowed_keys_and_characters(bench, root, bench["per_layer"][0]),
        "keys .*'why'.*, not those of per_layer"),
    "a_configuration_no_cell_uses": (
        bigram_tree, _a_configuration_no_cell_uses, rules.config_files_are_their_own_and_under_paths,
        "configuration bigram is used by no cell"),
}


@pytest.mark.parametrize("name", list(BROKEN))
def test_a_tree_that_breaks_a_rule_fails_that_rule(tmp_path, name):
    tree, breaks, rule, says = BROKEN[name]
    root, bench = tree(tmp_path)
    breaks(root, bench)
    for holds in (rule, rules.check):
        with pytest.raises(AssertionError, match=says):
            holds(bench, root)


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
    bench = spec.benchmark()
    for work in bench["workloads"]:
        rules.cell_runs_the_architecture_its_file_names(bench, spec.ROOT, work["name"])
        cell = spec.find_cell(work["name"])
        if cell.config_name in rules.UNCUT:
            assert "architecture" not in cell.config and cell.architecture == "demo_block"
