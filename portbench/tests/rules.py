"""The rules that ``BENCHMARK.json`` and the files it names are held to,
whatever architecture a configuration names.

Each rule is a function of ``(bench, root)``: ``bench`` the benchmark's
dict, ``root`` the benchmark's folder (``spec.ROOT``, or a throwaway copy);
a rule of one cell, entry or configuration also takes its name.  A rule
raises ``AssertionError`` naming what broke.  ``test_portbench_benchmark.py``
holds the real benchmark to them case by case; ``check`` holds a whole
tree to every one of them, as the tests of throwaway trees do."""

from __future__ import annotations

import json
import re
from pathlib import Path

from portbench import run, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
# the keys of each entry; a metric may add "workloads"
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
# keys that hold a width, which a configuration never cuts: hidden,
# intermediate, latent, state and projection sizes, head sizes, expansion
# factors and the experts per token
WIDTH = re.compile(r"_dim$|_rank$|hidden_size|intermediate|latent|state_size|proj|head_size|expan"
                   r"|experts_per_tok|^d_model$|^d_ff$|^n_embd$|^n_inner$")
# the demo block's configurations at their published widths: the tests also
# hold them by name to ``reduced == []``, no ``architecture`` key and one chip
UNCUT = ("pythia-1.4b", "gpt2-medium")


def _config_entry(bench: dict, name: str) -> dict:
    return next(c for c in bench["configs"] if c["name"] == name)


def _config_file(bench: dict, root: Path, name: str) -> dict:
    return spec.load_json(root.parent / _config_entry(bench, name)["file"])


def _cells(bench: dict) -> list:
    return [w["name"] for w in bench["workloads"]]


# -- the whole benchmark ---------------------------------------------------


def top_level_keys_and_size(bench: dict, root: Path) -> None:
    assert set(bench) == TOP_KEYS, sorted(set(bench) ^ TOP_KEYS)
    assert len(json.dumps(bench)) <= 64 * 1024
    assert bench["paths"] == ["portbench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word, word


def full_check_of_24_cells_fits_its_time(bench: dict, root: Path) -> None:
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def names_are_unique(bench: dict, root: Path) -> None:
    for group in (bench["configs"], bench["workloads"], bench["end_to_end"] + bench["per_layer"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names)), names
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs)), pairs


def end_to_end_bounds_and_sources(bench: dict, root: Path) -> None:
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace"), m["name"]
        assert 0.01 <= m["bound"] <= 0.25, m["name"]


def per_layer_metrics_move_a_metric_of_their_cells(bench: dict, root: Path) -> None:
    cells = _cells(bench)
    by_name = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        moved = by_name[m["moves"]]
        for cell in m.get("workloads", moved.get("workloads", cells)):
            assert cell in cells, f"{m['name']}: no cell {cell}"
            assert cell in moved.get("workloads", cells), f"{m['name']}: {cell} does not report {m['moves']}"


def config_files_are_their_own_and_under_paths(bench: dict, root: Path) -> None:
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files)), files
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/configs/"), c["file"]
        assert spec.load_json(root.parent / c["file"])["source"] == c["source"], c["name"]
        assert c["name"] in used, f"configuration {c['name']} is used by no cell"


def at_most_a_quarter_of_the_cells_take_four_chips(bench: dict, root: Path) -> None:
    cells = bench["workloads"]
    for w in cells:
        assert w["chips"] in (1, 4), f"{w['name']}: {w['chips']} chips"
    four = [w["name"] for w in cells if w["chips"] == 4]
    allowed = max(1, len(cells) // 4)
    assert len(four) <= allowed, f"{len(four)} cells on 4 chips among {len(cells)}, at most {allowed}: {four}"


# -- one entry, cell or configuration ---------------------------------------


def entry_within_the_allowed_keys_and_characters(bench: dict, root: Path, entry: dict) -> None:
    """An entry of ``configs``, ``workloads``, ``end_to_end`` or
    ``per_layer``: just its group's keys, and names, units and lines
    within the allowed characters."""
    group = next(g for g in ENTRY_KEYS if entry in bench[g])
    extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
    assert ENTRY_KEYS[group] <= set(entry) <= ENTRY_KEYS[group] | extra, \
        f"{entry['name']}: keys {sorted(entry)}, not those of {group}"
    assert NAME.match(entry["name"]), entry["name"]
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key]), entry[key]
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key], key
    if "unit" in entry:
        assert UNIT.match(entry["unit"]), entry["unit"]
        assert entry["better"] in ("lower", "higher")
    if "reduced" in entry:
        assert len(entry["reduced"]) <= 16 and all(NAME.match(key) for key in entry["reduced"])


def cell_reports_setup_another_end_to_end_and_a_per_layer_metric(bench: dict, root: Path, cell: str) -> None:
    found = spec.find_cell(cell, bench, root)
    names = [m["name"] for m in found.end_to_end]
    assert "setup_s" in names and len(names) >= 2, names
    assert found.per_layer
    assert found.chips in (1, 4)


def cell_finds_its_traffic_limits_readers_and_shapes(bench: dict, root: Path, cell: str) -> None:
    """The cell's traffic, limits and metric readers are found, and its
    architecture builds its program on the CPU and counts it."""
    found = spec.find_cell(cell, bench, root)
    cfg, traffic, model = found.config, found.traffic, found.model
    entry = traffic["entry"]
    assert entry in run.ENTRIES and entry in model.SOURCES, entry
    assert found.limits["numbers"] and all(n["limit"] > 0 for n in found.limits["numbers"].values())
    for metric in found.end_to_end + found.per_layer:
        assert callable(spec.metric_reader(metric["name"], root)), metric["name"]
    if found.architecture == spec.DEFAULT_ARCHITECTURE:
        assert cfg["head_dim"] * cfg["n_heads"] == cfg["d_model"]
    assert callable(model.program(cfg, traffic, entry))
    for count in (model.vocab(cfg), model.parameters(cfg)):
        assert isinstance(count, int) and count > 0, count
    assert model.model_flops(cfg, traffic["batch"], traffic["seq"], entry) > 0


def cell_runs_the_architecture_its_file_names(bench: dict, root: Path, cell: str) -> None:
    work = next(w for w in bench["workloads"] if w["name"] == cell)
    arch = _config_file(bench, root, work["config"]).get("architecture", spec.DEFAULT_ARCHITECTURE)
    files = [root / "models" / f"{arch}.py", root / "reference" / f"{arch}.py"]
    missing = [str(path) for path in files if not path.is_file()]
    assert not missing, f"{cell}: architecture {arch!r} names no file {missing}"
    assert spec.find_cell(cell, bench, root).architecture == arch


def config_lists_each_cut_in_reduced(bench: dict, root: Path, config: str) -> None:
    """``reduced`` is the file's, and each item is a key of the file's
    ``published`` block (or a dotted path into one) that the file holds at
    its top level with another value; no width is cut, and no published key
    held at the top level differs without being listed."""
    listed = _config_entry(bench, config)["reduced"]
    cfg = _config_file(bench, root, config)
    assert listed == cfg["reduced"], \
        f"{config}: reduced in BENCHMARK.json {listed} is not the file's {cfg['reduced']}"
    published = cfg.get("published", {})
    cut = set()
    for item in listed:
        keys = [k for k in published if item == k or item.startswith(k + ".")]
        assert keys, f"{config}: {item!r} in reduced is no key of the published block"
        cut.update(keys)
        assert not WIDTH.search(item), f"{config}: {item!r} is a width, which is never cut"
    for key in cut:
        assert key in cfg and cfg[key] != published[key], \
            f"{config}: {key!r} is in reduced but the file keeps its published value {published[key]!r}"
    for key in set(published) & set(cfg) - cut:
        assert cfg[key] == published[key], \
            f"{config}: {key!r} is {cfg[key]!r} against the published {published[key]!r} and not in reduced"


BENCH_RULES = (top_level_keys_and_size, full_check_of_24_cells_fits_its_time, names_are_unique,
               end_to_end_bounds_and_sources, per_layer_metrics_move_a_metric_of_their_cells,
               config_files_are_their_own_and_under_paths, at_most_a_quarter_of_the_cells_take_four_chips)
ENTRY_RULES = (entry_within_the_allowed_keys_and_characters,)
CELL_RULES = (cell_reports_setup_another_end_to_end_and_a_per_layer_metric,
              cell_finds_its_traffic_limits_readers_and_shapes, cell_runs_the_architecture_its_file_names)
CONFIG_RULES = (config_lists_each_cut_in_reduced,)


def check(bench: dict, root: Path) -> None:
    """Every rule over the whole tree: each entry, cell and configuration.
    Raises one ``AssertionError`` that names every rule broken or that
    raised."""
    failed = []

    def hold(rule, *of):
        try:
            rule(bench, root, *of)
        except Exception as e:  # a rule that cannot find its parts is broken too
            named = [o["name"] if isinstance(o, dict) else o for o in of]
            failed.append(f"{rule.__name__}{named or ''}: {type(e).__name__}: {e}")

    for rule in BENCH_RULES:
        hold(rule)
    for rule in ENTRY_RULES:
        for group in ENTRY_KEYS:
            for entry in bench[group]:
                hold(rule, entry)
    for rule in CELL_RULES:
        for cell in _cells(bench):
            hold(rule, cell)
    for rule in CONFIG_RULES:
        for c in bench["configs"]:
            hold(rule, c["name"])
    assert not failed, "\n".join(failed)
