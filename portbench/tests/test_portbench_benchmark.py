"""``BENCHMARK.json`` within its contract, and every file it names found."""

import json
import re

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert not any(word.startswith("/") or ".." in word for word in BENCH["command"])


def test_a_full_check_of_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_lines_within_the_allowed_characters(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics_move_an_end_to_end_metric_reported_in_their_cells():
    by_name = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = by_name[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    found = spec.find_cell(cell)
    names = [m["name"] for m in found.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert found.per_layer
    assert found.chips == 1


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_config_traffic_limits_and_metric_readers(cell):
    found = spec.find_cell(cell)
    assert found.traffic["entry"] in ("train", "forward")
    assert found.config["reduced"] == []
    assert found.config["head_dim"] * found.config["n_heads"] == found.config["d_model"]
    assert found.limits["numbers"] and all(n["limit"] > 0 for n in found.limits["numbers"].values())
    for metric in found.end_to_end + found.per_layer:
        assert callable(spec.metric_reader(metric["name"]))


def test_config_files_are_their_own_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/configs/")
        assert spec.load_json(spec.ROOT.parent / c["file"])["source"] == c["source"]
        assert c["reduced"] == []


def test_kernel_classes_hold_the_main_path_kernels():
    classes = {kc.name: kc for kc in spec.kernel_classes()}
    assert {"attention", "mlp", "library", "rmsnorm", "cross_entropy"} <= set(classes)
    for kernel, kind, call in [
        ("void (anonymous namespace)::mlp_kernel<(anonymous namespace)::Tile<128, 128, 2, 4>, true>(x)",
         "mlp", "matmul_gelu_bwd"),
        ("void (anonymous namespace)::mlp_kernel<(anonymous namespace)::Tile<128, 128, 2, 4>, false>(x)",
         "mlp", "matmul_gelu"),
        ("void (anonymous namespace)::causal_attention_kernel<128>(x)", "attention", "causal_attention"),
        ("void (anonymous namespace)::attention_stream_dkv_kernel<64, 128, 1>(x)", "attention", None),
        ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_cublas", "library", None),
        ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT", "library", None),
        ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float> >(int)",
         "glue", None),
        ("Memcpy DtoD (Device -> Device)", "glue", None),
    ]:
        assert spec.classify(kernel, list(classes.values())) == (kind, call)
