"""``BENCHMARK.json`` within its contract, and every file it names found:
the rules of ``rules.py``, which hold for any architecture, case by case,
and the configurations at their published widths held to being uncut."""

import pytest

from portbench import spec
from portbench.tests import rules

BENCH = spec.benchmark()
ROOT = spec.ROOT
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_size():
    rules.top_level_keys_and_size(BENCH, ROOT)


def test_a_full_check_of_24_cells_fits_its_time():
    rules.full_check_of_24_cells_fits_its_time(BENCH, ROOT)


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_lines_within_the_allowed_characters(entry):
    rules.entry_within_the_allowed_keys_and_characters(BENCH, ROOT, entry)


def test_names_are_unique():
    rules.names_are_unique(BENCH, ROOT)


def test_end_to_end_bounds_and_sources():
    rules.end_to_end_bounds_and_sources(BENCH, ROOT)


def test_per_layer_metrics_move_an_end_to_end_metric_reported_in_their_cells():
    rules.per_layer_metrics_move_a_metric_of_their_cells(BENCH, ROOT)


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    rules.at_most_a_quarter_of_the_cells_take_four_chips(BENCH, ROOT)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    rules.cell_reports_setup_another_end_to_end_and_a_per_layer_metric(BENCH, ROOT, cell)
    found = spec.find_cell(cell)
    if found.config_name in rules.UNCUT:
        assert found.chips == 1


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_config_traffic_limits_and_metric_readers(cell):
    rules.cell_finds_its_traffic_limits_readers_and_shapes(BENCH, ROOT, cell)
    found = spec.find_cell(cell)
    if found.config_name in rules.UNCUT:
        assert found.config["reduced"] == []


def test_config_files_are_their_own_and_under_paths():
    rules.config_files_are_their_own_and_under_paths(BENCH, ROOT)
    for c in BENCH["configs"]:
        if c["name"] in rules.UNCUT:
            assert c["reduced"] == []


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_each_configuration_lists_its_cuts_in_reduced(config):
    rules.config_lists_each_cut_in_reduced(BENCH, ROOT, config)


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
