"""The operation counts against hand counts at the two configurations, and,
to the bit, the counts each cell's metrics read: the model's operations a
call, the parameters, and each roofline call's operations and bytes, as
the harness counted them before the architecture moved into its own files
(``models/demo_block.py``)."""

import pytest

from portbench import counts, spec

MODEL, _ = spec.architecture("demo_block")

# (config, batch, seq, entry) -> TFLOP a call, by hand: 6 (train) or 2
# (forward) x the weights in products x tokens, plus attention's 12 d (train)
# or 4 d (forward) a causal pair, a head, a row and a layer
CASES = {
    ("pythia-1.4b", 4, 2048, "train"): 69.4,
    ("gpt2-medium", 16, 1024, "train"): 37.2,
    ("pythia-1.4b", 4, 2048, "forward"): 23.1,
    ("gpt2-medium", 128, 128, "train"): 35.1,
}

# each cell's model operations a call, as the parent commit counted them
MODEL_FLOPS = {
    "pythia-1.4b.train.s2048": 69_387_612_585_984,
    "gpt2-medium.train.s1024": 37_222_166_298_624,
    "pythia-1.4b.forward.s2048": 23_129_204_195_328,
    "gpt2-medium.train.s128": 35_057_502_781_440,
}

# each cell's roofline calls, (operations, bytes), as the parent counted them
ATTENTION = {
    "pythia-1.4b.train.s2048": ((68_753_031_168, 134_217_728), (137_506_062_336, 234_881_024)),
    "gpt2-medium.train.s1024": ((34_393_292_800, 134_217_728), (68_786_585_600, 234_881_024)),
    "pythia-1.4b.forward.s2048": ((68_753_031_168, 134_217_728), (137_506_062_336, 234_881_024)),
    "gpt2-medium.train.s128": ((4_328_521_728, 134_217_728), (8_657_043_456, 234_881_024)),
}
MLP = {
    "pythia-1.4b.train.s2048": ((274_877_906_944, 335_544_320), (274_877_906_944, 335_544_320)),
    "gpt2-medium.train.s1024": ((137_438_953_472, 310_378_496), (137_438_953_472, 310_378_496)),
    "pythia-1.4b.forward.s2048": ((274_877_906_944, 201_326_592), (274_877_906_944, 335_544_320)),
    "gpt2-medium.train.s128": ((137_438_953_472, 310_378_496), (137_438_953_472, 310_378_496)),
}


def config(name):
    return spec.load_json(spec.ROOT / "configs" / f"{name}.json")


@pytest.mark.parametrize("case", list(CASES), ids=lambda c: f"{c[0]}-{c[3]}-b{c[1]}-s{c[2]}")
def test_model_flops_match_hand_counts(case):
    name, batch, seq, entry = case
    assert MODEL.model_flops(config(name), batch, seq, entry) / 1e12 == pytest.approx(CASES[case], abs=0.05)


@pytest.mark.parametrize("cell", list(MODEL_FLOPS))
def test_each_cells_model_flops_are_the_parents_to_the_bit(cell):
    found = spec.find_cell(cell)
    t = found.traffic
    assert found.architecture == "demo_block"
    assert found.model.model_flops(found.config, t["batch"], t["seq"], t["entry"]) == MODEL_FLOPS[cell]


@pytest.mark.parametrize("cell", list(ATTENTION))
def test_each_cells_roofline_calls_are_the_parents_to_the_bit(cell):
    found = spec.find_cell(cell)
    t = found.traffic
    calls = found.model.CALLS
    assert set(calls) == {"attention", "mlp"}
    for klass, want in (("attention", ATTENTION), ("mlp", MLP)):
        for (call, cost), pinned in zip(calls[klass].items(), want[cell]):
            assert cost(found.config, t["batch"], t["seq"], t["entry"], call) == pinned, (klass, call)


def test_products_and_attention_by_hand():
    cfg = config("pythia-1.4b")
    weights = 24 * (3 * 2048 * 2048 + 2048 * 2048 + 2 * 2048 * 8192) + 2048 * 50304
    assert MODEL.product_weights(cfg) == weights == 1_310_982_144
    # 6 N T in products, and 4.95 T in attention: 2048 * 2049 / 2 pairs
    assert 6 * weights * 8192 / 1e12 == pytest.approx(64.44, abs=0.01)
    attention = 24 * counts.attention_flops(4, 2048, 16, 128, 128, "forward") * 3
    assert attention == 24 * 12 * 128 * 2048 * 2049 // 2 * 4 * 16
    assert attention / 1e12 == pytest.approx(4.95, abs=0.01)


def test_attention_counts_take_query_and_value_widths_apart():
    # heads of 192-wide queries and keys and 128-wide values: a pair's
    # scores take 2 * 192 forward, its p @ v 2 * 128
    assert counts.attention_flops(1, 1, 1, 192, 128, "forward") == 2 * (192 + 128)
    assert counts.attention_flops(1, 1, 1, 192, 128, "backward") == 4 * (192 + 128)
    # q, k and v in, the output out; backward also their gradients
    assert counts.attention_bytes(1, 1, 1, 192, 128, "forward") == 2 * (192 + 192 + 128 + 128)
    assert counts.attention_bytes(1, 1, 1, 192, 128, "backward") == 2 * (2 * (192 + 192 + 128) + 128)


@pytest.mark.parametrize("name, total", [("pythia-1.4b", 1_414_103_040), ("gpt2-medium", 404_965_376)])
def test_parameters_as_the_config_states(name, total):
    cfg = config(name)
    assert MODEL.parameters(cfg) == cfg["parameters"] == total


def test_bound_is_the_larger_of_operations_and_bytes():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(989e12, 6.7e12) == pytest.approx(2.0)


def test_mlp_kernel_bytes_read_once_written_once():
    m = 16 * 1024
    flops, nbytes = counts.mlp_kernel_call(m, 1024, 4096, "forward", keep_pre=True)
    assert flops == 2 * m * 1024 * 4096
    assert nbytes == 2 * (m * 1024 + 1024 * 4096 + 2 * m * 4096)
    _, served = counts.mlp_kernel_call(m, 1024, 4096, "forward", keep_pre=False)
    assert nbytes - served == 2 * m * 4096
