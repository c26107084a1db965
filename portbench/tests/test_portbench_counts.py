"""The operation counts against hand counts at the two configurations."""

import pytest

from portbench import counts, spec

# (config, batch, seq, entry) -> TFLOP a call, by hand: 6 (train) or 2
# (forward) x the weights in products x tokens, plus attention's 12 d (train)
# or 4 d (forward) a causal pair, a head, a row and a layer
CASES = {
    ("pythia-1.4b", 4, 2048, "train"): 69.4,
    ("gpt2-medium", 16, 1024, "train"): 37.2,
    ("pythia-1.4b", 4, 2048, "forward"): 23.1,
    ("gpt2-medium", 128, 128, "train"): 35.1,
}


def config(name):
    return spec.load_json(spec.ROOT / "configs" / f"{name}.json")


@pytest.mark.parametrize("case", list(CASES), ids=lambda c: f"{c[0]}-{c[3]}-b{c[1]}-s{c[2]}")
def test_model_flops_match_hand_counts(case):
    name, batch, seq, entry = case
    assert counts.model_flops(config(name), batch, seq, entry) / 1e12 == pytest.approx(CASES[case], abs=0.05)


def test_products_and_attention_by_hand():
    cfg = config("pythia-1.4b")
    weights = 24 * (3 * 2048 * 2048 + 2048 * 2048 + 2 * 2048 * 8192) + 2048 * 50304
    assert counts.product_weights(cfg) == weights == 1_310_982_144
    # 6 N T in products, and 4.95 T in attention: 2048 * 2049 / 2 pairs
    assert 6 * weights * 8192 / 1e12 == pytest.approx(64.44, abs=0.01)
    attention = 24 * counts.attention_flops(cfg, 4, 2048, "forward") * 3
    assert attention == 24 * 12 * 128 * 2048 * 2049 // 2 * 4 * 16
    assert attention / 1e12 == pytest.approx(4.95, abs=0.01)


@pytest.mark.parametrize("name, total", [("pythia-1.4b", 1_414_103_040), ("gpt2-medium", 404_965_376)])
def test_parameters_as_the_config_states(name, total):
    cfg = config(name)
    assert counts.parameters(cfg) == cfg["parameters"] == total


def test_bound_is_the_larger_of_operations_and_bytes():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(989e12, 6.7e12) == pytest.approx(2.0)


def test_mlp_kernel_bytes_read_once_written_once():
    cfg = config("gpt2-medium")
    flops, nbytes = counts.mlp_kernel_call(cfg, 16, 1024, "forward", keep_pre=True)
    m = 16 * 1024
    assert flops == 2 * m * 1024 * 4096
    assert nbytes == 2 * (m * 1024 + 1024 * 4096 + 2 * m * 4096)
    _, served = counts.mlp_kernel_call(cfg, 16, 1024, "forward", keep_pre=False)
    assert nbytes - served == 2 * m * 4096
