"""The plain reference against the port's CPU path (its plain versions,
bf16 operands in every product) at a tiny size: they agree to bf16's
rounding, and the reference's own pieces are the equations'."""

import math

import pytest
import torch

from operator_forge_torch import demo
from portbench import inputs, spec
from portbench.reference import demo_block as ref
from portbench.reference.products import Products, fp8
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 21
MODEL, _ = spec.architecture("demo_block")


def setup():
    cfg = tiny.config()
    config = demo.DemoConfig(vocab=cfg["vocab"], d_model=cfg["d_model"], n_heads=cfg["n_heads"],
                             n_layers=cfg["n_layers"], d_ff=cfg["d_ff"], seq_len=32, batch=4)
    pool = inputs.token_pool(cfg["vocab"], tiny.TRAIN, SEED, CPU)
    return cfg, config, pool


def test_forward_agrees_with_the_port_to_bf16_rounding():
    cfg, config, pool = setup()
    params = MODEL.make_params(cfg, SEED, CPU)
    got = demo.forward(params, pool[0, :, :-1], config)
    want = torch.stack(ref.forward_logits(params, pool[0, :, :-1], cfg, Products()))
    scale = want.square().mean().sqrt()
    assert float((got - want).abs().max() / scale) < 0.1
    assert float((got - want).square().mean().sqrt() / scale) < 0.02


def test_one_sgd_step_agrees_with_the_port():
    cfg, config, pool = setup()
    params = MODEL.make_params(cfg, SEED, CPU)
    new, loss = demo.train_step(params, pool[0], config)
    grads = [((p - n) / config.learning_rate).norm() for p, n in
             zip(demo.tree_leaves(params), demo.tree_leaves(new))]
    out = ref.sgd_steps(MODEL.make_params(cfg, SEED, CPU), [pool[0]],
                        {**cfg, "learning_rate": config.learning_rate}, Products())
    assert float(loss) == pytest.approx(out["losses"][0], abs=1e-3)
    for got, want in zip(grads, out["grad_norms"]):
        assert float(got) == pytest.approx(want, rel=0.02)


def test_the_loss_at_the_start_is_near_log_vocab_for_small_logits():
    cfg = tiny.config()
    params = MODEL.make_params(cfg, SEED, CPU)
    params["unembed"].zero_()
    pool = inputs.token_pool(cfg["vocab"], tiny.TRAIN, SEED, CPU)
    loss = ref.next_token_nll(params, pool[0], cfg["n_heads"], Products())
    assert float(loss) == pytest.approx(math.log(cfg["vocab"]), rel=1e-6)


def test_attention_is_causal():
    cfg = tiny.config()
    params = MODEL.make_params(cfg, SEED, CPU)
    pool = inputs.token_pool(cfg["vocab"], tiny.TRAIN, SEED, CPU)
    tokens = pool[0, :1, :-1].clone()
    before = ref.logits(params, tokens, cfg["n_heads"], Products())
    tokens[0, -1] = (tokens[0, -1] + 1) % cfg["vocab"]
    after = ref.logits(params, tokens, cfg["n_heads"], Products())
    assert torch.equal(before[0, :-1], after[0, :-1])
    assert not torch.equal(before[0, -1], after[0, -1])


def test_recompute_and_rows_change_nothing_but_the_order_of_sums():
    cfg = tiny.config()
    pool = inputs.token_pool(cfg["vocab"], tiny.TRAIN, SEED, CPU)
    a = ref.sgd_steps(MODEL.make_params(cfg, SEED, CPU), [pool[0], pool[1]],
                      {**cfg, "learning_rate": 0.01}, Products())
    params = MODEL.make_params(cfg, SEED, CPU)
    live = ref.leaves(params)
    for p in live:
        p.requires_grad_(True)
    loss = ref.next_token_nll(params, pool[0], cfg["n_heads"], Products())
    grads = torch.autograd.grad(loss, live)
    assert float(loss) == pytest.approx(a["losses"][0], rel=1e-6)
    # the step's norm is read from its rounded update, |p - (p - lr g)| / lr,
    # whose rounding is up to an f32 ulp of |p| on each element
    for g, p, norm in zip(grads, ref.leaves(MODEL.make_params(cfg, SEED, CPU)), a["grad_norms"]):
        ulp = torch.finfo(torch.float32).eps * float(p.abs().max())
        assert float(g.norm()) == pytest.approx(norm, rel=1e-4, abs=math.sqrt(p.numel()) * ulp / 0.01)


def test_fp8_holds_each_operand_to_three_mantissa_bits():
    t = torch.linspace(-3, 3, 1001)
    q = fp8(t)
    assert float(q.abs().max()) == pytest.approx(3.0)
    assert float(((q - t).abs() / t.abs().clamp_min(0.1)).max()) <= 2.0**-4 + 1e-6
    assert not torch.equal(q, t)
