"""The port's loss and SGD train step (``operator_forge_torch.demo``)
against the JAX reference (``operator_forge/tpu/demo.py:112-127``), on the
CPU, on the same parameters and tokens.

Tolerances, from bf16 rounding (every product of the model rounds to bf16,
so gradients agree to a few bf16 ulps of their magnitude, not to f32):
- the loss within 5e-5 (measured 3.3e-6 at DemoConfig());
- each gradient leaf within 4 bf16 ulps of that leaf's max |g| (measured
  at most 2.0);
- each parameter after one step within ``lr`` times that, plus 1 f32 ulp
  of |p| for the rounding of ``p - lr * g``.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from operator_forge.tpu import demo as jdemo
from operator_forge_torch import demo
from operator_forge_torch.entry import train_entry
from operator_forge_torch.kernels import attention, bf16_ulp, gelu, rmsnorm, step_tolerance
from operator_forge_torch.kernels import cross_entropy as ce

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "test": dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, seq_len=16, batch=8),
    "default": {},
}


@pytest.fixture(scope="module")
def config():
    return demo.DemoConfig(**CONFIGS["test"])


def _tokens(config, batch, seed=1):
    return torch.randint(
        0, config.vocab, (batch, config.seq_len + 1), generator=torch.Generator().manual_seed(seed)
    )


class TestDemoTrain:
    def test_loss_finite_and_near_uniform_at_init(self, config):
        params = demo.init_params(config, torch.Generator().manual_seed(0), "cpu")
        loss = demo.loss_fn(params, _tokens(config, 4), config)
        assert loss.shape == () and bool(torch.isfinite(loss))
        # near-uniform logits at init: loss ~= log(vocab)
        assert abs(float(loss) - np.log(config.vocab)) < 0.5

    def test_train_step_reduces_loss(self, config):
        params = demo.init_params(config, torch.Generator().manual_seed(0), "cpu")
        tokens = _tokens(config, 8)
        _, loss0 = demo.train_step(params, tokens, config)
        for _ in range(10):
            params, loss = demo.train_step(params, tokens, config)
        assert float(loss) < float(loss0)

    def test_train_step_returns_new_tensors(self, config):
        params = demo.init_params(config, torch.Generator().manual_seed(0), "cpu")
        before = demo.tree_map(torch.clone, params)
        new, loss = demo.train_step(params, _tokens(config, 8), config)
        for p, b, n in zip(*map(demo.tree_leaves, (params, before, new))):
            assert torch.equal(p, b) and not p.requires_grad
            assert n is not p and not n.requires_grad and n.shape == p.shape
        assert not loss.requires_grad
        assert any(not torch.equal(p, n) for p, n in zip(demo.tree_leaves(params), demo.tree_leaves(new)))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def reference_step(request):
    """The reference's loss, gradients and stepped parameters, and the
    port's, on the reference's parameters and tokens."""
    jconfig = jdemo.DemoConfig(**CONFIGS[request.param])
    config = demo.DemoConfig(**CONFIGS[request.param])
    jparams = jdemo.init_params(jconfig, jax.random.PRNGKey(0))
    jtokens = jax.random.randint(
        jax.random.PRNGKey(1), (jconfig.batch, jconfig.seq_len + 1), 0, jconfig.vocab
    )
    jloss, jgrads = jax.value_and_grad(jdemo.loss_fn)(jparams, jtokens, jconfig)
    jnew, jstep_loss = jdemo.train_step(jparams, jtokens, jconfig)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    params = demo.params_from_jax(as_np(jparams), "cpu")
    tokens = torch.from_numpy(np.array(jtokens)).long()
    loss, grads = demo.value_and_grad(params, tokens, config)
    new, step_loss = demo.train_step(params, tokens, config)
    return dict(
        config=config, params=params,
        want=dict(loss=float(jloss), grads=as_np(jgrads), new=as_np(jnew), step_loss=float(jstep_loss)),
        got=dict(loss=loss, grads=grads, new=new, step_loss=step_loss),
    )


def _grad_tolerances(grads):
    return [4 * float(bf16_ulp(torch.tensor(np.abs(g).max()))) for g in demo.tree_leaves(grads)]


def test_loss_matches_jax(reference_step):
    want, got = reference_step["want"], reference_step["got"]
    assert abs(float(got["loss"]) - want["loss"]) <= 5e-5
    assert abs(float(got["step_loss"]) - want["step_loss"]) <= 5e-5
    assert float(got["loss"]) == float(got["step_loss"])


def test_gradients_match_jax(reference_step):
    want, got = reference_step["want"], reference_step["got"]
    leaves = zip(demo.tree_leaves(got["grads"]), demo.tree_leaves(want["grads"]),
                 _grad_tolerances(want["grads"]))
    for i, (g, w, tol) in enumerate(leaves):
        assert g.shape == w.shape and g.dtype == torch.float32
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol, f"leaf {i}: max |err| {err:.3e} > 4 bf16 ulps of max |g| ({tol:.3e})"


def test_one_step_matches_jax(reference_step):
    want, got = reference_step["want"], reference_step["got"]
    lr = reference_step["config"].learning_rate
    leaves = zip(demo.tree_leaves(got["new"]), demo.tree_leaves(want["new"]),
                 demo.tree_leaves(reference_step["params"]), demo.tree_leaves(want["grads"]))
    for i, (n, w, p, g) in enumerate(leaves):
        err = (n - torch.tensor(w)).abs()
        tol = step_tolerance(p, torch.tensor(g), lr)
        assert bool((err <= tol).all()), f"leaf {i}: max |err| {float(err.max()):.3e}"


def _unfused_loss(params, tokens, config):
    """The model composed from the plain pieces with every cast a step of
    its own, as before RMSNorm and cross entropy took them in: the f32
    RMSNorm cast to bf16 before each product, the bf16 logits widened
    before the loss.  ``(f32 logits, loss)``."""
    bf16 = torch.bfloat16
    x = params["embed"][tokens[:, :-1]]
    for layer in params["layers"]:
        qkv = rmsnorm.rmsnorm(x, layer["ln1"]).to(bf16) @ layer["wqkv"].to(bf16)
        out = attention.causal_attention(qkv, config.n_heads)
        x = x + (out @ layer["wo"].to(bf16)).float()
        h = gelu.gelu_tanh(rmsnorm.rmsnorm(x, layer["ln2"]).to(bf16) @ layer["w1"].to(bf16))
        x = x + (h @ layer["w2"].to(bf16)).float()
    logits = (x.to(bf16) @ params["unembed"].to(bf16)).float()
    return logits, ce.cross_entropy(logits, tokens[:, 1:].contiguous())


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def unfused_step(request):
    """The port's forward, loss, gradients and step, and the unfused
    composition's, on the same parameters and tokens.  The embedding's
    gradient sums duplicate tokens in parallel on the CPU, in an order that
    changes from run to run; deterministic algorithms fix that order."""
    config = demo.DemoConfig(**CONFIGS[request.param])
    params = demo.init_params(config, torch.Generator().manual_seed(0), "cpu")
    tokens = _tokens(config, config.batch)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got = dict(logits=demo.forward(params, tokens[:, :-1], config),
                   step=demo.train_step(params, tokens, config))
        got["loss"], got["grads"] = demo.value_and_grad(params, tokens, config)
        live = demo.tree_map(lambda p: p.detach().requires_grad_(), params)
        logits, loss = _unfused_loss(live, tokens, config)
        grads = iter(torch.autograd.grad(loss, demo.tree_leaves(live)))
        grads = demo.tree_map(lambda _: next(grads), live)
    finally:
        torch.use_deterministic_algorithms(was)
    lr = config.learning_rate
    want = dict(logits=logits.detach(), loss=loss.detach(), grads=grads,
                step=(demo.tree_map(lambda p, g: p - lr * g, params, grads), loss.detach()))
    return got, want


def test_forward_is_the_unfused_composition(unfused_step):
    got, want = unfused_step
    assert torch.equal(got["logits"], want["logits"])


def test_value_and_grad_is_the_unfused_composition(unfused_step):
    got, want = unfused_step
    assert torch.equal(got["loss"], want["loss"])
    assert all(torch.equal(a, b) for a, b in zip(*map(demo.tree_leaves, (got["grads"], want["grads"]))))


def test_train_step_is_the_unfused_composition(unfused_step):
    (new, loss), (want_new, want_loss) = unfused_step[0]["step"], unfused_step[1]["step"]
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(*map(demo.tree_leaves, (new, want_new))))


def test_train_entry_on_cpu_runs():
    fn, (params, tokens) = train_entry(device="cpu")
    assert tokens.shape == (8, 65) and tokens.dtype == torch.long
    new, loss = fn(params, tokens)
    assert loss.shape == () and bool(torch.isfinite(loss))
    assert abs(float(loss) - np.log(256)) < 0.5
    assert [t.shape for t in demo.tree_leaves(new)] == [t.shape for t in demo.tree_leaves(params)]
    _, (_, same) = train_entry(device="cpu")
    assert torch.equal(tokens, same)


def test_train_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_entry()


@pytest.mark.parametrize("name", ["entry", "train_entry"])
def test_entry_points_pin_f32_accumulation(name):
    """In a fresh process, where PyTorch allows reduced-precision bf16
    reductions by default, each entry point turns them off, and TF32."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import torch\n"
         "m = torch.backends.cuda.matmul\n"
         "assert m.allow_bf16_reduced_precision_reduction\n"
         f"from operator_forge_torch.entry import {name}\n"
         f"{name}(device='cpu')\n"
         "assert not m.allow_bf16_reduced_precision_reduction and not m.allow_tf32\n"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


# Configs past the kernels' former caps, at small widths: a sequence of
# 1100 (attention took at most 1024), a vocab of 20000 (cross entropy took
# at most 16384) and a head of 256 (attention took at most 128).
DOMAIN_BASE = dict(d_model=32, n_heads=2, n_layers=1, d_ff=64, batch=1, vocab=64)
DOMAIN = {
    "seq_1100": dict(seq_len=1100),
    "vocab_20000": dict(vocab=20000, seq_len=8),
    "head_dim_256": dict(d_model=256, n_heads=1, seq_len=8),
}


@pytest.fixture(scope="module", params=sorted(DOMAIN))
def domain_step(request):
    """The reference's loss and gradients and the port's, on the CPU, at a
    config past a former cap."""
    kwargs = {**DOMAIN_BASE, **DOMAIN[request.param]}
    jconfig, config = jdemo.DemoConfig(**kwargs), demo.DemoConfig(**kwargs)
    jparams = jdemo.init_params(jconfig, jax.random.PRNGKey(0))
    jtokens = jax.random.randint(
        jax.random.PRNGKey(1), (jconfig.batch, jconfig.seq_len + 1), 0, jconfig.vocab
    )
    jloss, jgrads = jax.value_and_grad(jdemo.loss_fn)(jparams, jtokens, jconfig)
    params = demo.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    loss, grads = demo.value_and_grad(params, torch.from_numpy(np.array(jtokens)).long(), config)
    return dict(want_loss=float(jloss), want=jax.tree_util.tree_map(np.asarray, jgrads),
                loss=float(loss), grads=grads)


def test_loss_past_the_former_caps_matches_jax(domain_step):
    """The loss within 5e-5, as at the configs above."""
    assert abs(domain_step["loss"] - domain_step["want_loss"]) <= 5e-5


def test_gradients_past_the_former_caps_match_jax(domain_step):
    """Each gradient leaf within 2 bf16 ulps of that leaf's max |g|."""
    got, want = demo.tree_leaves(domain_step["grads"]), demo.tree_leaves(domain_step["want"])
    for i, (g, w) in enumerate(zip(got, want)):
        tol = 2 * float(bf16_ulp(torch.tensor(np.abs(w).max())))
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol, f"leaf {i}: max |err| {err:.3e} > 2 bf16 ulps of max |g| ({tol:.3e})"
