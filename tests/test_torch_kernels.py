"""The port's kernel modules against the JAX reference, on the CPU.

Each kernel's plain version (what a wrapper runs for a CPU tensor) gets the
same inputs, made with numpy, as the function of ``operator_forge/tpu/demo.py``
it replaces.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from operator_forge.tpu import demo as jdemo
from operator_forge_torch import demo, telemetry
from operator_forge_torch.kernels import (
    attention, bf16_ulp, carry_close, gelu, rmsnorm, row_ulps, rows_close, run_twice, step_tolerance,
    within_ulps,
)

CONFIGS = {
    "test": dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, seq_len=16, batch=8),
    "default": {},
}


def _launches(wrapper: str) -> tuple:
    """The launch counters of ``wrapper`` and of its backward."""
    return telemetry.value(f"kernels.{wrapper}"), telemetry.value(f"kernels.{wrapper}_bwd")


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def configs_and_params(request):
    sizes = CONFIGS[request.param]
    jconfig = jdemo.DemoConfig(**sizes)
    jparams = jdemo.init_params(jconfig, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jconfig, jparams, demo.DemoConfig(**sizes), demo.params_from_jax(tree, "cpu")


def _sigma3(shape, seed):
    return (3.0 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def test_attention_matches_jax(configs_and_params):
    """``_attention`` with ``causal_attention_ref`` inside, against
    ``demo._attention``: within 2 bf16 ulps of the output's magnitude (the
    QKV and ``wo`` products round to bf16 and may sum in another order)."""
    jconfig, jparams, config, params = configs_and_params
    x = np.random.default_rng(0).standard_normal(
        (config.batch, config.seq_len, config.d_model)
    ).astype(np.float32)
    want = np.asarray(jdemo._attention(jnp.asarray(x), jparams["layers"][0], jconfig))
    got = demo._attention(torch.from_numpy(x), params["layers"][0], config)
    assert got.dtype == torch.float32
    atol = 2 * float(bf16_ulp(torch.tensor(np.abs(want).max())))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def _qkv(b, s, n_heads, head_dim, seed=0):
    shape = (b, s, 3 * n_heads * head_dim)
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)).bfloat16()


def test_attention_is_causal():
    """Changing q, k and v after position i leaves outputs up to i as they
    were: the -1e30 fill gives masked keys a weight of exactly 0."""
    qkv = _qkv(2, 12, 2, 16)
    later = qkv.clone()
    later[:, 7:] = _qkv(2, 5, 2, 16, seed=1)
    a = attention.causal_attention_ref(qkv, 2)
    b = attention.causal_attention_ref(later, 2)
    assert torch.equal(a[:, :7], b[:, :7])
    assert not torch.equal(a[:, 7:], b[:, 7:])


def test_attention_wrapper_takes_plain_version_on_cpu():
    qkv = _qkv(2, 16, 2, 32)
    before = telemetry.value("kernels.causal_attention")
    assert torch.equal(
        attention.causal_attention(qkv, 2), attention.causal_attention_ref(qkv, 2)
    )
    assert telemetry.value("kernels.causal_attention") == before


@pytest.mark.parametrize(
    "qkv, n_heads",
    [
        (torch.zeros(1, 8, 0, dtype=torch.bfloat16), 1),         # head_dim 0
        (torch.zeros(1, 0, 96, dtype=torch.bfloat16), 1),        # seq 0
        (torch.zeros(1, 8, 96, dtype=torch.float32), 1),         # f32
        (torch.zeros(1, 8, 96, dtype=torch.bfloat16), 5),        # 32 % 5 != 0
    ],
    ids=["head_dim", "seq", "dtype", "heads"],
)
def test_attention_rejects_what_the_kernel_cannot_take(qkv, n_heads):
    with pytest.raises(ValueError):
        attention.causal_attention(qkv, n_heads)


def test_rmsnorm_matches_jax():
    x = _sigma3((512, 128), seed=1)
    gain = np.random.default_rng(2).standard_normal(128).astype(np.float32)
    want = np.asarray(jdemo._rmsnorm(jnp.asarray(x), jnp.asarray(gain)))
    got = rmsnorm.rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(gain))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_rmsnorm_wrapper_takes_plain_version_on_cpu():
    x = torch.from_numpy(_sigma3((4, 16, 64), seed=3))
    gain = torch.linspace(0.5, 1.5, 64)
    before = telemetry.value("kernels.rmsnorm")
    assert torch.equal(rmsnorm.rmsnorm(x, gain), rmsnorm.rmsnorm_ref(x, gain))
    assert telemetry.value("kernels.rmsnorm") == before
    with pytest.raises(ValueError):
        rmsnorm.rmsnorm(x.bfloat16(), gain)
    with pytest.raises(ValueError):
        rmsnorm.rmsnorm(x, gain[:32])


def test_rmsnorm_to_bf16_matches_jax_and_the_unfused_chain():
    """The plain path of ``rmsnorm_to_bf16`` within 1 bf16 ulp of
    ``_rmsnorm(x, g).astype(bf16)`` (both round an f32 value once; JAX's
    f32 sum runs in another order), bit for bit ``rmsnorm(x, g)`` cast to
    bf16, and its gradient the bits of that unfused chain's; no launch."""
    x = _sigma3((512, 128), seed=7)
    gain = np.random.default_rng(8).standard_normal(128).astype(np.float32)
    want = jdemo._rmsnorm(jnp.asarray(x), jnp.asarray(gain)).astype(jnp.bfloat16)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    fused = [torch.from_numpy(x).requires_grad_(), torch.from_numpy(gain).requires_grad_()]
    chain = [t.detach().clone().requires_grad_() for t in fused]
    before = _launches("rmsnorm")
    got = rmsnorm.rmsnorm_to_bf16(*fused)
    unfused = rmsnorm.rmsnorm(*chain).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, unfused)
    assert bool(((got.float() - want).abs() <= bf16_ulp(want)).all())
    dy = torch.from_numpy(_sigma3((512, 128), seed=9)).bfloat16()
    got.backward(dy)
    unfused.backward(dy)
    assert all(torch.equal(a.grad, b.grad) for a, b in zip(fused, chain))
    assert _launches("rmsnorm") == before


def test_rmsnorm_fwd_writes_f32_or_bf16():
    """On the CPU the bf16 output is the plain f32 value cast; other
    output types are refused."""
    x = torch.from_numpy(_sigma3((4, 16, 64), seed=10))
    gain = torch.linspace(0.5, 1.5, 64)
    got = rmsnorm.rmsnorm_fwd(x, gain, torch.bfloat16)
    assert torch.equal(got, rmsnorm.rmsnorm_ref(x, gain).to(torch.bfloat16))
    assert torch.equal(rmsnorm.rmsnorm_fwd(x, gain), rmsnorm.rmsnorm_ref(x, gain))
    with pytest.raises(ValueError):
        rmsnorm.rmsnorm_fwd(x, gain, torch.float16)


def test_gelu_matches_jax_in_f32():
    """The tanh form agrees to about 1e-6 at sigma 3; the erf form, torch's
    default, differs by about 5e-4 and would fail this."""
    x = _sigma3((512, 512), seed=4)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = gelu.gelu_tanh_ref(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=2e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


def test_gelu_matches_jax_in_bf16():
    """Within 1 bf16 ulp of max(|y|, 1).  JAX evaluates the formula in bf16
    steps, so where 1 + tanh(u) cancels (x < -2) its result is off by up to
    about 1e-3 in absolute terms; the port computes in f32 and rounds once."""
    x = jnp.asarray(_sigma3((512, 512), seed=5), jnp.bfloat16)
    want = torch.from_numpy(np.array(jax.nn.gelu(x).astype(jnp.float32)))
    got = gelu.gelu_tanh_ref(torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    tol = bf16_ulp(torch.maximum(want.abs(), torch.ones(())))
    assert bool(((got.float() - want).abs() <= tol).all())


def test_gelu_wrapper_takes_plain_version_on_cpu():
    """``gelu_tanh`` on a CPU tensor is the plain version.  It raises on
    f32, and on any other device: on the card the GELU runs in the epilogue
    of ``mlp.matmul_gelu``, whose wrapper ``tests/test_torch_mlp.py``
    holds to its plain version and its counter."""
    x = torch.from_numpy(_sigma3((64, 128), seed=6)).bfloat16()
    assert torch.equal(gelu.gelu_tanh(x), gelu.gelu_tanh_ref(x))
    with pytest.raises(ValueError):
        gelu.gelu_tanh(x.float())
    with pytest.raises(ValueError, match="matmul_gelu"):
        gelu.gelu_tanh(x.to("meta"))


def test_bf16_ulp():
    t = torch.tensor([1.0, 1.5, 2.0, -3.0, 0.09, 0.0])
    want = torch.tensor([2.0**-7, 2.0**-7, 2.0**-6, 2.0**-6, 2.0**-11, 2.0**-133])
    assert torch.equal(bf16_ulp(t), want)


def test_within_ulps():
    want = torch.tensor([1.0, -3.0])  # the largest magnitude's bf16 ulp is 2**-6
    got = want + torch.tensor([2 * 2.0**-6, 0.0])
    assert within_ulps(got, want, 2) and not within_ulps(got, want, 1)
    assert within_ulps(got.bfloat16(), want, 2)


def test_row_ulps():
    """Errors in ulps of each row's largest magnitude (rows of 2 values:
    2**-6 for the first row, 2**-13 for the second; a row of zeros those
    of 2**-14 of its part's largest) and of the part's largest."""
    want = torch.tensor([[1.0, -3.0, 0.03, 0.02]])
    got = want + torch.tensor([[2 * 2.0**-6, 0.0, 0.0, 3 * 2.0**-13]])
    assert row_ulps(got, want, 2) == (3.0, 2.0) and rows_close(got, want, 2)
    got[0, 3] += 2.0**-13
    assert row_ulps(got, want, 2) == (4.0, 2.0) and not rows_close(got, want, 2)
    assert within_ulps(got, want, 2)  # the whole tensor's tolerance passes it
    got[0, 0] += 2.0**-6
    assert row_ulps(got, want, 2) == (4.0, 3.0)
    # zeros: of 3, 2**-14 of it has an ulp of 2**-20; with two parts, the
    # second's largest is 2**-10: 2**-31
    want = torch.tensor([[1.0, -3.0, 0.0, 0.0, 2.0**-10, 0.0, 0.0, 0.0]])
    got = want + torch.tensor([[0.0, 0.0, 3 * 2.0**-20, 0.0, 0.0, 0.0, 0.0, 3 * 2.0**-31]])
    assert row_ulps(got, want, 2, 2) == (3.0, 3 * 2.0**-14)
    assert rows_close(got, want, 2, 2)
    got[0, 7] *= 2
    assert not rows_close(got, want, 2, 2) and rows_close(got, want, 2)


@pytest.mark.parametrize("off", [1.02, 1.05, 1.1])
def test_rows_close_rejects_late_rows_that_are_off(off):
    """The control of attention's check: plain attention's output at
    ``[1, 2048, 1, 32]`` with its later half of rows ``off`` times too
    large, as a softmax sum that much off in the late key tiles leaves it.
    ``rows_close`` rejects it; two bf16 ulps of the whole output's max
    (row 0 is v_0, some 10 times a late row) would not."""
    qkv = torch.randn((1, 2048, 96), generator=torch.Generator().manual_seed(3)).bfloat16()
    want = attention.causal_attention_ref(qkv, 1)
    got = want.float()
    got[:, 1024:] *= off
    assert rows_close(want, want, 32) and not rows_close(got, want, 32)
    assert within_ulps(got, want, 2)


def test_step_tolerance():
    """``lr`` x 4 bf16 ulps of max |g| plus 1 f32 ulp of each |p|."""
    p = torch.tensor([1.0, -2.0, 0.0])
    g = torch.tensor([0.5, -1.0, 0.25])
    want = 0.01 * 4 * 2.0**-7 + torch.tensor([2.0**-23, 2.0**-22, 2.0**-149])
    torch.testing.assert_close(step_tolerance(p, g, 0.01), want, rtol=1e-6, atol=0)


def test_run_twice():
    x = torch.arange(4.0)
    (got,), same = run_twice(lambda: x * 2)
    assert same and torch.equal(got, x * 2)
    calls = []
    (first, _), same = run_twice(lambda: (calls.append(1) or torch.tensor(len(calls)), x))
    assert not same and int(first) == 1


def test_carry_close():
    """rtol and atol 2e-5 where the plain value is finite, infinities in
    the same places."""
    want = torch.tensor([-math.inf, 1.0, 100.0])
    assert carry_close(want + torch.tensor([0.0, 3e-5, 1e-3]), want)
    assert not carry_close(want + torch.tensor([0.0, 5e-5, 0.0]), want)
    assert not carry_close(torch.tensor([-1e30, 1.0, 100.0]), want)
    assert not carry_close(torch.tensor([math.inf, 1.0, 100.0]), want)
