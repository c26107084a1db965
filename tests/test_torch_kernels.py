"""The port's kernel modules against the JAX reference, on the CPU.

Each kernel's plain version (what a wrapper runs for a CPU tensor) gets the
same inputs, made with numpy, as the function of ``operator_forge/tpu/demo.py``
it replaces.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from operator_forge.tpu import demo as jdemo
from operator_forge_torch import demo
from operator_forge_torch.kernels import attention, bf16_ulp, gelu, rmsnorm

CONFIGS = {
    "test": dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, seq_len=16, batch=8),
    "default": {},
}


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
    before = attention.launches
    assert torch.equal(
        attention.causal_attention(qkv, 2), attention.causal_attention_ref(qkv, 2)
    )
    assert attention.launches == before


@pytest.mark.parametrize(
    "qkv, n_heads",
    [
        (torch.zeros(1, 8, 3 * 256, dtype=torch.bfloat16), 1),   # head_dim 256
        (torch.zeros(1, 1025, 96, dtype=torch.bfloat16), 1),     # seq 1025
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
    before = rmsnorm.launches
    assert torch.equal(rmsnorm.rmsnorm(x, gain), rmsnorm.rmsnorm_ref(x, gain))
    assert rmsnorm.launches == before
    with pytest.raises(ValueError):
        rmsnorm.rmsnorm(x.bfloat16(), gain)
    with pytest.raises(ValueError):
        rmsnorm.rmsnorm(x, gain[:32])


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
    x = torch.from_numpy(_sigma3((64, 128), seed=6)).bfloat16()
    before = gelu.launches
    assert torch.equal(gelu.gelu_tanh(x), gelu.gelu_tanh_ref(x))
    assert gelu.launches == before
    with pytest.raises(ValueError):
        gelu.gelu_tanh(x.float())


def test_bf16_ulp():
    t = torch.tensor([1.0, 1.5, 2.0, -3.0, 0.09, 0.0])
    want = torch.tensor([2.0**-7, 2.0**-7, 2.0**-6, 2.0**-6, 2.0**-11, 2.0**-133])
    assert torch.equal(bf16_ulp(t), want)
