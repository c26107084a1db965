"""The port's kernels against their plain versions on the card.

These tests need an NVIDIA GPU (Hopper: the CUDA source is built for
``sm_90a``), ``nvcc`` and ``triton``; elsewhere they skip.  The file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import pytest
import torch

from operator_forge_torch.kernels import attention, bf16_ulp, gelu, rmsnorm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _normal(shape, seed, device, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=g)).to(device)


@pytest.mark.parametrize(
    "b, s, n_heads, head_dim",
    [(8, 64, 4, 32), (8, 16, 2, 32), (2, 17, 3, 16), (1, 1024, 2, 128), (3, 100, 1, 8)],
)
def test_attention_kernel_matches_plain(cuda, b, s, n_heads, head_dim):
    """Within 2 bf16 ulps of the output's magnitude: the kernel sums in
    another order than cuBLAS before each bf16 rounding."""
    qkv = _normal((b, s, 3 * n_heads * head_dim), 0, cuda).bfloat16()
    before = attention.launches
    got = attention.causal_attention(qkv, n_heads)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    want = attention.causal_attention_ref(qkv, n_heads)
    tol = 2 * bf16_ulp(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= float(tol)


@pytest.mark.parametrize("shape", [(512, 128), (3, 5, 100), (7, 1000)])
def test_rmsnorm_kernel_matches_plain(cuda, shape):
    """rtol 1e-5, atol 1e-6: the row sum is taken in another order."""
    x = _normal(shape, 1, cuda, scale=3.0)
    gain = _normal(shape[-1:], 2, cuda)
    before = rmsnorm.launches
    got = rmsnorm.rmsnorm(x, gain)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    torch.testing.assert_close(got, rmsnorm.rmsnorm_ref(x, gain), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(512, 512), (1000,)])
def test_gelu_kernel_matches_plain(cuda, shape):
    """Within 1 bf16 ulp of max(|y|, 2**-8): both round an f32 value once,
    and the plain version's 1 + tanh(u) cancels in f32 where |y| < 2**-8."""
    x = _normal(shape, 3, cuda, scale=3.0).bfloat16()
    before = gelu.launches
    got = gelu.gelu_tanh(x)
    torch.cuda.synchronize()
    assert gelu.launches == before + 1
    want = gelu.gelu_tanh_ref(x).float()
    tol = bf16_ulp(want.abs().clamp_min(2.0**-8))
    assert bool(((got.float() - want).abs() <= tol).all())
