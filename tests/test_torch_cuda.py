"""The port's kernels against their plain versions on the card.

These tests need an NVIDIA GPU (Hopper: the CUDA sources are built for
``sm_90a``) and ``nvcc``; elsewhere they skip.  The file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import collections
import math
import os
import subprocess
import sys
import time

import pytest
import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.distributed.device_mesh import init_device_mesh
from torch.utils._python_dispatch import TorchDispatchMode

from operator_forge_torch import demo, telemetry
from operator_forge_torch.entry import dryrun_multichip, entry, train_entry
from operator_forge_torch.jit import WARMUP_CALLS, jit, nbytes
from operator_forge_torch.kernels import (
    attention, bf16_ulp, build, carry_close, gelu, grads_close, mlp, rmsnorm, run_twice,
    step_tolerance, rows_close, within_floored_ulps, within_ulps, wrapper_call,
)
from operator_forge_torch.kernels import cross_entropy as ce
from operator_forge_torch.kernels import ring_attention as ra

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.cuda


def _launches(wrapper: str) -> tuple:
    """The launch counters of ``wrapper`` and of its backward."""
    return telemetry.value(f"kernels.{wrapper}"), telemetry.value(f"kernels.{wrapper}_bwd")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _normal(shape, seed, device, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=g)).to(device)


# DemoConfig()'s shape; the dryrun's (2 heads of 32 at seq 16, and 1 head
# per model rank); the tile edges at seq 1, 63, 65 and 128; ragged seqs;
# head widths below one k-step, not a multiple of 8, and the widest
ATTENTION_SHAPES = [
    (8, 64, 4, 32), (8, 16, 2, 32), (2, 17, 3, 16), (1, 1024, 2, 128), (3, 100, 1, 8),
    (2, 1, 2, 32), (2, 63, 2, 32), (2, 65, 2, 32), (2, 128, 2, 32), (2, 16, 1, 32),
    (2, 70, 2, 12),
    # past the former caps: seq 1025 and 2048 on the tiles path, a row too
    # long for its spilled scores, heads of 129 and 256 (Gemma 7B's) and a
    # batch of 65536 on the stream path
    (1, 1025, 2, 32), (1, 2048, 4, 32), (1, 4000, 1, 64), (2, 40, 2, 129), (2, 128, 2, 256),
    (65536, 2, 1, 8),
    # the stream path: a long row at the tiles path's widest head, Gemma
    # 7B's heads at seq 2048, heads past the former cap of 3072, and an odd
    # width that is not a multiple of 8 (element-by-element staging), each
    # with two groups of warps a block; and a grid of two blocks an SM and
    # more, one group a block
    (1, 4096, 4, 128), (1, 2048, 4, 256), (1, 8, 1, 3073), (1, 40, 1, 4096), (2, 33, 2, 200),
    (8, 3000, 8, 128),
]


@pytest.mark.parametrize("b, s, n_heads, head_dim", ATTENTION_SHAPES)
def test_attention_kernel_matches_plain(cuda, b, s, n_heads, head_dim):
    """Within 3 bf16 ulps of each row's magnitude (a head of one query,
    whose scale falls with the keys it sees) and 2 of the output's
    (``rows_close``): the kernel sums in another order than cuBLAS before
    each bf16 rounding.  Two launches on the same inputs give the same
    bits."""
    qkv = _normal((b, s, 3 * n_heads * head_dim), 0, cuda).bfloat16()
    before = telemetry.value("kernels.causal_attention")
    (got,), same = run_twice(lambda: attention.causal_attention(qkv, n_heads))
    torch.cuda.synchronize()
    assert telemetry.value("kernels.causal_attention") == before + 2 and same
    assert rows_close(got, attention.causal_attention_ref(qkv, n_heads), head_dim)


def _within_bf16_ulp(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Elementwise within 1 bf16 ulp of ``want``: both round an f32 value
    once, and the two f32 values lie a few f32 ulps apart."""
    want = want.float()
    return bool(((got.float() - want).abs() <= bf16_ulp(want)).all())


# DemoConfig()'s [512, 128] and the wide step's [4096, 128] (a warp a row);
# odd and wider rows (a block a row, staged in shared memory, with and
# without 16-byte copies), and rows past what shared memory holds
@pytest.mark.parametrize("shape", [(512, 128), (3, 5, 100), (7, 1000), (3, 16385), (256, 20480),
                                   (4096, 128), (5, 130), (2, 70000)])
def test_rmsnorm_kernel_matches_plain(cuda, shape):
    """f32 within rtol 1e-5, atol 1e-6: the row sum is taken in another
    order.  bf16 within 1 bf16 ulp of the plain value cast.  One launch a
    call, the same bits from two."""
    x = _normal(shape, 1, cuda, scale=3.0)
    gain = _normal(shape[-1:], 2, cuda)
    before = telemetry.value("kernels.rmsnorm")
    got = rmsnorm.rmsnorm(x, gain)
    torch.cuda.synchronize()
    assert telemetry.value("kernels.rmsnorm") == before + 1
    want = rmsnorm.rmsnorm_ref(x, gain)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    (got,), same = run_twice(lambda: rmsnorm.rmsnorm_fwd(x, gain, torch.bfloat16))
    assert telemetry.value("kernels.rmsnorm") == before + 3 and same and got.dtype == torch.bfloat16
    assert _within_bf16_ulp(got, want.to(torch.bfloat16))


# (M, K, N) of the MLP's products: DemoConfig()'s, its half on two model
# ranks (d_ff / 2), the wide step's M = 4096 (the large tiles), one row;
# odd widths (element by element), a depth of 1, ragged edges on every
# side of a small and of a large tile, a depth of many stages, and 2188
# column tiles; the benchmark cells' (Pythia-1.4B's, GPT-2 medium's) and a
# ragged shape past them (the last row and column tiles part outside)
MLP_SHAPES = [(512, 128, 512), (512, 128, 256), (4096, 128, 512), (1, 128, 512), (91, 72, 200),
              (3, 1, 5), (1000, 130, 77), (130, 200, 33), (3000, 72, 1000), (64, 4096, 96),
              (7, 16, 70000), (8192, 2048, 8192), (16384, 1024, 4096), (8191, 2048, 8184)]
# the shapes of MLP_SHAPES that take the wgmma design (csrc/mlp.cu's
# mlp_wgmma): aligned operands and at least 512 tile steps
MLP_WGMMA_SHAPES = {(7, 16, 70000), (8192, 2048, 8192), (16384, 1024, 4096), (8191, 2048, 8184)}


def _bf16_at(t: torch.Tensor, offset: int) -> torch.Tensor:
    """``t`` in bf16, contiguous, ``offset`` values past a 16-byte
    boundary (1: a base the kernels stage element by element)."""
    out = torch.empty(t.numel() + offset, dtype=torch.bfloat16, device=t.device)[offset:]
    return out.view(t.shape).copy_(t)


def _mlp_fwd_inputs(m, k, n, device, offset=0, seed=3):
    """x at unit scale and w1 scaled so that ``h_pre`` has a scale of 3,
    the GELU's whole range."""
    x = _bf16_at(_normal((m, k), seed, device), offset)
    return x, _bf16_at(_normal((k, n), seed + 1, device, scale=3.0 / math.sqrt(k)), offset)


def _mlp_bwd_inputs(m, k, n, device, offset=0, seed=9):
    """dy and w2 as the forward's, h_pre at a scale of 3."""
    dy = _bf16_at(_normal((m, k), seed, device), offset)
    w2 = _bf16_at(_normal((n, k), seed + 1, device, scale=1.0 / math.sqrt(k)), offset)
    return dy, w2, _bf16_at(_normal((m, n), seed + 2, device, scale=3.0), offset)


@pytest.mark.parametrize("m, k, n", MLP_SHAPES)
def test_matmul_gelu_kernel_matches_plain(cuda, m, k, n):
    """h_pre within 1 bf16 ulp of the plain product's, each value floored
    at 2**-8 of the max (only the order of the f32 sum differs); h within
    ``mlp.gelu_close`` of the plain GELU of that h_pre.  One
    launch a call, the same bits from two, and the served call (no h_pre)
    gives h's bits.  ``kernels.matmul_gelu.wgmma`` moves by one a call at
    the shapes that take the wgmma design, and not at the others."""
    x, w1 = _mlp_fwd_inputs(m, k, n, cuda)
    before = telemetry.value("kernels.matmul_gelu")
    wgmma = telemetry.value("kernels.matmul_gelu.wgmma")
    (h, h_pre), same = run_twice(lambda: mlp.matmul_gelu(x, w1))
    served, none = mlp.matmul_gelu(x, w1, keep_pre=False)
    torch.cuda.synchronize()
    assert telemetry.value("kernels.matmul_gelu") == before + 3 and same and none is None
    took = 3 if (m, k, n) in MLP_WGMMA_SHAPES else 0
    assert telemetry.value("kernels.matmul_gelu.wgmma") == wgmma + took
    assert h.shape == h_pre.shape == (m, n) and torch.equal(served, h)
    assert within_floored_ulps(h_pre, mlp.matmul_gelu_ref(x, w1)[1], 1)
    assert mlp.gelu_close(h, h_pre)


@pytest.mark.parametrize("kernel", ["matmul_gelu", "matmul_gelu_bwd"])
@pytest.mark.parametrize("m, k, n", [(91, 72, 200), (512, 128, 512), (3000, 72, 1000)])
def test_mlp_kernels_on_unaligned_rows(cuda, kernel, m, k, n):
    """Every operand 2 bytes past a 16-byte boundary: staged element by
    element (the mma.sync design: TMA cannot describe them, and the wgmma
    counter does not move), with the tolerances of the aligned tests."""
    wgmma = telemetry.value(f"kernels.{kernel}.wgmma")
    if kernel == "matmul_gelu":
        x, w1 = _mlp_fwd_inputs(m, k, n, cuda, offset=1)
        h, h_pre = mlp.matmul_gelu(x, w1)
        assert within_floored_ulps(h_pre, mlp.matmul_gelu_ref(x, w1)[1], 1)
        assert mlp.gelu_close(h, h_pre)
    else:
        inputs = _mlp_bwd_inputs(m, k, n, cuda, offset=1)
        assert within_floored_ulps(mlp.matmul_gelu_bwd(*inputs), mlp.matmul_gelu_bwd_ref(*inputs), 2)
    assert telemetry.value(f"kernels.{kernel}.wgmma") == wgmma


# the backward's first launch on long rows (64-row tiles, two passes): the
# benchmark's rows and widths (Pythia's 2048 of 128, GPT-2's 1024 of 64) at
# fewer batches and heads; rows not a multiple of 64; the first row past
# one chunk; GPT-2 s128's row.  On an H100 these grids of 64-row tiles fill
# fewer than half the SMs and keep 16-row tiles; ROWS64_SHAPES, the same
# rows with more heads or batches, take the long-row design.
LONG_ROW_SHAPES = [
    (1, 2048, 2, 128), (2, 1024, 2, 64), (1, 2047, 2, 128), (1, 1089, 1, 64), (2, 65, 2, 128),
    (4, 128, 4, 64),
]
ROWS64_SHAPES = [
    (1, 2048, 8, 128), (2, 1024, 4, 64), (1, 2047, 8, 128), (1, 1089, 8, 64), (8, 65, 8, 128),
    (4, 128, 16, 64),
]


@pytest.mark.parametrize(
    "b, s, n_heads, head_dim", ATTENTION_SHAPES + LONG_ROW_SHAPES + ROWS64_SHAPES)
def test_attention_bwd_kernel_matches_plain(cuda, b, s, n_heads, head_dim):
    """dQ, dK and dV each within 3 bf16 ulps of each row's magnitude (a
    head of one query for dQ, of one key for dK and dV) and 2 of its own
    (``rows_close``): the kernels sum in another order than cuBLAS before
    each bf16 rounding.  ``ROWS64_SHAPES`` are counted as long-row calls."""
    d = n_heads * head_dim
    qkv = _normal((b, s, 3 * d), 4, cuda).bfloat16()
    dout = _normal((b, s, d), 5, cuda).bfloat16()
    before = telemetry.value("kernels.causal_attention_bwd")
    rows64 = telemetry.value("kernels.causal_attention_bwd.rows64")
    (got,), same = run_twice(lambda: attention.causal_attention_bwd(qkv, dout, n_heads))
    assert telemetry.value("kernels.causal_attention_bwd") == before + 2 and same
    if (b, s, n_heads, head_dim) in ROWS64_SHAPES:
        assert telemetry.value("kernels.causal_attention_bwd.rows64") == rows64 + 2
    want = attention.causal_attention_bwd_ref(qkv, dout, n_heads)
    assert rows_close(got, want, head_dim, 3)


@pytest.mark.parametrize("b, s, n_heads, head_dim", [
    (1, 2048, 8, 128), (2, 1024, 4, 64), (1, 1089, 8, 64), (1, 2048, 2, 128), (2, 65, 2, 32),
    (8, 64, 4, 32)])
def test_attention_bwd_stats_plane_matches_plain(cuda, b, s, n_heads, head_dim):
    """The statistics the first launch hands the second, f32 ``[3, b, h,
    s]``, against the plain values in f64 from the same bf16 scores (the
    long-row design carries the sum and D online, rescaled as the max
    grows): the max within 1 bf16 ulp of itself (a score whose f32 sum
    rounds to bf16 the other way), the sum within 2**-10 of itself, D
    within 2**-10 of ``sum_k y |dP|``, the scale its terms cancel from."""
    d = n_heads * head_dim
    qkv = _normal((b, s, 3 * d), 6, cuda).bfloat16()
    dout = _normal((b, s, d), 7, cuda).bfloat16()
    stats = torch.full((3, b, n_heads, s), math.nan, device=cuda)
    dqkv = torch.empty_like(qkv)
    lib = attention._library()
    status = lib.causal_attention_bwd_bf16(
        qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), b, s, n_heads,
        head_dim, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert status == 0
    q, k, v = (attention._heads(t, n_heads) for t in qkv.chunk(3, dim=-1))
    d_out = attention._heads(dout, n_heads)
    root = torch.tensor(head_dim, dtype=torch.float32, device=cuda).sqrt()
    mask = torch.ones(s, s, dtype=torch.bool, device=cuda).tril()
    scores = torch.where(mask, (q @ k.transpose(-1, -2)).float() / root, attention.MASK_FILL)
    top = scores.amax(-1)
    e = torch.exp(scores.double() - top.double().unsqueeze(-1))
    total = e.sum(-1)
    y = e / total.unsqueeze(-1)
    d_p = (d_out @ v.transpose(-1, -2)).double()
    big_d = (y * d_p).sum(-1)
    scale = (y * d_p.abs()).sum(-1)
    assert bool(((stats[0] - top).abs() <= bf16_ulp(top)).all())
    assert bool(((stats[1].double() - total).abs() <= 2.0**-10 * total).all())
    assert bool(((stats[2].double() - big_d).abs() <= 2.0**-10 * scale).all())


# the benchmark's train shapes, Pythia-1.4B's and GPT-2 medium's RMSNorm
# rows, which fill the card's grid
RMSNORM_BWD_CELL_SHAPES = [(8192, 2048), (16384, 1024)]
# beside them, a small grid (DemoConfig()'s [512, 128], 7 rows of 1000)
# and strided rows (an odd width, a width past 8192)
RMSNORM_BWD_BITS_SHAPES = [*RMSNORM_BWD_CELL_SHAPES, (512, 128), (7, 1000), (3, 16385), (5, 40000)]


# DemoConfig()'s [512, 128]; one row; 4096 rows; the widest rows; strided
# rows of odd widths (100, 16385) and past 8192; few rows, each block one
# step (37, 15, 7, 133 rows); the cells' shapes; row counts that do not
# divide among the grid's blocks (8191); rows of 4096 (Pythia-6.9B's) and
# 8192 columns, a row of 1000 that leaves lanes idle, and rows of 128, a
# warp a row
@pytest.mark.parametrize(
    "shape", [(512, 128), (3, 5, 100), (7, 1000), (1, 128), (4096, 128), (64, 16384), (37, 128),
              (3, 16385), (256, 20480), (5, 40000), *RMSNORM_BWD_CELL_SHAPES, (8191, 2048),
              (133, 1024), (4099, 4096), (1000, 8192), (5000, 1000), (20000, 128)]
)
def test_rmsnorm_bwd_kernel_matches_plain(cuda, shape):
    """dx and dgain within rtol 1e-5 and 1e-6 of each one's max: f32, sums
    in another order."""
    x = _normal(shape, 6, cuda, scale=3.0)
    dy = _normal(shape, 7, cuda)
    gain = _normal(shape[-1:], 8, cuda)
    before = telemetry.value("kernels.rmsnorm_bwd")
    got, same = run_twice(lambda: rmsnorm.rmsnorm_bwd(x, gain, dy))
    assert telemetry.value("kernels.rmsnorm_bwd") == before + 2 and same
    for g, w in zip(got, rmsnorm.rmsnorm_bwd_ref(x, gain, dy)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6 * float(w.abs().max()))


def _rmsnorm_bwd_inputs(shape, seed, device):
    """x (scale 3), a bf16 dy and the gain of RMSNorm's backward."""
    return (_normal(shape, seed, device, scale=3.0), _normal(shape, seed + 1, device).bfloat16(),
            _normal(shape[-1:], seed + 2, device))


@pytest.mark.parametrize("shape", RMSNORM_BWD_BITS_SHAPES)
def test_rmsnorm_bwd_bf16_dy_gives_the_bits_of_widening_first(cuda, shape):
    """The kernel reading a bf16 dy gives the bits of ``rmsnorm_bwd`` on dy
    widened to f32 (the widening is exact, the rest the same launch), and
    so does ``rmsnorm_to_bf16``'s backward; each call is one launch."""
    x, dy, gain = _rmsnorm_bwd_inputs(shape, 40, cuda)
    before = telemetry.value("kernels.rmsnorm_bwd")
    got = rmsnorm.rmsnorm_bwd_bf16(x, gain, dy)
    want = rmsnorm.rmsnorm_bwd(x, gain, dy.float())
    live = x.clone().requires_grad_(), gain.clone().requires_grad_()
    through = torch.autograd.grad(rmsnorm.rmsnorm_to_bf16(*live), live, dy)
    assert telemetry.value("kernels.rmsnorm_bwd") == before + 3
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(through, want))


@pytest.mark.parametrize("shape", RMSNORM_BWD_BITS_SHAPES)
def test_rmsnorm_bwd_grid_replays_give_the_same_bits(cuda, shape):
    """Two replays of a captured call give the eager call's bits: the last
    block of each launch sets the ticket counters back to 0 (dx and dgain
    are spoilt between the replays, so a replay that wrote neither would
    show)."""
    x, dy, gain = _rmsnorm_bwd_inputs(shape, 43, cuda)
    want = rmsnorm.rmsnorm_bwd_bf16(x, gain, dy)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = rmsnorm.rmsnorm_bwd_bf16(x, gain, dy)
    for _ in range(2):
        for t in got:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    n = rmsnorm._bwd_library().rmsnorm_bwd_counters()
    assert int(build.counters("rmsnorm_bwd", x.device, n).abs().sum()) == 0


class _AtenOps(TorchDispatchMode):
    """Records the name of every PyTorch operation run inside it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_rmsnorm_bwd_is_one_launch_a_call_with_no_cast(cuda):
    """At the cells' shapes and at ``[7, 1000]``, with f32 or bf16 dy, each
    call is one launch, counted once by ``kernels.rmsnorm_bwd``, and the
    only PyTorch operations it runs make its outputs and its scratch: a
    bf16 dy costs no cast."""
    for shape in [*RMSNORM_BWD_CELL_SHAPES, (7, 1000)]:
        x, dy, gain = _rmsnorm_bwd_inputs(shape, 46, cuda)
        dy32 = dy.float()
        for call in (lambda: rmsnorm.rmsnorm_bwd(x, gain, dy32),
                     lambda: rmsnorm.rmsnorm_bwd_bf16(x, gain, dy)):
            call()  # (a device's first call also makes the counters)
            before = telemetry.value("kernels.rmsnorm_bwd")
            with _AtenOps() as ops:
                call()
            assert telemetry.value("kernels.rmsnorm_bwd") == before + 1, shape
            assert set(ops.names) <= {"empty", "empty_like"}, (shape, ops.names)


@pytest.mark.parametrize("m, k, n", MLP_SHAPES)
def test_matmul_gelu_bwd_kernel_matches_plain(cuda, m, k, n):
    """dh_pre within 2 bf16 ulps of the plain composition's, each value
    floored at 2**-8 of the max: the product dy @ w2ᵀ sums in another
    order, which moves its rounding by one ulp, and the slope (up to 1.13)
    scales that ulp before the second rounding, which can then land two
    ulps of dh_pre apart.  One launch a call, the same bits from two;
    ``kernels.matmul_gelu_bwd.wgmma`` counts the calls at the shapes that
    take the wgmma design."""
    dy, w2, h_pre = _mlp_bwd_inputs(m, k, n, cuda)
    before = telemetry.value("kernels.matmul_gelu_bwd")
    wgmma = telemetry.value("kernels.matmul_gelu_bwd.wgmma")
    (got,), same = run_twice(lambda: mlp.matmul_gelu_bwd(dy, w2, h_pre))
    torch.cuda.synchronize()
    assert telemetry.value("kernels.matmul_gelu_bwd") == before + 2 and same and got.shape == (m, n)
    took = 2 if (m, k, n) in MLP_WGMMA_SHAPES else 0
    assert telemetry.value("kernels.matmul_gelu_bwd.wgmma") == wgmma + took
    assert within_floored_ulps(got, mlp.matmul_gelu_bwd_ref(dy, w2, h_pre), 2)


# DemoConfig()'s [512, 256] and rows of 1000 and 2048 (a warp a row in
# bf16; 1000 in f32); odd rows of 100 (a block a row in bf16); the wide
# step's 32000 and 16385 (a block a row, staged in shared memory); rows
# past what shared memory holds in f32 (70000) and in bf16 (120000)
@pytest.mark.parametrize("rows, vocab", [((8, 64), 256), ((512,), 1000), ((3, 7), 1000),
                                         ((3,), 16385), ((256,), 32000), ((3, 5), 100),
                                         ((4,), 2048), ((2,), 70000), ((2,), 120000)])
def test_cross_entropy_kernels_match_plain(cuda, rows, vocab):
    """On f32 logits the loss within rtol 1e-5 and dlogits within 1e-7:
    ``exp`` and ``log`` of another rounding and sums in another order.  On
    the same logits in bf16 the loss within rtol 1e-5 of the plain version
    and bf16 dlogits within 1 bf16 ulp of its.  One launch a call each
    way, the same bits from two."""
    for dtype in (torch.float32, torch.bfloat16):
        logits = _normal((*rows, vocab), 11, cuda, scale=2.0).to(dtype)
        targets = torch.randint(0, vocab, rows, generator=torch.Generator().manual_seed(12)).to(cuda)
        grad = torch.tensor(0.75, device=cuda)
        before = _launches("cross_entropy")
        (loss, lse), same = run_twice(lambda: ce.cross_entropy_fwd(logits, targets))
        (dlogits,), same_bwd = run_twice(lambda: ce.cross_entropy_bwd(logits, targets, lse, grad))
        assert _launches("cross_entropy") == (before[0] + 2, before[1] + 2)
        assert same and same_bwd and dlogits.dtype == dtype
        want_loss, want_lse = ce.cross_entropy_ref(logits, targets)
        torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
        torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=0)
        want = ce.cross_entropy_bwd_ref(logits, targets, want_lse, grad)
        if dtype == torch.float32:
            torch.testing.assert_close(dlogits, want, rtol=0, atol=1e-7)
        else:
            assert _within_bf16_ulp(dlogits, want)


def test_autograd_functions_match_autograd_of_plain(cuda):
    """Each kernel's autograd ``Function`` on the card against autograd of
    its plain forward on the same CUDA tensors, with the tolerances above."""
    qkv = _normal((2, 17, 144), 13, cuda).bfloat16()
    dout = _normal((2, 17, 48), 14, cuda).bfloat16()
    got, want = qkv.clone().requires_grad_(), qkv.clone().requires_grad_()
    attention.causal_attention(got, 3).backward(dout)
    attention.causal_attention_ref(want, 3).backward(dout)
    assert within_ulps(got.grad, want.grad, 2)

    x, dy, gain = _normal((7, 100), 15, cuda), _normal((7, 100), 16, cuda), _normal((100,), 17, cuda)
    gx, wx = x.clone().requires_grad_(), x.clone().requires_grad_()
    gg, wg = gain.clone().requires_grad_(), gain.clone().requires_grad_()
    rmsnorm.rmsnorm(gx, gg).backward(dy)
    rmsnorm.rmsnorm_ref(wx, wg).backward(dy)
    for g, w in ((gx.grad, wx.grad), (gg.grad, wg.grad)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6 * float(w.abs().max()))

    # the MLP against autograd of its plain composition: each gradient
    # within 2 bf16 ulps of its max (a bf16 product of dh_pre, which moves
    # by up to 2 ulps, summed in another order; autograd of the plain GELU
    # differentiates the tanh form)
    operands = (_normal((2, 9, 64), 18, cuda).bfloat16(),
                _normal((64, 96), 19, cuda, scale=3.0 / 8).bfloat16(),
                _normal((96, 48), 37, cuda, scale=0.1).bfloat16())
    dy = _normal((2, 9, 48), 38, cuda).bfloat16()
    got = [t.clone().requires_grad_() for t in operands]
    want = [t.clone().requires_grad_() for t in operands]
    mlp.mlp(*got).backward(dy)
    (gelu.gelu_tanh_ref(want[0] @ want[1]) @ want[2]).backward(dy)
    for g, w in zip(got, want):
        assert within_ulps(g.grad, w.grad, 2)

    logits = _normal((4, 9, 256), 20, cuda)
    targets = torch.randint(0, 256, (4, 9), generator=torch.Generator().manual_seed(21)).to(cuda)
    gl, wl = logits.clone().requires_grad_(), logits.clone().requires_grad_()
    ce.cross_entropy(gl, targets).backward()
    ce.cross_entropy_ref(wl, targets)[0].backward()
    torch.testing.assert_close(gl.grad, wl.grad, rtol=0, atol=1e-7)


def test_bf16_functions_match_autograd_of_plain(cuda):
    """``rmsnorm_to_bf16`` against autograd of the plain RMSNorm cast to
    bf16, and cross entropy on bf16 logits against autograd of the plain
    version on the widened logits (its gradient cast back): the outputs
    within 1 bf16 ulp and the loss within rtol 1e-5, the gradients within
    the f32 tolerances above (dx, dgain) and 1 bf16 ulp (dlogits)."""
    x, gain = _normal((7, 128), 25, cuda, scale=3.0), _normal((128,), 26, cuda)
    dy = _normal((7, 128), 27, cuda).bfloat16()
    got = [x.clone().requires_grad_(), gain.clone().requires_grad_()]
    want = [x.clone().requires_grad_(), gain.clone().requires_grad_()]
    y = rmsnorm.rmsnorm_to_bf16(*got)
    y_want = rmsnorm.rmsnorm_ref(*want).to(torch.bfloat16)
    assert y.dtype == torch.bfloat16 and _within_bf16_ulp(y, y_want)
    y.backward(dy)
    y_want.backward(dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.grad, w.grad, rtol=1e-5, atol=1e-6 * float(w.grad.abs().max()))

    logits = _normal((4, 9, 256), 28, cuda).bfloat16()
    targets = torch.randint(0, 256, (4, 9), generator=torch.Generator().manual_seed(29)).to(cuda)
    gl, wl = logits.clone().requires_grad_(), logits.clone().requires_grad_()
    loss = ce.cross_entropy(gl, targets)
    want_loss = ce.cross_entropy_ref(wl.float(), targets)[0]
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    loss.backward()
    want_loss.backward()
    assert gl.grad.dtype == torch.bfloat16 and _within_bf16_ulp(gl.grad, wl.grad)


def test_train_step_on_card_matches_cpu(cuda):
    """One step of ``train_entry()`` on the card against the same step on
    the CPU (the plain versions): the loss within 5e-5 and each parameter
    within lr x 4 bf16 ulps of its gradient's max |g| plus 1 f32 ulp."""
    fn, (params, tokens) = train_entry()
    config = demo.DemoConfig()
    cpu_params = demo.tree_map(lambda t: t.cpu(), params)
    new, loss = fn(params, tokens)
    want_loss, grads = demo.value_and_grad(cpu_params, tokens.cpu(), config)
    want_new, _ = fn(cpu_params, tokens.cpu())
    assert abs(float(loss) - float(want_loss)) <= 5e-5
    for n, w, p, g in zip(*map(demo.tree_leaves, (new, want_new, cpu_params, grads))):
        assert bool(((n.cpu() - w).abs() <= step_tolerance(p, g, config.learning_rate)).all())


def test_entry_pins_f32_accumulation_in_a_fresh_process(cuda):
    proc = subprocess.run(
        [sys.executable, "-c",
         "import torch\n"
         "from operator_forge_torch.entry import entry\n"
         "fn, args = entry()\n"
         "m = torch.backends.cuda.matmul\n"
         "assert not m.allow_bf16_reduced_precision_reduction and not m.allow_tf32\n"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr


# (query block, visiting block, carry) of one step on rank 2 of a 4-rank
# ring: the diagonal, an earlier block, a later (fully masked) block, and
# the ring's first step from m = -inf
RING_CASES = {
    "diagonal": (2, 2, "seen"), "earlier": (2, 1, "seen"),
    "later": (2, 3, "seen"), "first": (2, 2, "fresh"),
}


def ring_inputs(shape, case, device, dtype=torch.float32, seed=30):
    """q, k, v of one ring step and a carry, fresh or after the diagonal
    block of other keys (through the plain version)."""
    q, k, v, k0, v0 = (_normal(shape, seed + i, device).to(dtype) for i in range(5))
    b, h, s, d = shape
    carry = (torch.full((b, h, s, 1), -math.inf, device=device),
             torch.zeros(shape, device=device), torch.zeros((b, h, s, 1), device=device))
    my, origin, kind = RING_CASES[case]
    if kind == "seen":
        carry = ra.ring_step_ref(q, k0, v0, *carry, my, my)
    return (q, k, v, *carry), my, origin


@pytest.mark.parametrize("case", sorted(RING_CASES))
@pytest.mark.parametrize(
    "shape, dtype",
    [((8, 4, 16, 32), torch.float32), ((1, 4, 256, 32), torch.float32),
     ((2, 3, 17, 16), torch.float32), ((2, 3, 17, 16), torch.bfloat16),
     ((1, 2, 1024, 128), torch.float32), ((8, 4, 16, 32), torch.bfloat16),
     ((4, 4, 33, 32), torch.float32),
     # past the former caps: s 1025 and 2048 (scored twice), d 129 and 160
     ((1, 2, 1025, 32), torch.float32), ((1, 4, 2048, 32), torch.float32),
     ((1, 2, 64, 129), torch.float32), ((1, 2, 64, 160), torch.bfloat16),
     ((65536, 1, 2, 4), torch.float32),
     # the tiled kernel's edges: 4096 keys on one head, an unaligned head
     # with ragged tiles and chunks, the widest head it takes, bf16, more
     # than 65535 batches; and a head past it (the long kernel, kept)
     ((1, 1, 4096, 32), torch.float32), ((2, 2, 1100, 33), torch.float32),
     ((1, 2, 1088, 128), torch.float32), ((1, 2, 1030, 64), torch.bfloat16),
     ((1, 2, 1100, 129), torch.float32), ((65536, 1, 64, 4), torch.float32),
     # the wide kernel's edges: one under (the long kernel), at and one over
     # its first block of 64 keys; q streamed past heads of 256 and a second
     # output pass past 256 columns; bf16 heads of 200 (no 16-byte loads
     # in f32 terms, ragged tiles and chunks); the key walk split between
     # a cluster's two blocks from 256 keys (also ragged); heads of 3073 and
     # 4096, past the former cap, under and over a key chunk
     ((1, 2, 63, 256), torch.float32), ((1, 2, 64, 256), torch.float32),
     ((1, 2, 65, 257), torch.float32), ((2, 2, 130, 384), torch.float32),
     ((2, 2, 100, 200), torch.bfloat16), ((1, 2, 256, 256), torch.float32),
     ((1, 1, 300, 160), torch.float32), ((1, 1, 33, 3073), torch.float32),
     ((1, 1, 70, 4096), torch.bfloat16)],
)
def test_ring_step_kernel_matches_plain(cuda, shape, dtype, case):
    """The carry within rtol and atol 2e-5 of the plain version (f32 sums
    in another order, exp of another rounding; -inf in the same places), one launch a
    call, the same bits from two launches; a later block leaves the carry's
    bits as they were.  Past 1024 keys the atol is 2e-5 of each part's
    max (``carry_close(scaled=True)``): there the plain version's own f32
    sums lie further than 2e-5 from a float64 evaluation (``chip_smoke.py``
    prints both distances at 2048 keys)."""
    (q, k, v, *carry), my, origin = ring_inputs(shape, case, cuda, dtype)
    want = ra.ring_step_ref(q, k, v, *carry, my, origin)

    def step():
        return ra.ring_step(q, k, v, *(t.clone() for t in carry), my, origin)

    before = telemetry.value("kernels.ring_attention_step")
    got, same = run_twice(step)
    torch.cuda.synchronize()
    assert telemetry.value("kernels.ring_attention_step") == before + 2 and same
    for g, w in zip(got, want):
        assert carry_close(g, w, scaled=shape[2] > 1024)
    if case == "later":
        assert all(torch.equal(g, c) for g, c in zip(got, carry))


def ring_bwd_inputs(shape, case, device, dtype=torch.float32, seed=40):
    """The inputs of one backward ring step: q, k, v and dout, the final
    (m, den) of a forward over the case's blocks (the plain version), each
    row's D, and accumulators that already hold other blocks' sums."""
    (q, k, v, *carry), my, origin = ring_inputs(shape, case, device, dtype, seed)
    m, num, den = ra.ring_step_ref(q, k, v, *carry, my, origin)
    dout = _normal(shape, seed + 10, device).to(dtype)
    big_d = (dout.float() * (num / den)).sum(dim=-1, keepdim=True)
    acc = [_normal(shape, seed + 11 + i, device) for i in range(3)]
    return (q, k, v, dout, m, den, big_d), my, origin, acc


RING_BWD_SHAPES = [
    ((8, 4, 16, 32), torch.float32), ((8, 4, 16, 32), torch.bfloat16),
    ((1, 4, 256, 32), torch.float32), ((2, 3, 17, 16), torch.float32),
    ((2, 3, 17, 16), torch.bfloat16), ((1, 4, 2048, 32), torch.float32),
    ((1, 2, 64, 160), torch.float32), ((65536, 1, 2, 4), torch.float32),
    # the tiled kernel's edges, one under, at and one over each: its first
    # block (64 keys), three 32-row tiles (96) and two 64-row chunks (128)
    # on 32-row tiles, two 64-row tiles (128) on 64-row tiles (128 heads,
    # whose diagonal blocks pair tiles, an odd count at 129)
    ((1, 1, 63, 32), torch.float32), ((1, 1, 64, 32), torch.float32),
    ((1, 1, 65, 32), torch.float32), ((1, 2, 95, 32), torch.float32),
    ((1, 2, 96, 32), torch.float32), ((1, 2, 97, 32), torch.float32),
    ((1, 2, 127, 32), torch.float32), ((1, 2, 128, 32), torch.float32),
    ((1, 2, 129, 32), torch.float32), ((16, 8, 127, 32), torch.float32),
    ((16, 8, 128, 32), torch.float32), ((16, 8, 129, 32), torch.float32),
    # a tile's chunks shared by the two blocks of a cluster from 4 chunks
    # (256 keys; 257 splits 3 and 2), also on wide and bf16 heads
    ((1, 1, 255, 32), torch.float32), ((1, 1, 256, 32), torch.float32),
    ((1, 1, 257, 32), torch.float32), ((1, 1, 300, 100), torch.float32),
    ((1, 2, 300, 48), torch.bfloat16),
    # heads on the tiled kernel: not a multiple of 4 (no 16-byte copies),
    # bf16 (widened as staged), odd, the widest (128, and on 64-row tiles,
    # whose other side then has one buffer) and one past it (the row kernel)
    ((1, 2, 150, 20), torch.float32), ((1, 2, 160, 64), torch.bfloat16),
    ((2, 2, 100, 33), torch.bfloat16), ((1, 2, 128, 128), torch.float32),
    ((8, 8, 130, 100), torch.float32), ((16, 8, 128, 128), torch.float32),
    ((1, 2, 128, 129), torch.float32),
    # the wide kernel's edges: one under (the row kernel), at and one over
    # its first block of 64 rows; a second output pass past 256 columns;
    # bf16 heads of 200, ragged tiles and chunks; a tile's chunks split
    # between a cluster's two blocks from 256 rows (also ragged); heads of
    # 3073 and 4096, past the former cap, under a chunk (the wide kernel
    # under 64 rows past heads of 256) and over one
    ((1, 2, 63, 256), torch.float32), ((1, 2, 64, 256), torch.float32),
    ((1, 2, 65, 257), torch.float32), ((2, 2, 130, 384), torch.float32),
    ((2, 2, 100, 200), torch.bfloat16), ((1, 2, 256, 256), torch.float32),
    ((1, 1, 300, 160), torch.float32), ((1, 1, 33, 3073), torch.float32),
    ((1, 1, 70, 4096), torch.bfloat16),
]


@pytest.mark.parametrize("case", sorted(RING_CASES))
@pytest.mark.parametrize("shape, dtype", RING_BWD_SHAPES)
def test_ring_step_bwd_kernel_matches_plain(cuda, shape, dtype, case):
    """dq, dk and dv within rtol 2e-5 and atol 2e-5 of each one's max
    (``grads_close``), one launch a call, the same bits from two launches;
    a later block leaves the accumulators' bits as they were."""
    inputs, my, origin, acc = ring_bwd_inputs(shape, case, cuda, dtype)
    want = ra.ring_step_bwd_ref(*inputs, my, origin, *acc)

    def step():
        return ra.ring_step_bwd(*inputs, my, origin, *(t.clone() for t in acc))

    before = telemetry.value("kernels.ring_attention_step_bwd")
    got, same = run_twice(step)
    torch.cuda.synchronize()
    assert telemetry.value("kernels.ring_attention_step_bwd") == before + 2 and same
    for g, w in zip(got, want):
        assert grads_close(g, w)
    if case == "later":
        assert all(torch.equal(g, a) for g, a in zip(got, acc))


@pytest.fixture
def nccl_one(cuda, tmp_path):
    """A process group of one rank on NCCL, for the ring's collectives."""
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}",
                            rank=0, world_size=1)
    yield init_device_mesh("cuda", (1,), mesh_dim_names=("seq",))
    dist.destroy_process_group()


@pytest.mark.parametrize("shape", [(8, 4, 64, 32), (1, 4, 1024, 32), (2, 2, 1100, 16), (1, 2, 512, 256)])
def test_ring_attention_gradient_matches_dense(nccl_one, shape):
    """``backward()`` through ``ring_attention`` on the group of one: one
    backward step, its gradient within rtol 2e-5 and atol 2e-5 of each
    gradient's max of autograd through ``dense_causal_attention``."""
    q, k, v = (_normal(shape, 50 + i, "cuda").requires_grad_() for i in range(3))
    dout = _normal(shape, 53, "cuda")
    before = telemetry.value("kernels.ring_attention_step_bwd")
    demo.ring_attention(q, k, v, nccl_one, axis="seq").backward(dout)
    torch.cuda.synchronize()
    assert telemetry.value("kernels.ring_attention_step_bwd") == before + 1
    got = [t.grad for t in (q, k, v)]
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    demo.dense_causal_attention(q2, k2, v2).backward(dout)
    for g, w in zip(got, (q2.grad, k2.grad, v2.grad)):
        assert grads_close(g, w)


def _same_tree(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(demo.tree_leaves(a), demo.tree_leaves(b)))


def test_jitted_forward_gives_the_eager_bits(cuda):
    """``jit`` of ``entry()``'s forward captures once and gives each
    request the eager forward's bits; the logits the first call returned
    are unchanged by the second."""
    fn, (params, tokens) = entry()
    other = torch.randint(0, 256, tokens.shape, generator=torch.Generator().manual_seed(7)).to(cuda)
    jitted = jit(fn)
    first = jitted(params, tokens)
    kept = first.clone()
    second = jitted(params, other)
    assert len(jitted.captures) == 1
    assert torch.equal(first, kept) and not torch.equal(first, second)
    assert torch.equal(first, fn(params, tokens)) and torch.equal(second, fn(params, other))


def test_jitted_train_step_gives_the_eager_bits(cuda):
    """``jit`` of ``train_entry()``'s step, chained over 3 steps: each
    step's loss and parameters are the eager chain's bits, and what a call
    returned is unchanged by the next.  A batch of 4 is a second signature:
    a second capture, with the eager bits too."""
    fn, (params, tokens) = train_entry()
    jitted = jit(fn)
    eager = got = params
    returned = []
    for _ in range(3):
        eager, want_loss = fn(eager, tokens)
        got, loss = jitted(got, tokens)
        assert torch.equal(loss, want_loss) and _same_tree(got, eager)
        returned.append((got, loss, demo.tree_map(torch.clone, got), loss.clone()))
    for got, loss, got_copy, loss_copy in returned:
        assert torch.equal(loss, loss_copy) and _same_tree(got, got_copy)
    half = tokens[:4].contiguous()
    got, loss = jitted(params, half)
    want, want_loss = fn(params, half)
    assert len(jitted.captures) == 2
    assert torch.equal(loss, want_loss) and _same_tree(got, want)


def test_jitted_sharded_step_on_nccl_one_gives_train_steps_bits(nccl_one):
    """``sharded_train_step`` on the (1, 1) mesh of an NCCL group of one,
    captured with its collectives: 3 chained steps give the bits of its
    plain ``step`` and of ``train_step``."""
    config = demo.DemoConfig()
    _, (params, tokens) = train_entry()
    mesh = demo.make_mesh(1)
    step = demo.sharded_train_step(mesh, config)
    local = eager = demo.shard_params(params, config, mesh)
    single = params
    for _ in range(3):
        local, loss = step(local, tokens)
        eager, eager_loss = step.fn(eager, tokens)
        single, single_loss = demo.train_step(single, tokens, config)
        assert torch.equal(loss, eager_loss) and torch.equal(loss, single_loss)
        assert _same_tree(local, eager) and _same_tree(demo.gather_params(local, config, mesh), single)
    assert len(step.captures) == 1


def test_jit_raises_where_the_function_syncs_the_host(cuda):
    """A function that copies a value to the host (``.item()``) cannot be
    captured: ``jit`` raises at every call, keeps no capture and returns
    no eager result in its place; the card works on after it."""
    calls = []

    def fn(x):
        calls.append(x)
        return x * x.sum().item()

    jitted = jit(fn)
    x = torch.ones(4, device=cuda)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            jitted(x)
    assert jitted.captures == {} and len(calls) == 2 * (WARMUP_CALLS + 1)
    assert torch.equal(fn(x), torch.full((4,), 4.0, device=cuda))


def test_jit_counts_calls_replays_captures_and_copied_bytes(cuda):
    """``telemetry`` counts each call, replay and capture of a jitted
    forward, the bytes copied in and out (arguments and logits) a call and
    each capture's seconds; a wrapper's launches are those of the warm-up
    and capture calls, never a replay's.  With no profiler session open no
    device mark is read."""
    fn, (params, tokens) = entry()
    half = tokens[:4].contiguous()
    jitted = jit(fn)
    telemetry.reset()
    for _ in range(3):
        logits = jitted(params, tokens)
    half_logits = jitted(params, half)
    snap = telemetry.snapshot()
    counters = snap["counters"]
    weights = nbytes(demo.tree_leaves(params))
    copied = 3 * (weights + nbytes([tokens, logits])) + weights + nbytes([half, half_logits])
    assert (counters["jit.calls"], counters["jit.replays"], counters["jit.captures"]) == (4, 4, 2)
    assert counters["jit.copy_bytes"] == copied
    assert counters["jit.warmup_s"] > 0 and counters["jit.capture_s"] > 0
    launches = 2 * (WARMUP_CALLS + 1) * demo.DemoConfig().n_layers
    assert counters["kernels.causal_attention"] == launches
    assert snap["device"] == {} and snap["skipped"] == 0


# How long a profiled call waits inside the profiler's window at each end.
# The profiler keeps only device activities whose times, converted to the
# host's clock, fall inside its window; on the card that conversion can put
# a kernel's start before the launch call that made it, and a call made as
# soon as the window opens then falls outside it, leaving the trace empty
# (the benchmark's traced stretch keeps the same guard, ``portbench/trace.py``).
PROFILE_MARGIN_S = 0.01


def _cuda_kernels(fn) -> list[str]:
    """Names of the device activities the profiler records in one call of
    ``fn``, after one call outside the trace (the build, the first
    launch); the call runs ``PROFILE_MARGIN_S`` inside the profiler's
    window at each end."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        time.sleep(PROFILE_MARGIN_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def test_rmsnorm_bwd_is_one_kernel(cuda):
    """One call of ``rmsnorm_bwd`` runs one CUDA kernel: dx and dgain come
    from one launch, with no second pass and no copy."""
    x, dy = _normal((512, 128), 22, cuda), _normal((512, 128), 23, cuda)
    gain = _normal((128,), 24, cuda)
    kernels = _cuda_kernels(lambda: rmsnorm.rmsnorm_bwd(x, gain, dy))
    assert len(kernels) == 1, kernels


def test_rmsnorm_to_bf16_bwd_is_one_kernel_at_the_cells_shape(cuda):
    """At Pythia-1.4B's ``[8192, 2048]``, ``rmsnorm_to_bf16``'s backward
    runs one CUDA kernel, the backward's: no cast of dy, no memset of the
    scratch or the counters."""
    x, dy, gain = _rmsnorm_bwd_inputs((8192, 2048), 49, cuda)
    live = x.requires_grad_(), gain.requires_grad_()
    y = rmsnorm.rmsnorm_to_bf16(*live)
    kernels = _cuda_kernels(lambda: torch.autograd.grad(y, live, dy, retain_graph=True))
    assert len(kernels) == 1 and "rmsnorm_bwd_kernel" in kernels[0], kernels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows, vocab", [(512, 256), (64, 32000)])
def test_cross_entropy_is_one_kernel_each_way(cuda, rows, vocab, dtype):
    """One call of the forward runs one CUDA kernel, the mean included,
    and one of the backward one kernel."""
    logits = _normal((rows, vocab), 30, cuda, scale=2.0).to(dtype)
    targets = torch.randint(0, vocab, (rows,), generator=torch.Generator().manual_seed(31)).to(cuda)
    kernels = _cuda_kernels(lambda: ce.cross_entropy_fwd(logits, targets))
    assert len(kernels) == 1, kernels
    lse = ce.cross_entropy_fwd(logits, targets)[1]
    grad = torch.ones((), device=cuda)
    kernels = _cuda_kernels(lambda: ce.cross_entropy_bwd(logits, targets, lse, grad))
    assert len(kernels) == 1, kernels


def test_rmsnorm_to_bf16_is_one_kernel_with_no_cast_after_it(cuda):
    """``rmsnorm_to_bf16`` runs one CUDA kernel, and the product that
    reads its output runs no elementwise kernel (a cast) before cuBLAS's."""
    x, gain = _normal((512, 128), 32, cuda), _normal((128,), 33, cuda)
    w = _normal((128, 384), 34, cuda).bfloat16()
    kernels = _cuda_kernels(lambda: rmsnorm.rmsnorm_to_bf16(x, gain))
    assert len(kernels) == 1, kernels
    kernels = _cuda_kernels(lambda: demo._bf16_matmul(rmsnorm.rmsnorm_to_bf16(x, gain), w))
    assert sum("rmsnorm" in k for k in kernels) == 1, kernels
    assert not any("elementwise" in k for k in kernels), kernels


def test_mlp_runs_no_kernel_between_its_products(cuda):
    """The MLP's forward and backward run one hand kernel each and, beside
    them, only the products (no elementwise kernel: no GELU, no cast)."""
    operands = [_normal(shape, 39 + i, cuda, scale=0.1).bfloat16().requires_grad_()
                for i, shape in enumerate(((8, 64, 128), (128, 512), (512, 128)))]
    dy = _normal((8, 64, 128), 42, cuda).bfloat16()
    kernels = _cuda_kernels(lambda: torch.autograd.grad(mlp.mlp(*operands), operands, dy))
    assert sum("mlp_kernel" in k for k in kernels) == 2, kernels
    assert not any("elementwise" in k or "gelu" in k.lower() for k in kernels), kernels


def test_mlp_kernels_replay_from_a_cuda_graph(cuda):
    """A CUDA graph of both kernels, replayed twice, gives the eager
    outputs' bits each time: at DemoConfig()'s shape (the mma.sync design)
    and at GPT-2 medium's cell's (the wgmma design, its tensor maps captured
    as launch parameters)."""
    for m, k, n in ((512, 128, 512), (16384, 1024, 4096)):
        x, w1 = _mlp_fwd_inputs(m, k, n, cuda)
        dy, w2, h_pre = _mlp_bwd_inputs(m, k, n, cuda)
        eager = (*mlp.matmul_gelu(x, w1), mlp.matmul_gelu_bwd(dy, w2, h_pre))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = (*mlp.matmul_gelu(x, w1), mlp.matmul_gelu_bwd(dy, w2, h_pre))
        for _ in range(2):
            for t in replayed:
                t.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(replayed, eager)), (m, k, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_entropy_replays_from_a_cuda_graph(cuda, dtype):
    """A CUDA graph of the forward, replayed twice, gives the eager loss's
    bits each time: the last block sets its ticket counter back to 0."""
    logits = _normal((512, 256), 35, cuda, scale=2.0).to(dtype)
    targets = torch.randint(0, 256, (512,), generator=torch.Generator().manual_seed(36)).to(cuda)
    eager = ce.cross_entropy_fwd(logits, targets)[0].clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ce.cross_entropy_fwd(logits, targets)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loss, _ = ce.cross_entropy_fwd(logits, targets)
    for _ in range(2):
        loss.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(loss, eager)
    assert torch.equal(ce.cross_entropy_fwd(logits, targets)[0], eager)


@pytest.mark.parametrize(
    "case, shape",
    [pytest.param(case, shape, id=case if shape == (8, 4, 16, 32) else f"{case}-{'x'.join(map(str, shape))}")
     for shape in ((8, 4, 16, 32), (1, 4, 1024, 256)) for case in ("earlier", "later")],
)
def test_ring_step_is_one_kernel(cuda, case, shape):
    """One call of ``ring_step`` runs one CUDA kernel, also for a later
    block, whose blocks exit at once, and at heads of 256."""
    (q, k, v, *carry), my, origin = ring_inputs(shape, case, cuda)
    kernels = _cuda_kernels(lambda: ra.ring_step(q, k, v, *carry, my, origin))
    assert len(kernels) == 1, kernels


@pytest.mark.parametrize("shape, case, kernel", [
    ((8, 4, 16, 32), "earlier", "ring_step_kernel<float>"),
    ((8, 4, 64, 32), "diagonal", "ring_step_kernel<float>"),
    ((1, 4, 256, 32), "earlier", "ring_step_tiled_kernel<float, 8, 2>"),
    ((1, 4, 1024, 32), "diagonal", "ring_step_tiled_kernel<float, 8, 2>"),
    ((1, 4, 2048, 32), "earlier", "ring_step_tiled_kernel<float, 8, 2>"),
    ((1, 4, 4096, 32), "diagonal", "ring_step_tiled_kernel<float, 16, 2>"),
    ((1, 2, 1030, 64), "earlier", "ring_step_tiled_kernel<float, 8, 4>"),
    ((1, 2, 1088, 128), "diagonal", "ring_step_tiled_kernel<float, 8, 8>"),
    ((65536, 1, 64, 4), "earlier", "ring_step_tiled_kernel<float, 16, 2>"),
    ((1, 2, 1100, 129), "earlier", "ring_step_wide_kernel<float, true>"),
    ((1, 4, 1024, 256), "earlier", "ring_step_wide_kernel<float, true>"),
    ((1, 2, 63, 256), "earlier", "ring_step_long_kernel<float>"),
    ((1, 1, 33, 257), "diagonal", "ring_step_wide_kernel<float, false>"),
    ((65536, 1, 2, 4), "earlier", "ring_step_long_kernel<float>"),
])
def test_ring_step_path_by_shape(cuda, shape, case, kernel):
    """Which kernel a shape takes: the row kernel under 256 keys; tiles
    from there, 32 rows where 64-row tiles give fewer than 256 blocks, 2,
    4 or 8 columns a thread, and from 64 keys for more than 65535 batches
    or heads; the wide kernel for heads over 128 from 64 keys, q staged up
    to heads of 256 and streamed past them (at any block); the long kernel
    under 64 keys for heads of 129 to 256 and for more than 65535 batches
    or heads."""
    (q, k, v, *carry), my, origin = ring_inputs(shape, case, cuda)
    kernels = _cuda_kernels(lambda: ra.ring_step(q, k, v, *carry, my, origin))
    assert len(kernels) == 1 and kernel in kernels[0], kernels


@pytest.mark.parametrize("shape", [(8, 4, 16, 32), (1, 4, 4096, 32), (1, 4, 1024, 256)])
def test_ring_step_replays_from_a_cuda_graph(cuda, shape):
    """A CUDA graph of one step, replayed twice on the same carry, gives
    the eager step's bits each time: the launch makes no host sync and
    keeps no state between calls."""
    (q, k, v, *carry), my, origin = ring_inputs(shape, "diagonal", cuda)
    eager = ra.ring_step(q, k, v, *(t.clone() for t in carry), my, origin)
    live = [t.clone() for t in carry]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ra.ring_step(q, k, v, *live, my, origin)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ra.ring_step(q, k, v, *live, my, origin)
    for _ in range(2):
        for t, c in zip(live, carry):
            t.copy_(c)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(live, eager))


@pytest.mark.parametrize("shape", [(8, 4, 16, 32), (1, 4, 1024, 256)])
def test_ring_step_bwd_replays_from_a_cuda_graph(cuda, shape):
    """A CUDA graph of one backward step, replayed twice on the same
    accumulators, gives the eager step's bits each time."""
    inputs, my, origin, acc = ring_bwd_inputs(shape, "earlier", cuda)
    eager = ra.ring_step_bwd(*inputs, my, origin, *(t.clone() for t in acc))
    live = [t.clone() for t in acc]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ra.ring_step_bwd(*inputs, my, origin, *live)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ra.ring_step_bwd(*inputs, my, origin, *live)
    for _ in range(2):
        for t, a in zip(live, acc):
            t.copy_(a)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(live, eager))


@pytest.mark.parametrize(
    "case, shape",
    [pytest.param(case, shape, id=case if shape == (8, 4, 16, 32) else f"{case}-{'x'.join(map(str, shape))}")
     for shape in ((8, 4, 16, 32), (1, 4, 1024, 256)) for case in ("earlier", "later")],
)
def test_ring_step_bwd_is_one_kernel(cuda, case, shape):
    """One call of ``ring_step_bwd`` runs one CUDA kernel (every role in
    one grid), also for a later block, and at heads of 256."""
    inputs, my, origin, acc = ring_bwd_inputs(shape, case, cuda)
    kernels = _cuda_kernels(lambda: ra.ring_step_bwd(*inputs, my, origin, *acc))
    assert len(kernels) == 1, kernels


@pytest.mark.parametrize("shape, case, kernel", [
    ((8, 4, 16, 32), "earlier", "ring_step_bwd_kernel<float>"),
    ((1, 1, 63, 32), "diagonal", "ring_step_bwd_kernel<float>"),
    ((1, 1, 64, 32), "earlier", "ring_step_bwd_tiled_kernel<float, 8, 2>"),
    ((1, 4, 1024, 32), "diagonal", "ring_step_bwd_tiled_kernel<float, 8, 2>"),
    ((1, 4, 2048, 32), "earlier", "ring_step_bwd_tiled_kernel<float, 16, 2>"),
    ((1, 4, 4096, 32), "diagonal", "ring_step_bwd_tiled_kernel<float, 16, 2>"),
    ((2, 2, 100, 33), "earlier", "ring_step_bwd_tiled_kernel<float, 8, 4>"),
    ((16, 8, 128, 128), "diagonal", "ring_step_bwd_tiled_kernel<float, 16, 8>"),
    ((1, 2, 128, 129), "earlier", "ring_step_bwd_wide_kernel<float>"),
    ((1, 4, 1024, 256), "diagonal", "ring_step_bwd_wide_kernel<float>"),
    ((1, 2, 63, 256), "diagonal", "ring_step_bwd_kernel<float>"),
    ((1, 1, 33, 3073), "earlier", "ring_step_bwd_wide_kernel<float>"),
])
def test_ring_step_bwd_path_by_shape(cuda, shape, case, kernel):
    """Which kernel a shape takes: the row kernel below 64 keys up to heads
    of 256; tiles of 32 rows; 64 rows where their grid (pairs of tiles on
    the diagonal) has 256 blocks; 2, 4 or 8 columns a thread; the wide
    kernel for heads over 128 from 64 keys, and at any block past heads of
    256."""
    inputs, my, origin, acc = ring_bwd_inputs(shape, case, cuda)
    kernels = _cuda_kernels(lambda: ra.ring_step_bwd(*inputs, my, origin, *acc))
    assert len(kernels) == 1 and kernel in kernels[0], kernels


# Profiled after the other kernels' path tests, with them: the profiler
# puts the card's activities on the host's clock by a conversion it sets up
# at its first session in the process, and the conversion drifts as the
# process runs on (past ``PROFILE_MARGIN_S`` some 35 s after that session
# on an H100), so the profiled tests keep together, within seconds of the
# first session.
@pytest.mark.parametrize(
    "shape, tiles, args",
    [((8, 64, 4, 32), True, "32, true"),
     ((1, 2048, 4, 32), True, "32, false"),
     ((1, 2048, 16, 128), True, ("128, false", "128")),
     ((1, 1024, 2, 128), True, "128, false"),
     ((1, 4000, 1, 64), False, "64, 64, 2"), ((1, 4096, 4, 128), False, "128, 128, 2"),
     ((1, 3000, 6, 128), False, "128, 128, 1"),
     ((2, 128, 2, 256), False, ("256, 256, 2", "256, 128, 2")),
     ((2, 33, 2, 200), False, ("256, 256, 2", "256, 128, 2")),
     ((1, 8, 1, 3073), False, "64, 128, 2"), ((65536, 2, 1, 8), False, "16, 16, 1")],
)
def test_attention_path_by_shape(cuda, shape, tiles, args):
    """The tiles path takes the main path's shapes and seq 2048 of 32-wide
    heads; the stream path a row whose spilled scores overflow shared
    memory, heads wider than 128 (one score chunk up to heads of 256, else
    chunks of 64 columns; output passes of 128) and more than 65535
    batches, with two groups of warps a block on a grid of fewer than two
    blocks an SM (then a head of 256 takes the forward's and dQ's output
    in one pass of 256 columns; dK and dV keep 128).  Either path is one
    forward kernel and two backward kernels, named by path and template
    arguments (the padded head, one chunk or more; score and output
    columns, groups): one set for all three, or the forward's and dQ's,
    then dK and dV's.  On the tiles path a row of more than one chunk with
    a head of 64 or 128 takes dQ's long-row design (the padded head alone)
    where the grid of 64-row tiles fills half the SMs, counted by
    ``kernels.causal_attention_bwd.rows64``; a smaller grid (32 blocks of 64
    rows at ``(1, 1024, 2, 128)``) or a narrower head (``(1, 2048, 4, 32)``)
    keeps the 16-row tiles."""
    assert attention.tiles(*shape) == tiles
    b, s, n_heads, head_dim = shape
    qkv = _normal((b, s, 3 * n_heads * head_dim), 40, cuda).bfloat16()
    dout = _normal((b, s, n_heads * head_dim), 41, cuda).bfloat16()
    first, last = (args, args) if isinstance(args, str) else args
    if tiles:
        names = (f"causal_attention_kernel<{first}>", f"causal_attention_bwd_dq_kernel<{last}>",
                 f"causal_attention_bwd_dkv_kernel<{first.split(',')[0]}>")
    else:
        names = (f"attention_stream_kernel<{first}>", f"attention_stream_dq_kernel<{first}>",
                 f"attention_stream_dkv_kernel<{last}>")
    fwd = _cuda_kernels(lambda: attention.causal_attention_fwd(qkv, n_heads))
    rows64 = telemetry.value("kernels.causal_attention_bwd.rows64")
    bwd = _cuda_kernels(lambda: attention.causal_attention_bwd(qkv, dout, n_heads))
    assert len(fwd) == 1 and names[0] in fwd[0], fwd
    assert len(bwd) == 2 and names[1] in bwd[0] and names[2] in bwd[1], bwd
    long_rows = tiles and first != last
    assert attention.rows64(*shape) == long_rows
    assert telemetry.value("kernels.causal_attention_bwd.rows64") == rows64 + 2 * long_rows


@pytest.mark.parametrize("path", ["forward", "train_step"])
def test_jitted_replay_runs_the_ports_kernels(cuda, path):
    """One call of a captured path, its kernels counted by name
    (``kernels.wrapper_call``): each wrapper's kernel as many times as the
    eager path launches it (a layer's attention, its two RMSNorms and its
    MLP, then cross entropy, forward and backward)."""
    layers = demo.DemoConfig().n_layers
    fn, args = entry() if path == "forward" else train_entry()
    want = {"causal_attention": layers, "rmsnorm": 2 * layers, "matmul_gelu": layers}
    if path == "train_step":
        want.update({f"{name}_bwd": count for name, count in want.items()},
                    cross_entropy=1, cross_entropy_bwd=1)
    jitted = jit(fn)
    names = _cuda_kernels(lambda: jitted(*args))
    assert len(jitted.captures) == 1
    assert collections.Counter(filter(None, map(wrapper_call, names))) == want, names


def test_device_marks_of_a_replayed_step_add_up_to_its_busy_time(cuda):
    """Replays of a train step under the profiler: every replay's device
    marks are read (``step.forward``, ``step.backward``, ``step.update``
    and ``jit``'s copies, none skipped), and their sum comes within 3% of
    the profiler's busy time a call.  The step is ``DemoConfig()``'s at
    widths of 1024 over 1024 tokens (about 19 ms a call): at
    ``DemoConfig()``'s own 0.37 ms the card waits on the host's launches
    between kernels, and a mark counts that wait where busy time does not
    (1.49 times the busy time on an H100)."""
    config = demo.DemoConfig(vocab=8192, d_model=1024, n_heads=8, n_layers=2, d_ff=4096,
                             seq_len=1024, batch=8, learning_rate=1e-3)
    params = demo.init_params(config, torch.Generator().manual_seed(0), cuda)
    tokens = torch.randint(0, config.vocab, (config.batch, config.seq_len + 1),
                           generator=torch.Generator().manual_seed(1)).to(cuda)
    step = jit(lambda p, t: demo.train_step(p, t, config))
    calls = 10
    params, loss = step(params, tokens)
    loss.item()
    telemetry.reset()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(calls):
            params, loss = step(params, tokens)
            loss.item()
        time.sleep(PROFILE_MARGIN_S)
    snap = telemetry.snapshot()
    names = ("step.forward", "step.backward", "step.update", "jit.copy")
    assert {name: total["reads"] for name, total in snap["device"].items()} == dict.fromkeys(names, calls)
    assert snap["skipped"] == 0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, reach = 0.0, -math.inf
    for start, end in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    marked = sum(total["seconds"] for total in snap["device"].values())
    assert marked == pytest.approx(busy / 1e6, rel=0.03)


def _slices_close(got, want_of, rows: int, check) -> None:
    """``got`` against the plain version ``want_of`` on its first and last
    ``rows`` rows (the kernels are rowwise there)."""
    for part in (slice(0, rows), slice(-rows, None)):
        check(got[part], want_of(part))


@pytest.mark.parametrize("name", ["matmul_gelu", "matmul_gelu_bwd", "rmsnorm", "rmsnorm_bwd",
                                  "cross_entropy", "rmsnorm_bf16", "cross_entropy_bf16",
                                  "rmsnorm_bwd_grid"])
def test_kernel_past_2_31_values(cuda, name):
    """A tensor of more than 2**31 values, whose offsets need 64 bits: the
    kernel's rows (or values) at both ends within the tolerances above of
    the plain version on the same slices (bf16 outputs within 1 bf16 ulp
    of the plain value cast)."""
    g = torch.Generator(device="cuda").manual_seed(60)
    if name in ("matmul_gelu", "matmul_gelu_bwd"):
        # outputs of 2**31 + 32768 values: rows of 512, a depth of 16
        m, k, n = 2**31 // 512 + 64, 16, 512
        a = torch.randn(m, k, generator=g, device="cuda").bfloat16()
        if name == "matmul_gelu":
            w1 = (0.75 * torch.randn(k, n, generator=g, device="cuda")).bfloat16()
            h, h_pre = mlp.matmul_gelu(a, w1)
            for part in (slice(0, 4096), slice(-4096, None)):
                assert within_floored_ulps(h_pre[part], a[part] @ w1, 1)
                assert mlp.gelu_close(h[part], h_pre[part])
        else:
            w2 = (0.25 * torch.randn(n, k, generator=g, device="cuda")).bfloat16()
            h_pre = torch.randn(m, n, generator=g, device="cuda", dtype=torch.bfloat16) * 3
            got = mlp.matmul_gelu_bwd(a, w2, h_pre)
            _slices_close(got, lambda part: mlp.matmul_gelu_bwd_ref(a[part], w2, h_pre[part]), 4096,
                          lambda x, y: within_floored_ulps(x, y, 2) or pytest.fail("beyond 2 ulps"))
    elif name == "rmsnorm":
        x = torch.randn(2**31 // 16384 + 1, 16384, generator=g, device="cuda")
        gain = torch.randn(16384, generator=g, device="cuda")
        _slices_close(rmsnorm.rmsnorm(x, gain), lambda part: rmsnorm.rmsnorm_ref(x[part], gain), 64,
                      lambda a, b: torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6))
    elif name == "rmsnorm_bf16":
        x = torch.randn(2**31 // 128 + 1, 128, generator=g, device="cuda")
        gain = torch.randn(128, generator=g, device="cuda")
        got = rmsnorm.rmsnorm_to_bf16(x, gain)
        _slices_close(got, lambda part: rmsnorm.rmsnorm_ref(x[part], gain).to(torch.bfloat16), 4096,
                      lambda a, b: _within_bf16_ulp(a, b) or pytest.fail("beyond 1 bf16 ulp"))
    elif name in ("rmsnorm_bwd", "rmsnorm_bwd_grid"):
        # strided rows of 16384; rows of 8192 held in registers with a bf16
        # dy; both grids' blocks in waves
        d = 16384 if name == "rmsnorm_bwd" else 8192
        x = 3 * torch.randn(2**31 // d + 1, d, generator=g, device="cuda")
        dy = torch.randn(x.shape, generator=g, device="cuda")
        gain = torch.randn(d, generator=g, device="cuda")
        if name == "rmsnorm_bwd":
            dx, dgain = rmsnorm.rmsnorm_bwd(x, gain, dy)
        else:
            dy = dy.bfloat16()
            before = telemetry.value("kernels.rmsnorm_bwd")
            dx, dgain = rmsnorm.rmsnorm_bwd_bf16(x, gain, dy)
            assert telemetry.value("kernels.rmsnorm_bwd") == before + 1
            dy = dy.float()
        want_dx = rmsnorm.rmsnorm_bwd_ref(x[-64:], gain, dy[-64:])[0]
        torch.testing.assert_close(dx[-64:], want_dx, rtol=1e-5, atol=1e-6 * float(want_dx.abs().max()))
        # the plain dgain over every row, 4096 rows at a time, the chunks'
        # sums added in float64 (in f32 the 33 additions of sums near 1000
        # would round by about 1e-3 themselves)
        want = sum(rmsnorm.rmsnorm_bwd_ref(x[r:r + 4096], gain, dy[r:r + 4096])[1].double()
                   for r in range(0, len(x), 4096)).float()
        torch.testing.assert_close(dgain, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))
    else:
        logits = 2 * torch.randn(2**31 // 32000 + 1, 32000, generator=g, device="cuda")
        if name == "cross_entropy_bf16":
            logits = logits.bfloat16()
        targets = torch.randint(0, 32000, logits.shape[:1], generator=g, device="cuda")
        grad = torch.tensor(1.0, device="cuda")
        loss, lse = ce.cross_entropy_fwd(logits, targets)
        dlogits = ce.cross_entropy_bwd(logits, targets, lse, grad)
        # the plain loss over every row, 4096 rows at a time
        nll = sum(float(ce.cross_entropy_ref(logits[r:r + 4096], targets[r:r + 4096])[0])
                  * len(targets[r:r + 4096]) for r in range(0, len(targets), 4096))
        assert abs(float(loss) - nll / len(targets)) <= 1e-5 * abs(nll / len(targets))
        torch.testing.assert_close(lse[-64:], ce.cross_entropy_ref(logits[-64:], targets[-64:])[1],
                                   rtol=1e-5, atol=0)
        n = torch.tensor(float(len(targets)), device="cuda")
        for part in (slice(0, 64), slice(-64, None)):
            rows = logits[part].float()
            want = (torch.exp(rows - lse[part, None])
                    - torch.nn.functional.one_hot(targets[part], 32000).float()) * (grad / n)
            if name == "cross_entropy":
                torch.testing.assert_close(dlogits[part], want, rtol=0, atol=1e-7)
            else:
                assert dlogits.dtype == torch.bfloat16
                assert _within_bf16_ulp(dlogits[part], want.to(torch.bfloat16))


def test_dryrun_multichip_on_one_card(cuda):
    loss = dryrun_multichip(1)
    assert math.isfinite(loss) and abs(loss - math.log(256)) < 0.5


def test_dryrun_multichip_with_more_ranks_than_cards_raises(cuda):
    """NCCL takes one card a rank: two ranks on one card are refused
    before any rank starts."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"{n} ranks need {n} CUDA devices"):
        dryrun_multichip(n)
