"""Causal softmax attention: the CUDA kernels ``csrc/causal_attention.cu``
(forward and backward) and their plain versions.

Counterpart of ``operator_forge/tpu/demo.py::_attention`` lines 79-92: it
takes the bf16 QKV product ``[b, s, 3d]`` and returns the bf16 attention
output ``[b, s, d]`` with the heads merged, ready for the ``wo`` product.
The kernels have two paths, chosen by shape in the source, both on the
tensor cores: the tiles path where a head is at most 128 wide, a row's
spilled scores fit in shared memory and the batch and heads fit the grid's
y and z; else the stream path, 64-row tiles that stream the other side
and the head in chunks, which takes any sequence, head width, batch and
head count (``tiles`` says which).
The backward takes that output's gradient and returns the gradient of the
QKV product, with the cast points of JAX's autodiff of the same lines, in
two launches: dQ with each row's softmax statistics, then dK and dV.  On
the tiles path dQ has two designs of one algorithm, chosen in the source
by what the launch can see: rows of at most 64 keys, or a grid of 64-row
tiles that would fill fewer than half the SMs, or heads of at most 32
columns or not a multiple of 8, take 16-row tiles of four warps; longer rows
take 64-row tiles, one warpgroup a tile, that stream K and V twice (the
statistics, then dQ) and recompute the scores rather than keep them, on
``wgmma`` and TMA (``rows64`` says which;
``kernels.causal_attention_bwd.rows64`` counts those calls).  At
Pythia-1.4B's ``[4, 2048, 16, 128]`` its five causal products bound it at
0.17 ms at 989 TFLOP/s, GPT-2 medium's ``[16, 1024, 16, 64]`` at 0.087 ms.
``causal_attention`` ties the forward and the backward together as an
autograd ``Function``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import telemetry
from . import build

MASK_FILL = -1e30  # finite, as in the reference: exp(MASK_FILL - max) == 0


def _heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, d = t.shape
    return t.reshape(b, s, n_heads, d // n_heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    b, h, s, head_dim = t.shape
    return t.transpose(1, 2).reshape(b, s, h * head_dim)


def _softmax_ref(q, k):
    """The f32 softmax ``y`` of the scaled, masked bf16 scores, the causal
    mask and the divisor ``sqrt(head_dim)``."""
    s, head_dim = q.shape[-2:]
    scores = (q @ k.transpose(-1, -2)).float()
    # a device tensor, not a Python float: CUDA turns division by a host
    # scalar into multiplication by its inverse, which rounds differently
    root = torch.tensor(head_dim, dtype=torch.float32, device=q.device).sqrt()
    scores = scores / root
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask, scores, MASK_FILL)
    unnormalized = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return unnormalized / unnormalized.sum(dim=-1, keepdim=True), mask, root


def causal_attention_ref(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Plain PyTorch version with the reference's cast points."""
    q, k, v = (_heads(t, n_heads) for t in qkv.chunk(3, dim=-1))
    probs, _, _ = _softmax_ref(q, k)
    return _merge(probs.to(torch.bfloat16) @ v)


def causal_attention_bwd_ref(
    qkv: torch.Tensor, dout: torch.Tensor, n_heads: int
) -> torch.Tensor:
    """Plain PyTorch version of the backward: bf16 ``dqkv [b, s, 3d]`` from
    bf16 ``dout [b, s, d]``, with the cast points of JAX's autodiff of
    ``demo.py:86-92`` (``jax.nn.softmax``'s JVP is ``y * (x' - sum(y x'))``)."""
    q, k, v = (_heads(t, n_heads) for t in qkv.chunk(3, dim=-1))
    d_out = _heads(dout, n_heads)
    y, mask, root = _softmax_ref(q, k)
    d_v = y.to(torch.bfloat16).transpose(-1, -2) @ d_out
    d_p = (d_out @ v.transpose(-1, -2)).float()
    big_d = (y * d_p).sum(dim=-1, keepdim=True)
    d_s = (torch.where(mask, y * (d_p - big_d), 0.0) / root).to(torch.bfloat16)
    d_q = d_s @ k
    d_k = d_s.transpose(-1, -2) @ q
    return torch.cat([_merge(d_q), _merge(d_k), _merge(d_v)], dim=-1)


def _check(qkv: torch.Tensor, n_heads: int) -> tuple[int, int, int]:
    if qkv.dtype != torch.bfloat16 or qkv.dim() != 3:
        raise ValueError(
            f"causal_attention takes bf16 [b, s, 3d], got {qkv.dtype} "
            f"{tuple(qkv.shape)}"
        )
    b, s, three_d = qkv.shape
    if n_heads < 1 or three_d % (3 * n_heads):
        raise ValueError(f"last dim {three_d} is not 3 * n_heads({n_heads}) * head_dim")
    head_dim = three_d // (3 * n_heads)
    if b < 1 or s < 1 or head_dim < 1:
        raise ValueError(f"causal_attention takes a non-empty batch, sequence and head, got "
                         f"b {b}, s {s}, head_dim {head_dim}")
    return b, s, head_dim


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.library("causal_attention")
    lib.causal_attention_bf16.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.causal_attention_bf16.restype = ctypes.c_int
    lib.causal_attention_bwd_bf16.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.causal_attention_bwd_bf16.restype = ctypes.c_int
    for entry in (lib.causal_attention_tiles, lib.causal_attention_bwd_rows64):
        entry.argtypes = [ctypes.c_int] * 4
        entry.restype = ctypes.c_int
    return lib


def tiles(b: int, s: int, n_heads: int, head_dim: int) -> bool:
    """Whether the kernels take a shape on the tiles path, the fast path
    of the main path's shapes, rather than the stream path (builds the
    kernels)."""
    return bool(_library().causal_attention_tiles(b, s, n_heads, head_dim))


@functools.cache
def rows64(b: int, s: int, n_heads: int, head_dim: int) -> bool:
    """Whether the backward's first launch takes 64-row tiles (rows of more
    than one chunk of 64 keys, heads padded to 64 or 128 of a multiple of 8
    columns, a 64-row grid that fills half the SMs) on 16-byte aligned
    tensors, rather than 16-row tiles or the stream path (builds the
    kernels)."""
    return bool(_library().causal_attention_bwd_rows64(b, s, n_heads, head_dim))


def causal_attention_fwd(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """bf16 ``[b, s, 3d]`` -> bf16 ``[b, s, d]``: the plain version for a
    CPU tensor, the CUDA kernel for a CUDA tensor."""
    b, s, head_dim = _check(qkv, n_heads)
    if qkv.device.type == "cpu":
        return causal_attention_ref(qkv, n_heads)
    if qkv.device.type != "cuda" or not qkv.is_contiguous():
        raise ValueError("causal_attention's kernel takes a contiguous CUDA tensor")
    lib = _library()
    out = torch.empty(b, s, n_heads * head_dim, dtype=torch.bfloat16, device=qkv.device)
    with torch.cuda.device(qkv.device):
        status = lib.causal_attention_bf16(
            qkv.data_ptr(), out.data_ptr(), b, s, n_heads, head_dim,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, status, "causal_attention")
    telemetry.count("kernels.causal_attention")
    return out


def causal_attention_bwd(
    qkv: torch.Tensor, dout: torch.Tensor, n_heads: int
) -> torch.Tensor:
    """bf16 ``qkv [b, s, 3d]`` and ``dout [b, s, d]`` -> bf16 ``dqkv
    [b, s, 3d]``: the plain version for CPU tensors, the CUDA kernels (two
    launches, counted once) for CUDA tensors."""
    b, s, head_dim = _check(qkv, n_heads)
    if dout.dtype != torch.bfloat16 or tuple(dout.shape) != (b, s, n_heads * head_dim):
        raise ValueError(
            f"causal_attention_bwd takes dout bf16 {(b, s, n_heads * head_dim)}, "
            f"got {dout.dtype} {tuple(dout.shape)}"
        )
    if qkv.device.type == "cpu" and dout.device.type == "cpu":
        return causal_attention_bwd_ref(qkv, dout, n_heads)
    if (qkv.device.type != "cuda" or dout.device != qkv.device
            or not qkv.is_contiguous() or not dout.is_contiguous()):
        raise ValueError(
            "causal_attention_bwd's kernel takes contiguous tensors on one CUDA device"
        )
    lib = _library()
    dqkv = torch.empty_like(qkv)
    # each row's softmax max and sum and its D = sum_k y dP, handed from the
    # first launch to the second: f32 [3, b, h, s], 24 KB at DemoConfig()
    stats = torch.empty(3, b, n_heads, s, dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        status = lib.causal_attention_bwd_bf16(
            qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
            b, s, n_heads, head_dim, torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, status, "causal_attention_bwd")
    telemetry.count("kernels.causal_attention_bwd")
    if rows64(b, s, n_heads, head_dim) and qkv.data_ptr() % 16 == dout.data_ptr() % 16 == 0:
        telemetry.count("kernels.causal_attention_bwd.rows64")
    return dqkv


class CausalAttention(torch.autograd.Function):
    """``causal_attention_fwd`` with ``causal_attention_bwd`` as its
    gradient; saves the QKV product."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
        ctx.save_for_backward(qkv)
        ctx.n_heads = n_heads
        return causal_attention_fwd(qkv, n_heads)

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        return causal_attention_bwd(qkv, dout.contiguous(), ctx.n_heads), None


def causal_attention(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Causal attention with a gradient: bf16 ``[b, s, 3d]`` -> bf16
    ``[b, s, d]``, the forward kernel now and the backward kernel under
    ``backward()`` (the plain versions for CPU tensors)."""
    return CausalAttention.apply(qkv, n_heads)
