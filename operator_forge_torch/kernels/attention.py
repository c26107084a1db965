"""Causal softmax attention: the CUDA kernel ``csrc/causal_attention.cu``
and its plain version.

Counterpart of ``operator_forge/tpu/demo.py::_attention`` lines 79-92: it
takes the bf16 QKV product ``[b, s, 3d]`` and returns the bf16 attention
output ``[b, s, d]`` with the heads merged, ready for the ``wo`` product.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

MAX_SEQ = 1024
MAX_HEAD_DIM = 128
MASK_FILL = -1e30  # finite, as in the reference: exp(MASK_FILL - max) == 0

launches = 0


def causal_attention_ref(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Plain PyTorch version with the reference's cast points."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    head_dim = d // n_heads
    q, k, v = (
        t.reshape(b, s, n_heads, head_dim).transpose(1, 2)
        for t in qkv.split(d, dim=-1)
    )
    scores = (q @ k.transpose(-1, -2)).float()
    # a device tensor, not a Python float: CUDA turns division by a host
    # scalar into multiplication by its inverse, which rounds differently
    root = torch.tensor(head_dim, dtype=torch.float32, device=qkv.device).sqrt()
    scores = scores / root
    mask = torch.ones(s, s, dtype=torch.bool, device=qkv.device).tril()
    scores = torch.where(mask, scores, MASK_FILL)
    unnormalized = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = unnormalized / unnormalized.sum(dim=-1, keepdim=True)
    out = probs.to(torch.bfloat16) @ v
    return out.transpose(1, 2).reshape(b, s, d)


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
    if not 1 <= s <= MAX_SEQ or head_dim > MAX_HEAD_DIM or b > 65535:
        raise ValueError(
            f"causal_attention takes seq <= {MAX_SEQ}, head_dim <= "
            f"{MAX_HEAD_DIM} and batch <= 65535; got b {b}, s {s}, head_dim {head_dim}"
        )
    return b, s, head_dim


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.library("causal_attention")
    lib.causal_attention_bf16.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.causal_attention_bf16.restype = ctypes.c_int
    return lib


def causal_attention(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """bf16 ``[b, s, 3d]`` -> bf16 ``[b, s, d]``: the plain version for a
    CPU tensor, the CUDA kernel for a CUDA tensor."""
    global launches
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
    launches += 1
    return out
