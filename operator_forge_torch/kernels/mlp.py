"""The MLP's first product with the tanh GELU in its epilogue, and the
backward's product with the GELU's slope in its epilogue: CUDA kernels,
their plain versions, and the autograd Function over the whole MLP.

Counterpart of ``operator_forge/tpu/demo.py::_mlp`` (lines 96-99), bf16
operands as the reference casts them:

- ``matmul_gelu(x, w1)``: ``h_pre = bf16(x @ w1)`` and ``h =
  bf16(gelu(f32(h_pre)))``, ``w1`` stored ``(in, out)``;
- ``matmul_gelu_bwd(dy, w2, h_pre)``: ``dh_pre = bf16(f32(bf16(dy @ w2ᵀ))
  · gelu'(f32(h_pre)))``, the gradient that reaches ``h_pre`` through the
  ``w2`` product and the GELU.

Each product accumulates in f32 and rounds once, then the GELU or its slope
(``kernels/gelu.py``'s f32 formulas) rounds once more: the unfused
composition's two roundings.  The kernels are CUDA C++, ``csrc/mlp.cu``;
the source's note has their bound and their two designs: calls on
16-byte aligned rows of at least 512 tile steps take the persistent wgmma
design, which ``kernels.matmul_gelu.wgmma`` and
``kernels.matmul_gelu_bwd.wgmma`` count (the C side's ``mlp_wgmma`` rule,
asked after each launch), every other call the mma.sync design.  The plain versions are
``torch.matmul`` followed by ``gelu.gelu_tanh_ref`` or
``gelu.gelu_tanh_bwd_ref``.

``mlp(x, w1, w2)`` is the MLP ``gelu(x @ w1) @ w2`` as one autograd
``Function``, because the backward kernel spans two of autograd's nodes
(the ``w2`` product's and the GELU's).  Forward: ``matmul_gelu``, writing
``h_pre`` only when a gradient can be taken, then ``h @ w2``.  Backward:
``matmul_gelu_bwd``, then ``dx``, ``dw1`` and ``dw2`` by ``torch.matmul``,
shaped as autograd shapes the unfused composition's products, so that on
the CPU the gradients keep that composition's bits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import telemetry
from . import bf16_ulp, build
from .gelu import gelu_tanh_bwd_ref, gelu_tanh_ref


def matmul_gelu_ref(x: torch.Tensor, w1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(h, h_pre)``."""
    h_pre = x @ w1
    return gelu_tanh_ref(h_pre), h_pre


def matmul_gelu_bwd_ref(dy: torch.Tensor, w2: torch.Tensor, h_pre: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward: ``dh_pre``."""
    return gelu_tanh_bwd_ref(h_pre, dy @ w2.t())


def gelu_close(h: torch.Tensor, h_pre: torch.Tensor) -> bool:
    """Whether ``h`` lies within 1 bf16 ulp of max(|y|, 2**-8) of the
    plain GELU of ``h_pre``: the check of the kernel's ``h`` against its
    own ``h_pre``.  Both round an f32 value once, and the plain version's
    ``1 + tanh(u)`` cancels in f32 where |y| < 2**-8."""
    want = gelu_tanh_ref(h_pre).float()
    return bool(((h.float() - want).abs() <= bf16_ulp(want.abs().clamp_min(2.0**-8))).all())


def _on_cpu(what: str, kernel: str, **tensors: torch.Tensor) -> bool:
    """True where every tensor lies on the CPU (the plain version), False
    where all lie on one CUDA device, contiguous (the kernel); raise
    otherwise."""
    devices = {t.device for t in tensors.values()}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda" or not all(
            t.is_contiguous() for t in tensors.values()):
        raise ValueError(
            f"{what}'s kernel ({kernel}) takes contiguous tensors on one CUDA device, got "
            + ", ".join(f"{name} on {t.device}" for name, t in tensors.items())
        )
    return False


def _check_bf16(what: str, **tensors: torch.Tensor) -> None:
    if any(t.dtype != torch.bfloat16 for t in tensors.values()):
        raise ValueError(
            f"{what} takes bf16, got "
            + ", ".join(f"{name} {t.dtype}" for name, t in tensors.items())
        )


def matmul_gelu(x: torch.Tensor, w1: torch.Tensor,
                keep_pre: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
    """bf16 ``x [..., K]`` and ``w1 [K, N]`` -> ``(h, h_pre)``, each bf16
    ``[..., N]``; ``h_pre`` is None unless ``keep_pre``.  The plain version
    for CPU tensors, one launch of the CUDA kernel for CUDA tensors."""
    _check_bf16("matmul_gelu", x=x, w1=w1)
    if x.dim() < 1 or w1.dim() != 2 or x.shape[-1] != w1.shape[0] or min(
            x.numel(), w1.numel()) < 1:
        raise ValueError(
            f"matmul_gelu takes x [..., K] and w1 [K, N], none empty, got "
            f"{tuple(x.shape)} and {tuple(w1.shape)}"
        )
    if _on_cpu("matmul_gelu", "matmul_gelu_bf16", x=x, w1=w1):
        h, h_pre = matmul_gelu_ref(x, w1)
        return h, h_pre if keep_pre else None
    k, n = w1.shape
    shape = (*x.shape[:-1], n)
    h = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
    h_pre = torch.empty_like(h) if keep_pre else None
    lib = _library()
    with torch.cuda.device(x.device):
        status = lib.matmul_gelu_bf16(
            x.data_ptr(), w1.data_ptr(), h.data_ptr(), h_pre.data_ptr() if keep_pre else None,
            x.numel() // k, n, k, torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, status, "matmul_gelu")
    telemetry.count("kernels.matmul_gelu")
    if lib.mlp_wgmma(x.data_ptr(), w1.data_ptr(), h.data_ptr(),
                     h_pre.data_ptr() if keep_pre else None, x.numel() // k, n, k):
        telemetry.count("kernels.matmul_gelu.wgmma")
    return h, h_pre


def matmul_gelu_bwd(dy: torch.Tensor, w2: torch.Tensor, h_pre: torch.Tensor) -> torch.Tensor:
    """bf16 ``dy [..., D]``, ``w2 [N, D]`` and ``h_pre [..., N]`` ->
    bf16 ``dh_pre [..., N]``: the plain version for CPU tensors, one launch
    of the CUDA kernel for CUDA tensors."""
    _check_bf16("matmul_gelu_bwd", dy=dy, w2=w2, h_pre=h_pre)
    if (dy.dim() < 1 or w2.dim() != 2 or dy.shape[-1] != w2.shape[1]
            or tuple(h_pre.shape) != (*dy.shape[:-1], w2.shape[0])
            or min(dy.numel(), w2.numel()) < 1):
        raise ValueError(
            f"matmul_gelu_bwd takes dy [..., D], w2 [N, D] and h_pre [..., N], none empty, "
            f"got {tuple(dy.shape)}, {tuple(w2.shape)} and {tuple(h_pre.shape)}"
        )
    if _on_cpu("matmul_gelu_bwd", "matmul_gelu_bwd_bf16", dy=dy, w2=w2, h_pre=h_pre):
        return matmul_gelu_bwd_ref(dy, w2, h_pre)
    n, d = w2.shape
    dh_pre = torch.empty_like(h_pre)
    lib = _library()
    with torch.cuda.device(dy.device):
        status = lib.matmul_gelu_bwd_bf16(
            dy.data_ptr(), w2.data_ptr(), h_pre.data_ptr(), dh_pre.data_ptr(), dy.numel() // d,
            n, d, torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, status, "matmul_gelu_bwd")
    telemetry.count("kernels.matmul_gelu_bwd")
    if lib.mlp_wgmma(dy.data_ptr(), w2.data_ptr(), h_pre.data_ptr(), dh_pre.data_ptr(),
                     dy.numel() // d, n, d):
        telemetry.count("kernels.matmul_gelu_bwd.wgmma")
    return dh_pre


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.library("mlp")
    for entry in (lib.matmul_gelu_bf16, lib.matmul_gelu_bwd_bf16):
        entry.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_void_p]
        entry.restype = ctypes.c_int
    lib.mlp_wgmma.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    lib.mlp_wgmma.restype = ctypes.c_int
    return lib


class MLP(torch.autograd.Function):
    """``gelu(x @ w1) @ w2`` on bf16 ``x [..., K]``, ``w1 [K, N]`` and
    ``w2 [N, D]``, with ``matmul_gelu_bwd`` in its gradient.  Saves x, w1,
    w2, h_pre and h: what the unfused composition's three nodes save."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                keep_pre: bool) -> torch.Tensor:
        h, h_pre = matmul_gelu(x, w1, keep_pre)
        ctx.save_for_backward(x, w1, w2, h_pre, h)
        return h @ w2

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, w1, w2, h_pre, h = ctx.saved_tensors
        dy = dy.contiguous()
        dh_pre = matmul_gelu_bwd(dy, w2, h_pre)
        m, (k, n), d = dh_pre.numel() // w1.shape[1], w1.shape, w2.shape[1]
        need_x, need_w1, need_w2, _ = ctx.needs_input_grad
        dx = dh_pre @ w1.t() if need_x else None
        dw1 = x.reshape(m, k).t() @ dh_pre.reshape(m, n) if need_w1 else None
        dw2 = h.reshape(m, n).t() @ dy.reshape(m, d) if need_w2 else None
        return dx, dw1, dw2, None


def mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The MLP with a gradient: bf16 ``x [..., K]``, ``w1 [K, N]`` and
    ``w2 [N, D]`` -> bf16 ``[..., D]``; the GELU runs in the first
    product's kernel now and its slope in the backward product's kernel
    under ``backward()`` (the plain versions for CPU tensors).  ``h_pre``
    is written only where a gradient can be taken."""
    keep_pre = torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, w2))
    return MLP.apply(x, w1, w2, keep_pre)
