"""Tanh-approximation GELU on bf16: a Triton kernel and its plain version.

Counterpart of ``jax.nn.gelu`` in ``operator_forge/tpu/demo.py::_mlp``
(line 98), whose default is the tanh form (``torch``'s default is erf).

Bound on an H100 SXM at DemoConfig() (h bf16 [512, 512]): it reads and
writes 262,144 bf16 values once, 1,048,576 B: 0.31 us at 3.35 TB/s; its
some 2.6 MFLOP of f32 arithmetic are nothing beside that.  At this size it
is bound by launch overhead.  Design: a flat elementwise pass, 1024 values
a program at 64-bit offsets (so 2**31 values or more are taken), bf16 in,
the formula in f32, one rounding to bf16 on the store.
``0.5 * (1 + tanh(u))`` is computed as ``1 / (1 + exp(-2u))``, the same
function with no cancellation near ``u = 0``.  Triton serves as well as
CUDA for a pure elementwise pass.

The backward is ``dx = bf16(f32(dy) * gelu'(f32(x)))``, with ``gelu'`` the
derivative of the same tanh form, written with ``s = sigmoid(2u)`` as
``s + 2x s (1 - s) c (1 + 3 * 0.044715 x²)``, ``c = sqrt(2 / pi)``: no
``1 + tanh`` to cancel.  JAX differentiates ``jax.nn.gelu`` on bf16 in bf16
steps; this follows the f32 formula rounded once, which is what autograd of
``gelu_tanh_ref`` gives (ROADMAP.md, Queue 3, has the divergence).  Its
bound at DemoConfig() (x, dy, dx bf16 [512, 512]): 1,572,864 B, 0.47 us at
3.35 TB/s.  Design: the forward's flat elementwise pass with two inputs.
``gelu_tanh`` ties the two directions together as an autograd ``Function``.
"""

from __future__ import annotations

import functools
import math

import torch

SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
BLOCK = 1024

launches = 0
bwd_launches = 0


def gelu_tanh_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``jax.nn.gelu``'s tanh formula in f32,
    rounded once to the input's type."""
    xf = x.float()
    cdf = 0.5 * (1.0 + torch.tanh(SQRT_2_OVER_PI * (xf + 0.044715 * (xf * xf * xf))))
    return (xf * cdf).to(x.dtype)


def gelu_tanh_bwd_ref(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward: ``dy * gelu'(x)`` in f32,
    rounded once to dy's type."""
    xf = x.float()
    s = torch.sigmoid(2.0 * SQRT_2_OVER_PI * (xf + 0.044715 * (xf * xf * xf)))
    slope = s + 2.0 * xf * s * (1.0 - s) * SQRT_2_OVER_PI * (1.0 + 3 * 0.044715 * xf * xf)
    return (dy.float() * slope).to(dy.dtype)


@functools.cache
def _kernel():
    # Triton resolves the names a kernel uses through its module's globals,
    # so ``tl`` is bound there, at the first launch rather than at import
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def gelu_kernel(x_ptr, y_ptr, n, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        inside = offs < n
        x = tl.load(x_ptr + offs, mask=inside, other=0.0).to(tl.float32)
        u = 0.7978845608028654 * (x + 0.044715 * (x * x * x))
        y = x / (1.0 + tl.exp(-2.0 * u))
        tl.store(y_ptr + offs, y.to(tl.bfloat16), mask=inside)

    @triton.jit
    def gelu_bwd_kernel(x_ptr, dy_ptr, dx_ptr, n, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        inside = offs < n
        x = tl.load(x_ptr + offs, mask=inside, other=0.0).to(tl.float32)
        dy = tl.load(dy_ptr + offs, mask=inside, other=0.0).to(tl.float32)
        u = 0.7978845608028654 * (x + 0.044715 * (x * x * x))
        s = 1.0 / (1.0 + tl.exp(-2.0 * u))
        slope = s + 2.0 * x * s * (1.0 - s) * 0.7978845608028654 * (1.0 + 0.134145 * x * x)
        tl.store(dx_ptr + offs, (dy * slope).to(tl.bfloat16), mask=inside)

    return triton, gelu_kernel, gelu_bwd_kernel


def gelu_tanh_fwd(x: torch.Tensor) -> torch.Tensor:
    """bf16 -> bf16 tanh GELU: the plain version for a CPU tensor, the
    Triton kernel for a CUDA tensor."""
    global launches
    if x.dtype != torch.bfloat16:
        raise ValueError(f"gelu_tanh takes bf16, got {x.dtype}")
    if x.device.type == "cpu":
        return gelu_tanh_ref(x)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("gelu_tanh's kernel takes a contiguous CUDA tensor")
    triton, kernel, _ = _kernel()
    y = torch.empty_like(x)
    n = x.numel()
    with torch.cuda.device(x.device):
        kernel[(triton.cdiv(n, BLOCK),)](x, y, n, BLOCK=BLOCK, num_warps=4)
    launches += 1
    return y


def gelu_tanh_bwd(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """bf16 ``x`` and ``dy`` -> bf16 ``dx`` of the tanh GELU: the plain
    version for CPU tensors, the Triton kernel for CUDA tensors."""
    global bwd_launches
    if x.dtype != torch.bfloat16 or dy.dtype != torch.bfloat16 or dy.shape != x.shape:
        raise ValueError(
            f"gelu_tanh_bwd takes bf16 x and dy of one shape, got {x.dtype} "
            f"{tuple(x.shape)} and {dy.dtype} {tuple(dy.shape)}"
        )
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return gelu_tanh_bwd_ref(x, dy)
    if (x.device.type != "cuda" or dy.device != x.device or not x.is_contiguous()
            or not dy.is_contiguous()):
        raise ValueError("gelu_tanh_bwd's kernel takes contiguous tensors on one CUDA device")
    triton, _, kernel = _kernel()
    dx = torch.empty_like(x)
    n = x.numel()
    with torch.cuda.device(x.device):
        kernel[(triton.cdiv(n, BLOCK),)](x, dy, dx, n, BLOCK=BLOCK, num_warps=4)
    bwd_launches += 1
    return dx


class GeluTanh(torch.autograd.Function):
    """``gelu_tanh_fwd`` with ``gelu_tanh_bwd`` as its gradient; saves the
    bf16 input."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return gelu_tanh_fwd(x)

    @staticmethod
    def backward(ctx, dy: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        return gelu_tanh_bwd(x, dy.contiguous())


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh GELU with a gradient, bf16 -> bf16: the forward kernel now and
    the backward kernel under ``backward()`` (the plain versions for CPU
    tensors)."""
    return GeluTanh.apply(x)
