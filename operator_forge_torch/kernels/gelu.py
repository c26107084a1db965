"""Tanh-approximation GELU on bf16: a Triton kernel and its plain version.

Counterpart of ``jax.nn.gelu`` in ``operator_forge/tpu/demo.py::_mlp``
(line 98), whose default is the tanh form (``torch``'s default is erf).

Bound on an H100 SXM at DemoConfig() (h bf16 [512, 512]): it reads and
writes 262,144 bf16 values once, 1,048,576 B: 0.31 us at 3.35 TB/s; its
some 2.6 MFLOP of f32 arithmetic are nothing beside that.  At this size it
is bound by launch overhead.  Design: a flat elementwise pass, 1024 values
a program, bf16 in, the formula in f32, one rounding to bf16 on the store.
``0.5 * (1 + tanh(u))`` is computed as ``1 / (1 + exp(-2u))``, the same
function with no cancellation near ``u = 0``.  Triton serves as well as
CUDA for a pure elementwise pass.
"""

from __future__ import annotations

import functools
import math

import torch

SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
BLOCK = 1024

launches = 0


def gelu_tanh_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``jax.nn.gelu``'s tanh formula in f32,
    rounded once to the input's type."""
    xf = x.float()
    cdf = 0.5 * (1.0 + torch.tanh(SQRT_2_OVER_PI * (xf + 0.044715 * (xf * xf * xf))))
    return (xf * cdf).to(x.dtype)


@functools.cache
def _kernel():
    # Triton resolves the names a kernel uses through its module's globals,
    # so ``tl`` is bound there, at the first launch rather than at import
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def gelu_kernel(x_ptr, y_ptr, n, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        inside = offs < n
        x = tl.load(x_ptr + offs, mask=inside, other=0.0).to(tl.float32)
        u = 0.7978845608028654 * (x + 0.044715 * (x * x * x))
        y = x / (1.0 + tl.exp(-2.0 * u))
        tl.store(y_ptr + offs, y.to(tl.bfloat16), mask=inside)

    return triton, gelu_kernel


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """bf16 -> bf16 tanh GELU: the plain version for a CPU tensor, the
    Triton kernel for a CUDA tensor."""
    global launches
    if x.dtype != torch.bfloat16:
        raise ValueError(f"gelu_tanh takes bf16, got {x.dtype}")
    if x.device.type == "cpu":
        return gelu_tanh_ref(x)
    if x.device.type != "cuda" or not x.is_contiguous() or x.numel() >= 2**31:
        raise ValueError("gelu_tanh's kernel takes a contiguous CUDA tensor")
    triton, kernel = _kernel()
    y = torch.empty_like(x)
    n = x.numel()
    with torch.cuda.device(x.device):
        kernel[(triton.cdiv(n, BLOCK),)](x, y, n, BLOCK=BLOCK, num_warps=4)
    launches += 1
    return y
