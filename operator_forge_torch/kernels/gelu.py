"""Tanh-approximation GELU on bf16: the formulas and their gradient, in
plain PyTorch.

Counterpart of ``jax.nn.gelu`` in ``operator_forge/tpu/demo.py::_mlp``
(line 98), whose default is the tanh form (``torch``'s default is erf).
``gelu_tanh_ref`` evaluates it in f32 and rounds once to the input's type.

The backward is ``dx = bf16(f32(dy) * gelu'(f32(x)))``, with ``gelu'`` the
derivative of the same tanh form, written with ``s = sigmoid(2u)`` as
``s + 2x s (1 - s) c (1 + 3 * 0.044715 x²)``, ``c = sqrt(2 / pi)``: no
``1 + tanh`` to cancel.  JAX differentiates ``jax.nn.gelu`` on bf16 in bf16
steps; this follows the f32 formula rounded once, which is what autograd of
``gelu_tanh_ref`` gives (ROADMAP.md, Queue 3, has the divergence).

On the card the GELU has no kernel of its own: it runs in the epilogue of
the product before it, and its slope in the epilogue of the backward's
product (``kernels/mlp.py``, ``csrc/mlp.cu``), whose plain versions call
these formulas.  ``gelu_tanh`` ties the two directions together as an
autograd ``Function`` for CPU tensors, so that the model can be composed
step by step on the CPU; on any other device it raises.
"""

from __future__ import annotations

import math

import torch

SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


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


def _check(*tensors: torch.Tensor) -> None:
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError(f"gelu_tanh takes bf16, got {[t.dtype for t in tensors]}")
    if any(t.device.type != "cpu" for t in tensors):
        raise ValueError(
            "gelu_tanh runs on the CPU only: on the card the GELU runs in the epilogue of "
            "kernels.mlp.matmul_gelu (and its slope in matmul_gelu_bwd)"
        )


class GeluTanh(torch.autograd.Function):
    """``gelu_tanh_ref`` with ``gelu_tanh_bwd_ref`` as its gradient, for
    bf16 CPU tensors; saves the input."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        _check(x)
        ctx.save_for_backward(x)
        return gelu_tanh_ref(x)

    @staticmethod
    def backward(ctx, dy: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        _check(dy)
        return gelu_tanh_bwd_ref(x, dy)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh GELU with a gradient, bf16 -> bf16, on CPU tensors."""
    return GeluTanh.apply(x)
