"""The products every plain reference computes on, and the precision they
keep: float32 with TF32 off (``exact_f32``), or, for the lower-precision
control, every product's operands held in fp8 (``Products("fp8")``).
Shared by the references under this folder, so that each architecture's
reference and its control compute alike.  Imports nothing of the program.
"""

from __future__ import annotations

import torch


def exact_f32() -> None:
    """Float32 products in float32: no TF32, in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(t: torch.Tensor, dtype: torch.dtype = torch.float8_e4m3fn) -> torch.Tensor:
    """``t`` rounded to an fp8 type under one scale for the whole tensor
    (its largest magnitude to the type's largest), back in float32: how an
    fp8 product's operand is held."""
    scale = torch.finfo(dtype).max / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(dtype).float() / scale


class FP8Product(torch.autograd.Function):
    """``a @ b`` with both operands in e4m3, and in the backward each
    product's operands in fp8 too, the gradient in e5m2: fp8 training's
    usual recipe."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = fp8(a), fp8(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        a, b = ctx.saved_tensors
        grad = fp8(grad, torch.float8_e5m2)
        return grad @ b.transpose(-1, -2), a.transpose(-1, -2) @ grad


class Products:
    """Every product of the block: ``a @ b`` in float32, or with every
    product's operands in fp8, forward and backward (``precision="fp8"``)."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"no products in {precision!r}")
        self.precision = precision

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return FP8Product.apply(a, b)
        return a @ b
