"""Mean next-token cross entropy over the vocab: CUDA kernels, forward and
backward, and their plain versions.

Counterpart of ``operator_forge/tpu/demo.py::loss_fn`` (lines 116-118):
``log_softmax`` over the last dim, the gather at the targets, then the mean
NLL; and of its transpose under ``jax.value_and_grad`` in ``train_step``
(lines 121-127): ``dlogits = (softmax(logits) - onehot(target)) * g / N``
with N the number of rows.  The logits are f32 or bf16: a bf16 logit is
widened exactly and everything is computed in f32, as the reference widens
the bf16 product's logits before the loss (line 109); ``dlogits`` comes
back in the logits' type, rounded once.  So the model feeds its bf16
logits straight in, and neither the widening nor its backward's narrowing
is a launch of its own.

The kernels are CUDA C++, ``csrc/cross_entropy.cu``: the forward is one
launch, whose last block to finish takes the mean over the rows in a
fixed order (no float atomics, so the loss repeats bit for bit), and the
backward is one launch.  The source's note has the bound and the design.
``cross_entropy`` ties the two directions together as an autograd
``Function``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import telemetry
from . import build


def _rows(logits: torch.Tensor, targets: torch.Tensor):
    return logits.reshape(-1, logits.shape[-1]), targets.reshape(-1)


def cross_entropy_ref(
    logits: torch.Tensor, targets: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward: ``(loss, lse)``, the mean NLL
    and each row's log-sum-exp, in ``jax.nn.log_softmax``'s order:
    ``logp = (x - max) - log(sum(exp(x - max)))``, on the logits widened
    to f32."""
    x, t = _rows(logits, targets)
    x = x.float()
    top = x.amax(dim=-1, keepdim=True)
    shifted = x - top
    log_total = torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))
    nll = -(shifted.gather(-1, t[:, None]) - log_total)
    return nll.mean(), (top + log_total).squeeze(-1)


def cross_entropy_bwd_ref(
    logits: torch.Tensor, targets: torch.Tensor, lse: torch.Tensor, grad: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the backward: ``(exp(x - lse) - onehot) *
    (grad / N)`` in f32 on the widened logits, in logits' shape and type;
    ``grad / N`` is a division, as JAX's transpose of the mean divides."""
    x, t = _rows(logits, targets)
    x = x.float()
    # a device tensor, not a Python int: CUDA turns division by a host
    # scalar into multiplication by its inverse, which rounds differently
    n = torch.tensor(x.shape[0], dtype=torch.float32, device=x.device)
    onehot = torch.nn.functional.one_hot(t, x.shape[-1]).to(x.dtype)
    dx = (torch.exp(x - lse[:, None]) - onehot) * (grad / n)
    return dx.to(logits.dtype).reshape(logits.shape)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.library("cross_entropy")
    for dtype in ("f32", "bf16"):
        fwd = getattr(lib, f"cross_entropy_fwd_{dtype}")
        fwd.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 4
                        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        bwd = getattr(lib, f"cross_entropy_bwd_{dtype}")
        bwd.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        bwd.restype = ctypes.c_int
    return lib


def _check(logits: torch.Tensor, targets: torch.Tensor, what: str) -> bool:
    """Validate f32 or bf16 ``logits [..., V]`` and integer ``targets
    [...]``; True where both lie on the CPU (the plain version), False for
    the kernel, raise otherwise."""
    if (logits.dtype not in (torch.float32, torch.bfloat16)
            or targets.dtype not in (torch.int32, torch.int64)
            or logits.dim() < 1 or targets.shape != logits.shape[:-1]
            or logits.shape[-1] < 1 or targets.numel() < 1):
        raise ValueError(
            f"{what} takes f32 or bf16 logits [..., V] with V >= 1 and integer "
            f"targets [...], got {logits.dtype} {tuple(logits.shape)} and "
            f"{targets.dtype} {tuple(targets.shape)}"
        )
    if logits.device.type == "cpu" and targets.device.type == "cpu":
        return True
    if (logits.device.type != "cuda" or targets.device != logits.device
            or not logits.is_contiguous() or not targets.is_contiguous()):
        raise ValueError(f"{what}'s kernels take contiguous tensors on one CUDA device")
    return False


def _entry(lib: ctypes.CDLL, name: str, logits: torch.Tensor):
    return getattr(lib, f"{name}_{'bf16' if logits.dtype == torch.bfloat16 else 'f32'}")


def cross_entropy_fwd(
    logits: torch.Tensor, targets: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 or bf16 ``logits [..., V]`` and targets in ``[0, V)`` -> f32
    ``(loss, lse)``: the plain version for CPU tensors, one launch of the
    CUDA kernel for CUDA tensors.  A target outside ``[0, V)`` is not
    checked on the card (that would wait for it) and picks no logit."""
    if _check(logits, targets, "cross_entropy"):
        return cross_entropy_ref(logits, targets)
    x, t = _rows(logits, targets)
    n_rows, n_cols = x.shape
    nll = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(nll)
    loss = torch.empty((), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        counter = build.counters("cross_entropy", x.device, 1)
        status = _entry(lib, "cross_entropy_fwd", x)(
            x.data_ptr(), t.data_ptr(), t.element_size(), nll.data_ptr(), lse.data_ptr(),
            loss.data_ptr(), counter.data_ptr(), n_rows, n_cols,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, status, "cross_entropy")
    telemetry.count("kernels.cross_entropy")
    return loss, lse


def cross_entropy_bwd(
    logits: torch.Tensor, targets: torch.Tensor, lse: torch.Tensor, grad: torch.Tensor
) -> torch.Tensor:
    """``dlogits`` in logits' shape and type for the loss gradient ``grad``
    (an f32 scalar tensor) and the forward's ``lse``: the plain version for
    CPU tensors, one launch of the CUDA kernel for CUDA tensors."""
    cpu = _check(logits, targets, "cross_entropy_bwd")
    n_rows = targets.numel()
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (n_rows,)
            or grad.dtype != torch.float32 or grad.numel() != 1):
        raise ValueError(
            f"cross_entropy_bwd takes f32 lse [{n_rows}] and an f32 scalar grad, got "
            f"{lse.dtype} {tuple(lse.shape)} and {grad.dtype} {tuple(grad.shape)}"
        )
    if cpu and lse.device.type == "cpu" and grad.device.type == "cpu":
        return cross_entropy_bwd_ref(logits, targets, lse, grad)
    if lse.device != logits.device or grad.device != logits.device or not lse.is_contiguous():
        raise ValueError("cross_entropy_bwd's kernel takes tensors on one CUDA device")
    x, t = _rows(logits, targets)
    dx = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        status = _entry(lib, "cross_entropy_bwd", x)(
            x.data_ptr(), t.data_ptr(), t.element_size(), lse.data_ptr(), grad.data_ptr(),
            dx.data_ptr(), n_rows, x.shape[1], torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, status, "cross_entropy_bwd")
    telemetry.count("kernels.cross_entropy_bwd")
    return dx.reshape(logits.shape)


class CrossEntropy(torch.autograd.Function):
    """``cross_entropy_fwd`` with ``cross_entropy_bwd`` as its gradient;
    saves the logits, the targets and each row's log-sum-exp."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        loss, lse = cross_entropy_fwd(logits, targets)
        ctx.save_for_backward(logits, targets, lse)
        return loss

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        logits, targets, lse = ctx.saved_tensors
        return cross_entropy_bwd(logits, targets, lse, grad.contiguous()), None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy with a gradient: f32 or bf16 ``logits [..., V]``
    and targets ``[...]`` -> f32 scalar, the forward kernel now and the
    backward kernel under ``backward()``, whose ``dlogits`` take the
    logits' type (the plain versions for CPU tensors)."""
    return CrossEntropy.apply(logits, targets)
