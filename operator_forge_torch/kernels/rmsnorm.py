"""RMSNorm over the last dim: a Triton forward, a CUDA backward, and their
plain versions.

Counterpart of ``operator_forge/tpu/demo.py::_rmsnorm`` (lines 71-73):
``x / sqrt(mean(x²) + 1e-6) * gain`` in f32.

Bound on an H100 SXM at DemoConfig() (x f32 [512, 128], gain f32 [128]):
it reads x and gain once and writes y once, 524,800 B: 0.16 us at
3.35 TB/s; its 0.26 MFLOP are nothing beside that.  At this size it is
bound by launch overhead.  Design: one program per row, the whole row in
registers, so x is read once and the reduction needs no shared memory or
second pass (a row wider than 16384 columns goes in chunks: a pass for the
sum of squares, then a writing pass; row offsets are 64-bit); the divisions and the square root round as IEEE's (``div_rn``,
``sqrt_rn``), as the reference's do.  Triton serves as well as CUDA here:
there is no tensor-core work, only a row reduction and an elementwise pass.

The backward is the transpose of the same lines.  With ``xhat = x / norm``
and ``u = dy * gain``: ``dx = (u - xhat * mean(u * xhat)) / norm`` per row
and ``dgain = sum over rows of dy * xhat``, all in f32.  Its kernel is CUDA
C++, ``csrc/rmsnorm_bwd.cu``: one launch of one thread-block cluster of
16 blocks (``cluster()``), which writes dx row by row and sums dgain's columns
first in each block's shared memory and then across the cluster through
distributed shared memory, which Triton does not reach (a window of
columns at a time where a row's sums would not fit, or would chain more
than 1024 rows).  No scratch in
device memory, no atomics: dgain repeats bit for bit.  The source's note
has its bound and design.  ``rmsnorm`` ties the two directions together as
an autograd ``Function``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

EPS = 1e-6
# a row of up to ROW_BLOCK columns sits in registers; a wider one goes
# CHUNK columns at a time
ROW_BLOCK = 16384
CHUNK = 8192

launches = 0
bwd_launches = 0


def rmsnorm_ref(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, the reference's formula."""
    norm = torch.sqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + EPS)
    return (x / norm) * gain


def rmsnorm_bwd_ref(
    x: torch.Tensor, gain: torch.Tensor, dy: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward: ``(dx, dgain)``."""
    norm = torch.sqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + EPS)
    xhat = x / norm
    u = dy * gain
    dx = (u - xhat * torch.mean(u * xhat, dim=-1, keepdim=True)) / norm
    return dx, (dy * xhat).reshape(-1, x.shape[-1]).sum(dim=0)


@functools.cache
def _kernel():
    # Triton resolves the names a kernel uses through its module's globals,
    # so ``tl`` is bound there, at the first launch rather than at import
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, gain_ptr, y_ptr, n_cols, eps, BLOCK: tl.constexpr,
                       ONE: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        x_row, y_row = x_ptr + row * n_cols, y_ptr + row * n_cols
        cols = tl.arange(0, BLOCK)
        if ONE:  # the row in registers
            inside = cols < n_cols
            x = tl.load(x_row + cols, mask=inside, other=0.0)
            mean_sq = tl.div_rn(tl.sum(x * x, axis=0), n_cols.to(tl.float32))
            norm = tl.sqrt_rn(mean_sq + eps)
            gain = tl.load(gain_ptr + cols, mask=inside, other=0.0)
            tl.store(y_row + cols, tl.div_rn(x, norm) * gain, mask=inside)
        else:  # chunk by chunk: the sum of squares, then the writing pass
            acc = tl.zeros([BLOCK], dtype=tl.float32)
            for c0 in range(0, n_cols, BLOCK):
                x = tl.load(x_row + c0 + cols, mask=c0 + cols < n_cols, other=0.0)
                acc += x * x
            norm = tl.sqrt_rn(tl.div_rn(tl.sum(acc, axis=0), n_cols.to(tl.float32)) + eps)
            for c0 in range(0, n_cols, BLOCK):
                inside = c0 + cols < n_cols
                x = tl.load(x_row + c0 + cols, mask=inside, other=0.0)
                gain = tl.load(gain_ptr + c0 + cols, mask=inside, other=0.0)
                tl.store(y_row + c0 + cols, tl.div_rn(x, norm) * gain, mask=inside)

    return triton, rmsnorm_kernel


def _check(x: torch.Tensor, gain: torch.Tensor, what: str) -> bool:
    """Validate ``x [..., d]`` and ``gain [d]``; True where both lie on the
    CPU (the plain version), False for the kernel, raise otherwise."""
    d = x.shape[-1]
    if (x.dtype != torch.float32 or gain.dtype != torch.float32
            or tuple(gain.shape) != (d,) or d < 1):
        raise ValueError(
            f"{what} takes f32 [..., d] and f32 gain [d] with d >= 1, "
            f"got {x.dtype} {tuple(x.shape)} and {gain.dtype} {tuple(gain.shape)}"
        )
    if x.device.type == "cpu" and gain.device.type == "cpu":
        return True
    if (x.device.type != "cuda" or gain.device != x.device
            or not x.is_contiguous() or not gain.is_contiguous()):
        raise ValueError(f"{what}'s kernel takes contiguous tensors on one CUDA device")
    return False


def rmsnorm_fwd(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """f32 ``[..., d]`` with f32 gain ``[d]`` -> f32 ``[..., d]``: the plain
    version for a CPU tensor, the Triton kernel for a CUDA tensor."""
    global launches
    d = x.shape[-1]
    if _check(x, gain, "rmsnorm"):
        return rmsnorm_ref(x, gain)
    triton, kernel = _kernel()
    y = torch.empty_like(x)
    block = triton.next_power_of_2(d) if d <= ROW_BLOCK else CHUNK
    with torch.cuda.device(x.device):
        kernel[(x.numel() // d,)](
            x, gain, y, d, EPS, BLOCK=block, ONE=d <= block,
            num_warps=min(max(block // 128, 1), 8),
        )
    launches += 1
    return y


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.library("rmsnorm_bwd")
    lib.rmsnorm_bwd_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.rmsnorm_bwd_f32.restype = ctypes.c_int
    lib.rmsnorm_bwd_cluster.argtypes = []
    lib.rmsnorm_bwd_cluster.restype = ctypes.c_int
    return lib


def cluster() -> int:
    """The blocks of the thread-block cluster the backward kernel runs on
    (builds the kernel)."""
    return _library().rmsnorm_bwd_cluster()


def rmsnorm_bwd(
    x: torch.Tensor, gain: torch.Tensor, dy: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dgain)`` of ``rmsnorm(x, gain)`` for the output gradient
    ``dy`` (f32, x's shape): the plain version for CPU tensors, one launch
    of the CUDA kernel for CUDA tensors (one a window of columns, counted
    once, for rows too wide or too many for one; see the source)."""
    global bwd_launches
    if dy.dtype != torch.float32 or dy.shape != x.shape:
        raise ValueError(
            f"rmsnorm_bwd takes dy f32 {tuple(x.shape)}, got {dy.dtype} {tuple(dy.shape)}"
        )
    if _check(x, gain, "rmsnorm_bwd") and dy.device.type == "cpu":
        return rmsnorm_bwd_ref(x, gain, dy)
    if dy.device != x.device or not dy.is_contiguous():
        raise ValueError("rmsnorm_bwd's kernel takes contiguous tensors on one CUDA device")
    d = x.shape[-1]
    dx = torch.empty_like(x)
    dgain = torch.empty_like(gain)
    lib = _library()
    with torch.cuda.device(x.device):
        status = lib.rmsnorm_bwd_f32(
            x.data_ptr(), gain.data_ptr(), dy.data_ptr(), dx.data_ptr(), dgain.data_ptr(),
            x.numel() // d, d, torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, status, "rmsnorm_bwd")
    bwd_launches += 1
    return dx, dgain


class RMSNorm(torch.autograd.Function):
    """``rmsnorm_fwd`` with ``rmsnorm_bwd`` as its gradient; saves x and
    the gain."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, gain)
        return rmsnorm_fwd(x, gain)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, gain = ctx.saved_tensors
        return rmsnorm_bwd(x, gain, dy.contiguous())


def rmsnorm(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """RMSNorm with a gradient: f32 ``[..., d]`` and gain ``[d]`` -> f32
    ``[..., d]``, the forward kernel now and the backward kernel under
    ``backward()`` (the plain versions for CPU tensors)."""
    return RMSNorm.apply(x, gain)
