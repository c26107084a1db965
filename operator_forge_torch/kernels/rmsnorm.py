"""RMSNorm over the last dim: a CUDA forward and backward, and their plain
versions.

Counterpart of ``operator_forge/tpu/demo.py::_rmsnorm`` (lines 71-73):
``x / sqrt(mean(x²) + 1e-6) * gain`` in f32.

The forward's kernel is CUDA C++, ``csrc/rmsnorm.cu``: a warp a row for
rows of up to 1024 columns (the model's 128 in one 16-byte load a lane), a
block a row past that, writing f32 or bf16.  The bf16 output is the
reference's ``_rmsnorm(...).astype(bf16)``, the operand the next product
reads (``demo.py:78,97``), rounded once from the same f32 value: so
``rmsnorm_to_bf16`` takes in the cast that followed RMSNorm, and the model
launches no cast between the two.  The source's note has the bound and the
design.

The backward is the transpose of the same lines.  With ``xhat = x / norm``
and ``u = dy * gain``: ``dx = (u - xhat * mean(u * xhat)) / norm`` per row
and ``dgain = sum over rows of dy * xhat``, all in f32.  Its kernel is CUDA
C++, ``csrc/rmsnorm_bwd.cu``, one launch at every shape: a grid of blocks
of contiguous rows, as many as fill the card where the rows allow (fewer
for a few rows, more in waves for very many), each block writing dx and
leaving its rows' dgain partial, summed in row order, in its row of a
scratch from PyTorch's allocator (under ``jit``'s capture, the graph's
pool).  The blocks draw integer tickets in groups: the last of each group
sums its group's partials in block order, and the last group sums the
groups' in group order and writes dgain.  Rows of a multiple of 8
columns up to 8192 with 16-byte aligned tensors (the benchmark's
``[8192, 2048]`` and ``[16384, 1024]``, ``DemoConfig()``'s ``[512,
128]``) are held in registers, 8 fixed columns a thread, read once;
other rows are strided by a block's threads in three passes.  The
counters (``build.counters``) are made once a device before any capture,
and the last block sets each back to 0.

No float atomics: every sum runs in a fixed order, and a call repeats bit
for bit.  ``rmsnorm_bwd`` takes an f32 ``dy`` and ``rmsnorm_bwd_bf16`` a
bf16 one, which the kernel widens exactly in registers: the bits of
``rmsnorm_bwd`` on ``dy`` widened first, in one launch and no cast.
``rmsnorm_to_bf16``'s backward hands its bf16 ``dy`` to
``rmsnorm_bwd_bf16``, or with a ``model`` group widens it, all-reduces it
and calls ``rmsnorm_bwd``.  The source's note has the bound and the
design.  ``rmsnorm`` and ``rmsnorm_to_bf16`` tie the two directions
together as autograd ``Function``s.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.distributed as dist

from .. import telemetry
from . import build

EPS = 1e-6


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


def rmsnorm_fwd(x: torch.Tensor, gain: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """f32 ``[..., d]`` with f32 gain ``[d]`` -> ``[..., d]`` of ``dtype``
    (f32, or bf16 rounded once from the f32 value): the plain version for a
    CPU tensor, one launch of the CUDA kernel for a CUDA tensor."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rmsnorm writes f32 or bf16, not {dtype}")
    d = x.shape[-1]
    if _check(x, gain, "rmsnorm"):
        return rmsnorm_ref(x, gain).to(dtype)
    y = torch.empty(x.shape, dtype=dtype, device=x.device)
    lib = _fwd_library()
    entry = lib.rmsnorm_bf16 if dtype == torch.bfloat16 else lib.rmsnorm_f32
    with torch.cuda.device(x.device):
        status = entry(x.data_ptr(), gain.data_ptr(), y.data_ptr(), x.numel() // d, d,
                       torch.cuda.current_stream().cuda_stream)
    build.check(lib, status, "rmsnorm")
    telemetry.count("kernels.rmsnorm")
    return y


@functools.cache
def _fwd_library() -> ctypes.CDLL:
    lib = build.library("rmsnorm")
    for entry in (lib.rmsnorm_f32, lib.rmsnorm_bf16):
        entry.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        entry.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = build.library("rmsnorm_bwd")
    for entry in (lib.rmsnorm_bwd_f32, lib.rmsnorm_bwd_bf16):
        entry.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        entry.restype = ctypes.c_int
    lib.rmsnorm_bwd_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.rmsnorm_bwd_plan.restype = ctypes.c_int
    lib.rmsnorm_bwd_counters.argtypes = []
    lib.rmsnorm_bwd_counters.restype = ctypes.c_int
    return lib


@functools.cache
def _plan(device: int, n_rows: int, d: int, aligned: bool) -> tuple[int, int]:
    """``(blocks, groups)`` of the backward's launch for rows ``[n_rows,
    d]`` on CUDA device ``device``, with its five tensors all 16-byte
    aligned or not (builds the kernel)."""
    lib = _bwd_library()
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        status = lib.rmsnorm_bwd_plan(n_rows, d, int(aligned), out)
    build.check(lib, status, "rmsnorm_bwd_plan")
    return out[0], out[1]


def _bwd(x: torch.Tensor, gain: torch.Tensor, dy: torch.Tensor):
    """``(dx, dgain)`` for a dy of x's shape: the plain version on dy
    widened for CPU tensors, one launch of the kernel (dy f32 or bf16) for
    contiguous tensors on one CUDA device."""
    if _check(x, gain, "rmsnorm_bwd") and dy.device.type == "cpu":
        return rmsnorm_bwd_ref(x, gain, dy.float())
    if dy.device != x.device or not dy.is_contiguous():
        raise ValueError("rmsnorm_bwd's kernel takes contiguous tensors on one CUDA device")
    d = x.shape[-1]
    n_rows = x.numel() // d
    dx = torch.empty_like(x)
    dgain = torch.empty_like(gain)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, gain, dy, dx, dgain))
    blocks, groups = _plan(x.device.index, n_rows, d, aligned)
    scratch = torch.empty((blocks + groups, d), dtype=torch.float32, device=x.device)
    lib = _bwd_library()
    entry = lib.rmsnorm_bwd_bf16 if dy.dtype == torch.bfloat16 else lib.rmsnorm_bwd_f32
    counters = build.counters("rmsnorm_bwd", x.device, lib.rmsnorm_bwd_counters())
    with torch.cuda.device(x.device):
        status = entry(x.data_ptr(), gain.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                       dgain.data_ptr(), scratch.data_ptr(), counters.data_ptr(), n_rows, d,
                       torch.cuda.current_stream().cuda_stream)
    build.check(lib, status, "rmsnorm_bwd")
    telemetry.count("kernels.rmsnorm_bwd")
    return dx, dgain


def rmsnorm_bwd(
    x: torch.Tensor, gain: torch.Tensor, dy: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dgain)`` of ``rmsnorm(x, gain)`` for the output gradient
    ``dy`` (f32, x's shape): the plain version for CPU tensors, one launch
    of the CUDA kernel for CUDA tensors."""
    if dy.dtype != torch.float32 or dy.shape != x.shape:
        raise ValueError(
            f"rmsnorm_bwd takes dy f32 {tuple(x.shape)}, got {dy.dtype} {tuple(dy.shape)}"
        )
    return _bwd(x, gain, dy)


def rmsnorm_bwd_bf16(
    x: torch.Tensor, gain: torch.Tensor, dy: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``rmsnorm_bwd(x, gain, dy.float())`` for a bf16 ``dy``, to the bit:
    the plain version on dy widened for CPU tensors, one launch of the
    CUDA kernel reading ``dy`` as it is for CUDA tensors."""
    if dy.dtype != torch.bfloat16 or dy.shape != x.shape:
        raise ValueError(
            f"rmsnorm_bwd_bf16 takes dy bf16 {tuple(x.shape)}, got {dy.dtype} {tuple(dy.shape)}"
        )
    return _bwd(x, gain, dy)


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


class RMSNormToBF16(torch.autograd.Function):
    """``rmsnorm_fwd`` to bf16, the operand of the product that follows,
    with the gradient of the chain it replaces: RMSNorm, then (with a
    ``model`` process group) Megatron's "f", then the cast to bf16.  Its
    backward widens the bf16 ``dy`` to f32, all-reduces it over ``model``
    where a group is given, then runs ``rmsnorm_bwd``: that chain's order,
    so its bits.  (``demo.CopyToModel`` around the bf16 output instead
    would all-reduce bf16 gradients.)  With no group it hands the bf16
    ``dy`` to ``rmsnorm_bwd_bf16``, which gives the same bits.  Saves x
    and the gain."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, gain: torch.Tensor, model) -> torch.Tensor:
        ctx.save_for_backward(x, gain)
        ctx.model = model
        return rmsnorm_fwd(x, gain, torch.bfloat16)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, gain = ctx.saved_tensors
        if ctx.model is None:
            return (*rmsnorm_bwd_bf16(x, gain, dy.contiguous()), None)
        dy = dy.to(torch.float32, memory_format=torch.contiguous_format)
        dist.all_reduce(dy, group=ctx.model)
        return (*rmsnorm_bwd(x, gain, dy), None)


def rmsnorm_to_bf16(x: torch.Tensor, gain: torch.Tensor, model=None) -> torch.Tensor:
    """RMSNorm written in bf16, with a gradient: f32 ``[..., d]`` and gain
    ``[d]`` -> bf16 ``[..., d]``, the bits of ``rmsnorm(x, gain)`` cast to
    bf16; the forward kernel now and, under ``backward()``, the f32
    gradient all-reduced over the ``model`` group (when one is given) and
    the backward kernel (the plain versions for CPU tensors)."""
    return RMSNormToBF16.apply(x, gain, model)
