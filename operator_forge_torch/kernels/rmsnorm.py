"""RMSNorm over the last dim: a Triton kernel and its plain version.

Counterpart of ``operator_forge/tpu/demo.py::_rmsnorm`` (lines 71-73):
``x / sqrt(mean(x²) + 1e-6) * gain`` in f32.

Bound on an H100 SXM at DemoConfig() (x f32 [512, 128], gain f32 [128]):
it reads x and gain once and writes y once, 524,800 B: 0.16 us at
3.35 TB/s; its 0.26 MFLOP are nothing beside that.  At this size it is
bound by launch overhead.  Design: one program per row, the whole row in
registers, so x is read once and the reduction needs no shared memory or
second pass; the divisions and the square root round as IEEE's (``div_rn``,
``sqrt_rn``), as the reference's do.  Triton serves as well as CUDA here:
there is no tensor-core work, only a row reduction and an elementwise pass.

The backward is the transpose of the same lines.  With ``xhat = x / norm``
and ``u = dy * gain``: ``dx = (u - xhat * mean(u * xhat)) / norm`` per row
and ``dgain = sum over rows of dy * xhat``, all in f32.  Its bound at
DemoConfig() (x, dy f32 [512, 128] read, dx written, gain and dgain): it
moves 787,456 B, 0.24 us at 3.35 TB/s, again far below one launch.  Design:
one program per row recomputes the norm as the forward does, writes dx and
its row's ``dy * xhat`` to a scratch of x's size; a second launch sums the
scratch per column over the rows in a fixed order.  No atomics, so dgain
repeats bit for bit.  ``rmsnorm`` ties the two directions together as an
autograd ``Function``.
"""

from __future__ import annotations

import functools

import torch

EPS = 1e-6
MAX_COLS = 16384

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
    def rmsnorm_kernel(x_ptr, gain_ptr, y_ptr, n_cols, eps, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        inside = cols < n_cols
        x = tl.load(x_ptr + row * n_cols + cols, mask=inside, other=0.0)
        mean_sq = tl.div_rn(tl.sum(x * x, axis=0), n_cols.to(tl.float32))
        norm = tl.sqrt_rn(mean_sq + eps)
        gain = tl.load(gain_ptr + cols, mask=inside, other=0.0)
        tl.store(y_ptr + row * n_cols + cols, tl.div_rn(x, norm) * gain, mask=inside)

    @triton.jit
    def rmsnorm_bwd_rows_kernel(x_ptr, gain_ptr, dy_ptr, dx_ptr, part_ptr, n_cols,
                                eps, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        inside = cols < n_cols
        at = row * n_cols + cols
        x = tl.load(x_ptr + at, mask=inside, other=0.0)
        d = n_cols.to(tl.float32)
        norm = tl.sqrt_rn(tl.div_rn(tl.sum(x * x, axis=0), d) + eps)
        xhat = tl.div_rn(x, norm)
        dy = tl.load(dy_ptr + at, mask=inside, other=0.0)
        u = dy * tl.load(gain_ptr + cols, mask=inside, other=0.0)
        mean_ux = tl.div_rn(tl.sum(u * xhat, axis=0), d)
        tl.store(dx_ptr + at, tl.div_rn(u - xhat * mean_ux, norm), mask=inside)
        tl.store(part_ptr + at, dy * xhat, mask=inside)

    @triton.jit
    def column_sum_kernel(part_ptr, out_ptr, n_rows, n_cols,
                          ROWS: tl.constexpr, COLS: tl.constexpr):
        cols = tl.program_id(0) * COLS + tl.arange(0, COLS)
        acc = tl.zeros([ROWS, COLS], dtype=tl.float32)
        for r0 in range(0, n_rows, ROWS):
            rows = r0 + tl.arange(0, ROWS)
            inside = (rows[:, None] < n_rows) & (cols[None, :] < n_cols)
            acc += tl.load(part_ptr + rows[:, None] * n_cols + cols[None, :],
                           mask=inside, other=0.0)
        tl.store(out_ptr + cols, tl.sum(acc, axis=0), mask=cols < n_cols)

    return triton, rmsnorm_kernel, rmsnorm_bwd_rows_kernel, column_sum_kernel


def _check(x: torch.Tensor, gain: torch.Tensor, what: str) -> bool:
    """Validate ``x [..., d]`` and ``gain [d]``; True where both lie on the
    CPU (the plain version), False for the kernel, raise otherwise."""
    d = x.shape[-1]
    if (x.dtype != torch.float32 or gain.dtype != torch.float32
            or tuple(gain.shape) != (d,) or not 1 <= d <= MAX_COLS):
        raise ValueError(
            f"{what} takes f32 [..., d] and f32 gain [d] with d <= {MAX_COLS}, "
            f"got {x.dtype} {tuple(x.shape)} and {gain.dtype} {tuple(gain.shape)}"
        )
    if x.device.type == "cpu" and gain.device.type == "cpu":
        return True
    if (x.device.type != "cuda" or gain.device != x.device
            or not x.is_contiguous() or not gain.is_contiguous()
            or x.numel() >= 2**31):
        raise ValueError(f"{what}'s kernel takes contiguous tensors on one CUDA device")
    return False


def rmsnorm_fwd(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """f32 ``[..., d]`` with f32 gain ``[d]`` -> f32 ``[..., d]``: the plain
    version for a CPU tensor, the Triton kernel for a CUDA tensor."""
    global launches
    d = x.shape[-1]
    if _check(x, gain, "rmsnorm"):
        return rmsnorm_ref(x, gain)
    triton, kernel, _, _ = _kernel()
    y = torch.empty_like(x)
    block = triton.next_power_of_2(d)
    with torch.cuda.device(x.device):
        kernel[(x.numel() // d,)](
            x, gain, y, d, EPS, BLOCK=block, num_warps=min(max(block // 128, 1), 8)
        )
    launches += 1
    return y


def rmsnorm_bwd(
    x: torch.Tensor, gain: torch.Tensor, dy: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dgain)`` of ``rmsnorm(x, gain)`` for the output gradient
    ``dy`` (f32, x's shape): the plain version for CPU tensors, the Triton
    kernels (two launches, counted once) for CUDA tensors."""
    global bwd_launches
    d = x.shape[-1]
    if dy.dtype != torch.float32 or dy.shape != x.shape:
        raise ValueError(
            f"rmsnorm_bwd takes dy f32 {tuple(x.shape)}, got {dy.dtype} {tuple(dy.shape)}"
        )
    if _check(x, gain, "rmsnorm_bwd") and dy.device.type == "cpu":
        return rmsnorm_bwd_ref(x, gain, dy)
    if dy.device != x.device or not dy.is_contiguous():
        raise ValueError("rmsnorm_bwd's kernel takes contiguous tensors on one CUDA device")
    triton, _, rows_kernel, sum_kernel = _kernel()
    n_rows = x.numel() // d
    dx = torch.empty_like(x)
    partial = torch.empty_like(x)
    dgain = torch.empty_like(gain)
    block = triton.next_power_of_2(d)
    cols = min(32, block)
    with torch.cuda.device(x.device):
        rows_kernel[(n_rows,)](
            x, gain, dy, dx, partial, d, EPS, BLOCK=block,
            num_warps=min(max(block // 128, 1), 8),
        )
        sum_kernel[(triton.cdiv(d, cols),)](
            partial, dgain, n_rows, d, ROWS=128, COLS=cols, num_warps=4
        )
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
    ``[..., d]``, the forward kernel now and the backward kernels under
    ``backward()`` (the plain versions for CPU tensors)."""
    return RMSNorm.apply(x, gain)
