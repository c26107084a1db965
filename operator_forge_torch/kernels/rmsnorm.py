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
"""

from __future__ import annotations

import functools

import torch

EPS = 1e-6
MAX_COLS = 16384

launches = 0


def rmsnorm_ref(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, the reference's formula."""
    norm = torch.sqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + EPS)
    return (x / norm) * gain


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

    return triton, rmsnorm_kernel


def rmsnorm(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """f32 ``[..., d]`` with f32 gain ``[d]`` -> f32 ``[..., d]``: the plain
    version for a CPU tensor, the Triton kernel for a CUDA tensor."""
    global launches
    d = x.shape[-1]
    if (x.dtype != torch.float32 or gain.dtype != torch.float32
            or tuple(gain.shape) != (d,) or not 1 <= d <= MAX_COLS):
        raise ValueError(
            f"rmsnorm takes f32 [..., d] and f32 gain [d] with d <= {MAX_COLS}, "
            f"got {x.dtype} {tuple(x.shape)} and {gain.dtype} {tuple(gain.shape)}"
        )
    if x.device.type == "cpu" and gain.device.type == "cpu":
        return rmsnorm_ref(x, gain)
    if (x.device.type != "cuda" or gain.device != x.device
            or not x.is_contiguous() or not gain.is_contiguous()
            or x.numel() >= 2**31):
        raise ValueError("rmsnorm's kernel takes contiguous tensors on one CUDA device")
    triton, kernel = _kernel()
    y = torch.empty_like(x)
    block = triton.next_power_of_2(d)
    with torch.cuda.device(x.device):
        kernel[(x.numel() // d,)](
            x, gain, y, d, EPS, BLOCK=block, num_warps=min(max(block // 128, 1), 8)
        )
    launches += 1
    return y
