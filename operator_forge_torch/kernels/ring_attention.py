"""One block step of causal ring attention: the CUDA kernel
``csrc/ring_attention.cu`` and its plain version.

Counterpart of ``operator_forge/tpu/demo.py::_ring_attention_body.step``
lines 276-298, without the ``ppermute`` of the K/V block: the f32 scores of
a query block against the block visiting it, masked causally from the two
blocks' ring positions, and the online-softmax update of the carry ``(m,
num, den)``.  ``demo.ring_attention`` calls it once per ring step.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build

MAX_SEQ = 1024
MAX_HEAD_DIM = 128

launches = 0


def ring_step_ref(q, k_blk, v_blk, m, num, den, q_block: int, k_block: int) -> tuple:
    """Plain PyTorch version, ``demo.py:279-295`` line for line: returns the
    new ``(m, num, den)`` as new tensors.  ``q_block`` is the query block's
    ring position (``my``) and ``k_block`` the visiting block's
    (``origin``)."""
    s, d = q.shape[-2:]
    # 1 / sqrt(f32(d)) in f32 on the device, as the reference rounds it
    scale = 1.0 / torch.tensor(d, dtype=torch.float32, device=q.device).sqrt()
    q32 = q.float()
    scores = (q32 @ k_blk.float().transpose(-1, -2)) * scale
    q_pos = q_block * s + torch.arange(s, device=q.device)[:, None]
    k_pos = k_block * s + torch.arange(s, device=q.device)[None, :]
    scores = torch.where(k_pos <= q_pos, scores, -math.inf)
    block_max = scores.amax(dim=-1, keepdim=True)
    new_m = torch.maximum(m, block_max)
    shift = torch.where(torch.isinf(new_m), 0.0, new_m)
    correction = torch.exp(m - shift)
    probs = torch.exp(scores - shift)
    num = num * correction + probs @ v_blk.float()
    den = den * correction + probs.sum(dim=-1, keepdim=True)
    return new_m, num, den


def _check(q, k_blk, v_blk, m, num, den) -> tuple[int, int, int, int]:
    if q.dim() != 4 or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ring_step takes f32 or bf16 q [b, h, s, d], got {q.dtype} {tuple(q.shape)}")
    b, h, s, d = q.shape
    for name, t in (("k_blk", k_blk), ("v_blk", v_blk)):
        if t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name} must match q's {q.dtype} {tuple(q.shape)}, got {t.dtype} {tuple(t.shape)}")
    for name, t, shape in (("m", m, (b, h, s, 1)), ("num", num, (b, h, s, d)), ("den", den, (b, h, s, 1))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"the carry's {name} must be f32 {shape}, got {t.dtype} {tuple(t.shape)}")
    if not 1 <= s <= MAX_SEQ or not 1 <= d <= MAX_HEAD_DIM or b > 65535 or h > 65535:
        raise ValueError(
            f"ring_step takes s <= {MAX_SEQ}, d <= {MAX_HEAD_DIM}, b and h <= 65535; "
            f"got {tuple(q.shape)}"
        )
    return b, h, s, d


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.library("ring_attention")
    for name in ("ring_step_f32", "ring_step_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def ring_step(q, k_blk, v_blk, m, num, den, q_block: int, k_block: int) -> tuple:
    """One ring step: updates the f32 carry ``m, den [b, h, s, 1]`` and
    ``num [b, h, s, d]`` in place and returns it.  ``q, k_blk, v_blk`` are
    f32 or bf16 ``[b, h, s, d]``; query ``i`` sits at ``q_block * s + i``
    and key ``j`` at ``k_block * s + j``.  The reference's carry is dead
    after each step, so updating it in place computes the same function
    without a copy.  CPU tensors take the plain version; CUDA tensors one
    launch of the kernel, also for a later block (``k_block > q_block``),
    whose keys are all masked: its blocks exit at once and the carry keeps
    its bits."""
    global launches
    b, h, s, d = _check(q, k_blk, v_blk, m, num, den)
    if q_block < 0 or k_block < 0:
        raise ValueError(f"ring positions are >= 0, got {q_block}, {k_block}")
    tensors = (q, k_blk, v_blk, m, num, den)
    if all(t.device.type == "cpu" for t in tensors):
        for t, new in zip((m, num, den), ring_step_ref(*tensors, q_block, k_block)):
            t.copy_(new)
        return m, num, den
    if (q.device.type != "cuda" or any(t.device != q.device for t in tensors)
            or not all(t.is_contiguous() for t in tensors)):
        raise ValueError("ring_step's kernel takes contiguous tensors on one CUDA device")
    lib = _library()
    fn = lib.ring_step_bf16 if q.dtype == torch.bfloat16 else lib.ring_step_f32
    with torch.cuda.device(q.device):
        status = fn(*(t.data_ptr() for t in tensors), b, h, s, d, q_block, k_block,
                    torch.cuda.current_stream().cuda_stream)
    build.check(lib, status, "ring_step")
    launches += 1
    return m, num, den
