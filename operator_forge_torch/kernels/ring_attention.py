"""One block step of causal ring attention, forward and backward: the CUDA
kernels ``csrc/ring_attention.cu`` and their plain versions.

Counterpart of ``operator_forge/tpu/demo.py::_ring_attention_body.step``
lines 276-298, without the ``ppermute`` of the K/V block: the f32 scores of
a query block against the block visiting it, masked causally from the two
blocks' ring positions, and the online-softmax update of the carry ``(m,
num, den)``.  ``demo.ring_attention`` calls it once per ring step.

The backward step is the transpose of the same lines that ``jax.grad``
derives through the ring's ``scan``: from the forward's final ``(m, den)``
it recomputes the block's probabilities ``p = exp(score - m) / den`` and
adds the block's share of dQ, dK and dV into f32 accumulators.
``demo.RingAttention`` calls it once per rotation of its backward ring.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import telemetry
from . import build


def _scale(d: int, device) -> torch.Tensor:
    # 1 / sqrt(f32(d)) in f32 on the device, as the reference rounds it
    return 1.0 / torch.tensor(d, dtype=torch.float32, device=device).sqrt()


def _seen(s: int, q_block: int, k_block: int, device) -> torch.Tensor:
    """[s, s]: whether query i (at ``q_block * s + i``) sees key j (at
    ``k_block * s + j``)."""
    q_pos = q_block * s + torch.arange(s, device=device)[:, None]
    k_pos = k_block * s + torch.arange(s, device=device)[None, :]
    return k_pos <= q_pos


def ring_step_ref(q, k_blk, v_blk, m, num, den, q_block: int, k_block: int) -> tuple:
    """Plain PyTorch version, ``demo.py:279-295`` line for line: returns the
    new ``(m, num, den)`` as new tensors.  ``q_block`` is the query block's
    ring position (``my``) and ``k_block`` the visiting block's
    (``origin``)."""
    s, d = q.shape[-2:]
    scores = (q.float() @ k_blk.float().transpose(-1, -2)) * _scale(d, q.device)
    scores = torch.where(_seen(s, q_block, k_block, q.device), scores, -math.inf)
    block_max = scores.amax(dim=-1, keepdim=True)
    new_m = torch.maximum(m, block_max)
    shift = torch.where(torch.isinf(new_m), 0.0, new_m)
    correction = torch.exp(m - shift)
    probs = torch.exp(scores - shift)
    num = num * correction + probs @ v_blk.float()
    den = den * correction + probs.sum(dim=-1, keepdim=True)
    return new_m, num, den


def ring_step_bwd_ref(q, k_blk, v_blk, dout, m, den, big_d, q_block: int, k_block: int,
                      dq, dk_blk, dv_blk) -> tuple:
    """Plain PyTorch version of the backward step: returns the new f32
    ``(dq, dk_blk, dv_blk)`` as new tensors.  ``dout`` is the output's
    gradient (q's type), ``m`` and ``den`` the forward's final carry and
    ``big_d`` each row's ``sum(dout * out)`` with ``out = num / den`` in f32,
    all ``[b, h, s, 1]`` f32 but ``dout``.  With the scores rescored as the
    forward scores them, ``p = exp(score - m) / den`` (a division),
    ``dP = dout . v``, and ``dS = p (dP - D) * scale`` (the transpose of
    the forward's product by ``scale``): dq gains ``dS k``, dk ``dS^T q``
    and dv ``p^T dout``.  A later block (every key masked) adds nothing."""
    s, d = q.shape[-2:]
    scale = _scale(d, q.device)
    q32, k32, v32, do32 = q.float(), k_blk.float(), v_blk.float(), dout.float()
    scores = (q32 @ k32.transpose(-1, -2)) * scale
    p = torch.where(_seen(s, q_block, k_block, q.device), torch.exp(scores - m) / den, 0.0)
    d_s = p * ((do32 @ v32.transpose(-1, -2)) - big_d) * scale
    return (dq + d_s @ k32, dk_blk + d_s.transpose(-1, -2) @ q32,
            dv_blk + p.transpose(-1, -2) @ do32)


def _check(q, k_blk, v_blk, m, num, den) -> tuple[int, int, int, int]:
    if q.dim() != 4 or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ring_step takes f32 or bf16 q [b, h, s, d], got {q.dtype} {tuple(q.shape)}")
    b, h, s, d = q.shape
    for name, t in (("k_blk", k_blk), ("v_blk", v_blk)):
        if t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name} must match q's {q.dtype} {tuple(q.shape)}, got {t.dtype} {tuple(t.shape)}")
    for name, t, shape in (("m", m, (b, h, s, 1)), ("num", num, (b, h, s, d)), ("den", den, (b, h, s, 1))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be f32 {shape}, got {t.dtype} {tuple(t.shape)}")
    if q.numel() == 0:
        raise ValueError(f"ring_step takes a non-empty block, got {tuple(q.shape)}")
    return b, h, s, d


def _plain(what: str, tensors, q_block: int, k_block: int) -> bool:
    """True where every tensor lies on the CPU (the plain version), False
    where the kernel takes them; raise otherwise."""
    if q_block < 0 or k_block < 0:
        raise ValueError(f"ring positions are >= 0, got {q_block}, {k_block}")
    if all(t.device.type == "cpu" for t in tensors):
        return True
    q = tensors[0]
    if (q.device.type != "cuda" or any(t.device != q.device for t in tensors)
            or not all(t.is_contiguous() for t in tensors)):
        raise ValueError(f"{what}'s kernel takes contiguous tensors on one CUDA device")
    return False


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.library("ring_attention")
    for name, pointers in (("ring_step", 6), ("ring_step_bwd", 10)):
        for dtype in ("f32", "bf16"):
            fn = getattr(lib, f"{name}_{dtype}")
            fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _launch(name: str, tensors, b: int, h: int, s: int, d: int, q_block: int, k_block: int) -> None:
    lib = _library()
    fn = getattr(lib, f"{name}_{'bf16' if tensors[0].dtype == torch.bfloat16 else 'f32'}")
    with torch.cuda.device(tensors[0].device):
        status = fn(*(t.data_ptr() for t in tensors), b, h, s, d, q_block, k_block,
                    torch.cuda.current_stream().cuda_stream)
    build.check(lib, status, name)


def ring_step(q, k_blk, v_blk, m, num, den, q_block: int, k_block: int) -> tuple:
    """One ring step: updates the f32 carry ``m, den [b, h, s, 1]`` and
    ``num [b, h, s, d]`` in place and returns it.  ``q, k_blk, v_blk`` are
    f32 or bf16 ``[b, h, s, d]``; query ``i`` sits at ``q_block * s + i``
    and key ``j`` at ``k_block * s + j``.  The reference's carry is dead
    after each step, so updating it in place computes the same function
    without a copy (autograd goes through ``demo.RingAttention``, whose
    forward records no graph).  CPU tensors take the plain version; CUDA
    tensors one launch of one of four kernels, chosen by shape: a warp a
    query row under 256 keys, register tiles from there (and from 64 keys
    past 65535 batches or heads) up to heads of 128, register tiles that
    take the head in column chunks for any wider head from 64 keys (and
    under 64 past heads of 256), a second warp-a-row kernel for the rest.
    A later block (``k_block > q_block``), whose keys are all masked, is one
    launch too: its blocks exit at once and the carry keeps its bits."""
    b, h, s, d = _check(q, k_blk, v_blk, m, num, den)
    tensors = (q, k_blk, v_blk, m, num, den)
    if _plain("ring_step", tensors, q_block, k_block):
        for t, new in zip((m, num, den), ring_step_ref(*tensors, q_block, k_block)):
            t.copy_(new)
        return m, num, den
    _launch("ring_step", tensors, b, h, s, d, q_block, k_block)
    telemetry.count("kernels.ring_attention_step")
    return m, num, den


def ring_step_bwd(q, k_blk, v_blk, dout, m, den, big_d, q_block: int, k_block: int,
                  dq, dk_blk, dv_blk) -> tuple:
    """One backward ring step: adds the block's share into the f32
    accumulators ``dq, dk_blk, dv_blk [b, h, s, d]`` in place and returns
    them.  ``q, k_blk, v_blk, dout`` are f32 or bf16 ``[b, h, s, d]`` of one
    type; ``m, den, big_d`` f32 ``[b, h, s, 1]`` (see ``ring_step_bwd_ref``).
    CPU tensors take the plain version; CUDA tensors one launch of one of
    three kernels, chosen by shape (a warp a row under 64 keys up to heads
    of 256, register tiles up to heads of 128, register tiles that take the
    head in column chunks past it), whose blocks of a later block exit at
    once, leaving the accumulators' bits as they were."""
    b, h, s, d = _check(q, k_blk, v_blk, m, dq, den)
    for name, t, dtype, shape in (
        ("dout", dout, q.dtype, q.shape), ("big_d", big_d, torch.float32, m.shape),
        ("dk_blk", dk_blk, torch.float32, q.shape), ("dv_blk", dv_blk, torch.float32, q.shape),
    ):
        if t.dtype != dtype or t.shape != shape:
            raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    tensors = (q, k_blk, v_blk, dout, m, den, big_d, dq, dk_blk, dv_blk)
    if _plain("ring_step_bwd", tensors, q_block, k_block):
        for t, new in zip((dq, dk_blk, dv_blk), ring_step_bwd_ref(*tensors[:7], q_block, k_block,
                                                                  dq, dk_blk, dv_blk)):
            t.copy_(new)
        return dq, dk_blk, dv_blk
    _launch("ring_step_bwd", tensors, b, h, s, d, q_block, k_block)
    telemetry.count("kernels.ring_attention_step_bwd")
    return dq, dk_blk, dv_blk
