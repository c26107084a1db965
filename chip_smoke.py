"""Drive the PyTorch/CUDA port of the demo LM on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one Hopper card and
nvcc:

    python3 chip_smoke.py

(``python3 chip_smoke.py --second-paths`` prints the card and the second
paths' rows of (c) with the ring's wide rows alone, a failed check on its
row's line, and exits 0; ``--cell-shapes`` prints the card and (h'')'s
rows alone.)

Phases, each of which exits non-zero on a failed check:
  (a) print the card's name and power limit; pin the matmul numerics to
      f32 accumulation (no TF32, no reduced-precision bf16 reductions), as
      the reference accumulates;
  (b) build every kernel from the checkout's sources (one ``nvcc`` a CUDA
      source, all at once), print the seconds and each kernel's registers
      and spill bytes;
  (c) hold each kernel against its plain version at the main path's shapes
      (the forward's, the train step's, the ring's block steps: every mask
      case at three shapes for the ring step; RMSNorm's forward to bf16,
      cross entropy on bf16 logits and the MLP's two fused products, as
      the model launches them, also at the wide step's shapes, rows
      ``rmsnorm_wide``, ``cross_entropy_wide``, ``matmul_gelu_wide`` and
      ``matmul_gelu_bwd_wide``), require two launches on the
      same inputs to agree bit for bit, and time the kernel eagerly and
      from a CUDA graph, the plain version, and one PyTorch call that
      computes the same function (a yardstick only: the port never calls
      it; for a backward, PyTorch's backward op alone on its forward's
      saved outputs), also from a CUDA graph; for the MLP's products also
      the parent's route (the cuBLAS product alone, and with PyTorch's
      GELU after it), from a CUDA graph; print one JSON line per
      kernel, then the kernels ranked by device time over their PyTorch
      call's.  The ring step and its backward are checked at every mask
      case at several shapes (the backward at each edge of its tiled
      kernel) and timed at every block the ring phases launch them at
      (``RING_TIMED``, ``RING_BWD_TIMED``), each beside SDPA (its
      backward op) under the same mask, each bound counting the pairs the
      mask leaves.  The kernels that only shapes off
      the main path reach (attention's stream kernels at heads of 256 and
      at Llama 2 7B's [1, 4096, 32, 128], the ring step at a block of 2048
      keys) are checked and timed the same way (``second_path_rows``).
      Then each kernel past its former cap
      (``domain_checks``: the ring step and its backward also at heads of
      3073 and 4096).  The ring's wide kernels at heads of 256 (Gemma 7B's)
      are main-path rows since the wide rings of (g) run them
      (``RING_WIDE_TIMED``, ``RING_WIDE_BWD_TIMED``);
  (d) serve requests: ``entry()``'s forward on seeded token batches, each
      checked against the same forward on the CPU (plain versions), with
      every kernel's launch count read around those calls; print the
      forward's median time and tokens/s;
  (e) train: ``train_entry()``'s SGD step, 10 steps on one batch, with the
      launch counts of every step read, a falling loss, and the first
      step's loss and parameters checked against the same step on the CPU;
      print the step's median time and tokens/s;
  (f) open an NCCL process group of one rank (a ``file://`` rendezvous in
      a temporary directory) for (g) and (h);
  (e') the wide step: ``loss_fn``, ``value_and_grad`` and one
      ``train_step`` at ``DemoConfig(vocab=32000, seq_len=2048, batch=2)``
      (past cross entropy's and attention's former caps), with exact launch
      counts and the step's peak device memory, against the same step on
      the CPU;
  (g) ring attention: the 4-rank ring's schedule replayed in one process
      (at step j rank r holds block (r - j) % 4, every block step through
      the kernel; a 2-rank ring at seq 8192, whose blocks of 4096 keys
      include an earlier one; 2-rank rings at heads of 256 over seq 2048
      and 8192, ``RING_WIDE_SHAPES``), and the real ``ring_attention`` on the
      group of one, each against ``dense_causal_attention``; the replay
      checks the kernel and the merge, not NCCL.  Then the ring's
      gradient the same two ways (the replay with a backward schedule of
      its own), against autograd of ``dense_causal_attention`` at
      [8, 4, 64, 32], [1, 4, 1024, 32] and [1, 4, 4096, 32] (4 ranks) and
      ``RING_WIDE_SHAPES`` (2), with n backward steps a rank for each
      backward;
  (h) the sharded train step on the (1, 1) mesh at ``DemoConfig()``, 3
      eager steps (``step.fn``) with per-step launch counts, the first
      against ``train_step`` on the same parameters and tokens;
      ``run_dryrun(1)`` in this process and then
      ``entry.dryrun_multichip(1)``, which spawns its own rank (each
      replaying its step from a CUDA graph);
  (h') the captured paths, ``jit`` of (d)'s forward on its 4 requests, of
      (e)'s step chained over 10 steps (and at batch 4, a second
      signature), and the sharded step on the (1, 1) mesh over 3 steps,
      each bit for bit against the eager path, checked after every call
      was made (no call overwrites what an earlier one returned); the
      launch counters see each capture and no replay; one replay's
      kernels, counted by name under the profiler, are the eager path's
      launches; print the host medians beside the eager ones;
  (h'') attention's backward at the benchmark's long rows (``CELL_SHAPES``:
      Pythia-1.4B's [4, 2048, 16, 128], GPT-2 medium's [16, 1024, 16, 64]),
      checked and timed as (c)'s rows, beside cuDNN's backward, with its
      first launch's device time apart under the profiler (after (h')'s
      profiled calls: the profiler sets its clock at its first session) and
      that launch's bound; then RMSNorm's backward at the same cells' rows
      ([8192, 2048], [16384, 1024]) with a bf16 dy, beside
      PyTorch's fused RMSNorm backward; then the MLP's two fused products
      at the same cells' (M, K, N) (``MLP_CELL_SHAPES``), beside their
      bound as the benchmark counts it and cuBLASLt's product with a GELU
      epilogue; on a ``cell_shapes`` line with no
      launches (``--cell-shapes`` adds (c)'s RMSNorm backward row at
      ``DemoConfig()``'s shape);
  (i) print the ring phases' launches by block, mask and head width, then
      ``{"kernels": [...]}``, launches summed over (d), (e), (e'), (g) and
      (h) (not (h'), whose replays only the profiler counts; for the
      ``_wide`` rows, over (e'); for a ring row at one block,
      its launches at that block and mask in (g); the second paths went on
      a line of their own in (c), with no launches on the main path), then,
      last, the device line.
It imports nothing of JAX: the card's machine has none.
"""

from __future__ import annotations

import collections
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.distributed.device_mesh import init_device_mesh

from operator_forge_torch import demo, telemetry
from operator_forge_torch.entry import dryrun_multichip, entry, train_entry
from operator_forge_torch.jit import WARMUP_CALLS, jit
from operator_forge_torch.kernels import (
    attention, bf16_ulp, build, carry_close, grads_close, mlp, rmsnorm, run_twice,
    row_ulps, rows_close, step_tolerance, within_floored_ulps, wrapper_call,
)
from operator_forge_torch.kernels import cross_entropy as ce
from operator_forge_torch.kernels import ring_attention as ra

# H100 SXM peaks (NVIDIA's data sheet, dense): device memory, the bf16
# tensor cores, and f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
REQUESTS = 4
TRAIN_STEPS = 10
SHARDED_STEPS = 3
RING_RANKS = 4
# each wrapper's launch counter, ``kernels.<name>`` in ``telemetry``; the
# kernels line's cross_entropy sums the forward's and the backward's
COUNTERS = ("causal_attention", "rmsnorm", "matmul_gelu", "causal_attention_bwd", "rmsnorm_bwd",
            "matmul_gelu_bwd", "cross_entropy", "cross_entropy_bwd", "ring_attention_step",
            "ring_attention_step_bwd")
# the ring's gradient is checked at these [batch, heads, seq, head_dim]
# on RING_RANKS replayed ranks
RING_GRAD_SHAPES = ((1, 4, 1024, 32), (1, 4, 4096, 32))
# the wide rings, forward and gradient, each replayed on 2 ranks: heads of
# 256 (Gemma 7B's) over seq 2048 (blocks of 1024) and over Gemma's context
# of 8192 (blocks of 4096)
RING_WIDE_SHAPES = ((1, 4, 2048, 256), (1, 4, 8192, 256))
# the wide phase: Llama 2's vocabulary and a sequence of 2048, the other
# widths DemoConfig()'s
WIDE = dict(vocab=32000, seq_len=2048, batch=2)


def fail(message: str) -> None:
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int = 100, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events: what a caller pays, launch overhead included."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(fn, per_graph: int = 20, reps: int = 50) -> float:
    """Time per call of ``fn`` replayed from a CUDA graph of ``per_graph``
    calls: the device's time with the host's launch overhead taken out."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # warm: the first launch of a Triton kernel compiles it
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return time_ms(graph.replay, reps=reps) / per_graph


def reset_counts() -> None:
    telemetry.reset()


def read_counts() -> dict:
    return {name: telemetry.value(f"kernels.{name}") for name in COUNTERS}


def bound(bytes_moved: int, flops: int, flop_per_s: float, *more: tuple) -> tuple[float, str]:
    """The least time, in ms, of moving ``bytes_moved`` and of ``flops``
    operations at ``flop_per_s`` (and each further ``(flops, rate)`` pair,
    operations of another type, after them), whichever is longer."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = sum(f / rate for f, rate in ((flops, flop_per_s), *more)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: rc {smi.returncode}: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: nvcc {time.perf_counter() - t0:.2f} s, {len(build.sources())} sources")
    # each kernel's registers a thread and spill bytes, from ptxas
    print(json.dumps({"kernel_resources": {name: build.resources(name) for name in build.sources()}}))


def main_path_inputs(config: demo.DemoConfig) -> dict:
    """Seeded inputs at the shapes the forward pass and the train step
    give each kernel."""
    g = torch.Generator().manual_seed(7)
    b, s, d = config.batch, config.seq_len, config.d_model

    def normal(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).cuda()

    x = normal(b, s, d)
    gain = 1.0 + 0.1 * normal(d)
    # the MLP's operands: x as RMSNorm writes it, w1 scaled so that h_pre
    # has a scale of 3 (the GELU's whole range), h_pre of that scale
    w1 = normal(d, config.d_ff, scale=3.0 / math.sqrt(d)).bfloat16()
    w2 = normal(config.d_ff, d, scale=1.0 / math.sqrt(config.d_ff)).bfloat16()
    qkv = normal(b, s, 3 * d).bfloat16()
    targets = torch.randint(0, config.vocab, (b, s), generator=g).cuda()
    wide = demo.DemoConfig(**WIDE)
    rows = wide.batch * wide.seq_len
    return {
        "attention": (qkv, config.n_heads),
        "rmsnorm": (x, gain),
        "mlp": (normal(b, s, d).bfloat16(), w1),
        "attention_bwd": (qkv, normal(b, s, d).bfloat16(), config.n_heads),
        "rmsnorm_bwd": (x, gain, normal(b, s, d)),
        "mlp_bwd": (normal(b, s, d).bfloat16(), w2, normal(b, s, config.d_ff, scale=3.0).bfloat16()),
        "cross_entropy": (normal(b, s, config.vocab, scale=2.0).bfloat16(), targets,
                          torch.ones(()).cuda()),
        # the wide step's shapes: its RMSNorm rows and its logits
        "rmsnorm_wide": (normal(rows, d), 1.0 + 0.1 * normal(d)),
        "mlp_wide": (normal(rows, d).bfloat16(), w1),
        "mlp_bwd_wide": (normal(rows, d).bfloat16(), w2,
                         normal(rows, config.d_ff, scale=3.0).bfloat16()),
        "cross_entropy_wide": (normal(rows, wide.vocab, scale=2.0).bfloat16(),
                               torch.randint(0, wide.vocab, (rows,), generator=g).cuda(),
                               torch.ones(()).cuda()),
    }


def sdpa_backward(q, k, v, dout, mask=None):
    """SDPA's backward op alone, causal or under a boolean ``mask``, on the
    saved outputs of the forward that SDPA picks for these inputs, run once
    here: (the backend's name, a call that launches only the backward)."""
    aten = torch.ops.aten
    causal = mask is None
    picked = F.scaled_dot_product_attention(
        q.detach().requires_grad_(), k, v, attn_mask=mask, is_causal=causal).grad_fn.name()
    if not causal:
        if "Efficient" not in picked:
            fail(f"SDPA picked {picked} under a mask, which has no backward op to time alone")
        bias = torch.zeros(mask.shape, device=q.device).masked_fill(~mask, -math.inf)
        bias = bias.expand(q.shape[0], q.shape[1], *mask.shape).contiguous()
        out, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
            q, k, v, bias, True, 0.0, False)
        return picked, lambda: aten._scaled_dot_product_efficient_attention_backward(
            dout, q, k, v, bias, out, lse, seed, offset, 0.0, [True, True, True, False], False)
    if "Flash" in picked:
        out, lse, cum_q, cum_k, max_q, max_k, seed, offset, _ = \
            aten._scaled_dot_product_flash_attention(q, k, v, 0.0, True)
        return picked, lambda: aten._scaled_dot_product_flash_attention_backward(
            dout, q, k, v, out, lse, cum_q, cum_k, max_q, max_k, 0.0, True, seed, offset)
    if "Efficient" in picked:
        out, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
            q, k, v, None, True, 0.0, True)
        return picked, lambda: aten._scaled_dot_product_efficient_attention_backward(
            dout, q, k, v, None, out, lse, seed, offset, 0.0, [True, True, True, False], True)
    if "Cudnn" in picked:
        out, lse, cum_q, cum_k, max_q, max_k, seed, offset, _ = \
            aten._scaled_dot_product_cudnn_attention(q, k, v, None, True, 0.0, True)
        return picked, lambda: aten._scaled_dot_product_cudnn_attention_backward(
            dout, q, k, v, out, lse, seed, offset, None, cum_q, cum_k, max_q, max_k, 0.0, True)
    fail(f"SDPA picked {picked}, which has no backward op to time alone")


def rmsnorm_row(x, gain, name: str, reps: int = 100) -> dict:
    """RMSNorm's forward to bf16, as the model launches it: f32 within rtol
    1e-5 and atol 1e-6 of the plain version (the row sum is taken in
    another order), bf16 within 1 bf16 ulp of the plain value cast (both
    round an f32 value once).  Timed to bf16, beside ``F.rms_norm`` cast to
    bf16."""
    bf16 = torch.bfloat16
    want = rmsnorm.rmsnorm_ref(x, gain)
    got32 = rmsnorm.rmsnorm_fwd(x, gain)
    got = rmsnorm.rmsnorm_fwd(x, gain, bf16).float()
    want16 = want.to(bf16).float()
    return dict(
        name=name, shape=list(x.shape), route="cuda",
        source="operator_forge_torch/csrc/rmsnorm.cu",
        replaces="operator_forge/tpu/demo.py:71", reps=reps,
        fn=lambda: rmsnorm.rmsnorm_fwd(x, gain, bf16),
        plain=lambda: rmsnorm.rmsnorm_ref(x, gain).to(bf16),
        library=lambda: F.rms_norm(x, (x.shape[-1],), gain, eps=rmsnorm.EPS).to(bf16),
        err=torch.cat([(got32 - want).flatten(), (got - want16).flatten()]),
        tolerance="f32 rtol 1e-5, atol 1e-6; bf16 1 bf16 ulp of the plain value cast",
        ok=bool(((got32 - want).abs() <= 1e-6 + 1e-5 * want.abs()).all())
        and bool(((got - want16).abs() <= bf16_ulp(want16)).all()),
        # read x and gain, write bf16 y; square, sum, divide, scale: 4 f32
        # operations an element
        bound=bound(x.numel() * (4 + 2) + gain.numel() * 4, 4 * x.numel(), F32_FLOP_PER_S),
    )


def cross_entropy_row(logits, targets, grad, name: str, reps: int = 100) -> dict:
    """Cross entropy, forward then backward, on the bf16 logits the model
    gives it: the loss within rtol 1e-5 and bf16 dlogits within 1 bf16 ulp
    of the plain version's; on the widened logits, dlogits within 1e-7.
    Timed on bf16, beside ``F.cross_entropy`` on the widened logits with
    the gradient cast back (PyTorch's backward of the widening)."""
    def fwd_bwd(x, fwd, bwd):
        loss, lse = fwd(x, targets)
        return loss, bwd(x, targets, lse, grad)

    wide = logits.float()
    got = fwd_bwd(logits, ce.cross_entropy_fwd, ce.cross_entropy_bwd)
    want = fwd_bwd(logits, ce.cross_entropy_ref, ce.cross_entropy_bwd_ref)
    got32 = fwd_bwd(wide, ce.cross_entropy_fwd, ce.cross_entropy_bwd)
    want32 = fwd_bwd(wide, ce.cross_entropy_ref, ce.cross_entropy_bwd_ref)
    rows2d, t1d = logits.view(-1, logits.shape[-1]), targets.view(-1)
    lr = rows2d.detach().requires_grad_()
    want16 = want[1].float()
    return dict(
        name=name, shape=list(logits.shape), route="cuda",
        source="operator_forge_torch/csrc/cross_entropy.cu",
        replaces="operator_forge/tpu/demo.py:116", reps=reps,
        fn=lambda: fwd_bwd(logits, ce.cross_entropy_fwd, ce.cross_entropy_bwd),
        plain=lambda: fwd_bwd(logits, ce.cross_entropy_ref, ce.cross_entropy_bwd_ref),
        library=lambda: torch.autograd.grad(F.cross_entropy(lr.float(), t1d), lr),
        err=torch.cat([(got[0] - want[0]).view(1), (got[1].float() - want16).flatten()]),
        tolerance="loss rtol 1e-5; bf16 dlogits 1 bf16 ulp; f32 dlogits atol 1e-7",
        ok=all(bool((g[0] - w[0]).abs() <= 1e-5 * w[0].abs()) for g, w in ((got, want), (got32, want32)))
        and bool(((got[1].float() - want16).abs() <= bf16_ulp(want16)).all())
        and bool(((got32[1] - want32[1]).abs() <= 1e-7).all()),
        # read the bf16 logits and the targets, write the loss and bf16
        # dlogits; max, exp, sums, the gather and the backward's formula:
        # some 10 f32 operations an element
        bound=bound(2 * logits.numel() * 2 + targets.numel() * targets.element_size() + 4,
                    10 * logits.numel(), F32_FLOP_PER_S),
    )


def mlp_row(x, w1, name: str, reps: int = 100) -> dict:
    """The MLP's first product with the GELU in its epilogue, as the train
    step launches it (h_pre kept): h_pre within 1 bf16 ulp of the plain
    product's, each value floored at 2**-8 of the max (the f32 sum runs in
    another order); h within ``mlp.gelu_close`` of the plain GELU of that
    h_pre; and the served call (no h_pre) with h's bits.  Timed beside
    the plain version, the yardstick (``torch._addmm_activation`` on a zero
    bias: one cuBLASLt call with a tanh-GELU epilogue) and the parent's
    route: the cuBLAS product alone and followed by ``F.gelu`` (tanh)."""
    h, h_pre = mlp.matmul_gelu(x, w1)
    served, _ = mlp.matmul_gelu(x, w1, keep_pre=False)
    want_h, want_pre = mlp.matmul_gelu_ref(x, w1)
    k, n = w1.shape
    m = x.numel() // k
    x2, zero = x.view(m, k), torch.zeros(n, dtype=torch.bfloat16, device=x.device)
    return dict(
        name=name, shape=[m, k, n], route="cuda", source="operator_forge_torch/csrc/mlp.cu",
        replaces="operator_forge/tpu/demo.py:97", reps=reps,
        fn=lambda: mlp.matmul_gelu(x, w1),
        plain=lambda: mlp.matmul_gelu_ref(x, w1),
        library=lambda: torch._addmm_activation(zero, x2, w1, use_gelu=True),
        extra={"served": lambda: mlp.matmul_gelu(x, w1, keep_pre=False),
               "product": lambda: x @ w1,
               "route": lambda: F.gelu(x @ w1, approximate="tanh")},
        err=torch.cat([(h_pre.float() - want_pre.float()).flatten(),
                       (h.float() - want_h.float()).flatten()]),
        tolerance="h_pre 1 bf16 ulp of each value floored at 2**-8 of max|h_pre|; "
                  "h 1 bf16 ulp of max(|y|, 2**-8) of the plain GELU of h_pre",
        ok=within_floored_ulps(h_pre, want_pre, 1) and mlp.gelu_close(h, h_pre)
        and torch.equal(served, h),
        # read x and w1, write h and h_pre; the product's 2 M N K bf16
        # operations, then some 10 f32 operations an output for the GELU
        bound=bound((x.numel() + w1.numel() + 2 * m * n) * 2, 2 * m * n * k, BF16_FLOP_PER_S,
                    (10 * m * n, F32_FLOP_PER_S)),
    )


def mlp_bwd_row(dy, w2, h_pre, name: str, reps: int = 100) -> dict:
    """The backward's product dy @ w2ᵀ with the GELU's slope in its
    epilogue: dh_pre within 2 bf16 ulps of the plain version's, each value
    floored at 2**-8 of the max (the product's 1-ulp difference, scaled by
    a slope of up to 1.13 before the second rounding).  Timed beside
    the plain version, the yardstick (``dy @ w2.t()`` then
    ``aten.gelu_backward``, tanh: two calls, which are also the parent's
    route) and the cuBLAS product alone."""
    got = mlp.matmul_gelu_bwd(dy, w2, h_pre)
    want = mlp.matmul_gelu_bwd_ref(dy, w2, h_pre)
    n, d = w2.shape
    m = dy.numel() // d
    return dict(
        name=name, shape=[m, d, n], route="cuda", source="operator_forge_torch/csrc/mlp.cu",
        replaces="operator_forge/tpu/demo.py:98", reps=reps,
        fn=lambda: mlp.matmul_gelu_bwd(dy, w2, h_pre),
        plain=lambda: mlp.matmul_gelu_bwd_ref(dy, w2, h_pre),
        library=lambda: torch.ops.aten.gelu_backward(dy @ w2.t(), h_pre, approximate="tanh"),
        extra={"product": lambda: dy @ w2.t()},
        err=got.float() - want.float(),
        tolerance="dh_pre 2 bf16 ulps of each value floored at 2**-8 of max|dh_pre|",
        ok=within_floored_ulps(got, want, 2),
        # read dy, w2 and h_pre, write dh_pre; the product's 2 M N D bf16
        # operations, then some 20 f32 operations an output for the slope
        bound=bound((dy.numel() + w2.numel() + 2 * m * n) * 2, 2 * m * n * d, BF16_FLOP_PER_S,
                    (20 * m * n, F32_FLOP_PER_S)),
    )


def attention_row(qkv, n_heads: int, name: str, reps: int = 100) -> dict:
    """Attention's forward: within 3 bf16 ulps of each row's magnitude (a
    head of one query: a row's scale falls with the keys it sees) and 2 of
    the output's (``rows_close``; the kernel sums in another order than
    cuBLAS before each bf16 rounding), timed beside SDPA, causal."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    hd = d // n_heads
    got = attention.causal_attention_fwd(qkv, n_heads).float()
    want = attention.causal_attention_ref(qkv, n_heads).float()
    ulps = row_ulps(got, want, hd)
    q, k, v = qkv.view(b, s, 3, n_heads, hd).permute(2, 0, 3, 1, 4)
    return dict(
        name=name, shape=[b, s, n_heads, hd], route="cuda",
        source="operator_forge_torch/csrc/causal_attention.cu",
        replaces="operator_forge/tpu/demo.py:86", reps=reps,
        fn=lambda: attention.causal_attention_fwd(qkv, n_heads),
        plain=lambda: attention.causal_attention_ref(qkv, n_heads),
        library=lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        err=got - want,
        tolerance="3 bf16 ulps of each row's max|out| (a head of a query; floored at 2**-14 of the "
                  "max) and 2 of the max",
        ok=rows_close(got, want, hd), fields={"row_ulps": ulps},
        # causal q.k and p.v products: 2 * 2 * head_dim per (query, key <= query)
        bound=bound(qkv.numel() * 2 + b * s * d * 2,
                    4 * hd * b * n_heads * s * (s + 1) // 2, BF16_FLOP_PER_S),
    )


def attention_bwd_row(qkv, dout, n_heads: int, name: str, reps: int = 100) -> dict:
    """Attention's backward: dQ, dK and dV each within 3 bf16 ulps of each
    row's max (a head of one query for dQ, of one key for dK and dV) and 2
    of its own max (``rows_close``), timed beside SDPA's backward op
    alone."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    hd = d // n_heads
    got = attention.causal_attention_bwd(qkv, dout, n_heads)
    want = attention.causal_attention_bwd_ref(qkv, dout, n_heads)
    ulps = row_ulps(got, want, hd, 3)
    # the heads as SDPA takes them; its backward op timed alone
    q, k, v = (t.contiguous() for t in qkv.view(b, s, 3, n_heads, hd).permute(2, 0, 3, 1, 4))
    d_heads = dout.view(b, s, n_heads, hd).transpose(1, 2).contiguous()
    picked, sdpa_bwd = sdpa_backward(q, k, v, d_heads)
    return dict(
        name=name, shape=[b, s, n_heads, hd], route="cuda",
        source="operator_forge_torch/csrc/causal_attention.cu",
        replaces="operator_forge/tpu/demo.py:86", reps=reps,
        fn=lambda: attention.causal_attention_bwd(qkv, dout, n_heads),
        plain=lambda: attention.causal_attention_bwd_ref(qkv, dout, n_heads),
        library=sdpa_bwd, library_op=picked,
        err=(got.float() - want.float()),
        tolerance="3 bf16 ulps of each row's max (a head of a query for dq, of a key for dk, dv; "
                  "floored at 2**-14 of the part's max) and 2 of the part's max",
        ok=rows_close(got, want, hd, 3), fields={"row_ulps": ulps},
        # read qkv and dout, write dqkv; five causal products (the score
        # recompute, dP, dV, dQ, dK) of 2 * head_dim each
        bound=bound(2 * qkv.numel() * 2 + dout.numel() * 2,
                    5 * 2 * hd * b * n_heads * s * (s + 1) // 2, BF16_FLOP_PER_S),
    )


def rmsnorm_bwd_row(x, gain, dy, name: str, reps: int = 100) -> dict:
    """RMSNorm's backward, dx and dgain within rtol 1e-5 and atol 1e-6 of
    each output's max, beside PyTorch's fused RMSNorm backward alone on its
    forward's saved rstd (on dy in f32).  A bf16 dy goes the model's way,
    ``rmsnorm_bwd_bf16`` (``rmsnorm_to_bf16``'s backward)."""
    bf16 = dy.dtype == torch.bfloat16
    call = (lambda: rmsnorm.rmsnorm_bwd_bf16(x, gain, dy)) if bf16 else (
        lambda: rmsnorm.rmsnorm_bwd(x, gain, dy))
    dy32 = dy.float()
    got = call()
    want = rmsnorm.rmsnorm_bwd_ref(x, gain, dy32)
    _, rstd = torch.ops.aten._fused_rms_norm(x, [x.shape[-1]], gain, rmsnorm.EPS)
    return dict(
        name=name, shape=list(x.shape), route="cuda",
        source="operator_forge_torch/csrc/rmsnorm_bwd.cu",
        replaces="operator_forge/tpu/demo.py:71", reps=reps,
        fn=call,
        plain=lambda: rmsnorm.rmsnorm_bwd_ref(x, gain, dy32),
        library=lambda: torch.ops.aten._fused_rms_norm_backward(
            dy32, x, [x.shape[-1]], rstd, gain, [True, True]),
        err=torch.cat([(g - w).flatten() for g, w in zip(got, want)]),
        tolerance="rtol 1e-5, atol 1e-6 of max|dx| and of max|dgain|",
        ok=all(bool(((g - w).abs() <= 1e-6 * w.abs().max() + 1e-5 * w.abs()).all())
               for g, w in zip(got, want)),
        fields={"dy": str(dy.dtype).removeprefix("torch.")},
        # read x and dy, write dx (gain and dgain beside them); some 11 f32
        # operations an element
        bound=bound(x.numel() * (4 + dy.element_size() + 4) + 2 * gain.numel() * 4,
                    11 * x.numel(), F32_FLOP_PER_S),
    )


def backward_rows(inputs: dict) -> list[dict]:
    """The train step's kernels: the three backwards and cross entropy."""
    rows = [attention_bwd_row(*inputs["attention_bwd"], "causal_attention_bwd")]
    rows.append(rmsnorm_bwd_row(*inputs["rmsnorm_bwd"], "rmsnorm_bwd"))

    rows.append(mlp_bwd_row(*inputs["mlp_bwd"], "matmul_gelu_bwd"))
    rows.append(mlp_bwd_row(*inputs["mlp_bwd_wide"], "matmul_gelu_bwd_wide"))

    rows.append(cross_entropy_row(*inputs["cross_entropy"], "cross_entropy"))
    rows.append(cross_entropy_row(*inputs["cross_entropy_wide"], "cross_entropy_wide", reps=10))
    return rows


# (query block, visiting block, carry) of one ring step on rank 2 of a
# 4-rank ring: the diagonal, an earlier block, a later (fully masked)
# block, and the ring's first step from m = -inf
RING_CASES = {
    "diagonal": (2, 2, "seen"), "earlier": (2, 1, "seen"),
    "later": (2, 3, "seen"), "first": (2, 2, "fresh"),
}


def mask_of(my: int, origin: int) -> str:
    """The mask a step of query block ``my`` against block ``origin`` sees."""
    return "diagonal" if origin == my else "earlier" if origin < my else "later"


def mask_pairs(b: int, h: int, s: int, mask: str) -> int:
    """The (query, key) pairs a block step's mask leaves: s^2 for an
    earlier block, s (s + 1) / 2 on the diagonal, a plane."""
    return b * h * (s * s if mask == "earlier" else s * (s + 1) // 2)


def ring_case(shape, dtype, case, g):
    """q, k, v of one ring step on the card and its carry, fresh or after
    the diagonal block of other keys (through the plain version)."""
    q, k, v, k0, v0 = (torch.randn(shape, generator=g).cuda().to(dtype) for _ in range(5))
    b, h, s, d = shape
    carry = (torch.full((b, h, s, 1), -math.inf, device="cuda"),
             torch.zeros(shape, device="cuda"), torch.zeros((b, h, s, 1), device="cuda"))
    my, origin, kind = RING_CASES[case]
    if kind == "seen":
        carry = ra.ring_step_ref(q, k0, v0, *carry, my, my)
    return (q, k, v), carry, my, origin


def sdpa_mask(s: int, mask: str):
    """SDPA's boolean mask for a block step: every key for an earlier
    block, None (causal) on the diagonal."""
    return torch.ones(s, s, dtype=torch.bool, device="cuda") if mask == "earlier" else None


def ring_block_row(name: str, shape, case: str, g) -> dict:
    """The ring's block step at one block the ring phases launch it at,
    f32: the carry within rtol and atol 2e-5 of the plain version (past
    1024 keys, atol 2e-5 of each part's max), timed beside SDPA under the
    same mask, its bound counting the pairs the mask leaves."""
    (q, k, v), carry, my, origin = ring_case(shape, torch.float32, case, g)
    b, h, s, d = shape
    mask = mask_of(my, origin)
    want = ra.ring_step_ref(q, k, v, *carry, my, origin)
    got = ra.ring_step(q, k, v, *(t.clone() for t in carry), my, origin)
    scratch = [t.clone() for t in carry]
    attn_mask = sdpa_mask(s, mask)
    carry_bytes = sum(t.numel() * 4 for t in carry)
    return dict(
        name=name, shape=list(shape), block=["fwd", s, mask, d], route="cuda",
        source="operator_forge_torch/csrc/ring_attention.cu",
        replaces="operator_forge/tpu/demo.py:276", reps=10 if s >= 1024 else 100,
        fn=lambda: ra.ring_step(q, k, v, *scratch, my, origin),
        repeat=lambda: ra.ring_step(q, k, v, *(t.clone() for t in carry), my, origin),
        plain=lambda: ra.ring_step_ref(q, k, v, *carry, my, origin),
        library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                                       is_causal=attn_mask is None),
        err=torch.tensor([max(float((a - w).abs()[torch.isfinite(w)].max()) for a, w in zip(got, want))]),
        tolerance="rtol and atol 2e-5 (past 1024 keys atol 2e-5 of each part's max); "
                  "-inf in the same places",
        ok=all(carry_close(a, w, scaled=s > 1024) for a, w in zip(got, want)),
        # read q, k, v and the carry, write the carry; per pair the mask
        # leaves: the two f32 products (2 * 2 * d) and the scale, exp and sum
        bound=bound(3 * q.numel() * 4 + 2 * carry_bytes, (4 * d + 4) * mask_pairs(b, h, s, mask),
                    F32_FLOP_PER_S),
    )


# the ring step's timed rows, at the blocks the ring phases launch it at:
# (name, [batch, heads, block, head_dim], case); the first is DemoConfig()'s
# heads over seq 64 on 4 ranks
RING_TIMED = (("ring_attention_step", (8, 4, 16, 32), "earlier"),
              ("ring_attention_step_256", (1, 4, 256, 32), "earlier"),
              ("ring_attention_step_1024", (1, 4, 1024, 32), "earlier"),
              ("ring_attention_step_1024d", (1, 4, 1024, 32), "diagonal"),
              ("ring_attention_step_4096", (1, 4, 4096, 32), "first"),
              ("ring_attention_step_4096e", (1, 4, 4096, 32), "earlier"))


def ring_rows(config: demo.DemoConfig) -> list[dict]:
    """The ring's block step at every mask case, at the ring of
    ``DemoConfig()``'s heads over seq 64 on 4 ranks, a longer block, a
    ragged one (also in bf16) and heads of the wide kernel (256 at its
    first block, 257, bf16 200): the carry within rtol and atol 2e-5 of the
    plain version, the same bits from two launches, and a later block's
    carry left bit for bit.  Each case's times at the first shape go on a
    line of their own; then one row a block of ``RING_TIMED``."""
    g = torch.Generator().manual_seed(11)
    first = (config.batch, config.n_heads, config.seq_len // RING_RANKS, config.head_dim)
    shapes = [(first, torch.float32), ((1, config.n_heads, 256, config.head_dim), torch.float32),
              ((2, 3, 17, 16), torch.float32), ((2, 3, 17, 16), torch.bfloat16),
              ((1, 2, 64, 256), torch.float32), ((1, 2, 65, 257), torch.float32),
              ((2, 2, 100, 200), torch.bfloat16)]
    cases = {}
    for shape, dtype in shapes:
        for case in RING_CASES:
            qkv, carry, my, origin = ring_case(shape, dtype, case, g)
            want = ra.ring_step_ref(*qkv, *carry, my, origin)
            got, same = run_twice(lambda: ra.ring_step(*qkv, *(t.clone() for t in carry), my, origin))
            where = f"ring_attention_step {case} {tuple(shape)} {dtype}"
            if not same:
                fail(f"{where}: two launches on the same inputs differ")
            if not all(carry_close(a, b) for a, b in zip(got, want)):
                fail(f"{where} disagrees with its plain version beyond rtol and atol 2e-5")
            if case == "later" and not all(torch.equal(a, b) for a, b in zip(got, carry)):
                fail(f"{where}: a fully masked block changed the carry")
            if shape == first:
                scratch = [t.clone() for t in carry]
                cases[case] = {
                    "ms": time_ms(lambda: ra.ring_step(*qkv, *scratch, my, origin)),
                    "graph_ms": graph_ms(lambda: ra.ring_step(*qkv, *scratch, my, origin)),
                }
    print(json.dumps({"ring_attention_step_cases": {"shape": list(first), **cases}}))
    return [ring_block_row(name, shape, case, g) for name, shape, case in RING_TIMED]


def ring_bwd_case(shape, dtype, case, g):
    """The inputs of one backward ring step on the card: q, k, v and dout,
    the final (m, den) of a forward over the case's blocks (the plain
    version), each row's D, and accumulators that already hold sums."""
    (q, k, v), carry, my, origin = ring_case(shape, dtype, case, g)
    m, num, den = ra.ring_step_ref(q, k, v, *carry, my, origin)
    dout = torch.randn(shape, generator=g).cuda().to(dtype)
    big_d = (dout.float() * (num / den)).sum(dim=-1, keepdim=True)
    acc = [torch.randn(shape, generator=g).cuda() for _ in range(3)]
    return (q, k, v, dout, m, den, big_d), my, origin, acc


# the backward step's checked shapes: the ring of DemoConfig()'s heads over
# 4 ranks (f32 and bf16) on the row kernel; on the tiled kernel the blocks
# one under, at and one over its first block (64 keys), a 32-row tile and
# a 64-row chunk, a 64-row tile, and the tiles whose chunks two blocks of
# a cluster share (from 256 keys); heads not a multiple of 4, odd and
# bf16, the widest it takes (also on 64-row tiles, one buffer) and one past
# it (the wide kernel, as is the head of 160); longer blocks, one past the
# forward's former cap of 1024 keys; on the wide kernel, heads of
# 256 under (the row kernel), at and over 64 rows, a head of 257 (a second
# output pass), bf16 heads of 200, and a split walk from 256 rows
RING_BWD_SHAPES = (((8, 4, 16, 32), torch.float32), ((8, 4, 16, 32), torch.bfloat16),
                   ((1, 1, 63, 32), torch.float32), ((1, 1, 64, 32), torch.float32),
                   ((1, 1, 65, 32), torch.float32), ((1, 2, 96, 32), torch.float32),
                   ((1, 2, 97, 32), torch.float32), ((1, 2, 129, 32), torch.float32),
                   ((16, 8, 128, 32), torch.float32), ((16, 8, 129, 32), torch.float32),
                   ((1, 1, 255, 32), torch.float32), ((1, 1, 257, 32), torch.float32),
                   ((1, 2, 300, 48), torch.bfloat16),
                   ((1, 2, 150, 20), torch.float32), ((2, 2, 100, 33), torch.bfloat16),
                   ((1, 2, 128, 128), torch.float32), ((16, 8, 128, 128), torch.float32),
                   ((1, 2, 128, 129), torch.float32), ((1, 2, 64, 160), torch.float32),
                   ((1, 4, 256, 32), torch.float32), ((1, 4, 2048, 32), torch.float32),
                   ((1, 2, 63, 256), torch.float32), ((1, 2, 64, 256), torch.float32),
                   ((1, 2, 65, 257), torch.float32), ((2, 2, 100, 200), torch.bfloat16),
                   ((1, 2, 256, 256), torch.float32))

# the backward step's timed rows, at every block the ring's gradient
# (phase_ring_grad) launches it at
RING_BWD_TIMED = (("ring_attention_step_bwd", (8, 4, 16, 32), "earlier"),
                  ("ring_attention_step_bwd_64", (8, 4, 64, 32), "diagonal"),
                  ("ring_attention_step_bwd_256", (1, 4, 256, 32), "earlier"),
                  ("ring_attention_step_bwd_1024", (1, 4, 1024, 32), "earlier"),
                  ("ring_attention_step_bwd_1024d", (1, 4, 1024, 32), "diagonal"),
                  ("ring_attention_step_bwd_4096", (1, 4, 4096, 32), "diagonal"))


def ring_bwd_block_row(name: str, shape, case: str, g) -> dict:
    """The backward step at one block the ring's gradient launches it at,
    f32, from zero accumulators (so that the error is the block's own
    sums'): dq, dk and dv within ``grads_close`` of the plain version,
    timed beside SDPA's backward op under the same mask, its bound counting
    the pairs the mask leaves."""
    inputs, my, origin, acc = ring_bwd_case(shape, torch.float32, case, g)
    acc = [torch.zeros_like(t) for t in acc]
    b, h, s, d = shape
    mask = mask_of(my, origin)
    want = ra.ring_step_bwd_ref(*inputs, my, origin, *acc)
    got = ra.ring_step_bwd(*inputs, my, origin, *(t.clone() for t in acc))
    scratch = [t.clone() for t in acc]
    q, k, v, dout = inputs[:4]
    picked, sdpa_bwd = sdpa_backward(q, k, v, dout, sdpa_mask(s, mask))
    return dict(
        name=name, shape=list(shape), block=["bwd", s, mask, d], route="cuda",
        source="operator_forge_torch/csrc/ring_attention.cu",
        replaces="operator_forge/tpu/demo.py:276", reps=10 if s >= 1024 else 100,
        fn=lambda: ra.ring_step_bwd(*inputs, my, origin, *scratch),
        repeat=lambda: ra.ring_step_bwd(*inputs, my, origin, *(t.clone() for t in acc)),
        plain=lambda: ra.ring_step_bwd_ref(*inputs, my, origin, *acc),
        library=sdpa_bwd, library_op=picked,
        err=torch.cat([(a - w).flatten() for a, w in zip(got, want)]),
        tolerance="rtol and atol 2e-5 of each output's max (grads_close)",
        ok=all(grads_close(a, w) for a, w in zip(got, want)),
        # read q, k, v, dout and m, den, D; read and write dq, dk, dv; five
        # products of 2 * d per pair the mask leaves
        bound=bound(4 * q.numel() * 4 + 3 * b * h * s * 4 + 6 * q.numel() * 4,
                    5 * 2 * d * mask_pairs(b, h, s, mask), F32_FLOP_PER_S),
    )


def ring_bwd_rows() -> list[dict]:
    """The ring's backward block step at every mask case and every shape
    of ``RING_BWD_SHAPES``: dq, dk and dv within ``grads_close`` of the
    plain version, the same bits from two launches, a later block's
    accumulators left bit for bit.  Each case's times at the first shape go
    on a line of their own; then one row a block of ``RING_BWD_TIMED``."""
    g = torch.Generator().manual_seed(17)
    cases = {}
    first = RING_BWD_SHAPES[0][0]
    for shape, dtype in RING_BWD_SHAPES:
        for case in RING_CASES:
            inputs, my, origin, acc = ring_bwd_case(shape, dtype, case, g)
            want = ra.ring_step_bwd_ref(*inputs, my, origin, *acc)
            got, same = run_twice(lambda: ra.ring_step_bwd(*inputs, my, origin, *(t.clone() for t in acc)))
            where = f"ring_attention_step_bwd {case} {tuple(shape)} {dtype}"
            if not same:
                fail(f"{where}: two launches on the same inputs differ")
            if not all(grads_close(a, b) for a, b in zip(got, want)):
                fail(f"{where} disagrees with its plain version beyond rtol and atol 2e-5 of its max")
            if case == "later" and not all(torch.equal(a, b) for a, b in zip(got, acc)):
                fail(f"{where}: a fully masked block changed the accumulators")
            if shape == first and dtype == torch.float32:
                scratch = [t.clone() for t in acc]
                cases[case] = {"graph_ms": graph_ms(lambda: ra.ring_step_bwd(*inputs, my, origin, *scratch))}
    print(json.dumps({"ring_attention_step_bwd_cases": {"shape": list(first), **cases}}))
    return [ring_bwd_block_row(name, shape, case, g) for name, shape, case in RING_BWD_TIMED]


# the ring's wide kernels at heads of 256 (Gemma 7B's), at the blocks the
# wide rings of phase (g) launch them at: 1024 keys earlier (a 2-rank ring
# over 2048) and 4096 on the diagonal (Gemma's context of 8192 on 2 ranks)
RING_WIDE_TIMED = (("ring_attention_step_hd256", (1, 4, 1024, 256), "earlier"),
                   ("ring_attention_step_hd256_4096", (1, 4, 4096, 256), "diagonal"))
RING_WIDE_BWD_TIMED = (("ring_attention_step_bwd_hd256", (1, 4, 1024, 256), "earlier"),
                       ("ring_attention_step_bwd_hd256_4096", (1, 4, 4096, 256), "diagonal"))


def wide_ring_rows() -> list[dict]:
    """The ring step and its backward at ``RING_WIDE_TIMED`` and
    ``RING_WIDE_BWD_TIMED``, checked and timed as the other ring rows."""
    g = torch.Generator().manual_seed(31)
    return ([ring_block_row(name, shape, case, g) for name, shape, case in RING_WIDE_TIMED]
            + [ring_bwd_block_row(name, shape, case, g) for name, shape, case in RING_WIDE_BWD_TIMED])


def second_path_rows() -> list[dict]:
    """The kernels that only shapes off the main path reach: attention's
    stream kernels, forward and backward, at heads of 256 (Gemma 7B's) at
    the wide step's seq of 2048 and DemoConfig()'s 4 heads, and at Llama 2
    7B's attention, 32 heads of 128 at its context of 4096, whose spilled
    scores the tiles path cannot hold; the ring step at the domain check's
    block of 2048 keys, earlier.  Each checked and timed as the main path's
    rows are."""
    g = torch.Generator().manual_seed(29)
    rows = []
    for name, (b, s, n_heads, hd) in (("hd256", (1, 2048, 4, 256)),
                                      ("llama2_7b", (1, 4096, 32, 128))):
        qkv = torch.randn((b, s, 3 * n_heads * hd), generator=g).cuda().bfloat16()
        dout = torch.randn((b, s, n_heads * hd), generator=g).cuda().bfloat16()
        rows += [attention_row(qkv, n_heads, f"causal_attention_{name}", reps=10),
                 attention_bwd_row(qkv, dout, n_heads, f"causal_attention_bwd_{name}", reps=10)]
    return rows + [ring_block_row("ring_attention_step_2048", (1, 4, 2048, 32), "earlier", g)]


# the benchmark's long rows: Pythia-1.4B's and GPT-2 medium's attention
# backward at their cells' [batch, seq, heads, head_dim]
CELL_SHAPES = (("pythia_1_4b", (4, 2048, 16, 128)), ("gpt2_medium", (16, 1024, 16, 64)))
# the same cells' MLP products, (tokens M, d_model K, d_ff N)
MLP_CELL_SHAPES = (("pythia_1_4b", (8192, 2048, 8192)), ("gpt2_medium", (16384, 1024, 4096)))


def kernel_device_ms(call, kernel: str, calls: int = 10) -> float | None:
    """Mean device ms that a call of ``call`` spends in the kernel named
    ``kernel`` (one launch a call), from the profiler's CUDA activities; None
    where it records another count.  Run after every other profiled phase:
    the profiler's clock conversion is set at a process's first session."""
    call()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    found = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and f"{kernel}<" in e.name]
    return sum(found) / calls / 1e3 if len(found) == calls else None


def cell_rows() -> list[dict]:
    """Attention's backward at the benchmark's long rows, checked and timed
    as the main path's rows are, with its first launch's device time apart
    (``dq_device_ms``) beside that launch's bound: its three causal products
    (S, dP, dQ) at the bf16 rate.  Then RMSNorm's backward at the same
    cells' rows, ``[b * s, n_heads * head_dim]`` with a bf16 dy, as
    ``rmsnorm_to_bf16``'s backward runs it; beside it the same call on dy
    in f32 (``f32_dy_graph_ms``)."""
    g = torch.Generator().manual_seed(37)
    rows = []
    for name, (b, s, n_heads, hd) in CELL_SHAPES:
        qkv = torch.randn((b, s, 3 * n_heads * hd), generator=g).cuda().bfloat16()
        dout = torch.randn((b, s, n_heads * hd), generator=g).cuda().bfloat16()
        row = attention_bwd_row(qkv, dout, n_heads, f"causal_attention_bwd_{name}", reps=10)
        # the call's dQ takes the long-row design: its counter moves by one
        before = telemetry.value("kernels.causal_attention_bwd.rows64")
        row["fn"]()
        if telemetry.value("kernels.causal_attention_bwd.rows64") != before + 1:
            fail(f"{row['name']}: dQ did not take the long-row design")
        row["fields"].update(
            rows64=True,
            dq_device_ms=kernel_device_ms(row["fn"], "causal_attention_bwd_dq_kernel"),
            dq_bound_ms=3 * 2 * hd * b * n_heads * s * (s + 1) // 2 / BF16_FLOP_PER_S * 1e3)
        rows.append(row)
    g_norm = torch.Generator().manual_seed(38)
    for name, (b, s, n_heads, hd) in CELL_SHAPES:
        x = (3.0 * torch.randn((b * s, n_heads * hd), generator=g_norm)).cuda()
        dy = torch.randn(x.shape, generator=g_norm).cuda().bfloat16()
        gain = (1.0 + 0.1 * torch.randn(x.shape[-1:], generator=g_norm)).cuda()
        row = rmsnorm_bwd_row(x, gain, dy, f"rmsnorm_bwd_{name}", reps=20)
        row["extra"] = {"f32_dy": lambda x=x, gain=gain, dy32=dy.float():
                        rmsnorm.rmsnorm_bwd(x, gain, dy32)}
        rows.append(row)
    return rows + mlp_cell_rows()


def mlp_cell_rows() -> list[dict]:
    """The MLP's two fused products at the benchmark cells' shapes,
    checked and timed as (c)'s rows, each beside its bound as the
    benchmark counts it (``portbench/counts.py::mlp_kernel_call``: inputs
    read once, outputs written once, h_pre kept; the product's 2 M N K at
    the bf16 rate, the epilogue's work not counted) and cuBLASLt's product
    with a GELU epilogue (``torch._addmm_activation``; the backward's is the
    same product, ``dy @ w2ᵀ``, with the GELU rather than its slope) as the
    yardstick; ``wgmma`` says whether the call took the wgmma design."""
    g = torch.Generator().manual_seed(39)
    rows = []
    for name, (m, k, n) in MLP_CELL_SHAPES:
        x = torch.randn((m, k), generator=g).cuda().bfloat16()
        w1 = (3.0 / math.sqrt(k) * torch.randn((k, n), generator=g)).cuda().bfloat16()
        w2 = (1.0 / math.sqrt(k) * torch.randn((n, k), generator=g)).cuda().bfloat16()
        h_pre = (3.0 * torch.randn((m, n), generator=g)).cuda().bfloat16()
        zero = torch.zeros(n, dtype=torch.bfloat16, device="cuda")
        fwd = mlp_row(x, w1, f"matmul_gelu_{name}", reps=20)
        bwd = mlp_bwd_row(x, w2, h_pre, f"matmul_gelu_bwd_{name}", reps=20)
        bwd["library"] = lambda x=x, w2=w2, zero=zero: torch._addmm_activation(
            zero, x, w2.t(), use_gelu=True)
        for row, counter in ((fwd, "matmul_gelu"), (bwd, "matmul_gelu_bwd")):
            row["bound"] = bound(2 * (m * k + k * n + 2 * m * n), 2 * m * n * k, BF16_FLOP_PER_S)
            before = telemetry.value(f"kernels.{counter}.wgmma")
            row["fn"]()
            row["fields"] = {"wgmma": telemetry.value(f"kernels.{counter}.wgmma") == before + 1}
            rows.append(row)
    return rows


def ring_step_f64(q, k, v, m, num, den, my: int, origin: int) -> tuple:
    """The ring step in float64 (the reference's lines, without f32
    rounding): what the kernel and the plain version are both measured
    against at a long block."""
    s, d = q.shape[-2:]
    scores = (q.double() @ k.double().transpose(-1, -2)) / math.sqrt(d)
    q_pos = my * s + torch.arange(s, device=q.device)[:, None]
    k_pos = origin * s + torch.arange(s, device=q.device)[None, :]
    scores = torch.where(k_pos <= q_pos, scores, -math.inf)
    new_m = torch.maximum(m.double(), scores.amax(dim=-1, keepdim=True))
    shift = torch.where(torch.isinf(new_m), 0.0, new_m)
    correction, probs = torch.exp(m.double() - shift), torch.exp(scores - shift)
    return (new_m, num.double() * correction + probs @ v.double(),
            den.double() * correction + probs.sum(dim=-1, keepdim=True))


def domain_checks() -> None:
    """Each kernel against its plain version past its former cap, at the
    widths the reference computes: cross entropy over Llama 2's 32000
    tokens and past what shared memory holds, RMSNorm over 20480 and 70000
    columns (each in f32 and to bf16), attention at seq 2048, at heads of
    256 (Gemma 7B's), at seq 4096 of heads of 128, at heads of 200 (not a
    multiple of 8), 3073 and 4096 (past the former cap of 3072), each
    repeated bit for bit, the ring step at a block of 2048 keys, the ring
    step and its backward at heads of 3073 and 4096, earlier and on the
    diagonal, each repeated bit for bit, and the
    MLP's two products at odd widths (on small and large tiles), a depth
    of 1, a depth of 4096, 2188 column tiles and with every operand off a
    16-byte boundary.  The
    tolerances are the kernels' rows'; these launches count on no path."""
    g = torch.Generator().manual_seed(19)

    def normal(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).cuda()

    checks = []
    # cross entropy over 32000 logits (staged in shared memory), and past
    # what shared memory holds in f32 (70000) and in bf16 (120000)
    for rows, vocab, dtype in ((256, 32000, torch.float32), (256, 32000, torch.bfloat16),
                               (2, 70000, torch.float32), (2, 120000, torch.bfloat16)):
        logits = normal(rows, vocab, scale=2.0).to(dtype)
        targets = torch.randint(0, vocab, (rows,), generator=g).cuda()
        grad = torch.ones(()).cuda()
        loss, lse = ce.cross_entropy_fwd(logits, targets)
        want_loss, want_lse = ce.cross_entropy_ref(logits, targets)
        dx = ce.cross_entropy_bwd(logits, targets, lse, grad).float()
        want_dx = ce.cross_entropy_bwd_ref(logits, targets, want_lse, grad).float()
        tol = 1e-7 if dtype == torch.float32 else bf16_ulp(want_dx)
        checks.append((f"cross_entropy {dtype}", [rows, vocab], float((dx - want_dx).abs().max()),
                       bool((loss - want_loss).abs() <= 1e-5 * want_loss.abs())
                       and bool(((dx - want_dx).abs() <= tol).all())))

    for rows, d in ((256, 20480), (4, 70000)):
        x, gain = normal(rows, d, scale=3.0), normal(d)
        y, want_y = rmsnorm.rmsnorm_fwd(x, gain), rmsnorm.rmsnorm_ref(x, gain)
        y16, want16 = rmsnorm.rmsnorm_fwd(x, gain, torch.bfloat16).float(), want_y.bfloat16().float()
        checks.append(("rmsnorm", [rows, d], float((y - want_y).abs().max()),
                       bool(((y - want_y).abs() <= 1e-6 + 1e-5 * want_y.abs()).all())
                       and bool(((y16 - want16).abs() <= bf16_ulp(want16)).all())))
    def unaligned(t):
        """``t``, contiguous, 2 bytes past a 16-byte boundary."""
        out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
        return out.view(t.shape).copy_(t)

    for m, k, n, shift in ((91, 72, 200, False), (3, 1, 5, False), (1000, 130, 77, False),
                           (3000, 72, 1000, False), (64, 4096, 96, False), (7, 16, 70000, False),
                           (91, 72, 200, True), (3000, 72, 1000, True)):
        place = unaligned if shift else (lambda t: t)
        where = "unaligned" if shift else "aligned"
        x = place(normal(m, k).bfloat16())
        w1 = place(normal(k, n, scale=3.0 / math.sqrt(k)).bfloat16())
        h, h_pre = mlp.matmul_gelu(x, w1)
        want_pre = mlp.matmul_gelu_ref(x, w1)[1]
        checks.append((f"matmul_gelu ({where})", [m, k, n],
                       float((h_pre.float() - want_pre.float()).abs().max()),
                       within_floored_ulps(h_pre, want_pre, 1) and mlp.gelu_close(h, h_pre)))
        dy = place(normal(m, k).bfloat16())
        w2 = place(normal(n, k, scale=1.0 / math.sqrt(k)).bfloat16())
        pre = place(normal(m, n, scale=3.0).bfloat16())
        got, want = mlp.matmul_gelu_bwd(dy, w2, pre), mlp.matmul_gelu_bwd_ref(dy, w2, pre)
        checks.append((f"matmul_gelu_bwd ({where})", [m, k, n],
                       float((got.float() - want.float()).abs().max()), within_floored_ulps(got, want, 2)))

    x, gain, dy = normal(256, 20480, scale=3.0), normal(20480), normal(256, 20480)
    got, want = rmsnorm.rmsnorm_bwd(x, gain, dy), rmsnorm.rmsnorm_bwd_ref(x, gain, dy)
    checks.append(("rmsnorm_bwd", [256, 20480], max(float((a - b).abs().max()) for a, b in zip(got, want)),
                   all(bool(((a - b).abs() <= 1e-6 * b.abs().max() + 1e-5 * b.abs()).all())
                       for a, b in zip(got, want))))

    row_errs = []  # attention's largest errors, bf16 ulps of their rows and parts
    for b, s, n_heads, hd in ((1, 2048, 4, 32), (2, 128, 2, 256), (1, 4096, 4, 128),
                              (2, 33, 2, 200), (1, 8, 1, 3073), (1, 40, 1, 4096)):
        qkv = normal(b, s, 3 * n_heads * hd).bfloat16()
        dout = normal(b, s, n_heads * hd).bfloat16()
        shape = [b, s, n_heads, hd]
        path = "tiles" if attention.tiles(b, s, n_heads, hd) else "stream"
        (out,), same = run_twice(lambda: attention.causal_attention_fwd(qkv, n_heads))
        want = attention.causal_attention_ref(qkv, n_heads)
        fwd_ulps = row_ulps(out, want, hd)
        checks.append((f"causal_attention ({path})", shape, float((out.float() - want.float()).abs().max()),
                       rows_close(out, want, hd) and same))
        if s == 4096:
            # the control: the late rows 2% off, as a softmax sum off by 2%
            # in the late key tiles would leave them, must fail the check
            off = out.float().clone()
            off[:, s // 2:] *= 1.02
            control = row_ulps(off, want, hd)
            checks.append(("causal_attention control, late rows 2% off, rejected", shape,
                           float((off - want.float()).abs().max()), not rows_close(off, want, hd)))
        (got,), same = run_twice(lambda: attention.causal_attention_bwd(qkv, dout, n_heads))
        want = attention.causal_attention_bwd_ref(qkv, dout, n_heads)
        bwd_ulps = row_ulps(got, want, hd, 3)
        checks.append((f"causal_attention_bwd ({path})", shape, float((got.float() - want.float()).abs().max()),
                       rows_close(got, want, hd, 3) and same))
        row_errs.append({"shape": shape, "path": path, "fwd": fwd_ulps, "bwd": bwd_ulps,
                         **({"control_late_rows_2pct_off": control} if s == 4096 else {})})

    (q, k, v), carry, my, origin = ring_case((1, 4, 2048, 32), torch.float32, "earlier", g)
    got = ra.ring_step(q, k, v, *(t.clone() for t in carry), my, origin)
    want = ra.ring_step_ref(q, k, v, *carry, my, origin)
    exact = ring_step_f64(q, k, v, *carry, my, origin)
    scratch = [t.clone() for t in carry]
    print(json.dumps({"ring_attention_step_vs_float64": {
        "shape": [1, 4, 2048, 32],
        "graph_ms": graph_ms(lambda: ra.ring_step(q, k, v, *scratch, my, origin), 20, 5),
        **{who: {name: float((t.double() - x).abs().max())
                 for name, t, x in zip(("m", "num", "den"), ts, exact)}
           for who, ts in (("kernel", got), ("plain", want))}}}))
    # past 1024 keys the atol is 2e-5 of each part's max (carry_close's
    # scaled rule): the plain version's own f32 sums round by more
    checks.append(("ring_attention_step", [1, 4, 2048, 32],
                   max(float((a - b).abs()[torch.isfinite(b)].max()) for a, b in zip(got, want)),
                   all(carry_close(a, b, scaled=True) for a, b in zip(got, want))))
    # the ring step and its backward past the former cap on heads of 3072,
    # on the wide kernels, earlier and on the diagonal
    for shape in ((1, 2, 100, 3073), (1, 2, 100, 4096)):
        for case in ("earlier", "diagonal"):
            qkv, carry, my, origin = ring_case(shape, torch.float32, case, g)
            got, same = run_twice(lambda: ra.ring_step(*qkv, *(t.clone() for t in carry), my, origin))
            want = ra.ring_step_ref(*qkv, *carry, my, origin)
            checks.append((f"ring_attention_step {case}", list(shape),
                           max(float((a - b).abs()[torch.isfinite(b)].max()) for a, b in zip(got, want)),
                           same and all(carry_close(a, b) for a, b in zip(got, want))))
            inputs, my, origin, acc = ring_bwd_case(shape, torch.float32, case, g)
            got, same = run_twice(lambda: ra.ring_step_bwd(*inputs, my, origin, *(t.clone() for t in acc)))
            want = ra.ring_step_bwd_ref(*inputs, my, origin, *acc)
            checks.append((f"ring_attention_step_bwd {case}", list(shape),
                           max(float((a - b).abs().max()) for a, b in zip(got, want)),
                           same and all(grads_close(a, b) for a, b in zip(got, want))))
    torch.cuda.synchronize()
    for name, shape, err, ok in checks:
        if not ok:
            fail(f"{name} at {shape} disagrees with its plain version or with itself on a "
                 f"repeat: max |err| {err:.3e}")
    print(json.dumps({"domain": [{"name": n, "shape": sh, "max_abs_err": e} for n, sh, e, _ in checks]}))
    print(json.dumps({"attention_row_ulps": row_errs}))


def phase_kernels(inputs: dict, config: demo.DemoConfig) -> list[dict]:
    rows = [attention_row(*inputs["attention"], "causal_attention")]
    rows.append(rmsnorm_row(*inputs["rmsnorm"], "rmsnorm"))
    rows.append(rmsnorm_row(*inputs["rmsnorm_wide"], "rmsnorm_wide"))

    rows.append(mlp_row(*inputs["mlp"], "matmul_gelu"))
    rows.append(mlp_row(*inputs["mlp_wide"], "matmul_gelu_wide"))
    rows += backward_rows(inputs)
    rows += ring_rows(config)
    rows += ring_bwd_rows()
    rows += wide_ring_rows()
    second = second_path_rows()
    domain_checks()
    out = measure(rows)
    second_out = measure(second)
    # step 2's order: each kernel's device time over its PyTorch call's
    ranking = sorted(({"name": r["name"], "graph_ms": r["graph_ms"],
                       "library_graph_ms": r["library_graph_ms"],
                       "factor": r["graph_ms"] / r["library_graph_ms"]} for r in out + second_out),
                     key=lambda r: -r["factor"])
    print(json.dumps({"against_library": ranking}))
    # the main path launches none of these: their line says so
    for line in second_out:
        line["launches"] = 0
    print(json.dumps({"second_paths": second_out}))
    return out


def measure(rows: list[dict], strict: bool = True) -> list[dict]:
    """Check each row against its plain version and on a repeat (a failed
    check fails the run, or with ``strict`` false only says so on its
    line), time it, print its line and return the lines."""
    out = []
    for row in rows:
        err = float(row["err"].abs().max())
        same = run_twice(row.get("repeat", row["fn"]))[1]
        if strict and not row["ok"]:
            fail(f"{row['name']} disagrees with its plain version: max |err| "
                 f"{err:.3e}, tolerance {row['tolerance']}")
        if strict and not same:
            fail(f"{row['name']}: two launches on the same inputs differ")
        # kernel, plain, plain, kernel: drift in the clocks hits both; the
        # wide rows take fewer calls (each moves hundreds of MB)
        reps = row.get("reps", 100)
        per_graph = 20 if reps >= 100 else 4
        ms = [time_ms(row["fn"], reps)]
        plain_ms = [time_ms(row["plain"], reps), time_ms(row["plain"], reps)]
        ms.append(time_ms(row["fn"], reps))
        bound_ms, bound_by = row["bound"]
        line = {
            "name": row["name"], "route": row["route"], "source": row["source"],
            "replaces": row["replaces"], **({"shape": row["shape"]} if "shape" in row else {}),
            **({"block": row["block"]} if "block" in row else {}),
            "launches": None,
            "max_abs_err": err, "tolerance": row["tolerance"], **row.get("fields", {}),
            "ok": row["ok"], "deterministic": same,
            "ms": statistics.mean(ms), "graph_ms": graph_ms(row["fn"], per_graph, reps // 2),
            "plain_ms": statistics.mean(plain_ms),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(row["library"], reps),
            **({"library_op": row["library_op"]} if "library_op" in row else {}),
            "library_graph_ms": graph_ms(row["library"], per_graph, reps // 2),
            **{f"{what}_graph_ms": graph_ms(fn, per_graph, reps // 2)
               for what, fn in row.get("extra", {}).items()},
        }
        print(json.dumps(line))
        out.append(line)
    return out


def host_median_ms(call, calls: int = 50) -> float:
    """Median host time of ``calls`` calls, each ending in a synchronize."""
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def serve_requests(config: demo.DemoConfig, tokens: torch.Tensor) -> list:
    """``entry()``'s token batch and ``REQUESTS - 1`` more, seeded."""
    return [tokens] + [
        torch.randint(0, config.vocab, (config.batch, config.seq_len),
                      generator=torch.Generator().manual_seed(100 + i)).cuda()
        for i in range(REQUESTS - 1)
    ]


def forward_launches(config: demo.DemoConfig) -> dict:
    """Each kernel's launches in one forward call."""
    return {"causal_attention": config.n_layers, "rmsnorm": 2 * config.n_layers,
            "matmul_gelu": config.n_layers}


def phase_serve(config: demo.DemoConfig) -> dict:
    fn, (params, tokens) = entry()
    requests = serve_requests(config, tokens)
    fn(params, tokens)  # warm the allocator and cuBLAS outside the count
    torch.cuda.synchronize()

    reset_counts()
    logits = [fn(params, t) for t in requests]
    torch.cuda.synchronize()
    launches = read_counts()
    per_call = dict.fromkeys(launches, 0)
    per_call.update(forward_launches(config))
    for name, count in launches.items():
        if count != per_call[name] * len(requests):
            fail(f"{name} launched {count} times in {len(requests)} forward "
                 f"calls, not {per_call[name]} per call")

    cpu_params = demo.tree_map(lambda t: t.cpu(), params)
    worst = 0.0
    for t, got in zip(requests, logits):
        want = fn(cpu_params, t.cpu())
        if got.shape != (config.batch, config.seq_len, config.vocab):
            fail(f"logits shaped {tuple(got.shape)}")
        if not bool(torch.isfinite(got).all()):
            fail("logits are not finite")
        # 4 bf16 ulps of the logits' magnitude: both runs round every
        # product to bf16, summing in different orders
        err = float((got.cpu() - want).abs().max())
        tol = 4 * float(bf16_ulp(want.abs().max()))
        if err > tol:
            fail(f"card logits differ from the CPU forward by {err:.3e} > {tol:.3e}")
        worst = max(worst, err)

    median_s = host_median_ms(lambda: fn(params, tokens)) / 1e3
    result = {
        "requests": len(requests),
        "launches": {name: launches[name] for name in ("causal_attention", "rmsnorm", "matmul_gelu")},
        "max_abs_err_vs_cpu": worst,
        "forward_median_ms": median_s * 1e3,
        "tokens_per_s": config.batch * config.seq_len / median_s,
    }
    print(json.dumps({"serve": result}))
    return launches


def step_launches(config: demo.DemoConfig) -> dict:
    """Each kernel's launches in one train step (a backward of two or three
    launches counts once)."""
    return {
        "causal_attention": config.n_layers, "causal_attention_bwd": config.n_layers,
        "rmsnorm": 2 * config.n_layers, "rmsnorm_bwd": 2 * config.n_layers,
        "matmul_gelu": config.n_layers, "matmul_gelu_bwd": config.n_layers,
        "cross_entropy": 1, "cross_entropy_bwd": 1, "ring_attention_step": 0,
        "ring_attention_step_bwd": 0,
    }


def check_step_launches(before: dict, after: dict, per_step: dict, what: str) -> None:
    for name, count in per_step.items():
        if after[name] - before[name] != count:
            fail(f"{what}: {name} launched {after[name] - before[name]} times, not {count}")


def phase_train(config: demo.DemoConfig) -> dict:
    fn, (params, tokens) = train_entry()
    cpu_params = demo.tree_map(lambda t: t.cpu(), params)
    fn(params, tokens)  # warm the allocator and cuBLAS outside the count
    torch.cuda.synchronize()

    per_step = step_launches(config)
    reset_counts()
    losses, times, first = [], [], None
    stepped = params
    for step in range(TRAIN_STEPS):
        before = read_counts()
        t0 = time.perf_counter()
        stepped, loss = fn(stepped, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check_step_launches(before, read_counts(), per_step, f"train step {step}")
        losses.append(float(loss))
        first = first or stepped
    launches = read_counts()
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"the loss did not fall over {TRAIN_STEPS} steps: {losses}")

    # the first step against the same step on the CPU: the loss within
    # 5e-5; each parameter within lr x 4 bf16 ulps of its gradient's max |g|
    # plus 1 f32 ulp of |p| (every product rounds to bf16, summed in
    # another order on each device)
    want_loss, grads = demo.value_and_grad(cpu_params, tokens.cpu(), config)
    want_new, _ = fn(cpu_params, tokens.cpu())
    loss_err = abs(losses[0] - float(want_loss))
    if loss_err > 5e-5:
        fail(f"first step's loss {losses[0]} differs from the CPU's {float(want_loss)}")
    worst = 0.0
    leaves = zip(*map(demo.tree_leaves, (first, want_new, cpu_params, grads)))
    for i, (got, want, p, g) in enumerate(leaves):
        tol = step_tolerance(p, g, config.learning_rate)
        err = (got.cpu() - want).abs()
        if not bool((err <= tol).all()):
            fail(f"first step's parameter leaf {i} differs from the CPU's by "
                 f"{float(err.max()):.3e}")
        worst = max(worst, float((err / tol).max()))

    median_s = statistics.median(times)
    result = {
        "steps": TRAIN_STEPS, "launches_per_step": per_step,
        "loss_first": losses[0], "loss_last": losses[-1],
        "loss_err_vs_cpu": loss_err, "param_err_vs_cpu_of_tolerance": worst,
        "step_median_ms": median_s * 1e3,
        "tokens_per_s": config.batch * config.seq_len / median_s,
    }
    print(json.dumps({"train": result}))
    return launches


# the ring phases' launches of each kernel by (direction, block, mask, head
# width): ("fwd" or "bwd", keys a block, "diagonal", "earlier" or "later",
# head_dim)
RING_BLOCK_LAUNCHES = collections.Counter()


def replay_ring(q, k, v, n: int) -> torch.Tensor:
    """The ``n``-rank ring's schedule in one process: at step j, rank r
    holds block (r - j) % n, and every block step goes through the kernel;
    then num / den per rank, the blocks joined along the sequence."""
    b, h, seq, d = q.shape
    s = seq // n
    qs, ks, vs = ([c.contiguous() for c in t.chunk(n, dim=2)] for t in (q, k, v))
    out = []
    for r in range(n):
        m = torch.full((b, h, s, 1), -math.inf, device=q.device)
        num = torch.zeros((b, h, s, d), device=q.device)
        den = torch.zeros((b, h, s, 1), device=q.device)
        for j in range(n):
            origin = (r - j) % n
            ra.ring_step(qs[r], ks[origin], vs[origin], m, num, den, r, origin)
            RING_BLOCK_LAUNCHES["fwd", s, mask_of(r, origin), d] += 1
        out.append(num / den)
    return torch.cat(out, dim=2)


def phase_ring(config: demo.DemoConfig) -> dict:
    """The replayed ring and the real ring on the group of one, against
    dense at rtol and atol 2e-5: at [8, 4, 64, 32] (``DemoConfig()``'s
    batch, heads and head width at seq 64) and [1, 4, 1024, 32] replayed on
    4 ranks, and at [1, 4, 8192, 32] on 2 (blocks of 4096 keys, an earlier
    one among them), and at ``RING_WIDE_SHAPES`` on 2 (the wide
    kernels)."""
    g = torch.Generator().manual_seed(13)
    shapes = [(config.batch, config.n_heads, config.seq_len, config.head_dim),
              (1, config.n_heads, 1024, config.head_dim), (1, config.n_heads, 8192, config.head_dim),
              *RING_WIDE_SHAPES]
    ranks = [RING_RANKS, RING_RANKS, 2, *(2 for _ in RING_WIDE_SHAPES)]
    inputs = [[torch.randn(shape, generator=g).cuda() for _ in range(3)] for shape in shapes]
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("seq",))
    result, launches = {}, dict.fromkeys(COUNTERS, 0)
    for what, run in (
        ("replayed ring", replay_ring),
        ("ring_attention on an NCCL group of one", lambda q, k, v, n: ring_of_one(q, k, v, mesh)),
    ):
        reset_counts()
        outs = [run(*qkv, n) for qkv, n in zip(inputs, ranks)]
        torch.cuda.synchronize()
        counts = read_counts()
        want = sum(n * n for n in ranks) if what.startswith("replayed") else len(shapes)
        if counts["ring_attention_step"] != want:
            fail(f"{what}: ring_attention_step launched {counts['ring_attention_step']} times, "
                 f"not {want}")
        errs = []
        for qkv, out in zip(inputs, outs):
            dense = demo.dense_causal_attention(*qkv)
            if out.shape != dense.shape or not bool(torch.isfinite(out).all()):
                fail(f"{what}: output shaped {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
            if not torch.allclose(out, dense, rtol=2e-5, atol=2e-5):
                fail(f"{what} differs from dense attention by {float((out - dense).abs().max()):.3e}")
            errs.append(float((out - dense).abs().max()))
        result[what] = {"shapes": shapes, "ranks": ranks if what.startswith("replayed") else 1,
                        "launches": counts["ring_attention_step"], "max_abs_err_vs_dense": errs}
        launches = {name: launches[name] + counts[name] for name in COUNTERS}
    print(json.dumps({"ring": result}))
    return launches


def replay_ring_grad(q, k, v, dout, n: int) -> tuple:
    """The ``n``-rank ring's forward and backward schedules in one process,
    every block step through the kernels: the forward as ``replay_ring``;
    then at backward step j rank r holds block (r - j) % n with that
    block's dk and dv, which so gather the ranks' shares in the real
    ring's order.  Returns dq, dk, dv with the blocks joined along the
    sequence."""
    b, h, seq, d = q.shape
    s = seq // n
    qs, ks, vs, dos = ([c.contiguous() for c in t.chunk(n, dim=2)] for t in (q, k, v, dout))
    stats = []
    for r in range(n):
        m = torch.full((b, h, s, 1), -math.inf, device=q.device)
        num = torch.zeros((b, h, s, d), device=q.device)
        den = torch.zeros((b, h, s, 1), device=q.device)
        for j in range(n):
            origin = (r - j) % n
            ra.ring_step(qs[r], ks[origin], vs[origin], m, num, den, r, origin)
            RING_BLOCK_LAUNCHES["fwd", s, mask_of(r, origin), d] += 1
        stats.append((m, den, (dos[r].float() * (num / den)).sum(dim=-1, keepdim=True)))
    dq, dk, dv = ([torch.zeros((b, h, s, d), device=q.device) for _ in range(n)] for _ in range(3))
    for j in range(n):
        for r in range(n):
            origin = (r - j) % n
            ra.ring_step_bwd(qs[r], ks[origin], vs[origin], dos[r], *stats[r], r, origin,
                             dq[r], dk[origin], dv[origin])
            RING_BLOCK_LAUNCHES["bwd", s, mask_of(r, origin), d] += 1
    return tuple(torch.cat(t, dim=2) for t in (dq, dk, dv))


def ring_of_one(q, k, v, mesh) -> torch.Tensor:
    """``demo.ring_attention`` over ``mesh``'s ``seq`` dim, a group of
    one: its block steps, all on the diagonal, tallied by block."""
    before = telemetry.value("kernels.ring_attention_step")
    out = demo.ring_attention(q, k, v, mesh, axis="seq")
    launched = telemetry.value("kernels.ring_attention_step") - before
    RING_BLOCK_LAUNCHES["fwd", q.shape[2], "diagonal", q.shape[3]] += launched
    return out


def ring_attention_grad(q, k, v, dout, mesh) -> tuple:
    """``backward()`` through ``demo.ring_attention`` over ``mesh``'s
    ``seq`` dim, a group of one: dq, dk, dv; the backward's block steps
    tallied by block."""
    live = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = ring_of_one(*live, mesh)
    before = telemetry.value("kernels.ring_attention_step_bwd")
    out.backward(dout)
    launched = telemetry.value("kernels.ring_attention_step_bwd") - before
    RING_BLOCK_LAUNCHES["bwd", q.shape[2], "diagonal", q.shape[3]] += launched
    return tuple(t.grad for t in live)


def phase_ring_grad(config: demo.DemoConfig) -> dict:
    """The ring's gradient: the replayed ring's backward and ``backward()``
    through ``ring_attention`` on the group of one, at ``DemoConfig()``'s
    full width [8, 4, 64, 32] and at ``RING_GRAD_SHAPES`` (the replay on
    ``RING_RANKS`` ranks) and at ``RING_WIDE_SHAPES`` (on 2), each against
    autograd of ``dense_causal_attention`` on the card within
    ``grads_close`` (rtol and atol 2e-5 of each gradient's max); exactly n
    backward steps a rank for each backward."""
    g = torch.Generator().manual_seed(23)
    shapes = [(config.batch, config.n_heads, config.seq_len, config.head_dim), *RING_GRAD_SHAPES,
              *RING_WIDE_SHAPES]
    ranks = [RING_RANKS] * (1 + len(RING_GRAD_SHAPES)) + [2] * len(RING_WIDE_SHAPES)
    inputs = [[torch.randn(shape, generator=g).cuda() for _ in range(4)] for shape in shapes]
    dense = []
    for q, k, v, dout in inputs:
        live = [t.clone().requires_grad_() for t in (q, k, v)]
        demo.dense_causal_attention(*live).backward(dout)
        dense.append([t.grad for t in live])
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("seq",))
    result, launches = {}, dict.fromkeys(COUNTERS, 0)
    for what, replayed, run in (
        ("replayed ring", True, lambda q, k, v, dout, n: replay_ring_grad(q, k, v, dout, n)),
        ("ring_attention on an NCCL group of one", False,
         lambda q, k, v, dout, n: ring_attention_grad(q, k, v, dout, mesh)),
    ):
        reset_counts()
        grads = [run(*x, n) for x, n in zip(inputs, ranks)]
        torch.cuda.synchronize()
        counts = read_counts()
        expected = sum(n * n for n in ranks) if replayed else len(shapes)
        for name in ("ring_attention_step", "ring_attention_step_bwd"):
            if counts[name] != expected:
                fail(f"{what}: {name} launched {counts[name]} times, not {expected} (n a rank for "
                     f"each of {len(shapes)} calls)")
        errs = []
        for shape, got, want in zip(shapes, grads, dense):
            for name, a, w in zip(("dq", "dk", "dv"), got, want):
                if a.shape != w.shape or not bool(torch.isfinite(a).all()):
                    fail(f"{what}: {name} at {shape} shaped {tuple(a.shape)}, finite {bool(torch.isfinite(a).all())}")
                if not grads_close(a, w):
                    fail(f"{what}: {name} at {shape} differs from dense attention's by "
                         f"{float((a - w).abs().max()):.3e} (max |g| {float(w.abs().max()):.3e})")
            errs.append(max(float((a - w).abs().max() / w.abs().max()) for a, w in zip(got, want)))
        result[what] = {"shapes": shapes, "ranks": ranks if replayed else 1,
                        "launches": counts["ring_attention_step_bwd"], "max_err_of_max_grad": errs}
        launches = {name: launches[name] + counts[name] for name in COUNTERS}
    print(json.dumps({"ring_grad": result}))
    return launches


def phase_wide() -> dict:
    """``loss_fn``, ``value_and_grad`` and one ``train_step`` at ``WIDE``
    (Llama 2's vocabulary of 32000 and a sequence of 2048: past cross
    entropy's and attention's former caps), on the card, with every
    kernel's launches counted, against the same step on the CPU with the
    plain versions: the losses within 5e-5 and each new parameter within
    ``step_tolerance``."""
    config = demo.DemoConfig(**WIDE)
    params = demo.init_params(config, torch.Generator().manual_seed(0), "cuda")
    tokens = torch.randint(0, config.vocab, (config.batch, config.seq_len + 1),
                           generator=torch.Generator().manual_seed(1)).cuda()
    reset_counts()
    loss = demo.loss_fn(params, tokens, config)
    vg_loss, _ = demo.value_and_grad(params, tokens, config)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    new, step_loss = demo.train_step(params, tokens, config)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_counts()
    per_step = step_launches(config)
    forward = {**forward_launches(config), "cross_entropy": 1}
    for name, count in launches.items():
        want = forward.get(name, 0) + 2 * per_step[name]
        if count != want:
            fail(f"wide phase: {name} launched {count} times, not {want}")

    t0 = time.perf_counter()
    cpu_params = demo.tree_map(lambda t: t.cpu(), params)
    want_loss, grads = demo.value_and_grad(cpu_params, tokens.cpu(), config)
    want_new = demo.tree_map(lambda p, g: p - config.learning_rate * g, cpu_params, grads)
    cpu_s = time.perf_counter() - t0
    errs = [abs(float(x) - float(want_loss)) for x in (loss, vg_loss, step_loss)]
    if max(errs) > 5e-5:
        fail(f"wide phase: losses {[float(x) for x in (loss, vg_loss, step_loss)]} differ from "
             f"the CPU's {float(want_loss)} by more than 5e-5")
    worst = 0.0
    for i, (got, want, p, g) in enumerate(zip(*map(demo.tree_leaves, (new, want_new, cpu_params, grads)))):
        tol = step_tolerance(p, g, config.learning_rate)
        err = (got.cpu() - want).abs()
        if not bool((err <= tol).all()):
            fail(f"wide phase: parameter leaf {i} differs from the CPU's by {float(err.max()):.3e}")
        worst = max(worst, float((err / tol).max()))
    print(json.dumps({"wide": {
        "config": WIDE, "loss": float(step_loss), "loss_err_vs_cpu": max(errs),
        "param_err_vs_cpu_of_tolerance": worst, "attention_path":
        "tiles" if attention.tiles(config.batch, config.seq_len, config.n_heads, config.head_dim) else "stream",
        "step_s": step_s, "step_peak_allocated_bytes": peak, "cpu_step_s": cpu_s,
        "launches": launches,
    }}))
    return launches


def phase_shard(config: demo.DemoConfig) -> dict:
    """``sharded_train_step`` on the (1, 1) mesh against ``train_step``,
    then the dryrun in this process and through its entry point."""
    fn, (params, tokens) = train_entry()
    mesh = demo.make_mesh(1)
    # the eager step: sharded_train_step returns it jitted, whose replays
    # the launch counters never see (phase h' holds the captured step)
    step = demo.sharded_train_step(mesh, config).fn
    local = demo.shard_params(params, config, mesh)
    step(local, tokens)  # warm the allocator and NCCL outside the count
    torch.cuda.synchronize()

    per_step = step_launches(config)
    reset_counts()
    stepped, times, losses, first = local, [], [], None
    for i in range(SHARDED_STEPS):
        before = read_counts()
        t0 = time.perf_counter()
        stepped, loss = step(stepped, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check_step_launches(before, read_counts(), per_step, f"sharded step {i}")
        losses.append(float(loss))
        first = first or demo.gather_params(stepped, config, mesh)
    launches = read_counts()

    # the first step against train_step on the same card, parameters and
    # tokens: the loss within 5e-5 and each leaf within step_tolerance;
    # with one rank on each axis the collectives are identities
    want_loss, grads = demo.value_and_grad(params, tokens, config)
    want_new, _ = demo.train_step(params, tokens, config)
    loss_err = abs(losses[0] - float(want_loss))
    if loss_err > 5e-5:
        fail(f"sharded step's loss {losses[0]} differs from train_step's {float(want_loss)}")
    worst, same_bits = 0.0, losses[0] == float(want_loss)
    for i, (got, want, p, g) in enumerate(zip(*map(demo.tree_leaves, (first, want_new, params, grads)))):
        tol = step_tolerance(p, g, config.learning_rate)
        err = (got - want).abs()
        if not bool((err <= tol).all()):
            fail(f"sharded step's parameter leaf {i} differs from train_step's by {float(err.max()):.3e}")
        worst = max(worst, float((err / tol).max()))
        same_bits = same_bits and torch.equal(got, want)

    reset_counts()
    dry_loss = demo.run_dryrun(1, device="cuda")
    torch.cuda.synchronize()
    dry_launches = read_counts()
    if dry_launches["ring_attention_step"] != 1:
        fail(f"run_dryrun(1) launched ring_attention_step {dry_launches['ring_attention_step']} times, not 1")
    t0 = time.perf_counter()
    entry_loss = dryrun_multichip(1)
    entry_s = time.perf_counter() - t0
    if not (math.isfinite(dry_loss) and math.isfinite(entry_loss)):
        fail(f"dryrun losses {dry_loss}, {entry_loss}")
    result = {
        "mesh": list(mesh.mesh.shape), "steps": SHARDED_STEPS, "launches_per_step": per_step,
        "loss_first": losses[0], "loss_err_vs_train_step": loss_err,
        "param_err_vs_train_step_of_tolerance": worst, "bits_equal_train_step": same_bits,
        "step_median_ms": statistics.median(times) * 1e3,
        "run_dryrun_1_loss": dry_loss, "run_dryrun_1_launches": dry_launches,
        "dryrun_multichip_1_loss": entry_loss, "dryrun_multichip_1_s": entry_s,
    }
    print(json.dumps({"shard": result}))
    return {name: launches[name] + dry_launches[name] for name in COUNTERS}


# how long a profiled call waits inside the profiler's window at each end
# (the card tests' PROFILE_MARGIN_S: the profiler can place a kernel's
# start before the launch that made it)
PROFILE_MARGIN_S = 0.01


def call_kernels(call) -> list[str]:
    """Names of the device kernels the profiler records in one call of
    ``call``, after one call outside the trace (a capture)."""
    call()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        time.sleep(PROFILE_MARGIN_S)
        call()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def same_tree(a: dict, b: dict) -> bool:
    return all(torch.equal(x, y) for x, y in zip(demo.tree_leaves(a), demo.tree_leaves(b)))


def check_capture_counts(before: dict, after: dict, per_call: dict, captures: int, what: str) -> None:
    """The launch counters around a jitted function's calls: ``WARMUP_CALLS
    + 1`` calls' worth for each capture (its warm-up and the call
    captured), nothing for a replay."""
    for name in COUNTERS:
        want = (WARMUP_CALLS + 1) * captures * per_call.get(name, 0)
        if after[name] - before[name] != want:
            fail(f"{what}: {name} counted {after[name] - before[name]} times, not {want}")


def phase_graph(config: demo.DemoConfig) -> dict:
    """The captured paths (``jit``), each against its eager path bit for
    bit: ``entry()``'s forward on the requests of (d), ``train_entry()``'s
    step chained over ``TRAIN_STEPS`` steps (and a second signature, batch
    4), ``sharded_train_step`` on the (1, 1) NCCL mesh over
    ``SHARDED_STEPS`` steps against ``train_step``.  What a call returned
    must be unchanged after the later calls; the launch counters must see
    each capture and no replay; one replay's kernels, counted by name with
    the profiler, must be each path's eager launches."""
    result = {}
    fn, (fwd_params, fwd_tokens) = entry()
    requests = serve_requests(config, fwd_tokens)
    eager = [fn(fwd_params, t) for t in requests]
    forward = jit(fn)
    before = read_counts()
    logits = [forward(fwd_params, t) for t in requests]
    torch.cuda.synchronize()
    check_capture_counts(before, read_counts(), forward_launches(config), 1, "captured forward")
    # each call's logits against the eager ones after every call was made
    if len(forward.captures) != 1 or not all(map(torch.equal, logits, eager)):
        fail("the captured forward's logits differ from the eager forward's")
    result["forward"] = {
        "requests": len(requests), "bits_equal_eager": True,
        "host_median_ms": host_median_ms(lambda: forward(fwd_params, fwd_tokens)),
        "eager_host_median_ms": host_median_ms(lambda: fn(fwd_params, fwd_tokens)),
    }

    fn, (params, tokens) = train_entry()
    chain, stepped = [], params
    for _ in range(TRAIN_STEPS):
        stepped, loss = fn(stepped, tokens)
        chain.append((stepped, loss))
    step = jit(fn)
    per_step = step_launches(config)
    got, stepped, times = [], params, []
    for i in range(TRAIN_STEPS):
        before = read_counts()
        t0 = time.perf_counter()
        stepped, loss = step(stepped, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check_capture_counts(before, read_counts(), per_step, int(i == 0), f"captured train step {i}")
        got.append((stepped, loss))
    for i, ((want, want_loss), (new, loss)) in enumerate(zip(chain, got)):
        if not (torch.equal(loss, want_loss) and same_tree(new, want)):
            fail(f"captured train step {i} differs from the eager chain's (checked after all "
                 f"{TRAIN_STEPS} steps)")
    half = tokens[:4].contiguous()
    new, loss = step(params, half)
    want, want_loss = fn(params, half)
    if len(step.captures) != 2 or not (torch.equal(loss, want_loss) and same_tree(new, want)):
        fail("the captured train step at batch 4, a second signature, differs from the eager step")
    result["train_step"] = {
        "steps": TRAIN_STEPS, "bits_equal_eager": True, "second_signature_bits_equal": True,
        "step_median_ms": statistics.median(times[1:]) * 1e3,
        "first_call_s": times[0],
        "eager_step_median_ms": host_median_ms(lambda: fn(params, tokens), TRAIN_STEPS),
    }

    mesh = demo.make_mesh(1)
    sharded = demo.sharded_train_step(mesh, config)
    local, single, times = demo.shard_params(params, config, mesh), params, []
    for i in range(SHARDED_STEPS):
        t0 = time.perf_counter()
        local, loss = sharded(local, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        single, single_loss = demo.train_step(single, tokens, config)
        if not (torch.equal(loss, single_loss) and same_tree(demo.gather_params(local, config, mesh), single)):
            fail(f"captured sharded step {i} on the (1, 1) mesh differs from train_step's bits")
    eager_local = demo.shard_params(params, config, mesh)
    result["sharded_step"] = {
        "mesh": list(mesh.mesh.shape), "steps": SHARDED_STEPS, "bits_equal_train_step": True,
        "step_median_ms": host_median_ms(lambda: sharded(eager_local, tokens), TRAIN_STEPS),
        "eager_step_median_ms": host_median_ms(lambda: sharded.fn(eager_local, tokens), TRAIN_STEPS),
    }

    # one replay's kernels by name, beside one eager call's, profiled
    # last and together (the profiler's clock drifts from a process's
    # first session)
    for path, jitted, args, per_call in (
        ("forward", forward, (fwd_params, fwd_tokens), forward_launches(config)),
        ("train_step", step, (params, tokens), per_step),
        ("sharded_step", sharded, (eager_local, tokens), per_step),
    ):
        names = call_kernels(lambda: jitted(*args))
        counts = collections.Counter(filter(None, map(wrapper_call, names)))
        want = {name: n for name, n in per_call.items() if n}
        if counts != want:
            fail(f"one replay of the captured {path} ran the port's kernels {dict(counts)}, not {want}")
        result[path].update(replay_kernels=len(names), replay_port_kernels=dict(counts),
                            eager_kernels=len(call_kernels(lambda: jitted.fn(*args))))
    print(json.dumps({"graph": result}))
    return result


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    t_start = time.perf_counter()
    phase_card()
    if sys.argv[1:] == ["--cell-shapes"]:
        # attention's and RMSNorm's backward and the MLP's products at the
        # benchmark's shapes alone, and RMSNorm's backward at DemoConfig()'s
        # shape beside them
        phase_build()
        demo_inputs = main_path_inputs(demo.DemoConfig())["rmsnorm_bwd"]
        rows = cell_rows() + [rmsnorm_bwd_row(*demo_inputs, "rmsnorm_bwd")]
        print(json.dumps({"cell_shapes": measure(rows)}))
        return
    if sys.argv[1:] == ["--second-paths"]:
        # the second paths' rows alone, checked and timed, a failed check
        # said on its line: copied into another tree (with its kernels'
        # helpers), this times that tree's kernels at the same shapes
        build.build_all()
        print(json.dumps({"second_paths": measure(second_path_rows() + wide_ring_rows(), strict=False)}))
        return
    config = demo.DemoConfig()
    inputs = main_path_inputs(config)
    phase_build()
    kernels = phase_kernels(inputs, config)
    paths = [phase_serve(config), phase_train(config)]
    wide = phase_wide()
    paths.append(wide)
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "rendezvous"),
                                rank=0, world_size=1)
        try:
            paths += [phase_ring(config), phase_ring_grad(config), phase_shard(config)]
            phase_graph(config)
        finally:
            dist.destroy_process_group()
    # the main path launches none of these at these shapes: their line says so
    cells = measure(cell_rows())
    for line in cells:
        line["launches"] = 0
    print(json.dumps({"cell_shapes": cells}))
    total = {name: sum(path[name] for path in paths) for name in COUNTERS}
    total["cross_entropy"] += total.pop("cross_entropy_bwd")
    # the rows at the wide step's shapes: that phase's launches
    total["rmsnorm_wide"] = wide["rmsnorm"]
    total["cross_entropy_wide"] = wide["cross_entropy"] + wide["cross_entropy_bwd"]
    total["matmul_gelu_wide"] = wide["matmul_gelu"]
    total["matmul_gelu_bwd_wide"] = wide["matmul_gelu_bwd"]
    print(json.dumps({"ring_block_launches": [
        {"direction": d, "block": b, "mask": m, "head_dim": hd, "launches": n}
        for (d, b, m, hd), n in sorted(RING_BLOCK_LAUNCHES.items())]}))
    for line in kernels:
        # a ring row at one block: its launches at that block in the ring
        # phases (the first row of each direction also carries the total)
        if "block" in line:
            line["block_launches"] = RING_BLOCK_LAUNCHES[tuple(line["block"])]
        line["launches"] = total.get(line["name"], line.get("block_launches"))
        if not line["launches"]:
            fail(f"{line['name']} was never launched on the main path")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
