"""Drive the PyTorch/CUDA port of the demo LM on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one Hopper card, nvcc
and triton:

    python3 chip_smoke.py

Phases, each of which exits non-zero on a failed check:
  (a) print the card's name and power limit; pin the matmul numerics to
      f32 accumulation (no TF32, no reduced-precision bf16 reductions), as
      the reference accumulates;
  (b) build every kernel from the checkout's sources, print the seconds;
  (c) hold each kernel against its plain version at the main path's shapes
      (the forward's and the train step's), require two launches on the
      same inputs to agree bit for bit, and time the kernel, the plain
      version and one PyTorch call that computes the same function (a
      yardstick only: the port never calls it); print one JSON line per
      kernel;
  (d) serve requests: ``entry()``'s forward on seeded token batches, each
      checked against the same forward on the CPU (plain versions), with
      every kernel's launch count read around those calls; print the
      forward's median time and tokens/s;
  (e) train: ``train_entry()``'s SGD step, 10 steps on one batch, with the
      launch counts of every step read, a falling loss, and the first
      step's loss and parameters checked against the same step on the CPU;
      print the step's median time and tokens/s;
  (f) print ``{"kernels": [...]}``, launches summed over (d) and (e), then,
      last, the device line.
It imports nothing of JAX: the card's machine has none.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from operator_forge_torch import demo
from operator_forge_torch.entry import entry, train_entry
from operator_forge_torch.kernels import (
    attention, bf16_ulp, build, gelu, rmsnorm, run_twice, step_tolerance, within_ulps,
)
from operator_forge_torch.kernels import cross_entropy as ce

# H100 SXM peaks (NVIDIA's data sheet, dense): device memory, the bf16
# tensor cores, and f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
REQUESTS = 4
TRAIN_STEPS = 10
# each wrapper's launch counter; the kernels line's cross_entropy sums the
# forward's and the backward's
COUNTERS = {
    "causal_attention": (attention, "launches"),
    "rmsnorm": (rmsnorm, "launches"),
    "gelu_tanh": (gelu, "launches"),
    "causal_attention_bwd": (attention, "bwd_launches"),
    "rmsnorm_bwd": (rmsnorm, "bwd_launches"),
    "gelu_tanh_bwd": (gelu, "bwd_launches"),
    "cross_entropy": (ce, "launches"),
    "cross_entropy_bwd": (ce, "bwd_launches"),
}


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
    for module, counter in COUNTERS.values():
        setattr(module, counter, 0)


def read_counts() -> dict:
    return {name: getattr(module, counter) for name, (module, counter) in COUNTERS.items()}


def bound(bytes_moved: int, flops: int, flop_per_s: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
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


def phase_build(inputs: dict) -> None:
    t0 = time.perf_counter()
    build.build_all()
    cuda_s = time.perf_counter() - t0
    # a Triton kernel compiles at its first launch
    t0 = time.perf_counter()
    rmsnorm.rmsnorm_fwd(*inputs["rmsnorm"])
    gelu.gelu_tanh_fwd(*inputs["gelu"])
    rmsnorm.rmsnorm_bwd(*inputs["rmsnorm_bwd"])
    gelu.gelu_tanh_bwd(*inputs["gelu_bwd"])
    logits, targets, grad = inputs["cross_entropy"]
    ce.cross_entropy_bwd(logits, targets, ce.cross_entropy_fwd(logits, targets)[1], grad)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    print(f"build: nvcc {cuda_s:.2f} s, triton {triton_s:.2f} s")


def main_path_inputs(config: demo.DemoConfig) -> dict:
    """Seeded inputs at the shapes the forward pass and the train step
    give each kernel."""
    g = torch.Generator().manual_seed(7)
    b, s, d = config.batch, config.seq_len, config.d_model

    def normal(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).cuda()

    x = normal(b, s, d)
    gain = 1.0 + 0.1 * normal(d)
    h = normal(b, s, config.d_ff, scale=3.0).bfloat16()
    qkv = normal(b, s, 3 * d).bfloat16()
    targets = torch.randint(0, config.vocab, (b, s), generator=g).cuda()
    return {
        "attention": (qkv, config.n_heads),
        "rmsnorm": (x, gain),
        "gelu": (h,),
        "attention_bwd": (qkv, normal(b, s, d).bfloat16(), config.n_heads),
        "rmsnorm_bwd": (x, gain, normal(b, s, d)),
        "gelu_bwd": (h, normal(b, s, config.d_ff).bfloat16()),
        "cross_entropy": (normal(b, s, config.vocab, scale=2.0), targets,
                          torch.ones(()).cuda()),
    }


def graph_of_grad(output, inputs, grad):
    """One backward through autograd of a yardstick's forward, computed
    once beforehand: only the backward runs in each timed call."""
    return lambda: torch.autograd.grad(output, inputs, grad, retain_graph=True)


def backward_rows(inputs: dict) -> list[dict]:
    """The train step's kernels: the three backwards and cross entropy."""
    rows = []

    # attention backward: dQ, dK and dV each within 2 bf16 ulps of its max
    qkv, dout, n_heads = inputs["attention_bwd"]
    b, s, three_d = qkv.shape
    d = three_d // 3
    hd = d // n_heads
    got = attention.causal_attention_bwd(qkv, dout, n_heads)
    want = attention.causal_attention_bwd_ref(qkv, dout, n_heads)
    parts = [(got[..., i * d:(i + 1) * d], want[..., i * d:(i + 1) * d]) for i in range(3)]
    # SDPA's forward once on leaf copies of the heads; each timed call runs
    # only its backward node, through the autograd engine
    q, k, v = (t.detach().contiguous().requires_grad_()
               for t in qkv.view(b, s, 3, n_heads, hd).permute(2, 0, 3, 1, 4))
    sdpa = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    rows.append(dict(
        name="causal_attention_bwd", route="cuda",
        source="operator_forge_torch/csrc/causal_attention.cu",
        replaces="operator_forge/tpu/demo.py:86",
        fn=lambda: attention.causal_attention_bwd(qkv, dout, n_heads),
        plain=lambda: attention.causal_attention_bwd_ref(qkv, dout, n_heads),
        library=graph_of_grad(sdpa, (q, k, v),
                              dout.view(b, s, n_heads, hd).transpose(1, 2).contiguous()),
        err=(got.float() - want.float()), tolerance="2 bf16 ulps of max|dq|, max|dk|, max|dv|",
        ok=all(within_ulps(g, w, 2) for g, w in parts),
        # read qkv and dout, write dqkv; five causal products (the score
        # recompute, dP, dV, dQ, dK) of 2 * head_dim each
        bound=bound(2 * qkv.numel() * 2 + dout.numel() * 2,
                    5 * 2 * hd * b * n_heads * s * (s + 1) // 2, BF16_FLOP_PER_S),
    ))

    # RMSNorm backward: rtol 1e-5, atol 1e-6 of each output's max
    x, gain, dy = inputs["rmsnorm_bwd"]
    got = rmsnorm.rmsnorm_bwd(x, gain, dy)
    want = rmsnorm.rmsnorm_bwd_ref(x, gain, dy)
    xr, gr = x.detach().requires_grad_(), gain.detach().requires_grad_()
    rows.append(dict(
        name="rmsnorm_bwd", route="triton",
        source="operator_forge_torch/kernels/rmsnorm.py",
        replaces="operator_forge/tpu/demo.py:71",
        fn=lambda: rmsnorm.rmsnorm_bwd(x, gain, dy),
        plain=lambda: rmsnorm.rmsnorm_bwd_ref(x, gain, dy),
        library=graph_of_grad(F.rms_norm(xr, (x.shape[-1],), gr, eps=rmsnorm.EPS),
                              (xr, gr), dy),
        err=torch.cat([(g - w).flatten() for g, w in zip(got, want)]),
        tolerance="rtol 1e-5, atol 1e-6 of max|dx| and of max|dgain|",
        ok=all(bool(((g - w).abs() <= 1e-6 * w.abs().max() + 1e-5 * w.abs()).all())
               for g, w in zip(got, want)),
        # read x and dy, write dx (gain and dgain beside them); some 11 f32
        # operations an element
        bound=bound(3 * x.numel() * 4 + 2 * gain.numel() * 4, 11 * x.numel(),
                    F32_FLOP_PER_S),
    ))

    # GELU backward: within 1 bf16 ulp of max(|dx|, 2**-8)
    h, dh = inputs["gelu_bwd"]
    got = gelu.gelu_tanh_bwd(h, dh).float()
    want = gelu.gelu_tanh_bwd_ref(h, dh).float()
    rows.append(dict(
        name="gelu_tanh_bwd", route="triton",
        source="operator_forge_torch/kernels/gelu.py",
        replaces="operator_forge/tpu/demo.py:98",
        fn=lambda: gelu.gelu_tanh_bwd(h, dh),
        plain=lambda: gelu.gelu_tanh_bwd_ref(h, dh),
        library=lambda: torch.ops.aten.gelu_backward(dh, h, approximate="tanh"),
        err=got - want, tolerance="1 bf16 ulp of max(|dx|, 2**-8)",
        ok=bool(((got - want).abs() <= bf16_ulp(want.abs().clamp_min(2.0**-8))).all()),
        # read x and dy, write dx; some 20 f32 operations an element
        bound=bound(3 * h.numel() * 2, 20 * h.numel(), F32_FLOP_PER_S),
    ))

    # cross entropy, forward then backward: the loss within rtol 1e-5,
    # dlogits within 1e-7
    logits, targets, grad = inputs["cross_entropy"]

    def fwd_bwd(fwd, bwd):
        loss, lse = fwd(logits, targets)
        return loss, bwd(logits, targets, lse, grad)

    got = fwd_bwd(ce.cross_entropy_fwd, ce.cross_entropy_bwd)
    want = fwd_bwd(ce.cross_entropy_ref, ce.cross_entropy_bwd_ref)
    rows2d, t1d = logits.view(-1, logits.shape[-1]), targets.view(-1)
    lr = rows2d.detach().requires_grad_()
    rows.append(dict(
        name="cross_entropy", route="triton",
        source="operator_forge_torch/kernels/cross_entropy.py",
        replaces="operator_forge/tpu/demo.py:116",
        fn=lambda: fwd_bwd(ce.cross_entropy_fwd, ce.cross_entropy_bwd),
        plain=lambda: fwd_bwd(ce.cross_entropy_ref, ce.cross_entropy_bwd_ref),
        library=lambda: torch.autograd.grad(F.cross_entropy(lr, t1d), lr),
        err=torch.cat([(got[0] - want[0]).view(1), (got[1] - want[1]).flatten()]),
        tolerance="loss rtol 1e-5; dlogits atol 1e-7",
        ok=bool((got[0] - want[0]).abs() <= 1e-5 * want[0].abs())
        and bool(((got[1] - want[1]).abs() <= 1e-7).all()),
        # read the logits and targets, write the loss and dlogits; max,
        # exp, sums, the gather and the backward's formula: some 10 f32
        # operations an element
        bound=bound(2 * logits.numel() * 4 + targets.numel() * 8 + 4,
                    10 * logits.numel(), F32_FLOP_PER_S),
    ))
    return rows


def phase_kernels(inputs: dict) -> list[dict]:
    rows = []

    # attention: within 2 bf16 ulps of the output's magnitude (the kernel
    # sums in another order than cuBLAS before each bf16 rounding)
    qkv, n_heads = inputs["attention"]
    b, s, three_d = qkv.shape
    d = three_d // 3
    hd = d // n_heads
    got = attention.causal_attention_fwd(qkv, n_heads).float()
    want = attention.causal_attention_ref(qkv, n_heads).float()
    q, k, v = qkv.view(b, s, 3, n_heads, hd).permute(2, 0, 3, 1, 4)
    rows.append(dict(
        name="causal_attention", route="cuda",
        source="operator_forge_torch/csrc/causal_attention.cu",
        replaces="operator_forge/tpu/demo.py:86",
        fn=lambda: attention.causal_attention_fwd(qkv, n_heads),
        plain=lambda: attention.causal_attention_ref(qkv, n_heads),
        library=lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        err=got - want, tolerance="2 bf16 ulps of max|out|",
        ok=bool((got - want).abs().max() <= 2 * bf16_ulp(want.abs().max())),
        # causal q.k and p.v products: 2 * 2 * head_dim per (query, key <= query)
        bound=bound(qkv.numel() * 2 + b * s * d * 2,
                    4 * hd * b * n_heads * s * (s + 1) // 2, BF16_FLOP_PER_S),
    ))

    # RMSNorm: rtol 1e-5, atol 1e-6 (the row sum is taken in another order)
    x, gain = inputs["rmsnorm"]
    got = rmsnorm.rmsnorm_fwd(x, gain)
    want = rmsnorm.rmsnorm_ref(x, gain)
    rows.append(dict(
        name="rmsnorm", route="triton",
        source="operator_forge_torch/kernels/rmsnorm.py",
        replaces="operator_forge/tpu/demo.py:71",
        fn=lambda: rmsnorm.rmsnorm_fwd(x, gain),
        plain=lambda: rmsnorm.rmsnorm_ref(x, gain),
        library=lambda: F.rms_norm(x, (x.shape[-1],), gain, eps=rmsnorm.EPS),
        err=got - want, tolerance="rtol 1e-5, atol 1e-6",
        ok=bool(((got - want).abs() <= 1e-6 + 1e-5 * want.abs()).all()),
        # square, sum, divide, scale: 4 f32 operations an element
        bound=bound(2 * x.numel() * 4 + gain.numel() * 4, 4 * x.numel(), F32_FLOP_PER_S),
    ))

    # GELU: within 1 bf16 ulp of max(|y|, 2**-8) (both round an f32 value
    # once; the plain 1 + tanh(u) cancels in f32 where |y| < 2**-8)
    (h,) = inputs["gelu"]
    got = gelu.gelu_tanh_fwd(h).float()
    want = gelu.gelu_tanh_ref(h).float()
    rows.append(dict(
        name="gelu_tanh", route="triton",
        source="operator_forge_torch/kernels/gelu.py",
        replaces="operator_forge/tpu/demo.py:98",
        fn=lambda: gelu.gelu_tanh_fwd(h),
        plain=lambda: gelu.gelu_tanh_ref(h),
        library=lambda: F.gelu(h, approximate="tanh"),
        err=got - want, tolerance="1 bf16 ulp of max(|y|, 2**-8)",
        ok=bool(((got - want).abs() <= bf16_ulp(want.abs().clamp_min(2.0**-8))).all()),
        # cube, polynomial, exp, divide: 10 f32 operations an element
        bound=bound(2 * h.numel() * 2, 10 * h.numel(), F32_FLOP_PER_S),
    ))
    rows += backward_rows(inputs)

    out = []
    for row in rows:
        err = float(row["err"].abs().max())
        if not row["ok"]:
            fail(f"{row['name']} disagrees with its plain version: max |err| "
                 f"{err:.3e}, tolerance {row['tolerance']}")
        if not run_twice(row["fn"])[1]:
            fail(f"{row['name']}: two launches on the same inputs differ")
        # kernel, plain, plain, kernel: drift in the clocks hits both
        ms = [time_ms(row["fn"])]
        plain_ms = [time_ms(row["plain"]), time_ms(row["plain"])]
        ms.append(time_ms(row["fn"]))
        bound_ms, bound_by = row["bound"]
        line = {
            "name": row["name"], "route": row["route"], "source": row["source"],
            "replaces": row["replaces"], "launches": None,
            "max_abs_err": err, "tolerance": row["tolerance"], "deterministic": True,
            "ms": statistics.mean(ms), "graph_ms": graph_ms(row["fn"]),
            "plain_ms": statistics.mean(plain_ms),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(row["library"]),
        }
        print(json.dumps(line))
        out.append(line)
    return out


def phase_serve(config: demo.DemoConfig) -> dict:
    fn, (params, tokens) = entry()
    requests = [tokens] + [
        torch.randint(0, config.vocab, (config.batch, config.seq_len),
                      generator=torch.Generator().manual_seed(100 + i)).cuda()
        for i in range(REQUESTS - 1)
    ]
    fn(params, tokens)  # warm the allocator and cuBLAS outside the count
    torch.cuda.synchronize()

    reset_counts()
    logits = [fn(params, t) for t in requests]
    torch.cuda.synchronize()
    launches = read_counts()
    per_call = dict.fromkeys(launches, 0)
    per_call.update(causal_attention=config.n_layers, rmsnorm=2 * config.n_layers,
                    gelu_tanh=config.n_layers)
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

    times = []
    for _ in range(50):
        t0 = time.perf_counter()
        fn(params, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    median_s = statistics.median(times)
    result = {
        "requests": len(requests),
        "launches": {name: launches[name] for name in ("causal_attention", "rmsnorm", "gelu_tanh")},
        "max_abs_err_vs_cpu": worst,
        "forward_median_ms": median_s * 1e3,
        "tokens_per_s": config.batch * config.seq_len / median_s,
    }
    print(json.dumps({"serve": result}))
    return launches


def phase_train(config: demo.DemoConfig) -> dict:
    fn, (params, tokens) = train_entry()
    cpu_params = demo.tree_map(lambda t: t.cpu(), params)
    fn(params, tokens)  # warm the allocator and cuBLAS outside the count
    torch.cuda.synchronize()

    per_step = {
        "causal_attention": config.n_layers, "causal_attention_bwd": config.n_layers,
        "rmsnorm": 2 * config.n_layers, "rmsnorm_bwd": 2 * config.n_layers,
        "gelu_tanh": config.n_layers, "gelu_tanh_bwd": config.n_layers,
        "cross_entropy": 1, "cross_entropy_bwd": 1,
    }
    reset_counts()
    losses, times, first = [], [], None
    stepped = params
    for step in range(TRAIN_STEPS):
        before = read_counts()
        t0 = time.perf_counter()
        stepped, loss = fn(stepped, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        after = read_counts()
        for name, count in per_step.items():
            if after[name] - before[name] != count:
                fail(f"train step {step}: {name} launched {after[name] - before[name]} "
                     f"times, not {count}")
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


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    phase_card()
    config = demo.DemoConfig()
    inputs = main_path_inputs(config)
    phase_build(inputs)
    kernels = phase_kernels(inputs)
    served = phase_serve(config)
    trained = phase_train(config)
    total = {name: served[name] + trained[name] for name in COUNTERS}
    total["cross_entropy"] += total.pop("cross_entropy_bwd")
    for line in kernels:
        line["launches"] = total[line["name"]]
        if line["launches"] < 1:
            fail(f"{line['name']} was never launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
