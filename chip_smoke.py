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
      and time the kernel, the plain version and one PyTorch call that
      computes the same function (a yardstick only: the port never calls
      it); print one JSON line per kernel;
  (d) serve requests: ``entry()``'s forward on seeded token batches, each
      checked against the same forward on the CPU (plain versions), with
      every kernel's launch count read around those calls; print the
      forward's median time and tokens/s;
  (e) print ``{"kernels": [...]}``, then, last, the device line.
It imports nothing of JAX: the card's machine has none.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from operator_forge_torch import demo
from operator_forge_torch.entry import entry
from operator_forge_torch.kernels import attention, bf16_ulp, build, gelu, rmsnorm

# H100 SXM peaks (NVIDIA's data sheet, dense): device memory, the bf16
# tensor cores, and f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
REQUESTS = 4


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
    rmsnorm.rmsnorm(*inputs["rmsnorm"])
    gelu.gelu_tanh(*inputs["gelu"])
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    print(f"build: nvcc {cuda_s:.2f} s, triton {triton_s:.2f} s")


def main_path_inputs(config: demo.DemoConfig) -> dict:
    """Seeded inputs at the shapes the forward pass gives each kernel."""
    g = torch.Generator().manual_seed(7)
    b, s, d = config.batch, config.seq_len, config.d_model

    def normal(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).cuda()

    return {
        "attention": (normal(b, s, 3 * d).bfloat16(), config.n_heads),
        "rmsnorm": (normal(b, s, d), 1.0 + 0.1 * normal(d)),
        "gelu": (normal(b, s, config.d_ff, scale=3.0).bfloat16(),),
    }


def phase_kernels(inputs: dict) -> list[dict]:
    rows = []

    # attention: within 2 bf16 ulps of the output's magnitude (the kernel
    # sums in another order than cuBLAS before each bf16 rounding)
    qkv, n_heads = inputs["attention"]
    b, s, three_d = qkv.shape
    d = three_d // 3
    hd = d // n_heads
    got = attention.causal_attention(qkv, n_heads).float()
    want = attention.causal_attention_ref(qkv, n_heads).float()
    q, k, v = qkv.view(b, s, 3, n_heads, hd).permute(2, 0, 3, 1, 4)
    rows.append(dict(
        name="causal_attention", route="cuda",
        source="operator_forge_torch/csrc/causal_attention.cu",
        replaces="operator_forge/tpu/demo.py:86",
        fn=lambda: attention.causal_attention(qkv, n_heads),
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
    got = rmsnorm.rmsnorm(x, gain)
    want = rmsnorm.rmsnorm_ref(x, gain)
    rows.append(dict(
        name="rmsnorm", route="triton",
        source="operator_forge_torch/kernels/rmsnorm.py",
        replaces="operator_forge/tpu/demo.py:71",
        fn=lambda: rmsnorm.rmsnorm(x, gain),
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
    got = gelu.gelu_tanh(h).float()
    want = gelu.gelu_tanh_ref(h).float()
    rows.append(dict(
        name="gelu_tanh", route="triton",
        source="operator_forge_torch/kernels/gelu.py",
        replaces="operator_forge/tpu/demo.py:98",
        fn=lambda: gelu.gelu_tanh(h),
        plain=lambda: gelu.gelu_tanh_ref(h),
        library=lambda: F.gelu(h, approximate="tanh"),
        err=got - want, tolerance="1 bf16 ulp of max(|y|, 2**-8)",
        ok=bool(((got - want).abs() <= bf16_ulp(want.abs().clamp_min(2.0**-8))).all()),
        # cube, polynomial, exp, divide: 10 f32 operations an element
        bound=bound(2 * h.numel() * 2, 10 * h.numel(), F32_FLOP_PER_S),
    ))

    out = []
    for row in rows:
        err = float(row["err"].abs().max())
        if not row["ok"]:
            fail(f"{row['name']} disagrees with its plain version: max |err| "
                 f"{err:.3e}, tolerance {row['tolerance']}")
        # kernel, plain, plain, kernel: drift in the clocks hits both
        ms = [time_ms(row["fn"])]
        plain_ms = [time_ms(row["plain"]), time_ms(row["plain"])]
        ms.append(time_ms(row["fn"]))
        bound_ms, bound_by = row["bound"]
        line = {
            "name": row["name"], "route": row["route"], "source": row["source"],
            "replaces": row["replaces"], "launches": None,
            "max_abs_err": err, "tolerance": row["tolerance"],
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

    attention.launches = rmsnorm.launches = gelu.launches = 0
    logits = [fn(params, t) for t in requests]
    torch.cuda.synchronize()
    launches = {
        "causal_attention": attention.launches,
        "rmsnorm": rmsnorm.launches,
        "gelu_tanh": gelu.launches,
    }
    per_call = {
        "causal_attention": config.n_layers,
        "rmsnorm": 2 * config.n_layers,
        "gelu_tanh": config.n_layers,
    }
    for name, count in launches.items():
        if count != per_call[name] * len(requests):
            fail(f"{name} launched {count} times in {len(requests)} forward "
                 f"calls, not {per_call[name]} per call")

    cpu_params = {
        "embed": params["embed"].cpu(), "unembed": params["unembed"].cpu(),
        "layers": [{k: t.cpu() for k, t in layer.items()} for layer in params["layers"]],
    }
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
        "requests": len(requests), "launches": launches,
        "max_abs_err_vs_cpu": worst,
        "forward_median_ms": median_s * 1e3,
        "tokens_per_s": config.batch * config.seq_len / median_s,
    }
    print(json.dumps({"serve": result}))
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    phase_card()
    config = demo.DemoConfig()
    inputs = main_path_inputs(config)
    phase_build(inputs)
    kernels = phase_kernels(inputs)
    launches = phase_serve(config)
    for line in kernels:
        line["launches"] = launches[line["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
