"""One run of one cell: set-up, the measured window, the check against the
plain reference, one JSON line.

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In order:

1. the cell's configuration, traffic and limits, by name (``spec``);
2. the weights and a pool of token batches, made on the card from the seed
   (``inputs``);
3. the entry the traffic names, wrapped in ``operator_forge_torch.jit.jit``
   as the entry points' callers wrap it, its one signature warmed up and
   captured (``ENTRIES``); a train cell's first ``CHECK_STEPS`` steps run
   here, through the window's own call, each on its own batch;
4. a closed loop of one client for ``--seconds``: each call waits for its
   answer (a train step's loss, read every step; a forward call's logits)
   before the next is issued; with ``--trace 1`` a stretch of it is
   profiled (``trace``);
5. the card's peak memory read, the program's state freed, then the plain
   reference (``reference/``) computed for what the timed path produced,
   and the numbers of ``check`` held to the cell's limits;
6. every compared number beside its limit on standard error, and the result
   as the last line of standard output.

A run exits non-zero and prints no result where there is no card or fewer
than the cell asks for, or where a module of JAX or of the JAX package
``operator_forge`` is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import random
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import torch
from operator_forge_torch import demo
from operator_forge_torch.entry import pin_numerics
from operator_forge_torch.jit import jit
from operator_forge_torch.kernels import build

from . import check, counts, inputs, spec
from . import trace as tracing
from .reference import demo_block as reference

CHECK_STEPS = 3
TRACE_FROM = 0.25    # the traced stretch starts this share into the window
TRACE_S = 2.0        # and takes whole calls for about this long
FORBIDDEN = ("jax", "jaxlib", "flax", "operator_forge")
CACHE = spec.ROOT.parent / ".portbench_cache"


@dataclass
class Record:
    """What a run measured, as the metric readers take it."""

    cell: spec.Cell
    setup_s: float = 0.0
    calls: int = 0
    window_s: float = 0.0
    tokens_per_call: int = 0
    latencies_s: list = field(default_factory=list)
    trace: object = None


class Phases:
    """The seconds of each part of set-up, in order, for the notes: each
    ``mark(name)`` closes the part that ran since the previous mark."""

    def __init__(self, started: float):
        self.last = started
        self.seconds: dict = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(name for name in sys.modules if name.split(".")[0] in FORBIDDEN)


def demo_config(cell: spec.Cell) -> demo.DemoConfig:
    cfg, traffic = cell.config, cell.traffic
    config = demo.DemoConfig(vocab=cfg["vocab"], d_model=cfg["d_model"], n_heads=cfg["n_heads"],
                             n_layers=cfg["n_layers"], d_ff=cfg["d_ff"], seq_len=traffic["seq"],
                             batch=traffic["batch"], learning_rate=cfg["learning_rate"])
    if config.head_dim != cfg["head_dim"]:
        raise ValueError(f"{cell.config_name}: head_dim {cfg['head_dim']} is not d_model / n_heads")
    return config


class Train:
    """A train step: ``jit(train_step)`` fed its own new parameters every
    step, its loss read every step."""

    sources = ("causal_attention", "mlp", "rmsnorm", "rmsnorm_bwd", "cross_entropy")

    def __init__(self, config, params, pool, traffic, seed):
        self.pool = pool
        self.lr = config.learning_rate
        self.step = jit(functools.partial(demo.train_step, config=config))
        self.params = params
        self.failed = 0
        self.readings = {}

    def prepare(self, cell, seed) -> float:
        """The capture and the first ``CHECK_STEPS`` steps from the seed's
        weights, on the pool's first batches; keeps each loss, each leaf's
        first gradient norm and change norm.  Returns the seconds spent on
        those norms (not the program's set-up)."""
        norm = torch.linalg.vector_norm
        losses, aside = [], 0.0
        start = self.params
        for i in range(CHECK_STEPS):
            new, loss = self.step(self.params, self.pool[i])
            losses.append(loss.item())
            if i == 0:
                t0 = time.perf_counter()
                grads = torch.stack([norm(a - b) for a, b in zip(demo.tree_leaves(start),
                                                                 demo.tree_leaves(new))])
                self.readings["grad_norms"] = (grads / self.lr).tolist()
                del start
                aside += time.perf_counter() - t0
            self.params = new
        t0 = time.perf_counter()
        self.readings["losses"] = losses
        self.readings["change_norms"] = self._change_norms(cell, seed)
        return aside + time.perf_counter() - t0

    def _change_norms(self, cell, seed) -> list:
        """|p - p0| of each leaf, the seed's weights made again a group at a
        time, in ``tree_leaves``'s order."""
        cfg = cell.config
        device = self.params["embed"].device
        found = {}
        for name in inputs.GROUPS:
            start = inputs.make_group(cfg, seed, name, device)
            starts = [start] if name in ("embed", "unembed") else list(start)
            for i, (leaf, p0) in enumerate(zip(inputs.group_leaves(self.params, name), starts)):
                found[(name, i)] = torch.linalg.vector_norm(leaf - p0)
            del start, starts
        for i, layer in enumerate(self.params["layers"]):
            for name in ("ln1", "ln2"):
                found[(name, i)] = torch.linalg.vector_norm(layer[name] - 1.0)
        order = [("embed", 0), ("unembed", 0)] + [(k, i) for i in range(cfg["n_layers"])
                                                  for k in inputs.LAYER_KEYS]
        return torch.stack([found[key] for key in order]).tolist()

    def call(self, i: int) -> None:
        self.params, loss = self.step(self.params, self.pool[(CHECK_STEPS + i) % len(self.pool)])
        if not math.isfinite(loss.item()):
            self.failed += 1

    def free(self) -> dict:
        """Drop the program's state; return the readings of the first steps."""
        del self.step, self.params
        return self.readings


class Forward:
    """Scoring: ``jit(forward)``, each call's f32 logits the reply to one
    request, waited for before the next.  Keeps the replies of calls drawn
    from the seed among the window's first ``checked_from_first``, and of
    its last call, for the check."""

    sources = ("causal_attention", "mlp", "rmsnorm")

    def __init__(self, config, params, pool, traffic, seed):
        self.pool, self.params = pool, params
        self.fwd = jit(functools.partial(demo.forward, config=config))
        self.failed = 0
        draw = random.Random(seed)
        self.checked = sorted(draw.sample(range(traffic["checked_from_first"]), traffic["checked_calls"]))
        self.kept: dict = {}
        self.last = None

    def prepare(self, cell, seed) -> float:
        """The capture, then as many replies held at once as the check
        keeps, so that the allocator holds their blocks before the window."""
        held = [self.fwd(self.params, self.pool[i % len(self.pool)])
                for i in range(len(self.checked) + 2)]
        self._wait()
        del held
        return 0.0

    def _wait(self) -> None:
        if self.params["embed"].is_cuda:
            torch.cuda.current_stream().synchronize()

    def call(self, i: int) -> None:
        out = self.fwd(self.params, self.pool[i % len(self.pool)])
        self._wait()
        if i in self.checked:
            self.kept[i] = out
        self.last = (i, out)

    def free(self) -> dict:
        """Drop the program's state; return the kept replies by call."""
        i, out = self.last
        self.kept.setdefault(i, out)
        del self.fwd, self.params, self.last
        return self.kept


ENTRIES = {"train": Train, "forward": Forward}


def _prebuild(sources) -> None:
    """The program's CUDA sources this entry reaches, built at once in
    parallel (each a no-op where its library is already built)."""
    names = [s for s in sources if s in build.sources()]
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        list(pool.map(build.build, names))


def window(entry, seconds: float, trace: bool, record: Record, classes) -> None:
    """The closed loop for ``seconds``; with ``trace``, a stretch of whole
    calls profiled from ``TRACE_FROM`` of the window on."""
    latencies, stretch, traced = [], None, 0
    started = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter()
        if trace and record.trace is None and stretch is None and now - started >= TRACE_FROM * seconds:
            stretch = tracing.Stretch().__enter__()
            want = max(3, math.ceil(TRACE_S / statistics.median(latencies)))
            traced = 0
        entry.call(i)
        end = time.perf_counter()
        latencies.append(end - now)
        i += 1
        if stretch is not None:
            traced += 1
            if traced == want:
                stretch.done(traced)
                stretch.__exit__(None, None, None)
                record.trace, stretch = stretch, None
        if end - started >= seconds and stretch is None:
            break
    record.window_s = end - started
    record.calls = i
    record.latencies_s = latencies
    if trace:
        record.trace = record.trace.read(classes)


def start(cell: spec.Cell, seed: int, device, phases: Phases | None = None):
    """Set-up up to the window: the entry with its signature captured and,
    for a train cell, its first steps taken; the pool; and the seconds spent
    on the check's own readings in between.  ``phases`` is marked after
    each part: the card's context, the build (``compile``), the weights,
    the pool, and the capture with the first calls."""
    phases = phases or Phases(time.perf_counter())
    traffic, cfg = cell.traffic, cell.config
    config = demo_config(cell)
    kind = ENTRIES[traffic["entry"]]
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.empty(1, device=device)
        phases.mark("context")
        _prebuild(kind.sources)
        phases.mark("compile")
    pin_numerics()
    params = inputs.make_params(cfg, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    phases.mark("weights")
    pool = inputs.token_pool(cfg, traffic, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    phases.mark("pool")
    entry = kind(config, params, pool, traffic, seed)
    del params
    aside = entry.prepare(cell, seed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    phases.mark("capture")
    return entry, pool, aside


def reference_outputs(cell: spec.Cell, seed: int, pool, device, calls=(), precision: str = "f32"):
    """What the plain reference gives in the program's place, in the form
    the program's outputs take: for a train cell the readings of its first
    steps; for a forward cell each call of ``calls``'s logits."""
    cfg = cell.config
    reference.exact_f32()
    params = inputs.make_params(cfg, seed, device)
    mm = reference.Products(precision)
    if cell.traffic["entry"] == "train":
        return reference.sgd_steps(params, [pool[i] for i in range(CHECK_STEPS)], cfg["n_heads"],
                                   cfg["learning_rate"], mm)
    return {i: torch.stack(reference.forward_logits(params, pool[i % len(pool)], cfg["n_heads"], mm))
            for i in calls}


def compare(cell: spec.Cell, seed: int, pool, device, outputs: list) -> list:
    """The numbers of ``check`` for each of ``outputs`` (the program's, or
    a stand-in's) against the float32 reference, computed once."""
    cfg = cell.config
    if cell.traffic["entry"] == "train":
        want = reference_outputs(cell, seed, pool, device)
        return [check.train_numbers(out, want) for out in outputs]
    reference.exact_f32()
    params = inputs.make_params(cfg, seed, device)
    mm = reference.Products("f32")
    gaps = [check.LogitGaps() for _ in outputs]
    for i in sorted(outputs[0]):
        rows = reference.forward_logits(params, pool[i % len(pool)], cfg["n_heads"], mm)
        for gap, out in zip(gaps, outputs):
            gap.add_call(out[i], rows)
    return [{**gap.numbers(), "calls_checked": len(outputs[0])} for gap in gaps]


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
        started: float, phases: Phases | None = None) -> dict:
    """One run of ``cell`` on ``device`` ("cuda", or "cpu" for the tests,
    where the port takes its plain versions): the result's dict and notes
    for standard error."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    phases = phases or Phases(started)
    entry, pool, aside = start(cell, seed, device, phases)
    record = Record(cell, tokens_per_call=cell.traffic["batch"] * cell.traffic["seq"])
    record.setup_s = time.perf_counter() - started - aside

    window(entry, seconds, trace, record, spec.kernel_classes(cell.root))

    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: modules of JAX or the JAX package are loaded: {', '.join(found)}")
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        kind_name = torch.cuda.get_device_name(device)
    else:
        peak, kind_name = 0, "cpu"
    failed = entry.failed
    outputs = entry.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    numbers = compare(cell, seed, pool, device, [outputs])[0]
    correct, checks = check.judge(numbers, cell.limits)
    reference_s = time.perf_counter() - t0

    metrics = {}
    for metric in cell.per_layer if trace else cell.end_to_end:
        value = spec.metric_reader(metric["name"], cell.root)(record)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind_name,
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": record.calls, "failed": failed,
              "metrics": metrics, "device": device_info}
    phases.seconds["capture"] -= aside
    notes = {"setup_s": record.setup_s, "compile_s": phases.seconds.get("compile", 0.0),
             "setup_phases_s": phases.seconds, "check_aside_s": aside, "reference_s": reference_s,
             "calls": record.calls, "window_s": record.window_s, "numbers": numbers}
    if trace:
        reading = record.trace
        device_info.update(busy_s=reading.busy_s, window_s=reading.window_s)
        result["breakdown"] = {"device_ops": reading.device_ops, "idle_gaps": reading.idle_gaps}
        notes.update(traced_calls=reading.calls, class_s=reading.class_s,
                     class_calls=reading.class_calls, glue_kernels=reading.glue_kernels)
    result["checks"] = checks
    return {"result": result, "notes": notes}


def _power() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def main(argv: list | None = None, started: float | None = None) -> None:
    started = time.perf_counter() if started is None else started
    phases = Phases(started)
    phases.mark("imports")
    parser = argparse.ArgumentParser(prog="python -m portbench", description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = spec.find_cell(args.workload)
    os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE / "cuda"))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        sys.exit(2)
    phases.mark("cuda_check")
    torch.set_num_threads(1)
    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", started, phases)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: {', '.join(found)}", file=sys.stderr)
        sys.exit(3)
    result, notes = out["result"], out["notes"]
    # read after the run, so that nvidia-smi's own start is no part of set-up
    print(f"portbench: {_power()}; peaks {counts.PEAK_FLOPS:.4g} FLOP/s bf16, {counts.PEAK_BYTES:.4g} B/s",
          file=sys.stderr)
    print("portbench: " + json.dumps(notes), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
