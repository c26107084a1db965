"""The port's counterpart of ``jax.jit``: a function of tensors captured once
per signature into a CUDA graph and replayed.

``jit(fn)`` returns a callable with ``fn``'s calling convention.  Its
arguments are pytrees (dicts, lists and tuples) whose leaves are tensors,
as the reference's ``params`` dict and ``tokens`` are; values bound by
``functools.partial`` (a ``config``) are static, as under ``jax.jit``.
The leaves choose the device, as every kernel wrapper of the port does:

- on the CPU, ``fn`` itself runs and its result comes back as it is;
- on one CUDA device, each signature (the tree's structure and each
  leaf's shape, dtype and device: ``jax.jit``'s abstract signature) is
  captured once.  The first call of a signature copies the arguments into
  static buffers, calls ``fn`` ``WARMUP_CALLS`` times on the device's
  capture stream (which builds the kernels, sets up cuBLAS's handle and
  workspace for that stream, makes the kernels' ticket counters and sets
  up NCCL's communicators, none of which a capture may do) and captures
  one call on that stream into a ``torch.cuda.CUDAGraph``.  Every call
  then copies its arguments into the buffers (one ``torch._foreach_copy_``
  for the leaves of each dtype: one launch each), replays the graph and
  copies the outputs out of the graph's pool into fresh tensors the same
  way, so that no later call overwrites a tensor an earlier one returned,
  as ``jax.jit`` returns fresh arrays.  One capture stream serves every
  capture on a device: cuBLAS keeps a workspace (64 MiB on an H100) for
  each stream it runs on, for the life of the process.

Leaves that are not tensors raise ``TypeError`` and leaves on more than one
device ``ValueError``, on every call.  A capture or a replay that fails
raises: nothing carries on eagerly.  The replay gives the eager call's
bits: the graph runs the same kernels on the same inputs.  Python side
effects of ``fn``, such as the kernel wrappers' launch counters, happen
while it is warmed and captured and never at a replay, as a jitted
function's happen while it is traced.  ``jit(fn).fn`` is ``fn``.

Every call counts and opens spans in ``telemetry``: ``jit.call`` around
it, ``jit.capture`` (with ``jit.warmup``), ``jit.copy_in``,
``jit.replay`` and ``jit.copy_out`` inside it.  The capture keeps the
device marks that ``telemetry.phase`` records into the graph; a replay
made while tracing is on queues them, and timing events around its
copies, for ``telemetry`` to read.

Each signature holds its static inputs, its outputs and the graph's
private memory pool (every intermediate of a call) for as long as the
jitted function lives.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass

import torch

from . import telemetry

# eager calls of a new signature before its capture
WARMUP_CALLS = 3


@functools.cache
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream every capture on ``device`` warms and captures on."""
    return torch.cuda.Stream(device)


def _copy(dst: list, src: list) -> None:
    """``dst[i].copy_(src[i])`` for every i, one ``_foreach_copy_`` for the
    tensors of each dtype (it takes its one-launch route only where every
    tensor shares a dtype)."""
    groups: dict[torch.dtype, tuple[list, list]] = {}
    for d, t in zip(dst, src):
        to, of = groups.setdefault(d.dtype, ([], []))
        to.append(d)
        of.append(t)
    for to, of in groups.values():
        torch._foreach_copy_(to, of)


def _flatten(tree, leaves: list):
    """Append ``tree``'s leaves to ``leaves`` in order; return its
    structure, a hashable value that ``_unflatten`` rebuilds it from."""
    if isinstance(tree, dict):
        return dict, tuple(tree), tuple(_flatten(tree[key], leaves) for key in tree)
    if type(tree) in (list, tuple):
        return type(tree), len(tree), tuple(_flatten(child, leaves) for child in tree)
    leaves.append(tree)
    return None


def _unflatten(structure, leaves):
    """The tree of ``structure`` with the leaves of the iterator ``leaves``."""
    if structure is None:
        return next(leaves)
    kind, keys, children = structure
    built = [_unflatten(child, leaves) for child in children]
    return dict(zip(keys, built)) if kind is dict else kind(built)


def nbytes(tensors: list) -> int:
    """The bytes of ``tensors``' elements: what ``_copy`` moves to or from them."""
    return sum(t.numel() * t.element_size() for t in tensors)


def _tensors(leaves: list, what: str) -> None:
    for leaf in leaves:
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"jit: every leaf of the {what} must be a tensor, got {type(leaf).__name__}")


@dataclass
class Capture:
    """One signature's graph: its static input and output leaves, the
    output tree's structure, its device marks and the bytes a call copies."""

    graph: torch.cuda.CUDAGraph
    inputs: list
    outputs: list
    structure: tuple
    marks: list         # the graph's device marks (``telemetry.phase``)
    copy_bytes: int     # copied in and out at each call


class Jitted:
    """``fn`` with one CUDA graph per signature of its arguments (see the
    module's docstring).  ``captures`` maps each signature seen on a card
    to its ``Capture``."""

    def __init__(self, fn):
        self.fn = fn
        self.captures: dict[tuple, Capture] = {}

    def __call__(self, *args, **kwargs):
        with telemetry.span("jit.call", telemetry.count("jit.calls")):
            leaves: list = []
            structure = _flatten((args, kwargs), leaves)
            _tensors(leaves, "arguments")
            devices = {leaf.device for leaf in leaves}
            if len(devices) > 1:
                raise ValueError(f"jit: the arguments lie on more than one device: {sorted(map(str, devices))}")
            if not devices or next(iter(devices)).type != "cuda":
                return self.fn(*args, **kwargs)
            key = (structure, tuple((leaf.shape, leaf.dtype, leaf.device) for leaf in leaves))
            capture = self.captures.get(key)
            if capture is None:
                capture = self.captures[key] = self._capture(structure, leaves)
            return self._replay(capture, leaves)

    @staticmethod
    def _replay(capture: Capture, leaves: list):
        """Copy in, replay, copy out; while tracing, the replay's marks and
        timing events around the copies are queued for reading, and read at
        the next replay (``telemetry.settle``)."""
        traced = telemetry.tracing()
        copies = [torch.cuda.Event(enable_timing=True) for _ in range(4)] if traced else None
        with torch.no_grad():
            with telemetry.span("jit.copy_in"):
                if traced:
                    copies[0].record()
                _copy(capture.inputs, leaves)
                if traced:
                    copies[1].record()
            # read earlier replays' marks while the copy runs, before this
            # replay records the graph's events again
            telemetry.settle()
            with telemetry.span("jit.replay"):
                capture.graph.replay()
            with telemetry.span("jit.copy_out"):
                fresh = [torch.empty_like(out) for out in capture.outputs]
                if traced:
                    copies[2].record()
                _copy(fresh, capture.outputs)
                if traced:
                    copies[3].record()
        telemetry.count("jit.replays")
        telemetry.count("jit.copy_bytes", capture.copy_bytes)
        if traced:
            telemetry.pending([*capture.marks, ("jit.copy", [(copies[0], copies[1]), (copies[2], copies[3])])])
        return _unflatten(capture.structure, iter(fresh))

    def _capture(self, structure, leaves: list) -> Capture:
        device = leaves[0].device
        inputs = [leaf.detach().clone() for leaf in leaves]
        args, kwargs = _unflatten(structure, iter(inputs))
        with telemetry.span("jit.capture"), torch.cuda.device(device):
            started = time.perf_counter()
            stream = _capture_stream(device)
            stream.wait_stream(torch.cuda.current_stream())
            with telemetry.span("jit.warmup"), torch.cuda.stream(stream):
                for _ in range(WARMUP_CALLS):
                    self.fn(*args, **kwargs)
            warmed = time.perf_counter()
            torch.cuda.current_stream().wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with telemetry.capturing() as marks, torch.cuda.graph(graph, stream=stream):
                result = self.fn(*args, **kwargs)
            # the capture began with a synchronize: its seconds hold the
            # warm-up calls' device time
            telemetry.count("jit.warmup_s", warmed - started)
            telemetry.count("jit.capture_s", time.perf_counter() - warmed)
            telemetry.count("jit.captures")
        outputs: list = []
        out_structure = _flatten(result, outputs)
        _tensors(outputs, "result")
        outputs = [out.detach() for out in outputs]
        return Capture(graph, inputs, outputs, out_structure, marks, nbytes(inputs) + nbytes(outputs))


def jit(fn) -> Jitted:
    """``fn`` captured once per signature into a CUDA graph and replayed
    where its tensors lie on a card, called as it is where they lie on the
    CPU: the counterpart of ``jax.jit`` (see the module's docstring)."""
    return Jitted(fn)
