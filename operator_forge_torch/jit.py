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
  workspace for that stream, makes cross entropy's ticket counter and sets
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

Each signature holds its static inputs, its outputs and the graph's
private memory pool (every intermediate of a call) for as long as the
jitted function lives.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

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


def _tensors(leaves: list, what: str) -> None:
    for leaf in leaves:
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"jit: every leaf of the {what} must be a tensor, got {type(leaf).__name__}")


@dataclass
class Capture:
    """One signature's graph: its static input and output leaves and the
    output tree's structure."""

    graph: torch.cuda.CUDAGraph
    inputs: list
    outputs: list
    structure: tuple


class Jitted:
    """``fn`` with one CUDA graph per signature of its arguments (see the
    module's docstring).  ``captures`` maps each signature seen on a card
    to its ``Capture``."""

    def __init__(self, fn):
        self.fn = fn
        self.captures: dict[tuple, Capture] = {}

    def __call__(self, *args, **kwargs):
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
        with torch.no_grad():
            _copy(capture.inputs, leaves)
            capture.graph.replay()
            fresh = [torch.empty_like(out) for out in capture.outputs]
            _copy(fresh, capture.outputs)
        return _unflatten(capture.structure, iter(fresh))

    def _capture(self, structure, leaves: list) -> Capture:
        device = leaves[0].device
        inputs = [leaf.detach().clone() for leaf in leaves]
        args, kwargs = _unflatten(structure, iter(inputs))
        with torch.cuda.device(device):
            stream = _capture_stream(device)
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                for _ in range(WARMUP_CALLS):
                    self.fn(*args, **kwargs)
            torch.cuda.current_stream().wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                result = self.fn(*args, **kwargs)
        outputs: list = []
        out_structure = _flatten(result, outputs)
        _tensors(outputs, "result")
        return Capture(graph, inputs, [out.detach() for out in outputs], out_structure)


def jit(fn) -> Jitted:
    """``fn`` captured once per signature into a CUDA graph and replayed
    where its tensors lie on a card, called as it is where they lie on the
    CPU: the counterpart of ``jax.jit`` (see the module's docstring)."""
    return Jitted(fn)
