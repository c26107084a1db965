"""Driver entry points of the port: ``entry``, the counterpart of
``__graft_entry__.entry`` (``__graft_entry__.py:26-34``); ``train_entry``,
the train step that the reference's dryruns run
(``operator_forge/tpu/demo.py:121-127``); and ``dryrun_multichip``, the
counterpart of ``__graft_entry__.dryrun_multichip``
(``__graft_entry__.py:37-41``)."""

from __future__ import annotations

from functools import partial

import torch

from . import demo, ranks


def pin_numerics() -> None:
    """Make the card's products accumulate in f32, as the reference's do:
    no TF32 for f32 products, and no reduced-precision reduction inside
    cuBLAS's bf16 products (PyTorch allows it by default).  Process-wide;
    it changes nothing on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _seeded(config: demo.DemoConfig, device, seed: int, seq_len: int):
    """Parameters and a token batch [batch, seq_len] from seeded generators,
    with the products pinned to f32 accumulation."""
    params = demo.init_params(config, torch.Generator().manual_seed(seed), device)
    tokens = torch.randint(
        0, config.vocab, (config.batch, seq_len),
        generator=torch.Generator().manual_seed(seed + 1),
    ).to(device)
    pin_numerics()
    return params, tokens


def entry(device: str | torch.device = "cuda", seed: int = 0):
    """Return ``(fn, (params, tokens))``: the forward pass of
    ``DemoConfig()`` with parameters and a token batch [8, 64] drawn from
    seeded generators.  ``fn`` is the eager forward, the "jittable forward
    step" of the reference's ``entry``: its caller takes ``jit.jit(fn)``
    for the forward replayed from a CUDA graph.  The default device is the
    card; with none present this raises unless ``device="cpu"`` is asked
    for.  Pins the products to f32 accumulation for the whole process
    (``pin_numerics``), before any capture."""
    config = demo.DemoConfig()
    params, tokens = _seeded(config, device, seed, config.seq_len)
    return partial(demo.forward, config=config), (params, tokens)


def train_entry(device: str | torch.device = "cuda", seed: int = 0):
    """Return ``(fn, (params, tokens))``: one SGD step of ``DemoConfig()``,
    ``fn(params, tokens) -> (new_params, loss)``, with parameters and a
    token batch [8, 65] (inputs and next-token targets) drawn from seeded
    generators.  ``fn`` is the eager step; ``jit.jit(fn)`` is the step
    replayed from a CUDA graph.  The default device is the card; with none
    present this raises unless ``device="cpu"`` is asked for.  Pins the
    products to f32 accumulation for the whole process (``pin_numerics``),
    before any capture."""
    config = demo.DemoConfig()
    params, tokens = _seeded(config, device, seed, config.seq_len + 1)
    return partial(demo.train_step, config=config), (params, tokens)


def _dryrun_rank(n_devices: int, device_type: str) -> float:
    pin_numerics()
    return demo.run_dryrun(n_devices, device=device_type)


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> float:
    """Run ``demo.run_dryrun`` in ``n_devices`` spawned ranks: one sharded
    (dp x tp, sequence-parallel inputs) train step on a ``(data, model)``
    mesh (on the card, each rank's step captured and replayed by
    ``jit``), then ring attention over all ranks against the dense
    reference.
    Returns the loss, after checking it is not NaN.  The default device is
    the card, one card a rank on NCCL: this raises where there is no card
    or fewer cards than ranks.  With ``device="cpu"`` the ranks run on
    gloo.  A rank that fails, or that has not returned within
    ``run_ranks``'s deadline, raises."""
    device = demo.resolve_device(device)
    loss = ranks.run_ranks(n_devices, _dryrun_rank, (n_devices, device.type), device.type)[0]
    if loss != loss:
        raise RuntimeError("the sharded train step's loss is NaN")
    return loss
