"""Driver entry point of the port, the counterpart of
``__graft_entry__.entry`` (``__graft_entry__.py:26-34``)."""

from __future__ import annotations

from functools import partial

import torch

from . import demo


def entry(device: str | torch.device = "cuda", seed: int = 0):
    """Return ``(fn, (params, tokens))``: the forward pass of
    ``DemoConfig()`` with parameters and a token batch drawn from seeded
    generators.  The default device is the card; with none present this
    raises unless ``device="cpu"`` is asked for."""
    config = demo.DemoConfig()
    params = demo.init_params(config, torch.Generator().manual_seed(seed), device)
    tokens = torch.randint(
        0, config.vocab, (config.batch, config.seq_len),
        generator=torch.Generator().manual_seed(seed + 1),
    ).to(device)
    return partial(demo.forward, config=config), (params, tokens)
