"""What a run feeds the program and the reference alike, made on the device
from the seed, whatever the architecture: a generator for each named part
of the inputs, and a pool of token batches.  Each architecture's weights
(``models/<architecture>.py``, ``make_params``) are drawn on generators
from ``generator``, one a group of weights named after it, so that any
group can be made again alone.
"""

from __future__ import annotations

import hashlib

import torch


def stream_seed(seed: int, what: str) -> int:
    """A 63-bit seed for the generator of ``what`` in the run of ``seed``."""
    digest = hashlib.sha256(f"{seed}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, what: str, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, what))


def token_pool(vocab: int, traffic: dict, seed: int, device: torch.device) -> torch.Tensor:
    """``[pool, batch, width]`` int64 token ids below ``vocab``, ``width``
    the sequence and, for a train step, one more for the last target.  Ids
    follow a Zipf law of the traffic's exponent over the vocabulary, its
    ranks given to ids by a permutation from the seed; every seed draws the
    same shapes."""
    width = traffic["seq"] + (1 if traffic["entry"] == "train" else 0)
    gen = generator(seed, "tokens", device)
    ranks = torch.arange(1, vocab + 1, device=device, dtype=torch.float64)
    cdf = torch.cumsum(ranks.pow(-float(traffic["zipf_exponent"])), 0)
    cdf /= cdf[-1].clone()
    ids = torch.randperm(vocab, generator=gen, device=device)
    u = torch.rand((traffic["pool"], traffic["batch"], width), generator=gen, device=device,
                   dtype=torch.float64)
    return ids[torch.searchsorted(cdf, u).clamp_max_(vocab - 1)]
