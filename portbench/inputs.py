"""What a run feeds the program and the reference alike, made on the device
from the seed: the parameters and a pool of token batches.

Each group of weights (the embedding, the unembedding, and each of the four
products stacked over the layers) is one ``torch.randn`` call on a
generator of its own, seeded from the run's seed and the group's name, so
that any group can be made again alone.  The parameters are in the port's
layout (``demo.tree_map``'s): ``{"embed", "unembed", "layers": [{"wqkv",
"wo", "w1", "w2", "ln1", "ln2"}]}``, f32, weights stored ``(in, out)``, each
layer's weight a view of its group, drawn with the configuration's
published initialisation (``make_group``).
"""

from __future__ import annotations

import hashlib

import torch

GROUPS = ("embed", "unembed", "wqkv", "wo", "w1", "w2")
LAYER_KEYS = ("wqkv", "wo", "w1", "w2", "ln1", "ln2")


def stream_seed(seed: int, what: str) -> int:
    """A 63-bit seed for the generator of ``what`` in the run of ``seed``."""
    digest = hashlib.sha256(f"{seed}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, what: str, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, what))


def group_shape(cfg: dict, name: str) -> tuple:
    d, f, v, n = cfg["d_model"], cfg["d_ff"], cfg["vocab"], cfg["n_layers"]
    return {"embed": (v, d), "unembed": (d, v), "wqkv": (n, d, 3 * d), "wo": (n, d, d),
            "w1": (n, d, f), "w2": (n, f, d)}[name]


def make_group(cfg: dict, seed: int, name: str, device: torch.device) -> torch.Tensor:
    """One group of weights, f32, N(0, std²) with the configuration's
    ``init_std``, or ``init_std_out`` for the products that write the
    residual stream (``wo``, ``w2``)."""
    out = torch.randn(group_shape(cfg, name), generator=generator(seed, name, device), device=device)
    return out.mul_(cfg["init_std_out"] if name in ("wo", "w2") else cfg["init_std"])


def make_params(cfg: dict, seed: int, device: torch.device) -> dict:
    groups = {name: make_group(cfg, seed, name, device) for name in GROUPS}
    return {
        "embed": groups["embed"],
        "unembed": groups["unembed"],
        "layers": [
            {**{k: groups[k][i] for k in ("wqkv", "wo", "w1", "w2")},
             "ln1": torch.ones(cfg["d_model"], device=device),
             "ln2": torch.ones(cfg["d_model"], device=device)}
            for i in range(cfg["n_layers"])
        ],
    }


def group_leaves(params: dict, name: str) -> list:
    """The leaves of group ``name`` in ``params``, one a layer for the
    stacked products."""
    if name in ("embed", "unembed"):
        return [params[name]]
    return [layer[name] for layer in params["layers"]]


def token_pool(cfg: dict, traffic: dict, seed: int, device: torch.device) -> torch.Tensor:
    """``[pool, batch, width]`` int64 token ids, ``width`` the sequence and,
    for a train step, one more for the last target.  Ids follow a Zipf law
    of the traffic's exponent over the vocabulary, its ranks given to ids
    by a permutation from the seed; every seed draws the same shapes."""
    vocab = cfg["vocab"]
    width = traffic["seq"] + (1 if traffic["entry"] == "train" else 0)
    gen = generator(seed, "tokens", device)
    ranks = torch.arange(1, vocab + 1, device=device, dtype=torch.float64)
    cdf = torch.cumsum(ranks.pow(-float(traffic["zipf_exponent"])), 0)
    cdf /= cdf[-1].clone()
    ids = torch.randperm(vocab, generator=gen, device=device)
    u = torch.rand((traffic["pool"], traffic["batch"], width), generator=gen, device=device,
                   dtype=torch.float64)
    return ids[torch.searchsorted(cdf, u).clamp_max_(vocab - 1)]
