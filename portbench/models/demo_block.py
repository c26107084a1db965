"""The demo block (``operator_forge_torch.demo``) as the harness runs and
counts it: a pre-norm transformer of RMSNorm, causal attention over one QKV
product, a GELU MLP, and an untied unembedding, trained by plain SGD.

The parameters are in the port's layout (``demo.tree_map``'s): ``{"embed",
"unembed", "layers": [{"wqkv", "wo", "w1", "w2", "ln1", "ln2"}]}``, f32,
weights stored ``(in, out)``.  Each group of weights (the embedding, the
unembedding, and each of the four products stacked over the layers) is one
``torch.randn`` call on the generator of its name (``inputs.generator``),
drawn with the configuration's published initialisation (``make_group``);
each layer's weight is a view of its group.
"""

from __future__ import annotations

import functools

import torch
from operator_forge_torch import demo

from portbench import counts, inputs

# the port's CUDA sources each entry reaches, built before the capture
SOURCES = {
    "train": ("causal_attention", "mlp", "rmsnorm", "rmsnorm_bwd", "cross_entropy"),
    "forward": ("causal_attention", "mlp", "rmsnorm"),
}
GROUPS = ("embed", "unembed", "wqkv", "wo", "w1", "w2")
LAYER_KEYS = ("wqkv", "wo", "w1", "w2", "ln1", "ln2")


def program(cfg: dict, traffic: dict, entry: str):
    """The callable that ``jit`` wraps for ``entry``: ``demo.train_step`` or
    ``demo.forward`` at the configuration's sizes and the traffic's batch
    and sequence."""
    config = demo.DemoConfig(vocab=cfg["vocab"], d_model=cfg["d_model"], n_heads=cfg["n_heads"],
                             n_layers=cfg["n_layers"], d_ff=cfg["d_ff"], seq_len=traffic["seq"],
                             batch=traffic["batch"], learning_rate=cfg["learning_rate"])
    if config.head_dim != cfg["head_dim"]:
        raise ValueError(f"head_dim {cfg['head_dim']} is not d_model / n_heads "
                         f"({cfg['d_model']} / {cfg['n_heads']})")
    fn = {"train": demo.train_step, "forward": demo.forward}[entry]
    return functools.partial(fn, config=config)


def vocab(cfg: dict) -> int:
    """The vocabulary the traffic's token ids are drawn from."""
    return cfg["vocab"]


# -- weights ---------------------------------------------------------------


def group_shape(cfg: dict, name: str) -> tuple:
    d, f, v, n = cfg["d_model"], cfg["d_ff"], cfg["vocab"], cfg["n_layers"]
    return {"embed": (v, d), "unembed": (d, v), "wqkv": (n, d, 3 * d), "wo": (n, d, d),
            "w1": (n, d, f), "w2": (n, f, d)}[name]


def make_group(cfg: dict, seed: int, name: str, device: torch.device) -> torch.Tensor:
    """One group of weights, f32, N(0, std²) with the configuration's
    ``init_std``, or ``init_std_out`` for the products that write the
    residual stream (``wo``, ``w2``)."""
    out = torch.randn(group_shape(cfg, name), generator=inputs.generator(seed, name, device), device=device)
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


def leaves(params: dict) -> list:
    """The parameters in the order of the check's norms: ``demo.tree_leaves``'s,
    which is the reference's ``leaves``'s."""
    return demo.tree_leaves(params)


def change_norms(params: dict, cfg: dict, seed: int, device: torch.device) -> list:
    """|p - p0| of each leaf, the seed's weights made again a group at a
    time, in ``leaves``'s order."""
    found = {}
    for name in GROUPS:
        start = make_group(cfg, seed, name, device)
        starts = [start] if name in ("embed", "unembed") else list(start)
        for i, (leaf, p0) in enumerate(zip(group_leaves(params, name), starts)):
            found[(name, i)] = torch.linalg.vector_norm(leaf - p0)
        del start, starts
    for i, layer in enumerate(params["layers"]):
        for name in ("ln1", "ln2"):
            found[(name, i)] = torch.linalg.vector_norm(layer[name] - 1.0)
    order = [("embed", 0), ("unembed", 0)] + [(k, i) for i in range(cfg["n_layers"]) for k in LAYER_KEYS]
    return torch.stack([found[key] for key in order]).tolist()


# -- counts ----------------------------------------------------------------


def product_weights(cfg: dict) -> int:
    """Weights that enter a product for every token: each layer's QKV,
    output and two MLP products, and the unembedding (the embedding is a
    gather, and the norm gains scale)."""
    d, f = cfg["d_model"], cfg["d_ff"]
    return cfg["n_layers"] * (3 * d * d + d * d + 2 * d * f) + d * cfg["vocab"]


def _heads(cfg: dict) -> tuple:
    """Attention's heads, their query and key width, and their value width."""
    return cfg["n_heads"], cfg["head_dim"], cfg["head_dim"]


def model_flops(cfg: dict, batch: int, seq: int, entry: str) -> float:
    """The model's operations for one call of ``entry``: every product
    (2 a weight and token forward, 6 for a train step) and attention."""
    tokens = batch * seq
    attention = counts.attention_flops(batch, seq, *_heads(cfg), "forward")
    if entry == "train":
        attention += counts.attention_flops(batch, seq, *_heads(cfg), "backward")
        return 6.0 * product_weights(cfg) * tokens + cfg["n_layers"] * attention
    if entry == "forward":
        return 2.0 * product_weights(cfg) * tokens + cfg["n_layers"] * attention
    raise ValueError(f"no operation count for entry {entry!r}")


def parameters(cfg: dict) -> int:
    """Every parameter: the products' weights, the embedding and the two
    norm gains of each layer."""
    return product_weights(cfg) + cfg["vocab"] * cfg["d_model"] + 2 * cfg["n_layers"] * cfg["d_model"]


def _attention_call(cfg, batch, seq, kind, call):
    direction = "forward" if call == "causal_attention" else "backward"
    return (counts.attention_flops(batch, seq, *_heads(cfg), direction),
            counts.attention_bytes(batch, seq, *_heads(cfg), direction))


def _mlp_call(cfg, batch, seq, kind, call):
    direction = "forward" if call == "matmul_gelu" else "backward"
    return counts.mlp_kernel_call(batch * seq, cfg["d_model"], cfg["d_ff"], direction,
                                  keep_pre=kind == "train")


# each kernel class's calls, by the call a kernel marks: (operations, bytes)
CALLS = {
    "attention": {"causal_attention": _attention_call, "causal_attention_bwd": _attention_call},
    "mlp": {"matmul_gelu": _mlp_call, "matmul_gelu_bwd": _mlp_call},
}
