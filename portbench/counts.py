"""Operations and bytes of a call from the cell's shapes, and the card's peaks.

The same whatever implements the call: a product of ``m x k`` by ``k x n``
is ``2 m k n`` operations (2 a multiply-add); attention counts only the
pairs the causal mask leaves, 2 products forward and 4 backward, with no
recomputation; each input is read once and each output written once.  A
train step counts the forward's products once and the backward's twice
(the input's gradient and the weight's), as model FLOPs utilisation does.
"""

from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM: dense bf16 tensor-core rate and HBM3
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    bound and the bytes bound."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def product_weights(cfg: dict) -> int:
    """Weights that enter a product for every token: each layer's QKV,
    output and two MLP products, and the unembedding (the embedding is a
    gather, and the norm gains scale)."""
    d, f = cfg["d_model"], cfg["d_ff"]
    return cfg["n_layers"] * (3 * d * d + d * d + 2 * d * f) + d * cfg["vocab"]


def causal_pairs(seq: int) -> int:
    """(query, key) pairs a causal mask leaves in one sequence of one head."""
    return seq * (seq + 1) // 2


def attention_flops(cfg: dict, batch: int, seq: int, direction: str) -> float:
    """One layer's attention: ``4 d`` a pair forward (scores and ``p @ v``),
    ``8 d`` backward (dV, dP, dQ, dK)."""
    per_pair = {"forward": 4, "backward": 8}[direction] * cfg["head_dim"]
    return float(per_pair * causal_pairs(seq) * batch * cfg["n_heads"])


def attention_bytes(cfg: dict, batch: int, seq: int, direction: str) -> float:
    """Forward: the bf16 QKV product in, the merged heads out.  Backward:
    QKV and the output's gradient in, QKV's gradient out."""
    width = batch * seq * cfg["d_model"] * BF16
    return float({"forward": 3 * width + width, "backward": 3 * width + width + 3 * width}[direction])


def mlp_kernel_call(cfg: dict, batch: int, seq: int, direction: str, keep_pre: bool) -> tuple[float, float]:
    """(operations, bytes) of one call of ``mlp_kernel``.  Forward (``x @
    w1`` with the GELU): x and w1 in, h out, and h_pre out where the
    gradient needs it.  Backward (``dy @ w2ᵀ`` with the GELU's slope): dy,
    w2 and h_pre in, dh_pre out."""
    m, d, f = batch * seq, cfg["d_model"], cfg["d_ff"]
    flops = 2.0 * m * d * f
    if direction == "forward":
        return flops, float(BF16 * (m * d + d * f + m * f * (2 if keep_pre else 1)))
    return flops, float(BF16 * (m * d + f * d + 2 * m * f))


def model_flops(cfg: dict, batch: int, seq: int, entry: str) -> float:
    """The model's operations for one call of ``entry``: every product
    (2 a weight and token forward, 6 for a train step) and attention."""
    tokens = batch * seq
    attention = attention_flops(cfg, batch, seq, "forward")
    if entry == "train":
        attention += attention_flops(cfg, batch, seq, "backward")
        return 6.0 * product_weights(cfg) * tokens + cfg["n_layers"] * attention
    if entry == "forward":
        return 2.0 * product_weights(cfg) * tokens + cfg["n_layers"] * attention
    raise ValueError(f"no operation count for entry {entry!r}")


def parameters(cfg: dict) -> int:
    """Every parameter: the products' weights, the embedding and the two
    norm gains of each layer."""
    return product_weights(cfg) + cfg["vocab"] * cfg["d_model"] + 2 * cfg["n_layers"] * cfg["d_model"]
