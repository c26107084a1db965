"""Operations and bytes of one call from its shapes, and the card's peaks:
the formulas that an architecture's counts (``models/<architecture>.py``)
are built from.

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


def causal_pairs(seq: int) -> int:
    """(query, key) pairs a causal mask leaves in one sequence of one head."""
    return seq * (seq + 1) // 2


def attention_flops(batch: int, seq: int, heads: int, qk_dim: int, v_dim: int, direction: str) -> float:
    """One layer's causal attention over ``heads`` heads whose queries and
    keys are ``qk_dim`` wide and values ``v_dim``: forward, the scores and
    ``p @ v``, ``2 (qk_dim + v_dim)`` a pair; backward, dV, dP, dQ and dK,
    twice that."""
    per_pair = {"forward": 2, "backward": 4}[direction] * (qk_dim + v_dim)
    return float(per_pair * causal_pairs(seq) * batch * heads)


def attention_bytes(batch: int, seq: int, heads: int, qk_dim: int, v_dim: int, direction: str) -> float:
    """Forward: q, k and v in bf16 in, the heads' outputs out.  Backward: q,
    k, v and the outputs' gradient in, the gradients of q, k and v out."""
    tokens = batch * seq * heads * BF16
    qkv = tokens * (2 * qk_dim + v_dim)
    out = tokens * v_dim
    return float({"forward": qkv + out, "backward": qkv + out + qkv}[direction])


def mlp_kernel_call(tokens: int, d_in: int, d_out: int, direction: str, keep_pre: bool) -> tuple[float, float]:
    """(operations, bytes) of one call of ``mlp_kernel`` on ``tokens`` rows,
    its weight ``d_in x d_out``.  Forward (``x @ w1`` with the GELU): x and
    w1 in, h out, and h_pre out where the gradient needs it.  Backward
    (``dy @ w2ᵀ`` with the GELU's slope, ``w2`` being ``d_out x d_in``):
    dy, w2 and h_pre in, dh_pre out."""
    m, d, f = tokens, d_in, d_out
    flops = 2.0 * m * d * f
    if direction == "forward":
        return flops, float(BF16 * (m * d + d * f + m * f * (2 if keep_pre else 1)))
    return flops, float(BF16 * (m * d + f * d + 2 * m * f))
