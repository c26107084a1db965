"""The demo block from its equations, in plain PyTorch and float32.

    x     = embed[tokens]
    per layer:
      x  += attn(rmsnorm(x) * ln1) @ wo      causal softmax(q kᵀ / sqrt(d_head)) v over each head
      x  += gelu_tanh(rmsnorm(x) * ln2 @ w1) @ w2
    logits = x @ unembed
    loss   = mean over tokens of -log softmax(logits)[next token]
    step   : p <- p - lr * dloss/dp  for every parameter

with ``rmsnorm(x) = x / sqrt(mean(x²) + 1e-6)``, weights stored ``(in,
out)``, q, k and v the QKV product's three equal column blocks, the heads
``d_head`` wide and merged back in order.  Every product runs in float32
with TF32 off (``products.exact_f32``), unless ``Products`` is asked to
hold its operands in fp8, which is the lower-precision control, not the
reference.

This module imports nothing of the program under test: it takes the
parameters and tokens the benchmark made, never anything the program made
from them.  Memory: a train step runs ``TOKENS_AT_ONCE`` tokens' rows at a
time (each part's gradient summed with the weight of its share of the rows)
and recomputes each layer in the backward (``torch.utils.checkpoint``), so
that it fits beside what the run keeps; neither changes the arithmetic's
result beyond the order of sums.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference.products import Products

EPS = 1e-6
TOKENS_AT_ONCE = 8192
GELU_C = math.sqrt(2.0 / math.pi)


def rmsnorm(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(x.square().mean(dim=-1, keepdim=True) + EPS) * gain


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(GELU_C * (x + 0.044715 * x * x * x)))


def block(x: torch.Tensor, layer: dict, n_heads: int, mm: Products) -> torch.Tensor:
    """One layer on ``x [rows, seq, d_model]``."""
    rows, seq, width = x.shape
    head = width // n_heads
    q, k, v = (t.reshape(rows, seq, n_heads, head).transpose(1, 2)
               for t in mm(rmsnorm(x, layer["ln1"]), layer["wqkv"]).chunk(3, dim=-1))
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(head)
    causal = torch.ones(seq, seq, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
    heads = mm(probs, v).transpose(1, 2).reshape(rows, seq, width)
    x = x + mm(heads, layer["wo"])
    return x + mm(gelu_tanh(mm(rmsnorm(x, layer["ln2"]), layer["w1"])), layer["w2"])


def logits(params: dict, tokens: torch.Tensor, n_heads: int, mm: Products,
           recompute: bool = False) -> torch.Tensor:
    """Token ids ``[rows, seq]`` -> float32 logits ``[rows, seq, vocab]``;
    with ``recompute`` each layer is recomputed in the backward."""
    x = params["embed"][tokens]
    for layer in params["layers"]:
        if recompute:
            x = checkpoint(block, x, layer, n_heads, mm, use_reentrant=False)
        else:
            x = block(x, layer, n_heads, mm)
    return mm(x, params["unembed"])


def next_token_nll(params: dict, tokens: torch.Tensor, n_heads: int, mm: Products,
                   recompute: bool = False) -> torch.Tensor:
    """Mean negative log-likelihood of ``tokens [rows, seq + 1]``'s next
    tokens."""
    out = logits(params, tokens[:, :-1], n_heads, mm, recompute)
    logp = torch.log_softmax(out, dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None]).mean()


def leaves(params: dict) -> list:
    """The parameters in one fixed order: embedding, unembedding, then each
    layer's ``wqkv, wo, w1, w2, ln1, ln2``."""
    return [params["embed"], params["unembed"],
            *(layer[k] for layer in params["layers"] for k in ("wqkv", "wo", "w1", "w2", "ln1", "ln2"))]


def sgd_steps(params: dict, batches: list, cfg: dict, mm: Products) -> dict:
    """Train ``params`` (updated in place) for one step a batch of
    ``batches`` (each ``[batch, seq + 1]``) at the configuration's
    ``learning_rate``, each step's loss the mean over the batch.  Returns each
    step's loss, each leaf's norm of the first gradient as the update took
    it, ``|p0 - p1| / lr``, and each leaf's norm of the change after the
    last step, ``|p_n - p0|``; leaves in ``leaves``'s order."""
    n_heads, lr = cfg["n_heads"], cfg["learning_rate"]
    start = [p.detach().clone() for p in leaves(params)]
    live = leaves(params)
    for p in live:
        p.requires_grad_(True)
    losses, first = [], None
    for step, batch in enumerate(batches):
        total = 0.0
        for part in batch.split(_rows_at_once(batch)):
            loss = next_token_nll(params, part, n_heads, mm, recompute=True) * (len(part) / len(batch))
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            norms = []
            for p in live:
                new = p - lr * p.grad
                if step == 0:
                    norms.append(torch.linalg.vector_norm(p - new) / lr)
                p.copy_(new)
                p.grad = None
            if step == 0:
                first = torch.stack(norms).tolist()
    with torch.no_grad():
        change = torch.stack([torch.linalg.vector_norm(p - p0) for p, p0 in zip(live, start)]).tolist()
    for p in live:
        p.requires_grad_(False)
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def _rows_at_once(tokens: torch.Tensor) -> int:
    return max(1, TOKENS_AT_ONCE // tokens.shape[1])


def forward_logits(params: dict, tokens: torch.Tensor, cfg: dict, mm: Products) -> list:
    """float32 logits of ``tokens [batch, seq]``, one ``[seq, vocab]``
    tensor a row, computed ``TOKENS_AT_ONCE`` tokens' rows at a time."""
    with torch.no_grad():
        return [row for part in tokens.split(_rows_at_once(tokens))
                for row in logits(params, part, cfg["n_heads"], mm)]
