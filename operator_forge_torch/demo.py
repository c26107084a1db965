"""The demo transformer LM's forward pass, loss and SGD train step in
PyTorch.

Counterpart of ``operator_forge/tpu/demo.py`` lines 27-127.  Parameters
keep the JAX layout: a dict ``{"embed", "unembed", "layers": [{"wqkv",
"wo", "w1", "w2", "ln1", "ln2"}]}`` of f32 tensors with weights stored
``(in, out)``, so ``forward`` computes ``x @ w`` as the reference does and
``params_from_jax`` is a plain conversion.  Every cast point of the
reference is kept: bf16 operands for every product with f32 results, and
the attention, RMSNorm, GELU and cross-entropy numerics of the kernels in
``kernels/``, each an autograd ``Function`` whose backward is a kernel too.
The kernels run where the tensors are: a CPU tensor takes the plain
version, a CUDA tensor the hand-written kernel.  The products, the residual
adds, the embedding gather and the SGD update stay plain tensor code, as
the reference leaves them to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .kernels.attention import causal_attention
from .kernels.cross_entropy import cross_entropy
from .kernels.gelu import gelu_tanh
from .kernels.rmsnorm import rmsnorm


@dataclass(frozen=True)
class DemoConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    seq_len: int = 64
    batch: int = 8
    learning_rate: float = 1e-2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def resolve_device(device: str | torch.device) -> torch.device:
    """The device asked for; a CUDA device with no card present raises
    rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "versions on the CPU"
        )
    return device


def init_params(
    config: DemoConfig, generator: torch.Generator, device: str | torch.device = "cuda"
) -> dict:
    """Parameters of the reference's shapes: N(0, 0.02²) weights and unit
    norm gains, drawn on the CPU from ``generator`` (so a seed gives the
    same weights on every device) and then moved to ``device``."""
    device = resolve_device(device)

    def dense(*shape):
        return (0.02 * torch.randn(shape, generator=generator)).to(device)

    params: dict[str, Any] = {
        "embed": dense(config.vocab, config.d_model),
        "unembed": dense(config.d_model, config.vocab),
        "layers": [],
    }
    for _ in range(config.n_layers):
        params["layers"].append(
            {
                "wqkv": dense(config.d_model, 3 * config.d_model),
                "wo": dense(config.d_model, config.d_model),
                "w1": dense(config.d_model, config.d_ff),
                "w2": dense(config.d_ff, config.d_model),
                "ln1": torch.ones(config.d_model, device=device),
                "ln2": torch.ones(config.d_model, device=device),
            }
        )
    return params


LAYER_KEYS = ("wqkv", "wo", "w1", "w2", "ln1", "ln2")


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """Apply ``fn`` leafwise over parameter dicts of one layout, as
    ``jax.tree_util.tree_map`` does over the reference's pytree."""
    trees = (tree, *rest)
    return {
        "embed": fn(*(t["embed"] for t in trees)),
        "unembed": fn(*(t["unembed"] for t in trees)),
        "layers": [
            {name: fn(*(layer[name] for layer in layers)) for name in LAYER_KEYS}
            for layers in zip(*(t["layers"] for t in trees))
        ],
    }


def tree_leaves(tree: dict) -> list:
    """The leaves of a parameter dict, in ``tree_map``'s order."""
    return [tree["embed"], tree["unembed"],
            *(layer[name] for layer in tree["layers"] for name in LAYER_KEYS)]


def params_from_jax(tree: dict, device: str | torch.device = "cuda") -> dict:
    """Convert the reference's parameter pytree (leaves as numpy arrays,
    ``np.asarray`` of each JAX array) into this module's parameters.  Each
    array is copied: numpy views of JAX arrays are read-only."""
    device = resolve_device(device)
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(device),
        tree,
    )


def _bf16_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16) @ w.to(torch.bfloat16)


_rmsnorm = rmsnorm  # demo.py:71-73


def _attention(x: torch.Tensor, layer: dict, config: DemoConfig) -> torch.Tensor:
    qkv = _bf16_matmul(x, layer["wqkv"])
    out = causal_attention(qkv, config.n_heads)
    return (out @ layer["wo"].to(torch.bfloat16)).float()


def _mlp(x: torch.Tensor, layer: dict) -> torch.Tensor:
    h = gelu_tanh(_bf16_matmul(x, layer["w1"]))
    return (h @ layer["w2"].to(torch.bfloat16)).float()


def forward(params: dict, tokens: torch.Tensor, config: DemoConfig) -> torch.Tensor:
    """Token ids [batch, seq] -> f32 logits [batch, seq, vocab]."""
    x = params["embed"][tokens]
    for layer in params["layers"]:
        x = x + _attention(_rmsnorm(x, layer["ln1"]), layer, config)
        x = x + _mlp(_rmsnorm(x, layer["ln2"]), layer)
    return _bf16_matmul(x, params["unembed"]).float()


def loss_fn(params: dict, tokens: torch.Tensor, config: DemoConfig) -> torch.Tensor:
    """Next-token cross entropy of token ids [batch, seq + 1]: an f32
    scalar."""
    logits = forward(params, tokens[:, :-1], config)
    return cross_entropy(logits, tokens[:, 1:].contiguous())


def value_and_grad(params: dict, tokens: torch.Tensor, config: DemoConfig) -> tuple:
    """``(loss, grads)``, grads in the parameters' layout: the counterpart
    of ``jax.value_and_grad(loss_fn)``, by autograd."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = loss_fn(live, tokens, config)
    grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
    return loss.detach(), tree_map(lambda _: next(grads), live)


def train_step(params: dict, tokens: torch.Tensor, config: DemoConfig) -> tuple:
    """One SGD step; returns ``(new_params, loss)``.  The update is the
    reference's ``p - lr * g`` (a product, then a difference: no fused
    multiply-add), into new tensors."""
    loss, grads = value_and_grad(params, tokens, config)
    lr = config.learning_rate
    return tree_map(lambda p, g: p.detach() - lr * g, params, grads), loss
