"""The demo transformer LM's forward pass in PyTorch.

Counterpart of ``operator_forge/tpu/demo.py`` lines 27-109.  Parameters
keep the JAX layout: a dict ``{"embed", "unembed", "layers": [{"wqkv",
"wo", "w1", "w2", "ln1", "ln2"}]}`` of f32 tensors with weights stored
``(in, out)``, so ``forward`` computes ``x @ w`` as the reference does and
``params_from_jax`` is a plain conversion.  Every cast point of the
reference is kept: bf16 operands for every product with f32 results, and
the attention, RMSNorm and GELU numerics of the kernels in ``kernels/``.
The kernels run where the tensors are: a CPU tensor takes the plain
version, a CUDA tensor the hand-written kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .kernels.attention import causal_attention
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


def params_from_jax(tree: dict, device: str | torch.device = "cuda") -> dict:
    """Convert the reference's parameter pytree (leaves as numpy arrays,
    ``np.asarray`` of each JAX array) into this module's parameters.  Each
    array is copied: numpy views of JAX arrays are read-only."""
    device = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(device)

    return {
        "embed": tensor(tree["embed"]),
        "unembed": tensor(tree["unembed"]),
        "layers": [
            {name: tensor(layer[name]) for name in ("wqkv", "wo", "w1", "w2", "ln1", "ln2")}
            for layer in tree["layers"]
        ],
    }


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
