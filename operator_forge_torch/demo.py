"""The demo transformer LM in PyTorch: forward pass, loss and SGD train
step, the (data, model) sharded train step, the multi-rank dryrun and
causal ring attention.

Counterpart of ``operator_forge/tpu/demo.py``, section for section under
the reference's headings.  Parameters
keep the JAX layout: a dict ``{"embed", "unembed", "layers": [{"wqkv",
"wo", "w1", "w2", "ln1", "ln2"}]}`` of f32 tensors with weights stored
``(in, out)``, so ``forward`` computes ``x @ w`` as the reference does and
``params_from_jax`` is a plain conversion.  Every cast point of the
reference is kept: bf16 operands for every product with f32 results, and
the attention, RMSNorm, MLP and cross-entropy numerics of the kernels in
``kernels/``, each an autograd ``Function`` whose backward is a kernel too.
Two of the casts are taken into the kernel beside them, with the same
bits: RMSNorm writes the bf16 operand of the product after it, and cross
entropy reads the bf16 logits and returns their gradient in bf16.  The
MLP's GELU runs in the epilogue of the ``w1`` product's kernel, and its
slope in the epilogue of the backward's ``dy @ w2ᵀ``.
The kernels run where the tensors are: a CPU tensor takes the plain
version, a CUDA tensor the hand-written kernel.  The other products, the
residual adds, the embedding gather and the SGD update stay plain tensor
code, as the reference leaves them to XLA.

Where the reference lets XLA shard one program over a ``jax.sharding.Mesh``,
each rank here runs its own program on plain local tensors over
``torch.distributed`` process groups, with the collectives written out.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .kernels.attention import causal_attention
from .kernels.cross_entropy import cross_entropy
from .kernels.mlp import mlp
from .kernels.ring_attention import ring_step, ring_step_bwd
from .kernels.rmsnorm import rmsnorm, rmsnorm_to_bf16
from .jit import jit
from . import telemetry


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


def _attention(x: torch.Tensor, layer: dict, config: DemoConfig, model=None) -> torch.Tensor:
    """f32 or bf16 ``x``.  With a ``model`` group, ``x``'s gradient must
    be all-reduced over it before it leaves (Megatron's "f"), as
    ``rmsnorm_to_bf16`` does in ``_logits``."""
    qkv = _bf16_matmul(x, layer["wqkv"])
    size = _size(model)
    if config.n_heads % size == 0:
        out = causal_attention(qkv, config.n_heads // size)
    else:
        # the heads do not split over the model ranks: every rank runs every
        # head on the gathered product and keeps its own output columns, the
        # rows of ``wo`` it holds
        width, rank = config.d_model // size, dist.get_rank(model)
        whole = GatherHeads.apply(qkv, model, config.d_model)
        out = causal_attention(whole, config.n_heads)[..., rank * width:(rank + 1) * width]
    return reduce_from_model((out @ layer["wo"].to(torch.bfloat16)).float(), model)


def _mlp(x: torch.Tensor, layer: dict, model=None) -> torch.Tensor:
    """f32 or bf16 ``x``, with ``_attention``'s condition on its gradient.
    The ``w1`` product, the GELU and the ``w2`` product are one autograd
    Function (``kernels/mlp.py``); with a ``model`` group ``w1`` and ``w2``
    are this rank's column and row shards."""
    bf16 = torch.bfloat16
    out = mlp(x.to(bf16), layer["w1"].to(bf16), layer["w2"].to(bf16))
    return reduce_from_model(out.float(), model)


def _logits(params: dict, tokens: torch.Tensor, config: DemoConfig, model=None) -> torch.Tensor:
    """Token ids [batch, seq] -> the bf16 product's logits [batch, seq,
    vocab], before the reference widens them (``demo.py:108-109``).  Each
    RMSNorm writes the bf16 operand of the product after it
    (``rmsnorm_to_bf16``, which carries Megatron's "f" for the sharded
    step), so no cast runs between the two."""
    x = params["embed"][tokens]
    for layer in params["layers"]:
        x = x + _attention(rmsnorm_to_bf16(x, layer["ln1"], model), layer, config, model)
        x = x + _mlp(rmsnorm_to_bf16(x, layer["ln2"], model), layer, model)
    return gather_from_model(_bf16_matmul(copy_to_model(x, model), params["unembed"]), model)


def forward(params: dict, tokens: torch.Tensor, config: DemoConfig, model=None) -> torch.Tensor:
    """Token ids [batch, seq] -> f32 logits [batch, seq, vocab].  With a
    ``model`` process group, ``params`` are this rank's Megatron shards
    (``shard_params``) and the collectives join them; the logits come out
    whole on every rank of the group."""
    with telemetry.phase("step.forward"):
        return _logits(params, tokens, config, model).float()


def loss_fn(params: dict, tokens: torch.Tensor, config: DemoConfig, model=None) -> torch.Tensor:
    """Next-token cross entropy of token ids [batch, seq + 1]: an f32
    scalar.  The bf16 logits go straight into the cross-entropy kernel,
    which widens them as it reads them, and its gradient comes back in
    bf16: the reference's widening and its transpose launch nothing."""
    logits = _logits(params, tokens[:, :-1], config, model)
    return cross_entropy(logits, tokens[:, 1:].contiguous())


def value_and_grad(params: dict, tokens: torch.Tensor, config: DemoConfig, model=None) -> tuple:
    """``(loss, grads)``, grads in the parameters' layout: the counterpart
    of ``jax.value_and_grad(loss_fn)``, by autograd; the loss in the phase
    ``step.forward``, the gradients in ``step.backward`` (``telemetry``)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with telemetry.phase("step.forward"):
        loss = loss_fn(live, tokens, config, model)
    with telemetry.phase("step.backward"):
        grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
    return loss.detach(), tree_map(lambda _: next(grads), live)


def train_step(params: dict, tokens: torch.Tensor, config: DemoConfig) -> tuple:
    """One SGD step; returns ``(new_params, loss)``.  The update is the
    reference's ``p - lr * g`` (a product, then a difference: no fused
    multiply-add), into new tensors."""
    loss, grads = value_and_grad(params, tokens, config)
    return _sgd(params, grads, config), loss


def _sgd(params: dict, grads: dict, config: DemoConfig) -> dict:
    lr = config.learning_rate
    with telemetry.phase("step.update"):
        return tree_map(lambda p, g: p.detach() - lr * g, params, grads)


# -- sharding ------------------------------------------------------------
#
# Megatron-style tensor parallelism over the mesh's ``model`` axis, written
# out: each rank holds its column or row shards as plain tensors, and three
# autograd Functions carry the collectives that XLA infers from the
# reference's shardings.  A ``model`` group of None (the single-device
# path) makes each of them the identity.


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class CopyToModel(torch.autograd.Function):
    """Megatron's "f", before a column-parallel product: the identity
    forward; backward, the gradient all-reduced (summed) over the model
    group, since each rank's shard sees only its part of it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class ReduceFromModel(torch.autograd.Function):
    """Megatron's "g", after a row-parallel product: the partial sums
    all-reduced over the model group forward; the identity backward.
    (``torch.distributed.nn.functional.all_reduce`` all-reduces its
    gradient too, which would multiply it by the group's size here.)"""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


class GatherFromModel(torch.autograd.Function):
    """The vocab-sharded logits all-gathered along the last dim over the
    model group forward; backward, this rank's columns of the gradient
    (every rank holds the whole gradient of the same loss)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.rank, ctx.width = dist.get_rank(group), x.shape[-1]
        return _all_gather(x, group, dim=-1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad[..., ctx.rank * ctx.width:(ctx.rank + 1) * ctx.width].contiguous(), None


class GatherHeads(torch.autograd.Function):
    """Where the heads do not split over the model group: each rank's
    columns of the QKV product (``[q_r | k_r | v_r]``, ``_qkv_order``)
    all-gathered and put back in the reference's ``[q | k | v]`` order
    forward.  Backward, each rank holds the gradient of its own output
    columns only, so the gradients are summed over the group (in f32, then
    rounded once to the input's type) before this rank takes its columns."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, d_model: int) -> torch.Tensor:
        order = _qkv_order(d_model, dist.get_world_size(group), x.device)
        ctx.group, ctx.order, ctx.rank, ctx.width = group, order, dist.get_rank(group), x.shape[-1]
        return _all_gather(x, group, dim=-1)[..., torch.argsort(order)]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        total = grad[..., ctx.order].float()
        dist.all_reduce(total, group=ctx.group)
        mine = total[..., ctx.rank * ctx.width:(ctx.rank + 1) * ctx.width]
        return mine.to(grad.dtype).contiguous(), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else GatherFromModel.apply(x, group)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim``, in rank
    order (no gradient)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def mesh_shape(n_devices: int) -> tuple[int, int]:
    """``(data, model)``: the model axis gets 2 when ``n_devices`` is even,
    so tensor parallelism is exercised alongside data parallelism
    (``demo.py:137``)."""
    model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return n_devices // model, model


def make_mesh(n_devices: int, device_type: str = "cuda") -> DeviceMesh:
    """A ``(data, model)`` device mesh of ``mesh_shape(n_devices)`` over the
    default process group, which must exist and hold ``n_devices`` ranks:
    rank ``r`` sits at ``(r // model, r % model)``, as the reference's
    device grid is laid out.  Every rank calls it."""
    return init_device_mesh(device_type, mesh_shape(n_devices), mesh_dim_names=("data", "model"))


def param_specs(config: DemoConfig) -> dict:
    """Megatron-style partition specs, one entry per dim of each leaf:
    qkv/w1/unembed column-parallel, wo/w2 row-parallel over ``model``;
    norms and the embedding replicated (``demo.py:148-160``)."""
    layer = {
        "wqkv": (None, "model"), "wo": ("model", None), "w1": (None, "model"),
        "w2": ("model", None), "ln1": (None,), "ln2": (None,),
    }
    return {
        "embed": (None, None),
        "unembed": (None, "model"),
        "layers": [dict(layer) for _ in range(config.n_layers)],
    }


@functools.cache
def _qkv_order(d_model: int, model: int, device: torch.device) -> torch.Tensor:
    """The column order of ``wqkv`` whose ``model`` equal chunks are
    ``[q_r | k_r | v_r]``, rank ``r``'s heads.  The reference shards
    ``wqkv``'s columns and then splits q, k and v globally (``demo.py:79``);
    a contiguous chunk would hand rank 0 ``[q | half of k]``.  Made once
    for each ``(d_model, model, device)`` and shared (no caller writes to
    it): its host-to-device copy then runs at a step's first call, never in
    a captured one."""
    width = d_model // model
    return torch.tensor(
        [part * d_model + r * width + c for r in range(model) for part in range(3) for c in range(width)],
        device=device,
    )


def _split_model(params: dict, config: DemoConfig, model: int) -> list[dict]:
    """Each model rank's shards of full parameters, ``wqkv``'s columns
    permuted first.  The sharded dims must split evenly, as the reference's
    shardings require; the heads need not (``_attention`` gathers them)."""
    if any(width % model for width in (config.d_model, config.d_ff, config.vocab)):
        raise ValueError(
            f"d_model ({config.d_model}), d_ff ({config.d_ff}) and vocab ({config.vocab}) "
            f"must split evenly over {model} model ranks"
        )
    layers = [
        {**layer, "wqkv": layer["wqkv"][:, _qkv_order(config.d_model, model, layer["wqkv"].device)]}
        for layer in params["layers"]
    ]
    permuted = {**params, "layers": layers}

    def block(p, spec, r):
        if "model" not in spec:
            return p
        return p.chunk(model, dim=spec.index("model"))[r].contiguous()

    return [tree_map(lambda p, spec: block(p, spec, r), permuted, param_specs(config))
            for r in range(model)]


def _join_model(blocks: list[dict], config: DemoConfig) -> dict:
    """Full parameters from every model rank's shards: ``_split_model``
    undone."""
    def join(spec, *parts):
        return torch.cat(parts, dim=spec.index("model")) if "model" in spec else parts[0]

    joined = tree_map(join, param_specs(config), *blocks)
    for layer in joined["layers"]:
        order = _qkv_order(config.d_model, len(blocks), layer["wqkv"].device)
        layer["wqkv"] = layer["wqkv"][:, torch.argsort(order)]
    return joined


def shard_params(params: dict, config: DemoConfig, mesh: DeviceMesh) -> dict:
    """This rank's shards of full parameters (every rank holds the same
    ones), as ``jax.device_put`` with ``param_specs`` places them."""
    return _split_model(params, config, mesh.size(1))[mesh.get_local_rank("model")]


def gather_params(local: dict, config: DemoConfig, mesh: DeviceMesh) -> dict:
    """Full parameters from every model rank's shards, in the reference's
    layout, so they compare leaf for leaf with its gathered arrays.  Every
    rank of the model group calls it."""
    group = mesh.get_group("model")
    size = mesh.size(1)
    parts = tree_map(lambda p: _all_gather(p, group, dim=0).chunk(size), local)
    return _join_model([tree_map(lambda ps: ps[r], parts) for r in range(size)], config)


def sharded_train_step(mesh: DeviceMesh, config: DemoConfig, sequence_parallel: bool = False):
    """The train step on a ``(data, model)`` mesh, the counterpart of
    ``demo.py:163-186``: returns ``jit(step)`` (``jit.py``), as the
    reference returns ``jax.jit`` of its step, with ``step(local_params,
    tokens) -> (new_local_params, loss)`` run by every rank on its own
    shards.  On the card each rank replays its step from a CUDA graph,
    NCCL's collectives inside it; on gloo (CPU tensors) ``step`` runs as it
    is.  The returned function's ``fn`` is the plain ``step``.

    Tokens are this rank's ``[batch / data, tok_len]`` block, or with
    ``sequence_parallel`` its ``[batch / data, tok_len / model]`` block,
    which is all-gathered over ``model`` along the sequence first (the
    all-gather XLA implies).  Attention runs on the rank's
    ``n_heads / model`` heads or, where the heads do not split, on every
    head of the gathered QKV product, keeping the rank's ``d_model /
    model`` output columns; the MLP runs on its ``d_ff / model`` columns;
    the vocab-sharded logits are all-gathered before the cross-entropy
    kernel.  The loss is the mean over the global batch: the gradients and
    the loss are averaged over ``data`` in one all-reduce."""
    model, data = mesh.get_group("model"), mesh.get_group("data")
    n_data = mesh.size(0)

    def step(local: dict, tokens: torch.Tensor) -> tuple:
        if sequence_parallel:
            tokens = _all_gather(tokens, model, dim=1)
        loss, grads = value_and_grad(local, tokens, config, model)
        leaves = [*tree_leaves(grads), loss.view(1)]
        flat = torch.cat([g.reshape(-1) for g in leaves])
        dist.all_reduce(flat, group=data)
        flat = flat / n_data
        parts = iter(t.view_as(g) for t, g in zip(flat.split([g.numel() for g in leaves]), leaves))
        grads = tree_map(lambda _: next(parts), grads)
        return _sgd(local, grads, config), next(parts).view(())

    return jit(step)


def _block(t: torch.Tensor, dim: int, index: int, count: int) -> torch.Tensor:
    """Block ``index`` of ``count`` equal blocks of ``t`` along ``dim``."""
    if t.shape[dim] % count:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into {count} equal blocks")
    return t.chunk(count, dim=dim)[index].contiguous()


def run_dryrun(n_devices: int, config: DemoConfig | None = None, device: str | torch.device = "cuda") -> float:
    """The counterpart of ``demo.py:189-237``, run by each of ``n_devices``
    ranks of the default process group: one sharded (dp x tp, with
    sequence-parallel inputs) train step on tiny shapes (captured and
    replayed on the card, by ``jit``), then ring
    attention over all ranks against the dense reference at rtol and atol
    3e-5 (raising if it disagrees).  Returns the loss.  Inputs come from
    seeded generators, the same on every rank."""
    device = resolve_device(device)
    config = config or DemoConfig(d_model=64, n_heads=2, n_layers=2, d_ff=128, seq_len=16, batch=8)
    mesh = make_mesh(n_devices, device.type)
    params = init_params(config, torch.Generator().manual_seed(0), device)
    # token length seq_len+1 must divide evenly across the model axis for
    # the sequence-parallel input sharding; pad up if needed (the forward
    # then runs on the padded length less one, as the reference's does)
    n_data, model_size = mesh.size(0), mesh.size(1)
    tok_len = config.seq_len + 1
    if tok_len % model_size:
        tok_len += model_size - (tok_len % model_size)
    tokens = torch.randint(
        0, config.vocab, (config.batch, tok_len), generator=torch.Generator().manual_seed(1)
    ).to(device)
    tokens = _block(tokens, 0, mesh.get_local_rank("data"), n_data)
    tokens = _block(tokens, 1, mesh.get_local_rank("model"), model_size)
    step = sharded_train_step(mesh, config, sequence_parallel=True)
    _, loss = step(shard_params(params, config, mesh), tokens)

    # the long-context path: ring attention over all ranks as one ring
    # must agree with the dense reference
    ring_mesh = init_device_mesh(device.type, (n_devices,), mesh_dim_names=("seq",))
    q = torch.randn((2, 2, 8 * n_devices, 16), generator=torch.Generator().manual_seed(2)).to(device)
    mine = _block(q, 2, ring_mesh.get_local_rank("seq"), n_devices)
    ringed = ring_attention(mine, mine, mine, ring_mesh, axis="seq")
    dense = _block(dense_causal_attention(q, q, q), 2, ring_mesh.get_local_rank("seq"), n_devices)
    torch.testing.assert_close(ringed, dense, rtol=3e-5, atol=3e-5)
    return float(loss)


# -- ring attention (sequence/context parallelism) -----------------------


def _exchange(sends: list, receives: list, group, after: int, before: int, tag0: int) -> list:
    """Post the sends of ``sends`` to ``after`` and the receives of
    ``receives`` from ``before``, one tag a tensor from ``tag0``; return
    the requests."""
    return dist.batch_isend_irecv(
        [dist.P2POp(dist.isend, t, after, group, tag=tag0 + i) for i, t in enumerate(sends)]
        + [dist.P2POp(dist.irecv, t, before, group, tag=tag0 + i) for i, t in enumerate(receives)]
    )


def _wait(requests: list) -> None:
    for request in requests:
        request.wait()


class RingAttention(torch.autograd.Function):
    """Causal ring attention over sequence shards, run by each of the ``n``
    ranks of ``group`` on its contiguous shard of q/k/v ``[b, h, s_local,
    d]``, with the gradient ``jax.grad`` derives through the reference's
    ring.

    Forward: K/V blocks travel ``i -> i + 1`` around the ring while the
    online softmax accumulates (``kernels/ring_attention.py``, one launch a
    step), so no rank materialises the full ``[s, s]`` scores.  The next
    block's send and receive are posted before the current block's step,
    so communication overlaps compute, and waited on before the next step.
    There are ``n - 1`` rotations: the reference's last ``ppermute``
    (``demo.py:296-297``) feeds no step.  Grad mode is off inside a
    Function's forward, so the carry is updated in place.  Saves q, k, v,
    the f32 output before its cast, and the final ``(m, den)``.

    Backward: each row's ``D = sum(dout * out)`` on the f32 output (the
    cast's derivative is the identity), then ``(k, v, dk, dv)`` go around
    the ring again, dk and dv accumulating the block's share at every rank
    it visits (one backward step a rotation).  K and V of the next step are
    posted before the step, dk and dv after it.  That takes ``n``
    rotations, one more than the forward: a block's dk and dv reach their
    owner only after the last step's hop, which carries dk and dv alone.
    With one rank nothing moves.

    The kernels take q, k and v all f32 or all bf16.  Other inputs (float16,
    or types that differ, as f32 q with bf16 k and v) are widened to f32
    first, as the reference widens q and each block on its own: a widening
    is exact.  The output comes back in q's type and each gradient in its
    own input's type, each rounded once."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group, n: int) -> torch.Tensor:
        my = dist.get_rank(group)
        b, h, s, d = q.shape
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        if q.dtype not in (torch.float32, torch.bfloat16) or not k.dtype == v.dtype == q.dtype:
            q, k, v = q.float(), k.float(), v.float()
        q, k_blk, v_blk = q.contiguous(), k.contiguous(), v.contiguous()
        m = torch.full((b, h, s, 1), -math.inf, device=q.device)    # running max
        num = torch.zeros((b, h, s, d), device=q.device)             # numerator
        den = torch.zeros((b, h, s, 1), device=q.device)             # denominator
        after = dist.get_global_rank(group, (my + 1) % n)
        before = dist.get_global_rank(group, (my - 1) % n)
        k, v = k_blk, v_blk
        for j in range(n):
            origin = (my - j) % n  # ring position this kv block came from
            if j < n - 1:
                k_next, v_next = torch.empty_like(k_blk), torch.empty_like(v_blk)
                pending = _exchange([k_blk, v_blk], [k_next, v_next], group, after, before, 0)
            ring_step(q, k_blk, v_blk, m, num, den, my, origin)
            if j < n - 1:
                _wait(pending)
                k_blk, v_blk = k_next, v_next
        # every query attends at least to itself (the j=0 diagonal block),
        # so den > 0 everywhere
        out = num / den
        ctx.save_for_backward(q, k, v, out, m, den)
        ctx.group, ctx.n, ctx.my, ctx.after, ctx.before = group, n, my, after, before
        return out.to(ctx.dtypes[0])

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        q, k_blk, v_blk, out, m, den = ctx.saved_tensors
        group, n, my, after, before = ctx.group, ctx.n, ctx.my, ctx.after, ctx.before
        dout = dout.to(q.dtype).contiguous()
        big_d = (dout.float() * out).sum(dim=-1, keepdim=True)
        dq = torch.zeros(out.shape, device=q.device)
        dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
        for j in range(n):
            origin = (my - j) % n  # ring position the kv block (and its dk, dv) came from
            if j < n - 1:
                k_next, v_next = torch.empty_like(k_blk), torch.empty_like(v_blk)
                pending = _exchange([k_blk, v_blk], [k_next, v_next], group, after, before, 0)
            ring_step_bwd(q, k_blk, v_blk, dout, m, den, big_d, my, origin, dq, dk, dv)
            if n > 1:
                dk_next, dv_next = torch.empty_like(dk), torch.empty_like(dv)
                _wait(_exchange([dk, dv], [dk_next, dv_next], group, after, before, 2))
                dk, dv = dk_next, dv_next
            if j < n - 1:
                _wait(pending)
                k_blk, v_blk = k_next, v_next
        dq_type, dk_type, dv_type = ctx.dtypes
        return dq.to(dq_type), dk.to(dk_type), dv.to(dv_type), None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: DeviceMesh,
                   axis: str = "model") -> torch.Tensor:
    """Causal attention with the sequence dimension sharded over the mesh
    dim ``axis``: every rank of that dim passes its own contiguous shard
    ``[b, h, seq / n, d]`` of q, k and v and gets its shard of the output,
    so its peak memory is O(s_local^2) instead of O(seq^2).  With one rank
    on ``axis`` no communication takes place.  ``backward()`` through it
    runs the ring's backward (``RingAttention``)."""
    group = mesh.get_group(axis)
    return RingAttention.apply(q, k, v, group, dist.get_world_size(group))


def dense_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The single-device reference ``ring_attention`` must agree with
    (plain PyTorch, no kernel): scores divided by ``sqrt(d)`` held in a
    device tensor, as the reference divides, and masked with ``-inf``."""
    d = q.shape[-1]
    root = torch.tensor(d, dtype=torch.float32, device=q.device).sqrt()
    scores = (q.float() @ k.float().transpose(-1, -2)) / root
    s = q.shape[2]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask, scores, -math.inf)
    probs = torch.softmax(scores, dim=-1)
    return (probs @ v.float()).to(q.dtype)
