"""What the port's multi-rank tests run in each spawned rank
(``operator_forge_torch.ranks.run_ranks``).  It imports neither JAX nor
the JAX package, since every rank imports it; inputs arrive and results
leave as numpy arrays."""

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
from torch.distributed.device_mesh import init_device_mesh

from operator_forge_torch import demo
from operator_forge_torch.kernels import rmsnorm


def _numpy(tree: dict) -> dict:
    return demo.tree_map(lambda t: t.detach().numpy(), tree)


def _ring_grads(q, k, v, dout, dtype, mesh) -> tuple:
    """Ring attention of ``q, k, v`` (numpy f32, cast to ``dtype``, one
    name or one for each of q, k and v) over ``mesh``'s ``seq`` dim and its
    gradient for ``dout``, through ``backward()``: ``(out, dq, dk, dv)`` as
    f32 numpy, then the names of those four tensors' types."""
    dtypes = (dtype,) * 3 if isinstance(dtype, str) else dtype

    def typed(a, name):
        return torch.from_numpy(a).to(getattr(torch, name)).requires_grad_()

    q, k, v = (typed(a, name) for a, name in zip((q, k, v), dtypes))
    out = demo.ring_attention(q, k, v, mesh, axis="seq")
    out.backward(torch.from_numpy(dout).to(out.dtype))
    tensors = (out, q.grad, k.grad, v.grad)
    return (*(t.detach().float().numpy() for t in tensors),
            tuple(str(t.dtype).removeprefix("torch.") for t in tensors))


def ring(rings: list, alone: list) -> dict:
    """For each ``(q, k, v, dout, dtype)`` of ``rings``, this rank's blocks
    of ring attention over all ranks on the sequence blocks and of its
    gradient; for each of ``alone``, ring attention and its gradient on a
    ring of one rank (a mesh dim of size 1).  See ``_ring_grads``."""
    n, rank = dist.get_world_size(), dist.get_rank()
    mesh = init_device_mesh("cpu", (n,), mesh_dim_names=("seq",))

    def mine(a):
        return np.ascontiguousarray(np.split(a, n, axis=2)[rank])

    one = init_device_mesh("cpu", (n, 1), mesh_dim_names=("ranks", "seq"))
    return {
        "rings": [_ring_grads(*map(mine, arrays), dtype, mesh) for *arrays, dtype in rings],
        "alone": [_ring_grads(*arrays, dtype, one) for *arrays, dtype in alone],
    }


def megatron(group) -> dict:
    """Forward values and gradients of the model-axis Functions on rank
    ``r`` of ``group``: input ``x_r = (r + 1) * [1, 2, 3]`` and loss
    ``sum(y * (r + 1))`` (for the gather, ``sum(y * arange)``)."""
    r = dist.get_rank(group)
    out = {}
    for name, fn in (("copy", demo.CopyToModel.apply), ("reduce", demo.ReduceFromModel.apply),
                     ("library_all_reduce", lambda x, g: dist_fn.all_reduce(x, group=g)),
                     ("gather", demo.GatherFromModel.apply)):
        x = ((r + 1) * torch.tensor([1.0, 2.0, 3.0])).requires_grad_()
        y = fn(x, group)
        weight = torch.arange(float(y.numel())) if name == "gather" else torch.tensor(r + 1.0)
        (y * weight).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    out["rmsnorm_to_bf16"] = _rmsnorm_to_bf16(group)
    return out


def _rmsnorm_to_bf16(group) -> dict:
    """``rmsnorm_to_bf16`` with the model group, the chain it replaces
    (f32 RMSNorm, ``CopyToModel``, the cast to bf16) and the function
    without a group, on this rank's x and bf16 output gradient: each one's
    output, dx and dgain as f32 numpy."""
    r = dist.get_rank(group)
    g = torch.Generator().manual_seed(5)
    x, gain = torch.randn(4, 16, generator=g) * (r + 1), torch.randn(16, generator=g)
    dy = (torch.randn(4, 16, generator=g) * (r + 1)).bfloat16()
    out = {}
    for name, fn in (
        ("fused", lambda a, b: rmsnorm.rmsnorm_to_bf16(a, b, group)),
        ("chain", lambda a, b: demo.CopyToModel.apply(rmsnorm.rmsnorm(a, b), group).to(torch.bfloat16)),
        ("alone", rmsnorm.rmsnorm_to_bf16),
    ):
        live = [x.clone().requires_grad_(), gain.clone().requires_grad_()]
        y = fn(*live)
        y.backward(dy)
        out[name] = [t.detach().float().numpy() for t in (y, *(t.grad for t in live))]
    return out


def sharded(cases: list) -> dict:
    """On a ``make_mesh(world size)`` mesh: the mesh's layout, the
    Functions on its model group, and for each case ``(config kwargs,
    parameters as numpy, tokens [batch, tok_len], sequence_parallel)`` one
    sharded step from those parameters on this rank's block of the tokens:
    its loss, and on rank 0 the gathered new parameters."""
    rank = dist.get_rank()
    mesh = demo.make_mesh(dist.get_world_size(), "cpu")
    data, model = mesh.size(0), mesh.size(1)
    out = {
        "mesh": (tuple(mesh.mesh.shape), mesh.mesh_dim_names,
                 (mesh.get_local_rank("data"), mesh.get_local_rank("model"))),
        "megatron": megatron(mesh.get_group("model")),
        "steps": [],
    }
    for kwargs, tree, tokens, sequence_parallel in cases:
        config = demo.DemoConfig(**kwargs)
        local = demo.shard_params(demo.params_from_jax(tree, "cpu"), config, mesh)
        block = torch.from_numpy(tokens).long().chunk(data)[mesh.get_local_rank("data")]
        if sequence_parallel:
            block = block.chunk(model, dim=1)[mesh.get_local_rank("model")]
        step = demo.sharded_train_step(mesh, config, sequence_parallel)
        new, loss = step(local, block.contiguous())
        full = demo.gather_params(new, config, mesh)
        out["steps"].append((float(loss), _numpy(full) if rank == 0 else None))
    return out
