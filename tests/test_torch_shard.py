"""The port's (data, model) sharded train step
(``operator_forge_torch.demo.sharded_train_step``: ``make_mesh``,
``param_specs``, the shard and gather helpers and the Megatron Functions)
against the JAX reference (``operator_forge/tpu/demo.py:133-186``), on the
CPU, on the same parameters and tokens.

The port's 8 ranks are gloo processes spawned once for the module
(``operator_forge_torch.ranks.run_ranks``, running
``tests/torch_ranks.py``); JAX runs on 8 virtual CPU devices.

Tolerances:
- the loss within 5e-5, the port's single-device bar, inside the
  reference's own 1e-3 (``test_tpu_demo.py:69``); measured 2.4e-6;
- each gathered parameter within ``step_tolerance`` (lr x 4 bf16 ulps of
  the leaf's max |g| + 1 f32 ulp of |p|), the single-device step's bound:
  a row-parallel product sums two bf16-rounded partials in f32 where the
  reference rounds the whole sum once, which moves a gradient by at most
  one more bf16 ulp of the partials (each no larger than the sum);
  measured at most 0.86 of the bound.
"""

import jax
import numpy as np
import pytest
import torch

import torch_ranks
from operator_forge.tpu import demo as jdemo
from operator_forge_torch import demo, ranks
from operator_forge_torch.kernels import step_tolerance

RANKS_TIMEOUT = 240
TEST_CONFIG = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, seq_len=16, batch=8)
# (config, sequence_parallel, token length, ranks): the reference's own
# test step, DemoConfig() at full width, and the dryrun's SP step, whose
# 17 tokens pad to 18 over the model axis, on the (4, 2) mesh; then heads
# that do not split over the model axis (3 heads of 32 and of 22 on the
# (4, 2) mesh, also with the SP step, 1 head on a (1, 2) mesh), which every
# rank runs whole
CASES = {
    "test": (TEST_CONFIG, False, 17, 8),
    "default": ({}, False, 65, 8),
    "test_sp": (TEST_CONFIG, True, 18, 8),
    "uneven_heads": (dict(d_model=96, n_heads=3, d_ff=384), False, 65, 8),
    "uneven_heads_66": (dict(d_model=66, n_heads=3), False, 65, 8),
    "uneven_heads_sp": (dict(TEST_CONFIG, d_model=96, n_heads=3), True, 18, 8),
    "one_head": (dict(d_model=64, n_heads=1), False, 65, 2),
}


def _as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def sharded_run():
    """JAX's sharded step on a mesh of each case's devices, and the
    port's: 8 ranks spawned once for the (4, 2) mesh's cases, 2 for the
    (1, 2) mesh's, then 1 rank for the (1, 1) mesh.  ``got[name]`` holds
    each rank's ``(loss, gathered parameters on rank 0)``, ``mesh`` the
    8 ranks' layouts and ``megatron`` their Functions' results."""
    grad = jax.jit(jax.grad(jdemo.loss_fn), static_argnums=2)
    cases, want = {8: [], 2: []}, {}
    for name, (kwargs, sequence_parallel, tok_len, n_ranks) in CASES.items():
        jmesh = jdemo.make_mesh(n_ranks)
        jconfig = jdemo.DemoConfig(**kwargs)
        jparams = jdemo.init_params(jconfig, jax.random.PRNGKey(0))
        jtokens = jax.random.randint(jax.random.PRNGKey(1), (jconfig.batch, tok_len), 0, jconfig.vocab)
        step = jdemo.sharded_train_step(jmesh, jconfig, sequence_parallel=sequence_parallel)
        with jmesh:
            jnew, jloss = step(jparams, jtokens)
        jgrads = grad(jparams, jtokens, jconfig)
        params = _as_np(jparams)
        cases[n_ranks].append((kwargs, params, np.asarray(jtokens), sequence_parallel))
        want[name] = dict(loss=float(jloss), new=_as_np(jnew), grads=_as_np(jgrads), params=params,
                          tokens=np.asarray(jtokens), config=demo.DemoConfig(**kwargs))
    runs = {n: ranks.run_ranks(n, torch_ranks.sharded, (cases[n],), "cpu", RANKS_TIMEOUT) for n in cases}
    got = {}
    for n, outs in runs.items():
        names = [name for name, case in CASES.items() if case[3] == n]
        for i, name in enumerate(names):
            got[name] = [out["steps"][i] for out in outs]
    alone = ranks.run_ranks(1, torch_ranks.sharded, (cases[8][:1],), "cpu", RANKS_TIMEOUT)
    return dict(want=want, got=got, mesh=[out["mesh"] for out in runs[8]],
                megatron=[out["megatron"] for out in runs[8]], alone=alone[0])


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_jax(n):
    assert demo.mesh_shape(n) == jdemo.make_mesh(n).devices.shape


def test_make_mesh_8(sharded_run):
    for rank, mesh in enumerate(sharded_run["mesh"]):
        assert mesh == ((4, 2), ("data", "model"), (rank // 2, rank % 2))


def test_param_specs_match_jax():
    config = jdemo.DemoConfig(**TEST_CONFIG)
    want = jax.tree_util.tree_map(tuple, jdemo.param_specs(config),
                                  is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert demo.param_specs(demo.DemoConfig(**TEST_CONFIG)) == want


def test_megatron_functions_on_2_ranks(sharded_run):
    """Rank r of the model group feeds x_r = (r + 1) [1, 2, 3] and takes
    the loss sum(y (r + 1)); for the gather, sum(y * arange(6))."""
    base = np.array([1.0, 2.0, 3.0], np.float32)
    for r in range(2):
        out = sharded_run["megatron"][r]
        y, grad = out["copy"]   # f: identity; gradient summed: 1 + 2
        assert np.array_equal(y, (r + 1) * base) and np.array_equal(grad, [3, 3, 3])
        y, grad = out["reduce"]  # g: sum forward; gradient passed through
        assert np.array_equal(y, 3 * base) and np.array_equal(grad, [r + 1] * 3)
        y, grad = out["gather"]  # columns gathered; own slice of gradient
        assert np.array_equal(y, np.concatenate([base, 2 * base]))
        assert np.array_equal(grad, np.arange(6.0)[3 * r:3 * r + 3])
        # the hazard "g" avoids: the library's all_reduce sums the
        # gradient too, so each rank gets 1 + 2 instead of its own r + 1
        y, grad = out["library_all_reduce"]
        assert np.array_equal(y, 3 * base) and np.array_equal(grad, [3, 3, 3])


def test_rmsnorm_to_bf16_on_2_ranks_gives_the_chains_bits(sharded_run):
    """On each rank of the model group, ``rmsnorm_to_bf16`` with the group
    gives the bits of RMSNorm, ``CopyToModel`` and the cast, gradients
    included: its backward widens the bf16 gradient and all-reduces it in
    f32, as the chain does.  Without the group the gradient differs (each
    rank feeds another output gradient), so the all-reduce ran."""
    for r in range(2):
        out = sharded_run["megatron"][r]["rmsnorm_to_bf16"]
        assert all(np.array_equal(a, b) for a, b in zip(out["fused"], out["chain"]))
        assert np.array_equal(out["fused"][0], out["alone"][0])
        assert not np.array_equal(out["fused"][1], out["alone"][1])


def test_wqkv_permutation_round_trips():
    config = demo.DemoConfig(**TEST_CONFIG)
    params = demo.init_params(config, torch.Generator().manual_seed(0), "cpu")
    for model in (1, 2):
        blocks = demo._split_model(params, config, model)
        joined = demo._join_model(blocks, config)
        for a, b in zip(demo.tree_leaves(joined), demo.tree_leaves(params)):
            assert torch.equal(a, b)
        d, width = config.d_model, config.d_model // model
        wqkv = params["layers"][0]["wqkv"]
        for r, block in enumerate(blocks):
            # rank r holds its own heads: [q_r | k_r | v_r]
            want = torch.cat([wqkv[:, part * d + r * width:part * d + (r + 1) * width] for part in range(3)], 1)
            assert torch.equal(block["layers"][0]["wqkv"], want)
            assert block["layers"][0]["wo"].shape == (width, d)
            assert block["unembed"].shape == (d, config.vocab // model)


@pytest.mark.parametrize("kwargs", [dict(vocab=255), dict(d_ff=127)], ids=["vocab", "d_ff"])
def test_shards_must_split_evenly(kwargs):
    """A vocabulary or an MLP width that does not split over 2 model ranks
    raises, in the port as in the reference (whose shardings refuse it);
    heads that do not split are taken (``test_sharded_step_*`` cases
    ``uneven_heads``, ``uneven_heads_66``, ``uneven_heads_sp`` and
    ``one_head``)."""
    config = demo.DemoConfig(**kwargs)
    params = demo.init_params(config, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="split evenly over 2 model ranks"):
        demo._split_model(params, config, 2)
    jconfig = jdemo.DemoConfig(**kwargs)
    jmesh = jdemo.make_mesh(2)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (jconfig.batch, jconfig.seq_len + 1), 0, jconfig.vocab)
    with pytest.raises(ValueError), jmesh:
        jdemo.sharded_train_step(jmesh, jconfig)(jdemo.init_params(jconfig, jax.random.PRNGKey(0)), tokens)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_loss_matches_jax(sharded_run, case):
    losses = [loss for loss, _ in sharded_run["got"][case]]
    assert len(set(losses)) == 1  # every rank holds the same global mean
    assert abs(losses[0] - sharded_run["want"][case]["loss"]) <= 5e-5


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_parameters_match_jax(sharded_run, case):
    want = sharded_run["want"][case]
    got = sharded_run["got"][case][0][1]
    lr = want["config"].learning_rate
    leaves = zip(*map(demo.tree_leaves, (got, want["new"], want["params"], want["grads"])))
    for j, (n, w, p, g) in enumerate(leaves):
        assert n.shape == w.shape
        err = torch.tensor(np.abs(n - w))
        tol = step_tolerance(torch.tensor(p), torch.tensor(g), lr)
        assert bool((err <= tol).all()), f"leaf {j}: max |err| {float(err.max()):.3e}"


def test_one_rank_mesh_is_the_single_device_step(sharded_run):
    """On a (1, 1) mesh the collectives are identities: the step gives the
    bits of ``train_step``."""
    want = sharded_run["want"]["test"]
    new, loss = demo.train_step(demo.params_from_jax(want["params"], "cpu"),
                                torch.from_numpy(want["tokens"]).long(), want["config"])
    got_loss, got = sharded_run["alone"]["steps"][0]
    assert got_loss == float(loss)
    for a, b in zip(demo.tree_leaves(got), demo.tree_leaves(new)):
        assert np.array_equal(a, b.numpy())
