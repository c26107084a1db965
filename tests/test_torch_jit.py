"""The port's counterpart of ``jax.jit`` (``operator_forge_torch.jit``) on
the CPU, where a jitted function runs as it is: the forward, the SGD step
chained over 3 steps and the sharded step on a gloo group of one rank each
give the eager call's bits, the jitted forward agrees with
``jax.jit(demo.forward)`` of the reference, and the checks on the
arguments hold.  The captured paths run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance against JAX: the logits within 2e-3, 4 bf16 ulps at |logit| <
0.125, as ``tests/test_torch_demo.py`` holds the eager forward.  The bit
checks run on one CPU thread (``one_thread``): with several, the CPU's
``index_put_`` accumulates the embedding's gradient in no fixed order, so
two eager steps differ in its last bits.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from operator_forge.tpu import demo as jdemo
from operator_forge_torch import demo
from operator_forge_torch.entry import entry, train_entry
from operator_forge_torch.jit import Jitted, _copy, _flatten, _unflatten, jit
from operator_forge_torch.kernels import wrapper_call

TEST_CONFIG = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, seq_len=16, batch=8)
CONFIGS = {"test": TEST_CONFIG, "default": {}}
STEPS = 3


def _inputs(kwargs: dict, tok_len_extra: int):
    config = demo.DemoConfig(**kwargs)
    params = demo.init_params(config, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, config.vocab, (config.batch, config.seq_len + tok_len_extra),
                           generator=torch.Generator().manual_seed(1))
    return config, params, tokens


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(demo.tree_leaves(a), demo.tree_leaves(b)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_jitted_forward_gives_the_eager_bits(name):
    config, params, tokens = _inputs(CONFIGS[name], 0)
    fn = partial(demo.forward, config=config)
    jitted = jit(fn)
    assert torch.equal(jitted(params, tokens), fn(params, tokens))
    assert jitted.captures == {}


def test_jitted_forward_matches_jax_jit():
    jconfig = jdemo.DemoConfig(**TEST_CONFIG)
    jparams = jdemo.init_params(jconfig, jax.random.PRNGKey(0))
    jtokens = jax.random.randint(jax.random.PRNGKey(1), (jconfig.batch, jconfig.seq_len), 0, jconfig.vocab)
    want = np.asarray(jax.jit(partial(jdemo.forward, config=jconfig))(jparams, jtokens))
    assert np.abs(want).max() < 0.125
    params = demo.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    got = jit(partial(demo.forward, config=demo.DemoConfig(**TEST_CONFIG)))(
        params, torch.from_numpy(np.array(jtokens)).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_jitted_train_step_chained_gives_the_eager_bits(one_thread, name):
    config, params, tokens = _inputs(CONFIGS[name], 1)
    fn = partial(demo.train_step, config=config)
    jitted = jit(fn)
    eager = got = params
    for _ in range(STEPS):
        eager, want_loss = fn(eager, tokens)
        got, loss = jitted(got, tokens)
        assert torch.equal(loss, want_loss) and _same(got, eager)


def test_entry_points_jit_on_the_cpu(one_thread):
    """``entry()`` and ``train_entry()`` return the eager function, which
    their callers jit."""
    for make in (entry, train_entry):
        fn, args = make(device="cpu")
        assert not isinstance(fn, Jitted)
        want = fn(*args)
        got = jit(fn)(*args)
        want, got = (t if isinstance(t, tuple) else (t,) for t in (want, got))
        for a, b in zip(got, want):
            assert _same(a, b) if isinstance(a, dict) else torch.equal(a, b)


@pytest.fixture(scope="module")
def gloo_one(tmp_path_factory):
    """A gloo process group of one rank in this process and its (1, 1)
    mesh."""
    path = tmp_path_factory.mktemp("gloo") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0, world_size=1)
    try:
        yield demo.make_mesh(1, "cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("sequence_parallel", [False, True], ids=["plain", "sp"])
def test_sharded_step_on_one_gloo_rank_gives_the_eager_bits(one_thread, gloo_one, sequence_parallel):
    """``sharded_train_step`` returns ``jit(step)``; on CPU tensors it gives
    the bits of its plain ``step`` and, on the (1, 1) mesh, of
    ``train_step``, over 3 chained steps."""
    config, params, tokens = _inputs(TEST_CONFIG, 1)
    step = demo.sharded_train_step(gloo_one, config, sequence_parallel)
    assert isinstance(step, Jitted)
    local = eager = demo.shard_params(params, config, gloo_one)
    single = params
    for _ in range(STEPS):
        local, loss = step(local, tokens)
        eager, eager_loss = step.fn(eager, tokens)
        single, single_loss = demo.train_step(single, tokens, config)
        assert torch.equal(loss, eager_loss) and torch.equal(loss, single_loss)
        assert _same(local, eager)
        assert _same(demo.gather_params(local, config, gloo_one), single)
    assert step.captures == {}


def test_gather_heads_makes_its_order_once(gloo_one, monkeypatch):
    """``GatherHeads`` builds the QKV column order from host data at its
    first call only: later calls, forward and backward, reuse one tensor,
    so a captured step makes no host-to-device copy for it."""
    demo._qkv_order.cache_clear()
    made = []
    host_tensor = torch.tensor
    monkeypatch.setattr(torch, "tensor", lambda *a, **k: made.append(a) or host_tensor(*a, **k))
    group = gloo_one.get_group("model")
    x = torch.randn(2, 4, 3 * 8, generator=torch.Generator().manual_seed(2))
    outs = []
    for _ in range(2):
        live = x.clone().requires_grad_()
        out = demo.GatherHeads.apply(live, group, 8)
        out.backward(torch.ones_like(out))
        outs.append((out, live.grad))
    assert len(made) == 1
    assert demo._qkv_order(8, 1, x.device) is demo._qkv_order(8, 1, x.device)
    # one rank holds every column in the reference's order
    assert torch.equal(outs[0][0], x) and torch.equal(outs[1][0], x)
    assert torch.equal(outs[0][1], outs[1][1])


def test_jit_is_its_function():
    fn = partial(demo.forward, config=demo.DemoConfig())
    assert jit(fn).fn is fn


@pytest.mark.parametrize("bad", [3, 0.5, None, "tokens", np.zeros(2)], ids=["int", "float", "none", "str", "numpy"])
def test_jit_refuses_a_leaf_that_is_not_a_tensor(bad):
    jitted = jit(lambda tree: tree["a"])
    with pytest.raises(TypeError, match="must be a tensor"):
        jitted({"a": torch.zeros(2), "b": [torch.ones(1), bad]})


def test_jit_refuses_leaves_on_two_devices():
    jitted = jit(lambda a, b: a)
    with pytest.raises(ValueError, match="more than one device"):
        jitted(torch.zeros(2), torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="more than one device"):
        jitted(torch.zeros(2), b={"x": [torch.zeros(2, device="meta")]})


def test_tree_structure_round_trips():
    """``_flatten`` takes dicts, lists and tuples in order and gives a
    hashable structure; ``_unflatten`` rebuilds the same tree."""
    t = [torch.full((1,), float(i)) for i in range(5)]
    tree = ({"b": t[0], "a": [t[1], (t[2], t[3])]}, [t[4]], {})
    leaves: list = []
    structure = _flatten(tree, leaves)
    assert [id(x) for x in leaves] == [id(x) for x in t]
    hash(structure)
    rebuilt = _unflatten(structure, iter(leaves))
    again: list = []
    assert _flatten(rebuilt, again) == structure and all(a is b for a, b in zip(again, leaves))
    assert list(rebuilt[0]) == ["b", "a"] and isinstance(rebuilt[0]["a"][1], tuple)
    assert isinstance(rebuilt[1], list) and rebuilt[2] == {}
    other: list = []
    assert _flatten(({"a": t[1], "b": t[0]}, [t[4]], {}), other) != structure


def test_copy_takes_leaves_of_every_dtype():
    """``_copy``, the copies in and out of a capture, groups the leaves by
    dtype for ``_foreach_copy_``, keeping each pair in place."""
    src = [torch.arange(3.0), torch.arange(4), torch.ones(2, 2), torch.arange(5, dtype=torch.int32),
           torch.full((), 7.0)]
    dst = [torch.empty_like(t) for t in src]
    _copy(dst, src)
    assert all(torch.equal(d, t) for d, t in zip(dst, src))


# names as the profiler gives them (demangled, cut here), with the
# wrapper whose call each marks
KERNEL_NAMES = {
    "void (anonymous namespace)::causal_attention_kernel<32, true>(__nv_bfloat16 const*": "causal_attention",
    "void (anonymous namespace)::causal_attention_bwd_dq_kernel<32, true>(__nv_": "causal_attention_bwd",
    "void (anonymous namespace)::causal_attention_bwd_dkv_kernel<32>(__nv_bfloat16": None,
    "void (anonymous namespace)::attention_stream_dkv_kernel<64, 128, 1>(__nv_bf": None,
    "void (anonymous namespace)::rmsnorm_warp<__nv_bfloat16, 1>(float const*": "rmsnorm",
    "void (anonymous namespace)::rmsnorm_bwd_kernel<true>(float const*, float const*": "rmsnorm_bwd",
    "void (anonymous namespace)::mlp_kernel<(anonymous namespace)::Tile<64, 32, 4, 2>, false>(__nv_bf":
        "matmul_gelu",
    "void (anonymous namespace)::mlp_kernel<(anonymous namespace)::Tile<64, 32, 4, 2>, true>(__nv_bfl":
        "matmul_gelu_bwd",
    "void (anonymous namespace)::ce_fwd_warp<__nv_bfloat16, 1>(__nv_bfloat16 const*": "cross_entropy",
    "void (anonymous namespace)::ce_bwd<__nv_bfloat16, true>(__nv_bfloat16 const*": "cross_entropy_bwd",
    "void (anonymous namespace)::ring_step_tiled_kernel<float, 8, 2>(float const*": "ring_attention_step",
    "void (anonymous namespace)::ring_step_bwd_wide_kernel<float>(float const*": "ring_attention_step_bwd",
    "nvjet_tst_64x32_64x16_2x4_h_bz_NTT": None,
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>": None,
    "Memcpy DtoD (Device -> Device)": None,
}


@pytest.mark.parametrize("kernel", sorted(KERNEL_NAMES))
def test_wrapper_call_names_the_wrapper_a_kernel_marks(kernel):
    assert wrapper_call(kernel) == KERNEL_NAMES[kernel]
