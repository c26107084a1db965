"""The port's ring attention (``operator_forge_torch.demo.ring_attention``,
its block step ``kernels/ring_attention.py``), ``dense_causal_attention``
and the multi-rank dryrun against the JAX reference
(``operator_forge/tpu/demo.py:189-343``), on the CPU.

Multi-rank runs are gloo process groups of spawned ranks
(``operator_forge_torch.ranks.run_ranks``); the ranks run
``tests/torch_ranks.py``, which imports no JAX.  Tolerances: the ring
against JAX's ring within rtol and atol 2e-5, the reference's own bar
(``test_tpu_demo.py:138-181``; measured 4.8e-7), and so is its gradient
against ``jax.vjp`` of the reference's ring in f32; in bf16 each gradient
within 2 bf16 ulps of its max |g|.  One block step of the plain version
against the reference's arithmetic within rtol 1e-5 and atol 1e-6 at heads
of 16 (the atol growing as the square root of the head's width past it,
as the rounding of a sum over the head does), and the backward step
against ``jax.vjp`` of it within rtol 1e-5 and atol 2e-6, f32 sums taken in
another order.
"""

import math
import operator
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_ranks
from operator_forge.tpu import demo as jdemo
from operator_forge_torch import demo, ranks, telemetry
from operator_forge_torch.entry import dryrun_multichip
from operator_forge_torch.kernels import bf16_ulp
from operator_forge_torch.kernels import ring_attention as ra

RANKS_TIMEOUT = 240


def _jax_step(q, k_blk, v_blk, m, num, den, my, origin):
    """One step of ``demo.py:279-295`` in JAX, transcribed."""
    s, d = q.shape[-2:]
    scale = 1.0 / jnp.sqrt(jnp.float32(d))
    scores = jnp.einsum(
        "bhqd,bhkd->bhqk", q.astype(jnp.float32), k_blk.astype(jnp.float32)
    ) * scale
    q_pos = my * s + jnp.arange(s)[:, None]
    k_pos = origin * s + jnp.arange(s)[None, :]
    scores = jnp.where(k_pos <= q_pos, scores, -jnp.inf)
    block_max = jnp.max(scores, axis=-1, keepdims=True)
    new_m = jnp.maximum(m, block_max)
    shift = jnp.where(jnp.isinf(new_m), 0.0, new_m)
    correction = jnp.exp(m - shift)
    probs = jnp.exp(scores - shift)
    num = num * correction + jnp.einsum(
        "bhqk,bhkd->bhqd", probs, v_blk.astype(jnp.float32)
    )
    den = den * correction + jnp.sum(probs, axis=-1, keepdims=True)
    return new_m, num, den


# (query block, visiting block, carry): the mask cases of one step on rank
# 2 of a 4-rank ring
CASES = {
    "diagonal": (2, 2, "seen"),
    "earlier": (2, 1, "seen"),
    "later": (2, 3, "seen"),
    "first": (2, 2, "fresh"),
}


def _step_inputs(case, shape=(2, 3, 17, 16), seed=0):
    """q, k, v of the step and a carry: fresh (``m = -inf``, zeros) or one
    that has seen the diagonal block of other keys."""
    rng = np.random.default_rng(seed)
    q, k, v, k0, v0 = (rng.standard_normal(shape, dtype=np.float32) for _ in range(5))
    my, origin, carry = CASES[case]
    b, h, s, d = shape
    fresh = (np.full((b, h, s, 1), -np.inf, np.float32), np.zeros(shape, np.float32),
             np.zeros((b, h, s, 1), np.float32))
    if carry == "fresh":
        return (q, k, v, *fresh), my, origin
    seen = tuple(np.asarray(t) for t in _jax_step(q, k0, v0, *fresh, my, my))
    return (q, k, v, *seen), my, origin


# the step's shapes: a ragged block, and heads the card's kernels take in
# column chunks: Gemma 7B's 256, and 3073 and 4096, past the former cap
STEP_SHAPES = [(2, 3, 17, 16), (1, 1, 33, 256), (1, 1, 9, 3073), (1, 1, 9, 4096)]


@pytest.mark.parametrize(
    "case, shape",
    [pytest.param(case, shape, id=case if shape == STEP_SHAPES[0] else f"{case}-{'x'.join(map(str, shape))}")
     for shape in STEP_SHAPES for case in sorted(CASES)],
)
def test_ring_step_ref_matches_jax(case, shape):
    """Within rtol 1e-5 and atol 1e-6 at heads of 16, the atol times the
    square root of the head's width over 16 past it: each score is an f32
    sum over the head, taken in another order, whose rounding grows as the
    square root of its terms' count (at 256, 3073 and 4096 some 2.6e-6,
    4.0e-6 and 3.4e-6 past the rtol, in num where it cancels)."""
    arrays, my, origin = _step_inputs(case, shape)
    want = [np.asarray(t) for t in _jax_step(*arrays, my, origin)]
    got = ra.ring_step_ref(*(torch.tensor(a) for a in arrays), my, origin)
    atol = 1e-6 * math.sqrt(max(1.0, shape[-1] / 16))
    for name, g, w in zip(("m", "num", "den"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=atol, err_msg=name)
    if case == "later":
        # every key masked: the carry comes back as it went in
        for g, before in zip(got, arrays[3:]):
            assert np.array_equal(g.numpy(), before)


@pytest.mark.parametrize("case", ["diagonal", "earlier", "first"])
def test_ring_step_ref_matches_jax_past_1024_keys(case):
    """The plain version, the card's yardstick for the tiled kernel, at a
    block of 2048 keys: within rtol 1e-5 and atol 2e-5 of each part's max
    (``carry_close(scaled=True)``'s rule), f32 sums over thousands of keys
    taken in another order."""
    arrays, my, origin = _step_inputs(case, shape=(1, 2, 2048, 32), seed=1)
    want = [np.asarray(t) for t in _jax_step(*arrays, my, origin)]
    got = ra.ring_step_ref(*(torch.tensor(a) for a in arrays), my, origin)
    for name, g, w in zip(("m", "num", "den"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        atol = 2e-5 * float(np.abs(w[np.isfinite(w)]).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=atol, err_msg=name)


def test_ring_step_on_cpu_updates_the_carry_in_place():
    arrays, my, origin = _step_inputs("earlier")
    q, k, v, m, num, den = (torch.from_numpy(a.copy()) for a in arrays)
    want = ra.ring_step_ref(q, k, v, m, num, den, my, origin)
    before = telemetry.value("kernels.ring_attention_step")
    out = ra.ring_step(q, k, v, m, num, den, my, origin)
    assert telemetry.value("kernels.ring_attention_step") == before  # the plain version is no launch
    assert all(o is t for o, t in zip(out, (m, num, den)))
    assert all(torch.equal(t, w) for t, w in zip((m, num, den), want))


def _block_grads(case, shape=(2, 3, 17, 16), seed=0):
    """The gradient of ``out = num / den`` after the step of ``case`` (and,
    for a carry that has seen it, the diagonal block of other keys before
    it) for a cotangent ``dout``: JAX's, by ``jax.vjp`` of ``_jax_step``,
    and the port's, one ``ring_step_bwd_ref`` a block from zero
    accumulators.  Returns ``(got, want)``, each ``(dq, dk, dv)``."""
    rng = np.random.default_rng(seed)
    q, k, v, k0, v0, dout = (rng.standard_normal(shape, dtype=np.float32) for _ in range(6))
    my, origin, carry = CASES[case]
    b, h, s, d = shape
    fresh = (np.full((b, h, s, 1), -np.inf, np.float32), np.zeros(shape, np.float32),
             np.zeros((b, h, s, 1), np.float32))

    def out_of(q, k, v):
        start = _jax_step(q, k0, v0, *fresh, my, my) if carry == "seen" else fresh
        _, num, den = _jax_step(q, k, v, *start, my, origin)
        return num / den

    _, vjp = jax.vjp(out_of, q, k, v)
    want = [np.asarray(t) for t in vjp(dout)]

    tq, tk, tv, tk0, tv0, tdo = (torch.from_numpy(a) for a in (q, k, v, k0, v0, dout))
    state = tuple(torch.from_numpy(a) for a in fresh)
    blocks = ([(tk0, tv0, my)] if carry == "seen" else []) + [(tk, tv, origin)]
    for kb, vb, at in blocks:
        state = ra.ring_step_ref(tq, kb, vb, *state, my, at)
    m, num, den = state
    big_d = (tdo * (num / den)).sum(dim=-1, keepdim=True)
    dq = torch.zeros(shape)
    for kb, vb, at in blocks:
        dq, dk, dv = ra.ring_step_bwd_ref(tq, kb, vb, tdo, m, den, big_d, my, at,
                                          dq, torch.zeros(shape), torch.zeros(shape))
    return (dq, dk, dv), want


# the backward step's shapes: a ragged block, and blocks at and past the
# card kernel's edges (its first tiled block, and a 64-row chunk, of 64
# rows; two chunks and two rows past them; a tile whose 5 chunks two blocks
# share), a head on its row kernel (wider than the tiled kernel's 128), and
# heads its wide kernel takes in column chunks (256, and 3073 and 4096,
# past the former cap)
BWD_SHAPES = [(2, 3, 17, 16), (1, 2, 64, 32), (1, 2, 65, 32), (1, 1, 130, 32), (1, 1, 257, 32),
              (1, 1, 33, 160), (1, 1, 33, 256), (1, 1, 9, 3073), (1, 1, 9, 4096)]


@pytest.mark.parametrize(
    "case, shape",
    [pytest.param(case, shape, id=case if shape == BWD_SHAPES[0] else f"{case}-{'x'.join(map(str, shape))}")
     for shape in BWD_SHAPES for case in sorted(CASES)],
)
def test_ring_step_bwd_ref_matches_jax(case, shape):
    """Within rtol 1e-5 and atol 2e-6 of ``jax.vjp`` of the reference's
    step arithmetic (measured 6.0e-7 against gradients up to 3.5): f32,
    sums in another order, and JAX's gradient also passes through the
    block max and the shift, which cancel exactly only without rounding.
    A later block adds nothing."""
    got, want = _block_grads(case, shape)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=2e-6, err_msg=name)
    if case == "later":
        assert not got[1].any() and not got[2].any()


def test_ring_step_bwd_on_cpu_updates_the_accumulators_in_place():
    """The wrapper on CPU tensors: the plain version's values, written into
    the accumulators it was given, and no launch; a later block leaves
    their bits as they were."""
    rng = np.random.default_rng(4)
    shape = (2, 3, 17, 16)
    q, k, v, dout, dq, dk, dv = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                                 for _ in range(7))
    m, den, big_d = (torch.from_numpy(rng.random((2, 3, 17, 1), dtype=np.float32)) + 1 for _ in range(3))
    for my, origin in ((2, 1), (2, 3)):
        accumulators = [t.clone() for t in (dq, dk, dv)]
        want = ra.ring_step_bwd_ref(q, k, v, dout, m, den, big_d, my, origin, *accumulators)
        before = telemetry.value("kernels.ring_attention_step_bwd")
        out = ra.ring_step_bwd(q, k, v, dout, m, den, big_d, my, origin, *accumulators)
        assert telemetry.value("kernels.ring_attention_step_bwd") == before
        assert all(o is t for o, t in zip(out, accumulators))
        assert all(torch.equal(t, w) for t, w in zip(accumulators, want))
        if origin > my:
            assert all(torch.equal(t, w) for t, w in zip(accumulators, (dq, dk, dv)))


@pytest.mark.parametrize("name", ["dtype", "dout", "stats", "accumulator", "position", "device"])
def test_ring_step_bwd_rejects_what_the_kernel_does_not_take(name):
    q = torch.zeros(1, 2, 8, 4)
    row = torch.ones(1, 2, 8, 1)
    args = [q, q, q, q, row, row, row, 0, 0, q.clone(), q.clone(), q.clone()]
    if name == "dtype":
        args[1] = q.bfloat16()
    elif name == "dout":
        args[3] = q.bfloat16()
    elif name == "stats":
        args[6] = torch.ones(1, 2, 8, 4)
    elif name == "accumulator":
        args[10] = q.bfloat16()
    elif name == "position":
        args[8] = -1
    elif name == "device":
        args[9] = args[9].to("meta")
    before = telemetry.value("kernels.ring_attention_step_bwd")
    with pytest.raises(ValueError):
        ra.ring_step_bwd(*args)
    assert telemetry.value("kernels.ring_attention_step_bwd") == before


def _bad(name):
    q = torch.zeros(1, 2, 8, 4)
    carry = [torch.zeros(1, 2, 8, 1), torch.zeros(1, 2, 8, 4), torch.zeros(1, 2, 8, 1)]
    args = [q, q, q, *carry, 0, 0]
    if name == "seq":  # an empty block: every length from 1 up is taken
        empty = torch.zeros(1, 1, 0, 4)
        args = [empty, empty, empty, torch.zeros(1, 1, 0, 1), empty, torch.zeros(1, 1, 0, 1), 0, 0]
    elif name == "head_dim":  # heads of no width: every width from 1 up is taken on the CPU
        empty = torch.zeros(1, 1, 8, 0)
        args = [empty, empty, empty, torch.zeros(1, 1, 8, 1), empty, torch.zeros(1, 1, 8, 1), 0, 0]
    elif name == "dtype":
        args[1] = q.bfloat16()
    elif name == "carry":
        args[5] = torch.zeros(1, 2, 8, 4)
    elif name == "carry_dtype":
        args[3] = carry[0].double()
    elif name == "position":
        args[7] = -1
    return args


@pytest.mark.parametrize("name", ["seq", "head_dim", "dtype", "carry", "carry_dtype", "position"])
def test_ring_step_rejects_what_the_kernel_does_not_take(name):
    with pytest.raises(ValueError):
        ra.ring_step(*_bad(name))


@pytest.mark.parametrize("on_meta", ["q", "v_blk", "m", "num", "all"])
def test_ring_step_rejects_a_device_neither_cpu_nor_cuda(on_meta):
    """A tensor on ``meta`` raises: the plain version serves CPU tensors
    only and is never a fallback for another device."""
    names = ("q", "k_blk", "v_blk", "m", "num", "den")
    args = _bad("none")[:6]
    args = [t.to("meta") if on_meta in (n, "all") else t for n, t in zip(names, args)]
    before = telemetry.value("kernels.ring_attention_step")
    with pytest.raises(ValueError):
        ra.ring_step(*args, 0, 0)
    assert telemetry.value("kernels.ring_attention_step") == before


def test_replayed_ring_schedule_matches_dense():
    """The 4-rank ring's schedule in one process: at step j rank r holds
    block (r - j) % 4; each block step through ``ring_step``, then num /
    den, against ``dense_causal_attention`` at rtol and atol 2e-5."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2, 32, 16), dtype=np.float32)) for _ in range(3))
    n = 4
    qs, ks, vs = (t.chunk(n, dim=2) for t in (q, k, v))
    out = []
    for r in range(n):
        m = torch.full((2, 2, 8, 1), -math.inf)
        num, den = torch.zeros(2, 2, 8, 16), torch.zeros(2, 2, 8, 1)
        for j in range(n):
            origin = (r - j) % n
            ra.ring_step(qs[r].contiguous(), ks[origin].contiguous(), vs[origin].contiguous(),
                         m, num, den, r, origin)
        out.append(num / den)
    torch.testing.assert_close(torch.cat(out, dim=2), demo.dense_causal_attention(q, k, v),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_dense_causal_attention_matches_jax(dtype):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 2, 32, 16), dtype=np.float32) for _ in range(3))
    want = jdemo.dense_causal_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)))
    tq, tk, tv = (torch.tensor(np.asarray(jnp.asarray(a, dtype), np.float32)) for a in (q, k, v))
    if dtype is jnp.bfloat16:
        tq, tk, tv = tq.bfloat16(), tk.bfloat16(), tv.bfloat16()
    got = demo.dense_causal_attention(tq, tk, tv)
    assert got.dtype == tq.dtype
    # f32: sums in another order; bf16: one rounding of such a value
    tol = 2e-6 if dtype is np.float32 else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


def _types(dtype) -> tuple:
    """The types of q, k and v: one name for all three, or one each."""
    return (dtype,) * 3 if isinstance(dtype, str) else tuple(dtype)


def _jax_ring(q, k, v, dout, dtype, n: int) -> tuple:
    """``jdemo.ring_attention`` on ``n`` CPU devices and its gradient by
    ``jax.vjp``, q, k and v cast to ``dtype`` (see ``_types``) and dout to
    q's: ``(out, dq, dk, dv)`` as f32 numpy, then their types' names."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
    q_t, k_t, v_t = _types(dtype)
    q, k, v, dout = (jnp.asarray(a, getattr(jnp, t)) for a, t in zip((q, k, v, dout), (q_t, k_t, v_t, q_t)))
    out, vjp = jax.vjp(lambda *qkv: jdemo.ring_attention(*qkv, mesh, axis="seq"), q, k, v)
    tensors = (out, *vjp(dout))
    return (*(np.asarray(t, np.float32) for t in tensors), tuple(str(t.dtype) for t in tensors))


def _f16_ulp(x: float) -> float:
    """The spacing of float16 values at ``x`` (normal range)."""
    return 2.0 ** (math.floor(math.log2(x)) - 10)


def _close(got, want, dtype) -> None:
    """Each of out, dq, dk and dv by its own type (out and dq q's, dk k's,
    dv v's), which both sides must agree on: f32 within rtol and atol 2e-5,
    the forward's bar; bf16 within 2 bf16 ulps of the array's max |value|
    and float16 within 2 float16 ulps of it (both round an f32 result once,
    which may differ in its last bits)."""
    assert got[4] == want[4], (got[4], want[4])
    for name, g, w, t in zip(("out", "dq", "dk", "dv"), got, want, want[4]):
        if t == "float32":
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5, err_msg=name)
        else:
            top = float(np.abs(w).max())
            tol = 2 * (float(bf16_ulp(torch.tensor(top))) if t == "bfloat16" else _f16_ulp(top))
            assert float(np.abs(g - w).max()) <= tol, (name, float(np.abs(g - w).max()), tol)


RING_SHAPE = (2, 2, 32, 16)   # the 4-rank ring: blocks of 8
ALONE_SHAPE = (1, 2, 8, 8)    # a ring of one rank
LONG_SHAPE = (1, 2, 1100, 8)  # a ring of one rank past 1024 keys
WIDE_SHAPE = (1, 2, 16, 3073)  # a ring of one rank past the card's former cap on heads


# the types the rings run in: f32 and bf16, which the kernels take, and
# float16 and f32 q with bf16 k and v, which the ring widens to f32 first
RING_TYPES = {"float32": "float32", "bfloat16": "bfloat16", "float16": "float16",
              "mixed": ("float32", "bfloat16", "bfloat16")}


@pytest.fixture(scope="module")
def ring_run():
    """Ring attention and its gradient in 4 gloo ranks, spawned once: the
    4-rank ring at ``RING_SHAPE`` in each of ``RING_TYPES`` and, on each
    rank, a 1-rank ring at ``ALONE_SHAPE`` (q = k = v) in each of them and
    at ``LONG_SHAPE`` and ``WIDE_SHAPE`` (f32)."""
    rng = np.random.default_rng(7)
    q, k, v, dout = (rng.standard_normal(RING_SHAPE, dtype=np.float32) for _ in range(4))
    small, d_small = (rng.standard_normal(ALONE_SHAPE, dtype=np.float32) for _ in range(2))
    long = [rng.standard_normal(LONG_SHAPE, dtype=np.float32) for _ in range(4)]
    rings = {name: (q, k, v, dout, dtype) for name, dtype in RING_TYPES.items()}
    alone = {name: (small, small, small, d_small, dtype) for name, dtype in RING_TYPES.items()}
    alone["long"] = (*long, "float32")
    alone["wide"] = (*(rng.standard_normal(WIDE_SHAPE, dtype=np.float32) for _ in range(4)), "float32")
    out = ranks.run_ranks(4, torch_ranks.ring, (list(rings.values()), list(alone.values())), "cpu",
                          RANKS_TIMEOUT)
    joined = {name: (*(np.concatenate([o["rings"][i][t] for o in out], axis=2) for t in range(4)),
                     out[0]["rings"][i][4])
              for i, name in enumerate(rings)}
    by_rank = [dict(zip(alone, o["alone"])) for o in out]
    return dict(rings=rings, alone=alone, joined=joined, by_rank=by_rank)


def test_ring_attention_matches_jax_on_4_ranks(ring_run):
    q, k, v, _, _ = ring_run["rings"]["float32"]
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("seq",))
    want = jdemo.ring_attention(q, k, v, mesh, axis="seq")
    np.testing.assert_allclose(ring_run["joined"]["float32"][0], np.asarray(want), rtol=2e-5, atol=2e-5)


def test_single_rank_ring_matches_jax(ring_run):
    small = ring_run["alone"]["float32"][0]
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("seq",))
    want = np.asarray(jdemo.ring_attention(small, small, small, mesh, axis="seq"))
    for alone in ring_run["by_rank"]:
        np.testing.assert_allclose(alone["float32"][0], want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", list(RING_TYPES))
def test_ring_attention_gradient_matches_jax_on_4_ranks(ring_run, dtype):
    """``backward()`` through the 4-rank ring against ``jax.vjp`` of the
    reference's ring on 4 devices (see ``_close``), also for float16 and
    for f32 q with bf16 k and v, which the reference takes: the output in
    q's type, each gradient in its own input's."""
    q, k, v, dout, types = ring_run["rings"][dtype]
    _close(ring_run["joined"][dtype], _jax_ring(q, k, v, dout, types, 4), types)


@pytest.mark.parametrize("case", [*RING_TYPES, "long", "wide"])
def test_single_rank_ring_gradient_matches_jax(ring_run, case):
    """The ring of one rank, at ``ALONE_SHAPE`` in each of ``RING_TYPES``,
    at a block of 1100 keys and at heads of 3073, and its gradient, against
    the reference on one device, on every rank."""
    *arrays, dtype = ring_run["alone"][case]
    want = _jax_ring(*arrays, dtype, 1)
    for alone in ring_run["by_rank"]:
        _close(alone[case], want, dtype)


def test_dryrun_multichip_on_cpu_is_finite():
    """8 gloo ranks: the (4, 2) mesh's sharded SP step and the 8-rank ring
    against dense (which raises if it disagrees at 3e-5)."""
    loss = dryrun_multichip(8, device="cpu")
    assert math.isfinite(loss)
    # near-uniform logits at init: loss ~= log(vocab)
    assert abs(loss - math.log(256)) < 0.5


def test_dryrun_multichip_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(1)


def test_run_ranks_needs_a_card_a_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA devices"):
        ranks.run_ranks(2, operator.add, (1, 2), "cuda")


def test_run_ranks_returns_values_and_raises_on_a_failed_rank():
    assert ranks.run_ranks(2, operator.add, (1, 2), "cpu", RANKS_TIMEOUT) == [3, 3]
    with pytest.raises(RuntimeError, match="exited with errors"):
        ranks.run_ranks(2, operator.truediv, (1, 0), "cpu", RANKS_TIMEOUT)


def test_run_ranks_ends_a_hung_rank_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        ranks.run_ranks(2, time.sleep, (600,), "cpu", timeout=5)
    assert time.monotonic() - t0 < 60
