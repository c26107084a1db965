"""The port's backward kernels and cross entropy, on the CPU.

Each backward's plain version (what a wrapper runs for CPU tensors) is held
against the JAX reference on the same inputs, made with numpy, and against
torch autograd of the plain forward; each module of the model is held to
``jax.vjp`` of the function of ``operator_forge/tpu/demo.py`` it replaces.
The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from operator_forge.tpu import demo as jdemo
from operator_forge_torch import demo, telemetry
from operator_forge_torch.kernels import attention, bf16_ulp, gelu, rmsnorm, rows_close
from operator_forge_torch.kernels import cross_entropy as ce

CONFIGS = {
    "test": dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, seq_len=16, batch=8),
    "default": {},
}


def _launches(wrapper: str) -> tuple:
    """The launch counters of ``wrapper`` and of its backward."""
    return telemetry.value(f"kernels.{wrapper}"), telemetry.value(f"kernels.{wrapper}_bwd")


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def configs_and_params(request):
    sizes = CONFIGS[request.param]
    jconfig = jdemo.DemoConfig(**sizes)
    jparams = jdemo.init_params(jconfig, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jconfig, jparams, demo.DemoConfig(**sizes), demo.params_from_jax(tree, "cpu")


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _assert_within_ulps(got, want, n):
    """|got - want| within ``n`` bf16 ulps of max |want|, in f32."""
    got = torch.as_tensor(np.asarray(got, dtype=np.float32))
    want = torch.as_tensor(np.array(want, dtype=np.float32))
    tol = n * float(bf16_ulp(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= tol, f"max |err| {err:.3e} > {n} bf16 ulps of max |want| ({tol:.3e})"


def _module_vjp(jfn, fn, jlayer, layer, x, dy, names):
    """Gradients of x and of ``layer[names]`` by ``jax.vjp`` of ``jfn`` and
    by autograd of ``fn`` on the same x, layer and output gradient."""
    _, vjp = jax.vjp(jfn, jnp.asarray(x), jlayer)
    jdx, jdlayer = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    live = {k: v.clone().requires_grad_() for k, v in layer.items()}
    fn(tx, live).backward(torch.from_numpy(dy))
    return [(tx.grad, jdx)] + [(live[k].grad, jdlayer[k]) for k in names]


class TestModuleVJPs:
    def test_attention_vjp_matches_jax(self, configs_and_params):
        """x, wqkv and wo within 2 bf16 ulps of each gradient's max |g|:
        every product rounds to bf16 and may sum in another order
        (measured at most 0.5 ulp at DemoConfig())."""
        jconfig, jparams, config, params = configs_and_params
        shape = (config.batch, config.seq_len, config.d_model)
        pairs = _module_vjp(
            lambda x, l: jdemo._attention(x, l, jconfig),
            lambda x, l: demo._attention(x, l, config),
            jparams["layers"][0], params["layers"][0],
            _normal(shape, 10), _normal(shape, 11), ("wqkv", "wo"),
        )
        for got, want in pairs:
            _assert_within_ulps(got.numpy(), want, 2)

    def test_mlp_vjp_matches_jax(self, configs_and_params):
        """x, w1 and w2 within 2 bf16 ulps of each gradient's max |g|
        (measured at most 1 ulp): the GELU's slope follows the f32 formula,
        JAX's bf16 steps, and the bf16 products round the difference away
        or to one ulp."""
        jconfig, jparams, config, params = configs_and_params
        shape = (config.batch, config.seq_len, config.d_model)
        pairs = _module_vjp(
            jdemo._mlp, demo._mlp, jparams["layers"][0], params["layers"][0],
            _normal(shape, 12), _normal(shape, 13), ("w1", "w2"),
        )
        for got, want in pairs:
            _assert_within_ulps(got.numpy(), want, 2)

    def test_rmsnorm_vjp_matches_jax(self):
        """dx and dgain within 1e-6 of each gradient's max |g|, the card's
        RMSNorm tolerance: all f32, summed in another order (measured
        1.0e-7 and 3.4e-7 of the max)."""
        x, dy = _normal((8, 64, 128), 14), _normal((8, 64, 128), 15)
        gain = _normal(128, 16)
        _, vjp = jax.vjp(jdemo._rmsnorm, jnp.asarray(x), jnp.asarray(gain))
        want = vjp(jnp.asarray(dy))
        tx = torch.from_numpy(x).requires_grad_()
        tg = torch.from_numpy(gain).requires_grad_()
        demo._rmsnorm(tx, tg).backward(torch.from_numpy(dy))
        for got, w in zip((tx.grad, tg.grad), want):
            w = np.asarray(w)
            np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())


def _qkv(b, s, n_heads, head_dim, seed=0):
    shape = (b, s, 3 * n_heads * head_dim)
    return torch.from_numpy(_normal(shape, seed)).bfloat16()


def _mean_rel(got, want):
    return float((got.float() - want.float()).abs().mean() / want.float().abs().mean())


def _jax_attention(qkv, n_heads):
    """``demo.py:79-91`` in JAX, transcribed from the QKV product to the
    merged heads: what ``causal_attention_ref`` computes."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    head_dim = d // n_heads
    q, k, v = jnp.split(qkv, 3, axis=-1)

    def heads(t):
        return t.reshape(b, s, n_heads, head_dim).transpose(0, 2, 1, 3)

    q, k, v = heads(q), heads(k), heads(v)
    scores = (q @ k.transpose(0, 1, 3, 2)).astype(jnp.float32)
    scores = scores / jnp.sqrt(jnp.float32(head_dim))
    scores = jnp.where(jnp.tril(jnp.ones((s, s), bool)), scores, -1e30)
    probs = jax.nn.softmax(scores, axis=-1).astype(jnp.bfloat16)
    return (probs @ v).transpose(0, 2, 1, 3).reshape(b, s, d)


# heads the card's kernels now take past their former cap of 3072 and a
# width that is not a multiple of 8, on short sequences
WIDE_HEADS = [(2, 33, 2, 200), (1, 8, 1, 3073), (1, 40, 1, 4096)]


@pytest.mark.parametrize("b, s, n_heads, head_dim", WIDE_HEADS)
def test_attention_ref_matches_jax_on_wide_heads(b, s, n_heads, head_dim):
    """The plain forward, the card kernels' yardstick, against the
    reference's lines at heads of 200, 3073 and 4096, by the card kernels'
    check (``rows_close``: 3 bf16 ulps of each row's max |out|, a head of
    one query, and 2 of the output's), the products summed in another
    order before each bf16 rounding."""
    qkv = _qkv(b, s, n_heads, head_dim)
    want = _jax_attention(jnp.asarray(qkv.float().numpy(), jnp.bfloat16), n_heads)
    got = attention.causal_attention_ref(qkv, n_heads)
    assert got.dtype == torch.bfloat16
    assert rows_close(got, torch.from_numpy(np.asarray(want, np.float32)), head_dim)


@pytest.mark.parametrize("b, s, n_heads, head_dim", WIDE_HEADS)
def test_attention_bwd_ref_matches_jax_on_wide_heads(b, s, n_heads, head_dim):
    """The plain backward against ``jax.vjp`` of the reference's lines at
    the same heads: dQ, dK and dV each by the same check (rows of a head
    of one query for dQ, of one key for dK and dV)."""
    qkv = _qkv(b, s, n_heads, head_dim)
    dout = torch.from_numpy(_normal((b, s, n_heads * head_dim), 1)).bfloat16()
    _, vjp = jax.vjp(lambda t: _jax_attention(t, n_heads), jnp.asarray(qkv.float().numpy(), jnp.bfloat16))
    (want,) = vjp(jnp.asarray(dout.float().numpy(), jnp.bfloat16))
    got = attention.causal_attention_bwd_ref(qkv, dout, n_heads)
    assert rows_close(got, torch.from_numpy(np.asarray(want, np.float32)), head_dim, 3)


@pytest.mark.parametrize("b, s, n_heads, head_dim", [(8, 64, 4, 32), (2, 17, 3, 16)])
def test_attention_bwd_ref_matches_autograd(b, s, n_heads, head_dim):
    """The plain backward writes out the cast points that autograd of the
    plain forward takes (dV from the rounded p, dS from the f32 y, the
    division by sqrt(head_dim)); only the softmax's transpose is summed in
    another order, which flips a rare bf16 rounding.  Within 1 bf16 ulp of
    max |dqkv|, and a mean |err| under 1e-5 of the mean |dqkv| (measured
    at most 1.1e-7)."""
    qkv = _qkv(b, s, n_heads, head_dim)
    dout = torch.from_numpy(_normal((b, s, n_heads * head_dim), 1)).bfloat16()
    live = qkv.clone().requires_grad_()
    attention.causal_attention_ref(live, n_heads).backward(dout)
    got = attention.causal_attention_bwd_ref(qkv, dout, n_heads)
    _assert_within_ulps(got.float().numpy(), live.grad.float().numpy(), 1)
    assert _mean_rel(got, live.grad) < 1e-5


def test_attention_bwd_ref_mixes_y_and_rounded_p():
    """dS uses the f32 softmax y and dV the rounded p.  Building dS from
    the rounded p instead moves dqkv by one bf16 rounding of p, a mean
    |err| of about 1.5e-3 of the mean |dqkv|: the test above would see it."""
    qkv = _qkv(8, 64, 4, 32)
    dout = torch.from_numpy(_normal((8, 64, 128), 2)).bfloat16()
    want = attention.causal_attention_bwd_ref(qkv, dout, 4)
    q, k, v = (attention._heads(t, 4) for t in qkv.chunk(3, dim=-1))
    d_out = attention._heads(dout, 4)
    y, mask, root = attention._softmax_ref(q, k)
    p = y.to(torch.bfloat16)
    d_p = (d_out @ v.transpose(-1, -2)).float()
    d_s = torch.where(mask, p * (d_p - (p * d_p).sum(-1, keepdim=True)), 0.0) / root
    d_s = d_s.to(torch.bfloat16)
    swapped = torch.cat(
        [attention._merge(d_s @ k), attention._merge(d_s.transpose(-1, -2) @ q),
         attention._merge(p.transpose(-1, -2) @ d_out)], dim=-1,
    )
    assert _mean_rel(swapped, want) > 1e-4


def test_rmsnorm_bwd_ref_matches_autograd():
    """dx within 1e-6 of its max (the transpose is written in another
    order: measured 9.5e-7 at max 9.3) and dgain bit for bit."""
    x, dy = torch.from_numpy(_normal((8, 64, 128), 3)), torch.from_numpy(_normal((8, 64, 128), 4))
    gain = torch.from_numpy(_normal(128, 5))
    lx, lg = x.clone().requires_grad_(), gain.clone().requires_grad_()
    rmsnorm.rmsnorm_ref(lx, lg).backward(dy)
    dx, dgain = rmsnorm.rmsnorm_bwd_ref(x, gain, dy)
    torch.testing.assert_close(dx, lx.grad, rtol=0, atol=1e-6 * float(lx.grad.abs().max()))
    assert torch.equal(dgain, lg.grad)


def _gelu_slope_f64(x):
    u = np.sqrt(2 / np.pi) * (x + 0.044715 * x**3)
    t = np.tanh(u)
    return 0.5 * (1 + t) + 0.5 * x * (1 - t * t) * np.sqrt(2 / np.pi) * (1 + 3 * 0.044715 * x * x)


def test_gelu_bwd_ref_matches_f64_and_autograd():
    """In f32 the sigmoid form is within rtol 1e-5, atol 1e-7 of the slope
    evaluated in f64; autograd of the plain forward differentiates the tanh
    form, whose ``1 - tanh²`` cancels at |x| > 3, so it is held within
    atol 1e-5 (measured 7.2e-6).  In bf16 both round an f32 value once:
    within 1 bf16 ulp of max(|dx|, 2**-8)."""
    x = _normal((512, 512), 6, scale=3.0)
    dy = _normal((512, 512), 7)
    got = gelu.gelu_tanh_bwd_ref(torch.from_numpy(x), torch.from_numpy(dy))
    exact = dy.astype(np.float64) * _gelu_slope_f64(x.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5, atol=1e-7)
    live = torch.from_numpy(x).requires_grad_()
    gelu.gelu_tanh_ref(live).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(got.numpy(), live.grad.numpy(), rtol=0, atol=1e-5)

    xb, dyb = torch.from_numpy(x).bfloat16(), torch.from_numpy(dy).bfloat16()
    got = gelu.gelu_tanh_bwd_ref(xb, dyb)
    assert got.dtype == torch.bfloat16
    live = xb.clone().requires_grad_()
    gelu.gelu_tanh_ref(live).backward(dyb)
    want = live.grad.float()
    assert bool(((got.float() - want).abs() <= bf16_ulp(want.abs().clamp_min(2.0**-8))).all())


def test_gelu_bwd_ref_matches_jax_in_f32():
    """Against ``jax.vjp(jax.nn.gelu)`` in f32: rtol 1e-5, and atol 2e-5
    for JAX's own tanh form, whose ``1 ± tanh`` cancels at large |x|
    (measured 1.6e-5 at sigma 3; the test above holds the port to f64)."""
    x, dy = _normal((512, 512), 8, scale=3.0), _normal((512, 512), 9)
    _, vjp = jax.vjp(jax.nn.gelu, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    got = gelu.gelu_tanh_bwd_ref(torch.from_numpy(x), torch.from_numpy(dy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)


def _logits_and_targets(shape, vocab, seed):
    logits = torch.from_numpy(_normal((*shape, vocab), seed, scale=2.0))
    targets = torch.from_numpy(np.random.default_rng(seed + 1).integers(0, vocab, shape))
    return logits, targets


def _jax_cross_entropy(logits, targets):
    logp = jax.nn.log_softmax(logits, axis=-1)
    return jnp.mean(-jnp.take_along_axis(logp, targets[..., None], axis=-1))


@pytest.mark.parametrize("shape, vocab", [((8, 64), 256), ((3, 7), 1000)])
def test_cross_entropy_ref_matches_jax(shape, vocab):
    """``loss_fn``'s tail, ``log_softmax`` + ``take_along_axis`` + ``mean``,
    and its VJP at a loss gradient of 1: the loss within 5e-6 (f32 sums in
    another order; measured 4.8e-7) and dlogits within rtol 1e-6, atol 1e-9
    (a few f32 ulps: ``exp`` and the scale round in another order; measured
    5.7e-7 relative)."""
    logits, targets = _logits_and_targets(shape, vocab, 20)
    want, vjp = jax.vjp(
        lambda l: _jax_cross_entropy(l, jnp.asarray(targets.numpy())), jnp.asarray(logits.numpy())
    )
    (want_d,) = vjp(jnp.float32(1.0))
    loss, lse = ce.cross_entropy_ref(logits, targets)
    assert loss.shape == () and lse.shape == (targets.numel(),)
    assert abs(float(loss) - float(want)) <= 5e-6
    got_d = ce.cross_entropy_bwd_ref(logits, targets, lse, torch.ones(()))
    assert got_d.shape == logits.shape
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6, atol=1e-9)


def test_cross_entropy_bwd_ref_matches_autograd():
    """Within 1e-9 (measured 4.3e-10): autograd differentiates the
    log-softmax step by step, the plain backward in one formula."""
    logits, targets = _logits_and_targets((8, 64), 256, 21)
    live = logits.clone().requires_grad_()
    loss, lse = ce.cross_entropy_ref(live, targets)
    loss.backward(torch.tensor(0.5))
    got = ce.cross_entropy_bwd_ref(logits, targets, lse.detach(), torch.tensor(0.5))
    torch.testing.assert_close(got, live.grad, rtol=0, atol=1e-9)


@pytest.mark.parametrize("shape, vocab", [((8, 64), 256), ((3, 7), 1000)])
def test_cross_entropy_on_bf16_logits_is_the_f32_path_cast(shape, vocab):
    """On bf16 logits the loss and lse are the bits of the f32 path on the
    widened logits, and dlogits the bits of its f32 dlogits cast to bf16,
    by the wrappers and through autograd (against the unfused ``.float()``
    before the loss).  Against ``jax.value_and_grad`` of the reference's
    tail, widening included, on the same bf16 logits: the loss within 5e-6
    and dlogits within 1 bf16 ulp (both round an f32 value once)."""
    wide, targets = _logits_and_targets(shape, vocab, 22)
    logits = wide.bfloat16()
    wide = logits.float()
    loss, lse = ce.cross_entropy_fwd(logits, targets)
    want_loss, want_lse = ce.cross_entropy_fwd(wide, targets)
    assert torch.equal(loss, want_loss) and torch.equal(lse, want_lse)
    g = torch.tensor(0.75)
    dx = ce.cross_entropy_bwd(logits, targets, lse, g)
    assert dx.dtype == torch.bfloat16
    assert torch.equal(dx, ce.cross_entropy_bwd(wide, targets, lse, g).to(torch.bfloat16))

    fused, chain = logits.clone().requires_grad_(), logits.clone().requires_grad_()
    ce.cross_entropy(fused, targets).backward(g)
    ce.cross_entropy(chain.float(), targets).backward(g)
    assert fused.grad.dtype == torch.bfloat16 and torch.equal(fused.grad, chain.grad)

    jlogits = jnp.asarray(logits.float().numpy()).astype(jnp.bfloat16)
    want, vjp = jax.vjp(
        lambda l: _jax_cross_entropy(l.astype(jnp.float32), jnp.asarray(targets.numpy())), jlogits
    )
    (want_d,) = vjp(jnp.float32(1.0))
    assert want_d.dtype == jnp.bfloat16
    assert abs(float(loss) - float(want)) <= 5e-6
    got_d = ce.cross_entropy_bwd(logits, targets, lse, torch.ones(())).float()
    want_d = torch.from_numpy(np.array(want_d.astype(jnp.float32)))
    assert bool(((got_d - want_d).abs() <= bf16_ulp(want_d)).all())


class TestWrappersOnCpu:
    """Each new wrapper takes its plain version for CPU tensors (no launch
    counted) and rejects what its kernel cannot take."""

    def test_attention(self):
        qkv = _qkv(2, 16, 2, 32)
        dout = torch.from_numpy(_normal((2, 16, 64), 30)).bfloat16()
        before = _launches("causal_attention")
        assert torch.equal(
            attention.causal_attention_bwd(qkv, dout, 2),
            attention.causal_attention_bwd_ref(qkv, dout, 2),
        )
        live = qkv.clone().requires_grad_()
        out = attention.causal_attention(live, 2)
        assert torch.equal(out, attention.causal_attention_ref(qkv, 2))
        out.backward(dout)
        assert torch.equal(live.grad, attention.causal_attention_bwd_ref(qkv, dout, 2))
        assert _launches("causal_attention") == before

    @pytest.mark.parametrize(
        "dout, n_heads",
        [
            (torch.zeros(2, 16, 64), 2),                           # f32 dout
            (torch.zeros(2, 16, 32, dtype=torch.bfloat16), 2),     # wrong width
            (torch.zeros(2, 16, 64, dtype=torch.bfloat16), 3),     # 192 % 9 != 0
        ],
        ids=["dtype", "shape", "heads"],
    )
    def test_attention_bwd_rejects(self, dout, n_heads):
        with pytest.raises(ValueError):
            attention.causal_attention_bwd(_qkv(2, 16, 2, 32), dout, n_heads)

    def test_rmsnorm(self):
        x = torch.from_numpy(_normal((4, 16, 64), 31, scale=3.0))
        dy = torch.from_numpy(_normal((4, 16, 64), 32))
        gain = torch.linspace(0.5, 1.5, 64)
        before = _launches("rmsnorm")
        got = rmsnorm.rmsnorm_bwd(x, gain, dy)
        want = rmsnorm.rmsnorm_bwd_ref(x, gain, dy)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        lx, lg = x.clone().requires_grad_(), gain.clone().requires_grad_()
        rmsnorm.rmsnorm(lx, lg).backward(dy)
        assert torch.equal(lx.grad, want[0]) and torch.equal(lg.grad, want[1])
        assert _launches("rmsnorm") == before
        for bad in (dy.bfloat16(), dy[..., :32], dy[0]):
            with pytest.raises(ValueError):
                rmsnorm.rmsnorm_bwd(x, gain, bad)
        with pytest.raises(ValueError):
            rmsnorm.rmsnorm_bwd(x, gain[:32], dy)

    def test_rmsnorm_bwd_bf16(self):
        """The bf16-dy entry on CPU tensors is the plain version on dy
        widened, launches nothing, and refuses an f32 dy or another shape."""
        x = torch.from_numpy(_normal((4, 16, 64), 36, scale=3.0))
        dy = torch.from_numpy(_normal((4, 16, 64), 37)).bfloat16()
        gain = torch.linspace(0.5, 1.5, 64)
        before = _launches("rmsnorm")
        got = rmsnorm.rmsnorm_bwd_bf16(x, gain, dy)
        want = rmsnorm.rmsnorm_bwd_ref(x, gain, dy.float())
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert _launches("rmsnorm") == before
        for bad in (dy.float(), dy[..., :32]):
            with pytest.raises(ValueError):
                rmsnorm.rmsnorm_bwd_bf16(x, gain, bad)
        with pytest.raises(ValueError):
            rmsnorm.rmsnorm_bwd_bf16(x.to("meta"), gain, dy)

    @pytest.mark.parametrize("on_meta", ["x", "gain", "dy", "all"])
    def test_rmsnorm_bwd_rejects_a_device_neither_cpu_nor_cuda(self, on_meta):
        """A tensor on ``meta`` raises: the plain version serves CPU tensors
        only and is never a fallback for another device."""
        args = {"x": torch.ones(4, 64), "gain": torch.ones(64), "dy": torch.ones(4, 64)}
        args = {k: t.to("meta") if on_meta in (k, "all") else t for k, t in args.items()}
        before = telemetry.value("kernels.rmsnorm_bwd")
        with pytest.raises(ValueError):
            rmsnorm.rmsnorm_bwd(args["x"], args["gain"], args["dy"])
        assert telemetry.value("kernels.rmsnorm_bwd") == before

    def test_gelu(self):
        """``gelu_tanh``'s gradient on CPU tensors is the plain backward.
        The fused wrappers that replace its kernels on the card, and what
        they reject, are in ``tests/test_torch_mlp.py``."""
        x = torch.from_numpy(_normal((64, 128), 33, scale=3.0)).bfloat16()
        dy = torch.from_numpy(_normal((64, 128), 34)).bfloat16()
        live = x.clone().requires_grad_()
        gelu.gelu_tanh(live).backward(dy)
        assert torch.equal(live.grad, gelu.gelu_tanh_bwd_ref(x, dy))
        for bad in (x.float(), x.to("meta")):
            with pytest.raises(ValueError):
                gelu.gelu_tanh(bad.requires_grad_())

    def test_cross_entropy(self):
        logits, targets = _logits_and_targets((4, 16), 256, 35)
        before = _launches("cross_entropy")
        loss, lse = ce.cross_entropy_fwd(logits, targets)
        want_loss, want_lse = ce.cross_entropy_ref(logits, targets)
        assert torch.equal(loss, want_loss) and torch.equal(lse, want_lse)
        g = torch.tensor(1.0)
        want_d = ce.cross_entropy_bwd_ref(logits, targets, lse, g)
        assert torch.equal(ce.cross_entropy_bwd(logits, targets, lse, g), want_d)
        live = logits.clone().requires_grad_()
        out = ce.cross_entropy(live, targets)
        assert torch.equal(out, want_loss)
        out.backward()
        assert torch.equal(live.grad, want_d)
        assert _launches("cross_entropy") == before

    def test_cross_entropy_bf16(self):
        """bf16 logits take the plain version too; ``dlogits`` come back
        in bf16."""
        logits, targets = _logits_and_targets((4, 16), 256, 37)
        logits = logits.bfloat16()
        before = _launches("cross_entropy")
        loss, lse = ce.cross_entropy_fwd(logits, targets)
        want_loss, want_lse = ce.cross_entropy_ref(logits, targets)
        assert torch.equal(loss, want_loss) and torch.equal(lse, want_lse)
        g = torch.tensor(1.0)
        got = ce.cross_entropy_bwd(logits, targets, lse, g)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, ce.cross_entropy_bwd_ref(logits, targets, lse, g))
        assert _launches("cross_entropy") == before

    @pytest.mark.parametrize(
        "logits, targets",
        [
            (torch.zeros(4, 8, dtype=torch.float16), torch.zeros(4, dtype=torch.long)),  # f16
            (torch.zeros(4, 8), torch.zeros(4)),                       # float targets
            (torch.zeros(4, 8), torch.zeros(5, dtype=torch.long)),     # shape
            (torch.zeros(2, 0), torch.zeros(2, dtype=torch.long)),     # no vocab
        ],
        ids=["dtype", "targets", "shape", "vocab"],
    )
    def test_cross_entropy_rejects(self, logits, targets):
        with pytest.raises(ValueError):
            ce.cross_entropy_fwd(logits, targets)
        with pytest.raises(ValueError):
            ce.cross_entropy_bwd(logits, targets, torch.zeros(targets.numel()), torch.ones(()))

    def test_cross_entropy_bwd_rejects_bad_lse_or_grad(self):
        logits, targets = _logits_and_targets((4,), 8, 36)
        for lse, g in ((torch.zeros(5), torch.ones(())), (torch.zeros(4), torch.ones(2))):
            with pytest.raises(ValueError):
                ce.cross_entropy_bwd(logits, targets, lse, g)


def test_forward_without_grad_records_nothing():
    """The serving forward builds no autograd graph when nothing needs a
    gradient, so it saves no tensors for a backward."""
    config = demo.DemoConfig(**CONFIGS["test"])
    params = demo.init_params(config, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((2, config.seq_len), dtype=torch.long)
    assert demo.forward(params, tokens, config).grad_fn is None
    with torch.no_grad():
        live = demo.tree_map(lambda p: p.clone().requires_grad_(), params)
        assert demo.forward(live, tokens, config).grad_fn is None
