"""The MLP's fused products (``operator_forge_torch/kernels/mlp.py``) on the
CPU: the plain path of ``mlp`` against JAX's ``_mlp``
(``operator_forge/tpu/demo.py:96-99``) forward and under ``jax.vjp``,
against the unfused composition bit for bit, and the wrappers' dispatch
and checks.  Inputs are made with numpy from a seed; the kernels
themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from operator_forge.tpu import demo as jdemo
from operator_forge_torch import demo, telemetry
from operator_forge_torch.kernels import bf16_ulp, gelu, within_floored_ulps
from operator_forge_torch.kernels import mlp as mlp_mod

BF16 = torch.bfloat16

# (batch dims, K, N, D): DemoConfig()'s MLP, the test config's, odd
# widths, a depth of 1, and a 2-D x
SHAPES = [((8, 64), 128, 512, 128), ((8, 16), 64, 128, 64), ((1, 91), 72, 200, 72),
          ((3, 5), 1, 24, 7), ((91,), 72, 200, 40)]


def _launches(wrapper: str) -> tuple:
    """The launch counters of ``wrapper`` and of its backward."""
    return telemetry.value(f"kernels.{wrapper}"), telemetry.value(f"kernels.{wrapper}_bwd")


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _inputs(lead, k, n, d, seed):
    """x as RMSNorm leaves it (unit scale) and weights at the model's
    initial scale, N(0, 0.02²) (``init_params``), as f32 numpy arrays."""
    return (_normal((*lead, k), seed), _normal((k, n), seed + 1, 0.02),
            _normal((n, d), seed + 2, 0.02))


def _bf16(a):
    return torch.from_numpy(a).to(BF16)


def _assert_within_ulps(got, want, n):
    """|got - want| within ``n`` bf16 ulps of max |want|, in f32."""
    got, want = torch.as_tensor(np.asarray(got, np.float32)), torch.as_tensor(np.asarray(want, np.float32))
    tol = n * float(bf16_ulp(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= tol, f"max |err| {err:.3e} > {n} bf16 ulps of max |want| ({tol:.3e})"


@pytest.mark.parametrize("lead, k, n, d", SHAPES)
def test_mlp_matches_jax(lead, k, n, d):
    """The output within 2 bf16 ulps of its max |y|, as ``_attention``'s
    (both round the products to bf16 and may sum in another order; JAX
    also evaluates the GELU in bf16 steps, ``test_gelu_matches_jax_in_bf16``);
    the gradients of x, w1 and w2 under ``jax.vjp`` within 2 bf16 ulps of
    each one's max |g|, as ``test_mlp_vjp_matches_jax``."""
    x, w1, w2 = _inputs(lead, k, n, d, seed=0)
    dy = _normal((*lead, d), 3)
    layer = {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)}
    want, vjp = jax.vjp(jdemo._mlp, jnp.asarray(x), layer)
    jdx, jdlayer = vjp(jnp.asarray(dy))
    live = [torch.from_numpy(a).requires_grad_() for a in (x, w1, w2)]
    got = demo._mlp(live[0], {"w1": live[1], "w2": live[2]})
    _assert_within_ulps(got.detach().numpy(), want, 2)
    got.backward(torch.from_numpy(dy))
    for g, w in zip((t.grad for t in live), (jdx, jdlayer["w1"], jdlayer["w2"])):
        assert g.shape == w.shape
        _assert_within_ulps(g.numpy(), w, 2)


def _unfused(x, w1, w2):
    """The MLP as three autograd nodes: the ``w1`` product, ``GeluTanh``,
    the ``w2`` product (what ``demo._mlp`` ran before the fusion)."""
    return gelu.gelu_tanh(x @ w1) @ w2


@pytest.mark.parametrize("lead, k, n, d", SHAPES)
def test_mlp_is_the_unfused_composition(lead, k, n, d):
    """On the CPU the Function gives the unfused composition's bits: the
    output and the gradients of x, w1 and w2."""
    arrays = _inputs(lead, k, n, d, seed=10)
    dy = _bf16(_normal((*lead, d), 13))
    outs, grads = [], []
    for fn in (mlp_mod.mlp, _unfused):
        live = [_bf16(a).requires_grad_() for a in arrays]
        out = fn(*live)
        out.backward(dy)
        outs.append(out.detach())
        grads.append([t.grad for t in live])
    assert outs[0].dtype == BF16 and torch.equal(*outs)
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_demo_mlp_runs_through_the_function():
    """``demo._mlp`` is the Function followed by the widening: its output's
    gradient node leads to ``MLPBackward``, and its gradients are the
    unfused composition's."""
    x, w1, w2 = _inputs((2, 8), 64, 128, 64, seed=20)
    layer = {"w1": torch.from_numpy(w1), "w2": torch.from_numpy(w2)}
    live = torch.from_numpy(x).to(BF16).requires_grad_()
    out = demo._mlp(live, layer)
    assert out.dtype == torch.float32
    assert out.grad_fn.next_functions[0][0].name() == "MLPBackward"
    want = _unfused(live.detach(), layer["w1"].to(BF16), layer["w2"].to(BF16)).float()
    assert torch.equal(out.detach(), want)


class TestWrappersOnCpu:
    """The wrappers take their plain versions for CPU tensors, count no
    launch, and reject what their kernels do not take."""

    def test_matmul_gelu(self):
        x, w1 = _bf16(_normal((2, 91, 72), 30)), _bf16(_normal((72, 200), 31, 0.3))
        before = _launches("matmul_gelu")
        h, h_pre = mlp_mod.matmul_gelu(x, w1)
        want_h, want_pre = mlp_mod.matmul_gelu_ref(x, w1)
        assert torch.equal(h, want_h) and torch.equal(h_pre, want_pre)
        assert torch.equal(h_pre, x @ w1) and torch.equal(h, gelu.gelu_tanh_ref(x @ w1))
        served, none = mlp_mod.matmul_gelu(x, w1, keep_pre=False)
        assert none is None and torch.equal(served, want_h)
        assert _launches("matmul_gelu") == before

    def test_matmul_gelu_bwd(self):
        dy, w2 = _bf16(_normal((2, 91, 40), 32)), _bf16(_normal((200, 40), 33, 0.3))
        h_pre = _bf16(_normal((2, 91, 200), 34, 3.0))
        before = _launches("matmul_gelu")
        got = mlp_mod.matmul_gelu_bwd(dy, w2, h_pre)
        assert got.dtype == BF16
        assert torch.equal(got, mlp_mod.matmul_gelu_bwd_ref(dy, w2, h_pre))
        assert torch.equal(got, gelu.gelu_tanh_bwd_ref(h_pre, dy @ w2.t()))
        assert _launches("matmul_gelu") == before

    @pytest.mark.parametrize(
        "x, w1",
        [(torch.zeros(4, 8), torch.zeros(8, 16, dtype=BF16)),           # f32 x
         (torch.zeros(4, 8, dtype=BF16), torch.zeros(8, 16)),           # f32 w1
         (torch.zeros(4, 8, dtype=BF16), torch.zeros(9, 16, dtype=BF16)),  # K differs
         (torch.zeros(4, 8, dtype=BF16), torch.zeros(8, dtype=BF16)),   # w1 not 2-D
         (torch.zeros(0, 8, dtype=BF16), torch.zeros(8, 16, dtype=BF16)),  # no rows
         (torch.zeros(4, 8, dtype=BF16), torch.zeros(8, 16, dtype=BF16, device="meta"))],
        ids=["x_dtype", "w1_dtype", "depth", "w1_dims", "empty", "device"],
    )
    def test_matmul_gelu_rejects(self, x, w1):
        before = telemetry.value("kernels.matmul_gelu")
        with pytest.raises(ValueError):
            mlp_mod.matmul_gelu(x, w1)
        assert telemetry.value("kernels.matmul_gelu") == before

    @pytest.mark.parametrize(
        "dy, w2, h_pre",
        [(torch.zeros(4, 8), torch.zeros(16, 8, dtype=BF16), torch.zeros(4, 16, dtype=BF16)),
         (torch.zeros(4, 8, dtype=BF16), torch.zeros(16, 8, dtype=BF16), torch.zeros(4, 16)),
         (torch.zeros(4, 8, dtype=BF16), torch.zeros(16, 9, dtype=BF16), torch.zeros(4, 16, dtype=BF16)),
         (torch.zeros(4, 8, dtype=BF16), torch.zeros(16, 8, dtype=BF16), torch.zeros(4, 15, dtype=BF16)),
         (torch.zeros(4, 8, dtype=BF16), torch.zeros(16, 8, dtype=BF16), torch.zeros(5, 16, dtype=BF16)),
         (torch.zeros(4, 8, dtype=BF16), torch.zeros(16, 8, dtype=BF16),
          torch.zeros(4, 16, dtype=BF16, device="meta"))],
        ids=["dy_dtype", "h_pre_dtype", "depth", "width", "rows", "device"],
    )
    def test_matmul_gelu_bwd_rejects(self, dy, w2, h_pre):
        before = telemetry.value("kernels.matmul_gelu_bwd")
        with pytest.raises(ValueError):
            mlp_mod.matmul_gelu_bwd(dy, w2, h_pre)
        assert telemetry.value("kernels.matmul_gelu_bwd") == before

    def test_function_counts_no_launch_on_cpu(self):
        arrays = _inputs((4, 16), 64, 128, 64, seed=40)
        live = [_bf16(a).requires_grad_() for a in arrays]
        before = _launches("matmul_gelu")
        mlp_mod.mlp(*live).float().sum().backward()
        assert all(t.grad is not None for t in live)
        assert _launches("matmul_gelu") == before


@pytest.mark.parametrize("grad", [True, False])
def test_h_pre_is_kept_only_for_a_gradient(monkeypatch, grad):
    """The forward asks ``matmul_gelu`` for ``h_pre`` only where a
    gradient can be taken: not for the served forward, nor under
    ``torch.no_grad()``."""
    asked = []
    real = mlp_mod.matmul_gelu

    def spy(x, w1, keep_pre=True):
        asked.append(keep_pre)
        return real(x, w1, keep_pre)

    monkeypatch.setattr(mlp_mod, "matmul_gelu", spy)
    arrays = _inputs((2, 8), 16, 32, 16, seed=50)
    live = [_bf16(a).requires_grad_(grad) for a in arrays]
    mlp_mod.mlp(*live)
    with torch.no_grad():
        mlp_mod.mlp(*live)
    assert asked == [grad, False]


def test_within_floored_ulps():
    """1 bf16 ulp of each value (2**-7 at 1.0, 2**-6 at 3.0), but never
    less than the ulp of 2**-8 of the largest (3.0 -> 2**-14 at 0.0117)."""
    want = torch.tensor([1.0, -3.0, 0.0])
    assert within_floored_ulps(want + torch.tensor([2.0**-7, -(2.0**-6), 2.0**-14]), want, 1)
    assert not within_floored_ulps(want + torch.tensor([2.0**-6, 0.0, 0.0]), want, 1)
    assert within_floored_ulps(want + torch.tensor([2.0**-6, 0.0, 0.0]), want, 2)
    assert not within_floored_ulps(want + torch.tensor([0.0, 0.0, 2.0**-13]), want, 1)
    assert within_floored_ulps(want.bfloat16(), want, 1)


def test_gelu_close():
    """The plain GELU of h_pre passes; one bf16 ulp more on a value of
    magnitude at least 2**-8 passes, two fail."""
    h_pre = _bf16(_normal((64, 64), 60, 3.0))
    h = gelu.gelu_tanh_ref(h_pre)
    assert mlp_mod.gelu_close(h, h_pre)
    big = h.float().abs().argmax()
    for ulps, ok in ((1, True), (2, False)):
        bumped = h.float().flatten().clone()
        bumped[big] += ulps * bf16_ulp(bumped[big])
        assert mlp_mod.gelu_close(bumped.view_as(h), h_pre) == ok
