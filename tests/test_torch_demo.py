"""The port's forward slice (``operator_forge_torch``) against the JAX
reference (``operator_forge/tpu/demo.py``), on the CPU, on the same
parameters and tokens."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from operator_forge.tpu import demo as jdemo
from operator_forge_torch import demo
from operator_forge_torch.entry import entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "test": dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, seq_len=16, batch=8),
    "default": {},
}


@pytest.fixture(scope="module")
def config():
    return demo.DemoConfig(**CONFIGS["test"])


class TestDemoModel:
    def test_forward_shapes(self, config):
        params = demo.init_params(config, torch.Generator().manual_seed(0), "cpu")
        tokens = torch.zeros((2, config.seq_len), dtype=torch.long)
        logits = demo.forward(params, tokens, config)
        assert logits.shape == (2, config.seq_len, config.vocab)
        assert logits.dtype == torch.float32


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name):
    """Logits within 2e-3: 4 bf16 ulps at |logit| < 0.125.  The gap
    measured on these weights is one ulp (4.9e-4 at DemoConfig())."""
    jconfig = jdemo.DemoConfig(**CONFIGS[name])
    jparams = jdemo.init_params(jconfig, jax.random.PRNGKey(0))
    tokens = jax.random.randint(
        jax.random.PRNGKey(1), (jconfig.batch, jconfig.seq_len), 0, jconfig.vocab
    )
    want = np.asarray(jdemo.forward(jparams, tokens, jconfig))
    assert np.abs(want).max() < 0.125
    params = demo.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    got = demo.forward(
        params, torch.from_numpy(np.array(tokens)).long(), demo.DemoConfig(**CONFIGS[name])
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


def test_init_params_layout_matches_jax(config):
    jconfig = jdemo.DemoConfig(**CONFIGS["test"])
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape), jdemo.init_params(jconfig, jax.random.PRNGKey(0))
    )
    params = demo.init_params(config, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == jshapes
    again = demo.init_params(config, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(params["layers"][1]["w2"], again["layers"][1]["w2"])
    assert torch.equal(params["layers"][0]["ln1"], torch.ones(config.d_model))
    assert abs(float(params["embed"].std()) - 0.02) < 2e-3


def test_params_from_jax_copies_each_array(config):
    jparams = jdemo.init_params(jdemo.DemoConfig(**CONFIGS["test"]), jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = demo.params_from_jax(tree, "cpu")
    params["layers"][0]["wqkv"].zero_()  # writable, and not a view of JAX's buffer
    assert np.abs(tree["layers"][0]["wqkv"]).max() > 0
    assert np.array_equal(params["unembed"].numpy(), tree["unembed"])


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_entry_on_cpu_runs():
    fn, (params, tokens) = entry(device="cpu")
    assert tokens.shape == (8, 64) and tokens.dtype == torch.long
    logits = fn(params, tokens)
    assert logits.shape == (8, 64, 256)
    assert bool(torch.isfinite(logits).all())
    _, (_, same) = entry(device="cpu")
    assert torch.equal(tokens, same)


def _run(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, **env},
    )


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = _run(
        "import sys, operator_forge_torch, operator_forge_torch.demo, "
        "operator_forge_torch.entry, operator_forge_torch.kernels.attention, "
        "operator_forge_torch.kernels.build, operator_forge_torch.kernels.gelu, "
        "operator_forge_torch.kernels.rmsnorm\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'operator_forge')]\n"
        "assert not bad, bad"
    )
    assert proc.returncode == 0, proc.stderr


def test_kernel_modules_import_without_triton_or_nvcc():
    """``sys.modules['triton'] = None`` makes any ``import triton`` fail,
    and PATH and CUDA_HOME lead to no nvcc: the modules import, and the
    CPU forward runs, all the same."""
    proc = _run(
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "from operator_forge_torch.kernels import attention, build, gelu, rmsnorm\n"
        "from operator_forge_torch.entry import entry\n"
        "fn, args = entry(device='cpu')\n"
        "assert fn(*args).shape == (8, 64, 256)\n",
        PATH=os.path.dirname(sys.executable), CUDA_HOME=os.path.join(REPO, "no-cuda"),
    )
    assert proc.returncode == 0, proc.stderr
