"""Port parity, the slice end to end: allocnet_tpu_torch's plan_batch
(ConvLSTM -> QP -> solve) against the JAX plan_batch with the shipped seq5
weights (CPU), and the port's isolation from JAX."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allocnet_tpu.config import QPConfig as JQPConfig
from allocnet_tpu.config import SolverConfig as JSolverConfig
from allocnet_tpu.models import import_torch
from allocnet_tpu.models.networks import ConvLSTMAllocNet as JConvLSTMAllocNet
from allocnet_tpu.planner import pipeline as jpipeline
from allocnet_tpu_torch.config import QPConfig, SolverConfig
from allocnet_tpu_torch.models import weights
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.planner import pipeline
from allocnet_tpu_torch.utils import scenarios

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "data/params/seq5_tokenthresh0_35.msgpack")


def _net():
    net = ConvLSTMAllocNet(5, 256, 0.5)
    net.load_state_dict(weights.load_params(WEIGHTS))
    return net


def test_plan_batch_matches_jax():
    # the shipped net is out of distribution on these synthetic corridors
    # (it solves ~1 in 4, README); B=16, seed 123 gives solved and unsolved
    cfg, jcfg = QPConfig(res=10), JQPConfig(res=10)
    budget = dict(n_chunks=2, iters_per_chunk=75)
    sc = scenarios.random_scenarios(cfg, 16, seed=123, min_seg=1)
    res = pipeline.plan_batch(_net(), cfg, SolverConfig(**budget), sc.state,
                              sc.hpolys, sc.seg, device="cpu")

    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                           import_torch.load_params_msgpack(WEIGHTS))
    jnet = JConvLSTMAllocNet(seq_len=5, hidden_size=256, token_thresh=0.5)
    jres = jpipeline.plan_batch(
        jnet, jparams, jcfg, JSolverConfig(**budget),
        jnp.asarray(sc.state, jnp.float32), jnp.asarray(sc.hpolys, jnp.float32),
        jnp.asarray(sc.seg))
    jres = jax.tree.map(np.asarray, jres)

    # network outputs: f32, same layer math -> rtol 1e-5
    np.testing.assert_allclose(res.times.numpy(), jres.times, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.tokens.numpy(), jres.tokens, rtol=1e-5, atol=1e-6)
    # solve: flags equal, coefficients on the solved set within 1e-3 (the
    # f32 solve's bar, tests/test_torch_solve.py)
    np.testing.assert_array_equal(res.solved.numpy(), jres.solved)
    np.testing.assert_array_equal(res.ok.numpy(), jres.ok)
    both = res.solved.numpy() & jres.solved
    assert 0 < both.sum() < 16
    c = res.coeffs.numpy()
    assert c.shape == (16, 5, 3, 8) and np.isfinite(c).all()
    scale = max(1.0, float(np.abs(jres.coeffs[both]).max()))
    assert float(np.abs(c - jres.coeffs)[both].max()) <= 1e-3 * scale


def test_plan_batch_refine_is_a_later_slice():
    cfg = QPConfig(res=10)
    sc = scenarios.random_scenarios(cfg, 2, seed=0)
    with pytest.raises(NotImplementedError):
        pipeline.plan_batch(_net(), cfg, SolverConfig(), sc.state, sc.hpolys,
                            sc.seg, refine_steps=2, device="cpu")


def test_entry_points_default_to_the_card():
    """Without a card, an entry point that is not asked for the CPU raises
    instead of running there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = QPConfig(res=10)
    sc = scenarios.random_scenarios(cfg, 2, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.plan_batch(_net(), cfg, SolverConfig(), sc.state, sc.hpolys,
                            sc.seg)


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither JAX, flax,
    msgpack, h5py nor the JAX package."""
    code = (
        "import sys, pkgutil, importlib, allocnet_tpu_torch\n"
        "for m in pkgutil.walk_packages(allocnet_tpu_torch.__path__, "
        "'allocnet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'msgpack', 'h5py', 'allocnet_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, env=env,
                   timeout=120)
