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
from allocnet_tpu.models.networks import ConvMLPAllocNet as JConvMLPAllocNet
from allocnet_tpu.planner import pipeline as jpipeline
from allocnet_tpu_torch.config import QPConfig, SolverConfig
from allocnet_tpu_torch.models import weights
from allocnet_tpu_torch import config
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet, ConvMLPAllocNet
from allocnet_tpu_torch.planner import pipeline
from allocnet_tpu_torch.train import dataset, evaluate, trainer
from allocnet_tpu_torch.utils import scenarios
from tests.torch_threads import one_torch_thread  # noqa: F401

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


def test_plan_batch_refine_matches_jax():
    """refine_steps=2 between the net and the final solve, in f64 on both
    sides (both run the plain ADMM scan and the same implicit gradients):
    the refined times, objectives and flags agree to rounding."""
    cfg, jcfg = QPConfig(res=10), JQPConfig(res=10)
    budget = dict(n_chunks=2, iters_per_chunk=75)
    sc = scenarios.random_scenarios(cfg, 8, seed=123, min_seg=1)
    net = _net().double()
    res = pipeline.plan_batch(net, cfg, SolverConfig(**budget), sc.state,
                              sc.hpolys, sc.seg, refine_steps=2,
                              device="cpu")
    base = pipeline.plan_batch(net, cfg, SolverConfig(**budget), sc.state,
                               sc.hpolys, sc.seg, device="cpu")

    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                           import_torch.load_params_msgpack(WEIGHTS))
    jnet = JConvLSTMAllocNet(seq_len=5, hidden_size=256, token_thresh=0.5)
    jres = jax.tree.map(np.asarray, jpipeline.plan_batch(
        jnet, jparams, jcfg, JSolverConfig(**budget), jnp.asarray(sc.state),
        jnp.asarray(sc.hpolys), jnp.asarray(sc.seg), refine_steps=2))

    np.testing.assert_array_equal(res.solved.numpy(), jres.solved)
    np.testing.assert_array_equal(res.ok.numpy(), jres.ok)
    np.testing.assert_allclose(res.times.numpy(), jres.times, rtol=1e-8,
                               atol=1e-12)
    s = jres.solved
    assert s.any()
    np.testing.assert_allclose(res.obj.numpy()[s], jres.obj[s], rtol=1e-8)
    scale = max(1.0, float(np.abs(jres.coeffs[s]).max()))
    assert float(np.abs(res.coeffs.numpy() - jres.coeffs)[s].max()) \
        <= 1e-8 * scale
    # the total time of each plan is kept (clamped to 0.05 first), and no
    # scenario solved without refinement ends up worse
    seg_mask = np.arange(5)[None, :] < sc.seg[:, None]
    np.testing.assert_allclose(
        res.times.numpy().sum(1),
        np.where(seg_mask, np.maximum(base.times.numpy(), 0.05), 0).sum(1),
        rtol=1e-12)
    b = base.solved.numpy()
    assert res.solved.numpy()[b].all()
    assert (res.obj.numpy()[b] <= base.obj.numpy()[b] * (1 + 1e-9)).all()


def test_plan_batch_mlp_gives_tokens_of_ones():
    """An MLP net has no stop tokens: plan_batch returns ones, as the JAX
    plan_batch does (f64 both sides)."""
    cfg, jcfg = QPConfig(res=10), JQPConfig(res=10)
    budget = dict(n_chunks=2, iters_per_chunk=75)
    sc = scenarios.random_scenarios(cfg, 4, seed=5, min_seg=1)
    jnet = JConvMLPAllocNet(seg=5, seq_len=5, hidden_size=32)
    jparams = jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, 9, 2)),
                        jnp.zeros((1, 50, 4, 5)))
    jparams = jax.tree.map(lambda a: jnp.asarray(np.float32(a), jnp.float64),
                           jparams)
    net = ConvMLPAllocNet(seg=5, seq_len=5, hidden_size=32)
    net.load_state_dict(weights.from_jax_params(
        jax.tree.map(np.asarray, jparams)))
    res = pipeline.plan_batch(net.double(), cfg, SolverConfig(**budget),
                              sc.state, sc.hpolys, sc.seg, device="cpu")
    jres = jax.tree.map(np.asarray, jpipeline.plan_batch(
        jnet, jparams, jcfg, JSolverConfig(**budget), jnp.asarray(sc.state),
        jnp.asarray(sc.hpolys), jnp.asarray(sc.seg)))
    assert torch.equal(res.tokens, torch.ones((4, 5), dtype=torch.float64))
    np.testing.assert_array_equal(res.tokens.numpy(), jres.tokens)
    np.testing.assert_allclose(res.times.numpy(), jres.times, rtol=1e-12)
    np.testing.assert_array_equal(res.solved.numpy(), jres.solved)


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
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.evaluate(_net(), config.TRAIN, sc)
    loader = dataset.Loader(sc, batch_size=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.Trainer(config.TRAIN, _net(), loader, "unused-workdir")


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither JAX, flax,
    msgpack, h5py nor the JAX package."""
    code = (
        "import sys, pkgutil, importlib, allocnet_tpu_torch\n"
        "for m in pkgutil.walk_packages(allocnet_tpu_torch.__path__, "
        "'allocnet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = ['ops.qp_diff', 'planner.refine', 'planner.trajectory', "
        "'train.losses', 'train.train_step', 'train.dataset', "
        "'train.trainer', 'train.evaluate', 'ops.voxel', 'ops.lp', "
        "'ops.lbfgs', 'ops.mvie', 'ops.firi', 'planner.native', "
        "'planner.rrt', 'planner.sfc', 'planner.planner', "
        "'planner.flatness', 'planner.control', 'planner.replan', "
        "'planner.driver', 'train.datagen', 'utils.pcd', 'utils.timing', "
        "'models.export', 'models.import_torch', 'parallel.mesh', "
        "'parallel.scaling', 'viz.artifacts', 'cli']\n"
        "missing = [m for m in new if 'allocnet_tpu_torch.' + m not in "
        "sys.modules]\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'msgpack', 'h5py', 'allocnet_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, env=env,
                   timeout=120)
