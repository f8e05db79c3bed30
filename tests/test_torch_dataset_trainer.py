"""Port parity, data and the training loop: allocnet_tpu_torch.train's
dataset, trainer and evaluate against allocnet_tpu.train's (CPU): the HDF5
layout both ways, the loader's batches, one epoch of the Trainer in f32
from the same weights, checkpoint and resume, the evaluation report, and
the committed runs/synth_comb checkpoint loaded by the port."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allocnet_tpu import config as jconfig
from allocnet_tpu.models import import_torch
from allocnet_tpu.models.networks import ConvLSTMAllocNet as JConvLSTM
from allocnet_tpu.train import dataset as jds
from allocnet_tpu.train import evaluate as jevaluate
from allocnet_tpu.train import trainer as jtrainer
from allocnet_tpu.utils import scenarios as jscenarios
from allocnet_tpu_torch import config
from allocnet_tpu_torch.models import weights
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.train import dataset as ds
from allocnet_tpu_torch.train import evaluate, trainer
from allocnet_tpu_torch.utils import scenarios
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = config.QPConfig(res=10)
STEP_KEYS = {"epoch", "step", "obj", "obj1", "objt", "objc", "stop",
             "success_rate", "time_segment_accuracy"}


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_h5_roundtrip_both_ways(tmp_path):
    sc = scenarios.random_scenarios(CFG, 6, seed=51, min_seg=1)
    ds.write_h5(str(tmp_path / "port.h5"), sc)
    jds.write_h5(str(tmp_path / "jax.h5"), sc)
    for name in ("port.h5", "jax.h5"):
        back = ds.read_h5(str(tmp_path / name), CFG)
        _equal(back, jds.read_h5(str(tmp_path / name), jconfig.QPConfig(res=10)))
        _equal(back, sc)
        assert back.seg.dtype == np.int32


def test_build_synthetic_and_read_many(tmp_path):
    jcfg = jconfig.QPConfig(res=10)
    for k in range(2):
        ds.build_synthetic(str(tmp_path / "shards" / f"p{k}.h5"), CFG, 4,
                           seed=k)
        jds.build_synthetic(str(tmp_path / f"j{k}.h5"), jcfg, 4, seed=k)
        _equal(ds.read_h5(str(tmp_path / "shards" / f"p{k}.h5"), CFG),
               jds.read_h5(str(tmp_path / f"j{k}.h5"), jcfg))
    many = ds.read_h5_many(str(tmp_path / "shards"), CFG)
    _equal(many, jds.read_h5_many([str(tmp_path / f"j{k}.h5")
                                   for k in range(2)], jcfg))
    assert many.state.shape[0] == 8


@pytest.mark.parametrize("batch_size, train_ratio", [(4, 0.9), (7, 0.75)])
def test_loader_matches_jax(batch_size, train_ratio):
    """The same split and the same shuffled batches as the JAX loader; at
    (7, 0.75) both splits end in a partial batch, which is dropped."""
    sc = scenarios.random_scenarios(CFG, 40, seed=53, min_seg=1)
    kw = dict(batch_size=batch_size, train_ratio=train_ratio, seed=3)
    a, b = ds.Loader(sc, **kw), jds.Loader(sc, **kw)
    np.testing.assert_array_equal(a.train_idx, b.train_idx)
    np.testing.assert_array_equal(a.val_idx, b.val_idx)
    for epoch in (0, 1):
        for split in ("train", "val"):
            got = list(a.epoch(epoch, split))
            want = list(b.epoch(epoch, split))
            assert len(got) == len(want)
            for x, y in zip(got, want):
                _equal(x, y)
    n_train = int(40 * train_ratio)
    assert len(list(a.epoch(0))) == n_train // batch_size
    assert len(list(a.epoch(0, "val"))) == (40 - n_train) // batch_size


def _tiny_cfg(mod, res, **solver):
    return mod.AllocNetConfig(
        qp=mod.QPConfig(order=4, res=res),
        solver=mod.SolverConfig(**solver),
        train=mod.TrainConfig(batch_size=4, max_epochs=1, save_freq=1),
        model=mod.ModelConfig(hidden_size=16))


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_trainer_checkpoint_and_resume(tmp_path):
    cfg = _tiny_cfg(config, 5, n_chunks=1, iters_per_chunk=30)
    sc = scenarios.random_scenarios(cfg.qp, 12, seed=55, min_seg=1)
    loader = ds.Loader(sc, batch_size=4, train_ratio=0.75, seed=0)
    wd = str(tmp_path / "run")
    torch.manual_seed(0)
    tr = trainer.Trainer(cfg, ConvLSTMAllocNet(5, 16, 0.42), loader, wd,
                         device="cpu")
    net = tr.train(max_epochs=1)
    assert tr.step == 2
    recs = _records(tr.log_path)
    assert [set(r) for r in recs[:2]] == [STEP_KEYS] * 2
    assert all(np.isfinite(r["obj"]) for r in recs[:2])
    assert recs[-1].keys() == {"epoch", "wall_s"}
    ck = trainer.latest_checkpoint(tr.ckpt_dir)
    assert ck is not None and ck.endswith("checkpoint2.pt")

    # resume: a fresh Trainer over another net picks up the weights, the
    # optimizer, the schedule and the step counter
    tr2 = trainer.Trainer(cfg, ConvLSTMAllocNet(5, 16, 0.42), loader, wd,
                          device="cpu")
    assert (tr2.step, tr2.start_epoch) == (2, 1)
    for k, v in net.state_dict().items():
        assert torch.equal(tr2.net.state_dict()[k], v)
    assert tr2.lr_sched.last_epoch == 2
    assert tr2.opt.state_dict()["state"][0]["step"] == 2
    tr2.train(max_epochs=2)
    assert tr2.step == 4
    assert trainer.latest_checkpoint(tr2.ckpt_dir).endswith("checkpoint4.pt")


def test_trainer_epoch_matches_jax(tmp_path):
    """One epoch (3 steps of 4, one validation batch) in f32 from the same
    weights.  use_pallas=False on both sides: both run the plain ADMM
    scan (the port's chunk path would apply Kx^T with f64 sums, ~1% per
    iteration apart from the scan).  f32 rounding in another order: the
    losses agree to rtol 1e-4.  Adam divides each gradient by its own
    running RMS, so every weight moves by ~lr per step whatever its
    gradient's size; the f32 gradients of near-zero entries differ by up
    to ~1% between the two summation orders, so the weights agree to
    3 steps x lr (1e-3) x 1% = 3e-5."""
    solver = dict(n_chunks=2, iters_per_chunk=60, use_pallas=False)
    cfg = _tiny_cfg(config, 10, **solver)
    jcfg = _tiny_cfg(jconfig, 10, **solver)
    sc = scenarios.random_scenarios(cfg.qp, 16, seed=57, min_seg=1)
    f32 = scenarios.ScenarioBatch(*(a.astype(np.float32) if a.dtype.kind == "f"
                                    else a for a in sc))
    kw = dict(batch_size=4, train_ratio=0.75, seed=0)

    jnet = JConvLSTM(seq_len=5, hidden_size=16, token_thresh=0.42)
    jtr = jtrainer.Trainer(jcfg, jnet, jds.Loader(f32, **kw),
                           str(tmp_path / "jax"), use_mesh=False)
    # f32 weights with a time head at ~2 s per segment, so the QPs solve
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                          jtr.ts.params)
    params = {"params": dict(params["params"],
                             tf_b=jnp.full((1,), 2.0, jnp.float32))}
    jtr.ts = jtr.ts._replace(params=params, opt_state=jtrainer.ts_lib
                             .make_optimizer(jcfg.train).init(params))
    net = ConvLSTMAllocNet(5, 16, 0.42)
    net.load_state_dict(weights.from_jax_params(
        jax.tree.map(np.asarray, params)))
    tr = trainer.Trainer(cfg, net, ds.Loader(f32, **kw), str(tmp_path / "pt"),
                         device="cpu")
    jts = jtr.train(max_epochs=1)
    tr.train(max_epochs=1)

    got, want = _records(tr.log_path), _records(jtr.log_path)
    assert len(got) == len(want) == 5          # 3 steps, val, wall time
    for g, w in zip(got[:4], want[:4]):
        assert g.keys() == w.keys()
        for k in g:
            if k == "split":
                assert g[k] == w[k]
            elif k != "wall_s":
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6)
    assert any(r["success_rate"] > 0 for r in got[:3])
    want_sd = weights.from_jax_params(jax.tree.map(np.asarray, jts.params))
    for k, v in tr.net.state_dict().items():
        assert float((v - want_sd[k]).abs().max()) <= 3e-5, k


WEIGHTS = os.path.join(ROOT, "data/params/seq5_tokenthresh0_35.msgpack")


def test_evaluate_matches_jax():
    """The shipped seq5 net over 16 scenarios (seed 123: solved and
    unsolved ones) in f32: the same flags, counts and certificates; the
    objective mean to 1e-4 (f32 solves in another summation order)."""
    budget = dict(n_chunks=2, iters_per_chunk=75)
    cfg = config.AllocNetConfig(qp=config.QPConfig(res=10),
                                solver=config.SolverConfig(**budget),
                                model=config.ModelConfig(token_thresh=0.5))
    jcfg = jconfig.AllocNetConfig(qp=jconfig.QPConfig(res=10),
                                  solver=jconfig.SolverConfig(**budget),
                                  model=jconfig.ModelConfig(token_thresh=0.5))
    sc = scenarios.random_scenarios(cfg.qp, 16, seed=123, min_seg=1)
    net = ConvLSTMAllocNet(5, 256, 0.5)
    net.load_state_dict(weights.load_params(WEIGHTS))
    rep, ex = evaluate.evaluate(net, cfg, sc, batch_size=8, certify=True,
                                extras=True, device="cpu")
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                           import_torch.load_params_msgpack(WEIGHTS))
    jrep, jex = jevaluate.evaluate(
        JConvLSTM(seq_len=5, hidden_size=256, token_thresh=0.5), jparams,
        jcfg, jscenarios.ScenarioBatch(*sc), batch_size=8, certify=True,
        extras=True)
    assert 0 < rep.success_rate < 1
    for name in ("n", "success_rate", "stop_token_accuracy",
                 "time_segment_accuracy", "certified_frac",
                 "certified_of_solved"):
        assert getattr(rep, name) == getattr(jrep, name), name
    for name in ("mean_obj", "mean_time_ratio"):
        np.testing.assert_allclose(getattr(rep, name), getattr(jrep, name),
                                   rtol=1e-4)
    assert ex.keys() == jex.keys()
    for k in ("solved", "pred_seg", "certified"):
        np.testing.assert_array_equal(ex[k], jex[k])


def test_committed_checkpoint_loads_and_performs():
    """runs/synth_comb's trained checkpoint and dataset, read by the port
    alone (its msgpack reader and its HDF5 reader), hold the bars of
    tests/test_dataset_trainer.py::test_committed_artifact_loads_and_performs."""
    root = os.path.join(ROOT, "runs", "synth_comb")
    cfg = config.AllocNetConfig(
        qp=config.QPConfig(res=10, max_vel=5.0, max_acc=7.0),
        solver=config.SolverConfig(n_chunks=2, iters_per_chunk=100),
        model=config.ModelConfig(hidden_size=256))
    sc = ds.read_h5(os.path.join(root, "dataset.h5"), cfg.qp)
    loader = ds.Loader(sc, batch_size=32, seed=0)
    ck = os.path.join(root, "checkpoints", "checkpoint2575.msgpack")
    net = ConvLSTMAllocNet(5, 256, 0.42)
    net.load_state_dict(weights.load_params(ck))
    val = loader._gather(loader.val_idx[:32])
    vs = scenarios.ScenarioBatch(state=val.state, hpolys=val.hpolys,
                                 times=val.ref_times, seg=val.seg)
    rep = evaluate.evaluate(net, cfg, vs, batch_size=32, device="cpu")
    assert rep.n == 32
    assert rep.success_rate >= 0.3
    assert rep.stop_token_accuracy >= 0.5
