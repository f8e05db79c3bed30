"""Port parity, data parallelism: parallel/mesh (initialize_distributed,
make_mesh, shard_batch, replicate), Trainer(use_mesh=True) and
parallel/scaling on the CPU.

Two processes train through DistributedDataParallel over gloo (a
`file://` rendezvous in the test's own directory, so parallel test
workers never share a port) and must end at the parameters of a
single-process replay of the same batches, as tests/test_dataset_trainer.py
holds the JAX mesh trainer to single-device steps.  In float64 the only
difference is the order of the gradient sums (each rank's half of the
batch, then the average): tolerance 1e-9 relative."""

import datetime
import os
import socket
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from allocnet_tpu.config import QPConfig as JQPConfig
from allocnet_tpu.config import SolverConfig as JSolverConfig
from allocnet_tpu.parallel import scaling as jscaling
from allocnet_tpu_torch.config import (AllocNetConfig, ModelConfig, QPConfig,
                                       SolverConfig, TrainConfig)
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.parallel import mesh, scaling
from allocnet_tpu_torch.train import dataset, train_step, trainer
from allocnet_tpu_torch.utils import scenarios
from tests.torch_threads import one_torch_thread  # noqa: F401

WORLD = 2
PARAM_RTOL = 1e-9
CFG = AllocNetConfig(qp=QPConfig(order=4, res=5),
                     solver=SolverConfig(n_chunks=1, iters_per_chunk=30),
                     train=TrainConfig(batch_size=8, max_epochs=1,
                                       save_freq=1),
                     model=ModelConfig(hidden_size=16))


def _setup():
    """The net (f64, a time head at ~2 s so that the QPs solve), and the
    loader of 24 scenarios in batches of 8."""
    torch.manual_seed(0)
    net = ConvLSTMAllocNet(5, 16, token_thresh=0.42)
    with torch.no_grad():
        net.tfs_output_layer.bias.fill_(2.0)
    sc = scenarios.random_scenarios(CFG.qp, 24, seed=57, min_seg=1)
    return net.double(), dataset.Loader(sc, batch_size=8, train_ratio=1.0,
                                        seed=0)


def _rank(rank, init, workdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    try:
        net, loader = _setup()
        tr = trainer.Trainer(CFG, net, loader,
                             os.path.join(workdir, f"rank{rank}"),
                             device="cpu")
        assert tr.mesh is not None and tr.mesh.size == WORLD
        tr.train(max_epochs=1)
        torch.save({"params": net.state_dict(), "step": tr.step},
                   os.path.join(workdir, f"params{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_two_ranks_train_as_one_process(tmp_path):
    init = f"file://{tmp_path / 'rendezvous'}"
    mp.spawn(_rank, args=(init, str(tmp_path)), nprocs=WORLD, join=True)
    got = [torch.load(tmp_path / f"params{r}.pt") for r in range(WORLD)]

    # the replay: one process, the whole batch per step
    net, loader = _setup()
    opt, sched = train_step.make_optimizer(net, CFG.train)
    steps = 0
    for b in loader.epoch(0, "train"):
        t = lambda a: torch.as_tensor(a, dtype=torch.float64)
        bundle = train_step.train_step(
            net, opt, sched, CFG.qp, CFG.solver, CFG.loss, t(b.state),
            t(b.hpolys), torch.as_tensor(b.seg).long(), t(b.ref_times),
            token_thresh=CFG.model.token_thresh)
        steps += 1
    assert float(bundle.success_rate) > 0
    assert got[0]["step"] == got[1]["step"] == steps == 3
    moved = 0.0
    start, _ = _setup()
    for k, v in net.state_dict().items():
        for g in got:
            torch.testing.assert_close(g["params"][k], v, rtol=PARAM_RTOL,
                                       atol=1e-12)
        moved = max(moved, float((v - start.state_dict()[k]).abs().max()))
    assert moved > 1e-4
    # rank 0 alone writes the metrics and the checkpoint
    assert os.path.exists(tmp_path / "rank0" / "metrics.jsonl")
    assert not os.path.exists(tmp_path / "rank1" / "metrics.jsonl")
    assert trainer.latest_checkpoint(str(tmp_path / "rank0" / "checkpoints"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_distributed(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.initialize_distributed() is False
    assert not dist.is_initialized()
    assert mesh.world() == (1, 0)
    # a configured launch whose master never answers: an error, not one
    # process training alone
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    with pytest.raises((RuntimeError, ValueError)):
        mesh.initialize_distributed(backend="gloo", timeout_s=2.0)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process group"):
        trainer.Trainer(CFG, ConvLSTMAllocNet(5, 16, 0.42), _setup()[1],
                        tempfile.mkdtemp(), device="cpu", use_mesh=True)


def test_mesh_helpers_in_one_process():
    m = mesh.make_mesh(device="cpu")
    assert (m.size, m.rank, m.device.type) == (1, 0, "cpu")
    a = np.arange(12.0).reshape(4, 3)
    out = mesh.shard_batch(m, {"a": a, "t": (torch.ones(4),)})
    assert torch.equal(out["a"], torch.from_numpy(a))
    assert torch.equal(mesh.replicate(m, [torch.ones(2)])[0], torch.ones(2))
    from torch.distributed.tensor import Replicate, Shard
    assert mesh.batch_sharding(m) == (Shard(0),)
    assert mesh.replicated(m) == (Replicate(),)
    with pytest.raises(ValueError):
        mesh.make_mesh(2, device="cpu")


def test_solve_scaling_returns_jax_keys():
    kw = dict(per_device_batch=4, device_counts=(1,))
    got = scaling.solve_scaling(cfg=QPConfig(res=5), scfg=SolverConfig(
        n_chunks=1, iters_per_chunk=30), device="cpu", **kw)
    want = jscaling.solve_scaling(cfg=JQPConfig(res=5), scfg=JSolverConfig(
        n_chunks=1, iters_per_chunk=30), **kw)
    assert set(got) == set(want)
    assert set(got[1]) == set(want[1])
    assert got[1]["batch"] == want[1]["batch"] == 4
    assert got[1]["efficiency"] == 1.0 and got[1]["solves_per_sec"] > 0
    assert got["platform"] == want["platform"] == "cpu"
