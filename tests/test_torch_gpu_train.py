"""Training through the QP on the card: a training step against the same
step on the CPU's plain path, the kernel launches per differentiable
solve, and the admm_chunk kernel against its plain version at the training
shape.  Skips without a CUDA device.  Run on the card with

    python -m pytest tests/test_torch_gpu_train.py -m gpu --noconftest -o addopts=''

This file imports no JAX, so it runs where only PyTorch is installed."""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from allocnet_tpu_torch import config
from allocnet_tpu_torch.models import weights
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.ops import admm_chunk, qp
from allocnet_tpu_torch.planner import pipeline
from allocnet_tpu_torch.train import dataset, train_step, trainer
from allocnet_tpu_torch.utils import scenarios

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = config.TRAIN            # order 4, res 10, v <= 5, a <= 7; 3 x 150
B = 32                        # TrainConfig.batch_size
# kernel vs plain, of each array's largest entry (tests/test_torch_gpu_kernel.py)
TOL = 5e-4
# TRAIN at ten segments with the seq10 net (config.SEQ10's model)
CFG10 = dataclasses.replace(
    CFG, qp=dataclasses.replace(CFG.qp, max_seg=10), model=config.SEQ10.model)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _net():
    net = ConvLSTMAllocNet(5, 256, 0.5)
    net.load_state_dict(weights.load_params(
        os.path.join(ROOT, "data/params/seq5_tokenthresh0_35.msgpack")))
    return net


def _batch(dev, seed=123):
    sc = scenarios.random_scenarios(CFG.qp, B, seed=seed, min_seg=1)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    return (f(sc.state), f(sc.hpolys),
            torch.as_tensor(sc.seg, device=dev).long(), f(sc.times))


def _solved(net, batch):
    with torch.no_grad():
        _, _, sol, _ = train_step.forward(net, CFG.qp, CFG.solver,
                                          *batch[:3])
    return sol.solved.cpu()


@pytest.mark.gpu
def test_training_step_matches_cpu(cuda):
    """Loss and gradients of one training step at B=32, TRAIN, on the
    card (the kernel) and on the CPU (its plain version), from the same
    weights, over the scenarios whose solved flags agree (a scenario at
    the tolerance may flip between two f32 reductions: at most one of 32).
    f32 through a QP with cond ~1e4: losses to rtol 1e-3, each gradient
    tensor to 1e-2 of its largest entry."""
    net_c, net_g = _net(), _net().to(cuda)
    batch_c, batch_g = _batch("cpu"), _batch(cuda)
    keep = _solved(net_c, batch_c) == _solved(net_g, batch_g)
    assert int(keep.sum()) >= B - 1
    idx = torch.nonzero(keep)[:, 0]
    grads, totals = [], []
    for net, batch in ((net_c, batch_c), (net_g, batch_g)):
        sub = [t[idx.to(t.device)] for t in batch]
        total, bundle = train_step.loss_fn(
            net, CFG.qp, CFG.solver, CFG.loss, *sub, CFG.model.token_thresh)
        total.backward()
        totals.append(float(total.detach()))
        grads.append({k: p.grad.cpu() for k, p in net.named_parameters()})
        assert float(bundle.success_rate) > 0
    assert np.isfinite(totals).all()
    np.testing.assert_allclose(totals[1], totals[0], rtol=1e-3)
    for k, g in grads[0].items():
        assert torch.isfinite(grads[1][k]).all(), k
        scale = float(g.abs().max())
        assert float((grads[1][k] - g).abs().max()) <= 1e-2 * scale + 1e-8, k


@pytest.mark.gpu
def test_launches_per_differentiable_solve(cuda):
    """A training step's forward solve runs exactly n_chunks kernel
    launches; its backward (the implicit KKT system) runs none; a
    plan_batch with refine_steps=2 runs 5 differentiable or plain solves
    (the start point, the raw input, 2 steps, the final solve)."""
    net = _net().to(cuda)
    batch = _batch(cuda)
    n = CFG.solver.n_chunks
    before = admm_chunk.admm_chunk.launches
    total, _ = train_step.loss_fn(net, CFG.qp, CFG.solver, CFG.loss, *batch,
                                  CFG.model.token_thresh)
    torch.cuda.synchronize()
    assert admm_chunk.admm_chunk.launches == before + n
    total.backward()
    torch.cuda.synchronize()
    assert admm_chunk.admm_chunk.launches == before + n
    sc = scenarios.random_scenarios(CFG.qp, 16, seed=5, min_seg=1)
    before = admm_chunk.admm_chunk.launches
    res = pipeline.plan_batch(net, CFG.qp, CFG.solver, sc.state, sc.hpolys,
                              sc.seg, refine_steps=2)
    torch.cuda.synchronize()
    assert admm_chunk.admm_chunk.launches == before + 5 * n
    assert torch.isfinite(res.coeffs).all()


@pytest.mark.gpu
def test_kernel_matches_plain_at_training_shape(cuda):
    """One full chunk (150 iterations) at B=32, res=10, from the solve's
    own first-chunk inputs."""
    sc = scenarios.random_scenarios(CFG.qp, B, seed=123, min_seg=1)
    f32 = np.float32
    data = qp.build_qp(CFG.qp, sc.state.astype(f32), sc.hpolys.astype(f32),
                       sc.times.astype(f32), sc.seg, device=cuda)
    args = admm_chunk.chunk_inputs(data, CFG.solver)
    s = CFG.solver
    got = admm_chunk.admm_chunk(*args, s.iters_per_chunk, s.sigma, s.alpha)
    torch.cuda.synchronize()
    want = admm_chunk.admm_chunk_reference(*args, s.iters_per_chunk, s.sigma,
                                           s.alpha)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= TOL * scale


@pytest.mark.gpu
def test_training_on_the_card_takes_only_the_kernel(cuda):
    """An f64 net would need the plain ADMM core: on the card the
    training step raises instead of running it."""
    net = _net().double().to(cuda)
    batch = [t.double() if t.is_floating_point() else t
             for t in _batch(cuda)]
    with pytest.raises(TypeError):
        train_step.loss_fn(net, CFG.qp, CFG.solver, CFG.loss, *batch,
                           CFG.model.token_thresh)


@pytest.mark.gpu
def test_trainer_epoch_on_the_card(cuda, tmp_path):
    sc = scenarios.random_scenarios(CFG.qp, 80, seed=7, min_seg=1)
    loader = dataset.Loader(sc, batch_size=B, train_ratio=0.8, seed=0)
    net = _net()
    start = copy.deepcopy(net.state_dict())
    tr = trainer.Trainer(CFG, net, loader, str(tmp_path))
    before = admm_chunk.admm_chunk.launches
    tr.train(max_epochs=1)
    torch.cuda.synchronize()
    # 2 training steps of 32 and 0 validation batches (16 < 32)
    assert tr.step == 2
    assert admm_chunk.admm_chunk.launches == before + 2 * CFG.solver.n_chunks
    moved = max(float((p.cpu() - start[k]).abs().max())
                for k, p in tr.net.state_dict().items())
    assert 0 < moved < 1
    assert trainer.latest_checkpoint(tr.ckpt_dir).endswith("checkpoint2.pt")


@pytest.mark.gpu
def test_seq10_trainer_step_matches_cpu(cuda, tmp_path):
    """One Trainer step of the shipped seq10 net at max_seg=10 (TRAIN's QP
    and budget) on the card: n_chunks kernel launches, the weights move,
    and the step's loss is the card's loss of that batch; that loss and
    its gradients agree with the CPU's plain path as in
    test_training_step_matches_cpu (on the scenarios whose solved flags
    agree; losses to rtol 1e-3, gradients to 1e-2 of each tensor's
    largest entry)."""
    def net10():
        net = ConvLSTMAllocNet(10, 256, CFG10.model.token_thresh)
        net.load_state_dict(weights.load_params(
            os.path.join(ROOT, "data/params/seq10_rest2rest.msgpack")))
        return net

    sc = scenarios.random_scenarios(CFG10.qp, 40, seed=41, min_seg=1)
    loader = dataset.Loader(sc, batch_size=B, train_ratio=0.8, seed=0)
    first = next(loader.epoch(0))
    f = lambda a, dev: torch.as_tensor(a, dtype=torch.float32, device=dev)
    batches = {dev: (f(first.state, dev), f(first.hpolys, dev),
                     torch.as_tensor(first.seg, device=dev).long(),
                     f(first.ref_times, dev)) for dev in ("cpu", cuda)}
    nets = {"cpu": net10(), cuda: net10().to(cuda)}
    flags = {}
    for dev, net in nets.items():
        with torch.no_grad():
            flags[dev] = train_step.forward(net, CFG10.qp, CFG10.solver,
                                            *batches[dev][:3])[2].solved.cpu()
    keep = flags["cpu"] == flags[cuda]
    assert int(keep.sum()) >= B - 1
    idx = torch.nonzero(keep)[:, 0]
    grads, totals = [], []
    for dev, net in nets.items():
        sub = [t[idx.to(t.device)] for t in batches[dev]]
        total, _ = train_step.loss_fn(net, CFG10.qp, CFG10.solver, CFG10.loss,
                                      *sub, CFG10.model.token_thresh)
        total.backward()
        totals.append(float(total.detach()))
        grads.append({k: p.grad.cpu() for k, p in net.named_parameters()})
    assert np.isfinite(totals).all()
    np.testing.assert_allclose(totals[1], totals[0], rtol=1e-3)
    for k, g in grads[0].items():
        assert torch.isfinite(grads[1][k]).all(), k
        scale = float(g.abs().max())
        assert float((grads[1][k] - g).abs().max()) <= 1e-2 * scale + 1e-8, k

    net = net10().to(cuda)
    with torch.no_grad():
        card_total = float(train_step.loss_fn(
            net, CFG10.qp, CFG10.solver, CFG10.loss, *batches[cuda],
            CFG10.model.token_thresh)[0])
    start = copy.deepcopy(net.state_dict())
    tr = trainer.Trainer(CFG10, net, loader, str(tmp_path))
    before = admm_chunk.admm_chunk.launches
    tr.train(max_epochs=1)
    torch.cuda.synchronize()
    assert tr.step == 1          # one step of 32; 8 validation scenarios < 32
    assert admm_chunk.admm_chunk.launches == before + CFG10.solver.n_chunks
    with open(tr.log_path) as fh:
        step = [json.loads(line) for line in fh if '"step"' in line][0]
    assert abs(step["obj"] - card_total) <= 1e-4 * max(1.0, abs(card_total))
    moved = max(float((p.cpu() - start[k].cpu()).abs().max())
                for k, p in tr.net.state_dict().items())
    assert 0 < moved < 1
