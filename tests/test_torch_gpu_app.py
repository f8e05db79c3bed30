"""The application layer on the card: dataset certification against the
CPU's plain path, the exported replanning step against the eager one, and
the admm_chunk kernel against its plain version at order 3 (min-jerk,
D=6).  Skips without a CUDA device.  Run on the card with

    python -m pytest tests/test_torch_gpu_app.py -m gpu --noconftest -o addopts=''

This file imports no JAX, so it runs where only PyTorch is installed."""

import numpy as np
import pytest
import torch

from allocnet_tpu_torch import config
from allocnet_tpu_torch.config import AllocNetConfig, QPConfig, SolverConfig
from allocnet_tpu_torch.models import export
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.ops import admm_chunk, qp
from allocnet_tpu_torch.planner import replan
from allocnet_tpu_torch.train import datagen
from allocnet_tpu_torch.utils import scenarios

# kernel vs plain: as tests/test_torch_gpu_kernel.py
TOL = 5e-4
# certify flags: a borderline sample's flag may flip between two f32
# reductions (chip_smoke.py holds each disagreement at DEPLOY to a
# rounding witness instead)
AGREE = 0.98
# the exported program runs the eager step's ops on the same card
PROGRAM_TOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_certify_on_the_card_matches_the_cpu(cuda):
    cfg = AllocNetConfig(qp=QPConfig(res=10))
    sc = scenarios.random_scenarios(cfg.qp, 64, seed=5, min_seg=1)
    admm_chunk.admm_chunk.launches = 0
    got = datagen.certified(cfg, sc, device=cuda)
    assert admm_chunk.admm_chunk.launches == config.CERTIFY_SOLVER.n_chunks
    want = datagen.certified(cfg, sc, device="cpu")
    assert (got == want).mean() >= AGREE
    assert got.sum() > 0


@pytest.mark.gpu
def test_exported_replan_step_on_the_card(cuda, tmp_path):
    cfg = AllocNetConfig(qp=QPConfig(res=10),
                         solver=SolverConfig(n_chunks=1, iters_per_chunk=30))
    torch.manual_seed(0)
    net = ConvLSTMAllocNet(5, 16, token_thresh=0.42)
    with torch.no_grad():
        net.tfs_output_layer.bias.fill_(2.0)
        net.stop_token_output_layer[0].bias.fill_(-5.0)
    export.save_replan(str(tmp_path), net, cfg, batch=2, device=cuda)
    program = export.load_replan(str(tmp_path))
    sc = scenarios.random_scenarios(cfg.qp, 2, seed=91, min_seg=2)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    prev = replan.init_state(2, cfg, device=cuda)
    seg = torch.as_tensor(sc.seg, dtype=torch.int32, device=cuda)
    admm_chunk.admm_chunk.launches = 0
    out = program(t(sc.state), t(sc.hpolys), seg, prev.coeffs,
                  prev.have_prev)
    torch.cuda.synchronize()
    assert admm_chunk.admm_chunk.launches == 1
    eager = replan.replan_step(net.to(cuda), None, cfg, t(sc.state),
                               t(sc.hpolys), seg, prev, device=cuda)
    assert torch.equal(out[2], eager[2])
    assert bool(eager[2].any())      # a solved, polished plan is compared
    scale = max(1.0, float(eager[1].abs().max()))
    assert float((out[1] - eager[1]).abs().max()) <= PROGRAM_TOL * scale


@pytest.mark.gpu
def test_kernel_at_order_3(cuda):
    cfg, scfg = config.jerk(QPConfig()), SolverConfig()
    sc = scenarios.random_scenarios(cfg, 64, seed=123, min_seg=1)
    f32 = np.float32
    data = qp.build_qp(cfg, sc.state.astype(f32), sc.hpolys.astype(f32),
                       sc.times.astype(f32), sc.seg, device=cuda)
    args = admm_chunk.chunk_inputs(data, scfg)
    it = scfg.iters_per_chunk
    got = admm_chunk.admm_chunk(*args, it, scfg.sigma, scfg.alpha)
    torch.cuda.synchronize()
    want = admm_chunk.admm_chunk_reference(*args, it, scfg.sigma, scfg.alpha)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= TOL * max(1.0,
                                                       float(w.abs().max()))
