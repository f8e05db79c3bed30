"""The admm_chunk CUDA kernel on the card: against its plain PyTorch
version, and the solve and plan paths through it.  Skips without a CUDA
device.  Run on the card with

    python -m pytest tests/test_torch_gpu_kernel.py -m gpu --noconftest -o addopts=''

This file imports no JAX, so it runs where only PyTorch is installed."""

import os

import numpy as np
import pytest
import torch

from allocnet_tpu_torch.config import QPConfig, SolverConfig
from allocnet_tpu_torch.models import weights
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.ops import admm, admm_chunk, qp
from allocnet_tpu_torch.planner import pipeline
from allocnet_tpu_torch.utils import scenarios

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel vs plain: f32 sums in another order, amplified through cond(M) ~
# 1e4 (measured <= 1.25e-4 of each array's largest entry on an H100)
TOL = 5e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data(cfg, B, seed, dev):
    sc = scenarios.random_scenarios(cfg, B, seed=seed, min_seg=1)
    f32 = np.float32
    return sc, qp.build_qp(cfg, sc.state.astype(f32), sc.hpolys.astype(f32),
                           sc.times.astype(f32), sc.seg, device=dev)


def _chunk_args(data, scfg, seed):
    """A random primal/dual state (seeded) at the problem's initial rho."""
    B = data.times.shape[0]
    x, z, _ = admm.warm_start(data)
    g = torch.Generator().manual_seed(seed)
    y = {k: torch.randn(v.shape, generator=g).to(v.device) for k, v in z.items()}
    rho_i, _ = admm.initial_rho(data, scfg, torch.float32)
    rho_e = rho_i * scfg.rho_eq_scale
    M = qp.normal_matrix(data, scfg.sigma, rho_e, rho_i)
    kx = admm_chunk.fused_refined_inverse(M, admm.spd_inverse(M))
    aeq, beq, nrm, h, sm, basis = admm_chunk.pack_scenario(data)
    return (x.reshape(B, -1).contiguous(),
            admm_chunk.ineq_pack({k: z[k] for k in qp.INEQ_KEYS}),
            admm_chunk.ineq_pack({k: y[k] for k in qp.INEQ_KEYS}) / rho_i[:, None, None],
            (qp.tree_flat({k: y[k] for k in qp.EQ_KEYS}, qp.EQ_KEYS)
             / rho_e[:, None]).contiguous(),
            kx, aeq, beq, nrm, h, sm, rho_i.contiguous(), rho_e.contiguous(),
            basis)


@pytest.mark.gpu
@pytest.mark.parametrize("res,B,n_iters", [(10, 8, 1), (10, 64, 75),
                                           (20, 1024, 150)])
def test_kernel_matches_plain(cuda, res, B, n_iters):
    scfg = SolverConfig()
    _, data = _data(QPConfig(res=res), B, 7, cuda)
    args = _chunk_args(data, scfg, 7)
    before = admm_chunk.admm_chunk.launches
    got = admm_chunk.admm_chunk(*args, n_iters, scfg.sigma, scfg.alpha)
    torch.cuda.synchronize()
    assert admm_chunk.admm_chunk.launches == before + 1
    want = admm_chunk.admm_chunk_reference(*args, n_iters, scfg.sigma,
                                           scfg.alpha)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= TOL * scale


@pytest.mark.gpu
def test_kernel_rejects_mixed_devices(cuda):
    _, data = _data(QPConfig(res=4), 2, 0, cuda)
    args = list(_chunk_args(data, SolverConfig(), 0))
    args[4] = args[4].cpu()
    with pytest.raises(ValueError):
        admm_chunk.admm_chunk(*args, 2, 1e-6, 1.6)


@pytest.mark.gpu
def test_kernel_smem_needs_opt_in(cuda):
    # the deploy shape needs ~155 KB: above the 48 KB default, so the
    # launch must opt in to more dynamic shared memory
    assert 48 * 1024 < admm_chunk.smem_bytes(QPConfig()) <= 227 * 1024


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(res=60), dict(res=4, max_faces=60)])
def test_kernel_raises_on_a_shape_it_cannot_take(cuda, kw):
    """res=60: one scenario's state exceeds a block's shared memory;
    60 faces + 12 box slots exceed the 64 a row's warp handles.  The
    wrapper and solve_qp raise; nothing runs the plain version instead."""
    cfg, scfg = QPConfig(**kw), SolverConfig(n_chunks=1, iters_per_chunk=2)
    _, data = _data(cfg, 2, 0, cuda)
    before = admm_chunk.admm_chunk.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        admm_chunk.admm_chunk(*_chunk_args(data, scfg, 0), 2, scfg.sigma,
                              scfg.alpha)
    with pytest.raises(RuntimeError, match="launch failed"):
        admm.solve_qp(data, scfg)
    assert admm_chunk.admm_chunk.launches == before


@pytest.mark.gpu
def test_solve_on_the_card_takes_only_the_kernel(cuda):
    """f64, or use_pallas=False, would need the plain ADMM core: on the
    card solve_qp raises instead."""
    cfg, scfg = QPConfig(res=4), SolverConfig(n_chunks=1, iters_per_chunk=2)
    sc = scenarios.random_scenarios(cfg, 2, seed=0, min_seg=1)
    data64 = qp.build_qp(cfg, sc.state, sc.hpolys, sc.times, sc.seg,
                         device=cuda)
    with pytest.raises(TypeError):
        admm.solve_qp(data64, scfg)
    _, data = _data(cfg, 2, 0, cuda)
    with pytest.raises(ValueError):
        admm.solve_qp(data, SolverConfig(use_pallas=False))


@pytest.mark.gpu
def test_solve_on_the_card_matches_cpu(cuda):
    cfg, scfg = QPConfig(res=10), SolverConfig(n_chunks=2, iters_per_chunk=75)
    sc, data = _data(cfg, 16, 5, cuda)
    before = admm_chunk.admm_chunk.launches
    sol = admm.solve_qp(data, scfg)
    torch.cuda.synchronize()
    assert admm_chunk.admm_chunk.launches == before + scfg.n_chunks
    _, cdata = _data(cfg, 16, 5, "cpu")
    ref = admm.solve_qp(cdata, scfg)
    solved = sol.solved.cpu()
    # a scenario at the tolerance may flip between two f32 reductions
    assert int((solved == ref.solved).sum()) >= 15
    both = solved & ref.solved
    assert both.sum() >= 8
    assert float((sol.coeffs.cpu() - ref.coeffs)[both].abs().max()) <= 1e-3


@pytest.mark.gpu
def test_plan_batch_on_the_card(cuda):
    cfg, scfg = QPConfig(), SolverConfig()
    net = ConvLSTMAllocNet(5, 256, 0.5)
    net.load_state_dict(weights.load_params(
        os.path.join(ROOT, "data/params/seq5_tokenthresh0_35.msgpack")))
    sc = scenarios.random_scenarios(cfg, 64, seed=123, min_seg=1)
    before = admm_chunk.admm_chunk.launches
    res = pipeline.plan_batch(net.to(cuda), cfg, scfg, sc.state, sc.hpolys,
                              sc.seg)
    torch.cuda.synchronize()
    assert admm_chunk.admm_chunk.launches == before + scfg.n_chunks
    assert res.coeffs.shape == (64, 5, 3, 8) and res.coeffs.is_cuda
    assert torch.isfinite(res.coeffs).all()
    ref = pipeline.plan_batch(net.cpu(), cfg, scfg, sc.state, sc.hpolys,
                              sc.seg, device="cpu")
    torch.testing.assert_close(res.times.cpu(), ref.times, rtol=1e-4, atol=1e-5)
    assert int((res.solved.cpu() == ref.solved).sum()) >= 63
