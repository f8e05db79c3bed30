"""The admm_chunk CUDA kernel on the card: against its plain PyTorch
version, and the solve and plan paths through it.  Skips without a CUDA
device.  Run on the card with

    python -m pytest tests/test_torch_gpu_kernel.py -m gpu --noconftest -o addopts=''

This file imports no JAX, so it runs where only PyTorch is installed."""

import os
import re

import numpy as np
import pytest
import torch

from allocnet_tpu_torch import config
from allocnet_tpu_torch.config import (AllocNetConfig, CorridorConfig,
                                       QPConfig, SolverConfig)
from allocnet_tpu_torch.models import weights
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.ops import admm, admm_chunk, ldl, qp
from allocnet_tpu_torch.planner import pipeline, planner
from allocnet_tpu_torch.train import datagen
from allocnet_tpu_torch.utils import scenarios
from tests.oracle import qp_oracle

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
    """A random dual state (seeded) at the problem's initial rho."""
    _, z, _ = admm.warm_start(data)
    g = torch.Generator().manual_seed(seed)
    y = {k: torch.randn(v.shape, generator=g).to(v.device) for k, v in z.items()}
    return admm_chunk.chunk_inputs(data, scfg, None, y)


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
@pytest.mark.parametrize("res,order", [(20, 4), (10, 4), (20, 3), (10, 3)])
def test_kernel_matches_plain_at_ten_segments(cuda, res, order):
    """Ten segments (n = 240 at order 4, 180 at order 3), B=256 x 150
    iterations from a random dual state: at res 20 one block per SM (Kx's
    live block in shared memory where it fits, else in device memory), at
    res 10 two."""
    scfg = SolverConfig()
    cfg = QPConfig(res=res, max_seg=10, order=order)
    _, data = _data(cfg, 256, 7, cuda)
    args = _chunk_args(data, scfg, 7)
    before = admm_chunk.admm_chunk.launches
    got = admm_chunk.admm_chunk(*args, scfg.iters_per_chunk, scfg.sigma,
                                scfg.alpha)
    torch.cuda.synchronize()
    assert admm_chunk.admm_chunk.launches == before + 1
    want = admm_chunk.admm_chunk_reference(*args, scfg.iters_per_chunk,
                                           scfg.sigma, scfg.alpha)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= TOL * scale


@pytest.mark.gpu
@pytest.mark.parametrize("max_seg", [5, 10])
@pytest.mark.parametrize("kind", admm_chunk.CHECK_BATCHES)
def test_kernel_matches_plain_on_each_route(cuda, kind, max_seg):
    """res 20, B=1024 x 150 iterations, at the deploy shape and at ten
    segments, on batches that take each of the kernel's routes: padded
    segments and faces skipped (1 segment), nothing to skip but faces
    (every segment), nothing skipped and Kx read from device memory (full
    faces), skip checks failing on every other scenario (nonzero padded
    warm start)."""
    cfg, scfg = QPConfig(max_seg=max_seg), SolverConfig()
    args = admm_chunk.check_batch(kind, cfg, scfg, 1024, 11, cuda)
    got = admm_chunk.admm_chunk(*args, scfg.iters_per_chunk, scfg.sigma,
                                scfg.alpha)
    torch.cuda.synchronize()
    want = admm_chunk.admm_chunk_reference(*args, scfg.iters_per_chunk,
                                           scfg.sigma, scfg.alpha)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= TOL * scale


@pytest.mark.gpu
def test_kernel_build_has_no_spills_and_two_blocks_per_sm(cuda):
    report = admm_chunk.build()["ptxas"]
    spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", report)
    assert spills and all(int(v) == 0 for v in spills), report
    assert admm_chunk.blocks_per_sm(QPConfig()) >= 2


@pytest.mark.gpu
def test_blocks_per_sm_at_ten_segments(cuda):
    """At S = 10, res 20 the fixed part and one scenario's slots outgrow
    half an SM: one block per SM, with all the shared memory a block may
    opt in to; at res 10 two.  The deploy shape keeps two."""
    optin = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    assert admm_chunk.blocks_per_sm(QPConfig(max_seg=10)) == 1
    assert admm_chunk.smem_bytes(QPConfig(max_seg=10)) == optin // 4 * 4
    assert admm_chunk.blocks_per_sm(QPConfig(res=10, max_seg=10)) >= 2
    assert admm_chunk.blocks_per_sm(QPConfig()) >= 2


@pytest.mark.gpu
@pytest.mark.parametrize("max_seg,kind,want", [
    (5, "full_faces", {2}), (5, "one_segment", {0}),
    (10, "every_segment", {2}), (10, None, {0, 1, 2})])
def test_kx_modes_match_the_profile_build(cuda, max_seg, kind, want):
    """Where each block keeps Kx, as the profile build records it, equals
    `kx_modes`' rule: the deploy shape's full-faces batch reads Kx from
    device memory, a 1-segment batch keeps it as f64 in shared memory;
    at S = 10 every live segment sends Kx to device memory, and the mix of
    1 to 10 segments (B=256, seed 123) takes all three."""
    cfg, scfg = QPConfig(max_seg=max_seg), SolverConfig()
    if kind is None:
        data = _data(cfg, 256, 123, cuda)[1]
        args = admm_chunk.chunk_inputs(data, scfg)
    else:
        args = admm_chunk.check_batch(kind, cfg, scfg, 256, 11, cuda)
    modes = admm_chunk.kx_modes(*args)
    _, prof = admm_chunk.phase_cycles(*args, n_iters=2, sigma=scfg.sigma,
                                      alpha=scfg.alpha)
    np.testing.assert_array_equal(prof[:, 1, 0].numpy(), modes)
    assert set(modes.tolist()) == want


@pytest.mark.gpu
def test_ten_segment_paths_on_the_card(cuda):
    """solve_qp, plan_batch with the seq10 net and plan_many on the maze
    at max_seg=10 run through the kernel (n_chunks launches each) and
    agree with the CPU: solved flags on 63 of 64; where the coefficients
    of a scenario both solve differ by more than 1e-3, the card's are
    within 1e-3 of the f64 oracle; a maze plan of more than 5 segments
    solves."""
    cfg, scfg = config.SEQ10.qp, config.SEQ10.solver
    sc, data = _data(cfg, 64, 5, cuda)
    before = admm_chunk.admm_chunk.launches
    sol = admm.solve_qp(data, scfg)
    torch.cuda.synchronize()
    assert admm_chunk.admm_chunk.launches == before + scfg.n_chunks
    ref = admm.solve_qp(_data(cfg, 64, 5, "cpu")[1], scfg)
    solved = sol.solved.cpu()
    assert int((solved == ref.solved).sum()) >= 63
    both = solved & ref.solved
    assert bool((torch.as_tensor(sc.seg)[both] > 5).any())
    # where the two f32 solves land apart, the card is the one within
    # 1e-3 of the f64 oracle (where the oracle certifies its KKT point)
    diff = (sol.coeffs.cpu() - ref.coeffs).abs().flatten(1).amax(1)
    for b in torch.nonzero(both & (diff > 1e-3))[:, 0].tolist():
        L = int(sc.seg[b])
        ora = qp_oracle.solve_scenario(cfg, sc.state[b], sc.hpolys[b],
                                       sc.times[b], L)
        if ora["kkt"] < 1e-7:           # else the oracle is not certified
            assert np.abs(sol.coeffs[b, :L].cpu().numpy()
                          - ora["coeffs"]).max() <= 1e-3, b

    net = ConvLSTMAllocNet(10, 256, config.SEQ10.model.token_thresh)
    net.load_state_dict(weights.load_params(
        os.path.join(ROOT, "data/params/seq10_rest2rest.msgpack")))
    net = net.to(cuda)
    before = admm_chunk.admm_chunk.launches
    res = pipeline.plan_batch(net, cfg, scfg, sc.state, sc.hpolys, sc.seg)
    torch.cuda.synchronize()
    assert admm_chunk.admm_chunk.launches == before + scfg.n_chunks
    assert res.coeffs.shape == (64, 10, 3, 8)
    assert torch.isfinite(res.coeffs).all()

    mcfg = AllocNetConfig(
        qp=QPConfig(res=10, max_seg=10, max_vel=8.0, max_acc=12.0),
        solver=SolverConfig(n_chunks=2, iters_per_chunk=150),
        model=config.SEQ10.model, corridor=CorridorConfig(use_rrt_star=False))
    pmap = planner.build_map(datagen.maze_map(), np.zeros(3),
                             np.array([40.0, 20.0, 4.0]), device=cuda)
    before = admm_chunk.admm_chunk.launches
    starts = np.array([[2.0, 10.0, 2.0], [2.0, 17.0, 2.0]])
    goals = np.array([[38.0, 10.0, 2.0], [38.0, 3.0, 2.0]])
    out = planner.plan_many(pmap, starts, goals, net, None, mcfg,
                            dtype=torch.float64)
    torch.cuda.synchronize()
    assert admm_chunk.admm_chunk.launches == before + mcfg.solver.n_chunks
    segs = out.traj.seg_mask.sum(-1).cpu().numpy()
    assert (out.corridor_ok & out.result.solved.cpu().numpy()
            & (segs > 5)).any()


@pytest.mark.gpu
def test_kernel_bad_block_index_gives_nan(cuda):
    """An Aeq block index out of range: the plain version raises, the
    kernel writes NaN to that scenario and computes the others."""
    scfg = SolverConfig()
    _, data = _data(QPConfig(res=10), 4, 3, cuda)
    args = list(_chunk_args(data, scfg, 3))
    args[6] = args[6].clone()
    args[6][1, 5, 1] = 99
    got = admm_chunk.admm_chunk(*args, 5, scfg.sigma, scfg.alpha)
    torch.cuda.synchronize()
    for g in got:
        assert bool(torch.isnan(g[1]).all())
        assert bool(torch.isfinite(g[[0, 2, 3]]).all())
    with pytest.raises(RuntimeError):       # on the CPU: a scatter index error
        admm_chunk.admm_chunk_reference(*(a.cpu() for a in args), 5,
                                        scfg.sigma, scfg.alpha)


@pytest.mark.gpu
def test_kernel_rejects_mixed_devices(cuda):
    _, data = _data(QPConfig(res=4), 2, 0, cuda)
    args = list(_chunk_args(data, SolverConfig(), 0))
    args[4] = args[4].cpu()
    with pytest.raises(ValueError):
        admm_chunk.admm_chunk(*args, 2, 1e-6, 1.6)


@pytest.mark.gpu
def test_kernel_smem_needs_opt_in(cuda):
    # the deploy shape asks for ~113 KB (two blocks per SM): above the 48 KB
    # default, so the launch must opt in to more dynamic shared memory
    assert 48 * 1024 < admm_chunk.smem_bytes(QPConfig()) <= 227 * 1024


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(res=100), dict(res=40, max_seg=10),
                                dict(res=4, max_faces=60)])
def test_kernel_raises_on_a_shape_it_cannot_take(cuda, kw):
    """res=100 (S = 5) and res=40 at S = 10: the fixed part and one
    scenario's z / yh slots alone exceed what a block may opt in to (Kx
    could stay in device memory, the slots cannot); 60 faces + 12 box
    slots exceed the 64 a row's warp handles.  The wrapper and solve_qp
    raise; nothing runs the plain version instead."""
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
    ldl_before = ldl.ldl_block.launches
    sol = admm.solve_qp(data, scfg)
    torch.cuda.synchronize()
    assert admm_chunk.admm_chunk.launches == before + scfg.n_chunks
    # the polish factors through the LDL^T block kernel: 4 blocks each
    n_ldl = ldl.ldl_block.launches - ldl_before
    assert n_ldl > 0 and n_ldl % 4 == 0
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
