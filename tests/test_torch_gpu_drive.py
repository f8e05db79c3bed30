"""The 10 Hz driver on the card: the admm_chunk kernel against its plain
version on the tick batches, and cold and warm ticks on the card against
the CPU's plain path from the same inputs.  Skips without a CUDA device.
Run on the card with

    python -m pytest tests/test_torch_gpu_drive.py -m gpu --noconftest -o addopts=''

This file imports no JAX, so it runs where only PyTorch is installed."""

import numpy as np
import pytest
import torch

from allocnet_tpu_torch.config import (AllocNetConfig, CorridorConfig,
                                       QPConfig, SolverConfig)
from allocnet_tpu_torch.ops import admm, admm_chunk, ldl, qp
from allocnet_tpu_torch.planner import driver, planner, replan
from allocnet_tpu_torch.utils import scenarios

# kernel vs plain: as tests/test_torch_gpu_kernel.py
TOL = 5e-4
# a tick on the card against the CPU's plain path from the same input:
# the same flags, plans to 1e-3 of the largest coefficient (the f32
# solve's bar)
PLAN_TOL = 1e-3
LO, HI = np.zeros(3), np.array([20.0, 20.0, 4.0])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


class ConstTimeNet(torch.nn.Module):
    def __init__(self, t: float, S: int):
        super().__init__()
        self.t, self.S = t, S

    def forward(self, state, hpolys):
        B = state.shape[0]
        return (torch.full((B, self.S), self.t, device=state.device),
                torch.ones((B, self.S), device=state.device))


def _pillar_map(seed=2):
    """tests/test_driver.py's map."""
    rng = np.random.default_rng(seed)
    pts = []
    for _ in range(3):
        c = rng.uniform([6, 6, 0], [14, 14, 0], size=3)
        for zz in np.linspace(0, 4, 20):
            ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
            pts.append(np.stack([c[0] + 0.3 * np.cos(ang),
                                 c[1] + 0.3 * np.sin(ang),
                                 np.full(8, zz)], axis=1))
    return np.concatenate(pts)


def _check_chunk(args):
    before = admm_chunk.admm_chunk.launches
    got = admm_chunk.admm_chunk(*args)
    torch.cuda.synchronize()
    assert admm_chunk.admm_chunk.launches == before + 1
    want = admm_chunk.admm_chunk_reference(*args)
    for name, g, w in zip(("x", "z", "yh", "yeh"), got, want):
        assert bool(torch.isfinite(g).all()), name
        err = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
        assert err <= TOL, (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,B,budget", [
    ("cold", 3, replan.cold_solver_config),
    ("warm", 1, replan.warm_solver_config),
    ("rescue", 4, replan.rescue_solver_config)])
def test_kernel_matches_plain_on_tick_batches(cuda, kind, B, budget):
    """The tick batches at DEPLOY shapes: the cold hedge (B=3, 250
    iterations from zero), a warm tick (B=1, 150 iterations from a solved
    primal and dual warm start) and a rescue batch (B=4, 150 iterations,
    two lanes warm and two from zero)."""
    cfg = QPConfig()
    scfg = budget(SolverConfig())
    sc = scenarios.random_scenarios(cfg, 4, seed=11, min_seg=2)
    f32 = np.float32

    def build(ix):
        return qp.build_qp(cfg, sc.state[ix].astype(f32),
                           sc.hpolys[ix].astype(f32),
                           sc.times[ix].astype(f32), sc.seg[ix], device=cuda)

    x0 = y0 = None
    if kind == "cold":
        data = build(np.arange(3))
    else:
        full = build(np.arange(4))
        sol = admm.solve_qp(full, SolverConfig())
        duals = driver._sol_duals(sol)
        # the warm lane: the scenario with active corridor rows
        ix = (np.arange(4) if kind == "rescue" else
              np.array([int(duals["corr"].abs().amax((1, 2, 3)).argmax())]))
        data = build(ix)
        x0 = qp.scale_coeffs(data, sol.coeffs[ix])
        y0 = {k: v[ix] for k, v in duals.items()}
        if kind == "rescue":
            keep = (torch.arange(B, device=cuda) % 2 == 0).float()
            x0 = x0 * keep[:, None, None, None]
            y0 = {k: v * keep.reshape((-1,) + (1,) * (v.ndim - 1))
                  for k, v in y0.items()}
    assert data.times.shape[0] == B
    args = admm_chunk.chunk_inputs(data, scfg, x0, y0)
    if kind == "warm":
        assert bool(args[0].any()) and bool(args[2].any())
    _check_chunk(args + (scfg.iters_per_chunk, scfg.sigma, scfg.alpha))


def _mission_cfg():
    return AllocNetConfig(qp=QPConfig(res=10),
                          solver=SolverConfig(n_chunks=4, polish_rounds=6,
                                              iters_per_chunk=250),
                          corridor=CorridorConfig(use_rrt_star=False))


def _assert_same_tick(out, ref):
    assert bool(out[0][0]) == bool(ref[0][0])
    c, rc = out[1].cpu().numpy(), ref[1].numpy()
    assert np.abs(c - rc).max() <= PLAN_TOL * max(1.0, np.abs(rc).max())
    np.testing.assert_allclose(out[2].cpu().numpy(), ref[2].numpy(),
                               atol=1e-6)
    s9, rs9 = out[3].state9.cpu().numpy(), ref[3].state9.numpy()
    assert np.abs(s9 - rs9).max() <= PLAN_TOL * max(1.0, np.abs(rs9).max())


@pytest.mark.gpu
def test_cold_and_warm_tick_match_cpu(cuda):
    """tests/test_driver.py's mission: the cold tick and the first warm
    tick on the card against the CPU plain path from the same inputs, and
    the kernel launched by each (4 per cold tick, 1 per solved warm
    tick)."""
    cfg = _mission_cfg()
    pmap = planner.build_map(_pillar_map(), LO, HI, device=cuda)
    cp = planner.plan_corridor(pmap, np.array([2.0, 3.0, 2.0]),
                               np.array([18.0, 3.0, 2.0]), cfg, seed=3,
                               device=cuda)
    assert cp.ok, cp.reason
    net = ConstTimeNet(5.0, cfg.qp.max_seg)
    gpu = driver.Driver(net, None, cfg, device=cuda)
    cpu = driver.Driver(net, None, cfg, device="cpu")
    st = gpu.reset(np.array([2.0, 3.0, 2.0]), cp.route[-1], cp.hpolys, cp.seg)
    state9 = torch.as_tensor(gpu._pack_state9(st))
    hp = torch.as_tensor(cp.hpolys, dtype=torch.float32)[None]
    seg = torch.tensor([cp.seg])

    n0 = admm_chunk.admm_chunk.launches
    out = gpu._cold(state9.to(cuda), hp.to(cuda), seg.to(cuda))
    torch.cuda.synchronize()
    assert admm_chunk.admm_chunk.launches - n0 == 4
    ref = cpu._cold(state9, hp, seg)
    assert bool(out[0][0])
    _assert_same_tick(out, ref)

    adv = out[3]
    prev_cpu = driver.PlanState(
        adv.prev.coeffs.cpu(), adv.prev.times.cpu(), adv.prev.have_prev.cpu(),
        {k: v.cpu() for k, v in adv.prev.duals.items()})
    n0 = admm_chunk.admm_chunk.launches
    l0 = ldl.ldl_block.launches
    with torch.no_grad():
        wout = gpu._tick(adv.state9, adv.hpolys, adv.seg, adv.prev)
        torch.cuda.synchronize()
        wref = cpu._tick(adv.state9.cpu(), adv.hpolys.cpu(), adv.seg.cpu(),
                         prev_cpu)
    assert wout[4] == wref[4] == 0
    assert admm_chunk.admm_chunk.launches - n0 == 1
    # the warm tick's polish factors through the LDL^T block kernel
    assert ldl.ldl_block.launches - l0 > 0
    _assert_same_tick(wout, wref)


@pytest.mark.gpu
def test_mission_on_the_card(cuda):
    """tests/test_driver.py's first leg on the card: 5 ticks from a cold
    plan, every one solved and moving toward the goal."""
    cfg = _mission_cfg()
    start, goal = np.array([2.0, 3.0, 2.0]), np.array([18.0, 3.0, 2.0])
    pmap = planner.build_map(_pillar_map(), LO, HI, device=cuda)
    cp = planner.plan_corridor(pmap, start, goal, cfg, seed=3, device=cuda)
    drv = driver.Driver(ConstTimeNet(5.0, cfg.qp.max_seg), None, cfg,
                        device=cuda, certify=True)
    st = drv.reset(start, cp.route[-1], cp.hpolys, cp.seg)
    st, res = drv.run(st, 5)
    assert all(r.solved for r in res)
    assert all(r.certified for r in res)
    assert np.linalg.norm(st.pos - goal) < np.linalg.norm(start - goal)
    assert np.isfinite(st.pos).all() and np.isfinite(st.vel).all()
    r = drv.tick(st, telemetry=True)
    assert r.telemetry.thrust.shape == (1, 100)
    assert bool((r.telemetry.thrust > 0).all())
