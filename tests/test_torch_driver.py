"""Port parity, the 10 Hz driver: allocnet_tpu_torch.planner.driver and
replan against allocnet_tpu's on the CPU.

The tick functions are fed the inputs that the JAX driver's own ticks got
on the mission of tests/test_driver.py (recorded once per module) and must
give the same `solved` flags and plans: the two CPU ADMM cores differ
slightly by design (Kx against Kx^T), so two missions left to run free
would drift apart, while one tick from one input stays within f32
roundoff.  The port then flies the same mission on its own with that
test's assertions."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allocnet_tpu.config import AllocNetConfig as JAllocNetConfig
from allocnet_tpu.config import CorridorConfig as JCorridorConfig
from allocnet_tpu.config import QPConfig as JQPConfig
from allocnet_tpu.config import SolverConfig as JSolverConfig
from allocnet_tpu.planner import driver as jdriver
from allocnet_tpu.planner import planner as jplanner
from allocnet_tpu.planner import replan as jreplan
from allocnet_tpu_torch.config import (AllocNetConfig, CorridorConfig,
                                       QPConfig, SolverConfig)
from allocnet_tpu_torch.ops import qp
from allocnet_tpu_torch.planner import driver, planner, replan
from allocnet_tpu_torch.utils import scenarios
from tests.test_driver import ConstTimeNet as JConstTimeNet
from tests.test_driver import _pillar_map
from tests.torch_threads import one_torch_thread  # noqa: F401

BUDGET = dict(n_chunks=4, polish_rounds=6, iters_per_chunk=250)
START = np.array([2.0, 3.0, 2.0])
GOAL1 = np.array([18.0, 3.0, 2.0])
GOAL2 = np.array([18.0, 17.0, 2.0])
LO, HI = [0, 0, 0], [20, 20, 4]
# one f32 tick from one input: the plans agree to f32 roundoff through a
# QP of condition ~1e4 (measured <= 5e-7 of the largest coefficient);
# bound 1e-4.  Multipliers are noisier at degenerate active sets
# (measured <= 1e-3 of the largest): bound 1e-2, which a wrong layout
# (swapped or shifted rows) exceeds by orders of magnitude
COEF_TOL = 1e-4
DUAL_TOL = 1e-2


class ConstTimeNet(torch.nn.Module):
    """The port's counterpart of tests/test_driver.py's stub: `t` seconds
    per segment."""

    def __init__(self, t: float, S: int):
        super().__init__()
        self.t, self.S = t, S

    def forward(self, state, hpolys):
        B = state.shape[0]
        return (torch.full((B, self.S), self.t, device=state.device),
                torch.ones((B, self.S), device=state.device))


def _cfg():
    return AllocNetConfig(qp=QPConfig(res=10), solver=SolverConfig(**BUDGET),
                          corridor=CorridorConfig(use_rrt_star=False))


def _jcfg():
    return JAllocNetConfig(qp=JQPConfig(res=10),
                           solver=JSolverConfig(**BUDGET),
                           corridor=JCorridorConfig(use_rrt_star=False))


def _t(a):
    return torch.as_tensor(np.array(a))


def _plan(p) -> driver.PlanState:
    """A JAX PlanState (numpy leaves) as the port's."""
    return driver.PlanState(_t(p.coeffs), _t(p.times), _t(p.have_prev),
                            {k: _t(v) for k, v in p.duals.items()})


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _assert_tick(out, jout):
    """Port tick output (solved, plan_c, times, adv[, stage]) against the
    JAX one."""
    solved, plan_c, times, adv = out[:4]
    jsolved, jplan_c, jtimes, jadv = jout[:4]
    np.testing.assert_array_equal(solved.numpy(), np.asarray(jsolved))
    assert _rel(plan_c.numpy(), jplan_c) <= COEF_TOL
    np.testing.assert_allclose(times.numpy(), np.asarray(jtimes), atol=1e-6)
    assert _rel(adv.state9.numpy(), jadv.state9) <= COEF_TOL
    assert _rel(adv.hpolys.numpy(), jadv.hpolys) <= 1e-6
    np.testing.assert_array_equal(adv.seg.numpy(), np.asarray(jadv.seg))
    np.testing.assert_array_equal(adv.done.numpy(), np.asarray(jadv.done))
    assert _rel(adv.prev.coeffs.numpy(), jadv.prev.coeffs) <= COEF_TOL
    np.testing.assert_allclose(adv.prev.times.numpy(),
                               np.asarray(jadv.prev.times), atol=1e-6)
    for k, v in adv.prev.duals.items():
        assert _rel(v.numpy(), jadv.prev.duals[k]) <= DUAL_TOL, k


@pytest.fixture(scope="module")
def jax_mission():
    """tests/test_driver.py's mission through the JAX driver, with every
    tick's (inputs, outputs) recorded: 5 ticks, a goal change, 5 ticks."""
    jcfg = _jcfg()
    pm = jplanner.build_map(_pillar_map(), LO, HI, scale=0.25, dilate_r=2)
    cp1 = jplanner.plan_corridor(pm, START, GOAL1, jcfg, seed=3)
    drv = jdriver.Driver(JConstTimeNet(), {"t": jnp.asarray(5.0), "S": 5},
                         jcfg, rate_hz=10.0)
    rec = {"cold": [], "tick": []}

    def recorder(kind, fn):
        def call(*args):
            out = fn(*args)
            rec[kind].append(jax.tree.map(np.asarray, (args, out)))
            return out
        return call

    drv._cold = recorder("cold", drv._cold)
    drv._tick = recorder("tick", drv._tick)
    st = drv.reset(START, cp1.route[-1], cp1.hpolys, cp1.seg)
    st, res1 = drv.run(st, 5)
    cp2 = jplanner.plan_corridor(pm, st.pos, GOAL2, jcfg, seed=5)
    st = drv.set_goal(st, cp2.route[-1], cp2.hpolys, cp2.seg)
    st, res2 = drv.run(st, 5)
    return drv, rec, res1 + res2


@pytest.fixture(scope="module")
def port_driver():
    return driver.Driver(ConstTimeNet(5.0, 5), None, _cfg(), rate_hz=10.0,
                         device="cpu")


def test_cold_ticks_match_jax(jax_mission, port_driver):
    _, rec, _ = jax_mission
    assert len(rec["cold"]) == 2
    for args, jout in rec["cold"]:
        out = port_driver._cold(*(_t(a) for a in args))
        assert bool(out[0][0])
        _assert_tick(out, jout)


def test_warm_ticks_match_jax(jax_mission, port_driver):
    """The combined tick (warm solve, rescue ladder on a miss) on every
    warm input of the mission; none missed, so stage 0 throughout."""
    _, rec, results = jax_mission
    assert len(rec["tick"]) == 8
    assert all(r.solved for r in results)
    for (state9, hp, seg, prev), jout in rec["tick"]:
        with torch.no_grad():
            out = port_driver._tick(_t(state9), _t(hp), _t(seg), _plan(prev))
        assert out[4] == 0
        _assert_tick(out, jout)


def test_warm_tick_sliver_split_matches_jax(jax_mission, port_driver):
    """The sliver split on the last recorded warm input: with sliver_ratio
    1.0 its first segment (4.6 s of 5 s) counts as a sliver, so piece 0 is
    frozen and the corridor from the real junction is re-solved."""
    drv, rec, _ = jax_mission
    (state9, hp, seg, prev), _ = rec["tick"][-1]
    assert prev.times[0, 0] < prev.times[0, 1]
    jtick = jax.jit(functools.partial(jdriver._warm_tick, drv.cfg_tick, 0.1,
                                      0, False, sliver_ratio=1.0))
    jout = jax.tree.map(np.asarray, jtick(state9, hp, seg, prev))
    with torch.no_grad():
        out = driver.make_warm_tick(port_driver.cfg_tick, 10.0,
                                    sliver_ratio=1.0)(
            _t(state9), _t(hp), _t(seg), _plan(prev))
    assert bool(out[0][0])
    _assert_tick(out, jout)
    # the frozen piece 0 is the previous plan's
    np.testing.assert_array_equal(out[1][0, 0].numpy(), prev.coeffs[0, 0])


def test_rescue_tick_matches_jax(jax_mission, port_driver):
    """The 4-lane rescue at the light budget (the split and the full
    problem, each warm and from scratch, as one batch of 4) on the same
    split input."""
    drv, rec, _ = jax_mission
    (state9, hp, seg, prev), _ = rec["tick"][-1]
    jlight = jreplan.rescue_solver_config(drv.cfg_tick.solver)
    jtick = jax.jit(functools.partial(jdriver._warm_tick, drv.cfg_tick, 0.1,
                                      0, True, sliver_ratio=1.0,
                                      rescue_scfg=jlight))
    jout = jax.tree.map(np.asarray, jtick(state9, hp, seg, prev))
    light = replan.rescue_solver_config(port_driver.cfg_tick.solver)
    with torch.no_grad():
        out = driver._warm_tick(port_driver.cfg_tick, 0.1, 0, True,
                                _t(state9), _t(hp), _t(seg), _plan(prev),
                                sliver_ratio=1.0, rescue_scfg=light)
    assert bool(out[0][0])
    _assert_tick(out, jout)


def test_solver_budgets_match_jax():
    for name in ("warm_solver_config", "rescue_solver_config",
                 "cold_solver_config"):
        for scfg, jscfg in ((SolverConfig(), JSolverConfig()),
                            (SolverConfig(**BUDGET), JSolverConfig(**BUDGET))):
            a = getattr(replan, name)(scfg)
            b = getattr(jreplan, name)(jscfg)
            assert {f: getattr(a, f) for f in a.__dataclass_fields__} == {
                f: getattr(b, f) for f in b.__dataclass_fields__}, name


def test_roll_advance_nudge_match_jax(jax_mission):
    """_roll_duals, _nudge_device and _advance in f64 on a recorded cold
    tick's plan, with a wide corridor and a corridor the point sits
    outside of: the same arithmetic to 1e-12."""
    _, rec, _ = jax_mission
    (state9, hp, seg), (_, plan_c, times, adv) = rec["cold"][0]
    duals = adv.prev.duals
    f64 = lambda a: np.asarray(a, np.float64)
    jf64 = lambda a: jnp.asarray(a, jnp.float64)
    cfg = AllocNetConfig(qp=QPConfig(res=10))
    jcfg = JAllocNetConfig(qp=JQPConfig(res=10))
    for dt in (0.1, 2.5, 4.97, 30.0):      # inside, near a junction, done
        out = driver._advance(cfg, dt, _t(f64(plan_c)), _t(f64(times)),
                              _t(f64(state9)), _t(f64(hp)), _t(seg),
                              {k: _t(f64(v)) for k, v in duals.items()})
        jout = jdriver._advance(jcfg, dt, jf64(plan_c), jf64(times),
                                jf64(state9), jf64(hp), jnp.asarray(seg),
                                {k: jf64(v) for k, v in duals.items()})
        leaves, jleaves = jax.tree.leaves(out), jax.tree.leaves(jout)
        assert len(leaves) == len(jleaves) == 12
        for a, b in zip(leaves, jleaves):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64),
                                       rtol=1e-12, atol=1e-12)
    src = np.array([[1, 2, 3, 4, 4], [0, 1, 2, 3, 4]])
    segn = np.array([3, 2])
    d2 = {k: np.concatenate([f64(v), 2.0 * f64(v)]) for k, v in duals.items()}
    for zero_first in (False, True):
        a = driver._roll_duals({k: _t(v) for k, v in d2.items()}, _t(src),
                               _t(segn), zero_first=zero_first)
        b = jdriver._roll_duals(d2, jnp.asarray(src), jnp.asarray(segn),
                                zero_first=zero_first)
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    p = np.array([[0.0, 0.0, 0.0], [30.0, 3.0, 9.0]])
    hp2 = np.concatenate([f64(hp)[:, 0], f64(hp)[:, 1]])
    np.testing.assert_allclose(
        driver._nudge_device(_t(hp2), _t(p)).numpy(),
        np.asarray(jdriver._nudge_device(jnp.asarray(hp2), jnp.asarray(p))),
        rtol=1e-12, atol=1e-12)


def test_host_helpers_match_jax():
    """trim_passed, nudge_inside and point_in_poly: the same NumPy code,
    equal results (tests/test_driver.py:116's corridor)."""
    def box(x0, x1):
        return np.array([[1, 0, 0, x1], [-1, 0, 0, -x0],
                         [0, 1, 0, 1.0], [0, -1, 0, 1.0],
                         [0, 0, 1, 1.0], [0, 0, -1, 1.0]], np.float64)
    hp = np.zeros((5, 8, 4))
    hp[0, :6] = box(0.0, 1.2)
    hp[1, :6] = box(0.8, 2.0)
    rng = np.random.default_rng(0)
    for p in [np.array([0.5, 0.0, 0.5]), np.array([1.5, 0.0, 0.5]),
              *rng.uniform(-1.5, 2.5, size=(20, 3))]:
        out, seg = driver.trim_passed(hp, 2, p)
        jout, jseg = jdriver.trim_passed(hp, 2, p)
        assert seg == jseg
        np.testing.assert_array_equal(out, jout)
        for i in range(2):
            assert (driver.point_in_poly(hp[i], p)
                    == jdriver.point_in_poly(hp[i], p))
            np.testing.assert_array_equal(driver.nudge_inside(hp[i], p),
                                          jdriver.nudge_inside(hp[i], p))
    assert driver.trim_passed(hp, 2, np.array([1.5, 0.0, 0.5]))[1] == 1


def test_qp_concat_matches_build_qp():
    cfg = QPConfig(res=10)
    a = scenarios.random_scenarios(cfg, 3, seed=5, min_seg=1)
    b = scenarios.random_scenarios(cfg, 2, seed=6, min_seg=2)
    da = qp.build_qp(cfg, a.state, a.hpolys, a.times, a.seg, device="cpu")
    db = qp.build_qp(cfg, b.state, b.hpolys, b.times, b.seg, device="cpu")
    cat = lambda x, y: np.concatenate([x, y])
    want = qp.build_qp(cfg, cat(a.state, b.state), cat(a.hpolys, b.hpolys),
                       cat(a.times, b.times), cat(a.seg, b.seg), device="cpu")
    got = qp.concat([da, db])
    assert got.cfg == want.cfg
    for name, g, w in zip(got._fields, got, want):
        if isinstance(w, torch.Tensor):
            # equal up to the last bit of a vectorized pow, whose lanes
            # depend on the batch size
            torch.testing.assert_close(g, w, rtol=1e-14, atol=0.0,
                                       msg=name)
    with pytest.raises(ValueError):
        qp.concat([da, qp.build_qp(QPConfig(res=20), a.state, a.hpolys,
                                   a.times, a.seg, device="cpu")])


def test_replan_step_warm_matches_cold():
    """tests/test_replan.py:16 through replan_step: a warm step at the
    reduced budget from the previous plan reaches the cold full-budget
    solution of a 2%-stretched allocation."""
    cfg = AllocNetConfig(qp=QPConfig(res=10),
                         solver=SolverConfig(n_chunks=2, iters_per_chunk=100))
    sc = scenarios.random_scenarios(cfg.qp, 4, seed=71, min_seg=2)

    class Fixed(torch.nn.Module):
        def forward(self, state, hpolys):
            return torch.as_tensor(sc.times, dtype=torch.float32)

    args = (sc.state, sc.hpolys, sc.seg)
    prev0 = replan.init_state(4, cfg, device="cpu")
    _, c0, s0, prev = replan.replan_step(Fixed(), None, cfg, *args, prev0,
                                         warm=False, device="cpu")
    assert s0.all() and prev.have_prev.all()
    _, cref, sref, _ = replan.replan_step(Fixed(), None, cfg, *args, prev0,
                                          time_scale=1.02, warm=False,
                                          device="cpu")
    t, cw, sw, prev2 = replan.replan_step(Fixed(), None, cfg, *args, prev,
                                          time_scale=1.02, device="cpu")
    both = (sref & sw).numpy()
    assert both.sum() >= 3
    assert float((cw - cref).abs().numpy()[both].max()) < 1e-3
    np.testing.assert_allclose(t.numpy()[0, :int(sc.seg[0])],
                               1.02 * sc.times[0, :int(sc.seg[0])],
                               rtol=1e-6)
    assert bool(prev2.have_prev.all())


def test_mission_through_the_port():
    """tests/test_driver.py:45 through the port alone, with that test's
    assertions: 5 ticks, a goal change, 5 ticks and a telemetry tick."""
    cfg = _cfg()
    pmap = planner.build_map(_pillar_map(), LO, HI, scale=0.25, dilate_r=2,
                             device="cpu")
    cp1 = planner.plan_corridor(pmap, START, GOAL1, cfg, seed=3,
                                device="cpu")
    assert cp1.ok, cp1.reason
    drv = driver.Driver(ConstTimeNet(5.0, cfg.qp.max_seg), None, cfg,
                        rate_hz=10.0, device="cpu")
    st = drv.reset(START, cp1.route[-1], cp1.hpolys, cp1.seg)

    st, res1 = drv.run(st, 5)
    solved1 = [r.solved for r in res1]
    assert solved1[0], "cold first plan must solve"
    assert any(solved1[1:]), solved1
    assert np.linalg.norm(st.pos - GOAL1) < np.linalg.norm(START - GOAL1)
    assert np.all(np.isfinite(st.pos)) and np.all(np.isfinite(st.vel))
    assert bool(st.prev.have_prev[0])                   # warm start armed

    cp2 = planner.plan_corridor(pmap, st.pos, GOAL2, cfg, seed=5,
                                device="cpu")
    assert cp2.ok, cp2.reason
    st = drv.set_goal(st, cp2.route[-1], cp2.hpolys, cp2.seg)
    assert not bool(st.prev.have_prev[0])               # warm start dropped

    pos_before = st.pos.copy()
    st, res2 = drv.run(st, 5)
    assert any(r.solved for r in res2)
    assert (np.linalg.norm(st.pos - GOAL2)
            < np.linalg.norm(pos_before - GOAL2))

    r = drv.tick(st, telemetry=True)
    if r.solved:
        tel = r.telemetry
        assert tel.thrust.shape == (1, 100)             # 1 kHz x 0.1 s
        assert np.all(tel.thrust.numpy() > 0)
        assert np.all(tel.speed.numpy() <= cfg.qp.max_vel * 1.2)


def test_plan_cold_pipelined_matches_split_path():
    """tests/test_driver.py:176: the pipelined corridor -> cold tick chain
    gives the same corridor and cold-tick decision as plan_corridor and a
    separate cold tick."""
    cfg = _cfg()
    pmap = planner.build_map(_pillar_map(), LO, HI, scale=0.25, dilate_r=2,
                             device="cpu")
    cold = driver.make_cold_tick(ConstTimeNet(5.0, cfg.qp.max_seg), cfg,
                                 None, rate_hz=10.0)
    ok, reason, route, hp, seg, solved, plan_c, times, adv = \
        planner.plan_cold_pipelined(pmap, START, GOAL1, cfg, cold, seed=3,
                                    device="cpu")
    assert ok, reason
    assert solved
    cp = planner.plan_corridor(pmap, START, GOAL1, cfg, seed=3, device="cpu")
    assert cp.ok and seg == cp.seg
    np.testing.assert_allclose(hp, cp.hpolys, atol=1e-6)
    np.testing.assert_allclose(route[-1], cp.route[-1], atol=1e-6)
    st9 = np.zeros((1, 2, 3, 3), np.float32)
    st9[0, 0, :, 0] = START
    st9[0, 1, :, 0] = cp.route[-1]
    solved2, _, times2, _ = cold(_t(st9), _t(cp.hpolys).float()[None],
                                 _t([cp.seg]))
    assert bool(solved2[0]) == solved
    np.testing.assert_allclose(times, times2.numpy(), atol=1e-5)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = _cfg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.Driver(ConstTimeNet(5.0, 5), None, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replan.init_state(1, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replan.replan_step(ConstTimeNet(5.0, 5), None, cfg,
                           np.zeros((1, 2, 3, 3)), np.zeros((1, 5, 50, 4)),
                           np.ones(1), replan.ReplanState(
                               torch.zeros(1, 5, 3, 8),
                               torch.zeros(1, dtype=torch.bool)))
    pmap = planner.build_map(_pillar_map(), LO, HI, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        planner.plan_cold_pipelined(pmap, START, GOAL1, cfg, None, seed=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        planner.plan_many(pmap, START[None], GOAL1[None], ConstTimeNet(5, 5),
                          None, cfg)
