"""Port parity, the 50-mission drive eval: allocnet_tpu_torch.planner.
drive_eval against scripts/drive_eval.py and the JAX package's Driver, on
the CPU.

The missions are sampled as the script samples them (map 100, the shared
`default_rng(12345)`), the first is flown a few ticks by the port's
`fly_mission` and by the JAX driver, the cold-stall re-plan loop is driven
with a stub driver whose ticks never solve, and the summary's formulas
are checked on hand-built ticks."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from allocnet_tpu.config import AllocNetConfig as JAllocNetConfig
from allocnet_tpu.models import import_torch as jimport_torch
from allocnet_tpu.models.networks import ConvLSTMAllocNet as JConvLSTMAllocNet
from allocnet_tpu.planner import driver as jdriver
from allocnet_tpu.planner import planner as jplanner
from allocnet_tpu.train import datagen as jdatagen
from allocnet_tpu_torch import config
from allocnet_tpu_torch.models import import_torch
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.planner import drive_eval, driver, planner, sfc
from tests import native_runtime
from tests.test_torch_driver import COEF_TOL
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LO, HI = np.zeros(3), np.asarray(drive_eval.EXTENT)
# corridors in f64 on both sides: faces as sets to 1e-6 of the largest
# entry (tests/test_torch_corridor.py's ROW_TOL)
FACE_TOL = 1e-6
# ticks flown by both drivers: a cold tick and warm ones; the two ADMM
# cores differ by design (Kx against Kx^T), so each side flies on its own
# and the positions are held to tests/test_torch_driver.py's COEF_TOL of
# the largest coordinate (measured: about 1e-6 m apart after 8 ticks)
FLY_TICKS = 6


def _script():
    """scripts/drive_eval.py as a module (its main is not run)."""
    spec = importlib.util.spec_from_file_location(
        "drive_eval_script", os.path.join(ROOT, "scripts", "drive_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def missions():
    """The first 2 missions of map 100 from the script's sampler (JAX
    package, f64 under tests/conftest.py) and from the port's (CPU, f64),
    each from a fresh default_rng(RNG_SEED); and the port's map."""
    if not native_runtime.ensure_loaded():
        pytest.skip("g++ is not installed: no JAX native runtime")
    seed = drive_eval.MAP_SEED0
    jpm = jplanner.build_map(jdatagen.random_obstacle_map(
        seed, drive_eval.EXTENT), LO, HI, scale=0.25, dilate_r=2)
    jm = _script().sample_missions(
        jpm, JAllocNetConfig(), np.random.default_rng(drive_eval.RNG_SEED),
        2, LO, HI)
    pm = drive_eval.build_eval_map(seed, device="cpu")
    m = planner.sample_missions(
        pm, config.DEPLOY, np.random.default_rng(drive_eval.RNG_SEED), 2, LO,
        HI, device="cpu", dtype=torch.float64)
    return jm, m, pm


def test_sampled_missions_match_the_script(missions):
    """(a) the same starts, goals, segment counts and corridors."""
    jm, m, _ = missions
    assert len(jm) == len(m) == 2
    for (js, jcp), (s, goal, _, cp) in zip(jm, m):
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(cp.route[-1], jcp.route[-1])
        assert cp.seg == jcp.seg and cp.ok
        scale = max(1.0, float(np.abs(jcp.hpolys).max()))
        for i in range(cp.seg):
            assert (sfc.face_set_distance(cp.hpolys[i], jcp.hpolys[i])
                    <= FACE_TOL * scale), i


def test_fly_mission_matches_the_jax_driver(missions):
    """(b) the first mission, FLY_TICKS ticks, each side on its own
    corridor: the same solved and tracking flags per tick, positions
    within COEF_TOL of the largest coordinate."""
    jm, m, pm = missions
    js, jcp = jm[0]
    s, _, _, cp = m[0]
    net = drive_eval.NET
    jdrv = jdriver.Driver(JConvLSTMAllocNet(5, 256, token_thresh=0.5),
                          jimport_torch.load_params(net), JAllocNetConfig(),
                          rate_hz=10.0)
    jst = jdrv.reset(js, jcp.route[-1], jcp.hpolys, jcp.seg)
    _, jres = jdrv.run(jst, FLY_TICKS, stop_when_done=True,
                       stall_limit=drive_eval.STALL_LIMIT)
    drv = driver.Driver(ConvLSTMAllocNet(5, 256, token_thresh=0.5),
                        import_torch.load_params(net), config.DEPLOY,
                        rate_hz=10.0, device="cpu")
    rng = np.random.default_rng(0)
    state = rng.bit_generator.state
    fl = drive_eval.fly_mission(drv, pm, config.DEPLOY, s, cp, rng,
                                FLY_TICKS)
    assert rng.bit_generator.state == state         # no re-plan drawn
    assert fl.replans == 0 and len(fl.ticks) == len(jres) == FLY_TICKS
    assert fl.cold == [True] + [False] * (FLY_TICKS - 1)
    np.testing.assert_array_equal([r.solved for r in fl.ticks],
                                  [r.solved for r in jres])
    np.testing.assert_array_equal([r.tracking for r in fl.ticks],
                                  [r.tracking for r in jres])
    pos = np.array([r.state.pos for r in fl.ticks])
    jpos = np.array([np.asarray(r.state.pos) for r in jres])
    assert np.isfinite(pos).all()
    assert (float(np.abs(pos - jpos).max())
            <= COEF_TOL * max(1.0, float(np.abs(jpos).max())))
    assert np.linalg.norm(pos[-1] - s) > 0          # the vehicle moved


class _StallDriver:
    """A driver whose ticks never solve: each run stalls after
    `stall_limit` planless ticks (or fewer when n_ticks runs out)."""

    device = torch.device("cpu")

    def __init__(self):
        self.goals = []

    def reset(self, pos, goal, hpolys, seg):
        return driver.DriverState(
            pos=np.asarray(pos, float), vel=np.zeros(3), acc=np.zeros(3),
            hpolys=hpolys, seg=seg, goal=np.asarray(goal, float), prev=None)

    def set_goal(self, st, goal, hpolys, seg):
        self.goals.append(np.asarray(goal, float))
        return st._replace(goal=np.asarray(goal, float), hpolys=hpolys,
                           seg=seg)

    def run(self, st, n_ticks, stop_when_done=False, stall_limit=10):
        r = driver.TickResult(times=np.zeros(5), solved=False, state=st,
                              telemetry=None, latency_s=0.01)
        return st, [r] * min(n_ticks, stall_limit)


@pytest.mark.parametrize("ok,max_ticks,attempts,flown,n_ticks", [
    (False, 600, 20, 0, 5),        # no corridor found: 20 attempts
    (True, 600, 4, 4, 25),         # 4 flown re-plans, each stalls
    (True, 12, 2, 2, 12),          # the tick budget runs out first
])
def test_stall_loop(monkeypatch, ok, max_ticks, attempts, flown, n_ticks):
    """(c) attempts 1-3 with the online front-end budget, the rest with
    the offline one; one seed per attempt from the shared rng; stops at 4
    flown re-plans, 20 attempts or the tick budget."""
    calls = []
    start, goal = np.array([1.0, 2.0, 1.0]), np.array([18.0, 17.0, 2.0])
    cp = planner.CorridorPlan(np.array([start, goal]), np.zeros((5, 50, 4)),
                              2, True, "ok")

    def plan_corridor(pmap, s, g, cfg, seed=0, device=None, **kw):
        calls.append((np.array(s), np.array(g), cfg.corridor, seed))
        return cp._replace(ok=ok, route=np.array([s, g + 1.0]))

    monkeypatch.setattr(planner, "plan_corridor", plan_corridor)
    drv = _StallDriver()
    rng = np.random.default_rng(7)
    fl = drive_eval.fly_mission(drv, None, config.DEPLOY, start, cp, rng,
                                max_ticks)
    assert len(calls) == attempts and fl.replans == flown
    assert len(fl.ticks) == n_ticks and all(fl.cold)
    online = config.DEPLOY.corridor.online()
    for k, (s, g, ccfg, _) in enumerate(calls):
        assert ccfg == (online if k < 3 else config.DEPLOY.corridor)
        np.testing.assert_array_equal(s, start)
        np.testing.assert_array_equal(g, goal)     # the mission's goal
    ref = np.random.default_rng(7)
    assert [c[3] for c in calls] == [int(ref.integers(1 << 30))
                                     for _ in calls]
    assert rng.bit_generator.state == ref.bit_generator.state
    assert len(drv.goals) == flown


def _tick(solved, tracking=False, ms=10.0, rescue=0, certified=None,
          pos=(0.0, 0.0, 0.0)):
    st = driver.DriverState(pos=np.asarray(pos), vel=np.zeros(3),
                            acc=np.zeros(3), hpolys=None, seg=1,
                            goal=np.zeros(3), prev=None, done=False)
    return driver.TickResult(times=np.zeros(5), solved=solved, state=st,
                             telemetry=None, latency_s=ms / 1e3,
                             tracking=tracking, certified=certified,
                             rescue=rescue)


def test_summarize_gives_the_script_formulas():
    """(d) two hand-built missions through mission_record and summarize:
    the script's rates from raw counts, p50/p99 over every tick, and the
    split by stage."""
    done = lambda p, g: driver.DriverState(
        pos=np.asarray(p, float), vel=np.zeros(3), acc=np.zeros(3),
        hpolys=None, seg=1, goal=np.asarray(g, float), prev=None, done=True)
    cp = planner.CorridorPlan(np.array([[0.0, 0, 0], [5.0, 0, 0]]),
                              np.zeros((5, 50, 4)), 3, True, "ok")
    # mission 1: a planless cold tick, a solved cold tick, warm ticks (one
    # tracking, one light rescue, one heavy rescue); arrives
    t1 = [_tick(False, ms=150.0), _tick(True, ms=140.0, certified=True),
          _tick(True, ms=50.0, certified=True), _tick(False, True, 60.0),
          _tick(True, ms=120.0, rescue=1, certified=False),
          _tick(True, ms=200.0, rescue=2, certified=True)]
    c1 = drive_eval.cold_flags(t1)
    assert c1 == [True, True, False, False, False, False]
    f1 = drive_eval.Flight(done([5.0, 0, 0.1], [5.0, 0, 0]), t1, 1, c1)
    # mission 2: one cold tick, 40 warm ticks; stops 1 m short
    t2 = [_tick(True, ms=100.0, certified=True)] + [
        _tick(True, ms=30.0 + k, certified=True) for k in range(40)]
    f2 = drive_eval.Flight(done([4.0, 0, 0], [5.0, 0, 0]), t2, 0,
                           drive_eval.cold_flags(t2))
    ms = [drive_eval.mission_record(100, np.zeros(3), cp, f)
          for f in (f1, f2)]
    assert [m["arrived"] for m in ms] == [True, False]
    assert ms[0]["n_flight_ticks"] == 5 and ms[0]["n_flight_solved"] == 4
    assert ms[0]["corridor_replans"] == 1 and ms[0]["finite"]
    ticks = [(t, drive_eval.tick_stage(r, c)) for m in ms
             for t, r, c in zip(m["latency_ms"], m["rescue"], m["cold"])]
    out = drive_eval.summarize(ms, ticks, True, n_maps=1)
    lat = np.array([r.latency_s * 1e3 for r in t1 + t2])
    assert out["n_missions"] == 2 and out["arrival_rate"] == 0.5
    assert out["tick_solve_rate"] == pytest.approx(45 / 47, abs=1e-15)
    assert out["flight_tick_solve_rate"] == pytest.approx(45 / 46, abs=1e-15)
    assert out["flown_plan_certified_rate"] == pytest.approx(44 / 45,
                                                             abs=1e-15)
    assert drive_eval.summarize(ms, ticks, False, n_maps=1)[
        "flown_plan_certified_rate"] is None
    assert out["total_corridor_replans"] == 1
    assert out["wall_p50_ms"] == pytest.approx(np.percentile(lat, 50))
    assert out["wall_p99_ms"] == pytest.approx(np.percentile(lat, 99))
    assert out["final_dist_p50_m"] == pytest.approx(np.median([0.1, 1.0]))
    st = out["stages"]
    assert [st[s]["n"] for s in drive_eval.STAGES] == [3, 42, 1, 1]
    warm = lat[[2, 3] + list(range(7, 47))]
    np.testing.assert_allclose(st["warm"]["wall_p99_ms"],
                               np.percentile(warm, 99))
    np.testing.assert_allclose(st["cold"]["wall_p50_ms"], 140.0)
    # the warm p99 over the 44 ticks that are not cold lies between the
    # light rescue (120 ms) and the heavy one (200 ms): the tail is the
    # heavy rescue alone
    nc = np.concatenate([warm, [120.0, 200.0]])
    assert st["warm_p99_ms"] == pytest.approx(np.percentile(nc, 99))
    assert st["warm_tail_n"] == 1
    assert st["rescue_2"]["tail_share"] == 1.0
    assert st["cold"]["tail_share"] == st["warm"]["tail_share"] == 0.0
    # a warm p99 below the cold ticks: they join the tail
    split = drive_eval.stage_split([(10.0, "warm")] * 99 + [
        (90.0, "rescue_1"), (100.0, "cold"), (95.0, "cold")])
    assert split["warm_tail_n"] == 3
    assert split["cold"]["tail_share"] == pytest.approx(2 / 3)
    assert split["rescue_1"]["tail_share"] == pytest.approx(1 / 3)
    assert split["rescue_2"] == {"n": 0, "wall_p50_ms": None,
                                 "wall_p99_ms": None, "tail_share": 0.0}


def test_missions_matching_record(tmp_path):
    """Counted from the first mission to the first mismatch, start and
    goal to the record's 3 decimals; None without a record."""
    rec = [{"start": [1.0, 2.0, 3.0], "goal": [4.0, 5.0, 6.0], "seg": 2},
           {"start": [1.5, 2.0, 3.0], "goal": [4.0, 5.0, 6.0], "seg": 3},
           {"start": [0.0, 0.0, 0.0], "goal": [1.0, 1.0, 1.0], "seg": 1}]
    path = tmp_path / "drive_eval.json"
    path.write_text(json.dumps({"missions": rec}))
    ms = [dict(r) for r in rec]
    ms[0]["start"] = [1.0004, 2.0, 3.0]
    ms[2]["seg"] = 2
    assert drive_eval.missions_matching_record(ms, str(path)) == 2
    ms[1]["goal"] = [4.0, 5.002, 6.0]
    assert drive_eval.missions_matching_record(ms, str(path)) == 1
    assert drive_eval.missions_matching_record(
        ms, str(tmp_path / "absent.json")) is None


def test_main_on_the_cpu(tmp_path, capsys):
    """The entry point with --device cpu, one mission cut to 3 ticks: the
    output file and the last line (the summary without the missions); the
    mission is the JAX record's first."""
    out = tmp_path / "drive_eval.json"
    assert drive_eval.main(["1", "1", "3", "--device", "cpu", "--out",
                            str(out)]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    full = json.loads(out.read_text())
    assert "missions" not in last and len(full["missions"]) == 1
    assert last == {k: v for k, v in full.items() if k != "missions"}
    assert last["n_missions"] == 1 and full["missions"][0]["n_ticks"] == 3
    assert last["missions_matching_record"] == 1
    assert last["launches"]["cold"]["ticks"] == 1
    assert sum(last["stages"][s]["n"] for s in drive_eval.STAGES) == 3
    assert (tmp_path / "drive_eval_partial.jsonl").read_text().count(
        "\n") == 1


def test_entry_point_defaults_to_the_card():
    """(e) as tests/test_torch_driver.py's
    test_entry_points_default_to_the_card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drive_eval.run_eval(1, 1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drive_eval.main(["1", "1", "1"])


def test_no_jax_in_the_module():
    """The eval imports neither JAX nor the JAX package nor scripts/."""
    code = ("import sys; import allocnet_tpu_torch.planner.drive_eval; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'scripts' "
            "or m.startswith(('jax.', 'allocnet_tpu.', 'scripts.')) "
            "or m == 'allocnet_tpu']; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
