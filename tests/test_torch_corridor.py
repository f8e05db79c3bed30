"""Port parity, corridor front end: allocnet_tpu_torch's RRT (Python and
native), window crop, convex cover, shortcut, fused corridor, plan_corridor
and plan_many against allocnet_tpu's, on the CPU.  Corridor geometry runs
in f64 on both sides (the JAX side under tests/conftest.py's x64); routes
are the same NumPy code and the same C++ source, so they match exactly."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allocnet_tpu.config import AllocNetConfig as JAllocNetConfig
from allocnet_tpu.config import CorridorConfig as JCorridorConfig
from allocnet_tpu.config import QPConfig as JQPConfig
from allocnet_tpu.config import SolverConfig as JSolverConfig
from allocnet_tpu.models import import_torch
from allocnet_tpu.models.networks import ConvLSTMAllocNet as JConvLSTMAllocNet
from allocnet_tpu.planner import native as jnative
from allocnet_tpu.planner import planner as jplanner
from allocnet_tpu.planner import rrt as jrrt
from allocnet_tpu.planner import sfc as jsfc
from allocnet_tpu.train import datagen as jdatagen
from allocnet_tpu_torch.config import (AllocNetConfig, CorridorConfig,
                                       QPConfig, SolverConfig)
from allocnet_tpu_torch.models import weights
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.planner import native, planner, rrt, sfc
from allocnet_tpu_torch.train import datagen
from tests import native_runtime
from tests.test_driver import _pillar_map
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "data/params/seq5_tokenthresh0_35.msgpack")
LO, HI = np.zeros(3), np.array([20.0, 20.0, 4.0])
F64 = torch.float64
# f64 corridors: FIRI picks, MVIE and the IPM in the same arithmetic;
# rows to 1e-6 of the largest entry (measured: equal to the last bit on
# these maps)
ROW_TOL = 1e-6
# the same mission as tests/test_driver.py, through the pillar map there,
# plus a diagonal route that needs several windows
START = np.array([2.0, 3.0, 2.0])
GOALS = (np.array([18.0, 3.0, 2.0]), np.array([18.0, 17.0, 2.0]))


def _cfgs(**ccfg):
    return (AllocNetConfig(qp=QPConfig(res=10),
                           corridor=CorridorConfig(**ccfg)),
            JAllocNetConfig(qp=JQPConfig(res=10),
                            corridor=JCorridorConfig(**ccfg)))


@pytest.fixture(scope="module")
def maps():
    # the JAX runtime builds at first use; another worker may be building
    # it now (tests/native_runtime.py)
    if not native_runtime.ensure_loaded():
        pytest.skip("g++ is not installed: no JAX native runtime")
    pts = _pillar_map()
    pm = planner.build_map(pts, LO, HI, scale=0.25, dilate_r=2, device="cpu")
    jpm = jplanner.build_map(pts, LO, HI, scale=0.25, dilate_r=2)
    assert jpm.native is not None
    return pts, pm, jpm


@pytest.fixture(scope="module")
def diag_route(maps):
    """A Python-RRT route across the pillar field, simplified."""
    _, pm, _ = maps
    route = rrt.plan(START, GOALS[1], pm.surf, LO, HI, seed=3)
    assert route is not None
    return rrt.simplify(route, pm.surf, 0.5)


def test_map_matches_jax(maps):
    _, pm, jpm = maps
    np.testing.assert_array_equal(pm.surf, jpm.surf)
    np.testing.assert_array_equal(pm.grid.occ.numpy(),
                                  np.asarray(jpm.grid.occ))


@pytest.mark.parametrize("seed", [3, 5])
def test_python_rrt_matches_jax(maps, seed):
    _, pm, _ = maps
    a = rrt.plan(START, GOALS[1], pm.surf, LO, HI, seed=seed)
    b = jrrt.plan(START, GOALS[1], pm.surf, LO, HI, seed=seed)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rrt.simplify(a, pm.surf, 0.5),
                                  jrrt.simplify(b, pm.surf, 0.5))


@pytest.mark.parametrize("star", [False, True])
def test_native_routes_match_jax(maps, star):
    """The port's build of runtime/allocnet_native.cpp and the JAX
    package's: the same routes for the same seeds."""
    _, pm, jpm = maps
    ccfg = CorridorConfig(use_rrt_star=star, rrt_max_iter=1000)
    jccfg = JCorridorConfig(use_rrt_star=star, rrt_max_iter=1000)
    for seed in (3, 7):
        a = planner.search_route(pm, START, GOALS[1], ccfg, seed)
        b = jplanner.search_route(jpm, START, GOALS[1], jccfg, seed)
        np.testing.assert_array_equal(a, b)
    assert pm.native.blocked(pm.surf[0])
    assert not pm.native.blocked(START)


def test_crop_windows_native_matches_numpy(maps, diag_route):
    _, pm, _ = maps
    ccfg = CorridorConfig()
    _, los, his, _, _ = sfc._windows(diag_route, ccfg, LO, HI)
    a = native.crop_windows(pm.surf, los, his, 512)
    b = sfc._crop_windows(pm.surf, los, his, 512)
    c = jnative.crop_windows(pm.surf, los, his, 512)
    for x, y in ((a, b), (a, c)):
        np.testing.assert_array_equal(x[0], y[0])
        np.testing.assert_array_equal(x[1], y[1])
    assert b[1].sum() > 0


def test_build_map_without_native_takes_python_rrt(maps):
    pts, _, _ = maps
    pm = planner.build_map(pts, LO, HI, native=False, device="cpu")
    assert pm.native is None
    route = planner.search_route(pm, START, GOALS[0], CorridorConfig(), 3)
    want = rrt.simplify(rrt.plan(START, GOALS[0], pm.surf, LO, HI, seed=3),
                        pm.surf, 0.5)
    np.testing.assert_array_equal(route, want)


def test_native_build_failure_raises(monkeypatch):
    """No silent fallback: without g++ the native build raises."""
    native.build.cache_clear()
    native._load.cache_clear()
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR / "absent")
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            native.NativeGrid(np.zeros((1, 3)), LO, HI)
    finally:
        native.build.cache_clear()
        native._load.cache_clear()


RACERS = 4


def test_concurrent_runtime_builds_all_load(tmp_path):
    """The `maps` fixture's wait (tests/native_runtime.py) in RACERS
    processes started together on a fresh copy of runtime/ with no
    library: one builds it, and every one loads it."""
    if shutil.which(native_runtime.makefile_command(".", "x")[0]) is None:
        pytest.skip("g++ is not installed")
    rt = tmp_path / "runtime"
    rt.mkdir()
    for name in ("Makefile", "allocnet_native.cpp"):
        shutil.copy(os.path.join(native_runtime.RUNTIME, name), rt / name)
    go = tmp_path / "go"
    code = ("import os, time\n"
            "from tests import native_runtime\n"
            f"while not os.path.exists({str(go)!r}):\n"
            "    time.sleep(0.01)\n"
            f"print(native_runtime.ensure_loaded({str(rt)!r}))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(RACERS)]
    go.touch()
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * RACERS, outs
    assert [o.strip() for o, _ in outs] == ["True"] * RACERS, outs
    assert sorted(os.listdir(rt)) == ["Makefile", "allocnet_native.cpp",
                                      native_runtime.LIB]


def _rows_close(a, b):
    np.testing.assert_allclose(a, b, atol=ROW_TOL * max(1.0, np.abs(b).max()))


@pytest.fixture(scope="module")
def generic(maps, diag_route):
    """convex_cover -> short_cut -> normalize_polys on both sides."""
    _, pm, _ = maps
    ccfg, jccfg = CorridorConfig(), JCorridorConfig()
    cover = sfc.convex_cover(diag_route, pm.surf, LO, HI, ccfg, device="cpu",
                             dtype=F64)
    jcover = jsfc.convex_cover(diag_route, pm.surf, LO, HI, jccfg)
    cut = sfc.normalize_polys(sfc.short_cut(cover, device="cpu", dtype=F64))
    jcut = jsfc.normalize_polys(jsfc.short_cut(jcover))
    return cover, jcover, cut, jcut


def test_convex_cover_and_shortcut_match_jax(generic):
    cover, jcover, cut, jcut = generic
    assert len(cover) == len(jcover) >= 3
    for a, b in zip(cover, jcover):
        assert a.shape == b.shape
        _rows_close(a, b)
    assert len(cut) == len(jcut)
    for a, b in zip(cut, jcut):
        _rows_close(a, b)


def test_corridor_online_matches_jax_and_generic(maps, diag_route, generic):
    """The fused corridor: the same seg and rows as the JAX fused path and
    as the port's generic path (tests/test_planner.py:134)."""
    _, pm, _ = maps
    _, _, cut, _ = generic
    qcfg, ccfg = QPConfig(res=10), CorridorConfig()
    hp, seg, polys, goal_r = sfc.corridor_online(
        diag_route, pm.surf, LO, HI, ccfg, qcfg, device="cpu", dtype=F64)
    jhp, jseg, _, jgoal = jsfc.corridor_online(
        diag_route, pm.surf, LO, HI, JCorridorConfig(), JQPConfig(res=10))
    assert seg == jseg == len(cut)
    _rows_close(hp, jhp)
    np.testing.assert_allclose(goal_r, jgoal, atol=ROW_TOL)
    hp_ref, seg_ref = sfc.to_padded(cut, qcfg)
    assert seg == seg_ref
    _rows_close(hp, hp_ref)
    np.testing.assert_allclose(
        goal_r, sfc._refine_goal_host(diag_route, cut[-1])[-1], atol=1e-8)
    assert len(polys) == seg


@pytest.mark.parametrize("star", [False, True])
def test_plan_corridor_matches_jax(maps, star):
    """plan_corridor on the pillar map of tests/test_driver.py, both legs
    of its mission; the default (Informed RRT*) and plain RRT."""
    _, pm, jpm = maps
    cfg, jcfg = _cfgs(use_rrt_star=star, rrt_max_iter=1000)
    start = START
    for k, goal in enumerate(GOALS):
        cp = planner.plan_corridor(pm, start, goal, cfg, seed=3 + 2 * k,
                                   device="cpu", dtype=F64)
        jcp = jplanner.plan_corridor(jpm, start, goal, jcfg, seed=3 + 2 * k)
        assert (cp.ok, cp.reason, cp.seg) == (jcp.ok, jcp.reason, jcp.seg)
        assert cp.ok, cp.reason
        _rows_close(cp.hpolys, jcp.hpolys)
        np.testing.assert_allclose(cp.route, jcp.route, atol=ROW_TOL)
        start = cp.route[-1]


def test_plan_corridor_f32_matches_f64(maps):
    """The card's dtype: the same polytopes, face for face to 1e-4 of the
    largest entry.  Faces are compared as sets: the window box's symmetric
    faces tie exactly in FIRI's pick, and f32 rounding breaks the tie
    the other way on this route (a reordering of the same faces)."""
    _, pm, _ = maps
    cfg, _ = _cfgs(use_rrt_star=False)
    a = planner.plan_corridor(pm, START, GOALS[1], cfg, seed=3, device="cpu")
    b = planner.plan_corridor(pm, START, GOALS[1], cfg, seed=3, device="cpu",
                              dtype=F64)
    assert a.seg == b.seg
    tol = 1e-4 * np.abs(b.hpolys).max()
    for i in range(b.seg):
        assert sfc.face_set_distance(a.hpolys[i], b.hpolys[i]) <= tol, i


def test_entry_points_default_to_the_card(maps):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pts, pm, _ = maps
    cfg, _ = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        planner.build_map(pts, LO, HI)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        planner.plan_corridor(pm, START, GOALS[0], cfg, seed=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sfc.corridor_online(np.stack([START, GOALS[0]]), pm.surf, LO, HI,
                            cfg.corridor, cfg.qp)


def test_plan_many_matches_jax():
    """plan_many with the shipped seq5 net on an obstacle map: corridors
    (f64 on both sides, then f32 into the net), network times and solve
    flags as the JAX plan_many; coefficients to 1e-3 on the solved set
    (the f32 solve's bar, tests/test_torch_solve.py)."""
    pts = datagen.random_pillar_map(3)
    np.testing.assert_array_equal(pts, jdatagen.random_pillar_map(3))
    budget = dict(n_chunks=2, iters_per_chunk=75)
    cfg = AllocNetConfig(qp=QPConfig(res=10), solver=SolverConfig(**budget))
    jcfg = JAllocNetConfig(qp=JQPConfig(res=10),
                           solver=JSolverConfig(**budget))
    pm = planner.build_map(pts, LO, HI, device="cpu")
    jpm = jplanner.build_map(pts, LO, HI)
    starts = np.array([[1.0, 1.0, 1.5], [2.0, 18.0, 1.0], [1.0, 10.0, 2.0]])
    goals = np.array([[18.0, 18.0, 2.0], [18.0, 2.0, 2.0], [19.0, 9.0, 1.0]])

    net = ConvLSTMAllocNet(5, 256, 0.5)
    out = planner.plan_many(pm, starts, goals, net,
                            weights.load_params(WEIGHTS), cfg, seed=11,
                            device="cpu", dtype=F64)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                           import_torch.load_params_msgpack(WEIGHTS))
    jout = jplanner.plan_many(jpm, starts, goals,
                              JConvLSTMAllocNet(5, 256, 0.5), jparams, jcfg,
                              seed=11)
    assert out.reasons == jout.reasons
    np.testing.assert_array_equal(out.corridor_ok, jout.corridor_ok)
    assert out.corridor_ok.sum() >= 2
    res, jres = out.result, jax.tree.map(np.asarray, jout.result)
    np.testing.assert_allclose(res.times.numpy(), jres.times, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(res.solved.numpy(), jres.solved)
    both = res.solved.numpy() & jres.solved
    c = res.coeffs.numpy()
    assert np.isfinite(c).all() and c.shape == (3, 5, 3, 8)
    if both.any():
        scale = max(1.0, float(np.abs(jres.coeffs[both]).max()))
        assert float(np.abs(c - jres.coeffs)[both].max()) <= 1e-3 * scale
    np.testing.assert_array_equal(out.traj.seg_mask.numpy(),
                                  np.asarray(jout.traj.seg_mask))
