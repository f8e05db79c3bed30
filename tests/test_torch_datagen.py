"""Port parity, dataset generation from a point cloud: utils/pcd,
train/datagen (generate, certify), utils/scenarios.corridor_time_lower_bounds
and config.jerk against allocnet_tpu's on the CPU.

Tolerances: the PCD reader and the crop are the same NumPy code (exact);
generate runs its corridors in float64 on both sides (tests/conftest.py
turns on JAX x64), so corridors agree as face sets to 1e-6 of the largest
entry and the reference times, max(quintic bound, 0.3) * slack over the
junction interiors, to 1e-9; the time lower bounds to 1e-9 (same LP in
float64)."""

import dataclasses

import numpy as np
import pytest
import torch

from allocnet_tpu import config as jconfig
from allocnet_tpu.config import AllocNetConfig as JAllocNetConfig
from allocnet_tpu.config import QPConfig as JQPConfig
from allocnet_tpu.train import datagen as jdatagen
from allocnet_tpu.utils import pcd as jpcd
from allocnet_tpu.utils import scenarios as jscenarios
from allocnet_tpu_torch import config
from allocnet_tpu_torch.config import AllocNetConfig, QPConfig
from allocnet_tpu_torch.ops import admm, qp
from allocnet_tpu_torch.planner import sfc
from allocnet_tpu_torch.train import dataset, datagen
from allocnet_tpu_torch.utils import pcd, scenarios
from tests.torch_threads import one_torch_thread  # noqa: F401

FACE_TOL = 1e-6
TIME_TOL = 1e-9


def _cloud():
    """Two random_obstacle_map tiles side by side (40 x 20 x 4 m)."""
    return np.concatenate([datagen.random_obstacle_map(100),
                           datagen.random_obstacle_map(101)
                           + np.array([20.0, 0.0, 0.0])])


def test_pcd_roundtrip_and_crops_match_jax(tmp_path):
    cloud = _cloud()
    path = str(tmp_path / "cloud.pcd")
    pcd.write_pcd(path, cloud)
    jpcd.write_pcd(str(tmp_path / "j.pcd"), cloud)
    assert open(path).read() == open(tmp_path / "j.pcd").read()
    back = pcd.read_pcd(path)
    np.testing.assert_array_equal(back, jpcd.read_pcd(path))
    np.testing.assert_allclose(back, cloud, atol=5e-7)   # "%.6f"

    # a binary cloud with an extra field and a non-finite point
    pts = np.concatenate([cloud[:50], [[np.nan, 0.0, 0.0]]]).astype(np.float32)
    rec = np.zeros(len(pts), dtype=[("x", "f4"), ("y", "f4"), ("z", "f4"),
                                    ("intensity", "u1")])
    for k, name in enumerate("xyz"):
        rec[name] = pts[:, k]
    bpath = tmp_path / "cloud_bin.pcd"
    with open(bpath, "wb") as f:
        f.write(b"VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 1\n"
                b"TYPE F F F U\nCOUNT 1 1 1 1\nWIDTH 51\nHEIGHT 1\n"
                b"POINTS 51\nDATA binary\n" + rec.tobytes())
    got = pcd.read_pcd(str(bpath))
    np.testing.assert_array_equal(got, jpcd.read_pcd(str(bpath)))
    assert got.shape == (50, 3)

    kw = dict(extent=(20.0, 20.0, 4.0), stride=(10.0, 10.0), min_points=2000)
    crops, jcrops = pcd.crop_segments(back, **kw), jpcd.crop_segments(back,
                                                                       **kw)
    assert len(crops) == len(jcrops) >= 2
    for c, j in zip(crops, jcrops):
        np.testing.assert_array_equal(c["origin"], j["origin"])
        np.testing.assert_array_equal(c["points"], j["points"])
    assert pcd.crop_segments(np.zeros((0, 3))) == []


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """generate(res 10, 6 samples, seed 5), as tests/test_datagen_viz.py
    runs it, through both packages (corridors in float64); the port's
    batch also written to HDF5."""
    path = str(tmp_path_factory.mktemp("datagen") / "dataset.h5")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(datagen, "CORRIDOR_DTYPE", torch.float64)
        sc = datagen.generate(AllocNetConfig(qp=QPConfig(res=10)),
                              n_samples=6, out_path=path, seed=5,
                              device="cpu")
    jsc = jdatagen.generate(JAllocNetConfig(qp=JQPConfig(res=10)),
                            n_samples=6, seed=5)
    return sc, jsc, path


def test_generate_matches_jax(generated):
    sc, jsc, _ = generated
    assert 2 <= len(sc.seg) <= 6
    np.testing.assert_array_equal(sc.seg, np.asarray(jsc.seg))
    np.testing.assert_array_equal(sc.state, np.asarray(jsc.state))
    scale = max(1.0, float(np.abs(jsc.hpolys).max()))
    for b in range(len(sc.seg)):
        for i in range(int(sc.seg[b])):
            assert sfc.face_set_distance(
                sc.hpolys[b, i], np.asarray(jsc.hpolys[b, i])) <= FACE_TOL * scale
        assert not sc.hpolys[b, int(sc.seg[b]):].any()
    np.testing.assert_allclose(sc.times, np.asarray(jsc.times), rtol=0,
                               atol=TIME_TOL)
    # corridors contain their start points
    for b in range(len(sc.seg)):
        first = sc.hpolys[b, 0]
        live = np.linalg.norm(first[:, :3], axis=1) > 1e-6
        assert np.all(first[live, :3] @ sc.state[b, 0, :, 0]
                      <= first[live, 3] + 1e-5)


def test_certified_samples_resolve_in_f32(generated):
    """Every kept sample re-solves with its reference times at the
    certification budget in float32 (the production dtype)."""
    sc, _, _ = generated
    cfg = QPConfig(res=10)
    f32 = np.float32
    data = qp.build_qp(cfg, sc.state.astype(f32), sc.hpolys.astype(f32),
                       sc.times.astype(f32), sc.seg, device="cpu")
    sol = admm.solve_qp(data, config.CERTIFY_SOLVER)
    assert bool(sol.solved.all())
    np.testing.assert_array_equal(
        datagen.certified(AllocNetConfig(qp=cfg), sc, device="cpu"),
        np.ones(len(sc.seg), bool))
    empty = scenarios.ScenarioBatch(*(a[:0] for a in sc))
    assert len(datagen.certify(AllocNetConfig(qp=cfg), empty).seg) == 0


def test_h5_roundtrip(generated):
    sc, _, path = generated
    back = dataset.read_h5(path, QPConfig(res=10))
    np.testing.assert_array_equal(back.seg, sc.seg)
    np.testing.assert_allclose(back.times, sc.times, atol=1e-12)
    np.testing.assert_allclose(back.state, sc.state, atol=1e-12)
    np.testing.assert_allclose(back.hpolys, sc.hpolys, atol=1e-12)


def test_corridor_time_lower_bounds_match_jax():
    cfg = QPConfig(res=10)
    sc = scenarios.random_scenarios(cfg, 4, seed=41, min_seg=1)
    got = scenarios.corridor_time_lower_bounds(sc.hpolys, sc.state, sc.seg,
                                               cfg.max_vel, cfg.max_acc)
    want = jscenarios.corridor_time_lower_bounds(sc.hpolys, sc.state, sc.seg,
                                                 cfg.max_vel, cfg.max_acc)
    assert got.shape == (4, cfg.max_seg)
    assert (got[np.arange(cfg.max_seg)[None] < sc.seg[:, None]] > 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TIME_TOL)


def test_jerk_matches_jax():
    for cfg, jcfg in ((QPConfig(), JQPConfig()),
                      (QPConfig(res=10, max_vel=5.0), JQPConfig(
                          res=10, max_vel=5.0))):
        got = config.jerk(cfg)
        assert dataclasses.asdict(got) == dataclasses.asdict(jconfig.jerk(jcfg))
        assert (got.order, got.D, got.n_var) == (3, 6, 90)
