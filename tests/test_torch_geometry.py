"""Port parity, corridor geometry: allocnet_tpu_torch.ops voxel, lp, lbfgs,
mvie and firi against their allocnet_tpu counterparts on the cases of
tests/test_geometry.py, on the CPU in f64 (the JAX side runs f64 under
tests/conftest.py), plus the config fields that the corridor front end
adds."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allocnet_tpu import config as jconfig
from allocnet_tpu.ops import firi as jfiri
from allocnet_tpu.ops import lbfgs as jlbfgs
from allocnet_tpu.ops import lp as jlp
from allocnet_tpu.ops import mvie as jmvie
from allocnet_tpu.ops import voxel as jvoxel
from allocnet_tpu_torch import config
from allocnet_tpu_torch.ops import firi, lbfgs, lp, mvie, voxel
from tests.torch_threads import one_torch_thread  # noqa: F401

# f64 through the same arithmetic on both sides: the LP/IPM and L-BFGS
# results agree to roundoff amplified by a few Newton/quasi-Newton steps
LP_TOL = 1e-8
# FIRI composes 4 x 50 picks, 3 MVIE fits and an SVD: world-frame rows to
# 1e-6 of the largest entry
FIRI_TOL = 1e-6


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _box(lo, hi):
    rows = []
    for j in range(3):
        a = np.zeros(3)
        a[j] = 1.0
        rows.append(np.concatenate([a, [hi[j]]]))
        rows.append(np.concatenate([-a, [-lo[j]]]))
    return np.asarray(rows)


def test_config_matches_jax():
    """CorridorConfig, AllocNetConfig.corridor and DEPLOY carry the JAX
    package's fields and defaults."""
    assert (dataclasses.asdict(config.DEPLOY)
            == dataclasses.asdict(jconfig.DEPLOY))
    assert (dataclasses.asdict(config.CorridorConfig().online())
            == dataclasses.asdict(jconfig.CorridorConfig().online()))


def test_voxelize_dilate_surf_match_jax():
    """Occupancy, dilation and surface points: exact, including the grid
    border (a point in a corner cell)."""
    pts = np.array([[5.5, 5.5, 5.5], [0.2, 10.7, 0.1], [30.0, 1.0, 1.0]])
    size = (11, 11, 11)
    occ = voxel.voxelize(_t(pts).float(), [0.0, 0.0, 0.0], size, 1.0)
    jocc = jvoxel.voxelize(jnp.asarray(pts, jnp.float32), [0.0, 0.0, 0.0],
                           size, 1.0)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(
        voxel.voxelize_host(pts, [0.0, 0.0, 0.0], size, 1.0),
        np.asarray(jocc))
    for r in (0, 1, 2):
        d, s = voxel.dilate(occ, r)
        jd, js = jvoxel.dilate(jocc, r)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert int(voxel.dilate(occ, 1)[0].sum()) == 27 + 8

    grid = voxel.make_grid(pts, [0.0, 0.0, 0.0], size, 1.0, dilate_r=1,
                           device="cpu")
    jgrid = jvoxel.make_grid(pts, [0.0, 0.0, 0.0], size, 1.0, dilate_r=1)
    q = np.array([[5.5, 5.5, 5.5], [3.2, 3.2, 3.2], [-3.0, 0.0, 0.0],
                  [0.5, 9.9, 0.5]])
    np.testing.assert_array_equal(
        voxel.query(grid, _t(q).float()).numpy(),
        np.asarray(jvoxel.query(jgrid, jnp.asarray(q, jnp.float32))))
    np.testing.assert_array_equal(voxel.surf_points_host(grid),
                                  jvoxel.surf_points_host(jgrid))
    sp, sm = voxel.surf_points(grid, 64)
    jsp, jsm = jvoxel.surf_points(jgrid, 64)
    np.testing.assert_array_equal(sm.numpy(), np.asarray(jsm))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))


def test_voxel_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        voxel.make_grid(np.zeros((1, 3)), [0, 0, 0], (4, 4, 4), 1.0, 1)


def test_find_interior_and_overlap_match_jax():
    box = _box([-1, -1, -1], [1, 1, 1])
    hp = np.zeros((3, 8, 4))
    mk = np.zeros((3, 8))
    hp[0, :6], mk[0, :6] = box, 1.0
    hp[1, :6], mk[1, :6] = _box([0.5, -2, 0], [2.5, 2.5, 3]), 1.0
    hp[2, :6], mk[2, :6] = 3.0 * _box([-1, 0, -1], [1, 0.5, 1]), 1.0
    hp[2, 6], mk[2, 6] = [1.0, 1.0, 0.0, 0.4], 1.0    # a slanted cut
    pt, depth = lp.find_interior(_t(hp), _t(mk))
    jpt, jdepth = jlp.find_interior(jnp.asarray(hp), jnp.asarray(mk))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jpt), atol=LP_TOL)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), atol=LP_TOL)
    np.testing.assert_allclose(depth[0].item(), 1.0, atol=1e-3)

    shifted = _box([0.5, 0.5, 0.5], [2.5, 2.5, 2.5])[None]
    apart = _box([3.0, 3.0, 3.0], [5.0, 5.0, 5.0])[None]
    m6 = np.ones((1, 6))
    for other, want in ((shifted, True), (apart, False)):
        got = lp.overlap(_t(box[None]), _t(m6), _t(other), _t(m6))
        jgot = jlp.overlap(jnp.asarray(box[None]), jnp.asarray(m6),
                           jnp.asarray(other), jnp.asarray(m6))
        assert bool(got[0]) == bool(jgot[0]) == want
    x, viol = lp.solve_lp(_t([[0.0, 0.0, 1.0]]), _t(box[None, :, :3]),
                          _t(box[None, :, 3]), iters=100)
    jx, jviol = jlp.solve_lp(jnp.asarray([[0.0, 0.0, 1.0]]),
                             jnp.asarray(box[None, :, :3]),
                             jnp.asarray(box[None, :, 3]), iters=100)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=LP_TOL)
    np.testing.assert_allclose(viol.numpy(), np.asarray(jviol), atol=LP_TOL)
    ca = _t([[0.2, 0.0, 0.9], [1.5, 0.0, 0.0]])
    got = lp.contains(_t(box).expand(2, 6, 4), _t(m6).expand(2, 6), ca)
    assert got.tolist() == [True, False]


def test_lbfgs_quadratic_matches_jax():
    A = np.diag([1.0, 10.0, 100.0])
    b = np.array([1.0, -2.0, 3.0])
    x, fv = lbfgs.minimize(
        lambda v: 0.5 * torch.einsum('bki,ij,bkj->bk', v, _t(A), v)
        - v @ _t(b), torch.zeros((1, 3), dtype=torch.float64), iters=40)
    jx, jfv = jlbfgs.minimize(
        lambda v: 0.5 * v @ jnp.asarray(A) @ v - jnp.asarray(b) @ v,
        jnp.zeros(3), iters=40)
    np.testing.assert_allclose(x[0].numpy(), np.linalg.solve(A, b),
                               atol=1e-5)
    np.testing.assert_allclose(x[0].numpy(), np.asarray(jx), atol=LP_TOL)
    np.testing.assert_allclose(fv[0].item(), float(jfv), atol=LP_TOL)


def _shape(ell):
    """(R diag(r^2) R^T, p): the ellipsoid, free of SVD column signs."""
    R, r, p = (np.asarray(a) for a in (ell.R, ell.r, ell.p))
    return np.einsum('...ij,...j,...kj->...ik', R, r ** 2, R), p


@pytest.mark.parametrize("lo,hi,r0,iters,radii", [
    ([-1, -1, -1], [1, 1, 1], 0.3, 80, [1.0, 1.0, 1.0]),       # unit cube
    ([-4, -2, -0.5], [4, 2, 0.5], 0.2, 100, [0.5, 2.0, 4.0]),  # slab
])
def test_mvie_matches_jax(lo, hi, r0, iters, radii):
    hp = _box(lo, hi)[None]
    mask = np.ones((1, 6))
    init = mvie.Ellipsoid(R=torch.eye(3, dtype=torch.float64)[None],
                          p=torch.zeros((1, 3), dtype=torch.float64),
                          r=torch.full((1, 3), r0, dtype=torch.float64))
    jinit = jmvie.Ellipsoid(R=jnp.eye(3)[None], p=jnp.zeros((1, 3)),
                            r=jnp.full((1, 3), r0))
    ell, ok = mvie.max_vol_ellipsoid(_t(hp), _t(mask), init, iters=iters)
    jell, jok = jmvie.max_vol_ellipsoid(jnp.asarray(hp), jnp.asarray(mask),
                                        jinit, iters=iters)
    assert bool(ok[0]) and bool(jok[0])
    Q, p = _shape(ell)
    jQ, jp = _shape(jell)
    np.testing.assert_allclose(Q, jQ, atol=LP_TOL * np.abs(jQ).max())
    np.testing.assert_allclose(p, jp, atol=LP_TOL)
    np.testing.assert_allclose(np.sort(ell.r[0].numpy()), radii, rtol=0.1)


def test_mvie_keeps_the_seed_with_padded_rows():
    """A zero (padded) row gives |A_i L| a NaN gradient in both packages,
    so L-BFGS keeps the seed: the same ellipsoid on both sides."""
    hp = np.zeros((1, 8, 4))
    hp[0, :6] = _box([-4, -2, -0.5], [4, 2, 0.5])
    mask = np.zeros((1, 8))
    mask[0, :6] = 1.0
    init = mvie.Ellipsoid(R=torch.eye(3, dtype=torch.float64)[None],
                          p=torch.zeros((1, 3), dtype=torch.float64),
                          r=torch.full((1, 3), 0.2, dtype=torch.float64))
    jinit = jmvie.Ellipsoid(R=jnp.eye(3)[None], p=jnp.zeros((1, 3)),
                            r=jnp.full((1, 3), 0.2))
    ell, _ = mvie.max_vol_ellipsoid(_t(hp), _t(mask), init, iters=20)
    jell, _ = jmvie.max_vol_ellipsoid(jnp.asarray(hp), jnp.asarray(mask),
                                      jinit, iters=20)
    Q, p = _shape(ell)
    jQ, jp = _shape(jell)
    np.testing.assert_allclose(Q, jQ, atol=1e-12)
    np.testing.assert_allclose(Q[0], 0.04 * np.eye(3), atol=1e-12)
    np.testing.assert_allclose(p, jp, atol=1e-12)
    # batched with an unpadded problem, the iterations run: the padded
    # problem still keeps its seed, to the bit of the skipped path
    hp2 = np.concatenate([hp, hp])
    mask2 = np.concatenate([mask, mask])
    mask2[1, 6:] = 1.0
    hp2[1, 6:] = _box([-5, -5, -5], [5, 5, 5])[:2]
    init2 = mvie.Ellipsoid(*(torch.cat([a, a]) for a in init))
    ell2, _ = mvie.max_vol_ellipsoid(_t(hp2), _t(mask2), init2, iters=20)
    for a, b in zip(ell2, ell):
        assert torch.equal(a[0], b[0])
    assert not torch.equal(ell2.r[1], ell.r[0])


@pytest.fixture(scope="module")
def firi_case():
    B = 2
    bd = np.stack([_box([-5, -5, -2], [5, 5, 2])] * B)
    obstacles = np.array([
        [[2.0, 0.0, 0.0], [0.0, 2.5, 0.5], [-3.0, 1.0, 0.0],
         [1.5, -2.0, 0.3], [1e6, 1e6, 1e6]],
        [[0.0, 3.0, 0.0], [2.5, 2.5, 0.2], [-2.0, -2.0, -0.4],
         [3.0, -1.0, 0.1], [1e6, 1e6, 1e6]],
    ])
    pc_mask = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 1, 0]], np.float64)
    a = np.array([[-1.0, 0.0, 0.0]] * B)
    b = np.array([[1.0, 0.5, 0.0]] * B)
    args = (bd, obstacles, pc_mask, a, b)
    kw = dict(iterations=2, mvie_iters=40)
    res = firi.firi(*(_t(x) for x in args), **kw)
    jres = jfiri.firi(*(jnp.asarray(x) for x in args), **kw)
    return args, res, jres


def test_firi_matches_jax(firi_case):
    _, res, jres = firi_case
    np.testing.assert_array_equal(res.mask.numpy(), np.asarray(jres.mask))
    np.testing.assert_array_equal(res.ok.numpy(), np.asarray(jres.ok))
    hp, jhp = res.hpolys.numpy(), np.asarray(jres.hpolys)
    np.testing.assert_allclose(hp, jhp, atol=FIRI_TOL * np.abs(jhp).max())
    Q, p = _shape(res.ellipsoid)
    jQ, jp = _shape(jres.ellipsoid)
    np.testing.assert_allclose(Q, jQ, atol=FIRI_TOL)
    np.testing.assert_allclose(p, jp, atol=FIRI_TOL)


def test_firi_separates_obstacles(firi_case):
    """tests/test_geometry.py's assertions on the port's result."""
    (_, obstacles, _, a, b), res, _ = firi_case
    assert bool(res.ok.all())
    hp, mk = res.hpolys.numpy(), res.mask.numpy()
    for bi in range(2):
        rows = hp[bi][mk[bi] > 0]
        assert rows.shape[0] >= 4
        for s in (a[bi], b[bi]):
            assert np.all(rows[:, :3] @ s <= rows[:, 3] + 1e-5)
        for k in range(4):
            assert np.max(rows[:, :3] @ obstacles[bi, k] - rows[:, 3]) > -1e-4


def test_firi_f32_on_cpu_matches_f64(firi_case):
    """The card runs FIRI in f32: the same picks, rows to 1e-4 of the
    largest entry, on the CPU."""
    args, res, _ = firi_case
    res32 = firi.firi(*(_t(x).float() for x in args), iterations=2,
                      mvie_iters=40)
    np.testing.assert_array_equal(res32.mask.numpy(), res.mask.numpy())
    hp = res.hpolys.numpy()
    np.testing.assert_allclose(res32.hpolys.double().numpy(), hp,
                               atol=1e-4 * np.abs(hp).max())
