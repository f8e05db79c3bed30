"""Port parity, numpy and QP assembly: allocnet_tpu_torch's bases, scenarios
and ops/qp against allocnet_tpu's, on the same seeded inputs (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allocnet_tpu.config import QPConfig as JQPConfig
from allocnet_tpu.ops import bases as jbases
from allocnet_tpu.ops import qp as jqp
from allocnet_tpu.utils import scenarios as jscenarios
from allocnet_tpu_torch.config import QPConfig
from allocnet_tpu_torch.ops import bases, qp
from allocnet_tpu_torch.utils import scenarios
from tests.torch_threads import one_torch_thread  # noqa: F401

CFGS = [dict(), dict(res=10), dict(order=3), dict(res=10, max_vel=5.0, max_acc=7.0)]


@pytest.mark.parametrize("kw", CFGS)
def test_bases_bit_identical(kw):
    cfg = QPConfig(**kw)
    D, o, R = cfg.D, cfg.order, cfg.res
    for a, b in zip(bases.sampled_bases(D, R), jbases.sampled_bases(D, R)):
        np.testing.assert_array_equal(a, b)
    for compat in (True, False):
        np.testing.assert_array_equal(bases.gram_matrix(o, compat),
                                      jbases.gram_matrix(o, compat))
    np.testing.assert_array_equal(bases.slot_scales(D, o),
                                  jbases.slot_scales(D, o))
    for tau in (0.0, 1.0):
        np.testing.assert_array_equal(bases.boundary_bases(D, o, tau),
                                      jbases.boundary_bases(D, o, tau))
    np.testing.assert_array_equal(bases.unscale_powers(D),
                                  jbases.unscale_powers(D))
    if o == 4:
        assert bases.gram_matrix(4)[2, 3] == 1400.0   # reference_compat entry


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("kw", [dict(min_seg=1), dict(min_seg=2, rest_to_rest=False)])
def test_scenarios_bit_identical(seed, kw):
    a = scenarios.random_scenarios(QPConfig(), 16, seed=seed, **kw)
    b = jscenarios.random_scenarios(JQPConfig(), 16, seed=seed, **kw)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _both(kw, dtype, B=6, seed=3):
    cfg, jcfg = QPConfig(**kw), JQPConfig(**kw)
    sc = scenarios.random_scenarios(cfg, B, seed=seed, min_seg=1)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    arrs = [sc.state.astype(np_dt), sc.hpolys.astype(np_dt),
            sc.times.astype(np_dt), sc.seg]
    data = qp.build_qp(cfg, *arrs, device="cpu")
    jdata = jqp.build_qp(jcfg, *(jnp.asarray(a) for a in arrs))
    return data, jdata


def _close(a, b, tol):
    """|a - b| <= tol * max(1, max|b|) elementwise."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(1.0, float(np.abs(b).max()))
    err = float(np.abs(a - b).max())
    assert err <= tol * scale, (err, scale)


# f64: both sides do the same arithmetic up to summation order -> 1e-12
# relative to each array's largest entry.  f32: the same, at the f32
# resolution of sums over <= 120 terms -> 1e-5.
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kw", CFGS[:3])
def test_build_qp_matches(kw, dtype):
    data, jdata = _both(kw, dtype)
    for name in qp.QPData._fields[:-1]:
        _close(getattr(data, name).numpy(), getattr(jdata, name), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kw", CFGS[:3])
def test_operators_match(kw, dtype):
    data, jdata = _both(kw, dtype)
    cfg = data.cfg
    rng = np.random.default_rng(1)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    x = rng.normal(size=(6, cfg.max_seg, 3, cfg.D)).astype(np_dt)
    ax, jax_ = qp.apply_A(data, torch.tensor(x)), jqp.apply_A(jdata, jnp.asarray(x))
    for k in ax:
        _close(ax[k].numpy(), jax_[k], TOL[dtype])
    y = {k: rng.normal(size=v.shape).astype(np_dt) for k, v in ax.items()}
    _close(qp.apply_AT(data, {k: torch.tensor(v) for k, v in y.items()}).numpy(),
           jqp.apply_AT(jdata, {k: jnp.asarray(v) for k, v in y.items()}),
           TOL[dtype])
    _close(qp.apply_P(data, torch.tensor(x)).numpy(),
           jqp.apply_P(jdata, jnp.asarray(x)), TOL[dtype])
    _close(qp.objective(data, torch.tensor(x)).numpy(),
           jqp.objective(jdata, jnp.asarray(x)), TOL[dtype])
    _close(qp.unscale_coeffs(data, torch.tensor(x)).numpy(),
           jqp.unscale_coeffs(jdata, jnp.asarray(x)), TOL[dtype])
    for keys in (qp.EQ_KEYS, qp.INEQ_KEYS):
        _close(qp.tree_flat(ax, keys).numpy(), jqp.tree_flat(jax_, keys),
               TOL[dtype])
    _close(qp.tree_flat(qp.eq_rhs(data), qp.EQ_KEYS).numpy(),
           jqp.tree_flat(jqp.eq_rhs(jdata), jqp.EQ_KEYS), 0.0)
    _close(qp.tree_flat(qp.ineq_rhs(data), qp.INEQ_KEYS).numpy(),
           jqp.tree_flat(jqp.ineq_rhs(jdata), jqp.INEQ_KEYS), 0.0)


def test_apply_AT_is_adjoint():
    data, _ = _both(dict(res=10), torch.float64)
    cfg = data.cfg
    g = torch.Generator().manual_seed(0)
    x = torch.randn((6, cfg.max_seg, 3, cfg.D), generator=g, dtype=torch.float64)
    ax = qp.apply_A(data, x)
    y = {k: torch.randn(v.shape, generator=g, dtype=torch.float64)
         for k, v in ax.items()}
    lhs = sum((ax[k] * y[k]).sum() for k in ax)
    rhs = (x * qp.apply_AT(data, y)).sum()
    assert abs(float(lhs - rhs)) <= 1e-10 * abs(float(lhs))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kw", CFGS[:3])
def test_normal_matrix_and_dense_eq_match(kw, dtype):
    data, jdata = _both(kw, dtype)
    rho_i = np.linspace(0.8, 12.0, 6)
    M = qp.normal_matrix(data, 1e-6, torch.tensor(rho_i * 100, dtype=dtype),
                         torch.tensor(rho_i, dtype=dtype))
    jM = jqp.normal_matrix(jdata, 1e-6, jnp.asarray(rho_i * 100, M.numpy().dtype),
                           jnp.asarray(rho_i, M.numpy().dtype))
    _close(M.numpy(), jM, TOL[dtype])
    A, b = qp.dense_eq(data)
    jA, jb = jqp.dense_eq(jdata)
    _close(A.numpy(), jA, 0.0)
    _close(b.numpy(), jb, 0.0)


def test_normal_matrix_is_the_dense_gram():
    """M = sigma I + P + rho_eq Aeq^T Aeq + rho_in G^T G with G built row by
    row from apply_A (f64)."""
    data, _ = _both(dict(res=10), torch.float64, B=2)
    cfg = data.cfg
    n = cfg.n_var
    eye = torch.eye(n, dtype=torch.float64)
    cols = [qp.apply_A(data, eye[i].expand(2, n).reshape(2, cfg.max_seg, 3, cfg.D))
            for i in range(n)]
    Aeq = torch.stack([qp.tree_flat(c, qp.EQ_KEYS) for c in cols], -1)
    G = torch.stack([qp.tree_flat(c, qp.INEQ_KEYS) for c in cols], -1)
    P = torch.stack([qp.apply_P(data, eye[i].expand(2, n).reshape(
        2, cfg.max_seg, 3, cfg.D)).reshape(2, n) for i in range(n)], -1)
    want = 1e-6 * eye + P + 300.0 * Aeq.transpose(1, 2) @ Aeq \
        + 3.0 * G.transpose(1, 2) @ G
    got = qp.normal_matrix(data, 1e-6, 300.0, 3.0)
    _close(got.numpy(), want.numpy(), 1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kw", CFGS[:3])
def test_scale_coeffs_roundtrip_and_matches(kw, dtype):
    data, jdata = _both(kw, dtype)
    cfg = data.cfg
    rng = np.random.default_rng(2)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    c = rng.normal(size=(6, cfg.max_seg, 3, cfg.D)).astype(np_dt)
    x = qp.scale_coeffs(data, torch.tensor(c))
    _close(x.numpy(), jqp.scale_coeffs(jdata, jnp.asarray(c)), TOL[dtype])
    # unscale(scale(c)) = c on active segments, 0 on padded ones
    back = qp.unscale_coeffs(data, x).numpy()
    mask = data.seg_mask.numpy()[:, :, None, None]
    _close(back, c * mask, TOL[dtype])
    _close(qp.scale_coeffs(data, qp.unscale_coeffs(data, x)).numpy(),
           x.numpy() * mask, TOL[dtype])


@pytest.mark.parametrize("seed", [0, 5])
def test_infer_seg_matches(seed):
    sc = scenarios.random_scenarios(QPConfig(), 16, seed=seed, min_seg=1)
    hp = np.array(sc.hpolys)
    hp[3, 1] = 0.0                         # a gap ends the corridor early
    got = qp.infer_seg(torch.tensor(hp)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jqp.infer_seg(
        jnp.asarray(hp))))
    want = np.array(sc.seg)
    want[3] = min(want[3], 1)
    np.testing.assert_array_equal(got, want)
