"""Port parity, ADMM core and LDL: allocnet_tpu_torch.ops.admm / ops.ldl
against allocnet_tpu's on the same seeded scenarios (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allocnet_tpu.config import QPConfig as JQPConfig
from allocnet_tpu.config import SolverConfig as JSolverConfig
from allocnet_tpu.ops import admm as jadmm
from allocnet_tpu.ops import ldl as jldl
from allocnet_tpu.ops import qp as jqp
from allocnet_tpu_torch.config import QPConfig, SolverConfig
from allocnet_tpu_torch.ops import admm, ldl, qp
from allocnet_tpu_torch.utils import scenarios
from tests.torch_threads import one_torch_thread  # noqa: F401


def _both(dtype, B=6, seed=5, res=10):
    cfg, jcfg = QPConfig(res=res), JQPConfig(res=res)
    sc = scenarios.random_scenarios(cfg, B, seed=seed, min_seg=1)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    arrs = [sc.state.astype(np_dt), sc.hpolys.astype(np_dt),
            sc.times.astype(np_dt), sc.seg]
    return (qp.build_qp(cfg, *arrs, device="cpu"),
            jqp.build_qp(jcfg, *(jnp.asarray(a) for a in arrs)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_spd_inverse_and_ns_update_match(dtype):
    data, jdata = _both(dtype)
    rho = np.linspace(1.0, 8.0, 6)
    tdt = data.times.dtype
    M = qp.normal_matrix(data, 1e-6, torch.tensor(rho * 100, dtype=tdt),
                         torch.tensor(rho, dtype=tdt))
    jM = jnp.asarray(M.numpy())
    Minv = admm.spd_inverse(M)
    jMinv = jadmm.spd_inverse(jM)
    # f64: the same algorithm up to summation order; f32: Cholesky of a
    # cond ~1e4 matrix, so ~1e-7 * 1e4 relative to the largest entry
    tol = 1e-9 if dtype == torch.float64 else 2e-3
    assert _rel(Minv.numpy(), jMinv) <= tol
    N = qp.normal_matrix(data, 1e-6, 0.0, 0.0)
    f = torch.tensor([0.5, 1.0, 2.0, 5.0, 3.0, 0.7], dtype=tdt)
    Minv2, P2 = admm.ns_update_inverse(Minv, M - N, f, N)
    jMinv2, jP2 = jadmm.ns_update_inverse(jnp.asarray(Minv.numpy()),
                                          jnp.asarray((M - N).numpy()),
                                          jnp.asarray(f.numpy()),
                                          jnp.asarray(N.numpy()))
    assert _rel(Minv2.numpy(), jMinv2) <= tol
    assert _rel(P2.numpy(), jP2) <= 1e-12
    if dtype == torch.float64:
        # and the update is the inverse of N + f P
        eye = torch.eye(M.shape[-1], dtype=tdt)
        assert float(((N + P2) @ Minv2 - eye).abs().max()) <= 1e-8


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_initial_rho_matches(dtype):
    data, jdata = _both(dtype)
    scfg, jscfg = SolverConfig(), JSolverConfig()
    r, fl = admm.initial_rho(data, scfg, data.times.dtype)
    jr, jfl = jadmm.initial_rho(jdata, jscfg, jdata.times.dtype)
    assert _rel(r.numpy(), jr) <= (1e-12 if dtype == torch.float64 else 1e-5)
    assert _rel(fl.numpy(), jfl) <= (1e-12 if dtype == torch.float64 else 1e-5)


# iterates and residuals after one and after two chunks.  f64: the same
# arithmetic up to summation order, 1e-8 relative to each array's largest
# entry (measured <= 3e-11), residuals within 1e-8 of their OSQP scales.
# f32: ADMM carries f32 roundoff through cond(M) ~ 1e4 over 75 iterations
# (measured <= 8.5e-4 relative on the iterates, so 5e-3); the primal
# residual agrees within 1e-3 of its scale (measured 1.5e-5) and the dual
# residual, a difference of two terms of its scale's size that each sum the
# iterates' error over the 6200 sampled rows, within 0.1 (measured 0.048).
@pytest.mark.parametrize("n_chunks", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_admm_solve_matches_per_chunk(dtype, n_chunks):
    data, jdata = _both(dtype)
    scfg = SolverConfig(n_chunks=n_chunks, iters_per_chunk=75)
    jscfg = JSolverConfig(n_chunks=n_chunks, iters_per_chunk=75)
    x, z, y, rho_e, rho_i, pri, dua = admm.admm_solve(data, scfg)
    jx, jz, jy, jrho_e, jrho_i, jpri, jdua = jadmm.admm_solve(jdata, jscfg)
    f64 = dtype == torch.float64
    tol = 1e-8 if f64 else 5e-3
    assert _rel(x.numpy(), jx) <= tol
    for k in qp.INEQ_KEYS:
        assert _rel(z[k].numpy(), jz[k]) <= tol
    for k in qp.EQ_KEYS + qp.INEQ_KEYS:
        assert _rel(y[k].numpy(), jy[k]) <= tol
    assert _rel(rho_i.numpy(), jrho_i) <= (1e-12 if f64 else 1e-5)
    assert _rel(rho_e.numpy(), jrho_e) <= (1e-12 if f64 else 1e-5)
    _, pri_scale, _, dua_scale = admm._residuals(
        data, x, z, y, qp.eq_rhs(data), qp.ineq_rhs(data))
    dp = np.abs(pri.numpy() - np.asarray(jpri)) / pri_scale.numpy()
    dd = np.abs(dua.numpy() - np.asarray(jdua)) / dua_scale.numpy()
    assert dp.max() <= (1e-8 if f64 else 1e-3)
    assert dd.max() <= (1e-8 if f64 else 0.1)


def test_admm_solve_warm_start_matches():
    """x0/y0 warm start (f64)."""
    data, jdata = _both(torch.float64)
    scfg = SolverConfig(n_chunks=1, iters_per_chunk=30)
    jscfg = JSolverConfig(n_chunks=1, iters_per_chunk=30)
    x0, _, y0, *_ = admm.admm_solve(data, scfg)
    x, *_ = admm.admm_solve(data, scfg, x0, y0)
    jx, *_ = jadmm.admm_solve(jdata, jscfg, jnp.asarray(x0.numpy()),
                              {k: jnp.asarray(v.numpy()) for k, v in y0.items()})
    assert _rel(x.numpy(), jx) <= 1e-8


def _random_kkt(dtype, B=3, n=40, m=30, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, n))
    Lp = rng.normal(size=(B, n, n))
    P = Lp @ np.swapaxes(Lp, 1, 2) / n + 1e-3 * np.eye(n)
    delta = 1e-4
    K = np.zeros((B, n + m, n + m))
    K[:, :n, :n] = P + delta * np.eye(n)
    K[:, :n, n:] = np.swapaxes(A, 1, 2)
    K[:, n:, :n] = A
    K[:, n:, n:] = -delta * np.eye(m)
    rhs = rng.normal(size=(B, n + m))
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    return K.astype(np_dt), rhs.astype(np_dt), n


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ldl_matches(dtype):
    K, rhs, n = _random_kkt(dtype)
    Kp, rp, N = ldl.pad_to_block(torch.tensor(K), torch.tensor(rhs), nb=32)
    jKp, jrp, jN = jldl.pad_to_block(jnp.asarray(K), jnp.asarray(rhs), nb=32)
    assert N == jN
    np.testing.assert_array_equal(Kp.numpy(), np.asarray(jKp))
    np.testing.assert_array_equal(rp.numpy(), np.asarray(jrp))
    L, d = ldl.ldl_factor(Kp, nb=32, n_pos=n, reg=1e-6)
    jL, jd = jldl.ldl_factor(jKp, nb=32, n_pos=n, reg=1e-6)
    sol = ldl.ldl_solve(L, d, rp)
    jsol = jldl.ldl_solve(jL, jd, jrp)
    # f64: same elimination order, 1e-9; f32: the pivot-free factor of a
    # delta = 1e-4 quasi-definite matrix carries ~1e-3 relative error
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    assert _rel(L.numpy(), jL) <= tol
    assert _rel(d.numpy(), jd) <= tol
    assert _rel(sol.numpy(), jsol) <= tol
    if dtype == torch.float64:
        x = sol[:, :K.shape[1]].numpy()
        np.testing.assert_allclose(np.einsum('bij,bj->bi', K, x), rhs,
                                   atol=1e-8)


def test_ldl_sign_vector_and_bad_size():
    K, rhs, n = _random_kkt(torch.float64, n=32, m=32)
    sign = torch.tensor([1.0] * n + [-1.0] * 32, dtype=torch.float64)
    L1, d1 = ldl.ldl_factor(torch.tensor(K), nb=32, sign=sign)
    L2, d2 = ldl.ldl_factor(torch.tensor(K), nb=32, n_pos=n)
    np.testing.assert_array_equal(L1.numpy(), L2.numpy())
    np.testing.assert_array_equal(d1.numpy(), d2.numpy())
    with pytest.raises(ValueError):
        ldl.ldl_factor(torch.tensor(K)[:, :60, :60], nb=32)


def test_polish_trace_changes_no_output(monkeypatch):
    """polish's `trace` callback (the drop pass's values, which
    chip_smoke.trace_sample prints) is called once per drop pass of every
    round, its values give the pass's new active set, and the solve's
    outputs stay bit for bit the same as without it (CERTIFY_SOLVER: 6
    rounds, one drop pass each)."""
    from allocnet_tpu_torch.config import CERTIFY_SOLVER as scfg
    data, _ = _both(torch.float32, B=4, seed=5)
    calls, polish = [], admm.polish
    monkeypatch.setattr(admm, "polish", lambda *a, **k: polish(
        *a, trace=calls.append, **k))
    traced = admm.solve_qp(data, scfg)
    monkeypatch.undo()
    plain = admm.solve_qp(data, scfg)
    assert len(calls) == scfg.polish_rounds * scfg.polish_drop_passes
    for d in calls:
        assert d["lam"].shape == d["gx_h"].shape == d["idx"].shape == (
            4, scfg.max_active)
        assert torch.equal(d["active_out"], (
            d["active_in"] & (d["lam"] > d["lam_thr"])) | (d["gx_h"] > 1e-7))
    for name, a, b in zip(plain._fields, traced, plain):
        for u, v in (zip(a.values(), b.values()) if isinstance(a, dict)
                     else [(a, b)]):
            assert torch.equal(u, v) and torch.equal(
                u.view(torch.int8), v.view(torch.int8)), name
