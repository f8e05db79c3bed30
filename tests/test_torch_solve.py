"""Port parity, the full solve: allocnet_tpu_torch.ops.admm.solve_qp against
the JAX solve_qp (which runs its XLA-scan core on the CPU) and against the
f64 KKT-certified oracle (tests/oracle/qp_oracle.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allocnet_tpu.config import QPConfig as JQPConfig
from allocnet_tpu.config import SolverConfig as JSolverConfig
from allocnet_tpu.ops import admm as jadmm
from allocnet_tpu.ops import qp as jqp
from allocnet_tpu_torch.config import QPConfig, SolverConfig
from allocnet_tpu_torch.ops import admm, admm_chunk, qp
from allocnet_tpu_torch.utils import scenarios
from tests.oracle import qp_oracle
from tests.torch_threads import one_torch_thread  # noqa: F401

B, SEED = 8, 5
# small budget (2 x 75 iterations), as tests/test_pallas_kernel.py
BUDGET = dict(n_chunks=2, iters_per_chunk=75)
# the certification path's options: refactor per chunk, two polish rounds
# with a drop/enter pass, pivoted LU
VARIANT = dict(BUDGET, ns_rho_update=False, polish_rounds=2,
               polish_drop_passes=1, polish_method="lu")


@functools.lru_cache(maxsize=None)
def _solve(dtype_name, variant):
    kw = VARIANT if variant else BUDGET
    cfg, jcfg = QPConfig(res=10), JQPConfig(res=10)
    sc = scenarios.random_scenarios(cfg, B, seed=SEED, min_seg=1)
    np_dt = np.dtype(dtype_name)
    arrs = [sc.state.astype(np_dt), sc.hpolys.astype(np_dt),
            sc.times.astype(np_dt), sc.seg]
    data = qp.build_qp(cfg, *arrs, device="cpu")
    sol = admm.solve_qp(data, SolverConfig(**kw))
    jdata = jqp.build_qp(jcfg, *(jnp.asarray(a) for a in arrs))
    jsol = jadmm.solve_qp(jdata, JSolverConfig(**kw))
    return cfg, sc, sol, jax.tree.map(np.asarray, jsol)


# Tolerances: solved flags equal; coefficients of scenarios solved on both
# sides within 1e-3 (bench.py's bar; measured 1e-5 in f32, 4e-13 in f64,
# where both sides run the same plain ADMM).  In f32 the port runs the
# chunk loop (Kx^T, scaled duals) against JAX's XLA scan, so only the
# post-polish solution is comparable.
@pytest.mark.parametrize("dtype,variant,tol", [("float32", False, 1e-3),
                                               ("float64", False, 1e-9),
                                               ("float64", True, 1e-9)])
def test_solve_qp_matches_jax(dtype, variant, tol):
    _, _, sol, jsol = _solve(dtype, variant)
    solved = sol.solved.numpy()
    np.testing.assert_array_equal(solved, jsol.solved)
    assert solved.sum() >= B // 2
    both = solved & jsol.solved
    c, jc = sol.coeffs.numpy(), jsol.coeffs
    assert np.isfinite(c).all()
    scale = max(1.0, float(np.abs(jc[both]).max()))
    assert float(np.abs(c - jc)[both].max()) <= tol * scale
    np.testing.assert_allclose(sol.obj.numpy()[both], jsol.obj[both],
                               rtol=100 * tol)
    assert sol.coeffs.dtype == getattr(torch, dtype)
    if dtype == "float64":
        np.testing.assert_array_equal(sol.polished.numpy(), jsol.polished)
        # residuals agree to 1e-4 relative down to the f64 roundoff floor of
        # the residual evaluation itself (~1e-11 absolute)
        for name in ("pri_rel", "dua_rel"):
            np.testing.assert_allclose(getattr(sol, name).numpy(),
                                       getattr(jsol, name), rtol=1e-4,
                                       atol=1e-10)


def test_solve_qp_takes_the_chunk_loop_in_f32(monkeypatch):
    """f32 goes through admm_chunk (its plain version on the CPU); f64
    through the plain admm_solve."""
    calls = []
    real = admm_chunk.admm_chunk

    def spy(*a, **k):
        calls.append(a[0].dtype)
        return real(*a, **k)

    monkeypatch.setattr(admm_chunk, "admm_chunk", spy)
    cfg = QPConfig(res=10)
    sc = scenarios.random_scenarios(cfg, 2, seed=1, min_seg=1)
    for dt, n in ((np.float32, 2), (np.float64, 0)):
        calls.clear()
        data = qp.build_qp(cfg, sc.state.astype(dt), sc.hpolys.astype(dt),
                           sc.times.astype(dt), sc.seg, device="cpu")
        admm.solve_qp(data, SolverConfig(n_chunks=2, iters_per_chunk=5))
        assert calls == [torch.float32] * n


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_solve_qp_matches_f64_oracle(dtype):
    """bench.py's gates on the solved set: OSQP-normalized residual < 1e-3
    and coefficients within 1e-3 of the certified f64 oracle."""
    cfg, sc, sol, _ = _solve(dtype, False)
    solved = sol.solved.numpy()
    rel = np.maximum(sol.pri_rel.numpy(), sol.dua_rel.numpy())
    assert rel[solved].max() < 1e-3
    checked = 0
    for b in np.nonzero(solved)[0][:3]:
        ora = qp_oracle.solve_scenario(cfg, sc.state[b], sc.hpolys[b],
                                       sc.times[b], sc.seg[b])
        if ora['kkt'] > 1e-7:
            continue
        L = int(sc.seg[b])
        assert np.abs(sol.coeffs.numpy()[b, :L] - ora['coeffs']).max() <= 1e-3
        checked += 1
    assert checked >= 2


def test_solve_qp_infeasible_times_are_flagged():
    """Times far too short: unsolved, yet every output finite (f32)."""
    cfg = QPConfig(res=10)
    sc = scenarios.random_scenarios(cfg, 4, seed=3, min_seg=2)
    times = np.where(sc.times > 0, 0.05, 0.0).astype(np.float32)
    data = qp.build_qp(cfg, sc.state.astype(np.float32),
                       sc.hpolys.astype(np.float32), times, sc.seg,
                       device="cpu")
    sol = admm.solve_qp(data, SolverConfig(**BUDGET))
    assert not sol.solved.any()
    assert torch.isfinite(sol.coeffs).all()
