"""Port parity, time refinement: allocnet_tpu_torch.planner.refine against
allocnet_tpu.planner.refine (CPU, f64, res=10, a 2 x 75 solver), and the
refinement's contract on the port, as tests/test_refine.py states it:
never worse than the input, the total time kept in fix_total mode, bounds
kept in free mode, unsolved inputs passed through."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allocnet_tpu.config import QPConfig as JQPConfig
from allocnet_tpu.config import SolverConfig as JSolverConfig
from allocnet_tpu.planner import refine as jrefine
from allocnet_tpu_torch.config import QPConfig, SolverConfig
from allocnet_tpu_torch.ops import admm, qp
from allocnet_tpu_torch.planner import refine
from allocnet_tpu_torch.utils import scenarios
from tests.torch_threads import one_torch_thread  # noqa: F401

BUDGET = dict(n_chunks=2, iters_per_chunk=75, polish_rounds=2)
CFG, SCFG = QPConfig(res=10), SolverConfig(**BUDGET)
JCFG, JSCFG = JQPConfig(res=10), JSolverConfig(**BUDGET)
S = CFG.max_seg
# f64, the same solves and gradients on both sides (tests/
# test_torch_qp_diff.py: ~1e-13); the accept/reject decisions compare
# objectives that differ by >> 1e-10, so the paths agree and the results
# match to rtol 1e-8
RTOL = 1e-8


def _skewed(n=2, seed=11):
    """Solvable scenarios whose times are skewed away from the heuristic."""
    sc = scenarios.random_scenarios(CFG, n, seed=seed, min_seg=3)
    times = np.array(sc.times)
    for b in range(n):
        k = int(sc.seg[b])
        times[b, :k] *= np.where(np.arange(S) % 2 == 0, 1.5, 1 / 1.5)[:k]
    return sc.state, sc.hpolys, times, sc.seg


def _port(args, **kw):
    return refine.refine_times(CFG, SCFG, *(torch.tensor(a) for a in args),
                               **kw)


def _jax(args, **kw):
    return jrefine.refine_times(JCFG, JSCFG, *(jnp.asarray(a) for a in args),
                                **kw)


def _mask(seg):
    return (np.arange(S)[None, :] < np.asarray(seg)[:, None]).astype(float)


def _snap(state, hpolys, times, seg):
    data = qp.build_qp(CFG, state, hpolys, times, seg, device="cpu")
    sol = admm.solve_qp(data, SCFG)
    return sol.obj.numpy(), sol.solved.numpy()


@pytest.fixture(scope="module")
def fix_total():
    args = _skewed()
    return args, _port(args, steps=4), _jax(args, steps=4)


def test_fix_total_matches_jax(fix_total):
    _, res, jres = fix_total
    for name in ("times", "obj", "obj0"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)), rtol=RTOL,
                                   atol=1e-12)
    np.testing.assert_array_equal(res.improved.numpy(),
                                  np.asarray(jres.improved))


def test_fix_total_improves_and_conserves(fix_total):
    (state, hpolys, times, seg), res, _ = fix_total
    obj_in, solved_in = _snap(state, hpolys, times, seg)
    assert solved_in.all()
    assert bool((res.obj <= res.obj0 + 1e-9).all())
    assert bool(res.improved.any())
    m = _mask(seg)
    np.testing.assert_allclose((res.times.numpy() * m).sum(1),
                               (np.maximum(times, 0.05) * m).sum(1),
                               rtol=1e-12)
    obj_ref, solved_ref = _snap(state, hpolys, res.times.numpy() + (1 - m),
                                seg)
    assert solved_ref.all()
    imp = res.improved.numpy()
    assert (obj_ref[imp] <= obj_in[imp] + 1e-6).all()


def test_free_time_mode_matches_jax_and_keeps_bounds():
    args = _skewed(seed=17)
    kw = dict(steps=2, rho=1.0, fix_total=False, t_min=0.05, t_max=20.0)
    res, jres = _port(args, **kw), _jax(args, **kw)
    np.testing.assert_allclose(res.times.numpy(), np.asarray(jres.times),
                               rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(res.obj.numpy(), np.asarray(jres.obj),
                               rtol=RTOL)
    assert bool((res.obj <= res.obj0 + 1e-9).all())
    m = _mask(args[3]) > 0
    t = res.times.numpy()
    assert (t[m] >= 0.05 - 1e-12).all() and (t[m] <= 20.0 + 1e-12).all()


def test_unsolved_scenarios_pass_through():
    state, hpolys, times, seg = _skewed(seed=23)
    times[0] = np.where(times[0] > 0, 1e-3, times[0])     # infeasible
    res = _port((state, hpolys, times, seg), steps=2)
    np.testing.assert_allclose(res.times[0].numpy(), times[0] * _mask(seg)[0])
    assert not bool(res.improved[0])
    assert float(res.obj0[0]) == refine._BAD


def test_deficit_floor_never_worse_than_input():
    """A fraction below min_frac engages the floor, so theta0's point is
    not the input; the raw-input baseline keeps the result no worse."""
    state, hpolys, times, seg = _skewed(n=1, seed=29)
    k = int(seg[0])
    times[0, 0] = 0.01 * times[0, :k].sum()
    res = _port((state, hpolys, times, seg), steps=1, min_frac=0.05)
    obj_in, solved_in = _snap(state, hpolys,
                              np.maximum(times, 0.05) + (1 - _mask(seg)), seg)
    if solved_in[0]:
        np.testing.assert_allclose(float(res.obj0[0]), obj_in[0], rtol=1e-6)
    assert float(res.obj[0]) <= float(res.obj0[0])
    if not bool(res.improved[0]):
        np.testing.assert_array_equal(res.times.numpy(), times * _mask(seg))
