"""Port parity, trajectories: allocnet_tpu_torch.planner.trajectory against
allocnet_tpu.planner.trajectory on the same seeded coefficients (CPU, f64),
and the certificate's own contract on the port (the spike that dense
sampling misses, as tests/test_certify.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.polynomial import polynomial as P

from allocnet_tpu.planner import trajectory as jtraj
from allocnet_tpu_torch.planner import trajectory
from tests.torch_threads import one_torch_thread  # noqa: F401

# f64 on both sides, the same formulas with sums in another order:
# agreement to a few ulps of the largest entry
RTOL = 1e-12


def _random(B=6, S=3, D=8, seed=1):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(B, S, 3, D)) * 0.5
    t = rng.uniform(0.5, 3.0, size=(B, S))
    seg = rng.integers(1, S + 1, size=B)
    return c, t, seg


def _both(c, t, seg):
    return (trajectory.from_solution(torch.tensor(c), torch.tensor(t),
                                     torch.tensor(seg)),
            jtraj.from_solution(jnp.asarray(c), jnp.asarray(t),
                                jnp.asarray(seg)))


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("seed", [1, 11])
def test_eval_sample_and_rates_match_jax(seed):
    tr, jtr = _both(*_random(B=8, S=4, seed=seed))
    _close(tr.total_time, jtr.total_time)
    rng = np.random.default_rng(seed + 100)
    tq = rng.uniform(-0.5, 1.1, size=8) * np.asarray(jtr.total_time)
    _close(trajectory.eval_state(tr, torch.tensor(tq)),
           jtraj.eval_state(jtr, jnp.asarray(tq)))
    t, st = trajectory.sample(tr, 17)
    jt, jst = jtraj.sample(jtr, 17)
    _close(t, jt)
    _close(st, jst)
    for a, b in zip(trajectory.max_rates(tr, 33), jtraj.max_rates(jtr, 33)):
        _close(a, b)


@pytest.mark.parametrize("levels", [0, 3, 5])
def test_certificates_match_jax(levels):
    c, t, seg = _random(B=8, S=4, seed=11)
    tr, jtr = _both(c, t, seg)
    for a, b in zip(trajectory.certified_max_rates(tr, levels),
                    jtraj.certified_max_rates(jtr, levels)):
        _close(a, b)
    for a, b in zip(trajectory.certified_axis_rates(tr, levels),
                    jtraj.certified_axis_rates(jtr, levels)):
        _close(a, b)
    v, a = trajectory.certified_axis_rates(tr, levels)
    for vmax, amax in ((float(v.max()), float(a.max())),
                       (float(v.median()), float(a.median()))):
        np.testing.assert_array_equal(
            trajectory.certify_box(tr, vmax, amax, levels).numpy(),
            np.asarray(jtraj.certify_box(jtr, vmax, amax, levels)))


def test_host_certificates_match_jax():
    c, t, seg = _random(B=8, S=4, seed=13)
    for a, b in zip(trajectory.certified_max_rates_host(c, t, seg, 4),
                    jtraj.certified_max_rates_host(c, t, seg, 4)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(trajectory.certified_axis_rates_host(c, t, seg, 5),
                    jtraj.certified_axis_rates_host(c, t, seg, 5)):
        np.testing.assert_array_equal(a, b)
    v, a = jtraj.certified_axis_rates_host(c, t, seg, 5)
    np.testing.assert_array_equal(
        trajectory.certify_box_host(c, t, seg, np.median(v), np.median(a), 5),
        jtraj.certify_box_host(c, t, seg, np.median(v), np.median(a), 5))
    # the device version in f64 gives the host version's bounds
    tr, _ = _both(c, t, seg)
    _close(trajectory.certified_axis_rates(tr, 5)[0], v, rtol=1e-9)


def test_certificate_rejects_inter_sample_spike():
    # v(tau) = (4 tau (1-tau))^3 peaks at 1.0 at tau = 0.5, between the
    # 6-point grid's nodes
    pos = P.polyint(P.polypow([0, 4, -4], 3))
    cc = np.zeros((1, 1, 3, 8))
    cc[0, 0, 0] = pos[::-1][:8]
    tr = trajectory.from_solution(torch.tensor(cc), torch.ones((1, 1),
                                  dtype=torch.float64), torch.tensor([1]))
    v_coarse, _ = trajectory.max_rates(tr, samples_per_seg=6)
    v_true, _ = trajectory.max_rates(tr, samples_per_seg=50001)
    vu, vl, _, _ = trajectory.certified_max_rates(tr, levels=4)
    assert float(v_coarse[0]) < 0.9 * float(v_true[0])
    assert float(vl[0]) <= float(v_true[0]) + 1e-9 <= float(vu[0]) + 2e-9
    assert not bool(trajectory.certify_box(tr, 0.95, 1e9)[0])
    assert bool(trajectory.certify_box(tr, 1.05, 1e9)[0])


def test_certificate_float32_against_float64():
    """In f32 the certificate carries ~1e-3 relative noise from the T^k
    powers (the JAX module's precision contract): hold the f32 bounds to
    the f64 ones at 1e-3 of the largest."""
    c, t, seg = _random(B=8, S=4, seed=17)
    tr64, _ = _both(c, t, seg)
    tr32 = trajectory.Trajectory(*(a.float() for a in tr64))
    for a, b in zip(trajectory.certified_axis_rates(tr32, 4),
                    trajectory.certified_axis_rates(tr64, 4)):
        assert a.dtype == torch.float32
        _close(a.double(), b, rtol=1e-3)


def test_taylor_shift_and_snap_cost_match_jax():
    c, t, seg = _random(B=5, S=3, seed=19)
    u = np.random.default_rng(20).uniform(0, 1, size=(5, 3))
    _close(trajectory.taylor_shift(torch.tensor(c), torch.tensor(u)),
           jtraj.taylor_shift(jnp.asarray(c), jnp.asarray(u)))
    tr, jtr = _both(c, t, seg)
    for compat in (True, False):
        _close(trajectory.snap_cost(tr, 4, compat),
               jtraj.snap_cost(jtr, 4, compat))
    # the shifted polynomial at s equals the original at u + s
    q = trajectory.taylor_shift(torch.tensor(c), torch.tensor(u)).numpy()
    s = 0.3
    val_q = np.polyval(q[0, 0, 1], s)
    val_p = np.polyval(c[0, 0, 1], u[0, 0] + s)
    assert abs(val_q - val_p) <= 1e-12 * max(1.0, abs(val_p))
