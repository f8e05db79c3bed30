"""Port parity, flatness map and control sampling: allocnet_tpu_torch.
planner.flatness (forward and its vjp adjoint) and planner.control against
allocnet_tpu's on the CPU in f64, on random flat states and on a solved
trajectory's control horizon.  The same arithmetic on both sides: every
output to 1e-10 of its largest entry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allocnet_tpu.config import PhysParams as JPhysParams
from allocnet_tpu.config import QPConfig as JQPConfig
from allocnet_tpu.config import SolverConfig as JSolverConfig
from allocnet_tpu.ops import admm as jadmm
from allocnet_tpu.ops import qp as jqp
from allocnet_tpu.planner import control as jcontrol
from allocnet_tpu.planner import flatness as jflatness
from allocnet_tpu.planner import trajectory as jtrajectory
from allocnet_tpu_torch.config import PhysParams, QPConfig
from allocnet_tpu_torch.planner import control, flatness, trajectory
from allocnet_tpu_torch.utils import scenarios
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-10


def _close(a, b):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b,
                               atol=TOL * max(1.0, np.abs(b).max()))


@pytest.fixture(scope="module")
def flat_inputs():
    rng = np.random.default_rng(3)
    B = 64
    return (rng.normal(0, 2, (B, 3)), rng.normal(0, 3, (B, 3)),
            rng.normal(0, 5, (B, 3)), rng.uniform(-np.pi, np.pi, B),
            rng.normal(0, 1, B))


def test_flatness_forward_matches_jax(flat_inputs):
    out = flatness.forward(PhysParams(), *(torch.tensor(a)
                                           for a in flat_inputs))
    jout = jflatness.forward(JPhysParams(), *(jnp.asarray(a)
                                              for a in flat_inputs))
    for a, b in zip(out, jout):
        _close(a.numpy(), b)
    # unit quaternions, thrust at hover ~ m g
    np.testing.assert_allclose(out.quat.norm(dim=-1).numpy(), 1.0, atol=1e-12)
    hover = flatness.forward(PhysParams(), *(torch.zeros(1, 3),) * 3,
                             torch.zeros(1), torch.zeros(1))
    np.testing.assert_allclose(float(hover.thrust[0]),
                               PhysParams().vehicle_mass * 9.81, rtol=1e-6)


def test_flatness_backward_matches_jax(flat_inputs):
    rng = np.random.default_rng(4)
    B = flat_inputs[0].shape[0]
    cot = (rng.normal(size=B), rng.normal(size=(B, 4)),
           rng.normal(size=(B, 3)))
    grads = flatness.backward(PhysParams(),
                              *(torch.tensor(a) for a in flat_inputs + cot))
    jgrads = jflatness.backward(JPhysParams(),
                                *(jnp.asarray(a) for a in flat_inputs + cot))
    assert len(grads) == len(jgrads) == 5
    for a, b in zip(grads, jgrads):
        _close(a.numpy(), b)


@pytest.fixture(scope="module")
def solved_traj():
    """A solved f64 trajectory (the JAX solve; both sides sample the same
    coefficients)."""
    cfg = JQPConfig(res=10)
    sc = scenarios.random_scenarios(QPConfig(res=10), 4, seed=71, min_seg=2)
    data = jqp.build_qp(cfg, *(jnp.asarray(x) for x in (
        sc.state, sc.hpolys, sc.times, sc.seg)))
    sol = jadmm.solve_qp(data, JSolverConfig(n_chunks=2, iters_per_chunk=100))
    assert np.asarray(sol.solved).all()
    return np.asarray(sol.coeffs), np.asarray(sc.times), np.asarray(sc.seg)


@pytest.mark.parametrize("rate_hz,horizon_s,t0", [(1000.0, 0.1, 0.0),
                                                  (50.0, 2.0, 0.7)])
def test_control_horizon_matches_jax(solved_traj, rate_hz, horizon_s, t0):
    coeffs, times, seg = solved_traj
    traj = trajectory.from_solution(torch.tensor(coeffs), torch.tensor(times),
                                    torch.tensor(seg))
    jtraj = jtrajectory.from_solution(jnp.asarray(coeffs), jnp.asarray(times),
                                      jnp.asarray(seg))
    cs = control.control_horizon(traj, PhysParams(), rate_hz, horizon_s, t0)
    jcs = jcontrol.control_horizon(jtraj, JPhysParams(), rate_hz, horizon_s,
                                   t0)
    n = int(rate_hz * horizon_s)
    assert cs.thrust.shape == (4, n)
    for name, a, b in zip(cs._fields, cs, jcs):
        assert a.shape == np.asarray(b).shape, name
        _close(a.numpy(), b)
    assert bool((cs.thrust > 0).all())
