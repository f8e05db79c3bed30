"""Control-rate trajectory sampling (the reference's 1 kHz process() loop,
learning_planning.cpp:217-304): trajectory state and flatness outputs at
query times, with the reference's telemetry (speed, thrust, tilt, body
rate; visualizer.hpp:57-60).

Port of `allocnet_tpu/planner/control.py`: one call evaluates a whole
horizon of control ticks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from allocnet_tpu_torch.config import PhysParams
from allocnet_tpu_torch.planner import flatness, trajectory


class ControlSample(NamedTuple):
    pos: torch.Tensor      # (..., 3)
    vel: torch.Tensor
    acc: torch.Tensor
    jerk: torch.Tensor
    thrust: torch.Tensor   # (...,)
    quat: torch.Tensor     # (..., 4)
    omega: torch.Tensor    # (..., 3)
    speed: torch.Tensor    # (...,)
    tilt: torch.Tensor     # (...,) radians, from the quaternion


def sample_controls(traj: trajectory.Trajectory, phys: PhysParams,
                    t: torch.Tensor, psi=None, dpsi=None) -> ControlSample:
    """Control outputs at global times t (B,) of a trajectory batch (one
    time per trajectory)."""
    st = trajectory.eval_state(traj, t, max_deriv=3)       # (B, 4, 3)
    pos, vel, acc, jerk = st[:, 0], st[:, 1], st[:, 2], st[:, 3]
    zeros = torch.zeros_like(pos[:, 0])
    psi = zeros if psi is None else psi
    dpsi = zeros if dpsi is None else dpsi
    out = flatness.forward(phys, vel, acc, jerk, psi, dpsi)
    speed = torch.linalg.vector_norm(vel, dim=-1)
    q = out.quat
    tilt = torch.arccos(torch.clamp(1.0 - 2.0 * (q[..., 1] ** 2
                                                 + q[..., 2] ** 2),
                                    -1.0, 1.0))
    return ControlSample(pos=pos, vel=vel, acc=acc, jerk=jerk,
                         thrust=out.thrust, quat=q, omega=out.omega,
                         speed=speed, tilt=tilt)


def control_horizon(traj: trajectory.Trajectory, phys: PhysParams,
                    rate_hz: float = 1000.0, horizon_s: float = 1.0,
                    t0: float = 0.0) -> ControlSample:
    """Every control tick of a horizon for trajectories 0..B-1 at once:
    fields (B, n_ticks, ...)."""
    n = int(rate_hz * horizon_s)
    B = traj.coeffs.shape[0]
    ts = t0 + torch.arange(n, dtype=traj.times.dtype,
                           device=traj.times.device) / rate_hz
    rep = trajectory.Trajectory(*(a.repeat_interleave(n, dim=0)
                                  for a in traj))
    cs = sample_controls(rep, phys, ts.repeat(B))
    return ControlSample(*(a.reshape((B, n) + a.shape[1:]) for a in cs))
