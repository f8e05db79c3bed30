"""Quadrotor differential-flatness map.

Port of `allocnet_tpu/planner/flatness.py` (the reference's FlatnessMap,
flatness.hpp:54-134).  The reference hand-writes the adjoint
(flatness.hpp:136-260); here `backward` is `torch.func.vjp` of the same
forward, as the JAX module's is `jax.vjp`.

Inputs follow the reference: (vel, acc, jerk, psi, dpsi) -> (thrust,
quaternion wxyz, body rate), batched over a leading axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from allocnet_tpu_torch.config import PhysParams


class FlatOutputs(NamedTuple):
    thrust: torch.Tensor   # (B,)
    quat: torch.Tensor     # (B, 4) wxyz
    omega: torch.Tensor    # (B, 3) body rate


def forward(phys: PhysParams, vel, acc, jerk, psi, dpsi) -> FlatOutputs:
    """vel, acc, jerk (B, 3), psi, dpsi (B,) -> FlatOutputs."""
    m = phys.vehicle_mass
    g = phys.grav_acc
    dh, dv, cp, veps = (phys.horiz_drag, phys.vert_drag,
                        phys.parasitic_drag, phys.speed_smooth)

    # drag-augmented specific force direction (flatness.hpp:71-90)
    speed = torch.sqrt((vel * vel).sum(-1) + veps)
    w_term = 1.0 + cp * speed
    w = w_term[..., None] * vel
    dh_m = dh / m
    gvec = torch.zeros_like(vel)
    gvec[..., 2] = g
    zu = acc + dh_m * w + gvec

    zu_norm = torch.linalg.vector_norm(zu, dim=-1, keepdim=True)
    z = zu / zu_norm

    # time derivative of the unit vector z (flatness.hpp:91-108):
    # dz = (I - z z^T) dz_in / |zu|
    v_dot_a = (vel * acc).sum(-1)
    dw_term = cp * v_dot_a / speed
    dw = w_term[..., None] * acc + dw_term[..., None] * vel
    dz_in = jerk + dh_m * dw
    dz = (dz_in - z * (z * dz_in).sum(-1, keepdim=True)) / zu_norm

    # collective thrust (flatness.hpp:109-112)
    f_term = m * acc + dv * w + m * gvec
    thrust = (z * f_term).sum(-1)

    # tilt quaternion composed with yaw (flatness.hpp:113-122), wxyz
    tilt_den = torch.sqrt(2.0 * (1.0 + z[..., 2]))
    tilt0 = 0.5 * tilt_den
    tilt1 = -z[..., 1] / tilt_den
    tilt2 = z[..., 0] / tilt_den
    c_half = torch.cos(0.5 * psi)
    s_half = torch.sin(0.5 * psi)
    quat = torch.stack([
        tilt0 * c_half,
        tilt1 * c_half + tilt2 * s_half,
        tilt2 * c_half - tilt1 * s_half,
        tilt0 * s_half,
    ], dim=-1)

    # body rates (flatness.hpp:123-131)
    c_psi = torch.cos(psi)
    s_psi = torch.sin(psi)
    omg_den = z[..., 2] + 1.0
    omg_term = dz[..., 2] / omg_den
    omega = torch.stack([
        dz[..., 0] * s_psi - dz[..., 1] * c_psi
        - (z[..., 0] * s_psi - z[..., 1] * c_psi) * omg_term,
        dz[..., 0] * c_psi + dz[..., 1] * s_psi
        - (z[..., 0] * c_psi + z[..., 1] * s_psi) * omg_term,
        (z[..., 1] * dz[..., 0] - z[..., 0] * dz[..., 1]) / omg_den + dpsi,
    ], dim=-1)

    return FlatOutputs(thrust=thrust, quat=quat, omega=omega)


def backward(phys: PhysParams, vel, acc, jerk, psi, dpsi,
             thr_grad, quat_grad, omg_grad):
    """Adjoint of `forward` (the reference's FlatnessMap::backward,
    flatness.hpp:136-260).  Returns (vel_grad, acc_grad, jerk_grad,
    psi_grad, dpsi_grad)."""
    _, vjp = torch.func.vjp(
        lambda v, a, j, p, dp: tuple(forward(phys, v, a, j, p, dp)),
        vel, acc, jerk, psi, dpsi)
    return vjp((thr_grad, quat_grad, omg_grad))
