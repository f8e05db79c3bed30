"""Batched piecewise-polynomial trajectories: evaluation, sampling, rate
checks and Bernstein certificates.

Port of `allocnet_tpu/planner/trajectory.py` (the reference's Piece /
Trajectory templates, trajectory.hpp:37-645).  Coefficients are stored
highest degree first per (segment, axis), the reference layout
(trajectory.hpp:75-85).  Rates are bounded by dense sampling (`max_rates`)
or certified by the Bernstein hull with de Casteljau subdivision
(`certified_*`); the `_host` functions are float64 NumPy mirrors of the
certificates for callers that need a proof from float32 results.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from allocnet_tpu_torch.ops import bases


class Trajectory(NamedTuple):
    """Batch of piecewise-polynomial trajectories.

    coeffs: (B, S, 3, D) physical coefficients, highest degree first
    times:  (B, S) segment durations (padding arbitrary)
    seg_mask: (B, S) 1.0 for active segments
    """

    coeffs: torch.Tensor
    times: torch.Tensor
    seg_mask: torch.Tensor

    @property
    def total_time(self) -> torch.Tensor:
        return (self.times * self.seg_mask).sum(-1)


def from_solution(coeffs: torch.Tensor, times: torch.Tensor,
                  seg: torch.Tensor) -> Trajectory:
    S = times.shape[-1]
    seg = torch.as_tensor(seg, device=times.device)
    mask = (torch.arange(S, device=times.device)[None, :]
            < seg[:, None]).to(times.dtype)
    return Trajectory(coeffs=coeffs, times=times * mask, seg_mask=mask)


def _locate(traj: Trajectory, t: torch.Tensor):
    """Global time -> (segment index, local time) (trajectory.hpp:518-543).
    t: (B,)."""
    dt = traj.times * traj.seg_mask
    cum = dt.cumsum(-1)
    start = cum - dt
    t_clip = torch.minimum(torch.clamp_min(t, 0.0), cum[:, -1])
    # last active segment whose start <= t
    idx = ((start <= t_clip[:, None]) & (traj.seg_mask > 0)).sum(-1) - 1
    idx = idx.clamp(0, dt.shape[-1] - 1)
    local = t_clip - torch.gather(start, 1, idx[:, None])[:, 0]
    return idx, local


def _deriv_row(D: int, r: int, t: torch.Tensor) -> torch.Tensor:
    """(..., D) row of d^r/dt^r of (t^{D-1}, ..., t, 1)."""
    rows = []
    for k in range(D):
        deg = D - 1 - k
        if deg >= r:
            rows.append(bases.falling_factorial(deg, r) * t ** (deg - r))
        else:
            rows.append(torch.zeros_like(t))
    return torch.stack(rows, dim=-1)


def eval_state(traj: Trajectory, t: torch.Tensor,
               max_deriv: int = 3) -> torch.Tensor:
    """(pos, vel, acc, ...) at global times t (B,): (B, max_deriv+1, 3)."""
    D = traj.coeffs.shape[-1]
    idx, local = _locate(traj, t)
    c = traj.coeffs[torch.arange(t.shape[0], device=t.device), idx]
    rows = torch.stack([_deriv_row(D, r, local)
                        for r in range(max_deriv + 1)], dim=1)
    return torch.einsum('brd,bjd->brj', rows, c)


def sample(traj: Trajectory, n: int, max_deriv: int = 2):
    """n uniform samples over [0, total_time]: (t (B, n), states (B, n,
    max_deriv+1, 3))."""
    B = traj.coeffs.shape[0]
    frac = torch.linspace(0.0, 1.0, n, dtype=traj.times.dtype,
                          device=traj.times.device)
    t = traj.total_time[:, None] * frac[None, :]
    rep = Trajectory(*(a.repeat_interleave(n, dim=0) for a in traj))
    states = eval_state(rep, t.reshape(-1), max_deriv)
    return t, states.reshape(B, n, max_deriv + 1, 3)


def max_rates(traj: Trajectory, samples_per_seg: int = 64):
    """(max |vel|, max |acc|) per trajectory by dense sampling in tau:
    the norm over axes, the max over segments and samples."""
    D = traj.coeffs.shape[-1]
    taus = torch.as_tensor(np.linspace(0.0, 1.0, samples_per_seg),
                           dtype=traj.times.dtype, device=traj.times.device)
    t = traj.times[:, :, None] * taus
    vel = torch.einsum('bsnd,bsjd->bsnj', _deriv_row(D, 1, t), traj.coeffs)
    acc = torch.einsum('bsnd,bsjd->bsnj', _deriv_row(D, 2, t), traj.coeffs)
    m = traj.seg_mask[:, :, None]
    vmag = torch.linalg.vector_norm(vel, dim=-1) * m
    amag = torch.linalg.vector_norm(acc, dim=-1) * m
    return vmag.amax((1, 2)), amag.amax((1, 2))


def _deriv_tau_coeffs(traj: Trajectory, r: int) -> torch.Tensor:
    """Coefficients of d^r p/dt^r composed with t = T_i tau, ascending in
    tau: (B, S, 3, D-r), q_k = fall(k+r, r) c_{k+r} T^k with c the
    ascending physical coefficients."""
    D = traj.coeffs.shape[-1]
    dtype, dev = traj.coeffs.dtype, traj.coeffs.device
    c_deg = traj.coeffs.flip(-1)
    K = D - r
    fall = torch.as_tensor([bases.falling_factorial(k + r, r)
                            for k in range(K)], dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    tsafe = torch.where(traj.seg_mask > 0, torch.clamp_min(traj.times, 1e-9),
                        one)
    tp = tsafe[:, :, None] ** torch.arange(K, dtype=dtype, device=dev)
    return c_deg[..., r:] * fall * tp[:, :, None, :]


def _mono_to_bernstein(n: int) -> np.ndarray:
    """(n+1, n+1): ascending monomial coefficients on [0, 1] -> Bernstein
    coefficients, b_j = sum_{k<=j} C(j,k)/C(n,k) a_k."""
    A = np.zeros((n + 1, n + 1))
    for j in range(n + 1):
        for k in range(j + 1):
            A[j, k] = math.comb(j, k) / math.comb(n, k)
    return A


def _bernstein_product(n: int) -> np.ndarray:
    """(2n+1, n+1, n+1) tensor squaring a degree-n Bernstein form."""
    P = np.zeros((2 * n + 1, n + 1, n + 1))
    for i in range(n + 1):
        for j in range(n + 1):
            P[i + j, i, j] = (math.comb(n, i) * math.comb(n, j)
                              / math.comb(2 * n, i + j))
    return P


def _subdivision_matrices(n: int) -> tuple[np.ndarray, np.ndarray]:
    """de Casteljau split at 1/2: (L, R) give the Bernstein coefficients of
    the two halves."""
    L = np.zeros((n + 1, n + 1))
    for j in range(n + 1):
        for k in range(j + 1):
            L[j, k] = math.comb(j, k) * 0.5 ** j
    R = np.zeros((n + 1, n + 1))
    for j in range(n + 1):
        for k in range(j, n + 1):
            R[j, k] = math.comb(n - j, k - j) * 0.5 ** (n - j)
    return L, R


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _sq_norm_bernstein(e: torch.Tensor) -> torch.Tensor:
    """Bernstein coefficients of |v|^2 on [0, 1] from ascending monomial
    derivative coefficients e (..., 3, K); the squaring happens in
    Bernstein space, which float32 tolerates (see the JAX module)."""
    K = e.shape[-1]
    b1 = torch.einsum('jk,...xk->...xj', _const(_mono_to_bernstein(K - 1), e),
                      e)
    P = _const(_bernstein_product(K - 1), e)
    return torch.einsum('mij,...xi,...xj->...m', P, b1, b1)


def _subdivide(b: torch.Tensor, levels: int, axis: int) -> torch.Tensor:
    """`levels` rounds of de Casteljau bisection of Bernstein coefficients
    in the last dim; the halves stack along `axis`."""
    L, R = (_const(m, b) for m in _subdivision_matrices(b.shape[-1] - 1))
    for _ in range(levels):
        b = torch.cat([torch.einsum('jk,...k->...j', L, b),
                       torch.einsum('jk,...k->...j', R, b)], dim=axis)
    return b


def certified_max_rates(traj: Trajectory, levels: int = 3):
    """Certified bounds on max |vel| and max |acc| (the norm) over each
    trajectory: (vel_ub, vel_lb, acc_ub, acc_lb).  The squared-rate
    polynomial is bounded by its Bernstein coefficients (convex hull),
    tightened by `levels` rounds of subdivision; lb is attained at an
    interval endpoint.  In float32 read the bounds with a ~1% guard band;
    the `_host` version runs in float64."""
    def bounds(r: int):
        b = _sq_norm_bernstein(_deriv_tau_coeffs(traj, r))[:, :, None, :]
        b = _subdivide(b, levels, axis=2)
        mask = traj.seg_mask[:, :, None, None] > 0
        ninf = torch.full((), -math.inf, dtype=b.dtype, device=b.device)
        ub = torch.where(mask, b, ninf).amax((1, 2, 3))
        ends = torch.maximum(b[..., 0], b[..., -1])
        lb = torch.where(mask[..., 0], ends, ninf).amax((1, 2))
        return (torch.sqrt(torch.clamp_min(ub, 0.0)),
                torch.sqrt(torch.clamp_min(lb, 0.0)))

    vel_ub, vel_lb = bounds(1)
    acc_ub, acc_lb = bounds(2)
    return vel_ub, vel_lb, acc_ub, acc_lb


def certified_axis_rates(traj: Trajectory, levels: int = 4):
    """Per-axis certified upper bounds (max over t and axes of |vel_axis|,
    of |acc_axis|): the Bernstein hull of the derivative polynomials
    themselves, the bound matching the QP's per-axis box constraints
    (qp_solver.hpp:255-296)."""
    def bound(r: int) -> torch.Tensor:
        e = _deriv_tau_coeffs(traj, r)
        A = _const(_mono_to_bernstein(e.shape[-1] - 1), e)
        b = torch.einsum('jk,bsxk->bsxj', A, e)[:, :, :, None, :]
        b = _subdivide(b, levels, axis=3)
        mask = traj.seg_mask[:, :, None, None, None] > 0
        ninf = torch.full((), -math.inf, dtype=b.dtype, device=b.device)
        return torch.where(mask, b.abs(), ninf).amax((1, 2, 3, 4))

    return bound(1), bound(2)


def certify_box(traj: Trajectory, max_vel: float, max_acc: float,
                levels: int = 4) -> torch.Tensor:
    """(B,) bool, True = proof that |vel_axis| <= max_vel and |acc_axis| <=
    max_acc hold for all t (the QP's constraint semantics).  A False may be
    a looseness of the bound; raise `levels` to tighten."""
    vel_ub, acc_ub = certified_axis_rates(traj, levels=levels)
    return (vel_ub <= max_vel) & (acc_ub <= max_acc)


def _host_deriv_tau(coeffs, times, seg, r):
    """NumPy float64 `_deriv_tau_coeffs` and the (B, S) active mask."""
    coeffs = np.asarray(coeffs, np.float64)
    times = np.asarray(times, np.float64)
    S, D = coeffs.shape[1], coeffs.shape[3]
    mask = np.arange(S)[None, :] < np.asarray(seg)[:, None]
    tsafe = np.where(mask, np.maximum(times, 1e-9), 1.0)
    K = D - r
    fall = np.array([bases.falling_factorial(k + r, r) for k in range(K)],
                    np.float64)
    tp = tsafe[:, :, None] ** np.arange(K)[None, None]
    return coeffs[..., ::-1][..., r:] * fall * tp[:, :, None, :], mask


def certified_max_rates_host(coeffs: np.ndarray, times: np.ndarray,
                             seg: np.ndarray, levels: int = 4):
    """Float64 NumPy mirror of `certified_max_rates`, upper bounds only:
    (vel_ub, acc_ub)."""
    def ub(r: int) -> np.ndarray:
        e, mask = _host_deriv_tau(coeffs, times, seg, r)
        K = e.shape[-1]
        b1 = np.einsum('jk,bsxk->bsxj', _mono_to_bernstein(K - 1), e)
        b = np.einsum('mij,bsxi,bsxj->bsm', _bernstein_product(K - 1), b1,
                      b1)[:, :, None, :]
        L, R = _subdivision_matrices(b.shape[-1] - 1)
        for _ in range(levels):
            b = np.concatenate([np.einsum('jk,bsik->bsij', L, b),
                                np.einsum('jk,bsik->bsij', R, b)], axis=2)
        hi = np.max(np.where(mask[:, :, None, None], b, -np.inf),
                    axis=(1, 2, 3))
        return np.sqrt(np.maximum(hi, 0.0))

    return ub(1), ub(2)


def certified_axis_rates_host(coeffs: np.ndarray, times: np.ndarray,
                              seg: np.ndarray, levels: int = 4):
    """Float64 NumPy mirror of `certified_axis_rates`."""
    def ub(r: int) -> np.ndarray:
        e, mask = _host_deriv_tau(coeffs, times, seg, r)
        K = e.shape[-1]
        b = np.einsum('jk,bsxk->bsxj', _mono_to_bernstein(K - 1),
                      e)[:, :, :, None, :]
        L, R = _subdivision_matrices(K - 1)
        for _ in range(levels):
            b = np.concatenate([np.einsum('jk,bsxik->bsxij', L, b),
                                np.einsum('jk,bsxik->bsxij', R, b)], axis=3)
        return np.max(np.where(mask[:, :, None, None, None], np.abs(b),
                               -np.inf), axis=(1, 2, 3, 4))

    return ub(1), ub(2)


def certify_box_host(coeffs: np.ndarray, times: np.ndarray, seg: np.ndarray,
                     max_vel: float, max_acc: float,
                     levels: int = 4) -> np.ndarray:
    """Host float64 `certify_box`: (B,) bool."""
    vel_ub, acc_ub = certified_axis_rates_host(coeffs, times, seg, levels)
    return (vel_ub <= max_vel) & (acc_ub <= max_acc)


def taylor_shift(coeffs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Re-root polynomials at t = u: q(s) = p(u + s).  coeffs (..., 3, D)
    highest degree first; u (...) over the leading dims."""
    D = coeffs.shape[-1]
    comb = np.array([[math.comb(d, j) if d >= j else 0.0 for d in range(D)]
                     for j in range(D)])
    pows = np.array([[max(d - j, 0) for d in range(D)] for j in range(D)])
    # M[..., j, d] = C(d, j) u^{d-j} (degree-indexed, lowest first)
    M = _const(comb, coeffs) * u[..., None, None] ** _const(pows, coeffs)
    M = M * _const(comb > 0, coeffs)
    q_deg = torch.einsum('...jd,...xd->...xj', M, coeffs.flip(-1))
    return q_deg.flip(-1)


def snap_cost(traj: Trajectory, order: int,
              reference_compat: bool = False) -> torch.Tensor:
    """Integral of the squared order-th derivative (reference
    getTrajCost, trajectory.hpp:354-427) via the unit-interval Gram;
    reference_compat reproduces the reference's m_34 Gram entry."""
    D = traj.coeffs.shape[-1]
    Qh = _const(bases.gram_matrix(order, reference_compat=reference_compat),
                traj.coeffs)
    pw = _const(bases.unscale_powers(D), traj.coeffs)
    one = torch.ones((), dtype=traj.times.dtype, device=traj.times.device)
    tsafe = torch.where(traj.seg_mask > 0, torch.clamp_min(traj.times, 1e-6),
                        one)
    cs = traj.coeffs * (tsafe[:, :, None] ** pw)[:, :, None, :]
    per_seg = torch.einsum('bsjd,de,bsje->bs', cs, Qh, cs)
    w = tsafe ** (-(2 * order - 1))
    return (per_seg * w * traj.seg_mask).sum(-1)
