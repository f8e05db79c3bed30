"""Polynomial time-power bases on the unit interval (numpy), a copy of
`allocnet_tpu/ops/bases.py`.

Reformulation of the reference's time-power basis rows
(`get_t_state`, qp_solver.hpp:90-116 / min_traj_opt.py:300-335).

The reference evaluates bases at physical times t, which produces rows
spanning 14 orders of magnitude (t^7 vs 1) and an ill-conditioned QP.  We
instead re-parametrize each segment to unit time tau = t / T_i:

    p(t)   = sum_k c_k t^{D-1-k}          (original, highest-degree-first,
                                           matching trajectory.hpp:75-85)
    q(tau) = sum_k c'_k tau^{D-1-k},      c'_k = c_k * T^{D-1-k}
    d^r p / dt^r (t) = T^{-r} * d^r q / dtau^r (tau)

All basis matrices below are CONSTANT (independent of segment times), which
is what makes the batched QP assembly a handful of einsums with no
data-dependent shapes.
"""

from __future__ import annotations

import functools

import numpy as np


def falling_factorial(n: int, r: int) -> float:
    """n * (n-1) * ... * (n-r+1); 1 for r == 0."""
    out = 1.0
    for i in range(r):
        out *= n - i
    return out


@functools.lru_cache(maxsize=None)
def basis_row(D: int, r: int, tau: float) -> np.ndarray:
    """Row beta_r(tau) in R^D with the reference's highest-degree-first layout:
    entry k multiplies coefficient of tau^{D-1-k}.

    beta_r(tau)_k = falling(D-1-k, r) * tau^{D-1-k-r}   (0 when D-1-k < r)

    At tau=0 this reproduces the reference's `zero_A` rows
    (qp_solver.hpp:69-81, min_traj_opt.py:56-65); at general tau it matches
    `get_t_state` rows up to the T^{...} column scaling absorbed into c'.
    """
    row = np.zeros(D, dtype=np.float64)
    for k in range(D):
        deg = D - 1 - k
        if deg >= r:
            row[k] = falling_factorial(deg, r) * (tau ** (deg - r))
    return row


def basis_matrix(D: int, r: int, taus: np.ndarray) -> np.ndarray:
    """(len(taus), D) matrix of beta_r rows."""
    return np.stack([basis_row(D, r, float(t)) for t in np.asarray(taus)])


@functools.lru_cache(maxsize=None)
def sample_taus(res: int) -> np.ndarray:
    """Constraint sample points tau_s = s / res, s = 0..res-1.

    Reference quirk preserved: samples cover [0, 1) only — the segment end
    point is NOT sampled (qp_solver.hpp:261-272, min_traj_opt.py:560-570),
    and the s=0 row is the zero-time basis.
    """
    return np.arange(res, dtype=np.float64) / float(res)


@functools.lru_cache(maxsize=None)
def sampled_bases(D: int, res: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(B0, B1, B2): (res, D) position/velocity/acceleration basis matrices at
    the constraint sample points."""
    taus = sample_taus(res)
    return (
        basis_matrix(D, 0, taus),
        basis_matrix(D, 1, taus),
        basis_matrix(D, 2, taus),
    )


@functools.lru_cache(maxsize=None)
def boundary_bases(D: int, n_deriv: int, tau: float) -> np.ndarray:
    """(n_deriv, D) stacked beta_0..beta_{n_deriv-1} at a boundary point.

    boundary_bases(D, 3, 0.0) == the reference's zero_A[0:3] rows;
    boundary_bases(D, order, 1.0) == unit-time analog of get_t_state(T)."""
    return np.stack([basis_row(D, r, tau) for r in range(n_deriv)])


@functools.lru_cache(maxsize=None)
def gram_matrix(order: int, reference_compat: bool = True) -> np.ndarray:
    """D x D Gram matrix of the order-th derivative on [0, 1]:

        Qhat_{kl} = integral_0^1 beta_order(tau)_k * beta_order(tau)_l dtau

    The per-segment Hessian block in scaled variables is T^{-(2*order-1)} Qhat
    — verified against the reference's closed-form CostQ blocks
    (qp_solver.hpp:197-235, min_traj_opt.py:464-505): e.g. for order=4,
    Qhat_00 = 840^2/7 = 100800 and CostQ_00 = 100800 * t^7.

    Only the top-left order x order block (coefficients of degree >= order) is
    nonzero, matching the reference's order x order CostQ placement
    (qp_solver.hpp:240).

    KNOWN REFERENCE BUG (documented per SURVEY.md section 7): for order=4 the
    reference hardcodes m_34 = 1400 * t^2 in BOTH its C++ and Python copies
    (qp_solver.hpp:213, min_traj_opt.py:493), but the true snap Gram entry is
    integral(120 tau * 24) = 1440.  With reference_compat=True (default) we
    reproduce 1400 so solutions/objectives match the deployed system (whose
    network weights were trained against that objective); pass
    reference_compat=False for the mathematically exact minimum-snap cost.
    """
    D = 2 * order
    Q = np.zeros((D, D), dtype=np.float64)
    for k in range(D):
        dk = D - 1 - k
        if dk < order:
            continue
        for l in range(D):
            dl = D - 1 - l
            if dl < order:
                continue
            fk = falling_factorial(dk, order)
            fl = falling_factorial(dl, order)
            # integral of tau^{dk-order} * tau^{dl-order}
            Q[k, l] = fk * fl / (dk + dl - 2 * order + 1)
    if reference_compat and order == 4:
        Q[2, 3] = Q[3, 2] = 1400.0
    return Q


@functools.lru_cache(maxsize=None)
def slot_scales(D: int, order: int) -> np.ndarray:
    """Per-coefficient equilibration scales s_k = max(1, falling(deg_k, order)).

    Without scaling, the order-th-derivative Gram spans up to 100800 (snap)
    and the KKT condition number exceeds what float32 can carry through an
    iterative solver.  Scaling by the full falling factorial (alpha=1) fixes
    the Gram but makes the tau=1 boundary rows nearly rank-deficient
    (entries 1/840).  The balanced exponent alpha = 2/3 equalizes the two
    extremes: Gram max ~ f^(2-2a) == boundary-row min ~ f^(-a) at f^(2/3)
    (~89 for snap, ~14 for jerk).  Composes with the per-segment T^deg time
    scaling into one diagonal variable change, exactly invertible.
    """
    return np.array([
        max(1.0, falling_factorial(D - 1 - k, order)) ** (2.0 / 3.0)
        for k in range(D)
    ])


@functools.lru_cache(maxsize=None)
def unscale_powers(D: int) -> np.ndarray:
    """Exponent e_k = D-1-k such that c_k = c'_k / T^{e_k} recovers original
    (physical-time) coefficients from scaled ones."""
    return np.arange(D - 1, -1, -1, dtype=np.float64)
