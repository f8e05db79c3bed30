"""MINCO-style segment-time refinement through the differentiable QP.

Port of `allocnet_tpu/planner/refine.py` (its docstring gives the method):
a few accept/reject steps of gradient descent on the QP's optimal value as
a function of the segment times, batched over scenarios, each step one
differentiable solve (ops/qp_diff.py).

* ``fix_total=True`` (default): T = T_tot * softmax(theta) over the active
  slots with a deficit-only floor at ``min_frac`` of the total, so the
  network's total time is kept exactly.
* ``fix_total=False``: free-time descent on J(T) + rho * sum(T), T =
  exp(theta) clamped to [t_min, t_max] (rho > 0 needed).

The JAX module's `lax.scan` is a Python loop here.  The refined allocation
is returned only where it strictly beats the objective at the raw input
allocation (one extra forward solve), so the result is never worse than
the input.  Runs with autograd on whatever the caller's grad mode is.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from allocnet_tpu_torch.config import QPConfig, SolverConfig
from allocnet_tpu_torch.ops import qp_diff

_BAD = 1e30


class RefineResult(NamedTuple):
    times: torch.Tensor      # (B, S) refined segment times (masked)
    obj: torch.Tensor        # (B,) J + rho*sum(T) at the refined allocation
    obj0: torch.Tensor       # (B,) same objective at the input allocation
    improved: torch.Tensor   # (B,) bool: obj < obj0 (strict)


def refine_times(cfg: QPConfig, scfg: SolverConfig, state, hpolys, times, seg,
                 *, steps: int = 8, lr: float = 0.5, rho: float = 0.0,
                 fix_total: bool = True, min_frac: float = 0.02,
                 t_min: float = 0.05, t_max: float = 20.0) -> RefineResult:
    """Refine the per-segment times (B, S) by descending the QP value.

    state (B, 2, 3, 3), hpolys (B, S, F, 4), times, seg (B,): tensors on
    one device.  Each step costs one differentiable solve (forward ADMM and
    polish, one active-set KKT backward)."""
    S = cfg.max_seg
    dtype, dev = times.dtype, times.device
    seg = torch.as_tensor(seg, device=dev).long()
    state, hpolys, times = (t.detach() for t in (state, hpolys, times))
    seg_mask = (torch.arange(S, device=dev)[None, :] < seg[:, None]).to(dtype)
    one = torch.ones((), dtype=dtype, device=dev)
    bad = torch.full((), _BAD, dtype=dtype, device=dev)
    t0_safe = torch.where(seg_mask > 0, torch.clamp_min(times, t_min), one)
    t_tot = (t0_safe * seg_mask).sum(1, keepdim=True)

    def theta_to_times(theta):
        if fix_total:
            logits = torch.where(seg_mask > 0, theta,
                                 torch.full((), -torch.inf, dtype=dtype,
                                            device=dev))
            p = torch.softmax(logits, dim=1) * seg_mask
            # deficit-only floor: raise fractions below min_frac to it and
            # take the surplus proportionally from those above; the
            # identity when every fraction clears the floor, so theta0 maps
            # to the input allocation exactly
            floor = torch.full((), min_frac, dtype=dtype, device=dev)
            pf = torch.maximum(p, floor) * seg_mask
            deficit = (pf - p).sum(1, keepdim=True)
            above = torch.clamp_min(p - min_frac, 0.0) * seg_mask
            denom = torch.clamp_min(above.sum(1, keepdim=True), 1e-12)
            return t_tot * (pf - deficit * above / denom)
        t = torch.exp(theta)
        return t.clamp(t_min, t_max) * seg_mask + (1.0 - seg_mask)

    def objective_at(t):
        """(B,) J + rho * sum(T), _BAD where unsolved or not finite."""
        coeffs, sol = qp_diff.solve(cfg, scfg, state, hpolys, t, seg)
        J = qp_diff.objective(cfg, state, hpolys, t, seg, coeffs)
        val = J + rho * (t * seg_mask).sum(1)
        val = torch.where(sol.solved, val, bad)
        return torch.where(torch.isfinite(val), val, bad)

    def value_and_grad(theta):
        theta = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            val = objective_at(theta_to_times(theta))
            g, = torch.autograd.grad(val.sum(), theta)
        return val.detach(), g * seg_mask

    theta = torch.log(t0_safe)
    f_b, g_b = value_and_grad(theta)

    # baseline objective at the raw (t_min-clamped) input allocation: when
    # the deficit floor engages, theta0's point is not the input, and this
    # makes "never worse than the input" hold
    t_raw = t0_safe * seg_mask + (1.0 - seg_mask)
    with torch.no_grad():
        f_raw = objective_at(t_raw)

    step_sz = torch.full((times.shape[0],), lr, dtype=dtype, device=dev)
    for _ in range(steps):
        cand = theta - step_sz[:, None] * g_b
        f_c, g_c = value_and_grad(cand)
        acc = f_c < f_b
        # a select: the JAX module's blend acc * cand + (1 - acc) * theta
        # gives the same on finite values and NaN for a rejected inf
        theta = torch.where(acc[:, None], cand, theta)
        g_b = torch.where(acc[:, None], g_c, g_b)
        f_b = torch.where(acc, f_c, f_b)
        step_sz = torch.where(acc, step_sz * 1.3, step_sz * 0.5)

    # accept the refined allocation only where it strictly beats the raw
    # input objective (this also upgrades a scenario unsolved at the input
    # to a feasible refined point)
    improved = f_b < f_raw
    with torch.no_grad():
        t_ref = torch.where(improved[:, None], theta_to_times(theta) * seg_mask,
                            times * seg_mask)
    return RefineResult(times=t_ref, obj=torch.where(improved, f_b, f_raw),
                        obj0=f_raw, improved=improved)
