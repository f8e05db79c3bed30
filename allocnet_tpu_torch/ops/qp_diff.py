"""Differentiable batched QP solve with implicit KKT gradients.

Port of `allocnet_tpu/ops/qp_diff.py` (its docstring compares it with the
reference's OsqpLayer, layers.py:35-247).  The forward pass is the plain
`admm.solve_qp` without autograd (on a card: the admm_chunk kernel for the
ADMM iterations, then polish); the backward pass differentiates through the
ACTIVE-SET KKT system at the solution, of size n + m_eq + max_active (250
at the deploy shape), assembled densely and solved by LU with one step of
refinement against the unregularized system.

    solve(cfg, scfg, state, hpolys, times, seg) -> (coeffs, sol)

`coeffs` carries gradients with respect to (state, hpolys, times); `sol` is
the QPSolution, without gradients.  Unsolved scenarios get zero gradient.
"""

from __future__ import annotations

import torch

from allocnet_tpu_torch.config import QPConfig, SolverConfig
from allocnet_tpu_torch.ops import admm, qp
from allocnet_tpu_torch.ops.qp import INEQ_KEYS


def _active_set(data: qp.QPData, scfg: SolverConfig, x, lam_flat):
    """Active-set selection from a solved point (the polish's scoring):
    (idx (B, K) flat inequality rows, active (B, K) 0/1 in x's dtype)."""
    ineq_flat = qp.tree_flat(qp.apply_A(data, x), INEQ_KEYS)
    slack = qp.tree_flat(qp.ineq_rhs(data), INEQ_KEYS) - ineq_flat
    scale = torch.clamp_min(lam_flat.abs().amax(1, keepdim=True), 1.0)
    score = lam_flat / scale - slack.clamp_min(0.0)
    idx = admm._top_k(score, scfg.max_active)
    active = ((torch.gather(lam_flat, 1, idx) > 1e-6 * scale)
              & (torch.gather(slack, 1, idx) < 1e-5))
    return idx, active.to(x.dtype)


def _residuals(cfg: QPConfig, seg, idx, active, state, hpolys, times, x, nu,
               lam_act):
    """KKT residual map R(theta, s) at the fixed solution s = (x, nu,
    lam_act); differentiable in theta = (state, hpolys, times) through the
    QP assembly."""
    data = qp.build_qp(cfg, state, hpolys, times, seg, device=times.device)
    B = x.shape[0]
    Aeq, beq = qp.dense_eq(data)
    G_act, h_act = admm._gather_ineq_rows(data, idx)
    G_act = G_act * active[..., None]
    h_act = h_act * active
    xf = x.reshape(B, -1)
    r1 = (qp.apply_P(data, x).reshape(B, -1)
          + torch.einsum('bmn,bm->bn', Aeq, nu)
          + torch.einsum('bkn,bk->bn', G_act, lam_act))
    r2 = torch.einsum('bmn,bn->bm', Aeq, xf) - beq
    r3 = (torch.einsum('bkn,bn->bk', G_act, xf) - h_act) * active
    return r1, r2, r3


def _kkt_adjoint(cfg: QPConfig, scfg: SolverConfig, data: qp.QPData, idx,
                 active, x_bar):
    """Solve K^T [u; v; w] = [x_bar; 0] on the regularized active-set KKT
    matrix K (symmetric), with one refinement step on the unregularized
    one.  Returns (u (B, n), v (B, m_eq), w (B, K))."""
    B = x_bar.shape[0]
    n = cfg.n_var
    dtype, dev = x_bar.dtype, x_bar.device
    Aeq, _ = qp.dense_eq(data)
    m_eq = Aeq.shape[1]
    G_act, _ = admm._gather_ineq_rows(data, idx)
    G_act = G_act * active[..., None]
    P = admm._dense_P_explicit(data)
    m = m_eq + scfg.max_active
    delta = max(scfg.polish_delta, 1e-5 if dtype == torch.float32 else 0.0)
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    eye_m = torch.eye(m, dtype=dtype, device=dev)
    A_full = torch.cat([Aeq, G_act], dim=1)
    K0 = torch.cat([torch.cat([P, A_full.transpose(1, 2)], 2),
                    torch.cat([A_full, torch.zeros_like(eye_m).expand(
                        B, m, m)], 2)], 1)
    # inert rows (inactive padding) need a nonzero diagonal; active rows
    # get -delta regularization like the polish
    Kmat = K0 + delta * torch.block_diag(eye_n, -eye_m)
    rhs = torch.cat([x_bar.reshape(B, n), x_bar.new_zeros((B, m))], dim=1)
    # lu_factor_ex: no host sync to check the factorization
    lu, piv, _ = torch.linalg.lu_factor_ex(Kmat)

    def lu_solve(r):
        return torch.linalg.lu_solve(lu, piv, r[..., None])[..., 0]

    sol = lu_solve(rhs)
    r = torch.einsum('bij,bj->bi', K0, sol) - rhs
    sol = sol - lu_solve(r)
    return sol[:, :n], sol[:, n:n + m_eq], sol[:, n + m_eq:] * active


class _ImplicitSolve(torch.autograd.Function):
    """x = argmin of the QP given (state, hpolys, times); the forward value
    comes in already solved, the backward applies the implicit function
    theorem on the active-set KKT system."""

    @staticmethod
    def forward(ctx, cfg, scfg, state, hpolys, times, seg, x, nu, lam_act,
                idx, active, solved):
        ctx.cfg, ctx.scfg = cfg, scfg
        ctx.save_for_backward(state, hpolys, times, seg, x, nu, lam_act, idx,
                              active, solved)
        return x.clone()

    @staticmethod
    def backward(ctx, x_bar):
        (state, hpolys, times, seg, x, nu, lam_act, idx, active,
         solved) = ctx.saved_tensors
        cfg, scfg = ctx.cfg, ctx.scfg
        B = x.shape[0]
        # zero cotangent for unsolved scenarios: their "solution" means
        # nothing
        x_bar = x_bar * solved.to(x_bar.dtype).reshape(B, 1, 1, 1)
        with torch.no_grad():
            data = qp.build_qp(cfg, state, hpolys, times, seg,
                               device=times.device)
            u, v, w = _kkt_adjoint(cfg, scfg, data, idx, active, x_bar)
        theta = [t.detach().requires_grad_(want) for t, want in
                 zip((state, hpolys, times), ctx.needs_input_grad[2:5])]
        with torch.enable_grad():
            r1, r2, r3 = _residuals(cfg, seg, idx, active, *theta, x, nu,
                                    lam_act)
            lagr = (u * r1).sum() + (v * r2).sum() + (w * r3).sum()
            grads = iter(torch.autograd.grad(
                lagr, [t for t in theta if t.requires_grad],
                materialize_grads=True))
        return (None, None, *(-next(grads) if t.requires_grad else None
                              for t in theta), *(None,) * 7)


def solve(cfg: QPConfig, scfg: SolverConfig, state, hpolys, times, seg):
    """Differentiable solve: returns (coeffs, sol).

    state (B, 2, 3, 3), hpolys (B, S, F, 4), times (B, S) tensors on one
    device, seg (B,).  coeffs (B, S, 3, D) physical coefficients carry
    gradients with respect to (state, hpolys, times); sol is the
    QPSolution of the forward solve, without gradients."""
    dev = times.device
    seg = torch.as_tensor(seg, device=dev).long()
    with torch.no_grad():
        data = qp.build_qp(cfg, state, hpolys, times, seg, device=dev)
        sol = admm.solve_qp(data, scfg)
        lam_flat = qp.tree_flat(sol.lam, INEQ_KEYS)
        idx, active = _active_set(data, scfg, sol.x, lam_flat)
        lam_act = torch.gather(lam_flat, 1, idx) * active
    x = _ImplicitSolve.apply(cfg, scfg, state, hpolys, times, seg, sol.x,
                             sol.nu, lam_act, idx, active, sol.solved)
    data = qp.build_qp(cfg, state, hpolys, times, seg, device=dev)
    coeffs = qp.unscale_coeffs(data, x)
    # unsolved scenarios carry no gradient at all (neither through the
    # implicit solve nor through the unscaling's time factors)
    mask = sol.solved.reshape((-1,) + (1,) * (coeffs.ndim - 1))
    return torch.where(mask, coeffs, coeffs.detach()), sol


def objective(cfg: QPConfig, state, hpolys, times, seg, coeffs):
    """Differentiable physical objective 1/2 x^T Q x (B,) from physical
    coefficients (the normalized QP-cost loss, layers.py:149, 245)."""
    data = qp.build_qp(cfg, state, hpolys, times, seg, device=times.device)
    return qp.objective(data, qp.scale_coeffs(data, coeffs))
