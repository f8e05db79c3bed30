"""Batched OSQP-style ADMM solver and active-set polish.

Port of `allocnet_tpu/ops/admm.py` (its docstrings give the derivations).
The x-update uses the closed-form normal matrix from ops/qp.py, inverted
once per rho update; constraint applications are matrix-free; shapes are
static, so a whole batch solves in one pass.  After ADMM, a one-round
active-set polish solves the KKT system on the detected active set with a
pivot-free LDL^T (ops/ldl.py), then status flags and un-scaling follow.

`solve_qp` runs the ADMM chunks through ops/admm_chunk.py (the CUDA kernel
on a card, its plain version on the CPU) for f32; `admm_solve` below is the
plain reference loop, used for other dtypes and by the tests.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from allocnet_tpu_torch.config import SolverConfig
from allocnet_tpu_torch.ops import ldl as ldl_lib
from allocnet_tpu_torch.ops import qp
from allocnet_tpu_torch.ops.qp import EQ_KEYS, INEQ_KEYS, QPData


class QPSolution(NamedTuple):
    x: torch.Tensor         # (B, S, 3, D) scaled solution
    coeffs: torch.Tensor    # (B, S, 3, D) physical coefficients
    obj: torch.Tensor       # (B,) physical objective 1/2 x^T Q x
    nu: torch.Tensor        # (B, m_eq) equality duals (scaled rows)
    lam: dict               # {'corr': (B,S,R,F), 'box': (B,S,R,3,4)}
    pri_res: torch.Tensor   # (B,) max primal violation
    dua_res: torch.Tensor   # (B,) max dual residual
    solved: torch.Tensor    # (B,) bool: residuals within tolerance + obj window
    polished: torch.Tensor  # (B,) bool: polish accepted
    pri_rel: torch.Tensor   # (B,) pri_res / (1 + pri_scale), OSQP-normalized
    dua_rel: torch.Tensor   # (B,) dua_res / (1 + dua_scale)


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (like.ndim - 1))


def _rho_tree(y: dict, rho_e, rho_i) -> dict:
    out = {k: _bcast(rho_e, y[k]) for k in EQ_KEYS}
    out.update({k: _bcast(rho_i, y[k]) for k in INEQ_KEYS})
    return out


def _project(v: dict, beq: dict, h: dict) -> dict:
    out = {k: beq[k] for k in EQ_KEYS}
    for k in INEQ_KEYS:
        out[k] = torch.minimum(v[k], h[k])
    return out


def _maxabs(t: dict, keys) -> torch.Tensor:
    B = t[keys[0]].shape[0]
    return torch.stack([t[k].reshape(B, -1).abs().amax(1) for k in keys]).amax(0)


def _residuals(data: QPData, x, z, y, beq, h):
    """OSQP primal/dual residuals and their scales."""
    ax = qp.apply_A(data, x)
    dif = {k: ax[k] - z[k] for k in ax}
    keys = EQ_KEYS + INEQ_KEYS
    pri = _maxabs(dif, keys)
    pri_rel = torch.maximum(_maxabs(ax, keys), _maxabs(z, keys))
    px = qp.apply_P(data, x)
    aty = qp.apply_AT(data, y)
    B = px.shape[0]
    dua = (px + aty).reshape(B, -1).abs().amax(1)
    dua_rel = torch.maximum(px.reshape(B, -1).abs().amax(1),
                            aty.reshape(B, -1).abs().amax(1))
    return pri, pri_rel, dua, dua_rel


def spd_inverse(M: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a batched SPD matrix: Cholesky of M plus a
    relative diagonal jitter (f32 roundoff can push the smallest eigenvalue
    of the assembled M below zero), then one Newton step against the
    unjittered M to square away the jitter and roundoff."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    mdiag = M.diagonal(dim1=-2, dim2=-1).abs().amax(-1)
    rel = 2e-5 if M.dtype == torch.float32 else 4e-14
    # cholesky_ex: no host sync; a failed factor gives NaN, as in JAX
    L, info = torch.linalg.cholesky_ex(M + rel * mdiag[:, None, None] * eye)
    L = torch.where((info == 0)[:, None, None], L, torch.nan)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(M), upper=False)
    Minv = Linv.transpose(-1, -2) @ Linv
    return Minv @ (2.0 * eye - M @ Minv)


def ns_update_inverse(Minv, P, f, N, k: int = 4):
    """Update Minv = (N + P)^-1 to (N + f P)^-1 without re-factorizing:
    Newton-Schulz on K = I + (f-1) Minv P from X0 = 2/(1+f) I (spectrum of K
    in [min(1,f), max(1,f)]), then two Newton steps against the
    reconstructed M' = N + f P.  Returns (Minv', f P)."""
    n = Minv.shape[-1]
    eye = torch.eye(n, dtype=Minv.dtype, device=Minv.device)
    f = f.reshape(-1, 1, 1).to(Minv.dtype)
    K = eye + (f - 1.0) * (Minv @ P)
    X = (2.0 / (1.0 + f)) * eye.expand_as(K)
    for _ in range(k):
        X = X @ (2.0 * eye - K @ X)
    Minv2 = X @ Minv
    P2 = f * P
    M2 = N + P2
    for _ in range(2):
        Minv2 = Minv2 @ (2.0 * eye - M2 @ Minv2)
    return Minv2, P2


def initial_rho(data: QPData, scfg: SolverConfig, dtype):
    """Per-scenario (rho_i0, adaptation floor): rho scaled by the problem's
    own objective/constraint trace balance s / s_ref, clipped to
    [0.25, 4] x rho; the floor is 0.25 x that initialization."""
    B = data.times.shape[0]
    dev = data.times.device
    if not scfg.rho_scale_init:
        rho_i = torch.full((B,), scfg.rho, dtype=dtype, device=dev)
        return rho_i, 0.25 * rho_i
    N_stat = qp.normal_matrix(data, scfg.sigma, 0.0, 0.0)
    M_unit = qp.normal_matrix(data, scfg.sigma, scfg.rho_eq_scale, 1.0)

    def tr(m):
        return m.diagonal(dim1=-2, dim2=-1).sum(-1)

    s_stat = torch.sqrt(tr(N_stat) / torch.clamp_min(tr(M_unit) - tr(N_stat),
                                                     1e-12))
    rho_i = torch.clamp(scfg.rho * s_stat / scfg.rho_scale_ref,
                        0.25 * scfg.rho, 4.0 * scfg.rho).to(dtype)
    return rho_i, 0.25 * rho_i


def rho_rescale(pri, pri_rel, dua, dua_rel, rho_i, rho_floor):
    """Chunk-boundary rho adaptation from the primal/dual residual balance,
    biased upward (factor clipped to [0.5, 5]) and kept within
    [floor, 100] so rho_eq stays in f32's comfortable range."""
    ratio = torch.sqrt((pri / torch.clamp_min(pri_rel, 1e-12))
                       / torch.clamp_min(dua / torch.clamp_min(dua_rel, 1e-12),
                                         1e-12))
    factor = torch.clamp(ratio.to(rho_i.dtype), 0.5, 5.0)
    return torch.minimum(torch.maximum(rho_i * factor, rho_floor),
                         torch.full_like(rho_i, 100.0))


def warm_start(data: QPData, x0=None, y0=None):
    """(x, z, y) at the start of ADMM: x0 (zeros by default), its projected
    constraint values, and y0 (zeros by default)."""
    cfg = data.cfg
    B = data.times.shape[0]
    x = (data.times.new_zeros((B, cfg.max_seg, 3, cfg.D)) if x0 is None
         else x0)
    z = _project(qp.apply_A(data, x), qp.eq_rhs(data), qp.ineq_rhs(data))
    y = {k: torch.zeros_like(v) for k, v in z.items()} if y0 is None else y0
    return x, z, y


def admm_solve(data: QPData, scfg: SolverConfig, x0=None, y0=None):
    """Plain ADMM loop.  Returns (x, z, y, rho_e, rho_i, pri, dua).
    x0/y0 warm-start the primal and dual iterates (OSQP warm_start)."""
    cfg = data.cfg
    dtype = data.times.dtype
    B = data.times.shape[0]
    n = cfg.n_var
    beq = qp.eq_rhs(data)
    h = qp.ineq_rhs(data)
    x, z, y = warm_start(data, x0, y0)

    sigma, alpha = scfg.sigma, scfg.alpha
    rho_i, rho_floor = initial_rho(data, scfg, dtype)
    rho_e = rho_i * scfg.rho_eq_scale

    # first chunk: Cholesky inverse; later chunks cross the rho rescale with
    # the Newton-Schulz update (f = 1 on the first pass is the identity)
    if scfg.ns_rho_update:
        M = qp.normal_matrix(data, sigma, rho_e, rho_i)
        Minv = spd_inverse(M)
        N = qp.normal_matrix(data, sigma, 0.0, 0.0)
        P = M - N
    f = torch.ones((B,), dtype=dtype, device=x.device)

    for _ in range(scfg.n_chunks):
        if scfg.ns_rho_update:
            Minv, P = ns_update_inverse(Minv, P, f, N)
            M = N + P
        else:
            M = qp.normal_matrix(data, sigma, rho_e, rho_i)
            Minv = spd_inverse(M)
        rho = _rho_tree(y, rho_e, rho_i)
        for _ in range(scfg.iters_per_chunk):
            rhs_tree = {k: rho[k] * z[k] - y[k] for k in z}
            rhs = (sigma * x + qp.apply_AT(data, rhs_tree)).reshape(B, n)
            xt = torch.einsum('bnm,bm->bn', Minv, rhs)
            # one step of iterative refinement of the f32 explicit inverse
            resid = rhs - torch.einsum('bnm,bm->bn', M, xt)
            xt = xt + torch.einsum('bnm,bm->bn', Minv, resid)
            xt = torch.clamp(xt, -1e6, 1e6).reshape(x.shape)
            zt = qp.apply_A(data, xt)
            x = alpha * xt + (1.0 - alpha) * x
            v = {k: alpha * zt[k] + (1.0 - alpha) * z[k] + y[k] / rho[k]
                 for k in z}
            z = _project(v, beq, h)
            y = {k: torch.clamp((v[k] - z[k]) * rho[k], -1e6, 1e6) for k in z}
        rho_i_new = rho_rescale(*_residuals(data, x, z, y, beq, h),
                                rho_i, rho_floor)
        f = rho_i_new / rho_i
        rho_i = rho_i_new
        rho_e = rho_i * scfg.rho_eq_scale

    pri, _, dua, _ = _residuals(data, x, z, y, beq, h)
    return x, z, y, rho_e, rho_i, pri, dua


# ---------------------------------------------------------------------------
# polish: active-set KKT refinement
# ---------------------------------------------------------------------------

def _dense_P_explicit(data: QPData) -> torch.Tensor:
    """(B, n, n) dense scaled Hessian (block diagonal)."""
    cfg = data.cfg
    Qhat = qp.consts(cfg, data.times.dtype, data.times.device)[-1]
    D, S = cfg.D, cfg.max_seg
    eyeD = torch.eye(D, dtype=Qhat.dtype, device=Qhat.device)
    Pblk = (data.w_obj[:, :, None, None] * Qhat
            + (1.0 - data.seg_mask)[:, :, None, None] * eyeD)
    B = Pblk.shape[0]
    P = Pblk.new_zeros((B, cfg.n_var, cfg.n_var))
    for i in range(S):
        for j in range(3):
            sl = slice((i * 3 + j) * D, (i * 3 + j + 1) * D)
            P[:, sl, sl] = Pblk[:, i]
    return P


def _gather_ineq_rows(data: QPData, idx: torch.Tensor):
    """Inequality rows for flat indices idx (B, K): rows (B, K, n), rhs
    (B, K).  Flat layout: corr (S, R, F), then box (S, R, 3, 4) with slot
    t in {+vel, +acc, -vel, -acc}."""
    cfg = data.cfg
    B0, B1, B2 = qp.consts(cfg, data.times.dtype, data.times.device)[:3]
    S, R, F, D = cfg.max_seg, cfg.res, cfg.max_faces, cfg.D
    dtype, dev = data.times.dtype, data.times.device
    B, K = idx.shape
    n_corr = S * R * F
    is_corr = idx < n_corr

    ci = torch.where(is_corr, idx, 0)
    c_i, c_s, c_f = ci // (R * F), (ci // F) % R, ci % F
    bi = torch.where(is_corr, 0, idx - n_corr)
    b_i, b_s = bi // (R * 12), (bi // 12) % R
    b_j, b_t = (bi // 4) % 3, bi % 4

    batch = torch.arange(B, device=dev)[:, None]
    kk = torch.arange(K, device=dev)[None, :]
    a = data.normals[batch, c_i, c_f]                              # (B,K,3)
    corr_full = torch.zeros((B, K, S, 3, D), dtype=dtype, device=dev)
    corr_full[batch, kk, c_i] = torch.einsum('bkj,bkd->bkjd', a, B0[c_s])

    sign = torch.where(b_t >= 2, -1.0, 1.0).to(dtype)
    vb = torch.where((b_t % 2 == 0)[..., None], B1[b_s], B2[b_s])
    vb = vb * (sign * data.seg_mask[batch, b_i])[..., None]
    box_full = torch.zeros((B, K, S, 3, D), dtype=dtype, device=dev)
    box_full[batch, kk, b_i, b_j] = vb

    rows = torch.where(is_corr[..., None], corr_full.reshape(B, K, -1),
                       box_full.reshape(B, K, -1))
    h_flat = qp.tree_flat(qp.ineq_rhs(data), INEQ_KEYS)
    return rows, torch.gather(h_flat, 1, idx)


def _top_k(score: torch.Tensor, K: int) -> torch.Tensor:
    """Indices of the K largest scores, ties broken toward the lower index
    (the order `jax.lax.top_k` gives)."""
    return torch.sort(score, dim=1, descending=True, stable=True)[1][:, :K]


def polish(data: QPData, scfg: SolverConfig, x, beq_flat, h_flat, lam_flat,
           refine_sel: bool = False, *, trace=None):
    """Active-set KKT solve with regularization and iterative refinement.
    Returns (x_pol, nu_pol, lam_full_pol, idx).

    Round 0 (refine_sel False) selects rows with a positive dual estimate or
    near-zero slack; later rounds take signed multipliers from the previous
    polish and keep a row only if its multiplier is positive or it is
    strictly violated.

    `trace`, when given, is called once per drop pass with a dict of that
    pass's (B, K) tensors over the gathered rows `idx`: `lam` (signed
    multipliers) and `gx_h` (G x - h at the pass's point), the keep
    threshold `lam_thr` (B, 1), `active_in` and `active_out`; it changes
    no output."""
    cfg = data.cfg
    dtype, dev = x.dtype, x.device
    B = x.shape[0]
    n = cfg.n_var
    K = scfg.max_active

    Aeq, beq = qp.dense_eq(data)
    m_eq = Aeq.shape[1]
    ax_flat = qp.tree_flat(qp.apply_A(data, x), EQ_KEYS + INEQ_KEYS)[:, m_eq:]
    slack = h_flat - ax_flat
    scale = torch.clamp_min(lam_flat.abs().amax(1, keepdim=True), 1.0)
    if refine_sel:
        score = lam_flat / scale - slack
    else:
        score = lam_flat.clamp_min(0.0) / scale - slack.clamp_min(0.0)
    idx = _top_k(score, K)
    lam_k = torch.gather(lam_flat, 1, idx)
    slack_k = torch.gather(slack, 1, idx)
    if refine_sel:
        active = (lam_k > 1e-7 * scale) | (slack_k < -1e-7)
    else:
        active = (lam_k > 1e-5 * scale) | (slack_k < 1e-6)

    G_act, h_act = _gather_ineq_rows(data, idx)
    if scfg.polish_dedup:
        # keep only the first (highest-scored) row of each near-parallel
        # cluster: near-duplicate faces make the KKT inconsistent by their
        # offset gap
        af = active.to(dtype)
        nrm = torch.sqrt(torch.clamp_min((G_act * G_act).sum(-1), 1e-12))
        cos = (G_act @ G_act.transpose(1, 2)) / (nrm[:, :, None]
                                                 * nrm[:, None, :])
        prior = torch.triu(torch.ones((K, K), dtype=dtype, device=dev), 1)
        dup = ((cos > 1.0 - 1e-5).to(dtype) * af[:, :, None]
               * prior[None]).amax(1)
        active = active & (dup < 0.5)
    P = _dense_P_explicit(data)
    delta = max(scfg.polish_delta, 1e-5 if dtype == torch.float32 else 0.0)
    m = m_eq + K
    kdim = n + m
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    eye_m = torch.eye(m, dtype=dtype, device=dev)

    def kkt_solve(active):
        G_a = G_act * active[..., None]
        h_a = h_act * active
        A_full = torch.cat([Aeq, G_a], dim=1)                    # (B, m, n)
        Kmat = torch.cat([
            torch.cat([P + delta * eye_n, A_full.transpose(1, 2)], 2),
            torch.cat([A_full, (-delta * eye_m).expand(B, m, m)], 2)], 1)
        rhs = torch.cat([x.new_zeros((B, n)), beq, h_a], dim=1)

        if scfg.polish_method == "ldl":
            # static symmetric permutation: PD coefficient slots first,
            # constraint rows next, P-null slots last; factor a more heavily
            # regularized KKT and refine against the true one
            df = max(scfg.polish_ldl_delta, delta)
            slot = np.arange(n) % cfg.D
            perm = np.concatenate([np.nonzero(slot < cfg.order)[0],
                                   np.arange(n, kdim),
                                   np.nonzero(slot >= cfg.order)[0]])
            iperm = torch.as_tensor(np.argsort(perm), device=dev)
            perm_t = torch.as_tensor(perm, device=dev)
            sgn_nat = np.where(np.arange(kdim) < n, 1.0, -1.0)
            Kf = Kmat + (df - delta) * torch.diag(
                torch.as_tensor(sgn_nat, dtype=dtype, device=dev))
            Kf = Kf[:, perm_t][:, :, perm_t]
            Kp, _, _ = ldl_lib.pad_to_block(Kf, rhs, nb=64)
            L, dvec = ldl_lib.ldl_factor(
                Kp, nb=64, reg=float(scfg.polish_ldl_delta),
                sign=torch.as_tensor(sgn_nat[perm], dtype=dtype, device=dev))
            kp = Kp.shape[1]

            def solve_fn(r):
                rpad = r.new_zeros((B, kp))
                rpad[:, :kdim] = r[:, perm_t]
                return ldl_lib.ldl_solve(L, dvec, rpad)[:, :kdim][:, iperm]
        else:
            lu, piv = torch.linalg.lu_factor(Kmat)

            def solve_fn(r):
                return torch.linalg.lu_solve(lu, piv, r[..., None])[..., 0]

        sol = solve_fn(rhs)

        def kkt_residual(sol):
            xx, mults = sol[:, :n], sol[:, n:]
            r1 = (torch.einsum('bnm,bm->bn', P, xx)
                  + torch.einsum('bmn,bm->bn', A_full, mults))
            r2 = (torch.einsum('bmn,bn->bm', A_full, xx)
                  - torch.cat([beq, h_a], dim=1))
            return torch.cat([r1, r2], dim=1)

        n_refine = scfg.polish_refine_steps + (
            1 if scfg.polish_method == "ldl" else 0)
        for _ in range(n_refine):
            sol = sol - solve_fn(kkt_residual(sol))
        return sol

    sol = kkt_solve(active)
    for _ in range(scfg.polish_drop_passes):
        # classical active-set drop/enter pass within the gathered rows
        lam_act = sol[:, n + m_eq:]
        lam_mag = torch.clamp_min(lam_act.abs().amax(1, keepdim=True), 1.0)
        keep = lam_act > -1e-7 * lam_mag
        gx_h = torch.einsum('bkn,bn->bk', G_act, sol[:, :n]) - h_act
        viol = gx_h > 1e-7
        active_in, active = active, (active & keep) | viol
        if trace is not None:
            trace({"idx": idx, "lam": lam_act, "gx_h": gx_h,
                   "lam_thr": -1e-7 * lam_mag, "active_in": active_in,
                   "active_out": active})
        sol = kkt_solve(active)

    x_pol = sol[:, :n].reshape(x.shape)
    nu_pol = sol[:, n:n + m_eq]
    lam_act = sol[:, n + m_eq:] * active
    lam_full = torch.zeros_like(lam_flat).scatter(1, idx, lam_act)
    return x_pol, nu_pol, lam_full, idx


def _full_residuals(data: QPData, x, nu, lam_flat, beq, h_flat,
                    with_scales: bool = False):
    """Primal/dual residual of (x, nu, lam) against the full constraint set;
    with_scales adds OSQP's relative-criterion scales (q = 0 here)."""
    B = x.shape[0]
    ax = qp.tree_flat(qp.apply_A(data, x), EQ_KEYS + INEQ_KEYS)
    m_eq = beq.shape[1]
    pri_eq = (ax[:, :m_eq] - beq).abs().amax(1)
    pri_in = (ax[:, m_eq:] - h_flat).clamp_min(0.0).amax(1)
    pri = torch.maximum(pri_eq, pri_in)

    y_tree = unflatten_duals(data, torch.cat([nu, lam_flat], dim=1))
    px = qp.apply_P(data, x)
    aty = qp.apply_AT(data, y_tree)
    dua = (px + aty).reshape(B, -1).abs().amax(1)
    if not with_scales:
        return pri, dua
    ax_mag = ax.abs().amax(1)
    rhs_mag = torch.maximum(beq.abs().amax(1), h_flat.abs().amax(1))
    pri_scale = torch.maximum(ax_mag, rhs_mag)
    dua_scale = torch.maximum(px.reshape(B, -1).abs().amax(1),
                              aty.reshape(B, -1).abs().amax(1))
    return pri, dua, pri_scale, dua_scale


def unflatten_duals(data: QPData, y_flat: torch.Tensor) -> dict:
    cfg = data.cfg
    B = y_flat.shape[0]
    S, R, F, o = cfg.max_seg, cfg.res, cfg.max_faces, cfg.order
    sizes = {'start': (3, 3), 'end': (3, 3), 'junc': (S - 1, 3, o),
             'corr': (S, R, F), 'box': (S, R, 3, 4)}
    out, off = {}, 0
    for k in EQ_KEYS + INEQ_KEYS:
        sz = int(np.prod(sizes[k]))
        out[k] = y_flat[:, off:off + sz].reshape((B,) + sizes[k])
        off += sz
    return out


def solve_launches(qcfg, scfg: SolverConfig) -> tuple[int, int]:
    """(K1, L1) launches of one `solve_qp` on a card: n_chunks admm_chunk
    launches and, per polish round, 1 + polish_drop_passes factorizations
    of the padded KKT (n_var + n_eq + max_active rows, in 64-column
    blocks), one ldl_block launch per block.  A differentiable solve's
    backward launches neither."""
    blocks = -(-(qcfg.n_var + qcfg.n_eq + scfg.max_active) // 64)
    return (scfg.n_chunks,
            scfg.polish_rounds * (1 + scfg.polish_drop_passes) * blocks)


def solve_qp(data: QPData, scfg: SolverConfig, x0=None, y0=None) -> QPSolution:
    """Full batched solve: ADMM, polish, status.  x0/y0: warm start.

    Runs on the device that holds `data`.  Matrix products stay in full
    f32 (utils/device.resolve_device turns TF32 off).  On a card the ADMM
    runs through the admm_chunk kernel only, which takes f32 with
    `use_pallas`, at most 52 faces (F + 12 <= 64 slots per sample row)
    and a shape whose fixed part and z / yh slots fit in one block's
    shared memory: on an H100 res <= 78 at 5 segments, <= 36 at 10 (the
    deploy shape and config.SEQ10 at res 20 both launch); Kx stays in
    device memory where it does not fit.  Anything else raises there."""
    from allocnet_tpu_torch.ops import admm_chunk

    B = data.times.shape[0]
    if data.times.device.type != "cpu":
        # on a card the ADMM runs through the kernel only: its wrapper
        # raises on what it cannot take (not f32, slots too many for a
        # block's shared memory)
        if not scfg.use_pallas:
            raise ValueError("solve_qp: use_pallas=False runs the plain ADMM "
                             "core, which the port keeps for the CPU")
        core = admm_chunk.admm_solve_chunked
    elif scfg.use_pallas and data.times.dtype == torch.float32:
        core = admm_chunk.admm_solve_chunked    # the kernel's plain version
    else:
        core = admm_solve
    x, z, y, _, _, _, _ = core(data, scfg, x0, y0)

    beq = qp.tree_flat(qp.eq_rhs(data), EQ_KEYS)
    h_flat = qp.tree_flat(qp.ineq_rhs(data), INEQ_KEYS)
    y_eq = qp.tree_flat({k: y[k] for k in EQ_KEYS}, EQ_KEYS)
    lam_flat = qp.tree_flat({k: y[k] for k in INEQ_KEYS},
                            INEQ_KEYS).clamp_min(0.0)
    pri_a, dua_a = _full_residuals(data, x, y_eq, lam_flat, beq, h_flat)
    nu, lam = y_eq, lam_flat
    polished = torch.zeros((B,), dtype=torch.bool, device=x.device)

    if scfg.polish:
        # batched active-set iteration: each round selects from the latest
        # finite polish point (signed multipliers after round 0) and the
        # best point so far is kept
        x_sel, lam_sel = x, lam
        for r in range(scfg.polish_rounds):
            x_p, nu_p, lam_ps, _ = polish(data, scfg, x_sel, beq, h_flat,
                                          lam_sel, refine_sel=r > 0)
            lam_p = lam_ps.clamp_min(0.0)
            pri_p, dua_p = _full_residuals(data, x_p, nu_p, lam_p, beq, h_flat)
            finite = torch.isfinite(x_p.reshape(B, -1)).all(1)
            better = finite & (torch.maximum(pri_p, dua_p)
                               < torch.maximum(pri_a, dua_a))
            x = torch.where(_bcast(better, x), x_p, x)
            nu = torch.where(better[:, None], nu_p, nu)
            lam = torch.where(better[:, None], lam_p, lam)
            pri_a = torch.where(better, pri_p, pri_a)
            dua_a = torch.where(better, dua_p, dua_a)
            polished = polished | better
            x_sel = torch.where(_bcast(finite, x_sel), x_p, x_sel)
            lam_sel = torch.where(finite[:, None], lam_ps, lam_sel)

    coeffs = qp.unscale_coeffs(data, x)
    obj = qp.objective(data, x)
    # OSQP's relative termination criterion plus the reference's objective
    # sanity window (qp_solver.hpp:298-358, 340-345)
    _, _, pri_sc, dua_sc = _full_residuals(data, x, nu, lam, beq, h_flat,
                                           with_scales=True)
    tol_p = scfg.eps_abs * 10 + scfg.eps_rel * 10 * pri_sc
    tol_d = scfg.eps_abs * 10 + scfg.eps_rel * 10 * dua_sc
    solved = ((pri_a < tol_p) & (dua_a < tol_d)
              & (obj < scfg.obj_max) & (obj > scfg.obj_min))
    lam_tree = unflatten_duals(data, torch.cat([nu * 0, lam], dim=1))
    return QPSolution(
        x=x, coeffs=coeffs, obj=obj, nu=nu,
        lam={k: lam_tree[k] for k in INEQ_KEYS},
        pri_res=pri_a, dua_res=dua_a, solved=solved, polished=polished,
        pri_rel=pri_a / (1.0 + pri_sc), dua_rel=dua_a / (1.0 + dua_sc))
