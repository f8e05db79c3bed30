"""Batched, structured assembly of the corridor-constrained min-snap QP.

Port of `allocnet_tpu/ops/qp.py`; its docstring derives the formulation.
In short: each segment's polynomial lives on unit time tau in [0, 1] with
slot-equilibrated coefficients, so the corridor/box inequality operator G is
constant and never materialized (G x = evaluate pos/vel/acc at res samples,
G^T y its explicit adjoint), the Hessian is T^{-(2o-1)} times a constant
Gram, and the ADMM normal matrix has a closed Kronecker form.  Everything is
padded to (max_seg, max_faces) and masked so shapes are static.

Problem per scenario:  min 1/2 x^T Q x  s.t.  A x = b,  G x <= h,
x the (segment, axis, coefficient) stack, highest degree first.
"""

from __future__ import annotations

import math
import weakref
from typing import NamedTuple

import numpy as np
import torch

from allocnet_tpu_torch.config import QPConfig
from allocnet_tpu_torch.ops import bases
from allocnet_tpu_torch.utils.device import resolve_device

# Minimum segment time considered valid (the reference rejects < 1e-10,
# learning_planner.hpp:181-189); also keeps T^r scalings finite on padding.
TIME_FLOOR = 1e-4


class QPData(NamedTuple):
    """Everything needed to apply the (scaled) QP operators for a batch.
    B = batch, S = max_seg, F = max_faces, R = res, D = 2*order, o = order."""

    normals: torch.Tensor     # (B, S, F, 3) unit face normals (0 on padding)
    offsets: torch.Tensor     # (B, S, F) face offsets (a.x <= b)
    times: torch.Tensor       # (B, S) safe segment times (1 on padding)
    seg_mask: torch.Tensor    # (B, S)
    face_mask: torch.Tensor   # (B, S, F)
    end_onehot: torch.Tensor  # (B, S) one-hot at segment seg-1
    junc_mask: torch.Tensor   # (B, S-1)
    b_start: torch.Tensor     # (B, 3, 3) [axis, deriv] start * T_0^r
    b_end: torch.Tensor       # (B, 3, 3) end * T_{L-1}^r
    kappa: torch.Tensor       # (B, S-1, o) (T_i / T_{i+1})^r
    jrow_scale: torch.Tensor  # (B, S-1, o) 1 / max(1, kappa * r!)
    w_obj: torch.Tensor       # (B, S) normalized Hessian weights
    w_true: torch.Tensor      # (B, S) physical weights T^{-(2o-1)}
    h_corr: torch.Tensor      # (B, S, R, F) face offsets (1 on padding)
    h_box: torch.Tensor       # (B, S, 1, 1, 4) [vmax T, amax T^2, vmax T, amax T^2]
    cfg: QPConfig


def _tensor(a, device, dtype=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype or a.dtype)
    return torch.as_tensor(np.asarray(a), device=device, dtype=dtype)


def masks_from_inputs(cfg: QPConfig, hpolys: torch.Tensor, seg: torch.Tensor):
    """(seg_mask, face_mask, end_onehot, junc_mask) from padded inputs."""
    S = cfg.max_seg
    dt = hpolys.dtype
    idx = torch.arange(S, device=hpolys.device)
    seg = seg.long()
    seg_mask = (idx[None, :] < seg[:, None]).to(dt)
    norms = torch.linalg.vector_norm(hpolys[..., :3], dim=-1)
    face_mask = (norms > 1e-6).to(dt) * seg_mask[..., None]
    end_onehot = (idx[None, :] == (seg[:, None] - 1)).to(dt)
    junc_mask = (idx[None, :S - 1] < (seg[:, None] - 1)).to(dt)
    return seg_mask, face_mask, end_onehot, junc_mask


def infer_seg(hpolys: torch.Tensor) -> torch.Tensor:
    """Active segment count (B,) from zero padding: the leading polytopes
    whose total norm exceeds 1 (the reference's rule, min_traj_opt.py:
    75-92: the corridor ends at the first polytope with norm <= 1)."""
    alive = torch.linalg.vector_norm(hpolys, dim=(2, 3)) > 1.0
    return torch.cumprod(alive.to(torch.int32), dim=1).sum(1)


def build_qp(cfg: QPConfig, state, hpolys, times, seg, device=None) -> QPData:
    """Assemble the scaled QP for a batch.

    state (B, 2, 3, 3) [start/end, axis, (p, v, a)], hpolys (B, S, F, 4)
    normalized a.x <= b rows (zero padded), times (B, S), seg (B,).  Inputs
    may be numpy arrays or tensors; the dtype follows `times`.  Runs on the
    card unless `device` says otherwise."""
    dev = resolve_device(device)
    times = _tensor(times, dev)
    dtype = times.dtype
    state = _tensor(state, dev, dtype)
    hpolys = _tensor(hpolys, dev, dtype)
    seg = _tensor(seg, dev, torch.long)
    o, D = cfg.order, cfg.D

    seg_mask, face_mask, end_onehot, junc_mask = masks_from_inputs(
        cfg, hpolys, seg)
    one = torch.ones((), dtype=dtype, device=dev)
    t_safe = torch.where(seg_mask > 0, times.clamp_min(TIME_FLOOR), one)

    normals = hpolys[..., :3] * face_mask[..., None]
    offsets = torch.where(face_mask > 0, hpolys[..., 3], one)

    rpow = torch.arange(3, dtype=dtype, device=dev)
    t0 = t_safe[:, 0]
    tL = (end_onehot * t_safe).sum(1)
    b_start = state[:, 0] * t0[:, None, None] ** rpow
    b_end = state[:, 1] * tL[:, None, None] ** rpow

    ratio = t_safe[:, :-1] / t_safe[:, 1:]
    opow = torch.arange(o, dtype=dtype, device=dev)
    kappa = ratio[:, :, None] ** opow
    fact_r = torch.tensor([math.factorial(r) for r in range(o)], dtype=dtype,
                          device=dev)
    jrow_scale = 1.0 / torch.clamp_min(kappa * fact_r, 1.0)

    s = bases.slot_scales(D, o)
    qnorm = float(np.abs(bases.gram_matrix(o) / np.outer(s, s)).max())
    zero = torch.zeros((), dtype=dtype, device=dev)
    w_true = torch.where(seg_mask > 0, t_safe ** (-(2 * o - 1)), zero)
    w_obj = (w_true / qnorm
             / torch.where(seg_mask > 0, w_true, zero).amax(1, keepdim=True))

    R = cfg.res
    h_corr = offsets[:, :, None, :].expand(-1, -1, R, -1).contiguous()
    hv = cfg.max_vel * t_safe
    ha = cfg.max_acc * t_safe ** 2
    h_box = torch.stack([hv, ha, hv, ha], dim=-1)
    h_box = torch.where(seg_mask[..., None] > 0, h_box, one)[:, :, None, None, :]

    return QPData(
        normals=normals, offsets=offsets, times=t_safe, seg_mask=seg_mask,
        face_mask=face_mask, end_onehot=end_onehot, junc_mask=junc_mask,
        b_start=b_start, b_end=b_end, kappa=kappa, jrow_scale=jrow_scale,
        w_obj=w_obj, w_true=w_true, h_corr=h_corr, h_box=h_box, cfg=cfg)


# ---------------------------------------------------------------------------
# constant basis tensors
# ---------------------------------------------------------------------------

_CONSTS: dict = {}
_TRACED_CONSTS: dict = {}


def consts(cfg: QPConfig, dtype: torch.dtype, device: torch.device):
    """Slot-equilibrated constant bases (B0, B1, B2, Bz3, Be3, Beo, fact,
    Qhat): every matrix acts on s-scaled coefficients c'' = s * c'.

    Cached per (cfg, dtype, device).  While `torch.export` traces, the
    tensors made are the tracer's fakes: they are cached apart, for that
    trace only, so that they never reach eager callers and the program
    holds one copy of each."""
    key = (cfg, dtype, torch.device(device))
    mode = torch._guards.detect_fake_mode()
    if mode is None:
        if key not in _CONSTS:
            _CONSTS[key] = _consts(cfg, dtype, device)
        return _CONSTS[key]
    hit = _TRACED_CONSTS.get(key)
    if hit is None or hit[0]() is not mode:
        hit = (weakref.ref(mode), _consts(cfg, dtype, device))
        _TRACED_CONSTS[key] = hit
    return hit[1]


def _consts(cfg: QPConfig, dtype: torch.dtype, device: torch.device):
    o, D, R = cfg.order, cfg.D, cfg.res
    s = bases.slot_scales(D, o)
    B0, B1, B2 = (b / s for b in bases.sampled_bases(D, R))
    Bz3 = bases.boundary_bases(D, 3, 0.0) / s
    Be3 = bases.boundary_bases(D, 3, 1.0) / s
    Beo = bases.boundary_bases(D, o, 1.0) / s
    fact = (np.array([bases.falling_factorial(r, r) for r in range(o)])
            / s[D - o:][::-1])
    Qhat = bases.gram_matrix(o) / np.outer(s, s)
    return tuple(torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                 device=device)
                 for a in (B0, B1, B2, Bz3, Be3, Beo, fact, Qhat))


def _consts_of(data: QPData):
    return consts(data.cfg, data.times.dtype, data.times.device)


def _xrev(x: torch.Tensor, o: int) -> torch.Tensor:
    """x[..., D-1-r] for r = 0..o-1 (what the tau=0 basis selects)."""
    D = x.shape[-1]
    return x[..., D - o:].flip(-1)


# ---------------------------------------------------------------------------
# linear operators (x: (B, S, 3, D) scaled coefficients)
# ---------------------------------------------------------------------------

def apply_A(data: QPData, x: torch.Tensor) -> dict:
    """All constraint rows applied to x.  Leaves: start (B,3,3), end (B,3,3),
    junc (B,S-1,3,o), corr (B,S,R,F), box (B,S,R,3,4)."""
    o = data.cfg.order
    B0, B1, B2, Bz3, Be3, Beo, fact, _ = _consts_of(data)

    start = torch.einsum('rd,bjd->bjr', Bz3, x[:, 0])
    end = torch.einsum('rd,bs,bsjd->bjr', Be3, data.end_onehot, x)

    left = torch.einsum('rd,bijd->bijr', Beo, x[:, :-1])
    right = _xrev(x[:, 1:], o) * fact
    jm = data.junc_mask[:, :, None, None]
    d = data.jrow_scale[:, :, None, :]
    junc = torch.where(jm > 0, (left - data.kappa[:, :, None, :] * right) * d,
                       right)

    pos = torch.einsum('rd,bijd->birj', B0, x)
    corr = torch.einsum('bifj,birj->birf', data.normals, pos)

    sm = data.seg_mask[:, :, None, None]
    vel = torch.einsum('rd,bijd->birj', B1, x) * sm
    acc = torch.einsum('rd,bijd->birj', B2, x) * sm
    box = torch.stack([vel, acc, -vel, -acc], dim=-1)
    return {'start': start, 'end': end, 'junc': junc, 'corr': corr, 'box': box}


def apply_AT(data: QPData, y: dict) -> torch.Tensor:
    """Adjoint of apply_A, written out term by term."""
    o, D = data.cfg.order, data.cfg.D
    B0, B1, B2, Bz3, Be3, Beo, fact, _ = _consts_of(data)

    pos = torch.einsum('bifj,birf->birj', data.normals, y['corr'])
    sm = data.seg_mask[:, :, None, None]
    ybox = y['box']
    vel = (ybox[..., 0] - ybox[..., 2]) * sm
    acc = (ybox[..., 1] - ybox[..., 3]) * sm
    x = (torch.einsum('rd,birj->bijd', B0, pos)
         + torch.einsum('rd,birj->bijd', B1, vel)
         + torch.einsum('rd,birj->bijd', B2, acc))
    x = x + torch.einsum('rd,bs,bjr->bsjd', Be3, data.end_onehot, y['end'])

    jm = data.junc_mask[:, :, None, None] > 0
    d = data.jrow_scale[:, :, None, :]
    yj = y['junc']
    w_left = torch.where(jm, yj * d, torch.zeros_like(yj))
    w_right = torch.where(jm, -data.kappa[:, :, None, :] * d * yj, yj) * fact
    # x is a fresh tensor here, so the adds below update it in place
    x[:, 0] += torch.einsum('rd,bjr->bjd', Bz3, y['start'])
    x[:, :-1] += torch.einsum('rd,bijr->bijd', Beo, w_left)
    x[:, 1:, :, D - o:] += w_right.flip(-1)
    return x


def apply_P(data: QPData, x: torch.Tensor, true_weights: bool = False):
    """Hessian in scaled variables: block-diagonal w_i * Qhat per (segment,
    axis), identity blocks on padded segments."""
    Qhat = _consts_of(data)[-1]
    w = data.w_true if true_weights else data.w_obj
    px = torch.einsum('de,bije->bijd', Qhat, x) * w[:, :, None, None]
    return px + (1.0 - data.seg_mask)[:, :, None, None] * x


def objective(data: QPData, x: torch.Tensor) -> torch.Tensor:
    """Physical objective 1/2 x^T Q x, (B,)."""
    px = apply_P(data, x, true_weights=True) * data.seg_mask[:, :, None, None]
    return 0.5 * (x * px).sum((1, 2, 3))


def eq_rhs(data: QPData) -> dict:
    B = data.times.shape[0]
    S, o = data.cfg.max_seg, data.cfg.order
    return {'start': data.b_start, 'end': data.b_end,
            'junc': data.times.new_zeros((B, S - 1, 3, o))}


def ineq_rhs(data: QPData) -> dict:
    cfg = data.cfg
    B = data.times.shape[0]
    return {'corr': data.h_corr,
            'box': data.h_box.expand(B, cfg.max_seg, cfg.res, 3, 4)}


EQ_KEYS = ('start', 'end', 'junc')
INEQ_KEYS = ('corr', 'box')


def tree_flat(y: dict, keys) -> torch.Tensor:
    B = y[keys[0]].shape[0]
    return torch.cat([y[k].reshape(B, -1) for k in keys], dim=1)


# ---------------------------------------------------------------------------
# normal matrix  M = sigma I + P + rho_eq Aeq^T Aeq + rho_in G^T G
# ---------------------------------------------------------------------------

def _kron3(C: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """kron over (axis, coeff): C (..., 3, 3) x K (D, D) -> (..., 3D, 3D)."""
    out = C[..., :, None, :, None] * K[:, None, :]
    s = out.shape
    return out.reshape(*s[:-4], s[-4] * s[-3], s[-2] * s[-1])


def normal_matrix(data: QPData, sigma, rho_eq, rho_in) -> torch.Tensor:
    """Dense (B, n, n) x-update matrix in closed form: every inequality row of
    segment i is a_f (x) beta_0(tau) or +/- e_j (x) beta_{1,2}(tau), so
    sum g g^T = C_i (x) B0^T B0 + 2 I3 (x) (B1^T B1 + B2^T B2); the equality
    rows add the block-tridiagonal continuity coupling."""
    cfg = data.cfg
    o, D, S = cfg.order, cfg.D, cfg.max_seg
    dtype, dev = data.times.dtype, data.times.device
    B0, B1, B2, Bz3, Be3, Beo, fact, Qhat = _consts_of(data)
    Bn = data.times.shape[0]
    n3d = 3 * D
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eyeD = torch.eye(D, dtype=dtype, device=dev)

    rho_eq = torch.as_tensor(rho_eq, dtype=dtype, device=dev).reshape(-1, 1, 1)
    rho_in = torch.as_tensor(rho_in, dtype=dtype, device=dev).reshape(-1, 1, 1)

    Pblk = (data.w_obj[:, :, None, None] * Qhat
            + (1.0 - data.seg_mask)[:, :, None, None] * eyeD
            + sigma * eyeD)
    diag = torch.einsum('jk,bsde->bsjdke', eye3, Pblk).reshape(Bn, S, n3d, n3d)

    C = torch.einsum('bifj,bifk->bijk', data.normals, data.normals)
    diag = diag + rho_in[:, None] * _kron3(C, B0.T @ B0)

    P12 = 2.0 * (B1.T @ B1 + B2.T @ B2)
    boxk = _kron3(eye3, P12)
    diag = diag + rho_in[:, None] * data.seg_mask[:, :, None, None] * boxk

    startk = _kron3(eye3, Bz3.T @ Bz3)
    sel0 = torch.zeros((S,), dtype=dtype, device=dev)
    sel0[0] = 1.0
    diag = diag + rho_eq[:, None] * sel0[None, :, None, None] * startk

    endk = _kron3(eye3, Be3.T @ Be3)
    diag = diag + rho_eq[:, None] * data.end_onehot[:, :, None, None] * endk

    jm = data.junc_mask
    d2 = data.jrow_scale ** 2
    leftk = torch.einsum('bir,rd,re->bide', d2, Beo, Beo)
    leftk = torch.einsum('jk,bide->bijdke', eye3, leftk).reshape(
        Bn, S - 1, n3d, n3d)
    add_left = rho_eq[:, None] * jm[:, :, None, None] * leftk
    coef = torch.where(jm[:, :, None] > 0, data.jrow_scale * data.kappa * fact,
                       fact.expand_as(data.kappa))
    slots = D - 1 - torch.arange(o, device=dev)
    slot_diag = torch.zeros((Bn, S - 1, D), dtype=dtype, device=dev)
    slot_diag[..., slots] = coef ** 2
    rdk = torch.einsum('jk,bide->bijdke', eye3,
                       torch.diag_embed(slot_diag)).reshape(Bn, S - 1, n3d, n3d)
    zpad = diag.new_zeros((Bn, 1, n3d, n3d))
    diag = (diag + torch.cat([add_left, zpad], 1)
            + torch.cat([zpad, rho_eq[:, None] * rdk], 1))

    cols = torch.zeros((Bn, S - 1, D, D), dtype=dtype, device=dev)
    cols[..., slots] = torch.einsum('bir,rd->bidr', d2 * data.kappa * fact, Beo)
    offd = -torch.einsum('jk,bide->bijdke', eye3, cols).reshape(
        Bn, S - 1, n3d, n3d)
    offd = rho_eq[:, None] * jm[:, :, None, None] * offd

    n = S * n3d
    M = torch.zeros((Bn, n, n), dtype=dtype, device=dev)
    for i in range(S):
        sl = slice(i * n3d, (i + 1) * n3d)
        M[:, sl, sl] += diag[:, i]
        if i < S - 1:
            sl2 = slice((i + 1) * n3d, (i + 2) * n3d)
            M[:, sl, sl2] += offd[:, i]
            M[:, sl2, sl] += offd[:, i].transpose(-1, -2)
    return M


# ---------------------------------------------------------------------------
# dense equality rows (polish, and the chunk kernel's A_eq)
# ---------------------------------------------------------------------------

def dense_eq(data: QPData):
    """(B, m_eq, n) equality matrix and (B, m_eq) RHS in scaled variables.
    Row order: start (j, r), end (j, r), junction (i, j, r)."""
    cfg = data.cfg
    o, D, S = cfg.order, cfg.D, cfg.max_seg
    dtype, dev = data.times.dtype, data.times.device
    _, _, _, Bz3, Be3, Beo, fact, _ = _consts_of(data)
    Bn = data.times.shape[0]
    n = S * 3 * D

    start_rows = torch.zeros((3, 3, S, 3, D), dtype=dtype, device=dev)
    for j in range(3):
        start_rows[j, :, 0, j, :] = Bz3
    start_rows = start_rows.reshape(9, n).expand(Bn, 9, n)

    end_rows = torch.zeros((Bn, 3, 3, S, 3, D), dtype=dtype, device=dev)
    for j in range(3):
        end_rows[:, j, :, :, j, :] = torch.einsum(
            'bs,rd->bsrd', data.end_onehot, Be3).permute(0, 2, 1, 3)
    end_rows = end_rows.reshape(Bn, 9, n)

    jm = data.junc_mask
    coef = torch.where(jm[:, :, None] > 0, data.jrow_scale * data.kappa * fact,
                       fact.expand_as(data.kappa))
    ar = torch.arange(o, device=dev)
    jrows = torch.zeros((Bn, S - 1, 3, o, S, 3, D), dtype=dtype, device=dev)
    for i in range(S - 1):
        left = torch.einsum('br,rd->brd', jm[:, i, None] * data.jrow_scale[:, i],
                            Beo)
        right = torch.zeros((Bn, o, D), dtype=dtype, device=dev)
        right[:, ar, D - 1 - ar] = torch.where(jm[:, i, None] > 0,
                                               -coef[:, i], coef[:, i])
        for j in range(3):
            jrows[:, i, j, :, i, j, :] = left
            jrows[:, i, j, :, i + 1, j, :] = right
    jrows = jrows.reshape(Bn, (S - 1) * 3 * o, n)

    Aeq = torch.cat([start_rows, end_rows, jrows], dim=1)
    return Aeq, tree_flat(eq_rhs(data), EQ_KEYS)


# ---------------------------------------------------------------------------
# solution transforms
# ---------------------------------------------------------------------------

def unscale_coeffs(data: QPData, x: torch.Tensor) -> torch.Tensor:
    """Scaled solution -> physical coefficients (B, S, 3, D), highest degree
    first; padded segments zeroed.  The variable change is
    x = s_k * T_i^{deg_k} * c_phys (slot equilibration and unit time)."""
    cfg = data.cfg
    dev = data.times.device
    pw = torch.as_tensor(bases.unscale_powers(cfg.D), dtype=x.dtype, device=dev)
    s = torch.as_tensor(bases.slot_scales(cfg.D, cfg.order), dtype=x.dtype,
                        device=dev)
    scale = s * data.times[:, :, None] ** pw
    return x / scale[:, :, None, :] * data.seg_mask[:, :, None, None]


def scale_coeffs(data: QPData, c: torch.Tensor) -> torch.Tensor:
    """Physical coefficients (B, S, 3, D) -> scaled variables, the inverse
    of `unscale_coeffs` on active segments."""
    cfg = data.cfg
    dev = data.times.device
    pw = torch.as_tensor(bases.unscale_powers(cfg.D), dtype=c.dtype, device=dev)
    s = torch.as_tensor(bases.slot_scales(cfg.D, cfg.order), dtype=c.dtype,
                        device=dev)
    scale = s * data.times[:, :, None] ** pw
    return c * scale[:, :, None, :]


def concat(datas) -> QPData:
    """Several QPData batches as one, along the batch axis: every tensor
    field concatenated, `cfg` kept (the batches must share it)."""
    cfg = datas[0].cfg
    if any(d.cfg != cfg for d in datas):
        raise ValueError("qp.concat: the batches have different configs")
    return QPData(*(torch.cat(fields) if isinstance(fields[0], torch.Tensor)
                    else fields[0] for fields in zip(*datas)))
