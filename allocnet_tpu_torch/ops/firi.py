"""FIRI: Fast Iterative Region Inflation, batched over windows.

Port of `allocnet_tpu/ops/firi.py` (the reference's firi::firi,
firi.hpp:267-416): grow a convex polytope around a seed segment inside a
bounding box, separating it from a local obstacle cloud, alternating with
MVIE (ops/mvie.py).

The reference's greedy plane selection ends when the data says so
(firi.hpp:349-398); the JAX module scans a fixed `n_planes` picks with
masked no-ops after the end, and this port runs the same `n_planes` masked
steps as a Python loop.  `torch.argmin` and `jnp.argmin` both return the
first minimum, so ties pick the same row.

Half-spaces are a.x <= b rows ((..., 4), b in column 3); padded rows and
points are zeros with mask arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from allocnet_tpu_torch.ops import mvie


class FiriResult(NamedTuple):
    hpolys: torch.Tensor     # (B, K, 4) a.x <= b rows, zero padded
    mask: torch.Tensor       # (B, K)
    ellipsoid: mvie.Ellipsoid
    ok: torch.Tensor         # (B,) seed endpoints inside the bounding box


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


def _tangent_planes(pc_f, fa, fb, eps):
    """Per-point separating planes in the forward (ball) frame
    (firi.hpp:303-335): the sphere tangent, relaxed toward the seed
    endpoints where it would cut them off."""
    distR = _norm(pc_f)
    n = pc_f / distR.clamp_min(1e-12)[..., None]
    t3 = -distR

    def relax(n, t3, distR, endpoint):
        viol = torch.einsum('bnj,bj->bn', n, endpoint) + t3 > eps
        delta = pc_f - endpoint[:, None, :]
        dd = (delta * delta).sum(-1).clamp_min(1e-12)
        proj = endpoint[:, None, :] - (
            (delta * endpoint[:, None, :]).sum(-1) / dd)[..., None] * delta
        pnorm = _norm(proj).clamp_min(1e-12)
        n2 = proj / pnorm[..., None]
        return (torch.where(viol[..., None], n2, n),
                torch.where(viol, -pnorm, t3),
                torch.where(viol, pnorm, distR))

    n, t3, distR = relax(n, t3, distR, fa)
    n, t3, distR = relax(n, t3, distR, fb)

    # last resort: the plane through the point that keeps both endpoints
    viol = torch.einsum('bnj,bj->bn', n, fa) + t3 > eps
    cr = torch.linalg.cross(fa[:, None, :] - pc_f, fb[:, None, :] - pc_f,
                            dim=-1)
    crn = cr / _norm(cr).clamp_min(1e-12)[..., None]
    t3c = -torch.einsum('bnj,bj->bn', crn, fa)
    flip = torch.where(t3c > 0.0, -1.0, 1.0).to(pc_f.dtype)
    n = torch.where(viol[..., None], crn * flip[..., None], n)
    t3 = torch.where(viol, t3c * flip, t3)
    return n, t3, distR


def _clear(flags, idx, cond):
    """flags[b, idx[b]] &= ~cond[b]."""
    cur = flags.gather(1, idx[:, None])
    return flags.scatter(1, idx[:, None], cur & ~cond[:, None])


def firi(
    bd: torch.Tensor,        # (B, Mb, 4) bounding rows a.x <= b
    pc: torch.Tensor,        # (B, N, 3) obstacle points (padded)
    pc_mask: torch.Tensor,   # (B, N)
    seed_a: torch.Tensor,    # (B, 3)
    seed_b: torch.Tensor,    # (B, 3)
    iterations: int = 4,     # firi.hpp:272
    n_planes: int = 50,
    eps: float = 1e-6,
    mvie_iters: int = 60,
) -> FiriResult:
    B, Mb, _ = bd.shape
    dt, dev = bd.dtype, bd.device
    bd_a, bd_b = bd[..., :3], bd[..., 3]
    batch = torch.arange(B, device=dev)
    inf = torch.tensor(torch.inf, dtype=dt, device=dev)

    def inside(x):
        return (torch.einsum('bmi,bi->bm', bd_a, x) - bd_b).amax(-1) <= 0.0

    ok = inside(seed_a) & inside(seed_b)
    ell = mvie.Ellipsoid(
        R=torch.eye(3, dtype=dt, device=dev).expand(B, 3, 3),
        p=0.5 * (seed_a + seed_b),
        r=torch.ones((B, 3), dtype=dt, device=dev))

    for loop in range(iterations):
        inv_r = 1.0 / ell.r.clamp_min(1e-9)
        forward = inv_r[..., :, None] * ell.R.transpose(-1, -2)
        backward = ell.R * ell.r[..., None, :]

        fwdB = torch.einsum('bmi,bij->bmj', bd_a, backward)       # (B,Mb,3)
        fwdD = torch.einsum('bmi,bi->bm', bd_a, ell.p) - bd_b     # a.p - b
        distD = fwdD.abs() / _norm(fwdB).clamp_min(1e-12)

        pc_f = torch.einsum('bij,bnj->bni', forward, pc - ell.p[:, None, :])
        fa = torch.einsum('bij,bj->bi', forward, seed_a - ell.p)
        fb = torch.einsum('bij,bj->bi', forward, seed_b - ell.p)

        tn, t3, distR = _tangent_planes(pc_f, fa, fb, eps)
        distR = torch.where(pc_mask > 0, distR, inf)

        bdF = torch.ones((B, Mb), dtype=torch.bool, device=dev)
        pcF = pc_mask > 0
        planes_f = torch.zeros((B, n_planes, 4), dtype=dt, device=dev)
        nH = torch.zeros((B,), dtype=torch.long, device=dev)
        for _ in range(n_planes):
            dD = torch.where(bdF, distD, inf)
            dR = torch.where(pcF, distR, inf)
            iD = torch.argmin(dD, dim=-1)
            iR = torch.argmin(dR, dim=-1)
            mD = dD[batch, iD]
            mR = dR[batch, iR]
            active = torch.isfinite(torch.minimum(mD, mR))
            pick_bd = mD < mR

            rows_bd = torch.cat([fwdB[batch, iD], fwdD[batch, iD, None]], -1)
            rows_pc = torch.cat([tn[batch, iR], t3[batch, iR, None]], -1)
            row = torch.where(pick_bd[:, None], rows_bd, rows_pc)
            planes_f[batch, nH] = torch.where(active[:, None], row,
                                              planes_f[batch, nH])

            bdF = _clear(bdF, iD, pick_bd & active)
            pcF = _clear(pcF, iR, ~pick_bd & active)
            # drop the points the chosen plane already separates
            sep = (torch.einsum('bni,bi->bn', pc_f, row[:, :3])
                   + row[:, 3:4] > -eps)
            pcF = pcF & ~(sep & active[:, None])
            nH = nH + active.long()

        # back to the world frame (firi.hpp:400-405): n_w = n_f @ forward,
        # b_w = -d_f + n_w . p
        n_w = torch.einsum('bki,bij->bkj', planes_f[..., :3], forward)
        b_w = -planes_f[..., 3] + torch.einsum('bki,bi->bk', n_w, ell.p)
        kidx = torch.arange(n_planes, device=dev)[None, :]
        pmask = (kidx < nH[:, None]).to(dt)
        planes = torch.cat([n_w, b_w[..., None]], -1) * pmask[..., None]

        if loop < iterations - 1:
            ell, _ = mvie.max_vol_ellipsoid(planes, pmask, ell,
                                            iters=mvie_iters)

    return FiriResult(hpolys=planes, mask=pmask, ellipsoid=ell, ok=ok)
