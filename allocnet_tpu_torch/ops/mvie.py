"""Maximum-volume inscribed ellipsoid (MVIE), batched.

Port of `allocnet_tpu/ops/mvie.py` (the reference's maxVolInsEllipsoid,
firi.hpp:163-265): the smoothed-L1 penalty plus log-det objective over the
Cholesky-factor parametrization (costMVIE, firi.hpp:86-157), minimized by
the batched L-BFGS of ops/lbfgs.py from an interior point of the IPM in
ops/lp.py.

Ellipsoid: E = { R diag(r) u + p : |u| <= 1 }.  The rotation comes from an
SVD, whose column signs are free: torch and JAX may return R with columns
of opposite sign, so the ellipsoid is compared as R diag(r^2) R^T and p,
never R itself.

The row norm |A_i L| is sqrt(sum of squares), as `jnp.linalg.norm`
computes it: its gradient at a zero row (a padded row) is NaN in both
packages.  L-BFGS then finds no descent step and keeps the seed, so a
batch entry with any padded row returns its seed ellipsoid on both sides.
Inside FIRI every plane set is padded to `n_planes`, so there the
ellipsoid never moves from its seed; the port skips the iterations when
no problem of the batch can move (`max_vol_ellipsoid`), with the same
result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from allocnet_tpu_torch.ops import lbfgs, lp

SMOOTH_EPS = 1e-2     # firi.hpp:215 (*pSmoothEps)
PENALTY_WT = 1e3      # firi.hpp:216 (*pPenaltyWt)


class Ellipsoid(NamedTuple):
    R: torch.Tensor    # (..., 3, 3) rotation
    p: torch.Tensor    # (..., 3) centre
    r: torch.Tensor    # (..., 3) radii


def _smoothed_l1(x):
    """smoothedL1 with mu = SMOOTH_EPS (firi.hpp:60-84), zero for x <= 0."""
    mu = SMOOTH_EPS
    xdmu = x / mu
    quad = (mu - 0.5 * x) * xdmu * xdmu * xdmu
    lin = x - 0.5 * mu
    return torch.where(x <= 0.0, torch.zeros_like(x),
                       torch.where(x > mu, lin, quad))


def _L_of(params):
    """Lower-triangular factor (..., 3, 3) from the 9-vector (..., 9)."""
    rtd, cde = params[..., 3:6], params[..., 6:9]
    eps = torch.finfo(params.dtype).tiny
    zero = torch.zeros_like(rtd[..., 0])
    return torch.stack([
        torch.stack([rtd[..., 0] ** 2 + eps, zero, zero], -1),
        torch.stack([cde[..., 0], rtd[..., 1] ** 2 + eps, zero], -1),
        torch.stack([cde[..., 2], cde[..., 1], rtd[..., 2] ** 2 + eps], -1),
    ], -2)


def _cost(params, A, row_mask):
    """costMVIE (firi.hpp:86-157) for params (B, K, 9), rows A (B, M, 3):
    penalty on |A L| + A p - 1 minus log det L; masked rows add nothing."""
    p = params[..., :3]
    L = _L_of(params)
    AL = torch.einsum('bmi,bkij->bkmj', A, L)
    viola = (torch.sqrt((AL * AL).sum(-1))
             + torch.einsum('bmi,bki->bkm', A, p) - 1.0)
    pen = (_smoothed_l1(viola) * row_mask[:, None, :]).sum(-1)
    logdet = torch.log(L.diagonal(dim1=-2, dim2=-1)).sum(-1)
    return PENALTY_WT * pen - logdet


def max_vol_ellipsoid(hpolys: torch.Tensor, mask: torch.Tensor,
                      init: Ellipsoid, iters: int = 60, lp_iters: int = 400):
    """Batched MVIE: hpolys (..., M, 4) a.x <= b rows (zero padded), mask
    (..., M), seeded from `init`.  Returns (Ellipsoid, ok), ok = an
    interior point exists (depth > 0, firi.hpp:178-182)."""
    dt = hpolys.dtype
    mask = mask.to(dt)
    interior, depth = lp.find_interior(hpolys, mask, iters=lp_iters)
    ok = depth > 0.0

    a, b = lp._normalize_rows(hpolys, mask)
    denom = b - torch.einsum('...mi,...i->...m', a, interior)
    denom = torch.where(mask > 0, denom.clamp_min(1e-9),
                        torch.ones_like(denom))
    A = a / denom[..., None]                      # firi.hpp:196-198

    # initial 9-vector from the seed ellipsoid (firi.hpp:200-211)
    Q = torch.einsum('...ij,...j,...kj->...ik', init.R, init.r ** 2, init.R)
    eye = torch.eye(3, dtype=dt, device=hpolys.device)
    Lc = torch.linalg.cholesky_ex(Q + 1e-9 * eye)[0]
    d0 = torch.sqrt(Lc.diagonal(dim1=-2, dim2=-1).clamp_min(1e-6))
    x0 = torch.cat([init.p - interior, d0,
                    torch.stack([Lc[..., 1, 0], Lc[..., 2, 1], Lc[..., 2, 0]],
                                -1)], -1)

    batch_shape = hpolys.shape[:-2]
    flatA = A.reshape((-1,) + A.shape[-2:])
    flatM = mask.reshape(-1, mask.shape[-1])
    xs = x0.reshape(-1, 9)
    # a problem with a padded row keeps its seed (module docstring): when
    # every problem of the batch has one, as in FIRI's padded plane sets,
    # the iterations would change nothing and are skipped (one host sync)
    if bool((flatM > 0).all(1).any()):
        xs, _ = lbfgs.minimize(lambda v: _cost(v, flatA, flatM), xs,
                               iters=iters)
    xs = xs.reshape(batch_shape + (9,))

    L = _L_of(xs)
    p = xs[..., :3] + interior

    # L = U S V^T: rotation and radii from the left factor, the sign of
    # det U fixed by swapping its first two columns (firi.hpp:240-259)
    U, Sv, _ = torch.linalg.svd(L)
    swap = torch.linalg.det(U) < 0.0
    U_fixed = torch.where(swap[..., None, None], U[..., [1, 0, 2]], U)
    S_fixed = torch.where(swap[..., None], Sv[..., [1, 0, 2]], Sv)
    return Ellipsoid(R=U_fixed, p=p, r=S_fixed), ok
