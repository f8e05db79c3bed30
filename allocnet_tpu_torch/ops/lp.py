"""Batched small dense LPs and polytope predicates.

Port of `allocnet_tpu/ops/lp.py` (the reference's Seidel LP, sdlp.hpp:
708-785, and the geo_utils predicates, geo_utils.hpp:43-124).  The
production solver is a batched primal log-barrier Newton IPM over a
4-variable system (`find_interior_ipm`); the fixed-iteration ADMM LP
(`solve_lp`) is kept for comparison, as in the JAX package.  Padded rows
are inert (zero row, offset 1).  Every function runs on its inputs'
device and dtype.
"""

from __future__ import annotations

import torch


def _mv(G, x):
    """(..., M, n) @ (..., n) -> (..., M)."""
    return torch.einsum('...mn,...n->...m', G, x)


def _mtv(G, y):
    """(..., M, n)^T @ (..., M) -> (..., n)."""
    return torch.einsum('...mn,...m->...n', G, y)


def solve_lp(c: torch.Tensor, G: torch.Tensor, h: torch.Tensor,
             eps: float = 1e-6, rho: float = 1.0, sigma: float = 1e-6,
             alpha: float = 1.6, iters: int = 400):
    """min c.x s.t. Gx <= h by a regularized ADMM, batched over leading
    dims.  c (..., n), G (..., M, n), h (..., M).  Returns (x (..., n),
    max violation (...,))."""
    n = c.shape[-1]
    eye = torch.eye(n, dtype=c.dtype, device=c.device)
    M = (eps + sigma) * eye + rho * torch.einsum('...mi,...mj->...ij', G, G)
    Minv = torch.linalg.inv_ex(M)[0]

    x = torch.zeros_like(c)
    z = torch.minimum(_mv(G, x), h)
    y = torch.zeros_like(h)
    for _ in range(iters):
        rhs = sigma * x - c + _mtv(G, rho * z - y)
        xt = torch.einsum('...nm,...m->...n', Minv, rhs)
        zt = _mv(G, xt)
        x_new = alpha * xt + (1 - alpha) * x
        v = alpha * zt + (1 - alpha) * z + y / rho
        z = torch.minimum(v, h)
        y = torch.clamp((v - z) * rho, -1e6, 1e6)
        x = torch.clamp(x_new, -1e6, 1e6)
    viol = (_mv(G, x) - h).clamp_min(0.0).amax(-1)
    return x, viol


def _normalize_rows(hpolys: torch.Tensor, mask: torch.Tensor):
    """Split padded (..., M, 4) a.x <= b stacks into unit rows and
    offsets."""
    a = hpolys[..., :3]
    nrm = torch.linalg.vector_norm(a, dim=-1)
    safe = nrm.clamp_min(1e-9)
    a = a / safe[..., None] * mask[..., None]
    b = torch.where(mask > 0, hpolys[..., 3] / safe,
                    torch.ones_like(safe))
    return a, b


def find_interior_ipm(hpolys: torch.Tensor, mask: torch.Tensor,
                      outer: int = 12, inner: int = 2, mu: float = 3.0):
    """Deepest interior point (max d s.t. a.x + d <= b, unit rows) by a
    batched primal log-barrier Newton IPM: `outer` barrier stages of
    `inner` Newton steps each.  The iterate stays strictly feasible, so
    the depth is a lower bound of the Chebyshev depth.

    Returns (point (..., 3), depth (...,))."""
    dt, dev = hpolys.dtype, hpolys.device
    mask = mask.to(dt)
    a, b = _normalize_rows(hpolys, mask)
    G = torch.cat([a, mask[..., None]], dim=-1)
    batch = hpolys.shape[:-2]

    # strictly feasible start: x = 0, d = min_i b_i - 1 (every slack >= 1)
    inf = torch.full_like(b, torch.inf)
    d0 = torch.where(mask > 0, b, inf).amin(-1) - 1.0
    d0 = torch.where(torch.isfinite(d0), d0, torch.full_like(d0, -1.0))
    z = torch.zeros(batch + (4,), dtype=dt, device=dev)
    z[..., 3] = d0
    c = torch.zeros(batch + (4,), dtype=dt, device=dev)
    c[..., 3] = -1.0
    eye = torch.eye(4, dtype=dt, device=dev)

    def newton(z, t):
        # slack floor 1e-6: inv_s**2 stays representable in f32
        s = (b - _mv(G, z)).clamp_min(1e-6)
        inv_s = 1.0 / s
        grad = t * c + _mtv(G, inv_s)
        H = torch.einsum('...mi,...m,...mj->...ij', G, inv_s * inv_s, G)
        H = H + 1e-6 * eye
        # solve_ex: no host sync for an error check, as on JAX's side
        dz = -torch.linalg.solve_ex(H, grad[..., None])[0][..., 0]
        # cap runaway steps on degenerate (all-padded) instances
        nrm = torch.linalg.vector_norm(dz, dim=-1, keepdim=True)
        dz = dz * torch.clamp(1e3 / nrm.clamp_min(1e-12), max=1.0)
        Gdz = _mv(G, dz)
        amax = torch.where(Gdz > 1e-12, s / Gdz.clamp_min(1e-12),
                           inf).amin(-1)
        alpha = torch.clamp(0.99 * amax, max=1.0)
        return z + alpha[..., None] * dz

    ts = mu ** torch.arange(outer, dtype=dt, device=dev)
    for k in range(outer):
        for _ in range(inner):
            z = newton(z, ts[k])
    return z[..., :3], z[..., 3]


def overlap_ipm(p1, m1, p2, m2, eps: float = 0.01, outer: int = 12,
                inner: int = 2):
    """`overlap` on the IPM."""
    hp = torch.cat([p1, p2], dim=-2)
    mk = torch.cat([m1, m2], dim=-1)
    _, depth = find_interior_ipm(hp, mk, outer=outer, inner=inner)
    return depth > eps


def find_interior_admm(hpolys: torch.Tensor, mask: torch.Tensor,
                       iters: int = 400):
    """`find_interior` by the first-order LP (comparison only: less
    accurate than the IPM on hard geometry)."""
    mask = mask.to(hpolys.dtype)
    a, b = _normalize_rows(hpolys, mask)
    G = torch.cat([a, mask[..., None]], dim=-1)
    c = torch.zeros(hpolys.shape[:-2] + (4,), dtype=hpolys.dtype,
                    device=hpolys.device)
    c[..., 3] = -1.0
    x, _ = solve_lp(c, G, b, iters=iters)
    return x[..., :3], x[..., 3]


def overlap_admm(p1, m1, p2, m2, eps: float = 0.01, iters: int = 400):
    """`overlap` on the first-order LP (comparison only)."""
    hp = torch.cat([p1, p2], dim=-2)
    mk = torch.cat([m1, m2], dim=-1)
    _, depth = find_interior_admm(hp, mk, iters=iters)
    return depth > eps


def find_interior(hpolys: torch.Tensor, mask: torch.Tensor,
                  iters: int = 400):
    """Deepest interior point (reference findInterior, geo_utils.hpp:
    43-61): hpolys (..., M, 4) a.x <= b rows (zero padded), mask (..., M).
    Returns (point (..., 3), depth (...,)); an interior exists iff depth >
    0.  Runs the IPM; `iters` is kept for the JAX signature."""
    del iters
    return find_interior_ipm(hpolys, mask)


def overlap(p1, m1, p2, m2, eps: float = 0.01, iters: int = 400):
    """Do two padded polytopes share a point with clearance eps?
    (geo_utils.hpp:64-124).  Returns bool (...)."""
    del iters
    return overlap_ipm(p1, m1, p2, m2, eps=eps)


def contains(hpolys: torch.Tensor, mask: torch.Tensor, pts: torch.Tensor,
             tol: float = 0.01):
    """Point in polytope (min_traj_opt.py:235): hpolys (..., M, 4), pts
    (..., 3) -> bool (...)."""
    v = _mv(hpolys[..., :3], pts) - hpolys[..., 3]
    v = torch.where(mask > 0, v, torch.full_like(v, -1.0))
    return v.amax(-1) <= tol
