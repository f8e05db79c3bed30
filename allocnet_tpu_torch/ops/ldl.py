"""Batched pivot-free blocked LDL^T for quasi-definite KKT systems.

Port of `allocnet_tpu/ops/ldl.py`.  The polish solves the regularized KKT

    [[P + delta I,  A^T     ],
     [A,            -delta I]]

which is quasi-definite, so LDL^T exists without pivoting for every
symmetric permutation (Vanderbei 1995).  Blocked right-looking schedule with
block size nb: unblocked LDL^T of the diagonal block, a triangular solve for
the panel, a GEMM for the trailing update.  In f32 the raw factor is only
~1e-2 accurate through the tiny pivots; the polish's iterative refinement
restores full accuracy.
"""

from __future__ import annotations

import torch


def _ldl_unblocked(Kb: torch.Tensor, sign: torch.Tensor, reg: float):
    """LDL^T of a (B, nb, nb) symmetric block, no pivoting.  Pivots smaller
    than `reg` are bumped to sign * reg (QDLDL-style); a large pivot keeps
    its value even if rounding flipped its sign.  Returns (L unit lower, d).

    Runs as the registered operator `allocnet_torch::ldl_block`, so that a
    program exported with `torch.export` holds one node per diagonal block
    instead of the ~20 of each column (the polish factors up to 12 KKT
    systems of 256 columns per solve); the operator runs this same code."""
    return torch.ops.allocnet_torch.ldl_block(Kb, sign, float(reg))


@torch.library.custom_op("allocnet_torch::ldl_block", mutates_args=())
def _ldl_block(Kb: torch.Tensor, sign: torch.Tensor,
               reg: float) -> tuple[torch.Tensor, torch.Tensor]:
    B, NB, _ = Kb.shape
    K = Kb.clone()
    ar = torch.arange(NB, device=K.device)
    for j in range(NB):
        dj = K[:, j, j]
        dj = torch.where(dj.abs() >= reg, dj, sign[j] * reg)
        col = K[:, :, j] / dj[:, None]
        mask = (ar > j).to(K.dtype)
        lcol = col * mask
        K = K - dj[:, None, None] * lcol[:, :, None] * lcol[:, None, :]
        K[:, :, j] = torch.where(mask > 0, col, K[:, :, j])
    d = K.diagonal(dim1=1, dim2=2).clone()
    L = torch.tril(K, -1) + torch.eye(NB, dtype=K.dtype, device=K.device)
    return L, d


@_ldl_block.register_fake
def _ldl_block_fake(Kb, sign, reg):
    return torch.empty_like(Kb), Kb.new_empty(Kb.shape[:2])


def ldl_factor(K: torch.Tensor, nb: int = 64, n_pos: int | None = None,
               reg: float = 1e-6, sign: torch.Tensor | None = None):
    """Blocked LDL^T of (B, N, N), N a multiple of nb.  Expected pivot signs
    come from `n_pos` (leading positive block, rest negative) or an explicit
    `sign` vector of +/-1; padding columns are positive.  Returns (L, d)."""
    B, N, _ = K.shape
    if N % nb:
        raise ValueError(f"size {N} is not a multiple of the block {nb}")
    dtype, dev = K.dtype, K.device
    if sign is None:
        n_pos = N if n_pos is None else n_pos
        sign = torch.where(torch.arange(N, device=dev) < n_pos, 1.0, -1.0)
    sign = torch.as_tensor(sign, dtype=dtype, device=dev)
    if sign.shape[0] < N:
        sign = torch.cat([sign, sign.new_ones(N - sign.shape[0])])

    K = K.clone()
    L = torch.zeros_like(K)
    d = K.new_zeros((B, N))
    for s in range(0, N, nb):
        Lkk, dk = _ldl_unblocked(K[:, s:s + nb, s:s + nb], sign[s:s + nb], reg)
        L[:, s:s + nb, s:s + nb] = Lkk
        d[:, s:s + nb] = dk
        if s + nb < N:
            rest = slice(s + nb, N)
            # panel: X L_kk^T = K_rest,k
            panel = torch.linalg.solve_triangular(
                Lkk.transpose(1, 2), K[:, rest, s:s + nb], upper=True,
                left=False)
            dinv = torch.where(dk.abs() > 1e-30, 1.0 / dk,
                               torch.zeros((), dtype=dtype, device=dev))
            Lpanel = panel * dinv[:, None, :]
            L[:, rest, s:s + nb] = Lpanel
            K[:, rest, rest] -= (Lpanel * dk[:, None, :]) @ Lpanel.transpose(1, 2)
    return L, d


def ldl_solve(L: torch.Tensor, d: torch.Tensor, rhs: torch.Tensor):
    """Solve K x = rhs given K = L D L^T; rhs (B, N) -> (B, N)."""
    y = torch.linalg.solve_triangular(L, rhs[:, :, None], upper=False,
                                      unitriangular=True)[:, :, 0]
    dinv = torch.where(d.abs() > 1e-30, 1.0 / d,
                       torch.zeros((), dtype=d.dtype, device=d.device))
    return torch.linalg.solve_triangular(
        L.transpose(1, 2), (y * dinv)[:, :, None], upper=True,
        unitriangular=True)[:, :, 0]


def pad_to_block(K: torch.Tensor, rhs: torch.Tensor, nb: int = 64):
    """Pad (B, N, N) K with identity and rhs with zeros to a multiple of nb.
    Returns (K_padded, rhs_padded, N)."""
    B, N, _ = K.shape
    Np = -(-N // nb) * nb
    if Np == N:
        return K, rhs, N
    Kp = K.new_zeros((B, Np, Np))
    Kp[:, :N, :N] = K
    Kp[:, N:, N:] = torch.eye(Np - N, dtype=K.dtype, device=K.device)
    rp = rhs.new_zeros((B, Np))
    rp[:, :N] = rhs
    return Kp, rp, N
