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

The diagonal block is the operator `allocnet_torch::ldl_block`
(`ldl_block`): on a card the hand-written kernel csrc/ldl_block.cu (one
launch per block; the JAX package runs a `lax.fori_loop` inside its jitted
programs), on the CPU its plain version `ldl_block_reference`.  The panel's
triangular solve, the trailing GEMM and `ldl_solve`'s two triangular
solves are library calls, as JAX leaves them to XLA.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from allocnet_tpu_torch.ops import _cuda_build

SOURCE = _cuda_build.CSRC / "ldl_block.cu"
BUILD_DIR = _cuda_build.BUILD_DIR
# IEEE products and differences, no FMA contraction: the kernel's
# arithmetic is the plain operator's, in its order (csrc/ldl_block.cu)
NVCC_FLAGS = _cuda_build.NVCC_FLAGS + ["-fmad=false"]
MAX_NB = 64


# ---------------------------------------------------------------------------
# build and load (ops/_cuda_build.py), at first use
# ---------------------------------------------------------------------------

def library_name() -> str:
    """File name of the built library: keyed by a hash of the source and
    the flags."""
    return _cuda_build.library_name("ldl_block", SOURCE, NVCC_FLAGS)


def set_build_dir(path) -> None:
    """Build into (and load from) `path` from now on."""
    global BUILD_DIR
    BUILD_DIR = Path(path)
    build.cache_clear()
    _library.cache_clear()


@functools.cache
def build() -> dict:
    """Compile csrc/ldl_block.cu into BUILD_DIR unless that library exists
    there.  Returns {'path', 'seconds', 'ptxas'} (`_cuda_build.build`)."""
    return _cuda_build.build("ldl_block", SOURCE, NVCC_FLAGS, BUILD_DIR)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ldl_block_launch.argtypes = [i, i, ctypes.c_float] + [p] * 5
    lib.ldl_block_launch.restype = i
    lib.ldl_block_error_string.argtypes = [i]
    lib.ldl_block_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# the diagonal block: the operator, its kernel and its plain version
# ---------------------------------------------------------------------------

def ldl_block(Kb: torch.Tensor, sign: torch.Tensor, reg: float):
    """LDL^T of a (B, nb, nb) symmetric block, no pivoting.  Pivots smaller
    than `reg` are bumped to sign * reg (QDLDL-style); a large pivot keeps
    its value even if rounding flipped its sign.  Returns (L unit lower,
    d), d the unbumped diagonal.  The port of the JAX `_ldl_unblocked`.

    Runs the registered operator `allocnet_torch::ldl_block`: on CUDA
    tensors the kernel csrc/ldl_block.cu (f32, nb <= 64; one launch per
    block, counted in `ldl_block.launches`) or an error, on CPU tensors
    `ldl_block_reference`.  A program exported with `torch.export` holds
    one node per diagonal block."""
    return torch.ops.allocnet_torch.ldl_block(Kb, sign, float(reg))


ldl_block.launches = 0
_counted = ldl_block      # keeps counting when a caller wraps `ldl_block`


def ldl_block_reference(Kb: torch.Tensor, sign: torch.Tensor, reg: float):
    """The plain version of the kernel: the JAX loop over columns as
    batched tensor ops (~15 launches per column on a card), on any device
    and float dtype.  Divides by the pivot where JAX multiplies by its
    reciprocal."""
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


def _check(Kb: torch.Tensor, sign: torch.Tensor):
    if Kb.dim() != 3 or Kb.shape[1] != Kb.shape[2] or Kb.shape[1] < 1:
        raise ValueError(f"ldl_block: K has shape {tuple(Kb.shape)}, needs "
                         f"(B, nb, nb)")
    if tuple(sign.shape) != (Kb.shape[1],):
        raise ValueError(f"ldl_block: sign has shape {tuple(sign.shape)}, "
                         f"needs ({Kb.shape[1]},)")
    if sign.device != Kb.device:
        raise ValueError(f"ldl_block: sign on {sign.device}, K on "
                         f"{Kb.device}")
    if sign.dtype != Kb.dtype:
        raise TypeError(f"ldl_block: sign is {sign.dtype}, K {Kb.dtype}")
    if not (Kb.is_contiguous() and sign.is_contiguous()):
        raise ValueError("ldl_block: K and sign must be contiguous")


@torch.library.custom_op("allocnet_torch::ldl_block", mutates_args=(),
                         device_types="cpu")
def _ldl_block_op(Kb: torch.Tensor, sign: torch.Tensor,
                  reg: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The operator on CPU tensors: the plain version (f32, and f64 for
    the CPU's f64 solves)."""
    _check(Kb, sign)
    if Kb.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ldl_block: K is {Kb.dtype}")
    return ldl_block_reference(Kb, sign, reg)


@_ldl_block_op.register_kernel("cuda")
def _ldl_block_cuda(Kb, sign, reg):
    """The operator on CUDA tensors: one launch of the kernel or an
    error."""
    _check(Kb, sign)
    B, NB, _ = Kb.shape
    if Kb.dtype != torch.float32:
        raise TypeError(f"ldl_block: the kernel is float32, K is {Kb.dtype}")
    if NB > MAX_NB:
        raise ValueError(f"ldl_block: the kernel takes blocks of at most "
                         f"{MAX_NB} columns, not {NB}")
    L = torch.empty_like(Kb)
    d = Kb.new_empty((B, NB))
    lib = _library()
    with torch.cuda.device(Kb.device):
        stream = torch.cuda.current_stream(Kb.device).cuda_stream
        err = lib.ldl_block_launch(B, NB, float(reg), Kb.data_ptr(),
                                   sign.data_ptr(), L.data_ptr(),
                                   d.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ldl_block: launch failed at B={B} nb={NB}: "
                           f"cudaError {err} "
                           f"({lib.ldl_block_error_string(err).decode()})")
    _counted.launches += 1
    return L, d


@_ldl_block_op.register_fake
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
        Lkk, dk = ldl_block(K[:, s:s + nb, s:s + nb].contiguous(),
                            sign[s:s + nb], reg)
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
