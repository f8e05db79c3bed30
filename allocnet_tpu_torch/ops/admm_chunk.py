"""Fused ADMM chunk: the kernel wrapper, its plain version, and the chunk
loop around them.

`admm_chunk` runs `n_iters` OSQP-style ADMM iterations for every scenario of
a batch.  On CUDA tensors it launches the hand-written kernel in
`csrc/admm_chunk.cu` (which replaces the TPU kernel
`allocnet_tpu/ops/pallas/admm_tiled.py::_kernel`); on CPU tensors it runs
`admm_chunk_reference`, the same iterations as batched tensor ops.

Layout (B scenarios, n = S*3*D variables, m equality rows, S*R sample rows,
C = F + 12 inequality slots per row):

  x (B, n)              scaled coefficients, order (segment, axis, coeff)
  z, yh (B, S*R, C)     inequality values and scaled duals yh = y / rho_i;
                        slots: F faces, then box j*4 + (+v, +a, -v, -a)
  yeh (B, m)            scaled equality duals y_eq / rho_e
  kx (B, n, n)          x-update matrix (2 Minv - Minv M Minv)^T
  aeq (B, m, n), beq (B, m)
  normals (B, S, F, 3), h (B, S, C) slot bounds (the same for every sample)
  seg_mask (B, S), rho_i, rho_e (B,), basis (3, R, D) slot-scaled B0, B1, B2

`admm_solve_chunked` is the counterpart of `admm_tiled.admm_solve_tiled`:
the Cholesky / Newton-Schulz inverse, residuals and the rho rescale stay in
PyTorch between launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from allocnet_tpu_torch.config import QPConfig, SolverConfig
from allocnet_tpu_torch.ops import admm, qp

BOX_SLOTS = 12
SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "admm_chunk.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


# ---------------------------------------------------------------------------
# build and load (nvcc -> plain-C shared library -> ctypes), at first use
# ---------------------------------------------------------------------------

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build csrc/admm_chunk.cu")
    return path


@functools.cache
def build() -> dict:
    """Compile the kernel into BUILD_DIR (keyed by a hash of the source and
    flags) unless that library exists.  Returns {'path', 'seconds',
    'ptxas'}: build wall time (0 if it was already built) and the
    `-Xptxas -v` report (registers, shared memory, spills)."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"admm_chunk_{key}.so"
    log = BUILD_DIR / f"admm_chunk_{key}.log"
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0,
                "ptxas": log.read_text() if log.exists() else ""}
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, lib)          # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    report = res.stdout + res.stderr
    log.write_text(report)
    return {"path": str(lib), "seconds": time.perf_counter() - t0,
            "ptxas": report}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.admm_chunk_launch.argtypes = [i] * 7 + [f, f] + [p] * 18
    lib.admm_chunk_launch.restype = i
    lib.admm_chunk_smem_bytes.argtypes = [i] * 5
    lib.admm_chunk_smem_bytes.restype = ctypes.c_size_t
    lib.admm_chunk_error_string.argtypes = [i]
    lib.admm_chunk_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(cfg: QPConfig) -> int:
    """Dynamic shared memory of one kernel block at this shape (bytes), as
    the built library computes it."""
    return _library().admm_chunk_smem_bytes(cfg.max_seg, cfg.res,
                                            cfg.max_faces, cfg.D, cfg.n_eq)


# ---------------------------------------------------------------------------
# the wrapper and its plain version
# ---------------------------------------------------------------------------

def _dims(x, z, yeh, normals):
    B, n = x.shape
    S, F = normals.shape[1], normals.shape[2]
    R = z.shape[1] // S
    return B, n, S, R, F, n // (3 * S), yeh.shape[1]


def _check(x, z, yh, yeh, kx, aeq, beq, normals, h, seg_mask, rho_i, rho_e,
           basis):
    tensors = dict(x=x, z=z, yh=yh, yeh=yeh, kx=kx, aeq=aeq, beq=beq,
                   normals=normals, h=h, seg_mask=seg_mask, rho_i=rho_i,
                   rho_e=rho_e, basis=basis)
    dev = x.device
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"admm_chunk: {name} is {t.dtype}, needs float32")
        if t.device != dev:
            raise ValueError(f"admm_chunk: {name} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"admm_chunk: {name} is not contiguous")
    if normals.dim() != 4 or normals.shape[3] != 3:
        raise ValueError(f"admm_chunk: normals {tuple(normals.shape)}")
    B, n, S, R, F, D, m = _dims(x, z, yeh, normals)
    C = F + BOX_SLOTS
    want = dict(x=(B, n), z=(B, S * R, C), yh=(B, S * R, C), yeh=(B, m),
                kx=(B, n, n), aeq=(B, m, n), beq=(B, m), normals=(B, S, F, 3),
                h=(B, S, C), seg_mask=(B, S), rho_i=(B,), rho_e=(B,),
                basis=(3, R, D))
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"admm_chunk: {name} has shape "
                             f"{tuple(tensors[name].shape)}, expected {shape}")
    if n != S * 3 * D:
        raise ValueError(f"admm_chunk: n={n} is not S*3*D")


def admm_chunk(x, z, yh, yeh, kx, aeq, beq, normals, h, seg_mask, rho_i,
               rho_e, basis, n_iters: int, sigma: float, alpha: float):
    """`n_iters` ADMM iterations; returns new (x, z, yh, yeh).

    CPU tensors run `admm_chunk_reference`; CUDA tensors launch the kernel
    (on the current stream) or raise.  `admm_chunk.launches` counts kernel
    launches."""
    _check(x, z, yh, yeh, kx, aeq, beq, normals, h, seg_mask, rho_i, rho_e,
           basis)
    if x.device.type == "cpu":
        return admm_chunk_reference(x, z, yh, yeh, kx, aeq, beq, normals, h,
                                    seg_mask, rho_i, rho_e, basis, n_iters,
                                    sigma, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"admm_chunk: no kernel for device {x.device}")
    B, n, S, R, F, D, m = _dims(x, z, yeh, normals)
    lib = _library()
    outs = [torch.empty_like(t) for t in (x, z, yh, yeh)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.admm_chunk_launch(
            B, S, R, F, D, m, int(n_iters), float(sigma), float(alpha),
            *(t.data_ptr() for t in (kx, aeq, beq, normals, h, seg_mask,
                                     rho_i, rho_e, basis, x, z, yh, yeh)),
            *(t.data_ptr() for t in outs), stream)
    if err != 0:
        raise RuntimeError(
            f"admm_chunk: launch failed at S={S} R={R} F={F} D={D} m={m}: "
            f"cudaError {err} ({lib.admm_chunk_error_string(err).decode()}); "
            f"the kernel takes F + {BOX_SLOTS} <= 64 slots per row and one "
            f"scenario's state in one block's shared memory")
    admm_chunk.launches += 1
    return tuple(outs)


admm_chunk.launches = 0


def admm_chunk_reference(x, z, yh, yeh, kx, aeq, beq, normals, h, seg_mask,
                         rho_i, rho_e, basis, n_iters: int, sigma: float,
                         alpha: float):
    """Plain PyTorch version of the kernel: the same iterations as batched
    tensor ops.  Returns new (x, z, yh, yeh)."""
    B, n, S, R, F, D, m = _dims(x, z, yeh, normals)
    B0, B1, B2 = basis
    sm = seg_mask[:, :, None, None]
    ri, re = rho_i[:, None, None], rho_e[:, None]
    yci, yce = (1e6 / rho_i)[:, None, None], (1e6 / rho_e)[:, None]
    hh = h[:, :, None, :]                                  # (B, S, 1, C)
    z = z.view(B, S, R, -1)
    yh = yh.view(B, S, R, -1)
    for _ in range(n_iters):
        u = z - yh
        pos_w = torch.einsum('bsrf,bsfj->bsrj', u[..., :F], normals)
        ub = u[..., F:].reshape(B, S, R, 3, 4) * sm[..., None]
        gt = (torch.einsum('rd,bsrj->bsjd', B0, pos_w)
              + torch.einsum('rd,bsrj->bsjd', B1, ub[..., 0] - ub[..., 2])
              + torch.einsum('rd,bsrj->bsjd', B2, ub[..., 1] - ub[..., 3]))
        eq = torch.einsum('bmn,bm->bn', aeq, beq - yeh)
        rrow = sigma * x + re * eq + ri[:, :, 0] * gt.reshape(B, n)
        xt = torch.clamp(torch.einsum('bnm,bm->bn', kx, rrow), -1e6, 1e6)
        veq = torch.einsum('bmn,bn->bm', aeq, xt)
        xs = xt.view(B, S, 3, D)
        pos = torch.einsum('rd,bsjd->bsrj', B0, xs)
        vel = torch.einsum('rd,bsjd->bsrj', B1, xs) * sm
        acc = torch.einsum('rd,bsjd->bsrj', B2, xs) * sm
        vi = torch.cat([torch.einsum('bsfj,bsrj->bsrf', normals, pos),
                        torch.stack([vel, acc, -vel, -acc], -1).reshape(
                            B, S, R, BOX_SLOTS)], dim=-1)
        x = alpha * xt + (1.0 - alpha) * x
        v = alpha * vi + (1.0 - alpha) * z + yh
        z = torch.minimum(v, hh)
        yh = torch.clamp(v - z, -yci[..., None], yci[..., None])
        yeh = torch.clamp(yeh + alpha * (veq - beq), -yce, yce)
    return x, z.reshape(B, S * R, -1), yh.reshape(B, S * R, -1), yeh


# ---------------------------------------------------------------------------
# packing between QPData / dual trees and the chunk layout
# ---------------------------------------------------------------------------

def ineq_pack(tree: dict) -> torch.Tensor:
    """{'corr': (B,S,R,F), 'box': (B,S,R,3,4)} -> (B, S*R, F+12)."""
    corr, box = tree['corr'], tree['box']
    B, S, R, F = corr.shape
    return torch.cat([corr.reshape(B, S * R, F),
                      box.reshape(B, S * R, BOX_SLOTS)], dim=-1).contiguous()


def ineq_unpack(arr: torch.Tensor, cfg: QPConfig) -> dict:
    B = arr.shape[0]
    S, R, F = cfg.max_seg, cfg.res, cfg.max_faces
    return {'corr': arr[..., :F].reshape(B, S, R, F),
            'box': arr[..., F:].reshape(B, S, R, 3, 4)}


def yeq_unpack(flat: torch.Tensor, cfg: QPConfig) -> dict:
    B = flat.shape[0]
    S, o = cfg.max_seg, cfg.order
    return {'start': flat[:, 0:9].reshape(B, 3, 3),
            'end': flat[:, 9:18].reshape(B, 3, 3),
            'junc': flat[:, 18:18 + (S - 1) * 3 * o].reshape(B, S - 1, 3, o)}


def pack_scenario(data: qp.QPData):
    """Per-scenario f32 constants that last across chunks:
    (aeq, beq, normals, h, seg_mask, basis)."""
    cfg = data.cfg
    B, S = data.times.shape
    f32 = torch.float32
    Aeq, beq = qp.dense_eq(data)
    h_box = data.h_box.expand(B, S, 1, 3, 4).reshape(B, S, BOX_SLOTS)
    h = torch.cat([data.h_corr[:, :, 0, :], h_box], dim=-1)
    basis = torch.stack(qp.consts(cfg, f32, data.times.device)[:3])
    return tuple(t.to(f32).contiguous() for t in
                 (Aeq, beq, data.normals, h, data.seg_mask, basis))


def fused_refined_inverse(M: torch.Tensor, Minv: torch.Tensor) -> torch.Tensor:
    """The kernel's x-update matrix: Kx = 2 Minv - Minv M Minv (applying it
    is one step of iterative refinement of the Minv solve), stored
    TRANSPOSED.  The TPU kernel contracts Kx over its first axis, i.e.
    applies Kx^T, and in f32 Kx is not symmetric (spd_inverse's Newton step
    breaks the symmetry at ~1e-2 on ill-conditioned corridors), so the port
    applies Kx^T as well; admm.admm_solve applies Kx itself."""
    kx = 2.0 * Minv - Minv @ (M @ Minv)
    return kx.transpose(-1, -2).to(torch.float32).contiguous()


def admm_solve_chunked(data: qp.QPData, scfg: SolverConfig, x0=None, y0=None):
    """admm.admm_solve with the fused chunk as the inner loop.  Same
    signature and result (x, z, y, rho_e, rho_i, pri, dua), including the
    x0/y0 warm start; f32 only (raises TypeError on other dtypes)."""
    cfg = data.cfg
    dtype = data.times.dtype
    if dtype != torch.float32:
        raise TypeError(f"admm_solve_chunked: the fused chunk is float32, "
                        f"the QP is {dtype}")
    B = data.times.shape[0]
    beq_tree = qp.eq_rhs(data)
    hh = qp.ineq_rhs(data)
    x, z, y = admm.warm_start(data, x0, y0)

    rho_i, rho_floor = admm.initial_rho(data, scfg, torch.float32)
    rho_e = rho_i * scfg.rho_eq_scale
    aeq, beq, normals, h, seg_mask, basis = pack_scenario(data)

    xp = x.reshape(B, -1).to(torch.float32).contiguous()
    zp = ineq_pack({k: z[k] for k in qp.INEQ_KEYS}).to(torch.float32)
    yhp = (ineq_pack({k: y[k] for k in qp.INEQ_KEYS}).to(torch.float32)
           / rho_i[:, None, None])
    yehp = (qp.tree_flat({k: y[k] for k in qp.EQ_KEYS}, qp.EQ_KEYS).to(
        torch.float32) / rho_e[:, None])

    # first chunk: Cholesky inverse; later chunks cross the rho rescale with
    # the Newton-Schulz update (f = 1 on the first pass is the identity)
    if scfg.ns_rho_update:
        M = qp.normal_matrix(data, scfg.sigma, rho_e.to(dtype), rho_i.to(dtype))
        Minv = admm.spd_inverse(M)
        Nmat = qp.normal_matrix(data, scfg.sigma, 0.0, 0.0)
        P = M - Nmat
    f = torch.ones((B,), dtype=torch.float32, device=xp.device)

    for _ in range(scfg.n_chunks):
        if scfg.ns_rho_update:
            Minv, P = admm.ns_update_inverse(Minv, P, f, Nmat)
            M = Nmat + P
        else:
            M = qp.normal_matrix(data, scfg.sigma, rho_e.to(dtype),
                                 rho_i.to(dtype))
            Minv = admm.spd_inverse(M)
        xp, zp, yhp, yehp = admm_chunk(
            xp, zp, yhp.contiguous(), yehp.contiguous(),
            fused_refined_inverse(M, Minv), aeq, beq, normals, h, seg_mask,
            rho_i.contiguous(), rho_e.contiguous(), basis,
            scfg.iters_per_chunk, scfg.sigma, scfg.alpha)
        x, z, y = _unpack(cfg, xp, zp, yhp, yehp, rho_i, rho_e, beq_tree, dtype)
        rho_i_new = admm.rho_rescale(*admm._residuals(data, x, z, y, beq_tree,
                                                      hh), rho_i, rho_floor)
        # rescale the scaled duals to the new rho before the next chunk
        yhp = yhp * (rho_i / rho_i_new)[:, None, None]
        yehp = yehp * (rho_i / rho_i_new)[:, None]
        f = rho_i_new / rho_i
        rho_i = rho_i_new
        rho_e = rho_i * scfg.rho_eq_scale

    x, z, y = _unpack(cfg, xp, zp, yhp, yehp, rho_i, rho_e, beq_tree, dtype)
    pri, _, dua, _ = admm._residuals(data, x, z, y, beq_tree, hh)
    return x, z, y, rho_e.to(dtype), rho_i.to(dtype), pri, dua


def _unpack(cfg, xp, zp, yhp, yehp, rho_i, rho_e, beq_tree, dtype):
    """Chunk layout -> structured (x, z, y) in `dtype` (unscaled duals)."""
    B = xp.shape[0]
    x = xp.reshape(B, cfg.max_seg, 3, cfg.D).to(dtype)
    z = dict(beq_tree, **{k: v.to(dtype)
                          for k, v in ineq_unpack(zp, cfg).items()})
    yi = ineq_unpack(yhp * rho_i[:, None, None], cfg)
    ye = yeq_unpack(yehp * rho_e[:, None], cfg)
    y = {k: v.to(dtype) for k, v in {**ye, **yi}.items()}
    return x, z, y
