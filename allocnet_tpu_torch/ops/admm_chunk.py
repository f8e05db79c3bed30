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
  aeq_val (B, m, 2, D), aeq_blk (B, m, 2) int32
                        the equality rows, structured: each row's values on
                        (at most) two (segment, axis) blocks of D
                        coefficients and those blocks' indices s*3 + j
                        (`pack_aeq`; `aeq_dense` expands them), beq (B, m)
  normals (B, S, F, 3), h (B, S, C) slot bounds (the same for every sample)
  seg_mask (B, S), rho_i, rho_e (B,), basis (3, R, D) slot-scaled B0, B1, B2

`admm_solve_chunked` is the counterpart of `admm_tiled.admm_solve_tiled`:
the Cholesky / Newton-Schulz inverse, residuals and the rho rescale stay in
PyTorch between launches.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from allocnet_tpu_torch.config import QPConfig, SolverConfig
from allocnet_tpu_torch.ops import _cuda_build, admm, qp
from allocnet_tpu_torch.utils import scenarios

BOX_SLOTS = 12
SOURCE = _cuda_build.CSRC / "admm_chunk.cu"
BUILD_DIR = _cuda_build.BUILD_DIR


# ---------------------------------------------------------------------------
# build and load (ops/_cuda_build.py), at first use
# ---------------------------------------------------------------------------

def _flags(profile: bool) -> list:
    return _cuda_build.NVCC_FLAGS + (["-DADMM_CHUNK_PROFILE"] if profile
                                     else [])


def library_name(profile: bool = False) -> str:
    """File name of the built library: keyed by a hash of the source and
    the flags, so an edit of either builds anew."""
    return _cuda_build.library_name("admm_chunk", SOURCE, _flags(profile))


def set_build_dir(path) -> None:
    """Build into (and load from) `path` from now on."""
    global BUILD_DIR
    BUILD_DIR = Path(path)
    build.cache_clear()
    _library.cache_clear()


@functools.cache
def build(profile: bool = False) -> dict:
    """Compile the kernel into BUILD_DIR unless that library exists there
    (`library_name`).  `profile` builds the variant that records per-phase
    cycle counts (-DADMM_CHUNK_PROFILE).  Returns {'path', 'seconds',
    'ptxas'}: build wall time (0 if it was already built) and the
    `-Xptxas -v` report (registers, shared memory, spills)."""
    return _cuda_build.build("admm_chunk", SOURCE, _flags(profile),
                             BUILD_DIR)


@functools.cache
def _library(profile: bool = False) -> ctypes.CDLL:
    lib = ctypes.CDLL(build(profile)["path"])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.admm_chunk_launch.argtypes = [i] * 7 + [f, f] + [p] * 20
    lib.admm_chunk_launch.restype = i
    lib.admm_chunk_smem_bytes.argtypes = [i] * 5
    lib.admm_chunk_smem_bytes.restype = ctypes.c_size_t
    lib.admm_chunk_blocks_per_sm.argtypes = [i] * 5
    lib.admm_chunk_blocks_per_sm.restype = i
    lib.admm_chunk_kx_mode.argtypes = [i] * 7
    lib.admm_chunk_kx_mode.restype = i
    lib.admm_chunk_error_string.argtypes = [i]
    lib.admm_chunk_error_string.restype = ctypes.c_char_p
    lib.admm_chunk_phase_names.restype = ctypes.c_char_p
    return lib


def smem_bytes(cfg: QPConfig) -> int:
    """Dynamic shared memory of one kernel block at this shape (bytes), as
    the built library computes it for the current card; 0 if the kernel
    does not take the shape (the fixed part and one scenario's z / yh
    slots need more than a block may opt in to).  Half an SM where that
    holds the fixed part and the slots (two blocks per SM), else up to the
    whole opt-in (one block per SM); Kx stays in device memory where its
    live block does not fit in what is left (`kx_modes`)."""
    return _library().admm_chunk_smem_bytes(cfg.max_seg, cfg.res,
                                            cfg.max_faces, cfg.D, cfg.n_eq)


def blocks_per_sm(cfg: QPConfig) -> int:
    """Scenarios (blocks) resident per SM at this shape on the current card
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), -1 if refused: 2 at
    the deploy shape, 1 from 8 segments at res 20."""
    return _library().admm_chunk_blocks_per_sm(cfg.max_seg, cfg.res,
                                               cfg.max_faces, cfg.D, cfg.n_eq)


# where a block keeps Kx, by the kernel's mode number
KX_MODES = ("f64 shared", "f32 shared", "device memory")


def kx_modes(*args) -> np.ndarray:
    """(B,) int: where the kernel keeps each scenario's Kx on a launch with
    these arguments (those of `admm_chunk`): 0 its live block as f64 in
    shared memory, 1 as f32 there, 2 in device memory.  The rule its
    blocks apply: `live_parts`, then what the launch's shared memory holds
    after the live z / yh slots.  Needs the built library (the card's
    shared memory sizes); the profile build records the same per block
    (`phase_cycles`)."""
    B, n, S, R, F, D, m = _dims(args[0], args[1], args[3], args[8])
    Ls, face_live = live_parts(*args)
    Fw = face_live.sum(-1).amax(-1)
    lib, modes = _library(), {}
    pairs = torch.stack([Ls, Fw], 1).cpu().tolist()
    for p in pairs:
        if tuple(p) not in modes:
            modes[tuple(p)] = lib.admm_chunk_kx_mode(S, R, F, D, m, *p)
    return np.array([modes[tuple(p)] for p in pairs])


# ---------------------------------------------------------------------------
# the wrapper and its plain version
# ---------------------------------------------------------------------------

def _dims(x, z, yeh, normals):
    B, n = x.shape
    S, F = normals.shape[1], normals.shape[2]
    R = z.shape[1] // S
    return B, n, S, R, F, n // (3 * S), yeh.shape[1]


def _check(x, z, yh, yeh, kx, aeq_val, aeq_blk, beq, normals, h, seg_mask,
           rho_i, rho_e, basis):
    tensors = dict(x=x, z=z, yh=yh, yeh=yeh, kx=kx, aeq_val=aeq_val,
                   aeq_blk=aeq_blk, beq=beq, normals=normals, h=h,
                   seg_mask=seg_mask, rho_i=rho_i, rho_e=rho_e, basis=basis)
    dev = x.device
    for name, t in tensors.items():
        want_dtype = torch.int32 if name == "aeq_blk" else torch.float32
        if t.dtype != want_dtype:
            raise TypeError(f"admm_chunk: {name} is {t.dtype}, needs "
                            f"{want_dtype}")
        if t.device != dev:
            raise ValueError(f"admm_chunk: {name} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"admm_chunk: {name} is not contiguous")
    if normals.dim() != 4 or normals.shape[3] != 3:
        raise ValueError(f"admm_chunk: normals {tuple(normals.shape)}")
    B, n, S, R, F, D, m = _dims(x, z, yeh, normals)
    C = F + BOX_SLOTS
    want = dict(x=(B, n), z=(B, S * R, C), yh=(B, S * R, C), yeh=(B, m),
                kx=(B, n, n), aeq_val=(B, m, 2, D), aeq_blk=(B, m, 2),
                beq=(B, m), normals=(B, S, F, 3),
                h=(B, S, C), seg_mask=(B, S), rho_i=(B,), rho_e=(B,),
                basis=(3, R, D))
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"admm_chunk: {name} has shape "
                             f"{tuple(tensors[name].shape)}, expected {shape}")
    if n != S * 3 * D:
        raise ValueError(f"admm_chunk: n={n} is not S*3*D")


def admm_chunk(x, z, yh, yeh, kx, aeq_val, aeq_blk, beq, normals, h, seg_mask,
               rho_i, rho_e, basis, n_iters: int, sigma: float, alpha: float):
    """`n_iters` ADMM iterations; returns new (x, z, yh, yeh).

    CPU tensors run `admm_chunk_reference`; CUDA tensors launch the kernel
    (on the current stream) or raise.  `admm_chunk.launches` counts kernel
    launches.  Calls the registered operator `allocnet_torch::admm_chunk`,
    so that `torch.export` can trace a program that contains it."""
    return torch.ops.allocnet_torch.admm_chunk(
        x, z, yh, yeh, kx, aeq_val, aeq_blk, beq, normals, h, seg_mask,
        rho_i, rho_e, basis, int(n_iters), float(sigma), float(alpha))


admm_chunk.launches = 0


@torch.library.custom_op("allocnet_torch::admm_chunk", mutates_args=())
def _admm_chunk_op(x: torch.Tensor, z: torch.Tensor, yh: torch.Tensor,
                   yeh: torch.Tensor, kx: torch.Tensor, aeq_val: torch.Tensor,
                   aeq_blk: torch.Tensor, beq: torch.Tensor,
                   normals: torch.Tensor, h: torch.Tensor,
                   seg_mask: torch.Tensor, rho_i: torch.Tensor,
                   rho_e: torch.Tensor, basis: torch.Tensor, n_iters: int,
                   sigma: float, alpha: float
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """The operator behind `admm_chunk` (its real implementation)."""
    args = (x, z, yh, yeh, kx, aeq_val, aeq_blk, beq, normals, h, seg_mask,
            rho_i, rho_e, basis)
    _check(*args)
    if x.device.type == "cpu":
        outs = admm_chunk_reference(*args, n_iters, sigma, alpha)
        # an operator's outputs may not alias its inputs (n_iters = 0)
        return tuple(o.clone() if o.untyped_storage().data_ptr()
                     == i.untyped_storage().data_ptr() else o
                     for o, i in zip(outs, args))
    if x.device.type != "cuda":
        raise ValueError(f"admm_chunk: no kernel for device {x.device}")
    outs = _launch(_library(), *args, n_iters, sigma, alpha, None)
    admm_chunk.launches += 1
    return outs


@_admm_chunk_op.register_fake
def _admm_chunk_fake(x, z, yh, yeh, kx, aeq_val, aeq_blk, beq, normals, h,
                     seg_mask, rho_i, rho_e, basis, n_iters, sigma, alpha):
    _check(x, z, yh, yeh, kx, aeq_val, aeq_blk, beq, normals, h, seg_mask,
           rho_i, rho_e, basis)
    return tuple(torch.empty_like(t) for t in (x, z, yh, yeh))


def _launch(lib, x, z, yh, yeh, kx, aeq_val, aeq_blk, beq, normals, h,
            seg_mask, rho_i, rho_e, basis, n_iters, sigma, alpha, prof):
    B, n, S, R, F, D, m = _dims(x, z, yeh, normals)
    outs = [torch.empty_like(t) for t in (x, z, yh, yeh)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.admm_chunk_launch(
            B, S, R, F, D, m, int(n_iters), float(sigma), float(alpha),
            *(t.data_ptr() for t in (kx, aeq_val, aeq_blk, beq, normals, h,
                                     seg_mask, rho_i, rho_e, basis, x, z, yh,
                                     yeh)),
            *(t.data_ptr() for t in outs),
            None if prof is None else prof.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"admm_chunk: launch failed at S={S} R={R} F={F} D={D} m={m}: "
            f"cudaError {err} ({lib.admm_chunk_error_string(err).decode()}); "
            f"the kernel takes F + {BOX_SLOTS} <= 64 slots per row, an even "
            f"D, and the fixed part and one scenario's z / yh slots in the "
            f"shared memory a block may opt in to (Kx may stay in device "
            f"memory)")
    return tuple(outs)


def phase_cycles(*args, n_iters: int, sigma: float, alpha: float):
    """One launch of the profile build of the kernel (CUDA tensors, the
    arguments of `admm_chunk`): returns (phase names, (B, 3, phases) int64
    SM cycles per block, summed over the iterations: [:, 0] each phase's
    wall time, [:, 1] its slowest warp's busy time and [:, 2] all warps'
    busy time, the last two for the iteration's phases only; [:, 1, 0],
    in the load phase's column, is where the block kept Kx, as in
    `kx_modes`).  Not counted
    in `admm_chunk.launches`: it is a measurement, not the main path."""
    _check(*args)
    lib = _library(profile=True)
    names = lib.admm_chunk_phase_names().decode().split(",")
    prof = torch.zeros((args[0].shape[0], 3, len(names)), dtype=torch.int64,
                       device=args[0].device)
    _launch(lib, *args, n_iters, sigma, alpha, prof)
    torch.cuda.synchronize(args[0].device)
    return names, prof.cpu()


def admm_chunk_reference(x, z, yh, yeh, kx, aeq_val, aeq_blk, beq, normals,
                         h, seg_mask, rho_i, rho_e, basis, n_iters: int,
                         sigma: float, alpha: float,
                         sum_dtype=torch.float64):
    """Plain PyTorch version of the kernel: the same iterations as batched
    tensor ops, dense (Aeq expanded, every segment and slot).  Everything is
    f32 but the x-update product Kx rrow, which is taken in f64 from its f32
    operands and rounded back (in f32 it carries most of a chunk's roundoff
    error).  `sum_dtype=torch.float32` takes that product in f32 instead,
    as the TPU kernel does (for accuracy studies); f64 inputs run the whole
    chunk in f64.  Returns new (x, z, yh, yeh)."""
    B, n, S, R, F, D, m = _dims(x, z, yeh, normals)
    aeq = aeq_dense(aeq_val, aeq_blk, n)
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
        # Kx rrow: f32 operands, products and sum in f64, as the kernel
        xt = torch.clamp(torch.einsum('bnm,bm->bn', kx.to(sum_dtype),
                                      rrow.to(sum_dtype)).to(x.dtype),
                         -1e6, 1e6)
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


def live_parts(x, z, yh, yeh, kx, aeq_val, aeq_blk, beq, normals, h,
               seg_mask, rho_i=None, rho_e=None, basis=None):
    """What the kernel computes for each scenario, by the rule its blocks
    apply when they load (takes the kernel's arguments): (Ls (B,), the
    segments 0..Ls-1 it keeps live, and face_live (B, S, F), the face slots
    it keeps live).  The rest stays exactly at its input (zero) under the
    dense iteration, so the kernel skips it: trailing segments with
    seg_mask 0, zero normals, zero x / z / yh and h >= 0, whose Kx blocks to
    the live segments are zero and whose equality rows carry zero beq and
    yeh and no live coefficient; and face slots with a zero normal, h >= 0
    and z = yh = 0 in every sample.  A non-finite input keeps everything
    live."""
    B, n, S, R, F, D, m = _dims(x, z, yeh, normals)
    C = F + BOX_SLOTS
    dense = ~torch.stack([torch.isfinite(t).flatten(1).all(1) for t in
                          (x, z, yh, yeh, kx, aeq_val, beq, normals, h)]).all(0)
    colnz = ((z != 0) | (yh != 0)).reshape(B, S, R, C).any(2)
    segbad = (colnz.any(-1) | (normals != 0).flatten(2).any(-1)
              | ~(h >= 0).all(-1) | (x.reshape(B, S, -1) != 0).any(-1)
              | (seg_mask != 0))
    steps = torch.arange(1, S + 1, device=x.device)
    Lc = (segbad * steps).amax(-1)
    act = torch.arange(n, device=x.device)[None, :] < (Lc * 3 * D)[:, None]
    bad = ((kx != 0) & (act[:, :, None] != act[:, None, :])).flatten(1).any(1)
    nz = (aeq_val != 0).any(-1)
    skip = aeq_blk >= (3 * Lc)[:, None, None]
    touches = (skip & nz).any(-1)
    live = (~skip & nz).any(-1)
    bad |= (touches & (live | (beq != 0) | (yeh != 0))).any(-1)
    Ls = torch.where(dense | bad, S, Lc)
    face_live = (dense[:, None, None] | (normals != 0).any(-1)
                 | ~(h[..., :F] >= 0) | colnz[..., :F])
    seg_live = torch.arange(S, device=x.device)[None, :] < Ls[:, None]
    return Ls, face_live & seg_live[..., None]


def chunk_inputs(data: qp.QPData, scfg: SolverConfig, x0=None, y0=None):
    """The kernel's arguments for the first chunk of a solve from the warm
    start (x0, y0) (`admm.warm_start`; zeros by default), at the initial
    rho and its Cholesky inverse."""
    B = data.times.shape[0]
    f32 = torch.float32
    x, z, y = admm.warm_start(data, x0, y0)
    rho_i, _ = admm.initial_rho(data, scfg, f32)
    rho_e = rho_i * scfg.rho_eq_scale
    M = qp.normal_matrix(data, scfg.sigma, rho_e, rho_i)
    kx = fused_refined_inverse(M, admm.spd_inverse(M))
    aval, ablk, beq, nrm, h, sm, basis = pack_scenario(data)
    yh = ineq_pack({k: y[k] for k in qp.INEQ_KEYS}) / rho_i[:, None, None]
    yeh = qp.tree_flat({k: y[k] for k in qp.EQ_KEYS}, qp.EQ_KEYS) / rho_e[:, None]
    return (x.reshape(B, -1).to(f32).contiguous(),
            ineq_pack({k: z[k] for k in qp.INEQ_KEYS}).to(f32),
            yh.to(f32).contiguous(), yeh.to(f32).contiguous(), kx, aval, ablk,
            beq, nrm, h, sm, rho_i.contiguous(), rho_e.contiguous(), basis)


def padded_noise(data: qp.QPData, seed: int, every: int = 2):
    """A warm start (x0, y0) that is nonzero everywhere, padded segments and
    face slots included, on every `every`-th scenario (zero on the others):
    the case where the kernel's load-time check must keep the padded parts
    live.  Drawn with numpy from `seed`."""
    cfg = data.cfg
    B, S = data.times.shape
    rng = np.random.default_rng(seed)
    on = (np.arange(B) % every == 0)
    dev, dt = data.times.device, data.times.dtype
    T = lambda a: torch.as_tensor(a * on.reshape((B,) + (1,) * (a.ndim - 1)),
                                  dtype=dt, device=dev)
    x0 = T(0.1 * rng.normal(size=(B, S, 3, cfg.D)))
    _, z, _ = admm.warm_start(data)
    y0 = {k: T(rng.normal(size=tuple(v.shape))) for k, v in z.items()}
    return x0, y0


# batches that drive each of the kernel's routes, for the checks on the card
CHECK_BATCHES = ("one_segment", "every_segment", "full_faces",
                 "padded_warm_start")


def check_batch(kind: str, cfg: QPConfig, scfg: SolverConfig, B: int,
                seed: int, device):
    """The kernel's arguments for one of CHECK_BATCHES (f32 scenarios from
    `random_scenarios(seed)`): every scenario with 1 segment; every one with
    cfg.max_seg (every segment live); every segment with every face slot
    in use (`scenarios.fill_faces`, no padded face slot, so nothing is
    skipped); 1 to cfg.max_seg segments with a warm start that is nonzero
    in padded parts on every other scenario (`padded_noise`)."""
    S = cfg.max_seg
    segs = dict(one_segment=(1, 1), every_segment=(S, S), full_faces=(S, S),
                padded_warm_start=(1, S))[kind]
    sc = scenarios.random_scenarios(cfg, B, seed=seed, min_seg=segs[0],
                                    max_seg=segs[1])
    if kind == "full_faces":
        sc = scenarios.fill_faces(sc, seed)
    f32 = np.float32
    data = qp.build_qp(cfg, sc.state.astype(f32), sc.hpolys.astype(f32),
                       sc.times.astype(f32), sc.seg, device=device)
    warm = padded_noise(data, seed) if kind == "padded_warm_start" else ()
    return chunk_inputs(data, scfg, *warm)


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


def pack_aeq(aeq: torch.Tensor, S: int):
    """Dense (B, m, n) equality rows -> structured (aeq_val (B, m, 2, D) f32,
    aeq_blk (B, m, 2) int32): per row the two (segment, axis) blocks of D
    coefficients that hold its nonzeros (nonzero blocks first, by index;
    then zero blocks), and their values, copied.  Exact for rows with at
    most two nonzero blocks, as every row of `qp.dense_eq` has (a start or
    end row one block, a junction row the blocks of segments i and i + 1)."""
    B, m, n = aeq.shape
    S3 = 3 * S
    blocks = aeq.reshape(B, m, S3, n // S3)
    nz = (blocks != 0).any(-1)
    order = torch.arange(S3, 0, -1, device=aeq.device)
    key = nz.to(torch.int64) * (S3 + 1) + order
    blk = key.topk(2, dim=-1).indices
    val = torch.gather(blocks, 2, blk[..., None].expand(B, m, 2, n // S3))
    return val.to(torch.float32).contiguous(), blk.to(torch.int32).contiguous()


def aeq_dense(aeq_val: torch.Tensor, aeq_blk: torch.Tensor, n: int):
    """Structured equality rows -> dense (B, m, n), the inverse of
    `pack_aeq`."""
    B, m, _, D = aeq_val.shape
    out = aeq_val.new_zeros((B, m, n // D, D))
    out.scatter_(2, aeq_blk.long()[..., None].expand(B, m, 2, D), aeq_val)
    return out.reshape(B, m, n)


def pack_scenario(data: qp.QPData):
    """Per-scenario f32 constants that last across chunks:
    (aeq_val, aeq_blk, beq, normals, h, seg_mask, basis)."""
    cfg = data.cfg
    B, S = data.times.shape
    f32 = torch.float32
    Aeq, beq = qp.dense_eq(data)
    aeq_val, aeq_blk = pack_aeq(Aeq.to(f32), S)
    h_box = data.h_box.expand(B, S, 1, 3, 4).reshape(B, S, BOX_SLOTS)
    h = torch.cat([data.h_corr[:, :, 0, :], h_box], dim=-1)
    basis = torch.stack(qp.consts(cfg, f32, data.times.device)[:3])
    return (aeq_val, aeq_blk) + tuple(
        t.to(f32).contiguous()
        for t in (beq, data.normals, h, data.seg_mask, basis))


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
    aeq_val, aeq_blk, beq, normals, h, seg_mask, basis = pack_scenario(data)

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
            fused_refined_inverse(M, Minv), aeq_val, aeq_blk, beq, normals, h,
            seg_mask, rho_i.contiguous(), rho_e.contiguous(), basis,
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
