"""The two kernels' numbers on the card: each held against its plain
version on the same inputs, timed with CUDA events, and the least time
the card could take for the same work (its bound).

K1 (`ops/admm_chunk`) is held within CHUNK_TOL of each output's largest
entry, L1 (`ops/ldl.ldl_block`) exactly.  The bounds are the larger of the
bytes a launch must move over the card's memory rate and the operations
it must do over the card's f32 peak (PEAK_BYTES, PEAK_F32_FLOPS: an H100
SXM).  Used by chip_smoke.py and train/chain.py; a mismatch raises
SystemExit.  Needs a CUDA device (the work counts do not).
"""

from __future__ import annotations

import contextlib

import torch

CHUNK_TOL = 5e-4          # kernel vs plain, of each array's largest entry
# H100 SXM published peaks (NVIDIA data sheet): f32 on the CUDA cores and
# HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def fail(msg):
    raise SystemExit(f"kernel check: FAILED: {msg}")


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds per call on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chunk_work(cfg, n_iters, aeq, normals, seg_mask):
    """(FLOP, bytes) that one admm_chunk launch must do on this run's
    inputs.  Operations count what the data needs: 2 FLOP per multiply-add
    of the products over active segments only (padded segments' variables
    stay exactly zero: the normal matrix is block-diagonal between active
    and padded segments), the nonzeros of Aeq, the active corridor faces,
    and ~16 FLOP per active inequality slot per iteration (relaxation,
    projection, dual update, the z - yh difference).  Bytes: every input
    read once and every output written once, f32, as passed (dense)."""
    S, R, F, D = cfg.max_seg, cfg.res, cfg.max_faces, cfg.D
    n, m, NR, C = cfg.n_var, cfg.n_eq, S * R, F + 12
    batch = aeq.shape[0]
    segs = seg_mask.double().sum(1)
    n_act = 3 * D * segs
    faces = (normals.abs().sum(-1) > 0).double().sum((1, 2))
    nnz = (aeq != 0).double().sum((1, 2))
    macs = (n_act ** 2 + 2 * nnz + 2 * faces * R * 3
            + 2 * segs * R * 9 * D)
    slots = faces * R + segs * R * 12
    flops = n_iters * float((2 * macs + 16 * slots + 3 * n_act + 4 * m).sum())
    floats_in = (n * n + m * n + m + S * F * 3 + S * C + S + 2   # per scenario
                 + n + 2 * NR * C + m)                            # state in
    floats_out = n + 2 * NR * C + m
    nbytes = 4 * (batch * (floats_in + floats_out) + 3 * R * D)
    return flops, nbytes


def ldl_work(B, NB):
    """(operations, bytes) of one ldl_block launch on B blocks of NB
    columns.  Per block: two products and a difference for each entry of
    the lower triangle that a column's update touches (sum over j of
    (NB - j)(NB - j - 1) / 2) and one divide for each entry of L below the
    diagonal; the work does not depend on the data (no column ends early).
    Bytes: K read once and L written once (B NB^2 f32 each), d written
    once, the signs read once."""
    upd = sum((NB - j) * (NB - j - 1) // 2 for j in range(NB))
    return B * (3 * upd + NB * (NB - 1) // 2), 4 * (2 * B * NB * NB + B * NB
                                                    + NB)


def ldl_compare(got, want, reg, what):
    """L1's (L, d) against the plain version's on the finite scenarios of
    the reference: (equal, equal bit patterns, max abs diff, bumped pivots
    in the reference).  Fails unless they are equal (torch.equal: a zero
    may differ in sign only, which the bit patterns show)."""
    (L, d), (rL, rd) = got, want
    fin = torch.isfinite(rL).flatten(1).all(1) & torch.isfinite(rd).all(1)
    L, d, rL, rd = L[fin], d[fin], rL[fin], rd[fin]
    same = torch.equal(L, rL) and torch.equal(d, rd)
    bits = (torch.equal(L.view(torch.int32), rL.view(torch.int32))
            and torch.equal(d.view(torch.int32), rd.view(torch.int32)))
    bumped = int((rd.abs() < reg).sum())
    absd = 0.0 if not fin.any() else max(float((L - rL).abs().max()),
                                         float((d - rd).abs().max()))
    if not same:
        fail(f"ldl_block differs from its plain version on the {what} "
             f"blocks: max abs diff {absd:.3e}")
    return same, bits, absd, bumped


def first_launch_per_batch(launch, recorded):
    """admm_chunk._launch that keeps, in `recorded` by batch size, the
    first arguments (the kernel's tensors, n_iters, sigma, alpha) of each
    batch size it launches."""

    def rec_launch(lib, *a):
        if int(a[0].shape[0]) not in recorded:
            recorded[int(a[0].shape[0])] = [
                t.clone() if torch.is_tensor(t) else t for t in a[:17]]
        return launch(lib, *a)
    return rec_launch


class _FirstBlock:
    """`block` that keeps the first (K, signs, reg) it gets in `blocks`;
    its other attributes (the launch count) are the block's."""

    def __init__(self, block, blocks: list):
        self.block, self.blocks = block, blocks

    def __call__(self, Kb, sign, reg):
        if not self.blocks:
            self.blocks.append((Kb.clone(), sign.clone(), reg))
        return self.block(Kb, sign, reg)

    def __getattr__(self, name):
        return getattr(self.block, name)


@contextlib.contextmanager
def first_ldl_block(ldl, blocks: list):
    """Within the block, the first diagonal block that reaches
    `ldl.ldl_block` (K, signs, reg) is appended to `blocks`."""
    block = ldl.ldl_block
    ldl.ldl_block = _FirstBlock(block, blocks)
    try:
        yield blocks
    finally:
        ldl.ldl_block = block


def kernel_check(k1, ref, a, what):
    """The kernel against its plain version on the recorded arguments `a`
    (the kernel's tensors, n_iters, sigma, alpha): returns each output's
    max difference over the plain version's largest entry; fails on a
    non-finite output or above CHUNK_TOL."""
    got = k1(*a)
    torch.cuda.synchronize()
    want = ref(*a)
    errs = []
    for name, g, w in zip(("x", "z", "yh", "yeh"), got, want):
        if not bool(torch.isfinite(g).all()):
            fail(f"kernel {name} not finite on the {what} batch")
        errs.append(float((g - w).abs().max())
                    / max(1.0, float(w.abs().max())))
    if max(errs) > CHUNK_TOL:
        fail(f"admm_chunk disagrees with its plain version on the {what} "
             f"batch: {max(errs):.3e} of the largest entry")
    return errs


def shape_numbers(admm_chunk, qcfg, a, what, reps=20):
    """Kernel vs plain (`kernel_check`), then the kernel's and the plain
    version's ms per launch and the bound (`chunk_work`) on the recorded
    arguments `a`."""
    k1, ref = admm_chunk.admm_chunk, admm_chunk.admm_chunk_reference
    errs = kernel_check(k1, ref, a, what)
    ms = cuda_ms(lambda: k1(*a), reps=reps)
    pms = cuda_ms(lambda: ref(*a), reps=3)
    fl, nb = chunk_work(qcfg, a[14], admm_chunk.aeq_dense(
        a[5], a[6], qcfg.n_var), a[8], a[10])
    bms = max(fl / PEAK_F32_FLOPS, nb / PEAK_BYTES) * 1e3
    print(f"  admm_chunk on the {what} batch (B={a[0].shape[0]}, {a[14]} "
          f"iterations, D={qcfg.D}): kernel {ms:.3f} ms, plain {pms:.3f} ms, "
          f"bound {bms:.5f} ms ({fl:.3e} FLOP, {nb:.3e} B); max diff / "
          f"max|plain| of x z yh yeh " + " ".join(f"{e:.3e}" for e in errs),
          flush=True)
    return {"B": int(a[0].shape[0]), "iters": int(a[14]), "ms": ms,
            "plain_ms": pms, "bound_ms": bms, "max_rel_err": max(errs)}
