#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (allocnet_tpu_torch) on one NVIDIA
card: builds the admm_chunk kernel from csrc/ (no register spills), holds
it against its plain PyTorch version at the deploy shape and on batches
that take each of its routes (padded parts skipped or not, Kx in shared or
device memory), solves the deploy QP batch through it (bench.py's accuracy
gates), serves plan_batch requests with the shipped seq5 ConvLSTM weights,
and prints one JSON line per kernel and a final status line.

    python3 chip_smoke.py

Needs a CUDA device and the CUDA toolkit (nvcc); exits non-zero without
them, and on any failed check.  Writes nothing but the kernel build in
allocnet_tpu_torch/_build/.  Imports neither JAX nor the JAX package.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 1024                  # the deploy batch (bench.py)
SEED = 123                # bench.py's scenario seed
CHUNK_TOL = 5e-4          # kernel vs plain, of each array's largest entry
ORACLE_N = 8
REQUESTS = 3              # plan_batch requests served on the main path
# H100 SXM published peaks (NVIDIA data sheet): f32 on the CUDA cores and
# HBM3 bandwidth, for the kernel's bound
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def phase(name, t0):
    print(f"[{name}] {time.perf_counter() - t0:.3f} s", flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds per call on the card (CUDA events)."""
    import torch
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


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from allocnet_tpu_torch.config import QPConfig, SolverConfig
    from allocnet_tpu_torch.models import weights
    from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
    from allocnet_tpu_torch.ops import admm, admm_chunk, qp
    from allocnet_tpu_torch.planner import pipeline
    from allocnet_tpu_torch.utils import scenarios
    from allocnet_tpu_torch.utils.device import resolve_device

    spec = importlib.util.spec_from_file_location(
        "qp_oracle", os.path.join(ROOT, "tests", "oracle", "qp_oracle.py"))
    qp_oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qp_oracle)

    t_all = time.perf_counter()
    dev = resolve_device()           # the card; TF32 off
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}",
          flush=True)

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    info = admm_chunk.build()
    print(f"admm_chunk build: {info['seconds']:.2f} s -> {info['path']}")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas:", line.strip())
    spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", info["ptxas"])
    if not spills or any(int(v) for v in spills):
        fail(f"ptxas reports register spills: {spills}")
    print(f"  dynamic shared memory per block: "
          f"{admm_chunk.smem_bytes(QPConfig())} bytes; blocks (scenarios) "
          f"per SM: {admm_chunk.blocks_per_sm(QPConfig())}")
    phase("build", t0)

    # ---- 2. the kernel against its plain version, one deploy chunk -------
    t0 = time.perf_counter()
    cfg, scfg = QPConfig(), SolverConfig()
    sc = scenarios.random_scenarios(cfg, B, seed=SEED, min_seg=1)
    f32 = np.float32
    data = qp.build_qp(cfg, sc.state.astype(f32), sc.hpolys.astype(f32),
                       sc.times.astype(f32), sc.seg, device=dev)
    args = admm_chunk.chunk_inputs(data, scfg)
    aeq = admm_chunk.aeq_dense(args[5], args[6], cfg.n_var)
    nrm, sm = args[8], args[10]
    it = scfg.iters_per_chunk
    got = admm_chunk.admm_chunk(*args, it, scfg.sigma, scfg.alpha)
    torch.cuda.synchronize()
    want = admm_chunk.admm_chunk_reference(*args, it, scfg.sigma, scfg.alpha)
    max_err = 0.0
    for name, g, w in zip(("x", "z", "yh", "yeh"), got, want):
        if not bool(torch.isfinite(g).all()):
            fail(f"kernel {name} not finite")
        err = float((g - w).abs().max())
        scale = max(1.0, float(w.abs().max()))
        max_err = max(max_err, err)
        print(f"  {name}: max abs diff {err:.3e}, relative to max|plain| "
              f"{err / scale:.3e} (tolerance {CHUNK_TOL:.0e})")
        if err > CHUNK_TOL * scale:
            fail(f"admm_chunk {name} disagrees with its plain version")
    chunk_ms = cuda_ms(lambda: admm_chunk.admm_chunk(*args, it, scfg.sigma,
                                                     scfg.alpha), reps=10)
    plain_ms = cuda_ms(lambda: admm_chunk.admm_chunk_reference(
        *args, it, scfg.sigma, scfg.alpha), reps=3)
    flops, nbytes = chunk_work(cfg, it, aeq, nrm, sm)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    print(f"admm_chunk B={B} x {it} iterations: kernel {chunk_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms "
          f"({flops:.3e} FLOP -> {t_ops:.4f} ms, {nbytes:.3e} B -> "
          f"{t_bytes:.4f} ms)")
    Ls, face_live = admm_chunk.live_parts(*args)
    segs = torch.as_tensor(sc.seg, device=dev)
    print(f"  routes: {int((Ls == segs).sum())} of {B} scenarios skip their "
          f"padded segments; live segments {float(Ls.float().mean()):.3f}, "
          f"live faces per live segment "
          f"{float(face_live.sum() / Ls.sum()):.3f} (of {cfg.max_faces})")
    phase("kernel vs plain", t0)

    # ---- 2b. the kernel against its plain version on each route ----------
    t0 = time.perf_counter()
    for batch in admm_chunk.CHECK_BATCHES:
        rargs = admm_chunk.check_batch(batch, cfg, scfg, B, SEED, dev)
        got = admm_chunk.admm_chunk(*rargs, it, scfg.sigma, scfg.alpha)
        torch.cuda.synchronize()
        want = admm_chunk.admm_chunk_reference(*rargs, it, scfg.sigma,
                                               scfg.alpha)
        errs = []
        for name, g, w in zip(("x", "z", "yh", "yeh"), got, want):
            if not bool(torch.isfinite(g).all()):
                fail(f"kernel {name} not finite on {batch}")
            scale = max(1.0, float(w.abs().max()))
            errs.append(float((g - w).abs().max()) / scale)
            if errs[-1] > CHUNK_TOL:
                fail(f"admm_chunk {name} disagrees with its plain version on "
                     f"{batch}: {errs[-1]:.3e} of the largest entry")
        Ls, face_live = admm_chunk.live_parts(*rargs)
        ms = cuda_ms(lambda: admm_chunk.admm_chunk(*rargs, it, scfg.sigma,
                                                   scfg.alpha), reps=3)
        print(f"  {batch}: kernel {ms:.3f} ms; max diff / max|plain| of x z "
              f"yh yeh " + " ".join(f"{e:.3e}" for e in errs)
              + f" (tolerance {CHUNK_TOL:.0e}); live segments "
              f"{float(Ls.float().mean()):.3f}, live faces per live segment "
              f"{float(face_live.sum() / Ls.sum()):.3f}")
    phase("routes", t0)

    # ---- 3. the deploy-point solve through the kernel ---------------------
    t0 = time.perf_counter()
    admm_chunk.admm_chunk.launches = 0
    sol = admm.solve_qp(data, scfg)
    torch.cuda.synchronize()
    if admm_chunk.admm_chunk.launches != scfg.n_chunks:
        fail(f"solve_qp launched admm_chunk "
             f"{admm_chunk.admm_chunk.launches} times, expected {scfg.n_chunks}")
    solved = sol.solved.cpu().numpy()
    rel = torch.maximum(sol.pri_rel, sol.dua_rel).cpu().numpy()
    coeffs = sol.coeffs.cpu().numpy()
    if not np.isfinite(coeffs).all():
        fail("non-finite coefficients")
    frac = float(solved.mean())
    max_rel = float(rel[solved].max())
    print(f"solve_qp B={B}: solved {frac:.4f}, max normalized residual "
          f"{max_rel:.3e}")
    if frac < 0.99:
        fail(f"solved fraction {frac:.4f} < 0.99")
    if max_rel >= 1e-3:
        fail(f"max normalized residual {max_rel:.2e} on the solved set")
    idx = np.nonzero(solved)[0]
    checked, max_diff = 0, 0.0
    for b in idx[np.linspace(0, len(idx) - 1, ORACLE_N).astype(int)]:
        ora = qp_oracle.solve_scenario(cfg, sc.state[b], sc.hpolys[b],
                                       sc.times[b], sc.seg[b])
        if ora["kkt"] > 1e-7:
            continue                  # the oracle itself is not certified
        L = int(sc.seg[b])
        max_diff = max(max_diff, float(np.abs(coeffs[b, :L]
                                              - ora["coeffs"]).max()))
        checked += 1
    print(f"  f64 oracle: {checked} scenarios, max coefficient diff "
          f"{max_diff:.3e}")
    if checked < ORACLE_N // 2 or max_diff > 1e-3:
        fail(f"oracle parity: {checked} checked, max diff {max_diff:.2e}")
    sets = [cuda_ms(lambda: admm.solve_qp(data, scfg), reps=5)
            for _ in range(3)]
    print("  solve_qp ms per batch, 3 sets x 5: "
          + ", ".join(f"{s:.2f}" for s in sets)
          + f" -> {B / (np.mean(sets) / 1e3):.1f} solves/s")
    phase("solve", t0)

    # ---- 4. serve: plan_batch requests (the main path) --------------------
    t0 = time.perf_counter()
    net = ConvLSTMAllocNet(5, 256, token_thresh=0.5)
    net.load_state_dict(weights.load_params(os.path.join(
        ROOT, "data", "params", "seq5_tokenthresh0_35.msgpack")))
    net = net.to(dev).eval()
    reqs = [scenarios.random_scenarios(cfg, B, seed=SEED + r, min_seg=1)
            for r in range(REQUESTS)]
    pipeline.plan_batch(net, cfg, scfg, reqs[0].state, reqs[0].hpolys,
                        reqs[0].seg)           # warm-up (cuDNN, allocator)
    torch.cuda.synchronize()
    admm_chunk.admm_chunk.launches = 0
    results, req_ms = [], []
    for r in reqs:
        t1 = time.perf_counter()
        results.append(pipeline.plan_batch(net, cfg, scfg, r.state, r.hpolys,
                                           r.seg))
        torch.cuda.synchronize()
        req_ms.append((time.perf_counter() - t1) * 1e3)
    launches = admm_chunk.admm_chunk.launches
    print(f"plan_batch: {REQUESTS} requests of B={B}, "
          + ", ".join(f"{t:.1f}" for t in req_ms) + " ms; admm_chunk "
          f"launches {launches}")
    if launches != REQUESTS * scfg.n_chunks:
        fail(f"plan_batch launched admm_chunk {launches} times, expected "
             f"{REQUESTS * scfg.n_chunks}")
    for res in results:
        if res.coeffs.shape != (B, cfg.max_seg, 3, cfg.D):
            fail(f"coefficients of shape {tuple(res.coeffs.shape)}")
        if not bool(torch.isfinite(res.coeffs).all()):
            fail("non-finite plan coefficients")
        print(f"  solved {float(res.solved.float().mean()):.4f}, ok "
              f"{float(res.ok.float().mean()):.4f}")
    # the same first 16 scenarios on the CPU, through the plain path
    n_ref = 16
    ref = pipeline.plan_batch(net.to("cpu"), cfg, scfg, reqs[0].state[:n_ref],
                              reqs[0].hpolys[:n_ref], reqs[0].seg[:n_ref],
                              device="cpu")
    got = results[0]
    t_gpu, k_gpu = got.times[:n_ref].cpu(), got.tokens[:n_ref].cpu()
    if not (torch.allclose(t_gpu, ref.times, rtol=1e-4, atol=1e-5)
            and torch.allclose(k_gpu, ref.tokens, rtol=1e-4, atol=1e-5)):
        fail("network outputs on the card differ from the CPU's")
    s_gpu = got.solved[:n_ref].cpu()
    agree = int((s_gpu == ref.solved).sum())
    both = s_gpu & ref.solved
    diff = float((got.coeffs[:n_ref].cpu() - ref.coeffs)[both].abs().max()) \
        if both.any() else 0.0
    print(f"  vs CPU plain path on {n_ref}: solved flags agree on {agree}, "
          f"{int(both.sum())} solved on both, max coefficient diff {diff:.3e}")
    # a scenario whose residual sits at the tolerance may flip between two
    # f32 reductions: allow one flag of 16 to differ
    if agree < n_ref - 1 or diff > 1e-3:
        fail("plan_batch on the card disagrees with the CPU path")
    phase("serve", t0)

    kernels = [{
        "name": "admm_chunk", "route": "cuda",
        "source": "allocnet_tpu_torch/csrc/admm_chunk.cu",
        "replaces": "allocnet_tpu/ops/pallas/admm_tiled.py:236",
        "launches": launches, "max_abs_err": max_err, "ms": chunk_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }]
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
