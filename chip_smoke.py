#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (allocnet_tpu_torch) on one NVIDIA
card: builds the admm_chunk kernel from csrc/ (no register spills), holds
it against its plain PyTorch version at the deploy shape, on batches that
take each of its routes (padded parts skipped or not, Kx in shared or
device memory) and at the training shape, solves the deploy QP batch
through it (bench.py's accuracy gates), serves plan_batch requests with the
shipped seq5 ConvLSTM weights, trains that net through the QP for one
epoch (Trainer, TRAIN operating point), refines one request's segment
times through the differentiable QP, then at the DEPLOY point builds a
voxel map from a point cloud, plans two missions' corridors (native
Informed RRT*, FIRI, the fused corridor; held against the CPU's) and flies
them with the 10 Hz receding-horizon driver (cold, warm and rescue ticks;
the kernel held against its plain version on each tick batch, the first
cold tick against the CPU path), and prints one JSON line per kernel and
a final status line.

    python3 chip_smoke.py

Needs a CUDA device, the CUDA toolkit (nvcc) and g++; exits non-zero
without them, and on any failed check.  Writes nothing but the kernel and
runtime builds in allocnet_tpu_torch/_build/.  Imports neither JAX nor the
JAX package.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 1024                  # the deploy batch (bench.py)
SEED = 123                # bench.py's scenario seed
CHUNK_TOL = 5e-4          # kernel vs plain, of each array's largest entry
ORACLE_N = 8
REQUESTS = 3              # plan_batch requests served on the main path
TRAIN_N = 320             # scenarios of the train phase: 9 steps of 32, 1 val
REFINE_B = 256            # the refine request's batch
NET = os.path.join("data", "params", "seq5_tokenthresh0_35.msgpack")
# corridor and fly phases: map 0 of scripts/drive_eval.py, 2 missions
# sampled as its sample_missions does, flown at DEPLOY for at most 200
# ticks; scripts/smoke_missions_jax.py flies the same missions through
# the JAX package
MAP_SEED = 100
EXTENT = (20.0, 20.0, 4.0)
MISSION_SEED = 1
N_MISSIONS = 2
MAX_TICKS = 200
ARRIVE_DIST = 0.3         # drive_eval's arrival: done and within 0.3 m
CORRIDOR_TOL = 1e-3       # card vs CPU corridor, of the largest row entry
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
    from allocnet_tpu_torch import config
    from allocnet_tpu_torch.config import QPConfig, SolverConfig
    from allocnet_tpu_torch.models import weights
    from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
    from allocnet_tpu_torch.ops import admm, admm_chunk, qp
    from allocnet_tpu_torch.planner import (driver, pipeline, planner,
                                            replan, sfc)
    from allocnet_tpu_torch.train import datagen
    from allocnet_tpu_torch.train import dataset, losses, train_step, trainer
    from allocnet_tpu_torch.utils import scenarios
    from allocnet_tpu_torch.utils.device import resolve_device

    spec = importlib.util.spec_from_file_location(
        "qp_oracle", os.path.join(ROOT, "tests", "oracle", "qp_oracle.py"))
    qp_oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qp_oracle)

    t_all = time.perf_counter()
    dev = resolve_device()           # the card; TF32 off
    device_kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {device_kind} x{torch.cuda.device_count()}, torch "
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

    # ---- 5. train: one epoch through the QP (TRAIN, B=32) -----------------
    t0 = time.perf_counter()
    tcfg = config.TRAIN
    tq, ts_ = tcfg.qp, tcfg.solver
    tsc = scenarios.random_scenarios(tq, TRAIN_N, seed=SEED, min_seg=1)
    loader = dataset.Loader(tsc, batch_size=tcfg.train.batch_size,
                            train_ratio=tcfg.train.training_data_ratio,
                            seed=tcfg.train.seed)
    n_steps = len(loader.train_idx) // tcfg.train.batch_size
    n_val = len(loader.val_idx) // tcfg.train.batch_size

    # the kernel against its plain version at the training shape: the
    # first training batch's first chunk
    first = next(loader.epoch(0))
    tdata = qp.build_qp(tq, first.state.astype(f32), first.hpolys.astype(f32),
                        first.ref_times.astype(f32), first.seg, device=dev)
    targs = admm_chunk.chunk_inputs(tdata, ts_)
    got = admm_chunk.admm_chunk(*targs, it, ts_.sigma, ts_.alpha)
    torch.cuda.synchronize()
    want = admm_chunk.admm_chunk_reference(*targs, it, ts_.sigma, ts_.alpha)
    terrs = []
    for name, g, w in zip(("x", "z", "yh", "yeh"), got, want):
        if not bool(torch.isfinite(g).all()):
            fail(f"kernel {name} not finite at the training shape")
        terrs.append(float((g - w).abs().max())
                     / max(1.0, float(w.abs().max())))
        if terrs[-1] > CHUNK_TOL:
            fail(f"admm_chunk {name} disagrees with its plain version at the "
                 f"training shape: {terrs[-1]:.3e} of the largest entry")
    train_chunk_ms = cuda_ms(lambda: admm_chunk.admm_chunk(
        *targs, it, ts_.sigma, ts_.alpha), reps=20)
    train_plain_ms = cuda_ms(lambda: admm_chunk.admm_chunk_reference(
        *targs, it, ts_.sigma, ts_.alpha), reps=3)
    tflops, tbytes = chunk_work(tq, it, admm_chunk.aeq_dense(
        targs[5], targs[6], tq.n_var), targs[8], targs[10])
    train_bound_ms = max(tflops / PEAK_F32_FLOPS, tbytes / PEAK_BYTES) * 1e3
    print(f"admm_chunk at the training shape (B={tcfg.train.batch_size}, "
          f"res={tq.res}) x {it} iterations: kernel {train_chunk_ms:.3f} ms, "
          f"plain {train_plain_ms:.3f} ms, bound {train_bound_ms:.4f} ms "
          f"({tflops:.3e} FLOP, {tbytes:.3e} B); max diff / max|plain| of "
          f"x z yh yeh " + " ".join(f"{e:.3e}" for e in terrs))

    def per_scenario(net_, batch, device):
        """(per-scenario losses, solved flags) of one batch, no update."""
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        st, hp, rt = t(batch.state), t(batch.hpolys), t(batch.ref_times)
        sg = torch.as_tensor(batch.seg, device=device).long()
        with torch.no_grad():
            times, tokens, sol, obj = train_step.forward(net_, tq, ts_, st,
                                                         hp, sg)
            per = [float(losses.compute_losses(
                tcfg.loss, times[i:i + 1], tokens[i:i + 1], sg[i:i + 1],
                sol.solved[i:i + 1], obj[i:i + 1], st[i:i + 1],
                rt[i:i + 1], tcfg.model.token_thresh).total)
                for i in range(len(batch.seg))]
        return np.array(per), sol.solved.cpu().numpy()

    tnet = ConvLSTMAllocNet(5, 256, token_thresh=0.5)
    tnet.load_state_dict(weights.load_params(os.path.join(
        ROOT, "data", "params", "seq5_tokenthresh0_35.msgpack")))
    start = {k: v.clone() for k, v in tnet.state_dict().items()}
    cpu_per, cpu_solved = per_scenario(tnet, first, "cpu")
    tnet = tnet.to(dev)
    gpu_per, gpu_solved = per_scenario(tnet, first, dev)

    with tempfile.TemporaryDirectory() as workdir:
        tr = trainer.Trainer(tcfg, tnet, loader, workdir)
        torch.cuda.synchronize()
        admm_chunk.admm_chunk.launches = 0
        t1 = time.perf_counter()
        tr.train(max_epochs=1)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
        train_launches = admm_chunk.admm_chunk.launches
        with open(tr.log_path) as f:
            records = [json.loads(line) for line in f]
        ck = trainer.latest_checkpoint(tr.ckpt_dir)
    steps = [r for r in records if "step" in r]
    val = [r for r in records if r.get("split") == "val"]
    print(f"train: {len(steps)} steps of {tcfg.train.batch_size} and "
          f"{n_val} validation batch(es) in {train_s * 1e3:.1f} ms; admm_chunk "
          f"launches {train_launches}; checkpoint {os.path.basename(ck)}")
    print("  step losses: " + ", ".join(f"{r['obj']:.4f}" for r in steps)
          + "; success " + ", ".join(f"{r['success_rate']:.3f}"
                                     for r in steps))
    if val:
        print(f"  validation: loss {val[0]['obj']:.4f}, success "
              f"{val[0]['success_rate']:.3f}")
    if len(steps) != n_steps or len(val) != min(n_val, 1):
        fail(f"train ran {len(steps)} steps and {len(val)} validations")
    if not all(np.isfinite(r["obj"]) for r in steps + val):
        fail("non-finite training loss")
    if train_launches != ts_.n_chunks * (n_steps + n_val):
        fail(f"train launched admm_chunk {train_launches} times, expected "
             f"{ts_.n_chunks} x {n_steps + n_val} forward solves")
    moved = max(float((v.cpu() - start[k]).abs().max())
                for k, v in tnet.state_dict().items())
    if not 0 < moved < 1:
        fail(f"training moved the weights by {moved:.3e}")
    agree = cpu_solved == gpu_solved
    card_first = float(np.mean(gpu_per))
    diff = float(np.abs(gpu_per - cpu_per)[agree].max() / max(
        1.0, np.abs(cpu_per[agree]).max()))
    print(f"  first step vs the CPU plain path: loss {steps[0]['obj']:.6f} "
          f"(card, trainer), {card_first:.6f} (card, recomputed), "
          f"{float(np.mean(cpu_per)):.6f} (CPU); solved flags agree on "
          f"{int(agree.sum())} of {len(agree)}; per-scenario loss diff "
          f"{diff:.3e} of the largest where they agree; weights moved by up "
          f"to {moved:.3e}")
    # a scenario at the tolerance may flip between two f32 reductions
    # (one of 32 allowed); f32 through a QP of cond ~1e4: rtol 1e-3
    if agree.sum() < len(agree) - 1 or diff > 1e-3:
        fail("the first training step disagrees with the CPU plain path")
    if abs(card_first - steps[0]["obj"]) > 1e-4 * max(1.0, abs(card_first)):
        fail("the trainer's first loss differs from its recomputation")

    # step time and its shares: forward (net, solve, objective, losses),
    # backward (implicit KKT, net), optimizer (Adam, schedule)
    bt = tr.to_device(first)
    shares = {"forward": [], "backward": [], "optimizer": []}
    for rep in range(4):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tr.opt.zero_grad(set_to_none=True)
        total, _ = train_step.loss_fn(tnet, tq, ts_, tcfg.loss, *bt,
                                      tcfg.model.token_thresh)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        total.backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        tr.opt.step()
        tr.lr_sched.step()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        if rep:                                  # the first is a warm-up
            for k, a, b in (("forward", t1, t2), ("backward", t2, t3),
                            ("optimizer", t3, t4)):
                shares[k].append((b - a) * 1e3)
    step_ms = {k: float(np.mean(v)) for k, v in shares.items()}
    print(f"  training step ms (3 timed, B={tcfg.train.batch_size}): "
          f"{sum(step_ms.values()):.2f} = forward {step_ms['forward']:.2f} + "
          f"backward {step_ms['backward']:.2f} + optimizer "
          f"{step_ms['optimizer']:.2f}; "
          f"{train_launches / (n_steps + n_val):g} launches per forward solve "
          f"(counted in the train run)")
    phase("train", t0)

    # ---- 6. refine: one plan_batch with refine_steps=2 ---------------------
    t0 = time.perf_counter()
    rq = reqs[0]
    rin = (rq.state[:REFINE_B], rq.hpolys[:REFINE_B], rq.seg[:REFINE_B])
    base = pipeline.plan_batch(net.to(dev), cfg, scfg, *rin)
    pipeline.plan_batch(net, cfg, scfg, *rin, refine_steps=2)   # warm-up
    torch.cuda.synchronize()
    admm_chunk.admm_chunk.launches = 0
    t1 = time.perf_counter()
    ref = pipeline.plan_batch(net, cfg, scfg, *rin, refine_steps=2)
    torch.cuda.synchronize()
    refine_ms = (time.perf_counter() - t1) * 1e3
    refine_launches = admm_chunk.admm_chunk.launches
    if not bool(torch.isfinite(ref.coeffs).all()):
        fail("non-finite refined coefficients")
    if refine_launches != 5 * scfg.n_chunks:
        fail(f"refine launched admm_chunk {refine_launches} times, expected "
             f"5 solves x {scfg.n_chunks}")
    both = (base.solved & ref.solved).cpu()
    ob, orf = base.obj.cpu()[both], ref.obj.cpu()[both]
    improved = int((orf < ob).sum())
    # refinement keeps each plan's total of the 0.05-clamped active times
    active = (torch.arange(cfg.max_seg, device=dev)[None, :]
              < torch.as_tensor(rin[2], device=dev)[:, None])
    tot_b = torch.where(active, torch.clamp_min(base.times, 0.05),
                        base.times).sum(1)
    tot_err = float(((ref.times.sum(1) - tot_b).abs() / tot_b).max())
    print(f"refine: plan_batch B={REFINE_B}, refine_steps=2: "
          f"{refine_ms:.1f} ms; admm_chunk launches {refine_launches}; "
          f"solved {int(base.solved.sum())} -> {int(ref.solved.sum())}; on "
          f"the {int(both.sum())} solved both ways mean objective "
          f"{float(ob.mean()):.4f} -> {float(orf.mean()):.4f}, {improved} "
          f"improved; total time kept to {tot_err:.2e}")
    if not both.any() or float(orf.mean()) > float(ob.mean()) * (1 + 1e-4):
        fail("refinement raised the mean objective")
    if tot_err > 1e-4:
        fail("refinement changed the plans' total time")
    phase("refine", t0)

    # ---- 7. corridor: map, routes, corridors at DEPLOY on the card -------
    t0 = time.perf_counter()
    dcfg = config.DEPLOY
    lo, hi = np.zeros(3), np.asarray(EXTENT)
    pts = datagen.random_obstacle_map(MAP_SEED, EXTENT)
    map_ms = []
    for _ in range(2):               # the first builds the C++ runtime
        # (unless an earlier command in the same checkout did)
        t1 = time.perf_counter()
        pmap = planner.build_map(pts, lo, hi, scale=0.25, dilate_r=2,
                                 native=True, device=dev)
        torch.cuda.synchronize()
        map_ms.append((time.perf_counter() - t1) * 1e3)
    print(f"corridor: map {MAP_SEED} ({len(pts)} points, "
          f"{pmap.grid.occ.shape} voxels, {len(pmap.surf)} surface points): "
          f"build_map {map_ms[0]:.1f} ms the first time, "
          f"{map_ms[1]:.1f} ms the second")
    t1 = time.perf_counter()
    missions = planner.sample_missions(pmap, dcfg, np.random.default_rng(
        MISSION_SEED), N_MISSIONS, lo, hi, device=dev)
    print(f"  sampled {len(missions)} missions in "
          f"{(time.perf_counter() - t1) * 1e3:.1f} ms (seed {MISSION_SEED})")
    if len(missions) != N_MISSIONS:
        fail(f"sampled {len(missions)} missions of {N_MISSIONS}")
    route_ms, corr_ms = [], []
    for k, (start, goal, rseed, cp) in enumerate(missions):
        t1 = time.perf_counter()
        route = planner.search_route(pmap, start, goal, dcfg.corridor, rseed)
        route_ms.append((time.perf_counter() - t1) * 1e3)
        args = (route, pmap.surf, lo, hi, dcfg.corridor, dcfg.qp)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        hp, seg, _, goal_r = sfc.corridor_online(*args, device=dev)
        corr_ms.append((time.perf_counter() - t1) * 1e3)
        hp_c, seg_c, _, goal_c = sfc.corridor_online(*args, device="cpu")
        scale = max(1.0, float(np.abs(hp_c).max()))
        dist = max(sfc.face_set_distance(hp[i], hp_c[i])
                   for i in range(min(seg, dcfg.qp.max_seg)))
        print(f"  mission {k}: {np.round(start, 3).tolist()} -> "
              f"{np.round(goal_r, 3).tolist()}, route of {len(route)} "
              f"points ({route_ms[-1]:.1f} ms), seg {seg} (CPU {seg_c}); "
              f"corridor_online {corr_ms[-1]:.1f} ms; card vs CPU: faces "
              f"{dist / scale:.3e} of the largest entry, goal "
              f"{float(np.abs(goal_r - goal_c).max()):.3e}")
        if seg != seg_c or dist > CORRIDOR_TOL * scale:
            fail(f"mission {k}: the card's corridor differs from the CPU's")
        if seg != cp.seg or not np.array_equal(hp, cp.hpolys):
            fail(f"mission {k}: plan_corridor and corridor_online differ")
    phase("corridor", t0)
    # ---- 8. fly: the 10 Hz driver on the sampled missions (DEPLOY) -------
    t0 = time.perf_counter()
    params = weights.load_params(os.path.join(ROOT, NET))
    drv = driver.Driver(ConvLSTMAllocNet(5, 256, token_thresh=0.5), params,
                        dcfg, rate_hz=10.0, certify=True, device=dev)
    drv.prewarm()
    k1, launch = admm_chunk.admm_chunk, admm_chunk._launch
    recorded = {}             # the kernel's inputs on each tick batch

    def recording_launch(lib, *a):
        """admm_chunk._launch, keeping the first arguments (the kernel's
        tensors, n_iters, sigma, alpha) of each tick batch: the cold hedge
        (B=3), a warm tick with a nonzero primal and dual start (B=1), a
        rescue (B=4)."""
        B = a[0].shape[0]
        kind = {3: "cold", 1: "warm", 4: "rescue"}.get(B)
        fresh = kind is not None and kind not in recorded
        if fresh and (kind != "warm" or (bool(a[0].any())
                                         and bool(a[2].any()))):
            recorded[kind] = [t.clone() if torch.is_tensor(t) else t
                              for t in a[:17]]
        return launch(lib, *a)

    per_call = {"cold": [], 0: [], 1: [], 2: []}    # launches per tick
    tick_inputs = {}
    cold_fn, tick_fn = drv._cold, drv._tick

    def cold_counted(*a):
        tick_inputs.setdefault("cold", [x.clone() for x in a])
        n0 = k1.launches
        out = cold_fn(*a)
        per_call["cold"].append(k1.launches - n0)
        return out

    def tick_counted(*a):
        tick_inputs["warm"] = a
        n0 = k1.launches
        out = tick_fn(*a)
        per_call[out[4]].append(k1.launches - n0)
        return out

    drv._cold, drv._tick = cold_counted, tick_counted
    admm_chunk._launch = recording_launch
    flights = []
    torch.cuda.synchronize()
    k1.launches = 0
    for start, goal, rseed, cp in missions:
        st = drv.reset(start, cp.route[-1], cp.hpolys, cp.seg)
        st, res = drv.run(st, MAX_TICKS, stop_when_done=True, stall_limit=5)
        flights.append((st, res))
    fly_launches = k1.launches
    admm_chunk._launch = launch
    drv._cold, drv._tick = cold_fn, tick_fn

    cold_ms, warm_ms, n_ticks, n_solved, n_track = [], [], 0, 0, 0
    n_cert, n_acc, n_arrived = 0, 0, 0
    for k, (st, res) in enumerate(flights):
        for r in res:
            s_ = r.state
            if not (np.isfinite(s_.pos).all() and np.isfinite(s_.vel).all()
                    and np.isfinite(s_.acc).all()):
                fail(f"mission {k}: a tick gave a non-finite state")
        dist = float(np.linalg.norm(st.pos - st.goal))
        arrived = bool(st.done) and dist < ARRIVE_DIST
        n_arrived += arrived
        cold_ms.append(res[0].latency_s * 1e3)
        warm_ms += [r.latency_s * 1e3 for r in res[1:]]
        n_ticks += len(res)
        n_solved += sum(r.solved for r in res)
        n_track += sum(r.tracking for r in res)
        certs = [r.certified for r in res if r.certified is not None]
        n_cert += sum(certs)
        n_acc += len(certs)
        print(f"fly: mission {k}: {len(res)} ticks, arrived {arrived}, "
              f"final distance {dist:.4f} m, solved {sum(r.solved for r in res)}"
              f", tracking {sum(r.tracking for r in res)}, light rescues "
              f"{sum(r.rescue == 1 for r in res)}, heavy "
              f"{sum(r.rescue == 2 for r in res)}, certified "
              f"{sum(certs)} of {len(certs)} accepted plans; cold tick "
              f"{cold_ms[-1]:.1f} ms")
    launches_per = {k: sorted(set(v)) for k, v in per_call.items()}
    print(f"  cold tick ms {', '.join(f'{t:.1f}' for t in cold_ms)}; warm "
          f"tick p50 {np.percentile(warm_ms, 50):.1f} ms, p99 "
          f"{np.percentile(warm_ms, 99):.1f} ms over {len(warm_ms)} ticks; "
          f"tick-solve rate {n_solved / n_ticks:.4f} ({n_solved} of "
          f"{n_ticks}); tracking {n_track}; light rescues {len(per_call[1])}"
          f", heavy {len(per_call[2])}; arrived {n_arrived} of "
          f"{len(flights)}; certified {n_cert} of {n_acc}")
    print(f"  admm_chunk launches: {fly_launches} in the fly phase; per cold "
          f"tick {launches_per['cold']} ({len(per_call['cold'])} ticks), per "
          f"warm tick {launches_per[0]} ({len(per_call[0])}), per light "
          f"rescue tick {launches_per[1]}, per heavy {launches_per[2]}")
    if fly_launches != sum(sum(v) for v in per_call.values()):
        fail("admm_chunk launched outside the ticks")
    if not per_call["cold"] or not per_call[0] or min(
            min(v) for v in per_call.values() if v) < 1:
        fail("a tick ran without launching admm_chunk")
    if n_arrived == 0:
        fail("no mission arrived")

    # the first cold tick again on the CPU's plain path, same corridor
    cpu_cold = driver.make_cold_tick(
        ConvLSTMAllocNet(5, 256, token_thresh=0.5), drv.cfg_tick, params)
    c_in = [x.cpu() for x in tick_inputs["cold"]]
    g_out = drv._cold(*tick_inputs["cold"])
    c_out = cpu_cold(*c_in)
    g_c, c_c = g_out[1].cpu().numpy(), c_out[1].numpy()
    cold_diff = float(np.abs(g_c - c_c).max() / max(1.0, np.abs(c_c).max()))
    print(f"  first cold tick vs the CPU plain path: solved "
          f"{bool(g_out[0][0])} / {bool(c_out[0][0])}, coefficients "
          f"{cold_diff:.3e} of the largest")
    if bool(g_out[0][0]) != bool(c_out[0][0]) or cold_diff > 1e-3:
        fail("the first cold tick on the card disagrees with the CPU path")

    # the kernel against its plain version on the tick batches
    if "rescue" not in recorded:
        # no tick missed: force one light rescue on the last warm input
        admm_chunk._launch = recording_launch
        driver._warm_tick(drv.cfg_tick, 0.1, 0, True, *tick_inputs["warm"],
                          rescue_scfg=replan.rescue_solver_config(
                              drv.cfg_tick.solver))
        admm_chunk._launch = launch
    tick_shapes = {}
    for batch in ("cold", "warm", "rescue"):
        if batch not in recorded:
            fail(f"no {batch} batch reached admm_chunk")
        a = recorded[batch]
        got = k1(*a)
        torch.cuda.synchronize()
        want = admm_chunk.admm_chunk_reference(*a)
        errs = []
        for name, g, w in zip(("x", "z", "yh", "yeh"), got, want):
            if not bool(torch.isfinite(g).all()):
                fail(f"kernel {name} not finite on the {batch} batch")
            errs.append(float((g - w).abs().max())
                        / max(1.0, float(w.abs().max())))
        if max(errs) > CHUNK_TOL:
            fail(f"admm_chunk disagrees with its plain version on the {batch} "
                 f"batch: {max(errs):.3e} of the largest entry")
        ms = cuda_ms(lambda: k1(*a), reps=20)
        pms = cuda_ms(lambda: admm_chunk.admm_chunk_reference(*a), reps=3)
        fl, nb = chunk_work(dcfg.qp, a[14], admm_chunk.aeq_dense(
            a[5], a[6], dcfg.qp.n_var), a[8], a[10])
        bms = max(fl / PEAK_F32_FLOPS, nb / PEAK_BYTES) * 1e3
        tick_shapes[batch] = {"B": int(a[0].shape[0]), "iters": int(a[14]),
                             "ms": ms, "plain_ms": pms, "bound_ms": bms,
                             "max_rel_err": max(errs)}
        print(f"  admm_chunk on the {batch} batch (B={a[0].shape[0]}, "
              f"{a[14]} iterations): kernel {ms:.3f} ms, plain {pms:.3f} ms, "
              f"bound {bms:.5f} ms ({fl:.3e} FLOP, {nb:.3e} B); max diff / "
              f"max|plain| of x z yh yeh "
              + " ".join(f"{e:.3e}" for e in errs))
    phase("fly", t0)

    kernels = [{
        "name": "admm_chunk", "route": "cuda",
        "source": "allocnet_tpu_torch/csrc/admm_chunk.cu",
        "replaces": "allocnet_tpu/ops/pallas/admm_tiled.py:236",
        "launches": launches, "max_abs_err": max_err,
        "ms": chunk_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "launches_by_path": {
            "serve": launches, "train": train_launches,
            "refine": refine_launches,
            "cold_tick": sum(per_call["cold"]), "warm_tick": sum(per_call[0]),
            "rescue": sum(per_call[1]) + sum(per_call[2]),
            "fly": fly_launches},
        "launches_per_tick": {"cold": launches_per["cold"],
                              "warm": launches_per[0],
                              "light_rescue": launches_per[1],
                              "heavy_rescue": launches_per[2]},
        "tick_shapes": tick_shapes,
        "train_shape": {"ms": train_chunk_ms, "plain_ms": train_plain_ms,
                        "bound_ms": train_bound_ms,
                        "max_rel_err": max(terrs)},
    }]
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
