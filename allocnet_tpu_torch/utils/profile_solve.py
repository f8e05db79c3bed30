#!/usr/bin/env python3
"""Where the time of the port's deploy-point solve and of its training step
goes, on one NVIDIA card.

Runs `allocnet_tpu_torch.ops.admm.solve_qp` on the deploy batch (B=1024,
`QPConfig()`, `SolverConfig()`, bench.py's seed 123) under
`torch.profiler`, after a warm-up, and prints the device time by kernel
name (largest first), the number of kernel launches, the wall time of the
profiled solves and the share of it the device spent idle, and the device
time and launches of the port's two hand-written kernels (K1 admm_chunk,
L1 ldl_block, the polish's LDL^T diagonal block).  Then it runs
one deploy chunk (150 iterations from the solve's first state) through the
profile build of the admm_chunk kernel and prints its per-phase SM cycles
(mean over blocks): each phase's wall cycles per iteration (load and store
once per launch), as thread 0 of each block reads clock64() at the
barriers, and the busy cycles of the phase's slowest warp and of the mean
warp (16 per block); once for the whole batch and once for 132 scenarios,
one block per SM.  Last, it profiles training steps the same way (the
shipped seq5 ConvLSTM at the TRAIN operating point, B=32: the net, the
differentiable solve, the implicit backward and Adam) and prints the
same device-time table per step.  Then the 10 Hz driver's ticks at
DEPLOY with the same net: the first mission that chip_smoke.py flies
(map 0 of scripts/drive_eval.py, missions sampled with seed 1), its
cold tick and its first warm tick, each repeated from the same state,
with the host time of the tick's parts (QP assembly, the ADMM chunks,
polish and its LDL factor, diagonal blocks and solves, residuals, the
advance, the certificate) from profiler ranges.

    python3 -m allocnet_tpu_torch.utils.profile_solve [--reps 3] [--top 25]
        [--ticks-only]

Needs a CUDA device; imports no JAX.
"""

import argparse
import subprocess
import sys
import time
from collections import defaultdict


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--ticks-only", action="store_true",
                    help="profile only the driver's ticks")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_solve: no CUDA device", file=sys.stderr)
        return 2
    from allocnet_tpu_torch.config import QPConfig, SolverConfig
    from allocnet_tpu_torch.ops import admm, admm_chunk, qp
    from allocnet_tpu_torch.utils import scenarios
    from allocnet_tpu_torch.utils.device import resolve_device

    dev = resolve_device()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if args.ticks_only:
        profile_ticks(dev, args.reps, args.top)
        return 0
    cfg, scfg = QPConfig(), SolverConfig()
    sc = scenarios.random_scenarios(cfg, 1024, seed=123, min_seg=1)
    f32 = np.float32
    data = qp.build_qp(cfg, sc.state.astype(f32), sc.hpolys.astype(f32),
                       sc.times.astype(f32), sc.seg, device=dev)
    for _ in range(2):
        admm.solve_qp(data, scfg)
    torch.cuda.synchronize()

    profile_device(lambda: admm.solve_qp(data, scfg), args.reps, args.top,
                   "solve", "solves of B=1024")
    print_phase_cycles(data, scfg, admm_chunk)
    profile_train(dev, args.reps, args.top)
    profile_ticks(dev, args.reps, args.top)
    return 0


# the port's hand-written kernels, by the name of their __global__
# function: csrc/admm_chunk.cu (K1), csrc/ldl_block.cu (L1)
HAND_WRITTEN = {"admm_chunk_kernel": "K1 admm_chunk",
                "ldl_block_kernel": "L1 ldl_block"}


def profile_device(fn, reps, top, unit, what, sections=()):
    """Run fn `reps` times under torch.profiler and print the wall time,
    device busy time, idle share and launches per call, the device time
    and launches per call of each hand-written kernel (HAND_WRITTEN), and
    the `top` kernel names by device time; then, for each name in
    `sections` (record_function ranges that fn opens), its host time per
    call and share of the wall.  Returns {'wall_ms', 'busy_ms', 'idle',
    'launches', and per hand-written kernel name its (ms, launches)}, per
    call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    # device kernels only (not CPU-side operator rows)
    by_name, count = defaultdict(float), defaultdict(int)
    host, host_n = defaultdict(float), defaultdict(int)
    for ev in prof.events():
        if ev.name in sections:
            # a section's range; it also shows as a device annotation,
            # which is not a kernel
            if ev.device_type == torch.autograd.DeviceType.CPU:
                host[ev.name] += ev.time_range.elapsed_us()
                host_n[ev.name] += 1
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] += ev.time_range.elapsed_us()
            count[ev.name] += 1
    busy = sum(by_name.values())
    out = {"wall_ms": wall_us / 1e3 / reps, "busy_ms": busy / 1e3 / reps,
           "idle": 1 - busy / wall_us,
           "launches": sum(count.values()) / reps}
    print(f"{reps} {what}: wall {out['wall_ms']:.2f} ms per {unit}, "
          f"device busy {out['busy_ms']:.2f} ms per {unit}, "
          f"idle share {out['idle']:.3f}, "
          f"{out['launches']:g} kernel launches per {unit}")
    for key, label in HAND_WRITTEN.items():
        names = [n for n in by_name if key in n]
        out[key] = (sum(by_name[n] for n in names) / 1e3 / reps,
                    sum(count[n] for n in names) / reps)
        print(f"  {label}: {out[key][0]:.3f} device ms per {unit} "
              f"({out[key][0] / max(out['busy_ms'], 1e-9):.3f} of busy), "
              f"{out[key][1]:g} launches per {unit}")
    if top:
        print(f"{'device ms/' + unit:>16} {'share':>6} {'launches':>9}  "
              f"kernel")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{t / 1e3 / reps:16.3f} {t / busy:6.3f} "
              f"{count[name] // reps:9d}  {name[:100]}")
    if sections:
        print(f"{'host ms/' + unit:>16} {'share':>6} {'calls':>9}  section "
              f"(under the profiler; sections nest)")
        for name in sections:
            print(f"{host[name] / 1e3 / reps:16.3f} {host[name] / wall_us:6.3f} "
                  f"{host_n[name] // reps:9d}  {name}")
    return out


def profile_train(dev, reps, top):
    """Training steps of the shipped seq5 net at TRAIN, B=32."""
    import os

    import torch
    from allocnet_tpu_torch import config
    from allocnet_tpu_torch.models import weights
    from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
    from allocnet_tpu_torch.train import train_step
    from allocnet_tpu_torch.utils import scenarios

    cfg = config.TRAIN
    net = ConvLSTMAllocNet(5, 256, token_thresh=0.5)
    net.load_state_dict(weights.load_params(os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "data", "params",
        "seq5_tokenthresh0_35.msgpack")))
    net = net.to(dev)
    opt, lr_sched = train_step.make_optimizer(net, cfg.train)
    sc = scenarios.random_scenarios(cfg.qp, cfg.train.batch_size, seed=123,
                                    min_seg=1)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    batch = (t(sc.state), t(sc.hpolys),
             torch.as_tensor(sc.seg, device=dev).long(), t(sc.times))

    def step():
        train_step.train_step(net, opt, lr_sched, cfg.qp, cfg.solver,
                              cfg.loss, *batch,
                              token_thresh=cfg.model.token_thresh)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    profile_device(step, reps, top, "step",
                   f"training steps of B={cfg.train.batch_size} at TRAIN")


def profile_ticks(dev, reps, top):
    """The driver's cold tick and first warm tick on chip_smoke.py's first
    mission (DEPLOY, the shipped seq5 net), each under the profiler."""
    import os

    import numpy as np
    import torch
    from allocnet_tpu_torch import config
    from allocnet_tpu_torch.models import weights
    from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
    from allocnet_tpu_torch.planner import driver, planner
    from allocnet_tpu_torch.train import datagen

    cfg = config.DEPLOY
    lo, hi = np.zeros(3), np.array([20.0, 20.0, 4.0])
    pmap = planner.build_map(datagen.random_obstacle_map(100, tuple(hi)),
                             lo, hi, scale=0.25, dilate_r=2, device=dev)
    start, _, _, cp = planner.sample_missions(
        pmap, cfg, np.random.default_rng(1), 1, lo, hi, device=dev)[0]
    params = weights.load_params(os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "data", "params",
        "seq5_tokenthresh0_35.msgpack"))
    drv = driver.Driver(ConvLSTMAllocNet(5, 256, token_thresh=0.5), params,
                        cfg, rate_hz=10.0, certify=True, device=dev)
    drv.prewarm()
    st0 = drv.reset(start, cp.route[-1], cp.hpolys, cp.seg)
    r = drv.tick(st0)
    if not r.solved:
        print("profile_ticks: the cold tick did not solve")
        return
    st1 = r.state
    drv.tick(st1)
    torch.cuda.synchronize()

    # host time by section: record_function ranges around the tick's
    # parts (restored after the profile)
    from allocnet_tpu_torch.ops import admm, admm_chunk, ldl, qp
    from allocnet_tpu_torch.planner import trajectory
    wrapped = [(qp, "build_qp"), (admm_chunk, "admm_solve_chunked"),
               (admm, "polish"), (ldl, "ldl_factor"), (ldl, "ldl_block"),
               (ldl, "ldl_solve"),
               (admm, "_full_residuals"), (driver, "_advance"),
               (trajectory, "certify_box_host")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in wrapped]

    def ranged(name, fn):
        def call(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return call

    for mod, name, fn in saved:
        setattr(mod, name, ranged(name, fn))
    sections = [name for _, name in wrapped]
    try:
        profile_device(lambda: drv.tick(st0), reps, top, "tick",
                       f"cold ticks (seg {cp.seg}, B=3 hedge)", sections)
        profile_device(lambda: drv.tick(st1), reps, top, "tick",
                       "warm ticks (B=1)", sections)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def print_phase_cycles(data, scfg, admm_chunk):
    """Per-phase cycles of one deploy chunk through the profile build."""
    import torch

    B = data.times.shape[0]
    args = admm_chunk.chunk_inputs(data, scfg)
    it = scfg.iters_per_chunk
    # the deploy batch (two scenarios per SM), then its first 132 scenarios
    # alone (one block per SM on a 132-SM card: no other block's warps
    # between a phase's instructions)
    for count in (B, 132):
        sub = tuple(a[:count].contiguous() if a.dim() and a.shape[0] == B
                    else a for a in args)
        names, prof = admm_chunk.phase_cycles(*sub, n_iters=it,
                                              sigma=scfg.sigma,
                                              alpha=scfg.alpha)
        mean = prof.double().mean(0)          # (3, phases)
        total = float(mean[0].sum())
        kx = torch.bincount(prof[:, 1, 0], minlength=3)
        print(f"admm_chunk phases, B={count} x {it} iterations (profile "
              f"build; SM cycles, mean over blocks): {total:.0f} cycles per "
              f"block; Kx kept " + ", ".join(
                  f"{name} {int(c)}" for name, c in
                  zip(admm_chunk.KX_MODES, kx)))
        print(f"{'phase':>8} {'cycles/launch':>14} {'share':>6} "
              f"{'wall/iter':>10} {'slowest warp busy/iter':>23} "
              f"{'mean warp busy/iter':>20}")
        for k, name in enumerate(names):
            c = float(mean[0, k])
            if name in ("load", "store"):
                print(f"{name:>8} {c:14.0f} {c / total:6.3f}")
                continue
            print(f"{name:>8} {c:14.0f} {c / total:6.3f} {c / it:10.1f} "
                  f"{float(mean[1, k]) / it:23.1f} "
                  f"{float(mean[2, k]) / it / 16:20.1f}")


if __name__ == "__main__":
    sys.exit(main())
