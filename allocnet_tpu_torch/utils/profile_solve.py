#!/usr/bin/env python3
"""Where the time of the port's deploy-point solve goes, on one NVIDIA card.

Runs `allocnet_tpu_torch.ops.admm.solve_qp` on the deploy batch (B=1024,
`QPConfig()`, `SolverConfig()`, bench.py's seed 123) under
`torch.profiler`, after a warm-up, and prints the device time by kernel
name (largest first), the number of kernel launches, the wall time of the
profiled solves and the share of it the device spent idle.  Then it runs
one deploy chunk (150 iterations from the solve's first state) through the
profile build of the admm_chunk kernel and prints its per-phase SM cycles
(mean over blocks): each phase's wall cycles per iteration (load and store
once per launch), as thread 0 of each block reads clock64() at the
barriers, and the busy cycles of the phase's slowest warp and of the mean
warp (16 per block); once for the whole batch and once for 132 scenarios,
one block per SM.

    python3 -m allocnet_tpu_torch.utils.profile_solve [--reps 3] [--top 25]

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
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    cfg, scfg = QPConfig(), SolverConfig()
    sc = scenarios.random_scenarios(cfg, 1024, seed=123, min_seg=1)
    f32 = np.float32
    data = qp.build_qp(cfg, sc.state.astype(f32), sc.hpolys.astype(f32),
                       sc.times.astype(f32), sc.seg, device=dev)
    for _ in range(2):
        admm.solve_qp(data, scfg)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            admm.solve_qp(data, scfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    # device kernels only (not CPU-side operator rows)
    by_name, count = defaultdict(float), defaultdict(int)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] += ev.time_range.elapsed_us()
            count[ev.name] += 1
    busy = sum(by_name.values())
    print(f"{args.reps} solves of B=1024: wall {wall_us / 1e3 / args.reps:.2f} ms "
          f"per solve, device busy {busy / 1e3 / args.reps:.2f} ms per solve, "
          f"idle share {1 - busy / wall_us:.3f}, "
          f"{sum(count.values()) // args.reps} kernel launches per solve")
    print(f"{'device ms/solve':>16} {'share':>6} {'launches':>9}  kernel")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"{t / 1e3 / args.reps:16.3f} {t / busy:6.3f} "
              f"{count[name] // args.reps:9d}  {name[:100]}")
    print_phase_cycles(data, scfg, admm_chunk)
    return 0


def print_phase_cycles(data, scfg, admm_chunk):
    """Per-phase cycles of one deploy chunk through the profile build."""
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
        print(f"admm_chunk phases, B={count} x {it} iterations (profile "
              f"build; SM cycles, mean over blocks): {total:.0f} cycles per "
              f"block")
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
