#!/usr/bin/env python3
"""Where the time of the port's deploy-point solve goes, on one NVIDIA card.

Runs `allocnet_tpu_torch.ops.admm.solve_qp` on the deploy batch (B=1024,
`QPConfig()`, `SolverConfig()`, bench.py's seed 123) under
`torch.profiler`, after a warm-up, and prints the device time by kernel
name (largest first), the number of kernel launches, the wall time of the
profiled solves and the share of it the device spent idle.

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
    from allocnet_tpu_torch.ops import admm, qp
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
