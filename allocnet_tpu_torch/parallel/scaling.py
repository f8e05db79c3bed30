"""Weak-scaling measurement of the batched QP solve over data-parallel
processes.

Port of `allocnet_tpu/parallel/scaling.py`:

    efficiency(N) = throughput(N devices, N*B scenarios)
                    / (N * throughput(1 device, B scenarios))

Each process of the group (one device each, parallel/mesh.py) solves its
rank's B scenarios of the N*B; a count's time is the slowest participating
rank's.  In one process only the count 1 runs.  Run one process per card,
e.g. `torchrun --nproc-per-node 4 -m allocnet_tpu_torch.parallel.scaling`.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from allocnet_tpu_torch.config import QPConfig, SolverConfig
from allocnet_tpu_torch.ops import admm, qp
from allocnet_tpu_torch.parallel import mesh as mesh_lib
from allocnet_tpu_torch.utils import scenarios


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _throughput(step, args, device: torch.device, reps: int = 3) -> float:
    """Seconds per call of step(*args) after one warm-up call, host clock
    ending in a device sync."""
    step(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        step(*args)
    _sync(device)
    return (time.perf_counter() - t0) / reps


def solve_scaling(
    per_device_batch: int = 256,
    device_counts: tuple[int, ...] | None = None,
    cfg: QPConfig | None = None,
    scfg: SolverConfig | None = None,
    seed: int = 0,
    device=None,
) -> dict:
    """Weak-scaling sweep of the batched solve.  Returns {count: {'batch',
    'solves_per_sec', 'efficiency'}, 'platform': 'gpu' or 'cpu'}, the same
    on every rank."""
    cfg = cfg or QPConfig()
    scfg = scfg or SolverConfig()
    size, rank = mesh_lib.world()
    device_counts = device_counts or tuple(
        n for n in (1, 2, 4, 8, 16) if n <= size)

    results = {}
    base = None
    for nd in device_counts:
        m = mesh_lib.make_mesh(nd, device)
        B = per_device_batch * nd
        sc = scenarios.random_scenarios(cfg, B, seed=seed, min_seg=1)
        f32 = np.float32
        dt = 0.0
        if rank < nd:
            st, hp, tm, sg = mesh_lib.shard_batch(m, (
                sc.state.astype(f32), sc.hpolys.astype(f32),
                sc.times.astype(f32), sc.seg))
            step = lambda st, hp, tm, sg: admm.solve_qp(
                qp.build_qp(cfg, st, hp, tm, sg, device=m.device), scfg).obj
            dt = _throughput(step, (st, hp, tm, sg), m.device)
        if size > 1:
            t = torch.tensor([dt], dtype=torch.float64, device=m.device)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            dt = float(t[0])
        tput = B / dt
        if base is None:
            base = tput
        results[nd] = {"batch": B, "solves_per_sec": tput,
                       "efficiency": tput / (base * nd)}
    results["platform"] = "gpu" if m.device.type == "cuda" else "cpu"
    return results


def main():
    import json
    mesh_lib.initialize_distributed()
    out = solve_scaling()
    if mesh_lib.world()[1] == 0:
        print(json.dumps(out, indent=2, default=float))


if __name__ == "__main__":
    main()
