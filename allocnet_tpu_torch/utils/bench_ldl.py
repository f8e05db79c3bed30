#!/usr/bin/env python3
"""L1, the polish's LDL^T diagonal-block kernel (csrc/ldl_block.cu), per
launch on one NVIDIA card at the batch sizes of the polish's paths (warm
tick B=1, cold B=3, rescue B=4, certify B=256, deploy and S=10 B=1024, and
B=1025, which leaves the last thread block short), on seeded
quasi-definite 64-column blocks with bumped pivots.  Given `--against`,
also another source with the same C interface (for example a parent
commit's csrc/ldl_block.cu), built with the same flags, timed in turns
with this one (other, this, this, other) in the same process.

For each version and batch: ms per call of back-to-back eager launches
(CUDA events around `reps` calls; at small batches the host's launch rate
can set it) and ms per launch inside a captured CUDA graph of `reps`
launches (events around replays: the device time, launch gaps of the graph
included).  Each version is first held against the plain version
`ldl.ldl_block_reference` on the same card, bit for bit.  Prints the
card's name, power limit and largest SM clock, and one JSON line.

    python3 -m allocnet_tpu_torch.utils.bench_ldl [--against FILE]
        [--reps 100]

Needs a CUDA device; imports no JAX.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from allocnet_tpu_torch.ops import _cuda_build, ldl
from allocnet_tpu_torch.utils.device import resolve_device

BATCHES = (1, 3, 4, 256, 1024, 1025)
REG = 1e-5                                 # SolverConfig.polish_ldl_delta


def random_qd_blocks(B, dev, seed, nb=64):
    """Seeded quasi-definite (B, nb, nb) f32 blocks, the first 5 nb / 8
    pivots positive and the rest negative, with pivots below the polish's
    reg (1e-5) in columns 5, 20, 45 and 50 scaled to nb (no coupling to
    the columns before them); and the signs."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(B, nb, nb))
    K = W @ np.swapaxes(W, 1, 2) / nb + np.eye(nb)
    npos = (5 * nb) // 8
    K[:, npos:, npos:] = -K[:, npos:, npos:]
    K[:, :npos, npos:] *= 0.1
    K[:, npos:, :npos] *= 0.1
    for j, v in ((5, 0.0), (20, 3e-8), (45, 2e-9), (50, -4e-7)):
        j = j * nb // 64
        K[:, j, :j] = K[:, :j, j] = 0.0
        K[:, j, j] = v
    sign = np.where(np.arange(nb) < npos, 1.0, -1.0)
    return (torch.tensor(K, dtype=torch.float32, device=dev),
            torch.tensor(sign, dtype=torch.float32, device=dev))


def event_ms(fn, reps, warmup=2):
    """Mean ms per call of `reps` back-to-back calls (CUDA events)."""
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


def graph_ms(fn, reps, replays=5):
    """Mean ms per call of `fn` captured `reps` times in one CUDA graph,
    over `replays` replays after a warm one (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ldl_block_launch.argtypes = [i, i, ctypes.c_float] + [p] * 5
    lib.ldl_block_launch.restype = i
    return lib


def launcher(lib):
    """ldl_block through `lib`'s C entry, as the operator calls it, without
    touching the operator's launch count."""
    def run(Kb, sign, reg):
        B, NB, _ = Kb.shape
        L = torch.empty_like(Kb)
        d = Kb.new_empty((B, NB))
        stream = torch.cuda.current_stream(Kb.device).cuda_stream
        err = lib.ldl_block_launch(B, NB, float(reg), Kb.data_ptr(),
                                   sign.data_ptr(), L.data_ptr(),
                                   d.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"ldl_block_launch: cudaError {err}")
        return L, d
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another ldl_block.cu to time")
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args(argv)
    dev = resolve_device()
    smi = subprocess.run(["nvidia-smi",
                          "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    versions = {"this": launcher(ldl._library())}
    order = ["this", "this"]
    if args.against:
        info = _cuda_build.build("ldl_block_other", Path(args.against),
                                 ldl.NVCC_FLAGS, ldl.BUILD_DIR)
        versions["other"] = launcher(_bind(ctypes.CDLL(info["path"])))
        order = ["other", "this", "this", "other"]
    print(f"L1 geometry: {ldl.geometry()}")

    out = {name: {} for name in versions}
    for B in BATCHES:
        Kb, sg = random_qd_blocks(B, dev, seed=B)
        rL, rd = ldl.ldl_block_reference(Kb, sg, REG)
        for name, run in versions.items():
            L, d = run(Kb, sg, REG)
            torch.cuda.synchronize()
            if not (torch.equal(L, rL) and torch.equal(d, rd)):
                raise SystemExit(f"bench_ldl: {name} differs from the plain "
                                 f"version at B={B}")
        times = {name: {"eager_ms": [], "graph_ms": []} for name in versions}
        for name in order:
            fn = (lambda run=versions[name]: run(Kb, sg, REG))
            times[name]["eager_ms"].append(event_ms(fn, args.reps))
            times[name]["graph_ms"].append(graph_ms(fn, args.reps))
        for name, t in times.items():
            out[name][B] = t
            print(f"B={B:5d} {name:5s}: eager "
                  + " / ".join(f"{v:.4f}" for v in t["eager_ms"])
                  + " ms per call, graph "
                  + " / ".join(f"{v:.4f}" for v in t["graph_ms"])
                  + " ms per launch", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                      "reps": args.reps, "bitwise": True, "times": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
