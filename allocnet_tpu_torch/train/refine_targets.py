#!/usr/bin/env python3
"""Refinement of a corpus's supervision time targets, on the card.

The port's counterpart of `scripts/refine_targets.py`: every row's stored
segment times (the datagen heuristic's, feasible but not cost-optimal)
go through `planner/refine.refine_times` (fixed total, STEPS accept/reject
steps through the differentiable QP) at the script's point CFG (res 10,
v <= 5 m/s, a <= 7 m/s^2, `CERTIFY_SOLVER`), in chunks of CHUNK rows, the
last one padded with its last row; a row's times are rewritten only where
the refinement strictly lowered its objective (live slots only; padding
slots and every other row keep their bytes).  Each chunk's result is kept
as a part, `<out>.parts/chunk_<c>.npz`, with the metadata (start, stop,
steps, n_total) that a resumed run checks before it reads the part: a
part from another `--chunk`, `--steps` or corpus is refused, so a resume
assembles exactly what one run would.  Then `<out>` (state, hpolys,
times, seg in float32) and `<stem>_stats.json` (n, steps, improved_frac,
rel_obj_reduction_mean and _median, with the script's formulas).

Beyond the script the parts also keep each row's objectives (obj0, obj),
and the run returns ms and K1 / L1 launches per computed chunk.

    python -m allocnet_tpu_torch.train.refine_targets [--in SRC.npz]
        [--out OUT.npz] [--chunk 512] [--steps 6] [--device cpu]

Defaults read and write under the repository's git-ignored output
directory (`chiprun_out/chain/`).  Runs on the card unless `--device`
says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from allocnet_tpu_torch.config import (CERTIFY_SOLVER, AllocNetConfig,
                                       QPConfig)
from allocnet_tpu_torch.ops import admm, admm_chunk, ldl
from allocnet_tpu_torch.planner import refine
from allocnet_tpu_torch.train import dataset
from allocnet_tpu_torch.utils.device import resolve_device
from allocnet_tpu_torch.utils.scenarios import ScenarioBatch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chain")
IN = os.path.join(OUT_DIR, "big100k_combined.npz")
OUT = os.path.join(OUT_DIR, "big100k_refined.npz")
CHUNK = 512
STEPS = 6

# the script's cfg
CFG = AllocNetConfig(qp=QPConfig(res=10, max_vel=5.0, max_acc=7.0),
                     solver=CERTIFY_SOLVER)


def parts_dir(out: str) -> str:
    return out + ".parts"


def part_path(out: str, c: int) -> str:
    return os.path.join(parts_dir(out), f"chunk_{c:05d}.npz")


def stats_path(out: str) -> str:
    return out.replace(".npz", "") + "_stats.json"


def check_part(zz, c: int, chunk: int, steps: int, n: int, path: str):
    """The script's `_check_part`: a part must carry this run's start,
    stop, steps and n_total (a part without them is refused too)."""
    want = {"start": c * chunk, "stop": min((c + 1) * chunk, n),
            "steps": steps, "n_total": n}
    for k, v in want.items():
        if k not in zz.files or int(zz[k]) != v:
            raise SystemExit(
                f"stale/incompatible cache {path}: expected {k}={v}, "
                f"got {zz[k] if k in zz.files else 'missing'} - delete "
                f"{os.path.dirname(path)} or rerun with the original "
                f"--chunk/--steps")


def chunk_launches(cfg: AllocNetConfig = CFG, steps: int = STEPS):
    """(K1, L1) launches of one chunk: refine_times' differentiable solve
    at the start, its forward solve at the raw input and one per step,
    each `admm.solve_launches`."""
    return tuple((2 + steps) * n for n in admm.solve_launches(cfg.qp,
                                                               cfg.solver))


def rel_of(obj0: np.ndarray, obj: np.ndarray) -> np.ndarray:
    """The script's relative objective reduction (0 where unsolved)."""
    ok = obj0 < 1e29
    return np.where(ok, (obj0 - obj) / np.maximum(obj0, 1e-9), 0.0)


def read_corpus(path: str) -> ScenarioBatch:
    """The corpus as the script reads it: float32 state, hpolys, times."""
    sc = dataset.read_npz(path)
    f32 = lambda a: np.asarray(a, np.float32)
    return ScenarioBatch(f32(sc.state), f32(sc.hpolys), f32(sc.times),
                         np.asarray(sc.seg))


def refine_rows(sc: ScenarioBatch, ip: np.ndarray, steps: int = STEPS,
                device=None, cfg: AllocNetConfig = CFG) -> dict:
    """`refine.refine_times` of rows `ip` of `sc` (one float32 batch on
    `device`): numpy times, improved, obj0, obj and rel per row of ip."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a[ip], np.float32), device=dev)
    res = refine.refine_times(
        cfg.qp, cfg.solver, t(sc.state), t(sc.hpolys), t(sc.times),
        torch.as_tensor(sc.seg[ip], device=dev).long(), steps=steps)
    out = {"times": res.times.detach().cpu().numpy(),
           "improved": res.improved.cpu().numpy(),
           "obj0": res.obj0.detach().cpu().numpy(),
           "obj": res.obj.detach().cpu().numpy()}
    out["rel"] = rel_of(out["obj0"], out["obj"])
    return out


def _sync(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _save_part(path: str, **arrays) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def assemble(sc: ScenarioBatch, out: str, chunk: int, steps: int) -> dict:
    """The script's assembly: every part checked and read in order; only
    the improved rows' live slots take the refined times.  Returns the
    refined batch's arrays, the per-row improved, rel, obj0 and obj, and
    the statistics."""
    n, S = len(sc.seg), sc.times.shape[1]
    t_out = np.array(sc.times)
    acc = {"improved": np.zeros(n, bool), "rel": np.zeros(n),
           "obj0": np.zeros(n, np.float32), "obj": np.zeros(n, np.float32)}
    for c in range(-(-n // chunk)):
        path = part_path(out, c)
        zz = np.load(path)
        check_part(zz, c, chunk, steps, n, path)
        sl = slice(c * chunk, min((c + 1) * chunk, n))
        k = sl.stop - sl.start
        mask = np.arange(S)[None] < sc.seg[sl][:, None]
        imp = zz["improved"][:k]
        t_out[sl] = np.where(mask & imp[:, None], zz["times"][:k],
                             sc.times[sl])
        acc["improved"][sl] = imp
        acc["rel"][sl] = zz["rel"][:k]
        for key in ("obj0", "obj"):
            if key in zz.files:
                acc[key][sl] = zz[key][:k]
    stats = {"n": int(n), "steps": steps,
             "improved_frac": float(acc["improved"].mean()),
             "rel_obj_reduction_mean": float(acc["rel"].mean()),
             "rel_obj_reduction_median": float(np.median(acc["rel"]))}
    return {"times": t_out, **acc, "stats": stats}


def refine_corpus(src: str = IN, out: str = OUT, chunk: int = CHUNK,
                  steps: int = STEPS, device=None, log=print) -> dict:
    """The script's main: nothing when `out` exists; else each chunk
    without a part refined and kept, every part checked, then `out` and
    its statistics written.  Returns {"stats", "computed", "resumed",
    "chunks": per computed chunk {c, rows, ms, k1, l1}, "wall_s"} (or
    {"skipped": out})."""
    if os.path.exists(out):
        log(f"{out} exists; nothing to do")
        return {"skipped": out}
    dev = resolve_device(device)
    sc = read_corpus(src)
    n = len(sc.seg)
    os.makedirs(parts_dir(out), exist_ok=True)
    n_chunks = -(-n // chunk)
    k1, l1 = admm_chunk.admm_chunk, ldl.ldl_block
    chunks, resumed, improved = [], 0, 0
    t_all = time.perf_counter()
    for c in range(n_chunks):
        path = part_path(out, c)
        if os.path.exists(path):
            zz = np.load(path)
            check_part(zz, c, chunk, steps, n, path)
            improved += int(zz["improved"].sum())
            resumed += 1
            continue
        start, stop = c * chunk, min((c + 1) * chunk, n)
        idx = np.arange(start, stop)
        # pad the tail chunk to the chunk's batch with its last row
        ip = np.concatenate([idx, np.full(chunk - len(idx), idx[-1])])
        n0, m0 = k1.launches, l1.launches
        t0 = _sync(dev)
        r = refine_rows(sc, ip, steps, dev)
        ms = (_sync(dev) - t0) * 1e3
        k = len(idx)
        _save_part(path, times=r["times"][:k], improved=r["improved"][:k],
                   rel=r["rel"][:k], obj0=r["obj0"][:k], obj=r["obj"][:k],
                   start=start, stop=stop, steps=steps, n_total=n)
        improved += int(r["improved"][:k].sum())
        chunks.append({"c": c, "rows": k, "ms": ms,
                       "k1": k1.launches - n0, "l1": l1.launches - m0})
        if c % 10 == 0:
            log(json.dumps({"chunk": c, "of": n_chunks,
                            "improved": improved, "ms": round(ms, 1)}))
    got = assemble(sc, out, chunk, steps)
    dataset.write_npz(out, ScenarioBatch(sc.state, sc.hpolys, got["times"],
                                         sc.seg))
    with open(stats_path(out), "w") as f:
        json.dump(got["stats"], f, indent=1)
    log(json.dumps(got["stats"]))
    return {"stats": got["stats"], "computed": len(chunks),
            "resumed": resumed, "chunks": chunks,
            "wall_s": time.perf_counter() - t_all}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--in", dest="src", default=IN)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--chunk", type=int, default=CHUNK)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    refine_corpus(a.src, a.out, a.chunk, a.steps, a.device,
                  lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
