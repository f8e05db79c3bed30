#!/usr/bin/env python3
"""Held-out evaluation of segment-time refinement, on the card.

The port's counterpart of `scripts/eval_refine.py`: the supervised arm's
latest checkpoint (`runs/big3`, a hidden-256 ConvLSTM at ModelConfig's
default stop-token threshold 0.42, not the arm's calibrated one) gives
each never-seen scenario of `data/eval_fresh.npz` its segment times; the
QP is solved at those times, `refine.refine_times` redistributes them
(6 accept/reject steps through the differentiable QP, the total time
kept), and the QP is solved again at the refined times, all at the
script's operating point CFG (res 10, v <= 5 m/s, a <= 7 m/s^2,
`CERTIFY_SOLVER`: 4 x 250 ADMM iterations, 6 polish rounds, one drop
pass), in chunks of 500.  `--subset` runs the 192 scenarios of
`runs/big3/eval_subset.npz` as one chunk.

Beyond the script it times each chunk (the net, the first solve, the
refinement, the second solve), counts both kernels' launches per chunk
(K1 `admm_chunk`, L1 `ldl_block`; on the card each must launch) and
checks GATES: the success rates and the total-time drift against the
record (`runs/refine/results_full.json`, the JAX package's run on the
TPU), the improved fraction and the objective reductions against the
JAX package's run on the CPU (REFERENCE, `tests/jax_refine_record.py`),
whose per-scenario flags it also compares.  `--subset` gates only the
drift: its record (`runs/refine/results.json`) predates the JAX
package's fix of the refinement's baseline.

    python -m allocnet_tpu_torch.planner.refine_eval [--subset] [--n N]
        [--out PATH] [--record PATH] [--device cpu]

The JSON goes to `--out` (default OUT, in the repository's git-ignored
output directory).  Runs on the card unless `--device` says otherwise;
exits 1 when a gate fails.
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
                                       ModelConfig, QPConfig, TrainConfig)
from allocnet_tpu_torch.models import packing, weights
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.ops import admm, admm_chunk, ldl, qp
from allocnet_tpu_torch.planner import refine
from allocnet_tpu_torch.train.heldout_eval import (ROOT, RUNS, latest_msgpack,
                                                   load_scenarios)
from allocnet_tpu_torch.utils.device import device_line, resolve_device

# the script's cfg: the training shapes with the certification solver
CFG = AllocNetConfig(
    qp=QPConfig(res=10, max_vel=5.0, max_acc=7.0),
    solver=CERTIFY_SOLVER,
    train=TrainConfig(batch_size=128),
    model=ModelConfig(hidden_size=256),
)
WORKDIR = os.path.join(RUNS, "big3")
SUBSET = os.path.join(WORKDIR, "eval_subset.npz")
RECORD = os.path.join(RUNS, "refine", "results_full.json")
SUBSET_RECORD = os.path.join(RUNS, "refine", "results.json")
REFERENCE = os.path.join(ROOT, "tests", "records", "refine_full_jax_cpu.json")
REFERENCE_FLAGS = os.path.splitext(REFERENCE)[0] + ".npz"
OUT = os.path.join(ROOT, "chiprun_out", "refine_eval.json")
STEPS = 6
CHUNK = 500
TIME_MIN = 0.05           # the net's times are clamped here on live slots
WARMUP_N = 8
# the per-scenario arrays each chunk gives (the script's accumulators)
ACC = ("solved0", "solved1", "obj0", "obj1", "improved", "ts0", "ts1")
# the gates: (field, limit, kind, against); "abs" is |ours - theirs| <=
# limit, "max" ours <= limit.  "record" is RECORD, the JAX package's run
# on the TPU; "reference" is REFERENCE, the JAX package's run on the CPU
# (tests/jax_refine_record.py), for the objective statistics, which the
# record's TPU run gives and no CPU run of the JAX package reproduces
# (not even its code of that run).  float32 summation order decides 2.6-3%
# of the solved flags at multi-round polish, so the success rates get the
# held-out eval's 0.02 and the objective statistics a little more; the
# fixed-total refinement keeps the total time to float32 rounding
GATES = (("success_rate_net", 0.02, "abs", "record"),
         ("success_rate_refined", 0.02, "abs", "record"),
         ("improved_frac", 0.03, "abs", "reference"),
         ("rel_obj_reduction_median", 0.02, "abs", "reference"),
         ("rel_obj_reduction_mean", 0.03, "abs", "reference"),
         ("rel_obj_reduction_p90", 0.05, "abs", "reference"),
         ("total_time_max_rel_drift", 1e-6, "max", "record"))


def load_net(device=None) -> ConvLSTMAllocNet:
    """ConvLSTMAllocNet(5, 256, 0.42) with the latest `.msgpack` of
    WORKDIR, on `device` (the card unless the caller asks for another).
    The threshold is ModelConfig's default, as the script's: the net
    zeroes every time after its stop token fires, so it decides which
    live slots net_times clamps to TIME_MIN."""
    m = CFG.model
    net = ConvLSTMAllocNet(m.seq_len, m.hidden_size, m.token_thresh)
    net.load_state_dict(weights.load_params(latest_msgpack(WORKDIR)))
    return net.to(resolve_device(device)).eval()


def seg_mask_of(seg, like):
    S = CFG.qp.max_seg
    return (torch.arange(S, device=like.device)[None, :]
            < seg[:, None]).to(like.dtype)


@torch.no_grad()
def net_times(net, state, hpolys, seg):
    """(B, S) times the QP gets: the net's, at least TIME_MIN on live
    slots, 1 on padded ones."""
    out = net(packing.pack_state(state), packing.pack_hpolys(hpolys))
    times = out[0] if isinstance(out, tuple) else out
    return torch.where(seg_mask_of(seg, times) > 0,
                       torch.clamp_min(times, TIME_MIN),
                       torch.ones_like(times))


@torch.no_grad()
def solve_obj(state, hpolys, seg, times):
    """(solved, obj) of the QP at `times`, at CFG's solver."""
    data = qp.build_qp(CFG.qp, state, hpolys, times, seg, device=times.device)
    sol = admm.solve_qp(data, CFG.solver)
    return sol.solved, sol.obj


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def run_chunk(net, state, hpolys, seg):
    """One chunk (tensors on the net's device) as the script runs it:
    net times t0, the solve at t0, STEPS steps of refinement (fixed total),
    the solve at the refined times.  Returns (per-scenario numpy arrays
    ACC plus the refined times "t1", seconds of each stage)."""
    dev = state.device
    t_a = _sync(dev)
    t0 = net_times(net, state, hpolys, seg)
    t_b = _sync(dev)
    solved0, obj0 = solve_obj(state, hpolys, seg, t0)
    t_c = _sync(dev)
    res = refine.refine_times(CFG.qp, CFG.solver, state, hpolys, t0, seg,
                              steps=STEPS)
    t_d = _sync(dev)
    seg_mask = seg_mask_of(seg, t0)
    solved1, obj1 = solve_obj(state, hpolys, seg, res.times + (1.0 - seg_mask))
    t_e = _sync(dev)
    arrays = {"solved0": solved0, "solved1": solved1, "obj0": obj0,
              "obj1": obj1, "improved": res.improved,
              "ts0": (t0 * seg_mask).sum(1),
              "ts1": (res.times * seg_mask).sum(1), "t1": res.times}
    seconds = {"net_s": t_b - t_a, "solve0_s": t_c - t_b,
               "refine_s": t_d - t_c, "solve1_s": t_e - t_d}
    return {k: v.detach().cpu().numpy() for k, v in arrays.items()}, seconds


def summarize(acc: dict, subset: bool, checkpoint: str) -> dict:
    """The script's record from the per-scenario arrays ACC, field for
    field and in its order."""
    solved0, solved1, obj0, obj1, improved, tsum0, tsum1 = (
        np.asarray(acc[k]) for k in ACC)
    both = solved0 & solved1
    rel = (obj0[both] - obj1[both]) / np.maximum(obj0[both], 1e-9)
    return {
        "n": int(len(solved0)), "steps": STEPS, "subset": subset,
        "checkpoint": checkpoint,
        "success_rate_net": float(solved0.mean()),
        "success_rate_refined": float(solved1.mean()),
        "n_both_solved": int(both.sum()),
        "improved_frac": float(improved[both].mean()),
        "rel_obj_reduction_mean": float(rel.mean()),
        "rel_obj_reduction_median": float(np.median(rel)),
        "rel_obj_reduction_p90": float(np.percentile(rel, 90)),
        "total_time_max_rel_drift": float(
            np.max(np.abs(tsum1 - tsum0)[solved0] / tsum0[solved0])),
    }


def gates(out: dict, record: dict, reference: dict) -> dict:
    """GATES of `out` (summarize's fields) against the record and the
    reference.  Over all of the record's 2,000 scenarios every gate
    applies; over a cut, or over the subset (whose record predates the
    JAX package's refinement fix, and which has no reference), only the
    total-time drift does."""
    full = out["n"] == record["n"] and not out["subset"]
    checks, passed = {}, True
    for field, limit, kind, against in GATES:
        if not full and kind != "max":
            continue
        ours = out[field]
        theirs = (record if against == "record" else reference)[field]
        ok = ours <= limit if kind == "max" else abs(ours - theirs) <= limit
        checks[field] = {"ours": ours, against: theirs, "limit": limit,
                         "kind": kind, "ok": bool(ok)}
        passed &= bool(ok)
    return {"fields": checks, "over": "all" if full else f"first {out['n']}",
            "passed": passed}


def read_scenarios(subset: bool, n: int | None = None):
    """(state, hpolys, seg) numpy arrays: the first n of the held-out set,
    or of SUBSET."""
    if not subset:
        sc = load_scenarios(n)
        return sc.state, sc.hpolys, sc.seg
    z = np.load(SUBSET)
    return tuple(z[k][:n] for k in ("state", "hpolys", "seg"))


def run(subset: bool = False, n: int | None = None, device=None,
        record_path: str | None = None, warmup: bool = True,
        log=print) -> dict:
    """The eval over the first n scenarios (all by default) in chunks of
    CHUNK (one chunk with `subset`).  Returns summarize's fields plus
    timing, launches per chunk, warm-up seconds, the device, the record's
    and the reference's paths, the gates (None without a record) and the
    share of scenarios whose flags equal the reference's (None with
    `subset`).  With `warmup`, on the card, one chunk of WARMUP_N
    scenarios runs first, so that the kernels' builds and the libraries'
    first calls stay out of the timed chunks.  On the card raises unless
    both kernels launched in every chunk."""
    dev = resolve_device(device)
    state, hpolys, seg = read_scenarios(subset, n)
    B = int(seg.shape[0])
    chunk = B if subset else CHUNK
    net = load_net(dev)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    seg_t = torch.as_tensor(seg, device=dev).long()
    state_t, hpolys_t = f32(state), f32(hpolys)
    warmup_s = None
    if warmup and dev.type == "cuda":
        t0 = time.perf_counter()
        w = slice(0, WARMUP_N)
        run_chunk(net, state_t[w], hpolys_t[w], seg_t[w])
        warmup_s = _sync(dev) - t0
    k1, l1 = admm_chunk.admm_chunk, ldl.ldl_block
    acc = {k: [] for k in ACC}
    chunks = []
    t_all = _sync(dev)
    for c0 in range(0, B, chunk):
        sl = slice(c0, c0 + chunk)
        n0, m0 = k1.launches, l1.launches
        arrays, sec = run_chunk(net, state_t[sl], hpolys_t[sl], seg_t[sl])
        launches = {"admm_chunk": k1.launches - n0,
                    "ldl_block": l1.launches - m0}
        if dev.type == "cuda" and min(launches.values()) < 1:
            raise RuntimeError(f"refine_eval: chunk {len(chunks) + 1} ran "
                               f"without launching both kernels: {launches}")
        for k in ACC:
            acc[k].append(arrays[k])
        rec = {"scenarios": int(arrays["ts0"].shape[0]),
               "wall_s": sum(sec.values()), **sec, "launches": launches}
        chunks.append(rec)
        log(json.dumps({"chunk_done": len(chunks), "of": -(-B // chunk),
                        **rec}))
    wall = _sync(dev) - t_all
    acc = {k: np.concatenate(v) for k, v in acc.items()}
    out = summarize(acc, subset, os.path.basename(latest_msgpack(WORKDIR)))
    out.update(
        wall_s=wall, scenarios_per_s=B / wall, chunks=chunks,
        warmup_s=warmup_s, device=device_line(dev), record=None,
        reference=None, gates=None, flags_agree=None)
    record_path = record_path or (SUBSET_RECORD if subset else RECORD)
    if os.path.exists(record_path):
        with open(record_path) as f:
            record = json.load(f)
        with open(REFERENCE) as f:
            reference = json.load(f)
        out["record"] = os.path.relpath(record_path, ROOT)
        out["reference"] = os.path.relpath(REFERENCE, ROOT)
        out["gates"] = gates(out, record, reference)
    if not subset and os.path.exists(REFERENCE_FLAGS):
        ref = np.load(REFERENCE_FLAGS)
        out["flags_agree"] = {k: float((acc[k] == ref[k][:B]).mean())
                              for k in ("solved0", "solved1", "improved")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--subset", action="store_true",
                    help="the 192 scenarios of runs/big3/eval_subset.npz")
    ap.add_argument("--n", type=int, default=None,
                    help="the first N scenarios (all by default)")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--record", default=None,
                    help="the record to gate against (results_full.json, "
                         "or results.json with --subset)")
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    out = run(a.subset, a.n, a.device, a.record,
              log=lambda s: print(s, flush=True))
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "chunks"}))
    return 0 if out["gates"] is None or out["gates"]["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
