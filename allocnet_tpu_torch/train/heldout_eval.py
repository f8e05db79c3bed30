#!/usr/bin/env python3
"""Held-out evaluation of the trained nets through the QP, on the card.

The port's counterpart of `scripts/eval_big.py` (one arm) and
`scripts/mcnemar_eval.py` (three arms, paired tests): each arm's latest
checkpoint (`runs/<arm>/checkpoints/checkpoint*.msgpack`, a hidden-256
ConvLSTM) at its calibrated stop-token threshold (`best_thresh` of
`runs/<arm>/calibration.json`) runs `evaluate.evaluate` with certificates
over the never-seen scenarios of `data/eval_fresh.npz` (2,000 certified
scenarios from map seeds 9000+), in batches of 256, at the scripts'
operating point `EVAL_CFG` (res 10, v <= 5 m/s, a <= 7 m/s^2, 4 polish
rounds, 3 x 250 ADMM iterations).  Each pair of arms gets the exact
two-sided McNemar test on the per-scenario solved and certified flags.

Beyond the scripts it holds the flags against the record
(`runs/mcnemar/per_scenario.npz`: agreement, discordant counts, rate
difference), times each arm (wall, solves per second, ms of each batch),
counts both kernels' launches per arm (K1 `admm_chunk`, L1 `ldl_block`;
on the card each must launch) and checks the gates of `GATES` against
`runs/mcnemar/results.json`.

    python -m allocnet_tpu_torch.train.heldout_eval [--arms big3,finetune,big4]
        [--n N] [--out PATH] [--record-dir DIR] [--device cpu]

The JSON goes to `--out` (default OUT, in the repository's git-ignored
output directory) with the per-scenario flags beside it
(`<out>_per_scenario.npz`).  Runs on the card unless `--device` says
otherwise; exits 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from allocnet_tpu_torch.config import (AllocNetConfig, ModelConfig, QPConfig,
                                       SolverConfig, TrainConfig)
from allocnet_tpu_torch.models import weights
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.ops import admm_chunk, ldl
from allocnet_tpu_torch.train import evaluate, trainer
from allocnet_tpu_torch.utils.device import device_line, resolve_device
from allocnet_tpu_torch.utils.scenarios import ScenarioBatch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE = os.path.join(ROOT, "data", "eval_fresh.npz")
RUNS = os.path.join(ROOT, "runs")
RECORD_DIR = os.path.join(RUNS, "mcnemar")
OUT = os.path.join(ROOT, "chiprun_out", "heldout_eval.json")

# the scripts' BASE: the training shapes with the certification-grade
# solver budget
EVAL_CFG = AllocNetConfig(
    qp=QPConfig(res=10, max_vel=5.0, max_acc=7.0),
    solver=SolverConfig(polish_rounds=4, iters_per_chunk=250),
    train=TrainConfig(batch_size=128),
    model=ModelConfig(hidden_size=256),
)
BATCH = 256
WARMUP_N = 8
ARMS = ("big3", "finetune", "big4")
PAIRS = (("finetune", "big3"),   # QP-gradient finetune vs supervised
         ("big4", "big3"),       # distilled flagship vs supervised
         ("big4", "finetune"))
FLAGS = ("solved", "certified")
# each arm against the record's: (report field, limit, kind); "abs" is
# |ours - record| <= limit, "rel" |ours - record| <= limit * |record|,
# "min" ours >= limit
GATES = (("stop_token_accuracy", 0.0025, "abs"),
         ("mean_time_ratio", 1e-4, "rel"),
         ("certified_of_solved", 0.999, "min"),
         ("success_rate", 0.02, "abs"))


def load_scenarios(n: int | None = None) -> ScenarioBatch:
    """The first n scenarios of CACHE (all by default)."""
    z = np.load(CACHE)
    return ScenarioBatch(*(z[k][:n] for k in ("state", "hpolys", "times",
                                              "seg")))


def calibrated_thresh(run_dir: str) -> float:
    with open(os.path.join(run_dir, "calibration.json")) as f:
        return float(json.load(f)["best_thresh"])


def latest_msgpack(run_dir: str) -> str:
    path = trainer.latest_checkpoint(os.path.join(run_dir, "checkpoints"),
                                     suffix=".msgpack")
    if path is None:
        raise FileNotFoundError(f"no checkpoint*.msgpack under {run_dir}")
    return path


def load_arm(run_dir: str, device=None) -> ConvLSTMAllocNet:
    """The arm's net: ConvLSTMAllocNet(5, 256, best_thresh) with the
    latest `.msgpack` checkpoint's parameters, on `device` (the card
    unless the caller asks for another)."""
    net = ConvLSTMAllocNet(5, 256, calibrated_thresh(run_dir))
    net.load_state_dict(weights.load_params(latest_msgpack(run_dir)))
    return net.to(resolve_device(device)).eval()


def arm_config(thresh: float) -> AllocNetConfig:
    return dataclasses.replace(EVAL_CFG, model=dataclasses.replace(
        EVAL_CFG.model, token_thresh=thresh))


def mcnemar(a: np.ndarray, b: np.ndarray) -> dict:
    """Exact two-sided McNemar test on paired boolean outcomes (the
    binomial test on the discordant pairs), rounded as the record is."""
    from scipy import stats

    a, b = np.asarray(a, bool), np.asarray(b, bool)
    disc_a = int(np.sum(a & ~b))       # a solves, b fails
    disc_b = int(np.sum(~a & b))
    n = disc_a + disc_b
    p = (min(1.0, 2.0 * stats.binom.cdf(min(disc_a, disc_b), n, 0.5))
         if n else 1.0)
    return {"b_only_first": disc_a, "c_only_second": disc_b,
            "p_two_sided": round(float(p), 5),
            "delta": round(float(a.mean() - b.mean()), 5)}


def compare_record(flags: dict, record) -> dict:
    """Each arm's flags ({arm: {"solved": (n,), "certified": (n,)}})
    against the record's (`record[f"{arm}_{flag}"]`, its first n):
    agreement, the scenarios only ours or only the record's flag holds,
    and our rate minus the record's.  Arms the record lacks are left
    out."""
    out = {}
    for arm, fl in flags.items():
        if f"{arm}_solved" not in record:
            continue
        out[arm] = {}
        for k in FLAGS:
            ours = np.asarray(fl[k], bool)
            rec = np.asarray(record[f"{arm}_{k}"], bool)[:len(ours)]
            out[arm][k] = {
                "agreement": float((ours == rec).mean()),
                "only_ours": int((ours & ~rec).sum()),
                "only_record": int((~ours & rec).sum()),
                "delta": float(ours.mean() - rec.mean())}
    return out


def gates(arms: dict, results: dict, record, n: int) -> dict:
    """GATES for each arm against the record (`results`: results.json,
    `record`: per_scenario.npz).  Over all of the record's scenarios every
    gate applies; over its first n < all only the success rate (against
    the record's flags on those n) and certified_of_solved do."""
    full = n == results["n"]
    out, passed = {}, True
    for arm, rep in arms.items():
        if arm not in results["arms"]:
            continue
        rec = dict(results["arms"][arm])
        if not full:
            rec = {"success_rate": float(np.asarray(
                record[f"{arm}_solved"], bool)[:n].mean()),
                "certified_of_solved": None}
        out[arm] = {}
        for field, limit, kind in GATES:
            if field not in rec:
                continue
            ours, theirs = rep[field], rec[field]
            if kind == "min":
                ok = ours >= limit
            elif kind == "abs":
                ok = abs(ours - theirs) <= limit
            else:
                ok = abs(ours - theirs) <= limit * abs(theirs)
            out[arm][field] = {"ours": ours, "record": theirs,
                               "limit": limit, "kind": kind, "ok": bool(ok)}
            passed &= bool(ok)
    return {"arms": out, "over": "all" if full else f"first {n}",
            "passed": passed}


def eval_arm(run_dir: str, sc: ScenarioBatch, device=None,
             thresh: float | None = None):
    """One arm over `sc` (at `thresh`, else its calibrated threshold):
    (EvalReport, per-scenario extras, timing, launches).  On the card both
    kernels must launch."""
    dev = resolve_device(device)
    net = load_arm(run_dir, dev)
    if thresh is not None:
        net.token_thresh = thresh
    cfg = arm_config(net.token_thresh)
    k1, l1 = admm_chunk.admm_chunk, ldl.ldl_block
    n0, m0 = k1.launches, l1.launches
    batch_ms = []
    t0 = time.perf_counter()
    rep, ex = evaluate.evaluate(net, cfg, sc, batch_size=BATCH,
                                certify=True, extras=True, device=dev,
                                batch_ms=batch_ms)
    wall = time.perf_counter() - t0
    launches = {"admm_chunk": k1.launches - n0, "ldl_block": l1.launches - m0}
    if dev.type == "cuda" and min(launches.values()) < 1:
        raise RuntimeError(f"heldout_eval: {run_dir} ran without launching "
                           f"both kernels: {launches}")
    timing = {"wall_s": wall, "solves_per_s": sc.state.shape[0] / wall,
              "batch_ms": batch_ms}
    return rep, ex, timing, launches


def read_record(record_dir: str):
    """(results.json, per_scenario.npz) of the record, or (None, None)."""
    res = os.path.join(record_dir, "results.json")
    per = os.path.join(record_dir, "per_scenario.npz")
    if not (os.path.exists(res) and os.path.exists(per)):
        return None, None
    with open(res) as f:
        return json.load(f), dict(np.load(per))


def run(arms=ARMS, n: int | None = None, device=None,
        record_dir: str = RECORD_DIR, warmup: bool = True,
        log=print) -> tuple[dict, dict]:
    """The arms (directories of RUNS) over the first n scenarios of CACHE
    (all by default).  Returns (the results.json fields plus checkpoints,
    warm-up seconds, timing, launches, device, record comparison and
    gates; the per-scenario flags by `{arm}_{flag}`).  With `warmup`, on
    the card, the first arm runs once on WARMUP_N scenarios before the
    timed arms, so that the kernels' builds and the libraries' first
    calls stay out of them (`warmup_s`; None otherwise)."""
    dev = resolve_device(device)
    sc = load_scenarios(n)
    n = int(sc.state.shape[0])
    warmup_s = None
    if warmup and dev.type == "cuda":
        t0 = time.perf_counter()
        eval_arm(os.path.join(RUNS, arms[0]), ScenarioBatch(
            *(a[:WARMUP_N] for a in sc)), dev)
        warmup_s = time.perf_counter() - t0
    reps, flags, timing, launches, ckpts = {}, {}, {}, {}, {}
    for arm in arms:
        run_dir = os.path.join(RUNS, arm)
        rep, ex, timing[arm], launches[arm] = eval_arm(run_dir, sc, dev)
        reps[arm] = dict(rep._asdict(),
                         token_thresh=calibrated_thresh(run_dir))
        flags[arm] = {k: ex[k] for k in FLAGS}
        ckpts[arm] = os.path.relpath(latest_msgpack(run_dir), ROOT)
        log(f"{arm}: thresh={reps[arm]['token_thresh']} success="
            f"{rep.success_rate:.4f} certified={rep.certified_frac:.4f} "
            f"stop-token={rep.stop_token_accuracy:.4f} "
            f"({os.path.basename(ckpts[arm])}); {timing[arm]['wall_s']:.2f} "
            f"s, {timing[arm]['solves_per_s']:.1f} solves/s; launches "
            f"{launches[arm]}")
    pairs = [(x, y) for x, y in PAIRS if x in flags and y in flags]
    out = {
        "n": n,
        "cache": "data/eval_fresh.npz (map seeds 9000+, never seen)",
        "arms": reps,
        **{f"mcnemar_{k}": {f"{x}_vs_{y}": mcnemar(flags[x][k], flags[y][k])
                            for x, y in pairs} for k in FLAGS},
        "checkpoints": ckpts, "warmup_s": warmup_s, "timing": timing,
        "launches": launches,
        "device": device_line(dev), "record": None, "gates": None,
    }
    results, record = read_record(record_dir)
    if results is not None:
        out["record"] = compare_record(flags, record)
        out["gates"] = gates(reps, results, record, n)
    per = {f"{arm}_{k}": flags[arm][k] for arm in flags for k in FLAGS}
    return out, per


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arms", default=",".join(ARMS),
                    help="comma-separated runs/ directories")
    ap.add_argument("--n", type=int, default=None,
                    help="the first N scenarios (all by default)")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--record-dir", default=RECORD_DIR,
                    help="results.json and per_scenario.npz of the record")
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    out, per = run(tuple(a.arms.split(",")), a.n, a.device, a.record_dir,
                   log=lambda s: print(s, flush=True))
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    stem = os.path.splitext(a.out)[0]
    np.savez(stem + "_per_scenario.npz", **per)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("arms", "timing")}))
    return 0 if out["gates"] is None or out["gates"]["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
