#!/usr/bin/env python3
"""The training chain on a corpus prefix, on the card, with its gates.

The stages of `scripts/round3_chain.sh` and `scripts/regen_data.sh` that
train, in one process, each at its script's configuration and full width
on the first N rows (25,600 by default) of the script's own corpus:

1. the prefix: `corpus.write_shards(n, per_map=250, seed0=1000)` and
   `corpus.combine` (the first maps of regen_data.sh's stage 1, seeds
   1000+, 30% pillar maps), maps 1000, 1030 and 1031 held row by row
   against the JAX package's CPU run of them (MAPS_RECORD);
2. `refine_targets.refine_corpus` over it (chunks of 512, CERTIFY_SOLVER,
   6 steps), a resume over the same parts and a refused one, and the
   first 512 rows of `data/eval_fresh.npz` at their stored times as one
   chunk against the JAX package's CPU run (REFINE_REF);
3. `calibrate_thresh.calibrate` of the three shipped arms (`runs/big3`,
   `runs/finetune`, `runs/big4`) on the prefix's validation rows, the
   held-out touch against `heldout_eval.eval_arm` at the same threshold,
   and each arm's grid over the JAX package's CPU rows of maps 1000, 1030
   and 1031 (MAPS_ROWS) against the JAX package's grid on them;
4. `train_big.train` from scratch, one epoch each: big3 at init seeds 0
   and 1, big4 (the refined targets) at seed 0, and big3 with PyTorch's
   default init (ungated, to show whether the windows separate inits);
5. `finetune_qp.finetune`, one epoch from `runs/big3`'s committed
   checkpoint, and the committed big3 over eval_fresh at 0.42 beside it;
   then FT_REF_STEPS steps of the fine-tune on MAPS_ROWS, the batches of
   the JAX package's CPU run recorded in MAPS_RECORD.

Then each kernel at the chain's new shapes (K1 at B=128 x 100 and at
B=512 x 250, res 10; L1 at B=128 and B=512) against its plain version,
timed against its bound.  GATES below; JSON to `--out` with every stage's
outputs, seconds, ms per training step and launches per stage; exits 1
when a gate fails.

    python -m allocnet_tpu_torch.train.chain [--n 25600] [--out PATH]
        [--device cpu] [--reference-only]

`--n` cuts the prefix (windows the run's steps do not reach go ungated);
`--reference-only` runs gate (b)'s REF_N reference rows alone;
`run(chunk=C, eval_n=N)` cuts a CPU rehearsal further (a smaller refine
chunk, the first N held-out rows).  Work files go to a temporary
directory.  Runs on the card unless `--device` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.ops import admm, admm_chunk, ldl, qp
from allocnet_tpu_torch.train import (calibrate_thresh, corpus, datagen,
                                      dataset, finetune_qp, heldout_eval,
                                      refine_targets, train_big)
from allocnet_tpu_torch.train import train_step as ts_lib
from allocnet_tpu_torch.utils import kernel_bench, witness
from allocnet_tpu_torch.utils.device import device_line, resolve_device
from allocnet_tpu_torch.utils.scenarios import ScenarioBatch

ROOT = train_big.ROOT
OUT = os.path.join(ROOT, "chiprun_out", "chain.json")
RECORDS = os.path.join(ROOT, "tests", "records", "train_chain_records.json")
REFINE_REF = os.path.join(ROOT, "tests", "records",
                          "refine_targets_jax_cpu.npz")
CPU_CURVES = os.path.join(ROOT, "tests", "records", "train_chain_cpu.json")
# the JAX package's CPU run of gen_dataset.py's maps 1000, 1030 and 1031
# at 250 a map, the shipped arms' calibration grids over their certified
# rows and the fine-tune's first steps on them (tests/jax_chain_record.py
# maps)
MAPS_RECORD = os.path.join(ROOT, "tests", "records", "chain_maps_jax_cpu.json")
MAPS_ROWS = os.path.join(ROOT, "tests", "records", "chain_maps_jax_cpu.npz")
FT_REF_STEPS = 10
# the CPU curves from scratch at the JAX init (tests/jax_chain_record.py):
# two JAX seeds and two of the port's; their spread widens gate d's bands
SPREAD_RUNS = ("jax_0", "jax_1", "port_0", "port_1")
SPREAD_WINDOW = {"1-10": "1-10", "11-90": "11-40", "91-180": "11-40"}
N, PER_MAP, SEED0 = 25600, 250, 1000
EPOCHS = 1                # per training run
REF_N = 512
ARMS = heldout_eval.ARMS
# (name, arm, init seed, init): the from-scratch runs; the last ungated
RUNS = (("big3_seed0", "big3", 0, "jax"), ("big3_seed1", "big3", 1, "jax"),
        ("big4_seed0", "big4", 0, "jax"),
        ("big3_default_init", "big3", 0, "default"))
WINDOWS = ((1, 10), (11, 90), (91, 180))
FT_WINDOWS = ((1, 10), (11, 90))
LOSSES, ACCS = ("obj", "stop"), ("time_segment_accuracy",)
FT_LOSSES, FT_ACCS = ("obj",), ("time_segment_accuracy",)
GRID_GATED = ("stop_token_accuracy",)
MAPS_GATED = ("success_rate", "stop_token_accuracy")
FT_REF_FIELDS = ("obj", "success_rate", "time_segment_accuracy")

# GATES, fixed before the first run on the card (PERF.md section 6):
# a. prefix: on the card every map that reached the certification launched
#    K1 4 and L1 48 times (`corpus.launch_gate`); the first F64_ROWS
#    certified rows of every map pass the solved test in float64, the
#    certification solved again giving the same flags; the maps of
#    MAPS_RECORD that the prefix generates, row by row against the JAX
#    package's CPU run (`corpus.scenario_gates`: differences at most
#    corpus.MAX_DIFF_SHARE of the map's rows + MAX_DIFF_SLACK, each
#    witnessed beside its control; added after the fourth run on the
#    card, to show whether the card's ~175 certified of 250 a map, where
#    the TPU corpus has 250, is the port's: the JAX package's CPU run
#    certifies 187, 183 and 198 of 250 on those maps, the port's CPU run
#    187, 182 and 203);
# b. refinement: the contract on every row of the prefix (an improved row's
#    objective fell and its total time is kept to TOTAL_RTOL relative; an
#    unimproved row and every padding slot byte-equal to the input); a
#    second run over the same parts computes no chunk and assembles the
#    same arrays, byte for byte; a run at another chunk is refused; on the
#    REF_N reference rows each improved flag equals the JAX CPU run's
#    except where it moves under `witness.flag_moves` (rounds from
#    WITNESS_ROUND, at most WITNESS_DRAWS, on the run's device), beside a
#    control of agreeing rows (corpus.CONTROL_PER_ROW per row, at least
#    corpus.CONTROL_MIN_ROWS, moving on at most corpus.CONTROL_MAX); a row
#    the draws leave fails the gate unless REFINE_UNWITNESSED lists it
#    with its evidence; `rel`
#    within REL_TOL on at least REL_SHARE of the rows both runs improve,
#    and the improved fraction and rel's mean and median within STAT_TOL
#    of the JAX CPU run's.  Changed from the first proposal (rel within
#    1e-3 on every agreeing row) before the first run on the card: the
#    port's CPU run of the same 512 rows (tests/jax_chain_record.py
#    refine-port) parts from the JAX CPU run on 15 flags and puts rel
#    beyond 1e-3 on 67 of the 465 rows both improve (0.856 within), by up
#    to 0.74: a different accept or reject at one of the 6 steps, or a
#    different solved flag at the input (rel 0), changes rel by the whole
#    step; its statistics agree (improved 0.9277 / 0.9180, mean 0.3236 /
#    0.3237, median 0.2664 / 0.2614);
# c. calibration: each arm's grid row at each threshold within GRID_TOL of
#    the record's in stop-token accuracy (GRID_GATED); the held-out touch's
#    flags equal `heldout_eval.eval_arm`'s at the chosen threshold, row
#    for row; each arm's grid over MAPS_ROWS within GRID_TOL of the JAX
#    package's CPU grid over the same rows in success and stop-token
#    accuracy (MAPS_GATED).  The prefix grid's success stands beside the
#    TPU record's, ungated: the record's rows are the TPU corpus's, 250
#    certified on every map (runs/big/dataset.json: 50,000 in 200
#    shards), which the JAX package as it stands does not give back
#    (a. above: ~75% certify on the CPU); every arm's success sat
#    0.02-0.05 under the record's on the prefix (big4 0.0505 and 0.051
#    at 0.5 and 0.6), as the JAX package's own grid over its rows of
#    maps 1000, 1030 and 1031 does (MAPS_RECORD).  Changed after the
#    second and third runs on the card (the first proposal: success within
#    GRID_TOL of the TPU record's);
# d. from scratch (big3 seeds 0 and 1, big4 seed 0): no non-finite loss;
#    each window's mean of LOSSES within BAND_LOSS (relative) outside the
#    span of the two records' means and of ACCS within BAND_ACC
#    (absolute), each band widened to the spread of the four CPU runs
#    from scratch at the JAX init (SPREAD_RUNS: (max - min) / mean of a
#    loss, max - min of an accuracy, over their SPREAD_WINDOW) where that
#    is wider: the two records share one init draw (JAX seed 0), which
#    the CPU runs show to be the slowest of four; the 1-10 window's loss
#    band widens to the card's two seeds' relative spread at step 1 when
#    that is wider still.  The port's runs start from the JAX seeds' very
#    weights (train_step.init_params), so the four runs are two draws,
#    each run on both sides;
# e. fine-tune: each window's mean of FT_LOSSES within FT_LOSS (relative)
#    of the record's, of FT_ACCS within FT_ACC; eval_fresh success at 0.42
#    within FT_EVAL_TOL of the committed big3's over the same rows; the
#    first FT_REF_STEPS steps on MAPS_ROWS (the JAX CPU run's batches)
#    within FT_LOSS in obj and FT_ACC in success and accuracy of that
#    run's.  The prefix windows' success stands beside the TPU record's,
#    ungated, for (c)'s reason (0.3633 over 1-10 against the record's
#    0.3953 in the fourth run on the card; the JAX package's CPU run on
#    eval_fresh's rows 0.356, on MAPS_ROWS in MAPS_RECORD).  Changed after
#    the second run on the card (the first proposal: success within FT_ACC
#    of the TPU record's);
# f. launches: every stage's K1 and L1 counts equal what its code gives
#    (`refine_targets.chunk_launches` per chunk, `admm.solve_launches` per
#    eval batch, training step and validation batch); on the card only.
F64_ROWS = 32
TOTAL_RTOL = 1e-5
WITNESS_ROUND, WITNESS_DRAWS, WITNESS_SEED = 8, 64, 13
# reference rows whose improved flag differs from the JAX CPU run's and
# that no draw on the card moved, each with what is known of it
REFINE_UNWITNESSED = {
    202: "card and port CPU unimproved, JAX CPU improved; 64 draws of "
         "+-1e-6 on the card leave the flag.  The port's CPU solve of the "
         "row at its stored times is solved at B = 1 and unsolved at B = 2 "
         "(dual residual 0.58): its ADMM is bit-equal at both, the plain "
         "chunk summing each scenario in one order whatever the batch "
         "(tests/test_torch_train_chain.py::test_row202_admm_reads_no_"
         "batch_mate); the polish's batched products part.  Elementwise "
         "products in the polish make the row solved at every B, and move "
         "2-3% of other marginal flags (tests/batch_order_check.py).",
}
REL_TOL, REL_SHARE, STAT_TOL = 1e-3, 0.80, 0.03
GRID_TOL = 0.05
BAND_LOSS, BAND_ACC = 0.25, 0.08
FT_LOSS, FT_ACC = 0.10, 0.03
FT_EVAL_TOL = 0.02
MAX_WITNESS_BATCH = 1024
LDL_REPS = 20


def _check(checks: dict, name: str, ok: bool, **detail) -> None:
    checks[name] = {"ok": bool(ok), **detail}


def _sync(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def read_records(path: str = RECORDS) -> dict:
    with open(path) as f:
        return json.load(f)


def read_maps_record(path: str = MAPS_RECORD) -> dict:
    with open(path) as f:
        return json.load(f)


def windows(steps: list, bounds=WINDOWS) -> dict:
    """Means of each field over each window the steps cover whole."""
    out = {}
    for a, b in bounds:
        w = [r for r in steps if a <= r["step"] <= b]
        if len(w) == b - a + 1:
            out[f"{a}-{b}"] = {k: float(np.mean([r[k] for r in w]))
                               for k in w[0] if k not in ("epoch", "step")}
    return out


# ---- a. the prefix ---------------------------------------------------------

def f64_first(rec: dict, k: int, device=None) -> dict:
    """The first k certified rows of a generate record in float64: the
    certification solved again on `device` (flags repeated?) and those
    rows' solution re-evaluated on the CPU."""
    batch, flags = rec["batch"], np.asarray(rec["flags"], bool)
    idx = np.nonzero(flags)[0][:k]
    if not len(idx):
        return {"rows": 0, "failing": [], "repeat_equal": True}
    sol = datagen.certify_solve(corpus.GEN_CFG, batch, device)
    repeat = bool((sol.solved.cpu().numpy()[:len(flags)] == flags).all())
    sub = ScenarioBatch(*(a[idx] for a in batch))
    ok = datagen.solved_in_f64(corpus.GEN_CFG, sub, corpus._rows_of(
        sol, torch.as_tensor(idx).to(sol.solved.device)))
    return {"rows": int(len(idx)), "failing": idx[~ok].tolist(),
            "repeat_equal": repeat}


def prefix_gates(checks: dict, entries: list, f64: dict, cuda: bool) -> None:
    """(a) the launches per map (on the card) and the float64 rows."""
    if cuda:
        corpus.launch_gate(checks, entries)
    bad = {s: r["failing"] for s, r in f64.items() if r["failing"]}
    rep = [s for s, r in f64.items() if not r["repeat_equal"]]
    _check(checks, "prefix_first_rows_f64", not bad and not rep and f64,
           maps=len(f64), rows=sum(r["rows"] for r in f64.values()),
           failing=bad, flags_not_repeated=rep, per_map=F64_ROWS)


def maps_gates(checks: dict, entries: list, records: list, ref: dict, dev,
               log) -> None:
    """(a) the prefix's maps that MAPS_RECORD holds (at its request)
    against the JAX package's CPU run, row by row (`corpus.
    scenario_gates`, the card's draws first), and a check that every
    recorded map up to the prefix's last was gated."""
    got = corpus.scenario_gates(entries, records, ref, dev, log,
                                card_first=torch.device(dev).type == "cuda")
    checks.update({f"prefix_vs_jax_{k}": v for k, v in got.items()})
    last = max((e["map"] for e in entries), default=-1)
    want = sorted(m["seed"] for m in ref["full"]["maps"] if m["seed"] <= last)
    gated = sorted(int(k[4:]) for k in got if k.startswith("map_"))
    _check(checks, "prefix_vs_jax_maps", gated == want, gated=gated,
           want=want)


def make_prefix(n: int, dev, log, work: str,
                maps_ref: dict) -> tuple[str, dict, dict]:
    shards = os.path.join(work, "shards")
    records = []
    t0 = time.perf_counter()
    gen = corpus.write_shards(shards, n, PER_MAP, SEED0, device=dev,
                              records=records, log=log)
    path = os.path.join(work, "big100k_combined.npz")
    comb = corpus.combine([shards], path)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    entries = [e for e in gen["maps"] if not e.get("resumed")]
    f64 = {e["map"]: f64_first(r, F64_ROWS, dev)
           for e, r in zip(entries, records)}
    checks = {}
    maps_gates(checks, entries, records, maps_ref, dev, log)
    maps = gen["maps"]
    certified = sum(e["samples"] for e in maps)
    out = {"maps": [{k: e[k] for k in ("map", "plain", "samples", "map_s",
                                        "request", "candidates",
                                        "to_certify", "k1", "l1",
                                        "vs_reference")
                     if k in e} for e in maps],
           "n": comb["n"], "seg_hist": comb["seg_hist"],
           "pillar_rows": int(sum(e["samples"] for e in maps
                                  if e.get("plain"))),
           "generate_s": gen_s, "s_per_sample": gen_s / max(certified, 1),
           "f64_s": time.perf_counter() - t0, "f64": f64,
           "launches": {"k1": sum(e.get("k1", 0) for e in maps),
                        "l1": sum(e.get("l1", 0) for e in maps)}}
    log(json.dumps({k: out[k] for k in ("n", "seg_hist", "pillar_rows",
                                        "generate_s", "s_per_sample",
                                        "launches")}))
    return path, out, checks


# ---- b. the refinement -----------------------------------------------------

def contract_gate(checks: dict, src: ScenarioBatch, times: np.ndarray,
                  improved: np.ndarray, obj0: np.ndarray,
                  obj: np.ndarray) -> None:
    """(b) an improved row's objective fell and its total time is kept;
    every other row and every padding slot keeps its bytes."""
    S = src.times.shape[1]
    live = np.arange(S)[None] < src.seg[:, None]
    imp = np.asarray(improved, bool)
    fell = obj[imp] < obj0[imp]
    tot0 = (src.times * live).sum(1, dtype=np.float64)
    tot1 = (times * live).sum(1, dtype=np.float64)
    drift = np.abs(tot1 - tot0) / np.maximum(np.abs(tot0), 1e-12)
    same = lambda a, b: a.astype(np.float32).view(np.int32) == \
        b.astype(np.float32).view(np.int32)
    eq = same(times, src.times)
    bad_rows = np.nonzero(~imp & ~eq.all(1))[0]
    bad_pad = np.nonzero((~live & ~eq).any(1))[0]
    _check(checks, "refine_contract",
           bool(fell.all()) and float(drift[imp].max(initial=0.0))
           <= TOTAL_RTOL and not len(bad_rows) and not len(bad_pad),
           rows=int(len(imp)), improved=int(imp.sum()),
           objective_not_fell=np.nonzero(imp)[0][~fell].tolist()[:20],
           max_total_rel_drift=float(drift[imp].max(initial=0.0)),
           limit=TOTAL_RTOL, unimproved_changed=bad_rows.tolist()[:20],
           padding_changed=bad_pad.tolist()[:20])


def resume_gate(checks: dict, computed: int, same: bool,
                refused: bool) -> None:
    _check(checks, "refine_resume", computed == 0 and same and refused,
           chunks_computed_again=computed, same_arrays=same,
           other_chunk_refused=refused)


def refine_flags(sc: ScenarioBatch, steps: int, dev) -> np.ndarray:
    """The refinement's improved flags of every row of `sc`, in batches of
    at most MAX_WITNESS_BATCH rows."""
    out = []
    for s in range(0, len(sc.seg), MAX_WITNESS_BATCH):
        ip = np.arange(s, min(s + MAX_WITNESS_BATCH, len(sc.seg)))
        out.append(refine_targets.refine_rows(sc, ip, steps, dev)
                   ["improved"])
    return np.concatenate(out)


def _draw_rows(sc: ScenarioBatch, rows, pool, steps: int, dev, seed: int,
               most: int) -> dict:
    """`witness.flag_moves` (on `dev`, at most `most` draws) of the
    improved flags of `rows` and of a control drawn from `pool` (rows on
    which both runs agree)."""
    rows = np.asarray(rows, int)
    rng = np.random.default_rng(seed)
    n_ctrl = min(max(corpus.CONTROL_PER_ROW * len(rows),
                     corpus.CONTROL_MIN_ROWS), len(pool))
    ctrl = (np.sort(rng.choice(pool, n_ctrl, replace=False)) if len(rows)
            else np.zeros(0, int))
    both = np.concatenate([rows, ctrl]).astype(int)
    if not len(both):
        return {"moves": [], "control": [0, 0], "unwitnessed": []}
    moves, draws = witness.flag_moves(
        lambda b: refine_flags(b, steps, dev), sc, both,
        [(seed, int(i)) for i in both], WITNESS_ROUND, most)
    n = len(rows)
    return {"moves": [[int(i), int(m), int(d)] for i, m, d in
                      zip(rows, moves[:n], draws[:n])],
            "control": [int((moves[n:] > 0).sum()), int(len(ctrl))],
            "unwitnessed": [int(i) for i, m in zip(rows, moves[:n])
                            if not m]}


def reference_gate(checks: dict, ours: dict, ref, wit: dict) -> None:
    """(b) the reference rows against the JAX CPU run (None: missing)."""
    if ref is None:
        _check(checks, "refine_reference", False, missing=REFINE_REF)
        return
    imp, rimp = np.asarray(ours["improved"], bool), ref["improved"]
    differ = np.nonzero(imp != rimp)[0]
    both = imp & rimp
    d = np.abs(ours["rel"] - ref["rel"])[both]
    within = float((d <= REL_TOL).mean()) if both.any() else 1.0
    ctl, rows = wit["control"]
    ctl_ok = rows < corpus.CONTROL_MIN_ROWS or ctl <= corpus.CONTROL_MAX * rows
    unknown = [i for i in wit["unwitnessed"] if i not in REFINE_UNWITNESSED]
    stats = {k: [float(f(a)), float(f(b))] for k, f, a, b in (
        ("improved_frac", np.mean, imp, rimp),
        ("rel_obj_reduction_mean", np.mean, ours["rel"], ref["rel"]),
        ("rel_obj_reduction_median", np.median, ours["rel"], ref["rel"]))}
    stats_ok = all(abs(a - b) <= STAT_TOL for a, b in stats.values())
    _check(checks, "refine_reference",
           not unknown and ctl_ok and within >= REL_SHARE and stats_ok,
           rows=int(len(imp)), improved=int(imp.sum()),
           reference_improved=int(rimp.sum()), differ=differ.tolist(),
           unwitnessed=wit["unwitnessed"],
           explained={i: REFINE_UNWITNESSED[i] for i in wit["unwitnessed"]
                      if i in REFINE_UNWITNESSED},
           control={"moved": ctl, "rows": rows},
           control_limit=corpus.CONTROL_MAX,
           rel_within=within, rel_tol=REL_TOL, rel_share=REL_SHARE,
           rel_max_diff=float(d.max(initial=0.0)),
           stats_ours_reference=stats, stat_tol=STAT_TOL)


def refinement(src: str, dev, chunk: int, log, work: str) -> dict:
    out = os.path.join(work, "big100k_refined.npz")
    steps = refine_targets.STEPS
    first = refine_targets.refine_corpus(src, out, chunk, steps, dev, log)
    sc = refine_targets.read_corpus(src)
    got = refine_targets.assemble(sc, out, chunk, steps)
    arrays = {k: v for k, v in np.load(out).items()}
    # a second run over the same parts, then one at another chunk
    os.remove(out)
    again = refine_targets.refine_corpus(src, out, chunk, steps, dev, log)
    same = all(np.load(out)[k].tobytes() == v.tobytes()
               for k, v in arrays.items())
    os.remove(out)
    try:
        refine_targets.refine_corpus(src, out, max(chunk // 2, 1), steps,
                                     dev, log)
        refused = False
    except SystemExit as e:
        refused = True
        log(f"refused: {e}")
    if not os.path.exists(out):
        refine_targets.refine_corpus(src, out, chunk, steps, dev, log)
    return {"first": first, "again": {k: again[k] for k in
                                      ("computed", "resumed")},
            "same_arrays": same, "refused": refused, "sc": sc,
            "assembled": got, "path": out}


def reference_rows(dev, steps: int, log) -> tuple[dict, dict, dict]:
    """The REF_N reference rows as one chunk on `dev`, the JAX CPU run and
    the witnesses of the rows that differ."""
    sc = refine_targets.read_corpus(heldout_eval.CACHE)
    sc = ScenarioBatch(*(a[:REF_N] for a in sc))
    t0 = _sync(dev)
    ours = refine_targets.refine_rows(sc, np.arange(REF_N), steps, dev)
    ms = (_sync(dev) - t0) * 1e3
    imp = np.asarray(ours["improved"], bool)
    if not os.path.exists(REFINE_REF):
        log(f"no record {REFINE_REF}: the reference rows go unchecked")
        return ours, None, {"ms": ms, "witness": None}
    ref = np.load(REFINE_REF)
    rimp = ref["improved"][:REF_N]
    differ = np.nonzero(imp != rimp)[0]
    pool = np.nonzero(imp == rimp)[0]
    t0 = time.perf_counter()
    wit = _draw_rows(sc, differ, pool, steps, dev, WITNESS_SEED,
                     WITNESS_DRAWS)
    wit["s"] = time.perf_counter() - t0
    log(f"reference rows: {int(imp.sum())} improved (JAX CPU "
        f"{int(rimp.sum())}), {len(differ)} differ; witnesses "
        + json.dumps(wit))
    stats = json.loads(str(ref["stats"]))
    return ours, {k: ref[k][:REF_N] for k in ("improved", "rel")}, {
        "ms": ms, "witness": wit, "jax_cpu_stats": stats,
        "ours": {"improved_frac": float(imp.mean()),
                 "rel_obj_reduction_mean": float(ours["rel"].mean()),
                 "rel_obj_reduction_median": float(np.median(ours["rel"]))}}


# ---- c. calibration --------------------------------------------------------

def _grid_far(grid: list, record: list, fields) -> tuple[list, list]:
    """([threshold, field, ours, the record's] beyond GRID_TOL, thresholds
    the record lacks)."""
    by = {r["token_thresh"]: r for r in record}
    far = [[r["token_thresh"], k, r[k], by[r["token_thresh"]][k]]
           for r in grid if r["token_thresh"] in by for k in fields
           if abs(r[k] - by[r["token_thresh"]][k]) > GRID_TOL]
    return far, [r["token_thresh"] for r in grid
                 if r["token_thresh"] not in by]


def calibration_gate(checks: dict, arm: str, grid: list, record: list,
                     touch: np.ndarray, eval_arm: np.ndarray) -> None:
    """(c) each grid row against the record's at its threshold
    (GRID_GATED); the held-out touch's flags against eval_arm's."""
    far, missing = _grid_far(grid, record, GRID_GATED)
    rows = np.nonzero(np.asarray(touch, bool) != np.asarray(eval_arm, bool))[0]
    _check(checks, f"calibration_{arm}",
           grid and not missing and not far and not len(rows),
           beyond=far, not_in_record=missing, tol=GRID_TOL,
           touch_vs_eval_arm=rows.tolist()[:20])


def maps_calibration_gate(checks: dict, arm: str, grid: list,
                          record: list) -> None:
    """(c) the arm's grid over MAPS_ROWS against the JAX package's
    (MAPS_GATED), every threshold of the record present."""
    far, missing = _grid_far(grid, record, MAPS_GATED)
    have = {r["token_thresh"] for r in grid}
    absent = [r["token_thresh"] for r in record if r["token_thresh"]
              not in have]
    _check(checks, f"calibration_maps_{arm}",
           grid and not far and not missing and not absent, beyond=far,
           not_in_record=missing, not_run=absent, tol=GRID_TOL,
           fields=list(MAPS_GATED))


# ---- d, e. training --------------------------------------------------------

def band(values: list, loss: bool, widen: float = 0.0) -> tuple:
    lo, hi = min(values), max(values)
    if loss:
        rel = max(BAND_LOSS, widen)
        return lo * (1 - rel), hi * (1 + rel)
    rel = max(BAND_ACC, widen)
    return lo - rel, hi + rel


def cpu_spread(path: str = CPU_CURVES) -> dict:
    """{window: {field: spread}} of the SPREAD_RUNS CPU curves over each
    window's SPREAD_WINDOW: (max - min) / mean for a loss, max - min for
    an accuracy."""
    with open(path) as f:
        curves = json.load(f)["curves"]
    out = {}
    for w, cw in SPREAD_WINDOW.items():
        out[w] = {}
        for k in LOSSES + ACCS:
            v = [curves[r]["windows"][cw][k] for r in SPREAD_RUNS]
            out[w][k] = ((max(v) - min(v)) / np.mean(v) if k in LOSSES
                         else max(v) - min(v))
    return out


def scratch_gate(checks: dict, name: str, steps: list, rec: dict,
                 spread: float = 0.0, widen: dict | None = None) -> dict:
    """(d) one from-scratch run against the two records' windows; `widen`
    ({window: {field: spread}}, `cpu_spread`) widens the bands, `spread`
    (the card's seeds at step 1) the 1-10 window's losses."""
    win = windows(steps)
    finite = all(np.isfinite(r[k]) for r in steps for k in r
                 if k not in ("epoch", "step"))
    widen = widen or {}
    out = {}
    for w, fields in win.items():
        for k in LOSSES + ACCS:
            wd = widen.get(w, {}).get(k, 0.0)
            if w == "1-10" and k in LOSSES:
                wd = max(wd, spread)
            lo, hi = band([rec["big3"][w][k], rec["big4"][w][k]],
                          k in LOSSES, wd)
            out[f"{w} {k}"] = [fields[k], lo, hi, lo <= fields[k] <= hi]
    _check(checks, f"scratch_{name}", finite and all(
        v[3] for v in out.values()) and len(win) > 0, finite=finite,
        windows=out, band_loss=BAND_LOSS, band_acc=BAND_ACC,
        step1_spread=spread, widen=widen)
    return win


def finetune_gate(checks: dict, steps: list, rec: dict, success: float,
                  big3_success: float) -> dict:
    """(e) the fine-tune's windows against the record's; its eval_fresh
    success against the committed big3's."""
    win = windows(steps, FT_WINDOWS)
    finite = all(np.isfinite(r[k]) for r in steps for k in r
                 if k not in ("epoch", "step"))
    out = {}
    for w, fields in win.items():
        for k in FT_LOSSES + FT_ACCS:
            r = rec[w][k]
            lo, hi = ((r * (1 - FT_LOSS), r * (1 + FT_LOSS)) if k in FT_LOSSES
                      else (r - FT_ACC, r + FT_ACC))
            out[f"{w} {k}"] = [fields[k], lo, hi, lo <= fields[k] <= hi]
    ev_ok = abs(success - big3_success) <= FT_EVAL_TOL
    _check(checks, "finetune", finite and ev_ok and len(win) > 0 and all(
        v[3] for v in out.values()), finite=finite, windows=out,
        eval_fresh_success=success, big3_success=big3_success,
        eval_tol=FT_EVAL_TOL)
    return win


def finetune_steps(path: str, n: int, dev) -> list:
    """The first n steps of finetune_qp's cfg from runs/big3's params (a
    fresh Adam and schedule) on the rows of `path` as the corpus, the
    batches of `Loader(seed=0)`'s train epochs in turn (those of
    tests/jax_chain_record.py's run): per step the loss fields."""
    cfg = finetune_qp.CFG
    loader = dataset.Loader(dataset.read_npz(path),
                            batch_size=cfg.train.batch_size, seed=0)
    net = ConvLSTMAllocNet(cfg.model.seq_len, cfg.model.hidden_size,
                           cfg.model.token_thresh)
    net.load_state_dict(calibrate_thresh.read_params(calibrate_thresh.latest(
        finetune_qp.START))[0])
    net = net.to(dev)
    opt, sched = ts_lib.make_optimizer(net, cfg.train)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    if len(loader.train_idx) < cfg.train.batch_size:
        raise ValueError(f"{path}: no training batch of "
                         f"{cfg.train.batch_size}")
    out, epoch = [], 0
    while len(out) < n:
        for b in loader.epoch(epoch, "train"):
            if len(out) == n:
                break
            bb = ts_lib.train_step(
                net, opt, sched, cfg.qp, cfg.solver, cfg.loss, t(b.state),
                t(b.hpolys), torch.as_tensor(b.seg, device=dev).long(),
                t(b.ref_times), token_thresh=cfg.model.token_thresh)
            out.append({"step": len(out) + 1, "obj": float(bb.total),
                        **{k: float(getattr(bb, k)) for k in (
                            "obj1", "objt", "objc", "stop", "success_rate",
                            "time_segment_accuracy")}})
        epoch += 1
    return out


def finetune_maps_gate(checks: dict, steps: list, record: dict) -> dict:
    """(e) the fine-tune's first steps on MAPS_ROWS against the JAX
    package's CPU run on the same batches."""
    win = windows(steps, ((1, FT_REF_STEPS),))
    key = f"1-{FT_REF_STEPS}"
    ref = record["windows"][key]
    out = {}
    for k in FT_REF_FIELDS:
        r = ref[k]
        lo, hi = ((r * (1 - FT_LOSS), r * (1 + FT_LOSS)) if k == "obj"
                  else (r - FT_ACC, r + FT_ACC))
        v = win.get(key, {}).get(k, float("nan"))
        out[k] = [v, lo, hi, lo <= v <= hi]
    _check(checks, "finetune_maps", len(steps) == FT_REF_STEPS and all(
        v[3] for v in out.values()), window=out, steps=len(steps))
    return win


def launch_gate(checks: dict, name: str, got: tuple, want: tuple) -> None:
    """(f) a stage's (K1, L1) launches equal what its code gives."""
    _check(checks, f"launches_{name}", tuple(got) == tuple(want),
           got=list(got), want=list(want))


def train_launches(r: dict) -> tuple:
    """(K1, L1) that a train_big / finetune_qp result must have launched:
    per training step and validation batch one forward solve at the
    training budget (its implicit backward launches neither), then one
    solve per eval batch."""
    k, l = admm.solve_launches(train_big.CFG.qp, train_big.CFG.solver)
    ek, el = admm.solve_launches(train_big.CFG.qp, train_big.EVAL_SOLVER)
    t, e = r["train"], r["eval"]
    solves = t["steps"] + t["val_batches"]
    return (solves * k, solves * l), (e["batches"] * ek, e["batches"] * el)


# ---- the kernels at the chain's shapes -------------------------------------

def record_solve(cfg, sc: ScenarioBatch, dev):
    """The K1 arguments of the first chunk of a cold solve of `sc` at
    `cfg` (its stored times; `admm_chunk.chunk_inputs`) and the first
    diagonal block that the solve's polish gives L1."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    data = qp.build_qp(cfg.qp, t(sc.state), t(sc.hpolys), t(sc.times),
                       torch.as_tensor(sc.seg, device=dev).long(),
                       device=dev)
    s = cfg.solver
    args = list(admm_chunk.chunk_inputs(data, s)) + [
        s.iters_per_chunk, s.sigma, s.alpha]
    with kernel_bench.first_ldl_block(ldl, []) as blocks:
        admm.solve_qp(data, s)
    return args, blocks[0]


def l1_numbers(Kb, sg, reg, tag: str, log) -> dict:
    """L1 against its plain version on the blocks (Kb, sg, reg), exactly
    (kernel_bench.ldl_compare), its ms in a CUDA graph and eager, the plain
    version's ms and the bound (kernel_bench.ldl_work)."""
    from allocnet_tpu_torch.utils import bench_ldl

    kb = kernel_bench
    same, bits, absd, _ = kb.ldl_compare(
        ldl.ldl_block(Kb, sg, reg), ldl.ldl_block_reference(Kb, sg, reg),
        reg, tag)
    ops, nbytes = kb.ldl_work(Kb.shape[0], Kb.shape[1])
    t_ops, t_bytes = (ops / kb.PEAK_F32_FLOPS * 1e3,
                      nbytes / kb.PEAK_BYTES * 1e3)
    l1 = {"B": int(Kb.shape[0]),
          "ms": bench_ldl.graph_ms(lambda: ldl.ldl_block(Kb, sg, reg),
                                   reps=LDL_REPS),
          "eager_ms": kb.cuda_ms(lambda: ldl.ldl_block(Kb, sg, reg),
                                 reps=LDL_REPS, warmup=2),
          "plain_ms": kb.cuda_ms(
              lambda: ldl.ldl_block_reference(Kb, sg, reg), reps=3),
          "bound_ms": max(t_ops, t_bytes),
          "bound_by": "operations" if t_ops >= t_bytes else "bytes",
          "equal": same, "bit_patterns": bits, "max_abs_err": absd}
    log(f"ldl_block at the {tag}: {json.dumps(l1)}")
    return l1


def kernel_shapes(sc: ScenarioBatch, dev, log) -> dict:
    """K1 and L1 at the training step's batch (B=128, 2 x 100, res 10)
    and the refinement chunk's (B=512, CERTIFY_SOLVER), each against its
    plain version (K1 within kernel_bench.CHUNK_TOL, L1 exactly) and timed
    against its bound (kernel_bench.chunk_work, ldl_work)."""
    out = {}
    for tag, cfg, b in (("train B=128", train_big.CFG, 128),
                        ("refine B=512", refine_targets.CFG, 512)):
        sub = ScenarioBatch(*(a[:b] for a in sc))
        args, (Kb, sg, reg) = record_solve(cfg, sub, dev)
        k1 = kernel_bench.shape_numbers(admm_chunk, cfg.qp, args,
                                        f"chain {tag}")
        out[tag] = {"k1": k1, "l1": l1_numbers(Kb, sg, reg,
                                               f"chain's {tag}", log)}
    return out


# ---- the run ---------------------------------------------------------------

def run(n: int = N, device=None, chunk: int | None = None,
        eval_n: int | None = None, work: str | None = None,
        log=print) -> dict:
    """The chain in `work` (emptied first; by default a temporary
    directory, removed at the end: the corpus and its refinement take
    ~1 GB at the default n).  `chunk` and `eval_n` cut a CPU rehearsal
    (see the module's docstring)."""
    if work is None:
        with tempfile.TemporaryDirectory() as d:
            return run(n, device, chunk, eval_n, d, log)
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    chunk = chunk or refine_targets.CHUNK
    rec, maps_rec = read_records(), read_maps_record()
    checks, seconds, out = {}, {}, {"n": n, "epochs": EPOCHS}
    if os.path.isdir(work):
        shutil.rmtree(work)
    os.makedirs(work)
    eval_path = heldout_eval.CACHE
    if eval_n is not None:
        eval_path = os.path.join(work, "eval_fresh_cut.npz")
        dataset.write_npz(eval_path, heldout_eval.load_scenarios(eval_n))
    k1, l1 = admm_chunk.admm_chunk, ldl.ldl_block

    # a. the prefix
    t0 = time.perf_counter()
    comb, out["prefix"], map_checks = make_prefix(n, dev, log, work,
                                                  maps_rec)
    prefix_gates(checks, out["prefix"]["maps"], out["prefix"]["f64"], cuda)
    checks.update(map_checks)
    seconds["prefix"] = time.perf_counter() - t0

    # b. the refinement
    t0 = time.perf_counter()
    n0, m0 = k1.launches, l1.launches
    ref = refinement(comb, dev, chunk, log, work)
    got = ref["assembled"]
    contract_gate(checks, ref["sc"], got["times"], got["improved"],
                  got["obj0"], got["obj"])
    resume_gate(checks, ref["again"]["computed"], ref["same_arrays"],
                ref["refused"])
    first = ref["first"]
    if cuda:
        want = refine_targets.chunk_launches(refine_targets.CFG)
        launch_gate(checks, "refine_per_chunk",
                    sorted({(c["k1"], c["l1"]) for c in first["chunks"]}),
                    [want])
    ours, jref, refs = reference_rows(dev, refine_targets.STEPS, log)
    reference_gate(checks, ours, jref, refs["witness"])
    out["refine"] = {
        "stats": first["stats"], "record_stats": rec["refine_targets"],
        "chunks": len(first["chunks"]), "chunk": chunk,
        "ms_per_chunk": [c["ms"] for c in first["chunks"]],
        "wall_s": first["wall_s"],
        "rows_per_s": len(ref["sc"].seg) / first["wall_s"],
        "again": ref["again"], "same_arrays": ref["same_arrays"],
        "refused": ref["refused"], "reference": refs,
        "launches": {"k1": k1.launches - n0, "l1": l1.launches - m0}}
    seconds["refine"] = time.perf_counter() - t0

    # c. calibration of the shipped arms on the prefix's validation rows
    #    and on the JAX package's rows of MAPS_RECORD's maps
    t0 = time.perf_counter()
    out["calibration"] = {}
    ev = dataset.read_npz(eval_path)
    mrows = dataset.read_npz(MAPS_ROWS)
    bk, bl = admm.solve_launches(calibrate_thresh.CFG.qp,
                                 calibrate_thresh.CFG.solver)
    for arm in ARMS:
        run_dir = os.path.join(heldout_eval.RUNS, arm)
        c = calibrate_thresh.calibrate(
            run_dir, comb, calibrate_thresh.VAL_N,
            os.path.join(work, "calibrate", arm), dev, eval_path=eval_path,
            log=log)
        th = c["calibration"]["best_thresh"]
        _, ex, _, _ = heldout_eval.eval_arm(run_dir, ev, dev, thresh=th)
        calibration_gate(checks, arm, c["calibration"]["grid"],
                         rec["calibration"][arm]["grid"], c["flags"],
                         ex["solved"])
        params, _ = calibrate_thresh.read_params(calibrate_thresh.latest(
            run_dir))
        mgrid, mtms = [], []
        for mth in calibrate_thresh.GRID:
            rep, tm = calibrate_thresh.eval_at(params, mth, mrows, dev)
            mgrid.append(dict(rep._asdict(), token_thresh=mth))
            mtms.append(tm)
        mrec = maps_rec["calibration"][arm]["grid"]
        maps_calibration_gate(checks, arm, mgrid, mrec)
        if cuda:
            tms = c["timing"]["grid"] + [c["timing"]["eval_fresh"]] + mtms
            launch_gate(checks, f"calibration_{arm}",
                        (sum(t["k1"] for t in tms), sum(t["l1"] for t in tms)),
                        (sum(t["batches"] for t in tms) * bk,
                         sum(t["batches"] for t in tms) * bl))
        out["calibration"][arm] = {
            "grid": c["calibration"]["grid"], "best_thresh": th,
            "record_best": rec["calibration"][arm]["best_thresh"],
            "eval_fresh_calibrated": c["eval_fresh_calibrated"],
            "val_n": c["calibration"]["val_n"],
            "maps_grid": mgrid, "maps_best": calibrate_thresh.best_row(
                mgrid)["token_thresh"],
            "maps_jax_grid": [{k: v for k, v in r.items() if k != "unsolved"}
                              for r in mrec],
            "maps_jax_best": calibrate_thresh.best_row(mrec)["token_thresh"],
            "timing": {"grid_s": [t["wall_s"] for t in c["timing"]["grid"]],
                       "eval_fresh_s": c["timing"]["eval_fresh"]["wall_s"],
                       "maps_s": [t["wall_s"] for t in mtms]}}
    seconds["calibration"] = time.perf_counter() - t0

    # d. from scratch
    t0 = time.perf_counter()
    out["train"] = {}
    refined = ref["path"]
    for name, arm, seed, init in RUNS:
        t1 = time.perf_counter()
        r = train_big.train(arm, comb if arm == "big3" else refined,
                            os.path.join(work, name), EPOCHS, seed, init,
                            dev, eval_path, log)
        steps = r["metrics"]
        out["train"][name] = {
            "arm": arm, "seed": seed, "init": init,
            "windows": windows(steps), "step1": steps[0] if steps else None,
            "steps": len(steps), "ms_per_step": r["train"]["ms_per_step"],
            "train": r["train"], "eval_fresh": r["eval_fresh"],
            "s": time.perf_counter() - t1}
        if cuda:
            tw, ew = train_launches(r)
            launch_gate(checks, f"train_{name}", (r["train"]["k1"],
                                                  r["train"]["l1"]), tw)
            launch_gate(checks, f"eval_{name}", (r["eval"]["k1"],
                                                 r["eval"]["l1"]), ew)
    s1 = [out["train"][f"big3_seed{s}"]["step1"]["obj"] for s in (0, 1)]
    spread = abs(s1[0] - s1[1]) / max(abs(np.mean(s1)), 1e-12)
    widen = cpu_spread()
    for name, _, _, init in RUNS:
        if init == "jax":
            scratch_gate(checks, name,
                         [r for r in train_big.read_metrics(os.path.join(
                             work, name, "metrics.jsonl")) if "step" in r],
                         rec["windows"], spread, widen)
    seconds["train"] = time.perf_counter() - t0

    # e. the fine-tune
    t0 = time.perf_counter()
    r = finetune_qp.finetune(comb, finetune_qp.START,
                             os.path.join(work, "finetune"), EPOCHS, dev,
                             eval_path, log)
    big3 = heldout_eval.load_arm(os.path.join(heldout_eval.RUNS, "big3"),
                                 dev)
    big3.token_thresh = finetune_qp.CFG.model.token_thresh
    b3rep, _, _ = train_big.eval_fresh(big3, finetune_qp.CFG, dev, eval_path)
    out["finetune"] = {
        "windows": windows(r["metrics"], FT_WINDOWS),
        "steps": len(r["metrics"]), "ms_per_step": r["train"]["ms_per_step"],
        "train": r["train"], "eval_fresh": r["eval_fresh"],
        "big3_eval_fresh_at_0.42": b3rep._asdict(), "start": r["start"]}
    finetune_gate(checks, r["metrics"], rec["windows"]["finetune"],
                  r["eval_fresh"]["success_rate"], b3rep.success_rate)
    if cuda:
        tw, ew = train_launches(r)
        launch_gate(checks, "train_finetune", (r["train"]["k1"],
                                               r["train"]["l1"]), tw)
        launch_gate(checks, "eval_finetune", (r["eval"]["k1"],
                                              r["eval"]["l1"]), ew)
    # the same fine-tune's first steps on the JAX package's map rows
    n0, m0 = k1.launches, l1.launches
    fsteps = finetune_steps(MAPS_ROWS, FT_REF_STEPS, dev)
    out["finetune"]["maps"] = {
        "steps": fsteps, "windows": finetune_maps_gate(
            checks, fsteps, maps_rec["finetune"]),
        "jax_windows": maps_rec["finetune"]["windows"]}
    if cuda:
        fk, fl = admm.solve_launches(finetune_qp.CFG.qp,
                                     finetune_qp.CFG.solver)
        launch_gate(checks, "train_finetune_maps",
                    (k1.launches - n0, l1.launches - m0),
                    (FT_REF_STEPS * fk, FT_REF_STEPS * fl))
    seconds["finetune"] = time.perf_counter() - t0

    if cuda:
        t0 = time.perf_counter()
        out["kernels"] = kernel_shapes(ref["sc"], dev, log)
        seconds["kernels"] = time.perf_counter() - t0
    out.update(seconds=seconds, device=device_line(dev),
               gates={"checks": checks,
                      "passed": all(v["ok"] for v in checks.values())})
    return out


def reference_only(device=None, log=print) -> dict:
    """Gate (b)'s reference rows alone: the REF_N rows as one chunk
    against the JAX CPU run, with the witnesses of the rows that differ
    (`reference_rows`, `reference_gate`)."""
    dev = resolve_device(device)
    checks = {}
    ours, jref, refs = reference_rows(dev, refine_targets.STEPS, log)
    reference_gate(checks, ours, jref, refs["witness"])
    return {"reference": refs, "device": device_line(dev),
            "gates": {"checks": checks,
                      "passed": all(v["ok"] for v in checks.values())}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N, help="prefix rows")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default=None)
    ap.add_argument("--reference-only", action="store_true",
                    help="only gate (b)'s reference rows")
    a = ap.parse_args(argv)
    log = lambda s: print(s, flush=True)
    out = (reference_only(a.device, log) if a.reference_only
           else run(a.n, a.device, log=log))
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1, default=lambda o: o.tolist()
                  if isinstance(o, np.ndarray) else str(o))
    failed = {k: v for k, v in out["gates"]["checks"].items() if not v["ok"]}
    print(json.dumps({"failed": failed}, default=str)[:20000])
    print(json.dumps({"seconds": out.get("seconds"), "failed": sorted(failed),
                      "passed": out["gates"]["passed"]}))
    return 0 if out["gates"]["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
