#!/usr/bin/env python3
"""The paper's ablation on the card: QP-gradient against supervised
training from scratch, for the ConvLSTM and the ConvMLP, with its gates.

The port's counterpart of `scripts/train_big2.py` (arm `lstm_qp_grad`),
`scripts/train_ablation.py` (`lstm_supervised`) and
`scripts/mlp_probe.py` (`mlp_qp_grad`, `mlp_supervised`), each at its
script's cfg and full width (ARMS, `arm_cfg`): res 10, v <= 5 m/s, a <= 7
m/s^2, a 2 x 100 ADMM budget, B = 128, Adam at 1e-3 under cosine warm
restarts (t0 3000, t_mult 2), hidden 256; the LSTM arms 50 epochs, the
MLP arms 15.  Every arm runs the net, the solve and its implicit backward
at every step, whatever its loss weights (`train_step.train_step`).  The
corpus is the prefix of regen_data.sh's stage 1 (`chain.make_prefix`,
seeds 1000+, with its gates), generated once per run at the most rows any
of its arms takes: the LSTM arms the first LSTM_ROWS (**cut** from the
scripts' 50,000, as the training chain's prefix), the MLP arms the first
MLP_ROWS, as mlp_probe.py.  Each arm starts from
`train_step.init_params(net, 0)`, the JAX package's seed-0 weights (the
draws the TPU runs started from), trains with `train_big.run`
(`Loader(seed=0)`, the 0.9 split) and ends with the scripts' eval over
`data/eval_fresh.npz` (4 polish rounds, 3 x 250 iterations).

Outputs go to `chiprun_out/ablation/<arm>/` (never `runs/`): the
Trainer's `metrics.jsonl`, `dataset.json`, `eval_fresh.json` (the
scripts' keys), `eval_flags.json` (the 2,000 solved flags, packed) and
`result.json`; the checkpoints stay in a temporary directory.  The run's
summary goes to `--out`.  When both arms of a family ran, McNemar's b / c
/ p come from their two flag vectors; `--pair FLAGS.json` supplies an
arm of an earlier run (its `eval_flags.json`).

    python -m allocnet_tpu_torch.train.ablation --arm A [--arm B ...]
        [--pair FLAGS.json] [--out PATH] [--device cpu]

Runs on the card unless `--device` says otherwise; exits 1 when a gate
fails.  `run` also takes a prepared corpus, a held-out file and an epoch
count in place of the prefix, eval_fresh and the scripts' epochs (a
rehearsal or the smoke's phase: a window the run does not cover whole
goes ungated, and so does the eval).
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from allocnet_tpu_torch.config import (AllocNetConfig, LossConfig,
                                       ModelConfig, QPConfig, SolverConfig,
                                       TrainConfig)
from allocnet_tpu_torch.models.networks import ConvMLPAllocNet
from allocnet_tpu_torch.ops import admm, admm_chunk, ldl
from allocnet_tpu_torch.train import chain, corpus, dataset, heldout_eval
from allocnet_tpu_torch.train import train_big
from allocnet_tpu_torch.utils import kernel_bench
from allocnet_tpu_torch.utils.device import device_line, resolve_device
from allocnet_tpu_torch.utils.scenarios import ScenarioBatch

ROOT = train_big.ROOT
OUT_DIR = os.path.join(ROOT, "chiprun_out", "ablation")
OUT = os.path.join(ROOT, "chiprun_out", "ablation.json")
RECORDS = os.path.join(ROOT, "tests", "records", "ablation_records.json")
# the first CPU_STEPS steps of each arm on eval_fresh batches from the JAX
# init, JAX seeds 0 and 1 and the port's (tests/jax_ablation_record.py)
JAX_CPU = os.path.join(ROOT, "tests", "records", "ablation_jax_cpu.json")
PORT_CPU = os.path.join(ROOT, "tests", "records", "ablation_port_cpu.json")
CPU_STEPS = 40
SPREAD_RUNS = ("jax_0", "jax_1", "port_0", "port_1")
LSTM_ROWS, MLP_ROWS = 25_600, 10_000
SEED = 0

# arm: its script (file:lines of its cfg), net, loss, rows, epochs, the
# script's checkpoint period and its family (FAMILIES)
ARMS = {
    "lstm_qp_grad": {
        "script": "scripts/train_big2.py:30-36", "net": "lstm",
        "loss": LossConfig(), "rows": LSTM_ROWS, "epochs": 50,
        "save_freq": 2, "family": "lstm"},
    "lstm_supervised": {
        "script": "scripts/train_ablation.py:44-51", "net": "lstm",
        "loss": LossConfig(w1=0.0, wt=1.0, wc=0.0, wp=20.0),
        "rows": LSTM_ROWS, "epochs": 50, "save_freq": 10, "family": "lstm"},
    "mlp_qp_grad": {
        "script": "scripts/mlp_probe.py:39,58-65", "net": "mlp",
        "loss": LossConfig(w1=17.5, wt=1200.0, wc=0.1, wp=0.0),
        "rows": MLP_ROWS, "epochs": 15, "save_freq": 5, "family": "mlp"},
    "mlp_supervised": {
        "script": "scripts/mlp_probe.py:41,58-65", "net": "mlp",
        "loss": LossConfig(w1=0.0, wt=1.0, wc=0.0, wp=0.0),
        "rows": MLP_ROWS, "epochs": 15, "save_freq": 5, "family": "mlp"},
}
FAMILIES = {"lstm": ("lstm_qp_grad", "lstm_supervised"),
            "mlp": ("mlp_qp_grad", "mlp_supervised")}
# the loss windows: the first epoch's, and the steps at which the TPU run
# and this one share a learning rate (the ends of the first two cosine
# periods, 3,000 and 9,000; the MLP runs' last 90 steps)
WINDOWS = {"lstm": ((1, 10), (11, 90), (91, 180), (2901, 3000),
                    (8901, 9000)),
           "mlp": ((1, 10), (11, 90), (91, 180), (961, 1050))}
LOSSES = ("obj", "objt", "stop")
RATES = ("success_rate", "time_segment_accuracy")

# GATES, fixed before the first run on the card (PERF.md section 6):
# a. the prefix: `chain.make_prefix`'s gates unchanged (on the card 4 K1
#    and 48 L1 a map; each map's first chain.F64_ROWS certified rows
#    solved in float64, the flags repeated; maps 1000, 1030 and 1031 row
#    by row against the JAX package's CPU run, each difference
#    witnessed);
# b. each arm's loss windows (WINDOWS) against its TPU record's
#    (RECORDS): no non-finite loss; the mean of each of LOSSES within
#    chain.BAND_LOSS (relative) and of RATES within chain.BAND_ACC
#    (absolute) of the record's, each band widened to the spread of the
#    four CPU runs of the arm's first CPU_STEPS steps (SPREAD_RUNS, the
#    1-10 window over their 1-10, every other over their 11-40; `spread`)
#    where that is wider; a window the run does not cover whole goes
#    ungated, and at least one must be covered;
# c. the held-out eval of an uncut run: an MLP arm's eval_fresh success
#    within EVAL_TOL of its record's; an LSTM arm's (cut corpus) stands
#    beside its record's ungated, as do its stop-token accuracy and time
#    ratio; each family's winner and McNemar b / c / p stand beside the
#    records' verdict;
# d. launches, on the card: each arm's K1 and L1 counts equal
#    `admm.solve_launches` per training step and validation batch (2 / 4)
#    and per eval batch of 256 (3 / 16), exactly;
# e. the kernels, on the card: K1 on the arm's first training launch at
#    B=128 against its plain version (kernel_bench.CHUNK_TOL), L1 on the
#    step's first polish block exactly (kernel_bench.ldl_compare), each
#    timed against its bound.
EVAL_TOL = 0.04


def arm_cfg(arm: str) -> AllocNetConfig:
    """The arm's script's AllocNetConfig."""
    a = ARMS[arm]
    return AllocNetConfig(
        qp=QPConfig(res=10, max_vel=5.0, max_acc=7.0),
        solver=SolverConfig(n_chunks=2, iters_per_chunk=100),
        train=TrainConfig(batch_size=128, max_epochs=a["epochs"],
                          learning_rate=1e-3, t0=3000, t_mult=2,
                          save_freq=a["save_freq"]),
        model=ModelConfig(hidden_size=256),
        loss=a["loss"])


def mlp_net(cfg: AllocNetConfig) -> torch.nn.Module:
    """mlp_probe.py's net: a ConvMLP at the cfg's widths."""
    return ConvMLPAllocNet(seg=cfg.qp.max_seg, seq_len=cfg.model.seq_len,
                           hidden_size=cfg.model.hidden_size)


def net_factory(arm: str):
    """The arm's net as a function of its cfg."""
    return train_big.lstm_net if ARMS[arm]["net"] == "lstm" else mlp_net


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


# ---- b. the loss windows ---------------------------------------------------

def spread(jax_cpu: dict, port_cpu: dict, arm: str) -> dict:
    """{window: {field: spread}} of the SPREAD_RUNS CPU runs of `arm`:
    (max - min) / mean of a loss, max - min of a rate, the 1-10 window
    over their 1-10 and every other over their 11-40."""
    runs = {**jax_cpu["curves"][arm], **port_cpu["curves"][arm]}
    out = {}
    for a, b in WINDOWS[ARMS[arm]["family"]]:
        cw = "1-10" if (a, b) == (1, 10) else f"11-{CPU_STEPS}"
        out[f"{a}-{b}"] = {}
        for k in LOSSES + RATES:
            v = [runs[r]["windows"][cw][k] for r in SPREAD_RUNS]
            mean = abs(float(np.mean(v)))
            out[f"{a}-{b}"][k] = (((max(v) - min(v)) / mean if mean else 0.0)
                                  if k in LOSSES else max(v) - min(v))
    return out


def window_gate(checks: dict, arm: str, steps: list, rec: dict,
                widen: dict) -> dict:
    """(b) the arm's windows against its record's; returns the run's."""
    win = chain.windows(steps, WINDOWS[ARMS[arm]["family"]])
    finite = all(np.isfinite(r[k]) for r in steps for k in r
                 if k not in ("epoch", "step"))
    out = {}
    for w, fields in win.items():
        for k in LOSSES + RATES:
            lo, hi = chain.band([rec[w][k]], k in LOSSES,
                                widen.get(w, {}).get(k, 0.0))
            out[f"{w} {k}"] = [fields[k], lo, hi, lo <= fields[k] <= hi]
    chain._check(checks, f"windows_{arm}", finite and len(win) > 0 and all(
        v[3] for v in out.values()), finite=finite, windows=out,
        band_loss=chain.BAND_LOSS, band_rate=chain.BAND_ACC, widen=widen)
    return win


# ---- c. the held-out eval --------------------------------------------------

def eval_gate(checks: dict, arm: str, ev: dict, rec: dict) -> None:
    """(c) an MLP arm's eval_fresh success within EVAL_TOL of its
    record's (called for uncut runs only)."""
    if ARMS[arm]["family"] != "mlp":
        return
    got, want = ev["success_rate"], rec["success_rate"]
    chain._check(checks, f"eval_{arm}", abs(got - want) <= EVAL_TOL,
                 success=got, record=want, tol=EVAL_TOL)


def pack_flags(arm: str, flags: np.ndarray) -> dict:
    flags = np.asarray(flags, bool)
    return {"arm": arm, "n": int(len(flags)), "solved": int(flags.sum()),
            "bits": base64.b64encode(np.packbits(flags).tobytes()).decode()}


def unpack_flags(rec: dict) -> np.ndarray:
    bits = np.frombuffer(base64.b64decode(rec["bits"]), np.uint8)
    return np.unpackbits(bits)[:rec["n"]].astype(bool)


def verdicts(flags: dict, records: dict) -> dict:
    """Each family whose two arms have flags: success of both, the
    winner, McNemar (qp_grad first) beside the records' success and
    winner."""
    out = {}
    for fam, (q, s) in FAMILIES.items():
        if q not in flags or s not in flags:
            continue
        fq, fs = flags[q], flags[s]
        rq, rs = (records["eval_fresh"][a]["success_rate"] for a in (q, s))
        out[fam] = {"success": {q: float(fq.mean()), s: float(fs.mean())},
                    "winner": q if fq.mean() > fs.mean() else s
                    if fs.mean() > fq.mean() else "tie",
                    "mcnemar": heldout_eval.mcnemar(fq, fs),
                    "record_success": {q: rq, s: rs},
                    "record_winner": q if rq > rs else s}
    return out


# ---- d, e. launches and kernels --------------------------------------------

def launches_want(cfg: AllocNetConfig, r: dict) -> tuple:
    """(K1, L1) of the training (per step and validation batch one solve
    at the training budget; its implicit backward launches neither) and
    of the eval (one solve per batch at train_big.EVAL_SOLVER)."""
    k, l = admm.solve_launches(cfg.qp, cfg.solver)
    ek, el = admm.solve_launches(cfg.qp, train_big.EVAL_SOLVER)
    t, e = r["train"], r["eval"]
    solves = t["steps"] + t["val_batches"]
    return (solves * k, solves * l), (e["batches"] * ek, e["batches"] * el)


def kernel_numbers(cfg: AllocNetConfig, recorded: dict, blocks: list,
                   arm: str, log) -> dict:
    """(e) K1 on the arm's first training launch at B=128, L1 on its
    first polish block."""
    if 128 not in recorded or not blocks:
        raise SystemExit(f"ablation: {arm} launched no K1 at B=128 or no "
                         f"L1 (batches {sorted(recorded)})")
    tag = f"{arm} step B=128"
    return {"k1": kernel_bench.shape_numbers(admm_chunk, cfg.qp,
                                             recorded[128], tag),
            "l1": chain.l1_numbers(*blocks[0], tag, log)}


# ---- the run ---------------------------------------------------------------

def arm_outputs(out_dir: str, arm: str, r: dict, result: dict) -> None:
    """The arm's files under out_dir/<arm>/ (metrics, dataset, eval,
    flags, result)."""
    d = os.path.join(out_dir, arm)
    os.makedirs(d, exist_ok=True)
    for name in ("metrics.jsonl", "dataset.json", "eval_fresh.json"):
        shutil.copy(os.path.join(r["workdir"], name), os.path.join(d, name))
    with open(os.path.join(d, "eval_flags.json"), "w") as f:
        json.dump(pack_flags(arm, r["eval_flags"]), f)
    with open(os.path.join(d, "result.json"), "w") as f:
        json.dump(result, f, indent=1, default=str)


def run(arms, device=None, corpus_path: str | None = None,
        epochs: int | None = None, eval_path: str = heldout_eval.CACHE,
        pairs=(), out_dir: str = OUT_DIR, work: str | None = None,
        kernel_inputs: dict | None = None, log=print) -> dict:
    """The arms in turn on one corpus, in `work` (emptied first; by
    default a temporary directory, removed at the end): the prefix
    (`chain.make_prefix` at the most rows an arm takes, with its gates)
    unless `corpus_path` names a prepared one, each arm on its first
    rows.  `epochs` cuts every arm's, `eval_path` replaces eval_fresh;
    `pairs` are other arms' eval_flags.json records (`pack_flags`).  On
    the card each arm's first B=128 launch and polish block are checked
    against the plain versions (gate e), or, when `kernel_inputs` is a
    dict, go into it by arm for the caller to check."""
    if work is None:
        with tempfile.TemporaryDirectory() as d:
            return run(arms, device, corpus_path, epochs, eval_path, pairs,
                       out_dir, d, kernel_inputs, log)
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    rec = read_json(RECORDS)
    jax_cpu, port_cpu = read_json(JAX_CPU), read_json(PORT_CPU)
    checks, seconds = {}, {}
    if os.path.isdir(work):
        shutil.rmtree(work)
    os.makedirs(work)
    out = {"arms": {}, "prefix": None}
    uncut = (corpus_path is None and epochs is None
             and eval_path == heldout_eval.CACHE)

    # a. the prefix, at the most rows an arm takes
    if corpus_path is None:
        t0 = time.perf_counter()
        corpus_path, prefix, map_checks = chain.make_prefix(
            max(ARMS[a]["rows"] for a in arms), dev, log, work,
            chain.read_maps_record())
        chain.prefix_gates(checks, prefix["maps"], prefix["f64"], cuda)
        checks.update(map_checks)
        seconds["prefix"] = time.perf_counter() - t0
        out["prefix"] = {k: v for k, v in prefix.items() if k != "f64"}
    full = dataset.read_npz(corpus_path)

    flags = {p["arm"]: unpack_flags(p) for p in pairs}
    for arm in arms:
        t0 = time.perf_counter()
        a, cfg = ARMS[arm], arm_cfg(arm)
        n = min(a["rows"], len(full.seg))
        data = os.path.join(work, f"rows_{n}.npz")
        if not os.path.exists(data):
            dataset.write_npz(data, ScenarioBatch(*(x[:n] for x in full)))
        ds = {"n": n, "seg_hist": corpus.seg_hist(full.seg[:n]),
              "source": f"the first {n} rows of "
                        + (os.path.basename(corpus_path) if out["prefix"]
                           is None else "regen_data.sh stage 1's prefix "
                           "(train/chain.make_prefix)")}
        recorded, blocks = {}, []
        launch = admm_chunk._launch
        if cuda:
            admm_chunk._launch = kernel_bench.first_launch_per_batch(
                launch, recorded)
        try:
            with kernel_bench.first_ldl_block(ldl, blocks):
                r = train_big.run(cfg, net_factory(arm), data,
                                  os.path.join(work, arm), arm, ds, epochs,
                                  SEED, "jax", dev, eval_path, log)
        finally:
            admm_chunk._launch = launch
        steps = r["metrics"]
        win = window_gate(checks, arm, steps, rec["windows"][arm],
                          spread(jax_cpu, port_cpu, arm))
        if uncut:
            eval_gate(checks, arm, r["eval_fresh"], rec["eval_fresh"][arm])
        result = {
            "script": a["script"], "rows": n, "epochs": epochs or a["epochs"],
            "uncut": uncut, "windows": win,
            "record_windows": rec["windows"][arm],
            "step1": steps[0] if steps else None, "steps": len(steps),
            "train": {k: v for k, v in r["train"].items() if k != "steps_s"},
            "epoch_s": r["train"]["steps_s"],
            "eval_fresh": r["eval_fresh"],
            "record_eval_fresh": rec["eval_fresh"][arm], "eval": r["eval"]}
        if cuda:
            tw, ew = launches_want(cfg, r)
            chain.launch_gate(checks, f"train_{arm}", (r["train"]["k1"],
                                                       r["train"]["l1"]), tw)
            chain.launch_gate(checks, f"eval_{arm}", (r["eval"]["k1"],
                                                      r["eval"]["l1"]), ew)
            if kernel_inputs is None:
                result["kernels"] = kernel_numbers(cfg, recorded, blocks,
                                                   arm, log)
            else:
                kernel_inputs[arm] = (recorded, blocks)
        flags[arm] = r["eval_flags"]
        seconds[arm] = time.perf_counter() - t0
        result["s"] = seconds[arm]
        arm_outputs(out_dir, arm, r, result)
        out["arms"][arm] = result
        log(json.dumps({arm: {"ms_per_step": r["train"]["ms_per_step"],
                              "eval_fresh": r["eval_fresh"]["success_rate"],
                              "s": seconds[arm]}}))
    out.update(verdicts=verdicts(flags, rec), seconds=seconds,
               device=device_line(dev),
               gates={"checks": checks,
                      "passed": all(v["ok"] for v in checks.values())})
    return out


def execute(arms, pairs=(), out: str = OUT, device=None) -> int:
    """`run`, its summary to `out`, the failed gates printed; 0 when
    every gate holds."""
    log = lambda s: print(s, flush=True)
    res = run(arms, device, pairs=[read_json(p) for p in pairs], log=log)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=1, default=lambda o: o.tolist()
                  if isinstance(o, np.ndarray) else str(o))
    failed = {k: v for k, v in res["gates"]["checks"].items()
              if not v["ok"]}
    print(json.dumps({"failed": failed}, default=str)[:20000])
    print(json.dumps({"seconds": res["seconds"], "verdicts": res["verdicts"],
                      "failed": sorted(failed),
                      "passed": res["gates"]["passed"]}))
    return 0 if res["gates"]["passed"] else 1


def add_arguments(ap) -> None:
    ap.add_argument("--arm", action="append", choices=list(ARMS),
                    required=True, help="an arm (repeat for more)")
    ap.add_argument("--pair", action="append", default=[],
                    help="another arm's eval_flags.json")
    ap.add_argument("--out", default=OUT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_arguments(ap)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    return execute(a.arm, a.pair, a.out, a.device)


if __name__ == "__main__":
    sys.exit(main())
