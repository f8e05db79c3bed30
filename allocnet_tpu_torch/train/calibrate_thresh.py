#!/usr/bin/env python3
"""Calibration of the stop-token threshold on the validation split, on
the card, then one touch of the held-out set at the chosen threshold.

The port's counterpart of `scripts/calibrate_thresh.py`: the run's latest
checkpoint (`<run>/checkpoints/checkpoint*.pt` of the port's Trainer, else
`checkpoint*.msgpack` of the JAX package, read through
`models/weights.load_params`), a hidden-256 ConvLSTM, is evaluated
(`train/evaluate.evaluate`, batches of 256) at each threshold of GRID on
the trainer's own validation rows of the corpus (`Loader(seed=0)`'s 0.9
split, its first `--n`), at the script's cfg (res 10, v <= 5 m/s, a <= 7
m/s^2, 4 polish rounds, 3 x 250 ADMM iterations); the best threshold is
the highest stop-token accuracy with success breaking ties, the first of
GRID's order on a full tie (Python's `max`, as the script); then
`data/eval_fresh.npz` once at that threshold.  Writes
`<out>/calibration.json` (grid, best_thresh, checkpoint, val_n,
criterion) and `<out>/eval_fresh_calibrated.json`, the script's keys.

Beyond the script the result carries the per-scenario solved flags of
the held-out touch, K1 / L1 launches per batch and the wall of each part.

    python -m allocnet_tpu_torch.train.calibrate_thresh --run runs/big3
        [--data CORPUS.npz] [--n 2000] [--out DIR] [--device cpu]

`--out` defaults to `chiprun_out/chain/calibrate/<run's name>/`, never
the run's own directory.  Runs on the card unless `--device` says
otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from allocnet_tpu_torch.config import (AllocNetConfig, ModelConfig, QPConfig,
                                       SolverConfig, TrainConfig)
from allocnet_tpu_torch.models import weights
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.ops import admm_chunk, ldl
from allocnet_tpu_torch.train import dataset, evaluate, trainer
from allocnet_tpu_torch.utils.device import resolve_device
from allocnet_tpu_torch.utils.scenarios import ScenarioBatch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA = os.path.join(ROOT, "chiprun_out", "chain", "big100k_combined.npz")
EVAL = os.path.join(ROOT, "data", "eval_fresh.npz")
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chain", "calibrate")
GRID = (0.25, 0.30, 0.35, 0.42, 0.50, 0.60)
VAL_N = 2000
BATCH = 256
CRITERION = "stop_token_accuracy, success tie-break"

# the script's cfg
CFG = AllocNetConfig(
    qp=QPConfig(res=10, max_vel=5.0, max_acc=7.0),
    solver=SolverConfig(polish_rounds=4, iters_per_chunk=250),
    train=TrainConfig(batch_size=128),
    model=ModelConfig(hidden_size=256),
)


def subset(sc: ScenarioBatch, idx) -> ScenarioBatch:
    return ScenarioBatch(*(a[idx] for a in sc))


def val_rows(sc: ScenarioBatch, n: int = VAL_N,
             batch_size: int = CFG.train.batch_size) -> np.ndarray:
    """The trainer's validation rows (Loader seed 0, ratio 0.9), first n."""
    return dataset.Loader(sc, batch_size=batch_size, seed=0).val_idx[:n]


def best_row(rows: list) -> dict:
    """The script's choice: max by (stop-token accuracy, success), the
    first row of the grid's order on a tie."""
    return max(rows, key=lambda r: (r["stop_token_accuracy"],
                                    r["success_rate"]))


def latest(run_dir: str) -> str:
    """The run's latest checkpoint: the port's `.pt`, else a `.msgpack`."""
    ck = os.path.join(run_dir, "checkpoints")
    path = (trainer.latest_checkpoint(ck)
            or trainer.latest_checkpoint(ck, suffix=".msgpack"))
    if path is None:
        raise FileNotFoundError(f"no checkpoint under {run_dir}")
    return path


def read_params(path: str) -> tuple[dict, int | None]:
    """(state_dict, epoch) of a `.pt` Trainer checkpoint or a `.msgpack`
    (epoch None: the JAX payload's is not read)."""
    if path.endswith(".pt"):
        payload = torch.load(path, map_location="cpu", weights_only=True)
        return payload["model"], int(payload["epoch"])
    return weights.load_params(path), None


def make_net(params: dict, thresh: float, device) -> ConvLSTMAllocNet:
    m = CFG.model
    net = ConvLSTMAllocNet(m.seq_len, m.hidden_size, thresh)
    net.load_state_dict(params)
    return net.to(device).eval()


def thresh_config(thresh: float) -> AllocNetConfig:
    return dataclasses.replace(CFG, model=dataclasses.replace(
        CFG.model, token_thresh=thresh))


def eval_at(params: dict, thresh: float, sc: ScenarioBatch, dev,
            extras: bool = False):
    """`evaluate.evaluate` of the net at `thresh` over `sc`; with the
    wall, the batches' ms and K1 / L1 launches."""
    net = make_net(params, thresh, dev)
    k1, l1 = admm_chunk.admm_chunk, ldl.ldl_block
    n0, m0 = k1.launches, l1.launches
    batch_ms = []
    t0 = time.perf_counter()
    got = evaluate.evaluate(net, thresh_config(thresh), sc,
                            batch_size=BATCH, extras=extras, device=dev,
                            batch_ms=batch_ms)
    timing = {"wall_s": time.perf_counter() - t0, "batch_ms": batch_ms,
              "k1": k1.launches - n0, "l1": l1.launches - m0,
              "batches": -(-len(sc.seg) // BATCH)}
    return got, timing


def calibrate(run_dir: str, data: str = DATA, n: int = VAL_N,
              out_dir: str | None = None, device=None, eval_path: str = EVAL,
              log=print, grid=GRID) -> dict:
    """The script's main (over the thresholds `grid`).  Returns {"calibration": calibration.json,
    "eval_fresh_calibrated": its JSON, "flags": the held-out touch's
    per-scenario solved flags, "timing": {"grid": per threshold,
    "eval_fresh"}, "out_dir"}."""
    dev = resolve_device(device)
    out_dir = out_dir or os.path.join(OUT_DIR, os.path.basename(
        os.path.normpath(run_dir)))
    sc = dataset.read_npz(data)
    val = subset(sc, val_rows(sc, n))
    log(f"val calibration set: {val.state.shape[0]}")
    path = latest(run_dir)
    params, epoch = read_params(path)
    rows, timing = [], {"grid": []}
    for th in grid:
        rep, tm = eval_at(params, th, val, dev)
        rows.append(dict(rep._asdict(), token_thresh=th))
        timing["grid"].append(tm)
        log(json.dumps(rows[-1]))
    best = best_row(rows)
    cal = {"grid": rows, "best_thresh": best["token_thresh"],
           "checkpoint": os.path.basename(path), "val_n": int(n),
           "criterion": CRITERION}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "calibration.json"), "w") as f:
        json.dump(cal, f, indent=1)
    log(f"best threshold {best['token_thresh']}")
    # one touch of the held-out set at the calibrated threshold
    ev = dataset.read_npz(eval_path)
    th = best["token_thresh"]
    (rep, ex), timing["eval_fresh"] = eval_at(params, th, ev, dev,
                                              extras=True)
    res = dict(rep._asdict(), token_thresh=th,
               checkpoint=os.path.basename(path), epoch=epoch,
               fresh_maps=True, calibrated=True)
    with open(os.path.join(out_dir, "eval_fresh_calibrated.json"), "w") as f:
        json.dump(res, f, indent=1)
    log(json.dumps(res))
    return {"calibration": cal, "eval_fresh_calibrated": res,
            "flags": np.asarray(ex["solved"], bool), "timing": timing,
            "out_dir": out_dir}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", required=True)
    ap.add_argument("--data", default=DATA)
    ap.add_argument("--n", type=int, default=VAL_N)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    calibrate(os.path.abspath(a.run), a.data, a.n, a.out, a.device,
              log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
