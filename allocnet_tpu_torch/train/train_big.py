#!/usr/bin/env python3
"""The flagship supervised run from scratch, on the card.

The port's counterpart of `scripts/train_big3.py` (`--arm big3`: the
combined corpus, arm name `supervised_100k_fixed_init`) and
`scripts/train_big4.py` (`--arm big4`: the same run on the refined
targets of `train/refine_targets`, arm name `distilled_refined_targets`),
which share one config on purpose (`train_big4.py:33`): CFG, res 10, v <=
5 m/s, a <= 7 m/s^2, a 2 x 100 ADMM budget, B = 128, 35 epochs of Adam at
1e-3 under cosine warm restarts (t0 3000, t_mult 2), a checkpoint every 5
epochs, a hidden-256 ConvLSTM, supervised time loss only (w1 0, wt 1, wc
0, wp 20).  The net starts from `train_step.init_params(net, seed)`, the
JAX package's initialization (`--init default` keeps PyTorch's own, for
comparison); the port's Trainer over `Loader(seed=0)` (the 0.9 split)
resumes from the workdir's latest checkpoint.  Writes `dataset.json`, the
Trainer's `metrics.jsonl` and `checkpoints/`, then `eval_fresh.json`: the
net over `data/eval_fresh.npz` at 4 polish rounds and 3 x 250 ADMM
iterations, with the script's keys.

Beyond the script the result carries the host s of each epoch's steps,
ms per step and K1 / L1 launches of the training and of the eval.
`run` is the same run at any cfg and net (train/ablation.py's arms).

    python -m allocnet_tpu_torch.train.train_big --arm big3|big4
        [--data CORPUS.npz] [--out WORKDIR] [--epochs E] [--seed S]
        [--init jax|default] [--device cpu]

`--out` defaults to `chiprun_out/chain/<arm>/`, never `runs/`.  Runs on
the card unless `--device` says otherwise.
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

from allocnet_tpu_torch.config import (AllocNetConfig, LossConfig,
                                       ModelConfig, QPConfig, SolverConfig,
                                       TrainConfig)
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.ops import admm_chunk, ldl
from allocnet_tpu_torch.train import corpus, dataset, evaluate
from allocnet_tpu_torch.train import train_step as ts_lib
from allocnet_tpu_torch.train import trainer as trainer_lib
from allocnet_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chain")
EVAL = os.path.join(ROOT, "data", "eval_fresh.npz")
ARMS = {
    "big3": {"data": os.path.join(OUT_DIR, "big100k_combined.npz"),
             "arm": "supervised_100k_fixed_init"},
    "big4": {"data": os.path.join(OUT_DIR, "big100k_refined.npz"),
             "arm": "distilled_refined_targets"},
}

# the scripts' cfg (train_big3.py:41-48, train_big4.py:33-41)
CFG = AllocNetConfig(
    qp=QPConfig(res=10, max_vel=5.0, max_acc=7.0),
    solver=SolverConfig(n_chunks=2, iters_per_chunk=100),
    train=TrainConfig(batch_size=128, max_epochs=35, learning_rate=1e-3,
                      t0=3000, t_mult=2, save_freq=5),
    model=ModelConfig(hidden_size=256),
    loss=LossConfig(w1=0.0, wt=1.0, wc=0.0, wp=20.0),
)
# the held-out eval after training: the certification-grade budget
EVAL_SOLVER = SolverConfig(polish_rounds=4, iters_per_chunk=250)


def read_metrics(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def eval_fresh(net, cfg: AllocNetConfig, device, eval_path: str = EVAL):
    """The scripts' closing eval: (EvalReport, extras, {wall_s, k1, l1,
    batches})."""
    sc = dataset.read_npz(eval_path)
    ecfg = dataclasses.replace(cfg, solver=EVAL_SOLVER)
    k1, l1 = admm_chunk.admm_chunk, ldl.ldl_block
    n0, m0 = k1.launches, l1.launches
    t0 = time.perf_counter()
    rep, ex = evaluate.evaluate(net.eval(), ecfg, sc, extras=True,
                                device=device)
    return rep, ex, {"wall_s": time.perf_counter() - t0,
                     "k1": k1.launches - n0, "l1": l1.launches - m0,
                     "batches": -(-len(sc.seg) // 256)}


def run_trainer(tr, epochs, log) -> dict:
    """`tr.train(epochs)` with the launches and host seconds around it."""
    k1, l1 = admm_chunk.admm_chunk, ldl.ldl_block
    n0, m0, step0 = k1.launches, l1.launches, tr.step
    t0 = time.perf_counter()
    tr.train(max_epochs=epochs)
    if tr.dev.type == "cuda":
        torch.cuda.synchronize(tr.dev)
    wall = time.perf_counter() - t0
    steps = tr.step - step0
    epochs_run = len(tr.steps_s)
    val_batches = epochs_run * (len(tr.loader.val_idx)
                                // tr.loader.batch_size)
    out = {"steps": steps, "val_batches": val_batches, "wall_s": wall,
           "steps_s": tr.steps_s,
           "ms_per_step": (sum(tr.steps_s) / steps * 1e3) if steps else None,
           "k1": k1.launches - n0, "l1": l1.launches - m0}
    log(f"trained {steps} steps in {wall:.1f} s "
        f"({out['ms_per_step'] or 0:.1f} ms per step); launches "
        f"{out['k1']} / {out['l1']}")
    return out


def lstm_net(cfg: AllocNetConfig) -> torch.nn.Module:
    """The scripts' net: a ConvLSTM at the cfg's model widths."""
    return ConvLSTMAllocNet(seq_len=cfg.model.seq_len,
                            hidden_size=cfg.model.hidden_size,
                            token_thresh=cfg.model.token_thresh)


def run(cfg: AllocNetConfig, make_net, data: str, workdir: str, name: str,
        ds: dict, epochs: int | None = None, seed: int = 0,
        init: str = "jax", device=None, eval_path: str = EVAL,
        log=print) -> dict:
    """A run from scratch at `cfg`: `make_net(cfg)` initialized by
    `init_params(net, seed)` (or PyTorch's own with init="default"), the
    port's Trainer over `Loader(seed=0)` on the corpus `data` in
    `workdir` (resuming from its latest checkpoint), then the closing eval
    over `eval_path`.  `ds` goes to `dataset.json`, `name` into the eval's
    JSON as its arm.  Returns {"dataset", "train" (steps, seconds, launches),
    "metrics" (the step records), "eval_fresh" (the script's JSON),
    "eval_flags", "eval" (wall, launches), "workdir"}."""
    dev = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    sc = dataset.read_npz(data)
    log(f"dataset: {len(sc.seg)} samples, seg dist {corpus.seg_hist(sc.seg)}")
    with open(os.path.join(workdir, "dataset.json"), "w") as f:
        json.dump(ds, f)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             seed=seed))
    loader = dataset.Loader(sc, batch_size=cfg.train.batch_size, seed=0)
    torch.manual_seed(seed)
    net = make_net(cfg)
    if init == "jax":
        ts_lib.init_params(net, cfg.train.seed)
    tr = trainer_lib.Trainer(cfg, net, loader, workdir, device=dev)
    log(f"training from epoch {tr.start_epoch}")
    summary = run_trainer(tr, epochs, log)
    rep, ex, ev = eval_fresh(tr.net, cfg, dev, eval_path)
    out = dict(rep._asdict(), arm=name, step=int(tr.step))
    with open(os.path.join(workdir, "eval_fresh.json"), "w") as f:
        json.dump(out, f, indent=1)
    log(json.dumps(out))
    return {"dataset": ds, "train": summary, "init": init, "seed": seed,
            "metrics": [r for r in read_metrics(tr.log_path) if "step" in r],
            "eval_fresh": out, "eval_flags": np.asarray(ex["solved"], bool),
            "eval": ev, "workdir": workdir}


def train(arm: str, data: str | None = None, workdir: str | None = None,
          epochs: int | None = None, seed: int = 0, init: str = "jax",
          device=None, eval_path: str = EVAL, log=print) -> dict:
    """The script's main for `arm` (`run` at CFG with the ConvLSTM)."""
    spec = ARMS[arm]
    data = data or spec["data"]
    seg = dataset.read_npz(data).seg
    n = int(len(seg))
    ds = ({"n": n, "seg_hist": corpus.seg_hist(seg),
           "sources": [os.path.relpath(data, ROOT)]} if arm == "big3" else
          {"n": n, "source": os.path.relpath(data, ROOT),
           "targets": "refined (train/refine_targets.py)"})
    return run(CFG, lstm_net, data, workdir or os.path.join(OUT_DIR, arm),
               spec["arm"], ds, epochs, seed, init, device, eval_path, log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arm", choices=sorted(ARMS), required=True)
    ap.add_argument("--data", default=None)
    ap.add_argument("--out", default=None, help="the workdir")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init", choices=("jax", "default"), default="jax")
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    train(a.arm, a.data, a.out, a.epochs, a.seed, a.init, a.device,
          log=lambda s: print(s, flush=True))
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
