#!/usr/bin/env python3
"""The QP-gradient fine-tune from the supervised flagship, on the card.

The port's counterpart of `scripts/finetune_qp.py`: the port's Trainer at
the script's CFG (res 10, v <= 5 m/s, a <= 7 m/s^2, a 2 x 100 ADMM
budget, B = 128, 10 epochs of Adam at 2e-4 under cosine restarts with t0
4000 and t_mult 1, a checkpoint every 2 epochs, a hidden-256 ConvLSTM,
losses w1 5, wt 1200, wc 0.1, wp 20) over `Loader(seed=0)` of the corpus.
When the workdir has no checkpoint of its own, the net takes the params
of the supervised run's latest checkpoint (START, `runs/big3`'s committed
`.msgpack` through `models/weights.load_params`, or a `.pt` of the port's
Trainer) and nothing else: the Adam state and the schedule start fresh;
otherwise the Trainer resumes.  After training `eval_fresh.json`: the net
over `data/eval_fresh.npz` at 4 polish rounds and 3 x 250 ADMM
iterations, with the script's keys (`arm`, `start`, `step`).

    python -m allocnet_tpu_torch.train.finetune_qp [--data CORPUS.npz]
        [--start DIR] [--out WORKDIR] [--epochs E] [--device cpu]

`--out` defaults to `chiprun_out/chain/finetune/`, never `runs/`.  Runs
on the card unless `--device` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from allocnet_tpu_torch.config import (AllocNetConfig, LossConfig,
                                       ModelConfig, QPConfig, SolverConfig,
                                       TrainConfig)
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.train import calibrate_thresh, dataset, train_big
from allocnet_tpu_torch.train import train_step as ts_lib
from allocnet_tpu_torch.train import trainer as trainer_lib
from allocnet_tpu_torch.utils.device import resolve_device

ROOT = train_big.ROOT
START = os.path.join(ROOT, "runs", "big3")
DATA = train_big.ARMS["big3"]["data"]
WORKDIR = os.path.join(train_big.OUT_DIR, "finetune")
ARM = "supervised_then_qp_finetune"

# the script's cfg (finetune_qp.py:37-46)
CFG = AllocNetConfig(
    qp=QPConfig(res=10, max_vel=5.0, max_acc=7.0),
    solver=SolverConfig(n_chunks=2, iters_per_chunk=100),
    train=TrainConfig(batch_size=128, max_epochs=10, learning_rate=2e-4,
                      t0=4000, t_mult=1, save_freq=2),
    model=ModelConfig(hidden_size=256),
    # moderate time pressure: w1 well below the from-scratch 17.5 so the
    # success-preserving supervised solution stays in the basin
    loss=LossConfig(w1=5.0, wt=1200.0, wc=0.1, wp=20.0),
)


def start_params(tr: trainer_lib.Trainer, start: str, log=print) -> str:
    """The script's start: with no checkpoint of the workdir's own (step
    0, epoch 0) the net takes the params of `start`'s latest checkpoint,
    in place (the optimizer's and scheduler's fresh state stays);
    otherwise nothing.  Returns the checkpoint taken, or None."""
    if tr.start_epoch == 0 and tr.step == 0:
        src = calibrate_thresh.latest(start)
        params, _ = calibrate_thresh.read_params(src)
        tr.net.load_state_dict(params)
        log(f"fine-tuning from {src}")
        return src
    log(f"resuming fine-tune at epoch {tr.start_epoch}")
    return None


def finetune(data: str = DATA, start: str = START,
             workdir: str = WORKDIR, epochs: int | None = None,
             device=None, eval_path: str = train_big.EVAL,
             log=print) -> dict:
    """The script's main.  Returns {"train", "metrics", "eval_fresh",
    "eval_flags", "eval", "workdir", "start"} (as train_big.train)."""
    dev = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    sc = dataset.read_npz(data)
    log(f"train {len(sc.seg)} / eval {len(dataset.read_npz(eval_path).seg)}")
    loader = dataset.Loader(sc, batch_size=CFG.train.batch_size, seed=0)
    torch.manual_seed(CFG.train.seed)
    net = ts_lib.init_params(ConvLSTMAllocNet(
        seq_len=CFG.model.seq_len, hidden_size=CFG.model.hidden_size,
        token_thresh=CFG.model.token_thresh), CFG.train.seed)
    tr = trainer_lib.Trainer(CFG, net, loader, workdir, device=dev)
    src = start_params(tr, start, log)
    summary = train_big.run_trainer(tr, epochs, log)
    rep, ex, ev = train_big.eval_fresh(tr.net, CFG, dev, eval_path)
    out = dict(rep._asdict(), arm=ARM,
               start=os.path.relpath(calibrate_thresh.latest(start), ROOT),
               step=int(tr.step))
    with open(os.path.join(workdir, "eval_fresh.json"), "w") as f:
        json.dump(out, f, indent=1)
    log(json.dumps(out))
    return {"train": summary, "start": src,
            "metrics": [r for r in train_big.read_metrics(tr.log_path)
                        if "step" in r],
            "eval_fresh": out, "eval_flags": ex["solved"], "eval": ev,
            "workdir": workdir}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=DATA)
    ap.add_argument("--start", default=START,
                    help="the supervised run's directory")
    ap.add_argument("--out", default=WORKDIR, help="the workdir")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    finetune(a.data, a.start, a.out, a.epochs, a.device,
             log=lambda s: print(s, flush=True))
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
