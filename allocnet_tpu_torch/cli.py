"""allocnet_tpu_torch command line: plan on a map, generate datasets,
train, evaluate, export.  The port's counterpart of scripts/allocnet.py
(same subcommands and arguments), plus --device: every subcommand runs on
the card unless it says otherwise.  --checkpoint takes a TorchScript .pt
(the reference's shipped format, or what `export` writes) or a flax
.msgpack (data/params/*.msgpack).

Usage:
  python -m allocnet_tpu_torch.cli datagen --out data/dataset.npz --n 512
  python -m allocnet_tpu_torch.cli train --dataset data/dataset.npz \\
      --workdir runs/e0
  python -m allocnet_tpu_torch.cli eval --dataset data/dataset.npz \\
      --checkpoint data/params/seq5_tokenthresh0_35.msgpack
  python -m allocnet_tpu_torch.cli plan --pcd map.pcd --start 1 1 1.5 \\
      --goal 18 18 2 --checkpoint ... --out artifacts/
  python -m allocnet_tpu_torch.cli export --checkpoint ... --out exported/

datagen --out and train/eval --dataset take a .npz file (state, hpolys,
times, seg, as train/corpus writes) or HDF5 (.h5, or for train/eval a
directory of .h5 shards; needs h5py), by the path's suffix; plan writes a
PNG (matplotlib).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np


def _cfg(args):
    from allocnet_tpu_torch.config import AllocNetConfig, QPConfig
    return AllocNetConfig(qp=QPConfig(res=args.res))


def _load_net(args):
    """The checkpoint's ConvLSTM (stop at token > 0.5, as the reference's
    deployed nets), on args.device."""
    from allocnet_tpu_torch.models import import_torch
    from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
    from allocnet_tpu_torch.utils.device import resolve_device

    sd = import_torch.load_params(args.checkpoint)
    seq = 5 if sd["hpoly_input_module.5.weight"].shape[1] == 16 else 10
    hidden = sd["output_module.weight_hh_l0"].shape[1]
    net = ConvLSTMAllocNet(seq_len=seq, hidden_size=hidden, token_thresh=0.5)
    net.load_state_dict(sd)
    return net.to(resolve_device(args.device)).eval()


def cmd_datagen(args):
    from allocnet_tpu_torch.train import datagen
    points = None
    if args.pcd:
        from allocnet_tpu_torch.utils import pcd
        points = pcd.read_pcd(args.pcd)
    sc = datagen.generate(_cfg(args), args.n, out_path=args.out,
                          points=points, seed=args.seed, device=args.device)
    print(json.dumps({"samples": int(sc.state.shape[0]), "out": args.out}))


def cmd_train(args):
    from allocnet_tpu_torch.config import TrainConfig
    from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
    from allocnet_tpu_torch.parallel import mesh as mesh_lib
    from allocnet_tpu_torch.train import dataset as ds_lib
    from allocnet_tpu_torch.train import trainer as trainer_lib

    mesh_lib.initialize_distributed()       # under torchrun: one per card
    cfg = _cfg(args)
    cfg = dataclasses.replace(cfg, train=TrainConfig(
        batch_size=args.batch_size, max_epochs=args.epochs))
    sc = ds_lib.read_scenarios(args.dataset, cfg.qp)
    loader = ds_lib.Loader(sc, batch_size=cfg.train.batch_size)
    net = ConvLSTMAllocNet(seq_len=cfg.model.seq_len,
                           hidden_size=args.hidden,
                           token_thresh=cfg.model.token_thresh)
    tr = trainer_lib.Trainer(cfg, net, loader, args.workdir,
                             device=args.device)
    tr.train()
    print(json.dumps({"workdir": args.workdir, "steps": tr.step}))


def cmd_eval(args):
    from allocnet_tpu_torch.train import dataset as ds_lib
    from allocnet_tpu_torch.train import evaluate
    cfg = _cfg(args)
    net = _load_net(args)
    sc = ds_lib.read_scenarios(args.dataset, cfg.qp)
    rep = evaluate.evaluate(net, cfg, sc, device=args.device)
    print(json.dumps({k: float(v) for k, v in rep._asdict().items()}))


def cmd_plan(args):
    from allocnet_tpu_torch.planner import planner as planner_lib
    from allocnet_tpu_torch.train import datagen
    from allocnet_tpu_torch.viz import artifacts

    cfg = _cfg(args)
    if args.pcd:
        from allocnet_tpu_torch.utils import pcd
        points = pcd.read_pcd(args.pcd)
        lo = points.min(axis=0) - 0.5
        hi = points.max(axis=0) + 0.5
    else:
        points = datagen.random_pillar_map(args.seed)
        lo, hi = np.zeros(3), np.array([20.0, 20.0, 4.0])

    net = _load_net(args)
    pmap = planner_lib.build_map(points, lo, hi, device=args.device)
    out = planner_lib.plan_many(
        pmap, np.asarray([args.start]), np.asarray([args.goal]),
        net, None, cfg, seed=args.seed, refine_steps=args.refine,
        device=args.device)
    os.makedirs(args.out, exist_ok=True)
    ok = bool(out.corridor_ok[0]) and bool(out.result.ok[0])
    reason = out.reasons[0]
    if reason == "ok" and not ok:
        # the corridor succeeded; name the stage that failed after it
        # (the reference's taxonomy: bad predicted times against a QP
        # failure, learning_planner.hpp:181-189, qp_solver.hpp:334-352)
        reason = "bad_times" if bool(out.result.solved[0]) else "qp_failed"
    report = {"ok": ok, "reason": reason,
              "times": out.result.times[0].cpu().tolist(),
              "obj": float(out.result.obj[0])}
    if out.corridor_ok[0]:
        path = os.path.join(args.out, "trajectory.png")
        artifacts.plot_trajectory(out.traj, 0, path)
        report["artifact"] = path
    print(json.dumps(report))


def cmd_export(args):
    from allocnet_tpu_torch.models import export as export_lib
    net = _load_net(args)
    export_lib.save(args.out, net, seq_len=net.seq_len)
    print(json.dumps({"out": args.out}))


def main(argv=None):
    p = argparse.ArgumentParser(
        description="allocnet_tpu_torch: plan, generate datasets, train, "
                    "evaluate, export (PyTorch/CUDA)")
    p.add_argument("--res", type=int, default=20)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("datagen")
    d.add_argument("--out", required=True)
    d.add_argument("--n", type=int, default=256)
    d.add_argument("--pcd", default=None)
    d.add_argument("--seed", type=int, default=0)
    d.set_defaults(fn=cmd_datagen)

    t = sub.add_parser("train")
    t.add_argument("--dataset", required=True)
    t.add_argument("--workdir", required=True)
    t.add_argument("--batch-size", type=int, default=32)
    t.add_argument("--epochs", type=int, default=50)
    t.add_argument("--hidden", type=int, default=256)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval")
    e.add_argument("--dataset", required=True)
    e.add_argument("--checkpoint", required=True)
    e.set_defaults(fn=cmd_eval)

    pl = sub.add_parser("plan")
    pl.add_argument("--pcd", default=None)
    pl.add_argument("--start", type=float, nargs=3, required=True)
    pl.add_argument("--goal", type=float, nargs=3, required=True)
    pl.add_argument("--checkpoint", required=True)
    pl.add_argument("--out", default="artifacts")
    pl.add_argument("--seed", type=int, default=0)
    pl.add_argument("--refine", type=int, default=0, metavar="STEPS",
                    help="time-refinement steps (0 = off): redistribute the "
                         "net's total time across segments by gradient "
                         "descent through the differentiable QP")
    pl.set_defaults(fn=cmd_plan)

    ex = sub.add_parser("export")
    ex.add_argument("--checkpoint", required=True)
    ex.add_argument("--out", required=True)
    ex.set_defaults(fn=cmd_export)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
