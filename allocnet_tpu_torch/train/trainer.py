"""Training manager: epochs, validation, checkpoint and resume, metrics.

Port of `allocnet_tpu/train/trainer.py` (the reference's
MinSnapNetworkTrainingManager, train_minsnap_conv_lstm.py:24-332), on one
device.  Differences from the JAX module:

  * the Trainer takes a built nn.Module with its weights; a run from
    scratch initializes them first with `train_step.init_params(net,
    cfg.train.seed)`, the counterpart of the JAX `init_state`'s
    `net.init` (its very draws, utils/jax_random);
  * checkpoints are `torch.save` files `checkpoint{step}.pt` holding the
    model, optimizer and scheduler state dicts, the step and the epoch,
    not the JAX module's flax msgpack pytrees; the two formats do not read
    each other's files;
  * data parallelism (`use_mesh`) is one process per device: the net is
    wrapped in DistributedDataParallel over the process group
    (parallel/mesh.py), each rank trains on its slice of every batch and
    the gradients are averaged, which equals the whole batch's gradient
    (the loss is a mean over scenarios); rank 0 writes the metrics (of
    the whole batch) and the checkpoints.

Metrics go to `metrics.jsonl` with the JAX module's keys.  A step's
LossBundle stays on the device and is written out every `log_every` steps,
so logging adds no per-step host sync.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from allocnet_tpu_torch.config import AllocNetConfig
from allocnet_tpu_torch.train import dataset as ds_lib
from allocnet_tpu_torch.train import losses as losses_lib
from allocnet_tpu_torch.train import train_step as ts_lib
from allocnet_tpu_torch.utils.device import resolve_device


def save_checkpoint(ckpt_dir: str, net, opt, lr_sched, epoch: int,
                    step: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"checkpoint{step}.pt")
    torch.save({"model": net.state_dict(), "optimizer": opt.state_dict(),
                "scheduler": lr_sched.state_dict(), "step": step,
                "epoch": epoch}, path)
    return path


def latest_checkpoint(ckpt_dir: str, suffix: str = ".pt") -> str | None:
    """The highest-step `checkpoint{step}{suffix}` in ckpt_dir: the port's
    `.pt` files, or with suffix=".msgpack" the JAX package's."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [f for f in os.listdir(ckpt_dir)
             if f.startswith("checkpoint") and f.endswith(suffix)]
    if not cands:
        return None
    cands.sort(key=lambda f: int(f[len("checkpoint"):-len(suffix)]))
    return os.path.join(ckpt_dir, cands[-1])


def restore_checkpoint(path: str, net, opt, lr_sched) -> tuple[int, int]:
    """Load a checkpoint into (net, opt, lr_sched); returns (step, epoch)."""
    dev = next(net.parameters()).device
    payload = torch.load(path, map_location=dev, weights_only=True)
    net.load_state_dict(payload["model"])
    opt.load_state_dict(payload["optimizer"])
    lr_sched.load_state_dict(payload["scheduler"])
    return int(payload["step"]), int(payload["epoch"])


class Trainer:
    # flush buffered step metrics every N steps: reading a bundle's
    # scalars waits for the device
    log_every: int = 25

    def __init__(self, cfg: AllocNetConfig, net: torch.nn.Module,
                 loader: ds_lib.Loader, workdir: str, device=None,
                 use_mesh: bool | None = None):
        """`net` (its weights as given) moves to `device`: the card unless
        the caller asks for another one.  Resumes from the latest
        checkpoint in `workdir`/checkpoints if there is one.

        use_mesh: train data-parallel over the process group
        (`parallel.mesh.initialize_distributed` first); by default on when
        the group has more than one process.  Every rank passes the same
        loader (same seed), and the batch size must split over the ranks;
        rank 0's weights are broadcast to all at the start."""
        from allocnet_tpu_torch.parallel import mesh as mesh_lib

        self.cfg = cfg
        if use_mesh is None:
            use_mesh = mesh_lib.world()[0] > 1
        if use_mesh and not dist.is_initialized():
            raise ValueError("Trainer(use_mesh=True) needs a process group: "
                             "call parallel.mesh.initialize_distributed()")
        self.mesh = mesh_lib.make_mesh(device=device) if use_mesh else None
        self.dev = (self.mesh.device if self.mesh is not None
                    else resolve_device(device))
        self.net = net.to(self.dev)
        self.dtype = next(self.net.parameters()).dtype
        self.loader = loader
        self.workdir = workdir
        self.ckpt_dir = os.path.join(workdir, "checkpoints")
        self.log_path = os.path.join(workdir, "metrics.jsonl")
        os.makedirs(workdir, exist_ok=True)

        self.opt, self.lr_sched = ts_lib.make_optimizer(self.net, cfg.train)
        self.step = 0
        self.start_epoch = 0
        self.steps_s: list = []      # host s of each epoch's steps
        ck = latest_checkpoint(self.ckpt_dir)
        if ck is not None:
            self.step, self.start_epoch = restore_checkpoint(
                ck, self.net, self.opt, self.lr_sched)
        # the module the training step calls: the DDP wrapper averages
        # the gradients over the ranks in the backward
        self.model = self.net
        if self.mesh is not None:
            self.model = torch.nn.parallel.DistributedDataParallel(
                self.net, device_ids=([self.dev.index]
                                      if self.dev.type == "cuda" else None))
        self.is_writer = self.mesh is None or self.mesh.rank == 0

    def _log(self, record: dict) -> None:
        if not self.is_writer:
            return
        with open(self.log_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _flush_steps(self, pending: list) -> None:
        if not pending:
            return
        if self.mesh is not None:
            # each rank's bundles are of its slice: average them into the
            # whole batch's (equal slices, means over scenarios)
            stacked = torch.stack([torch.stack(list(b))
                                   for _, _, b in pending])
            dist.all_reduce(stacked)
            stacked /= self.mesh.size
            pending[:] = [(e, s, losses_lib.LossBundle(*row))
                          for (e, s, _), row in zip(pending, stacked)]
        if not self.is_writer:
            pending.clear()
            return
        with open(self.log_path, "a") as f:
            for epoch, step, bundle in pending:
                f.write(json.dumps({
                    "epoch": epoch, "step": step,
                    "obj": float(bundle.total), "obj1": float(bundle.obj1),
                    "objt": float(bundle.objt), "objc": float(bundle.objc),
                    "stop": float(bundle.stop),
                    "success_rate": float(bundle.success_rate),
                    "time_segment_accuracy": float(
                        bundle.time_segment_accuracy),
                }) + "\n")
        pending.clear()

    def to_device(self, batch: ds_lib.Batch, shard: bool = False):
        """(state, hpolys, seg, ref_times) tensors on the trainer's device
        in the net's dtype; with `shard` and a mesh, this rank's slice."""
        t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.dev)
        out = (t(batch.state), t(batch.hpolys),
               torch.as_tensor(batch.seg, device=self.dev).long(),
               t(batch.ref_times))
        if shard and self.mesh is not None:
            from allocnet_tpu_torch.parallel import mesh as mesh_lib
            out = mesh_lib.shard_batch(self.mesh, out)
        return out

    def train(self, max_epochs: int | None = None) -> torch.nn.Module:
        """Train from `start_epoch` to `max_epochs` (the config's if None);
        returns the net."""
        c = self.cfg
        epochs = max_epochs or c.train.max_epochs
        for epoch in range(self.start_epoch, epochs):
            t0 = time.time()
            pending: list = []
            for batch in self.loader.epoch(epoch, "train"):
                bundle = ts_lib.train_step(
                    self.model, self.opt, self.lr_sched, c.qp, c.solver,
                    c.loss, *self.to_device(batch, shard=True),
                    token_thresh=c.model.token_thresh)
                self.step += 1
                pending.append((epoch, self.step, bundle))
                if len(pending) >= self.log_every:
                    self._flush_steps(pending)
            self._flush_steps(pending)
            # the epoch's training steps, up to their last metrics read
            # back (a wait for the device); not written to the metrics
            self.steps_s.append(time.time() - t0)
            # validation (reference: train_minsnap_conv.py:287-332)
            with torch.no_grad():
                val = [ts_lib.loss_fn(self.net, c.qp, c.solver, c.loss,
                                      *self.to_device(b),
                                      c.model.token_thresh)[1]
                       for b in self.loader.epoch(epoch, "val")]
            if val:
                self._log({
                    "epoch": epoch, "split": "val",
                    "obj": float(np.mean([float(v.total) for v in val])),
                    "success_rate": float(np.mean(
                        [float(v.success_rate) for v in val])),
                })
            if (epoch + 1) % c.train.save_freq == 0 and self.is_writer:
                save_checkpoint(self.ckpt_dir, self.net, self.opt,
                                self.lr_sched, epoch + 1, self.step)
            self._log({"epoch": epoch, "wall_s": time.time() - t0})
        return self.net
