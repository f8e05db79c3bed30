"""End-to-end differentiable training step: net -> QP -> loss -> Adam.

Port of `allocnet_tpu/train/train_step.py` (the reference's train loop
core, minsnap_network_conv_lstm.py:464-505).  The batch goes through the
network, the batched differentiable solve (ops/qp_diff.py: on a card the
admm_chunk kernel forward, the implicit KKT system backward) and the
losses; `torch.optim.Adam` with `LambdaLR` over `cosine_warm_restarts`
updates the net.  The JAX TrainState (params, optimizer state, step) is
the nn.Module, the optimizer and the scheduler here.
"""

from __future__ import annotations

import math

import torch

from allocnet_tpu_torch.config import (LossConfig, QPConfig, SolverConfig,
                                       TrainConfig)
from allocnet_tpu_torch.models import packing
from allocnet_tpu_torch.ops import qp_diff
from allocnet_tpu_torch.train import losses as losses_lib

TIME_MIN = 0.05   # floor of the active times the QP sees


def cosine_warm_restarts(lr: float, t0: int, t_mult: int, eta_min: float,
                         total_steps: int = 200_000):
    """Learning rate as a function of the update index (0 for the first
    update): torch CosineAnnealingWarmRestarts as optax's joined cosine
    decay schedules compute it (the JAX module): within a period P that
    started at update s0, lr * ((1 - a) (1 + cos(pi k / P)) / 2 + a) with
    k = step - s0 and a = eta_min / lr; periods grow by t_mult and the last
    one, past total_steps, holds at eta_min once it ends."""
    alpha = eta_min / lr
    starts, periods = [], []
    period, start = t0, 0
    while start < total_steps:
        starts.append(start)
        periods.append(period)
        start += period
        period *= max(t_mult, 1)

    def schedule(step: int) -> float:
        i = 0
        while i + 1 < len(starts) and step >= starts[i + 1]:
            i += 1
        k = min(step - starts[i], periods[i])
        cos = 0.5 * (1.0 + math.cos(math.pi * k / periods[i]))
        return lr * ((1.0 - alpha) * cos + alpha)

    return schedule


def make_optimizer(net: torch.nn.Module, tcfg: TrainConfig):
    """(Adam, LambdaLR): the scheduler steps once per update, so update k
    runs at cosine_warm_restarts(k)."""
    sched = cosine_warm_restarts(tcfg.learning_rate, tcfg.t0, tcfg.t_mult,
                                 tcfg.eta_min)
    opt = torch.optim.Adam(net.parameters(), lr=tcfg.learning_rate)
    lr_sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda k: sched(k) / tcfg.learning_rate)
    return opt, lr_sched


def forward(net, qcfg: QPConfig, scfg: SolverConfig, state, hpolys, seg,
            tlb=None):
    """Net and differentiable solve for a batch of tensors on the net's
    device: (times (B, S), tokens (B, S) or None for an MLP net, sol, obj
    (B,) the differentiable QP objective).

    tlb (B, S): the reference's use_time_factor mode (min_traj_opt.py:
    113-133), where the net predicts a factor over the per-segment time
    lower bound.  The active times the QP sees are floored at 0.05 so the
    padded QP stays well posed for bad early predictions."""
    out = net(packing.pack_state(state), packing.pack_hpolys(hpolys))
    times, tokens = out if isinstance(out, tuple) else (out, None)
    if tlb is not None:
        times = tlb * (1.0 + times)

    S = qcfg.max_seg
    seg_mask = (torch.arange(S, device=times.device)[None, :]
                < seg[:, None]).to(times.dtype)
    times_q = torch.where(seg_mask > 0, torch.maximum(
        times, torch.full((), TIME_MIN, dtype=times.dtype,
                          device=times.device)), torch.ones_like(times))

    coeffs, sol = qp_diff.solve(qcfg, scfg, state, hpolys, times_q, seg)
    obj = qp_diff.objective(qcfg, state, hpolys, times_q, seg, coeffs)
    return times, tokens, sol, obj


def loss_fn(net, qcfg: QPConfig, scfg: SolverConfig, lcfg: LossConfig,
            state, hpolys, seg, ref_times, token_thresh: float, tlb=None):
    """(total, LossBundle) for a batch (see `forward`)."""
    times, tokens, sol, obj = forward(net, qcfg, scfg, state, hpolys, seg,
                                      tlb)
    bundle = losses_lib.compute_losses(
        lcfg, times, tokens, seg, sol.solved, obj, state,
        ref_times=ref_times, token_thresh=token_thresh)
    return bundle.total, bundle


def train_step(net, opt, lr_sched, qcfg: QPConfig, scfg: SolverConfig,
               lcfg: LossConfig, state, hpolys, seg, ref_times,
               token_thresh: float = 0.42, tlb=None):
    """One Adam update of `net` on a batch; returns the LossBundle,
    detached (device tensors, not synchronized)."""
    opt.zero_grad(set_to_none=True)
    total, bundle = loss_fn(net, qcfg, scfg, lcfg, state, hpolys, seg,
                            ref_times, token_thresh, tlb)
    total.backward()
    opt.step()
    lr_sched.step()
    return losses_lib.LossBundle(*(t.detach() for t in bundle))
