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

import numpy as np
import torch

from allocnet_tpu_torch.config import (LossConfig, QPConfig, SolverConfig,
                                       TrainConfig)
from allocnet_tpu_torch.models import packing
from allocnet_tpu_torch.ops import qp_diff
from allocnet_tpu_torch.train import losses as losses_lib

TIME_MIN = 0.05   # floor of the active times the QP sees
# std of a unit normal truncated at +-2: flax's variance_scaling divides
# by it so that the truncated draw has the variance asked for
TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_params(net: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """The JAX package's initialization (`init_state`'s `net.init`,
    models/networks.py) of a ConvLSTMAllocNet or ConvMLPAllocNet, in
    place, with its draws: every weight of a Linear, Conv and the LSTM is
    flax's variance_scaling(2.0, "fan_in", "truncated_normal") draw under
    `jax.random.PRNGKey(seed)` (utils/jax_random: the parameter's own key
    from its path, a normal truncated at +-2 scaled by sqrt(2 / fan_in) /
    TRUNC_STD, fan_in taken in torch layout: in for a Linear or an LSTM
    matrix, in x kernel for a conv); every bias 0, LayerNorm scales 1, the
    ConvMLP's last bias 1.0.  The weights equal the JAX package's CPU
    `net.init` to 2 units in the last place of the truncation bound.
    Returns `net`."""
    from allocnet_tpu_torch.models import weights
    from allocnet_tpu_torch.models.networks import ConvMLPAllocNet
    from allocnet_tpu_torch.utils import jax_random

    mlp = isinstance(net, ConvMLPAllocNet)
    # the maps list each module's parameters in its declaration order,
    # which is the order flax counts them in
    paths = weights.MLP_JAX_TO_TORCH if mlp else weights.JAX_TO_TORCH
    counter, where = {}, {}
    for path, name in paths.items():
        counter[path[:-1]] = counter.get(path[:-1], 0) + 1
        where[name] = (path[:-1], counter[path[:-1]])
    for module_name, module in net.named_modules():
        for name, p in module.named_parameters(recurse=False):
            full = f"{module_name}.{name}" if module_name else name
            if isinstance(module, torch.nn.LayerNorm):
                p.fill_(1.0 if name == "weight" else 0.0)
            elif name.startswith("bias"):
                p.zero_()
            else:
                std = (np.sqrt(np.float32(2.0 / p[0].numel()))
                       / np.float32(TRUNC_STD))
                z = jax_random.truncated_normal(
                    jax_random.param_key(int(seed), *where[full]),
                    tuple(p.shape))
                p.copy_(torch.from_numpy(z * std))
    if mlp:
        net.output_module[8].bias.fill_(1.0)
    return net


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
