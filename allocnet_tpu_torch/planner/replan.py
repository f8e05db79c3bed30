"""Receding-horizon replanning: the solver budgets of the 10 Hz loop and
one batched replanning step.

Port of `allocnet_tpu/planner/replan.py` (its docstrings give the
measurements behind each budget).  The warm path reuses the previous
trajectory as the warm start (the old physical coefficients re-scaled into
the new problem's variables, qp.scale_coeffs) at a reduced iteration
budget; the batch is the number of vehicles replanning together.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from allocnet_tpu_torch.config import AllocNetConfig, SolverConfig
from allocnet_tpu_torch.models import packing
from allocnet_tpu_torch.models.networks import bind
from allocnet_tpu_torch.ops import admm, qp
from allocnet_tpu_torch.planner import refine as refine_lib
from allocnet_tpu_torch.utils.device import resolve_device


class ReplanState(NamedTuple):
    coeffs: torch.Tensor     # (B, S, 3, D) previous physical coefficients
    have_prev: torch.Tensor  # (B,) bool


def warm_solver_config(scfg: SolverConfig) -> SolverConfig:
    """Warm-started solves: one chunk of at least 150 iterations, at least
    4 polish rounds with a drop/enter pass, and no objective ceiling (a
    final-approach re-solve legitimately exceeds the plan-time window;
    the residual gates still reject divergence)."""
    return dataclasses.replace(
        scfg, n_chunks=1, iters_per_chunk=max(150, scfg.iters_per_chunk),
        polish_rounds=max(4, scfg.polish_rounds),
        polish_drop_passes=max(1, scfg.polish_drop_passes),
        obj_max=float("inf"))


def rescue_solver_config(scfg: SolverConfig) -> SolverConfig:
    """The light in-tick rescue: the cold budget's polish schedule over 2
    chunks of 150 iterations (fewer rho rescales keep a warm-started
    iterate near its fixed point)."""
    return dataclasses.replace(
        cold_solver_config(scfg), n_chunks=2, iters_per_chunk=150)


def cold_solver_config(scfg: SolverConfig) -> SolverConfig:
    """Certification-scale budget for cold plans: 4 chunks of 250
    iterations with exact re-factorization between them, at least 6
    polish rounds with a drop/enter pass."""
    return dataclasses.replace(
        scfg, n_chunks=4, iters_per_chunk=250, ns_rho_update=False,
        polish_rounds=max(6, scfg.polish_rounds),
        polish_drop_passes=max(1, scfg.polish_drop_passes))


def init_state(batch: int, cfg: AllocNetConfig, device=None) -> ReplanState:
    dev = resolve_device(device)
    S, D = cfg.qp.max_seg, cfg.qp.D
    return ReplanState(
        coeffs=torch.zeros((batch, S, 3, D), dtype=torch.float32, device=dev),
        have_prev=torch.zeros((batch,), dtype=torch.bool, device=dev))


def replan_step(net, params, cfg: AllocNetConfig, state, hpolys, seg,
                prev: ReplanState, time_scale: float = 1.0,
                warm: bool = True, refine_steps: int = 0, device=None):
    """One replanning step: network inference and the QP, warm-started
    from `prev` when `warm`.

    warm=False runs the full solver budget with no warm start (the
    reference's cold plan on a fresh goal); time_scale stretches the
    predicted times uniformly; refine_steps > 0 refines the allocation
    through the differentiable QP before the final solve (at the warm
    budget when `warm`).  `params` is a state_dict for `net`, or None for
    the weights it holds.  Runs on the card unless `device` says
    otherwise.

    Returns (times, coeffs, solved, new ReplanState)."""
    with torch.no_grad():
        return step(bind(net, params), cfg, state, hpolys, seg, prev,
                    time_scale, warm, refine_steps, resolve_device(device))


def step(net, cfg: AllocNetConfig, state, hpolys, seg, prev: ReplanState,
         time_scale: float, warm: bool, refine_steps: int, dev):
    """`replan_step`'s body for a net that holds its weights, on device
    `dev`, without the no_grad around it (models/export.save_replan
    traces it under its own)."""
    dtype = prev.coeffs.dtype
    state = torch.as_tensor(state, dtype=dtype, device=dev)
    hpolys = torch.as_tensor(hpolys, dtype=dtype, device=dev)
    seg = torch.as_tensor(seg, device=dev).long()

    out = net(packing.pack_state(state), packing.pack_hpolys(hpolys))
    times = (out[0] if isinstance(out, tuple) else out) * time_scale
    S = cfg.qp.max_seg
    seg_mask = (torch.arange(S, device=dev)[None, :]
                < seg[:, None]).to(times.dtype)
    times_q = torch.where(seg_mask > 0, times.clamp_min(0.05),
                          torch.ones_like(times))

    if refine_steps > 0:
        ref_scfg = warm_solver_config(cfg.solver) if warm else cfg.solver
        ref = refine_lib.refine_times(cfg.qp, ref_scfg, state, hpolys,
                                      times_q, seg, steps=refine_steps)
        times_q = ref.times + (1.0 - seg_mask)
        times = torch.where(seg_mask > 0, times_q, times)

    data = qp.build_qp(cfg.qp, state, hpolys, times_q, seg, device=dev)
    x0 = qp.scale_coeffs(data, prev.coeffs)
    x0 = x0 * prev.have_prev.to(x0.dtype).reshape(-1, 1, 1, 1)

    scfg = warm_solver_config(cfg.solver) if warm else cfg.solver
    sol = admm.solve_qp(data, scfg, x0=x0 if warm else None)

    new_prev = ReplanState(
        coeffs=torch.where(sol.solved.reshape(-1, 1, 1, 1), sol.coeffs,
                           prev.coeffs),
        have_prev=prev.have_prev | sol.solved)
    return times * seg_mask, sol.coeffs, sol.solved, new_prev
