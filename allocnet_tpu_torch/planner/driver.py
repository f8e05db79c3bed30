"""Clocked receding-horizon driver: the 10 Hz replanning loop.

Port of `allocnet_tpu/planner/driver.py` (its docstring gives the design
and the measurements behind it).  In short: a cold tick (reset or goal
change) runs the network once and solves the QP over a small batch of
uniform time stretches (`HEDGE_SCALES`), keeping the first feasible one.
Every later tick re-solves the QP from the pinned current state, warm-
started with the previous plan shifted by one tick period (primal and
dual), falls back to tracking the previous plan when the solve misses, and
advances the vehicle along the accepted plan while rolling the corridor,
times, coefficients and multipliers forward.  A first segment much
shorter than the next (a sliver) is frozen to the previous plan and only
the rest of the corridor is re-solved.  A warm tick that misses runs a
4-lane rescue (the split and the full problem, each warm and from
scratch) at a light budget, then at the cold budget.

What differs from the JAX module:

* the tick functions run eagerly (`jax.jit` per shape has no counterpart
  here);
* the rescue ladder of `_combined_tick` branches on the host (`if` on the
  B=1 `solved` flag, one device sync) where the JAX module uses an
  in-program `lax.cond`; the tick syncs anyway to read the advanced state;
* `TickResult.rescue` records which stage of the ladder accepted the plan;
* the fast start (`enable_compilation_cache`, `Driver(cache_dir=,
  aot_path=)`, `save_aot`) keeps prebuilt libraries, not serialized
  programs: the port traces and compiles nothing, and what a fresh process
  pays before its first tick is the `nvcc` builds of the two kernels and
  the `g++` build of the native runtime;
* `onchip_tick_cost` chains the ticks in a Python loop (no `lax.scan`)
  that reads nothing back to the host until the last tick.

Device state (the previous plan and its multipliers) stays on the
driver's device; the host keeps a handful of scalars per tick.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from allocnet_tpu_torch.config import AllocNetConfig, SolverConfig
from allocnet_tpu_torch.models import packing
from allocnet_tpu_torch.models.networks import bind
from allocnet_tpu_torch.ops import admm, admm_chunk, ldl, qp
from allocnet_tpu_torch.planner import control, native, replan, trajectory
from allocnet_tpu_torch.planner import refine as refine_lib
from allocnet_tpu_torch.utils.device import resolve_device

# cold-tick feasibility hedge: uniform stretches of the predicted times,
# solved as one batch; the first (smallest) feasible stretch wins
HEDGE_SCALES = (1.0, 1.45, 2.1)

# minimum carried segment time; below it the advance snaps to the next
# junction (refine.py's t_min and replan's 0.05 clamp)
T_MIN = 0.05

# a first segment shorter than this fraction of the next is a sliver: the
# warm tick freezes piece 1 and re-solves only the suffix
SLIVER_RATIO = 0.6


class PlanState(NamedTuple):
    """The previous accepted plan, aligned to the current (rolled)
    corridor, with its multipliers as the dual warm start."""
    coeffs: torch.Tensor     # (B, S, 3, D) physical coefficients
    times: torch.Tensor      # (B, S) masked segment times (0 on padding)
    have_prev: torch.Tensor  # (B,) bool
    duals: dict              # {start, end, junc, corr, box} multipliers


class DriverState(NamedTuple):
    """Host-side loop state of one vehicle."""
    pos: np.ndarray          # (3,)
    vel: np.ndarray          # (3,)
    acc: np.ndarray          # (3,)
    hpolys: np.ndarray       # (S, F, 4) normalized corridor (a.x <= b)
    seg: int                 # active polytope count
    goal: np.ndarray         # (3,)
    prev: PlanState
    done: bool = False       # arrived at the goal


class TickResult(NamedTuple):
    times: np.ndarray
    solved: bool             # this tick's QP converged
    state: DriverState
    telemetry: control.ControlSample | None
    latency_s: float
    tracking: bool = False   # the solve missed: the previous plan is tracked
    certified: bool | None = None  # f64 Bernstein box certificate of the
    #   accepted plan (certify=True only; outside the timed region)
    rescue: int = 0          # the rescue stage that accepted the plan: 0
    #   none, 1 light (2 x 150), 2 heavy (the cold budget)


def zero_duals(batch: int, qcfg, device=None, dtype=torch.float32) -> dict:
    """All-zero multiplier tree (cold start)."""
    S, R, F, o = qcfg.max_seg, qcfg.res, qcfg.max_faces, qcfg.order
    z = lambda *sh: torch.zeros((batch,) + sh, dtype=dtype, device=device)
    return {'start': z(3, 3), 'end': z(3, 3), 'junc': z(S - 1, 3, o),
            'corr': z(S, R, F), 'box': z(S, R, 3, 4)}


def _sol_duals(sol) -> dict:
    """Multiplier tree of a QPSolution: equality rows from `nu`, laid out
    as qp.tree_flat over EQ_KEYS (start (3, 3), end (3, 3), junc (S-1, 3,
    o)), inequality rows from `lam`."""
    nu, lam = sol.nu, sol.lam
    B = nu.shape[0]
    S = lam['corr'].shape[1]
    junc = nu[:, 18:]
    o = junc.shape[1] // (3 * (S - 1))
    return {'start': nu[:, :9].reshape(B, 3, 3),
            'end': nu[:, 9:18].reshape(B, 3, 3),
            'junc': junc.reshape(B, S - 1, 3, o),
            'corr': lam['corr'], 'box': lam['box']}


def _take(a: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """a[b, ix[b, k]]: (B, K, ...) gathered along the segment axis."""
    return a[torch.arange(a.shape[0], device=a.device)[:, None], ix]


def _seg_mask(seg: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return (torch.arange(n, device=seg.device)[None, :]
            < seg[:, None]).to(dtype)


def _roll_duals(duals: dict, src: torch.Tensor, seg_new: torch.Tensor,
                zero_first: bool = False) -> dict:
    """Shift the multiplier tree along the segment axis (src = gather
    indices, as for hpolys and coeffs).  start/end are kept: they only
    seed the warm start.  zero_first also clears slot 0 (a frozen piece
    has no live multipliers)."""
    S = src.shape[1]
    dt = duals['corr'].dtype
    mask = _seg_mask(seg_new, S, dt)
    corr = _take(duals['corr'], src) * mask[:, :, None, None]
    box = _take(duals['box'], src) * mask[:, :, None, None, None]
    src_j = torch.clamp(src[:, :S - 1], 0, S - 2)
    mask_j = _seg_mask(seg_new - 1, S - 1, dt)
    junc = _take(duals['junc'], src_j) * mask_j[:, :, None, None]
    if zero_first:
        corr[:, 0] = 0.0
        box[:, 0] = 0.0
        junc[:, 0] = 0.0
    return {'start': duals['start'], 'end': duals['end'], 'junc': junc,
            'corr': corr, 'box': box}


def init_plan(batch: int, cfg: AllocNetConfig, device=None) -> PlanState:
    S, D = cfg.qp.max_seg, cfg.qp.D
    return PlanState(
        coeffs=torch.zeros((batch, S, 3, D), dtype=torch.float32,
                           device=device),
        times=torch.zeros((batch, S), dtype=torch.float32, device=device),
        have_prev=torch.zeros((batch,), dtype=torch.bool, device=device),
        duals=zero_duals(batch, cfg.qp, device))


# ---------------------------------------------------------------------------
# host-side geometry helpers (NumPy, as in the JAX module)
# ---------------------------------------------------------------------------

def point_in_poly(hpoly: np.ndarray, p: np.ndarray, slack: float = 1e-6):
    """All-faces test for normalized rows [a, b] meaning a.x <= b; zero rows
    (padding) are inert."""
    a, b = hpoly[:, :3], hpoly[:, 3]
    live = np.abs(a).sum(axis=1) > 1e-9
    return bool(np.all(a[live] @ p <= b[live] + slack)) if live.any() else False


def nudge_inside(hpoly: np.ndarray, p: np.ndarray, margin: float = 0.05,
                 iters: int = 4) -> np.ndarray:
    """Project p to be >= margin inside every live face of a normalized
    polytope (rows [a, b], |a| = 1, a.x <= b)."""
    a, b = hpoly[:, :3], hpoly[:, 3]
    live = np.abs(a).sum(axis=1) > 1e-9
    q = p.astype(np.float64).copy()
    for _ in range(iters):
        v = a[live] @ q - (b[live] - margin)
        if v.max() <= 0:
            break
        i = int(np.argmax(v))
        q = q - v[i] * a[live][i]
    return q


def trim_passed(hpolys: np.ndarray, seg: int, p: np.ndarray):
    """Drop the corridor prefix the vehicle has left: keep from the LAST
    polytope that contains p (consecutive polytopes overlap)."""
    idx = 0
    for i in range(seg):
        if point_in_poly(hpolys[i], p):
            idx = i
    if idx == 0:
        return hpolys, seg
    out = np.zeros_like(hpolys)
    out[:seg - idx] = hpolys[idx:seg]
    return out, seg - idx


# ---------------------------------------------------------------------------
# device-side tick functions
# ---------------------------------------------------------------------------

def _nudge_device(hpoly: torch.Tensor, p: torch.Tensor, margin: float = 5e-3,
                  iters: int = 4) -> torch.Tensor:
    """Batched most-violated-face projection: hpoly (B, F, 4), p (B, 3)."""
    a, b = hpoly[..., :3], hpoly[..., 3]
    live = a.abs().sum(-1) > 1e-9
    rows = torch.arange(a.shape[0], device=a.device)
    for _ in range(iters):
        v = torch.where(live, torch.einsum('bfj,bj->bf', a, p) - (b - margin),
                        torch.full_like(b, -1.0))
        ai = a[rows, torch.argmax(v, dim=1)]
        step = v.amax(1).clamp_min(0.0)
        p = p - step[:, None] * ai
    return p


class _Advance(NamedTuple):
    state9: torch.Tensor     # (B, 2, 3, 3) next pinned start + goal
    hpolys: torch.Tensor     # (B, S, F, 4) rolled corridor
    seg: torch.Tensor        # (B,)
    prev: PlanState          # rolled/shifted plan = next tick's warm start
    done: torch.Tensor       # (B,) bool: arrived (goal at rest)


def _advance(cfg: AllocNetConfig, dt: float, plan_c, times_q, state9, hpolys,
             seg, duals) -> _Advance:
    """Advance the vehicle dt along (plan_c, times_q) and roll the corridor,
    times, coefficients and multipliers so the remainder starts at the new
    state."""
    qcfg = cfg.qp
    S = qcfg.max_seg
    dtype, dev = plan_c.dtype, plan_c.device
    B = plan_c.shape[0]
    rows = torch.arange(B, device=dev)
    mask = _seg_mask(seg, S, dtype)
    dtimes = times_q * mask
    traj = trajectory.Trajectory(coeffs=plan_c, times=dtimes, seg_mask=mask)
    total = dtimes.sum(1)
    dtv = torch.full((B,), dt, dtype=dtype, device=dev)

    idx, u = trajectory._locate(traj, dtv)
    rem = dtimes[rows, idx] - u
    # a remainder below T_MIN snaps to the junction: the advance lands at
    # the start of the next piece instead of carrying a sliver segment
    snap = rem < T_MIN
    idx2 = idx + snap.long()
    done = (total - dt <= T_MIN) | (idx2 >= seg)
    idx2c = torch.clamp(idx2, 0, S - 1)
    zero = torch.zeros((), dtype=dtype, device=dev)
    u2 = torch.where(snap, zero, u)

    seg_start = dtimes.cumsum(1) - dtimes
    t_eval = torch.where(done, total, seg_start[rows, idx2c] + u2)
    adv = trajectory.eval_state(traj, t_eval, max_deriv=2)   # (B, 3, 3)

    roll = torch.where(done, torch.zeros_like(idx2c), idx2c)
    src = torch.clamp(roll[:, None] + torch.arange(S, device=dev)[None, :],
                      0, S - 1)
    seg_new = seg - roll
    mask_new = _seg_mask(seg_new, S, dtype)

    hp_new = _take(hpolys, src) * mask_new[:, :, None, None]
    t_roll = _take(dtimes, src)
    times_new = t_roll.clone()
    times_new[:, 0] = torch.where(snap, t_roll[:, 0], rem)
    times_new = times_new * mask_new

    c_roll = _take(plan_c, src)
    coeffs_new = c_roll.clone()
    coeffs_new[:, 0] = trajectory.taylor_shift(c_roll[:, 0], u2)
    coeffs_new = coeffs_new * mask_new[:, :, None, None]

    # pin the next start: a mm-scale corridor nudge and a box clip close
    # the re-sampled-constraint gap
    vmax = qcfg.max_vel * (1.0 - 1e-3)
    amax = qcfg.max_acc * (1.0 - 1e-3)
    pos = _nudge_device(hp_new[:, 0], adv[:, 0])
    vel = torch.clamp(adv[:, 1], -vmax, vmax)
    acc = torch.clamp(adv[:, 2], -amax, amax)
    still = done[:, None]
    start = torch.stack([pos, torch.where(still, zero, vel),
                         torch.where(still, zero, acc)], dim=-1)
    state9_new = state9.clone()
    state9_new[:, 0] = start

    prev = PlanState(coeffs=coeffs_new, times=times_new,
                     have_prev=torch.ones((B,), dtype=torch.bool, device=dev),
                     duals=_roll_duals(duals, src, seg_new))
    return _Advance(state9=state9_new, hpolys=hp_new, seg=seg_new,
                    prev=prev, done=done)


def _where_b(c: torch.Tensor, b, a):
    """torch.where with the (B,) condition broadcast over a's trailing
    axes."""
    return torch.where(c.reshape((-1,) + (1,) * (a.ndim - 1)), b, a)


def _warm_tick(cfg: AllocNetConfig, dt: float, refine_steps: int,
               strong: bool, state9, hpolys, seg, prev: PlanState,
               sliver_ratio: float = SLIVER_RATIO,
               rescue_scfg: SolverConfig | None = None):
    """One warm tick: re-solve from the pinned state with the shifted
    previous plan as warm start, fall back to it on failure, advance.
    Returns (solved, plan_c, times, advance).

    When t1 < sliver_ratio * t2 piece 1 is frozen to the previous plan's
    sub-arc and only the rest of the corridor is re-solved from the
    junction state, then spliced back.  `strong` runs the 4-lane rescue
    instead of the fast solve (see the module docstring)."""
    qcfg = cfg.qp
    S, D = qcfg.max_seg, qcfg.D
    dtype, dev = prev.coeffs.dtype, prev.coeffs.device
    B = state9.shape[0]
    mask = _seg_mask(seg, S, dtype)
    one = torch.ones((), dtype=dtype, device=dev)
    times_q = torch.where(mask > 0, prev.times.clamp_min(T_MIN), one)

    if refine_steps > 0:
        ref = refine_lib.refine_times(qcfg, replan.warm_solver_config(
            cfg.solver), state9, hpolys, times_q, seg, steps=refine_steps)
        times_q = torch.where(mask > 0, ref.times.clamp_min(T_MIN), one)

    sliver = (seg > 1) & (times_q[:, 0] < sliver_ratio * times_q[:, 1])

    # sub-problem: corridor and plan rolled by one, the start pinned at
    # the junction state of the previous plan's piece 0
    rows = torch.stack([trajectory._deriv_row(D, r, times_q[:, 0])
                        for r in range(3)], dim=1)              # (B, 3, D)
    junc = torch.einsum('brd,bxd->bxr', rows, prev.coeffs[:, 0])
    state9_b = state9.clone()
    state9_b[:, 0] = junc
    src = torch.clamp(torch.arange(S, device=dev) + 1, 0, S - 1).expand(B, S)
    hp_b = _take(hpolys, src)
    seg_b = seg - 1
    mask_b = _seg_mask(seg_b, S, dtype)
    times_b = torch.where(mask_b > 0, _take(times_q, src), one)
    coeffs_b = _take(prev.coeffs, src)

    sel = lambda b, a: _where_b(sliver, b, a)
    state9_s = sel(state9_b, state9)
    hp_s = sel(hp_b, hpolys)
    times_s = sel(times_b, times_q)
    seg_s = torch.where(sliver, seg_b, seg)
    warm_c = sel(coeffs_b, prev.coeffs)
    duals_b = _roll_duals(prev.duals, src, seg_b)
    y0 = {k: sel(duals_b[k], prev.duals[k]) for k in prev.duals}

    data = qp.build_qp(qcfg, state9_s, hp_s, times_s, seg_s, device=dev)
    x0 = qp.scale_coeffs(data, warm_c)

    def _splice(sol, sol_d):
        """A split-problem solution in full-corridor slots: slot 0 = the
        frozen previous piece, slots 1.. = the sub-problem's pieces."""
        dst = torch.clamp(torch.arange(S, device=dev) - 1, 0,
                          S - 1).expand(B, S)
        unrolled = _take(sol.coeffs, dst)
        unrolled[:, 0] = prev.coeffs[:, 0]
        sol_d_un = _roll_duals(sol_d, dst, seg, zero_first=True)
        return (sel(unrolled, sol.coeffs),
                {k: sel(sol_d_un[k], sol_d[k]) for k in sol_d})

    if strong:
        # the rescue: the split problem warm and from scratch, the full
        # problem warm and from scratch, as one batch of 4B; any solved
        # lane wins, the lower objective on ties
        scfg_t = (rescue_scfg if rescue_scfg is not None
                  else replan.cold_solver_config(cfg.solver))
        data_f = qp.build_qp(qcfg, state9, hpolys, times_q, seg, device=dev)
        x0f = qp.scale_coeffs(data_f, prev.coeffs)
        data4 = qp.concat([data, data, data_f, data_f])
        x04 = torch.cat([x0, torch.zeros_like(x0), x0f,
                         torch.zeros_like(x0f)])
        y04 = {k: torch.cat([y0[k], torch.zeros_like(y0[k]), prev.duals[k],
                             torch.zeros_like(prev.duals[k])])
               for k in y0}
        sol4 = admm.solve_qp(data4, scfg_t, x0=x04, y0=y04)
        cands = []
        for i in range(4):
            sol_i = type(sol4)(*(
                {k: v[i * B:(i + 1) * B] for k, v in f.items()}
                if isinstance(f, dict) else f[i * B:(i + 1) * B]
                for f in sol4))
            d_i = _sol_duals(sol_i)
            c_i = sol_i.coeffs
            if i < 2:
                c_i, d_i = _splice(sol_i, d_i)
            cands.append((sol_i.solved, sol_i.obj, c_i, d_i))
        solved, obj, sol_c, sol_d = cands[0]
        for s2, o2, c2, d2 in cands[1:]:
            take = s2 & (~solved | (o2 < obj))
            sol_c = _where_b(take, c2, sol_c)
            sol_d = {k: _where_b(take, d2[k], sol_d[k]) for k in sol_d}
            obj = torch.where(take, o2, obj)
            solved = solved | s2
    else:
        sol = admm.solve_qp(data, replan.warm_solver_config(cfg.solver),
                            x0=x0, y0=y0)
        sol_c, sol_d = _splice(sol, _sol_duals(sol))
        solved = sol.solved

    plan_c = _where_b(solved, sol_c, prev.coeffs)
    plan_d = {k: _where_b(solved, sol_d[k], prev.duals[k]) for k in sol_d}
    adv = _advance(cfg, dt, plan_c, times_q, state9, hpolys, seg, plan_d)
    return solved, plan_c, times_q * mask, adv


def _cold_tick(net, cfg: AllocNetConfig, dt: float, time_scale: float,
               state9, hpolys, seg):
    """Cold tick (fresh goal): the network once, then one batched solve
    over the feasibility hedge; the first feasible stretch wins.  Returns
    (solved, plan_c, times, advance)."""
    qcfg = cfg.qp
    S = qcfg.max_seg
    out = net(packing.pack_state(state9), packing.pack_hpolys(hpolys))
    times = (out[0] if isinstance(out, tuple) else out) * time_scale
    dtype, dev = times.dtype, times.device
    B = times.shape[0]
    H = len(HEDGE_SCALES)
    mask = _seg_mask(seg, S, dtype)
    # a stop token that fired a step early leaves an active slot at time
    # 0: fill it with the mean of the nonzero active predictions (flooring
    # it at T_MIN would make a numerically infeasible terminal sliver)
    active = mask > 0
    truncated = active & (times <= 1e-6)
    nz = active & ~truncated
    nz_mean = (torch.where(nz, times, torch.zeros_like(times)).sum(1)
               / nz.sum(1).clamp_min(1).to(dtype))
    times = torch.where(truncated, nz_mean[:, None], times)

    scales = torch.tensor(HEDGE_SCALES, dtype=dtype, device=dev)
    times_h = (times[None] * scales[:, None, None]).reshape(H * B, S)
    mask_h = mask.repeat(H, 1)
    times_qh = torch.where(mask_h > 0, times_h.clamp_min(T_MIN),
                           torch.ones_like(times_h))
    data = qp.build_qp(qcfg, state9.repeat(H, 1, 1, 1),
                       hpolys.repeat(H, 1, 1, 1), times_qh, seg.repeat(H),
                       device=dev)
    sol = admm.solve_qp(data, replan.cold_solver_config(cfg.solver))

    solved_h = sol.solved.reshape(H, B)
    first = torch.argmax(solved_h.to(torch.int32), dim=0)   # first feasible
    solved = solved_h.any(0)
    cols = torch.arange(B, device=dev)
    pick = lambda a: a.reshape((H, B) + a.shape[1:])[first, cols]
    plan_c = pick(sol.coeffs)
    times_q = pick(times_qh)
    plan_d = {k: pick(v) for k, v in _sol_duals(sol).items()}

    adv = _advance(cfg, dt, plan_c, times_q, state9, hpolys, seg, plan_d)
    # an unsolved cold tick has no plan: the caller discards the advance
    return solved, plan_c, times_q * mask, adv


def _combined_tick(cfg: AllocNetConfig, dt: float, refine_steps: int,
                   state9, hpolys, seg, prev: PlanState):
    """The warm tick with its rescue ladder: the fast warm solve; if it
    misses, the 4-lane rescue at the light budget (replan.
    rescue_solver_config); if that misses, at the cold budget.  The ladder
    branches on the host on the B=1 flag.  Returns (solved, plan_c, times,
    advance, stage), stage = the rescue that ran last (0, 1 or 2)."""
    out = _warm_tick(cfg, dt, refine_steps, False, state9, hpolys, seg, prev)
    if bool(out[0][0]):
        return out + (0,)
    out = _warm_tick(cfg, dt, refine_steps, True, state9, hpolys, seg, prev,
                     rescue_scfg=replan.rescue_solver_config(cfg.solver))
    if bool(out[0][0]):
        return out + (1,)
    return _warm_tick(cfg, dt, refine_steps, True, state9, hpolys, seg,
                      prev) + (2,)


def make_warm_tick(cfg: AllocNetConfig, rate_hz: float = 10.0,
                   refine_steps: int = 0, strong: bool = False,
                   sliver_ratio: float = SLIVER_RATIO):
    return lambda state9, hpolys, seg, prev: _warm_tick(
        cfg, 1.0 / rate_hz, refine_steps, strong, state9, hpolys, seg, prev,
        sliver_ratio=sliver_ratio)


def make_combined_tick(cfg: AllocNetConfig, rate_hz: float = 10.0,
                       refine_steps: int = 0):
    return lambda state9, hpolys, seg, prev: _combined_tick(
        cfg, 1.0 / rate_hz, refine_steps, state9, hpolys, seg, prev)


def make_cold_tick(net, cfg: AllocNetConfig, params, rate_hz: float = 10.0,
                   time_scale: float = 1.0):
    """The cold tick as a function of (state9 (1, 2, 3, 3), hpolys (1, S,
    F, 4), seg (1,)) on the net's device; `params` as for `Driver`."""
    net = bind(net, params)

    @torch.no_grad()
    def cold(state9, hpolys, seg):
        return _cold_tick(net, cfg, 1.0 / rate_hz, time_scale, state9,
                          hpolys, seg.long())
    return cold


# ---------------------------------------------------------------------------
# fast start: prebuilt libraries
# ---------------------------------------------------------------------------

def enable_compilation_cache(cache_dir: str) -> None:
    """Build the two kernels (nvcc) and the native runtime (g++) into
    `cache_dir` and load them from there: a directory kept between
    processes builds each library once (the libraries are keyed by a hash
    of their source and flags)."""
    os.makedirs(cache_dir, exist_ok=True)
    for mod in _AOT_LIBS.values():
        mod.set_build_dir(cache_dir)


# the libraries of the fast start: the ADMM chunk kernel, the polish's
# LDL^T block kernel, the native runtime
_AOT_LIBS = {"kernel": admm_chunk, "ldl": ldl, "native": native}


def _aot_manifest(cfg: AllocNetConfig, params: dict, device) -> dict:
    """Compatibility fingerprint of a saved library set: the libraries are
    valid for the same sources (their names carry the hashes), torch
    version and card; the config repr and the params digest pin the
    checkpoint the artefact flies (a stale artefact must not fly an old
    network).  No kernel libraries on the CPU."""
    h = hashlib.sha256()
    for k, v in sorted(params.items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    return {"torch": torch.__version__,
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "capability": (list(torch.cuda.get_device_capability(dev))
                           if cuda else None),
            "cfg": repr(cfg), "params_sha": h.hexdigest()[:16],
            "kernel": admm_chunk.library_name() if cuda else None,
            "ldl": ldl.library_name() if cuda else None,
            "native": native.library_name()}


def _aot_dummy_args(cfg: AllocNetConfig, goal_dist: float = 5.0,
                    device=None):
    """B=1 inputs of the cold tick (state9, hpolys, seg) on a generous box
    corridor around a straight segment: feasible, so a cold and a warm
    tick run their whole path on it."""
    S, F = cfg.qp.max_seg, cfg.qp.max_faces
    hp = np.zeros((1, S, F, 4), np.float32)
    box = np.array([[1, 0, 0, goal_dist + 2.0], [-1, 0, 0, 2.0],
                    [0, 1, 0, 2.0], [0, -1, 0, 2.0],
                    [0, 0, 1, 4.0], [0, 0, -1, 1.0]], np.float32)
    hp[0, :2, :6] = box
    st = np.zeros((1, 2, 3, 3), np.float32)
    st[0, 1, 0, 0] = goal_dist
    st[0, 1, 2, 0] = 1.0
    t = lambda a: torch.as_tensor(a, device=device)
    return t(st), t(hp), t(np.array([2]))


# ---------------------------------------------------------------------------
# host driver
# ---------------------------------------------------------------------------

class Driver:
    """Single-vehicle receding-horizon driver (device batch of 1).

    net: a time-allocation nn.Module (models/networks.py); params: its
    state_dict (models/weights.load_params), or None for the weights it
    holds.  Runs on the card unless `device` says otherwise.

    box_margin tightens the vel/acc box the tick solves use (the mission
    limits stay cfg.qp.*): the QP samples the box at res points per
    segment, and a plan feasible at the samples can exceed the limit
    between them; 0.5% makes the flown plans carry the strict f64
    Bernstein certificate at the mission limits (certify=True checks
    every accepted plan, outside the timed region).

    cache_dir: where the kernels and the native runtime are built and
    loaded from (`enable_compilation_cache`).  aot_path: a directory that
    `save_aot` wrote; when its manifest matches, its prebuilt libraries
    are taken and `aot_loaded` is True, so the first tick builds nothing;
    otherwise the libraries are built at first use, as without it."""

    def __init__(self, net, params, cfg: AllocNetConfig,
                 rate_hz: float = 10.0, telemetry_hz: float = 1000.0,
                 time_scale: float = 1.0, refine_steps: int = 0,
                 certify: bool = False, box_margin: float = 0.005,
                 device=None, cache_dir: str | None = None,
                 aot_path: str | None = None):
        self.device = resolve_device(device)
        if cache_dir:
            enable_compilation_cache(cache_dir)
        self.certify = certify
        # a copy on the driver's device: the caller's net stays where it is
        self.net = (copy.deepcopy(net) if params is None
                    else bind(net, params)).to(self.device).eval()
        self.cfg = cfg
        m = 1.0 - box_margin
        self.cfg_tick = dataclasses.replace(cfg, qp=dataclasses.replace(
            cfg.qp, max_vel=cfg.qp.max_vel * m, max_acc=cfg.qp.max_acc * m))
        self.rate_hz = rate_hz
        self.telemetry_hz = telemetry_hz
        ct = self.cfg_tick
        self._cold = make_cold_tick(self.net, ct, None, rate_hz, time_scale)
        self._tick = make_combined_tick(ct, rate_hz, refine_steps)
        self.aot_loaded = aot_path is not None and self._load_aot(aot_path)

    # -- prebuilt libraries (fast cold start) ------------------------------

    def save_aot(self, path: str) -> dict:
        """Run a cold and a warm tick (`prewarm`: builds and launches the
        kernels on a card), then save the built kernel libraries (none on
        the CPU), the built native runtime and a manifest (`_aot_manifest`)
        into `path`.  A later process constructed with aot_path=<path>
        builds none of them.  Returns {library kind: bytes}."""
        os.makedirs(path, exist_ok=True)
        self.prewarm()
        libs = {"native": native.build()}
        if self.device.type == "cuda":
            libs["kernel"] = admm_chunk.build()["path"]
            libs["ldl"] = ldl.build()["path"]
        sizes = {}
        for kind, src in libs.items():
            dst = os.path.join(path, os.path.basename(src))
            shutil.copyfile(src, dst)
            sizes[kind] = os.path.getsize(dst)
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(_aot_manifest(self.cfg_tick, self.net.state_dict(),
                                    self.device), f, indent=1)
        return sizes

    def _load_aot(self, path: str) -> bool:
        """Take the libraries that `save_aot` wrote into the build
        directories.  False (they are built at first use) when the manifest
        is missing or does not match this driver; a matching manifest
        whose library file is missing raises."""
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return False
        if manifest != _aot_manifest(self.cfg_tick, self.net.state_dict(),
                                     self.device):
            return False
        for kind, mod in _AOT_LIBS.items():
            if manifest[kind] is None:
                continue
            dst = mod.BUILD_DIR / manifest[kind]
            if dst.exists():
                continue
            dst.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=dst.parent)
            os.close(fd)
            try:
                shutil.copyfile(Path(path) / manifest[kind], tmp)
                os.replace(tmp, dst)          # atomic, as the builds
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        return True

    def prewarm(self, goal_dist: float = 5.0):
        """Run a cold and a warm tick on a dummy box corridor
        (`_aot_dummy_args`): builds the kernels and warms the allocator and
        cuDNN before the first real tick."""
        args = _aot_dummy_args(self.cfg, goal_dist, self.device)
        _, _, _, adv = self._cold(*args)
        with torch.no_grad():
            self._tick(adv.state9, adv.hpolys, adv.seg, adv.prev)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset(self, pos, goal, hpolys, seg) -> DriverState:
        return DriverState(
            pos=np.asarray(pos, np.float64), vel=np.zeros(3),
            acc=np.zeros(3), hpolys=np.asarray(hpolys), seg=int(seg),
            goal=np.asarray(goal, np.float64),
            prev=init_plan(1, self.cfg, self.device), done=False)

    def set_goal(self, st: DriverState, goal, hpolys, seg) -> DriverState:
        """Goal change: a new corridor and no plan (a cold replan, the
        reference's targetCallBack)."""
        return st._replace(goal=np.asarray(goal, np.float64),
                           hpolys=np.asarray(hpolys), seg=int(seg),
                           prev=init_plan(1, self.cfg, self.device),
                           done=False)

    def _pack_state9(self, st: DriverState) -> np.ndarray:
        state9 = np.zeros((1, 2, 3, 3), np.float32)
        state9[0, 0, :, 0] = st.pos
        state9[0, 0, :, 1] = st.vel
        state9[0, 0, :, 2] = st.acc
        state9[0, 1, :, 0] = st.goal
        return state9

    @torch.no_grad()
    def tick(self, st: DriverState, telemetry: bool = False) -> TickResult:
        if st.done:
            return TickResult(times=np.zeros(self.cfg.qp.max_seg),
                              solved=True, state=st, telemetry=None,
                              latency_s=0.0, tracking=False)
        dev = self.device
        have = bool(st.prev.have_prev[0])
        state9 = torch.as_tensor(self._pack_state9(st), device=dev)
        hp_dev = torch.as_tensor(st.hpolys, dtype=torch.float32,
                                 device=dev)[None]
        seg_dev = torch.tensor([st.seg], device=dev)

        t0 = time.perf_counter()
        if have:
            solved, plan_c, times, adv, stage = self._tick(
                state9, hp_dev, seg_dev, st.prev)
        else:
            solved, plan_c, times, adv = self._cold(state9, hp_dev, seg_dev)
            stage = 0
        ok = bool(solved[0])
        adv_np = adv.state9.cpu().numpy()     # the device round trip
        lat = time.perf_counter() - t0

        tracking = (not ok) and have
        if ok or tracking:
            # the accepted (or tracked) plan: advance and roll
            new_st = DriverState(
                pos=adv_np[0, 0, :, 0].astype(np.float64),
                vel=adv_np[0, 0, :, 1].astype(np.float64),
                acc=adv_np[0, 0, :, 2].astype(np.float64),
                hpolys=adv.hpolys[0].cpu().numpy(), seg=int(adv.seg[0]),
                goal=st.goal, prev=adv.prev, done=bool(adv.done[0]))
        else:
            # an unsolved cold tick: no plan exists, hold and wait
            new_st = st

        tel = None
        if telemetry and (ok or tracking):
            traj = trajectory.from_solution(plan_c, times, seg_dev)
            tel = control.control_horizon(
                traj, self.cfg.phys, rate_hz=self.telemetry_hz,
                horizon_s=1.0 / self.rate_hz)
        cert = None
        if self.certify and ok:
            # f64 Bernstein certificate of the accepted plan at the
            # mission limits, outside the latency timer
            cert = bool(trajectory.certify_box_host(
                plan_c.double().cpu().numpy(), times.double().cpu().numpy(),
                np.array([st.seg]), self.cfg.qp.max_vel,
                self.cfg.qp.max_acc)[0])
        return TickResult(times=times[0].cpu().numpy(), solved=ok,
                          state=new_st, telemetry=tel, latency_s=lat,
                          tracking=tracking, certified=cert, rescue=stage)

    def run(self, st: DriverState, n_ticks: int, realtime: bool = False,
            goal_changes: dict | None = None, telemetry: bool = False,
            stop_when_done: bool = False, stall_limit: int = 10):
        """Run n_ticks; goal_changes maps a tick index to (goal, hpolys,
        seg).  Returns (final state, list of TickResult).

        stall_limit: consecutive planless ticks (cold solve failed, nothing
        to track) before giving up; a failing cold tick does not change
        the state, so repeating it cannot recover.  0 disables."""
        results = []
        period = 1.0 / self.rate_hz
        stalled = 0
        for k in range(n_ticks):
            if goal_changes and k in goal_changes:
                st = self.set_goal(st, *goal_changes[k])
            r = self.tick(st, telemetry=telemetry)
            planless = (not r.solved) and (not r.tracking)
            stalled = stalled + 1 if planless else 0
            st = r.state
            results.append(r)
            if stop_when_done and st.done:
                break
            if stall_limit and stalled >= stall_limit:
                break
            if realtime and r.latency_s < period:
                time.sleep(period - r.latency_s)
        return st, results


# ---------------------------------------------------------------------------
# on-chip tick cost
# ---------------------------------------------------------------------------

@torch.no_grad()
def _chain_ticks(net, cfg: AllocNetConfig, state9, hpolys, seg,
                 n_ticks: int, dt: float, time_scale: float,
                 refine_steps: int):
    """A cold tick, then n_ticks - 1 warm ticks (the fast solve, no rescue
    ladder) fed back on the device; after arrival a tick holds the done
    state.  Nothing is read back to the host.  Returns (solved (n_ticks,
    B) bool, each tick's flag or'ed with done before it; done (B,))."""
    solved0, _, _, adv = _cold_tick(net, cfg, dt, time_scale, state9,
                                    hpolys, seg)
    st, hp, sg, prev, done = (adv.state9, adv.hpolys, adv.seg, adv.prev,
                              adv.done)
    flags = [solved0]
    for _ in range(n_ticks - 1):
        solved, _, _, a = _warm_tick(cfg, dt, refine_steps, False, st, hp,
                                     sg, prev)
        keep = lambda new, old: _where_b(done, old, new)
        st, hp = keep(a.state9, st), keep(a.hpolys, hp)
        sg = torch.where(done, sg, a.seg)
        prev = PlanState(
            coeffs=keep(a.prev.coeffs, prev.coeffs),
            times=keep(a.prev.times, prev.times),
            have_prev=torch.where(done, prev.have_prev, a.prev.have_prev),
            duals={k: keep(a.prev.duals[k], prev.duals[k])
                   for k in prev.duals})
        flags.append(solved | done)
        done = done | a.done
    return torch.stack(flags), done


def onchip_tick_cost(net, params, cfg: AllocNetConfig, state9, hpolys, seg,
                     n_ticks: int = 50, rate_hz: float = 10.0,
                     time_scale: float = 1.0, refine_steps: int = 0,
                     device=None):
    """Per-tick cost of the ticks alone: a cold plan and n_ticks - 1 warm
    ticks chained on the device (`_chain_ticks`), one host read at the
    end; the host's per-tick work of `Driver.tick` (state packing,
    telemetry, certificates) is left out.  state9 (B, 2, 3, 3), hpolys
    (B, S, F, 4), seg (B,); `params` as for `Driver`.  Runs on the card
    unless `device` says otherwise.  Returns (seconds per tick, solved
    fraction over the ticks, with a tick after arrival counted solved,
    arrived fraction)."""
    dev = resolve_device(device)
    net = (copy.deepcopy(net) if params is None
           else bind(net, params)).to(dev).eval()
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    args = (t(state9), t(hpolys), t(seg, torch.long))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    solved, done = _chain_ticks(net, cfg, *args, n_ticks, 1.0 / rate_hz,
                                time_scale, refine_steps)
    frac = float(solved.float().mean())               # the one host read
    wall = time.perf_counter() - t0
    return wall / n_ticks, frac, float(done.float().mean())
