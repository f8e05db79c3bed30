#!/usr/bin/env python3
"""The 10 Hz drive eval at the reference deploy point, on the card.

The port's counterpart of `scripts/drive_eval.py`: the same 10
`random_obstacle_map` maps (seeds 100-109, 20 x 20 x 4 m), the same 5
missions per map drawn by `planner.sample_missions` from one
`np.random.default_rng(12345)` (re-plan seeds drawn from it too), the same
net (the shipped seq5 ConvLSTM, `seq5_tokenthresh0_35_cpu.msgpack`) and the
same `Driver` at `config.DEPLOY` (res 20, v <= 4 m/s, a <= 6 m/s^2, order
4, box margin 0.005), at most 600 ticks a mission, with the script's
cold-stall re-plan loop.  It writes the script's fields and its targets
stay the script's: arrival >= 0.95, tick solve >= 0.99, p99 < 100 ms.

Beyond them it keeps each tick's rescue stage (`TickResult.rescue`) and
whether the tick was cold, and splits the latency by stage: cold, warm
with no rescue, rescue 1 (light) and rescue 2 (heavy), with each stage's
share of the ticks above the warm p99.  It counts the two kernels'
launches (K1 `admm_chunk`, L1 `ldl_block`) per tick kind, and counts the
missions whose (start, goal, seg) equal, in order, those of the JAX
package's record `runs/drive/drive_eval.json` (printed, not gated).

    python -m allocnet_tpu_torch.planner.drive_eval [n_maps missions_per_map
        max_ticks] [--certify] [--out PATH] [--aot PATH] [--record PATH]
        [--device cpu]

Defaults 10 5 600; the output goes to OUT, in the repository's
git-ignored output directory.  Runs on the card unless `--device` says
otherwise.  The last line printed is the summary without the missions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np

from allocnet_tpu_torch import config
from allocnet_tpu_torch.models import import_torch
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.ops import admm_chunk, ldl
from allocnet_tpu_torch.planner import driver as driver_lib
from allocnet_tpu_torch.planner import planner
from allocnet_tpu_torch.train import datagen
from allocnet_tpu_torch.utils.device import device_line, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NET = os.path.join(ROOT, "data", "params", "seq5_tokenthresh0_35_cpu.msgpack")
OUT = os.path.join(ROOT, "chiprun_out", "drive_eval.json")
RECORD = os.path.join(ROOT, "runs", "drive", "drive_eval.json")
EXTENT = (20.0, 20.0, 4.0)
MAP_SEED0 = 100
RNG_SEED = 12345
ARRIVE_DIST = 0.3
BOX_MARGIN = 0.005
TICK_BUDGET_MS = 100.0
# the cold-stall re-plan loop (scripts/drive_eval.py:126-168)
STALL_LIMIT = 5
MAX_FLOWN = 4
MAX_ATTEMPTS = 20
ONLINE_ATTEMPTS = 3
# the record rounds start and goal to 3 decimals
RECORD_ATOL = 1e-3
STAGES = ("cold", "warm", "rescue_1", "rescue_2")


class Flight(NamedTuple):
    state: driver_lib.DriverState
    ticks: list               # TickResult, in order
    replans: int              # corridor re-plans flown
    cold: list                # bool per tick: the tick ran the cold path


def cold_flags(res) -> list:
    """Which ticks of one `Driver.run` ran the cold path: the first (after
    `reset` or `set_goal` there is no plan), and every tick after a
    planless one (an unsolved cold tick holds the state, so the next tick
    is cold again).  A warm tick that misses tracks the previous plan and
    is never planless."""
    return [k == 0 or not (res[k - 1].solved or res[k - 1].tracking)
            for k in range(len(res))]


def tick_stage(rescue: int, cold: bool) -> str:
    """The stage of a tick (STAGES) from its rescue stage and cold flag."""
    return "cold" if cold else STAGES[1 + rescue]


def build_eval_map(map_seed: int, device=None):
    """The map of `map_seed`: `random_obstacle_map` over EXTENT, voxel
    0.25 m, dilation 2, with the native collision grid."""
    pts = datagen.random_obstacle_map(map_seed, EXTENT)
    return planner.build_map(pts, np.zeros(3), np.asarray(EXTENT),
                             scale=0.25, dilate_r=2, device=device)


def fly_mission(drv, pmap, cfg, start, cp, rng, max_ticks: int) -> Flight:
    """One mission (scripts/drive_eval.py:126-168): fly `cp` from `start`
    until arrival, `max_ticks` or a stall of STALL_LIMIT planless ticks.
    A cold-plan stall is deterministic, so the operator re-plans the
    route: while none of the last 3 ticks solved, a fresh route seed from
    `rng` (the first ONLINE_ATTEMPTS attempts with the online front-end
    budget, then the offline one), up to MAX_FLOWN flown re-plans or
    MAX_ATTEMPTS attempts."""
    st = drv.reset(start, cp.route[-1], cp.hpolys, cp.seg)
    st, res = drv.run(st, max_ticks, stop_when_done=True,
                      stall_limit=STALL_LIMIT)
    res = list(res)
    cold = cold_flags(res)
    flown, attempts = 0, 0
    while (not st.done and len(res) < max_ticks and flown < MAX_FLOWN
           and attempts < MAX_ATTEMPTS
           and not any(r.solved for r in res[-3:])):
        attempts += 1
        ccfg = (cfg.corridor.online() if attempts <= ONLINE_ATTEMPTS
                else cfg.corridor)
        cp2 = planner.plan_corridor(
            pmap, st.pos, cp.route[-1],
            dataclasses.replace(cfg, corridor=ccfg),
            seed=int(rng.integers(1 << 30)), device=drv.device)
        if not cp2.ok:
            continue
        flown += 1
        st = drv.set_goal(st, cp2.route[-1], cp2.hpolys, cp2.seg)
        st, res2 = drv.run(st, max_ticks - len(res), stop_when_done=True,
                           stall_limit=STALL_LIMIT)
        res += res2
        cold += cold_flags(res2)
    return Flight(st, res, flown, cold)


def mission_record(map_seed: int, start, cp, flight: Flight) -> dict:
    """The script's per-mission fields (scripts/drive_eval.py:170-193),
    and per tick: latency, rescue stage, cold flag; `finite` whether every
    tick's state is finite."""
    st, res = flight.state, flight.ticks
    dist = float(np.linalg.norm(st.pos - st.goal))
    solved = np.array([r.solved for r in res])
    tracking = np.array([r.tracking for r in res])
    certs = [r.certified for r in res if r.certified is not None]
    # planless: a failed cold tick (no plan, the vehicle holds); flight
    # ticks are the rest
    planless = ~solved & ~tracking
    return {
        "map_seed": map_seed,
        "start": [round(float(v), 3) for v in start],
        "goal": [round(float(v), 3) for v in cp.route[-1]],
        "seg": int(cp.seg),
        "n_ticks": len(res),
        "arrived": bool(st.done) and dist < ARRIVE_DIST,
        "final_dist_m": dist,
        "solve_rate": float(solved.mean()),
        "tracking_rate": float(tracking.mean()),
        "n_flight_ticks": int((~planless).sum()),
        "n_flight_solved": int(solved.sum()),
        "corridor_replans": flight.replans,
        "certified_plans": float(np.mean(certs)) if certs else None,
        "n_certified_plans": len(certs),
        "n_certified_true": int(sum(certs)),
        "finite": all(np.isfinite(r.state.pos).all()
                      and np.isfinite(r.state.vel).all()
                      and np.isfinite(r.state.acc).all() for r in res),
        "latency_ms": [r.latency_s * 1e3 for r in res],
        "rescue": [int(r.rescue) for r in res],
        "cold": [bool(c) for c in flight.cold],
    }


def _pct(ms, q):
    return float(np.percentile(ms, q)) if len(ms) else None


def stage_split(ticks) -> dict:
    """Per stage (STAGES) of `ticks`, a list of (latency ms, stage): the
    count, p50 and p99, and the share of the tail, the ticks (of any
    stage) above the warm p99, that the stage makes up.  The warm p99 is
    taken over every tick that is not cold."""
    ms = np.array([t for t, _ in ticks], float)
    stage = np.array([s for _, s in ticks])
    warm_p99 = _pct(ms[stage != "cold"], 99)
    tail = (ms > warm_p99) if warm_p99 is not None else np.zeros(len(ms),
                                                                  bool)
    out = {"warm_p99_ms": warm_p99, "warm_tail_n": int(tail.sum())}
    for s in STAGES:
        sel = stage == s
        out[s] = {"n": int(sel.sum()), "wall_p50_ms": _pct(ms[sel], 50),
                  "wall_p99_ms": _pct(ms[sel], 99),
                  "tail_share": (float((tail & sel).sum() / tail.sum())
                                 if tail.any() else None)}
    return out


def summarize(missions: list, ticks: list, certify: bool, *, n_maps: int,
              cfg=config.DEPLOY, aot_fast_start: bool = False,
              prewarm_s: float | None = None) -> dict:
    """The script's summary (scripts/drive_eval.py:196-233), aggregated
    from raw counts, with the per-stage split of `ticks` ((latency ms,
    stage) of every tick of every mission).  Keeps `missions`."""
    n = lambda key: sum(m[key] for m in missions)
    ms = [t for t, _ in ticks]
    return {
        "operating_point": {"res": cfg.qp.res, "max_vel": cfg.qp.max_vel,
                            "max_acc": cfg.qp.max_acc,
                            "order": cfg.qp.order},
        "aot_fast_start": aot_fast_start,
        "solve_box_margin": BOX_MARGIN,
        "n_maps": n_maps,
        "n_missions": len(missions),
        "arrival_rate": float(np.mean([m["arrived"] for m in missions])),
        "tick_solve_rate": n("n_flight_solved") / max(n("n_ticks"), 1),
        # over the ticks that fly a plan: the planless stalls before a
        # corridor re-plan are counted by corridor_replans
        "flight_tick_solve_rate": (n("n_flight_solved")
                                   / max(n("n_flight_ticks"), 1)),
        "total_corridor_replans": n("corridor_replans"),
        "flown_plan_certified_rate": (
            n("n_certified_true") / max(n("n_certified_plans"), 1)
            if certify else None),
        "wall_p50_ms": _pct(ms, 50),
        "wall_p99_ms": _pct(ms, 99),
        "stages": stage_split(ticks),
        "prewarm_compile_s": prewarm_s,
        "tick_budget_ms": TICK_BUDGET_MS,
        "final_dist_p50_m": _pct([m["final_dist_m"] for m in missions], 50),
        "missions": missions,
    }


def missions_matching_record(missions: list, record_path: str = RECORD):
    """How many missions, from the first, have the (start, goal, seg) of
    the record's missions in the same place (start and goal within
    RECORD_ATOL); None when the record is absent."""
    try:
        with open(record_path) as f:
            rec = json.load(f)["missions"]
    except (OSError, ValueError, KeyError):
        return None
    k = 0
    for m, r in zip(missions, rec):
        if (m["seg"] != r["seg"]
                or not np.allclose(m["start"], r["start"], rtol=0,
                                   atol=RECORD_ATOL)
                or not np.allclose(m["goal"], r["goal"], rtol=0,
                                   atol=RECORD_ATOL)):
            break
        k += 1
    return k


class LaunchMeter:
    """Counts K1's and L1's launches in each of a driver's ticks, by tick
    kind (STAGES): wraps the driver's cold and combined tick functions.
    The counters move only where a kernel launches (on the card)."""

    def __init__(self, drv):
        self.k1, self.l1 = admm_chunk.admm_chunk, ldl.ldl_block
        self.calls = []           # (kind, K1 launches, L1 launches)
        cold, tick = drv._cold, drv._tick

        def counted(fn, kind_of):
            def call(*a):
                n0, m0 = self.k1.launches, self.l1.launches
                out = fn(*a)
                self.calls.append((kind_of(out), self.k1.launches - n0,
                                   self.l1.launches - m0))
                return out
            return call

        drv._cold = counted(cold, lambda out: "cold")
        drv._tick = counted(tick, lambda out: STAGES[1 + out[4]])

    def by_kind(self) -> dict:
        """{kind: {ticks, k1, l1 (totals), k1_per_tick, l1_per_tick
        (the distinct counts)}}."""
        out = {}
        for kind in STAGES:
            c = [(a, b) for k, a, b in self.calls if k == kind]
            out[kind] = {"ticks": len(c), "k1": sum(a for a, _ in c),
                         "l1": sum(b for _, b in c),
                         "k1_per_tick": sorted({a for a, _ in c}),
                         "l1_per_tick": sorted({b for _, b in c})}
        return out


def run_eval(n_maps: int = 10, per_map: int = 5, max_ticks: int = 600,
             certify: bool = False, device=None, aot_path: str | None = None,
             record_path: str = RECORD, partial_path: str | None = None,
             on_map=None, log=print) -> dict:
    """Fly `per_map` missions on each of `n_maps` maps and summarize
    (`summarize`, with `launches` by tick kind and
    `missions_matching_record`).  `on_map(map_seed, pmap, rng_state,
    plans)` is called after each map's missions are sampled, with the
    rng's state before the sampling.  Each mission's record is appended
    to `partial_path` as a JSON line."""
    dev = resolve_device(device)
    cfg = config.DEPLOY
    lo, hi = np.zeros(3), np.asarray(EXTENT)
    t0 = time.perf_counter()
    drv = driver_lib.Driver(ConvLSTMAllocNet(5, 256, token_thresh=0.5),
                            import_torch.load_params(NET), cfg, rate_hz=10.0,
                            certify=certify, box_margin=BOX_MARGIN,
                            device=dev, aot_path=aot_path)
    drv.prewarm()
    prewarm_s = time.perf_counter() - t0
    # no corridor prewarm (scripts/drive_eval.py:97-114): it warms XLA
    # compiles, and the port compiles nothing at run time
    meter = LaunchMeter(drv)
    if partial_path:
        os.makedirs(os.path.dirname(os.path.abspath(partial_path)),
                    exist_ok=True)
        open(partial_path, "w").close()
    missions, ticks = [], []
    rng = np.random.default_rng(RNG_SEED)
    for mi in range(n_maps):
        map_seed = MAP_SEED0 + mi
        pmap = build_eval_map(map_seed, dev)
        rng_state = rng.bit_generator.state
        plans = planner.sample_missions(pmap, cfg, rng, per_map, lo, hi,
                                        device=dev)
        if on_map is not None:
            on_map(map_seed, pmap, rng_state, plans)
        for start, _, _, cp in plans:
            flight = fly_mission(drv, pmap, cfg, start, cp, rng, max_ticks)
            m = mission_record(map_seed, start, cp, flight)
            missions.append(m)
            ticks += [(t, tick_stage(r, c)) for t, r, c in
                      zip(m["latency_ms"], m["rescue"], m["cold"])]
            if partial_path:
                with open(partial_path, "a") as f:
                    f.write(json.dumps(m) + "\n")
            log(f"map {map_seed} mission {len(missions)}: arrived="
                f"{m['arrived']} dist={m['final_dist_m']:.4f} ticks="
                f"{m['n_ticks']} solve={m['solve_rate']:.4f} replans="
                f"{m['corridor_replans']} rescues="
                f"{sum(s > 0 for s in m['rescue'])}")
    if [k for k, _, _ in meter.calls] != [s for _, s in ticks]:
        raise RuntimeError("drive_eval: the ticks' stages disagree with the "
                           "tick functions the driver called")
    out = summarize(missions, ticks, certify, n_maps=n_maps, cfg=cfg,
                    aot_fast_start=drv.aot_loaded, prewarm_s=prewarm_s)
    out["device"] = device_line(dev)
    out["launches"] = meter.by_kind()
    out["missions_matching_record"] = missions_matching_record(
        missions, record_path)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", type=int,
                    help="n_maps missions_per_map max_ticks (10 5 600)")
    ap.add_argument("--certify", action="store_true",
                    help="f64 Bernstein certificate of every accepted plan")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--aot", default=None,
                    help="a directory that Driver.save_aot wrote")
    ap.add_argument("--record", default=RECORD,
                    help="the JAX package's drive_eval.json")
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    if len(a.sizes) > 3:
        ap.error("at most three sizes: n_maps missions_per_map max_ticks")
    n_maps, per_map, max_ticks = (a.sizes + [10, 5, 600][len(a.sizes):])
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    out = run_eval(n_maps, per_map, max_ticks, certify=a.certify,
                   device=a.device, aot_path=a.aot, record_path=a.record,
                   partial_path=os.path.splitext(a.out)[0]
                   + "_partial.jsonl",
                   log=lambda s: print(s, flush=True))
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "missions"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
