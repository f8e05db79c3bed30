#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (allocnet_tpu_torch) on one NVIDIA
card: builds its two kernels from csrc/ (admm_chunk and the polish's LDL^T
block, ldl_block; one nvcc each, started together; no register spills),
holds admm_chunk against its plain PyTorch version at the deploy shape, on
batches that take each of its routes (padded parts skipped or not, Kx in
shared or device memory) and at the training shape, solves the deploy QP batch
through it (bench.py's accuracy gates), serves plan_batch requests with the
shipped seq5 ConvLSTM weights, trains that net through the QP for one
epoch (Trainer, TRAIN operating point), refines one request's segment
times through the differentiable QP, then at the DEPLOY point builds a
voxel map from a point cloud, plans two missions' corridors (native
Informed RRT*, FIRI, the fused corridor; held against the CPU's) and flies
them with the 10 Hz receding-horizon driver (cold, warm and rescue ticks;
the kernel held against its plain version on each tick batch, the first
cold tick against the CPU path), then runs planner/drive_eval's 50-mission
eval on a cut of 2 maps x 2 missions (every mission arrives; the sampled
missions held against the CPU's; tick latency by rescue stage), then
train/heldout_eval's evaluation of the three trained nets over the 2,000
held-out scenarios (gated against runs/mcnemar; the kernel against its
plain version on the eval's batches; big4's first 256 against the CPU
path, each differing flag held by a float64 re-check or a rounding
witness), then planner/refine_eval's time refinement of big3's times over
the same 2,000 scenarios in chunks of 500 (gated against runs/refine;
exact launch counts; the kernel against its plain version at B=500; a
chunk's host wall split by section), then planner/frontend_eval's front
end at DEPLOY: the route-search curve on a cut (map 200 x 3 pairs, arms up
to 5,000 iterations), all 20 cold plans split into path, corridor and net
+ QP (one traced under torch.profiler) and the 20 pipelined plans, gated
against the JAX package's CPU run (every cold plan launching both
kernels; the kernel against its plain version on a cold-plan batch),
then train/corpus's scenario-corpus generator: map 9000 asked for 64
samples through write_shards (run again: nothing generated; combined),
gated scenario by scenario against the JAX package's CPU run of the same
request (tests/records/corpus_jax_cpu.json; every difference witnessed
on the CPU), its corridors against the CPU's, 4 K1 and 48 L1 launches
per certification, the kernel against its plain version at the
certification's batch and at the 512 of a full map, then
train/mcnemar10k's paired eval on a cut (the first 240 held-out
scenarios and 32 fresh ones of map 12000: batches of 256 and 16, the full
run's tail shape): the McNemar table's keys, 6 K1 and 32 L1 launches per
arm, the cache rows' flags against the held-out phase's (each difference
witnessed), both kernels against their plain versions at B=16,
then train/chain's stages on a cut: map 1000's certified rows refined as
one chunk of 128, two training steps of 128 each of train_big (from the
JAX init) and finetune_qp (from runs/big3), each with its held-out eval,
and calibrate_thresh at two thresholds on 32 rows (exact launch counts
per chunk, step and batch; the kernel against its plain version at the
training step's B=128 x 100), then train/ablation's four arms on the
chain phase's rows: two steps of each from the JAX init (the ConvLSTM and
the ConvMLP, QP-gradient and supervised losses) and one held-out eval
batch each (exact launch counts; both kernels against their plain
versions at the ConvMLP step's B=128), and eval_fresh row 202 through
the kernel alone, beside itself, beside row 5 and in a batch of 64, its
outputs bit-equal every time.
Then the application layer at
DEPLOY: generates a certified dataset from a synthetic point cloud (PCD
write, read and crop; corridors and certification held against the CPU's;
certify sample 80 traced through the kernel, the plain chunk on the card
and the CPU path), exports the net as TorchScript and the replanning
step as a `torch.export` program (held against the eager ones), starts
two fresh processes to their first tick with and without the prebuilt
libraries of `Driver.save_aot`, chains 20 ticks on the card
(`onchip_tick_cost`), runs the solve-scaling sweep on the card and holds
the kernel against its plain version at the certify shape and at order 3
(min-jerk).  Then the ten-segment operating point, and last the `ldl`
phase: ldl_block against its plain version, exactly, on the diagonal
blocks that the polish factored on the way (deploy solve, cold, warm and
rescue ticks, held-out eval, refine eval, front end, corpus, mcnemar10k
at B=16, certify, S=10) and on random
blocks (B=1024, and B=1025, whose last thread block is short),
non-finite scenarios kept to themselves, and all kernel launches per
factorization, solve and tick with the plain version on the card and with
the kernel.
Every path counts both kernels' launches and fails if one did not launch.
Prints one JSON line with both kernels and a final status line.

    python3 chip_smoke.py

(`python3 chip_smoke.py --first-tick ...` is the fast-start phase's child
process.)

Needs a CUDA device, the CUDA toolkit (nvcc) and g++; exits non-zero
without them, and on any failed check.  Writes nothing but the kernel and
runtime builds in allocnet_tpu_torch/_build/ and temporary directories.
Imports neither JAX nor the JAX package, nor h5py or matplotlib.
"""

import concurrent.futures
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# the kernels against their plain versions, their times and bounds
from allocnet_tpu_torch.utils.kernel_bench import (
    CHUNK_TOL, PEAK_BYTES, PEAK_F32_FLOPS, chunk_work, cuda_ms,
    first_launch_per_batch, ldl_compare, ldl_work,
    shape_numbers)

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 1024                  # the deploy batch (bench.py)
SEED = 123                # bench.py's scenario seed
ORACLE_N = 8
REQUESTS = 3              # plan_batch requests served on the main path
TRAIN_N = 320             # scenarios of the train phase: 9 steps of 32, 1 val
REFINE_B = 256            # the refine request's batch
NET = os.path.join("data", "params", "seq5_tokenthresh0_35.msgpack")
# corridor and fly phases: map 0 of scripts/drive_eval.py, 2 missions
# sampled as its sample_missions does, flown at DEPLOY for at most 200
# ticks; scripts/smoke_missions_jax.py flies the same missions through
# the JAX package
MAP_SEED = 100
EXTENT = (20.0, 20.0, 4.0)
MISSION_SEED = 1
N_MISSIONS = 2
MAX_TICKS = 200
ARRIVE_DIST = 0.3         # drive_eval's arrival: done and within 0.3 m
CORRIDOR_TOL = 1e-3       # card vs CPU corridor, of the largest row entry
# application phases: a 40 x 40 x 4 m cloud of four random_obstacle_map
# tiles, cropped to 20 x 20 x 4 m; the CLI's default sample count
DATAGEN_SEED = 100
DATAGEN_CROP = (20.0, 20.0, 4.0)
DATAGEN_N = 256
# card vs CPU certify flags: every sample the card keeps passes the
# solved test again in float64 on the CPU; one the card drops and the CPU
# keeps must have a CPU flag decided by rounding, i.e. one that flips
# when the sample's times move by 1e-6 of themselves (a random sign per
# time) in one of WITNESS_DRAWS draws; as many samples where they agree
# are drawn as a control, and the witness must leave at least half of
# those unflipped
WITNESS_REL = 1e-6
WITNESS_DRAWS = 32
WITNESS_SEED = 7
ONCHIP_TICKS = 20
JERK_B = 256
# seq10 phase: config.SEQ10 (ModelMaxSeg = 10, the shipped seq10 net) at
# res 20; the first SEQ10_CPU_N scenarios solved again on the CPU; the
# refine request's batch; the maze flow of tests/test_seq10_e2e.py (its
# res 10, generous box limits and 2 x 150 budget: the seq10 net is out of
# distribution on synthetic maps)
SEQ10_NET = os.path.join("data", "params", "seq10_rest2rest.msgpack")
SEQ10_CPU_N = 64
SEQ10_FLAG_AGREE = 0.95
SEQ10_REFINE_B = 256
MAZE_EXTENT = (40.0, 20.0, 4.0)
MAZE_STARTS = ((2.0, 10.0, 2.0), (2.0, 17.0, 2.0))
MAZE_GOALS = ((38.0, 10.0, 2.0), (38.0, 3.0, 2.0))
# drive_eval phase: planner/drive_eval's 50-mission eval cut to its first
# 2 maps (seeds 100 and 101) x 2 missions, at most 600 ticks each, with
# certify; the card's sampled missions against the CPU's (goal within
# DRIVE_GOAL_TOL m)
DRIVE_MAPS = 2
DRIVE_PER_MAP = 2
DRIVE_TICKS = 600
DRIVE_GOAL_TOL = 1e-3
# the certify sample whose flag the card and the CPU decide differently
# with no rounding witness (datagen phase): traced through K1, the plain
# chunk on the card and the CPU path
TRACE_SAMPLE = 80
# the held-out eval (train/heldout_eval): every arm over all of
# data/eval_fresh.npz on the card, gated against runs/mcnemar; big4's
# first HELDOUT_CPU_N scenarios against the CPU path, where each flag the
# card drops and the CPU keeps must move when every QP input of its
# scenario moves by WITNESS_REL of itself (a random sign per entry): in
# batches of HELDOUT_WITNESS_ROWS rows shared among the scenarios that
# have not moved, at most HELDOUT_WITNESS_BATCHES of them; one more batch
# among as many agreeing scenarios may move at most half of them
HELDOUT_CPU_N = 256
HELDOUT_WITNESS_ROWS = 128
HELDOUT_WITNESS_BATCHES = 4
# the front end (planner/frontend_eval): the curve cut to the first
# FRONTEND_PAIRS scenarios of map 200 at arms up to FRONTEND_MAX_CAP
# iterations (no quality run: its rrt_star arm is the 40,000-iteration
# search), every cold plan and pipelined plan
FRONTEND_PAIRS = 3
FRONTEND_MAX_CAP = 5000
# the corpus generator (train/corpus): write_shards of map 9000 asked for
# CORPUS_N samples (the JAX CPU record's smoke run), gated per scenario
# against that record (the card's draws before the CPU's, which then draw
# only the rows the card's leave: the phase's CPU cost is bounded by
# WITNESS_DRAWS draws of those rows and their control); every candidate
# corridor against the CPU's, at
# most CORPUS_CORRIDOR_DIFFS of them apart and each witnessed; K1 at the
# certification's bucket and at CORPUS_FULL_B, the bucket of a map asked
# for 400 (the full run's), its batch tiled from the recorded one
CORPUS_N = 64
CORPUS_CORRIDOR_DIFFS = 2
CORPUS_FULL_B = 512
# the 10,000-scenario McNemar eval (train/mcnemar10k) cut to the first
# MCN_BASE held-out scenarios and the first MCN_FRESH certified rows of
# map 12000 asked for MCN_ASK (fresh_scenarios): one batch of 256 and one
# of MCN_TAIL_B, the full run's last batch
MCN_BASE = 240
MCN_ASK = 64
MCN_FRESH = 32
MCN_TAIL_B = 16
# the chain phase: map 1000 (the corpus prefix's first), one refine chunk,
# CHAIN_STEPS training steps of 128 over the certified rows tiled to
# CHAIN_ROWS (the Loader's 0.9 split leaves CHAIN_VAL validation rows)
CHAIN_MAP = 1000
CHAIN_ASK = 200
CHAIN_REFINE_B = 128
CHAIN_ROWS = 320
CHAIN_STEPS = 2
CHAIN_VAL = 32
CHAIN_GRID = (0.42, 0.5)
# the ablation phase: every arm one epoch of the chain phase's rows (its
# CHAIN_STEPS steps) and one held-out eval batch of ABL_EVAL rows; the
# kernel's batch-mate check on eval_fresh row ABL_ROW beside ABL_MATE
ABL_EVAL = 256
ABL_ROW, ABL_MATE, ABL_WIDE = 202, 5, 64


# the two kernels' wrappers (set in main): each counts its own launches
K1 = L1 = None
# L1's launches on each path of the run, and the polish blocks captured for
# the ldl phase (`record_ldl`)
LDL_LAUNCHES = {}
LDL_REC = {"tag": None, "batch": None, "blocks": {}, "factor": {}}
LDL_REPS = 20
LDL_TAIL_B = 1025        # a batch whose last thread block is short


def phase(name, t0):
    print(f"[{name}] {time.perf_counter() - t0:.3f} s", flush=True)


def zero_counts():
    """Both kernels' launch counts to 0, just before a path runs."""
    K1.launches = L1.launches = 0


def l1_ran(path, n=None):
    """L1's launches on `path` (since `zero_counts`, or `n`), kept in
    LDL_LAUNCHES; fails if it did not launch."""
    n = L1.launches if n is None else n
    LDL_LAUNCHES[path] = n
    if n < 1:
        fail(f"the {path} path did not launch ldl_block")
    return n


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def record_ldl(ldl, L1):
    """Wraps `ldl.ldl_factor` so that the first factorization under each
    tag (LDL_REC['tag']; 'fly' tags by batch: cold B=3, warm B=1, rescue
    B=4; of LDL_REC['batch'] scenarios only when that is set) keeps its K,
    signs and the diagonal blocks that reach L1."""
    factor = ldl.ldl_factor

    def recording_factor(K, **kw):
        tag = LDL_REC["tag"]
        if tag == "fly":
            tag = {3: "cold tick", 1: "warm tick", 4: "rescue tick"}.get(
                K.shape[0])
        if (tag is None or tag in LDL_REC["blocks"]
                or LDL_REC["batch"] not in (None, K.shape[0])):
            return factor(K, **kw)
        blocks = LDL_REC["blocks"][tag] = []
        LDL_REC["factor"][tag] = (K.clone(), kw["sign"].clone(), kw["reg"])

        def rec_block(Kb, sign, reg):
            blocks.append((Kb.clone(), sign.clone(), reg))
            return L1(Kb, sign, reg)

        ldl.ldl_block = rec_block
        try:
            return factor(K, **kw)
        finally:
            ldl.ldl_block = L1

    ldl.ldl_factor = recording_factor


def first_tick(npz, cache_dir, aot_dir=None):
    """A fresh process's first tick (the fast-start phase runs this in a
    subprocess): build the Driver at DEPLOY with the shipped seq5 net,
    building into the empty `cache_dir`, from the prebuilt libraries of
    `aot_dir` when given; run the first cold tick on the mission in `npz`;
    then get the native runtime.  Prints one JSON line: seconds to the
    first tick, the compilers it ran, build seconds, aot_loaded; writes
    the tick's plan next to `npz`."""
    t_start = time.perf_counter()
    ran = {}                  # compiler -> seconds it ran
    real_run = subprocess.run

    def run(cmd, *a, **k):
        t0 = time.perf_counter()
        try:
            return real_run(cmd, *a, **k)
        finally:
            name = os.path.basename(str(cmd[0]))
            ran[name] = ran.get(name, 0.0) + time.perf_counter() - t0

    subprocess.run = run
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    from allocnet_tpu_torch import config
    from allocnet_tpu_torch.models import weights
    from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
    from allocnet_tpu_torch.ops import admm_chunk, ldl
    from allocnet_tpu_torch.planner import driver, native

    m = np.load(npz)
    drv = driver.Driver(ConvLSTMAllocNet(5, 256, token_thresh=0.5),
                        weights.load_params(os.path.join(ROOT, NET)),
                        config.DEPLOY, rate_hz=10.0, cache_dir=cache_dir,
                        aot_path=aot_dir)
    st = drv.reset(m["start"], m["goal"], m["hpolys"], int(m["seg"]))
    r = drv.tick(st)
    torch.cuda.synchronize()
    to_tick = time.perf_counter() - t_start
    tick_builds = dict(ran)
    native.build()            # the front end's runtime, after the tick
    np.savez(npz.replace(".npz", f"_{'aot' if aot_dir else 'build'}.npz"),
             times=r.times, pos=r.state.pos, vel=r.state.vel,
             acc=r.state.acc,
             coeffs=r.state.prev.coeffs.cpu().numpy())
    print(json.dumps({"to_first_tick_s": to_tick, "solved": r.solved,
                      "builds_before_tick_s": tick_builds,
                      "builds_s": ran, "aot_loaded": drv.aot_loaded,
                      "launches": admm_chunk.admm_chunk.launches,
                      "ldl_launches": ldl.ldl_block.launches}))
    return 0


def solved_in_f64(dcfg, batch, sol, scfg=None):
    """(B,) bool: whether a certify solve's solutions `sol` (physical
    coefficients and multipliers, any device) pass the solver's solved
    test (of `scfg`, CERTIFY_SOLVER by default) when re-evaluated in
    float64 on the CPU against the QP of the same float32 inputs
    (`datagen.solved_in_f64`)."""
    from allocnet_tpu_torch.train import datagen
    return datagen.solved_in_f64(dcfg, batch, sol, scfg)


def rounding_witness(dcfg, batch, flags_gpu, flags_cpu, dev):
    """Each sample whose certify flag differs between the card and the CPU,
    and as many where they agree (the control), certified again in
    WITNESS_DRAWS draws with its times moved by WITNESS_REL of themselves
    (a random sign per time, each sample's from its own seed), on the CPU
    and on the card (`witness.flag_moves`, one round: a draw flips when
    its flag differs from the unmoved sample's in the same batch).
    Prints and returns (disagreeing samples, control samples, CPU flips
    per sample, card flips per sample)."""
    import numpy as np
    from allocnet_tpu_torch.train import datagen
    from allocnet_tpu_torch.utils import witness

    wrng = np.random.default_rng(WITNESS_SEED)
    bad = np.nonzero(flags_gpu != flags_cpu)[0]
    ctrl = np.sort(wrng.choice(np.nonzero(flags_gpu == flags_cpu)[0],
                               len(bad), replace=False))
    idx = np.concatenate([bad, ctrl])
    seeds = [(WITNESS_SEED, int(i)) for i in idx]
    flips = {}
    for side, d in (("CPU", "cpu"), ("card (not gated)", dev)):
        flips[side], _ = witness.flag_moves(
            lambda b: datagen.certified(dcfg, b, device=d), batch, idx,
            seeds, WITNESS_DRAWS, WITNESS_DRAWS, fields=("times",))
        print(f"  rounding witness on the {side}, {WITNESS_DRAWS} draws of "
              f"the times x (1 +- {WITNESS_REL:g}): flips of each "
              f"disagreeing sample " + ", ".join(
                  f"{b}: {n}" for b, n in zip(bad, flips[side][:len(bad)]))
              + "; of each control sample " + ", ".join(
                  f"{b}: {n}" for b, n in zip(ctrl, flips[side][len(bad):])))
    return bad, ctrl, flips["CPU"], flips["card (not gated)"]


def trace_sample(dcfg, batch, b, dev):
    """Certify sample `b` of `batch` solved three ways, each on the whole
    batch at CERTIFY_SOLVER: through K1 on the card, through the plain
    chunk (`admm_chunk_reference`) on the card, and through the CPU path.
    Prints, for sample b, each chunk's outputs (x, z, yh, yeh: max
    difference over the larger side's largest entry, per pair of sides),
    each polish round's active set (the rows with a nonzero multiplier),
    with each side's input multiplier and slack for a row some side keeps
    and another drops and, at the round's drop pass (`admm.polish`'s
    `trace`), that row's multiplier against the keep threshold and its
    G x - h, and the status test, then the first step where
    each pair parts: a chunk above CHUNK_TOL, an active set, or the
    status.  Printed only."""
    import numpy as np
    import torch
    from allocnet_tpu_torch import config
    from allocnet_tpu_torch.ops import admm, admm_chunk, qp

    k1, polish = admm_chunk.admm_chunk, admm.polish
    f32 = lambda a: a.astype("float32")
    sides = {}
    for name, d, chunk in (("K1", dev, k1),
                           ("plain", dev, admm_chunk.admm_chunk_reference),
                           ("CPU", "cpu", k1)):
        tr = sides[name] = {"chunks": [], "active": [], "inputs": [],
                            "drops": []}

        def rec_chunk(*a, chunk=chunk, tr=tr):
            out = chunk(*a)
            tr["chunks"].append([o[b].double().cpu() for o in out])
            return out

        # the operator counts K1's launches on the module's `admm_chunk`,
        # which is rec_chunk here: the trace's launches stay out of K1's
        rec_chunk.launches = 0

        def rec_polish(data, scfg, x, beq, h, lam, tr=tr, **k):
            # each drop pass's values of sample b, by flat row
            passes = []
            tr["drops"].append(passes)

            def drop(d):
                v = {key: d[key][b].tolist() for key in d}
                passes.append({row: {key: v[key][j] for key in (
                    "lam", "gx_h", "active_in", "active_out")}
                    | {"lam_thr": v["lam_thr"][0]}
                    for j, row in enumerate(v["idx"])})

            out = polish(data, scfg, x, beq, h, lam, trace=drop, **k)
            tr["active"].append(frozenset(
                torch.nonzero(out[2][b]).flatten().tolist()))
            # the round's inputs: each row's signed multiplier and slack
            ax = qp.tree_flat(qp.apply_A(data, x), admm.EQ_KEYS
                              + admm.INEQ_KEYS)[b, beq.shape[1]:]
            tr["inputs"].append((lam[b].double().cpu(),
                                 (h[b] - ax).double().cpu(),
                                 h[b].double().cpu()))
            return out

        admm_chunk.admm_chunk, admm.polish = rec_chunk, rec_polish
        try:
            sol = admm.solve_qp(qp.build_qp(
                dcfg.qp, f32(batch.state), f32(batch.hpolys),
                f32(batch.times), batch.seg, device=d), config.CERTIFY_SOLVER)
        finally:
            admm_chunk.admm_chunk, admm.polish = k1, polish
        tr["status"] = (bool(sol.solved[b]), bool(sol.polished[b]),
                        float(sol.pri_rel[b]), float(sol.dua_rel[b]),
                        float(sol.obj[b]))
    print(f"  trace of certify sample {b} (seg {batch.seg[b]}), K1 on the "
          f"card / plain chunk on the card / CPU path:")
    pairs = (("K1", "CPU"), ("plain", "CPU"), ("K1", "plain"))

    def ulp(h):
        return float(np.spacing(np.float32(abs(float(h)))))

    def rel(u, v):
        return max(float((p - q).abs().max())
                   / max(1.0, float(p.abs().max()), float(q.abs().max()))
                   for p, q in zip(u, v))
    parted = {}
    for c in range(len(sides["CPU"]["chunks"])):
        diffs = {p: rel(sides[p[0]]["chunks"][c], sides[p[1]]["chunks"][c])
                 for p in pairs}
        print(f"    chunk {c}: " + ", ".join(
            f"{u} vs {v} {e:.3e}" for (u, v), e in diffs.items()))
        for p, e in diffs.items():
            if e > CHUNK_TOL:
                parted.setdefault(p, f"chunk {c} ({e:.3e})")
    for r in range(len(sides["CPU"]["active"])):
        sets = {s: sides[s]["active"][r] for s in sides}
        print(f"    polish round {r}: active rows " + ", ".join(
            f"{s} {len(a)}" for s, a in sets.items()) + "; differ " + ", ".join(
            f"{u} vs {v} {len(sets[u] ^ sets[v])}" for u, v in pairs))
        for u, v in pairs:
            if sets[u] != sets[v]:
                parted.setdefault((u, v), f"polish round {r}'s active set")
        # the rows one side keeps and another drops, with the round's
        # inputs on each side: from round 1 a row stays when its signed
        # multiplier is positive or its slack is below -1e-7
        for row in sorted(set().union(*sets.values())
                          - frozenset.intersection(*sets.values())):
            print(f"      row {row}: " + "; ".join(
                f"{s} {'keeps' if row in sets[s] else 'drops'} (multiplier "
                f"{float(sides[s]['inputs'][r][0][row]):.4e}, slack "
                f"{float(sides[s]['inputs'][r][1][row]):.3e} = "
                f"{float(sides[s]['inputs'][r][1][row]) / ulp(sides[s]['inputs'][r][2][row]):+.2f} "
                f"float32 ulps of its offset)" for s in sides))
            # the drop pass after the round's first KKT solve: a row stays
            # when its multiplier is above the keep threshold or G x - h >
            # 1e-7 (ops/admm.py, polish)
            for p in range(len(sides["CPU"]["drops"][r])):
                print(f"      row {row}, drop pass {p}: " + "; ".join(
                    f"{s} " + (
                        "not gathered" if row not in sides[s]["drops"][r][p]
                        else "multiplier {lam:.4e} vs keep threshold "
                        "{lam_thr:.3e}, G x - h {gx_h:+.3e} (against "
                        "1e-7), active {active_in} -> {active_out}".format(
                            **sides[s]["drops"][r][p][row]))
                    for s in sides))
    for s, st in ((s, sides[s]["status"]) for s in sides):
        print(f"    status {s}: solved {st[0]} polished {st[1]} pri_rel "
              f"{st[2]:.3e} dua_rel {st[3]:.3e} obj {st[4]:.6f}")
    for u, v in pairs:
        if sides[u]["status"][0] != sides[v]["status"][0]:
            parted.setdefault((u, v), "the status test")
    print("    first step where they part: " + "; ".join(
        f"{u} vs {v}: {parted.get((u, v), 'none')}" for u, v in pairs))


def drive_eval_phase(dev):
    """planner/drive_eval's eval on its cut (DRIVE_MAPS maps x
    DRIVE_PER_MAP missions, DRIVE_TICKS ticks, certify), through its
    `run_eval` (which raises when the ticks' stages disagree with the
    tick functions the driver called).  Fails on a non-finite state, a
    mission that does not arrive, a sampled mission that differs from the
    CPU's, or a tick without a K1 and an L1 launch.  Returns K1's launches
    on the path."""
    import numpy as np
    from allocnet_tpu_torch import config
    from allocnet_tpu_torch.planner import drive_eval, planner

    t0 = time.perf_counter()
    lo, hi = np.zeros(3), np.asarray(drive_eval.EXTENT)

    def same_as_cpu(map_seed, pmap, rng_state, plans):
        rng = np.random.default_rng()
        rng.bit_generator.state = rng_state
        cpu = planner.sample_missions(pmap, config.DEPLOY, rng,
                                      DRIVE_PER_MAP, lo, hi, device="cpu")
        if len(cpu) != len(plans):
            fail(f"map {map_seed}: {len(plans)} missions sampled on the "
                 f"card, {len(cpu)} on the CPU")
        for k, ((s, _, _, cp), (s_c, _, _, cp_c)) in enumerate(zip(plans,
                                                                  cpu)):
            dg = float(np.abs(cp.route[-1] - cp_c.route[-1]).max())
            print(f"  map {map_seed} mission {k}: {np.round(s, 3).tolist()}"
                  f" -> {np.round(cp.route[-1], 3).tolist()}, seg {cp.seg} "
                  f"(CPU seg {cp_c.seg}, goal {dg:.2e} m apart)")
            if (not np.array_equal(s, s_c) or cp.seg != cp_c.seg
                    or dg > DRIVE_GOAL_TOL):
                fail(f"map {map_seed} mission {k}: the card sampled another "
                     f"mission than the CPU")

    zero_counts()
    out = drive_eval.run_eval(DRIVE_MAPS, DRIVE_PER_MAP, DRIVE_TICKS,
                              certify=True, device=dev, on_map=same_as_cpu,
                              log=lambda s: print("  " + s, flush=True))
    k1n = K1.launches
    l1_ran("drive_eval")
    missions = out["missions"]
    print("drive_eval: " + json.dumps(
        {k: v for k, v in out.items() if k not in ("missions", "stages",
                                                   "launches")}))
    st = out["stages"]
    print(f"  tick ms by stage (warm p99 {st['warm_p99_ms']:.1f} ms, "
          f"{st['warm_tail_n']} ticks above it): " + "; ".join(
              f"{s} {st[s]['n']} ticks" + (
                  f" p50 {st[s]['wall_p50_ms']:.1f} p99 "
                  f"{st[s]['wall_p99_ms']:.1f}, tail share "
                  f"{st[s]['tail_share']:.3f}" if st[s]['n'] else "")
              for s in drive_eval.STAGES))
    print(f"  missions_matching_record: {out['missions_matching_record']} "
          f"(runs/drive/drive_eval.json; not gated)")
    la = out["launches"]
    print(f"  launches: admm_chunk {k1n}, ldl_block {LDL_LAUNCHES['drive_eval']}"
          f" on the path (prewarm included); per tick kind: " + "; ".join(
              f"{s} {la[s]['ticks']} ticks, admm_chunk {la[s]['k1']} "
              f"{la[s]['k1_per_tick']}, ldl_block {la[s]['l1']} "
              f"{la[s]['l1_per_tick']}" for s in drive_eval.STAGES))
    for m in missions:
        if not m["finite"]:
            fail(f"map {m['map_seed']}: a tick gave a non-finite state")
        if not m["arrived"]:
            fail(f"map {m['map_seed']}: a mission did not arrive "
                 f"({m['final_dist_m']:.4f} m)")
    if len(missions) != DRIVE_MAPS * DRIVE_PER_MAP:
        fail(f"drive_eval flew {len(missions)} missions")
    if k1n < 1:
        fail("the drive_eval path did not launch admm_chunk")
    if any(min(la[s][k] or [1]) < 1 for s in drive_eval.STAGES
           for k in ("k1_per_tick", "l1_per_tick")):
        fail("a drive_eval tick ran without launching both kernels")
    phase("drive_eval", t0)
    return k1n


def moving_witness(flags_of, batch, idx, ref, rng, batches):
    """Draws, in batches of HELDOUT_WITNESS_ROWS rows, of the scenarios
    idx of `batch` with every QP input (state, corridor, times) moved by
    WITNESS_REL of itself, a random sign per entry: at most `batches`
    batches, each shared among the scenarios whose flag (`flags_of(batch)`)
    has not yet differed from ref (one per idx).  Returns (moves, draws)
    per scenario."""
    import numpy as np
    from allocnet_tpu_torch.utils import scenarios

    move = lambda a: a * (1.0 + WITNESS_REL * rng.choice([-1.0, 1.0],
                                                         size=a.shape))
    moves, draws = np.zeros(len(idx), int), np.zeros(len(idx), int)
    for _ in range(batches):
        pending = np.nonzero(moves == 0)[0]
        if not len(pending):
            break
        rows = np.resize(pending, HELDOUT_WITNESS_ROWS)
        b = idx[rows]
        got = flags_of(scenarios.ScenarioBatch(
            move(batch.state[b]), move(batch.hpolys[b]),
            move(batch.times[b]), batch.seg[b]))
        np.add.at(draws, rows, 1)
        np.add.at(moves, rows, got != ref[rows])
    return moves, draws


def heldout_phase(dev):
    """train/heldout_eval on the card: the three arms over all held-out
    scenarios at EVAL_CFG (`heldout_eval.run`, which raises unless each
    arm launched both kernels), held to the gates of `heldout_eval.GATES`
    against runs/mcnemar/results.json (the record comparison and the
    McNemar pairs printed, not gated).  K1 against its plain version on
    the first eval batch (B=256) and on the short last one (B=208); the
    first polish factorization's blocks recorded for the ldl phase (tag
    "heldout").  big4 on the first HELDOUT_CPU_N scenarios against the
    CPU path: the net's outputs within 1e-5, and every flag that differs:
    one the card keeps passes the solved test again in float64, one the
    card drops and the CPU keeps moves under `moving_witness` on the CPU,
    which moves at most half of as many agreeing scenarios.  Returns K1's
    launches on the path and its numbers at both shapes."""
    import numpy as np
    import torch
    from allocnet_tpu_torch.ops import admm, admm_chunk, qp
    from allocnet_tpu_torch.train import evaluate, heldout_eval
    from allocnet_tpu_torch.utils import scenarios

    t0 = time.perf_counter()
    launch, recorded = admm_chunk._launch, {}
    admm_chunk._launch = first_launch_per_batch(launch, recorded)
    zero_counts()
    LDL_REC["tag"] = "heldout"
    try:
        # the kernels are built and warm by now: no warm-up batch, so the
        # counts and the recorded batches are the eval's own
        out, per = heldout_eval.run(device=dev, warmup=False,
                                    log=lambda s: print("  " + s, flush=True))
    finally:
        admm_chunk._launch = launch
        LDL_REC["tag"] = None
    k1n = K1.launches
    l1_ran("heldout")
    if out["gates"] is None:
        fail("the record runs/mcnemar is not in the copy")
    n, ecfg = out["n"], heldout_eval.EVAL_CFG
    batches = -(-n // heldout_eval.BATCH)
    results, _ = heldout_eval.read_record(heldout_eval.RECORD_DIR)
    for arm, rep in out["arms"].items():
        tm, la, rc = out["timing"][arm], out["launches"][arm], out["record"][arm]
        print(f"heldout {arm}: success {rep['success_rate']:.4f} (record "
              f"{results['arms'][arm]['success_rate']:.4f}), stop-token "
              f"{rep['stop_token_accuracy']:.4f} ("
              f"{results['arms'][arm]['stop_token_accuracy']:.4f}), time "
              f"ratio {rep['mean_time_ratio']:.6f} ("
              f"{results['arms'][arm]['mean_time_ratio']:.6f}), certified "
              f"of solved {rep['certified_of_solved']:.4f}; flags agree "
              f"with the record on {rc['solved']['agreement']:.4f} (only "
              f"ours {rc['solved']['only_ours']}, only the record's "
              f"{rc['solved']['only_record']}); {tm['wall_s']:.2f} s, "
              f"{tm['solves_per_s']:.1f} solves/s, ms per batch "
              + " ".join(f"{v:.1f}" for v in tm["batch_ms"])
              + f"; launches admm_chunk {la['admm_chunk']}, ldl_block "
              f"{la['ldl_block']}", flush=True)
        if la["admm_chunk"] != batches * ecfg.solver.n_chunks:
            fail(f"heldout {arm} launched admm_chunk {la['admm_chunk']} "
                 f"times for {batches} batches")
    for k in heldout_eval.FLAGS:
        print(f"  McNemar ({k}), ours / record: " + "; ".join(
            f"{p}: b {v['b_only_first']} / {results[f'mcnemar_{k}'][p]['b_only_first']}"
            f", c {v['c_only_second']} / {results[f'mcnemar_{k}'][p]['c_only_second']}"
            f", p {v['p_two_sided']} / {results[f'mcnemar_{k}'][p]['p_two_sided']}"
            for p, v in out[f"mcnemar_{k}"].items()))
    print("  gates: " + json.dumps(out["gates"]))
    if not out["gates"]["passed"]:
        fail("the held-out eval misses a gate against runs/mcnemar")
    if sorted(recorded) != sorted({heldout_eval.BATCH,
                                   n - (batches - 1) * heldout_eval.BATCH}):
        fail(f"admm_chunk ran at batch sizes {sorted(recorded)}")
    shapes = {f"B={b}": shape_numbers(admm_chunk, ecfg.qp, a,
                                      f"held-out eval B={b}")
              for b, a in sorted(recorded.items(), reverse=True)}

    # big4 on the first HELDOUT_CPU_N scenarios: the card against the CPU
    sc = heldout_eval.load_scenarios(n=HELDOUT_CPU_N)
    run_dir = os.path.join(heldout_eval.RUNS, "big4")
    nets = {d: heldout_eval.load_arm(run_dir, d) for d in (dev, "cpu")}
    cfg = heldout_eval.arm_config(nets["cpu"].token_thresh)
    _, ex_cpu = evaluate.evaluate(nets["cpu"], cfg, sc, certify=True,
                                  extras=True, device="cpu")
    flags_gpu = per["big4_solved"][:HELDOUT_CPU_N]
    flags_cpu = ex_cpu["solved"]
    tq, pseg = {}, {}
    for d in (dev, "cpu"):
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=d)
        times, _, _, times_q = evaluate.qp_times(
            nets[d], cfg, t(sc.state), t(sc.hpolys),
            torch.as_tensor(sc.seg, device=d).long())
        tq[d], pseg[d] = times_q.cpu().numpy(), (times > 1e-6).sum(1).cpu()
    terr = float(np.abs(tq[dev] - tq["cpu"]).max() / np.abs(tq["cpu"]).max())
    print(f"heldout big4, first {HELDOUT_CPU_N} scenarios, card vs CPU: "
          f"segments predicted equal {bool(torch.equal(pseg[dev], pseg['cpu']))}"
          f", QP times within {terr:.2e} of the largest; flags agree on "
          f"{int((flags_gpu == flags_cpu).sum())} of {HELDOUT_CPU_N} (card "
          f"{flags_gpu.mean():.4f}, CPU {flags_cpu.mean():.4f})", flush=True)
    if not torch.equal(pseg[dev], pseg["cpu"]) or terr > 1e-5:
        fail("the net's outputs on the card differ from the CPU's")

    def solve(batch, d):
        f32 = np.float32
        return admm.solve_qp(qp.build_qp(
            cfg.qp, batch.state.astype(f32), batch.hpolys.astype(f32),
            batch.times.astype(f32), batch.seg, device=d), cfg.solver)
    qb = {d: scenarios.ScenarioBatch(sc.state, sc.hpolys, tq[d], sc.seg)
          for d in (dev, "cpu")}
    sol = solve(qb[dev], dev)
    again = sol.solved.cpu().numpy()
    ok64 = solved_in_f64(cfg, qb[dev], sol, cfg.solver)
    print(f"  card solve again on the same inputs: flags identical "
          f"{bool((again == flags_gpu).all())}; of its {int(again.sum())} "
          f"solved {int(ok64[again].sum())} pass the solved test "
          f"re-evaluated in float64 on the CPU")
    if (again != flags_gpu).any():
        fail("the card's held-out flags changed between two runs")
    if not ok64[again].all():
        fail(f"held-out scenarios {np.nonzero(again & ~ok64)[0].tolist()} "
             f"are solved on the card and fail the solved test in float64")
    bad = np.nonzero(flags_gpu != flags_cpu)[0]
    dropped = bad[~flags_gpu[bad]]
    if len(bad):
        rng = np.random.default_rng(WITNESS_SEED)
        flags_of = lambda b: solve(b, "cpu").solved.cpu().numpy()
        moves, draws = moving_witness(flags_of, qb["cpu"], dropped,
                                      flags_cpu[dropped], rng,
                                      HELDOUT_WITNESS_BATCHES)
        ctrl = np.sort(rng.choice(np.nonzero(flags_gpu == flags_cpu)[0],
                                  len(bad), replace=False))
        cm, _ = moving_witness(flags_of, qb["cpu"], ctrl, flags_cpu[ctrl],
                               rng, 1)
        print(f"  differing flags {bad.tolist()} (card keeps "
              f"{bad[flags_gpu[bad]].tolist()}: solved in float64); "
              f"rounding witness on the CPU, moves / draws of each the card "
              f"drops: " + ", ".join(f"{b}: {m}/{d}" for b, m, d in
                                     zip(dropped, moves, draws))
              + f"; control moved {ctrl[cm > 0].tolist()} of {len(ctrl)}")
        if (moves == 0).any():
            fail(f"held-out scenarios {dropped[moves == 0].tolist()} are "
                 f"dropped on the card and kept on the CPU under every "
                 f"move of their inputs")
        if 2 * int((cm > 0).sum()) > len(ctrl):
            fail("the held-out rounding witness moves most of the control")
    phase("heldout", t0)
    return k1n, shapes, per


def refine_eval_launches(cfg, steps):
    """(K1, L1) launches one chunk of planner/refine_eval must make: ten
    solves (the one at the net's times and the one at the refined times,
    and in refine.refine_times the differentiable solve at the start, the
    forward solve at the raw input and one per step), each
    `admm.solve_launches`."""
    from allocnet_tpu_torch.ops import admm
    return tuple((4 + steps) * n for n in admm.solve_launches(cfg.qp,
                                                               cfg.solver))


def refine_eval_phase(dev):
    """planner/refine_eval on the card: all 2,000 held-out scenarios in
    chunks of 500 at the script's point (`refine_eval.run`, which raises
    unless each chunk launched both kernels), held to `refine_eval.GATES`
    against runs/refine/results_full.json and the JAX package's CPU run
    (`refine_eval.REFERENCE`); each chunk's K1 and L1
    launches exactly as `refine_eval_launches` derives them.  K1 against
    its plain version on its first launch at B=500 (250 iterations, res
    10); the first polish factorization's blocks recorded for the ldl
    phase (tag "refine_eval").  Then the first chunk once more with its
    host wall split into the net, the forward solves (ADMM and polish),
    the polish alone, the implicit KKT backward and the rest.  Returns
    K1's launches on the path, its numbers at B=500 and the split."""
    import numpy as np
    import torch
    from allocnet_tpu_torch.ops import admm, admm_chunk, qp_diff
    from allocnet_tpu_torch.planner import refine_eval

    t0 = time.perf_counter()
    launch, recorded = admm_chunk._launch, {}
    admm_chunk._launch = first_launch_per_batch(launch, recorded)
    zero_counts()
    LDL_REC["tag"] = "refine_eval"
    try:
        # the kernels are built and warm by now: no warm-up chunk
        out = refine_eval.run(device=dev, warmup=False,
                              log=lambda s: print("  " + s, flush=True))
    finally:
        admm_chunk._launch = launch
        LDL_REC["tag"] = None
    k1n = K1.launches
    l1_ran("refine_eval")
    if out["gates"] is None:
        fail("the record runs/refine/results_full.json is not in the copy")
    print("refine_eval: " + "; ".join(
        f"{f} {v['ours']:.6g} ({k} {v[k]:.6g})"
        for f, v in out["gates"]["fields"].items()
        for k in ("record", "reference") if k in v)
        + f"; flags agreeing with the JAX CPU run {out['flags_agree']}; "
        f"{out['wall_s']:.2f} s, {out['scenarios_per_s']:.1f} scenarios/s",
        flush=True)
    want = refine_eval_launches(refine_eval.CFG, refine_eval.STEPS)
    chunks = out["chunks"]
    got = [(c["launches"]["admm_chunk"], c["launches"]["ldl_block"])
           for c in chunks]
    print(f"  launches per chunk (admm_chunk, ldl_block): {got}, expected "
          f"{want} each; ms per chunk: " + "; ".join(
              f"{c['wall_s'] * 1e3:.1f} = net {c['net_s'] * 1e3:.1f} + solve0 "
              f"{c['solve0_s'] * 1e3:.1f} + refine {c['refine_s'] * 1e3:.1f} "
              f"+ solve1 {c['solve1_s'] * 1e3:.1f}" for c in chunks))
    print("  gates: " + json.dumps(out["gates"]))
    n = len(refine_eval.read_scenarios(False)[2])
    if out["n"] != n or len(chunks) != -(-n // refine_eval.CHUNK):
        fail(f"refine_eval ran {out['n']} scenarios of {n} in {len(chunks)} "
             f"chunks")
    if any(g != want for g in got) or k1n != want[0] * len(chunks):
        fail(f"refine_eval launched (admm_chunk, ldl_block) {got} per chunk, "
             f"expected {want}")
    if not out["gates"]["passed"]:
        fail("the refine eval misses a gate (runs/refine or the JAX CPU "
             "reference)")
    if sorted(recorded) != sorted({c["scenarios"] for c in chunks}):
        fail(f"admm_chunk ran at batch sizes {sorted(recorded)}")
    shape = shape_numbers(admm_chunk, refine_eval.CFG.qp,
                          recorded[refine_eval.CHUNK],
                          f"refine eval B={refine_eval.CHUNK}")

    # the first chunk again, its host wall split by section (each section
    # ends in a synchronize, which the split's wall includes)
    split = {"forward_solves_s": 0.0, "polish_s": 0.0, "backward_s": 0.0}
    solve_qp, polish = admm.solve_qp, admm.polish
    backward = qp_diff._ImplicitSolve.backward

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t1
            return r
        return run

    state, hpolys, seg = refine_eval.read_scenarios(False, refine_eval.CHUNK)
    net = refine_eval.load_net(dev)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    admm.solve_qp = timed("forward_solves_s", solve_qp)
    admm.polish = timed("polish_s", polish)
    qp_diff._ImplicitSolve.backward = staticmethod(timed("backward_s",
                                                         backward))
    try:
        _, sec = refine_eval.run_chunk(net, t(state), t(hpolys),
                                       torch.as_tensor(seg, device=dev).long())
    finally:
        admm.solve_qp, admm.polish = solve_qp, polish
        qp_diff._ImplicitSolve.backward = staticmethod(backward)
    wall = sum(sec.values())
    split.update(net_s=sec["net_s"], wall_s=wall, other_s=wall - sec["net_s"]
                 - split["forward_solves_s"] - split["backward_s"])
    print(f"  first chunk again, host ms: {wall * 1e3:.1f} = net "
          f"{split['net_s'] * 1e3:.1f} + 10 forward solves "
          f"{split['forward_solves_s'] * 1e3:.1f} (polish "
          f"{split['polish_s'] * 1e3:.1f} of it) + 7 implicit KKT backwards "
          f"{split['backward_s'] * 1e3:.1f} + the rest "
          f"{split['other_s'] * 1e3:.1f}", flush=True)
    phase("refine_eval", t0)
    return k1n, shape, split


def frontend_phase(dev):
    """planner/frontend_eval on the card (`frontend_eval.run`, which
    raises unless every kept cold plan and pipelined plan launched both
    kernels): the curve on its cut, the 20 cold plans (maps 210-211) split
    into path, corridor and net + QP with one plan traced per phase under
    torch.profiler, the 20 pipelined plans; fails unless every gate
    against the JAX CPU reference holds (`frontend_eval.gates`: routes,
    kept plans and flags scenario by scenario, the card's corridors
    against the CPU's, pipelined flags against the split path's).  K1
    against its plain version on the first cold-plan batch (the hedge,
    B=3); the first cold plan's polish blocks recorded for the ldl phase
    (tag "frontend").  Returns K1's launches on the path and its numbers
    at the cold-plan batch."""
    from allocnet_tpu_torch import config
    from allocnet_tpu_torch.ops import admm_chunk
    from allocnet_tpu_torch.planner import frontend_eval

    t0 = time.perf_counter()
    launch, recorded = admm_chunk._launch, {}
    admm_chunk._launch = first_launch_per_batch(launch, recorded)
    zero_counts()
    LDL_REC["tag"] = "frontend"
    try:
        out = frontend_eval.run(dev, maps=1, pairs=FRONTEND_PAIRS,
                                max_cap=FRONTEND_MAX_CAP, with_quality=False,
                                cut_cold=False,
                                log=lambda s: print("  " + s, flush=True))
    finally:
        admm_chunk._launch = launch
        LDL_REC["tag"] = None
    k1n = K1.launches
    l1_ran("frontend")
    cp, pp = out["cold_plan"], out["cold_plan_pipelined"]
    kept = [p for p in cp["plans"] if p["solved"] is not None]
    print(f"frontend: {len(cp['plans'])} cold plans, {len(kept)} kept: path "
          f"p50 {cp['path_ms_p50']:.2f} ms, corridor p50 "
          f"{cp['corridor_ms_p50']:.2f} ms, net + QP p50 "
          f"{cp['net_qp_ms_p50']:.2f} ms; total p50 {cp['total_ms_p50']:.2f}"
          f" p95 {cp['total_ms_p95']:.2f} ms over {cp['n_plans']} plans, "
          f"solved {cp['solved_frac']:.4f}; pipelined p50 "
          f"{pp['total_ms_p50']:.2f} p95 {pp['total_ms_p95']:.2f} ms, solved "
          f"{pp['solved_frac']:.4f}", flush=True)
    tr = cp["trace"]
    print(f"  plan {tr['k']} traced, per phase (torch.profiler): " + "; ".join(
        f"{ph} wall {tr[ph]['wall_ms']:.2f} ms, device busy "
        f"{tr[ph]['busy_ms']:.3f} ms, idle {tr[ph]['idle']:.3f}, "
        f"{tr[ph]['launches']:g} launches (K1 {tr[ph]['k1_launches']:g}, "
        f"{tr[ph]['k1_ms']:.3f} ms; L1 {tr[ph]['l1_launches']:g}, "
        f"{tr[ph]['l1_ms']:.3f} ms)" for ph in frontend_eval.PHASES))
    print("  launches per kept cold plan (admm_chunk, ldl_block): "
          + ", ".join(f"{p['k']}: {p['k1']}/{p['l1']}" for p in kept)
          + "; gates: " + json.dumps(out["gates"]), flush=True)
    if not out["gates"]["passed"]:
        fail("the front-end eval misses a gate against the JAX CPU "
             "reference")
    missed = [p["k"] for p in cp["plans"] + pp["plans"]
              if p["solved"] is not None and min(p["k1"], p["l1"]) < 1]
    if missed or not kept or tr is None:
        fail(f"front-end plans {missed} ran without both kernels")
    if sorted(recorded) != [3]:
        fail(f"admm_chunk ran at batch sizes {sorted(recorded)} on the "
             f"front end")
    shape = shape_numbers(admm_chunk, config.DEPLOY.qp, recorded[3],
                          "frontend cold plan")
    phase("frontend", t0)
    return k1n, shape, {"total_ms_p50": cp["total_ms_p50"],
                        "net_qp_ms_p50": cp["net_qp_ms_p50"],
                        "trace": tr}


def corpus_phase(dev):
    """train/corpus on the card: `write_shards` of map 9000 asked for
    CORPUS_N samples into a temporary directory, the same call again (it
    must generate nothing and keep the total), then `combine` (equal to
    the shard).  Fails unless the map's certification launched K1
    CERTIFY_K1 and L1 CERTIFY_L1 times, the per-scenario gates hold
    against the JAX CPU record's run of the same request
    (`corpus.scenario_gates`: every difference witnessed, the card's
    draws first) and
    every candidate corridor is within CORRIDOR_TOL of the port's CPU
    corridor, or, on at most CORPUS_CORRIDOR_DIFFS candidates, witnessed
    (`corpus.corridors_vs_cpu`).  K1 against its plain version at the
    certification's bucket and at CORPUS_FULL_B (the batch tiled); the
    polish blocks recorded for the ldl phase (tag "corpus").  Returns
    K1's launches on the path and its numbers at both shapes."""
    import numpy as np
    from allocnet_tpu_torch.ops import admm_chunk
    from allocnet_tpu_torch.train import corpus, dataset

    t0 = time.perf_counter()
    with open(corpus.REFERENCE) as f:
        ref = json.load(f)
    seed0, log = corpus.FRESH_SEED0, lambda s: print("  " + s, flush=True)
    launch, recorded, records = admm_chunk._launch, {}, []
    with tempfile.TemporaryDirectory() as d:
        admm_chunk._launch = first_launch_per_batch(launch, recorded)
        zero_counts()
        LDL_REC["tag"] = "corpus"
        try:
            first = corpus.write_shards(d, CORPUS_N, CORPUS_N, seed0,
                                        device=dev, max_maps=1,
                                        records=records, log=log)
        finally:
            admm_chunk._launch = launch
            LDL_REC["tag"] = None
        k1n = K1.launches
        l1_ran("corpus")
        gen_s = time.perf_counter() - t0
        again = corpus.write_shards(d, CORPUS_N, CORPUS_N, seed0, device=dev,
                                    max_maps=1, log=log)
        if again["generated"] or again["total"] != first["total"]:
            fail(f"write_shards generated {again['generated']} maps again "
                 f"(total {again['total']}, first {first['total']})")
        comb = corpus.combine([d], os.path.join(d, "combined.npz"))
        a = dataset.read_npz(os.path.join(d, f"shard_{seed0}.npz"))
        b = dataset.read_npz(comb["out"])
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            fail("combine differs from the shard")
    e = first["maps"][0]
    print(f"corpus: map {seed0} asked for {CORPUS_N}: {e['candidates']} "
          f"candidates, {e['to_certify']} to the certification, "
          f"{e['samples']} certified in {e['map_s']:.3f} s (stages s "
          + ", ".join(f"{k} {v:.3f}" for k, v in e["stages_s"].items())
          + f"); resumed with nothing generated; combine {comb['n']} rows; "
          f"launches K1 {e['k1']}, L1 {e['l1']}", flush=True)
    t1 = time.perf_counter()
    checks = corpus.scenario_gates(first["maps"], records, ref, dev, log=log,
                                   card_first=True)
    corpus.launch_gate(checks, first["maps"])
    t2 = time.perf_counter()
    cv = corpus.corridors_vs_cpu(records[0], corpus.map_points(seed0)[1])
    t3 = time.perf_counter()
    unwitnessed = [k for k, v in cv["differ"].items() if not v]
    print(f"  corridors of all {cv['candidates']} candidates, card vs CPU: "
          f"{len(cv['differ'])} apart (moves under the witness "
          f"{cv['differ']}), the rest within {cv['max']:.3e} of the largest "
          f"entry; host s: gates {t2 - t1:.3f}, CPU corridors {t3 - t2:.3f}; "
          f"gates: " + json.dumps(checks), flush=True)
    if "map_9000" not in checks or not all(v["ok"] for v in checks.values()):
        fail("the corpus generator misses a gate against the JAX CPU record")
    if len(cv["differ"]) > CORPUS_CORRIDOR_DIFFS or unwitnessed:
        fail(f"corpus corridors on the card differ from the CPU's: "
             f"{cv['differ']}")
    qcfg = corpus.GEN_CFG.qp
    if len(recorded) != 1:
        fail(f"admm_chunk ran at batch sizes {sorted(recorded)} in the "
             f"corpus phase")
    (bucket, args), = recorded.items()
    shapes = {"certify": shape_numbers(admm_chunk, qcfg, args,
                                       "corpus certify")}
    k = CORPUS_FULL_B // bucket
    tiled = [t.repeat(k, *[1] * (t.dim() - 1)).contiguous() for t in args[:13]]
    shapes["full_bucket"] = shape_numbers(
        admm_chunk, qcfg, tiled + list(args[13:]),
        f"corpus certify tiled to B={CORPUS_FULL_B}")
    shapes.update(seconds=gen_s, launches={"k1": e["k1"], "l1": e["l1"]},
                  corridors=cv, stages_s=e["stages_s"],
                  certified=e["samples"], candidates=e["candidates"])
    phase("corpus", t0)
    return k1n, shapes


def mcnemar10k_phase(dev, heldout_flags):
    """train/mcnemar10k on a cut: the first MCN_BASE scenarios of the
    held-out cache, then the first MCN_FRESH certified rows of map 12000
    asked for MCN_ASK (`corpus.fresh_scenarios`, the full run's first
    map), the three arms over them (`mcnemar10k.evaluate_arms`: one batch
    of 256 and one of MCN_TAIL_B).  Fails unless the table has the
    script's keys, each arm launched K1 n_chunks and L1
    mcnemar10k.L1_PER_BATCH times per batch, and the cache rows' flags
    equal the held-out phase's (`heldout_flags`) or, where they differ,
    move under `mcnemar10k.cache_row_gate`'s witness on the card (gate
    c: every cache row here shares its batch with fresh rows).  K1
    against its plain version at B=MCN_TAIL_B; the first polish
    factorization at that batch recorded for the ldl phase (tag
    "mcnemar10k B=16").  Returns K1's launches on the path and its
    numbers at that shape."""
    import numpy as np
    from allocnet_tpu_torch.ops import admm_chunk
    from allocnet_tpu_torch.train import corpus, heldout_eval, mcnemar10k

    t0 = time.perf_counter()
    log = lambda s: print("  " + s, flush=True)
    fresh, entries = corpus.fresh_scenarios(
        MCN_ASK, mcnemar10k.SEED0, max_maps=1, device=dev, log=log)
    if len(fresh.seg) < MCN_FRESH:
        fail(f"map {mcnemar10k.SEED0} certified {len(fresh.seg)} of "
             f"{MCN_ASK}, fewer than {MCN_FRESH}")
    sc = mcnemar10k.join(heldout_eval.load_scenarios(MCN_BASE),
                         type(fresh)(*(a[:MCN_FRESH] for a in fresh)))
    gen_s = time.perf_counter() - t0
    launch, recorded = admm_chunk._launch, {}
    admm_chunk._launch = first_launch_per_batch(launch, recorded)
    zero_counts()
    LDL_REC["tag"], LDL_REC["batch"] = "mcnemar10k B=16", MCN_TAIL_B
    try:
        out, per = mcnemar10k.evaluate_arms(sc, dev, log=log)
    finally:
        admm_chunk._launch = launch
        LDL_REC["tag"], LDL_REC["batch"] = None, None
    k1n = K1.launches
    l1_ran("mcnemar10k")
    eval_s = time.perf_counter() - t0 - gen_s
    pairs = [f"{x}_vs_{y}" for x, y in heldout_eval.PAIRS]
    keys = ("b_only_first", "c_only_second", "p_two_sided", "delta")
    for k in heldout_eval.FLAGS:
        if (list(out[f"mcnemar_{k}"]) != pairs or any(
                tuple(v) != keys for v in out[f"mcnemar_{k}"].values())):
            fail(f"the mcnemar10k table mcnemar_{k} has keys "
                 f"{json.dumps(out[f'mcnemar_{k}'])}")
    n_chunks = heldout_eval.EVAL_CFG.solver.n_chunks
    want = {"admm_chunk": 2 * n_chunks,
            "ldl_block": 2 * mcnemar10k.L1_PER_BATCH}
    for arm, rep in out["arms"].items():
        tm = out["timing"][arm]
        print(f"mcnemar10k {arm}: success {rep['success_rate']:.4f}, "
              f"certified of solved {rep['certified_of_solved']:.4f}; "
              f"{tm['wall_s']:.2f} s, ms per batch "
              + " ".join(f"{v:.1f}" for v in tm["batch_ms"])
              + f"; launches {out['launches'][arm]}", flush=True)
        if out["launches"][arm] != want:
            fail(f"mcnemar10k {arm} launched {out['launches'][arm]}, "
                 f"not {want}")
    print("  McNemar (solved): " + json.dumps(out["mcnemar_solved"]),
          flush=True)
    checks = {}
    ref = {a: {k: np.asarray(heldout_flags[f"{a}_{k}"][:MCN_BASE], bool)
               for k in heldout_eval.FLAGS} for a in out["arms"]}
    t1 = time.perf_counter()
    rows = mcnemar10k.cache_row_gate(checks, per, ref, sc, MCN_BASE, dev,
                                     log)
    print(f"  cache rows 0-{MCN_BASE - 1} against the heldout phase "
          f"({time.perf_counter() - t1:.2f} s): "
          + json.dumps(checks["cache_rows"]), flush=True)
    if not checks["cache_rows"]["ok"]:
        fail("mcnemar10k's cache rows part from the held-out eval's "
             "without a witness")
    if sorted(recorded) != [MCN_TAIL_B, heldout_eval.BATCH]:
        fail(f"admm_chunk ran at batch sizes {sorted(recorded)} in the "
             f"mcnemar10k phase")
    shape = shape_numbers(admm_chunk, heldout_eval.EVAL_CFG.qp,
                          recorded[MCN_TAIL_B],
                          f"mcnemar10k B={MCN_TAIL_B}")
    shape.update(generate_s=gen_s, eval_s=eval_s,
                 generated=entries[0]["certified"],
                 generation_launches={"k1": entries[0]["k1"],
                                      "l1": entries[0]["l1"]},
                 launches=out["launches"],
                 cache_rows={a: {k: v["differ"] for k, v in r.items()}
                             for a, r in rows.items()})
    phase("mcnemar10k", t0)
    return k1n, shape


def chain_phase(dev):
    """The training chain (train/chain's stages) on a cut: map CHAIN_MAP
    asked for CHAIN_ASK, its first CHAIN_REFINE_B certified rows refined
    as one chunk (`refine_targets.refine_corpus` at --chunk
    CHAIN_REFINE_B), the certified rows tiled to CHAIN_ROWS (a Loader
    split of CHAIN_STEPS steps of 128 and CHAIN_VAL validation rows),
    `train_big.train` big3 for one epoch from the JAX init and
    `finetune_qp.finetune` for one epoch from runs/big3, each ending in
    its eval over the 2,000 held-out scenarios, and
    `calibrate_thresh.calibrate` of runs/big3 at CHAIN_GRID on the
    CHAIN_VAL validation rows.  Fails unless every stage launched K1 and
    L1 exactly as its code gives (`refine_targets.chunk_launches`,
    `chain.train_launches`, `admm.solve_launches`), the
    losses are finite and the refinement contract holds.  K1 against its
    plain version at the training step's B=128 x 100 (res 10); the first
    polish factorization at B=128 recorded for the ldl phase (tag "chain
    B=128").  Returns K1's launches on the path and its numbers at that
    shape."""
    import numpy as np
    from allocnet_tpu_torch.ops import admm, admm_chunk
    from allocnet_tpu_torch.train import (calibrate_thresh, chain, corpus,
                                          dataset, finetune_qp,
                                          refine_targets, train_big)
    from allocnet_tpu_torch.utils.scenarios import ScenarioBatch

    t0 = time.perf_counter()
    log = lambda s: print("  " + s, flush=True)
    sc, e = corpus.generate_map(CHAIN_MAP, CHAIN_ASK, device=dev)
    if len(sc.seg) < CHAIN_REFINE_B:
        fail(f"map {CHAIN_MAP} certified {len(sc.seg)} of {CHAIN_ASK}, "
             f"fewer than {CHAIN_REFINE_B}")
    reps = -(-CHAIN_ROWS // len(sc.seg))
    rows = ScenarioBatch(*(np.concatenate([a] * reps)[:CHAIN_ROWS]
                           for a in sc))
    launch, recorded = admm_chunk._launch, {}
    got = {}
    with tempfile.TemporaryDirectory() as d:
        src, data = os.path.join(d, "refine_in.npz"), os.path.join(
            d, "corpus.npz")
        dataset.write_npz(src, ScenarioBatch(*(a[:CHAIN_REFINE_B]
                                               for a in sc)))
        dataset.write_npz(data, rows)
        out = os.path.join(d, "refined.npz")
        zero_counts()
        got["refine"] = refine_targets.refine_corpus(
            src, out, CHAIN_REFINE_B, device=dev, log=log)
        got["refine_launches"] = (K1.launches, L1.launches)
        inp = refine_targets.read_corpus(src)
        asm = refine_targets.assemble(inp, out, CHAIN_REFINE_B,
                                      refine_targets.STEPS)
        checks = {}
        chain.contract_gate(checks, inp, asm["times"], asm["improved"],
                            asm["obj0"], asm["obj"])
        admm_chunk._launch = first_launch_per_batch(launch, recorded)
        LDL_REC["tag"], LDL_REC["batch"] = "chain B=128", 128
        try:
            got["train"] = train_big.train(
                "big3", data, os.path.join(d, "big3"), 1, 0, "jax", dev,
                log=log)
        finally:
            admm_chunk._launch = launch
            LDL_REC["tag"], LDL_REC["batch"] = None, None
        got["finetune"] = finetune_qp.finetune(
            data, finetune_qp.START, os.path.join(d, "finetune"), 1, dev,
            log=log)
        got["calibrate"] = calibrate_thresh.calibrate(
            os.path.join(ROOT, "runs", "big3"), data, CHAIN_VAL,
            os.path.join(d, "calibrate"), dev, log=log, grid=CHAIN_GRID)
    k1n = K1.launches
    l1_ran("chain")
    print(f"chain: map {CHAIN_MAP}: {len(sc.seg)} certified of {CHAIN_ASK} "
          f"in {e['map_s']:.2f} s; refinement of {CHAIN_REFINE_B} rows "
          f"as one chunk: {json.dumps(got['refine']['stats'])}, "
          f"{got['refine']['chunks'][0]['ms']:.1f} ms, launches "
          f"{got['refine_launches']}; contract "
          + json.dumps(checks["refine_contract"]), flush=True)
    if not checks["refine_contract"]["ok"]:
        fail("the refinement breaks its contract")
    want = refine_targets.chunk_launches()
    if tuple(got["refine_launches"]) != want:
        fail(f"the refine chunk launched {got['refine_launches']}, not "
             f"{want}")
    for name in ("train", "finetune"):
        r = got[name]
        steps = r["metrics"]
        tw, ew = chain.train_launches(r)
        print(f"  {name}: {len(steps)} steps, ms per step "
              f"{r['train']['ms_per_step']:.1f}; losses "
              + ", ".join(f"{s['obj']:.3f}" for s in steps)
              + f"; launches {r['train']['k1']} / {r['train']['l1']} "
              f"(expected {tw}); eval_fresh success "
              f"{r['eval_fresh']['success_rate']:.4f}, launches "
              f"{r['eval']['k1']} / {r['eval']['l1']} (expected {ew})",
              flush=True)
        if len(steps) != CHAIN_STEPS or not all(
                np.isfinite(s["obj"]) for s in steps):
            fail(f"chain {name} ran {len(steps)} steps or a non-finite loss")
        if ((r["train"]["k1"], r["train"]["l1"]) != tw
                or (r["eval"]["k1"], r["eval"]["l1"]) != ew):
            fail(f"chain {name} launched other counts than its code gives")
    c = got["calibrate"]
    bk, bl = admm.solve_launches(calibrate_thresh.CFG.qp,
                                 calibrate_thresh.CFG.solver)
    tms = c["timing"]["grid"] + [c["timing"]["eval_fresh"]]
    cal = (sum(t["k1"] for t in tms), sum(t["l1"] for t in tms))
    nb = sum(t["batches"] for t in tms)
    print(f"  calibration of runs/big3 on {c['calibration']['val_n']} rows: "
          + json.dumps([[r["token_thresh"], r["stop_token_accuracy"],
                         r["success_rate"]] for r in c["calibration"]
                        ["grid"]])
          + f"; best {c['calibration']['best_thresh']}; eval_fresh "
          f"success {c['eval_fresh_calibrated']['success_rate']:.4f}; "
          f"launches {cal} (expected {(nb * bk, nb * bl)})", flush=True)
    if len(c["calibration"]["grid"]) != len(CHAIN_GRID) or cal != (
            nb * bk, nb * bl):
        fail("the chain's calibration ran another grid or launch count")
    if 128 not in recorded:
        fail(f"admm_chunk ran at batch sizes {sorted(recorded)} in the "
             f"chain's training")
    shape = shape_numbers(admm_chunk, train_big.CFG.qp, recorded[128],
                          "chain train B=128")
    shape.update(launches={
        "refine_chunk": list(got["refine_launches"]),
        **{n: [got[n]["train"]["k1"], got[n]["train"]["l1"]]
           for n in ("train", "finetune")}, "calibrate": list(cal)},
        ms_per_step={n: got[n]["train"]["ms_per_step"]
                     for n in ("train", "finetune")},
        refine_chunk_ms=got["refine"]["chunks"][0]["ms"])
    phase("chain", t0)
    return k1n, shape, rows


def batch_mate_check(dev):
    """K1 on eval_fresh row ABL_ROW's chunk inputs (the refinement's
    cfg, its stored times; built once at B=ABL_WIDE and sliced) alone,
    beside itself, beside row ABL_MATE and in its batch of ABL_WIDE: the
    row's outputs must be bit-equal every time.  Not counted."""
    import numpy as np
    import torch
    from allocnet_tpu_torch.ops import admm_chunk, qp
    from allocnet_tpu_torch.train import refine_targets

    sc = refine_targets.read_corpus(os.path.join(ROOT, "data",
                                                 "eval_fresh.npz"))
    cfg = refine_targets.CFG
    s = cfg.solver
    idx = np.array([ABL_ROW, ABL_MATE] + [i for i in range(ABL_WIDE)
                                          if i not in (ABL_ROW, ABL_MATE)]
                   )[:ABL_WIDE]
    t = lambda a: torch.as_tensor(a[idx], device=dev)
    data = qp.build_qp(cfg.qp, t(sc.state), t(sc.hpolys), t(sc.times),
                       t(sc.seg).long(), device=dev)
    args = admm_chunk.chunk_inputs(data, s)
    rest = (s.iters_per_chunk, s.sigma, s.alpha)
    pick = lambda rows: [a[rows].contiguous() if torch.is_tensor(a)
                         and a.dim() and a.shape[0] == ABL_WIDE else a
                         for a in args]
    runs = {name: admm_chunk.admm_chunk(*pick(torch.as_tensor(rows,
                                                              device=dev)),
                                        *rest)
            for name, rows in (("alone", [0]), ("itself", [0, 0]),
                               ("row 5", [0, 1]),
                               (f"B={ABL_WIDE}", list(range(ABL_WIDE))))}
    torch.cuda.synchronize()
    want = runs["alone"]
    same = {name: all(torch.equal(g[0], w[0]) for g, w in zip(got, want))
            for name, got in runs.items()}
    print(f"  row {ABL_ROW} through the kernel (B=1, 2, 2, {ABL_WIDE}), "
          f"outputs bit-equal to B=1: {json.dumps(same)}", flush=True)
    if not all(same.values()):
        fail(f"the kernel's outputs for row {ABL_ROW} depend on its "
             f"batch mates: {same}")
    return same


def ablation_phase(dev, rows):
    """train/ablation's arms on the chain phase's rows (CHAIN_ROWS, a
    Loader split of CHAIN_STEPS steps of 128): `ablation.run` for one
    epoch of each arm at its script's cfg and full width from the JAX
    init, each ending in an eval over the first ABL_EVAL held-out
    scenarios (one batch).  Fails unless every arm ran CHAIN_STEPS finite
    steps and launched K1 and L1 exactly as `ablation.launches_want`
    gives (the run's own gates d); then K1 and L1 against their plain
    versions at the ConvMLP QP-gradient step's B=128 (its first launch and
    polish block) and the kernel's batch-mate check (`batch_mate_check`).
    Returns K1's launches on the path, the kernels' numbers at that shape
    and the batch-mate result."""
    from allocnet_tpu_torch.train import ablation, dataset, heldout_eval

    t0 = time.perf_counter()
    log = lambda s: print("  " + s, flush=True)
    inputs = {}
    with tempfile.TemporaryDirectory() as d:
        data, ev = os.path.join(d, "rows.npz"), os.path.join(d, "eval.npz")
        dataset.write_npz(data, rows)
        dataset.write_npz(ev, heldout_eval.load_scenarios(ABL_EVAL))
        zero_counts()
        out = ablation.run(list(ablation.ARMS), dev, data, 1, ev,
                           out_dir=os.path.join(d, "out"),
                           work=os.path.join(d, "work"),
                           kernel_inputs=inputs, log=log)
    k1n = K1.launches
    l1_ran("ablation")
    for arm, r in out["arms"].items():
        tw, ew = ablation.launches_want(ablation.arm_cfg(arm), r)
        print(f"  {arm}: {r['steps']} steps, ms per step "
              f"{r['train']['ms_per_step']:.1f}; step 1 loss "
              f"{r['step1']['obj']:.3f}; launches {r['train']['k1']} / "
              f"{r['train']['l1']} (expected {tw}); eval success "
              f"{r['eval_fresh']['success_rate']:.4f} of {ABL_EVAL}, "
              f"launches {r['eval']['k1']} / {r['eval']['l1']} (expected "
              f"{ew})", flush=True)
        if r["steps"] != CHAIN_STEPS or not out["gates"]["checks"][
                f"windows_{arm}"]["finite"]:
            fail(f"ablation {arm} ran {r['steps']} steps or a non-finite "
                 f"loss")
        if ((r["train"]["k1"], r["train"]["l1"]) != tw
                or (r["eval"]["k1"], r["eval"]["l1"]) != ew):
            fail(f"ablation {arm} launched other counts than its code "
                 f"gives")
    shape = ablation.kernel_numbers(ablation.arm_cfg("mlp_qp_grad"),
                                    *inputs["mlp_qp_grad"], "mlp_qp_grad",
                                    log)
    shape["launches"] = {arm: [r["train"]["k1"], r["train"]["l1"],
                               r["eval"]["k1"], r["eval"]["l1"]]
                         for arm, r in out["arms"].items()}
    shape["ms_per_step"] = {arm: r["train"]["ms_per_step"]
                            for arm, r in out["arms"].items()}
    same = batch_mate_check(dev)
    phase("ablation", t0)
    return k1n, shape, same


def application_phases(dev, drv, params, cold_inputs, mission):
    """The application layer at DEPLOY: dataset generation from a point
    cloud, the exported artefacts, the fast start, the on-chip tick cost,
    the scaling sweep and one min-jerk batch.  Returns the kernel's
    launches by path and its numbers at the certify and min-jerk shapes."""
    import numpy as np
    import torch
    from allocnet_tpu_torch import config
    from allocnet_tpu_torch.config import QPConfig, SolverConfig
    from allocnet_tpu_torch.models import export, packing
    from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
    from allocnet_tpu_torch.ops import admm, admm_chunk, qp
    from allocnet_tpu_torch.parallel import scaling
    from allocnet_tpu_torch.planner import driver, planner, replan
    from allocnet_tpu_torch.train import datagen
    from allocnet_tpu_torch.utils import pcd, scenarios, timing, witness

    k1, launch = admm_chunk.admm_chunk, admm_chunk._launch
    dcfg = config.DEPLOY
    launches, shapes = {}, {}

    # ---- 9. datagen: PCD -> crops -> corridors -> certify ----------------
    t0 = time.perf_counter()
    tiles = [datagen.random_obstacle_map(DATAGEN_SEED + k, EXTENT)
             + np.array([20.0 * (k % 2), 20.0 * (k // 2), 0.0])
             for k in range(4)]
    cloud = np.concatenate(tiles)
    with tempfile.TemporaryDirectory() as d:
        pcd.write_pcd(os.path.join(d, "cloud.pcd"), cloud)
        back = pcd.read_pcd(os.path.join(d, "cloud.pcd"))
    if back.shape != cloud.shape or np.abs(back - cloud).max() > 1e-5:
        fail("the PCD round trip changed the cloud")
    min_pts = min(len(t) for t in tiles)
    crops = pcd.crop_segments(back, extent=DATAGEN_CROP, stride=(10.0, 10.0),
                              min_points=min_pts)
    print(f"datagen: cloud of {len(cloud)} points (4 tiles, seeds "
          f"{DATAGEN_SEED}-{DATAGEN_SEED + 3}); PCD round trip max diff "
          f"{np.abs(back - cloud).max():.2e}; {len(crops)} crops of "
          f"{DATAGEN_CROP} m with >= {min_pts} points: "
          + ", ".join(f"{np.round(c['origin'], 2).tolist()} "
                      f"({len(c['points'])})" for c in crops))
    if not crops:
        fail("no crop holds a tile's points")
    rec = {"batch": None, "args": None, "cands": [], "plans": []}
    certified, plan_batch = datagen.certified, planner.plan_corridors_batch

    def rec_certified(cfg, sc, device=None):
        rec["batch"] = rec["batch"] or sc
        return certified(cfg, sc, device)

    def rec_plans(pmap, starts, goals, cfg, seed=0, **k):
        out = plan_batch(pmap, starts, goals, cfg, seed=seed, **k)
        rec["cands"].append((starts, goals, seed))
        rec["plans"].append(out)
        return out

    def rec_launch(lib, *a):
        if rec["args"] is None:
            rec["args"] = [t.clone() if torch.is_tensor(t) else t
                           for t in a[:17]]
        return launch(lib, *a)

    datagen.certified, planner.plan_corridors_batch = rec_certified, rec_plans
    admm_chunk._launch = rec_launch
    timer = timing.PhaseTimer()
    torch.cuda.synchronize()
    zero_counts()
    LDL_REC["tag"] = "certify"
    t1 = time.perf_counter()
    gen = datagen.generate(dcfg, DATAGEN_N, points=crops[0]["points"],
                           extent=DATAGEN_CROP, seed=DATAGEN_SEED,
                           device=dev, timer=timer)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t1
    LDL_REC["tag"] = None
    launches["datagen"] = k1.launches
    l1_ran("datagen")
    datagen.certified, planner.plan_corridors_batch = certified, plan_batch
    admm_chunk._launch = launch
    n_cand = sum(len(c[0]) for c in rec["cands"])
    print(f"  generate(DEPLOY, n_samples={DATAGEN_N}) on crop 0: {gen_s:.3f} "
          f"s; {n_cand} candidates drawn, {len(rec['batch'].seg)} with a "
          f"corridor went to certify, {len(gen.seg)} kept; stages ms "
          + ", ".join(f"{k} {v['total_s'] * 1e3:.1f}"
                      for k, v in timer.summary().items())
          + f"; admm_chunk launches {launches['datagen']}, ldl_block "
          f"{LDL_LAUNCHES['datagen']}")
    if len(gen.seg) == 0 or not np.isfinite(gen.times).all():
        fail("generate kept no sample or gave non-finite times")
    if launches["datagen"] != config.CERTIFY_SOLVER.n_chunks:
        fail(f"certify launched admm_chunk {launches['datagen']} times")
    shapes["certify"] = shape_numbers(admm_chunk, dcfg.qp, rec["args"],
                                      "certify")
    flags_gpu = datagen.certified(dcfg, rec["batch"], device=dev)
    flags_cpu = datagen.certified(dcfg, rec["batch"], device="cpu")
    agree = float((flags_gpu == flags_cpu).mean())
    print(f"  certify flags, card vs CPU plain path: agree on "
          f"{int((flags_gpu == flags_cpu).sum())} of {len(flags_cpu)} "
          f"({agree:.4f}); kept {int(flags_gpu.sum())} / {int(flags_cpu.sum())}")

    def solve(sc, device):
        f32 = np.float32
        data = qp.build_qp(dcfg.qp, sc.state.astype(f32),
                           sc.hpolys.astype(f32), sc.times.astype(f32),
                           sc.seg, device=device)
        return admm.solve_qp(data, config.CERTIFY_SOLVER)
    # what the card keeps is solved: its solutions pass the solved test
    # again in float64 on the CPU
    sols = {dev: solve(rec["batch"], dev)}
    again = sols[dev].solved.cpu().numpy()
    ok64 = solved_in_f64(dcfg, rec["batch"], sols[dev])
    print(f"  card certify run again on the same batch: flags identical "
          f"{bool((again == flags_gpu).all())}; of its {int(again.sum())} "
          f"kept samples {int(ok64[again].sum())} pass the solved test "
          f"re-evaluated in float64 on the CPU")
    if (again != flags_gpu).any():
        fail("the card's certify flags changed between two runs")
    if not ok64[again].all():
        fail(f"certify samples {np.nonzero(again & ~ok64)[0].tolist()} are "
             f"kept on the card and fail the solved test in float64")
    if agree < 1.0:
        # what the disagreeing samples look like on each side
        sols["cpu"] = solve(rec["batch"], "cpu")
        for b in np.nonzero(flags_gpu != flags_cpu)[0]:
            print(f"    sample {b} (seg {rec['batch'].seg[b]}): " + "; ".join(
                f"{'card' if d != 'cpu' else 'CPU'} solved "
                f"{bool(s_.solved[b])} polished {bool(s_.polished[b])} "
                f"pri_rel {float(s_.pri_rel[b]):.3e} dua_rel "
                f"{float(s_.dua_rel[b]):.3e} obj {float(s_.obj[b]):.5f}"
                for d, s_ in sols.items()))
            for s_ in sols.values():
                if not bool(torch.isfinite(s_.coeffs[b]).all()):
                    fail(f"certify sample {b} disagrees and one side's "
                         f"coefficients are not finite")
        # a sample the card drops and the CPU keeps must be one whose CPU
        # flag is decided by rounding (one the card keeps is held by the
        # float64 test above)
        bad, ctrl, flips, _ = rounding_witness(
            dcfg, rec["batch"], flags_gpu, flags_cpu, dev)
        missed = bad[(flips[:len(bad)] == 0) & ~flags_gpu[bad]]
        if len(missed):
            fail(f"certify samples {missed.tolist()} are dropped on the card "
                 f"and kept on the CPU under every perturbation of the times")
        if 2 * int((flips[len(bad):] > 0).sum()) > len(ctrl):
            fail("the rounding witness flips most of the control samples")
    if TRACE_SAMPLE < len(rec["batch"].seg):
        trace_sample(dcfg, rec["batch"], TRACE_SAMPLE, dev)
    starts, goals, seed = rec["cands"][0]
    n_c = min(8, len(starts))
    pmap_c = planner.build_map(crops[0]["points"], np.zeros(3),
                               np.asarray(DATAGEN_CROP), device="cpu")
    cpu_plans = plan_batch(pmap_c, starts[:n_c], goals[:n_c], dcfg,
                           seed=seed, device="cpu")
    worst = 0.0
    for b, (g, c) in enumerate(zip(rec["plans"][0][:n_c], cpu_plans)):
        if g.ok != c.ok or g.seg != c.seg:
            fail(f"datagen candidate {b}: card corridor ok {g.ok} seg "
                 f"{g.seg}, CPU ok {c.ok} seg {c.seg}")
        if g.ok:
            d = witness.corridor_distance(g.hpolys, g.seg, c.hpolys, c.seg)
            worst = max(worst, np.inf if d is None else d)
    print(f"  corridors of the first {n_c} candidates, card vs CPU: same ok "
          f"and seg, faces within {worst:.3e} of the largest entry")
    if worst > CORRIDOR_TOL:
        fail("datagen corridors on the card differ from the CPU's")
    phase("datagen", t0)

    # ---- 10. export: TorchScript net, exported replan step ---------------
    t0 = time.perf_counter()
    net = ConvLSTMAllocNet(5, 256, token_thresh=0.5)
    net.load_state_dict(params)
    net = net.to(dev).eval()
    sc = scenarios.random_scenarios(dcfg.qp, 16, seed=SEED, min_seg=1)
    xs = packing.pack_state(torch.as_tensor(sc.state, dtype=torch.float32,
                                            device=dev))
    xh = packing.pack_hpolys(torch.as_tensor(sc.hpolys, dtype=torch.float32,
                                             device=dev))
    with tempfile.TemporaryDirectory() as d:
        export.save(d, net, batch=16, seq_len=5)
        ts_net = export.load(d)
        with torch.no_grad():
            got, want = ts_net(xs, xh), net(xs, xh)
        ts_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        t1 = time.perf_counter()
        export.save_replan(d, net, dcfg, batch=1)
        exp_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        prog = export.load_replan(d)
        load_s = time.perf_counter() - t1
        size = os.path.getsize(os.path.join(d, "replan.pt2"))
    print(f"export: TorchScript seq5 net, times and tokens vs eager on the "
          f"card {ts_err:.3e}; replan step exported in {exp_s:.1f} s, "
          f"loaded in {load_s:.1f} s ({size} bytes)")
    if ts_err > 1e-6:
        fail("the TorchScript net differs from the eager net")
    # the first mission's cold inputs: with no previous plan, then warm
    # from the driver's cold-tick plan; and the first of the 16 random
    # scenarios above that the eager step solves, so that a solved,
    # polished plan is compared too
    st9, hp, sg = cold_inputs
    with torch.no_grad():
        c_solved, c_plan = drv._cold(st9, hp, sg)[:2]
    none1 = replan.init_state(1, dcfg, device=dev)
    cases = [("no previous plan", (st9, hp, sg), none1),
             (f"warm from the cold tick's plan (solved {bool(c_solved[0])})",
              (st9, hp, sg), replan.ReplanState(c_plan.contiguous(),
                                                c_solved))]
    t32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    for r in range(len(sc.seg)):
        one = (t32(sc.state[r:r + 1]), t32(sc.hpolys[r:r + 1]),
               torch.as_tensor(sc.seg[r:r + 1], device=dev))
        if bool(replan.replan_step(net, None, dcfg, *one, none1,
                                   device=dev)[2][0]):
            cases.append((f"random scenario {r} (seed {SEED}), no previous "
                          f"plan", one, none1))
            break
    else:
        fail("the replan step solves none of the 16 random scenarios")
    launches["replan_export"] = 0
    n_solved, n_ldl = 0, 0
    for name, (st9, hp, sg), prev in cases:
        torch.cuda.synchronize()
        zero_counts()
        out = prog(st9, hp, sg.to(torch.int32), prev.coeffs, prev.have_prev)
        torch.cuda.synchronize()
        n_launch = k1.launches
        launches["replan_export"] += n_launch
        n_ldl += l1_ran("replan_export")
        eager = replan.replan_step(net, None, dcfg, st9, hp, sg, prev,
                                   device=dev)
        n_solved += int(bool(out[2][0]) and bool(eager[2][0]))
        c_p, c_e = out[1].cpu().numpy(), eager[1].cpu().numpy()
        rp_err = float(np.abs(c_p - c_e).max() / max(1.0, np.abs(c_e).max()))
        print(f"  program vs eager replan_step, {name}: solved "
              f"{bool(out[2][0])} / {bool(eager[2][0])}, coefficients "
              f"{rp_err:.3e} of the largest; admm_chunk launches {n_launch}"
              f", ldl_block {LDL_LAUNCHES['replan_export']}")
        if (bool(out[2][0]) != bool(eager[2][0]) or rp_err > 1e-6
                or not np.isfinite(c_p).all()):
            fail("the exported replan step differs from the eager one")
        if n_launch < 1:
            fail("the exported replan step did not launch admm_chunk")
    if n_solved == 0:
        fail("no compared replan step solved")
    LDL_LAUNCHES["replan_export"] = n_ldl
    phase("export", t0)

    # ---- 11. fast start: prebuilt libraries, first tick in a new process --
    t0 = time.perf_counter()
    start, goal, _, cp = mission
    with tempfile.TemporaryDirectory() as d:
        aot = os.path.join(d, "aot")
        sizes = drv.save_aot(aot)
        npz = os.path.join(d, "mission.npz")
        np.savez(npz, start=start, goal=cp.route[-1], hpolys=cp.hpolys,
                 seg=cp.seg)
        runs = {}
        for kind, extra in (("aot", [aot]), ("build", [])):
            t1 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--first-tick",
                 npz, os.path.join(d, f"cache_{kind}"), *extra],
                capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t1
            if res.returncode != 0:
                fail(f"the {kind} first-tick process failed:\n"
                     f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
            runs[kind] = json.loads(res.stdout.strip().splitlines()[-1])
            runs[kind]["process_s"] = wall
            runs[kind]["plan"] = dict(np.load(npz.replace(
                ".npz", f"_{kind}.npz")))
    for kind, r in runs.items():
        print(f"fast_start: {kind}: {r['process_s']:.2f} s process wall, "
              f"{r['to_first_tick_s']:.2f} s to the first tick (solved "
              f"{r['solved']}); compilers run before the tick "
              f"{r['builds_before_tick_s']}, in all {r['builds_s']} (s); "
              f"aot_loaded {r['aot_loaded']}; admm_chunk launches "
              f"{r['launches']}, ldl_block {r['ldl_launches']}")
    print(f"  artefact: {sizes} bytes")
    a, b = runs["aot"], runs["build"]
    if not a["aot_loaded"] or a["builds_s"] or b["aot_loaded"]:
        fail("the prebuilt-library process built or did not load them")
    if set(b["builds_s"]) != {"nvcc", "g++"}:
        fail(f"the building process ran {b['builds_s']}, not nvcc and g++")
    if not a["solved"] or not b["solved"]:
        fail("a first tick did not solve")
    pdiff = max(float(np.abs(a["plan"][k] - b["plan"][k]).max()
                      / max(1.0, np.abs(b["plan"][k]).max()))
                for k in b["plan"])
    print(f"  the two first ticks' plans differ by {pdiff:.3e} of the largest")
    if pdiff > 1e-6:
        fail("the two first ticks differ")
    launches["fast_start"] = a["launches"] + b["launches"]
    if min(a["ldl_launches"], b["ldl_launches"]) < 1:
        fail("a first tick did not launch ldl_block")
    l1_ran("fast_start", a["ldl_launches"] + b["ldl_launches"])
    phase("fast_start", t0)

    # ---- 12. on-chip tick cost: a cold tick and 19 warm ticks ------------
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    zero_counts()
    per_tick, solved_f, arrived_f = driver.onchip_tick_cost(
        ConvLSTMAllocNet(5, 256, token_thresh=0.5), params, dcfg,
        *cold_inputs, n_ticks=ONCHIP_TICKS, device=dev)
    launches["onchip"] = k1.launches
    l1_ran("onchip")
    print(f"onchip: {ONCHIP_TICKS} ticks chained on the card: "
          f"{per_tick * 1e3:.1f} ms per tick, solved {solved_f:.4f}, "
          f"arrived {arrived_f:.1f}; admm_chunk launches {k1.launches} "
          f"(4 cold + {ONCHIP_TICKS - 1} warm), ldl_block "
          f"{LDL_LAUNCHES['onchip']}")
    if not all(np.isfinite([per_tick, solved_f, arrived_f])):
        fail("onchip_tick_cost gave a non-finite number")
    if k1.launches != 4 + ONCHIP_TICKS - 1:
        fail(f"onchip launched admm_chunk {k1.launches} times")
    phase("onchip", t0)

    # ---- 13. scaling: the solve sweep on this one card -------------------
    t0 = time.perf_counter()
    zero_counts()
    sweep = scaling.solve_scaling(per_device_batch=B, device_counts=(1,),
                                  cfg=QPConfig(), scfg=SolverConfig(),
                                  device=dev)
    launches["scaling"] = k1.launches
    l1_ran("scaling")
    print(f"scaling: {json.dumps(sweep)}; admm_chunk launches {k1.launches}"
          f", ldl_block {LDL_LAUNCHES['scaling']}")
    if sweep["platform"] != "gpu" or not sweep[1]["solves_per_sec"] > 0:
        fail("solve_scaling did not run on the card")
    phase("scaling", t0)

    # ---- 14. min-jerk: the kernel at order 3 (D=6) -----------------------
    t0 = time.perf_counter()
    jcfg, scfg = config.jerk(QPConfig()), SolverConfig()
    jsc = scenarios.random_scenarios(jcfg, JERK_B, seed=SEED, min_seg=1)
    f32 = np.float32
    jdata = qp.build_qp(jcfg, jsc.state.astype(f32), jsc.hpolys.astype(f32),
                        jsc.times.astype(f32), jsc.seg, device=dev)
    jargs = list(admm_chunk.chunk_inputs(jdata, scfg)) + [
        scfg.iters_per_chunk, scfg.sigma, scfg.alpha]
    shapes["jerk"] = shape_numbers(admm_chunk, jcfg, jargs, "min-jerk")
    phase("jerk", t0)
    return launches, shapes


def seq10_phase(dev, qp_oracle):
    """The ten-segment operating point (`config.SEQ10`, n = 240) through
    the kernel: against its plain version on the solve's first chunk and
    on three route batches, the S = 10 solve (f64 oracle, CPU flags), one
    plan_batch request with the seq10 net and one with refinement, and
    plan_many on the maze.  Returns the kernel's launches by path and its
    numbers at this shape."""
    import numpy as np
    import torch
    from allocnet_tpu_torch import config
    from allocnet_tpu_torch.config import (AllocNetConfig, CorridorConfig,
                                           QPConfig, SolverConfig)
    from allocnet_tpu_torch.models import weights
    from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
    from allocnet_tpu_torch.ops import admm, admm_chunk, qp
    from allocnet_tpu_torch.planner import pipeline, planner, trajectory
    from allocnet_tpu_torch.train import datagen
    from allocnet_tpu_torch.utils import scenarios

    t0 = time.perf_counter()
    k1 = admm_chunk.admm_chunk
    cfg, scfg = config.SEQ10.qp, config.SEQ10.solver
    it, f32 = scfg.iters_per_chunk, np.float32
    launches = {}
    print(f"seq10: S={cfg.max_seg}, res={cfg.res}, n={cfg.n_var}, "
          f"m={cfg.n_eq}: dynamic shared memory per block "
          f"{admm_chunk.smem_bytes(cfg)} bytes, blocks (scenarios) per SM "
          f"{admm_chunk.blocks_per_sm(cfg)}")
    if admm_chunk.blocks_per_sm(cfg) < 1:
        fail("the kernel refuses the ten-segment shape")

    def kx_kept(a):
        modes = np.bincount(admm_chunk.kx_modes(*a[:14]), minlength=3)
        return ", ".join(f"{n} {int(c)}" for n, c in
                         zip(admm_chunk.KX_MODES, modes))

    sc = scenarios.random_scenarios(cfg, B, seed=SEED, min_seg=1)
    data = qp.build_qp(cfg, sc.state.astype(f32), sc.hpolys.astype(f32),
                       sc.times.astype(f32), sc.seg, device=dev)
    args = list(admm_chunk.chunk_inputs(data, scfg)) + [it, scfg.sigma,
                                                        scfg.alpha]
    shape = shape_numbers(admm_chunk, cfg, args, "seq10 solve's first chunk",
                          reps=5)
    print(f"  Kx kept: {kx_kept(args)}; segments per scenario "
          f"{float(sc.seg.mean()):.3f}")
    shape["batches"] = {}
    for batch in ("every_segment", "full_faces", "padded_warm_start"):
        rargs = list(admm_chunk.check_batch(batch, cfg, scfg, B, SEED, dev)) + [
            it, scfg.sigma, scfg.alpha]
        shape["batches"][batch] = shape_numbers(admm_chunk, cfg, rargs,
                                                f"seq10 {batch}", reps=3)
        print(f"  Kx kept: {kx_kept(rargs)}")
    phase("seq10 kernel", t0)

    # ---- the S = 10 solve --------------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    zero_counts()
    LDL_REC["tag"] = "S=10 solve"
    sol = admm.solve_qp(data, scfg)
    torch.cuda.synchronize()
    LDL_REC["tag"] = None
    launches["seq10_solve"] = k1.launches
    l1_ran("seq10_solve")
    if k1.launches != scfg.n_chunks:
        fail(f"the S=10 solve launched admm_chunk {k1.launches} times")
    solved = sol.solved.cpu().numpy()
    coeffs = sol.coeffs.cpu().numpy()
    rel = torch.maximum(sol.pri_rel, sol.dua_rel).cpu().numpy()
    if coeffs.shape != (B, cfg.max_seg, 3, cfg.D) or not np.isfinite(
            coeffs).all():
        fail("the S=10 solve gave non-finite coefficients")
    idx = np.nonzero(solved)[0]
    if len(idx) == 0:
        fail("the S=10 solve solved nothing")
    # half of the oracle's scenarios from the solved ones of more than 5
    # segments, half from the rest, each spread over the batch
    picks = []
    for part in (idx[sc.seg[idx] > 5], idx[sc.seg[idx] <= 5]):
        if len(part):
            picks += part[np.linspace(0, len(part) - 1,
                                      ORACLE_N // 2).astype(int)].tolist()
    checked, max_diff, long_checked = 0, 0.0, 0
    for b in sorted(set(picks)):
        ora = qp_oracle.solve_scenario(cfg, sc.state[b], sc.hpolys[b],
                                       sc.times[b], sc.seg[b])
        if ora["kkt"] > 1e-7:
            continue
        L = int(sc.seg[b])
        max_diff = max(max_diff, float(np.abs(coeffs[b, :L]
                                              - ora["coeffs"]).max()))
        checked += 1
        long_checked += L > 5
    sets = [cuda_ms(lambda: admm.solve_qp(data, scfg), reps=3)
            for _ in range(2)]
    print(f"seq10 solve_qp B={B}: solved {float(solved.mean()):.4f} "
          f"(segments {float(sc.seg.mean()):.3f} per scenario), max "
          f"normalized residual on the solved set {float(rel[solved].max()):.3e}"
          f"; f64 oracle: {checked} scenarios ({long_checked} with more than "
          f"5 segments), max coefficient diff {max_diff:.3e}; admm_chunk "
          f"launches {launches['seq10_solve']}, ldl_block "
          f"{LDL_LAUNCHES['seq10_solve']}; ms per solve, 2 sets x 3: "
          + ", ".join(f"{t:.2f}" for t in sets)
          + f" -> {B / (np.mean(sets) / 1e3):.1f} solves/s")
    if checked < ORACLE_N // 2 or long_checked == 0 or max_diff > 1e-3:
        fail(f"S=10 oracle parity: {checked} checked ({long_checked} long), "
             f"max diff {max_diff:.2e}")
    n = SEQ10_CPU_N
    cdata = qp.build_qp(cfg, sc.state[:n].astype(f32),
                        sc.hpolys[:n].astype(f32), sc.times[:n].astype(f32),
                        sc.seg[:n], device="cpu")
    csol = admm.solve_qp(cdata, scfg)
    cs = csol.solved.numpy()
    agree = float((cs == solved[:n]).mean())
    both = cs & solved[:n]
    cdiff = float(np.abs(coeffs[:n] - csol.coeffs.numpy())[both].max()) \
        if both.any() else 0.0
    print(f"  vs the CPU plain path on the first {n}: solved flags agree on "
          f"{agree:.4f}, {int(both.sum())} solved on both, max coefficient "
          f"diff {cdiff:.3e}")
    for b in np.nonzero(cs != solved[:n])[0]:
        print(f"    scenario {b} (seg {sc.seg[b]}): card solved "
              f"{bool(solved[b])} pri_rel {float(sol.pri_rel[b]):.3e} dua_rel "
              f"{float(sol.dua_rel[b]):.3e}; CPU solved {bool(cs[b])} pri_rel "
              f"{float(csol.pri_rel[b]):.3e} dua_rel "
              f"{float(csol.dua_rel[b]):.3e}")
    if agree < SEQ10_FLAG_AGREE:
        fail("the S=10 solve's flags on the card disagree with the CPU's")
    # where the two f32 solves land more than 1e-3 apart, the card's
    # coefficients are the ones held to the f64 oracle
    apart = both & (np.abs(coeffs[:n] - csol.coeffs.numpy()).reshape(
        n, -1).max(1) > 1e-3)
    for b in np.nonzero(apart)[0]:
        ora = qp_oracle.solve_scenario(cfg, sc.state[b], sc.hpolys[b],
                                       sc.times[b], sc.seg[b])
        L = int(sc.seg[b])
        e_card = float(np.abs(coeffs[b, :L] - ora["coeffs"]).max())
        e_cpu = float(np.abs(csol.coeffs.numpy()[b, :L]
                             - ora["coeffs"]).max())
        print(f"    scenario {b} (seg {L}): card and CPU {float(np.abs(coeffs[b] - csol.coeffs.numpy()[b]).max()):.3e} "
              f"apart; from the f64 oracle (kkt {ora['kkt']:.1e}) card "
              f"{e_card:.3e}, CPU {e_cpu:.3e}")
        if ora["kkt"] <= 1e-7 and e_card > 1e-3:
            fail(f"S=10 scenario {b}: the card's solution is not the "
                 f"oracle's")
    phase("seq10 solve", t0)

    # ---- serve: one plan_batch request with the seq10 net, one refined ---
    t0 = time.perf_counter()
    net = ConvLSTMAllocNet(cfg.max_seg, 256, config.SEQ10.model.token_thresh)
    net.load_state_dict(weights.load_params(os.path.join(ROOT, SEQ10_NET)))
    net = net.to(dev).eval()
    req = scenarios.random_scenarios(cfg, B, seed=SEED + 1, min_seg=1)
    pipeline.plan_batch(net, cfg, scfg, req.state[:8], req.hpolys[:8],
                        req.seg[:8])                       # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t1 = time.perf_counter()
    res = pipeline.plan_batch(net, cfg, scfg, req.state, req.hpolys, req.seg)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t1) * 1e3
    launches["seq10_serve"] = k1.launches
    l1_ran("seq10_serve")
    if k1.launches != scfg.n_chunks:
        fail(f"the seq10 plan_batch launched admm_chunk {k1.launches} times")
    if res.coeffs.shape != (B, cfg.max_seg, 3, cfg.D) or not bool(
            torch.isfinite(res.coeffs).all()):
        fail("the seq10 plan_batch gave non-finite coefficients")
    n_ref = 16
    cref = pipeline.plan_batch(net.to("cpu"), cfg, scfg, req.state[:n_ref],
                               req.hpolys[:n_ref], req.seg[:n_ref],
                               device="cpu")
    net = net.to(dev)
    t_ok = torch.allclose(res.times[:n_ref].cpu(), cref.times, rtol=1e-4,
                          atol=1e-5)
    s_agree = int((res.solved[:n_ref].cpu() == cref.solved).sum())
    print(f"seq10 plan_batch B={B}: {serve_ms:.1f} ms; solved "
          f"{float(res.solved.float().mean()):.4f}, ok "
          f"{float(res.ok.float().mean()):.4f}; admm_chunk launches "
          f"{launches['seq10_serve']}, ldl_block {LDL_LAUNCHES['seq10_serve']}"
          f"; vs CPU on {n_ref}: times agree {t_ok}, "
          f"solved flags agree on {s_agree}")
    if not t_ok or s_agree < n_ref - 1:
        fail("the seq10 plan_batch on the card disagrees with the CPU path")
    rin = (req.state[:SEQ10_REFINE_B], req.hpolys[:SEQ10_REFINE_B],
           req.seg[:SEQ10_REFINE_B])
    base = pipeline.plan_batch(net, cfg, scfg, *rin)
    torch.cuda.synchronize()
    zero_counts()
    t1 = time.perf_counter()
    ref = pipeline.plan_batch(net, cfg, scfg, *rin, refine_steps=2)
    torch.cuda.synchronize()
    refine_ms = (time.perf_counter() - t1) * 1e3
    launches["seq10_refine"] = k1.launches
    l1_ran("seq10_refine")
    active = (torch.arange(cfg.max_seg, device=dev)[None, :]
              < torch.as_tensor(rin[2], device=dev)[:, None])
    tot_b = torch.where(active, torch.clamp_min(base.times, 0.05),
                        base.times).sum(1)
    tot_err = float(((ref.times.sum(1) - tot_b).abs() / tot_b).max())
    kept = bool(ref.solved[base.solved].all())
    print(f"  refine_steps=2 at B={SEQ10_REFINE_B}: {refine_ms:.1f} ms; "
          f"solved {int(base.solved.sum())} -> {int(ref.solved.sum())}; "
          f"total time kept to {tot_err:.2e}; admm_chunk launches "
          f"{launches['seq10_refine']}, ldl_block "
          f"{LDL_LAUNCHES['seq10_refine']}")
    if (k1.launches != 5 * scfg.n_chunks or tot_err > 1e-4 or not kept
            or not bool(torch.isfinite(ref.coeffs).all())):
        fail("the seq10 refined plan_batch failed its checks")
    phase("seq10 serve", t0)

    # ---- plan_many on the maze: corridors of more than 5 segments --------
    t0 = time.perf_counter()
    mcfg = AllocNetConfig(
        qp=QPConfig(res=10, max_seg=cfg.max_seg, max_vel=8.0, max_acc=12.0),
        solver=SolverConfig(n_chunks=2, iters_per_chunk=150),
        model=config.SEQ10.model, corridor=CorridorConfig(use_rrt_star=False))
    pts, lo, hi = datagen.maze_map(), np.zeros(3), np.asarray(MAZE_EXTENT)
    starts, goals = np.asarray(MAZE_STARTS), np.asarray(MAZE_GOALS)
    out = {}
    for d in (dev, "cpu"):
        pmap = planner.build_map(pts, lo, hi, scale=0.25, dilate_r=2,
                                 device=d)
        torch.cuda.synchronize()
        zero_counts()
        t1 = time.perf_counter()
        # corridors in f64, as the JAX package computes them in its test
        out[d] = planner.plan_many(pmap, starts, goals, net.to(d), None,
                                   mcfg, device=d, dtype=torch.float64)
        torch.cuda.synchronize()
        if d == dev:
            many_ms = (time.perf_counter() - t1) * 1e3
            launches["seq10_plan_many"] = k1.launches
            l1_ran("seq10_plan_many")
    net.to(dev)
    g, c = out[dev], out["cpu"]
    segs = g.traj.seg_mask.sum(-1).cpu().numpy().astype(int)
    g_solved = g.result.solved.cpu().numpy()
    long_ok = g.corridor_ok & g_solved & (segs > 5)
    print(f"seq10 plan_many on the maze ({len(pts)} points): {many_ms:.1f} ms;"
          f" reasons {g.reasons}, segments {segs.tolist()}, solved "
          f"{g_solved.tolist()} (CPU: {c.reasons}, "
          f"{c.traj.seg_mask.sum(-1).numpy().astype(int).tolist()}, "
          f"{c.result.solved.numpy().tolist()}); admm_chunk launches "
          f"{launches['seq10_plan_many']}, ldl_block "
          f"{LDL_LAUNCHES['seq10_plan_many']}")
    if launches["seq10_plan_many"] != mcfg.solver.n_chunks:
        fail("plan_many did not launch admm_chunk once per chunk")
    if g.reasons != c.reasons or not np.array_equal(
            segs, c.traj.seg_mask.sum(-1).numpy().astype(int)):
        fail("the maze corridors on the card differ from the CPU's")
    if not torch.allclose(g.result.times.cpu(), c.result.times, rtol=1e-4,
                          atol=1e-5):
        fail("the maze plans' times on the card differ from the CPU's")
    if not long_ok.any():
        fail("no maze plan of more than 5 segments solved")
    b = int(np.nonzero(long_ok)[0][0])
    one = trajectory.Trajectory(*(t[b:b + 1] for t in g.traj))
    _, states = trajectory.sample(one, n=64)
    vmax, amax = trajectory.max_rates(one)
    start_err = float((states[0, 0, 0].cpu() - torch.as_tensor(
        starts[b], dtype=states.dtype)).abs().max())
    print(f"  plan {b} ({segs[b]} segments): start within {start_err:.2e} m, "
          f"max speed {float(vmax[0]):.3f} m/s, max acceleration "
          f"{float(amax[0]):.3f} m/s^2")
    if (not bool(torch.isfinite(states).all()) or start_err > 1e-2
            or float(vmax[0]) > 1.2 * mcfg.qp.max_vel
            or float(amax[0]) > 1.2 * mcfg.qp.max_acc):
        fail(f"the maze plan {b} is not a sane trajectory")
    phase("seq10 plan_many", t0)
    return launches, shape


LDL_TAGS = ("deploy solve", "cold tick", "warm tick", "rescue tick",
            "heldout", "refine_eval", "frontend", "corpus",
            "mcnemar10k B=16", "chain B=128", "certify", "S=10 solve")


def ldl_phase(dev, drv, tick_inputs, data, scfg):
    """L1 against its plain version on the card, exactly (`ldl_compare`):
    on every diagonal block of the first polish factorization recorded
    under each of LDL_TAGS, on random quasi-definite blocks with bumped
    pivots (B=1024) and on the same at LDL_TAIL_B, whose last thread block
    is short; on a batch with two non-finite scenarios and on one of 8
    with a NaN in scenario 5 only (which shares its thread block with
    scenarios 4, 6 and 7).  Per shape: ms per launch inside a CUDA graph
    (the kernel's device time), ms per eager call (CUDA events), the plain
    version's ms, the bound (`ldl_work`).  The kernel's launch geometry.
    The deploy solve's polish through L1 against the same solve through
    the plain version.  Then all kernel launches (torch.profiler) per
    factorization, deploy solve, cold tick and warm tick with the plain
    version on the card (before) and with L1 (after), and the ticks' host
    ms both ways.  Returns (numbers by shape, launch and time counts,
    geometry)."""
    import numpy as np
    import torch
    from allocnet_tpu_torch.ops import admm, ldl
    from allocnet_tpu_torch.utils import bench_ldl, profile_solve

    t0 = time.perf_counter()
    ref = ldl.ldl_block_reference
    geometry = ldl.geometry()
    print(f"ldl: L1 geometry: {geometry['warps_per_block']} scenarios "
          f"(warps) per thread block, {geometry['blocks_per_sm']} thread "
          f"blocks per SM, {geometry['registers']} registers and "
          f"{geometry['local_bytes']} bytes of local memory per thread, "
          f"{geometry['smem_bytes']} bytes of shared memory per thread "
          f"block", flush=True)
    shapes = {}
    cases = [(tag, LDL_REC["blocks"].get(tag)) for tag in LDL_TAGS]
    for tag, b in (("random, bumped pivots", B),
                   ("random, short last thread block", LDL_TAIL_B)):
        cases.append((tag, [(*bench_ldl.random_qd_blocks(b, dev, SEED),
                             1e-5)]))
    for tag, blocks in cases:
        if not blocks:
            fail(f"no {tag} factorization reached ldl_block")
        same, bits, absd, bumped = True, True, 0.0, 0
        for Kb, sg, reg in blocks:
            got = L1(Kb, sg, reg)
            torch.cuda.synchronize()
            if not (bool(torch.isfinite(got[0]).all())
                    and bool(torch.isfinite(got[1]).all())):
                fail(f"ldl_block gave non-finite values on the {tag} blocks")
            r = ldl_compare(got, ref(Kb, sg, reg), reg, tag)
            same, bits = same and r[0], bits and r[1]
            absd, bumped = max(absd, r[2]), bumped + r[3]
        Kb, sg, reg = blocks[0]
        ms = bench_ldl.graph_ms(lambda: L1(Kb, sg, reg), reps=LDL_REPS)
        eager = cuda_ms(lambda: L1(Kb, sg, reg), reps=LDL_REPS, warmup=2)
        pms = cuda_ms(lambda: ref(Kb, sg, reg), reps=3)
        ops, nbytes = ldl_work(Kb.shape[0], Kb.shape[1])
        t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        shapes[tag] = {"B": int(Kb.shape[0]), "blocks": len(blocks),
                       "ms": ms, "eager_ms": eager, "plain_ms": pms,
                       "bound_ms": max(t_ops, t_bytes),
                       "bound_by": "operations" if t_ops >= t_bytes
                       else "bytes", "equal": same, "bit_patterns": bits,
                       "max_abs_err": absd, "bumped_pivots": bumped}
        print(f"ldl: {tag}: {len(blocks)} blocks of B={Kb.shape[0]} x 64 x 64;"
              f" kernel {ms:.4f} ms per launch in a graph, {eager:.4f} ms "
              f"per eager call, plain {pms:.3f} ms per block, bound "
              f"{max(t_ops, t_bytes):.5f} ms ({ops:.3e} operations, "
              f"{nbytes:.3e} B); equal {same}, bit patterns equal {bits}; "
              f"bumped pivots {bumped}", flush=True)

    strict = torch.tril(torch.ones(64, 64, dtype=torch.bool, device=dev), -1)
    eye = torch.eye(64, device=dev)
    # non-finite input: scenario 1 a NaN below the diagonal, scenario 2 an
    # inf above it; then a NaN in scenario 5 of 8 only (thread block 1)
    for B_, seed, where, bad in ((4, SEED + 1, ((1, 30, 12), (2, 10, 33)),
                                  (1, 2)),
                                 (8, SEED + 8, ((5, 40, 7),), (5,))):
        Kb, sg = bench_ldl.random_qd_blocks(B_, dev, seed)
        for (b, i, k), v in zip(where, (float("nan"), float("inf"))):
            Kb[b, i, k] = v
        (L, d), (rL, rd) = L1(Kb, sg, 1e-5), ref(Kb, sg, 1e-5)
        torch.cuda.synchronize()
        bad_ok = all(bool(torch.isnan(d[b]).all())
                     and bool(torch.isnan(L[b][strict]).all())
                     and torch.equal(L[b].masked_fill(strict, 0.0), eye)
                     and not bool(torch.isfinite(rd[b]).all()) for b in bad)
        good = [b for b in range(B_) if b not in bad]
        good_ok = all(torch.equal(L[b], rL[b]) and torch.equal(d[b], rd[b])
                      for b in good)
        print(f"  non-finite scenarios {bad} of {B_}: d and strict L NaN on "
              f"the card, unit diagonal, not finite in the plain version: "
              f"{bad_ok}; scenarios {good} equal the plain version: "
              f"{good_ok}")
        if not bad_ok or not good_ok:
            fail(f"ldl_block on non-finite input (B={B_})")

    # the polish through L1 and through the plain version, same inputs
    block = ldl.ldl_block
    with torch.no_grad():
        sol = admm.solve_qp(data, scfg)
        ldl.ldl_block = ref
        try:
            plain = admm.solve_qp(data, scfg)
        finally:
            ldl.ldl_block = block
    sol_diff = float((sol.coeffs - plain.coeffs).abs().max()) / max(
        1.0, float(plain.coeffs.abs().max()))
    flags_same = bool(torch.equal(sol.solved, plain.solved))
    print(f"  deploy solve B={B}, polish through ldl_block vs the plain "
          f"version: coefficients {sol_diff:.3e} of the largest, solved "
          f"flags equal {flags_same}")
    if sol_diff > 1e-5 or not flags_same:
        fail("the polish through ldl_block differs from the plain version")

    # launches per path before (the plain version on the card) and after
    K, sg, reg = LDL_REC["factor"]["deploy solve"]
    paths = {
        "factorization": lambda: ldl.ldl_factor(K, nb=64, reg=reg, sign=sg),
        "deploy solve": lambda: admm.solve_qp(data, scfg),
        "cold tick": lambda: drv._cold(*tick_inputs["cold"]),
        "warm tick": lambda: drv._tick(*tick_inputs["warm"])}
    counts = {}
    for way in ("before", "after"):
        ldl.ldl_block = ref if way == "before" else block
        try:
            with torch.no_grad():
                # a first profiler session after a long one lost most of
                # its kernel events on the card: one session to discard
                profile_solve.profile_device(paths["factorization"], 1, 0,
                                             "call", "warm-up (discarded)")
                for name, fn in paths.items():
                    fn()
                    torch.cuda.synchronize()
                    c = profile_solve.profile_device(
                        fn, 2, 0, name.split()[-1],
                        f"{name} {way} (ldl_block "
                        f"{'plain' if way == 'before' else 'kernel'})")
                    counts[f"{name} {way}"] = c
                for name in ("cold tick", "warm tick"):
                    wall = []
                    for _ in range(5 if name == "cold tick" else 10):
                        t1 = time.perf_counter()
                        paths[name]()
                        torch.cuda.synchronize()
                        wall.append((time.perf_counter() - t1) * 1e3)
                    counts[f"{name} {way} host ms"] = wall
                    print(f"  {name} {way}: host ms p50 "
                          f"{np.percentile(wall, 50):.1f}, max "
                          f"{max(wall):.1f} over {len(wall)}")
        finally:
            ldl.ldl_block = block
    print("ldl: kernel launches (all kernels, torch.profiler) before -> "
          "after: " + "; ".join(
              f"{name} {counts[name + ' before']['launches']:g} -> "
              f"{counts[name + ' after']['launches']:g}" for name in paths))
    phase("ldl", t0)
    return shapes, counts, geometry


def main():
    import numpy as np
    import torch

    if len(sys.argv) > 1 and sys.argv[1] == "--first-tick":
        return first_tick(*sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from allocnet_tpu_torch import config
    from allocnet_tpu_torch.config import QPConfig, SolverConfig
    from allocnet_tpu_torch.models import weights
    from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
    from allocnet_tpu_torch.ops import admm, admm_chunk, ldl, qp
    from allocnet_tpu_torch.planner import (driver, pipeline, planner,
                                            replan, sfc)
    from allocnet_tpu_torch.train import datagen
    from allocnet_tpu_torch.train import dataset, losses, train_step, trainer
    from allocnet_tpu_torch.utils import scenarios
    from allocnet_tpu_torch.utils.device import resolve_device

    spec = importlib.util.spec_from_file_location(
        "qp_oracle", os.path.join(ROOT, "tests", "oracle", "qp_oracle.py"))
    qp_oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qp_oracle)

    global K1, L1
    K1, L1 = admm_chunk.admm_chunk, ldl.ldl_block
    record_ldl(ldl, L1)
    t_all = time.perf_counter()
    dev = resolve_device()           # the card; TF32 off
    device_kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {device_kind} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}",
          flush=True)

    # ---- 1. build: both kernels, one nvcc each, started together --------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = {"admm_chunk": pool.submit(admm_chunk.build),
                  "ldl_block": pool.submit(ldl.build)}
        builds = {k: f.result() for k, f in builds.items()}
    for name, info in builds.items():
        print(f"{name} build: {info['seconds']:.2f} s -> {info['path']}")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print("  ptxas:", line.strip())
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)",
                            info["ptxas"])
        if not spills or any(int(v) for v in spills):
            fail(f"ptxas reports register spills in {name}: {spills}")
    print(f"  dynamic shared memory per block: "
          f"{admm_chunk.smem_bytes(QPConfig())} bytes; blocks (scenarios) "
          f"per SM: {admm_chunk.blocks_per_sm(QPConfig())}")
    phase("build", t0)

    # ---- 2. the kernel against its plain version, one deploy chunk -------
    t0 = time.perf_counter()
    cfg, scfg = QPConfig(), SolverConfig()
    sc = scenarios.random_scenarios(cfg, B, seed=SEED, min_seg=1)
    f32 = np.float32
    data = qp.build_qp(cfg, sc.state.astype(f32), sc.hpolys.astype(f32),
                       sc.times.astype(f32), sc.seg, device=dev)
    args = admm_chunk.chunk_inputs(data, scfg)
    aeq = admm_chunk.aeq_dense(args[5], args[6], cfg.n_var)
    nrm, sm = args[8], args[10]
    it = scfg.iters_per_chunk
    got = admm_chunk.admm_chunk(*args, it, scfg.sigma, scfg.alpha)
    torch.cuda.synchronize()
    want = admm_chunk.admm_chunk_reference(*args, it, scfg.sigma, scfg.alpha)
    max_err = 0.0
    for name, g, w in zip(("x", "z", "yh", "yeh"), got, want):
        if not bool(torch.isfinite(g).all()):
            fail(f"kernel {name} not finite")
        err = float((g - w).abs().max())
        scale = max(1.0, float(w.abs().max()))
        max_err = max(max_err, err)
        print(f"  {name}: max abs diff {err:.3e}, relative to max|plain| "
              f"{err / scale:.3e} (tolerance {CHUNK_TOL:.0e})")
        if err > CHUNK_TOL * scale:
            fail(f"admm_chunk {name} disagrees with its plain version")
    chunk_ms = cuda_ms(lambda: admm_chunk.admm_chunk(*args, it, scfg.sigma,
                                                     scfg.alpha), reps=10)
    plain_ms = cuda_ms(lambda: admm_chunk.admm_chunk_reference(
        *args, it, scfg.sigma, scfg.alpha), reps=3)
    flops, nbytes = chunk_work(cfg, it, aeq, nrm, sm)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    print(f"admm_chunk B={B} x {it} iterations: kernel {chunk_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms "
          f"({flops:.3e} FLOP -> {t_ops:.4f} ms, {nbytes:.3e} B -> "
          f"{t_bytes:.4f} ms)")
    Ls, face_live = admm_chunk.live_parts(*args)
    segs = torch.as_tensor(sc.seg, device=dev)
    print(f"  routes: {int((Ls == segs).sum())} of {B} scenarios skip their "
          f"padded segments; live segments {float(Ls.float().mean()):.3f}, "
          f"live faces per live segment "
          f"{float(face_live.sum() / Ls.sum()):.3f} (of {cfg.max_faces})")
    phase("kernel vs plain", t0)

    # ---- 2b. the kernel against its plain version on each route ----------
    t0 = time.perf_counter()
    for batch in admm_chunk.CHECK_BATCHES:
        rargs = admm_chunk.check_batch(batch, cfg, scfg, B, SEED, dev)
        got = admm_chunk.admm_chunk(*rargs, it, scfg.sigma, scfg.alpha)
        torch.cuda.synchronize()
        want = admm_chunk.admm_chunk_reference(*rargs, it, scfg.sigma,
                                               scfg.alpha)
        errs = []
        for name, g, w in zip(("x", "z", "yh", "yeh"), got, want):
            if not bool(torch.isfinite(g).all()):
                fail(f"kernel {name} not finite on {batch}")
            scale = max(1.0, float(w.abs().max()))
            errs.append(float((g - w).abs().max()) / scale)
            if errs[-1] > CHUNK_TOL:
                fail(f"admm_chunk {name} disagrees with its plain version on "
                     f"{batch}: {errs[-1]:.3e} of the largest entry")
        Ls, face_live = admm_chunk.live_parts(*rargs)
        ms = cuda_ms(lambda: admm_chunk.admm_chunk(*rargs, it, scfg.sigma,
                                                   scfg.alpha), reps=3)
        print(f"  {batch}: kernel {ms:.3f} ms; max diff / max|plain| of x z "
              f"yh yeh " + " ".join(f"{e:.3e}" for e in errs)
              + f" (tolerance {CHUNK_TOL:.0e}); live segments "
              f"{float(Ls.float().mean()):.3f}, live faces per live segment "
              f"{float(face_live.sum() / Ls.sum()):.3f}")
    phase("routes", t0)

    # ---- 3. the deploy-point solve through the kernel ---------------------
    t0 = time.perf_counter()
    zero_counts()
    LDL_REC["tag"] = "deploy solve"
    sol = admm.solve_qp(data, scfg)
    torch.cuda.synchronize()
    LDL_REC["tag"] = None
    l1_ran("solve")
    if admm_chunk.admm_chunk.launches != scfg.n_chunks:
        fail(f"solve_qp launched admm_chunk "
             f"{admm_chunk.admm_chunk.launches} times, expected {scfg.n_chunks}")
    solved = sol.solved.cpu().numpy()
    rel = torch.maximum(sol.pri_rel, sol.dua_rel).cpu().numpy()
    coeffs = sol.coeffs.cpu().numpy()
    if not np.isfinite(coeffs).all():
        fail("non-finite coefficients")
    frac = float(solved.mean())
    max_rel = float(rel[solved].max())
    print(f"solve_qp B={B}: solved {frac:.4f}, max normalized residual "
          f"{max_rel:.3e}; ldl_block launches {LDL_LAUNCHES['solve']}")
    if frac < 0.99:
        fail(f"solved fraction {frac:.4f} < 0.99")
    if max_rel >= 1e-3:
        fail(f"max normalized residual {max_rel:.2e} on the solved set")
    idx = np.nonzero(solved)[0]
    checked, max_diff = 0, 0.0
    for b in idx[np.linspace(0, len(idx) - 1, ORACLE_N).astype(int)]:
        ora = qp_oracle.solve_scenario(cfg, sc.state[b], sc.hpolys[b],
                                       sc.times[b], sc.seg[b])
        if ora["kkt"] > 1e-7:
            continue                  # the oracle itself is not certified
        L = int(sc.seg[b])
        max_diff = max(max_diff, float(np.abs(coeffs[b, :L]
                                              - ora["coeffs"]).max()))
        checked += 1
    print(f"  f64 oracle: {checked} scenarios, max coefficient diff "
          f"{max_diff:.3e}")
    if checked < ORACLE_N // 2 or max_diff > 1e-3:
        fail(f"oracle parity: {checked} checked, max diff {max_diff:.2e}")
    sets = [cuda_ms(lambda: admm.solve_qp(data, scfg), reps=5)
            for _ in range(3)]
    print("  solve_qp ms per batch, 3 sets x 5: "
          + ", ".join(f"{s:.2f}" for s in sets)
          + f" -> {B / (np.mean(sets) / 1e3):.1f} solves/s")
    phase("solve", t0)

    # ---- 4. serve: plan_batch requests (the main path) --------------------
    t0 = time.perf_counter()
    net = ConvLSTMAllocNet(5, 256, token_thresh=0.5)
    net.load_state_dict(weights.load_params(os.path.join(
        ROOT, "data", "params", "seq5_tokenthresh0_35.msgpack")))
    net = net.to(dev).eval()
    reqs = [scenarios.random_scenarios(cfg, B, seed=SEED + r, min_seg=1)
            for r in range(REQUESTS)]
    pipeline.plan_batch(net, cfg, scfg, reqs[0].state, reqs[0].hpolys,
                        reqs[0].seg)           # warm-up (cuDNN, allocator)
    torch.cuda.synchronize()
    zero_counts()
    results, req_ms = [], []
    for r in reqs:
        t1 = time.perf_counter()
        results.append(pipeline.plan_batch(net, cfg, scfg, r.state, r.hpolys,
                                           r.seg))
        torch.cuda.synchronize()
        req_ms.append((time.perf_counter() - t1) * 1e3)
    launches = admm_chunk.admm_chunk.launches
    l1_ran("serve")
    print(f"plan_batch: {REQUESTS} requests of B={B}, "
          + ", ".join(f"{t:.1f}" for t in req_ms) + " ms; admm_chunk "
          f"launches {launches}, ldl_block {LDL_LAUNCHES['serve']}")
    if launches != REQUESTS * scfg.n_chunks:
        fail(f"plan_batch launched admm_chunk {launches} times, expected "
             f"{REQUESTS * scfg.n_chunks}")
    for res in results:
        if res.coeffs.shape != (B, cfg.max_seg, 3, cfg.D):
            fail(f"coefficients of shape {tuple(res.coeffs.shape)}")
        if not bool(torch.isfinite(res.coeffs).all()):
            fail("non-finite plan coefficients")
        print(f"  solved {float(res.solved.float().mean()):.4f}, ok "
              f"{float(res.ok.float().mean()):.4f}")
    # the same first 16 scenarios on the CPU, through the plain path
    n_ref = 16
    ref = pipeline.plan_batch(net.to("cpu"), cfg, scfg, reqs[0].state[:n_ref],
                              reqs[0].hpolys[:n_ref], reqs[0].seg[:n_ref],
                              device="cpu")
    got = results[0]
    t_gpu, k_gpu = got.times[:n_ref].cpu(), got.tokens[:n_ref].cpu()
    if not (torch.allclose(t_gpu, ref.times, rtol=1e-4, atol=1e-5)
            and torch.allclose(k_gpu, ref.tokens, rtol=1e-4, atol=1e-5)):
        fail("network outputs on the card differ from the CPU's")
    s_gpu = got.solved[:n_ref].cpu()
    agree = int((s_gpu == ref.solved).sum())
    both = s_gpu & ref.solved
    diff = float((got.coeffs[:n_ref].cpu() - ref.coeffs)[both].abs().max()) \
        if both.any() else 0.0
    print(f"  vs CPU plain path on {n_ref}: solved flags agree on {agree}, "
          f"{int(both.sum())} solved on both, max coefficient diff {diff:.3e}")
    # a scenario whose residual sits at the tolerance may flip between two
    # f32 reductions: allow one flag of 16 to differ
    if agree < n_ref - 1 or diff > 1e-3:
        fail("plan_batch on the card disagrees with the CPU path")
    phase("serve", t0)

    # ---- 5. train: one epoch through the QP (TRAIN, B=32) -----------------
    t0 = time.perf_counter()
    tcfg = config.TRAIN
    tq, ts_ = tcfg.qp, tcfg.solver
    tsc = scenarios.random_scenarios(tq, TRAIN_N, seed=SEED, min_seg=1)
    loader = dataset.Loader(tsc, batch_size=tcfg.train.batch_size,
                            train_ratio=tcfg.train.training_data_ratio,
                            seed=tcfg.train.seed)
    n_steps = len(loader.train_idx) // tcfg.train.batch_size
    n_val = len(loader.val_idx) // tcfg.train.batch_size

    # the kernel against its plain version at the training shape: the
    # first training batch's first chunk
    first = next(loader.epoch(0))
    tdata = qp.build_qp(tq, first.state.astype(f32), first.hpolys.astype(f32),
                        first.ref_times.astype(f32), first.seg, device=dev)
    targs = admm_chunk.chunk_inputs(tdata, ts_)
    got = admm_chunk.admm_chunk(*targs, it, ts_.sigma, ts_.alpha)
    torch.cuda.synchronize()
    want = admm_chunk.admm_chunk_reference(*targs, it, ts_.sigma, ts_.alpha)
    terrs = []
    for name, g, w in zip(("x", "z", "yh", "yeh"), got, want):
        if not bool(torch.isfinite(g).all()):
            fail(f"kernel {name} not finite at the training shape")
        terrs.append(float((g - w).abs().max())
                     / max(1.0, float(w.abs().max())))
        if terrs[-1] > CHUNK_TOL:
            fail(f"admm_chunk {name} disagrees with its plain version at the "
                 f"training shape: {terrs[-1]:.3e} of the largest entry")
    train_chunk_ms = cuda_ms(lambda: admm_chunk.admm_chunk(
        *targs, it, ts_.sigma, ts_.alpha), reps=20)
    train_plain_ms = cuda_ms(lambda: admm_chunk.admm_chunk_reference(
        *targs, it, ts_.sigma, ts_.alpha), reps=3)
    tflops, tbytes = chunk_work(tq, it, admm_chunk.aeq_dense(
        targs[5], targs[6], tq.n_var), targs[8], targs[10])
    train_bound_ms = max(tflops / PEAK_F32_FLOPS, tbytes / PEAK_BYTES) * 1e3
    print(f"admm_chunk at the training shape (B={tcfg.train.batch_size}, "
          f"res={tq.res}) x {it} iterations: kernel {train_chunk_ms:.3f} ms, "
          f"plain {train_plain_ms:.3f} ms, bound {train_bound_ms:.4f} ms "
          f"({tflops:.3e} FLOP, {tbytes:.3e} B); max diff / max|plain| of "
          f"x z yh yeh " + " ".join(f"{e:.3e}" for e in terrs))

    def per_scenario(net_, batch, device):
        """(per-scenario losses, solved flags) of one batch, no update."""
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        st, hp, rt = t(batch.state), t(batch.hpolys), t(batch.ref_times)
        sg = torch.as_tensor(batch.seg, device=device).long()
        with torch.no_grad():
            times, tokens, sol, obj = train_step.forward(net_, tq, ts_, st,
                                                         hp, sg)
            per = [float(losses.compute_losses(
                tcfg.loss, times[i:i + 1], tokens[i:i + 1], sg[i:i + 1],
                sol.solved[i:i + 1], obj[i:i + 1], st[i:i + 1],
                rt[i:i + 1], tcfg.model.token_thresh).total)
                for i in range(len(batch.seg))]
        return np.array(per), sol.solved.cpu().numpy()

    tnet = ConvLSTMAllocNet(5, 256, token_thresh=0.5)
    tnet.load_state_dict(weights.load_params(os.path.join(
        ROOT, "data", "params", "seq5_tokenthresh0_35.msgpack")))
    start = {k: v.clone() for k, v in tnet.state_dict().items()}
    cpu_per, cpu_solved = per_scenario(tnet, first, "cpu")
    tnet = tnet.to(dev)
    gpu_per, gpu_solved = per_scenario(tnet, first, dev)

    with tempfile.TemporaryDirectory() as workdir:
        tr = trainer.Trainer(tcfg, tnet, loader, workdir)
        torch.cuda.synchronize()
        zero_counts()
        t1 = time.perf_counter()
        tr.train(max_epochs=1)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
        train_launches = admm_chunk.admm_chunk.launches
        l1_ran("train")
        with open(tr.log_path) as f:
            records = [json.loads(line) for line in f]
        ck = trainer.latest_checkpoint(tr.ckpt_dir)
    steps = [r for r in records if "step" in r]
    val = [r for r in records if r.get("split") == "val"]
    print(f"train: {len(steps)} steps of {tcfg.train.batch_size} and "
          f"{n_val} validation batch(es) in {train_s * 1e3:.1f} ms; admm_chunk "
          f"launches {train_launches}, ldl_block {LDL_LAUNCHES['train']}; "
          f"checkpoint {os.path.basename(ck)}")
    print("  step losses: " + ", ".join(f"{r['obj']:.4f}" for r in steps)
          + "; success " + ", ".join(f"{r['success_rate']:.3f}"
                                     for r in steps))
    if val:
        print(f"  validation: loss {val[0]['obj']:.4f}, success "
              f"{val[0]['success_rate']:.3f}")
    if len(steps) != n_steps or len(val) != min(n_val, 1):
        fail(f"train ran {len(steps)} steps and {len(val)} validations")
    if not all(np.isfinite(r["obj"]) for r in steps + val):
        fail("non-finite training loss")
    if train_launches != ts_.n_chunks * (n_steps + n_val):
        fail(f"train launched admm_chunk {train_launches} times, expected "
             f"{ts_.n_chunks} x {n_steps + n_val} forward solves")
    moved = max(float((v.cpu() - start[k]).abs().max())
                for k, v in tnet.state_dict().items())
    if not 0 < moved < 1:
        fail(f"training moved the weights by {moved:.3e}")
    agree = cpu_solved == gpu_solved
    card_first = float(np.mean(gpu_per))
    diff = float(np.abs(gpu_per - cpu_per)[agree].max() / max(
        1.0, np.abs(cpu_per[agree]).max()))
    print(f"  first step vs the CPU plain path: loss {steps[0]['obj']:.6f} "
          f"(card, trainer), {card_first:.6f} (card, recomputed), "
          f"{float(np.mean(cpu_per)):.6f} (CPU); solved flags agree on "
          f"{int(agree.sum())} of {len(agree)}; per-scenario loss diff "
          f"{diff:.3e} of the largest where they agree; weights moved by up "
          f"to {moved:.3e}")
    # a scenario at the tolerance may flip between two f32 reductions
    # (one of 32 allowed); f32 through a QP of cond ~1e4: rtol 1e-3
    if agree.sum() < len(agree) - 1 or diff > 1e-3:
        fail("the first training step disagrees with the CPU plain path")
    if abs(card_first - steps[0]["obj"]) > 1e-4 * max(1.0, abs(card_first)):
        fail("the trainer's first loss differs from its recomputation")

    # step time and its shares: forward (net, solve, objective, losses),
    # backward (implicit KKT, net), optimizer (Adam, schedule)
    bt = tr.to_device(first)
    shares = {"forward": [], "backward": [], "optimizer": []}
    for rep in range(4):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tr.opt.zero_grad(set_to_none=True)
        total, _ = train_step.loss_fn(tnet, tq, ts_, tcfg.loss, *bt,
                                      tcfg.model.token_thresh)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        total.backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        tr.opt.step()
        tr.lr_sched.step()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        if rep:                                  # the first is a warm-up
            for k, a, b in (("forward", t1, t2), ("backward", t2, t3),
                            ("optimizer", t3, t4)):
                shares[k].append((b - a) * 1e3)
    step_ms = {k: float(np.mean(v)) for k, v in shares.items()}
    print(f"  training step ms (3 timed, B={tcfg.train.batch_size}): "
          f"{sum(step_ms.values()):.2f} = forward {step_ms['forward']:.2f} + "
          f"backward {step_ms['backward']:.2f} + optimizer "
          f"{step_ms['optimizer']:.2f}; "
          f"{train_launches / (n_steps + n_val):g} launches per forward solve "
          f"(counted in the train run)")
    phase("train", t0)

    # ---- 6. refine: one plan_batch with refine_steps=2 ---------------------
    t0 = time.perf_counter()
    rq = reqs[0]
    rin = (rq.state[:REFINE_B], rq.hpolys[:REFINE_B], rq.seg[:REFINE_B])
    base = pipeline.plan_batch(net.to(dev), cfg, scfg, *rin)
    pipeline.plan_batch(net, cfg, scfg, *rin, refine_steps=2)   # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t1 = time.perf_counter()
    ref = pipeline.plan_batch(net, cfg, scfg, *rin, refine_steps=2)
    torch.cuda.synchronize()
    refine_ms = (time.perf_counter() - t1) * 1e3
    refine_launches = admm_chunk.admm_chunk.launches
    l1_ran("refine")
    if not bool(torch.isfinite(ref.coeffs).all()):
        fail("non-finite refined coefficients")
    if refine_launches != 5 * scfg.n_chunks:
        fail(f"refine launched admm_chunk {refine_launches} times, expected "
             f"5 solves x {scfg.n_chunks}")
    both = (base.solved & ref.solved).cpu()
    ob, orf = base.obj.cpu()[both], ref.obj.cpu()[both]
    improved = int((orf < ob).sum())
    # refinement keeps each plan's total of the 0.05-clamped active times
    active = (torch.arange(cfg.max_seg, device=dev)[None, :]
              < torch.as_tensor(rin[2], device=dev)[:, None])
    tot_b = torch.where(active, torch.clamp_min(base.times, 0.05),
                        base.times).sum(1)
    tot_err = float(((ref.times.sum(1) - tot_b).abs() / tot_b).max())
    print(f"refine: plan_batch B={REFINE_B}, refine_steps=2: "
          f"{refine_ms:.1f} ms; admm_chunk launches {refine_launches}, "
          f"ldl_block {LDL_LAUNCHES['refine']}; "
          f"solved {int(base.solved.sum())} -> {int(ref.solved.sum())}; on "
          f"the {int(both.sum())} solved both ways mean objective "
          f"{float(ob.mean()):.4f} -> {float(orf.mean()):.4f}, {improved} "
          f"improved; total time kept to {tot_err:.2e}")
    if not both.any() or float(orf.mean()) > float(ob.mean()) * (1 + 1e-4):
        fail("refinement raised the mean objective")
    if tot_err > 1e-4:
        fail("refinement changed the plans' total time")
    phase("refine", t0)

    # ---- 7. corridor: map, routes, corridors at DEPLOY on the card -------
    t0 = time.perf_counter()
    dcfg = config.DEPLOY
    lo, hi = np.zeros(3), np.asarray(EXTENT)
    pts = datagen.random_obstacle_map(MAP_SEED, EXTENT)
    map_ms = []
    for _ in range(2):               # the first builds the C++ runtime
        # (unless an earlier command in the same checkout did)
        t1 = time.perf_counter()
        pmap = planner.build_map(pts, lo, hi, scale=0.25, dilate_r=2,
                                 native=True, device=dev)
        torch.cuda.synchronize()
        map_ms.append((time.perf_counter() - t1) * 1e3)
    print(f"corridor: map {MAP_SEED} ({len(pts)} points, "
          f"{pmap.grid.occ.shape} voxels, {len(pmap.surf)} surface points): "
          f"build_map {map_ms[0]:.1f} ms the first time, "
          f"{map_ms[1]:.1f} ms the second")
    t1 = time.perf_counter()
    missions = planner.sample_missions(pmap, dcfg, np.random.default_rng(
        MISSION_SEED), N_MISSIONS, lo, hi, device=dev)
    print(f"  sampled {len(missions)} missions in "
          f"{(time.perf_counter() - t1) * 1e3:.1f} ms (seed {MISSION_SEED})")
    if len(missions) != N_MISSIONS:
        fail(f"sampled {len(missions)} missions of {N_MISSIONS}")
    route_ms, corr_ms = [], []
    for k, (start, goal, rseed, cp) in enumerate(missions):
        t1 = time.perf_counter()
        route = planner.search_route(pmap, start, goal, dcfg.corridor, rseed)
        route_ms.append((time.perf_counter() - t1) * 1e3)
        args = (route, pmap.surf, lo, hi, dcfg.corridor, dcfg.qp)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        hp, seg, _, goal_r = sfc.corridor_online(*args, device=dev)
        corr_ms.append((time.perf_counter() - t1) * 1e3)
        hp_c, seg_c, _, goal_c = sfc.corridor_online(*args, device="cpu")
        scale = max(1.0, float(np.abs(hp_c).max()))
        dist = max(sfc.face_set_distance(hp[i], hp_c[i])
                   for i in range(min(seg, dcfg.qp.max_seg)))
        print(f"  mission {k}: {np.round(start, 3).tolist()} -> "
              f"{np.round(goal_r, 3).tolist()}, route of {len(route)} "
              f"points ({route_ms[-1]:.1f} ms), seg {seg} (CPU {seg_c}); "
              f"corridor_online {corr_ms[-1]:.1f} ms; card vs CPU: faces "
              f"{dist / scale:.3e} of the largest entry, goal "
              f"{float(np.abs(goal_r - goal_c).max()):.3e}")
        if seg != seg_c or dist > CORRIDOR_TOL * scale:
            fail(f"mission {k}: the card's corridor differs from the CPU's")
        if seg != cp.seg or not np.array_equal(hp, cp.hpolys):
            fail(f"mission {k}: plan_corridor and corridor_online differ")
    phase("corridor", t0)
    # ---- 8. fly: the 10 Hz driver on the sampled missions (DEPLOY) -------
    t0 = time.perf_counter()
    params = weights.load_params(os.path.join(ROOT, NET))
    drv = driver.Driver(ConvLSTMAllocNet(5, 256, token_thresh=0.5), params,
                        dcfg, rate_hz=10.0, certify=True, device=dev)
    drv.prewarm()
    k1, launch = admm_chunk.admm_chunk, admm_chunk._launch
    recorded = {}             # the kernel's inputs on each tick batch

    def recording_launch(lib, *a):
        """admm_chunk._launch, keeping the first arguments (the kernel's
        tensors, n_iters, sigma, alpha) of each tick batch: the cold hedge
        (B=3), a warm tick with a nonzero primal and dual start (B=1), a
        rescue (B=4)."""
        B = a[0].shape[0]
        kind = {3: "cold", 1: "warm", 4: "rescue"}.get(B)
        fresh = kind is not None and kind not in recorded
        if fresh and (kind != "warm" or (bool(a[0].any())
                                         and bool(a[2].any()))):
            recorded[kind] = [t.clone() if torch.is_tensor(t) else t
                              for t in a[:17]]
        return launch(lib, *a)

    per_call = {"cold": [], 0: [], 1: [], 2: []}    # launches per tick
    l1_call = {"cold": [], 0: [], 1: [], 2: []}
    tick_inputs = {}
    cold_fn, tick_fn = drv._cold, drv._tick

    def cold_counted(*a):
        tick_inputs.setdefault("cold", [x.clone() for x in a])
        n0, m0 = k1.launches, L1.launches
        out = cold_fn(*a)
        per_call["cold"].append(k1.launches - n0)
        l1_call["cold"].append(L1.launches - m0)
        return out

    def tick_counted(*a):
        tick_inputs["warm"] = a
        n0, m0 = k1.launches, L1.launches
        out = tick_fn(*a)
        per_call[out[4]].append(k1.launches - n0)
        l1_call[out[4]].append(L1.launches - m0)
        return out

    drv._cold, drv._tick = cold_counted, tick_counted
    admm_chunk._launch = recording_launch
    flights = []
    torch.cuda.synchronize()
    zero_counts()
    LDL_REC["tag"] = "fly"
    for start, goal, rseed, cp in missions:
        st = drv.reset(start, cp.route[-1], cp.hpolys, cp.seg)
        st, res = drv.run(st, MAX_TICKS, stop_when_done=True, stall_limit=5)
        flights.append((st, res))
    LDL_REC["tag"] = None
    fly_launches = k1.launches
    l1_ran("fly")
    admm_chunk._launch = launch
    drv._cold, drv._tick = cold_fn, tick_fn

    cold_ms, warm_ms, n_ticks, n_solved, n_track = [], [], 0, 0, 0
    n_cert, n_acc, n_arrived = 0, 0, 0
    for k, (st, res) in enumerate(flights):
        for r in res:
            s_ = r.state
            if not (np.isfinite(s_.pos).all() and np.isfinite(s_.vel).all()
                    and np.isfinite(s_.acc).all()):
                fail(f"mission {k}: a tick gave a non-finite state")
        dist = float(np.linalg.norm(st.pos - st.goal))
        arrived = bool(st.done) and dist < ARRIVE_DIST
        n_arrived += arrived
        cold_ms.append(res[0].latency_s * 1e3)
        warm_ms += [r.latency_s * 1e3 for r in res[1:]]
        n_ticks += len(res)
        n_solved += sum(r.solved for r in res)
        n_track += sum(r.tracking for r in res)
        certs = [r.certified for r in res if r.certified is not None]
        n_cert += sum(certs)
        n_acc += len(certs)
        print(f"fly: mission {k}: {len(res)} ticks, arrived {arrived}, "
              f"final distance {dist:.4f} m, solved {sum(r.solved for r in res)}"
              f", tracking {sum(r.tracking for r in res)}, light rescues "
              f"{sum(r.rescue == 1 for r in res)}, heavy "
              f"{sum(r.rescue == 2 for r in res)}, certified "
              f"{sum(certs)} of {len(certs)} accepted plans; cold tick "
              f"{cold_ms[-1]:.1f} ms")
    launches_per = {k: sorted(set(v)) for k, v in per_call.items()}
    print(f"  cold tick ms {', '.join(f'{t:.1f}' for t in cold_ms)}; warm "
          f"tick p50 {np.percentile(warm_ms, 50):.1f} ms, p99 "
          f"{np.percentile(warm_ms, 99):.1f} ms over {len(warm_ms)} ticks; "
          f"tick-solve rate {n_solved / n_ticks:.4f} ({n_solved} of "
          f"{n_ticks}); tracking {n_track}; light rescues {len(per_call[1])}"
          f", heavy {len(per_call[2])}; arrived {n_arrived} of "
          f"{len(flights)}; certified {n_cert} of {n_acc}")
    print(f"  admm_chunk launches: {fly_launches} in the fly phase; per cold "
          f"tick {launches_per['cold']} ({len(per_call['cold'])} ticks), per "
          f"warm tick {launches_per[0]} ({len(per_call[0])}), per light "
          f"rescue tick {launches_per[1]}, per heavy {launches_per[2]}")
    l1_per = {k: sorted(set(v)) for k, v in l1_call.items()}
    print(f"  ldl_block launches: {LDL_LAUNCHES['fly']} in the fly phase; per "
          f"cold tick {l1_per['cold']}, per warm tick {l1_per[0]}, per light "
          f"rescue tick {l1_per[1]}, per heavy {l1_per[2]}")
    if fly_launches != sum(sum(v) for v in per_call.values()):
        fail("admm_chunk launched outside the ticks")
    if LDL_LAUNCHES["fly"] != sum(sum(v) for v in l1_call.values()):
        fail("ldl_block launched outside the ticks")
    if not per_call["cold"] or not per_call[0] or min(
            min(v) for v in per_call.values() if v) < 1:
        fail("a tick ran without launching admm_chunk")
    if min(min(v) for v in l1_call.values() if v) < 1:
        fail("a tick ran without launching ldl_block")
    if n_arrived == 0:
        fail("no mission arrived")

    # the first cold tick again on the CPU's plain path, same corridor
    cpu_cold = driver.make_cold_tick(
        ConvLSTMAllocNet(5, 256, token_thresh=0.5), drv.cfg_tick, params)
    c_in = [x.cpu() for x in tick_inputs["cold"]]
    g_out = drv._cold(*tick_inputs["cold"])
    c_out = cpu_cold(*c_in)
    g_c, c_c = g_out[1].cpu().numpy(), c_out[1].numpy()
    cold_diff = float(np.abs(g_c - c_c).max() / max(1.0, np.abs(c_c).max()))
    print(f"  first cold tick vs the CPU plain path: solved "
          f"{bool(g_out[0][0])} / {bool(c_out[0][0])}, coefficients "
          f"{cold_diff:.3e} of the largest")
    if bool(g_out[0][0]) != bool(c_out[0][0]) or cold_diff > 1e-3:
        fail("the first cold tick on the card disagrees with the CPU path")

    # the kernel against its plain version on the tick batches
    if "rescue" not in recorded:
        # no tick missed: force one light rescue on the last warm input
        admm_chunk._launch = recording_launch
        LDL_REC["tag"] = "fly"
        driver._warm_tick(drv.cfg_tick, 0.1, 0, True, *tick_inputs["warm"],
                          rescue_scfg=replan.rescue_solver_config(
                              drv.cfg_tick.solver))
        LDL_REC["tag"] = None
        admm_chunk._launch = launch
    tick_shapes = {}
    for batch in ("cold", "warm", "rescue"):
        if batch not in recorded:
            fail(f"no {batch} batch reached admm_chunk")
        tick_shapes[batch] = shape_numbers(admm_chunk, dcfg.qp,
                                           recorded[batch], batch)
    phase("fly", t0)
    drive_launches = drive_eval_phase(dev)
    heldout_launches, heldout_shapes, heldout_flags = heldout_phase(dev)
    refeval_launches, refine_shape, refine_split = refine_eval_phase(dev)
    frontend_launches, frontend_shape, frontend_split = frontend_phase(dev)
    corpus_launches, corpus_shapes = corpus_phase(dev)
    mcn_launches, mcn_shape = mcnemar10k_phase(dev, heldout_flags)
    chain_launches, chain_shape, chain_rows = chain_phase(dev)
    abl_launches, abl_shape, abl_mates = ablation_phase(dev, chain_rows)

    app_launches, app_shapes = application_phases(
        dev, drv, params, tick_inputs["cold"], missions[0])
    seq10_launches, seq10_shape = seq10_phase(dev, qp_oracle)
    ldl_shapes, ldl_counts, ldl_geometry = ldl_phase(dev, drv, tick_inputs,
                                                     data, scfg)

    kernels = [{
        "name": "admm_chunk", "route": "cuda",
        "source": "allocnet_tpu_torch/csrc/admm_chunk.cu",
        "replaces": "allocnet_tpu/ops/pallas/admm_tiled.py:236",
        "launches": launches, "max_abs_err": max_err,
        "ms": chunk_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "launches_by_path": {
            "serve": launches, "train": train_launches,
            "refine": refine_launches,
            "cold_tick": sum(per_call["cold"]), "warm_tick": sum(per_call[0]),
            "rescue": sum(per_call[1]) + sum(per_call[2]),
            "fly": fly_launches, "drive_eval": drive_launches,
            "heldout": heldout_launches,
            "refine_eval": refeval_launches,
            "frontend": frontend_launches,
            "corpus": corpus_launches,
            "mcnemar10k": mcn_launches,
            "chain": chain_launches,
            "ablation": abl_launches,
            **app_launches, **seq10_launches},
        "launches_per_tick": {"cold": launches_per["cold"],
                              "warm": launches_per[0],
                              "light_rescue": launches_per[1],
                              "heavy_rescue": launches_per[2]},
        "tick_shapes": tick_shapes,
        "heldout_shapes": heldout_shapes,
        "refine_eval_shape": refine_shape,
        "refine_eval_split": refine_split,
        "frontend_shape": frontend_shape,
        "frontend_split": frontend_split,
        "corpus_shapes": corpus_shapes,
        "mcnemar10k_shape": mcn_shape,
        "chain_shape": chain_shape,
        "ablation_shape": {k: v for k, v in abl_shape.items() if k != "l1"},
        "row_202_batch_mates_bit_equal": abl_mates,
        "certify_shape": app_shapes["certify"],
        "jerk_shape": app_shapes["jerk"],
        "seq10_shape": seq10_shape,
        "train_shape": {"ms": train_chunk_ms, "plain_ms": train_plain_ms,
                        "bound_ms": train_bound_ms,
                        "max_rel_err": max(terrs)},
    }]
    dep = ldl_shapes["deploy solve"]
    kernels.append({
        "name": "ldl_block", "route": "cuda",
        "source": "allocnet_tpu_torch/csrc/ldl_block.cu",
        "replaces": "allocnet_tpu/ops/ldl.py:37 (_ldl_unblocked, "
                    "lax.fori_loop)",
        "history": "ported with one thread block per scenario; "
                   "redesigned with one warp per scenario, 4 per thread "
                   "block, panels of 8 columns, no block-wide barrier "
                   "(PERF.md section 6, kernel table)",
        "launches": LDL_LAUNCHES["serve"],
        "max_abs_err": max(v["max_abs_err"] for v in ldl_shapes.values()),
        "ms": dep["ms"], "plain_ms": dep["plain_ms"],
        "bound_ms": dep["bound_ms"], "bound_by": dep["bound_by"],
        # no PyTorch call computes a pivot-free LDL^T:
        # torch.linalg.ldl_factor pivots (Bunch-Kaufman)
        "library_ms": None,
        "launches_by_path": dict(LDL_LAUNCHES),
        "geometry": ldl_geometry,
        "shapes": ldl_shapes,
        "ablation_shape": abl_shape["l1"],
        "all_launches_before_after": {
            k: v["launches"] for k, v in ldl_counts.items()
            if isinstance(v, dict)},
    })
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
