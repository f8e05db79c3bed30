"""The JAX package's scenario-corpus generator on the CPU: the reference
that allocnet_tpu_torch.train.corpus holds the port's corpus against.

Runs scripts/eval_big.py's own `fresh_scenarios` (loaded through
importlib, on the CPU, float32 as the script runs: x64 stays off) and
records, per map, what `datagen.generate` was asked and gave (the map
seed, its kind, the request, the certified count) and, per row of the
batch that reached `datagen.certify`, the start, the goal, the segment
count, the reference times and whether the row certified.  Two runs:

- `full`: fresh_scenarios(2000, seed0=9000), the run that made
  data/eval_fresh.npz.  A map asks for min(400, 2000 - got), so the first
  maps, which ask for 400 whatever came before while got <= 1600, run as
  separate processes (each stops the script's loop after its first map);
  the rest follow one at a time, each asked what the loop would ask it.
- `smoke`: fresh_scenarios(64, seed0=9000), the cut of chip_smoke.py.

- `mcnemar10k`: the first MCN_MAPS maps of fresh_scenarios(8000,
  seed0=12000), scripts/mcnemar10k.py's call, each asked for 400 (so
  independent while got <= 7,600: one process each), and map 12000
  asked for 16; written to MCN_RECORD in RECORD's layout ("full" holds
  those maps only), beside the per-map counts of
  runs/mcnemar/run_10k.log.

RECORD keeps outcomes only, no faces and no times of this host.  It also
holds the per-map certified counts of runs/regen_eval.log (the TPU run of
`full`) and of runs/mcnemar/run_10k.log (fresh_scenarios(8000,
seed0=12000)), transcribed, the segment histogram of data/eval_fresh.npz,
and this run against them (`vs_records`).

    JAX_PLATFORMS=cpu python -m tests.jax_corpus_record [--work DIR]
        [--procs 6]
    JAX_PLATFORMS=cpu python -m tests.jax_corpus_record map SEED N OUT.json
        [--all]
    JAX_PLATFORMS=cpu python -m tests.jax_corpus_record mcnemar10k
        [--work DIR]

About 25 minutes on 8 cores (6 map processes, then 5 maps in turn);
`mcnemar10k` about 25 minutes (7 map processes).
"""

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(ROOT, "tests", "records", "corpus_jax_cpu.json")
CACHE = os.path.join(ROOT, "data", "eval_fresh.npz")
REGEN_LOG = os.path.join(ROOT, "runs", "regen_eval.log")
RUN10K_LOG = os.path.join(ROOT, "runs", "mcnemar", "run_10k.log")
FULL_N, SMOKE_N, SEED0, PER_MAP, MAX_MAPS = 2000, 64, 9000, 400, 40
MCN_RECORD = os.path.join(ROOT, "tests", "records", "mcnemar10k_jax_cpu.json")
MCN_N, MCN_SMOKE_N, MCN_SEED0, MCN_MAPS = 8000, 16, 12000, 6


class _FirstMapDone(Exception):
    pass


def log_counts(path):
    """[(map seed, certified)] of a fresh_scenarios log ("map S: C
    certified (got/n)" lines)."""
    with open(path) as f:
        return [(int(m), int(c)) for m, c in re.findall(
            r"^map (\d+): (\d+) certified", f.read(), re.M)]


def run_script(n, seed0, first_only):
    """The script's fresh_scenarios(n, seed0) on the CPU, its
    datagen.generate calls recorded.  Returns one dict per map: seed,
    kind, request, certified and the pre-certify rows (start, goal, seg,
    times, certified).  With first_only the loop stops after its first
    map."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    spec = importlib.util.spec_from_file_location(
        "_script_eval_big", os.path.join(ROOT, "scripts", "eval_big.py"))
    eb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(eb)
    dg = eb.datagen
    maps, kind, pre = [], [], []
    gen, cert = dg.generate, dg.certify
    pillar, obstacle = dg.random_pillar_map, dg.random_obstacle_map

    def rec_pillar(seed, *a, **k):
        kind.append("pillar")
        return pillar(seed, *a, **k)

    def rec_obstacle(seed, *a, **k):
        kind.append("obstacle")
        return obstacle(seed, *a, **k)

    def rec_certify(cfg, sc):
        out = cert(cfg, sc)
        pre.append((sc, np.isin(np.arange(len(sc.seg)), _kept(sc, out))))
        return out

    def rec_generate(cfg, n_samples, points=None, seed=0, **k):
        pre.clear()
        sc = gen(cfg, n_samples, points=points, seed=seed, **k)
        rows = pre[0] if pre else None
        maps.append({"seed": int(seed), "kind": kind[-1],
                     "request": int(n_samples),
                     "certified": int(len(sc.seg)), "rows": _rows(rows)})
        if first_only:
            raise _FirstMapDone
        return sc

    dg.generate, dg.certify = rec_generate, rec_certify
    dg.random_pillar_map, dg.random_obstacle_map = rec_pillar, rec_obstacle
    try:
        eb.fresh_scenarios(n, seed0=seed0)
    except _FirstMapDone:
        pass
    finally:
        dg.generate, dg.certify = gen, cert
        dg.random_pillar_map, dg.random_obstacle_map = pillar, obstacle
    return maps


def _kept(sc, out):
    """Indices of sc's rows that certify kept (certify keeps the order)."""
    idx, j = [], 0
    for i in range(len(sc.seg)):
        if j < len(out.seg) and np.array_equal(sc.state[i], out.state[j]):
            idx.append(i)
            j += 1
    assert j == len(out.seg)
    return idx


def _rows(rows):
    if rows is None:
        return {"start": [], "goal": [], "seg": [], "times": [],
                "certified": []}
    sc, flags = rows
    return {"start": sc.state[:, 0, :, 0].tolist(),
            "goal": sc.state[:, 1, :, 0].tolist(),
            "seg": sc.seg.astype(int).tolist(),
            "times": sc.times.tolist(),
            "certified": flags.astype(bool).tolist()}


def worker(seed, n, out, all_maps):
    maps = run_script(n, seed, first_only=not all_maps)
    with open(out, "w") as f:
        json.dump(maps, f)
    for m in maps:
        print(f"map {m['seed']}: {m['certified']} certified of "
              f"{m['request']} asked ({m['kind']})", flush=True)


def _spawn(args, log):
    return subprocess.Popen(
        [sys.executable, "-m", "tests.jax_corpus_record", "map"] + args,
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))


def _read(path):
    with open(path) as f:
        return json.load(f)


def full_run(work, procs):
    """fresh_scenarios(FULL_N, SEED0) map by map, the first `procs` maps
    in parallel at PER_MAP each (checked: the loop asks them that), and
    the smoke's fresh_scenarios(SMOKE_N, SEED0) beside them."""
    os.makedirs(work, exist_ok=True)
    path = lambda m, n: os.path.join(work, f"map_{m}_{n}.json")
    jobs = []
    with open(os.path.join(work, "log.txt"), "a") as log:
        smoke = os.path.join(work, "smoke.json")
        if not os.path.exists(smoke):
            jobs.append(_spawn([str(SEED0), str(SMOKE_N), smoke, "--all"],
                               log))
        for mi in range(procs):
            if not os.path.exists(path(SEED0 + mi, PER_MAP)):
                jobs.append(_spawn([str(SEED0 + mi), str(PER_MAP),
                                    path(SEED0 + mi, PER_MAP)], log))
        for j in jobs:
            if j.wait():
                raise SystemExit(f"a map process failed: {j.args}")
        maps, got = [], 0
        for mi in range(MAX_MAPS):
            if got >= FULL_N:
                break
            m, want = SEED0 + mi, min(PER_MAP, FULL_N - got)
            if not os.path.exists(path(m, want)):
                if _spawn([str(m), str(want), path(m, want)], log).wait():
                    raise SystemExit(f"map {m} failed")
            (rec,) = _read(path(m, want))
            assert rec["request"] == want
            maps.append(rec)
            got += rec["certified"]
    return maps, _read(smoke)


def _hist(segs):
    return np.bincount(np.asarray(segs, int), minlength=6).tolist()


def vs_records(maps):
    """This run against runs/regen_eval.log (per-map counts) and
    data/eval_fresh.npz (segment histogram; starts of each map's rows,
    which the cache holds in map order)."""
    logged = log_counts(REGEN_LOG)
    z = np.load(CACHE)
    cache_starts = z["state"][:, 0, :, 0]
    cert = lambda m: [r for r, c in zip(m["rows"]["start"],
                                        m["rows"]["certified"]) if c]
    out = {"per_map": [], "seg_hist": _hist(
        [s for m in maps for s, c in zip(m["rows"]["seg"],
                                         m["rows"]["certified"]) if c]),
        "cache_seg_hist": _hist(z["seg"])}
    off = 0
    for mi, (seed, count) in enumerate(logged):
        ours = maps[mi] if mi < len(maps) else None
        cache = {tuple(s) for s in cache_starts[off:off + count].tolist()}
        off += count
        mine = {tuple(s) for s in cert(ours)} if ours else set()
        out["per_map"].append({
            "seed": seed, "log": count,
            "jax_cpu": ours["certified"] if ours else None,
            "request_log": None, "shared_starts": len(cache & mine)})
    got = 0
    for row in out["per_map"]:
        row["request_log"] = min(PER_MAP, FULL_N - got)
        got += row["log"]
    return out


def mcnemar10k_run(work, out):
    """The first MCN_MAPS maps of fresh_scenarios(MCN_N, MCN_SEED0), each
    asked for PER_MAP (the loop asks that of every map while got <= MCN_N
    - PER_MAP: checked below), and map MCN_SEED0 asked for MCN_SMOKE_N,
    one process each, into MCN_RECORD."""
    os.makedirs(work, exist_ok=True)
    path = lambda m, n: os.path.join(work, f"map_{m}_{n}.json")
    todo = [(MCN_SEED0 + i, PER_MAP) for i in range(MCN_MAPS)]
    todo.append((MCN_SEED0, MCN_SMOKE_N))
    with open(os.path.join(work, "log.txt"), "a") as log:
        jobs = [_spawn([str(m), str(n), path(m, n)], log) for m, n in todo
                if not os.path.exists(path(m, n))]
        for j in jobs:
            if j.wait():
                raise SystemExit(f"a map process failed: {j.args}")
    maps, got = [], 0
    for m, n in todo[:-1]:
        assert min(PER_MAP, MCN_N - got) == n
        (rec,) = _read(path(m, n))
        maps.append(rec)
        got += rec["certified"]
    logged = log_counts(RUN10K_LOG)
    import jax
    rec = {"source": "tests/jax_corpus_record.py mcnemar10k",
           "script": "scripts/eval_big.py fresh_scenarios, as "
                     "scripts/mcnemar10k.py calls it",
           "jax": jax.__version__, "dtype": "float32",
           "full": {"n": MCN_N, "seed0": MCN_SEED0, "maps": maps,
                    "note": f"the first {MCN_MAPS} maps only"},
           "smoke": {"n": MCN_SMOKE_N, "seed0": MCN_SEED0,
                     "maps": _read(path(MCN_SEED0, MCN_SMOKE_N))},
           "logs": {"run_10k": logged},
           "vs_records": {"per_map": [
               {"seed": s_, "log": c, "jax_cpu": m["certified"]}
               for (s_, c), m in zip(logged, maps)]}}
    with open(out, "w") as f:
        json.dump(rec, f, separators=(",", ":"))
    print(json.dumps(rec["vs_records"]))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "map":
        ap = argparse.ArgumentParser()
        ap.add_argument("seed", type=int)
        ap.add_argument("n", type=int)
        ap.add_argument("out")
        ap.add_argument("--all", action="store_true",
                        help="every map of the loop, not only the first")
        a = ap.parse_args(argv[1:])
        return worker(a.seed, a.n, a.out, a.all)
    if argv and argv[0] == "mcnemar10k":
        ap = argparse.ArgumentParser()
        ap.add_argument("--work", default=os.path.join(ROOT, "chiprun_out",
                                                       "mcnemar10k_jax"))
        ap.add_argument("--out", default=MCN_RECORD)
        a = ap.parse_args(argv[1:])
        return mcnemar10k_run(a.work, a.out)
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", default=os.path.join(ROOT, "chiprun_out",
                                                   "corpus_jax"))
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--out", default=RECORD)
    a = ap.parse_args(argv)
    maps, smoke = full_run(a.work, a.procs)
    import jax
    rec = {"source": "tests/jax_corpus_record.py",
           "script": "scripts/eval_big.py fresh_scenarios",
           "jax": jax.__version__, "dtype": "float32",
           "full": {"n": FULL_N, "seed0": SEED0, "maps": maps},
           "smoke": {"n": SMOKE_N, "seed0": SEED0, "maps": smoke},
           "logs": {"regen_eval": log_counts(REGEN_LOG),
                    "run_10k": log_counts(RUN10K_LOG)},
           "vs_records": vs_records(maps)}
    with open(a.out, "w") as f:
        json.dump(rec, f, separators=(",", ":"))
    print(json.dumps(rec["vs_records"]))


if __name__ == "__main__":
    sys.exit(main())
