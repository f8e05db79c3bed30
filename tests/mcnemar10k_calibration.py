"""The port's CPU run of the 10,000-scenario McNemar eval: the readings that
allocnet_tpu_torch.train.mcnemar10k sets its gates from.

The eval's generator is `corpus.fresh_scenarios(8000, seed0=12000)`: each
map is asked for min(400, 8000 - got), so while got <= 7,600 every map
asks 400 whatever came before, and those maps run here as separate
processes (`gen`, one CPU thread each); the rest follow one at a time,
each asked what the loop would ask it.  Each map's batch, entry and
generate record go to WORK/map_<seed>_<n>.pkl.  Then, on the CPU:

- `maps`: the run's map count, per-map counts and segment shares, and
  maps 12000-12005 against tests/records/mcnemar10k_jax_cpu.json
  (`corpus.compare_map`: certified counts, differences);
- `run`: the maps, then `mcnemar10k.evaluate_arms` over the 10,000 (the
  committed 2,000, then the run's 8,000; `arm`, one process per arm):
  each arm's success against
  runs/mcnemar/results_10k.json (the expected shift), certified of
  solved, the McNemar verdicts, and rows 0-1999 against `heldout_eval`'s
  own run of the 2,000.

    python -m tests.mcnemar10k_calibration {run,maps} [--work DIR]
        [--procs 8] [--out tests/records/mcnemar10k_port_cpu.json]
    python -m tests.mcnemar10k_calibration gen SEED N OUT.pkl
    python -m tests.mcnemar10k_calibration arm ARM WORK OUT.pkl

About 25 minutes of generation on 8 cores (8 map processes, then the
tail in turn; 250-550 s a map asked for 400 on one thread), then about
25 minutes for the three arms over the 10,000 (one process each, 1,150 s
of it the 10,000).  `run` writes OUT (the committed record by default),
`maps` prints.
"""

import argparse
import json
import os
import pickle
import subprocess
import sys
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from allocnet_tpu_torch.train import (  # noqa: E402
    corpus, dataset, heldout_eval, mcnemar10k)

GATED = range(12000, 12006)
RECORD = os.path.join(ROOT, "tests", "records", "mcnemar10k_port_cpu.json")


def gen(seed, n, out):
    """One map of the loop on the CPU, saved with its generate record (the
    corridor plans as namespaces of ok, seg, hpolys, route)."""
    torch.set_num_threads(1)
    rec = {}
    t0 = time.perf_counter()
    sc, entry = corpus.generate_map(seed, n, device="cpu", record=rec)
    rec["chunks"] = [(a, b, c, [types.SimpleNamespace(
        ok=p.ok, seg=p.seg, hpolys=p.hpolys, route=p.route) for p in plans])
        for a, b, c, plans in rec.get("chunks", [])]
    tmp = out + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump((sc, entry, rec), f)
    os.replace(tmp, out)
    print(f"map {seed}: {entry['certified']} certified of {n} asked "
          f"({entry['kind']}) in {time.perf_counter() - t0:.1f} s",
          flush=True)


def _path(work, m, n):
    return os.path.join(work, f"map_{m}_{n}.pkl")


def _spawn(work, m, n, log):
    return subprocess.Popen(
        [sys.executable, "-m", "tests.mcnemar10k_calibration", "gen",
         str(m), str(n), _path(work, m, n)], cwd=ROOT, stdout=log,
        stderr=subprocess.STDOUT, env=dict(os.environ, OMP_NUM_THREADS="1"))


def generate(work, procs, n=mcnemar10k.FRESH_N, seed0=mcnemar10k.SEED0,
             ahead=21):
    """fresh_scenarios(n, seed0) map by map: the first `ahead` maps
    generated at PER_MAP in up to `procs` processes, then the loop walked
    in order, any map whose request differs generated then."""
    os.makedirs(work, exist_ok=True)
    per = corpus.PER_MAP
    with open(os.path.join(work, "log.txt"), "a") as log:
        todo = [m for m in range(seed0, seed0 + ahead)
                if not os.path.exists(_path(work, m, per))]
        running = []
        while todo or running:
            while todo and len(running) < procs:
                m = todo.pop(0)
                running.append(_spawn(work, m, per, log))
            time.sleep(2)
            for j in [j for j in running if j.poll() is not None]:
                if j.returncode:
                    raise SystemExit(f"a map process failed: {j.args}")
                running.remove(j)
        parts, entries, records, got = [], [], [], 0
        for m in range(seed0, seed0 + corpus.MAX_MAPS):
            if got >= n:
                break
            want = min(per, n - got)
            if not os.path.exists(_path(work, m, want)):
                if _spawn(work, m, want, log).wait():
                    raise SystemExit(f"map {m} failed")
            with open(_path(work, m, want), "rb") as f:
                sc, e, rec = pickle.load(f)
            parts.append(sc)
            entries.append(e)
            records.append(rec)
            got += e["certified"]
    return corpus.concat(parts), entries, records


def maps_part(sc, entries, records):
    """The run's outcomes and maps 12000-12005 against the JAX CPU record
    (when it exists)."""
    refs = {}
    if os.path.exists(mcnemar10k.REFERENCE):
        with open(mcnemar10k.REFERENCE) as f:
            refs = corpus.reference_maps(json.load(f))
    hist = np.asarray(corpus.seg_hist(sc.seg), float)
    out = {"maps": len(entries), "total": int(len(sc.seg)),
           "per_map": [[e["seed"], e["kind"], e["request"], e["candidates"],
                        e["to_certify"], e["certified"]] for e in entries],
           "seg_hist": hist.astype(int).tolist(),
           "seg_shares": (hist / hist.sum()).round(5).tolist(),
           "vs_jax_cpu": {}}
    for e, rec in zip(entries, records):
        m = refs.get((e["seed"], e["request"]))
        if m is None or e["seed"] not in GATED:
            continue
        cmp = corpus.compare_map(rec, m)
        out["vs_jax_cpu"][e["seed"]] = {
            "certified": cmp["certified"],
            "jax_cpu": cmp["reference_certified"],
            "count_rel": cmp["certified"] / cmp["reference_certified"] - 1,
            "differ": cmp["differ"], "diff_share": cmp["diff_share"],
            "by_kind": {k: len(v) for k, v in cmp["diff"].items()}}
    return out


def arm(name, work, out):
    """One arm on the CPU (one thread): `mcnemar10k.evaluate_arms` over the
    10,000 (WORK/joined.npz) and `heldout_reference` over the 2,000,
    pickled to `out`."""
    torch.set_num_threads(1)
    sc = dataset.read_npz(os.path.join(work, "joined.npz"))
    res, per = mcnemar10k.evaluate_arms(sc, "cpu", arms=(name,), log=print)
    ref = mcnemar10k.heldout_reference("cpu", arms=(name,), log=print)
    with open(out, "wb") as f:
        pickle.dump((res, per, ref), f)


def arms_part(sc, work, log):
    """mcnemar10k's three arms over the 10,000 on the CPU, one process each,
    and heldout_eval's run of the 2,000 as the reference of rows 0-1999:
    success, the shift from results_10k.json, the McNemar tables and
    verdicts, rows 0-1999 against the reference."""
    dataset.write_npz(os.path.join(work, "joined.npz"), sc)
    path = lambda a: os.path.join(work, f"arm_{a}.pkl")
    with open(os.path.join(work, "log.txt"), "a") as lg:
        jobs = [subprocess.Popen(
            [sys.executable, "-m", "tests.mcnemar10k_calibration", "arm", a,
             work, path(a)], cwd=ROOT, stdout=lg, stderr=subprocess.STDOUT,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
            for a in heldout_eval.ARMS if not os.path.exists(path(a))]
        for j in jobs:
            if j.wait():
                raise SystemExit(f"an arm process failed: {j.args}")
    reps, per, ref2k, timing = {}, {}, {}, {}
    for a in heldout_eval.ARMS:
        with open(path(a), "rb") as f:
            res, p, r = pickle.load(f)
        reps[a], timing[a] = res["arms"][a], res["timing"][a]["wall_s"]
        per.update(p)
        ref2k.update(r)
    results = mcnemar10k.read_results()
    out = {"arms": reps, "wall_s": timing, **{
        f"mcnemar_{k}": {f"{x}_vs_{y}": heldout_eval.mcnemar(
            per[f"{x}_{k}"], per[f"{y}_{k}"]) for x, y in heldout_eval.PAIRS}
        for k in heldout_eval.FLAGS}}
    out["rows_0_1999"] = {
        a: {k: np.nonzero(per[f"{a}_{k}"][:mcnemar10k.CACHE_N]
                          != ref2k[a][k])[0].tolist()
            for k in heldout_eval.FLAGS} for a in reps}
    out["success_2000_plus"] = {
        a: float(per[f"{a}_solved"][mcnemar10k.CACHE_N:].mean())
        for a in reps}
    out["shift"] = {a: round(reps[a]["success_rate"]
                             - results["arms"][a]["success_rate"], 5)
                    for a in reps}
    out["verdicts"] = mcnemar10k.verdicts(out["mcnemar_solved"])
    out["record_verdicts"] = mcnemar10k.verdicts(results["mcnemar_solved"])
    log(json.dumps(out))
    return out, per


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "arm":
        return arm(*argv[1:4])
    if argv and argv[0] == "gen":
        ap = argparse.ArgumentParser()
        ap.add_argument("seed", type=int)
        ap.add_argument("n", type=int)
        ap.add_argument("out")
        a = ap.parse_args(argv[1:])
        return gen(a.seed, a.n, a.out)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("part", choices=("run", "maps"))
    ap.add_argument("--work", default=os.path.join(ROOT, "chiprun_out",
                                                   "mcnemar10k_cpu"))
    ap.add_argument("--procs", type=int, default=8)
    ap.add_argument("--out", default=RECORD)
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    log = lambda s: print(round(time.perf_counter() - t0, 1), s, flush=True)
    fresh, entries, records = generate(a.work, a.procs)
    out = {"generation": maps_part(fresh, entries, records)}
    log(json.dumps(out["generation"]))
    if a.part == "run":
        sc = mcnemar10k.join(heldout_eval.load_scenarios(), fresh)
        out["eval"], per = arms_part(sc, a.work, log)
        np.savez(os.path.join(a.work, "per_scenario.npz"), **per)
    if a.part == "run":
        out = {"source": "tests/mcnemar10k_calibration.py run",
               "device": "cpu", "threads": "one per process (maps 8 at a "
               "time, arms one process each)", **out}
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
