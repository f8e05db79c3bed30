"""The port's CPU run of the corpus generator against the JAX CPU record:
the readings that allocnet_tpu_torch.train.corpus sets its witness
budgets, its controls' limit and its held-out expected shift from.

Runs `corpus.fresh_scenarios(2000, seed0=9000)` on the CPU (or reads a
saved run, `--run`), holds maps 9000-9005 against
tests/records/corpus_jax_cpu.json (`corpus.compare_map`), and reports:

- `certify`: every certify difference and CONTROL rows on which both runs
  agree per map, through `witness.flag_moves` on the CPU (rounds from
  corpus.WITNESS_ROUND, at most MOST draws): moves and draws per row, so
  the share moved at any budget up to MOST can be read off;
- `corridor`: every corridor difference, the candidates `--card` names
  (corridor differences of a run on the card: the same candidates, since
  the route search is the same host code) and CONTROL agreeing
  candidates per map, through `corpus.corridor_moves`' witness at most
  MOST draws, with each route's own CPU corridor (ok, segments, reason);
- `heldout`: `corpus.heldout` on the CPU over the run's 2,000 and the
  cache (the three nets' success on each, and the difference).

    python -m tests.corpus_calibration {certify,corridor,heldout}
        [--run RUN.pkl] [--out OUT.json] [--threads 4] [--most 256]
        [--card 9000:384,9001:57,...]

The CPU run takes about 20 minutes on 8 threads; `certify` about an hour
on 3 threads at MOST 256 (most rows of the control draw all of them),
`corridor` about 15 minutes on 2, `heldout` about 15 minutes on 2.
"""

import argparse
import json
import os
import pickle
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from allocnet_tpu_torch.planner import planner  # noqa: E402
from allocnet_tpu_torch.train import corpus, datagen  # noqa: E402
from allocnet_tpu_torch.utils import witness  # noqa: E402

CONTROL = {"certify": 20, "corridor": 10}
MAPS = range(9000, 9006)


def port_run(path):
    """(batch, entries, records) of the port's CPU run, saved to `path`
    (the records' corridor plans as (ok, seg, hpolys, route))."""
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    recs = []
    sc, entries = corpus.fresh_scenarios(corpus.FRESH_N, corpus.FRESH_SEED0,
                                         device="cpu", records=recs)
    for r in recs:
        r["chunks"] = [(a, b, c, [(p.ok, p.seg, p.hpolys, p.route)
                                  for p in plans])
                       for a, b, c, plans in r["chunks"]]
    if path:
        with open(path, "wb") as f:
            pickle.dump((sc, entries, recs), f)
    return sc, entries, recs


def certify(entries, recs, refs, most, log):
    out = {}
    for e, rec in zip(entries, recs):
        seed, m = e["seed"], refs.get((e["seed"], e["request"]))
        if m is None or seed not in MAPS:
            continue
        cmp = corpus.compare_map(rec, m)
        rng = np.random.default_rng((99, seed))
        diff = np.asarray(cmp["diff"]["certify"], int)
        ctrl = np.sort(rng.choice(cmp["_agree"], CONTROL["certify"],
                                  replace=False))
        idx = np.concatenate([diff, ctrl])
        mv, dr = witness.flag_moves(
            lambda b: datagen.certified(corpus.GEN_CFG, b, device="cpu"),
            rec["batch"], idx, [(7, seed, int(i)) for i in idx],
            corpus.WITNESS_ROUND, most)
        fl = np.asarray(rec["flags"], bool)
        row = lambda i, a, b: [int(i), bool(fl[i]), int(a), int(b)]
        n = len(diff)
        out[seed] = {"diff": [row(*t) for t in zip(diff, mv, dr)],
                     "ctrl": [row(*t) for t in zip(ctrl, mv[n:], dr[n:])]}
        log(seed, out[seed])
    return out


def corridor(entries, recs, refs, most, card, log):
    out = {}
    for e, rec in zip(entries, recs):
        seed, m = e["seed"], refs.get((e["seed"], e["request"]))
        if m is None or seed not in MAPS:
            continue
        cmp = corpus.compare_map(rec, m)
        rng = np.random.default_rng((99, seed))
        cands = corpus._candidates(rec)
        pmap = planner.build_map(corpus.map_points(seed)[1], np.zeros(3),
                                 np.asarray((20.0, 20.0, 4.0)), device="cpu")
        cidx = {corpus._key(c[0]): i for i, c in enumerate(cands)}
        agree = [cidx[corpus._key(rec["batch"].state[i, 0, :, 0])]
                 for i in cmp["_agree"]]
        kinds = {"diff": [c for c in cmp["diff"]["corridor"] if c >= 0],
                 "card": card.get(seed, []),
                 "ctrl": sorted(rng.choice(agree, CONTROL["corridor"],
                                           replace=False).tolist())}
        res = {}
        for kind, lst in kinds.items():
            res[kind] = []
            for c in lst:
                s, g, rs, _ = cands[c]
                route = planner.search_route(pmap, s, g,
                                             corpus.GEN_CFG.corridor, rs)
                own = planner.corridors_of_routes(
                    pmap, [route], corpus.GEN_CFG, device="cpu",
                    dtype=datagen.CORRIDOR_DTYPE)[0]
                drawn = {"n": 0}

                def corridors(routes):
                    drawn["n"] += len(routes) - 1
                    return [(p.ok, p.hpolys, p.seg) for p in
                            planner.corridors_of_routes(
                                pmap, routes, corpus.GEN_CFG, device="cpu",
                                dtype=datagen.CORRIDOR_DTYPE)]

                mv = witness.corridor_moves(corridors, route, (7, seed, int(c)),
                                            corpus.CORRIDOR_ROUND, most,
                                            corpus.CORRIDOR_TOL)
                res[kind].append([int(c), [bool(own.ok), int(own.seg),
                                           own.reason], mv, drawn["n"]])
        out[seed] = res
        log(seed, res)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("part", choices=("certify", "corridor", "heldout"))
    ap.add_argument("--run", default=None, help="the port's CPU run (.pkl)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--most", type=int, default=256)
    ap.add_argument("--card", default="",
                    help="seed:candidate,... corridor differences on a card")
    a = ap.parse_args(argv)
    torch.set_num_threads(a.threads)
    sc, entries, recs = port_run(a.run)
    with open(corpus.REFERENCE) as f:
        refs = corpus.reference_maps(json.load(f))
    t0 = time.perf_counter()
    log = lambda *v: print(round(time.perf_counter() - t0, 1),
                           json.dumps(v), flush=True)
    if a.part == "certify":
        out = certify(entries, recs, refs, a.most, log)
    elif a.part == "corridor":
        card = {}
        for item in filter(None, a.card.split(",")):
            s, c = item.split(":")
            card.setdefault(int(s), []).append(int(c))
        out = corridor(entries, recs, refs, a.most, card, log)
    else:
        out = corpus.heldout(sc, "cpu", log=print)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
