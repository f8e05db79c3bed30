"""Port parity, the 10,000-scenario McNemar eval (train/mcnemar10k, the
port of scripts/mcnemar10k.py): the port's generator on map 12000 against
the JAX package's CPU run of the same request
(tests/records/mcnemar10k_jax_cpu.json), the join and the cache reuse
against the script's build_cache (both generators stubbed), the output's
keys and per-scenario names against the script's, the McNemar values
against scripts/mcnemar_eval.py's on the 10k record's flags, and each
gate refusing a doctored result.  Reads committed records only: no JAX
generator runs here.

Tolerances: the map is gated as on the card (`corpus.scenario_gates`:
differences at most 0.15 of the rows + 4, each witnessed); the join, the
keys and the McNemar values are exact."""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from allocnet_tpu_torch.train import (corpus, datagen, dataset, evaluate,
                                      heldout_eval, mcnemar10k)
from allocnet_tpu_torch.utils import witness
from allocnet_tpu_torch.utils.scenarios import ScenarioBatch
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "mcnemar10k.py")


@pytest.fixture(scope="module")
def reference():
    with open(mcnemar10k.REFERENCE) as f:
        return json.load(f)


def _script(name, monkeypatch=None):
    """scripts/<name>.py loaded as a module; with `monkeypatch`, the
    script's absolute paths into the repository (the root its CACHE2K
    names) point at this checkout."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if monkeypatch is not None:
        root = mod.CACHE2K[:-len("/data/eval_fresh.npz")]
        spec_from = importlib.util.spec_from_file_location
        monkeypatch.setattr(
            importlib.util, "spec_from_file_location",
            lambda n, p, *a, **k: spec_from(n, p.replace(root, ROOT, 1),
                                            *a, **k))
    return mod


# ---- (a) the port's generator on map 12000 against the JAX CPU record -----

def test_record_is_the_scripts_loop(reference):
    """The record holds maps 12000-12005 asked for 400 each (the loop asks
    that while got <= 7,600), map 12000 asked for 16, and run_10k.log's
    per-map counts (29 maps, all pillar maps)."""
    maps = reference["full"]["maps"]
    assert [(m["seed"], m["request"]) for m in maps] == [
        (12000 + i, 400) for i in range(6)]
    assert sum(m["certified"] for m in maps) <= 8000 - 400
    assert [(m["seed"], m["request"]) for m in reference["smoke"]["maps"]] \
        == [(12000, 16)]
    logged = reference["logs"]["run_10k"]
    assert [s for s, _ in logged] == list(range(12000, 12029))
    assert sum(c for _, c in logged) >= 8000
    assert all(corpus.map_points(s)[0] for s, _ in logged)
    for m in maps + reference["smoke"]["maps"]:
        assert m["kind"] == "pillar"
        assert sum(m["rows"]["certified"]) == m["certified"]


def test_map_12000_asked_16_against_the_record(reference):
    """corpus.fresh_scenarios(16, seed0=12000) on the CPU, one map, gated
    scenario by scenario against the record's run of that request."""
    records = []
    _, entries = corpus.fresh_scenarios(16, mcnemar10k.SEED0, max_maps=1,
                                        device="cpu", records=records,
                                        log=lambda s: None)
    checks = corpus.scenario_gates(entries, records, reference, "cpu",
                                   log=lambda s: None)
    assert entries[0]["request"] == 16
    assert set(checks) == {"map_12000", "times", "witness_control"}
    assert all(v["ok"] for v in checks.values()), checks


# ---- (b) the join and the cache reuse against the script -----------------

def _stub_rows(seed, n):
    """At most 3 + seed % 4 stub rows whose start carries the seed."""
    k = min(n, 3 + seed % 4)
    st = np.zeros((k, 2, 3, 3))
    st[:, 0, 0, 0] = seed
    st[:, 0, 1, 0] = np.arange(k)
    return ScenarioBatch(st, np.full((k, 5, 50, 4), float(seed % 7)),
                         np.ones((k, 5)), np.full(k, 2, np.int32))


class _StubGenerate:
    def __init__(self):
        self.calls = []

    def __call__(self, cfg, n_samples, out_path=None, points=None, seed=0,
                 **kw):
        self.calls.append((int(seed), int(n_samples)))
        sc = _stub_rows(seed, n_samples)
        if kw.get("record") is not None:
            kw["record"].update(batch=sc, flags=np.ones(len(sc.seg), bool))
        return sc


def _stub_points(monkeypatch, *mods):
    for mod in mods:
        monkeypatch.setattr(mod, "random_pillar_map", lambda seed, *a: seed)
        monkeypatch.setattr(mod, "random_obstacle_map", lambda seed, *a: seed)


def test_join_and_cache_reuse_match_the_script(monkeypatch, tmp_path):
    """build_cache(2010): the committed 2,000, then fresh_scenarios(10,
    seed0=12000), in that order, written to the cache; a cache of at
    least 0.95 of the target reused without generating (1,910 rows for
    2,010), a smaller one rebuilt: the script and the port alike."""
    from allocnet_tpu.train import datagen as jdatagen
    script = _script("mcnemar10k", monkeypatch)
    jstub, stub = _StubGenerate(), _StubGenerate()
    monkeypatch.setattr(jdatagen, "generate", jstub)
    monkeypatch.setattr(datagen, "generate", stub)
    _stub_points(monkeypatch, jdatagen, datagen)
    monkeypatch.setattr(script, "CACHE2K", heldout_eval.CACHE)
    s_cache, p_cache = str(tmp_path / "s.npz"), str(tmp_path / "p.npz")
    monkeypatch.setattr(script, "CACHE10K", s_cache)
    monkeypatch.setattr(mcnemar10k, "CACHE10K", p_cache)
    build = lambda: mcnemar10k.build_cache(2010, device="cpu",
                                           log=lambda s: None)
    jsc = script.build_cache(2010)
    sc, entries = build()
    assert stub.calls == jstub.calls and len(stub.calls) > 1
    assert [(e["seed"], e["request"]) for e in entries] == stub.calls
    base = heldout_eval.load_scenarios()
    for f in ScenarioBatch._fields:
        np.testing.assert_array_equal(getattr(sc, f), getattr(jsc, f))
        np.testing.assert_array_equal(getattr(sc, f)[:2000],
                                      getattr(base, f))
        np.testing.assert_array_equal(getattr(dataset.read_npz(p_cache), f),
                                      getattr(dataset.read_npz(s_cache), f))
    assert len(sc.seg) >= 2010
    for rows, reused in ((1910, True), (1909, False)):
        cut = ScenarioBatch(*(a[:rows] for a in jsc))
        for path in (s_cache, p_cache):
            dataset.write_npz(path, cut)
        n0 = len(stub.calls)
        got, entries = build()
        jgot = script.build_cache(2010)
        assert (entries is None) == reused
        assert (len(stub.calls) == n0) == reused == (len(jstub.calls) == n0)
        assert len(got.seg) == len(jgot.seg) == (rows if reused else
                                                  len(jsc.seg))


# ---- (c) the output's keys against the script ----------------------------

def _script_keys():
    """The keys of the script's results dict and its per-scenario names
    (`f"{a}_{k}"` for k in its tuple of flags)."""
    tree = ast.parse(open(SCRIPT).read())
    keys, flags = None, None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [getattr(t, "id", None) for t in node.targets] == ["out"]):
            keys = [k.value for k in node.value.keys]
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "savez" and node.keywords[0].arg is None):
            comp = node.keywords[0].value
            flags = tuple(e.value for e in comp.generators[1].iter.elts)
    return keys, flags


def _fake_eval_arm(run_dir, sc, device=None):
    """A stand-in for heldout_eval.eval_arm: flags from the rows' starts."""
    arm = heldout_eval.ARMS.index(os.path.basename(run_dir))
    key = np.abs(sc.state[:, 0, :, 0]).sum(1) * 1000
    solved = (key.astype(np.int64) + arm) % 5 != 0
    rep = evaluate.EvalReport(
        n=len(solved), success_rate=float(solved.mean()),
        stop_token_accuracy=1.0, time_segment_accuracy=1.0, mean_obj=0.05,
        mean_time_ratio=1.0, certified_frac=float(solved.mean()),
        certified_of_solved=1.0)
    batches = -(-len(solved) // heldout_eval.BATCH)
    return (rep, {"solved": solved, "certified": solved.copy()},
            {"wall_s": 1.0, "solves_per_s": 1.0, "batch_ms": [1.0] * batches},
            {"admm_chunk": 0, "ldl_block": 0})


def _stub_main(monkeypatch, tmp_path):
    """main on a cut (n 2048: map 12000 asked for 48), generation and eval
    stubbed, the cache in tmp_path.  Returns (rc, the JSON)."""
    monkeypatch.setattr(datagen, "generate", _StubGenerate())
    _stub_points(monkeypatch, datagen)
    monkeypatch.setattr(heldout_eval, "eval_arm", _fake_eval_arm)
    monkeypatch.setattr(mcnemar10k, "CACHE10K", str(tmp_path / "c.npz"))
    out = str(tmp_path / "m.json")
    rc = mcnemar10k.main(["--n", "2048", "--device", "cpu", "--out", out])
    with open(out) as f:
        return rc, json.load(f)


def test_output_keys_match_the_script(monkeypatch, tmp_path, capsys):
    """main on a cut: the JSON starts with the script's keys, each arm
    carries its token_thresh, the per-scenario file holds `<arm>_<flag>`
    for the script's flags, and the cache rows are gated."""
    keys, flags = _script_keys()
    assert keys == ["n", "cache", "arms", "mcnemar_solved",
                    "mcnemar_certified"]
    assert flags == heldout_eval.FLAGS
    rc, res = _stub_main(monkeypatch, tmp_path)
    assert rc == 0, res["gates"]
    assert list(res)[:len(keys)] == keys
    assert res["n"] == len(dataset.read_npz(str(tmp_path / "c.npz")).seg)
    for arm in heldout_eval.ARMS:
        assert res["arms"][arm]["token_thresh"] == \
            heldout_eval.calibrated_thresh(os.path.join(heldout_eval.RUNS,
                                                        arm))
    pairs = [f"{x}_vs_{y}" for x, y in heldout_eval.PAIRS]
    assert list(res["mcnemar_solved"]) == list(res["mcnemar_certified"]) \
        == pairs
    with np.load(str(tmp_path / "m_per_scenario.npz")) as z:
        assert sorted(z.files) == sorted(f"{a}_{k}" for a in
                                         heldout_eval.ARMS for k in flags)
    assert res["gates"]["checks"]["cache_rows"]["shared"] == [1792, 1999]
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["n"] == \
        res["n"]


def test_a_reused_cache_fails_the_run(monkeypatch, tmp_path):
    """A second run over the first run's cache reuses it, as the script
    does, and exits 1: its generation went ungated."""
    rc, first = _stub_main(monkeypatch, tmp_path)
    assert rc == 0 and first["gates"]["checks"]["generation"]["ok"]
    rc, again = _stub_main(monkeypatch, tmp_path)
    assert rc == 1 and again["generation"] is None
    assert [k for k, v in again["gates"]["checks"].items()
            if not v["ok"]] == ["generation"]
    assert again["n"] == first["n"]


def test_unwitnessed_name_recorded_maps(reference):
    """Each difference that goes without a witness names a map of the
    record's full run by seed and request, a row or a candidate of it,
    and its evidence."""
    maps = {(m["seed"], m["request"]): m for m in reference["full"]["maps"]}
    for (seed, request, kind, i), why in corpus.UNWITNESSED.items():
        assert (seed, request) in maps
        assert kind in ("row", "candidate") and i >= 0
        assert "card" in why


# ---- (d) the McNemar values against the script ---------------------------

def test_mcnemar_equals_the_script():
    """heldout_eval.mcnemar and mcnemar_eval.mcnemar on the 10k record's
    flags: equal, and equal to results_10k.json's tables; the record's
    verdicts are VERDICTS except where EXPLAINED says otherwise."""
    me = _script("mcnemar_eval")
    results = mcnemar10k.read_results()
    with np.load(mcnemar10k.PER_SCENARIO) as z:
        flags = {k: z[k] for k in z.files}
    for k in heldout_eval.FLAGS:
        for x, y in heldout_eval.PAIRS:
            a, b = flags[f"{x}_{k}"], flags[f"{y}_{k}"]
            ours = heldout_eval.mcnemar(a, b)
            assert ours == me.mcnemar(a, b)
            assert ours == results[f"mcnemar_{k}"][f"{x}_vs_{y}"]
    got = mcnemar10k.verdicts(results["mcnemar_solved"])
    assert {p: v for p, v in got.items() if p not in mcnemar10k.EXPLAINED} \
        == {p: v for p, v in mcnemar10k.VERDICTS.items()
            if p not in mcnemar10k.EXPLAINED}


# ---- (e) each gate refuses a doctored result -----------------------------

def _table(verdicts):
    return {p: {"b_only_first": 10, "c_only_second": 5,
                "p_two_sided": 0.001 if sig else 0.5,
                "delta": 0.01 * sign} for p, (sign, sig) in verdicts.items()}


def _arms_out(n=10000):
    results = mcnemar10k.read_results()
    batches = -(-n // heldout_eval.BATCH)
    return {"n": n, "arms": {a: {"success_rate": results["arms"][a][
        "success_rate"] + mcnemar10k.HELDOUT10K_SHIFT[a],
        "certified_of_solved": 1.0} for a in heldout_eval.ARMS},
        "launches": {a: {"admm_chunk": 3 * batches,
                         "ldl_block": mcnemar10k.L1_PER_BATCH * batches}
                     for a in heldout_eval.ARMS}}, results


def _arm_case(case):
    out, results = _arms_out()
    if case == "success":
        out["arms"]["big4"]["success_rate"] += mcnemar10k.SUCCESS_TOL + 1e-3
    elif case == "certified":
        out["arms"]["big3"]["certified_of_solved"] = 0.998
    elif case == "launches":
        out["launches"]["finetune"]["ldl_block"] -= 1
    checks = {}
    mcnemar10k.arm_gates(checks, out, results, True, True, 3)
    return checks


def _verdict_case(case):
    """A table of the verdicts; "verdict_noise" moves the pair that is not
    different past zero by more than SIGN_NOISE (its sign is not gated),
    "verdict_sign_noise" a different pair just past SIGN_NOISE."""
    want = dict(mcnemar10k.VERDICTS)
    if case == "verdict_sign":
        s, sig = want["big4_vs_big3"]
        want["big4_vs_big3"] = (-s, sig)
    elif case == "verdict_p":
        s, sig = want["finetune_vs_big3"]
        want["finetune_vs_big3"] = (s, not sig)
    table = _table(want)
    if case == "verdict_noise":
        s, _ = want["finetune_vs_big3"]
        table["finetune_vs_big3"]["delta"] = -s * 2 * mcnemar10k.SIGN_NOISE
    if case == "verdict_sign_noise":
        s, _ = want["big4_vs_big3"]
        table["big4_vs_big3"]["delta"] = -s * 1.1 * mcnemar10k.SIGN_NOISE
    if case == "verdict_weak":
        table["big4_vs_finetune"]["p_two_sided"] = mcnemar10k.SIG_ALPHA
    checks = {}
    mcnemar10k.verdict_gate(checks, {"mcnemar_solved": table})
    return checks


def _cache_row_case(monkeypatch, case):
    """Cache rows 0-299 with the shared batch at 256-299: a flag of row
    260 (or 100) moved; the witness stubbed to move every row or none."""
    base_n = 300
    sc = heldout_eval.load_scenarios(base_n)
    ref = {a: {k: np.ones(base_n, bool) for k in heldout_eval.FLAGS}
           for a in heldout_eval.ARMS}
    per = {f"{a}_{k}": np.ones(base_n, bool) for a in heldout_eval.ARMS
           for k in heldout_eval.FLAGS}
    per["big4_solved"][100 if case == "cache_row_outside" else 260] = False
    moved = case != "cache_row_unwitnessed"
    monkeypatch.setattr(heldout_eval, "load_arm", lambda d, dev=None:
                        type("Net", (), {"token_thresh": 0.5})())
    monkeypatch.setattr(witness, "flag_moves", lambda f, b, idx, seeds, r, m:
                        (np.asarray([int(moved and i == 260) for i in idx]),
                         np.full(len(idx), 8)))
    checks = {}
    mcnemar10k.cache_row_gate(checks, per, ref, sc, base_n, "cpu",
                              log=lambda s: None)
    return checks


def _generation_case(monkeypatch, case, reference):
    """A whole run's generation: the port's CPU run's map count and shares,
    every certified row passing in float64, then one of them doctored."""
    n_maps = mcnemar10k.CPU_MAPS + (2 if case == "maps" else 0)
    shares = np.asarray(mcnemar10k.CPU_SEG_SHARES)
    if case == "seg_shares":
        shares = shares + np.array([0, 0.03, -0.03, 0, 0, 0])
    counts = np.floor(shares * 8000).astype(int)
    counts[counts.argmax()] += 8000 - counts.sum()
    seg = np.repeat(np.arange(6), counts).astype(np.int32)
    fresh = ScenarioBatch(np.zeros((len(seg), 2, 3, 3)),
                          np.zeros((len(seg), 5, 50, 4)),
                          np.ones((len(seg), 5)), seg)
    entries = [{"seed": 12000 + i, "request": 37} for i in range(n_maps)]
    records = [{"flags": np.ones(3, bool)} for _ in entries]
    f64 = np.ones(3, bool)
    if case == "f64":
        f64[1] = False
    monkeypatch.setattr(corpus, "recheck", lambda rec, dev=None: {
        "repeat_equal": case != "repeat", "f64": f64})
    checks = {}
    mcnemar10k.generation_gates(checks, fresh, entries, records, reference,
                                "cpu")
    return checks


def _count_case(case, reference):
    m = reference["full"]["maps"][2]
    got = m["certified"] * (1.06 if case == "count" else 1.04)
    checks = {}
    mcnemar10k.count_gate(checks, [{"seed": m["seed"], "request": 400,
                                    "certified": int(got)}], reference)
    return checks


GATE_CASES = {"success": "arm_big4", "certified": "arm_big3",
              "launches": "arm_finetune", "verdict_sign": "mcnemar",
              "verdict_sign_noise": "mcnemar",
              "verdict_p": "mcnemar", "verdict_weak": "mcnemar",
              "cache_row_unwitnessed": "cache_rows",
              "cache_row_outside": "cache_rows", "maps": "maps",
              "seg_shares": "seg_shares", "f64": "certified_in_f64",
              "repeat": "certified_in_f64", "count": "count_12002"}


def _gate_run(monkeypatch, case, reference):
    if case in ("success", "certified", "launches", "arms"):
        return _arm_case(case)
    if case.startswith("verdict"):
        return _verdict_case(case)
    if case.startswith("cache_row"):
        return _cache_row_case(monkeypatch, case)
    if case in ("maps", "seg_shares", "f64", "repeat", "generation"):
        return _generation_case(monkeypatch, case, reference)
    return _count_case(case, reference)


@pytest.mark.parametrize("case", ["arms", "verdict", "verdict_noise",
                                  "cache_row_witnessed", "generation",
                                  "count_within"])
def test_gates_pass_an_undoctored_result(monkeypatch, reference, case):
    checks = _gate_run(monkeypatch, case, reference)
    assert checks and all(v["ok"] for v in checks.values()), checks


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gates_refuse_a_doctored_result(monkeypatch, reference, case):
    checks = _gate_run(monkeypatch, case, reference)
    bad = sorted(k for k, v in checks.items() if not v["ok"])
    assert bad == [GATE_CASES[case]], checks


# ---- (f) no card, no JAX -------------------------------------------------

def test_without_a_card_it_raises(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setattr(mcnemar10k, "CACHE10K", str(tmp_path / "c.npz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mcnemar10k.main(["--out", str(tmp_path / "m.json")])
    assert not os.listdir(tmp_path)


def test_module_imports_no_jax():
    code = ("import sys; import allocnet_tpu_torch.train.mcnemar10k; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'allocnet_tpu', 'scripts', 'h5py')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
