"""Port parity, the scenario-corpus generators (train/corpus: the map loop
of scripts/eval_big.py's fresh_scenarios and scripts/gen_dataset.py, the
.npz shards with resume, regen_data.sh's combine) against the scripts and
the JAX package on the CPU, the record of the JAX package's CPU run
(tests/records/corpus_jax_cpu.json) against the repository's logs and
cache, the gates, the entry point and the CLI's .npz / .h5 choice.

Tolerances: the map loop's requests, map kinds and JSON keys are equal;
fresh_scenarios(16, seed0=9000) runs its corridors in float64 on both
sides (tests/conftest.py turns on JAX x64), so its requests, counts,
starts, goals and segment counts are equal, the corridors agree as face
sets to 1e-6 of the largest entry and the reference times to 1e-9; the
certification is float32 on both sides and its flags are equal.  Shards
and combine are exact."""

import ast
import importlib.util
import json
import os
import re
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

from allocnet_tpu_torch.planner import sfc
from allocnet_tpu_torch.train import corpus, datagen, dataset
from allocnet_tpu_torch.utils.scenarios import ScenarioBatch
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "data", "eval_fresh.npz")
FACE_TOL = 1e-6
TIME_TOL = 1e-9


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(k, seed):
    """k stub scenarios whose start carries the map seed and the row."""
    S, F = corpus.GEN_CFG.qp.max_seg, corpus.GEN_CFG.qp.max_faces
    st = np.zeros((k, 2, 3, 3))
    st[:, 0, 0, 0] = seed
    st[:, 0, 1, 0] = np.arange(k)
    return ScenarioBatch(st, np.full((k, S, F, 4), seed % 7, float),
                         np.ones((k, S)), np.full(k, 2, np.int32))


def _stub_yield(seed, n):
    """What the stub generate certifies of a request n on map seed: 0 on
    every fifth map, else at most 3 + seed % 5."""
    return 0 if seed % 5 == 4 else min(n, 3 + seed % 5)


class _StubGenerate:
    """A generate for both packages' loops: records (seed, request, pillar
    map or not) and certifies `_stub_yield` stub rows."""

    def __init__(self):
        self.calls = []

    def __call__(self, cfg, n_samples, out_path=None, points=None, seed=0,
                 **kw):
        pillar = np.array_equal(points, datagen.random_pillar_map(seed))
        self.calls.append((int(seed), int(n_samples), pillar))
        if "record" in kw and kw["record"] is not None:
            kw["record"].update(batch=_rows(_stub_yield(seed, n_samples),
                                            seed), flags=None)
        return _rows(_stub_yield(seed, n_samples), seed)


# ---- (a) the map loop ----------------------------------------------------

@pytest.mark.parametrize("n,seed0", [(40, 9025), (10 ** 6, 12000)])
def test_fresh_loop_matches_eval_big(monkeypatch, n, seed0):
    """Requests, map kinds and the 40-map cap of eval_big.fresh_scenarios
    (its datagen stubbed), against the port's."""
    eb = _script("eval_big")
    jstub, stub = _StubGenerate(), _StubGenerate()
    monkeypatch.setattr(eb.datagen, "generate", jstub)
    monkeypatch.setattr(datagen, "generate", stub)
    jsc = eb.fresh_scenarios(n, seed0=seed0)
    sc, entries = corpus.fresh_scenarios(n, seed0, device="cpu",
                                         log=lambda s: None)
    assert stub.calls == jstub.calls
    np.testing.assert_array_equal(sc.state, jsc.state)
    assert [(e["seed"], e["request"], e["kind"] == "pillar")
            for e in entries] == stub.calls
    kinds = {seed: p for seed, _, p in stub.calls}
    assert all(kinds[s] == (s % 100 < 30) for s in kinds)
    if n > 1000:
        assert len(stub.calls) == corpus.MAX_MAPS
    else:
        assert len(sc.seg) == n and len(stub.calls) < corpus.MAX_MAPS


def test_shard_loop_matches_gen_dataset(monkeypatch, tmp_path, capsys):
    """gen_dataset.main (its datagen stubbed, HDF5 writes counted): the
    same requests and map kinds as write_shards past 40 maps (no cap),
    the same pillar fraction rule, and its JSON lines' keys are the
    port's first keys."""
    gd = _script("gen_dataset")
    jstub, stub = _StubGenerate(), _StubGenerate()
    monkeypatch.setattr(gd.datagen, "generate", jstub)
    monkeypatch.setattr(gd.ds_lib, "write_h5", lambda path, sc: open(
        path, "w").close())
    monkeypatch.setattr(gd.ds_lib, "read_h5", lambda path, cfg: None)
    monkeypatch.setattr(datagen, "generate", stub)
    args = ["--n", "250", "--per-map", "9", "--seed0", "1070",
            "--pillar-frac", "0.5"]
    monkeypatch.setattr(sys, "argv", ["gen_dataset.py", "--out",
                                      str(tmp_path / "j")] + args)
    gd.main()
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    lines_port = []
    out = corpus.write_shards(str(tmp_path / "p"), 250, 9, 1070, 0.5,
                              device="cpu",
                              log=lambda s: lines_port.append(json.loads(s)))
    assert stub.calls == jstub.calls and len(stub.calls) > corpus.MAX_MAPS
    assert any(p for *_, p in stub.calls) and not all(
        p for *_, p in stub.calls)
    assert all(p == (s % 100 < 50) for s, _, p in stub.calls)
    assert len(lines) == len(lines_port)
    for a, b in zip(lines[:-1], lines_port[:-1]):
        assert list(b)[:len(corpus.SHARD_LINE_KEYS)] == list(a)
        assert [b[k] for k in ("map", "plain", "samples", "total")] == [
            a[k] for k in ("map", "plain", "samples", "total")]
    assert list(lines[-1]) == [k for k in lines_port[-1]]
    assert lines_port[-1]["done"] and out["total"] == lines[-1]["total"]
    assert tuple(corpus.SHARD_LINE_KEYS) == tuple(lines[0])
    assert sorted(os.listdir(tmp_path / "p")) == sorted(
        f.replace(".h5", ".npz") for f in os.listdir(tmp_path / "j"))


def test_map_points_rule():
    for seed, plain in ((9000, True), (9029, True), (9030, False),
                        (12099, False), (1129, True)):
        p, pts = corpus.map_points(seed)
        assert p == plain
        want = (datagen.random_pillar_map(seed) if plain
                else datagen.random_obstacle_map(seed))
        np.testing.assert_array_equal(pts, want)


# ---- (b) fresh_scenarios against the script, on the CPU ------------------

@pytest.fixture(scope="module")
def fresh16():
    """fresh_scenarios(16, seed0=9000) through the script (x64: float64
    corridors) and the port (float64 corridors), with each map's
    records."""
    eb = _script("eval_big")
    calls, gen = [], eb.datagen.generate

    def rec_generate(cfg, n, points=None, seed=0, **k):
        sc = gen(cfg, n, points=points, seed=seed, **k)
        calls.append((int(seed), int(n), int(len(sc.seg))))
        return sc

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(eb.datagen, "generate", rec_generate)
        jsc = eb.fresh_scenarios(16, seed0=9000)
    records = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(datagen, "CORRIDOR_DTYPE", torch.float64)
        sc, entries = corpus.fresh_scenarios(16, 9000, device="cpu",
                                             records=records,
                                             log=lambda s: None)
    return jsc, calls, sc, entries, records


def test_fresh_scenarios_match_the_script(fresh16):
    jsc, calls, sc, entries, records = fresh16
    assert len(calls) >= 2
    assert [(e["seed"], e["request"], e["certified"])
            for e in entries] == calls
    np.testing.assert_array_equal(sc.seg, np.asarray(jsc.seg))
    np.testing.assert_array_equal(sc.state, np.asarray(jsc.state))
    np.testing.assert_allclose(sc.times, np.asarray(jsc.times), rtol=0,
                               atol=TIME_TOL)
    scale = max(1.0, float(np.abs(jsc.hpolys).max()))
    for b in range(len(sc.seg)):
        for i in range(int(sc.seg[b])):
            assert sfc.face_set_distance(
                sc.hpolys[b, i], np.asarray(jsc.hpolys[b, i])) <= (
                    FACE_TOL * scale)
    assert [e["kind"] for e in entries] == ["pillar"] * len(entries)
    assert all(e["stages_s"]["corridors"] > 0 for e in entries)


# ---- (c) shards: resume and combine --------------------------------------

class _Interrupt(Exception):
    pass


def test_shards_resume_and_combine(monkeypatch, tmp_path):
    """A run cut short at its third map resumes: the shards written are
    read and counted, not generated again, and the total and the shards
    are an uninterrupted run's; combine equals the shards concatenated in
    sorted order, and a combined file followed by a directory (regen's
    stage 3) their concatenation."""
    stub = _StubGenerate()
    monkeypatch.setattr(datagen, "generate", stub)
    quiet = dict(device="cpu", log=lambda s: None)
    whole = corpus.write_shards(str(tmp_path / "whole"), 30, 5, 9000, **quiet)
    calls_whole = list(stub.calls)

    stub.calls.clear()
    cut = tmp_path / "cut"

    def failing(*a, **k):
        if len(stub.calls) == 2:
            raise _Interrupt
        return stub(*a, **k)

    monkeypatch.setattr(datagen, "generate", failing)
    with pytest.raises(_Interrupt):
        corpus.write_shards(str(cut), 30, 5, 9000, **quiet)
    done = sorted(os.listdir(cut))
    assert done == ["shard_9000.npz", "shard_9001.npz"]
    stamps = {f: os.stat(cut / f).st_mtime_ns for f in done}
    stub.calls.clear()
    monkeypatch.setattr(datagen, "generate", stub)
    again = corpus.write_shards(str(cut), 30, 5, 9000, **quiet)
    assert stub.calls == calls_whole[2:]
    assert [e["map"] for e in again["maps"] if e.get("resumed")] == [9000,
                                                                     9001]
    assert again["total"] == whole["total"] >= 30
    assert {f: os.stat(cut / f).st_mtime_ns for f in done} == stamps
    assert sorted(os.listdir(cut)) == sorted(os.listdir(tmp_path / "whole"))
    # a map that certified nothing wrote no shard, so it runs again (as in
    # the script); every other map is read
    stub.calls.clear()
    third = corpus.write_shards(str(cut), 30, 5, 9000, **quiet)
    assert stub.calls and all(_stub_yield(s, n) == 0
                              for s, n, _ in stub.calls)
    assert third["generated"] == len(stub.calls)
    assert third["total"] == whole["total"]

    shards = sorted(str(p) for p in cut.glob("shard_*.npz"))
    parts = [dataset.read_npz(p) for p in shards]
    out = corpus.combine([str(cut)], str(tmp_path / "combined.npz"))
    got = dataset.read_npz(out["out"])
    for f in ScenarioBatch._fields:
        np.testing.assert_array_equal(getattr(got, f), np.concatenate(
            [getattr(p, f) for p in parts]))
    assert out["n"] == whole["total"] and out["files"] == len(shards)
    with np.load(out["out"]) as z:
        assert sorted(z.files) == sorted(("state", "hpolys", "times", "seg"))
    both = corpus.combine([out["out"], str(tmp_path / "whole")],
                          str(tmp_path / "both.npz"))
    b = dataset.read_npz(both["out"])
    np.testing.assert_array_equal(b.state, np.concatenate(
        [got.state, got.state]))
    assert not list(tmp_path.rglob("*.tmp"))


# ---- (d) the record against the logs and the cache -----------------------

@pytest.fixture(scope="module")
def reference():
    with open(corpus.REFERENCE) as f:
        return json.load(f)


def _log_counts(path):
    out = []
    for line in open(path):
        m = re.match(r"map (\d+): (\d+) certified \((\d+)/(\d+)\)", line)
        if m:
            out.append([int(m.group(1)), int(m.group(2))])
    return out


def test_record_transcribes_the_logs_and_the_cache(reference):
    assert reference["logs"]["regen_eval"] == _log_counts(
        os.path.join(ROOT, "runs", "regen_eval.log"))
    assert reference["logs"]["run_10k"] == _log_counts(
        os.path.join(ROOT, "runs", "mcnemar", "run_10k.log"))
    assert sum(c for _, c in reference["logs"]["regen_eval"]) == 2000
    assert sum(c for _, c in reference["logs"]["run_10k"]) == 8000
    with np.load(CACHE) as z:
        hist = np.bincount(z["seg"], minlength=6).tolist()
    assert reference["vs_records"]["cache_seg_hist"] == hist
    assert hist[2:] == [615, 1042, 292, 51]


@pytest.mark.parametrize("run,n", [("full", 2000), ("smoke", 64)])
def test_record_is_the_scripts_loop(reference, run, n):
    """Each recorded map asks what the script's loop asks it, certifies
    the rows it flags, and the run stops where the loop stops."""
    got = 0
    maps = reference[run]["maps"]
    assert reference[run]["n"] == n
    for mi, m in enumerate(maps):
        assert m["seed"] == 9000 + mi
        assert m["request"] == min(corpus.PER_MAP, n - got)
        assert m["kind"] == ("pillar" if m["seed"] % 100 < 30 else
                             "obstacle")
        assert sum(m["rows"]["certified"]) == m["certified"]
        assert len(m["rows"]["seg"]) <= m["request"]
        got += m["certified"]
    assert got >= n and got - maps[-1]["certified"] < n


# ---- (e) the gates on hand-made outcomes ---------------------------------

def _plan(ok, seg=2, goal=(9.0, 9.0, 1.0)):
    from allocnet_tpu_torch.planner.planner import CorridorPlan
    S, F = corpus.GEN_CFG.qp.max_seg, corpus.GEN_CFG.qp.max_faces
    route = np.array([[0.0, 0.0, 1.0], goal])
    return CorridorPlan(route, np.zeros((S, F, 4)), seg if ok else 0, ok,
                        "ok" if ok else "long_corridor")


def _made_map():
    """Six candidates of one chunk.  The port: 0-4 reach the
    certification (its request, 5, filled), flags T T F T T.  The record:
    0, 1, 2, 4, 5, flags T F T T T.  So candidates 1 (the port certifies
    it) and 2 (the port drops it) are certify differences, 3 a corridor
    difference, 5 past the cut; 0 and 4 are shared and certified."""
    S = corpus.GEN_CFG.qp.max_seg
    starts = np.array([[1.0 + c, 2.0, 1.0] for c in range(6)])
    goals = np.array([[15.0, 15.0 - c, 2.0] for c in range(6)])
    plans = [_plan(c != 5, goal=goals[c]) for c in range(6)]
    ours = [0, 1, 2, 3, 4]
    st = np.zeros((5, 2, 3, 3))
    st[:, 0, :, 0] = starts[ours]
    st[:, 1, :, 0] = goals[ours]
    times = np.tile(np.linspace(1.0, 2.0, S), (5, 1))
    batch = ScenarioBatch(st, np.zeros((5, S, 50, 4)), times,
                          np.full(5, 2, np.int32))
    rec = {"chunks": [(starts, goals, 100, plans)], "batch": batch,
           "flags": np.array([True, True, False, True, True])}
    theirs = [0, 1, 2, 4, 5]
    ref = {"seed": 9000, "request": 5, "certified": 4, "rows": {
        "start": starts[theirs].tolist(), "goal": goals[theirs].tolist(),
        "seg": [2] * 5, "times": np.tile(np.linspace(1.0, 2.0, S),
                                         (5, 1)).tolist(),
        "certified": [True, False, True, True, True]}}
    entry = {"seed": 9000, "request": 5, "to_certify": 5, "certified": 4,
             "k1": 4, "l1": 48}
    return rec, ref, entry


def test_compare_map_classifies_the_differences():
    rec, ref, _ = _made_map()
    cmp = corpus.compare_map(rec, ref)
    assert cmp["diff"] == {"certify": [1, 2], "corridor": [3], "tail": [5]}
    assert (cmp["certified"], cmp["reference_certified"]) == (4, 4)
    assert cmp["shared"] == 2 and cmp["differ"] == 4
    assert cmp["diff_share"] == pytest.approx(1.0)
    assert sorted(cmp["_agree"]) == [0, 4]


def _outcome_ref():
    with np.load(CACHE) as z:
        hist = np.bincount(z["seg"], minlength=6).tolist()
    return {"logs": {"regen_eval": [[9000 + i, 1] for i in range(11)]},
            "vs_records": {"cache_seg_hist": hist, "seg_hist": hist,
                           "per_map": [{"seed": 9000, "log": 3, "jax_cpu": 3,
                                        "shared_starts": 3}]}}


class _Sol(NamedTuple):
    solved: torch.Tensor


def _gate_run(monkeypatch, case, min_rows=1, explained=None):
    """The checks of a hand-made run, moved past one limit by `case`.  The
    witnesses' inputs are stubbed: every certified row passes the float64
    test (so row 1, certified by the port only, is witnessed by it), the
    CPU flag of row 2 (dropped by the port only) moves under the draws,
    the corridor of candidate 3 moves, no control moves; the cache holds
    the starts of rows 0 and 1.  Controls of `min_rows` rows or more are
    gated; `explained`, when given, stands for corpus.UNWITNESSED."""
    rec, ref, entry = _made_map()
    monkeypatch.setattr(corpus, "CONTROL_MIN_ROWS", min_rows)
    w = {"f64": {0, 1, 3, 4}, "cpu": {2}, "device": None, "ctrl_cpu": 0,
         "ctrl_device": 0, "corridor": 3, "corridor_ctrl": 0,
         "repeat": True, "apart": set(), "corridor_row": 0}
    if case == "share":
        monkeypatch.setattr(corpus, "MAX_DIFF_SHARE", 0.5)
        monkeypatch.setattr(corpus, "MAX_DIFF_SLACK", 0)
    elif case == "f64_witness":
        w["f64"] = {0, 3, 4}
    elif case == "drop_witness":
        w["cpu"] = set()
    elif case == "drop_witness_on_the_card":
        w.update(cpu=set(), device=set())
    elif case == "card_draws":
        w.update(cpu=set(), device={2})
    elif case == "corridor_witness":
        w["corridor"] = 0
    elif case == "parted_corridor":
        w.update(cpu=set(), apart={2}, corridor_row=2)
    elif case == "parted_corridor_unmoved":
        w.update(cpu=set(), apart={2})
    elif case == "repeat":
        w["repeat"] = False
    elif case == "control":
        w["ctrl_cpu"] = 1
    elif case == "card_control":
        w.update(cpu=set(), device={2}, ctrl_device=1)
    elif case == "corridor_control":
        w["corridor_ctrl"] = 2
    elif case == "regenerated_f64":
        w["f64"] = {0, 1, 4}
    elif case == "time_share":
        ref["rows"]["times"][3] = [t * 1.002 for t in ref["rows"]["times"][3]]
    elif case == "mean_time":
        monkeypatch.setattr(corpus, "TIME_SHARE_MIN", 0.0)
        ref["rows"]["times"][3] = [t * 1.05 for t in ref["rows"]["times"][3]]
    elif case == "launches":
        entry["l1"] = 47
    flags = torch.as_tensor(rec["flags"])
    monkeypatch.setattr(datagen, "certify_solve", lambda cfg, sc, device=None:
                        _Sol(flags if w["repeat"] else ~flags))
    # the rows the float64 test is given are the certified ones, in order
    certified = np.nonzero(rec["flags"])[0]
    monkeypatch.setattr(datagen, "solved_in_f64", lambda cfg, sc, sol:
                        np.isin(certified, list(w["f64"])))

    def draws(batch, rows, pool, seed, tag, device):
        on_card = torch.device(device).type == "cuda"
        moving = w["device"] if on_card else w["cpu"]
        n_ctrl = min(len(rows), len(pool))
        ctrl = w["ctrl_device"] if on_card else w["ctrl_cpu"]
        return ({int(i): int(i in moving) for i in rows},
                {int(i): 8 for i in rows}, [min(ctrl, n_ctrl), n_ctrl])

    if w["device"] is not None:
        monkeypatch.setattr(corpus, "resolve_device",
                            lambda d=None: torch.device("cuda"))
    monkeypatch.setattr(corpus, "_draws", draws)
    monkeypatch.setattr(corpus, "corridor_moves", lambda *a, **k: {
        3: w["corridor"], 2: w["corridor_row"]}.get(a[-1][2],
                                                    w["corridor_ctrl"]))
    # the CPU corridor of candidate c (route seed 100 + c) parts from the
    # run's (no faces) when c is in w["apart"]
    S, F = corpus.GEN_CFG.qp.max_seg, corpus.GEN_CFG.qp.max_faces
    monkeypatch.setattr(corpus, "cpu_corridor", lambda pm, s, g, rs: (
        True, np.full((S, F, 4), float(rs - 100 in w["apart"])), 2))
    full = {"full": {"maps": [ref]}, "smoke": {"maps": []}}
    if explained is not None:
        monkeypatch.setattr(corpus, "UNWITNESSED", explained)
    checks = corpus.scenario_gates([entry], [rec], full, "cpu",
                                   log=lambda s: None)
    corpus.launch_gate(checks, [entry])
    oref = _outcome_ref()
    hist = np.asarray(oref["vs_records"]["cache_seg_hist"])
    seg = np.repeat(np.arange(6), hist)
    maps = [{}] * 11
    if case == "seg_shares":
        seg = np.concatenate([seg, np.full(100, 5)])
    elif case == "maps":
        maps = [{}] * 13
    elif case == "records":
        monkeypatch.setattr(corpus, "EXPLAINED", {})
        oref["vs_records"]["per_map"][0]["jax_cpu"] = 2
    corpus.outcome_gates(checks, ScenarioBatch(None, None, None, seg), maps,
                         oref)
    from allocnet_tpu_torch.train import heldout_eval
    b = rec["batch"]
    monkeypatch.setattr(heldout_eval, "load_scenarios", lambda n=None:
                        ScenarioBatch(*(a[:2] for a in b)))
    corpus.f64_gate(checks, ScenarioBatch(*(a[certified] for a in b)),
                    [rec], "cpu")
    held = {a: {"diff": corpus.HELDOUT_SHIFT[a] + 0.01}
            for a in corpus.HELDOUT_SHIFT}
    if case == "heldout":
        held["big4"]["diff"] = corpus.HELDOUT_SHIFT["big4"] - 0.031
    corpus.heldout_gate(checks, held)
    return checks


GATE_CASES = {"share": "map_9000", "f64_witness": "map_9000",
              "drop_witness": "map_9000",
              "drop_witness_on_the_card": "map_9000",
              "corridor_witness": "map_9000",
              "parted_corridor_unmoved": "map_9000",
              "repeat": "map_9000", "control": "witness_control",
              "card_control": "witness_control",
              "corridor_control": "witness_control",
              "regenerated_f64": "regenerated_only_in_f64",
              "time_share": "times", "mean_time": "times",
              "launches": "launches_per_certify", "seg_shares": "seg_shares",
              "maps": "maps", "records": "reference_vs_records",
              "heldout": "heldout"}


def test_witness_draws_are_per_row():
    """A row's draws come from its own seed: its moves are the same with
    or without other rows in the witness, and the rounds double."""
    from allocnet_tpu_torch.utils import witness
    from allocnet_tpu_torch.utils.scenarios import random_scenarios
    assert list(witness.rounds(8, 256)) == [8, 8, 16, 32, 64, 128]
    assert list(witness.rounds(8, 20)) == [8, 8, 4]
    sc = random_scenarios(corpus.GEN_CFG.qp, 3, seed=11, min_seg=1)
    seeds = [(7, 9000, i) for i in range(3)]
    flags_of = lambda b: datagen.certified(corpus.GEN_CFG, b, device="cpu")
    alone, d1 = witness.flag_moves(flags_of, sc, [2], seeds[2:], 4, 8)
    together, d3 = witness.flag_moves(flags_of, sc, [0, 1, 2], seeds, 4, 8)
    assert alone[0] == together[2] and d1[0] == d3[2]


def test_witness_holds_a_draw_against_its_own_batch():
    """A flag that depends on the batch it is computed in (here: on the
    batch's size) does not move under the draws: each draw is held
    against the unmoved row in the same batch."""
    from allocnet_tpu_torch.utils import witness
    from allocnet_tpu_torch.utils.scenarios import random_scenarios
    sc = random_scenarios(corpus.GEN_CFG.qp, 2, seed=3, min_seg=1)
    by_size = lambda b: np.full(len(b.seg), len(b.seg) > 4)
    moves, draws = witness.flag_moves(by_size, sc, [0, 1], [1, 2], 2, 16)
    assert moves.tolist() == [0, 0] and draws.tolist() == [16, 16]
    half = lambda b: b.times[:, 0] > sc.times[0, 0]
    moves, _ = witness.flag_moves(half, sc, [0], [0], 8, 8)
    assert 0 < moves[0] < 8


@pytest.mark.parametrize("a, b, apart", [
    ((False, None, 6), (False, None, 6), False),
    ((False, None, 6), (False, None, 7), True),
    ((True, np.ones((5, 50, 4)), 2), (False, None, 2), True),
    ((True, np.ones((5, 50, 4)), 2), (True, np.ones((5, 50, 4)) + 2e-3, 2),
     True),
    ((True, np.ones((5, 50, 4)), 2), (True, np.ones((5, 50, 4)) + 5e-4, 2),
     False)])
def test_corridors_apart(a, b, apart):
    """Two corridors that both fail are apart only by their polytope
    count; two that hold, by faces beyond the tolerance."""
    from allocnet_tpu_torch.utils import witness
    assert witness.corridors_apart(a, b, 1e-3) == apart


@pytest.mark.parametrize("case", ["card_draws", "parted_corridor"])
def test_card_draws_witness_a_dropped_row(monkeypatch, case):
    """A row the card drops and the CPU keeps in every draw is witnessed
    when the card's own flag moves under the draws there, or when the
    run's corridor of its candidate parts from the CPU's and the CPU's
    moves under draws of the route."""
    checks = _gate_run(monkeypatch, case)
    assert all(v["ok"] for v in checks.values()), checks


@pytest.mark.parametrize("case", ["control", "card_control",
                                  "corridor_control"])
def test_a_small_control_is_not_gated(monkeypatch, case):
    """A control of fewer than CONTROL_MIN_ROWS rows (here one row, moved)
    is reported, not gated: its share says nothing."""
    checks = _gate_run(monkeypatch, case, min_rows=3)
    assert all(v["ok"] for v in checks.values()), checks
    c = checks["witness_control"]
    assert sum(c[k]["moved"] for k in ("cpu", "device", "corridor")) >= 1


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gates_fail_past_their_limits(monkeypatch, case):
    base = _gate_run(monkeypatch, None)
    assert all(v["ok"] for v in base.values()), base
    assert set(base) == set(GATE_CASES.values())
    moved = _gate_run(monkeypatch, case)
    failed = {k for k, v in moved.items() if not v["ok"]}
    assert failed == {GATE_CASES[case]}, moved


@pytest.mark.parametrize("case, kind, i", [("drop_witness", "row", 2),
                                           ("corridor_witness", "candidate",
                                            3)])
def test_a_recorded_difference_passes_only_itself(monkeypatch, case, kind,
                                                  i):
    """A difference no witness covers passes its map where UNWITNESSED
    lists it by seed, request, kind and index, and stays among the map's
    unwitnessed; listed under another index, kind or request it fails."""
    checks = _gate_run(monkeypatch, case,
                       explained={(9000, 5, kind, i): "evidence"})
    assert all(v["ok"] for v in checks.values()), checks
    assert checks["map_9000"]["explained"] == {f"{kind} {i}": "evidence"}
    assert i in checks["map_9000"]["unwitnessed"]
    other = "row" if kind == "candidate" else "candidate"
    for key in ((9000, 5, kind, i + 1), (9000, 6, kind, i),
                (9000, 5, other, i)):
        checks = _gate_run(monkeypatch, case, explained={key: "evidence"})
        assert {k for k, v in checks.items() if not v["ok"]} == \
            {"map_9000"}, (key, checks)


def test_explained_covers_the_record(reference):
    """What of the records the JAX CPU run does not give back is
    explained, so the record gate holds on a whole run."""
    assert set(corpus.record_differences(reference)) <= set(corpus.EXPLAINED)


# ---- (f) the entry point on a cut ----------------------------------------

def test_main_on_the_cpu(tmp_path):
    """fresh on map 9000 at n=64 (the smoke's cut, gated per scenario
    against the record's run of it, every difference witnessed), then
    shards twice (the second generates nothing) and combine."""
    summ = str(tmp_path / "s.json")
    rc = corpus.main(["fresh", "--n", "64", "--max-maps", "1", "--device",
                      "cpu", "--no-heldout", "--out",
                      str(tmp_path / "f.npz"), "--summary", summ])
    with open(summ) as f:
        out = json.load(f)
    assert rc == 0, out["gates"]
    assert set(out["gates"]["checks"]) == {"map_9000", "times",
                                           "witness_control"}
    assert out["maps"][0]["request"] == 64 and out["total"] > 0
    assert out["launches"] == {"k1": 0, "l1": 0}
    assert len(dataset.read_npz(str(tmp_path / "f.npz")).seg) == out["total"]
    args = ["shards", "--out", str(tmp_path / "sh"), "--n", "4",
            "--per-map", "4", "--seed0", "9000", "--device", "cpu",
            "--summary", summ]
    assert corpus.main(args) == 0
    first = json.load(open(summ))
    assert corpus.main(args) == 0
    second = json.load(open(summ))
    # only a map that certified nothing (no shard) runs again
    empty = [e["map"] for e in first["maps"] if not e["samples"]]
    assert [e["map"] for e in second["maps"] if not e.get("resumed")] == empty
    assert second["total"] == first["total"] >= 4
    assert corpus.main(["combine", "--out", str(tmp_path / "c.npz"),
                        str(tmp_path / "sh"), "--device", "cpu",
                        "--summary", summ]) == 0
    assert json.load(open(summ))["n"] == first["total"]


# ---- (g) no card ---------------------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("cmd", [
    ["fresh", "--n", "4"],
    ["shards", "--out", "x", "--n", "4", "--per-map", "4", "--seed0", "9000"],
    ["combine", "--out", "x.npz", "x"]])
def test_without_a_card_the_commands_raise(tmp_path, cmd):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        corpus.main(cmd + ["--summary", str(tmp_path / "s.json")])
    assert not (tmp_path / "s.json").exists()


# ---- (h) what the module imports -----------------------------------------

def test_module_imports_no_jax_nor_h5py():
    tree = ast.parse(open(corpus.__file__).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert not names & {"jax", "jaxlib", "allocnet_tpu", "h5py", "scripts"}
    code = ("import sys; import allocnet_tpu_torch.train.corpus; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'allocnet_tpu', 'h5py')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


# ---- the CLI's .npz / .h5 choice -----------------------------------------

@pytest.mark.parametrize("suffix", [".npz", ".h5"])
def test_cli_dataset_suffix(tmp_path, capsys, suffix):
    """cli datagen writes, and cli eval reads, the format its path's
    suffix names; both hold the same samples."""
    from allocnet_tpu_torch import cli
    from allocnet_tpu_torch.config import AllocNetConfig, QPConfig
    if suffix == ".h5":
        pytest.importorskip("h5py")
    path = str(tmp_path / f"d{suffix}")
    cli.main(["--device", "cpu", "--res", "10", "datagen", "--out", path,
              "--n", "3", "--seed", "5"])
    assert json.loads(capsys.readouterr().out)["samples"] >= 1
    sc = dataset.read_scenarios(path, QPConfig(res=10))
    if suffix == ".npz":
        with np.load(path) as z:
            assert sorted(z.files) == sorted(ScenarioBatch._fields)
    want = datagen.generate(AllocNetConfig(qp=QPConfig(res=10)), 3, seed=5,
                            device="cpu")
    np.testing.assert_array_equal(sc.state, want.state)
    np.testing.assert_allclose(sc.times, want.times, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(sc.seg, want.seg)
    cli.main(["--device", "cpu", "--res", "10", "eval", "--dataset", path,
              "--checkpoint", os.path.join(
                  ROOT, "data", "params", "seq5_tokenthresh0_35.msgpack")])
    rep = json.loads(capsys.readouterr().out)
    assert 0.0 <= rep["success_rate"] <= 1.0
