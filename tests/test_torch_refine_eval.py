"""Port parity: allocnet_tpu_torch.planner.refine_eval, the port of
scripts/eval_refine.py (CPU).

The port's net times and one chunk of the eval at the script's operating
point (big3 at ModelConfig's threshold 0.42, CERTIFY_SOLVER, 6 refinement
steps) on the first 32 held-out scenarios of data/eval_fresh.npz, against
the same sequence built from the JAX package as the script runs it.  The
chunk takes ten solves at 6 polish rounds, whose rounding-decided polish
rows (tests/test_torch_heldout_eval.py), and seven implicit gradients,
whose active set is a threshold too, so float32 summation order can part
the two packages on a scenario, and the refinement's steps carry a
parting on.  Each scenario's outcome (its two solved flags, its improved
flag, the two objectives where both sides solve, the refined times) is
held equal, or, where it differs, witnessed as rounding-decided: it moves
when the port runs the scenario alone (in a batch of one, whose batched
products sum in another order), or else on the JAX side when the
scenario's QP inputs move by 1e-6 of themselves; each witness moves at
most half of as many agreeing scenarios.

Also: the script's summary formulas, the gates, the configuration, the
net and its threshold, and the entry point."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allocnet_tpu.models import packing as jpacking
from allocnet_tpu.models.networks import ConvLSTMAllocNet as JConvLSTM
from allocnet_tpu.ops import admm as jadmm
from allocnet_tpu.ops import qp as jqp
from allocnet_tpu.planner import refine as jrefine
from allocnet_tpu_torch.models import weights
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.planner import refine_eval
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 32
S = 5
# the net's times on both sides (float32, the same weights; the network
# tests hold the net to this)
NET_ATOL = 1e-5
# two objectives or refined allocations both sides reach are the same
# within this (float32 through a QP of condition ~1e4, as the held-out
# eval's test holds its objectives)
OBJ_RTOL = 1e-4
TIMES_RTOL = 1e-4
# the rounding witness of a scenario whose outcome differs: first the
# port runs it alone (a batch of one: other summation orders in the
# batched products) and its outcome moves from the port's own; for
# ALONE_CONTROLS agreeing scenarios alone, at most half move.  Where the
# port alone does not move, the JAX side does when every entry of the
# scenario's QP inputs (state, corridor, the net's times) moves by
# WITNESS_REL of itself, a random sign each: batches of WITNESS_ROWS rows
# (the chunk's shape, so the JAX sequence compiles once), one row for
# each of as many agreeing scenarios (the control), the rest shared among
# the scenarios that have not moved; at most WITNESS_BATCHES
WITNESS_REL = 1e-6
WITNESS_ROWS = N
WITNESS_BATCHES = 2
WITNESS_SEED = 7
ALONE_CONTROLS = 3
FLAGS = ("solved0", "solved1", "improved")


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "_script_eval_refine", os.path.join(ROOT, "scripts", "eval_refine.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def held():
    """The first N scenarios, the port's net on the CPU, and the JAX net
    with the same parameters."""
    state, hpolys, seg = refine_eval.read_scenarios(False, N)
    net = refine_eval.load_net("cpu")
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                           weights.to_jax_params(net.state_dict()))
    jnet = JConvLSTM(seq_len=5, hidden_size=256, token_thresh=0.42)
    return (state.astype(np.float32), hpolys.astype(np.float32), seg), net, \
        jnet, jparams


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _jax_sequence(script, jnet, jparams):
    """(net_times, chunk) of the JAX package as scripts/eval_refine.py
    runs them: chunk(state, hpolys, seg, t0) gives the per-scenario
    arrays of refine_eval.run_chunk from the net's times t0."""
    cfg = script.cfg

    @jax.jit
    def net_times(state, hpolys, seg):
        out = jnet.apply(jparams, jpacking.pack_state(state),
                         jpacking.pack_hpolys(hpolys))
        times = out[0] if isinstance(out, tuple) else out
        seg_mask = (jnp.arange(S)[None, :] < seg[:, None]).astype(times.dtype)
        return jnp.where(seg_mask > 0, jnp.maximum(times, 0.05), 1.0)

    @jax.jit
    def solve_obj(state, hpolys, seg, times):
        sol = jadmm.solve_qp(jqp.build_qp(cfg.qp, state, hpolys, times, seg),
                             cfg.solver)
        return sol.solved, sol.obj

    def chunk(state, hpolys, seg, t0):
        f32 = lambda a: jnp.asarray(a, jnp.float32)
        state, hpolys, t0, seg = f32(state), f32(hpolys), f32(t0), \
            jnp.asarray(seg)
        solved0, obj0 = solve_obj(state, hpolys, seg, t0)
        res = jrefine.refine_times(cfg.qp, cfg.solver, state, hpolys, t0, seg,
                                   steps=script.STEPS)
        seg_mask = (jnp.arange(S)[None, :] < seg[:, None]).astype(t0.dtype)
        solved1, obj1 = solve_obj(state, hpolys, seg,
                                  res.times + (1.0 - seg_mask))
        return {k: np.asarray(v) for k, v in (
            ("solved0", solved0), ("solved1", solved1), ("obj0", obj0),
            ("obj1", obj1), ("improved", res.improved),
            ("ts0", jnp.sum(t0 * seg_mask, axis=1)),
            ("ts1", jnp.sum(res.times * seg_mask, axis=1)),
            ("t1", res.times))}

    return (lambda st, hp, sg: np.asarray(net_times(
        jnp.asarray(st), jnp.asarray(hp), jnp.asarray(sg)))), chunk


def _moved(got, ref):
    """Per scenario, whether an outcome differs from the reference: a flag,
    an objective where both solved (OBJ_RTOL), or the refined times
    (TIMES_RTOL of the scenario's largest)."""
    moved = np.zeros(len(ref["solved0"]), bool)
    for k in FLAGS:
        moved |= got[k] != ref[k]
    for k, s in (("obj0", "solved0"), ("obj1", "solved1")):
        both = got[s] & ref[s]
        moved |= both & (np.abs(got[k] - ref[k]) > OBJ_RTOL * np.abs(ref[k]))
    scale = np.abs(ref["t1"]).max(1)
    moved |= np.abs(got["t1"] - ref["t1"]).max(1) > TIMES_RTOL * scale
    return moved


def test_load_net_is_big3_at_the_default_threshold(script):
    """The net is runs/big3's latest checkpoint at ModelConfig's 0.42 (not
    big3's calibrated 0.6), with exactly the msgpack reader's
    parameters."""
    path = refine_eval.latest_msgpack(refine_eval.WORKDIR)
    assert os.path.basename(path) == "checkpoint24605.msgpack"
    assert path.startswith(os.path.join(ROOT, script.WORKDIR))
    net = refine_eval.load_net("cpu")
    assert net.token_thresh == script.cfg.model.token_thresh == 0.42
    assert (net.hidden_size, net.seq_len) == (256, 5)
    want = weights.from_jax_params(weights.read_msgpack(path))
    got = net.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_cfg_is_the_scripts(script):
    """CFG is the script's cfg field by field; the steps and the chunk
    are its own."""
    for part in ("qp", "solver", "model", "train"):
        assert (dataclasses.asdict(getattr(refine_eval.CFG, part))
                == dataclasses.asdict(getattr(script.cfg, part))), part
    assert refine_eval.STEPS == script.STEPS == 6
    assert refine_eval.CHUNK == 500


def test_net_times_match_jax(held, script):
    """(a) net_times on the first 32 scenarios equals the JAX net's clamped
    times to NET_ATOL.  Over all 2,000, threshold 0.6 (big3's calibrated
    one) gives other times on some scenario: at 0.42 a stop token fires
    on a live step, the net zeroes that time and net_times clamps it to
    0.05, where at 0.6 the net keeps its own time."""
    (state, hpolys, seg), net, jnet, jparams = held
    jnet_times, _ = _jax_sequence(script, jnet, jparams)
    args = (_t(state), _t(hpolys), _t(seg, torch.long))
    got = refine_eval.net_times(net, *args).numpy()
    want = jnet_times(state, hpolys, seg)
    np.testing.assert_allclose(got, want, rtol=0, atol=NET_ATOL)
    st, hp, sg = refine_eval.read_scenarios(False)
    args = (_t(st), _t(hp), _t(sg, torch.long))
    net6 = ConvLSTMAllocNet(5, 256, 0.6)
    net6.load_state_dict(net.state_dict())
    got = refine_eval.net_times(net, *args).numpy()
    got6 = refine_eval.net_times(net6.eval(), *args).numpy()
    differ = np.abs(got6 - got) > 1e-3
    assert differ.any(), "threshold 0.6 gives the same times as 0.42"
    assert (got[differ] == 0.05).all() and (got6[differ] > 0.05).all()


def test_run_chunk_matches_jax(held, script):
    """(b) run_chunk at the script's point against the JAX package's
    sequence on the same 32 scenarios: per scenario equal solved and
    improved flags, objectives (where both sides solve) and refined times
    within OBJ_RTOL / TIMES_RTOL; every scenario that differs is
    witnessed as rounding-decided: its outcome moves when the port runs
    it alone, or on the JAX side when its inputs move by WITNESS_REL; each
    witness moves at most half of its agreeing controls."""
    (state, hpolys, seg), net, jnet, jparams = held
    jnet_times, jchunk = _jax_sequence(script, jnet, jparams)
    t0 = time.perf_counter()
    got, _ = refine_eval.run_chunk(net, _t(state), _t(hpolys),
                                   _t(seg, torch.long))
    t1 = time.perf_counter()
    jt0 = jnet_times(state, hpolys, seg)
    ref = jchunk(state, hpolys, seg, jt0)
    t2 = time.perf_counter()
    m = np.arange(S)[None, :] < seg[:, None]
    np.testing.assert_allclose(got["ts0"], ref["ts0"], rtol=1e-5)
    # fixed total: the refined allocation keeps the net's total
    np.testing.assert_allclose(got["ts1"], got["ts0"], rtol=1e-6)
    assert (got["t1"][~m] == 0).all()
    moved = _moved(got, ref)
    diff = np.nonzero(moved)[0]
    print(f"port {t1 - t0:.1f} s, JAX {t2 - t1:.1f} s; outcomes differ on "
          f"{diff.tolist()} (flags: " + ", ".join(
              f"{k} {np.nonzero(got[k] != ref[k])[0].tolist()}"
              for k in FLAGS) + ")")
    assert len(diff) <= N // 4
    if not len(diff):
        return
    rng = np.random.default_rng(WITNESS_SEED)
    agree = np.nonzero(~moved)[0]

    # the port alone on each scenario (a batch of one takes other
    # summation orders in its batched products), against its own outcome
    def alone(idx):
        runs = [refine_eval.run_chunk(net, _t(state[[i]]), _t(hpolys[[i]]),
                                      _t(seg[[i]], torch.long))[0]
                for i in idx]
        out = {k: np.concatenate([r[k] for r in runs]) for k in runs[0]}
        return _moved(out, {k: v[idx] for k, v in got.items()})

    by_port = alone(diff)
    actrl = np.sort(rng.choice(agree, min(len(diff), ALONE_CONTROLS),
                               replace=False))
    amoved = alone(actrl)
    t3 = time.perf_counter()
    print(f"  the port alone moves {diff[by_port].tolist()} of {diff.tolist()}"
          f", control {actrl[amoved].tolist()} of {actrl.tolist()} "
          f"({t3 - t2:.1f} s)")
    assert 2 * int(amoved.sum()) <= len(actrl)
    pending = diff[~by_port]
    if not len(pending):
        return

    # the JAX side under input moves, the rest of the witness
    ctrl = np.sort(rng.choice(agree, len(pending), replace=False))
    move = lambda a: a * (1.0 + WITNESS_REL * rng.choice([-1.0, 1.0],
                                                         size=a.shape))
    moves = np.zeros(len(pending), int)
    draws = np.zeros(len(pending), int)
    cmoved = None
    for _ in range(WITNESS_BATCHES):
        left = np.nonzero(moves == 0)[0]
        if not len(left):
            break
        n_ctrl = len(ctrl) if cmoved is None else 0
        rows = np.resize(left, WITNESS_ROWS - n_ctrl)
        b = np.concatenate([pending[rows], ctrl[:n_ctrl]])
        out = jchunk(move(state[b]), move(hpolys[b]), seg[b], move(jt0[b]))
        mv = _moved(out, {k: v[b] for k, v in ref.items()})
        np.add.at(draws, rows, 1)
        np.add.at(moves, rows, mv[:len(rows)])
        if cmoved is None:
            cmoved = mv[len(rows):]
    print("  JAX witness moves / draws: " + ", ".join(
        f"{i}: {f}/{d}" for i, f, d in zip(pending, moves, draws))
        + f"; control scenarios moved {ctrl[cmoved].tolist()} of "
        f"{len(ctrl)} ({time.perf_counter() - t3:.1f} s)")
    assert (moves > 0).all(), pending[moves == 0]
    assert 2 * int(cmoved.sum()) <= len(ctrl)


def test_summarize_is_the_scripts_formulas():
    """(c) summarize on hand-built arrays gives the script's record, key
    for key and in its order (scripts/eval_refine.py:109-127)."""
    rng = np.random.default_rng(3)
    n = 41
    acc = {"solved0": rng.random(n) < 0.8, "solved1": rng.random(n) < 0.85,
           "obj0": rng.uniform(0.01, 2.0, n).astype(np.float32),
           "obj1": rng.uniform(0.01, 2.0, n).astype(np.float32),
           "improved": rng.random(n) < 0.7,
           "ts0": rng.uniform(2.0, 9.0, n).astype(np.float32)}
    acc["ts1"] = (acc["ts0"] * (1 + rng.uniform(-1e-7, 1e-7, n))).astype(
        np.float32)
    got = refine_eval.summarize(acc, False, "checkpoint7.msgpack")
    solved0, solved1, obj0, obj1, improved, tsum0, tsum1 = (
        acc[k] for k in refine_eval.ACC)
    both = solved0 & solved1
    rel = (obj0[both] - obj1[both]) / np.maximum(obj0[both], 1e-9)
    want = {
        "n": n, "steps": 6, "subset": False,
        "checkpoint": "checkpoint7.msgpack",
        "success_rate_net": float(solved0.mean()),
        "success_rate_refined": float(solved1.mean()),
        "n_both_solved": int(both.sum()),
        "improved_frac": float(improved[both].mean()),
        "rel_obj_reduction_mean": float(rel.mean()),
        "rel_obj_reduction_median": float(np.median(rel)),
        "rel_obj_reduction_p90": float(np.percentile(rel, 90)),
        "total_time_max_rel_drift": float(
            np.max(np.abs(tsum1 - tsum0)[solved0] / tsum0[solved0])),
    }
    assert list(got) == list(want)
    assert got == want
    record, _ = _records()
    assert list(record) == list(want)


def _records():
    with open(refine_eval.RECORD) as f:
        record = json.load(f)
    with open(refine_eval.REFERENCE) as f:
        reference = json.load(f)
    return record, reference


def test_gates_on_the_records():
    """(d) Every gate passes on the record's and the reference's own
    fields and fails on one moved past its limit; over a cut, and over the
    subset, only the drift gate applies."""
    record, reference = _records()
    theirs = {f: (record if a == "record" else reference)[f]
              for f, _, _, a in refine_eval.GATES}
    own = dict(record, **theirs)
    g = refine_eval.gates(own, record, reference)
    assert g["passed"] and g["over"] == "all"
    assert list(g["fields"]) == [f for f, _, _, _ in refine_eval.GATES]
    for field, limit, kind, against in refine_eval.GATES:
        assert g["fields"][field][against] == theirs[field]
        for sign in ((1,) if kind == "max" else (1, -1)):
            bad = (limit * 1.01 if kind == "max"
                   else theirs[field] + sign * limit * 1.01)
            g = refine_eval.gates(dict(own, **{field: bad}), record, reference)
            assert not g["passed"] and not g["fields"][field]["ok"], field
            assert sum(not v["ok"] for v in g["fields"].values()) == 1
        if kind == "abs":
            inside = dict(own, **{field: theirs[field] + 0.99 * limit})
            assert refine_eval.gates(inside, record, reference)["passed"]
    for cut in (dict(own, n=8), dict(own, subset=True)):
        cut.update(success_rate_net=0.0, improved_frac=0.0)
        g = refine_eval.gates(cut, record, reference)
        assert g["over"] == f"first {cut['n']}" and g["passed"]
        assert list(g["fields"]) == ["total_time_max_rel_drift"]
        g = refine_eval.gates(dict(cut, total_time_max_rel_drift=2e-6),
                              record, reference)
        assert not g["passed"]


def test_reference_is_its_flags_summarized():
    """The JAX package's CPU reference (tests/jax_refine_record.py) over
    the 2,000: its fields are the script's formulas on its own
    per-scenario flags and objectives, the record's keys lead it, and its
    success rates lie within their gates of the record's."""
    record, reference = _records()
    z = np.load(refine_eval.REFERENCE_FLAGS)
    acc = {k: z[k] for k in ("solved0", "solved1", "obj0", "obj1",
                             "improved")}
    acc["ts0"] = acc["ts1"] = np.ones(len(acc["solved0"]), np.float32)
    got = refine_eval.summarize(acc, False, reference["checkpoint"])
    assert list(reference)[:len(record)] == list(record)
    for k, v in got.items():
        if k != "total_time_max_rel_drift":
            assert reference[k] == v, k
    assert reference["n"] == 2000 and reference["platform"] == "cpu"
    for f, limit, _, against in refine_eval.GATES:
        if against == "record" and f.startswith("success"):
            assert abs(reference[f] - record[f]) <= limit, f


def test_main_on_the_cpu(tmp_path, capsys):
    """(e) The entry point with --device cpu on the first 8 scenarios: the
    JSON has the script's fields in its order, then one chunk's timing
    and launches (none on the CPU), the device and the cut's gate; the
    last line is everything but the chunks; exit 0."""
    out = tmp_path / "r.json"
    rc = refine_eval.main(["--device", "cpu", "--n", "8", "--out", str(out)])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    full = json.loads(out.read_text())
    with open(refine_eval.RECORD) as f:
        keys = list(json.load(f))
    assert rc == 0
    assert list(full)[:len(keys)] == keys
    assert last == {k: v for k, v in full.items() if k != "chunks"}
    assert full["n"] == 8 and full["subset"] is False
    assert full["checkpoint"] == "checkpoint24605.msgpack"
    assert full["device"] == "cpu" and full["warmup_s"] is None
    (ch,) = full["chunks"]
    assert ch["scenarios"] == 8
    assert ch["launches"] == {"admm_chunk": 0, "ldl_block": 0}
    assert ch["wall_s"] == pytest.approx(sum(ch[k] for k in (
        "net_s", "solve0_s", "refine_s", "solve1_s")))
    assert full["record"] == "runs/refine/results_full.json"
    assert full["reference"] == "tests/records/refine_full_jax_cpu.json"
    assert full["gates"]["over"] == "first 8" and full["gates"]["passed"]
    assert set(full["flags_agree"]) == {"solved0", "solved1", "improved"}


def test_entry_point_defaults_to_the_card():
    """(f) Without --device the eval runs on the card, and raises without
    one (nothing falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        refine_eval.load_net()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        refine_eval.main(["--n", "1"])


def test_no_jax_in_the_module():
    """(g) The eval imports neither JAX nor the JAX package nor
    scripts/."""
    code = ("import sys; import allocnet_tpu_torch.planner.refine_eval; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'scripts' "
            "or m.startswith(('jax.', 'allocnet_tpu.', 'scripts.')) "
            "or m == 'allocnet_tpu']; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
