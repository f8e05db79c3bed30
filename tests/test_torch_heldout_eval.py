"""Port parity: allocnet_tpu_torch.train.heldout_eval, the port of
scripts/eval_big.py and scripts/mcnemar_eval.py (CPU).

The port's evaluate at the scripts' operating point with the runs/big4
checkpoint on the first 256 held-out scenarios of data/eval_fresh.npz,
against allocnet_tpu.train.evaluate, at 1, 2 and 4 polish rounds.  From
the second round on, a polish round keeps a candidate row when its
signed multiplier is positive or its slack is below -1e-7
(`admm.polish`, refine_sel), and a row that the previous round forced
as an equality has a slack of a few float32 ulps of its offset either
way: the two packages' float32 summation orders decide such rows, and
with them some flags and accepted points.  So each scenario's outcome
(its solved flag, and the objective of a point both sides accept) is
held equal, or, where it differs, moves on the JAX side when the
scenario's inputs move by 1e-6 of themselves (the rounding witness),
while most agreeing scenarios do not.

Also: McNemar on the record reproduces runs/mcnemar/results.json, each
arm's net and threshold, the record comparison, the gates and the
entry point."""

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
from allocnet_tpu.train import evaluate as jevaluate
from allocnet_tpu.utils import scenarios as jscenarios
from allocnet_tpu_torch.models import weights
from allocnet_tpu_torch.train import evaluate, heldout_eval
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 256
BIG4 = os.path.join(heldout_eval.RUNS, "big4")
THRESH = {"big3": 0.6, "finetune": 0.5, "big4": 0.42}
CKPT = {"big3": "checkpoint24605.msgpack",
        "finetune": "checkpoint7030.msgpack",
        "big4": "checkpoint24605.msgpack"}
# the rounding witness: each draw moves every entry of a scenario's QP
# inputs (state, corridor, the net's times) by WITNESS_REL of itself, a
# random sign each; batches of WITNESS_ROWS rows go to the scenarios that
# have not moved yet, at most WITNESS_BATCHES of them; one more batch
# is shared among as many scenarios whose outcomes agree (the control)
WITNESS_REL = 1e-6
WITNESS_ROWS = 64
WITNESS_BATCHES = 6
WITNESS_SEED = 7
# two points both sides accept are the same point within this
OBJ_RTOL = 1e-4


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def script():
    return _script("mcnemar_eval")


@pytest.fixture(scope="module")
def held():
    """The first N scenarios, the big4 net on the CPU, and the JAX side's
    parameters and clamped times (what its evaluate hands the QP)."""
    sc = heldout_eval.load_scenarios(n=N)
    net = heldout_eval.load_arm(BIG4, "cpu")
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                           weights.to_jax_params(net.state_dict()))
    jnet = JConvLSTM(seq_len=5, hidden_size=256, token_thresh=THRESH["big4"])
    times = jax.jit(lambda s, h: jnet.apply(
        jparams, jpacking.pack_state(s), jpacking.pack_hpolys(h))[0])(
        jnp.asarray(sc.state, jnp.float32),
        jnp.asarray(sc.hpolys, jnp.float32))
    live = np.arange(5)[None] < sc.seg[:, None]
    tq = np.where(live, np.maximum(np.asarray(times), 0.05), 1.0)
    return sc, net, jnet, jparams, tq.astype(np.float32)


def _outcome_of(jcfg):
    f32 = lambda a: jnp.asarray(a, jnp.float32)

    def run(st, hp, tm, sg):
        sol = jadmm.solve_qp(jqp.build_qp(jcfg.qp, st, hp, tm, sg),
                             jcfg.solver)
        return sol.solved, sol.obj
    run = jax.jit(run)
    return lambda st, hp, tm, sg: tuple(np.asarray(a) for a in run(
        f32(st), f32(hp), f32(tm), jnp.asarray(sg)))


def _moved(solved, obj, ref_solved, ref_obj):
    """Whether an outcome differs from the reference: another solved flag,
    or both solved at points whose objectives differ by more than
    OBJ_RTOL."""
    return (solved != ref_solved) | (solved & ref_solved & (
        np.abs(obj - ref_obj) > OBJ_RTOL * np.abs(ref_obj)))


def _draw(outcome_of, sc, tq, b, rng):
    move = lambda a: a * (1.0 + WITNESS_REL * rng.choice([-1.0, 1.0],
                                                         size=a.shape))
    return outcome_of(move(sc.state[b]), move(sc.hpolys[b]), move(tq[b]),
                      sc.seg[b])


def rounding_witness(outcome_of, sc, tq, idx, ref, rng):
    """(moves, draws) of each scenario idx[i] on the JAX side: draws whose
    outcome differs (`_moved`) from ref = (solved, obj) of idx, out of
    draws made.  Batches go to the scenarios that have not moved yet."""
    moves, draws = np.zeros(len(idx), int), np.zeros(len(idx), int)
    for _ in range(WITNESS_BATCHES):
        pending = np.nonzero(moves == 0)[0]
        if not len(pending):
            break
        rows = np.resize(pending, WITNESS_ROWS)
        solved, obj = _draw(outcome_of, sc, tq, idx[rows], rng)
        np.add.at(draws, rows, 1)
        np.add.at(moves, rows, _moved(solved, obj, ref[0][rows],
                                      ref[1][rows]))
    return moves, draws


def control_moves(outcome_of, sc, tq, idx, ref, rng):
    """Scenarios idx (the same outcome on both sides) whose JAX outcome
    moves in any draw of one witness batch shared among them."""
    rows = np.resize(np.arange(len(idx)), WITNESS_ROWS)
    solved, obj = _draw(outcome_of, sc, tq, idx[rows], rng)
    moved = np.zeros(len(idx), bool)
    np.logical_or.at(moved, rows, _moved(solved, obj, ref[0][rows],
                                         ref[1][rows]))
    return moved


@pytest.mark.parametrize("rounds", [1, 2, 4])
def test_evaluate_matches_jax_at_the_eval_point(held, script, rounds):
    """The port's evaluate at EVAL_CFG (big4, threshold 0.42) against the
    JAX package's at the scripts' BASE, on the first 256 scenarios, with
    `rounds` polish rounds: the net's outputs (pred_seg exactly, t_pred to
    1e-5), the stop-token metrics exactly, certified differing only where
    solved does, and the mean objective over the scenarios both solve at
    the same point to 1e-4.  Every outcome that differs (a solved flag, or
    a point both accept) is witnessed as rounding-decided, and at most
    half of as many agreeing scenarios move under the same witness."""
    sc, net, jnet, jparams, tq = held
    certify = rounds == 4
    solver = dict(polish_rounds=rounds)
    cfg = heldout_eval.arm_config(net.token_thresh)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                              **solver))
    base = script.BASE
    jcfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model,
                                        token_thresh=net.token_thresh),
        solver=dataclasses.replace(base.solver, **solver))
    t0 = time.perf_counter()
    rep, ex = evaluate.evaluate(net, cfg, sc, certify=certify, extras=True,
                                device="cpu")
    t1 = time.perf_counter()
    jrep, jex = jevaluate.evaluate(
        jnet, jparams, jcfg, jscenarios.ScenarioBatch(*sc), certify=certify,
        extras=True)
    t2 = time.perf_counter()
    np.testing.assert_array_equal(ex["pred_seg"], jex["pred_seg"])
    np.testing.assert_allclose(ex["t_pred"], jex["t_pred"], rtol=1e-5)
    np.testing.assert_allclose(ex["t_ref"], jex["t_ref"], rtol=1e-6)
    for name in ("n", "stop_token_accuracy", "time_segment_accuracy"):
        assert getattr(rep, name) == getattr(jrep, name), name
    if certify:
        cdiff = np.nonzero(ex["certified"] != jex["certified"])[0]
        assert set(cdiff) <= set(np.nonzero(ex["solved"]
                                            != jex["solved"])[0]), cdiff
        assert rep.certified_of_solved == jrep.certified_of_solved == 1.0
    moved = _moved(ex["solved"], ex["obj"], jex["solved"], jex["obj"])
    same = ex["solved"] & jex["solved"] & ~moved
    np.testing.assert_allclose(ex["obj"][same].mean(),
                               jex["obj"][same].mean(), rtol=OBJ_RTOL)
    diff = np.nonzero(moved)[0]
    print(f"{rounds} polish rounds: solved port {rep.success_rate:.4f}, JAX "
          f"{jrep.success_rate:.4f}; flags differ on "
          f"{np.nonzero(ex['solved'] != jex['solved'])[0].tolist()}, "
          f"points both accept on {diff.tolist()}; port "
          f"{t1 - t0:.1f} s, JAX {t2 - t1:.1f} s")
    if not len(diff):
        return
    assert len(diff) <= N // 10
    rng = np.random.default_rng(WITNESS_SEED)
    ref = (jex["solved"], jex["obj"])
    outcome_of = _outcome_of(jcfg)
    moves, draws = rounding_witness(outcome_of, sc, tq, diff,
                                    tuple(a[diff] for a in ref), rng)
    print("  witness moves / draws: " + ", ".join(
        f"{b}: {f}/{d}" for b, f, d in zip(diff, moves, draws)))
    assert (moves > 0).all(), diff[moves == 0]
    ctrl = np.sort(rng.choice(np.nonzero(~moved)[0], len(diff),
                              replace=False))
    cmoved = control_moves(outcome_of, sc, tq, ctrl,
                           tuple(a[ctrl] for a in ref), rng)
    print(f"  control scenarios moved: {ctrl[cmoved].tolist()} of "
          f"{len(ctrl)}; witness {time.perf_counter() - t2:.1f} s")
    assert 2 * int(cmoved.sum()) <= len(ctrl)


def test_mcnemar_reproduces_the_record(script):
    """The port's McNemar on the record's per-scenario flags gives
    results.json's mcnemar_solved and mcnemar_certified exactly, and
    equals the script's function on random paired flags."""
    rec = np.load(os.path.join(heldout_eval.RECORD_DIR, "per_scenario.npz"))
    with open(os.path.join(heldout_eval.RECORD_DIR, "results.json")) as f:
        results = json.load(f)
    for k in heldout_eval.FLAGS:
        got = {f"{x}_vs_{y}": heldout_eval.mcnemar(rec[f"{x}_{k}"],
                                                   rec[f"{y}_{k}"])
               for x, y in heldout_eval.PAIRS}
        assert got == results[f"mcnemar_{k}"], k
    rng = np.random.default_rng(0)
    for n in (1, 7, 500):
        a, b = rng.random(n) < 0.6, rng.random(n) < 0.5
        assert heldout_eval.mcnemar(a, b) == script.mcnemar(a, b)


@pytest.mark.parametrize("arm", heldout_eval.ARMS)
def test_load_arm(arm):
    """Each arm's net has its calibrated threshold and exactly the
    parameters the msgpack reader gives for its latest checkpoint."""
    run_dir = os.path.join(heldout_eval.RUNS, arm)
    path = heldout_eval.latest_msgpack(run_dir)
    assert path == os.path.join(run_dir, "checkpoints", CKPT[arm])
    net = heldout_eval.load_arm(run_dir, "cpu")
    assert net.token_thresh == THRESH[arm]
    assert (net.hidden_size, net.seq_len) == (256, 5)
    want = weights.from_jax_params(weights.read_msgpack(path))
    got = net.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_eval_cfg_is_the_scripts_base(script):
    """EVAL_CFG is mcnemar_eval.BASE (and eval_big.cfg), field by field."""
    for base in (script.BASE, _script("eval_big").cfg):
        for part in ("qp", "solver", "model", "train"):
            assert (dataclasses.asdict(getattr(heldout_eval.EVAL_CFG, part))
                    == dataclasses.asdict(getattr(base, part))), part
    assert heldout_eval.ARMS == script.ARMS
    assert heldout_eval.PAIRS == script.PAIRS


def test_compare_record_on_hand_built_flags():
    """Agreement, the one-sided counts and the rate difference, over the
    record's first n; arms the record lacks are left out."""
    t, f = True, False
    record = {"a_solved": np.array([t, t, f, f, t, t]),
              "a_certified": np.array([t, f, f, f, t, t])}
    flags = {"a": {"solved": np.array([t, f, t, f]),
                   "certified": np.array([t, f, f, f])},
             "b": {"solved": np.array([t]), "certified": np.array([t])}}
    got = heldout_eval.compare_record(flags, record)
    assert got == {"a": {
        "solved": {"agreement": 0.5, "only_ours": 1, "only_record": 1,
                   "delta": 0.0},
        "certified": {"agreement": 1.0, "only_ours": 0, "only_record": 0,
                      "delta": 0.0}}}


def test_gates():
    """All four gates over the whole record, and only the success rate
    (against the record's flags on those scenarios) and certified_of_solved
    over a cut."""
    results = {"n": 4, "arms": {"a": {
        "success_rate": 0.5, "stop_token_accuracy": 0.75,
        "mean_time_ratio": 1.25, "certified_of_solved": 1.0}}}
    record = {"a_solved": np.array([True, False, True, False])}
    ok = {"success_rate": 0.51, "stop_token_accuracy": 0.752,
          "mean_time_ratio": 1.25 * (1 + 9e-5), "certified_of_solved": 0.9995}
    g = heldout_eval.gates({"a": ok}, results, record, 4)
    assert g["passed"] and g["over"] == "all"
    assert set(g["arms"]["a"]) == {f for f, _, _ in heldout_eval.GATES}
    for field, bad in (("success_rate", 0.53), ("stop_token_accuracy", 0.747),
                       ("mean_time_ratio", 1.25 * (1 + 2e-4)),
                       ("certified_of_solved", 0.998)):
        g = heldout_eval.gates({"a": dict(ok, **{field: bad})}, results,
                               record, 4)
        assert not g["passed"] and not g["arms"]["a"][field]["ok"], field
    g = heldout_eval.gates({"a": dict(ok, success_rate=1.0)}, results,
                           record, 1)
    assert g["over"] == "first 1" and g["passed"]
    assert set(g["arms"]["a"]) == {"success_rate", "certified_of_solved"}


def test_main_on_the_cpu(tmp_path, capsys):
    """The entry point with --device cpu on the first 8 scenarios, two
    arms: the JSON (results.json's fields, the record comparison, timing
    of the one batch, no kernel launches on the CPU), the flags beside it
    and the last line (everything but arms and timing)."""
    out = tmp_path / "h.json"
    rc = heldout_eval.main(["--arms", "big4,big3", "--n", "8", "--device",
                            "cpu", "--out", str(out)])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    full = json.loads(out.read_text())
    assert rc == (0 if full["gates"]["passed"] else 1)
    assert last == {k: v for k, v in full.items()
                    if k not in ("arms", "timing")}
    assert full["n"] == 8 and set(full["arms"]) == {"big4", "big3"}
    assert set(full["mcnemar_solved"]) == {"big4_vs_big3"}
    assert full["arms"]["big4"]["token_thresh"] == 0.42
    assert full["launches"]["big4"] == {"admm_chunk": 0, "ldl_block": 0}
    assert len(full["timing"]["big3"]["batch_ms"]) == 1
    assert full["device"] == "cpu"
    assert full["checkpoints"]["big4"] == \
        "runs/big4/checkpoints/checkpoint24605.msgpack"
    per = np.load(tmp_path / "h_per_scenario.npz")
    assert sorted(per) == sorted(f"{a}_{k}" for a in ("big4", "big3")
                                 for k in heldout_eval.FLAGS)
    rec = full["record"]["big4"]["solved"]
    assert rec["only_ours"] + rec["only_record"] == round(
        8 * (1 - rec["agreement"]))


def test_entry_point_defaults_to_the_card():
    """Without --device the eval runs on the card, and raises without
    one (nothing falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        heldout_eval.load_arm(BIG4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        heldout_eval.main(["--n", "1"])


def test_no_jax_in_the_module():
    """The eval imports neither JAX nor the JAX package nor scripts/."""
    code = ("import sys; import allocnet_tpu_torch.train.heldout_eval; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'scripts' "
            "or m.startswith(('jax.', 'allocnet_tpu.', 'scripts.')) "
            "or m == 'allocnet_tpu']; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
