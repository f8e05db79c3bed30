"""Port parity, the front end's latency and quality evals:
allocnet_tpu_torch.planner.frontend_eval against scripts/
bench_frontend_latency.py, scripts/bench_frontend.py and the JAX package,
on the CPU.

The scenario streams against the script's; the curve's route searches and
the quality run's corridor rejects against the JAX package's on a few
scenarios of map 200; three cold plans of map 211 through the port's and
the JAX package's cold tick on the same corridor inputs; the pipelined
plan against the split one; the CLI on a cut; the gates on hand-made
outcomes; the JAX CPU reference (tests/records/frontend_jax_cpu.json,
tests/jax_frontend_record.py) against the records of runs/frontend."""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allocnet_tpu.config import AllocNetConfig as JAllocNetConfig
from allocnet_tpu.config import QPConfig as JQPConfig
from allocnet_tpu.models import import_torch as jimport_torch
from allocnet_tpu.models.networks import ConvLSTMAllocNet as JConvLSTMAllocNet
from allocnet_tpu.planner import driver as jdriver
from allocnet_tpu.planner import planner as jplanner
from allocnet_tpu.planner import sfc as jsfc
from allocnet_tpu_torch import config
from allocnet_tpu_torch.config import AllocNetConfig, CorridorConfig
from allocnet_tpu_torch.planner import driver, frontend_eval as fe
from tests import native_runtime
from tests.oracle import qp_oracle
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CURVE_PAIRS = 4
QUALITY_PAIRS = 3
COLD_PAIRS = 3
COLD_PLANS = 3
# one f32 cold tick from one input (tests/test_torch_driver.py's bars):
# the net's times to 1e-4 relative, the coefficients to 1e-3 of the
# largest, or else each side against the f64 KKT-certified oracle, the
# port within 1e-3 of it and the nearer of the two
TIME_RTOL = 1e-4
COEF_TOL = 1e-3


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference():
    with open(fe.REFERENCE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def script():
    if not native_runtime.ensure_loaded():
        pytest.skip("g++ is not installed: no JAX native runtime")
    return _script("bench_frontend_latency")


@pytest.mark.parametrize("map_seed", [200, 210])
def test_scenario_stream_matches_the_script(script, map_seed):
    """(a) the same starts and goals as the script's stream, in order."""
    want = [(s, g) for _, s, g in script.scenario_stream([map_seed], 10)]
    got = [(s, g) for _, s, g in fe.scenario_stream([map_seed], 10,
                                                    device="cpu")]
    assert len(got) == len(want) == 10
    for (s, g), (js, jg) in zip(got, want):
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(g, jg)


@pytest.fixture(scope="module")
def curve(script):
    """The port's curve on the first CURVE_PAIRS scenarios of map 200 at
    arms up to 2,500 iterations, and the JAX package's search_route on the
    same scenarios and arms."""
    out, _ = fe.latency_curve(config.DEPLOY, (200,), CURVE_PAIRS, 2500,
                              device="cpu")
    jcfg = JAllocNetConfig()
    want = {}
    for k, (pmap, s, g) in enumerate(script.scenario_stream([200],
                                                            CURVE_PAIRS)):
        for arm, ccfg in fe.curve_arms(config.DEPLOY, 2500).items():
            jc = dataclasses.replace(jcfg.corridor,
                                     use_rrt_star=ccfg.use_rrt_star,
                                     rrt_max_iter=ccfg.rrt_max_iter)
            r = jplanner.search_route(pmap, s, g, jc, seed=k)
            want.setdefault(arm, []).append(
                None if r is None else script.path_len(r))
    return out, want


@pytest.mark.parametrize("arm", ["rrt", "rrt_star_1000", "rrt_star_2500"])
def test_curve_matches_jax_search_route(curve, arm):
    """(b) per arm: the same routes found, path lengths to fe.LEN_RTOL."""
    out, want = curve
    assert out["ks"] == list(range(CURVE_PAIRS))
    got = out["lengths"][arm]
    assert [v is None for v in got] == [v is None for v in want[arm]]
    assert out["arms"][arm]["found"] == sum(v is not None for v in want[arm])
    for a, b in zip(got, want[arm]):
        if b is not None:
            assert abs(a - b) <= fe.LEN_RTOL * b


@pytest.fixture(scope="module")
def quality_fresh(script):
    return fe.quality(fe.QUALITY_CFG, (200,), QUALITY_PAIRS, device="cpu")


def test_quality_rejects_match_jax(script, quality_fresh):
    """(c) both front ends on the first QUALITY_PAIRS scenarios of map
    200: the same routes and, through convex_cover + short_cut, the same
    polytope counts and rejects as the JAX package (bench_frontend.py's
    loop)."""
    jcfg = JAllocNetConfig(qp=JQPConfig(res=10))
    q = quality_fresh
    for k, (pmap, s, g) in enumerate(script.scenario_stream(
            [200], QUALITY_PAIRS)):
        for f, use_star in (("rrt", False), ("rrt_star", True)):
            jc = dataclasses.replace(
                jcfg.corridor, use_rrt_star=use_star,
                rrt_max_iter=fe.STAR_ITERS if use_star
                else jcfg.corridor.rrt_max_iter)
            r = jplanner.search_route(pmap, s, g, jc, seed=k)
            if r is None:
                assert q["lengths"][f][k] is None
                continue
            assert abs(q["lengths"][f][k] - script.path_len(r)) <= (
                fe.LEN_RTOL * script.path_len(r))
            n = len(jsfc.short_cut(jsfc.convex_cover(
                r, pmap.surf, pmap.lo, pmap.hi, jc)))
            assert q["polys"][f][k] == n, (f, k)
    for f in ("rrt", "rrt_star"):
        assert q[f]["long_corridor_rejects"] == sum(
            n is not None and n > 5 for n in q["polys"][f])


def test_quality_reuses_the_curve_routes(quality_fresh):
    """(c) the quality run on the curve's rrt and rrt_star_40000 routes
    gives what its own search gives; routes of another configuration are
    refused."""
    _, routes = fe.latency_curve(config.DEPLOY, (200,), QUALITY_PAIRS,
                                 device="cpu")
    q = fe.quality(fe.QUALITY_CFG, (200,), QUALITY_PAIRS, routes,
                   device="cpu")
    assert q["reused_curve_routes"]
    for key in ("ks", "lengths", "polys"):
        assert q[key] == quality_fresh[key], key
    for f in ("rrt", "rrt_star"):
        assert q[f]["long_corridor_rejects"] == (
            quality_fresh[f]["long_corridor_rejects"])
    other = AllocNetConfig(corridor=CorridorConfig(rrt_step=0.5))
    with pytest.raises(AssertionError):
        fe.quality(other, (200,), QUALITY_PAIRS, routes, device="cpu")


@pytest.fixture(scope="module")
def cold_plans(reference):
    """The cold plans of the first COLD_PAIRS scenarios of maps 210 and
    211 that the JAX CPU run kept (the online search finds no route in the
    first 3 of map 210; 3 plans of map 211): the port's phases on the CPU
    (route, corridor, cold tick), then the JAX package's cold tick on the
    same inputs."""
    ks = [p["k"] for p in reference["plans"] if "solved" in p
          and p["k"] % fe.PER_MAP < COLD_PAIRS]
    assert len(ks) == COLD_PLANS
    net = fe.load_net("cpu")
    cold = driver.make_cold_tick(net, config.DEPLOY, None)
    jcold = jdriver.make_cold_tick(
        JConvLSTMAllocNet(5, 256, token_thresh=0.5), JAllocNetConfig(),
        jax.tree.map(jnp.asarray, jimport_torch.load_params_msgpack(fe.NET)))
    rows = []
    for k, pmap, s, g in fe._stream(fe.COLD_MAPS, COLD_PAIRS, "cpu"):
        if k not in ks:
            continue
        _, hp, seg, goal_r, solved, out = fe._plan_phases(
            pmap, s, g, k, config.DEPLOY, cold, torch.device("cpu"))
        args = (fe._state9(s, goal_r), hp.astype(np.float32)[None],
                np.asarray([seg]))
        jout = jax.tree.map(np.asarray, jcold(*(jnp.asarray(a)
                                                for a in args)))
        rows.append((k, args, solved, out, jout))
    return ks, rows


@pytest.mark.parametrize("i", range(COLD_PLANS))
def test_cold_plan_matches_jax_cold_tick(cold_plans, reference, i):
    """(d) one cold plan: the same solved flag as the JAX cold tick on the
    same corridor inputs and as the JAX CPU run's record; times to
    TIME_RTOL; coefficients to COEF_TOL of the largest, or else the port
    the nearer of the two to the f64 oracle and within COEF_TOL of it."""
    _, rows = cold_plans
    k, (state9, hp, seg), solved, out, jout = rows[i]
    plan = next(p for p in reference["plans"] if p["k"] == k)
    assert plan["seg"] == int(seg[0])
    assert solved == bool(jout[0][0]) == plan["solved"]
    t, jt = out[2].numpy(), jout[2]
    np.testing.assert_allclose(t, jt, rtol=TIME_RTOL, atol=0)
    c, jc = out[1].numpy(), jout[1]
    scale = max(1.0, float(np.abs(jc).max()))
    if solved and float(np.abs(c - jc).max()) > COEF_TOL * scale:
        L = int(seg[0])
        ora = qp_oracle.solve_scenario(
            config.DEPLOY.qp, state9[0].astype(np.float64),
            hp[0].astype(np.float64), t[0].astype(np.float64), L)
        assert ora["kkt"] < 1e-7
        port = float(np.abs(c[0, :L] - ora["coeffs"]).max())
        assert port <= COEF_TOL * scale
        assert port < float(np.abs(jc[0, :L] - ora["coeffs"]).max())


def test_pipelined_plan_agrees_with_cold_plan(cold_plans, reference):
    """(e) cold_plan and cold_plan_pipelined on the first COLD_PAIRS
    scenarios of maps 210 and 211 keep the same plans with the same flags,
    which are the JAX CPU run's and the cold_plans fixture's."""
    ks, rows = cold_plans
    split = fe.cold_plan(config.DEPLOY, None, None, fe.COLD_MAPS,
                         COLD_PAIRS, device="cpu")
    piped = fe.cold_plan_pipelined(config.DEPLOY, None, None, fe.COLD_MAPS,
                                   COLD_PAIRS, device="cpu")
    run = [p["k"] for p in split["plans"]]
    assert run == [p["k"] for p in piped["plans"]] == [0, 1, 2, 10, 11, 12]
    ref = {p["k"]: p.get("solved") for p in reference["plans"]}
    assert ([p["solved"] for p in split["plans"]]
            == [p["solved"] for p in piped["plans"]] == [ref[k] for k in run])
    assert {k: s for k, _, s, _, _ in rows} == {
        p["k"]: p["solved"] for p in split["plans"] if p["k"] in ks}
    assert split["trace"] is None
    assert split["n_plans"] == piped["n_plans"] == len(ks) - 1
    assert all(p[ph] > 0 for p in split["plans"] if p["solved"] is not None
               for ph in fe.PHASES)


@pytest.mark.parametrize("argv, checks", [
    (["--maps", "1", "--pairs", "2", "--max-cap", "1000"],
     ["curve_scenarios", "curve_rrt", "curve_rrt_star_1000", "quality_rrt",
      "quality_rrt_star", "cold_plans_kept", "cold_plan_flags",
      "corridors_vs_cpu", "pipelined_flags"]),
    (["--cold-only", "--maps", "1", "--pairs", "8"],
     ["cold_plans_kept", "cold_plan_flags", "corridors_vs_cpu",
      "pipelined_flags"])], ids=["curve_and_quality", "cold_only"])
def test_cli_on_a_cut_applies_the_cut_gates(tmp_path, reference, argv,
                                            checks):
    """(f) `--device cpu` on a cut (map 200 / 210, the first pairs of
    each, arms up to 1,000 iterations; or the cold plans alone): exit 0;
    the gates that a cut allows, scenario by scenario, all hold; the
    record gate is left out."""
    out_path = str(tmp_path / "frontend.json")
    rc = fe.main(["--device", "cpu", *argv, "--out", out_path])
    with open(out_path) as f:
        out = json.load(f)
    assert rc == 0 and out["gates"]["passed"] and not out["whole"]
    assert sorted(out["gates"]["checks"]) == sorted(checks)
    pairs = int(argv[argv.index("--pairs") + 1])
    assert [p["k"] for p in out["cold_plan"]["plans"]] == list(range(pairs))
    kept = [p["k"] for p in reference["plans"]
            if "solved" in p and p["k"] < pairs]
    assert out["gates"]["checks"]["cold_plans_kept"]["kept"] == kept
    if "--cold-only" in argv:
        assert out["curve"] is None and out["quality"] is None
        assert len(kept) == 2
    else:
        assert list(out["curve"]["arms"]) == ["rrt", "rrt_star_1000"]
        assert not out["quality"]["reused_curve_routes"]
        assert out["curve"]["ks"] == out["quality"]["ks"] == [0, 1]


@pytest.mark.parametrize("k, moves", [(10, 0), (16, fe.CORRIDOR_DRAWS)])
def test_corridor_witness(k, moves):
    """The corridor witness on the CPU: plan 16's corridor (a gap plan,
    whose corridor on the card had another face count than on the CPU)
    moves in every draw of its route moved by 1e-6 of itself; plan 10's
    in none."""
    pmap, s, g = next((p, s, g) for i, p, s, g in fe._stream(
        fe.COLD_MAPS, k % fe.PER_MAP + 1, "cpu") if i == k)
    route = fe.planner.search_route(pmap, s, g,
                                    config.DEPLOY.corridor.online(),
                                    seed=fe.COLD_SEED0 + k)
    assert fe.corridor_moves(pmap, route, k, config.DEPLOY) == moves


def _cold_out(flags):
    return {"cold_plan": {"plans": [{"k": k, "solved": s}
                                    for k, s in flags.items()]}}


@pytest.mark.parametrize("case", ["equal", "witnessed", "unwitnessed",
                                  "two_witnessed", "kept", "length",
                                  "corridor_witnessed",
                                  "corridor_unwitnessed",
                                  "two_corridors_witnessed"])
def test_gates_on_hand_made_outcomes(reference, case):
    """The gates: a flag may part from the JAX CPU run's only where the
    record's witness flipped it, on at most one plan; the kept plans must
    be the same; a path length may not move by 1e-5 relative; a card
    corridor may part from the CPU's only where the CPU's moves under
    the witness's draws, on at most one plan."""
    ref = json.loads(json.dumps(reference))
    plans = {p["k"]: p for p in ref["plans"]}
    flags = {k: p.get("solved") for k, p in plans.items()}
    kept = [k for k, s in flags.items() if s is not None]
    a, b = kept[0], kept[1]
    for k in (a, b):
        plans[k]["flips"] = 0
    want = case in ("equal", "witnessed")
    if case in ("witnessed", "two_witnessed"):
        plans[a]["flips"] = 3
        flags[a] = not flags[a]
    if case == "two_witnessed":
        plans[b]["flips"] = 5
        flags[b] = not flags[b]
    if case == "unwitnessed":
        flags[a] = not flags[a]
    if case == "kept":
        flags[a] = None
    out = _cold_out(flags)
    if case.startswith(("corridor", "two_corridors")):
        by_k = {p["k"]: p for p in out["cold_plan"]["plans"]}
        for k in kept:
            by_k[k]["corridor_vs_cpu"] = 1e-7
        by_k[a].update(corridor_vs_cpu=None, corridor_moves=(
            0 if case == "corridor_unwitnessed" else 6))
        if case == "two_corridors_witnessed":
            by_k[b].update(corridor_vs_cpu=2e-3, corridor_moves=1)
        want = case == "corridor_witnessed"
    if case == "length":
        lens = {arm: list(v) for arm, v in ref["curve_lengths"].items()}
        k = next(i for i, v in enumerate(lens["rrt"]) if v is not None)
        lens["rrt"][k] *= 1 + 1e-5
        out = {"curve": {"ks": list(range(len(lens["rrt"]))),
                         "scenarios": ref["curve_scenarios"],
                         "lengths": lens,
                         "arms": {arm: {"found": 0} for arm in lens}}}
        want = False
    assert fe.gates(out, ref)["passed"] == want


def test_reference_against_its_records_and_itself(reference):
    """The JAX CPU reference: every outcome the TPU records hold is equal
    or explained (fe.EXPLAINED); its per-scenario arrays give its own
    aggregates (found per arm, common_found, rejects, n_plans)."""
    ref = reference
    assert all(d in fe.EXPLAINED for d in fe.record_differences(ref))
    lens = ref["curve_lengths"]
    assert all(len(v) == ref["curve"]["n_scenarios"] for v in lens.values())
    for arm, v in lens.items():
        assert ref["curve"]["arms"][arm]["found"] == sum(
            x is not None for x in v)
    common = [all(lens[a][i] is not None for a in lens)
              for i in range(ref["curve"]["n_scenarios"])]
    assert ref["curve"]["common_found"] == sum(common)
    for f, v in ref["quality_per_scenario"].items():
        assert ref["quality"][f]["found"] == sum(x is not None
                                                 for x in v["lengths"])
        assert ref["quality"][f]["long_corridor_rejects"] == sum(
            n is not None and n > ref["max_seg"] for n in v["polys"])
        assert v["lengths"] == lens["rrt" if f == "rrt" else
                                    f"rrt_star_{fe.STAR_ITERS}"]
    kept = [p for p in ref["plans"] if "solved" in p]
    assert ref["cold_plan"]["n_plans"] == len(kept) - 1
    assert all(p["pipelined_solved"] == p["solved"] for p in kept)
    assert ref["cold_plan_pipelined"]["n_plans"] == len(kept) - 1
