"""The JAX package's front-end evals on the CPU: the reference that
allocnet_tpu_torch.planner.frontend_eval holds the port's outcomes against.

Runs, through the JAX package on the CPU at float32 as the scripts run:
scripts/bench_frontend_latency.py's `latency_curve`, `cold_plan` and
`cold_plan_pipelined` (its `main` is not run: it loads the net from a
TorchScript file outside the repository; the net here is
ConvLSTMAllocNet(5, 256, 0.5) with data/params/seq5_tokenthresh0_35_cpu.
msgpack), and scripts/bench_frontend.py's `main` with its output
directory pointed at a temporary one.  The route searches, corridors,
shortcuts and cold ticks those functions make are recorded per scenario
by wrapping the JAX package's module functions for the run.  Every cold
plan's flag is then witnessed: WITNESS_DRAWS draws of its cold tick's
inputs (state and corridor) moved by WITNESS_REL of themselves, a random
sign per entry; `flips` counts the draws whose flag differs.

RECORD keeps outcomes only (found counts, path lengths, rejects, segment
counts, flags), no times: they are this host's, not the card's.

`explain VARIANT` runs the script's `cold_plan` alone under one change of
numerics that the TPU run of the record (`runs/frontend/latency_curve.
json`) had and this CPU run has not, and prints its n_plans, solved_frac
and per-plan flags: `bf16` rounds the operands of every float32 matmul and
convolution outside the JAX package's `default_matmul_precision('float32')`
blocks to bfloat16 (the TPU's default precision), `pallas` solves through
the Pallas ADMM kernel (interpret mode) in place of the XLA scan,
`pallas_bf16` both, `buckets` crops the corridor's point clouds to the
record's buckets (256 / 512 / 1024, before dcefadd).

    JAX_PLATFORMS=cpu python -m tests.jax_frontend_record [OUT.json]
    JAX_PLATFORMS=cpu python -m tests.jax_frontend_record explain VARIANT

About 10 minutes on one CPU core (the 40,000-iteration Informed RRT* arm
runs twice, once in each script); `explain` 1-3 minutes.
"""

import contextlib
import importlib.util
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(ROOT, "tests", "records", "frontend_jax_cpu.json")
NET = os.path.join(ROOT, "data", "params", "seq5_tokenthresh0_35_cpu.msgpack")
WITNESS_REL = 1e-6
WITNESS_DRAWS = 16
WITNESS_SEED = 7


def script(name):
    """scripts/<name>.py as a module (its main is not run)."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def patched(mod, name, wrap):
    """mod.name replaced by wrap(original) inside the block."""
    orig = getattr(mod, name)
    setattr(mod, name, wrap(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def _len(route):
    return (None if route is None else
            float(np.linalg.norm(np.diff(route, axis=0), axis=1).sum()))


def main(out_path=RECORD):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from allocnet_tpu.config import AllocNetConfig
    from allocnet_tpu.models import import_torch
    from allocnet_tpu.models.networks import ConvLSTMAllocNet
    from allocnet_tpu.planner import driver as jdriver
    from allocnet_tpu.planner import planner as jplanner
    from allocnet_tpu.planner import sfc as jsfc

    lat, qual = script("bench_frontend_latency"), script("bench_frontend")
    cfg = AllocNetConfig()
    S = cfg.qp.max_seg
    searches = []          # (use_rrt_star, rrt_max_iter, seed, length,
    #                         [start, goal])
    cuts = []              # (index into searches, polytopes after short_cut)
    corridors = []         # (index into searches, seg, refined goal)
    colds = []             # (index into searches, (state9, hp, seg), solved)
    cold_fns = []

    def rec_search(fn):
        def search(pmap, start, goal, ccfg, seed=0):
            route = fn(pmap, start, goal, ccfg, seed)
            searches.append((bool(ccfg.use_rrt_star), int(ccfg.rrt_max_iter),
                             int(seed), _len(route),
                             [list(map(float, start)), list(map(float, goal))]))
            return route
        return search

    def rec_cut(fn):
        def cut(polys):
            out = fn(polys)
            cuts.append((len(searches) - 1, len(out)))
            return out
        return cut

    def rec_corridor(fn):
        def corridor(*a, **k):
            out = fn(*a, **k)
            corridors.append((len(searches) - 1, int(out[1]),
                              [float(v) for v in out[3]]))
            return out
        return corridor

    def rec_make_cold(fn):
        def make(*a, **k):
            cold = fn(*a, **k)
            cold_fns.append(cold)

            def call(state9, hp, seg):
                out = cold(state9, hp, seg)
                colds.append((len(searches) - 1,
                              tuple(np.asarray(x) for x in (state9, hp, seg)),
                              bool(np.asarray(out[0])[0])))
                return out
            return call
        return make

    net = ConvLSTMAllocNet(seq_len=5, hidden_size=256, token_thresh=0.5)
    params = jax.tree.map(jnp.asarray, import_torch.load_params_msgpack(NET))
    out = {"source": "tests/jax_frontend_record.py", "net": os.path.relpath(
        NET, ROOT), "jax": jax.__version__, "dtype": "float32"}

    def strip(d):
        """A script's output without its wall times."""
        if isinstance(d, dict):
            return {k: strip(v) for k, v in d.items() if "wall" not in k
                    and not k.endswith("_ms_p50") and not k.endswith("_ms_p95")}
        return d

    with patched(jplanner, "search_route", rec_search):
        # 1. the curve
        n0 = len(searches)
        curve = lat.latency_curve(cfg)
        arms = {}
        for use_star, cap, seed, length, se in searches[n0:]:
            name = f"rrt_star_{cap}" if use_star else "rrt"
            arms.setdefault(name, []).append(length)
        out["curve"] = strip(curve)
        out["curve_lengths"] = arms
        out["curve_scenarios"] = [se for *_, se in searches[n0:]][
            ::len(arms)]
        print(json.dumps({"curve": out["curve"]}), flush=True)

        # 2. the quality benchmark, its output to a temporary directory
        n0 = len(searches)
        with tempfile.TemporaryDirectory() as tmp, \
                patched(jsfc, "short_cut", rec_cut):
            qual.OUT = tmp
            qual.main()
            with open(os.path.join(tmp, "results.json")) as f:
                quality = json.load(f)
        per = {"rrt": {"lengths": [], "polys": []},
               "rrt_star": {"lengths": [], "polys": []}}
        polys_of = dict(cuts)
        for i in range(n0, len(searches)):
            use_star, cap, seed, length, _ = searches[i]
            arm = per["rrt_star" if use_star else "rrt"]
            arm["lengths"].append(length)
            arm["polys"].append(polys_of.get(i))
        out["quality"] = strip(quality)
        out["quality_per_scenario"] = per
        print(json.dumps({"quality": out["quality"]}), flush=True)

        # 3. the cold plan, split into path, corridor and net + QP
        n0, c0, d0 = len(searches), len(corridors), len(colds)
        with patched(jsfc, "corridor_online", rec_corridor), \
                patched(jdriver, "make_cold_tick", rec_make_cold):
            cold = lat.cold_plan(cfg, net, params)
        plans = [{"k": k, "route": searches[n0 + k][3] is not None,
                  "scenario": searches[n0 + k][4]}
                 for k in range(len(searches) - n0)]
        for i, seg, goal_r in corridors[c0:]:
            plans[i - n0].update(seg=seg, goal=goal_r)
        for i, inputs, solved in colds[d0:]:
            plans[i - n0].update(solved=solved, inputs=inputs)
        out["cold_plan"] = strip(cold)
        print(json.dumps({"cold_plan": out["cold_plan"]}), flush=True)

        # 4. the pipelined cold plan
        n0, d0 = len(searches), len(colds)
        with patched(jdriver, "make_cold_tick", rec_make_cold):
            piped = lat.cold_plan_pipelined(cfg, net, params)
        for i, _, solved in colds[d0:]:
            plans[i - n0]["pipelined_solved"] = solved
        out["cold_plan_pipelined"] = strip(piped)
        print(json.dumps({"cold_plan_pipelined": out["cold_plan_pipelined"]}),
              flush=True)

    # 5. the witness of every cold plan's flag
    cold = cold_fns[0]
    rng = np.random.default_rng(WITNESS_SEED)
    for p in plans:
        if "inputs" not in p:
            continue
        state9, hp, seg = p.pop("inputs")
        flips = 0
        for _ in range(WITNESS_DRAWS):
            mv = lambda a: (a * (1.0 + WITNESS_REL * rng.choice(
                [-1.0, 1.0], size=a.shape))).astype(np.float32)
            s = bool(np.asarray(cold(jnp.asarray(mv(state9)),
                                     jnp.asarray(mv(hp)),
                                     jnp.asarray(seg))[0])[0])
            flips += s != p["solved"]
        p["flips"] = flips
    out["plans"] = plans
    out["max_seg"] = S
    out["witness"] = {"rel": WITNESS_REL, "draws": WITNESS_DRAWS,
                      "seed": WITNESS_SEED}
    print(json.dumps({"plans": plans}), flush=True)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


def explain(variant: str) -> dict:
    """The script's cold_plan under `variant` (see the module's doc)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from allocnet_tpu.config import AllocNetConfig
    from allocnet_tpu.models import import_torch
    from allocnet_tpu.models.networks import ConvLSTMAllocNet
    from allocnet_tpu.ops import admm as jadmm
    from allocnet_tpu.ops.pallas import admm_tiled
    from allocnet_tpu.planner import driver as jdriver
    from allocnet_tpu.planner import sfc as jsfc

    tiled = []
    if variant in ("pallas", "pallas_bf16"):
        solve = admm_tiled.admm_solve_tiled

        def interpreted(*a, **k):
            tiled.append(1)
            return solve(*a, interpret=True, **k)

        class TPU:
            """`jax` as ops/admm.py sees it, with a TPU backend."""
            def __getattr__(self, name):
                return ((lambda: "tpu") if name == "default_backend"
                        else getattr(jax, name))

        admm_tiled.admm_solve_tiled, jadmm.jax = interpreted, TPU()
    if variant in ("bf16", "pallas_bf16"):
        from jax._src.lax import convolution as lconv
        from jax._src.lax import lax as llax
        dot, conv = llax.dot_general, lconv.conv_general_dilated

        def bf16(fn):
            def op(lhs, rhs, *a, **k):
                if (k.get("precision") is None
                        and jax.config.jax_default_matmul_precision
                        not in ("float32", "highest")):
                    lhs, rhs = (x.astype(jnp.bfloat16).astype(x.dtype)
                                if x.dtype == jnp.float32 else x
                                for x in (lhs, rhs))
                return fn(lhs, rhs, *a, **k)
            return op

        llax.dot_general = bf16(dot)
        lconv.conv_general_dilated = jax.lax.conv_general_dilated = bf16(conv)
    if variant == "buckets":
        def buckets(n, n_max):
            for b in (256, 512, 1024):
                if n <= b and b < n_max:
                    return b
            return n_max
        jsfc._points_bucket = buckets
    flags = []

    def rec_make_cold(fn):
        def make(*a, **k):
            cold = fn(*a, **k)

            def call(*x):
                out = cold(*x)
                flags.append(bool(np.asarray(out[0])[0]))
                return out
            return call
        return make

    net = ConvLSTMAllocNet(seq_len=5, hidden_size=256, token_thresh=0.5)
    params = jax.tree.map(jnp.asarray, import_torch.load_params_msgpack(NET))
    with patched(jdriver, "make_cold_tick", rec_make_cold):
        out = script("bench_frontend_latency").cold_plan(
            AllocNetConfig(), net, params)
    assert variant not in ("pallas", "pallas_bf16") or tiled
    res = {"variant": variant, "n_plans": out["n_plans"],
           "solved_frac": out["solved_frac"], "flags": flags}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    if sys.argv[1:2] == ["explain"]:
        explain(sys.argv[2])
    else:
        main(*sys.argv[1:])
