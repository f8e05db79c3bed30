"""The JAX package's CPU runs that the port's training chain
(allocnet_tpu_torch/train/{refine_targets,train_big,finetune_qp,chain}.py)
is held against, and the port's CPU runs beside them.

* `refine OFFSET N OUT.npz`: scripts/refine_targets.py's refinement
  (its cfg: res 10, v <= 5, a <= 7, CERTIFY_SOLVER; STEPS = 6) of rows
  [OFFSET, OFFSET + N) of data/eval_fresh.npz at their stored times, as
  one batch; per row improved, rel (the script's formula), obj0, obj and
  the refined times.
* `refine-port OFFSET N OUT.npz`: the same through the port on the CPU.
* `refine-all [--procs P]`: rows 0-511 (one chunk of the script's CHUNK)
  in P batches run by parallel worker processes (one XLA thread each),
  assembled into REFINE512 with the script's statistics.
* `refine-script`: the script itself (its `main`) over the first
  SCRIPT_N rows at `--chunk 16` (the last chunk padded), each call of
  `refine.refine_times` kept (its padded inputs' indices and outputs),
  with the script's output arrays and statistics, into REFINE40.
* `curve jax|port SEED|default OUT.json`: the first CURVE_STEPS training
  steps at scripts/train_big3.py's cfg from scratch (init seed SEED; for
  the port `default` keeps PyTorch's own init), B = 128, on the 2,000
  rows of data/eval_fresh.npz as a stand-in corpus (Loader seed 0).
* `finetune jax|port OUT.json`: the first FINETUNE_STEPS steps at
  scripts/finetune_qp.py's cfg from runs/big3's committed checkpoint
  (its params, a fresh Adam and schedule), the same batches.
* `assemble-curves DIR`: the curve and finetune files of DIR into CURVES.
* `row-batch ROW`: the port's plain solve (the refinement's cfg, CPU) of
  `eval_fresh` row ROW at its stored times alone, twice in one batch and
  in its batch of 64: solved, objective, residuals.
* `init-loss jax|port|default`: the loss of the first batch of that
  corpus at train_big3's cfg, no update, at init seeds 0-7 (mean, std).
* `gen-map SEED N OUT`: scripts/gen_dataset.py's map SEED asked for N
  (its cfg and map kind, through tests/jax_corpus_record.py's recording
  run of the same `datagen.generate` call): OUT.json holds the map in
  tests/records/corpus_jax_cpu.json's layout, OUT.npz the certified rows.
* `maps [--work DIR]`: gen-map of each of MAPS (the first pillar map and
  the first two obstacle maps of regen_data.sh's stage 1) at PER_MAP, one
  process each; then on their certified rows (MAPS_ROWS) each shipped
  arm's calibration grid (`calibrate-maps ARM OUT`: scripts/
  calibrate_thresh.py's cfg and GRID, its `evaluate.evaluate` over all the
  rows) and the first FINETUNE_STEPS steps of scripts/finetune_qp.py's cfg
  from runs/big3 with those rows as the corpus (`finetune-maps OUT`), one
  process each; all into MAPS_RECORD.

    JAX_PLATFORMS=cpu python -m tests.jax_chain_record refine-all
    JAX_PLATFORMS=cpu python -m tests.jax_chain_record refine-script
    JAX_PLATFORMS=cpu python -m tests.jax_chain_record curve jax 0 c.json

`refine-all` took 31 min on 8 busy cores (8 processes of 64 rows); a
curve of 40 steps 3-10 min on one or two threads.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = os.path.join(ROOT, "tests", "records")
REFINE512 = os.path.join(RECORDS, "refine_targets_jax_cpu.npz")
REFINE40 = os.path.join(RECORDS, "refine_targets_jax40.npz")
CURVES = os.path.join(RECORDS, "train_chain_cpu.json")
EVAL = os.path.join(ROOT, "data", "eval_fresh.npz")
BIG3 = os.path.join(ROOT, "runs", "big3", "checkpoints",
                    "checkpoint24605.msgpack")
MAPS_RECORD = os.path.join(RECORDS, "chain_maps_jax_cpu.json")
MAPS_ROWS = os.path.join(RECORDS, "chain_maps_jax_cpu.npz")
MAPS, PER_MAP = (1000, 1030, 1031), 250
ARMS = ("big3", "finetune", "big4")
REF_N = 512
SCRIPT_N, SCRIPT_CHUNK = 40, 16
CURVE_STEPS, FINETUNE_STEPS = 40, 10
FIELDS = ("obj", "obj1", "objt", "objc", "stop", "success_rate",
          "time_segment_accuracy")
ONE_THREAD = ("--xla_cpu_multi_thread_eigen=false "
              "intra_op_parallelism_threads=1")


def script(name: str):
    """scripts/<name>.py as a module (it imports the JAX package)."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_cpu():
    import jax
    jax.config.update("jax_platforms", "cpu")
    return jax


def load_eval(n=None) -> dict:
    z = np.load(EVAL)
    return {k: z[k][:n] for k in ("state", "hpolys", "times", "seg")}


def rel_of(obj0, obj1):
    """refine_targets.py's relative reduction (0 where unsolved)."""
    ok = obj0 < 1e29
    return np.where(ok, (obj0 - obj1) / np.maximum(obj0, 1e-9), 0.0)


def refine_rows(offset: int, n: int, out: str) -> None:
    _jax_cpu()
    import jax.numpy as jnp

    from allocnet_tpu.planner import refine

    mod = script("refine_targets")
    z = load_eval(offset + n)
    sl = slice(offset, offset + n)
    args = [jnp.asarray(z[k][sl].astype(np.float32))
            for k in ("state", "hpolys", "times")]
    res = refine.refine_times(mod.cfg.qp, mod.cfg.solver, *args,
                              jnp.asarray(z["seg"][sl]), steps=mod.STEPS)
    obj0, obj = np.asarray(res.obj0), np.asarray(res.obj)
    np.savez(out, improved=np.asarray(res.improved), obj0=obj0, obj=obj,
             rel=rel_of(obj0, obj), times=np.asarray(res.times))


def refine_port(offset: int, n: int, out: str) -> None:
    """The port's refinement of the same rows on the CPU (one thread)."""
    import torch

    from allocnet_tpu_torch.train import refine_targets

    torch.set_num_threads(1)
    sc = refine_targets.read_corpus(EVAL)
    r = refine_targets.refine_rows(sc, np.arange(offset, offset + n),
                                   device="cpu")
    np.savez(out, **r)


def refine_all(procs: int) -> dict:
    per = -(-REF_N // procs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=ONE_THREAD,
               PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        jobs = []
        for o in range(0, REF_N, per):
            p = os.path.join(d, f"rows{o}.npz")
            jobs.append((p, subprocess.Popen(
                [sys.executable, "-m", "tests.jax_chain_record", "refine",
                 str(o), str(min(per, REF_N - o)), p], cwd=ROOT, env=env)))
        for _, j in jobs:
            if j.wait():
                raise SystemExit(f"a batch failed: {j.args}")
        parts = [np.load(p) for p, _ in jobs]
        acc = {k: np.concatenate([q[k] for q in parts]) for k in parts[0]}
    import jax
    mod = script("refine_targets")
    stats = {"n": REF_N, "steps": mod.STEPS,
             "improved_frac": float(acc["improved"].mean()),
             "rel_obj_reduction_mean": float(acc["rel"].mean()),
             "rel_obj_reduction_median": float(np.median(acc["rel"])),
             "batches": len(parts), "rows_per_batch": per,
             "seconds": time.perf_counter() - t0, "jax": jax.__version__,
             "made_by": "tests/jax_chain_record.py refine-all"}
    np.savez(REFINE512, stats=json.dumps(stats), **acc)
    return stats


def refine_script() -> dict:
    """The JAX script's own run over the first SCRIPT_N rows at --chunk
    SCRIPT_CHUNK, every refine_times call recorded."""
    _jax_cpu()
    from allocnet_tpu.planner import refine

    mod = script("refine_targets")
    calls = []
    inner = refine.refine_times

    def recording(cfg, scfg, state, hpolys, times, seg, steps):
        res = inner(cfg, scfg, state, hpolys, times, seg, steps=steps)
        calls.append({"times_in": np.asarray(times),
                      "times": np.asarray(res.times),
                      "improved": np.asarray(res.improved),
                      "obj0": np.asarray(res.obj0),
                      "obj": np.asarray(res.obj)})
        return res

    refine.refine_times = recording
    z = load_eval(SCRIPT_N)
    with tempfile.TemporaryDirectory() as d:
        src, out = os.path.join(d, "in.npz"), os.path.join(d, "out.npz")
        np.savez(src, **z)
        argv = sys.argv
        sys.argv = ["refine_targets.py", "--in", src, "--out", out,
                    "--chunk", str(SCRIPT_CHUNK)]
        try:
            mod.main()
        finally:
            sys.argv, refine.refine_times = argv, inner
        got = np.load(out)
        with open(os.path.join(d, "out_stats.json")) as f:
            stats = json.load(f)
        parts = [np.load(os.path.join(out + ".parts", f"chunk_{c:05d}.npz"))
                 for c in range(len(calls))]
        rec = {"out_" + k: got[k] for k in ("state", "hpolys", "times",
                                             "seg")}
        for c, (call, part) in enumerate(zip(calls, parts)):
            rec.update({f"call{c}_{k}": v for k, v in call.items()})
            rec.update({f"part{c}_{k}": part[k] for k in part.files})
    np.savez(REFINE40, stats=json.dumps(stats), chunk=SCRIPT_CHUNK,
             calls=len(calls), **rec)
    return stats


def _windows(steps: list, bounds=((1, 10), (11, 40))) -> dict:
    return {f"{a}-{b}": {k: float(np.mean([s[k] for s in steps
                                           if a <= s["step"] <= b]))
                         for k in FIELDS} for a, b in bounds
            if any(a <= s["step"] <= b for s in steps)}


def _stand_in_loader(ds_lib, batch_size, path=EVAL):
    z = np.load(path)
    from allocnet_tpu_torch.utils.scenarios import ScenarioBatch
    sc = ScenarioBatch(*(z[k] for k in ("state", "hpolys", "times", "seg")))
    return ds_lib.Loader(sc, batch_size=batch_size, seed=0)


def _batches(loader, n):
    out, epoch = [], 0
    while len(out) < n:
        out += list(loader.epoch(epoch, "train"))
        epoch += 1
    return out[:n]


def run_jax(cfg, n_steps, params_from=None, seed=0, corpus=EVAL) -> list:
    _jax_cpu()
    import jax
    import jax.numpy as jnp

    from allocnet_tpu.models.networks import ConvLSTMAllocNet
    from allocnet_tpu.train import dataset as ds_lib
    from allocnet_tpu.train import train_step as ts_lib
    from allocnet_tpu.train import trainer as trainer_lib

    tcfg = dataclasses.replace(cfg.train, seed=seed)
    loader = _stand_in_loader(ds_lib, tcfg.batch_size, corpus)
    net = ConvLSTMAllocNet(seq_len=cfg.model.seq_len,
                           hidden_size=cfg.model.hidden_size,
                           token_thresh=cfg.model.token_thresh)
    sample = loader._gather(loader.train_idx[:2])
    ts = ts_lib.init_state(net, tcfg, jnp.asarray(sample.state, jnp.float32),
                           jnp.asarray(sample.hpolys, jnp.float32))
    if params_from is not None:
        restored, _ = trainer_lib.restore_checkpoint(params_from, ts)
        ts = ts._replace(params=restored.params)
    c = cfg
    step = jax.jit(lambda ts, st, hp, sg, rt: ts_lib.train_step(
        ts, net, tcfg, c.qp, c.solver, c.loss, st, hp, sg, rt,
        token_thresh=c.model.token_thresh))
    out = []
    for k, b in enumerate(_batches(loader, n_steps)):
        t0 = time.perf_counter()
        ts, bundle = step(ts, jnp.asarray(b.state, jnp.float32),
                          jnp.asarray(b.hpolys, jnp.float32),
                          jnp.asarray(b.seg),
                          jnp.asarray(b.ref_times, jnp.float32))
        rec = {"step": k + 1, **{f: float(getattr(bundle, n)) for f, n in
                                 zip(FIELDS, ("total",) + FIELDS[1:])},
               "s": time.perf_counter() - t0}
        out.append(rec)
        print(json.dumps(rec), flush=True)
    return out


def run_port(cfg, n_steps, params_from=None, seed=0, init="jax") -> list:
    import torch

    from allocnet_tpu_torch.models import weights
    from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
    from allocnet_tpu_torch.train import dataset as ds_lib
    from allocnet_tpu_torch.train import train_step as ts_lib

    torch.set_num_threads(1)
    loader = _stand_in_loader(ds_lib, cfg.train.batch_size)
    torch.manual_seed(seed)
    net = ConvLSTMAllocNet(cfg.model.seq_len, cfg.model.hidden_size,
                           cfg.model.token_thresh)
    if init == "jax":
        ts_lib.init_params(net, seed)
    if params_from is not None:
        net.load_state_dict(weights.load_params(params_from))
    opt, sched = ts_lib.make_optimizer(net, cfg.train)
    out = []
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    for k, b in enumerate(_batches(loader, n_steps)):
        t0 = time.perf_counter()
        bundle = ts_lib.train_step(
            net, opt, sched, cfg.qp, cfg.solver, cfg.loss, t(b.state),
            t(b.hpolys), torch.as_tensor(b.seg).long(), t(b.ref_times),
            token_thresh=cfg.model.token_thresh)
        rec = {"step": k + 1, **{f: float(getattr(bundle, n)) for f, n in
                                 zip(FIELDS, ("total",) + FIELDS[1:])},
               "s": time.perf_counter() - t0}
        out.append(rec)
        print(json.dumps(rec), flush=True)
    return out


def port_cfg(jcfg):
    """The port's AllocNetConfig with the fields of a JAX one."""
    from allocnet_tpu_torch import config as pc
    parts = {f.name: getattr(pc, type(getattr(jcfg, f.name)).__name__)(
        **dataclasses.asdict(getattr(jcfg, f.name)))
        for f in dataclasses.fields(jcfg)}
    return pc.AllocNetConfig(**parts)


def curve(side: str, seed: str, out: str) -> None:
    cfg = script("train_big3").cfg
    if side == "jax":
        steps = run_jax(cfg, CURVE_STEPS, seed=int(seed))
    else:
        steps = run_port(port_cfg(cfg), CURVE_STEPS,
                         seed=0 if seed == "default" else int(seed),
                         init="default" if seed == "default" else "jax")
    with open(out, "w") as f:
        json.dump({"side": side, "seed": seed, "steps": steps}, f)


def finetune(side: str, out: str) -> None:
    cfg = script("finetune_qp").cfg
    if side == "jax":
        steps = run_jax(cfg, FINETUNE_STEPS, params_from=BIG3)
    else:
        steps = run_port(port_cfg(cfg), FINETUNE_STEPS, params_from=BIG3)
    with open(out, "w") as f:
        json.dump({"side": side, "steps": steps}, f)


def assemble_curves(d: str) -> dict:
    out = {"corpus": "data/eval_fresh.npz (2,000 rows), Loader seed 0, "
                     "B=128", "made_by": "tests/jax_chain_record.py",
           "curves": {}, "finetune": {}}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            r = json.load(f)
        key = os.path.splitext(name)[0]
        kind = "finetune" if key.startswith("finetune") else "curves"
        out[kind][key] = {"steps": r["steps"], "windows": _windows(
            r["steps"], ((1, 10),) if kind == "finetune" else
            ((1, 10), (11, 40)))}
    with open(CURVES, "w") as f:
        json.dump(out, f, indent=1)
    return out


def init_loss(side: str) -> dict:
    cfg = script("train_big3").cfg
    out = []
    if side == "jax":
        _jax_cpu()
        import jax.numpy as jnp

        from allocnet_tpu.models.networks import ConvLSTMAllocNet
        from allocnet_tpu.train import dataset as ds_lib
        from allocnet_tpu.train import train_step as ts_lib
        b = next(_stand_in_loader(ds_lib, 128).epoch(0, "train"))
        net = ConvLSTMAllocNet(5, 256, 0.42)
        import jax
        f = jax.jit(lambda p, *a: ts_lib.loss_fn(
            p, net, cfg.qp, cfg.solver, cfg.loss, *a, 0.42)[1])
        args = (jnp.asarray(b.state, jnp.float32),
                jnp.asarray(b.hpolys, jnp.float32), jnp.asarray(b.seg),
                jnp.asarray(b.ref_times, jnp.float32))
        for s in range(8):
            ts = ts_lib.init_state(net, dataclasses.replace(cfg.train,
                                                            seed=s),
                                   args[0][:1], args[1][:1])
            out.append(float(f(ts.params, *args).total))
    else:
        import torch

        from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
        from allocnet_tpu_torch.train import dataset as ds_lib
        from allocnet_tpu_torch.train import train_step as ts_lib
        torch.set_num_threads(1)
        pc = port_cfg(cfg)
        b = next(_stand_in_loader(ds_lib, 128).epoch(0, "train"))
        t = lambda a: torch.as_tensor(a, dtype=torch.float32)
        for s in range(8):
            torch.manual_seed(s)
            net = ConvLSTMAllocNet(5, 256, 0.42)
            if side == "port":
                ts_lib.init_params(net, s)
            with torch.no_grad():
                _, bb = ts_lib.loss_fn(
                    net, pc.qp, pc.solver, pc.loss, t(b.state),
                    t(b.hpolys), torch.as_tensor(b.seg).long(),
                    t(b.ref_times), 0.42)
            out.append(float(bb.total))
    return {"side": side, "loss": out, "mean": float(np.mean(out)),
            "std": float(np.std(out))}


def row_batch(row: int) -> list:
    import torch

    from allocnet_tpu_torch.ops import admm, qp
    from allocnet_tpu_torch.train import refine_targets

    torch.set_num_threads(1)
    cfg = refine_targets.CFG
    sc = refine_targets.read_corpus(EVAL)
    out = []
    for idx in (np.array([row]), np.array([row, row]),
                np.arange(row - row % 64, row - row % 64 + 64)):
        t = lambda a: torch.as_tensor(a[idx])
        sol = admm.solve_qp(qp.build_qp(
            cfg.qp, t(sc.state), t(sc.hpolys), t(sc.times),
            torch.as_tensor(sc.seg[idx]).long(), device="cpu"), cfg.solver)
        k = int(np.nonzero(idx == row)[0][0])
        out.append({"batch": int(len(idx)), "solved": bool(sol.solved[k]),
                    "obj": float(sol.obj[k]),
                    "pri_res": float(sol.pri_res[k]),
                    "dua_res": float(sol.dua_res[k])})
    return out


def calibrate_maps(arm: str, out: str) -> dict:
    """scripts/calibrate_thresh.py's grid of runs/<arm>'s latest
    checkpoint over every row of MAPS_ROWS: per threshold the report and
    the rows left unsolved."""
    _jax_cpu()
    import jax.numpy as jnp

    from allocnet_tpu.models.networks import ConvLSTMAllocNet
    from allocnet_tpu.train import evaluate
    from allocnet_tpu.train import train_step as ts_lib
    from allocnet_tpu.train import trainer as trainer_lib
    from allocnet_tpu.utils.scenarios import ScenarioBatch

    mod = script("calibrate_thresh")
    z = np.load(MAPS_ROWS)
    sc = ScenarioBatch(*(z[k] for k in ("state", "hpolys", "times", "seg")))
    path = trainer_lib.latest_checkpoint(os.path.join(ROOT, "runs", arm,
                                                      "checkpoints"))
    rows = []
    for th in mod.GRID:
        ecfg = dataclasses.replace(mod.cfg, model=dataclasses.replace(
            mod.cfg.model, token_thresh=th))
        net = ConvLSTMAllocNet(seq_len=ecfg.model.seq_len,
                               hidden_size=ecfg.model.hidden_size,
                               token_thresh=th)
        ts, _ = trainer_lib.restore_checkpoint(path, ts_lib.init_state(
            net, ecfg.train, jnp.asarray(sc.state[:1], jnp.float32),
            jnp.asarray(sc.hpolys[:1], jnp.float32)))
        rep, ex = evaluate.evaluate(net, ts.params, ecfg, sc, extras=True)
        rows.append(dict(rep._asdict(), token_thresh=th,
                         unsolved=np.nonzero(~np.asarray(ex["solved"], bool))
                         [0].tolist()))
        print(json.dumps({k: v for k, v in rows[-1].items()
                          if k != "unsolved"}), flush=True)
    out_rec = {"arm": arm, "checkpoint": os.path.basename(path),
               "grid": rows}
    with open(out, "w") as f:
        json.dump(out_rec, f)
    return out_rec


def finetune_maps(out: str) -> None:
    steps = run_jax(script("finetune_qp").cfg, FINETUNE_STEPS,
                    params_from=BIG3, corpus=MAPS_ROWS)
    with open(out, "w") as f:
        json.dump({"side": "jax", "steps": steps}, f)


def maps_run(work: str) -> dict:
    os.makedirs(work, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=ONE_THREAD,
               PYTHONPATH=ROOT)
    run = lambda jobs: [p.wait() for p in [subprocess.Popen(
        [sys.executable, "-m", "tests.jax_chain_record"] + j, cwd=ROOT,
        env=env) for j in jobs]]
    path = lambda m: os.path.join(work, f"map_{m}")
    t0 = time.perf_counter()
    if any(run([["gen-map", str(m), str(PER_MAP), path(m)] for m in MAPS
                if not os.path.exists(path(m) + ".json")])):
        raise SystemExit("a map process failed")
    maps, parts = [], []
    for m in MAPS:
        with open(path(m) + ".json") as f:
            maps.append(json.load(f))
        parts.append(np.load(path(m) + ".npz"))
    np.savez_compressed(MAPS_ROWS, **{k: np.concatenate([p[k] for p in parts])
                                      for k in ("state", "hpolys", "times",
                                                "seg")})
    gen_s = time.perf_counter() - t0
    jobs = [["calibrate-maps", a, os.path.join(work, f"cal_{a}.json")]
            for a in ARMS] + [["finetune-maps",
                               os.path.join(work, "finetune.json")]]
    if any(run([j for j in jobs if not os.path.exists(j[-1])])):
        raise SystemExit("an evaluation process failed")
    cal = {}
    for a in ARMS:
        with open(os.path.join(work, f"cal_{a}.json")) as f:
            cal[a] = json.load(f)
    with open(os.path.join(work, "finetune.json")) as f:
        ft = json.load(f)["steps"]
    rec = {"made_by": "tests/jax_chain_record.py maps", "per_map": PER_MAP,
           "rows": os.path.relpath(MAPS_ROWS, ROOT),
           "full": {"maps": maps}, "smoke": {"maps": []},
           "calibration": cal,
           "finetune": {"steps": ft, "windows": _windows(ft, ((1, 10),))},
           "seconds": {"maps": gen_s, "all": time.perf_counter() - t0}}
    with open(MAPS_RECORD, "w") as f:
        json.dump(rec, f)
    return {"maps": [(m["seed"], m["kind"], m["certified"]) for m in maps],
            "calibration": {a: [[r["token_thresh"], r["stop_token_accuracy"],
                                 r["success_rate"]] for r in c["grid"]]
                            for a, c in cal.items()},
            "finetune": rec["finetune"]["windows"], "seconds": rec["seconds"]}


def gen_map(seed: int, n: int, out: str) -> dict:
    _jax_cpu()
    from allocnet_tpu.train import datagen as dg

    from tests import jax_corpus_record as jcr

    got, gen = [], dg.generate

    def keep(*a, **k):
        got.append(gen(*a, **k))
        return got[-1]

    dg.generate = keep
    try:
        (rec,) = jcr.run_script(n, seed, first_only=True)
    finally:
        dg.generate = gen
    sc = got[0]
    np.savez_compressed(out + ".npz", state=sc.state, hpolys=sc.hpolys,
                        times=sc.times, seg=sc.seg)
    with open(out + ".json", "w") as f:
        json.dump(rec, f)
    return {k: rec[k] for k in ("seed", "kind", "request", "certified")}


def main(argv):
    cmd = argv[0] if argv else ""
    if cmd == "refine":
        refine_rows(int(argv[1]), int(argv[2]), argv[3])
    elif cmd == "refine-port":
        refine_port(int(argv[1]), int(argv[2]), argv[3])
    elif cmd == "refine-all":
        procs = int(argv[argv.index("--procs") + 1]) if "--procs" in argv \
            else 8
        print(json.dumps(refine_all(procs)))
    elif cmd == "refine-script":
        print(json.dumps(refine_script()))
    elif cmd == "curve":
        curve(argv[1], argv[2], argv[3])
    elif cmd == "finetune":
        finetune(argv[1], argv[2])
    elif cmd == "row-batch":
        print(json.dumps(row_batch(int(argv[1]))))
    elif cmd == "maps":
        work = argv[argv.index("--work") + 1] if "--work" in argv else \
            tempfile.mkdtemp()
        print(json.dumps(maps_run(work)))
    elif cmd == "calibrate-maps":
        calibrate_maps(argv[1], argv[2])
    elif cmd == "finetune-maps":
        finetune_maps(argv[1])
    elif cmd == "gen-map":
        print(json.dumps(gen_map(int(argv[1]), int(argv[2]), argv[3])))
    elif cmd == "init-loss":
        print(json.dumps(init_loss(argv[1])))
    elif cmd == "assemble-curves":
        print(json.dumps({k: v["windows"] for k, v in
                          assemble_curves(argv[1])["curves"].items()}))
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
