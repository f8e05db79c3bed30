"""The JAX package's refinement eval on the CPU: the reference that
allocnet_tpu_torch.planner.refine_eval holds the port's objective
statistics against.

scripts/eval_refine.py's sequence (runs/big3 at threshold 0.42, the net's
times, the solve, 6 steps of refine.refine_times, the solve at the refined
times, at the script's cfg) through the JAX package on the CPU, over the
2,000 scenarios of data/eval_fresh.npz in chunks run by parallel worker
processes (one XLA thread each); the chunks' per-scenario arrays are
summarized with the script's formulas (refine_eval.summarize) into
RECORD, and the flags and objectives are kept in FLAGS.

    JAX_PLATFORMS=cpu python -m tests.jax_refine_record all [--chunk 200] [--procs 10]
    JAX_PLATFORMS=cpu python -m tests.jax_refine_record run OFFSET N OUT.npz
    python -m tests.jax_refine_record assemble CHUNK.npz ...

`all` took about an hour and a half on 8 cores (9 chunks of 200 in
parallel, 5,428 s each).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(ROOT, "tests", "records", "refine_full_jax_cpu.json")
FLAGS = os.path.join(ROOT, "tests", "records", "refine_full_jax_cpu.npz")
ONE_THREAD = ("--xla_cpu_multi_thread_eigen=false "
              "intra_op_parallelism_threads=1")


def run(offset: int, n: int, out: str) -> None:
    """The script's sequence over scenarios [offset, offset + n) as one
    chunk; per-scenario arrays to `out`."""
    import importlib.util

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from allocnet_tpu.models import packing
    from allocnet_tpu.models.networks import ConvLSTMAllocNet
    from allocnet_tpu.ops import admm, qp
    from allocnet_tpu.planner import refine
    from allocnet_tpu.train import train_step as ts_lib
    from allocnet_tpu.train import trainer as trainer_lib

    spec = importlib.util.spec_from_file_location(
        "_script_eval_refine", os.path.join(ROOT, "scripts", "eval_refine.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    cfg = script.cfg
    z = np.load(os.path.join(ROOT, "data", "eval_fresh.npz"))
    sl = slice(offset, offset + n)
    state_np = z["state"][sl].astype(np.float32)
    hpolys_np = z["hpolys"][sl].astype(np.float32)
    S = z["times"].shape[1]
    net = ConvLSTMAllocNet(seq_len=cfg.model.seq_len,
                           hidden_size=cfg.model.hidden_size,
                           token_thresh=cfg.model.token_thresh)
    template = ts_lib.init_state(net, cfg.train, jnp.asarray(state_np[:1]),
                                 jnp.asarray(hpolys_np[:1]))
    path = trainer_lib.latest_checkpoint(
        os.path.join(ROOT, script.WORKDIR, "checkpoints"))
    ts, _ = trainer_lib.restore_checkpoint(path, template)

    @jax.jit
    def net_times(state, hpolys, seg):
        out = net.apply(ts.params, packing.pack_state(state),
                        packing.pack_hpolys(hpolys))
        times = out[0] if isinstance(out, tuple) else out
        m = (jnp.arange(S)[None, :] < seg[:, None]).astype(times.dtype)
        return jnp.where(m > 0, jnp.maximum(times, 0.05), 1.0)

    @jax.jit
    def solve_obj(state, hpolys, seg, times):
        sol = admm.solve_qp(qp.build_qp(cfg.qp, state, hpolys, times, seg),
                            cfg.solver)
        return sol.solved, sol.obj

    state, hpolys = jnp.asarray(state_np), jnp.asarray(hpolys_np)
    seg = jnp.asarray(z["seg"][sl])
    t0 = net_times(state, hpolys, seg)
    solved0, obj0 = solve_obj(state, hpolys, seg, t0)
    res = refine.refine_times(cfg.qp, cfg.solver, state, hpolys, t0, seg,
                              steps=script.STEPS)
    m = (jnp.arange(S)[None, :] < seg[:, None]).astype(t0.dtype)
    solved1, obj1 = solve_obj(state, hpolys, seg, res.times + (1.0 - m))
    np.savez(out, **{k: np.asarray(v) for k, v in (
        ("solved0", solved0), ("solved1", solved1), ("obj0", obj0),
        ("obj1", obj1), ("improved", res.improved),
        ("ts0", jnp.sum(t0 * m, 1)), ("ts1", jnp.sum(res.times * m, 1)),
        ("t1", res.times), ("t0", t0))})


def assemble(paths, chunk: int, seconds: float | None = None) -> dict:
    """The chunks' arrays (in scenario order) summarized as the script
    does, with how they were made; writes RECORD and FLAGS."""
    import jax

    from allocnet_tpu_torch.planner import refine_eval

    parts = [np.load(p) for p in paths]
    acc = {k: np.concatenate([p[k] for p in parts]) for k in
           refine_eval.ACC}
    out = refine_eval.summarize(acc, False, "checkpoint24605.msgpack")
    out.update(platform="cpu", jax=jax.__version__, chunk=chunk,
               made_by="tests/jax_refine_record.py: run per chunk, assemble",
               seconds=seconds)
    os.makedirs(os.path.dirname(RECORD), exist_ok=True)
    with open(RECORD, "w") as f:
        json.dump(out, f, indent=1)
    np.savez(FLAGS, **{k: acc[k] for k in ("solved0", "solved1", "improved",
                                           "obj0", "obj1")})
    return out


def run_all(chunk: int, procs: int, workdir: str) -> dict:
    n = len(np.load(os.path.join(ROOT, "data", "eval_fresh.npz"))["seg"])
    offsets = list(range(0, n, chunk))
    paths = [os.path.join(workdir, f"chunk{o}.npz") for o in offsets]
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=ONE_THREAD,
               PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    pending = list(zip(offsets, paths))
    running = []
    while pending or running:
        while pending and len(running) < procs:
            o, p = pending.pop(0)
            running.append(subprocess.Popen(
                [sys.executable, "-m", "tests.jax_refine_record", "run",
                 str(o), str(min(chunk, n - o)), p], cwd=ROOT, env=env))
        running[0].wait()
        if running[0].returncode:
            raise SystemExit(f"a chunk failed: {running[0].args}")
        running.pop(0)
    return assemble(paths, chunk, time.perf_counter() - t0)


def main(argv):
    if argv[0] == "run":
        run(int(argv[1]), int(argv[2]), argv[3])
    elif argv[0] == "assemble":
        print(json.dumps(assemble(argv[1:], chunk=200)))
    elif argv[0] == "all":
        import argparse
        import tempfile
        ap = argparse.ArgumentParser()
        ap.add_argument("--chunk", type=int, default=200)
        ap.add_argument("--procs", type=int, default=10)
        a = ap.parse_args(argv[1:])
        with tempfile.TemporaryDirectory() as d:
            print(json.dumps(run_all(a.chunk, a.procs, d)))
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
