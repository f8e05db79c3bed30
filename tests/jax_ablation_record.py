"""The JAX package's CPU runs that the port's ablation
(allocnet_tpu_torch/train/ablation.py) is held against, and the port's
CPU runs beside them.

* `curve jax|port ARM SEED OUT.json`: the first STEPS training steps of
  ARM (ablation.ARMS: its script's cfg, net and loss) from scratch at init
  seed SEED (the JAX package's `init_state`; the port's
  `train_step.init_params`), full width, B = 128, on the 2,000 rows of
  data/eval_fresh.npz as a stand-in corpus (Loader seed 0): per step the
  loss fields and its seconds.
* `run-all [--procs P] [--work DIR]`: every arm at seeds 0 and 1 on both
  sides, P single-threaded processes at a time, assembled into JAX_RECORD
  (the JAX runs) and PORT_RECORD (the port's), each run's steps with its
  means over steps 1-10 and 11-40.
* `assemble DIR`: the curve files of DIR into the two records.
* `init-loss jax|port|jax-prefix ARM`: the loss fields (FIELDS: the
  total, the stop or padding term, ...) of the stand-in corpus's first
  batch at ARM's cfg, no update, at init seeds 0-7, each with its mean
  and std.  `jax-prefix` is the JAX package's net under the
  initialization it had before commit cc115fe (flax's kaiming_normal()
  with its default axes, which takes a torch-layout weight's fan-in from
  its output dimension), swapped in for this process only.

    JAX_PLATFORMS=cpu python -m tests.jax_ablation_record run-all

The JAX cfg of each arm is its script's (`scripts/train_big2.py`'s and
`scripts/train_ablation.py`'s module-level cfg; `scripts/mlp_probe.py`
builds its cfg inside its loop, copied into `jax_cfg` with the script's
ARMS losses).
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

from tests.jax_chain_record import (ONE_THREAD, _batches, _jax_cpu,
                                    _stand_in_loader, _windows, port_cfg,
                                    script)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = os.path.join(ROOT, "tests", "records")
JAX_RECORD = os.path.join(RECORDS, "ablation_jax_cpu.json")
PORT_RECORD = os.path.join(RECORDS, "ablation_port_cpu.json")
STEPS = 40
SEEDS = (0, 1)
ARMS = ("lstm_qp_grad", "lstm_supervised", "mlp_qp_grad", "mlp_supervised")
FIELDS = ("obj", "obj1", "objt", "objc", "stop", "success_rate",
          "time_segment_accuracy")


def jax_cfg(arm: str):
    """The arm's script's cfg (JAX package)."""
    if arm == "lstm_qp_grad":
        return script("train_big2").cfg
    if arm == "lstm_supervised":
        return script("train_ablation").cfg
    from allocnet_tpu.config import (AllocNetConfig, ModelConfig, QPConfig,
                                     SolverConfig, TrainConfig)
    loss = script("mlp_probe").ARMS[arm[len("mlp_"):]]
    # scripts/mlp_probe.py:58-65
    return AllocNetConfig(
        qp=QPConfig(res=10, max_vel=5.0, max_acc=7.0),
        solver=SolverConfig(n_chunks=2, iters_per_chunk=100),
        train=TrainConfig(batch_size=128, max_epochs=15,
                          learning_rate=1e-3, t0=3000, t_mult=2,
                          save_freq=5),
        model=ModelConfig(hidden_size=256),
        loss=loss,
    )


def _record(k, bundle, t0):
    rec = {"step": k + 1, **{f: float(getattr(bundle, n)) for f, n in
                             zip(FIELDS, ("total",) + FIELDS[1:])},
           "s": time.perf_counter() - t0}
    print(json.dumps(rec), flush=True)
    return rec


def run_jax(arm: str, seed: int) -> list:
    _jax_cpu()
    import jax
    import jax.numpy as jnp

    from allocnet_tpu.models.networks import ConvLSTMAllocNet, ConvMLPAllocNet
    from allocnet_tpu.train import dataset as ds_lib
    from allocnet_tpu.train import train_step as ts_lib

    cfg = jax_cfg(arm)
    tcfg = dataclasses.replace(cfg.train, seed=seed)
    loader = _stand_in_loader(ds_lib, tcfg.batch_size)
    if arm.startswith("mlp"):
        net = ConvMLPAllocNet(seg=cfg.qp.max_seg, seq_len=cfg.model.seq_len,
                              hidden_size=cfg.model.hidden_size)
    else:
        net = ConvLSTMAllocNet(seq_len=cfg.model.seq_len,
                               hidden_size=cfg.model.hidden_size,
                               token_thresh=cfg.model.token_thresh)
    sample = loader._gather(loader.train_idx[:2])
    ts = ts_lib.init_state(net, tcfg, jnp.asarray(sample.state, jnp.float32),
                           jnp.asarray(sample.hpolys, jnp.float32))
    c = cfg
    step = jax.jit(lambda ts, st, hp, sg, rt: ts_lib.train_step(
        ts, net, tcfg, c.qp, c.solver, c.loss, st, hp, sg, rt,
        token_thresh=c.model.token_thresh))
    out = []
    for k, b in enumerate(_batches(loader, STEPS)):
        t0 = time.perf_counter()
        ts, bundle = step(ts, jnp.asarray(b.state, jnp.float32),
                          jnp.asarray(b.hpolys, jnp.float32),
                          jnp.asarray(b.seg),
                          jnp.asarray(b.ref_times, jnp.float32))
        out.append(_record(k, bundle, t0))
    return out


def run_port(arm: str, seed: int) -> list:
    import torch

    from allocnet_tpu_torch.train import ablation
    from allocnet_tpu_torch.train import dataset as ds_lib
    from allocnet_tpu_torch.train import train_step as ts_lib

    torch.set_num_threads(1)
    cfg = ablation.arm_cfg(arm)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(port_cfg(
        jax_cfg(arm)))
    loader = _stand_in_loader(ds_lib, cfg.train.batch_size)
    torch.manual_seed(seed)
    net = ts_lib.init_params(ablation.net_factory(arm)(cfg), seed)
    opt, sched = ts_lib.make_optimizer(net, cfg.train)
    out = []
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    for k, b in enumerate(_batches(loader, STEPS)):
        t0 = time.perf_counter()
        bundle = ts_lib.train_step(
            net, opt, sched, cfg.qp, cfg.solver, cfg.loss, t(b.state),
            t(b.hpolys), torch.as_tensor(b.seg).long(), t(b.ref_times),
            token_thresh=cfg.model.token_thresh)
        out.append(_record(k, bundle, t0))
    return out


def curve(side: str, arm: str, seed: str, out: str) -> None:
    steps = (run_jax if side == "jax" else run_port)(arm, int(seed))
    with open(out, "w") as f:
        json.dump({"side": side, "arm": arm, "seed": int(seed),
                   "steps": steps}, f)


def assemble(d: str) -> dict:
    recs = {"jax": {}, "port": {}}
    for name in sorted(os.listdir(d)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(d, name)) as f:
            r = json.load(f)
        recs[r["side"]].setdefault(r["arm"], {})[
            f"{r['side']}_{r['seed']}"] = {
            "steps": r["steps"],
            "windows": _windows(r["steps"], ((1, 10), (11, STEPS)))}
    for side, path in (("jax", JAX_RECORD), ("port", PORT_RECORD)):
        with open(path, "w") as f:
            json.dump({"made_by": "tests/jax_ablation_record.py",
                       "corpus": "data/eval_fresh.npz (2,000 rows), Loader "
                                 "seed 0, B=128", "side": side,
                       "curves": recs[side]}, f, indent=1)
    return recs


def run_all(procs: int, work: str) -> dict:
    os.makedirs(work, exist_ok=True)
    jobs = [(side, arm, s) for arm in ARMS for s in SEEDS
            for side in ("jax", "port")]
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=ONE_THREAD,
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    running = []
    while jobs or running:
        while jobs and len(running) < procs:
            side, arm, s = jobs.pop(0)
            out = os.path.join(work, f"{side}_{arm}_{s}.json")
            if os.path.exists(out):
                continue
            log = open(out[:-5] + ".log", "w")
            running.append((subprocess.Popen(
                [sys.executable, "-m", "tests.jax_ablation_record", "curve",
                 side, arm, str(s), out], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT), log, out))
        time.sleep(5)
        for p in [r for r in running if r[0].poll() is not None]:
            running.remove(p)
            p[1].close()
            if p[0].returncode:
                raise SystemExit(f"{p[2]}: exit {p[0].returncode}")
    return assemble(work)


def init_loss(side: str, arm: str) -> dict:
    import numpy as np
    out = []
    if side in ("jax", "jax-prefix"):
        _jax_cpu()
        import jax
        import jax.numpy as jnp

        from allocnet_tpu.models import networks
        from allocnet_tpu.models.networks import (ConvLSTMAllocNet,
                                                  ConvMLPAllocNet)
        if side == "jax-prefix":
            import flax.linen as nn
            networks._torch_linear_init = nn.initializers.kaiming_normal()
            networks._torch_conv_init = nn.initializers.kaiming_normal()
        from allocnet_tpu.train import dataset as ds_lib
        from allocnet_tpu.train import train_step as ts_lib
        cfg = jax_cfg(arm)
        b = next(_stand_in_loader(ds_lib, 128).epoch(0, "train"))
        net = (ConvMLPAllocNet(seg=5, seq_len=5, hidden_size=256)
               if arm.startswith("mlp") else ConvLSTMAllocNet(5, 256, 0.42))
        f = jax.jit(lambda p, *a: ts_lib.loss_fn(
            p, net, cfg.qp, cfg.solver, cfg.loss, *a, 0.42)[1])
        args = (jnp.asarray(b.state, jnp.float32),
                jnp.asarray(b.hpolys, jnp.float32), jnp.asarray(b.seg),
                jnp.asarray(b.ref_times, jnp.float32))
        for s in range(8):
            ts = ts_lib.init_state(net, dataclasses.replace(cfg.train,
                                                            seed=s),
                                   args[0][:1], args[1][:1])
            out.append(f(ts.params, *args))
    else:
        import torch

        from allocnet_tpu_torch.train import ablation
        from allocnet_tpu_torch.train import dataset as ds_lib
        from allocnet_tpu_torch.train import train_step as ts_lib
        torch.set_num_threads(1)
        cfg = ablation.arm_cfg(arm)
        b = next(_stand_in_loader(ds_lib, 128).epoch(0, "train"))
        t = lambda a: torch.as_tensor(a, dtype=torch.float32)
        for s in range(8):
            net = ts_lib.init_params(ablation.net_factory(arm)(cfg), s)
            with torch.no_grad():
                _, bb = ts_lib.loss_fn(
                    net, cfg.qp, cfg.solver, cfg.loss, t(b.state),
                    t(b.hpolys), torch.as_tensor(b.seg).long(),
                    t(b.ref_times), 0.42)
            out.append(bb)
    fields = {f: [float(getattr(b, n)) for b in out] for f, n in
              zip(FIELDS, ("total",) + FIELDS[1:])}
    return {"side": side, "arm": arm, "seeds": list(range(8)),
            "fields": fields,
            "mean": {f: float(np.mean(v)) for f, v in fields.items()},
            "std": {f: float(np.std(v)) for f, v in fields.items()}}


def main(argv):
    cmd = argv[0] if argv else ""
    if cmd == "curve":
        curve(*argv[1:5])
    elif cmd == "run-all":
        procs = int(argv[argv.index("--procs") + 1]) if "--procs" in argv \
            else 6
        work = argv[argv.index("--work") + 1] if "--work" in argv else \
            tempfile.mkdtemp()
        recs = run_all(procs, work)
        print(json.dumps({s: {a: {k: v["windows"] for k, v in r.items()}
                              for a, r in arms.items()}
                          for s, arms in recs.items()}))
    elif cmd == "assemble":
        assemble(argv[1])
    elif cmd == "init-loss":
        print(json.dumps(init_loss(argv[1], argv[2])))
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
