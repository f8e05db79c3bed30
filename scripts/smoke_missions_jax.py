"""Fly chip_smoke.py's missions through the JAX package on the CPU.

chip_smoke.py's `corridor` and `fly` phases plan missions on map 0 of
scripts/drive_eval.py (random_obstacle_map(100), 20 x 20 x 4 m, voxel 0.25
m, dilation 2) with drive_eval's `sample_missions` and fly them with the
10 Hz driver at the deploy point (DEPLOY: res 20, v <= 4, a <= 6) and the
shipped seq5 net.  This script samples the same missions (the same seeds,
the same sampler) and flies them through the JAX package's Driver on the
CPU in float32, printing one JSON line per mission and per seed: the
reference results the card's run is read beside.

    JAX_PLATFORMS=cpu python scripts/smoke_missions_jax.py [seed ...]

With several seeds it reports each; chip_smoke.MISSION_SEED is the one
the smoke flies.
"""

import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from allocnet_tpu.config import AllocNetConfig  # noqa: E402
from allocnet_tpu.models import import_torch  # noqa: E402
from allocnet_tpu.models.networks import ConvLSTMAllocNet  # noqa: E402
from allocnet_tpu.planner import driver as driver_lib  # noqa: E402
from allocnet_tpu.planner import planner as planner_lib  # noqa: E402
from allocnet_tpu.train import datagen  # noqa: E402


def _drive_eval():
    spec = importlib.util.spec_from_file_location(
        "drive_eval", os.path.join(ROOT, "scripts", "drive_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    seeds = [int(s) for s in sys.argv[1:]] or [chip_smoke.MISSION_SEED]
    cfg = AllocNetConfig()
    lo, hi = np.zeros(3), np.asarray(chip_smoke.EXTENT)
    pts = datagen.random_obstacle_map(chip_smoke.MAP_SEED, chip_smoke.EXTENT)
    pmap = planner_lib.build_map(pts, lo, hi, scale=0.25, dilate_r=2)
    params = jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float32),
        import_torch.load_params_msgpack(os.path.join(ROOT, chip_smoke.NET)))
    drv = driver_lib.Driver(ConvLSTMAllocNet(5, 256, token_thresh=0.5),
                            params, cfg, rate_hz=10.0, certify=True)
    sample = _drive_eval().sample_missions
    for seed in seeds:
        rng = np.random.default_rng(seed)
        missions = sample(pmap, cfg, rng, chip_smoke.N_MISSIONS, lo, hi)
        arrived = []
        for k, (start, cp) in enumerate(missions):
            t0 = time.perf_counter()
            st = drv.reset(start, cp.route[-1], cp.hpolys, cp.seg)
            st, res = drv.run(st, chip_smoke.MAX_TICKS, stop_when_done=True,
                              stall_limit=5)
            dist = float(np.linalg.norm(st.pos - st.goal))
            certs = [r.certified for r in res if r.certified is not None]
            arrived.append(bool(st.done) and dist < chip_smoke.ARRIVE_DIST)
            print(json.dumps({
                "seed": seed, "mission": k,
                "start": [round(float(v), 4) for v in start],
                "goal": [round(float(v), 4) for v in cp.route[-1]],
                "seg": int(cp.seg), "n_ticks": len(res),
                "cold_solved": bool(res[0].solved),
                "solved": int(sum(r.solved for r in res)),
                "tracking": int(sum(r.tracking for r in res)),
                "arrived": arrived[-1], "final_dist_m": dist,
                "certified": int(sum(certs)), "accepted": len(certs),
                "wall_s": time.perf_counter() - t0}), flush=True)
        print(json.dumps({"seed": seed, "n_missions": len(missions),
                          "all_arrived": len(missions) ==
                          chip_smoke.N_MISSIONS and all(arrived)}),
              flush=True)


if __name__ == "__main__":
    main()
