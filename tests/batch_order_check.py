"""How many certify flags the polish's summation order moves on the CPU.

Two certify batches: the smoke's `datagen` batch (chip_smoke.py's cloud,
crop 0, DATAGEN_N candidates at config.DEPLOY) and map 1030's
(`corpus.generate_map(1030, 250)`), both generated on `--device`, then
certified on the CPU twice: with the polish's matrix-vector products as
the port has them (batched products, whose summation order the batch size
picks) and as elementwise products and sums (one order per scenario,
whatever the batch).  Prints, per batch, the flags kept each way and the
rows that move.

    python -m tests.batch_order_check [--device cpu]
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the polish's four matrix-vector products (ops/admm.py, `polish`)
BMV = {"bnm,bm->bn": lambda A, v: (A * v[:, None, :]).sum(-1),
       "bmn,bn->bm": lambda A, v: (A * v[:, None, :]).sum(-1),
       "bkn,bn->bk": lambda A, v: (A * v[:, None, :]).sum(-1),
       "bmn,bm->bn": lambda A, v: (A * v[:, :, None]).sum(1)}


def batches(device):
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from allocnet_tpu_torch import config
    from allocnet_tpu_torch.train import corpus, datagen
    from allocnet_tpu_torch.utils import pcd

    tiles = [datagen.random_obstacle_map(cs.DATAGEN_SEED + k, cs.EXTENT)
             + np.array([20.0 * (k % 2), 20.0 * (k // 2), 0.0])
             for k in range(4)]
    with tempfile.TemporaryDirectory() as d:
        pcd.write_pcd(os.path.join(d, "cloud.pcd"), np.concatenate(tiles))
        back = pcd.read_pcd(os.path.join(d, "cloud.pcd"))
    crops = pcd.crop_segments(back, extent=cs.DATAGEN_CROP,
                              stride=(10.0, 10.0),
                              min_points=min(len(t) for t in tiles))
    rec, certified = {}, datagen.certified

    def keep(cfg, sc, device=None):
        rec.setdefault("batch", sc)
        return certified(cfg, sc, device)

    datagen.certified = keep
    try:
        datagen.generate(config.DEPLOY, cs.DATAGEN_N,
                         points=crops[0]["points"], extent=cs.DATAGEN_CROP,
                         seed=cs.DATAGEN_SEED, device=device)
    finally:
        datagen.certified = certified
    r = {}
    corpus.generate_map(1030, 250, device=device, record=r)
    return {"datagen": (config.DEPLOY, rec["batch"]),
            "map_1030": (corpus.GEN_CFG, r["batch"])}


def flags(cfg, batch, elementwise: bool):
    from allocnet_tpu_torch.train import datagen

    einsum = torch.einsum

    def patched(eq, *ops):
        if eq in BMV and len(ops) == 2:
            return BMV[eq](*ops)
        return einsum(eq, *ops)

    if elementwise:
        torch.einsum = patched
    try:
        return np.asarray(datagen.certified(cfg, batch, device="cpu"), bool)
    finally:
        torch.einsum = einsum


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    out = {}
    for name, (cfg, batch) in batches(a.device).items():
        f0, f1 = flags(cfg, batch, False), flags(cfg, batch, True)
        out[name] = {"rows": int(len(f0)), "kept_batched": int(f0.sum()),
                     "kept_elementwise": int(f1.sum()),
                     "moved": np.nonzero(f0 != f1)[0].tolist()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
