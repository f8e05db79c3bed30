"""HDF5 scenario dataset (the reference's layout), a synthetic generator and
the shuffled batch loader.

Port of `allocnet_tpu/train/dataset.py`: the same numpy RNG calls, so both
packages yield the same batches from the same scenarios and seed.  The
reference layout (datasets.py:9-42) is one group `idx_{i}` per sample
holding stacked_state (9, 2), stacked_hpolys (50, 4, L) and traj_times (L,),
padded to seq_len on read.  `h5py` is imported inside the functions that
read or write files: a machine without it (the card's, for one) can still
train from scenarios kept in memory.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, NamedTuple

import numpy as np

from allocnet_tpu_torch.config import QPConfig
from allocnet_tpu_torch.utils.scenarios import ScenarioBatch, random_scenarios


class Batch(NamedTuple):
    state: np.ndarray      # (B, 2, 3, 3)
    hpolys: np.ndarray     # (B, S, F, 4)
    seg: np.ndarray        # (B,)
    ref_times: np.ndarray  # (B, S)


def write_h5(path: str, sc: ScenarioBatch) -> None:
    """Write scenarios in the reference's group-per-sample layout."""
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        for i in range(sc.state.shape[0]):
            g = f.create_group(f"idx_{i}")
            L = int(sc.seg[i])
            g.create_dataset("stacked_state", data=sc.state[i].reshape(2, 9).T)
            g.create_dataset("stacked_hpolys",
                             data=sc.hpolys[i, :L].transpose(1, 2, 0))
            g.create_dataset("traj_times", data=sc.times[i, :L])


def read_h5(path: str, cfg: QPConfig,
            seq_len: int | None = None) -> ScenarioBatch:
    """Read a whole file into padded scenario arrays (the reference's read
    and padding, datasets.py:25-42)."""
    import h5py

    S = seq_len or cfg.max_seg
    F = cfg.max_faces
    with h5py.File(path, "r") as f:
        n = len(f.keys())
        state = np.zeros((n, 2, 3, 3))
        hpolys = np.zeros((n, S, F, 4))
        times = np.zeros((n, S))
        seg = np.zeros((n,), np.int32)
        for i in range(n):
            g = f[f"idx_{i}"]
            state[i] = np.asarray(g["stacked_state"]).T.reshape(2, 3, 3)
            hp = np.asarray(g["stacked_hpolys"])           # (F, 4, L)
            L = hp.shape[2]
            hpolys[i, :L] = hp.transpose(2, 0, 1)[:, :F]
            tt = np.asarray(g["traj_times"])
            times[i, :len(tt)] = tt
            seg[i] = L
    return ScenarioBatch(state=state, hpolys=hpolys, times=times, seg=seg)


def read_h5_many(paths, cfg: QPConfig,
                 seq_len: int | None = None) -> ScenarioBatch:
    """Concatenate shard files into one ScenarioBatch; `paths` is a
    directory (every *.h5 in it, sorted), one file, or a list."""
    if isinstance(paths, str):
        paths = (sorted(glob.glob(os.path.join(paths, "*.h5")))
                 if os.path.isdir(paths) else [paths])
    parts = [read_h5(p, cfg, seq_len) for p in paths]
    return ScenarioBatch(*[np.concatenate([getattr(p, f) for p in parts])
                           for f in ScenarioBatch._fields])


def build_synthetic(path: str, cfg: QPConfig, n: int, seed: int = 0) -> None:
    """Generate and write a synthetic corridor dataset."""
    write_h5(path, random_scenarios(cfg, n, seed=seed, min_seg=1))


class Loader:
    """Shuffled batches with a train/val split (the reference trainer's
    random_split(0.9) + DataLoader(batch 32, shuffle),
    train_minsnap_conv_lstm.py:108-120).  Yields numpy Batches; a
    trailing partial batch is dropped."""

    def __init__(self, sc: ScenarioBatch, batch_size: int = 32,
                 train_ratio: float = 0.9, seed: int = 0):
        n = sc.state.shape[0]
        perm = np.random.default_rng(seed).permutation(n)
        n_train = int(n * train_ratio)
        self.train_idx = perm[:n_train]
        self.val_idx = perm[n_train:]
        self.sc = sc
        self.batch_size = batch_size
        self.seed = seed

    def _gather(self, idx) -> Batch:
        return Batch(state=self.sc.state[idx], hpolys=self.sc.hpolys[idx],
                     seg=self.sc.seg[idx], ref_times=self.sc.times[idx])

    def epoch(self, epoch: int, split: str = "train") -> Iterator[Batch]:
        idx = self.train_idx if split == "train" else self.val_idx
        order = np.random.default_rng(self.seed + 1000 * epoch).permutation(
            len(idx))
        idx = idx[order]
        bs = self.batch_size
        for k in range(len(idx) // bs):
            yield self._gather(idx[k * bs:(k + 1) * bs])
