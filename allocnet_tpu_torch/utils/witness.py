"""Rounding witnesses: whether an outcome moves when its inputs move by a
relative REL of themselves.

Two runs of one computation in different arithmetic (the card against
the CPU, float32 against the JAX package's float32) may decide a flag
differently where the flag sits at its threshold.  The witness of such a
difference is the flag moving when every entry of the inputs is moved by
REL of itself with a random sign: `draw_moves` draws in rounds (`rounds`)
shared among the items that have not moved yet, every item's signs from
its own seed, so an item's draws are the same whatever other items are
drawn with it.  A witness means something only beside its control: as
many items on which the two runs agree, through the same draws (the
callers report and gate the control's share of moved items).

- `flag_moves`: a per-row flag of a ScenarioBatch (a certify flag); each
  round's batch holds every pending row once unmoved and k times moved,
  and a draw moves when its flag differs from the unmoved copy's in the
  same batch (so the batch's size and bucket cannot decide it).
- `corridor_moves`: a corridor of a route; each round builds the route's
  own corridor with its k draws.
- `corridor_distance`: the face-set distance of two corridors.
"""

from __future__ import annotations

import numpy as np

from allocnet_tpu_torch.planner import sfc
from allocnet_tpu_torch.utils.scenarios import ScenarioBatch

REL = 1e-6
QP_INPUTS = ("state", "hpolys", "times")


def move(a: np.ndarray, rng, rel: float = REL) -> np.ndarray:
    """`a` with every entry moved by `rel` of itself, a random sign each."""
    return a * (1.0 + rel * rng.choice([-1.0, 1.0], size=a.shape))


def rounds(first: int, most: int):
    """Draws per round: first, first, then doubling, at most `most` in
    all."""
    done, k = 0, first
    while done < most:
        k = min(k, most - done)
        yield k
        done += k
        k = first if done == first else 2 * k


def draw_moves(differs, seeds, first: int, most: int):
    """Rounds of draws (`rounds(first, most)`) shared among the items (one
    per seed) that have not moved yet.  `differs(pending, k, rngs)` gives a
    (len(pending), k) bool array: whether each of k draws of each pending
    item (its signs from its rng) moves its outcome.  Returns (moves,
    draws) per item."""
    rngs = [np.random.default_rng(s) for s in seeds]
    moves = np.zeros(len(rngs), int)
    draws = np.zeros(len(rngs), int)
    for k in rounds(first, most):
        pending = np.nonzero(moves == 0)[0]
        if not len(pending):
            break
        got = np.asarray(differs(pending, k, [rngs[i] for i in pending]))
        draws[pending] += k
        moves[pending] += got.sum(1)
    return moves, draws


def flag_moves(flags_of, batch: ScenarioBatch, idx, seeds, first: int,
               most: int, fields=QP_INPUTS):
    """`draw_moves` of the flags (`flags_of(batch) -> (B,) bool`) of rows
    idx of `batch` with `fields` moved.  Returns (moves, draws) per row."""
    idx = np.asarray(idx, int)

    def differs(pending, k, rngs):
        parts = []
        for p, rng in zip(pending, rngs):
            rows = np.full(k + 1, idx[p])
            one = {f: getattr(batch, f)[rows] for f in ScenarioBatch._fields}
            for f in fields:
                one[f] = np.concatenate([one[f][:1], move(one[f][1:], rng)])
            parts.append(one)
        flags = np.asarray(flags_of(ScenarioBatch(**{
            f: np.concatenate([p[f] for p in parts])
            for f in ScenarioBatch._fields}))).reshape(len(pending), k + 1)
        return flags[:, 1:] != flags[:, :1]

    if not len(idx):
        return np.zeros(0, int), np.zeros(0, int)
    return draw_moves(differs, seeds, first, most)


def corridor_distance(hp, seg, hp_ref, seg_ref):
    """Largest face-set distance (`sfc.face_set_distance`) between two
    corridors over the reference's largest entry (0 for two empty ones);
    None when the segment or face counts differ."""
    if seg != seg_ref:
        return None
    if seg == 0:
        return 0.0
    scale = max(1.0, float(np.abs(hp_ref).max()))
    d = max(sfc.face_set_distance(hp[i], hp_ref[i]) for i in range(seg))
    return None if np.isinf(d) else d / scale


def corridors_apart(a, b, tol: float) -> bool:
    """Whether two corridors, each (ok, hpolys, seg), differ: in ok, in
    segment count, or (both ok) in faces beyond `tol` of the second's
    largest entry."""
    if a[0] != b[0] or a[2] != b[2]:
        return True
    if not a[0]:
        return False
    d = corridor_distance(a[1], a[2], b[1], b[2])
    return d is None or d > tol


def corridor_moves(corridors_of, route, seed, first: int, most: int,
                   tol: float) -> int:
    """How many draws of `route` give a corridor apart (`corridors_apart`,
    `tol`) from the route's own, built with them in each round
    (`corridors_of(routes) -> [(ok, hpolys, seg)]`): rounds until one
    moves (`draw_moves`)."""
    def differs(pending, k, rngs):
        own, *drawn = corridors_of([route] + [move(route, rngs[0])
                                              for _ in range(k)])
        return np.array([[corridors_apart(c, own, tol) for c in drawn]])

    return int(draw_moves(differs, [seed], first, most)[0][0])
