"""Safe-flight corridor: route -> windows -> batched FIRI -> shortcut ->
padded corridor tensors.

Port of `allocnet_tpu/planner/sfc.py` (sfc_gen::convexCover and shortCut,
sfc_gen.hpp:116-227, and the planner's normalization, learning_planner.hpp:
293-299).  The route walk runs on the host; all FIRI windows of a plan run
as one batched call, gap polytopes as a second, and the shortcut's
pairwise overlap LPs as one batched LP.

`corridor_online` is the fused path of the latency-bound cold plan: FIRI,
the gap test, every pairwise overlap LP, the greedy shortcut by gathers
and the goal refinement run on the device with one fetch at the end; a
plan with a gap window falls back to the generic path.

The window and point counts are padded to the JAX module's buckets
(`_bucket`, `_points_bucket`), so both packages run the same padded
problems.  Device work takes a `dtype`: float32 by default and on the card;
the parity tests pass float64, as the JAX side runs under x64 there.  The
window crop is NumPy; the JAX module takes the C++ crop when its runtime
is built (`native.crop_windows`: the same points in the same order).
"""

from __future__ import annotations

import numpy as np
import torch

from allocnet_tpu_torch.config import CorridorConfig, QPConfig
from allocnet_tpu_torch.ops import firi as firi_lib
from allocnet_tpu_torch.ops import lp
from allocnet_tpu_torch.utils.device import resolve_device


def walk_route(route: np.ndarray, progress: float) -> list:
    """Split a waypoint path into (a, b) windows of at most `progress`
    length (sfc_gen.hpp:140-151)."""
    windows = []
    b = route[0]
    i = 1
    n = len(route)
    while i < n:
        a = b
        if np.linalg.norm(a - route[i]) > progress:
            b = (route[i] - a) / np.linalg.norm(route[i] - a) * progress + a
        else:
            b = route[i]
            i += 1
        windows.append((a.copy(), b.copy()))
    return windows


def window_box(a, b, rng, lo, hi) -> tuple[np.ndarray, np.ndarray]:
    """Axis-aligned crop box corners (sfc_gen.hpp:153-158)."""
    hi_b = np.minimum(np.maximum(a, b) + rng, hi)
    lo_b = np.maximum(np.minimum(a, b) - rng, lo)
    return lo_b, hi_b


def window_bounds(a, b, rng, lo, hi) -> np.ndarray:
    """Axis-aligned crop box rows a.x <= b (sfc_gen.hpp:153-158)."""
    lo_b, hi_b = window_box(a, b, rng, lo, hi)
    rows = []
    for j in range(3):
        e = np.zeros(3)
        e[j] = 1.0
        rows.append(np.concatenate([e, [hi_b[j]]]))
        rows.append(np.concatenate([-e, [-lo_b[j]]]))
    return np.asarray(rows)


def _crop_windows(points: np.ndarray, lo_bs: np.ndarray, hi_bs: np.ndarray,
                  n_max: int):
    """The cloud cropped to each window: (W, n_max, 3) padded with 1e9 and
    (W, n_max) masks; strictly inside, cloud order, the first n_max."""
    W = len(lo_bs)
    pcs = np.full((W, n_max, 3), 1e9)
    masks = np.zeros((W, n_max))
    for k in range(W):
        if len(points):
            inside = np.all((points > lo_bs[k]) & (points < hi_bs[k]), axis=1)
            sel = points[inside][:n_max]
            pcs[k, :len(sel)] = sel
            masks[k, :len(sel)] = 1.0
    return pcs, masks


def _bucket(n: int) -> int:
    """Batch sizes rounded up to the JAX module's buckets, so both
    packages run the same padded FIRI and overlap batches."""
    for b in (4, 8, 16, 32, 64, 128):
        if n <= b:
            return b
    return ((n + 127) // 128) * 128


def _pad_windows(bds, pcs, masks, sa, sb, Bp):
    """Pad a window batch to Bp with dummy unit boxes (results dropped)."""
    pad = Bp - len(bds)
    if pad == 0:
        return bds, pcs, masks, sa, sb
    dummy_bd = np.tile(window_bounds(np.zeros(3), np.ones(3), 1.0,
                                     -np.full(3, 10.0), np.full(3, 10.0)),
                       (pad, 1, 1))
    return (np.concatenate([bds, dummy_bd]),
            np.concatenate([pcs, np.full((pad,) + pcs.shape[1:], 1e9)]),
            np.concatenate([masks, np.zeros((pad,) + masks.shape[1:])]),
            np.concatenate([sa, np.zeros((pad, 3)) + 0.2]),
            np.concatenate([sb, np.zeros((pad, 3)) + 0.4]))


def _firi_batched(bds, pcs, masks, sa, sb, iterations, n_planes, eps,
                  device, dtype):
    """FIRI over a window batch padded to its bucket; numpy results."""
    B = bds.shape[0]
    args = _pad_windows(bds, pcs, masks, sa, sb, _bucket(B))
    res = firi_lib.firi(*(torch.as_tensor(a, dtype=dtype, device=device)
                          for a in args),
                        iterations=iterations, n_planes=n_planes, eps=eps)
    return res.hpolys.cpu().numpy()[:B], res.mask.cpu().numpy()[:B]


def _windows(route, ccfg, lo, hi):
    """Windows of a route: (bounds (W, 6, 4), crop lo (W, 3), crop hi,
    seeds a (W, 3), seeds b (W, 3))."""
    windows = walk_route(route, ccfg.progress)
    W = len(windows)
    bds = np.zeros((W, 6, 4))
    los = np.zeros((W, 3))
    his = np.zeros((W, 3))
    for k, (a, b) in enumerate(windows):
        bds[k] = window_bounds(a, b, ccfg.range_xy, lo, hi)
        los[k], his[k] = window_box(a, b, ccfg.range_xy, lo, hi)
    sa = np.asarray([w[0] for w in windows]).reshape(-1, 3)
    sb = np.asarray([w[1] for w in windows]).reshape(-1, 3)
    return bds, los, his, sa, sb


def _split_gaps(hp, mk, seeds_a, owners, n_plans, eps):
    """Per-plan polytope lists with a None placeholder before each window
    whose seed `a` is cut off by >= 3 rows of its own and the previous
    polytope (sfc_gen.hpp:173-182).  Returns (lists, gap windows, slots)."""
    polys_per = [[] for _ in range(n_plans)]
    gap_idx, gap_slots = [], []
    for k in range(len(hp)):
        p = owners[k]
        rows = hp[k][mk[k] > 0]
        plist = polys_per[p]
        if plist:
            a = seeds_a[k]
            prev = plist[-1]
            viol = int(np.sum(rows[:, :3] @ a - rows[:, 3] > -eps))
            viol += int(np.sum(prev[:, :3] @ a - prev[:, 3] > -eps))
            if viol >= 3:
                gap_idx.append(k)
                gap_slots.append((p, len(plist)))
                plist.append(None)
        plist.append(rows)
    return polys_per, gap_idx, gap_slots


def convex_cover(route: np.ndarray, points: np.ndarray, lo: np.ndarray,
                 hi: np.ndarray, ccfg: CorridorConfig = CorridorConfig(),
                 n_points: int = 2048, n_planes: int = 50, eps: float = 1e-6,
                 device=None, dtype=torch.float32) -> list:
    """Route + obstacle surface points -> list of (F_i, 4) polytopes (a.x
    <= b rows): one batched FIRI call over all windows, a second over the
    gap windows."""
    return convex_cover_many([route], points, lo, hi, ccfg, n_points,
                             n_planes, eps, device, dtype)[0]


def _overlap_pairs(pa, ma, pb, mb, device, dtype):
    """Overlap LPs for a batch of pairs, padded to its bucket with copies
    of the first pair."""
    n = len(pa)
    reps = np.concatenate([np.arange(n), np.zeros(_bucket(n) - n, int)])
    t = lambda a: torch.as_tensor(a[reps], dtype=dtype, device=device)
    return lp.overlap(t(pa), t(ma), t(pb), t(mb), eps=0.1).cpu().numpy()[:n]


def _pad_polys(htemp, Fm=64):
    M = len(htemp)
    padded = np.zeros((M, Fm, 4))
    mask = np.zeros((M, Fm))
    for i, p in enumerate(htemp):
        k = min(p.shape[0], Fm)
        padded[i, :k] = p[:k]
        mask[i, :k] = 1.0
    return padded, mask


def _greedy_walk(omat: np.ndarray) -> list:
    """Greedy shortcut from the last polytope back to the first: the
    smallest overlapping earlier index at each hop (sfc_gen.hpp:188-227)."""
    M = len(omat)
    indices = [M - 1]
    i = M - 1
    while i > 0:
        for j in range(i):
            if omat[i, j] or j == i - 1:
                indices.insert(0, j)
                i = j
                break
    return indices


def short_cut(polys: list, device=None, dtype=torch.float32) -> list:
    """Greedy corridor pruning (sfc_gen.hpp:188-227) with all pairwise
    overlap LPs in one batch; a lone polytope is duplicated to force >= 2
    segments (sfc_gen.hpp:191-195), as the reference does."""
    return short_cut_many([polys], device, dtype)[0]


def _points_bucket(n: int, n_max: int) -> int:
    """The smallest of the JAX module's two point-count buckets that holds
    every cropped window."""
    if n <= 512 and n_max > 512:
        return 512
    return n_max


def _corridor_fused(bds, pcs, masks, sa, sb, wmask, goal, anchor, start, *,
                    n_planes: int, iterations: int, eps: float, S: int):
    """FIRI over all windows, row normalization, gap detection, every
    pairwise overlap LP (IPM), the greedy shortcut walk by gathers,
    corridor padding and goal refinement, on the inputs' device.  Returns
    (hp (S, F, 4), mk (S, F), seg, any_gap, refined goal (3,), state9 (1,
    2, 3, 3)) as device tensors."""
    dev, dt = bds.device, bds.dtype
    Bp = bds.shape[0]
    ii_np, jj_np = np.triu_indices(Bp, k=2)
    ii = torch.as_tensor(ii_np, device=dev)
    jj = torch.as_tensor(jj_np, device=dev)

    res = firi_lib.firi(bds, pcs, masks, sa, sb, iterations=iterations,
                        n_planes=n_planes, eps=eps)
    hp, mk = res.hpolys, res.mask
    nrm = torch.linalg.vector_norm(hp[..., :3], dim=-1, keepdim=True)
    hpn = torch.where(mk[..., None] > 0, hp / nrm.clamp_min(1e-12),
                      torch.zeros_like(hp))

    # gap test for window k: seed a_k cut off by >= 3 rows of its own and
    # the previous window's polytope (the trigger of convex_cover's first
    # gap; later gaps exist only if a first one does)
    def viol(h, m, x):
        v = torch.einsum('bpj,bj->bp', h[..., :3], x) - h[..., 3]
        return ((v > -eps) & (m > 0)).sum(1)

    own = viol(hpn, mk, sa)
    prv = viol(torch.roll(hpn, 1, 0), torch.roll(mk, 1, 0), sa)
    k = torch.arange(Bp, device=dev)
    gap = (own + prv >= 3) & (wmask > 0) & (k > 0)
    any_gap = (gap & (torch.roll(wmask, 1, 0) > 0)).any()

    ov = lp.overlap_ipm(hpn[ii], mk[ii], hpn[jj], mk[jj], eps=0.1)

    # greedy shortcut (sfc_gen.hpp:188-227) as a chain of gathers
    W = (wmask > 0).sum()
    M = torch.clamp(W, min=2)            # lone polytope: duplicate it
    omat = torch.zeros((Bp, Bp), dtype=torch.bool, device=dev)
    omat[ii, jj] = ov & (jj < W)
    omat = omat | omat.T
    iar = torch.arange(Bp, device=dev)
    omat = omat | ((iar[:, None] - iar[None, :]).abs() == 1)
    # next hop: the smallest j < i that overlaps (i - 1 always does)
    cand = torch.where(omat & (iar[None, :] < iar[:, None]), iar[None, :],
                       torch.full_like(omat, Bp, dtype=iar.dtype))
    jn = torch.where(iar == 0, torch.zeros_like(iar),
                     torch.minimum(cand.amin(1), iar - 1))
    c = M - 1
    chain = []
    for _ in range(Bp):
        chain.append(c)
        c = jn[c]
    cs = torch.stack(chain)                       # c_0 = M - 1
    seg = 1 + torch.argmax((cs == 0).to(torch.int32))

    # slot t holds chain entry seg-1-t; indices past W-1 are the
    # duplicated lone polytope
    t = torch.arange(S, device=dev)
    src = cs[torch.clamp(seg - 1 - t, 0, Bp - 1)]
    wi = torch.minimum(src, torch.clamp(W - 1, min=0))
    live = (t < seg).to(dt)
    hp_out = hpn[wi] * live[:, None, None]
    mk_out = mk[wi] * live[:, None]

    # goal refinement (min_traj_opt.py:214-232): pull the goal inside the
    # last polytope toward the previous route point
    li = torch.minimum(M - 1, torch.clamp(W - 1, min=0))
    last, lmk = hpn[li], mk[li]

    def depth(x):                                 # x (..., 3) -> (...)
        v = torch.einsum('fj,...j->...f', last[:, :3], x) - last[:, 3]
        return torch.where(lmk > 0, v, torch.full_like(v, -1.0)).amax(-1)

    lam = 1.0 - torch.arange(1, 20, dtype=dt, device=dev) / 20.0
    cands = (1.0 - lam)[:, None] * anchor + lam[:, None] * goal
    feas = depth(cands) <= 0.0
    first = torch.argmax(feas.to(torch.int32))
    goal_r = torch.where(depth(goal) <= 0.01, goal,
                         torch.where(feas.any(), cands[first], goal))

    # rest-to-rest boundary state of the cold plan, consumed on the device
    state9 = torch.zeros((1, 2, 3, 3), dtype=dt, device=dev)
    state9[0, 0, :, 0] = start
    state9[0, 1, :, 0] = goal_r
    return hp_out, mk_out, seg, any_gap, goal_r, state9


def corridor_online_dispatch(route: np.ndarray, points: np.ndarray,
                             lo: np.ndarray, hi: np.ndarray,
                             ccfg: CorridorConfig, qcfg: QPConfig,
                             n_points: int = 2048, n_planes: int = 50,
                             eps: float = 1e-6, device=None,
                             dtype=torch.float32):
    """Queue the fused corridor on the device without a host sync: returns
    the device tuple (hp (S, F, 4) padded and normalized, mk (S, F), seg,
    any_gap, refined goal, state9).  `corridor_online` is the synchronous
    wrapper."""
    dev = resolve_device(device)
    bds, los, his, sa, sb = _windows(route, ccfg, lo, hi)
    W = len(bds)
    pcs, masks = _crop_windows(points, los, his, n_points)
    # the crop is lossless below n_points: keep the smallest bucket that
    # holds every window
    n_live = int(masks.sum(axis=1).max()) if W else 0
    P = _points_bucket(n_live, n_points)
    pcs, masks = pcs[:, :P], masks[:, :P]
    Bp = _bucket(W)
    bds, pcs, masks, sa, sb = _pad_windows(bds, pcs, masks, sa, sb, Bp)
    wmask = np.zeros(Bp)
    wmask[:W] = 1.0
    anchor = route[-2] if len(route) > 1 else route[-1]
    args = [torch.as_tensor(np.asarray(x), dtype=dtype, device=dev) for x in
            (bds, pcs, masks, sa, sb, wmask, route[-1], anchor, route[0])]
    return _corridor_fused(*args, n_planes=n_planes,
                           iterations=ccfg.firi_iters, eps=eps,
                           S=qcfg.max_seg)


def corridor_online(route: np.ndarray, points: np.ndarray, lo: np.ndarray,
                    hi: np.ndarray, ccfg: CorridorConfig, qcfg: QPConfig,
                    n_points: int = 2048, n_planes: int = 50,
                    eps: float = 1e-6, device=None, dtype=torch.float32):
    """The corridor of the latency-bound path: returns (hpolys (S, F, 4)
    zero-padded and normalized, seg, polys list, refined goal), the same as
    normalize(short_cut(convex_cover())) plus goal refinement on gap-free
    plans, which it falls back to when a window has a gap.  seg may exceed
    qcfg.max_seg (a long corridor); callers reject it, as the reference
    does (learning_planner.hpp:287-291)."""
    dev = resolve_device(device)
    hp_d, mk_d, seg_d, gap_d, goal_d, _ = corridor_online_dispatch(
        route, points, lo, hi, ccfg, qcfg, n_points=n_points,
        n_planes=n_planes, eps=eps, device=dev, dtype=dtype)
    hp, mk, goal_r = (a.cpu().numpy() for a in (hp_d, mk_d, goal_d))
    seg, any_gap = int(seg_d), bool(gap_d)

    if any_gap:                                   # rare: gap polytopes
        polys = convex_cover(route, points, lo, hi, ccfg, n_points=n_points,
                             n_planes=n_planes, eps=eps, device=dev,
                             dtype=dtype)
        polys = normalize_polys(short_cut(polys, device=dev, dtype=dtype))
        hp, seg = to_padded(polys, qcfg)
        return hp, seg, polys, _refine_goal_host(route, polys[-1])[-1]

    polys = [hp[i][mk[i] > 0] for i in range(min(seg, qcfg.max_seg))]
    return np.asarray(hp, np.float64), seg, polys, goal_r


def face_set_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Distance between two padded polytopes (F, 4) as sets of live rows:
    the largest over rows of either of the max-abs distance to the nearest
    row of the other; inf when the live row counts differ.  FIRI picks
    between faces at equal distance (the symmetric faces of a window box)
    in index order, so a rounding difference can reorder the faces of the
    same polytope; this compares the polytopes, not the order."""
    ra = a[np.abs(a[:, :3]).sum(1) > 0]
    rb = b[np.abs(b[:, :3]).sum(1) > 0]
    if len(ra) != len(rb):
        return float("inf")
    if not len(ra):
        return 0.0
    d = np.abs(ra[:, None, :] - rb[None, :, :]).max(-1)
    return float(max(d.min(1).max(), d.min(0).max()))


def _refine_goal_host(route: np.ndarray, last_poly: np.ndarray) -> np.ndarray:
    """Host mirror of the fused goal refinement (min_traj_opt.py:214-232):
    pull the goal inside the last polytope by interpolating toward the
    previous route point."""
    goal = route[-1]
    a, b = last_poly[:, :3], last_poly[:, 3]
    if np.max(a @ goal - b) <= 0.01:
        return route
    anchor = route[-2] if len(route) > 1 else goal
    for k in range(1, 20):
        lam = 1.0 - k / 20.0
        cand = (1.0 - lam) * anchor + lam * goal
        if np.max(a @ cand - b) <= 0.0:
            out = route.copy()
            out[-1] = cand
            return out
    return route


def normalize_polys(polys: list) -> list:
    """Unit normals (learning_planner.hpp:293-299; rows already a.x <= b)."""
    out = []
    for p in polys:
        n = np.linalg.norm(p[:, :3], axis=1, keepdims=True)
        out.append(p / np.maximum(n, 1e-12))
    return out


def to_padded(polys: list, cfg: QPConfig) -> tuple[np.ndarray, int]:
    """Corridor list -> zero-padded (S, F, 4) and the segment count,
    clipped to S (callers reject seg > max_seg, learning_planner.hpp:
    287-291)."""
    S, F = cfg.max_seg, cfg.max_faces
    out = np.zeros((S, F, 4))
    seg = min(len(polys), S)
    for i in range(seg):
        p = polys[i][:F]
        out[i, :p.shape[0]] = p
    return out, seg


def convex_cover_many(routes: list, points: np.ndarray, lo: np.ndarray,
                      hi: np.ndarray, ccfg: CorridorConfig = CorridorConfig(),
                      n_points: int = 2048, n_planes: int = 50,
                      eps: float = 1e-6, device=None,
                      dtype=torch.float32) -> list:
    """convex_cover for many plans, every FIRI window of every plan in one
    batched call and every gap polytope in a second.  Returns one polytope
    list per route."""
    dev = resolve_device(device)
    parts = [_windows(r, ccfg, lo, hi) for r in routes]
    owners = np.concatenate([np.full(len(p[0]), i) for i, p in
                             enumerate(parts)] + [np.zeros(0)]).astype(int)
    if not len(owners):
        return [[] for _ in routes]
    bds, los, his, seeds_a, seeds_b = (np.concatenate([p[j] for p in parts])
                                       for j in range(5))
    pcs, masks = _crop_windows(points, los, his, n_points)
    hp, mk = _firi_batched(bds, pcs, masks, seeds_a, seeds_b,
                           ccfg.firi_iters, n_planes, eps, dev, dtype)
    polys_per, gap_idx, gap_slots = _split_gaps(hp, mk, seeds_a, owners,
                                                len(routes), eps)
    if gap_idx:
        hg, mg = _firi_batched(bds[gap_idx], pcs[gap_idx], masks[gap_idx],
                               seeds_a[gap_idx], seeds_a[gap_idx], 1,
                               n_planes, eps, dev, dtype)
        for gi, (p, slot) in enumerate(gap_slots):
            polys_per[p][slot] = hg[gi][mg[gi] > 0]
    return polys_per


def short_cut_many(corridors: list, device=None,
                   dtype=torch.float32) -> list:
    """short_cut for many corridors, every non-adjacent overlap LP of
    every corridor in one batched call."""
    dev = resolve_device(device)
    temps = [list(p) if len(p) != 1 else [p[0], p[0]] for p in corridors]
    pads = [_pad_polys(h) for h in temps]
    pairs = [np.triu_indices(len(h), k=2) for h in temps]
    pa = [pm[0][ii] for pm, (ii, _) in zip(pads, pairs)]
    ma = [pm[1][ii] for pm, (ii, _) in zip(pads, pairs)]
    pb = [pm[0][jj] for pm, (_, jj) in zip(pads, pairs)]
    mb = [pm[1][jj] for pm, (_, jj) in zip(pads, pairs)]
    n_all = sum(len(ii) for ii, _ in pairs)
    ov_all = (_overlap_pairs(*(np.concatenate(x) for x in (pa, ma, pb, mb)),
                             dev, dtype) if n_all else np.zeros(0, bool))
    out, off = [], 0
    for htemp, (ii, jj) in zip(temps, pairs):
        M = len(htemp)
        omat = np.zeros((M, M), bool)
        ov = ov_all[off:off + len(ii)]
        off += len(ii)
        omat[ii, jj] = ov
        omat[jj, ii] = ov
        for i in range(M - 1):
            omat[i, i + 1] = omat[i + 1, i] = True
        out.append([htemp[k] for k in _greedy_walk(omat)])
    return out
