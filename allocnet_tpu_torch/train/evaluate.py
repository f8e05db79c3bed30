"""Evaluation harness: success rate, stop-token and time-segment accuracy,
and optional trajectory certificates.

Port of `allocnet_tpu/train/evaluate.py` (the reference's scenario test
scripts, test_minsnap_model_conv_lstm_batch.py:24,149-182): net and QP over
a scenario set in batches, aggregated into the reference's metrics.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from allocnet_tpu_torch.config import AllocNetConfig
from allocnet_tpu_torch.models import packing
from allocnet_tpu_torch.ops import admm, qp
from allocnet_tpu_torch.planner import trajectory as traj_lib
from allocnet_tpu_torch.train import losses as losses_lib
from allocnet_tpu_torch.train.train_step import TIME_MIN
from allocnet_tpu_torch.utils.device import resolve_device
from allocnet_tpu_torch.utils.scenarios import ScenarioBatch


class EvalReport(NamedTuple):
    n: int
    success_rate: float                 # QP solved with predicted times
    stop_token_accuracy: float          # predicted segment count == corridor's
    time_segment_accuracy: float        # stop loss < 1.0 (reference metric)
    mean_obj: float                     # mean QP objective over solved
    mean_time_ratio: float              # predicted total time / reference
    # fraction of all scenarios whose solution carries a host-f64 Bernstein
    # proof of the per-axis box limits for every t (the QP enforces them
    # only at the res samples)
    certified_frac: float = float("nan")
    certified_of_solved: float = float("nan")


@torch.no_grad()
def _run(net, cfg: AllocNetConfig, state, hpolys, seg, ref_times):
    S = cfg.qp.max_seg
    out = net(packing.pack_state(state), packing.pack_hpolys(hpolys))
    times, tokens = out if isinstance(out, tuple) else (out, None)
    seg_mask = (torch.arange(S, device=times.device)[None, :]
                < seg[:, None]).to(times.dtype)
    times_q = torch.where(seg_mask > 0, torch.clamp_min(times, TIME_MIN),
                          torch.ones_like(times))
    data = qp.build_qp(cfg.qp, state, hpolys, times_q, seg,
                       device=times.device)
    sol = admm.solve_qp(data, cfg.solver)
    if tokens is not None:
        stop_loss = losses_lib.stop_token_loss(tokens, seg, cfg.loss,
                                               cfg.model.token_thresh)
        pred_seg = (times > 1e-6).sum(1)
    else:
        stop_loss = times.new_zeros((times.shape[0],))
        pred_seg = seg
    t_pred = (times * seg_mask).sum(1)
    t_ref = (ref_times * seg_mask).sum(1)
    return (sol.solved, sol.obj, stop_loss, pred_seg, t_pred, t_ref,
            sol.coeffs, times_q * seg_mask)


def evaluate(net, cfg: AllocNetConfig, sc: ScenarioBatch,
             batch_size: int = 256, certify: bool = False,
             extras: bool = False, device=None):
    """Run net and QP over a scenario set on `device` (the card unless the
    caller asks for another; the net must live there).  Returns an
    EvalReport, or (EvalReport, dict of per-scenario arrays) with
    extras=True.  certify adds the host-f64 per-axis box certificate
    (trajectory.certify_box_host, 5 subdivision levels)."""
    dev = resolve_device(device)
    dtype = next(net.parameters()).dtype
    n = sc.state.shape[0]
    want_traj = certify or extras
    cols = [[] for _ in range(6)]
    cof, tq = [], []
    for k in range(0, n, batch_size):
        sl = slice(k, min(k + batch_size, n))
        t = lambda a: torch.as_tensor(a[sl], dtype=dtype, device=dev)
        out = _run(net, cfg, t(sc.state), t(sc.hpolys),
                   torch.as_tensor(sc.seg[sl], device=dev).long(),
                   t(sc.times))
        for acc, val in zip(cols, out[:6]):
            acc.append(val.cpu().numpy())
        if want_traj:
            cof.append(out[6].cpu().numpy())
            tq.append(out[7].cpu().numpy())
    solved, objs, stops, pseg, tp, tr = (np.concatenate(c) for c in cols)

    certified = None
    if certify:
        certified = solved & traj_lib.certify_box_host(
            np.concatenate(cof), np.concatenate(tq), sc.seg,
            cfg.qp.max_vel, cfg.qp.max_acc, levels=5)

    rep = EvalReport(
        n=n,
        success_rate=float(solved.mean()),
        stop_token_accuracy=float((pseg == sc.seg[:len(pseg)]).mean()),
        time_segment_accuracy=float((stops < 1.0).mean()),
        mean_obj=float(objs[solved].mean()) if solved.any() else float("nan"),
        mean_time_ratio=float((tp / np.maximum(tr, 1e-6)).mean()),
        certified_frac=float(certified.mean()) if certify else float("nan"),
        certified_of_solved=(float(certified[solved].mean())
                             if certify and solved.any() else float("nan")),
    )
    if extras:
        ex = {"solved": solved, "obj": objs, "pred_seg": pseg,
              "t_pred": tp, "t_ref": tr}
        if certify:
            ex["certified"] = certified
        return rep, ex
    return rep
