"""End-to-end inference: corridor scenario -> learned segment times -> QP
-> trajectory coefficients, for a batch of scenarios.

Port of `allocnet_tpu/planner/pipeline.py` (the reference's
LearningPlanner::callModel, learning_planner.hpp:140-240, batched).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from allocnet_tpu_torch.config import QPConfig, SolverConfig
from allocnet_tpu_torch.models import packing
from allocnet_tpu_torch.ops import admm, qp
from allocnet_tpu_torch.planner import refine as refine_lib
from allocnet_tpu_torch.utils.device import resolve_device


class PlanResult(NamedTuple):
    times: torch.Tensor    # (B, S) predicted segment times (masked)
    tokens: torch.Tensor   # (B, S) stop tokens (ones for an MLP net)
    coeffs: torch.Tensor   # (B, S, 3, D) trajectory coefficients
    obj: torch.Tensor      # (B,)
    solved: torch.Tensor   # (B,) QP success
    ok: torch.Tensor       # (B,) success and every active time > 1e-10


@torch.no_grad()
def plan_batch(net, cfg: QPConfig, scfg: SolverConfig, state, hpolys, seg,
               refine_steps: int = 0, device=None) -> PlanResult:
    """Network inference and the batched QP solve.

    state (B, 2, 3, 3), hpolys (B, S, F, 4) normalized a.x <= b rows, seg
    (B,); numpy arrays or tensors (cast to the network's dtype).  `net`
    (a models.networks.ConvLSTMAllocNet or ConvMLPAllocNet) must live on
    the same device.  Runs on the card unless `device` says otherwise.  As
    the reference, any active predicted time <= 1e-10 fails `ok`.

    ``refine_steps > 0`` runs MINCO-style time refinement
    (planner/refine.py) between the network and the final solve: the net's
    total time is redistributed across segments by gradient descent
    through the differentiable QP."""
    dev = resolve_device(device)
    dtype = next(net.parameters()).dtype
    state = torch.as_tensor(state, dtype=dtype, device=dev)
    hpolys = torch.as_tensor(hpolys, dtype=dtype, device=dev)
    seg = torch.as_tensor(seg, device=dev).long()

    out = net(packing.pack_state(state), packing.pack_hpolys(hpolys))
    times, tokens = out if isinstance(out, tuple) else (out,
                                                        torch.ones_like(out))

    S = cfg.max_seg
    seg_mask = (torch.arange(S, device=dev)[None, :] < seg[:, None]).to(dtype)
    times_ok = torch.where(seg_mask > 0, times > 1e-10,
                           torch.ones_like(times, dtype=torch.bool)).all(1)

    if refine_steps > 0:
        # clamp to refine's t_min first: refine_times keeps the total of
        # the clamped allocation, so an active time in (1e-10, 0.05) would
        # otherwise inflate the mission time it keeps
        times_c = torch.where(seg_mask > 0, torch.clamp_min(times, 0.05),
                              times)
        ref = refine_lib.refine_times(cfg, scfg, state, hpolys, times_c, seg,
                                      steps=refine_steps)
        times = ref.times + (1.0 - seg_mask)   # padded slots inert, not zero

    data = qp.build_qp(cfg, state, hpolys, times, seg, device=dev)
    sol = admm.solve_qp(data, scfg)
    return PlanResult(times=times * seg_mask, tokens=tokens, coeffs=sol.coeffs,
                      obj=sol.obj, solved=sol.solved, ok=times_ok & sol.solved)
