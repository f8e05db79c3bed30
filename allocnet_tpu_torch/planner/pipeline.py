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
from allocnet_tpu_torch.utils.device import resolve_device


class PlanResult(NamedTuple):
    times: torch.Tensor    # (B, S) predicted segment times (masked)
    tokens: torch.Tensor   # (B, S) stop tokens
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
    (a models.networks.ConvLSTMAllocNet) must live on the same device.
    Runs on the card unless `device` says otherwise.  As the reference, any
    active predicted time <= 1e-10 fails `ok`; the solve still runs on
    floor-clamped times so the batch keeps its shape."""
    if refine_steps > 0:
        raise NotImplementedError(
            "refine_steps > 0 needs the differentiable QP (ops/qp_diff), "
            "which a later slice of the port brings")
    dev = resolve_device(device)
    dtype = next(net.parameters()).dtype
    state = torch.as_tensor(state, dtype=dtype, device=dev)
    hpolys = torch.as_tensor(hpolys, dtype=dtype, device=dev)
    seg = torch.as_tensor(seg, device=dev).long()

    times, tokens = net(packing.pack_state(state), packing.pack_hpolys(hpolys))

    S = cfg.max_seg
    seg_mask = (torch.arange(S, device=dev)[None, :] < seg[:, None]).to(dtype)
    times_ok = torch.where(seg_mask > 0, times > 1e-10,
                           torch.ones_like(times, dtype=torch.bool)).all(1)

    data = qp.build_qp(cfg, state, hpolys, times, seg, device=dev)
    sol = admm.solve_qp(data, scfg)
    return PlanResult(times=times * seg_mask, tokens=tokens, coeffs=sol.coeffs,
                      obj=sol.obj, solved=sol.solved, ok=times_ok & sol.solved)
