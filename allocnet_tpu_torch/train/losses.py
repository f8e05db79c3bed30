"""Training losses with the reference's semantics.

Port of `allocnet_tpu/train/losses.py` (the reference's OsqpLayer.forward /
forward4lstm, layers.py:51-247, and the loss mixing of
minsnap_network_conv_lstm.py:371-389).  Per scenario:

  obj1 = mean predicted time over active segments          (layers.py:85)
  objc = (1/2 x^T Q x) / path_length        [solved only]  (layers.py:149)
  objt = MSE(times, ref_times over active) / seg [unsolved] (layers.py:105)
  padding = MSE(times[seg:], 0)             [MLP head]      (layers.py:93)
  stop    = BCE(tokens, gt) + end_penalty * (#premature + #late)
                                            [LSTM head]     (layers.py:188-205)
  total = w1*obj1 + wc*objc + wp*stop_or_padding   (solved)
        = w1*obj1 + wt*objt + wp*stop_or_padding   (unsolved)

Where the JAX module takes jnp.maximum this one takes torch.maximum, so
that gradients split at ties the same way (clamp does not split).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from allocnet_tpu_torch.config import LossConfig


class LossBundle(NamedTuple):
    total: torch.Tensor          # scalar
    obj1: torch.Tensor           # scalar (mean over batch)
    objt: torch.Tensor
    objc: torch.Tensor
    stop: torch.Tensor
    success_rate: torch.Tensor
    time_segment_accuracy: torch.Tensor   # fraction with stop loss < 1.0


def _full(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=like.dtype, device=like.device)


def stop_token_targets(seg: torch.Tensor, seq_len: int,
                       dtype=torch.float32) -> torch.Tensor:
    """gt = zeros(seg-1) then ones (layers.py:190-193)."""
    idx = torch.arange(seq_len, device=seg.device)[None, :]
    return (idx >= (seg[:, None] - 1)).to(dtype)


def stop_token_loss(tokens: torch.Tensor, seg: torch.Tensor,
                    lcfg: LossConfig, token_thresh: float = 0.42):
    """BCE + premature/late end penalties (layers.py:195-205), (B,)."""
    gt = stop_token_targets(seg, tokens.shape[1], tokens.dtype)
    eps = 1e-7
    p = torch.minimum(torch.maximum(tokens, _full(eps, tokens)),
                      _full(1.0 - eps, tokens))
    bce = -(gt * torch.log(p) + (1.0 - gt) * torch.log(1.0 - p)).mean(1)
    premature = ((tokens > token_thresh) & (gt < token_thresh)).sum(1)
    late = ((tokens < token_thresh) & (gt > token_thresh)).sum(1)
    return bce + lcfg.end_penalty * (premature + late).to(tokens.dtype)


def compute_losses(lcfg: LossConfig, times, tokens, seg, solved, obj, state,
                   ref_times=None, token_thresh: float = 0.42) -> LossBundle:
    """times (B, S) predicted (masked rollout output), tokens (B, S) stop
    tokens or None for the MLP head, seg (B,), solved (B,) bool, obj (B,)
    differentiable QP objective, state (B, 2, 3, 3), ref_times (B, S)
    dataset times or None."""
    B, S = times.shape
    dtype = times.dtype
    seg_mask = (torch.arange(S, device=times.device)[None, :]
                < seg[:, None]).to(dtype)
    one = _full(1.0, times)
    nseg = torch.maximum(seg.to(dtype), one)
    solved_f = solved.to(dtype)

    obj1 = (times * seg_mask).sum(1) / nseg

    # normalized QP cost; path_length = ||goal - start|| (min_traj_opt.py:145)
    path_len = torch.maximum(torch.linalg.vector_norm(
        state[:, 1, :, 0] - state[:, 0, :, 0], dim=-1), _full(1e-3, times))
    objc = obj / path_len

    if ref_times is not None:
        objt = (((times - ref_times) * seg_mask) ** 2).sum(1) / nseg / nseg
    else:
        objt = times.new_zeros((B,))

    if tokens is not None:
        wp_loss = stop_token_loss(tokens, seg, lcfg, token_thresh)
        accurate = (wp_loss < 1.0).to(dtype)
    else:
        pad_mask = 1.0 - seg_mask
        denom = torch.maximum(pad_mask.sum(1), one)
        wp_loss = ((times * pad_mask) ** 2).sum(1) / denom
        accurate = times.new_ones((B,))

    # branch with `where`, not multiplication: the unsolved branch's objc
    # can be non-finite (a diverged infeasible solve) and 0 * nan = nan
    zero = _full(0.0, times)
    objc = torch.where(solved, objc, zero)
    objt = torch.where(solved, zero, objt)
    per = lcfg.w1 * obj1 + lcfg.wp * wp_loss + lcfg.wc * objc + lcfg.wt * objt

    return LossBundle(
        total=per.mean(),
        obj1=obj1.mean(),
        objt=((1.0 - solved_f) * objt).mean(),
        objc=(solved_f * objc).mean(),
        stop=wp_loss.mean(),
        success_rate=solved_f.mean(),
        time_segment_accuracy=accurate.mean(),
    )
