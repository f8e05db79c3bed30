"""Tensor packing between the scenario layout and the reference's network
input layout (port of `allocnet_tpu/models/packing.py`).

The network takes stacked_state (B, 9, 2): rows [px,vx,ax, py,vy,ay,
pz,vz,az], columns [start, end] (learning_planner.hpp:147-160), and
stacked_hpolys (B, 50, 4, S): [face, (a0,a1,a2,b), segment]
(learning_planner.hpp:161-168).  The scenario layout is state
(B, 2, 3, 3) [start/end, axis, (p,v,a)] and hpolys (B, S, F, 4).
"""

from __future__ import annotations

import torch


def pack_state(state: torch.Tensor) -> torch.Tensor:
    """(B, 2, 3, 3) -> (B, 9, 2)."""
    return state.reshape(state.shape[0], 2, 9).transpose(1, 2)


def unpack_state(stacked: torch.Tensor) -> torch.Tensor:
    """(B, 9, 2) -> (B, 2, 3, 3)."""
    return stacked.transpose(1, 2).reshape(stacked.shape[0], 2, 3, 3)


def pack_hpolys(hpolys: torch.Tensor) -> torch.Tensor:
    """(B, S, F, 4) -> (B, F, 4, S)."""
    return hpolys.permute(0, 2, 3, 1)


def unpack_hpolys(stacked: torch.Tensor) -> torch.Tensor:
    """(B, F, 4, S) -> (B, S, F, 4)."""
    return stacked.permute(0, 3, 1, 2)
