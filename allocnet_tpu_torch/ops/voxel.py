"""Voxel occupancy map as a dense 3D tensor.

Port of `allocnet_tpu/ops/voxel.py` (the reference's voxel_map::VoxelMap,
voxel_map.hpp:40-228, and its 26-neighbour dilation, voxel_dilater.hpp:
26-53):

  * the grid is an (X, Y, Z) bool tensor; point insertion is one scatter
    (`voxelize`) or a NumPy scatter on the host (`voxelize_host`);
  * one dilation round is one 3x3x3 max pool with stride 1 and padding 1
    (`F.max_pool3d` pads with -inf, so the border takes the maximum of its
    in-grid neighbours, as JAX's `reduce_window` with init False does);
  * the surface ("surf", the shell added by the last dilation round,
    voxel_map.hpp:116-161) is a mask difference.

Out-of-bounds queries return occupied, as voxel_map.hpp:190-204.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from allocnet_tpu_torch.utils.device import resolve_device


class VoxelGrid(NamedTuple):
    occ: torch.Tensor      # (X, Y, Z) bool: occupied, dilation included
    surf: torch.Tensor     # (X, Y, Z) bool: the last dilation shell
    origin: torch.Tensor   # (3,)
    scale: torch.Tensor    # ()


def voxelize(points: torch.Tensor, origin, size: tuple[int, int, int],
             scale: float) -> torch.Tensor:
    """Point cloud (N, 3) -> occupancy (X, Y, Z) on the points' device.
    Out-of-range points are dropped (voxel_map.hpp:98-106)."""
    dev = points.device
    origin = torch.as_tensor(np.asarray(origin), dtype=points.dtype,
                             device=dev)
    ids = torch.floor((points - origin) / scale).long()
    sz = torch.as_tensor(size, device=dev)
    inb = ((ids >= 0) & (ids < sz)).all(1)
    ids = ids[inb]
    grid = torch.zeros(size, dtype=torch.bool, device=dev)
    grid[ids[:, 0], ids[:, 1], ids[:, 2]] = True
    return grid


def _pool26(occ: torch.Tensor) -> torch.Tensor:
    """One 26-neighbour dilation round = 3x3x3 max pool."""
    pooled = F.max_pool3d(occ[None, None].to(torch.float32), kernel_size=3,
                          stride=1, padding=1)
    return pooled[0, 0] > 0


def dilate(occ: torch.Tensor, r: int) -> tuple[torch.Tensor, torch.Tensor]:
    """r dilation rounds; returns (dilated occupancy, surf mask), surf =
    the cells first marked in round r (voxel_map.hpp:157-160)."""
    if r <= 0:
        return occ, torch.zeros_like(occ)
    prev = occ
    for _ in range(r - 1):
        prev = _pool26(prev)
    cur = _pool26(prev)
    return cur, cur & ~prev


def voxelize_host(points: np.ndarray, origin, size: tuple[int, int, int],
                  scale: float) -> np.ndarray:
    """NumPy `voxelize`: the occupancy grid is data preparation, so a map
    build scatters on the host and moves one dense grid to the device."""
    pts = np.asarray(points)
    ids = np.floor((pts - np.asarray(origin, pts.dtype)) / scale).astype(
        np.int64)
    inb = np.all((ids >= 0) & (ids < np.asarray(size)), axis=1)
    ids = ids[inb]
    grid = np.zeros(size, bool)
    grid[ids[:, 0], ids[:, 1], ids[:, 2]] = True
    return grid


def make_grid(points, origin, size, scale: float, dilate_r: int,
              device=None) -> VoxelGrid:
    """Host scatter, then `dilate_r` pooling rounds on the device (the
    card unless `device` says otherwise)."""
    dev = resolve_device(device)
    occ0 = torch.as_tensor(voxelize_host(np.asarray(points, np.float32),
                                         origin, size, scale), device=dev)
    occ, surf = dilate(occ0, dilate_r)
    return VoxelGrid(occ=occ, surf=surf,
                     origin=torch.as_tensor(np.asarray(origin, np.float32),
                                            device=dev),
                     scale=torch.tensor(scale, dtype=torch.float32,
                                        device=dev))


def query(grid: VoxelGrid, pos: torch.Tensor) -> torch.Tensor:
    """Batched occupancy query (B, 3) -> (B,) bool; out of bounds = True."""
    ids = torch.floor((pos - grid.origin) / grid.scale).long()
    size = torch.as_tensor(grid.occ.shape, device=pos.device)
    inb = ((ids >= 0) & (ids < size)).all(-1)
    idc = torch.minimum(ids.clamp_min(0), size - 1)
    hit = grid.occ[idc[..., 0], idc[..., 1], idc[..., 2]]
    return torch.where(inb, hit, torch.ones_like(hit))


def surf_points(grid: VoxelGrid, max_points: int):
    """Surface voxel centres as a fixed-size padded array (M, 3) and mask
    (M,), in flat index order.  Centre = origin + (id + 0.5) * scale."""
    flat = grid.surf.reshape(-1)
    size = grid.occ.shape
    # stable sort of ~flat puts the occupied cells first in index order,
    # the order of JAX's argsort (stable on the CPU and the TPU)
    idx = torch.sort((~flat).to(torch.uint8), stable=True)[1][:max_points]
    mask = flat[idx]
    ix = idx // (size[1] * size[2])
    iy = (idx // size[2]) % size[1]
    iz = idx % size[2]
    ids = torch.stack([ix, iy, iz], dim=-1).to(torch.float32)
    pts = grid.origin + (ids + 0.5) * grid.scale
    return torch.where(mask[:, None], pts, torch.full_like(pts, 1e9)), mask


def surf_points_host(grid: VoxelGrid) -> np.ndarray:
    """Exact (N, 3) surface centres on the host (float64)."""
    ids = np.argwhere(grid.surf.cpu().numpy())
    return (grid.origin.cpu().numpy().astype(np.float64)
            + (ids + 0.5) * float(grid.scale))
