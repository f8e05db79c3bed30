"""Deployment export: the net as TorchScript, and the whole replanning
step as one `torch.export` program.

Port of `allocnet_tpu/models/export.py`, which writes StableHLO and a flax
msgpack.  Here:

* `save` writes the net as TorchScript (`model.pt`, `torch.jit.trace` in
  eval mode), the reference's own deploy format (ts_conversion_conv_mlp.py:
  22-33, loaded by learning_planner.hpp:58-138), with the reference's
  state_dict names, so `import_torch.load_torchscript_lstm` of either
  package reads it back;
* `save_replan` exports `planner/replan.replan_step` (net, QP assembly,
  ADMM through the admm_chunk kernel, polish, status) with
  `torch.export` to `replan.pt2`.  The program calls the operators
  `allocnet_torch::admm_chunk` and `allocnet_torch::ldl_block`, which
  importing this module registers; a program exported with CUDA inputs
  runs on the card, one exported with CPU inputs on the CPU.
"""

from __future__ import annotations

import copy
import os

import torch

from allocnet_tpu_torch.config import AllocNetConfig
from allocnet_tpu_torch.ops import admm_chunk, ldl  # noqa: F401  (operators)
from allocnet_tpu_torch.planner import replan
from allocnet_tpu_torch.utils.device import resolve_device


def save(path: str, net: torch.nn.Module, batch: int = 1,
         seq_len: int = 5) -> str:
    """Trace `net` (eval mode, on its own device) on inputs of shape
    (batch, 9, 2) and (batch, 50, 4, seq_len) and save it as TorchScript
    in path/model.pt.  Returns the file's path."""
    os.makedirs(path, exist_ok=True)
    net = copy.deepcopy(net).eval()
    p = next(net.parameters())
    state = torch.zeros((batch, 9, 2), dtype=p.dtype, device=p.device)
    hp = torch.zeros((batch, 50, 4, seq_len), dtype=p.dtype, device=p.device)
    with torch.no_grad():
        traced = torch.jit.trace(net, (state, hp))
    out = os.path.join(path, "model.pt")
    traced.save(out)
    return out


def load(path: str, device=None) -> torch.jit.ScriptModule:
    """The TorchScript net of path/model.pt (or of `path` itself, a .pt
    file), on the card unless `device` says otherwise."""
    f = path if path.endswith(".pt") else os.path.join(path, "model.pt")
    return torch.jit.load(f, map_location=resolve_device(device)).eval()


class ReplanStep(torch.nn.Module):
    """replan_step at the warm budget as a module of (state (B, 2, 3, 3)
    f32, hpolys (B, S, F, 4) f32, seg (B,) int32, previous coefficients
    (B, S, 3, D) f32, have_prev (B,) bool) -> (times, coeffs, solved, new
    coefficients, new have_prev): the JAX export's step signature, with
    the net's weights inside."""

    def __init__(self, net: torch.nn.Module, cfg: AllocNetConfig):
        super().__init__()
        self.net = net
        self.cfg = cfg

    def forward(self, state, hpolys, seg, prev_coeffs, have_prev):
        times, coeffs, solved, new = replan.step(
            self.net, self.cfg, state, hpolys, seg,
            replan.ReplanState(prev_coeffs, have_prev), 1.0, True, 0,
            state.device)
        return times, coeffs, solved, new.coeffs, new.have_prev


def save_replan(path: str, net: torch.nn.Module, cfg: AllocNetConfig,
                batch: int = 1, device=None) -> str:
    """Export the replanning step (`ReplanStep` on a copy of `net`) for
    batch `batch` on the card unless `device` says otherwise, and save it
    to path/replan.pt2.  Returns the file's path."""
    dev = resolve_device(device)
    os.makedirs(path, exist_ok=True)
    S, D, F = cfg.qp.max_seg, cfg.qp.D, cfg.qp.max_faces
    f32 = dict(dtype=torch.float32, device=dev)
    args = (torch.zeros((batch, 2, 3, 3), **f32),
            torch.zeros((batch, S, F, 4), **f32),
            torch.ones((batch,), dtype=torch.int32, device=dev),
            torch.zeros((batch, S, 3, D), **f32),
            torch.zeros((batch,), dtype=torch.bool, device=dev))
    step = ReplanStep(copy.deepcopy(net).to(dev).eval(), cfg)
    with torch.no_grad():
        program = torch.export.export(step, args)
    out = os.path.join(path, "replan.pt2")
    torch.export.save(program, out)
    return out


def load_replan(path: str) -> torch.nn.Module:
    """The exported replanning step of path/replan.pt2 (or of `path`
    itself, a .pt2 file) as a callable module, on the device it was
    exported for, its weights frozen."""
    f = path if path.endswith(".pt2") else os.path.join(path, "replan.pt2")
    module = torch.export.load(f).module()
    for p in module.parameters():
        p.requires_grad_(False)
    return module
