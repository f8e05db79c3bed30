"""Device choice for the port's entry points."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another one (the tests pass "cpu").  Without a card, asking for
    none raises instead of falling back to the CPU.

    Also pins float32 math to full precision: the solver diverges in TF32
    (the JAX package pins `default_matmul_precision('float32')` for the same
    reason), and cuDNN would otherwise run the ConvLSTM's convolutions in
    TF32 by default."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return dev


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them (a card
    set below its maximum runs slower under load), or the device type."""
    if dev.type != "cuda":
        return dev.type
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(dev)
