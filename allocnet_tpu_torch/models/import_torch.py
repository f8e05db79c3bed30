"""Checkpoints for the port's networks: the reference's TorchScript files
and flax msgpack parameter files.

Port of `allocnet_tpu/models/import_torch.py`.  The port's networks keep
the reference's state_dict names (models/networks.py), so a TorchScript
checkpoint loads by name; a flax msgpack file loads through
models/weights.py.  Where the JAX module converts a `.pt` once and writes
a `.msgpack` cache beside it (which then wins over the `.pt`), the port
reads the `.pt` itself every time and writes no cache.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from allocnet_tpu_torch.models import weights

# the ConvLSTM's state_dict keys (the reference's TorchScript names)
LSTM_KEYS = tuple(weights.JAX_TO_TORCH.values())


def _script_state_dict(path: str) -> dict:
    module = torch.jit.load(path, map_location="cpu")
    return {k: v.detach() for k, v in module.state_dict().items()}


def load_torchscript_lstm(path: str, dtype=torch.float32) -> dict:
    """TorchScript .pt -> state_dict of models/networks.ConvLSTMAllocNet."""
    sd = _script_state_dict(path)
    missing = [k for k in LSTM_KEYS if k not in sd]
    if missing:
        raise KeyError(f"{path}: not a ConvLSTM checkpoint, missing {missing}")
    return {k: sd[k].to(dtype).clone() for k in LSTM_KEYS}


def seq_len_of_checkpoint(path: str) -> int:
    """The seq10 variant differs only in the hpoly linear input width."""
    w = _script_state_dict(path)["hpoly_input_module.5.weight"]
    return 5 if w.shape[1] == 16 else 10


def load_params(path: str) -> dict:
    """state_dict from either checkpoint kind: a flax .msgpack
    (`weights.load_params`) or a TorchScript .pt (read directly, no cache
    written)."""
    if path.endswith(".msgpack"):
        return weights.load_params(path)
    return load_torchscript_lstm(path)


# ---------------------------------------------------------------------------
# flax msgpack writer (the layout models/weights.py reads)
# ---------------------------------------------------------------------------

def _pack(obj) -> bytes:
    """msgpack encoding of what flax writes: dicts with str keys (sorted),
    str, bool, None, ints, floats and numpy arrays (ext type 1: shape,
    dtype name, raw bytes), each in its shortest form."""
    if isinstance(obj, dict):
        n = len(obj)
        head = (bytes([0x80 | n]) if n < 16 else
                b"\xde" + struct.pack(">H", n) if n < 1 << 16 else
                b"\xdf" + struct.pack(">I", n))
        return head + b"".join(_pack(k) + _pack(obj[k])
                               for k in sorted(obj))     # as flax orders
    if isinstance(obj, (list, tuple)):
        n = len(obj)
        head = (bytes([0x90 | n]) if n < 16 else
                b"\xdc" + struct.pack(">H", n) if n < 1 << 16 else
                b"\xdd" + struct.pack(">I", n))
        return head + b"".join(_pack(v) for v in obj)
    if obj is None:
        return b"\xc0"
    if isinstance(obj, bool):
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, int):
        if -32 <= obj < 128:
            return struct.pack(">b", obj)
        kinds = ((">B", b"\xcc"), (">H", b"\xcd"), (">I", b"\xce"),
                 (">Q", b"\xcf")) if obj > 0 else (
            (">b", b"\xd0"), (">h", b"\xd1"), (">i", b"\xd2"),
            (">q", b"\xd3"))
        for fmt, code in kinds:                  # the shortest that holds it
            try:
                return code + struct.pack(fmt, obj)
            except struct.error:
                continue
        raise OverflowError(f"msgpack: {obj} does not fit 64 bits")
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        head = (bytes([0xa0 | n]) if n < 32 else
                b"\xd9" + struct.pack(">B", n) if n < 1 << 8 else
                b"\xda" + struct.pack(">H", n) if n < 1 << 16 else
                b"\xdb" + struct.pack(">I", n))
        return head + raw
    if isinstance(obj, bytes):
        n = len(obj)
        head = (b"\xc4" + struct.pack(">B", n) if n < 1 << 8 else
                b"\xc5" + struct.pack(">H", n) if n < 1 << 16 else
                b"\xc6" + struct.pack(">I", n))
        return head + obj
    if isinstance(obj, (np.ndarray, np.generic)):
        a = np.ascontiguousarray(obj)
        data = _pack([list(a.shape), a.dtype.name, a.tobytes()])
        n = len(data)
        fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        if n in fixext:
            head = bytes([fixext[n]])
        else:
            head = (b"\xc7" + struct.pack(">B", n) if n < 1 << 8 else
                    b"\xc8" + struct.pack(">H", n) if n < 1 << 16 else
                    b"\xc9" + struct.pack(">I", n))
        return head + struct.pack(">b", weights._EXT_NDARRAY) + data
    raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")


def save_params_msgpack(params: dict, path: str) -> None:
    """Write a ConvLSTM or ConvMLP state_dict as a flax msgpack params file
    (`weights.to_jax_params`): the bytes flax's `msgpack_serialize`
    writes, read by `weights.load_params` and by the JAX package's
    `load_params_msgpack`."""
    with open(path, "wb") as f:
        f.write(_pack(weights.to_jax_params(params)))
