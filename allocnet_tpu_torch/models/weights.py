"""Weights for the port's networks from the JAX package's parameters.

`read_msgpack` decodes a flax msgpack file (`data/params/*.msgpack`,
`runs/*/checkpoints/*.msgpack`) into nested dicts of numpy arrays without
the `msgpack` package; `from_jax_params` renames such a tree (ConvLSTM or
ConvMLP) to the state_dict names that models/networks.py uses.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

# JAX parameter path -> reference torch state_dict key
# (allocnet_tpu/models/import_torch.py:15-32, inverted)
JAX_TO_TORCH = {
    ('w_ih',): 'output_module.weight_ih_l0',
    ('w_hh',): 'output_module.weight_hh_l0',
    ('b_ih',): 'output_module.bias_ih_l0',
    ('b_hh',): 'output_module.bias_hh_l0',
    ('tf_w',): 'tfs_output_layer.weight',
    ('tf_b',): 'tfs_output_layer.bias',
    ('stop_w',): 'stop_token_output_layer.0.weight',
    ('stop_b',): 'stop_token_output_layer.0.bias',
    ('hpoly_enc', 'conv_w'): 'hpoly_input_module.0.weight',
    ('hpoly_enc', 'conv_b'): 'hpoly_input_module.0.bias',
    ('hpoly_enc', 'lin_w'): 'hpoly_input_module.5.weight',
    ('hpoly_enc', 'lin_b'): 'hpoly_input_module.5.bias',
    ('state_enc', 'conv_w'): 'state_input_module.0.weight',
    ('state_enc', 'conv_b'): 'state_input_module.0.bias',
    ('state_enc', 'lin_w'): 'state_input_module.4.weight',
    ('state_enc', 'lin_b'): 'state_input_module.4.bias',
}

# JAX ConvMLPAllocNet parameter path -> models/networks.ConvMLPAllocNet key
# (the encoders as above; the head's Linear / LayerNorm layers are entries
# 0, 1, 4, 5 and 8 of `output_module`)
MLP_JAX_TO_TORCH = {
    **{p: k for p, k in JAX_TO_TORCH.items() if p[0] in ('hpoly_enc',
                                                         'state_enc')},
    ('l1_w',): 'output_module.0.weight',
    ('l1_b',): 'output_module.0.bias',
    ('ln1_s',): 'output_module.1.weight',
    ('ln1_b',): 'output_module.1.bias',
    ('l2_w',): 'output_module.4.weight',
    ('l2_b',): 'output_module.4.bias',
    ('ln2_s',): 'output_module.5.weight',
    ('ln2_b',): 'output_module.5.bias',
    ('l3_w',): 'output_module.8.weight',
    ('l3_b',): 'output_module.8.bias',
}

# flax's msgpack extension code for a numpy array: (shape, dtype name, bytes)
_EXT_NDARRAY = 1


class _Reader:
    """A msgpack decoder for what flax writes: maps, arrays, str, bin, nil,
    bool, ints, floats and ext type 1 (numpy arrays)."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, k: int) -> memoryview:
        if self.pos + k > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos:self.pos + k]
        self.pos += k
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        t = self.unpack('>B')
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if 0x80 <= t <= 0x8f:
            return self.map(t & 0x0f)
        if 0x90 <= t <= 0x9f:
            return self.array(t & 0x0f)
        if 0xa0 <= t <= 0xbf:
            return str(self.take(t & 0x1f), 'utf-8')
        fixed = {0xc0: None, 0xc2: False, 0xc3: True}
        if t in fixed:
            return fixed[t]
        sized = {0xc4: '>B', 0xc5: '>H', 0xc6: '>I'}             # bin
        if t in sized:
            return bytes(self.take(self.unpack(sized[t])))
        sized = {0xd9: '>B', 0xda: '>H', 0xdb: '>I'}             # str
        if t in sized:
            return str(self.take(self.unpack(sized[t])), 'utf-8')
        nums = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I',
                0xcf: '>Q', 0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
        if t in nums:
            return self.unpack(nums[t])
        if t in (0xdc, 0xdd):
            return self.array(self.unpack('>H' if t == 0xdc else '>I'))
        if t in (0xde, 0xdf):
            return self.map(self.unpack('>H' if t == 0xde else '>I'))
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if t in fixext:
            return self.ext(fixext[t])
        sized = {0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}             # ext
        if t in sized:
            return self.ext(self.unpack(sized[t]))
        raise ValueError(f"msgpack: unsupported type byte 0x{t:02x}")

    def map(self, k: int) -> dict:
        out = {}
        for _ in range(k):
            key = self.value()
            out[key] = self.value()
        return out

    def array(self, k: int) -> list:
        return [self.value() for _ in range(k)]

    def ext(self, size: int):
        code = self.unpack('>b')
        data = bytes(self.take(size))
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack: unsupported ext type {code}")
        shape, dtype, raw = _Reader(data).value()
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def read_msgpack(path: str):
    """Decode a flax msgpack file into nested dicts with numpy leaves."""
    with open(path, 'rb') as f:
        reader = _Reader(f.read())
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} trailing "
                         f"bytes in {path}")
    return out


def from_jax_params(tree: dict) -> dict:
    """JAX ConvLSTMAllocNet or ConvMLPAllocNet parameters (numpy leaves; a
    plain params tree or one nested under 'params' keys, as in a training
    checkpoint) -> a float32 torch state_dict for the matching network of
    models/networks.py."""
    while 'w_ih' not in tree and 'l1_w' not in tree:
        if 'params' not in tree:
            raise KeyError("no ConvLSTMAllocNet or ConvMLPAllocNet "
                           "parameters in this tree")
        tree = tree['params']
    names = JAX_TO_TORCH if 'w_ih' in tree else MLP_JAX_TO_TORCH
    sd = {}
    for path, key in names.items():
        leaf = tree
        for p in path:
            leaf = leaf[p]
        sd[key] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    return sd


def load_params(path: str) -> dict:
    """state_dict from a flax msgpack parameter or checkpoint file."""
    return from_jax_params(read_msgpack(path))


def to_jax_params(sd: dict) -> dict:
    """The inverse of `from_jax_params`: a ConvLSTM or ConvMLP state_dict
    -> the JAX package's params tree {'params': {...}} with float32 numpy
    leaves (names only change; both keep torch's weight layouts)."""
    names = (JAX_TO_TORCH if 'output_module.weight_ih_l0' in sd
             else MLP_JAX_TO_TORCH)
    tree: dict = {}
    for path, key in names.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = sd[key].detach().cpu().numpy().astype(np.float32)
    return {'params': tree}

