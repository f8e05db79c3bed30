"""Time-allocation networks as nn.Modules: the ConvLSTM with stop tokens
and the ConvMLP.

Port of `allocnet_tpu/models/networks.py`: ConvLSTMAllocNet is the
reference's ConvLSTMMinimalSnapNetwork (minsnap_network_conv_lstm.py:
25-111), ConvMLPAllocNet its ConvMinimalSnapNetwork (minsnap_network_conv.py:
24-101).  The ConvLSTM's parameter names are the reference's torch
state_dict names (`allocnet_tpu/models/import_torch.py:15-32`); the ConvMLP
uses the same module names for its encoders and an `output_module` for its
head.  The JAX package's parameters load by name (models/weights.py).
"""

from __future__ import annotations

import copy

import torch
from torch import nn


class HpolyEncoder(nn.Sequential):
    """Corridor encoder: Conv2d(50->16, k3, pad 1) + ReLU + 2x MaxPool2d(2) +
    Linear(-> 32).  Input (B, 50, 4, seq_len)."""

    def __init__(self, seq_len: int = 5):
        flat_in = 16 if seq_len == 5 else 32
        super().__init__(nn.Conv2d(50, 16, 3, padding=1), nn.ReLU(),
                         nn.MaxPool2d(2), nn.MaxPool2d(2), nn.Flatten(),
                         nn.Linear(flat_in, 32))


class StateEncoder(nn.Sequential):
    """Start/end state encoder: Conv1d(9->8, k3, pad 1) + ReLU +
    MaxPool1d(2) + Linear(8->6).  Input (B, 9, 2)."""

    def __init__(self):
        super().__init__(nn.Conv1d(9, 8, 3, padding=1), nn.ReLU(),
                         nn.MaxPool1d(2), nn.Flatten(), nn.Linear(8, 6))


def lstm_cell(x, h, c, w_ih, w_hh, b_ih, b_hh):
    """One torch nn.LSTM step; gate order i, f, g, o."""
    gates = x @ w_ih.T + b_ih + h @ w_hh.T + b_hh
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


class ConvLSTMAllocNet(nn.Module):
    """Autoregressive LSTM time allocation with stop tokens.

    forward(stacked_state (B, 9, 2), stacked_hpolys (B, 50, 4, seq_len))
    returns (times, tokens), each (B, seq_len): the steps after the first
    stop token above the threshold get time 0 and token 1 (the firing step
    itself is kept, as the reference breaks after appending)."""

    def __init__(self, seq_len: int = 5, hidden_size: int = 256,
                 token_thresh: float = 0.42):
        super().__init__()
        self.seq_len = seq_len
        self.hidden_size = hidden_size
        self.token_thresh = token_thresh
        self.hpoly_input_module = HpolyEncoder(seq_len)
        self.state_input_module = StateEncoder()
        self.output_module = nn.LSTM(38, hidden_size)
        self.tfs_output_layer = nn.Linear(hidden_size, 1)
        self.stop_token_output_layer = nn.Sequential(nn.Linear(hidden_size, 1),
                                                     nn.Sigmoid())

    def embed(self, state, hpolys):
        return torch.cat([self.state_input_module(state),
                          self.hpoly_input_module(hpolys)], dim=-1)

    def rollout(self, combined):
        """All seq_len LSTM steps on the same input embedding; raw
        (tfs, stops), each (B, seq_len)."""
        lstm = self.output_module
        h = combined.new_zeros((combined.shape[0], self.hidden_size))
        c = torch.zeros_like(h)
        tfs, stops = [], []
        for _ in range(self.seq_len):
            h, c = lstm_cell(combined, h, c, lstm.weight_ih_l0,
                             lstm.weight_hh_l0, lstm.bias_ih_l0,
                             lstm.bias_hh_l0)
            tfs.append(self.tfs_output_layer(h)[:, 0])
            stops.append(self.stop_token_output_layer(h)[:, 0])
        return torch.stack(tfs, 1), torch.stack(stops, 1)

    def forward(self, state, hpolys, token_thresh: float | None = None):
        thresh = self.token_thresh if token_thresh is None else token_thresh
        tfs, stops = self.rollout(self.embed(state, hpolys))
        fired = (stops > thresh).to(torch.int32)
        keep = ((fired.cumsum(1) - fired) == 0).to(tfs.dtype)
        return tfs * keep, stops * keep + (1.0 - keep)


class ConvMLPAllocNet(nn.Module):
    """MLP-head time allocation: the two encoders, then Linear-LayerNorm-
    ReLU-Dropout twice, Linear(hidden -> seg) and Softplus(beta=2).

    forward(stacked_state, stacked_hpolys) returns times (B, seg).  As in
    the JAX package, dropout runs only when the caller passes
    deterministic=False; `train()` mode alone does not turn it on (the
    JAX training step never passes it, so the MLP trains without dropout).
    The last bias starts at 1.0, as in the JAX init: softplus(beta=2) has
    a dead zone below about -2 that a zero bias lets early steps reach."""

    def __init__(self, seg: int = 5, seq_len: int = 5, hidden_size: int = 128,
                 dropout: float = 0.2):
        super().__init__()
        self.seg = seg
        self.hpoly_input_module = HpolyEncoder(seq_len)
        self.state_input_module = StateEncoder()
        h = hidden_size
        self.output_module = nn.Sequential(
            nn.Linear(38, h), nn.LayerNorm(h), nn.ReLU(), nn.Dropout(dropout),
            nn.Linear(h, h), nn.LayerNorm(h), nn.ReLU(), nn.Dropout(dropout),
            nn.Linear(h, seg))
        nn.init.ones_(self.output_module[8].bias)

    def forward(self, state, hpolys, deterministic: bool = True):
        x = torch.cat([self.state_input_module(state),
                       self.hpoly_input_module(hpolys)], dim=-1)
        for layer in self.output_module:
            if isinstance(layer, nn.Dropout):
                if not deterministic:
                    x = nn.functional.dropout(x, layer.p, training=True)
            else:
                x = layer(x)
        # Softplus(beta=2) as log(1 + exp(2x)) / 2 without torch's
        # linear cut-off above 2x = 20, as jax.nn.softplus
        return torch.logaddexp(2.0 * x, torch.zeros_like(x)) / 2.0


def bind(net: nn.Module, params: dict | None) -> nn.Module:
    """`net` with the weights `params` (a state_dict, e.g. from
    models/weights.load_params): the counterpart of the JAX package's
    (net, params) pair.  A copy is loaded, so the caller's net keeps its
    weights; None returns `net` itself."""
    if params is None:
        return net
    out = copy.deepcopy(net)
    out.load_state_dict(params)
    return out
