"""Sequence encoders over per-slice features, for the baseline family.

Counterpart of ``mdhs_tpu/modules/sequence.py``: a (B, T, D) sequence of
per-slice image features (neighbouring CT / MR slices, or the views of one
image) becomes one (B, hidden_dim) vector.

- ``lstm`` / ``gru``: (bi)directional recurrent layers; the output at the
  last time index, then ``proj`` where the width changes (bidirectional).
  The backward direction's outputs are in the original order, as flax's
  ``nn.RNN(reverse=True, keep_order=True)`` gives them, so its output at the
  last index is its state after one step, not its final carry (the
  reference's ``nn.LSTM`` output has the same property). The recurrence is
  an explicit loop over T in the order flax's cells round: the input
  products for all steps at once, then each step's recurrent product in the
  module's dtype, the gates in the module's dtype, and the carry in float32
  (flax's ``initialize_carry`` makes it in the parameter dtype, float32, so
  ``f * c`` and the output ``o * tanh(c)`` are float32). The output is cast
  to the module's dtype. Dropout between layers only when ``num_layers > 1``.
- ``transformer``: the sinusoidal position table added, post-norm encoder
  layers (``TransformerEncoderLayer``: self-attention, dropout, add,
  LayerNorm; ReLU feed-forward of width ``max(4 hidden, 2 d)``, dropout,
  add, LayerNorm; eps 1e-5), mean pooling, ``proj`` where the width
  changes. The attention is ``modules/attention.py::MultiHeadAttention``.

Names are PyTorch's ``nn.LSTM`` / ``nn.GRU`` (``rnn.weight_ih_l{k}``,
``rnn.weight_hh_l{k}``, ``rnn.bias_hh_l{k}``, ``_reverse`` for the backward
direction; gate order i, f, g, o and r, z, n) and
``nn.TransformerEncoderLayer`` (``encoder.layers.{k}.self_attn``,
``linear1``, ``linear2``, ``norm1``, ``norm2``), the reference's
``sequence_blocks.py`` modules. The parameters are flax's, no more: the LSTM
has no input bias (``OptimizedLSTMCell``'s ``i*`` kernels have none, and a
second bias would take the same gradient and move twice as fast in
training); the GRU has the input biases ``bias_ih`` (3H) and the recurrent
bias of the n gate only, ``bias_hh`` (H), as ``GRUCell``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import device_constant
from .attention import MultiHeadAttention

_PE: dict = {}


def sinusoidal_pe_table(seq_len: int, dim: int) -> np.ndarray:
    """The (seq_len, dim) float32 table, computed on the host in numpy as the JAX
    package computes it (an odd ``dim`` has one cosine slot fewer than sine)."""
    pos = np.arange(seq_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32) * (-math.log(10000.0) / dim))
    pe = np.zeros((seq_len, dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: dim // 2])
    return pe


def sinusoidal_pe(seq_len: int, dim: int, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The table on ``device`` in ``dtype``, made once for each (seq_len, dim, device,
    dtype) (``device_constant``)."""
    return device_constant(_PE, (seq_len, dim, torch.device(device), dtype),
                           lambda: torch.from_numpy(sinusoidal_pe_table(seq_len, dim)).to(device=device, dtype=dtype))


class RNN(nn.Module):
    """``num_layers`` of flax ``OptimizedLSTMCell`` (``kind="lstm"``) or ``GRUCell``
    (``"gru"``) scans, forward and, where ``bidirectional``, backward, under
    ``nn.LSTM`` / ``nn.GRU`` names. ``forward`` takes (B, T, input_size) and
    returns (B, T, H or 2H) float32, the carry's dtype."""

    def __init__(self, kind: str, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = True, dropout: float = 0.0, device=None, dtype=None):
        super().__init__()
        if kind not in ("lstm", "gru"):
            raise ValueError(f"unknown recurrent cell {kind!r}")
        f = dict(device=device, dtype=dtype)
        self.kind, self.hidden_size, self.num_layers = kind, hidden_size, num_layers
        self.directions = ("", "_reverse") if bidirectional else ("",)
        self.dropout = nn.Dropout(dropout)
        gates = 4 if kind == "lstm" else 3
        for k in range(num_layers):
            width = input_size if k == 0 else hidden_size * len(self.directions)
            for sfx in self.directions:
                self.register_parameter(f"weight_ih_l{k}{sfx}",
                                        nn.Parameter(torch.empty(gates * hidden_size, width, **f)))
                self.register_parameter(f"weight_hh_l{k}{sfx}",
                                        nn.Parameter(torch.empty(gates * hidden_size, hidden_size, **f)))
                if kind == "gru":
                    self.register_parameter(f"bias_ih_l{k}{sfx}", nn.Parameter(torch.zeros(gates * hidden_size, **f)))
                self.register_parameter(f"bias_hh_l{k}{sfx}", nn.Parameter(
                    torch.zeros((4 * hidden_size) if kind == "lstm" else hidden_size, **f)))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """``nn.LSTM``'s default: every parameter uniform in +-1/sqrt(hidden_size)."""
        bound = 1.0 / math.sqrt(self.hidden_size)
        for p in self.parameters():
            p.uniform_(-bound, bound)

    def _direction(self, x: torch.Tensor, k: int, sfx: str) -> torch.Tensor:
        w_ih, w_hh = getattr(self, f"weight_ih_l{k}{sfx}"), getattr(self, f"weight_hh_l{k}{sfx}")
        b_hh = getattr(self, f"bias_hh_l{k}{sfx}")
        dt = w_ih.dtype
        B, T, H = x.shape[0], x.shape[1], self.hidden_size
        x = x.to(dt)
        h = torch.zeros((B, H), dtype=torch.float32, device=x.device)
        out = [None] * T
        steps = range(T - 1, -1, -1) if sfx else range(T)
        if self.kind == "lstm":
            gi = F.linear(x, w_ih)
            c = h
            for t in steps:
                i, f, g, o = (F.linear(h.to(dt), w_hh, b_hh) + gi[:, t]).chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = out[t] = torch.sigmoid(o) * torch.tanh(c)
        else:
            gi = F.linear(x, w_ih, getattr(self, f"bias_ih_l{k}{sfx}"))
            for t in steps:
                hd = h.to(dt)
                hr, hz = F.linear(hd, w_hh[:2 * H]).chunk(2, dim=-1)
                ir, iz, in_ = gi[:, t].chunk(3, dim=-1)
                r, z = torch.sigmoid(ir + hr), torch.sigmoid(iz + hz)
                n = torch.tanh(in_ + r * F.linear(hd, w_hh[2 * H:], b_hh))
                h = out[t] = (1.0 - z) * n + z * h
        return torch.stack(out, dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k in range(self.num_layers):
            x = torch.cat([self._direction(x, k, sfx) for sfx in self.directions], dim=-1)
            if k + 1 < self.num_layers:
                x = self.dropout(x)
        return x


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer with ``nn.TransformerEncoderLayer``'s defaults and names."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int, dropout: float = 0.1, device=None,
                 dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout, **f)
        self.linear1 = nn.Linear(d_model, dim_feedforward, **f)
        self.linear2 = nn.Linear(dim_feedforward, d_model, **f)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, **f)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, **f)
        self.dropout, self.dropout1, self.dropout2 = nn.Dropout(dropout), nn.Dropout(dropout), nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.dropout1(self.self_attn(x, x, x)))
        return self.norm2(x + self.dropout2(self.linear2(self.dropout(torch.relu(self.linear1(x))))))


class TransformerEncoder(nn.Module):
    def __init__(self, layers: list[TransformerEncoderLayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class SequenceEncoder(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int = 256, encoder_type: str = "lstm", num_layers: int = 1,
                 bidirectional: bool = True, dropout: float = 0.1, num_heads: int = 4, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.kind = encoder_type.lower()
        if self.kind in ("lstm", "gru"):
            self.rnn = RNN(self.kind, input_dim, hidden_dim, num_layers, bidirectional,
                           dropout if num_layers > 1 else 0.0, **f)
            out_dim = hidden_dim * (2 if bidirectional else 1)
        elif self.kind == "transformer":
            ff = max(hidden_dim * 4, input_dim * 2)
            self.encoder = TransformerEncoder([TransformerEncoderLayer(input_dim, num_heads, ff, dropout, **f)
                                               for _ in range(num_layers)])
            out_dim = input_dim
        else:
            raise ValueError(f"Unsupported sequence encoder type: {encoder_type}")
        self.proj = nn.Linear(out_dim, hidden_dim, **f) if out_dim != hidden_dim else None

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, input_dim). Returns (B, hidden_dim) in the module's dtype."""
        dt = self.dtype
        if self.kind == "transformer":
            h = x.to(dt) + sinusoidal_pe(x.shape[1], x.shape[2], x.device, dt)
            out = self.encoder(h).mean(dim=1)
        else:
            out = self.rnn(x)[:, -1, :]
        return (self.proj(out.to(dt)) if self.proj is not None else out).to(dt)
