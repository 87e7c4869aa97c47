"""The tabular (metadata) branch of the baseline family.

Counterpart of ``mdhs_tpu/modules/tabular.py``: Linear -> ReLU -> Dropout ->
Linear, named ``net.0`` and ``net.3`` as the reference's ``nn.Sequential``
(``tabular_encoder.net.{0,3}``, which ``mdhs_tpu.core.convert.
convert_baseline_full`` reads). The input is cast to the module's dtype, as
the JAX module casts it.
"""

from __future__ import annotations

import torch
from torch import nn


class TabularEncoder(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int = 128, dropout: float = 0.1, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.net = nn.Sequential(nn.Linear(input_dim, hidden_dim, **f), nn.ReLU(), nn.Dropout(dropout),
                                 nn.Linear(hidden_dim, hidden_dim, **f))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x.to(self.net[0].weight.dtype))
