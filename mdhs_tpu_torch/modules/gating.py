"""The dual-expert gate of the baseline family.

Counterpart of ``mdhs_tpu/modules/gating.py::DualExpertGate``: an MLP over
the concatenation of the local feature, the context feature and (with
``use_entropy``) the entropy of the local logits, cast to the local
feature's dtype, gives the weight alpha of the local logits; the sigmoid is
taken in float32. Names are the reference's ``fc.0`` and ``fc.2``
(``gate.fc.{0,2}``, which ``mdhs_tpu.core.convert.convert_baseline_full``
reads).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class DualExpertGate(nn.Module):
    def __init__(self, feature_dim: int, hidden_dim: int = 128, use_entropy: bool = True, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.use_entropy = use_entropy
        self.fc = nn.Sequential(nn.Linear(2 * feature_dim + int(use_entropy), hidden_dim, **f), nn.ReLU(),
                                nn.Linear(hidden_dim, 1, **f))

    def forward(self, local_feat: torch.Tensor, context_feat: torch.Tensor,
                entropy: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, 1) float32 alpha."""
        parts = [local_feat, context_feat]
        if self.use_entropy:
            if entropy is None:
                raise ValueError("entropy is required when use_entropy=True")
            parts.append(entropy.to(local_feat.dtype))
        return torch.sigmoid(self.fc(torch.cat(parts, dim=-1)).float())
