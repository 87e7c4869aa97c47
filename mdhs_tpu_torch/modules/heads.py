"""Classifier heads of the baseline family, eval forward.

Counterpart of ``mdhs_tpu/modules/heads.py`` for ``mlp`` (Linear -> ReLU ->
Dropout -> Linear, named ``0`` and ``3`` as the reference's
``nn.Sequential``) and ``moe`` (the KAN-expert MoE of ``modules/moe.py``).
Both return float32 logits. ``kan``, ``residual`` and ``attention_pooling``
raise ``NotImplementedError`` until they are ported.
"""

from __future__ import annotations

import torch
from torch import nn

from .moe import MoE


class MLPHead(nn.Sequential):
    def __init__(self, hidden_dim: int, num_classes: int, dropout: float = 0.1, device=None, dtype=None):
        f = dict(device=device, dtype=dtype)
        super().__init__(nn.Linear(hidden_dim, hidden_dim, **f), nn.ReLU(), nn.Dropout(dropout),
                         nn.Linear(hidden_dim, num_classes, **f))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).float()


class MoEHead(nn.Module):
    """MoE over KAN experts of layers (hidden, 4 hidden, classes); returns the
    logits. Eval only: the baseline family's training path (its gating
    generator and balance loss in the loss) is ROADMAP Queue 1 item 10."""

    def __init__(self, hidden_dim: int, num_classes: int, dropout: float = 0.0, num_experts: int = 4,
                 k: int = 2, device=None, dtype=None):
        super().__init__()
        self.dropout = nn.Dropout(dropout)
        self.moe = MoE(hidden_dim, num_classes, num_experts, k,
                       expert_layers=(hidden_dim, 4 * hidden_dim, num_classes), device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("the baseline family's MoE head in training: ROADMAP Queue 1 item 10")
        logits, _ = self.moe(self.dropout(x))
        return logits.float()


_NOT_PORTED = ("kan", "residual", "attention_pooling")


def build_head(classifier_type: str, *, hidden_dim: int, num_classes: int, dropout: float = 0.1,
               moe_num_experts: int = 4, moe_k: int = 2, device=None, dtype=None) -> nn.Module:
    f = dict(device=device, dtype=dtype)
    if classifier_type == "mlp":
        return MLPHead(hidden_dim, num_classes, dropout, **f)
    if classifier_type == "moe":
        return MoEHead(hidden_dim, num_classes, dropout, moe_num_experts, moe_k, **f)
    if classifier_type in _NOT_PORTED:
        raise NotImplementedError(f"classifier_type={classifier_type!r} is not ported yet: ROADMAP Queue 1 item 10")
    raise KeyError(f"unknown classifier_type {classifier_type!r}")
