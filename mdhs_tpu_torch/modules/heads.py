"""Classifier heads of the baseline family.

Counterpart of ``mdhs_tpu/modules/heads.py``, every ``classifier_type``:

- ``mlp``: Linear -> ReLU -> Dropout -> Linear, named ``0`` and ``3`` as the
  reference's ``nn.Sequential``;
- ``residual``: ``project`` -> ReLU -> ``res_block`` (``linear1`` -> ReLU ->
  Dropout -> ``linear2``, LayerNorm ``norm`` of the sum with its input) ->
  ``classifier``, the reference's ``ResidualClassifier`` names, which
  ``mdhs_tpu.core.convert._convert_head`` reads;
- ``attention_pooling``: a learned ``query`` attending through ``attn`` over
  the fused vector as a length-1 sequence, then ``classifier``;
- ``kan``: ``kan1`` (GroupKANLinear, dropout on its activation) -> LayerNorm
  ``norm`` -> ``kan2`` (no dropout), base.yml's default head;
- ``moe``: the KAN-expert MoE of ``modules/moe.py`` on the dropped-out input.

The ``attention_pooling`` and ``kan`` names follow the JAX tree (no torch
converter reads them). Every head returns float32 logits. In training the
MoE head gates with noise from a generator the caller gives and hands back
its balance loss (``logits_and_balance``), which the JAX head sows into the
``aux_loss`` collection for the trainer.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .attention import MultiHeadAttention
from .kan import GroupKANLinear
from .moe import MoE


class MLPHead(nn.Sequential):
    def __init__(self, hidden_dim: int, num_classes: int, dropout: float = 0.1, device=None, dtype=None):
        f = dict(device=device, dtype=dtype)
        super().__init__(nn.Linear(hidden_dim, hidden_dim, **f), nn.ReLU(), nn.Dropout(dropout),
                         nn.Linear(hidden_dim, num_classes, **f))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).float()


class ResidualBlock(nn.Module):
    def __init__(self, dim: int, dropout: float, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.linear1 = nn.Linear(dim, dim, **f)
        self.linear2 = nn.Linear(dim, dim, **f)
        self.dropout = nn.Dropout(dropout)
        self.norm = nn.LayerNorm(dim, eps=1e-5, **f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x + self.linear2(self.dropout(torch.relu(self.linear1(x)))))


class ResidualHead(nn.Module):
    def __init__(self, hidden_dim: int, num_classes: int, dropout: float = 0.1, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.project = nn.Linear(hidden_dim, hidden_dim, **f)
        self.res_block = ResidualBlock(hidden_dim, dropout, **f)
        self.classifier = nn.Linear(hidden_dim, num_classes, **f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.res_block(torch.relu(self.project(x)))).float()


class AttentionPoolingHead(nn.Module):
    def __init__(self, hidden_dim: int, num_classes: int, num_heads: int = 4, dropout: float = 0.1, device=None,
                 dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.query = nn.Parameter(torch.zeros((1, 1, hidden_dim), **f))
        self.attn = MultiHeadAttention(hidden_dim, num_heads, dropout, **f)
        self.classifier = nn.Linear(hidden_dim, num_classes, **f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = x[:, None, :]
        q = self.query.expand(x.shape[0], 1, -1).to(x.dtype)
        return self.classifier(self.attn(q, seq, seq)[:, 0]).float()


class KANHead(nn.Module):
    def __init__(self, hidden_dim: int, num_classes: int, dropout: float = 0.1, num_groups: int = 8,
                 act_mode: str = "gelu", device=None, dtype=None):
        super().__init__()
        if hidden_dim % num_groups != 0:
            raise ValueError(f"kan num_groups ({num_groups}) must divide hidden_dim ({hidden_dim})")
        f = dict(device=device, dtype=dtype)
        self.kan1 = GroupKANLinear(hidden_dim, hidden_dim, num_groups, act_mode, drop=dropout, **f)
        self.norm = nn.LayerNorm(hidden_dim, eps=1e-5, **f)
        self.kan2 = GroupKANLinear(hidden_dim, num_classes, num_groups, act_mode, drop=0.0, **f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.kan2(self.norm(self.kan1(x))).float()


class MoEHead(nn.Module):
    """MoE over KAN experts of layers (hidden, 4 hidden, classes). ``forward``
    returns the logits; in training it needs the gating noise's ``generator``
    (or a test's ``noise``), and ``logits_and_balance`` also returns the
    balance loss the trainer weighs by ``model.moe.balance_weight``."""

    def __init__(self, hidden_dim: int, num_classes: int, dropout: float = 0.0, num_experts: int = 4,
                 k: int = 2, device=None, dtype=None):
        super().__init__()
        self.dropout = nn.Dropout(dropout)
        self.moe = MoE(hidden_dim, num_classes, num_experts, k,
                       expert_layers=(hidden_dim, 4 * hidden_dim, num_classes), device=device, dtype=dtype)

    def logits_and_balance(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                           noise: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
        logits, balance = self.moe(self.dropout(x), train=self.training, generator=generator, noise=noise)
        return logits.float(), balance

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.logits_and_balance(x, generator, noise)[0]


def build_head(classifier_type: str, *, hidden_dim: int, num_classes: int, dropout: float = 0.1,
               num_heads: int = 8, kan_num_groups: int = 8, kan_act_mode: str = "gelu", moe_num_experts: int = 4,
               moe_k: int = 2, device=None, dtype=None) -> nn.Module:
    """``mdhs_tpu/modules/heads.py::build_head``: ``num_heads`` reaches
    ``attention_pooling``, ``kan_*`` the ``kan`` head, ``moe_*`` the ``moe`` head."""
    f = dict(device=device, dtype=dtype)
    if classifier_type == "mlp":
        return MLPHead(hidden_dim, num_classes, dropout, **f)
    if classifier_type == "residual":
        return ResidualHead(hidden_dim, num_classes, dropout, **f)
    if classifier_type == "attention_pooling":
        return AttentionPoolingHead(hidden_dim, num_classes, num_heads, dropout, **f)
    if classifier_type == "kan":
        return KANHead(hidden_dim, num_classes, dropout, kan_num_groups, kan_act_mode, **f)
    if classifier_type == "moe":
        return MoEHead(hidden_dim, num_classes, dropout, moe_num_experts, moe_k, **f)
    raise KeyError(f"unknown classifier_type {classifier_type!r}")
