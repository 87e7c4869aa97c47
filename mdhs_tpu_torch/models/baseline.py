"""MultimodalBaselineModel, the configurable baseline family.

Counterpart of ``mdhs_tpu/models/baseline.py``: ResNet tokens + BERT text
tokens -> a fusion (``modules/fusion.py``) -> a classifier head
(``modules/heads.py``), with the ablation modes ``image_only`` (the pooled
image tokens straight to the head) and ``text_off`` (the text tokens
zeroed). Images are NCHW, ImageNet-normalised (``normalize_input``).
Submodule names are the reference's (``image_encoder.model``,
``image_encoder.proj{2,3,4}``, ``text_encoder.model``, ``fusion``,
``classifier``), which ``mdhs_tpu.core.convert.convert_baseline_full`` reads.

Ported: the ``multiscale`` and ``mamba`` fusions and every head (``mlp``,
``residual``, ``attention_pooling``, ``kan``, ``moe``), served and trained:
``configs/common/base.yml`` and the ``configs/ham/*_v1.yml`` built on those.
``features_and_logits`` is the training forward (``baseline.py:352-358``):
the fused feature, the logits and the MoE head's balance loss (None for the
other heads). The fusion and head dropout is the config's clamped to 0.1, as
in JAX; the ResNet's BatchNorm follows the module's train/eval mode. The
gate, the sequence encoder, the tabular branch and the global/local stream
raise ``NotImplementedError`` naming their ROADMAP item, as do the other
fusions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..modules.fusion import NOT_PORTED as NOT_PORTED_FUSIONS, build_fusion, pool_image
from ..modules.heads import MoEHead, build_head
from .bert import BertConfig
from .encoders import ImageTokenEncoder, TextEncoder

ABLATION_MODES = (None, "image_only", "text_off")


@dataclasses.dataclass(frozen=True)
class BaselineConfig:
    """Same fields and defaults as ``mdhs_tpu.models.baseline.BaselineConfig``."""

    num_classes: int = 7
    image_feature_dim: int = 512
    text_feature_dim: int = 768
    hidden_dim: int = 256
    dropout: float = 0.2
    num_heads: int = 8
    image_backbone: str = "resnet18"
    classifier_type: str = "mlp"
    fusion_type: str = "basic"
    text_pool: str = "cls"
    kan_num_groups: int = 8
    kan_act_mode: str = "gelu"
    moe_num_experts: int = 4
    moe_k: int = 2
    tabular_enabled: bool = False
    tabular_input_dim: int = 0
    tabular_hidden_dim: int = 128
    tabular_dropout: float = 0.1
    gate_enabled: bool = False
    gate_hidden_dim: int = 128
    gate_use_entropy: bool = True
    gate_local_mode: str = "image_only"
    gate_context_mode: str = "full"
    sequence_enabled: bool = False
    sequence_type: str = "lstm"
    sequence_hidden_dim: int = 256
    sequence_num_layers: int = 1
    sequence_bidirectional: bool = True
    sequence_dropout: float = 0.1
    sequence_num_heads: int = 4
    global_local_enabled: bool = False
    global_local_crop_ratio: float = 0.6
    global_local_combine: str = "avg"
    remat: str = "none"
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)

    def check_ported(self) -> None:
        """Raise for the options the port does not have yet, naming the
        ROADMAP item that ports each; never ignore one silently."""
        for flag, what in ((self.gate_enabled, "gate (dual-expert gating)"),
                           (self.sequence_enabled, "sequence encoder"),
                           (self.tabular_enabled, "tabular branch"),
                           (self.global_local_enabled, "global/local dual stream")):
            if flag:
                raise NotImplementedError(f"baseline {what} is not ported yet: ROADMAP Queue 1 item 10")
        if self.fusion_type in NOT_PORTED_FUSIONS:
            raise NotImplementedError(f"fusion_type={self.fusion_type!r} is not ported yet: ROADMAP Queue 1 item 10")
        if self.remat != "none":
            raise NotImplementedError(f"remat={self.remat!r} is a training knob: ROADMAP Queue 1 item 8")


class MultimodalBaselineModel(nn.Module):
    normalize_input = True  # ImageNet normalisation (the JAX Trainer's family != "mibf")

    def __init__(self, cfg: BaselineConfig, device=None, dtype=None):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        f = dict(device=device, dtype=dtype)
        dropout = min(cfg.dropout, 0.1)  # fusion and head, as the JAX model clamps it
        self.image_encoder = ImageTokenEncoder(cfg.hidden_dim, cfg.image_backbone,
                                               multi_scale=cfg.fusion_type == "multiscale", **f)
        self.text_encoder = TextEncoder(cfg.bert, **f)
        self.fusion = build_fusion(cfg.fusion_type, text_dim=cfg.text_feature_dim, hidden_dim=cfg.hidden_dim,
                                   num_heads=cfg.num_heads, dropout=dropout, text_pool=cfg.text_pool, **f)
        self.classifier = build_head(cfg.classifier_type, hidden_dim=cfg.hidden_dim, num_classes=cfg.num_classes,
                                     dropout=dropout, num_heads=cfg.num_heads, kan_num_groups=cfg.kan_num_groups,
                                     kan_act_mode=cfg.kan_act_mode, moe_num_experts=cfg.moe_num_experts,
                                     moe_k=cfg.moe_k, **f)

    @property
    def input_dtype(self) -> torch.dtype:
        """The dtype the image tower takes (its stem convolution's)."""
        return self.image_encoder.model.conv1.weight.dtype

    def forward_features(self, images: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                         ablation_mode: Optional[str] = None) -> torch.Tensor:
        """The fused (B, hidden_dim) feature, or the pooled image tokens for ``image_only``."""
        if ablation_mode not in ABLATION_MODES:
            raise ValueError(f"ablation_mode={ablation_mode!r}: expected one of {ABLATION_MODES}")
        tokens, _ = self.image_encoder(images)
        if ablation_mode == "image_only":
            return pool_image(tokens)
        text_tokens, _ = self.text_encoder(input_ids, attention_mask)
        if ablation_mode == "text_off":
            text_tokens = torch.zeros_like(text_tokens)
        return self.fusion(tokens, text_tokens, attention_mask)

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                ablation_mode: Optional[str] = None) -> torch.Tensor:
        """images: (B, 3, H, W). Returns float32 logits (B, num_classes)."""
        return self.classifier(self.forward_features(images, input_ids, attention_mask, ablation_mode))

    def features_and_logits(self, images: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                            ablation_mode: Optional[str] = None, generator: Optional[torch.Generator] = None,
                            noise: Optional[torch.Tensor] = None):
        """(fused feature, float32 logits, the MoE head's balance loss or None):
        the training forward. ``generator`` (or a test's ``noise``) draws the
        MoE head's gating noise."""
        feats = self.forward_features(images, input_ids, attention_mask, ablation_mode)
        if isinstance(self.classifier, MoEHead):
            logits, balance = self.classifier.logits_and_balance(feats, generator, noise)
            return feats, logits, balance
        return feats, self.classifier(feats), None
