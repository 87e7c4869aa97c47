"""ConNexT: ConvNeXt + BERT with bidirectional 1x1-conv cross-attention and a
linear or KAN-expert MoE head, eval forward.

Counterpart of ``mdhs_tpu/models/connext.py::ConNexTClassifier``: the
ConvNeXt map (B, 7, 7, C) is reduced to ``fusion_dim`` by a 1x1 convolution;
BERT's CLS vector becomes a 1x1 map; ``textbased_cross_attention`` takes Q
from the image map and K, V from the text map, ``imagbased_cross_attention``
the reverse; both outputs are mean-pooled and summed, and the head (``fc``
or ``moe``) gives the logits. ``forward`` returns (logits float32, the MoE's
balance loss or 0), as the JAX module does. Images are NCHW,
ImageNet-normalised (``normalize_input``: the JAX Trainer normalises every
family but MIBF).

Submodule names are the reference's, which
``mdhs_tpu.core.convert.convert_connext_full`` reads: ``text_encoder.bert.*``
(HF BertModel), ``image_encoder.*`` (HF ConvNextModel), ``conv`` (the 1x1
reduction), ``{textbased,imagbased}_cross_attention.{query,key,value}_conv``
and ``fc`` or ``moe.*``. The multimodal-Mamba fusion and training (the noisy
gating and the balance loss's gradient) are not ported: ROADMAP Queue 1
item 11.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..modules.attention import ConvCrossAttention2D
from ..modules.moe import MoE
from .bert import BertConfig
from .convnext import CONVNEXT_SPECS, ConvNeXt
from .mibf import TextEncoder


@dataclasses.dataclass(frozen=True)
class ConNexTConfig:
    """The fields of ``mdhs_tpu.models.connext.ConNexTClassifier`` but its dtype,
    with the same defaults."""

    num_labels: int = 7
    convnext_variant: str = "base"
    fusion_dim: int = 768
    head: str = "linear"  # "linear" | "moe"
    moe_num_experts: int = 4
    moe_k: int = 2
    moe_expert_layers: Optional[tuple] = None  # None: the reference's [in, 512, 128, 32, out]
    use_mamba_fusion: bool = False
    llm_hidden_dim: int = 3584
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    remat: str = "none"

    def check_ported(self) -> None:
        if self.use_mamba_fusion:
            raise NotImplementedError("ConNexT's multimodal Mamba fusion (use_mamba_fusion) is not ported yet: "
                                      "ROADMAP Queue 1 item 11")
        if self.remat != "none":
            raise NotImplementedError(f"remat={self.remat!r} is a training knob: ROADMAP Queue 1 item 8")


class ConNexTClassifier(nn.Module):
    normalize_input = True

    def __init__(self, cfg: ConNexTConfig = ConNexTConfig(), device=None, dtype=None):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        f = dict(device=device, dtype=dtype)
        D = cfg.fusion_dim
        self.text_encoder = TextEncoder(cfg.bert, **f)
        self.image_encoder = ConvNeXt(cfg.convnext_variant, **f)
        self.conv = nn.Conv2d(CONVNEXT_SPECS[cfg.convnext_variant][1][-1], D, 1, **f)
        text = cfg.bert.hidden_size  # BERT's CLS as a 1x1 map of this many channels
        self.textbased_cross_attention = ConvCrossAttention2D(D, y_dim=text, **f)
        self.imagbased_cross_attention = ConvCrossAttention2D(D, x_dim=text, **f)
        if cfg.head == "moe":
            self.moe = MoE(D, cfg.num_labels, cfg.moe_num_experts, cfg.moe_k, cfg.moe_expert_layers, **f)
        else:
            self.fc = nn.Linear(D, cfg.num_labels, **f)

    @property
    def input_dtype(self) -> torch.dtype:
        """The dtype the image tower takes (its stem convolution's)."""
        return self.image_encoder.embeddings.patch_embeddings.weight.dtype

    def towers(self, images: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor):
        """(BERT's CLS vector (B, 768), the ConvNeXt map (B, H, W, C) NHWC)."""
        text_last, _ = self.text_encoder(input_ids, attention_mask)
        return text_last[:, 0, :], self.image_encoder(images)

    def fuse(self, text_cls: torch.Tensor, fmap: torch.Tensor) -> torch.Tensor:
        """The towers' outputs -> the fused (B, fusion_dim) feature the head takes."""
        reduced = F.linear(fmap, self.conv.weight.flatten(1), self.conv.bias)  # the 1x1 convolution, NHWC
        text_map = text_cls[:, None, None, :].to(reduced.dtype)
        p1 = self.textbased_cross_attention(reduced, text_map).mean(dim=(1, 2))
        p2 = self.imagbased_cross_attention(text_map, reduced).mean(dim=(1, 2))
        return p1 + p2

    def forward_features(self, images: torch.Tensor, input_ids: torch.Tensor,
                         attention_mask: torch.Tensor) -> torch.Tensor:
        return self.fuse(*self.towers(images, input_ids, attention_mask))

    def classify(self, fused: torch.Tensor):
        """(logits (B, num_labels) float32, balance loss)."""
        if self.cfg.head == "moe":
            return self.moe(fused)
        return self.fc(fused).float(), torch.zeros((), dtype=torch.float32, device=fused.device)

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor):
        """images: (B, 3, H, W). Returns (logits (B, num_labels) float32, balance loss)."""
        return self.classify(self.forward_features(images, input_ids, attention_mask))
