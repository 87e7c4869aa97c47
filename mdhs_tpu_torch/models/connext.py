"""ConNexT: ConvNeXt + BERT with bidirectional 1x1-conv cross-attention and a
linear or KAN-expert MoE head.

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
and ``fc`` or ``moe.*``. ``forward(..., train=True, generator=g)`` is the
training forward of ``mdhs_tpu/models/connext.py:85-120``: the MoE gates with
noise drawn from ``g`` and returns its balance loss; BERT's dropout is live
where the module is in training mode (``model.train()``), drawing from
torch's default generator.

``use_mamba_fusion`` (``mdhs_tpu/models/connext.py:57-66``, ``:97-105``)
replaces the cross-attention fusion and the head: the ConvNeXt map's 49
tokens (NHWC order, ``img_dim`` its last width, 1024 for base), BERT's CLS
vector and the LLM's first and last hidden-state vectors (zeros where none
are given) go through ``mamba_fusion`` (``modules/multimodal_mamba.py``,
KAN attention then Mamba), and the logits are ``mamba_fc`` of the sequence's
mean, in float32, with a balance loss of 0. Only what that forward uses is
built (no ``conv``, cross-attention, ``fc`` or ``moe``), as flax creates
only the parameters of the submodules it calls.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..modules.attention import ConvCrossAttention2D
from ..modules.moe import MoE
from ..modules.multimodal_mamba import MultimodalMamba
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
        img_dim = CONVNEXT_SPECS[cfg.convnext_variant][1][-1]
        if cfg.use_mamba_fusion:
            self.mamba_fusion = MultimodalMamba(text_dim=cfg.bert.hidden_size, img_dim=img_dim,
                                                hidden_dim=cfg.llm_hidden_dim, proj_dim=256, use_kan_attention=True,
                                                **f)
            self.mamba_fc = nn.Linear(256, cfg.num_labels, **f)
            return
        self.conv = nn.Conv2d(img_dim, D, 1, **f)
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

    def mamba_features(self, text_cls: torch.Tensor, fmap: torch.Tensor, first_hidden: Optional[torch.Tensor] = None,
                       last_hidden: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The Mamba fusion's (B, 256) feature, the mean of its (B, N + 3, 256)
        sequence; zeros stand in for a hidden vector not given."""
        B = fmap.shape[0]
        zeros = None
        if first_hidden is None or last_hidden is None:
            zeros = fmap.new_zeros((B, self.cfg.llm_hidden_dim))
        fh = zeros if first_hidden is None else first_hidden.to(fmap.dtype)
        lh = zeros if last_hidden is None else last_hidden.to(fmap.dtype)
        return self.mamba_fusion(text_cls.to(fmap.dtype), fmap.reshape(B, -1, fmap.shape[-1]), fh, lh).mean(dim=1)

    def forward_features(self, images: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                         first_hidden: Optional[torch.Tensor] = None,
                         last_hidden: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The feature the head takes: the fused cross-attention feature, or the Mamba fusion's."""
        towers = self.towers(images, input_ids, attention_mask)
        if self.cfg.use_mamba_fusion:
            return self.mamba_features(*towers, first_hidden, last_hidden)
        return self.fuse(*towers)

    def classify(self, fused: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None):
        """(logits (B, num_labels) float32, balance loss); ``train`` gates the MoE
        with noise from ``generator`` (or the given ``noise``)."""
        if self.cfg.use_mamba_fusion:
            return self.mamba_fc(fused).float(), torch.zeros((), dtype=torch.float32, device=fused.device)
        if self.cfg.head == "moe":
            return self.moe(fused, train=train, generator=generator, noise=noise)
        return self.fc(fused).float(), torch.zeros((), dtype=torch.float32, device=fused.device)

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                train: bool = False, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, first_hidden: Optional[torch.Tensor] = None,
                last_hidden: Optional[torch.Tensor] = None):
        """images: (B, 3, H, W); first / last_hidden (B, llm_hidden_dim), read by the
        Mamba fusion only. Returns (logits (B, num_labels) float32, balance loss)."""
        fused = self.forward_features(images, input_ids, attention_mask, first_hidden, last_hidden)
        return self.classify(fused, train, generator, noise)
