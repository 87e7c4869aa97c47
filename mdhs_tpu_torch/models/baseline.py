"""MultimodalBaselineModel, the configurable baseline family.

Counterpart of ``mdhs_tpu/models/baseline.py``: ResNet tokens + BERT text
tokens -> a fusion (``modules/fusion.py``) -> a classifier head
(``modules/heads.py``), with the ablation modes ``image_only`` (the pooled
image tokens straight to the head) and ``text_off`` (the text tokens
zeroed). Images are NCHW, ImageNet-normalised (``normalize_input``).
Submodule names are the reference's (``image_encoder.model``,
``image_encoder.proj{2,3,4}``, ``text_encoder.model``, ``fusion``,
``classifier``), which ``mdhs_tpu.core.convert.convert_baseline_full`` reads.

Ported: all nine fusions (``modules/fusion.py``: ``basic``, ``multiscale``,
``concat``, ``weighted_concat``, ``hadamard``, ``bilinear``,
``hierarchical``, ``mamba``, ``vmamba``; their state-dict keys under
``fusion.`` are listed there) and every head (``mlp``, ``residual``,
``attention_pooling``, ``kan``, ``moe``), served and trained:
``configs/common/base.yml`` and the ``configs/ham/*_v1.yml`` and
``configs/spine/*_v1.yml`` built on those. The tower is multi-scale for
``multiscale`` and ``hierarchical``; ``hierarchical`` cross-attends to BERT's
hidden states ``round(L * i / 3)`` (at least 1) for i = 1, 2, 3, (4, 8, 12)
for BERT-base, all of them zeroed under ``text_off``. And the branches
(``baseline.py:124-358``):

- the sequence encoder (``modules/sequence.py``): a 5-D input (B, T, 3, H,
  W), the slices of a sequence or the views of one image, goes through the
  image tower as one B * T stack; each slice's pooled tokens make a (B, T,
  hidden) sequence, encoded to one (B, hidden) vector (``sequence_proj``
  where ``sequence_encoder.hidden_dim`` differs), which is the image tokens
  as a length-1 sequence (copied to the three scales for ``multiscale`` and
  ``hierarchical``);
- the global/local stream: the image tower runs a second time on the
  center crop of ``crop_ratio`` (``int(H * ratio)`` at offset ``(H - ch) //
  2``) resized back to H x W bilinearly as ``jax.image.resize`` does it
  (``resize_weights``: its weight matrices, made on the host and applied as
  two products), and the two token sets are averaged, or concatenated and
  projected (``global_local_proj``, ``combine: concat``); the multiscale
  dict is averaged under either, as in JAX. In training the tower's
  BatchNorm sees both batches in turn, as flax's mutable ``batch_stats``;
- the tabular branch (``modules/tabular.py``): the fused feature and the
  encoded (B, tabular_input_dim) float32 record through ``tabular_fusion``
  (Linear, ReLU, Dropout);
- the dual-expert gate (``modules/gating.py``): ``forward`` computes the
  context feature (``gate.context_mode``, "full" = no ablation) and the
  local one (``gate.local_mode``), both logits, the entropy of the local
  softmax in float32 (+1e-8) and alpha, and returns alpha * local + (1 -
  alpha) * context. Out of training the two passes share one pass of the
  image tower (XLA shares it in the JAX program); in training each runs it.
  Training uses the ungated ``features_and_logits``, as the JAX Trainer
  does, so the gate's parameters never train in either package.

``sequence_proj`` and ``global_local_proj`` exist exactly where the JAX
model's init creates parameters for them. ``features_and_logits`` is the
training forward (``baseline.py:352-358``): the fused feature, the logits and
the MoE head's balance loss (None for the other heads). The fusion and head
dropout is the config's clamped to 0.1, as in JAX; the ResNet's BatchNorm
follows the module's train/eval mode. ``remat`` raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

import numpy as np

from ..device import device_constant
from ..modules.fusion import SCALES, build_fusion, pool_image
from ..modules.gating import DualExpertGate
from ..modules.heads import MoEHead, build_head
from ..modules.sequence import SequenceEncoder
from ..modules.tabular import TabularEncoder
from .bert import BertConfig
from .encoders import ImageTokenEncoder, TextEncoder

ABLATION_MODES = (None, "image_only", "text_off")
MULTI_SCALE_FUSIONS = ("multiscale", "hierarchical")  # the fusions that take the {layer2, layer3, layer4} dict


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
        if self.remat != "none":
            raise NotImplementedError(f"remat={self.remat!r} is a training knob: ROADMAP Queue 1 item 8")


_RESIZE: dict = {}


def resize_weights(n_in: int, n_out: int, device, dtype: torch.dtype) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize(..., "bilinear")`` along one axis
    (``jax/_src/image/scale.py::compute_weight_mat``: the triangle kernel at
    ``(i + 0.5) * n_in / n_out - 0.5``, unscaled when upsampling, each column
    normalised, zero where the sample lies outside the input), in float32 on the
    host, cast to ``dtype`` as JAX casts them to the image's; made once for each
    (n_in, n_out, device, dtype)."""
    def make():
        scale = n_out / n_in
        inv = np.float32(1.0 / scale)
        sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
        kscale = max(np.float32(1.0 / scale), np.float32(1.0))
        x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / np.float32(kscale)
        wts = np.maximum(np.float32(0.0), np.float32(1.0) - x).astype(np.float32)
        total = wts.sum(axis=0, keepdims=True, dtype=np.float32)
        wts = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       wts / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0)).astype(np.float32)
        wts = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], wts, np.float32(0.0))
        return torch.from_numpy(np.ascontiguousarray(wts, np.float32)).to(device=device, dtype=dtype)

    return device_constant(_RESIZE, (n_in, n_out, torch.device(device), dtype), make)


def center_crop_resize(x: torch.Tensor, ratio: float) -> torch.Tensor:
    """(N, C, H, W) -> the center crop of ``ratio`` (``int(H * ratio)`` rows at
    ``(H - ch) // 2``) resized back to H x W as ``jax.image.resize`` bilinear
    (``baseline.py:198-208``), in x's dtype and ``channels_last`` memory."""
    H, W = x.shape[-2:]
    ch, cw = max(1, int(H * ratio)), max(1, int(W * ratio))
    y0, x0 = max(0, (H - ch) // 2), max(0, (W - cw) // 2)
    crop = x[..., y0:y0 + ch, x0:x0 + cw]
    if (ch, cw) == (H, W):
        return crop
    wh, ww = resize_weights(ch, H, x.device, x.dtype), resize_weights(cw, W, x.device, x.dtype)
    out = torch.matmul(wh.transpose(0, 1), torch.matmul(crop, ww))
    return out.contiguous(memory_format=torch.channels_last)


class MultimodalBaselineModel(nn.Module):
    normalize_input = True  # ImageNet normalisation (the JAX Trainer's family != "mibf")

    def __init__(self, cfg: BaselineConfig, device=None, dtype=None):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        f = dict(device=device, dtype=dtype)
        dropout = min(cfg.dropout, 0.1)  # fusion and head, as the JAX model clamps it
        multi_scale = cfg.fusion_type in MULTI_SCALE_FUSIONS
        self.image_encoder = ImageTokenEncoder(cfg.hidden_dim, cfg.image_backbone, multi_scale=multi_scale, **f)
        self.text_encoder = TextEncoder(cfg.bert, **f)
        if cfg.sequence_enabled:
            self.sequence_encoder = SequenceEncoder(cfg.hidden_dim, cfg.sequence_hidden_dim, cfg.sequence_type,
                                                    cfg.sequence_num_layers, cfg.sequence_bidirectional,
                                                    cfg.sequence_dropout, cfg.sequence_num_heads, **f)
            if cfg.sequence_hidden_dim != cfg.hidden_dim:
                self.sequence_proj = nn.Linear(cfg.sequence_hidden_dim, cfg.hidden_dim, **f)
        # the multiscale dict is averaged under "concat" too, so the projection is never called there
        if cfg.global_local_enabled and cfg.global_local_combine == "concat" and not multi_scale:
            self.global_local_proj = nn.Linear(2 * cfg.hidden_dim, cfg.hidden_dim, **f)
        L = cfg.bert.num_hidden_layers  # hierarchical taps thirds of BERT's stack, as the JAX model does
        self.fusion = build_fusion(cfg.fusion_type, text_dim=cfg.text_feature_dim, hidden_dim=cfg.hidden_dim,
                                   num_heads=cfg.num_heads, dropout=dropout, text_pool=cfg.text_pool,
                                   text_layers=tuple(max(1, round(L * i / 3)) for i in (1, 2, 3)), **f)
        if cfg.tabular_enabled:
            if cfg.tabular_input_dim <= 0:
                raise ValueError("tabular_input_dim must be > 0 when tabular is enabled.")
            self.tabular_encoder = TabularEncoder(cfg.tabular_input_dim, cfg.tabular_hidden_dim, cfg.tabular_dropout,
                                                  **f)
            self.tabular_fusion = nn.Sequential(nn.Linear(cfg.hidden_dim + cfg.tabular_hidden_dim, cfg.hidden_dim,
                                                          **f), nn.ReLU(), nn.Dropout(dropout))
        if cfg.gate_enabled:
            self.gate = DualExpertGate(cfg.hidden_dim, cfg.gate_hidden_dim, cfg.gate_use_entropy, **f)
        self.classifier = build_head(cfg.classifier_type, hidden_dim=cfg.hidden_dim, num_classes=cfg.num_classes,
                                     dropout=dropout, num_heads=cfg.num_heads, kan_num_groups=cfg.kan_num_groups,
                                     kan_act_mode=cfg.kan_act_mode, moe_num_experts=cfg.moe_num_experts,
                                     moe_k=cfg.moe_k, **f)

    @property
    def input_dtype(self) -> torch.dtype:
        """The dtype the image tower takes (its stem convolution's)."""
        return self.image_encoder.model.conv1.weight.dtype

    def _image_tokens(self, images: torch.Tensor):
        """The tower's tokens of (N, 3, H, W) images, with the local stream combined in."""
        tokens, _ = self.image_encoder(images)
        if not self.cfg.global_local_enabled:
            return tokens
        local, _ = self.image_encoder(center_crop_resize(images, self.cfg.global_local_crop_ratio))
        if isinstance(tokens, dict):
            return {k: 0.5 * (tokens[k] + local[k]) for k in tokens}
        if self.cfg.global_local_combine == "concat":
            return self.global_local_proj(torch.cat([tokens, local], dim=-1))
        return 0.5 * (tokens + local)

    def encode_images(self, images: torch.Tensor):
        """(image tokens, pooled image feature) of (B, 3, H, W) images, or of a
        (B, T, 3, H, W) sequence through the sequence encoder."""
        if images.ndim == 5:
            if not self.cfg.sequence_enabled:
                raise ValueError("Sequence input provided but sequence encoder is disabled.")
            B, T = images.shape[:2]
            pooled = pool_image(self._image_tokens(images.flatten(0, 1)))
            seq = self.sequence_encoder(pooled.reshape(B, T, -1))
            if hasattr(self, "sequence_proj"):
                seq = self.sequence_proj(seq)
            return seq[:, None, :], seq
        tokens = self._image_tokens(images)
        return tokens, pool_image(tokens)

    def forward_features(self, images: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                         ablation_mode: Optional[str] = None, tabular: Optional[torch.Tensor] = None,
                         encoded=None) -> torch.Tensor:
        """The fused (B, hidden_dim) feature, or the pooled image feature for
        ``image_only``; ``encoded`` is ``encode_images``' result where the caller has it."""
        if ablation_mode not in ABLATION_MODES:
            raise ValueError(f"ablation_mode={ablation_mode!r}: expected one of {ABLATION_MODES}")
        tokens, pooled = encoded if encoded is not None else self.encode_images(images)
        if ablation_mode == "image_only":
            return pooled
        text_tokens, text_hidden = self.text_encoder(input_ids, attention_mask)
        if ablation_mode == "text_off":
            text_tokens = torch.zeros_like(text_tokens)
            text_hidden = tuple(torch.zeros_like(h) for h in text_hidden)
        if self.cfg.sequence_enabled and self.cfg.fusion_type in MULTI_SCALE_FUSIONS and not isinstance(tokens, dict):
            tokens = dict.fromkeys(SCALES, tokens)
        if self.cfg.fusion_type == "hierarchical":
            fused = self.fusion(tokens, text_tokens, attention_mask, text_hidden_states=text_hidden)
        else:
            fused = self.fusion(tokens, text_tokens, attention_mask)
        if self.cfg.tabular_enabled:
            if tabular is None:
                raise ValueError("tabular_input is required when tabular is enabled.")
            fused = self.tabular_fusion(torch.cat([fused, self.tabular_encoder(tabular)], dim=-1))
        return fused

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                ablation_mode: Optional[str] = None, tabular: Optional[torch.Tensor] = None) -> torch.Tensor:
        """images: (B, 3, H, W) or (B, T, 3, H, W); tabular: (B, tabular_input_dim)
        float32 where the branch is on. Returns float32 logits (B, num_classes)."""
        c = self.cfg
        if ablation_mode is not None or not c.gate_enabled:
            return self.classifier(self.forward_features(images, input_ids, attention_mask, ablation_mode, tabular))
        encoded = None if self.training else self.encode_images(images)
        context_mode = None if c.gate_context_mode == "full" else c.gate_context_mode
        context = self.forward_features(images, input_ids, attention_mask, context_mode, tabular, encoded)
        local = self.forward_features(images, input_ids, attention_mask, c.gate_local_mode, tabular, encoded)
        logits_context, logits_local = self.classifier(context), self.classifier(local)
        entropy = None
        if c.gate_use_entropy:
            probs = torch.softmax(logits_local.float(), dim=1)
            entropy = -(probs * torch.log(probs + 1e-8)).sum(dim=1, keepdim=True)
        alpha = self.gate(local, context, entropy)
        return alpha * logits_local + (1 - alpha) * logits_context

    def features_and_logits(self, images: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                            ablation_mode: Optional[str] = None, generator: Optional[torch.Generator] = None,
                            noise: Optional[torch.Tensor] = None, tabular: Optional[torch.Tensor] = None):
        """(fused feature, float32 logits, the MoE head's balance loss or None):
        the training forward, ungated. ``generator`` (or a test's ``noise``) draws the
        MoE head's gating noise."""
        feats = self.forward_features(images, input_ids, attention_mask, ablation_mode, tabular)
        if isinstance(self.classifier, MoEHead):
            logits, balance = self.classifier.logits_and_balance(feats, generator, noise)
            return feats, logits, balance
        return feats, self.classifier(feats), None
