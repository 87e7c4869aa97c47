"""MIBF-Net: ResNet50 + BERT with IBFA dual cross-attention and three heads.

Counterpart of ``mdhs_tpu/models/mibf.py``. Submodule names are the ones
``mdhs_tpu.core.convert.convert_mibf_full`` reads: ``text_encoder.bert.*``,
``image_encoder.*``, ``{textbased,imagbased}_cross_attention.*``, ``fc``,
``fc_image.{1,3}`` and ``fc_text.{1,3}``.

In training mode (``model.train()``) BatchNorm takes batch statistics and
BERT's dropout is live at the JAX package's four places
(``mdhs_tpu/models/bert.py:228, :338, :376, :415``); ``bn_stats_kernel=True``
makes the ResNet tower's BatchNorms take those statistics from the
``bn_stats`` kernel (``models/norm.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..modules.attention import JointKVCrossAttention
from .bert import BertConfig, BertModel
from .resnet import ResNetClassifier


class TextEncoder(nn.Module):
    """Holds the BERT under the reference's ``text_encoder.bert`` prefix."""

    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        self.bert = BertModel(cfg, device=device, dtype=dtype)

    def forward(self, input_ids, attention_mask):
        return self.bert(input_ids, attention_mask)


def _mlp_head(num_labels: int, **factory) -> nn.Sequential:
    return nn.Sequential(
        nn.Flatten(1), nn.Linear(768, 512, **factory), nn.ReLU(), nn.Linear(512, num_labels, **factory)
    )


class MIBFNet(nn.Module):
    normalize_input = False  # the MIBF pipeline has no Normalize

    def __init__(self, num_labels: int = 6, bert: BertConfig = BertConfig(), bn_stats_kernel: bool = False,
                 device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.text_encoder = TextEncoder(bert, **f)
        self.image_encoder = ResNetClassifier("resnet50", num_outputs=768, bn_stats_kernel=bn_stats_kernel, **f)
        text = bert.hidden_size  # 768 for BERT-base; the cross-attentions project any width to 768
        self.textbased_cross_attention = JointKVCrossAttention(768, 1, y_dim=text, **f)
        self.imagbased_cross_attention = JointKVCrossAttention(768, 1, x_dim=text, **f)
        self.fc = nn.Linear(768 * 2, num_labels, **f)
        self.fc_image = _mlp_head(num_labels, **f)
        self.fc_text = _mlp_head(num_labels, **f)

    @property
    def input_dtype(self) -> torch.dtype:
        """The dtype the image tower takes (its stem convolution's)."""
        return self.image_encoder.conv1.weight.dtype

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> dict[str, torch.Tensor]:
        """images: (B, 3, H, W) NCHW. Returns float32 logits of the three heads."""
        text_last, _ = self.text_encoder(input_ids, attention_mask)
        text_seq = text_last[:, 0:1, :]  # CLS token, (B, 1, 768)
        image_feat, _ = self.image_encoder(images)
        image_seq = image_feat[:, None, :]
        text_fused = self.textbased_cross_attention(image_seq, text_seq)  # Q = image
        image_fused = self.imagbased_cross_attention(text_seq, image_seq)  # Q = text
        B = images.shape[0]
        p = torch.cat([text_fused.reshape(B, 768), image_fused.reshape(B, 768)], dim=1)
        return {
            "image_text": self.fc(p).float(),
            "text": self.fc_text(text_fused).float(),
            "image": self.fc_image(image_fused).float(),
        }
