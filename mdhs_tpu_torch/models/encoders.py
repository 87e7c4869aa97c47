"""Image token encoder and text encoder of the baseline family.

Counterpart of ``mdhs_tpu/models/encoders.py``. ``ImageTokenEncoder`` runs
the port's ResNet on NCHW images and flattens its layer2/3/4 taps in NHWC
order to (B, H*W, C) token sequences, each projected to ``feature_dim``
(the JAX ``proj_layer{2,3,4}``). Names follow the reference torch modules,
``model.*`` (torchvision ResNet) and ``proj{2,3,4}``; ``TextEncoder`` holds
the BERT as ``model.*`` (HF BertModel). ``mdhs_tpu.core.convert.
convert_baseline_full`` reads both. MambaVision backbones raise
``NotImplementedError`` until they are ported.
"""

from __future__ import annotations

import torch
from torch import nn

from .bert import BertConfig, BertModel
from .resnet import BLOCK_CLS, ResNet


class ImageTokenEncoder(nn.Module):
    def __init__(self, feature_dim: int = 512, backbone: str = "resnet18", multi_scale: bool = False,
                 device=None, dtype=None):
        super().__init__()
        if backbone.startswith("mamba_vision_"):
            raise NotImplementedError(f"backbone={backbone!r} (MambaVision) is not ported yet: "
                                      "ROADMAP Queue 1 item 11")
        f = dict(device=device, dtype=dtype)
        self.model = ResNet(backbone, **f)
        self.multi_scale = multi_scale
        width = {f"layer{i}": w * BLOCK_CLS[backbone].expansion for i, w in ((2, 128), (3, 256), (4, 512))}
        if multi_scale:
            self.proj2 = nn.Linear(width["layer2"], feature_dim, **f)
            self.proj3 = nn.Linear(width["layer3"], feature_dim, **f)
        self.proj4 = nn.Linear(width["layer4"], feature_dim, **f)

    def forward(self, x: torch.Tensor):
        """x: (B, 3, H, W). Returns (tokens, taps): tokens (B, N, feature_dim),
        or the {layer2, layer3, layer4} dict when multi_scale."""
        taps = self.model(x)

        def tokens(key: str, proj: nn.Linear) -> torch.Tensor:
            return proj(taps[key].flatten(2).transpose(1, 2))  # (B, C, H, W) -> (B, H*W, C)

        if self.multi_scale:
            return {k: tokens(k, getattr(self, f"proj{k[-1]}")) for k in ("layer2", "layer3", "layer4")}, taps
        return tokens("layer4", self.proj4), taps


class TextEncoder(nn.Module):
    """BERT under the reference's ``text_encoder.model`` prefix; returns
    (last hidden state, all hidden states)."""

    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        self.model = BertModel(cfg, device=device, dtype=dtype)

    def forward(self, input_ids, attention_mask):
        return self.model(input_ids, attention_mask)
