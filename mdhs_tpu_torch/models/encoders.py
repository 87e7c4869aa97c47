"""Image token encoder and text encoder of the baseline family.

Counterpart of ``mdhs_tpu/models/encoders.py``. ``ImageTokenEncoder`` runs
the port's ResNet (``resnet18`` / ``34`` / ``50``) or MambaVision
(``mamba_vision_<variant>``, ``models/mamba_vision.py``: T, T2, S, B, L, L2,
L2_512, L3, L3_512) on NCHW images and flattens its layer2/3/4 taps in NHWC
order to (B, H*W, C) token sequences, each projected to ``feature_dim``
(the JAX ``proj_layer{2,3,4}``); the taps' widths are the backbone's (T:
160, 320, 640). Names follow the reference torch modules, ``model.*``
(torchvision ResNet, or NVIDIA's MambaVision without its ``norm`` and
``head``) and ``proj{2,3,4}``; ``TextEncoder`` holds the BERT as ``model.*``
(HF BertModel). ``mdhs_tpu.core.convert.convert_baseline_full`` reads the
ResNet and BERT names, ``convert_mamba_vision`` the MambaVision tower under
``model.``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .bert import BertConfig, BertModel
from .mamba_vision import MambaVision, stage_widths
from .resnet import BLOCK_CLS, ResNet

MAMBA_VISION = "mamba_vision_"


class ImageTokenEncoder(nn.Module):
    def __init__(self, feature_dim: int = 512, backbone: str = "resnet18", multi_scale: bool = False,
                 device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        if backbone.startswith(MAMBA_VISION):
            self.model = MambaVision(backbone[len(MAMBA_VISION):], **f)
            width = stage_widths(self.model.variant)
        else:
            self.model = ResNet(backbone, **f)
            width = {f"layer{i}": w * BLOCK_CLS[backbone].expansion for i, w in ((2, 128), (3, 256), (4, 512))}
        self.multi_scale = multi_scale
        if multi_scale:
            self.proj2 = nn.Linear(width["layer2"], feature_dim, **f)
            self.proj3 = nn.Linear(width["layer3"], feature_dim, **f)
        self.proj4 = nn.Linear(width["layer4"], feature_dim, **f)

    def forward(self, x: torch.Tensor, perturbations: Optional[dict] = None):
        """x: (B, 3, H, W). Returns (tokens, taps): tokens (B, N, feature_dim),
        or the {layer2, layer3, layer4} dict when multi_scale; ``perturbations``
        goes to the trunk's taps (``models/resnet.py::perturb``)."""
        taps = self.model(x, perturbations)

        def tokens(key: str, proj: nn.Linear) -> torch.Tensor:
            return proj(taps[key].flatten(2).transpose(1, 2))  # (B, C, H, W) -> (B, H*W, C)

        if self.multi_scale:
            return {k: tokens(k, getattr(self, f"proj{k[-1]}")) for k in ("layer2", "layer3", "layer4")}, taps
        return tokens("layer4", self.proj4), taps

    @property
    def stem(self) -> nn.Conv2d:
        """The tower's first convolution (its weight's dtype is the tower's input dtype)."""
        return self.model.patch_embed.conv_down[0] if isinstance(self.model, MambaVision) else self.model.conv1


class TextEncoder(nn.Module):
    """BERT under the reference's ``text_encoder.model`` prefix; returns
    (last hidden state, all hidden states)."""

    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        self.model = BertModel(cfg, device=device, dtype=dtype)

    def forward(self, input_ids, attention_mask):
        return self.model(input_ids, attention_mask)
