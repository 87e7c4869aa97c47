"""Seeded random initialisation from an explicit ``torch.Generator``."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..modules.attention import MultiHeadAttention
from ..modules.fusion import HierarchicalFusion, WeightedConcatFusion
from ..modules.heads import AttentionPoolingHead
from ..modules.kan import GroupKANLinear, KANLinear, make_grid
from ..modules.mamba import MambaBlock
from ..modules.moe import MoE
from ..modules.sequence import RNN
from .convnext import ConvNextLayer
from .mamba_vision import Block as MambaVisionBlock
from .mamba_vision import MambaVisionMixer


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every parameter of ``model`` from ``generator``, with the
    JAX package's init semantics.

    Linear, convolution and attention projection weights are normal with std
    1/sqrt(fan_in), the scale of flax's lecun-normal default; biases are
    zero; embeddings are normal with std 0.02 (BERT's initializer range);
    LayerNorm and BatchNorm are the identity (weight 1, bias 0, running mean
    0, running variance 1). Mamba, the VMamba block's two included
    (``mdhs_tpu/modules/mamba.py:27-45``):
    ``A_log = log(1..N)``, ``D = 1``, ``dt_bias`` the inverse softplus of a
    step drawn log-uniformly in [1e-3, 1e-1]; the MambaVision mixer
    (``mdhs_tpu/models/mamba_vision.py:132-150``) the same for its ``A_log``,
    ``D`` and ``dt_proj``'s bias, its depthwise conv1d and ``dt_proj`` weights
    normal with std 1/sqrt(fan_in) as every kernel, its blocks' ``gamma_1`` /
    ``gamma_2`` the variant's layer scale. KAN (``modules/kan.py:78-108``):
    base weights and spline scalers uniform in +-scale / sqrt(in), spline
    coefficients uniform in +-scale_noise / (2 grid_size) (the JAX layer fits
    them to noise of that range), and the grid ``make_grid``'s, never drawn.
    GroupKAN (``kan.py:269-274``): ``act_coeff`` normal with std 0.1 /
    grid_size, ``act_base`` one. The attention-pooling head's ``query``:
    normal with std 1. The recurrent cells (flax's ``OptimizedLSTMCell`` / ``GRUCell``
    defaults): input kernels normal with std 1/sqrt(fan_in), each gate's recurrent
    kernel orthogonal, biases zero. MoE: ``w_gate`` and ``w_noise`` zero. The weighted-concat fusion's
    ``w_img`` and ``w_txt`` and the hierarchical fusion's ``scale_weights``:
    zero. ConvNeXt's layer scale: its
    ``layer_scale_init`` (1e-6). Values are drawn on the generator's
    device in float32 and cast to each parameter's dtype and device.
    """

    def normal_(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator, device=generator.device) * std)

    def uniform(shape, bound: float) -> torch.Tensor:
        return (torch.rand(shape, generator=generator, device=generator.device) * 2.0 - 1.0) * bound

    def mamba_init(A_log: torch.Tensor, D: torch.Tensor, dt_bias: torch.Tensor) -> None:
        d_inner, d_state = A_log.shape
        # numpy's float32 log, as the JAX init takes it (torch's differs by an ulp at some n)
        A_log.copy_(torch.from_numpy(np.log(np.arange(1, d_state + 1, dtype=np.float32))).expand(d_inner, -1))
        D.fill_(1.0)
        u = torch.rand((d_inner,), generator=generator, device=generator.device)
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3)).clamp(min=1e-4)
        dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            normal_(m.weight, 1.0 / math.sqrt(m.weight[0].numel()))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, MultiHeadAttention):
            for name, w in m.named_parameters(recurse=False):
                if name.endswith("weight"):  # the packed (3E, E) or each of q, k, v by its own input width
                    normal_(w, 1.0 / math.sqrt(w.shape[1]))
            m.in_proj_bias.zero_()
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 0.02)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
        elif isinstance(m, MambaBlock):
            mamba_init(m.A_log, m.D, m.dt_bias)
        elif isinstance(m, KANLinear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.base_weight.copy_(uniform(m.base_weight.shape, m.scale_base * bound))
            m.spline_weight.copy_(uniform(m.spline_weight.shape, m.scale_noise / (2 * m.grid_size)))
            m.spline_scaler.copy_(uniform(m.spline_scaler.shape, m.scale_spline * bound))
            m.grid.copy_(make_grid(m.in_features, m.grid_size, m.spline_order, m.grid_range))
        elif isinstance(m, GroupKANLinear):
            normal_(m.act_coeff, 0.1 / m.grid_size)
            m.act_base.fill_(1.0)
        elif isinstance(m, AttentionPoolingHead):
            normal_(m.query, 1.0)
        elif isinstance(m, RNN):
            for name, p in m.named_parameters(recurse=False):
                if name.startswith("weight_ih"):
                    normal_(p, 1.0 / math.sqrt(p.shape[1]))
                elif name.startswith("weight_hh"):
                    for block in p.split(m.hidden_size):
                        block.copy_(nn.init.orthogonal_(torch.empty(block.shape, device=generator.device),
                                                        generator=generator))
                else:
                    p.zero_()
        elif isinstance(m, MoE):
            m.w_gate.zero_()
            m.w_noise.zero_()
        elif isinstance(m, ConvNextLayer):
            m.layer_scale_parameter.fill_(m.layer_scale_init)
        elif isinstance(m, (WeightedConcatFusion, HierarchicalFusion)):
            for p in m.parameters(recurse=False):
                p.zero_()
        elif isinstance(m, MambaVisionBlock) and m.layer_scale is not None:
            m.gamma_1.fill_(m.layer_scale)
            m.gamma_2.fill_(m.layer_scale)
    for m in model.modules():  # after the loop, which zeroed dt_proj's bias as a Linear's
        if isinstance(m, MambaVisionMixer):
            mamba_init(m.A_log, m.D, m.dt_proj.bias)
    return model
