"""mdhs_tpu_torch — the PyTorch / CUDA port of mdhs_tpu for NVIDIA Hopper.

The JAX package ``mdhs_tpu`` is the reference; this package mirrors its
module names so each counterpart is easy to find:

- ``mdhs_tpu_torch.ops``      eval preprocessing, the training augmentation,
                              GELU, int8 quantization, and the hand-written
                              CUDA kernels (``attention_block``,
                              ``ffn_block``, ``fused_attention`` and
                              its ablations ``attention_ablate``,
                              ``flash_attention``'s forward, dK/dV and dQ,
                              ``quant_kernel``'s int8 sublayers, ``shear``'s
                              ``shear_sublane``, ``bn_stats``,
                              ``selective_scan``, ``kan_spline``'s
                              ``kan_forward``) with their plain PyTorch
                              versions
- ``mdhs_tpu_torch.models``   ResNet, BERT, MIBF-Net, the baseline family
                              (``MultimodalBaselineModel`` and its encoders)
                              and BatchNorm as ``nn.Module``s with
                              torchvision / HF / reference state_dict names
- ``mdhs_tpu_torch.train``    losses, schedules and optimizers, metrics, and
                              the MIBF ``Trainer`` with ``MIBF_HAM_TRAIN``
- ``mdhs_tpu_torch.modules``  attention (``JointKVCrossAttention``,
                              ``MultiHeadAttention``), the baseline's fusions
                              and heads, Mamba, KAN and the KAN-expert MoE
- ``mdhs_tpu_torch.core``     weights carried across from the JAX trees
- ``mdhs_tpu_torch.diagnostics``  ``attention_ablate``: the attention core's
                              time split by stage on the card
- ``mdhs_tpu_torch.serving``  ``ServingModel``: resident weights, static
                              batch, pipelined request loop, for either
                              family; the int8 serving preset
                              ``MIBF_HAM_SERVING`` and the baseline
                              configurations ``HAM_FUSION_SSM``,
                              ``HAM_HEAD_MOE``

The package imports torch and numpy only: never jax, flax or mdhs_tpu.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
