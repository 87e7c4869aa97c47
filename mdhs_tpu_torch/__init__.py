"""mdhs_tpu_torch — the PyTorch / CUDA port of mdhs_tpu for NVIDIA Hopper.

The JAX package ``mdhs_tpu`` is the reference; this package mirrors its
module names so each counterpart is easy to find:

- ``mdhs_tpu_torch.ops``      eval preprocessing, GELU, and the hand-written
                              CUDA sublayer kernels (``attention_block``,
                              ``ffn_block``) with their plain PyTorch versions
- ``mdhs_tpu_torch.models``   ResNet, BERT and MIBF-Net as ``nn.Module``s
                              with torchvision / HF state_dict names
- ``mdhs_tpu_torch.modules``  ``JointKVCrossAttention``
- ``mdhs_tpu_torch.core``     weights carried across from the JAX trees
- ``mdhs_tpu_torch.serving``  ``ServingModel``: resident weights, static
                              batch, pipelined request loop

The package imports torch and numpy only: never jax, flax or mdhs_tpu.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
