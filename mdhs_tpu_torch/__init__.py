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
                              ``shear_sublane``, ``bn_stats`` and its
                              gradient, ``selective_scan``, ``kan_spline``'s
                              ``kan_forward``) with their plain PyTorch
                              versions; the eight on a served path are the
                              ``torch.ops.mdhs`` custom ops (``_library``)
- ``mdhs_tpu_torch.models``   ResNet, BERT, MIBF-Net, the baseline family
                              (``MultimodalBaselineModel`` and its encoders),
                              ConNexT and BatchNorm as ``nn.Module``s with
                              torchvision / HF / reference state_dict names;
                              ``build_model`` of a config
- ``mdhs_tpu_torch.train``    losses, schedules and optimizers, metrics (and the
                              eval CLIs' classification report), and
                              the MIBF ``Trainer`` with ``MIBF_HAM_TRAIN``
- ``mdhs_tpu_torch.modules``  attention (``JointKVCrossAttention``,
                              ``MultiHeadAttention``), the baseline's fusions
                              and heads, Mamba, KAN and the KAN-expert MoE
- ``mdhs_tpu_torch.core``     weights carried across from the JAX trees; configs,
                              the precision policy, checkpoints
- ``mdhs_tpu_torch.data``     the host data path: tokenizer, PNG reading, the
                              dataset join, the prefetching loader (with
                              ``mdhs_tpu_torch.native``, the binding of the
                              repository's native C++ resampler and WordPiece)
- ``mdhs_tpu_torch.cli``      the inference entry points ``run_predict``,
                              ``run_evaluate``, ``run_ablation_eval``
                              (``configs/`` holds JSON configs for them),
                              and the deployment pair ``export_serving``
                              (the served step through ``torch.export``)
                              and ``run_serve`` (an artifact alone -> CSV)
- ``mdhs_tpu_torch.diagnostics``  ``attention_ablate``: the attention core's
                              time split by stage on the card
- ``mdhs_tpu_torch.serving``  ``ServingModel``: resident weights, static
                              batch, pipelined request loop, for any
                              family, around a live model or loaded from an
                              exported artifact with no model code
                              (``ServingModel.load``); ``ServeFunction``,
                              the served step both run
- ``mdhs_tpu_torch.presets``  the served configurations: the int8 serving
                              preset ``MIBF_HAM_SERVING``, the baseline
                              configurations ``HAM_FUSION_SSM``,
                              ``HAM_HEAD_MOE``, ConNexT's ``CONNEXT_HAM``

The package imports torch and numpy (and PIL, yaml, msgpack or safetensors
only where a file asks for them): never jax, flax or mdhs_tpu.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
