"""Eval preprocessing, the training augmentation, GELU, int8 quantization,
and the hand-written CUDA kernels (the BERT sublayers ``attention_block`` and
``ffn_block``, their int8 twins in ``quant_kernel``, the attention core
``fused_attention`` and its ablated builds ``attention_ablate``, BERT's
flash-attention forward and backward in ``flash_attention``, the rotation's
``shear_sublane``, BatchNorm's ``bn_stats`` and its gradient
``bn_stats_backward``, Mamba's ``selective_scan``, the KAN layer's
``kan_forward``) with their plain PyTorch versions; ``bf16_gemm``
plans the bf16 sublayers' products. CUDA sources live in
``mdhs_tpu_torch/csrc``; ``_build`` compiles them at first use. ``_library``
registers the eight kernels on a served path as the ``torch.ops.mdhs`` custom
ops, on this package's import."""

from . import _library  # noqa: F401  (registers the mdhs ops)
