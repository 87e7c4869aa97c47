"""Eval preprocessing, the training augmentation, GELU, int8 quantization,
and the hand-written CUDA kernels (the BERT sublayers ``attention_block`` and
``ffn_block``, their int8 twins in ``quant_kernel``, the attention core
``fused_attention`` and its ablated builds ``attention_ablate``, BERT's
flash-attention forward and backward in ``flash_attention``, the rotation's
``shear_sublane``, BatchNorm's ``bn_stats``, Mamba's ``selective_scan``, the
KAN layer's ``kan_forward``) with their plain PyTorch versions. CUDA sources live in
``mdhs_tpu_torch/csrc``; ``_build`` compiles them at first use."""
