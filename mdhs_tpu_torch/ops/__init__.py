"""Eval preprocessing, GELU, and the hand-written CUDA sublayer kernels
(``attention_block``, ``ffn_block``) with their plain PyTorch versions.
CUDA sources live in ``mdhs_tpu_torch/csrc``; ``_build`` compiles them at
first use."""
