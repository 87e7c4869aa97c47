"""Attention, the baseline family's fusions and heads, Mamba, KAN and the MoE."""
