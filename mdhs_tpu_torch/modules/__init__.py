"""Attention modules shared by the model families."""
