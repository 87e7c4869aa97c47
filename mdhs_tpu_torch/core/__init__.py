"""Weights carried across from the JAX package's parameter trees."""
