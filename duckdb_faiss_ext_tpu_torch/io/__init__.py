"""Checkpoints and conversion from the JAX package."""
