"""Interchange with the JAX package's parameters."""
