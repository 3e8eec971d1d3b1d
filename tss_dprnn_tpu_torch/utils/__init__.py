"""Utilities of the port: weight conversion from the JAX package's variables and checkpoints."""
