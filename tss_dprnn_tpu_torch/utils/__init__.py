"""Utilities of the port: weight conversion from the JAX package's
variables, checkpoints, configs and profiling."""
