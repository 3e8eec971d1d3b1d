"""The plain PyTorch reference the benchmark holds the program to. It
imports nothing of the program and nothing of JAX."""
