"""The benchmark of the PyTorch and CUDA port (``tss_dprnn_tpu_torch``): see
README.md here and BENCHMARK.json at the root of the repository."""
