"""Tensor ops of the port: plain PyTorch functions, plus the hand-written
bidirectional LSTM kernel in :mod:`tss_dprnn_tpu_torch.ops.bilstm2`."""
