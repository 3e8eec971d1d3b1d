"""Tensor ops of the port: plain PyTorch functions, plus the hand-written
LSTM kernels' wrappers in :mod:`tss_dprnn_tpu_torch.ops.bilstm2` and
:mod:`tss_dprnn_tpu_torch.ops.lstm`. Importing the package registers their
serving entries as torch operators (namespace ``tss_dprnn_tpu_torch``), which
``torch.export.load`` needs for an artifact that calls them."""

from tss_dprnn_tpu_torch.ops import bilstm2, lstm  # noqa: F401
