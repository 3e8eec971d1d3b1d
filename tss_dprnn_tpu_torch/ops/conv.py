"""1-D convolutions and pools in torch layouts
(counterpart of ``tss_dprnn_tpu/ops/conv.py:21,40,67,78``).

Weights keep the torch layouts (Conv1d [O, I/groups, K]; ConvTranspose1d
[I, O/groups, K]). These are library convolutions, as they are ``lax.conv``
calls in the JAX package. On the card they run in full fp32 only because
:func:`tss_dprnn_tpu_torch.device.resolve_device` turns cuDNN's TF32 off.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """Conv1d with zero padding on both sides: x [B, C_in, L]; w [C_out, C_in,
    K] -> [B, C_out, (L + 2 padding - dilation (K - 1) - 1) // stride + 1]."""
    return F.conv1d(x, w.to(x.dtype), None if b is None else b.to(x.dtype), stride=stride,
                    padding=padding, dilation=dilation)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Bias-free ConvTranspose1d, no padding: x [B, C_in, L]; w [C_in, C_out, K]
    -> [B, C_out, (L - 1) * stride + K]."""
    return F.conv_transpose1d(x, w.to(x.dtype), stride=stride)


def avg_pool1d_exact(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping width-k mean: [B, C, L] -> [B, C, L // k] (the
    reference's frozen depthwise 'average' conv as a reshape and a mean)."""
    B, C, L = x.shape
    n = L // k
    return x[:, :, : n * k].reshape(B, C, n, k).mean(dim=3)


def max_pool1d(x: torch.Tensor, k: int) -> torch.Tensor:
    """torch nn.MaxPool1d(k) (stride k, no padding): [B, C, L] -> [B, C, L // k]."""
    B, C, L = x.shape
    n = L // k
    return x[:, :, : n * k].reshape(B, C, n, k).amax(dim=3)
