"""1-D convolutions in torch layouts
(counterpart of ``tss_dprnn_tpu/ops/conv.py:21,40``).

Weights keep the torch layouts (Conv1d [O, I/groups, K]; ConvTranspose1d
[I, O/groups, K]). On the card these run in full fp32 only because
:func:`tss_dprnn_tpu_torch.device.resolve_device` turns cuDNN's TF32 off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Bias-free Conv1d, no padding: x [B, C_in, L]; w [C_out, C_in, K]
    -> [B, C_out, (L - K) // stride + 1]."""
    return F.conv1d(x, w.to(x.dtype), stride=stride)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Bias-free ConvTranspose1d, no padding: x [B, C_in, L]; w [C_in, C_out, K]
    -> [B, C_out, (L - 1) * stride + K]."""
    return F.conv_transpose1d(x, w.to(x.dtype), stride=stride)
