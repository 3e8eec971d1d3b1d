"""Masked global layer norm, channels-last
(counterpart of ``tss_dprnn_tpu/ops/norms.py:23-148``, fp32 lane).

Mean and biased variance are taken over every axis but the batch axis, and
only over unmasked positions; the affine is per channel (last axis). gLN
adds 1e-8 inside the square root, torch's GroupNorm(1, C) ('ln') 1e-5.
"""

from __future__ import annotations

from typing import Optional

import torch

GLOBLN_EPS = 1e-8
GROUPNORM_EPS = 1e-5


def global_channel_norm_cl(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                           eps: float, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, *spatial, C]; mask broadcastable to x ({0,1}) or None.

    Statistics are computed in fp32 whatever x's type; the result has x's
    type. Masked positions come out exactly zero.
    """
    dims = tuple(range(1, x.ndim))
    xf = x.float()
    if mask is None:
        mean = xf.mean(dim=dims, keepdim=True)
        var = (xf - mean).square().mean(dim=dims, keepdim=True)
        out = (xf - mean) / torch.sqrt(var + eps)
        return (gamma.float() * out + beta.float()).to(x.dtype)
    m = torch.broadcast_to(mask, x.shape).float()
    n = m.sum(dim=dims, keepdim=True).clamp_min(1.0)
    mean = (xf * m).sum(dim=dims, keepdim=True) / n
    var = ((xf - mean).square() * m).sum(dim=dims, keepdim=True) / n
    out = (xf - mean) / torch.sqrt(var + eps) * m
    return ((gamma.float() * out + beta.float()) * m).to(x.dtype)
