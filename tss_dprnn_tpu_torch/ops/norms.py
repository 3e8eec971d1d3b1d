"""Masked global layer norms
(counterpart of ``tss_dprnn_tpu/ops/norms.py``).

Mean and biased variance are taken over every axis but the batch axis, and
only over unmasked positions. gLN adds 1e-8 inside the square root, torch's
GroupNorm(1, C) ('ln') 1e-5. The models run the channels-last form
(:func:`global_channel_norm_cl`, affine on the last axis); the
channels-first forms (:func:`global_channel_norm`, :func:`glob_ln`,
:func:`chan_ln`, affine on axis 1) and :func:`z_norm` are the JAX package's
plain ops, which no family calls.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

GLOBLN_EPS = 1e-8
GROUPNORM_EPS = 1e-5


def masked_mean_var(x: torch.Tensor, dims, mask: Optional[torch.Tensor] = None):
    """Mean and biased variance over ``dims`` (kept), only over positions
    where ``mask`` (broadcastable to x, {0,1}) is 1 when it is given."""
    dims = tuple(dims)
    if mask is None:
        mean = x.mean(dim=dims, keepdim=True)
        return mean, (x - mean).square().mean(dim=dims, keepdim=True)
    m = torch.broadcast_to(mask, x.shape).to(x.dtype)
    n = m.sum(dim=dims, keepdim=True).clamp_min(1.0)
    mean = (x * m).sum(dim=dims, keepdim=True) / n
    return mean, ((x - mean).square() * m).sum(dim=dims, keepdim=True) / n


def z_norm(x: torch.Tensor, dims, eps: float = GLOBLN_EPS,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) over ``dims``; masked positions zero."""
    mean, var = masked_mean_var(x, dims, mask)
    out = (x - mean) / torch.sqrt(var + eps)
    if mask is not None:
        out = out * torch.broadcast_to(mask, x.shape).to(x.dtype)
    return out


def global_channel_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Channels-first global norm: x [B, C, *spatial], statistics over every
    axis but the batch, gamma and beta [C] on axis 1; masked positions come
    out exactly zero."""
    out = z_norm(x, range(1, x.ndim), eps, mask)
    shape = [1, x.shape[1]] + [1] * (x.ndim - 2)
    out = gamma.reshape(shape).to(x.dtype) * out + beta.reshape(shape).to(x.dtype)
    if mask is not None:
        out = out * torch.broadcast_to(mask, x.shape).to(x.dtype)
    return out


def glob_ln(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's GlobLN (eps 1e-8), channels first."""
    return global_channel_norm(x, gamma, beta, GLOBLN_EPS, mask)


def chan_ln(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch nn.GroupNorm(1, C) (eps 1e-5), channels first."""
    return global_channel_norm(x, gamma, beta, GROUPNORM_EPS, mask)


def global_channel_norm_cl(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                           eps: float, mask: Optional[torch.Tensor] = None,
                           batch_axis: int = 0) -> torch.Tensor:
    """x [B, *spatial, C]; mask broadcastable to x ({0,1}) or None.
    ``batch_axis``: the axis of the examples, whose statistics are apart (1
    for a time-major [T, B, *, C]; ``tss_dprnn_tpu/ops/norms.py:113``).

    Statistics are computed in fp32 whatever x's type; the result has x's
    type. Masked positions come out exactly zero. A bf16 x takes the JAX
    package's bf16 route (``tss_dprnn_tpu/ops/norms.py:78-140``):
    one-pass statistics with fp32 accumulation (E[x^2] - E[x]^2, clamped at
    0; masked positions zeroed in bf16 first), gamma and beta folded into a
    per-example fp32 scale and shift, both rounded to bf16, and
    ``x * scale + shift`` in bf16.
    """
    dims = tuple(i for i in range(x.ndim) if i != batch_axis)
    if x.dtype == torch.bfloat16:
        return _channel_norm_bf16(x, gamma, beta, eps, mask, dims)
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


def _channel_norm_bf16(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                       mask: Optional[torch.Tensor], dims) -> torch.Tensor:
    m = None if mask is None else torch.broadcast_to(mask, x.shape)
    xm = x if m is None else x * m.to(x.dtype)
    n = (float(math.prod(x.shape[d] for d in dims)) if m is None
         else m.float().sum(dim=dims, keepdim=True).clamp_min(1.0))
    xf = xm.float()
    mean = xf.sum(dim=dims, keepdim=True) / n
    var = (xf.square().sum(dim=dims, keepdim=True) / n - mean.square()).clamp_min(0.0)
    scale = gamma.float() * torch.rsqrt(var + eps)
    shift = beta.float() - mean * scale
    out = x * scale.to(x.dtype) + shift.to(x.dtype)
    return out if m is None else out * m.to(x.dtype)
