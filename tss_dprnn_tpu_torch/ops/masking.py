"""Length masks, the masked flip and the masked softmax
(counterpart of ``tss_dprnn_tpu/ops/masking.py``).

Bucketed evaluation pads every utterance to its bucket length and threads
the true ``lengths`` through the graph; these helpers make the padded
computation equal the unpadded one on the valid region.
"""

from __future__ import annotations

from typing import Optional

import torch


def length_mask(lengths: torch.Tensor, size: int, dtype=torch.float32) -> torch.Tensor:
    """[B] lengths -> [B, size] {0,1} mask (1 where t < length)."""
    t = torch.arange(size, device=lengths.device)
    return (t[None, :] < lengths[:, None]).to(dtype)


def masked_flip(x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                time_axis: int = 1) -> torch.Tensor:
    """Each sequence reversed along ``time_axis`` within its valid length:
    ``out[t] = x[l - 1 - t]`` for ``t < l`` and ``x[t]`` past it; without
    lengths a plain flip. An index gather, so every value is copied exactly
    (where the JAX package multiplies by a one-hot matrix on the TPU)."""
    if lengths is None:
        return torch.flip(x, dims=(time_axis,))
    x1 = x.movedim(time_axis, 1)
    T = x1.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    src = lengths.to(device=x.device, dtype=torch.int64)[:, None] - 1 - t
    src = torch.where(src >= 0, src, t)  # [B, T]
    idx = src.reshape(src.shape + (1,) * (x1.ndim - 2)).expand_as(x1)
    return x1.gather(1, idx).movedim(1, time_axis)


def masked_softmax(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                   dim: int = -1) -> torch.Tensor:
    """Softmax over ``dim`` restricted to positions where ``mask != 0``;
    equals ``torch.softmax`` on the unpadded sequence."""
    if mask is None:
        e = torch.exp(x - x.amax(dim=dim, keepdim=True))
        return e / e.sum(dim=dim, keepdim=True)
    keep = mask != 0
    xm = torch.where(keep, x, torch.finfo(x.dtype).min)
    e = torch.exp(xm - xm.amax(dim=dim, keepdim=True)) * keep
    return e / (e.sum(dim=dim, keepdim=True) + 1e-38)
