"""Length masks and the masked softmax
(counterpart of ``tss_dprnn_tpu/ops/masking.py:17,78``).

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
