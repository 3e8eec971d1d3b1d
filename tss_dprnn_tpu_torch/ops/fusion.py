"""The five speaker-embedding fusions, channels-last
(counterpart of ``tss_dprnn_tpu/ops/fusion.py``): 'cat', 'add', 'mul' and
'film' broadcast the (projected) embedding over time; 'att' pools, scores
and upsamples.

Two reference quirks of 'att' are kept exactly:
- the frozen depthwise "average" conv (stride = kernel, weights 1/kernel)
  is a non-overlapping mean pool;
- ``nn.Upsample(mode='nearest')`` back to L, built per forward: with true
  lengths the source index is ``floor(t * (l_in / l_out))`` computed in
  float32, as torch computes it on the unpadded sequence.
"""

from __future__ import annotations

from typing import Optional

import torch

from tss_dprnn_tpu_torch.ops.masking import length_mask, masked_softmax


def concatenation(aux: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """aux [B, E], out [B, L, N] -> [B, L, N + E]: the embedding appended to
    every frame."""
    B, L, _ = out.shape
    return torch.cat([out, aux[:, None, :].expand(B, L, aux.shape[-1])], dim=-1)


def addition(aux_proj: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """aux_proj [B, N] (fusion_linear(aux)), out [B, L, N]."""
    return out + aux_proj[:, None, :]


def multiplication(aux_proj: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    return out * aux_proj[:, None, :]


def film(aux_mul: torch.Tensor, aux_add: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """FiLM: the multiplicative, then the additive modulation."""
    return out * aux_mul[:, None, :] + aux_add[:, None, :]


def mean_pool_time(x: torch.Tensor, k: int) -> torch.Tensor:
    """[B, L, N] -> [B, floor(L/k), N]: non-overlapping width-k mean."""
    B, L, N = x.shape
    n = L // k
    return x[:, : n * k].reshape(B, n, k, N).mean(dim=2)


def nearest_upsample_to(x: torch.Tensor, L: int, in_lengths: Optional[torch.Tensor] = None,
                        out_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch ``nn.Upsample(size=L, mode='nearest')`` over time on [B, L_in, N].

    With per-row true lengths the index is ``floor(t * float32(in/out))``
    (float32 on purpose: integer or float64 arithmetic moves indices at the
    boundaries), and positions t >= out_lengths are zero.
    """
    B, L_in, N = x.shape
    t = torch.arange(L, device=x.device)
    if in_lengths is None:
        idx = (t * L_in // L).clamp(0, L_in - 1)
        return x[:, idx]
    scale = in_lengths.float() / out_lengths.float()
    idx = torch.floor(t[None, :].float() * scale[:, None]).long().clamp(0, L_in - 1)
    out = torch.gather(x, 1, idx[:, :, None].expand(B, L, N))
    return out * length_mask(out_lengths, L, x.dtype)[:, :, None]


def attention(aux_proj: torch.Tensor, out: torch.Tensor, kernel_size: int,
              lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """aux_proj [B, N] (fusion_linear(aux)), out [B, L, N] normalised
    features -> out * upsample(att + aux) with
    att = softmax_t(sum_n(avg(out) * aux)) * aux."""
    L = out.shape[1]
    avg = mean_pool_time(out, kernel_size)  # [B, L_avg, N]
    a = aux_proj[:, None, :]
    score = (avg * a).sum(dim=-1, keepdim=True)  # [B, L_avg, 1]
    if lengths is None:
        att = masked_softmax(score, None, dim=1) * a + a
        return out * nearest_upsample_to(att, L)
    avg_lengths = lengths // kernel_size
    m = length_mask(avg_lengths, avg.shape[1], out.dtype)[:, :, None]
    att = masked_softmax(score, m, dim=1) * a + a
    up = nearest_upsample_to(att, L, in_lengths=avg_lengths, out_lengths=lengths)
    return out * up * length_mask(lengths, L, out.dtype)[:, :, None]
