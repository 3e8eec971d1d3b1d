"""SI-SDR and its length-masked form
(counterpart of ``tss_dprnn_tpu/ops/losses.py:23-53``).

asteroid's ``PairwiseNegSDR('sisdr')`` defaults: zero-mean both signals,
EPS = 1e-8, 10 * log10(||s_t||^2 / ||e||^2 + EPS).
"""

from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-8


def si_sdr(est: torch.Tensor, target: torch.Tensor, zero_mean: bool = True) -> torch.Tensor:
    """Scale-invariant SDR in dB. est/target: [..., T] -> [...]."""
    if zero_mean:
        est = est - est.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)
    dot = (est * target).sum(dim=-1, keepdim=True)
    energy = (target * target).sum(dim=-1, keepdim=True) + EPS
    scaled = (dot / energy) * target
    noise = est - scaled
    ratio = (scaled * scaled).sum(dim=-1) / ((noise * noise).sum(dim=-1) + EPS)
    return 10.0 * torch.log10(ratio + EPS)


def masked_si_sdr(est: torch.Tensor, target: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SI-SDR over each row's first ``lengths[b]`` samples; est/target
    [B, ..., T], lengths [B]."""
    if lengths is None:
        return si_sdr(est, target)
    T = est.shape[-1]
    shape = [est.shape[0]] + [1] * (est.ndim - 2) + [T]
    m = (torch.arange(T, device=est.device)[None, :] < lengths[:, None]).to(est.dtype)
    m = m.reshape(shape)
    n = m.sum(dim=-1).clamp_min(1.0)
    mean_e = (est * m).sum(dim=-1, keepdim=True) / n[..., None]
    mean_t = (target * m).sum(dim=-1, keepdim=True) / n[..., None]
    return si_sdr((est - mean_e) * m, (target - mean_t) * m, zero_mean=False)
