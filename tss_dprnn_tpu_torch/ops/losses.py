"""SI-SDR, its length-masked form, the PIT SI-SDR loss and cross-entropy
(counterpart of ``tss_dprnn_tpu/ops/losses.py``).

asteroid's ``PairwiseNegSDR('sisdr')`` defaults: zero-mean both signals,
EPS = 1e-8, 10 * log10(||s_t||^2 / ||e||^2 + EPS); PIT is the minimum over
source permutations of the mean pairwise loss.
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple, Union

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


def pairwise_neg_sisdr(est: torch.Tensor, target: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """est [B, n_est, T], target [B, n_src, T] -> [B, n_est, n_src] of
    -SI-SDR. With ``lengths`` [B] every statistic is restricted to each row's
    first ``lengths[b]`` samples."""
    if lengths is not None:
        T = est.shape[-1]
        m = (torch.arange(T, device=est.device)[None, :] < lengths[:, None]).to(est.dtype)[:, None]
        n = m.sum(dim=-1, keepdim=True).clamp_min(1.0)
        est = (est - (est * m).sum(dim=-1, keepdim=True) / n) * m
        target = (target - (target * m).sum(dim=-1, keepdim=True) / n) * m
    else:
        est = est - est.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)
    dot = torch.einsum("bet,bst->bes", est, target)
    energy = (target * target).sum(dim=-1)[:, None, :] + EPS
    # the explicit noise tensor [B, n_est, n_src, T] avoids the cancellation
    # of ||e||^2 - 2<e,s> + ||s||^2 in fp32 (n_est * n_src is 1 to 9)
    scaled = (dot / energy)[..., None] * target[:, None]
    noise = est[:, :, None] - scaled
    ratio = (scaled * scaled).sum(dim=-1) / ((noise * noise).sum(dim=-1) + EPS)
    return -10.0 * torch.log10(ratio + EPS)


def pit_from_pairwise(pw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """pw [B, n, n] -> (min over the n! permutations of the mean loss [B],
    index of the best permutation [B])."""
    n = pw.shape[-1]
    rows = torch.arange(n, device=pw.device)
    losses = torch.stack([pw[:, rows, list(p)].mean(dim=-1)
                          for p in itertools.permutations(range(n))], dim=-1)
    loss, idx = losses.min(dim=-1)
    return loss, idx


def pit_sisdr_loss(est: torch.Tensor, target: torch.Tensor, return_est: bool = False,
                   lengths: Optional[torch.Tensor] = None
                   ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """PIT-resolved negative SI-SDR, mean over the batch. est/target
    [B, n, T]; ``return_est`` also gives est reordered to the best
    permutation; ``lengths`` masks each row to its valid samples."""
    loss_b, idx = pit_from_pairwise(pairwise_neg_sisdr(est, target, lengths))
    loss = loss_b.mean()
    if not return_est:
        return loss
    n = est.shape[1]
    perms = torch.tensor(list(itertools.permutations(range(n))), device=est.device)
    inv = torch.argsort(perms[idx], dim=-1)  # est slot for each target slot
    return loss, torch.take_along_dim(est, inv[:, :, None], dim=1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels (torch
    CrossEntropyLoss), with the JAX package's arithmetic."""
    top = logits.max(dim=-1, keepdim=True).values
    logz = torch.log(torch.exp(logits - top).sum(dim=-1)) + top[:, 0]
    picked = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return (logz - picked).mean()
