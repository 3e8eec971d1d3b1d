"""Plain PyTorch reference of the training step: the losses, the gradient
clip and Adam, as the reference toolkit's trainers run them.

- BSS (DPRNN-TasNet): asteroid's PIT with ``PairwiseNegSDR('sisdr')``: both
  signals zero-mean, SI-SDR = 10 log10(|s_t|^2 / (|e|^2 + 1e-8) + 1e-8) with
  s_t = (<est, s> / (|s|^2 + 1e-8)) s, the loss the least over the source
  permutations of the mean negative SI-SDR, averaged over the batch.
- TSS (DPRNN-Spe-TasNet): that loss with the target as the one source, plus
  ``ce_gamma`` times the cross-entropy of the speaker logits.
- ``clip_grad_norm_(max_norm)``: every gradient scaled by
  min(1, max_norm / (global norm + 1e-6)).
- torch ``Adam(lr, weight_decay)``: the decay added to the gradient before
  the moments (betas 0.9, 0.999, eps 1e-8, bias-corrected).

It imports nothing of the program.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

EPS = 1e-8
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def neg_sisdr(est: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Negative SI-SDR in dB of [..., T] signals: [...]."""
    est = est - est.mean(dim=-1, keepdim=True)
    src = src - src.mean(dim=-1, keepdim=True)
    scale = (est * src).sum(dim=-1, keepdim=True) / ((src * src).sum(dim=-1, keepdim=True) + EPS)
    target = scale * src
    noise = est - target
    ratio = (target * target).sum(dim=-1) / ((noise * noise).sum(dim=-1) + EPS)
    return -10.0 * torch.log10(ratio + EPS)


def pit_loss(est: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """est, src [B, n, T]: the batch mean of the least permutation loss."""
    n = est.shape[1]
    per_perm = torch.stack([
        torch.stack([neg_sisdr(est[:, i], src[:, j]) for i, j in enumerate(perm)]).mean(dim=0)
        for perm in itertools.permutations(range(n))], dim=-1)
    return per_perm.min(dim=-1).values.mean()


def clip_(grads: Sequence[torch.Tensor], max_norm: float) -> None:
    total = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(scale)


class Adam:
    """torch.optim.Adam's update, written out."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, weight_decay: float):
        self.params, self.lr, self.wd = list(params), lr, weight_decay
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Update the parameters in place; returns the gradients as the
        moments took them (decay added)."""
        self.t += 1
        b1, b2 = BETAS
        taken = []
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = g + self.wd * p
            taken.append(g)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = m / (1 - b1 ** self.t)
            v_hat = v / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS))
        return taken


def train_steps(params: Dict[str, torch.Tensor], trainable: Sequence[str],
                loss_fn: Callable[[Dict[str, torch.Tensor], dict], torch.Tensor],
                batches: Sequence[dict], lr: float, weight_decay: float, clip_norm: float
                ) -> dict:
    """Steps of clip + Adam from ``params`` over ``batches``; ``params`` is
    updated in place. Returns each step's loss, the first step's gradients as
    Adam took them, by name, and the parameters after the last step."""
    leaves = [params[k].requires_grad_(True) for k in trainable]
    opt = Adam(leaves, lr, weight_decay)
    losses, first = [], None
    for batch in batches:
        loss = loss_fn(params, batch)
        grads = list(torch.autograd.grad(loss, leaves))
        losses.append(float(loss.detach()))
        if clip_norm:
            clip_(grads, clip_norm)
        taken = opt.step(grads)
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(trainable, taken)}
    return {"losses": losses, "first_grads": first,
            "params": {k: params[k].detach().clone() for k in trainable}}


def tss_loss(ce_gamma: float, forward: Callable) -> Callable:
    """The TSS trainer's loss over a batch dict (mix, target, reference,
    ref_len, spk_idx)."""
    def loss_fn(params, b):
        est, logits = forward(params, b["mix"], b["reference"], b["ref_len"])
        return (pit_loss(est[:, None], b["target"][:, None])
                + ce_gamma * F.cross_entropy(logits, b["spk_idx"].long()))
    return loss_fn


def bss_loss(forward: Callable) -> Callable:
    def loss_fn(params, b):
        return pit_loss(forward(params, b["mix"]), b["sources"])
    return loss_fn
