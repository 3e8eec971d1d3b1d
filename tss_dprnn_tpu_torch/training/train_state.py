"""The training optimizer (counterpart of ``make_optimizer``,
``tss_dprnn_tpu/training/train_state.py:60-79``).

The reference's semantics: clip the gradients by their global norm, then
torch ``Adam(lr, weight_decay)``, whose decay is added to the gradient
before the moments (coupled, not AdamW) — the JAX package's optax chain
``clip_by_global_norm -> add_decayed_weights -> scale_by_adam``. The
learning rate is set between epochs by the host-side schedulers.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

import torch


class Optimizer:
    """Clip + Adam (torch's defaults: betas 0.9, 0.999, eps 1e-8) over
    ``params``; ``step()`` consumes their ``.grad``. ``grad_norm(params)``,
    when given, is the global norm the clip divides by (under a model axis,
    ``parallel.ShardedParameters.grad_norm``: the norm of the whole arrays
    of which ``params`` hold slices); torch's ``clip_grad_norm_`` otherwise."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 weight_decay: float = 0.0, clip_norm: Optional[float] = None,
                 grad_norm: Optional[Callable[[Sequence[torch.Tensor]], torch.Tensor]] = None):
        self.params = [p for p in params if p.requires_grad]
        self.clip_norm = clip_norm
        self.grad_norm = grad_norm
        self.adam = torch.optim.Adam(self.params, lr=lr, weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.clip_norm and self.grad_norm is None:
            torch.nn.utils.clip_grad_norm_(self.params, self.clip_norm)
        elif self.clip_norm:
            # clip_grad_norm_'s scaling, on the given norm
            scale = (self.clip_norm / (self.grad_norm(self.params) + 1e-6)).clamp(max=1.0)
            for p in self.params:
                if p.grad is not None:
                    p.grad.mul_(scale)
        self.adam.step()

    @property
    def learning_rate(self) -> float:
        return float(self.adam.param_groups[0]["lr"])

    def set_learning_rate(self, lr: float) -> None:
        for group in self.adam.param_groups:
            group["lr"] = float(lr)

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, sd: dict) -> None:
        self.adam.load_state_dict(sd)
