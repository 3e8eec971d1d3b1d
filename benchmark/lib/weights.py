"""Seeded weights, keyed by the names and shapes of a ``state_dict``.

One uniform draw on the device from a ``torch.Generator`` seeded with the
run's seed fills every floating tensor at once; each tensor then takes its
slice, scaled by a rule on its name and shape (torch's default ranges):

- LSTM weights and biases (``*.rnn.weight_*`` / ``*.rnn.bias_*``):
  U(-1/sqrt(H), 1/sqrt(H));
- other weights of two or more axes (linear and convolution kernels):
  U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = every axis but the first;
  the bias beside such a weight the same;
- PReLU slopes (``*prelu*.weight``): 0.25 +- 0.05;
- the weight (or gamma) of a norm: 1 +- 0.1, its bias (or beta) +- 0.1;
- BatchNorm running means +- 0.1, running variances in [1, 1.1).
Other entries (the frozen 'att' averaging conv, ``num_batches_tracked``)
keep the values the model was built with.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def _scale(name: str, shape: torch.Size, shapes: Dict[str, torch.Size]):
    """(centre, half-width, one-sided) of the tensor's uniform range, or None
    to keep the model's own value."""
    leaf = name.rsplit(".", 1)[-1]
    if ".rnn." in name and (leaf.startswith("weight_") or leaf.startswith("bias_")):
        H = shapes[name.rsplit(".", 1)[0] + ".weight_hh_l0"][1]
        return 0.0, 1.0 / math.sqrt(H), False
    if "average." in name:
        return None
    if leaf == "running_mean":
        return 0.0, 0.1, False
    if leaf == "running_var":
        return 1.0, 0.1, True
    if len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:])), False
    if "prelu" in name and leaf == "weight":
        return 0.25, 0.05, False
    sibling = shapes.get(name.rsplit(".", 1)[0] + ".weight")
    if leaf == "bias" and sibling is not None and len(sibling) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(sibling[1:])), False
    if leaf in ("weight", "gamma"):
        return 1.0, 0.1, False
    if leaf in ("bias", "beta"):
        return 0.0, 0.1, False
    return None


def seeded_state(template: Dict[str, torch.Tensor], seed: int,
                 device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """A state dict with ``template``'s names, shapes and dtypes, drawn from
    ``seed`` on ``device``."""
    device = torch.device(device or "cpu")
    shapes = {k: v.shape for k, v in template.items()}
    rules = {k: _scale(k, v.shape, shapes) for k, v in template.items()
             if v.is_floating_point()}
    drawn = [k for k, r in rules.items() if r is not None]
    total = sum(template[k].numel() for k in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    u = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for k, v in template.items():
        if k not in drawn:
            out[k] = v.detach().to(device).clone()
            continue
        centre, half, one_sided = rules[k]
        part = u[at:at + v.numel()].reshape(v.shape)
        at += v.numel()
        out[k] = (centre + half * part) if one_sided else (centre + half * (2 * part - 1))
    return out
