"""Checkpoints as ``torch.save`` files (counterpart of
``tss_dprnn_tpu/utils/checkpoint.py``).

Files are named ``{epoch}_{best|last}`` under ``new_checkpoints_path``; the
newest ``n_checkpoints`` are kept and older ones removed. A file holds the
reference's ``.pt`` layout: ``{"epoch", "model"}`` plus, for exact resume,
``"optimizer"``, ``"scheduler"``, ``"step"`` and ``"run"``, and for a
DPRNN-Spe-IRA model its ``"share_blocks"``. Loading fails hard when the
weights do not match the model (the reference silently starts from random
weights), and when the recorded ``share_blocks`` differs from the model's:
the setting adds no parameter, so its weights would load under any value.
"""

from __future__ import annotations

import logging
import os
from collections import deque
from typing import Any, Callable, Dict, Mapping, Optional

import torch

logger = logging.getLogger(__name__)


def share_blocks_of(model: torch.nn.Module) -> Optional[int]:
    """The IRA model's ``share_blocks``; None for every other family."""
    return getattr(getattr(model, "separation", None), "share_blocks", None)


class CheckpointManager:
    def __init__(self, directory: str, n_checkpoints: int = 1000):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.queue: deque = deque(maxlen=n_checkpoints)

    def save(self, epoch: int, payload: Mapping[str, Any], best: bool = False) -> str:
        path = os.path.join(self.directory, f"{epoch}_{'best' if best else 'last'}")
        tmp = path + ".tmp"
        torch.save(dict(payload), tmp)
        os.replace(tmp, path)
        if self.queue.maxlen and len(self.queue) == self.queue.maxlen:
            evicted = self.queue[0]
            if evicted != path and os.path.exists(evicted):
                os.remove(evicted)
        self.queue.append(path)
        return path


def load_model(path: str, model: torch.nn.Module,
               load_state_dict: Optional[Callable[[Dict[str, torch.Tensor]], None]] = None
               ) -> Dict[str, Any]:
    """Load a checkpoint's weights into ``model`` (strict: a mismatch
    raises) and return the whole checkpoint as ``{"model": state_dict,
    ...}``: the trainer's layout as it is, a bare state_dict wrapped. A
    directory (the JAX package's orbax checkpoints) raises.
    ``load_state_dict`` loads the weights in place of ``model``'s own (a
    model whose parameters are sharded: ``parallel.ShardedParameters``)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package?): the port loads "
            "torch .pt files; convert it on a machine with JAX with export_state_dict of the "
            "JAX package's utils/torch_export.py and torch.save the state_dict")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(ckpt, dict) and isinstance(ckpt.get("model"), dict)):
        ckpt = {"model": ckpt}
    k = share_blocks_of(model)
    if k is not None:
        if "share_blocks" not in ckpt:
            logger.info("%s records no share_blocks (a reference or exported state_dict): "
                        "loaded under the model's share_blocks=%d", path, k)
        elif int(ckpt["share_blocks"]) != k:
            raise ValueError(f"{path} was trained with share_blocks={int(ckpt['share_blocks'])}"
                             f", the model has share_blocks={k}: set model.share_blocks to "
                             "the recorded value")
    if load_state_dict is None:
        model.load_state_dict(ckpt["model"], strict=True)
    else:
        load_state_dict(ckpt["model"])
    return ckpt
