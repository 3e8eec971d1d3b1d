"""The program's pieces every family shares (``tss_dprnn_tpu_torch``): the
model built from a configuration as the program's entry points build it,
its inferencers and trainers set up from a configuration, the loaders, and
the module class whose calls the traced run times (``RNNCore``). A family
(``families/<family>.py``) names its own entry classes and collates."""

from __future__ import annotations

import os
from typing import Dict

import torch

from tss_dprnn_tpu_torch.data import loader
from tss_dprnn_tpu_torch.models.layers import RNNCore
from tss_dprnn_tpu_torch.models.registry import build_model

RNN_MODULE = RNNCore


def model(config: dict, state: Dict[str, torch.Tensor], device: torch.device) -> torch.nn.Module:
    """The configuration's model on ``device`` with the given weights."""
    m = build_model(dict(config["model"], dtype=config.get("dtype"))).to(device)
    m.load_state_dict(state, strict=True)
    return m


def inferencer(cls, config: dict, state: Dict[str, torch.Tensor], device: torch.device,
               scratch: str):
    """An inferencer of class ``cls``; it takes its weights from a checkpoint
    file, written under ``scratch``."""
    m = build_model(dict(config["model"], dtype=config.get("dtype")))
    path = os.path.join(scratch, "weights.pt")
    torch.save({k: v.cpu() for k, v in state.items()}, path)
    return cls(m, {"checkpoint_path": path, "metrics": ["si_sdr"],
                   "data": {"sample_rate": config["sample_rate"]}}, device=device)


def trainer(cls, config: dict, state: Dict[str, torch.Tensor], device: torch.device,
            scratch: str):
    """A trainer of class ``cls`` over the model with these weights,
    configured as the configuration's ``training`` section says; its
    checkpoint directory (never written) is under ``scratch``."""
    settings = dict(config["training"], new_checkpoints_path=os.path.join(scratch, "chkpts"),
                    data={"sample_rate": config["sample_rate"]})
    return cls(model(config, state, device), settings, device=device)


def bucketed_loader(dataset, lengths, batch_size: int, collate, n_buckets: int, multiple: int):
    return loader.BucketedEvalLoader(dataset, batch_size, collate, lengths, n_buckets=n_buckets,
                                     multiple=multiple, process_index=0, process_count=1)


def train_loader(dataset, batch_size: int, collate, seed: int, prefetch: int):
    return loader.TrainLoader(dataset, batch_size, collate, shuffle=True, drop_last=True,
                              seed=seed, prefetch=prefetch, process_index=0, process_count=1)


def template(config: dict) -> Dict[str, torch.Tensor]:
    """The names, shapes and dtypes of the configuration's ``state_dict``
    (the values are uninitialised)."""
    return build_model(dict(config["model"], dtype=config.get("dtype"))).state_dict()
