"""DPRNN-TasNet: blind separation of two sources.

A request is (mixture, sources [2, T]); the program serves it through
``Inferencer.forward`` and trains on it through ``Trainer`` (PIT SI-SDR),
with the collates its entry points use. The reference is
``reference/dprnn.py``'s ``bss_forward`` and ``reference/training.py``'s PIT
SI-SDR loss.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.lib import port
from benchmark.reference import dprnn as ref
from benchmark.reference import training as ref_training
from tss_dprnn_tpu_torch.data import loader
from tss_dprnn_tpu_torch.inference import Inferencer
from tss_dprnn_tpu_torch.training import Trainer


def item(config: dict, requests, i: int):
    """(mixture, sources [2, T]) of request i."""
    n = requests.mix_len(i)
    sources = np.stack([requests.signal(i, 0, n), requests.signal(i, 1, n)])
    return sources.sum(axis=0), sources


def inferencer(config, state, device, scratch):
    return port.inferencer(Inferencer, config, state, device, scratch)


def trainer(config, state, device, scratch):
    return port.trainer(Trainer, config, state, device, scratch)


def eval_collate(config: dict, ref_multiple: int):
    return loader.collate_bss_eval


def train_collate(config: dict):
    return loader.collate_bss


def reference_estimate(state, config: dict, it, device) -> torch.Tensor:
    """The reference's estimates [2, T] for one request alone."""
    return ref.bss_forward(state, config["model"], torch.from_numpy(it[0])[None].to(device))[0]


def reference_loss(config: dict):
    """loss(params, batch) of the trainer's step, on the reference."""
    m = config["model"]
    return ref_training.bss_loss(lambda p, mix: ref.bss_forward(p, m, mix))
