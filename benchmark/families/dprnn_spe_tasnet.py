"""DPRNN-Spe-TasNet: target speech separation with the ResNet speaker
branch, in the fusions the reference has (``FUSIONS``).

A request is (mixture, target, enrolment reference, speaker index); the
program serves it through ``InferencerSpe.forward`` and trains on it through
``TrainerSpe``, with the collates its entry points use. The reference is
``reference/dprnn.py``'s ``tss_forward`` and ``reference/training.py``'s
SI-SDR + cross-entropy loss.
"""

from __future__ import annotations

import torch

from benchmark.lib import port
from benchmark.reference import dprnn as ref
from benchmark.reference import training as ref_training
from tss_dprnn_tpu_torch.data import loader
from tss_dprnn_tpu_torch.inference import InferencerSpe
from tss_dprnn_tpu_torch.training import TrainerSpe

FUSIONS = {"att": ref.attention_fusion}


def _fusion(config: dict):
    kind = config["model"]["fusion_type"]
    if kind not in FUSIONS:
        raise ValueError(f"the reference has no {kind!r} fusion: a family of its own adds it")
    return FUSIONS[kind]


def item(config: dict, requests, i: int):
    """(mixture, target, reference, speaker index) of request i."""
    n = requests.mix_len(i)
    target = requests.signal(i, 0, n)
    mix = target + requests.signal(i, 1, n)
    return (mix, target, requests.signal(i, 2, requests.ref_len(i)),
            requests.label(i, config["model"]["num_spks"]))


def inferencer(config, state, device, scratch):
    return port.inferencer(InferencerSpe, config, state, device, scratch)


def trainer(config, state, device, scratch):
    return port.trainer(TrainerSpe, config, state, device, scratch)


def eval_collate(config: dict, ref_multiple: int):
    return loader.make_collate_spe_eval(sample_rate=config["sample_rate"],
                                        ref_bucket_multiple=ref_multiple)


def train_collate(config: dict):
    return loader.collate_spe


def reference_estimate(state, config: dict, it, device) -> torch.Tensor:
    """The reference's target estimate [T] for one request alone."""
    mix, _, aux, _ = it
    out, _ = ref.tss_forward(state, config["model"], torch.from_numpy(mix)[None].to(device),
                             torch.from_numpy(aux)[None].to(device),
                             torch.tensor([float(len(aux))], device=device),
                             fusion=_fusion(config))
    return out[0]


def reference_loss(config: dict):
    """loss(params, batch) of the trainer's step, on the reference."""
    m, fusion = config["model"], _fusion(config)
    return ref_training.tss_loss(
        config["training"]["ce_gamma"],
        lambda p, mix, r, rl: ref.tss_forward(p, m, mix, r, rl, train=True, fusion=fusion))
