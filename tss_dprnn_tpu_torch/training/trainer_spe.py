"""Target-speech-separation trainer (counterpart of
``tss_dprnn_tpu/training/trainer_spe.py``): loss = PIT SI-SDR(estimate,
target as the single source) + ``ce_gamma`` * cross-entropy(speaker logits,
speaker index) in training, SI-SDR alone in eval."""

from __future__ import annotations

from typing import Dict

import torch

from tss_dprnn_tpu_torch.ops import losses
from tss_dprnn_tpu_torch.training.trainer import Trainer


class TrainerSpe(Trainer):
    def __init__(self, model, config, **kwargs):
        super().__init__(model, config, **kwargs)
        self.ce_gamma = float(config.get("ce_gamma", 0.5))

    def _forward_loss(self, batch: Dict[str, torch.Tensor], train: bool):
        est, logits = self.model(batch["mix"], batch["reference"], batch["ref_len"])
        sisdr = losses.pit_sisdr_loss(est[:, None], batch["target"][:, None])
        if not train:
            return sisdr, {}
        ce = losses.cross_entropy(logits, batch["spk_idx"])
        return sisdr + self.ce_gamma * ce, {"l": sisdr, "ce": ce}

    def _log_step(self, step, total_loss, aux):
        if aux:
            self.logger.info("l: %s, ce: %s", float(aux["l"]), float(aux["ce"]))
        super()._log_step(step, total_loss, aux)
