"""Target-speech-separation trainer (counterpart of
``tss_dprnn_tpu/training/trainer_spe.py``): loss = PIT SI-SDR(estimate,
target as the single source) + ``ce_gamma`` * cross-entropy(speaker logits,
speaker index) in training, SI-SDR alone in eval. The model and the SI-SDR
term read the batch's lengths as :meth:`Trainer._lengths_for` gives them;
with ``is_metrics`` the estimate goes into ``aux``. The eval mixtures'
estimates go to the reporter as 'inference_spe'. In a process group the
references are padded to the global batch's longest (``Trainer``'s data
parallelism)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tss_dprnn_tpu_torch import parallel
from tss_dprnn_tpu_torch.ops import losses
from tss_dprnn_tpu_torch.training.trainer import Trainer


class TrainerSpe(Trainer):
    def __init__(self, model, config, **kwargs):
        super().__init__(model, config, **kwargs)
        self.ce_gamma = float(config.get("ce_gamma", 0.5))

    def _forward_loss(self, batch: Dict[str, torch.Tensor], train: bool):
        model_lengths, loss_lengths = self._lengths_for(batch)
        est, logits = self._net(train)(batch["mix"], batch["reference"], batch["ref_len"],
                                       lengths=model_lengths)
        sisdr = losses.pit_sisdr_loss(est[:, None], batch["target"][:, None],
                                      lengths=loss_lengths)
        extra = {"est": est} if self.is_metrics else {}
        if not train:
            return sisdr, extra
        ce = losses.cross_entropy(logits, batch["spk_idx"])
        return sisdr + self.ce_gamma * ce, {"l": sisdr, "ce": ce, **extra}

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The batch on the device; in a process group the references padded
        on the host to the global batch's longest (over the data axis), as
        one process collates them (the speaker encoder's BatchNorm counts
        the padded frames)."""
        ref = np.asarray(batch["reference"])
        extra = parallel.longest_over_processes(ref.shape[1], self.mesh) - ref.shape[1]
        if extra:
            batch = dict(batch, reference=np.pad(ref, ((0, 0), (0, extra))))
        return super()._to_device(batch)

    mixtures_mode = "inference_spe"

    def _estimate_mixture(self, item: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        mix, ref = (torch.from_numpy(np.asarray(item[k], np.float32))[None].to(self.device)
                    for k in ("mix", "reference"))
        ref_len = torch.tensor([float(ref.shape[1])], device=self.device)
        est, _ = self.model(mix, ref, ref_len)
        return {"estimated": est[0].cpu().numpy()}

    def _log_step(self, step, total_loss, aux):
        if aux:
            self.logger.info("l: %s, ce: %s", float(aux["l"]), float(aux["ce"]))
        super()._log_step(step, total_loss, aux)
