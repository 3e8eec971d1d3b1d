"""RawNet TSS trainer (counterpart of
``tss_dprnn_tpu/training/trainer_rawnet.py``): the loss of :class:`TrainerSpe`
on batches whose references the collate resampled to 16 kHz
(``collate_spe(resample_ref_to=16000)``).

One departure from the JAX trainer: the demo mixtures of
``logs.metadata.ids`` come from the eval set at 8 kHz, and the JAX trainer
hands their references to the 16 kHz embedder as they are. This trainer
resamples them to 16 kHz first, as the reference trainer does
(``trainer_rawnet.py:14-16,31``). It moves only the reporter's demo audio,
never a loss or a metric.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from tss_dprnn_tpu_torch.data.resample import resample
from tss_dprnn_tpu_torch.training.trainer_spe import TrainerSpe

REF_RATE = 16000  # the embedder's rate


class TrainerRawNet(TrainerSpe):
    # RawNet3 keeps the reference's ``spk_encoder.bn1`` for its state_dict,
    # but its forward never reads it
    unused_parameters = True

    def _estimate_mixture(self, item: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        rate = int((self.config.get("data") or {}).get("sample_rate", 8000))
        ref = resample(np.asarray(item["reference"], np.float32), rate, REF_RATE)
        return super()._estimate_mixture(dict(item, reference=ref))
