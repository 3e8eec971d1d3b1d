"""Target-speech-separation inferencer
(counterpart of ``tss_dprnn_tpu/inference/inferencer_spe.py``): the forward
takes the reference waveform and its length; metrics are single-source
(target vs estimate): SI-SDR on the device as in the JAX package's
device-metrics lane (inferencer_spe.py:30-42), STOI and PESQ on the host."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tss_dprnn_tpu_torch.data.loader import BucketedEvalLoader, make_collate_spe_eval
from tss_dprnn_tpu_torch.inference.inferencer import Inferencer
from tss_dprnn_tpu_torch.ops.losses import masked_si_sdr


class InferencerSpe(Inferencer):
    def _make_loader(self, test_set, batch_size: int, n_buckets: int, multiple: int):
        return BucketedEvalLoader(test_set, batch_size, make_collate_spe_eval(),
                                  test_set.lengths(), n_buckets=n_buckets, multiple=multiple)

    def forward(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """Masked forward of one bucketed batch -> estimates [B, T] on the device."""
        t = self._to_device(batch, ("mix", "reference", "ref_len", "lengths"))
        est, _ = self.model(t["mix"], t["reference"], t["ref_len"], lengths=t["lengths"])
        return est

    def _batch_rows(self, batch: Dict[str, np.ndarray]):
        est = self.forward(batch)
        t = self._to_device(batch, ("mix", "target", "lengths"))
        rows = [{"index": int(i)} for i in batch["indices"]]
        if "si_sdr" in self.metrics:
            si_sdr = masked_si_sdr(est, t["target"], t["lengths"]).cpu().numpy()
            input_si_sdr = masked_si_sdr(t["mix"], t["target"], t["lengths"]).cpu().numpy()
            for b, row in enumerate(rows):
                row.update(si_sdr=float(si_sdr[b]), input_si_sdr=float(input_si_sdr[b]))
        return rows, (est.cpu().numpy() if self.host_metrics else None)

    def _host_targets(self, batch: Dict[str, np.ndarray], b: int) -> np.ndarray:
        return batch["target"][b]
