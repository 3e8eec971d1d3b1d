"""Target-speech-separation inferencer
(counterpart of ``tss_dprnn_tpu/inference/inferencer_spe.py``): the forward
takes the reference waveform and its length; metrics are single-source
(target vs estimate), in the lanes of :class:`Inferencer`. Each row goes to
the reporter as a 'test' record, in batch order (``inferencer_spe.py:89-115``);
the record holds the row's id and metrics, so the log-only reporter needs
no audio from the device."""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from tss_dprnn_tpu_torch.data.loader import BucketedEvalLoader, make_collate_spe_eval
from tss_dprnn_tpu_torch.inference.inferencer import Inferencer
from tss_dprnn_tpu_torch.ops.rnn import serving_time_major


class InferencerSpe(Inferencer):
    # the rate the eval collate resamples references to (None: as read)
    resample_ref_to = None

    def _make_loader(self, test_set, batch_size: int, n_buckets: int, multiple: int):
        collate = make_collate_spe_eval(self.resample_ref_to, self.sample_rate)
        return BucketedEvalLoader(test_set, batch_size, collate, test_set.lengths(),
                                  n_buckets=n_buckets, multiple=multiple, **self._share)

    def forward(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """Masked forward of one bucketed batch -> estimates [B, T] on the device."""
        t = self._to_device(batch, ("mix", "reference", "ref_len", "lengths"))
        with serving_time_major(self.model):
            est, _ = self.model(t["mix"], t["reference"], t["ref_len"], lengths=t["lengths"])
        return est

    def _separate(self, batch: Dict[str, np.ndarray]):
        est = self.forward(batch)
        t = self._to_device(batch, ("mix", "target", "lengths"))
        return est[:, None], t["target"][:, None], t

    def _host_targets(self, batch: Dict[str, np.ndarray], b: int) -> np.ndarray:
        return batch["target"][b]

    def _emit_rows(self, batch: Dict[str, np.ndarray], rows: List[Dict[str, Any]]) -> None:
        if self.reporter is None:
            return

        def imp(row, name):
            a, ia = row.get(name), row.get("input_" + name)
            return None if a is None or ia is None else a - ia

        for row in rows:
            self.reporter.add_and_report(
                logs={"id": row["index"], **{m: row.get(m) for m in ("si_sdr", "stoi", "pesq")},
                      **{f"{m}_imp": imp(row, m) for m in ("si_sdr", "stoi", "pesq")}},
                mode="test")
