"""The BSS inferencer, and the plumbing the other model families share
(counterpart of ``tss_dprnn_tpu/inference/inferencer.py``).

Semantics kept from the JAX package: a checkpoint is mandatory (a bare
state_dict or a trainer's ``{"model": ...}`` file); the model
runs in eval mode; bucketed batches run the masked forward; results land in
``all_metrics.csv`` and ``final_metrics.json`` with the ``{metric,
metric_imp}`` schema. Metrics are computed on the device, as in the JAX
package's ``device_metrics`` lane (inferencer.py:125-142, 291-300): for blind
source separation the estimates are reordered to the best permutation by
PIT SI-SDR first, and a row's metric is the mean over its sources. A
config without ``metrics`` asks for the JAX package's default,
``["si_sdr", "stoi", "pesq"]``. SI-SDR is the only metric of the port so far:
a config asking for another one, the default among them, raises.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from tss_dprnn_tpu_torch.data.loader import BucketedEvalLoader, collate_bss_eval
from tss_dprnn_tpu_torch.device import resolve_device
from tss_dprnn_tpu_torch.ops.losses import masked_si_sdr, pit_sisdr_loss
from tss_dprnn_tpu_torch.utils.checkpoint import load_model

SUPPORTED_METRICS = ("si_sdr",)
# what a config without ``metrics`` asks for, as in the JAX package
DEFAULT_METRICS = ("si_sdr", "stoi", "pesq")


class Inferencer:
    """Blind source separation (mode ``bss``): ``model(mix, lengths=...) ->
    [B, n_src, T]``. Subclasses for the other families override
    ``_make_loader(test_set, batch_size, n_buckets, multiple)``, ``forward``
    and ``_batch_rows(batch) -> [{"index", metric, "input_" + metric, ...}]``."""

    def __init__(self, model: torch.nn.Module, config: Dict[str, Any],
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.logger = logging.getLogger(__name__)
        self.metrics = list(config.get("metrics", DEFAULT_METRICS))
        unsupported = [m for m in self.metrics if m not in SUPPORTED_METRICS]
        if unsupported:
            default = "" if "metrics" in config else (
                f" (a config without `metrics` asks for the JAX default {list(DEFAULT_METRICS)}; "
                f"name `metrics: [si_sdr]` for the port)")
            raise NotImplementedError(f"metrics {unsupported} are not ported yet; the port "
                                      f"computes {SUPPORTED_METRICS}{default}")
        self.test_savedir = config.get("test_savedir", ".")
        checkpoint_path = config.get("checkpoint_path")
        if checkpoint_path is None:
            raise ValueError("checkpoint_path is required for inference")
        self.logger.info("Testing for pretrained: %s.", checkpoint_path)
        load_model(checkpoint_path, model)  # a bare state_dict or a trainer's checkpoint
        self.model = model.to(self.device).eval()

    def _to_device(self, batch: Dict[str, np.ndarray], keys) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(batch[k]).to(self.device) for k in keys}

    def _make_loader(self, test_set, batch_size: int, n_buckets: int, multiple: int):
        return BucketedEvalLoader(test_set, batch_size, collate_bss_eval, test_set.lengths(),
                                  n_buckets=n_buckets, multiple=multiple)

    def forward(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """Masked forward of one bucketed batch -> estimates [B, n_src, T] on
        the device, in the model's own source order."""
        t = self._to_device(batch, ("mix", "lengths"))
        return self.model(t["mix"], lengths=t["lengths"])

    def _batch_rows(self, batch: Dict[str, np.ndarray]) -> List[Dict[str, Any]]:
        t = self._to_device(batch, ("mix", "sources", "lengths"))
        lens = t["lengths"]
        _, est = pit_sisdr_loss(self.forward(batch), t["sources"], return_est=True, lengths=lens)
        mix_n = t["mix"][:, None, :].expand_as(est)
        si_sdr = masked_si_sdr(est, t["sources"], lens).mean(dim=1).cpu().numpy()
        input_si_sdr = masked_si_sdr(mix_n, t["sources"], lens).mean(dim=1).cpu().numpy()
        return [{"index": int(i), "si_sdr": float(si_sdr[b]),
                 "input_si_sdr": float(input_si_sdr[b])}
                for b, i in enumerate(batch["indices"])]

    def run(self, test_set, batch_size: int = 8, n_buckets: int = 8,
            bucket_multiple: int = 2000) -> Dict[str, Optional[float]]:
        """Evaluate ``test_set``; write all_metrics.csv and final_metrics.json."""
        rows: List[Dict[str, Any]] = []
        start = time.time()
        with torch.inference_mode():
            for batch in self._make_loader(test_set, batch_size, n_buckets, bucket_multiple):
                rows.extend(self._batch_rows(batch))
        self.logger.info("Finished *** <Total time:%.3f min>.", (time.time() - start) / 60)
        return self._save_result(rows)

    def _save_result(self, rows: List[Dict[str, Any]]) -> Dict[str, Optional[float]]:
        os.makedirs(self.test_savedir, exist_ok=True)
        rows = sorted(rows, key=lambda r: r["index"])
        columns = [c for c in rows[0] if c != "index"] if rows else []
        with open(os.path.join(self.test_savedir, "all_metrics.csv"), "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["index"] + columns)
            for r in rows:
                writer.writerow([r["index"]] + [r[c] for c in columns])
        final: Dict[str, Optional[float]] = {}
        for name in self.metrics:
            vals = np.array([r[name] for r in rows], np.float64)
            inputs = np.array([r["input_" + name] for r in rows], np.float64)
            final[name] = float(vals.mean()) if rows else None
            final[name + "_imp"] = float((vals - inputs).mean()) if rows else None
        self.logger.info("Overall metrics: %s", final)
        with open(os.path.join(self.test_savedir, "final_metrics.json"), "w") as f:
            json.dump(final, f, indent=0)
        return final
