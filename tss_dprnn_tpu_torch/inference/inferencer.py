"""Inferencer plumbing shared by the model families
(counterpart of ``tss_dprnn_tpu/inference/inferencer.py``).

Semantics kept from the JAX package: a checkpoint is mandatory (a bare
state_dict or a trainer's ``{"model": ...}`` file); the model
runs in eval mode; bucketed batches run the masked forward; results land in
``all_metrics.csv`` and ``final_metrics.json`` with the ``{metric,
metric_imp}`` schema. Metrics are computed on the device. SI-SDR is the
only metric of the port so far: a config asking for another one raises.
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

from tss_dprnn_tpu_torch.device import resolve_device
from tss_dprnn_tpu_torch.utils.checkpoint import load_model

SUPPORTED_METRICS = ("si_sdr",)


class Inferencer:
    """Subclasses provide ``_make_loader(test_set, batch_size, n_buckets,
    multiple)`` and ``_batch_rows(batch) -> [{"index", metric, "input_" +
    metric, ...}]``."""

    def __init__(self, model: torch.nn.Module, config: Dict[str, Any],
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.logger = logging.getLogger(__name__)
        self.metrics = list(config.get("metrics", list(SUPPORTED_METRICS)))
        unsupported = [m for m in self.metrics if m not in SUPPORTED_METRICS]
        if unsupported:
            raise NotImplementedError(
                f"metrics {unsupported} are not ported yet; the port computes {SUPPORTED_METRICS}")
        self.test_savedir = config.get("test_savedir", ".")
        checkpoint_path = config.get("checkpoint_path")
        if checkpoint_path is None:
            raise ValueError("checkpoint_path is required for inference")
        self.logger.info("Testing for pretrained: %s.", checkpoint_path)
        load_model(checkpoint_path, model)  # a bare state_dict or a trainer's checkpoint
        self.model = model.to(self.device).eval()

    def _to_device(self, batch: Dict[str, np.ndarray], keys) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(batch[k]).to(self.device) for k in keys}

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
