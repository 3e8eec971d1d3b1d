"""The BSS inferencer, and the plumbing the other model families share
(counterpart of ``tss_dprnn_tpu/inference/inferencer.py``).

Semantics kept from the JAX package: a checkpoint is mandatory (a bare
state_dict or a trainer's ``{"model": ...}`` file); the model
runs in eval mode; bucketed batches run the masked forward; results land in
``all_metrics.csv`` and ``final_metrics.json`` with the ``{metric,
metric_imp}`` schema, a metric that a row could not score (None) left out of
the means. The metric lanes are those of the JAX package's
``device_metrics`` lane (inferencer.py:125-142, 279-300), with STOI on the
host: for blind source separation the estimates are reordered to the best
permutation by PIT SI-SDR on the device, SI-SDR is computed there, and a
row's metric is the mean over its sources. STOI and PESQ run on the host in
float64 (``ops/metrics.get_metrics``) on the device's reordered estimate,
cut to each row's length; the audio crosses to the host only when one of
them is asked for. A pool of threads computes them while the next batch's
forward runs (``run(overlap_metrics=True)``). A config without ``metrics``
asks for the JAX package's default, ``["si_sdr", "stoi", "pesq"]``.
``device_pesq`` (PESQ on the device) is not ported yet and raises.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from tss_dprnn_tpu_torch.data.loader import BucketedEvalLoader, collate_bss_eval
from tss_dprnn_tpu_torch.device import resolve_device
from tss_dprnn_tpu_torch.ops import metrics as metrics_mod
from tss_dprnn_tpu_torch.ops.losses import masked_si_sdr, pit_sisdr_loss
from tss_dprnn_tpu_torch.utils.checkpoint import load_model

SUPPORTED_METRICS = ("si_sdr", "stoi", "pesq")
# computed on the host from the estimates (the rest on the device)
HOST_METRICS = ("stoi", "pesq")
# what a config without ``metrics`` asks for, as in the JAX package
DEFAULT_METRICS = ("si_sdr", "stoi", "pesq")


class Inferencer:
    """Blind source separation (mode ``bss``): ``model(mix, lengths=...) ->
    [B, n_src, T]``. Subclasses for the other families override
    ``_make_loader(test_set, batch_size, n_buckets, multiple)``, ``forward``
    and ``_batch_rows(batch) -> (rows, estimates)``, where each row is
    ``{"index", metric, "input_" + metric, ...}`` for the device metrics and
    the estimates are what the host metrics need (None when none is asked
    for); ``_host_targets(batch, b)`` gives row ``b``'s reference signals."""

    def __init__(self, model: torch.nn.Module, config: Dict[str, Any],
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.logger = logging.getLogger(__name__)
        self.metrics = list(config.get("metrics", DEFAULT_METRICS))
        unsupported = [m for m in self.metrics if m not in SUPPORTED_METRICS]
        if unsupported:
            raise NotImplementedError(f"metrics {unsupported} are not ported; the port "
                                      f"computes {SUPPORTED_METRICS}")
        if config.get("device_pesq"):
            raise NotImplementedError("device_pesq (PESQ on the device, ops/pesq_jax.py) is not "
                                      "ported yet: ROADMAP §1 item 4; the port scores PESQ on "
                                      "the host")
        self.host_metrics = [m for m in self.metrics if m in HOST_METRICS]
        self.sample_rate = int((config.get("data") or {}).get("sample_rate", 8000))
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

    def _batch_rows(self, batch: Dict[str, np.ndarray]):
        t = self._to_device(batch, ("mix", "sources", "lengths"))
        lens = t["lengths"]
        _, est = pit_sisdr_loss(self.forward(batch), t["sources"], return_est=True, lengths=lens)
        rows = [{"index": int(i)} for i in batch["indices"]]
        if "si_sdr" in self.metrics:
            mix_n = t["mix"][:, None, :].expand_as(est)
            si_sdr = masked_si_sdr(est, t["sources"], lens).mean(dim=1).cpu().numpy()
            input_si_sdr = masked_si_sdr(mix_n, t["sources"], lens).mean(dim=1).cpu().numpy()
            for b, row in enumerate(rows):
                row.update(si_sdr=float(si_sdr[b]), input_si_sdr=float(input_si_sdr[b]))
        return rows, (est.cpu().numpy() if self.host_metrics else None)

    def _host_targets(self, batch: Dict[str, np.ndarray], b: int) -> np.ndarray:
        return batch["sources"][b]

    def _host_rows(self, batch: Dict[str, np.ndarray], rows: List[Dict[str, Any]],
                   est: Optional[np.ndarray]) -> List[Dict[str, Any]]:
        """Fill the host metrics into a batch's rows, each over the row's
        valid samples, with columns in the order of ``self.metrics``.
        Touches nothing shared: it runs on the metric pool."""
        out = []
        for b, row in enumerate(rows):
            if self.host_metrics:
                n = int(batch["lengths"][b])
                row = dict(row, **metrics_mod.get_metrics(
                    batch["mix"][b, :n], self._host_targets(batch, b)[..., :n],
                    est[b][..., :n], self.sample_rate, self.host_metrics))
            out.append({"index": row["index"],
                        **{k: row[k] for m in self.metrics for k in (m, "input_" + m)}})
        return out

    def run(self, test_set, batch_size: int = 8, n_buckets: int = 8,
            bucket_multiple: int = 2000, overlap_metrics: bool = True,
            metrics_workers: Optional[int] = None) -> Dict[str, Optional[float]]:
        """Evaluate ``test_set``; write all_metrics.csv and final_metrics.json.

        With host metrics asked for and ``overlap_metrics``, a FIFO pool of
        ``metrics_workers`` threads (default ``min(4, cpu_count)``; numpy's
        STOI and PESQ release the interpreter lock) scores earlier batches
        while the next batch runs on the device. The rows equal those of the
        serial loop (``overlap_metrics=False``)."""
        rows: List[Dict[str, Any]] = []
        start = time.time()
        loader = self._make_loader(test_set, batch_size, n_buckets, bucket_multiple)
        with torch.inference_mode():
            if self.host_metrics and overlap_metrics:
                workers = metrics_workers or min(4, os.cpu_count() or 1)
                pending: deque = deque()
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    for batch in loader:
                        pending.append(pool.submit(self._host_rows, batch,
                                                   *self._batch_rows(batch)))
                        while len(pending) > 2 + workers:  # bound the estimates held
                            rows.extend(pending.popleft().result())
                    while pending:
                        rows.extend(pending.popleft().result())
            else:
                for batch in loader:
                    rows.extend(self._host_rows(batch, *self._batch_rows(batch)))
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
            # a metric a row could not score (None; STOI's NaN on too short
            # a signal) is left out of the means, as pandas' mean skips it
            vals = np.array([np.nan if r[name] is None else r[name] for r in rows], np.float64)
            inputs = np.array([np.nan if r["input_" + name] is None else r["input_" + name]
                               for r in rows], np.float64)
            if np.isnan(vals).all():
                final[name] = final[name + "_imp"] = None
                continue
            final[name] = float(np.nanmean(vals))
            imp = vals - inputs
            final[name + "_imp"] = None if np.isnan(imp).all() else float(np.nanmean(imp))
        self.logger.info("Overall metrics: %s", final)
        with open(os.path.join(self.test_savedir, "final_metrics.json"), "w") as f:
            json.dump(final, f, indent=0)
        return final
