"""The BSS inferencer, and the plumbing the other model families share
(counterpart of ``tss_dprnn_tpu/inference/inferencer.py``).

Semantics kept from the JAX package: a checkpoint is mandatory (a bare
state_dict or a trainer's ``{"model": ...}`` file); the model runs in eval
mode; bucketed batches run the masked forward; results land in
``all_metrics.csv`` and ``final_metrics.json`` with the ``{metric,
metric_imp}`` schema, a metric that a row could not score (None or NaN) left
out of the means. For blind source separation the estimates are reordered to
the best permutation by PIT SI-SDR on the device, SI-SDR is computed there,
and a row's metric is the mean over its sources. A config without
``metrics`` asks for the JAX package's default, ``["si_sdr", "stoi",
"pesq"]``.

Two metric lanes, as in the JAX package (inferencer.py:71-81, 125-162):
- the default: STOI and PESQ on the host in float64 (``ops/metrics``) on the
  device's estimate, cut to each row's length, on a pool of threads that
  scores earlier batches while the next batch's forward runs
  (``run(overlap_metrics=True)``);
- ``device_metrics``: STOI on the device (``ops/stoi.stoi_batch``), and with
  ``device_pesq`` (which turns ``device_metrics`` on) PESQ too
  (``ops/pesq_device.pesq_batch``), fp32, each one call per source on the
  estimate's rows stacked over the mixture's (2B rows), the estimate zeroed
  past each row's length first. PESQ without ``device_pesq`` stays on the
  host.
The estimate crosses to the host only for a host metric, and the pool starts
only then: with ``device_pesq`` neither happens (``host_counts`` counts
both). An optional reporter (``reporters.Reporter``) gets each TSS row's
'test' record in batch order.

Data parallelism (JAX ``inference/inferencer.py:82-116``, ``cli/test.py:
66-92``): in a process group of W processes each runs the whole batches
``plan[i::W]`` of the bucketed loader on its own card and writes its rows
to ``test_savedir/proc<i>/``, the JAX package's multi-host layout; the
rows are then gathered, and process 0 writes ``all_metrics.csv`` and
``final_metrics.json`` of every row into ``test_savedir``, the files one
process writes. No batch is split over cards, so the JAX Inferencer's
padded tail rows (``pad_to_batch``) have no counterpart.

Under a mesh (``mesh=parallel.make_mesh(data, model)``, JAX
``inferencer.py:84-91``) the data axis takes the part of the processes
above: each data group runs the whole batches ``plan[d::data]``; with a
``model`` axis of 2 or more each process keeps its slices of the matched
weights (``parallel.ShardedParameters``), gathered whole once for the run.
Model index 0 of each data group writes ``proc<d>/``, and process 0 the
merged files.
"""

from __future__ import annotations

import contextlib
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

from tss_dprnn_tpu_torch import parallel
from tss_dprnn_tpu_torch.data.loader import BucketedEvalLoader, collate_bss_eval
from tss_dprnn_tpu_torch.device import resolve_device
from tss_dprnn_tpu_torch.ops import metrics as metrics_mod
from tss_dprnn_tpu_torch.ops.losses import masked_si_sdr, pit_sisdr_loss
from tss_dprnn_tpu_torch.ops.masking import length_mask
from tss_dprnn_tpu_torch.ops.pesq_device import pesq_batch
from tss_dprnn_tpu_torch.ops.rnn import serving_time_major
from tss_dprnn_tpu_torch.ops.stoi import stoi_batch
from tss_dprnn_tpu_torch.utils.checkpoint import load_model

SUPPORTED_METRICS = ("si_sdr", "stoi", "pesq")
# what a config without ``metrics`` asks for, as in the JAX package
DEFAULT_METRICS = ("si_sdr", "stoi", "pesq")
# batches whose estimate was copied to the host for its metrics, and metric
# pools started, since the process began (or the caller last zeroed them)
host_counts = {"estimates": 0, "pools": 0}


class Inferencer:
    """Blind source separation (mode ``bss``): ``model(mix, lengths=...) ->
    [B, n_src, T]``. Subclasses for the other families override
    ``_make_loader(test_set, batch_size, n_buckets, multiple)``, ``forward``
    and ``_separate(batch) -> (estimates, targets, tensors)``, the estimates
    and targets [B, n_src, T] on the device and ``tensors`` the batch's
    ``mix`` and ``lengths`` there; ``_host_targets(batch, b)`` gives row
    ``b``'s reference signals for the host metrics and ``_emit_rows`` hands
    rows to the reporter."""

    def __init__(self, model: torch.nn.Module, config: Dict[str, Any],
                 device: Optional[Union[str, torch.device]] = None, reporter=None,
                 mesh: Optional[parallel.Mesh] = None):
        self.device = resolve_device(device)
        self.logger = logging.getLogger(__name__)
        self.reporter = reporter
        self.metrics = list(config.get("metrics", DEFAULT_METRICS))
        unsupported = [m for m in self.metrics if m not in SUPPORTED_METRICS]
        if unsupported:
            raise NotImplementedError(f"metrics {unsupported} are not ported; the port "
                                      f"computes {SUPPORTED_METRICS}")
        self.device_pesq = bool(config.get("device_pesq", False))
        self.device_metrics = bool(config.get("device_metrics", False)) or self.device_pesq
        on_device = ("stoi", "pesq") if self.device_pesq else ("stoi",) if self.device_metrics \
            else ()
        self.device_lane = [m for m in self.metrics if m in on_device]
        self.host_metrics = [m for m in self.metrics if m in ("stoi", "pesq")
                             and m not in on_device]
        self.sample_rate = int((config.get("data") or {}).get("sample_rate", 8000))
        # narrowband below 16 kHz, wideband from there, as the host lane picks
        self._pesq_mode = "nb" if self.sample_rate < 16000 else "wb"
        self.test_savedir = config.get("test_savedir", ".")
        checkpoint_path = config.get("checkpoint_path")
        if checkpoint_path is None:
            raise ValueError("checkpoint_path is required for inference")
        self.logger.info("Testing for pretrained: %s.", checkpoint_path)
        load_model(checkpoint_path, model)  # a bare state_dict or a trainer's checkpoint
        self.model = model.to(self.device).eval()
        self.mesh = mesh
        # each loader's place on the data axis (the process group's without a mesh)
        self._share = {} if mesh is None else dict(process_index=mesh.data_index,
                                                   process_count=mesh.data)
        self.shards = parallel.ShardedParameters(self.model, mesh) \
            if mesh is not None and mesh.model > 1 else None

    def _to_device(self, batch: Dict[str, np.ndarray], keys) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(batch[k]).to(self.device) for k in keys}

    def _make_loader(self, test_set, batch_size: int, n_buckets: int, multiple: int):
        return BucketedEvalLoader(test_set, batch_size, collate_bss_eval, test_set.lengths(),
                                  n_buckets=n_buckets, multiple=multiple, **self._share)

    def forward(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """Masked forward of one bucketed batch -> estimates [B, n_src, T] on
        the device, in the model's own source order. The bf16 lane's scans
        take the serving layout (``ops/rnn.serving_time_major``)."""
        t = self._to_device(batch, ("mix", "lengths"))
        with serving_time_major(self.model):
            return self.model(t["mix"], lengths=t["lengths"])

    def _separate(self, batch: Dict[str, np.ndarray]):
        t = self._to_device(batch, ("mix", "sources", "lengths"))
        _, est = pit_sisdr_loss(self.forward(batch), t["sources"], return_est=True,
                                lengths=t["lengths"])
        return est, t["sources"], t

    def _device_metric(self, name: str, clean: torch.Tensor, deg: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
        if name == "stoi":
            return stoi_batch(clean, deg, lengths, self.sample_rate)
        return pesq_batch(clean, deg, lengths, self.sample_rate, self._pesq_mode)

    def _batch_rows(self, batch: Dict[str, np.ndarray]):
        """A batch's rows with the device metrics, and its estimates on the
        host when a host metric needs them (else None)."""
        est, targets, t = self._separate(batch)
        mix, lens = t["mix"], t["lengths"]
        B, n_src, T = est.shape
        dm = {}
        if "si_sdr" in self.metrics:
            dm["si_sdr"] = masked_si_sdr(est, targets, lens).mean(dim=1)
            dm["input_si_sdr"] = masked_si_sdr(mix[:, None, :].expand_as(est), targets,
                                               lens).mean(dim=1)
        if self.device_lane:
            est = est * length_mask(lens, T, est.dtype)[:, None, :]  # padding is unspecified
            lens2 = torch.cat([lens, lens])
            for name in self.device_lane:
                # per source one call: the estimate's rows over the mixture's
                both = torch.stack([self._device_metric(
                    name, torch.cat([targets[:, j], targets[:, j]]),
                    torch.cat([est[:, j], mix]), lens2) for j in range(n_src)], dim=1)
                dm[name], dm["input_" + name] = both[:B].mean(dim=1), both[B:].mean(dim=1)
        host = {k: v.cpu().numpy() for k, v in dm.items()}
        rows = [dict({k: float(v[b]) for k, v in host.items()}, index=int(i))
                for b, i in enumerate(batch["indices"])]
        if not self.host_metrics:
            return rows, None
        host_counts["estimates"] += 1
        return rows, est.cpu().numpy()

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

    def _emit_rows(self, batch: Dict[str, np.ndarray], rows: List[Dict[str, Any]]) -> None:
        """Hand a batch's rows to the reporter; called in batch order."""

    def run(self, test_set, batch_size: int = 8, n_buckets: int = 8,
            bucket_multiple: int = 2000, overlap_metrics: bool = True,
            metrics_workers: Optional[int] = None) -> Dict[str, Optional[float]]:
        """Evaluate ``test_set``; write all_metrics.csv and final_metrics.json.

        With host metrics asked for and ``overlap_metrics``, a FIFO pool of
        ``metrics_workers`` threads (default ``min(4, cpu_count)``; numpy's
        STOI and PESQ release the interpreter lock) scores earlier batches
        while the next batch runs on the device. The rows equal those of the
        serial loop (``overlap_metrics=False``), and reach the reporter in
        batch order either way."""
        rows: List[Dict[str, Any]] = []
        start = time.time()
        loader = self._make_loader(test_set, batch_size, n_buckets, bucket_multiple)

        def consume(batch, batch_rows):
            self._emit_rows(batch, batch_rows)
            rows.extend(batch_rows)

        # the whole weights are gathered outside inference mode: the scans'
        # weight cache reads their version counters
        whole = self.shards.full() if self.shards is not None else contextlib.nullcontext()
        with torch.no_grad(), whole, torch.inference_mode():
            if self.host_metrics and overlap_metrics:
                workers = metrics_workers or min(4, os.cpu_count() or 1)
                host_counts["pools"] += 1
                pending: deque = deque()
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    for batch in loader:
                        pending.append((batch, pool.submit(self._host_rows, batch,
                                                           *self._batch_rows(batch))))
                        while len(pending) > 2 + workers:  # bound the estimates held
                            batch, fut = pending.popleft()
                            consume(batch, fut.result())
                    while pending:
                        batch, fut = pending.popleft()
                        consume(batch, fut.result())
            else:
                for batch in loader:
                    consume(batch, self._host_rows(batch, *self._batch_rows(batch)))
        self.logger.info("Finished *** <Total time:%.3f min>.", (time.time() - start) / 60)
        if parallel.process_count() == 1:
            return self._save_result(rows)
        rank = parallel.process_index()
        if self.mesh is None:
            self._save_result(rows, os.path.join(self.test_savedir, f"proc{rank}"))
        elif self.mesh.model_index == 0:
            self._save_result(rows, os.path.join(self.test_savedir,
                                                 f"proc{self.mesh.data_index}"))
        merged = sorted((r for part in parallel.gather_objects(rows, self.mesh) for r in part),
                        key=lambda r: r["index"])
        final = self._save_result(merged) if rank == 0 else self._final_metrics(merged)
        parallel.barrier()
        return final

    def _save_result(self, rows: List[Dict[str, Any]],
                     savedir: Optional[str] = None) -> Dict[str, Optional[float]]:
        """The rows in index order and their means, written to ``savedir``
        (default ``test_savedir``); returns the means."""
        savedir = savedir or self.test_savedir
        os.makedirs(savedir, exist_ok=True)
        rows = sorted(rows, key=lambda r: r["index"])
        final = self._final_metrics(rows)
        columns = [c for c in rows[0] if c != "index"] if rows else []
        with open(os.path.join(savedir, "all_metrics.csv"), "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["index"] + columns)
            for r in rows:
                writer.writerow([r["index"]] + [r[c] for c in columns])
        self.logger.info("Overall metrics: %s", final)
        with open(os.path.join(savedir, "final_metrics.json"), "w") as f:
            json.dump(final, f, indent=0)
        return final

    def _final_metrics(self, rows: List[Dict[str, Any]]) -> Dict[str, Optional[float]]:
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
        return final
