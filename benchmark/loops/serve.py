"""The serving loop: one client, closed loop, requests back to back.

Traffic parameters (``traffic/<mix>.json``):
- ``mix_seconds``, ``ref_seconds``: the ranges of mixture and reference
  lengths, drawn fresh from the seed for every ``cycle`` requests
  (``lib/audio.py``: continuous lengths, none repeated);
- ``bucketed`` true: requests are admitted in blocks of ``cycle`` in arrival
  order, each block grouped by the program's ``BucketedEvalLoader``
  (``batch_size``, ``n_buckets``, ``multiple``) with its eval collate
  (references padded to a multiple of ``ref_multiple``); false: each
  request is a batch of its own at its own length;
- ``warm_up``: how many requests set-up serves, from a stream of their own
  (fresh lengths over the same ranges), so that the window meets each new
  length as users' traffic does;
- ``check_requests``: how many completed requests the correctness check
  draws from the seed (the longest completed one besides).
Each batch goes through the family's inferencer's ``forward`` and its
estimates are copied to the host; a request is done when they are there.
The window serves until ``seconds`` have passed at a batch's start.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark.lib import audio, port
from benchmark.lib.weights import seeded_state
from benchmark.reference import dprnn as ref

WINDOW_STREAM, WARM_UP_STREAM = 0, 1


class Loop:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 scratch: str, family, flops, peaks: dict):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.scratch, self.family, self.flops, self.peaks = scratch, family, flops, peaks
        source = audio.Source(seed)

        def stream(index: int, cycle: int) -> audio.Requests:
            return audio.Requests(source, traffic["mix_seconds"], traffic["ref_seconds"], cycle,
                                  config["sample_rate"], index)

        self.requests = stream(WINDOW_STREAM, traffic["cycle"])
        self.warm_requests = stream(WARM_UP_STREAM, traffic["warm_up"])
        self.item = functools.partial(family.item, config)
        self.collate = family.eval_collate(config, traffic.get("ref_multiple", 1))
        self.done: Dict[int, tuple] = {}  # request id -> (host batch, row, length)
        self.latencies: List[float] = []
        self.records: List[dict] = []

    # ------------------------------------------------------------------ set-up

    def setup(self, trace: bool, patch: Optional[Callable] = None) -> None:
        self.phases = {"start": time.perf_counter()}
        self.state = seeded_state(port.template(self.config), self.seed, self.device)
        self.phases["weights"] = time.perf_counter()
        self.inf = self.family.inferencer(self.config, self.state, self.device, self.scratch)
        self.phases["inferencer"] = time.perf_counter()
        if trace:
            from benchmark.lib.trace import instrument_modules
            instrument_modules(self.inf.model, port.RNN_MODULE, backward=False)
        if patch is not None:
            patch(self)
        with torch.inference_mode():
            self._serve(self.warm_requests, lambda: False, cycles=1)
        self._sync()
        self.phases["warm_up"] = time.perf_counter()
        self.done.clear()
        self.latencies.clear()
        self.records.clear()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ window

    def _batches(self, requests: audio.Requests, cycle: int):
        """Batches of one cycle: [(batch dict, request ids)]."""
        t = self.traffic
        ids = list(range(cycle * requests.n, (cycle + 1) * requests.n))
        block = audio.Items(requests, self.item, ids)
        if t["bucketed"]:
            loader = port.bucketed_loader(block, block.lengths(), t["batch_size"], self.collate,
                                          t["n_buckets"], t["multiple"])
            for batch in loader:
                yield batch, [ids[i] for i in batch["indices"]]
        else:
            for i, rid in enumerate(ids):
                n = requests.mix_len(rid)
                batch = self.collate([block[i]], n)
                batch["lengths"] = np.array([n], np.int32)
                yield batch, [rid]

    def _serve(self, requests: audio.Requests, stop: Callable[[], bool],
               cycles: Optional[int] = None, stretch=None) -> None:
        """Serves whole cycles (``cycles`` of them) or until ``stop()`` holds
        at a batch's start. A request's latency runs from taking it (its
        batch's collate) to its estimate on the host."""
        sr, model = self.config["sample_rate"], self.config["model"]
        unit, cycle = 0, 0
        while cycles is None or cycle < cycles:
            batches = self._batches(requests, cycle)
            while True:
                t0 = time.perf_counter()
                if stop():
                    return
                try:
                    batch, ids = next(batches)
                except StopIteration:
                    break
                if stretch is not None:
                    stretch.unit(unit)
                est = self.inf.forward(batch).cpu().numpy()
                self.latencies.append(time.perf_counter() - t0)
                lengths = [requests.mix_len(r) for r in ids]
                refs = [requests.ref_len(r) for r in ids]
                for row, (rid, n) in enumerate(zip(ids, lengths)):
                    self.done[rid] = (est, row, n)
                self.records.append({
                    "audio_s": sum(lengths) / sr,
                    "samples": int(batch["mix"].size),
                    "padded": int(batch["mix"].size - sum(lengths)),
                    "flops": sum(self.flops.forward_flops(model, m, r)
                                 for m, r in zip(lengths, refs)),
                    "lstm_bound_s": self.flops.lstm_bound_s(
                        model, lengths, False, self.peaks["flops_per_s"],
                        self.peaks["bytes_per_s"]),
                })
                unit += 1
            cycle += 1

    def window(self, seconds: float, stretch=None) -> dict:
        t0 = time.perf_counter()
        with torch.inference_mode():
            self._serve(self.requests, lambda: time.perf_counter() - t0 >= seconds,
                        stretch=stretch)
        self._sync()
        window_s = time.perf_counter() - t0
        return {"window_s": window_s, "attempted": len(self.done), "failed": 0,
                "audio_s": sum(r["audio_s"] for r in self.records),
                "latencies_s": [] if self.traffic["bucketed"] else list(self.latencies),
                "records": self.records}

    def free(self) -> None:
        del self.inf
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ correctness

    def sample(self, completed: List[int]) -> List[int]:
        """The requests the check compares: ``check_requests`` drawn from the
        seed among the completed ones, and the longest of them."""
        rng = np.random.default_rng([self.seed, 5])
        k = min(self.traffic["check_requests"], len(completed))
        pick = set(int(i) for i in rng.choice(completed, size=k, replace=False))
        pick.add(max(completed, key=lambda r: (self.requests.mix_len(r), -r)))
        return sorted(pick)

    def _reference(self, rid: int, tf32: bool) -> np.ndarray:
        with torch.no_grad(), ref.precision(tf32):
            out = self.family.reference_estimate(self.state, self.config,
                                                 self.item(self.requests, rid), self.device)
        return out.cpu().numpy()

    @staticmethod
    def _rel(est: np.ndarray, want: np.ndarray) -> float:
        est, want = est.astype(np.float64), want.astype(np.float64)
        return float(np.linalg.norm(est - want) / np.linalg.norm(want))

    def check(self) -> Dict[str, float]:
        """The widest relative L2 gap of a sampled request's estimate, cut to
        its true length, from the reference's."""
        worst = 0.0
        for rid in self.sample(sorted(self.done)):
            est, row, n = self.done[rid]
            worst = max(worst, self._rel(est[row][..., :n], self._reference(rid, False)))
        return {"est_rel_err": worst}

    def control(self, completed: int) -> Dict[str, float]:
        """The check with the reference in TF32 in the program's place, over
        the requests a run that completed ``completed`` would sample."""
        worst = 0.0
        for rid in self.sample(list(range(completed))):
            worst = max(worst, self._rel(self._reference(rid, True), self._reference(rid, False)))
        return {"est_rel_err": worst}
