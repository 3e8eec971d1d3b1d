"""The training loop: the program's trainer over the program's shuffling,
prefetching loader, as a training job runs it.

Traffic parameters (``traffic/<mix>.json``): ``batch_size``,
``crop_seconds`` (every mixture a crop of that length), ``ref_seconds``
(references of the family's items, continuous lengths drawn from the seed
over the ``items`` of the training set, each batch padding them to its
longest), ``prefetch`` (the loader's thread), ``check_steps`` (how many
first steps the reference follows).

Set-up builds one trainer and drives it through its first ``check_steps``
steps, each a call of the trainer's ``train`` over the benchmark's feed,
one batch long, on the loader's first batches (rows that all differ); it
keeps the weights before them, the gradients Adam took in the first (from
its first moment) and the weights after the last. Nothing else is warmed
up: a batch whose padded reference length the program has not met pays
for it in the window, as in a training job. The window is one more call of
``train`` over the same trainer and stream, the feed ending at the first
batch asked for after ``seconds``; ``train`` reads its loss every
``print_freq`` steps and at its end, so the window ends on the host.
"""

from __future__ import annotations

import functools
import statistics
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from benchmark.lib import audio, port
from benchmark.lib.weights import seeded_state
from benchmark.reference import dprnn as ref
from benchmark.reference import training as ref_training


class Feed:
    """The batches ``Trainer.train`` iterates: from the shared stream until
    ``stop()`` holds (checked before each batch), timing the wait in the
    loader and telling the traced stretch where each step starts."""

    def __init__(self, stream: Iterator, stop: Callable[[int], bool], stretch=None,
                 kept: Optional[List] = None):
        self.stream, self.stop, self.stretch, self.kept = stream, stop, stretch, kept
        self.n = 0
        self.wait_s = 0.0
        self.ref_lens: List[List[int]] = []  # each batch's true reference lengths (TSS)

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        while not self.stop(self.n):
            if self.stretch is not None:
                self.stretch.unit(self.n)
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.loader"):
                batch = next(self.stream)
            self.wait_s += time.perf_counter() - t0
            if self.kept is not None:
                self.kept.append(batch)
            if "ref_len" in batch:
                self.ref_lens.append([int(r) for r in batch["ref_len"]])
            self.n += 1
            yield batch


def _forever(loader):
    while True:
        yield from loader


class Loop:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 scratch: str, family, flops, peaks: dict):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.scratch, self.family, self.flops, self.peaks = scratch, family, flops, peaks
        crop = traffic["crop_seconds"]
        self.crop = int(round(crop * config["sample_rate"]))
        requests = audio.Requests(audio.Source(seed), [crop, crop], traffic["ref_seconds"],
                                  traffic["items"], config["sample_rate"])
        self.items = audio.Items(requests, functools.partial(family.item, config),
                                 range(traffic["items"]))
        self.records: List[dict] = []

    # ------------------------------------------------------------------ set-up

    def setup(self, trace: bool, patch: Optional[Callable] = None) -> None:
        self.phases = {"start": time.perf_counter()}
        self.state = seeded_state(port.template(self.config), self.seed, self.device)
        self.phases["weights"] = time.perf_counter()
        self.tr = self.family.trainer(self.config, self.state, self.device, self.scratch)
        self.phases["trainer"] = time.perf_counter()
        if trace:
            from benchmark.lib.trace import OPTIMIZER, instrument_modules, wrap_call
            instrument_modules(self.tr.model, port.RNN_MODULE, backward=True)
            wrap_call(self.tr.optimizer, "step", OPTIMIZER)
        if patch is not None:
            patch(self)
        t = self.traffic
        self.loader = port.train_loader(self.items, t["batch_size"],
                                        self.family.train_collate(self.config), self.seed,
                                        t["prefetch"])
        self.stream = _forever(self.loader)
        params = dict(self.tr.model.named_parameters())
        self.trainable = list(params)
        self.before = {n: p.detach().clone() for n, p in params.items()}
        self.batches: List[dict] = []
        self.losses: List[float] = []
        self.first_grads: Dict[str, torch.Tensor] = {}
        beta1 = self.tr.optimizer.adam.param_groups[0]["betas"][0]
        for k in range(t["check_steps"]):
            self.losses.append(self.tr.train(Feed(self.stream, lambda n: n >= 1,
                                                  kept=self.batches)))
            if k == 0:
                state = self.tr.optimizer.adam.state
                self.first_grads = {n: state[p]["exp_avg"].detach() / (1 - beta1)
                                    for n, p in params.items() if p in state}
        self.after = {n: p.detach().clone() for n, p in params.items()}
        self._sync()
        self.phases["first_steps"] = time.perf_counter()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ window

    def window(self, seconds: float, stretch=None) -> dict:
        model = self.config["model"]
        t0 = time.perf_counter()
        feed = Feed(self.stream, lambda n: time.perf_counter() - t0 >= seconds, stretch)
        self.tr.train(feed)
        self._sync()
        window_s = time.perf_counter() - t0
        crops = [self.crop] * self.traffic["batch_size"]
        bound = self.flops.lstm_bound_s(model, crops, True, self.peaks["flops_per_s"],
                                        self.peaks["bytes_per_s"])
        refs = feed.ref_lens or [[0] * len(crops)] * feed.n
        self.records = [{"flops": self.flops.step_flops(model, crops, r), "lstm_bound_s": bound}
                        for r in refs]
        return {"window_s": window_s, "attempted": feed.n, "failed": 0, "steps": feed.n,
                "loader_wait_s": feed.wait_s, "records": self.records}

    def free(self) -> None:
        self.stream.close()
        del self.tr, self.stream, self.loader
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ correctness

    def _follow(self, tf32: bool, batches: List[dict]) -> dict:
        """The reference's steps from the weights before the first step."""
        tcfg = self.config["training"]
        params = {k: v.detach().clone() for k, v in self.state.items()}
        dev = [{k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in b.items()}
               for b in batches]
        with ref.precision(tf32):
            return ref_training.train_steps(params, self.trainable,
                                            self.family.reference_loss(self.config), dev,
                                            tcfg["optimizer"]["lr"],
                                            tcfg["optimizer"]["weight_decay"],
                                            tcfg["clip_norm"])

    def compare(self, want: dict, losses: List[float], first: Dict[str, torch.Tensor],
                after: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """The readings against a reference run ``want``: the gap of each
        step's loss (``loss_gap_step<k>``) and the widest of them
        (``loss_gap``), in the loss's own units (dB of SI-SDR, plus nats of
        cross-entropy: a loss of random weights on noise can sit near 0,
        where a relative gap means nothing); per leaf, the gap between the
        norms of the first gradient, and of the weights' change over the
        steps, over the larger of the reference leaf's norm and the median
        leaf's: the worst leaf's (``grad_norm_gap``, ``update_norm_gap``)
        and, of the change, the median leaf's (``update_norm_gap_median``).
        Leaves whose reference gradient is under a thousandth of the median
        leaf's are left out of the change. ``first_sign_flips``: the share of
        elements whose first gradient has the other sign than the
        reference's (Adam's first step moves each element by the learning
        rate in that sign). The cell's limits say which readings are
        compared."""
        gaps = [abs(a - b) for a, b in zip(losses, want["losses"])]

        def norms(d):
            return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}

        g_ref, g_got = norms(want["first_grads"]), norms(first)
        g_med = statistics.median(g_ref.values())
        d_ref = norms({k: want["params"][k] - self.before[k] for k in self.trainable})
        d_got = norms({k: after[k] - self.before[k] for k in self.trainable})
        moved = [k for k in self.trainable if g_ref[k] >= 1e-3 * g_med]
        d_med = statistics.median(d_ref[k] for k in moved)
        grad_gap = max(abs(g_got.get(k, 0.0) - g_ref[k]) / max(g_ref[k], g_med)
                       for k in self.trainable)
        move = [abs(d_got[k] - d_ref[k]) / max(d_ref[k], d_med) for k in moved]
        flips = sum(int((torch.sign(first[k]) != torch.sign(g)).sum()) if k in first
                    else g.numel() for k, g in want["first_grads"].items())
        readings = {f"loss_gap_step{k + 1}": g for k, g in enumerate(gaps)}
        readings.update(loss_gap=max(gaps), grad_norm_gap=grad_gap, update_norm_gap=max(move),
                        update_norm_gap_median=statistics.median(move),
                        first_sign_flips=flips / sum(g.numel()
                                                     for g in want["first_grads"].values()))
        return readings

    def check(self) -> Dict[str, float]:
        want = self._follow(False, self.batches)
        return self.compare(want, self.losses, self.first_grads, self.after)

    def control(self, completed: int = 0) -> Dict[str, float]:
        """The check with the reference in TF32 in the program's place."""
        got = self._follow(True, self.batches)
        want = self._follow(False, self.batches)
        return self.compare(want, got["losses"], got["first_grads"], got["params"])
