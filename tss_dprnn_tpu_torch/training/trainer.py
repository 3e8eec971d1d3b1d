"""Epoch orchestration (counterpart of ``tss_dprnn_tpu/training/trainer.py``).

As in the reference: best-loss tracking from the sentinel 100500,
``{epoch}_best`` / ``{epoch}_last`` checkpoints with rolling retention, early
stop after ``early_stop`` epochs without improvement, the scheduler stepped
after eval, and step logs every ``print_freq`` steps with the ``-loss``
convention. As in the JAX package: a checkpoint that does not load fails
hard, the resume epoch comes from the checkpoint, and ``save_optimizer``
resumes exactly (Adam state, scheduler, step and run counters, with the
loader's epoch-keyed shuffle).

The loss stays on the device and is read on the host only every
``print_freq`` steps and at the end of an epoch. Training runs with
``model.train()`` (BatchNorm on batch statistics; the LSTM scans through the
residual and backward kernels); eval with ``model.eval()`` and no autograd
(the inference kernel).

Each epoch's loss goes to the ``reporter`` (``reporters.Reporter``) when
there is one, and after each new best checkpoint the ``eval_mixtures`` (the
demo mixtures of ``logs.metadata.ids``) are separated in eval mode and
handed to it, as in the JAX trainers (``trainer.py:451-482``,
``trainer_spe.py:56-69``).

The JAX trainer's knobs (``training/trainer.py:70-97,132-178,258-320``):

- Batches with ``lengths`` (``data.loader.VarLenTrainLoader``): the model
  and the PIT loss read the true lengths, so the inter scans run the masked
  training kernels.
- ``accum_steps`` n: each batch is split into n equal row slices, each
  backward takes its ``loss / n``, and one clip and one optimizer step
  follow; the step's loss is the micro losses' mean and its ``aux`` the
  last micro-batch's. BatchNorm keeps only the last micro-batch's
  statistics, applied to the running statistics from before the step, as
  JAX does (``trainer.py:302``).
- ``lstm_save_every`` q: train steps run under ``ops.rnn.lstm_save_every``,
  every recorded LSTM scan keeping its states every q steps only.
- ``schedule_masks``: fixed-crop steps thread all-ones lengths through the
  model while the scans ignore them (``ops.rnn.lstm_ignore_lengths``); off
  for the run, with the JAX log line, once batches carry lengths.
- ``is_metrics``: each train batch's estimates are scored on the host
  (``ops.metrics.get_metrics`` over ``metrics``) and the epoch's means go
  to the reporter, as in JAX. With ``accum_steps > 1`` it is refused: the
  JAX trainer then scores the whole batch against the last micro-batch's
  estimates and raises IndexError at the first row past them.

``lstm_backend`` is accepted and ignored: the port always runs its kernels.

Data parallelism (JAX ``training/trainer.py:179-187, 330-368``): in a
process group (``parallel``, one process per card) the model is wrapped in
``DistributedDataParallel``, each process trains on its rows of every
global batch (``data.loader.process_rows``), and the step is the global
batch's: DDP averages the gradients (the local losses are means over equal
shares), BatchNorm takes the global statistics, TSS references are padded
to the global batch's longest, the clip sees the averaged gradients, and
under ``accum_steps`` the first n - 1 micro-batches skip DDP's all-reduce
(``no_sync``). Epoch losses are averaged and ``is_metrics``' sums and counts
summed over the processes, so logs, best tracking, the scheduler and early
stop agree on every process. Only process 0 writes checkpoints (the inner
module's ``state_dict``, no ``module.`` prefix), reports and separates the
eval mixtures; a barrier follows each checkpoint. One process takes none of
this: no wrapper, no collective.

Model axis (JAX ``TrainerSpe(model, config, mesh=make_mesh(data, model))``,
``trainer.py:248-255``): given a mesh whose ``model`` axis is 2 or more,
the trainer keeps on each process its slice of every parameter that
``parallel.DEFAULT_TP_RULES`` match (``parallel.ShardedParameters``, made
before the optimizer, so Adam's moments are slices too) and runs no DDP.
Each step gathers the whole weights over the model group once, runs the
forwards and backwards on them (the same kernels as one process), averages
the slices' gradients over the data group and the replicated ones over
every process, clips by the norm of the whole arrays and steps. Everything
the data axis reduces (the loss mean, metric sums, BatchNorm's statistics,
the references' longest) runs over the data group; the loaders are to be
given ``process_index = mesh.data_index`` and ``process_count =
mesh.data``. Process 0 writes checkpoints with the whole tensors under the
model's own names (and, with ``save_optimizer``, whole Adam moments), so a
checkpoint loads into one process or any mesh. A mesh with ``model`` 1 is
the data axis above.

``profile_dir`` (JAX ``trainer.py:323-341``): epoch 1's train loop runs
under ``utils.profiling.trace``, a ``torch.profiler`` Chrome trace per
process in that directory.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from tss_dprnn_tpu_torch import parallel
from tss_dprnn_tpu_torch.device import resolve_device
from tss_dprnn_tpu_torch.models.layers import BatchNorm
from tss_dprnn_tpu_torch.ops import losses
from tss_dprnn_tpu_torch.ops import metrics as metrics_ops
from tss_dprnn_tpu_torch.ops import rnn as rnn_ops
from tss_dprnn_tpu_torch.training.schedulers import ExponentialDecay, ReduceLROnPlateau
from tss_dprnn_tpu_torch.training.train_state import Optimizer
from tss_dprnn_tpu_torch.utils.checkpoint import CheckpointManager, load_model, share_blocks_of
from tss_dprnn_tpu_torch.utils.profiling import trace

BEST_LOSS_SENTINEL = 100500.0  # the reference's starting best loss


class Trainer:
    """The BSS trainer (mode ``bss``): PIT SI-SDR of ``model(mix)`` against
    the batch's ``sources`` on fixed crops. Subclasses override
    ``_forward_loss(batch, train) -> (loss, aux)``, with ``batch`` a dict of
    tensors on the device."""

    # whether a train step leaves a parameter without a gradient, which DDP
    # must then look for after each forward: no for the DPRNN families (the
    # IRA passes share the core, and every parameter reaches the loss)
    unused_parameters = False

    def __init__(self, model: torch.nn.Module, config: Dict[str, Any],
                 device: Optional[Union[str, torch.device]] = None,
                 logger: Optional[logging.Logger] = None, reporter=None,
                 eval_mixtures: Optional[Dict] = None,
                 mesh: Optional[parallel.Mesh] = None):
        self.accum_steps = int(config.get("accum_steps", 1))
        self.lstm_save_every = int(config.get("lstm_save_every", 1))
        self.schedule_masks = bool(config.get("schedule_masks", False))
        self.is_metrics = bool(config.get("is_metrics", False))
        self.metrics = list(config.get("metrics") or ["si_sdr", "pesq", "stoi"])
        self.sample_rate = int((config.get("data") or {}).get("sample_rate", 8000))
        if self.is_metrics and self.accum_steps > 1:
            raise ValueError("is_metrics with accum_steps > 1: the JAX trainer scores the "
                             "batch against the last micro-batch's estimates only and fails")
        self._varlen: Optional[bool] = None  # whether batches carry lengths, from the first
        self._metric_sums: Dict[str, float] = {}
        self._metric_cnt = 0
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.config = config
        self.logger = logger or logging.getLogger(__name__)
        self.reporter = reporter
        self.eval_mixtures = eval_mixtures or {}
        self.cur_epoch = int(config.get("cur_epoch") or 0)
        self.print_freq = int(config.get("print_freq", 5))
        self.rank, self.world = parallel.process_index(), parallel.process_count()
        self.mesh = mesh
        # the model axis: this process's slices, before the optimizer sees them
        self.shards: Optional[parallel.ShardedParameters] = None
        if mesh is not None and mesh.model > 1:
            self.shards = parallel.ShardedParameters(self.model, mesh)
            held, whole = self.shards.sharded_numel
            self.logger.info("model axis: mesh %s, this process holds %d of the %d elements of "
                             "%d sharded parameters", mesh.shape, held, whole,
                             len(self.shards.slots))

        opt_cfg = config.get("optimizer", {})
        self.base_lr = float(opt_cfg.get("lr", 1e-3))
        self.optimizer = Optimizer(self.model.parameters(), self.base_lr,
                                   float(opt_cfg.get("weight_decay", 0.0)),
                                   float(config.get("clip_norm") or 0.0) or None,
                                   self.shards.grad_norm if self.shards is not None else None)
        sched = config.get("lr_scheduler", {}) or {}
        if sched.get("decay_rate") is not None:
            self.lr_scheduler = ExponentialDecay(self.base_lr, float(sched["decay_rate"]))
            self.plateau = False
        else:
            self.lr_scheduler = ReduceLROnPlateau(
                self.base_lr, float(sched.get("factor", 0.5)), int(sched.get("patience", 2)))
            self.plateau = True
        self.logger.info("lr_scheduler is %s.", type(self.lr_scheduler).__name__)

        self.save_optimizer = bool(config.get("save_optimizer", False))
        self.step = 0
        self._run_counters = {"best_loss": BEST_LOSS_SENTINEL, "no_improve_cnt": 0}
        self.ckpt = CheckpointManager(config.get("new_checkpoints_path", "./chkpts"),
                                      int(config.get("n_checkpoints", 1000)))
        checkpoint_path = config.get("checkpoint_path")
        if checkpoint_path:
            self._resume(checkpoint_path)
        else:
            self.logger.info("Starting new training run.")
        self.ddp: Optional[DistributedDataParallel] = None
        if parallel.is_distributed() and self.shards is None:
            self.ddp = DistributedDataParallel(
                self.model, device_ids=[self.device.index] if self.device.type == "cuda" else None,
                broadcast_buffers=False, find_unused_parameters=self.unused_parameters)
            self.logger.info("DistributedDataParallel over %d processes (rank %d, %s)",
                             self.world, self.rank, torch.distributed.get_backend())

    def _net(self, train: bool) -> torch.nn.Module:
        """The module a step calls: the DDP wrapper in a train step of a
        process group, else the model itself."""
        return self.ddp if train and self.ddp is not None else self.model

    def _whole_weights(self):
        """The context the model runs in: under a model axis, with the whole
        weights gathered (``ShardedParameters.full``)."""
        return self.shards.full() if self.shards is not None else contextlib.nullcontext()

    def _resume(self, path: str) -> None:
        self.logger.info("Continue training from checkpoint: %s.", path)
        ckpt = load_model(path, self.model,
                          self.shards.load_state_dict if self.shards is not None else None)
        if not self.config.get("cur_epoch"):
            self.cur_epoch = int(ckpt.get("epoch", 0))
        if self.save_optimizer and "optimizer" in ckpt:
            state = ckpt["optimizer"]
            if self.shards is not None:
                state = self.shards.load_optimizer_state(state)
            self.optimizer.load_state_dict(state)
            self.step = int(ckpt.get("step", 0))
            if ckpt.get("scheduler"):
                self.lr_scheduler.load_state_dict(ckpt["scheduler"])
                self.optimizer.set_learning_rate(self.lr_scheduler.lr)
            self._run_counters.update(ckpt.get("run") or {})
            self.logger.info("Exact resume: optimizer/scheduler state restored.")

    # ---------------------------------------------------------------- steps

    def _lengths_for(self, batch: Dict[str, torch.Tensor]):
        """(model lengths, loss lengths): the batch's true lengths when it
        carries them; else all-ones lengths for the model alone under
        ``schedule_masks`` (fixed crops are full-length), or none."""
        true = batch.get("lengths")
        if true is not None:
            return true, true
        if not self.schedule_masks:
            return None, None
        mix = batch["mix"]
        return torch.full((mix.shape[0],), mix.shape[1], dtype=torch.int32,
                          device=mix.device), None

    def _forward_loss(self, batch: Dict[str, torch.Tensor], train: bool):
        model_lengths, loss_lengths = self._lengths_for(batch)
        out = self._net(train)(batch["mix"], model_lengths)
        if self.is_metrics:
            loss, est = losses.pit_sisdr_loss(out, batch["sources"], return_est=True,
                                              lengths=loss_lengths)
            return loss, {"est": est}
        return losses.pit_sisdr_loss(out, batch["sources"], lengths=loss_lengths), {}

    # the reporter mode of the eval mixtures' estimates
    mixtures_mode = "inference"

    def _estimate_mixture(self, item: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """One demo mixture separated, its sources reordered by PIT."""
        mix = torch.from_numpy(np.asarray(item["mix"], np.float32))[None].to(self.device)
        sources = torch.from_numpy(np.stack([item["s1_target"], item["s2_target"]]).astype(
            np.float32))[None].to(self.device)
        _, est = losses.pit_sisdr_loss(self.model(mix), sources, return_est=True)
        est = est[0].cpu().numpy()
        return {"s1_estimated": est[0], "s2_estimated": est[1]}

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        if self._varlen is None:
            self._varlen = "lengths" in batch
            if self._varlen and self.schedule_masks:
                self.logger.info("schedule_masks disabled: batches carry true lengths "
                                 "(variable-length training needs masked scans)")
        return {k: torch.from_numpy(np.asarray(v)).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _scans(self, train: bool) -> contextlib.ExitStack:
        """The LSTM context of a step: lengths ignored under
        ``schedule_masks`` on fixed crops; train steps also under
        ``lstm_save_every``."""
        stack = contextlib.ExitStack()
        stack.enter_context(rnn_ops.lstm_ignore_lengths(self.schedule_masks
                                                        and not self._varlen))
        if train:
            stack.enter_context(rnn_ops.lstm_save_every(self.lstm_save_every))
        return stack

    def _accumulated(self, batch: Dict[str, torch.Tensor]):
        """``accum_steps`` micro-batches' backwards into one set of
        gradients; (mean loss, last micro-batch's aux). Each micro-batch
        starts from the running statistics of before the step, so BatchNorm
        ends with the last one's update alone."""
        n = self.accum_steps
        B = batch["mix"].shape[0]
        if B % n:
            raise ValueError(f"batch size {B} does not divide by accum_steps {n}")
        m = B // n
        stats = [buf for mod in self.model.modules() if isinstance(mod, BatchNorm)
                 for buf in mod.buffers()]
        before = [buf.clone() for buf in stats]
        total = None
        for k in range(n):
            for buf, old in zip(stats, before):
                buf.copy_(old)
            micro = {key: v[k * m:(k + 1) * m] for key, v in batch.items()}
            # DDP all-reduces the summed gradients after the last micro-batch only
            skip = self.ddp.no_sync() if self.ddp is not None and k < n - 1 \
                else contextlib.nullcontext()
            with skip:
                loss, aux = self._forward_loss(micro, train=True)
                (loss / n).backward()
            total = loss.detach() if total is None else total + loss.detach()
        return total / n, aux

    def train_step(self, batch: Dict[str, np.ndarray]):
        """One optimizer step; returns (loss, aux) on the device."""
        self.model.train()
        batch = self._to_device(batch)
        self.optimizer.zero_grad()
        with self._whole_weights(), self._scans(train=True):
            if self.accum_steps > 1:
                loss, aux = self._accumulated(batch)
            else:
                loss, aux = self._forward_loss(batch, train=True)
                loss.backward()
        if self.shards is not None:
            self.shards.reduce_gradients()
        self.optimizer.step()
        self.step += 1
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        self.model.eval()
        batch = self._to_device(batch)
        with self._whole_weights(), self._scans(train=False):
            return self._forward_loss(batch, train=False)[0]

    # --------------------------------------------------------------- epochs

    def train(self, dataloader) -> float:
        self.logger.info("Set train mode...")
        if hasattr(dataloader, "set_epoch"):
            dataloader.set_epoch(self.cur_epoch)  # the epoch-keyed shuffle
        start = time.time()
        self._metric_sums, self._metric_cnt = {}, 0
        loss_sum = None
        with trace(self.config.get("profile_dir") if self.cur_epoch == 1 else None):
            for step, batch in enumerate(dataloader):
                with torch.profiler.record_function("train_step"):
                    loss, aux = self.train_step(batch)
                loss_sum = loss if loss_sum is None else loss_sum + loss
                if self.is_metrics:
                    self._accumulate_metrics(batch, aux)
                if step % self.print_freq == 0:
                    self._log_step(step, self._global_loss(loss_sum), aux)
        total = self._global_loss(loss_sum)
        if self.is_metrics:
            self._sum_metrics_over_processes()
        return self._log_epoch(total, max(len(dataloader), 1), start, "train")

    def eval(self, dataloader) -> float:
        self.logger.info("Set eval mode...")
        start = time.time()
        loss_sum = None
        for step, batch in enumerate(dataloader):
            loss = self.eval_step(batch)
            loss_sum = loss if loss_sum is None else loss_sum + loss
            if step % self.print_freq == 0:
                self._log_step(step, self._global_loss(loss_sum), {})
        return self._log_epoch(self._global_loss(loss_sum), max(len(dataloader), 1), start,
                               "eval")

    def _global_loss(self, loss_sum: Optional[torch.Tensor]) -> float:
        """A sum of step losses on the host, averaged over the data axis."""
        if loss_sum is None:
            return 0.0
        return float(parallel.mean_over_processes(loss_sum, self.mesh))

    def run(self, train_loader, eval_loader, n_epochs: int, early_stop: int) -> None:
        best_loss = float(self._run_counters["best_loss"])
        no_improve_cnt = int(self._run_counters["no_improve_cnt"])
        while self.cur_epoch < n_epochs:
            self.logger.info("Initiating epoch %d.", self.cur_epoch)
            self.cur_epoch += 1
            self.train(train_loader)
            eval_loss = self.eval(eval_loader)
            lr = self.lr_scheduler.step(eval_loss) if self.plateau else self.lr_scheduler.step()
            self.optimizer.set_learning_rate(lr)
            if eval_loss >= best_loss:
                no_improve_cnt += 1
                self._run_counters = {"best_loss": best_loss, "no_improve_cnt": no_improve_cnt}
                self.logger.info("No improvement, Best Loss: %.4f.", -best_loss)
            else:
                best_loss, no_improve_cnt = eval_loss, 0
                self._run_counters = {"best_loss": best_loss, "no_improve_cnt": no_improve_cnt}
                self._save_checkpoint(best=True)
                self.logger.info("Epoch: %d, Now Best Loss Change: %.4f.", self.cur_epoch,
                                 -best_loss)
                self._mixtures_inference()
            if no_improve_cnt == early_stop:
                self.logger.info("Stop training cause no impr for %d epochs", no_improve_cnt)
                break
        self._save_checkpoint(best=False)
        self.logger.info("Training for %d/%d epoches done!", self.cur_epoch, n_epochs)

    # ----------------------------------------------------------------- logs

    def _log_step(self, step: int, total_loss: float, aux: Dict[str, torch.Tensor]) -> None:
        self.logger.info("<epoch:%d, iter:%d, lr:%.3e, loss:%.3f>.", self.cur_epoch, step,
                         self.optimizer.learning_rate, -total_loss / (step + 1))

    def _accumulate_metrics(self, batch: Dict[str, np.ndarray],
                            aux: Dict[str, torch.Tensor]) -> None:
        """Host metrics of each row's estimate against its target (the
        sources for BSS), summed over the epoch (JAX ``trainer.py:420-438``)."""
        est = aux.get("est")
        if est is None:
            return
        est = est.cpu().numpy()
        target = np.asarray(batch.get("target", batch.get("sources")))
        mix = np.asarray(batch["mix"])
        for b in range(mix.shape[0]):
            md = metrics_ops.get_metrics(mix[b], target[b], est[b], self.sample_rate,
                                         self.metrics)
            for k in self.metrics:
                if md.get(k) is not None and np.isfinite(md[k]):
                    self._metric_sums[k] = self._metric_sums.get(k, 0.0) + md[k]
            self._metric_cnt += 1

    def _sum_metrics_over_processes(self) -> None:
        """The epoch's metric sums and row count over the data axis's rows."""
        if parallel.data_count(self.mesh) == 1:
            return
        flat = [v for k in self.metrics for v in (self._metric_sums.get(k, 0.0),
                                                   float(k in self._metric_sums))]
        *flat, count = parallel.sum_numbers_over_processes(flat + [self._metric_cnt], self.mesh)
        self._metric_sums = {k: flat[2 * i] for i, k in enumerate(self.metrics)
                             if flat[2 * i + 1] > 0}
        self._metric_cnt = int(count)

    def _log_epoch(self, total_loss: float, num_steps: int, start: float, mode: str) -> float:
        total_loss /= num_steps
        # as in JAX, an eval epoch reports the metrics of the train epoch before it
        metric_dict = None
        if self.is_metrics and self._metric_cnt > 0:
            metric_dict = {k: v / self._metric_cnt for k, v in self._metric_sums.items()}
        if self.reporter is not None and self.rank == 0:
            self.reporter.add_and_report(
                logs={"step": self.cur_epoch, "loss": -total_loss, "metrics": metric_dict},
                mode=mode)
        self.logger.info("Finished *** <epoch:%d, iter:%d, loss:%.3f, Total time:%.3f min>.",
                         self.cur_epoch, num_steps, -total_loss, (time.time() - start) / 60)
        return total_loss

    @torch.no_grad()
    def _mixtures_inference(self) -> None:
        """The eval mixtures through the model in eval mode, their estimates
        stored on each mixture and the lot handed to the reporter; process 0
        only (under a model axis every process joins the weights' gather)."""
        if not self.eval_mixtures or (self.rank != 0 and self.shards is None):
            return
        self.model.eval()
        with self._whole_weights():
            if self.rank != 0:
                return
            for item in self.eval_mixtures.values():
                item.update(self._estimate_mixture(item))
        if self.reporter is not None:
            self.reporter.add_and_report(
                logs={"step": self.cur_epoch, "mixtures": self.eval_mixtures},
                mode=self.mixtures_mode)

    # ---------------------------------------------------------- checkpoints

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state_dict with whole tensors (under a model axis a
        collective: every process calls it)."""
        if self.shards is not None:
            return self.shards.state_dict()
        return self.model.state_dict()

    def _save_checkpoint(self, best: bool = False) -> Optional[str]:
        """Process 0 writes the checkpoint and returns its path; every
        process waits for it (and under a model axis first joins the gather
        of the whole tensors)."""
        path = None
        model_state, optimizer_state = self.full_state_dict(), None
        if self.save_optimizer:
            optimizer_state = self.optimizer.state_dict()
            if self.shards is not None:
                optimizer_state = self.shards.optimizer_state(optimizer_state)
        if self.rank == 0:
            payload = {"epoch": self.cur_epoch, "model": model_state}
            if share_blocks_of(self.model) is not None:
                payload["share_blocks"] = share_blocks_of(self.model)
            if self.save_optimizer:
                payload.update(optimizer=optimizer_state, step=self.step,
                               scheduler=self.lr_scheduler.state_dict(),
                               run=dict(self._run_counters))
            path = self.ckpt.save(self.cur_epoch, payload, best=best)
            self.logger.info("Saved checkpoint: %s", path)
        parallel.barrier()
        return path
