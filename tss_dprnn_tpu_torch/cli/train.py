"""Training entry point (counterpart of ``tss_dprnn_tpu/cli/train.py``).

    python -m tss_dprnn_tpu_torch.cli.train --config configs/train_tss.yaml \
        --mode tss_spe [--set data.batch_size=8 optimizer.lr=5e-4 ...] [--device cpu]

Fixed crops through ``TrainLoader``, or with ``data.variable_length`` whole
utterances through ``VarLenTrainLoader`` (manifests frozen with ``segment:
null``; ``data.n_buckets`` length buckets, default 4, rows capped at
``data.max_segment`` seconds; TSS references padded to one length for the
run, the largest rounded up to 2000 samples, at 16 kHz for ``tss_rawnet``),
then ``Trainer`` / ``TrainerSpe`` / ``TrainerRawNet.run``, on the card
unless ``--device`` names another device. The model's weights are drawn
from the config's ``seed``. Epoch losses and the separated demo mixtures of
``logs.metadata.ids`` (indices into the eval set, which must hold them) go
to the log-only ``reporters.Reporter``, as the JAX CLI logs them without
wandb. Every trainer knob of the JAX package runs (``training/trainer.py``)
but ``is_metrics`` with ``accum_steps > 1``, which fails in JAX. ``--set
model.dtype=bfloat16`` trains the bf16 lane (fp32 parameters and
checkpoints), ``lstm_save_every`` > 1 included.

Data-parallel training, one process per card:

    python -m torch.distributed.run --standalone --nproc_per_node W \
        -m tss_dprnn_tpu_torch.cli.train --config ... --mode tss_spe

The process group comes from torchrun's environment or the config's
``jax.distributed`` keys (``utils/config.distributed_args``); NCCL on the
card, gloo with ``--device cpu``. ``data.batch_size`` stays the global
batch: each process loads its rows of it (with ``accum_steps`` n it must
divide by n W), and the trainer runs under ``DistributedDataParallel``.
Process 0 logs, reports and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import logging

import torch

from tss_dprnn_tpu_torch import parallel
from tss_dprnn_tpu_torch.cli.common import (MODES, dataset_for, eval_mixtures_from, get_logger,
                                            train_components)
from tss_dprnn_tpu_torch.data.loader import (TrainLoader, VarLenTrainLoader, collate_bss_eval,
                                             make_collate_spe_eval)
from tss_dprnn_tpu_torch.device import resolve_device
from tss_dprnn_tpu_torch.models.registry import build_model
from tss_dprnn_tpu_torch.reporters import Reporter
from tss_dprnn_tpu_torch.utils.config import distributed_args, load_config, model_config
from tss_dprnn_tpu_torch.utils.weights import init_weights_


def main(argv=None):
    parser = argparse.ArgumentParser(description="tss_dprnn_tpu_torch training")
    parser.add_argument("--config", required=True)
    parser.add_argument("--mode", default="bss", choices=MODES)
    parser.add_argument("--set", action="extend", nargs="*", default=[],
                        help="dotted config overrides (repeatable)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current CUDA card; 'cpu' runs the "
                             "kernels' plain versions)")
    args = parser.parse_args(argv)

    config = load_config(args.config, args.set)
    joined = parallel.join_group(distributed_args(config), args.device)
    try:
        _run(args, config)
    finally:
        if joined:
            parallel.leave_group()


def _run(args, config):
    rank, world = parallel.process_index(), parallel.process_count()
    logger = get_logger("train", logging.INFO if rank == 0 else logging.WARNING)
    spe, collate_fn, TrainerClass = train_components(args.mode)
    data_cfg = config["data"]
    device = resolve_device(args.device)

    logger.info("RUN %s", config.get("name"))
    logger.info("world size %d%s", world, ": DistributedDataParallel, process 0 logs"
                if parallel.is_distributed() else ": one process")
    logger.info("Initializing Datasets and Dataloaders....")
    train_set = dataset_for(config, "train", spe)
    eval_set = dataset_for(config, "eval", spe)
    batch_size, seed = data_cfg.get("batch_size", 5), data_cfg.get("seed", 0)
    # each process's rows of every global batch
    shares = dict(process_index=rank, process_count=world,
                  accum_steps=int(config.get("accum_steps", 1)))
    if data_cfg.get("variable_length"):
        sr = data_cfg.get("sample_rate", 8000)
        if spe:
            # one reference length for the run (JAX: one compiled program per bucket)
            rmax = max(max(train_set.ref_lengths()), max(eval_set.ref_lengths()))
            resample_to = 16000 if args.mode == "tss_rawnet" else None
            if resample_to:
                rmax = -(-(rmax * resample_to) // sr)
            vcollate = make_collate_spe_eval(resample_ref_to=resample_to, sample_rate=sr,
                                             ref_pad_to=int(-(-rmax // 2000) * 2000))
        else:
            vcollate = collate_bss_eval
        max_seg = data_cfg.get("max_segment")
        vl_kw = dict(batch_size=batch_size, collate_fn=vcollate, seed=seed,
                     n_buckets=int(data_cfg.get("n_buckets", 4)),
                     max_len=int(max_seg * sr) if max_seg else None, **shares)
        train_loader = VarLenTrainLoader(train_set, lengths=train_set.lengths(), shuffle=True,
                                         **vl_kw)
        eval_loader = VarLenTrainLoader(eval_set, lengths=eval_set.lengths(), shuffle=False,
                                        **dict(vl_kw, accum_steps=1))
    else:
        train_loader = TrainLoader(train_set, batch_size, collate_fn, shuffle=True,
                                   drop_last=True, seed=seed, **shares)
        eval_loader = TrainLoader(eval_set, batch_size, collate_fn, shuffle=False,
                                  drop_last=True, seed=seed, **dict(shares, accum_steps=1))
    logger.info("train dataloader len: %d", len(train_loader))
    logger.info("eval dataloader len: %d", len(eval_loader))
    eval_mixtures = eval_mixtures_from(config, eval_set, spe, logger)
    reporter = Reporter(config, logger) if spe or (config.get("logs") or {}) else None

    logger.info("Initializing model....")
    model = init_weights_(build_model(model_config(config)),
                          torch.Generator().manual_seed(int(config.get("seed", 0))))

    logger.info("Initializing trainer....")
    trainer = TrainerClass(model, config, device=device, logger=logger, reporter=reporter,
                           eval_mixtures=eval_mixtures)
    logger.info("Initiating trainer run...")
    trainer.run(train_loader, eval_loader, config.get("epochs", 10), config.get("early_stop", 10))
    logger.info("trainer run COMPLETED")
    if reporter:
        reporter.wandb_finish()


if __name__ == "__main__":
    main()
