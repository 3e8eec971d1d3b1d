"""Full-test-set evaluation entry point (counterpart of
``tss_dprnn_tpu/cli/test.py``).

    python -m tss_dprnn_tpu_torch.cli.test --config configs/test_tss.yaml \
        --mode tss_spe [--set checkpoint_path=model.pt ...] [--device cpu]

Runs on the card unless ``--device`` names another device. The checkpoint is
a port or reference ``.pt`` file; the JAX package's orbax directories raise.
Results go to ``all_metrics.csv`` and ``final_metrics.json`` in
``test_savedir``, and each row to the log through the log-only
``reporters.Reporter``. SI-SDR runs on the device; STOI and PESQ run on the
host unless ``--device-metrics`` (STOI on the device) or ``--device-pesq``
(STOI and PESQ on the device, so no estimate leaves it) moves them there.
The batch size defaults to 16 on that device lane and to 8 otherwise, as in
the JAX CLI, and the choice is logged. A config's ``lstm_backend`` is
accepted (the port has one backend). ``model.dtype: bfloat16`` (or ``--set
model.dtype=bfloat16``) serves the bf16 lane from the same checkpoint,
batch-major where the JAX Inferencer turns the time-major layout on for it.

Data-parallel eval: start one process per card and pass the world size,

    python -m torch.distributed.run --standalone --nproc_per_node W \
        -m tss_dprnn_tpu_torch.cli.test --config ... --data-parallel W

(``--data-parallel 0`` means the world size; another number raises). The
process group comes from torchrun's environment or the config's
``jax.distributed`` keys (``utils/config.distributed_args``). Each process
runs whole batches, ``plan[i::W]``, and writes its rows to
``test_savedir/proc<i>/``; process 0 then writes the merged
``all_metrics.csv`` and ``final_metrics.json`` into ``test_savedir``, as
one process would. ``--batch-size`` must divide by W, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import logging

from tss_dprnn_tpu_torch import parallel
from tss_dprnn_tpu_torch.cli.common import (MODES, dataset_for, get_logger,
                                            inference_components)
from tss_dprnn_tpu_torch.device import resolve_device
from tss_dprnn_tpu_torch.models.registry import build_model
from tss_dprnn_tpu_torch.reporters import Reporter
from tss_dprnn_tpu_torch.utils.config import distributed_args, load_config, model_config


def main(argv=None):
    parser = argparse.ArgumentParser(description="tss_dprnn_tpu_torch evaluation")
    parser.add_argument("--config", required=True)
    parser.add_argument("--mode", default="bss", choices=MODES)
    parser.add_argument("--set", action="extend", nargs="*", default=[])
    parser.add_argument("--batch-size", type=int, default=None,
                        help="eval batch size (default 8; 16 with --device-metrics or "
                             "--device-pesq, as in the JAX package)")
    parser.add_argument("--n-buckets", type=int, default=8)
    parser.add_argument("--data-parallel", type=int, default=1, metavar="N",
                        help="the processes sharing the eval, one per card: the world size of "
                             "the process group (0 = the world size; default 1)")
    parser.add_argument("--device-metrics", action="store_true",
                        help="STOI on the device too (SI-SDR and the PIT reorder always run "
                             "there); PESQ stays on the host")
    parser.add_argument("--device-pesq", action="store_true",
                        help="STOI and PESQ on the device (implies --device-metrics): the "
                             "separated audio never crosses to the host")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current CUDA card; 'cpu' runs the "
                             "kernels' plain versions)")
    args = parser.parse_args(argv)

    config = load_config(args.config, args.set)
    joined = parallel.join_group(distributed_args(config), args.device)
    try:
        return _run(parser, args, config)
    finally:
        if joined:
            parallel.leave_group()


def _run(parser, args, config):
    rank, world = parallel.process_index(), parallel.process_count()
    logger = get_logger("test", logging.INFO if rank == 0 else logging.WARNING)
    n_dp = world if args.data_parallel == 0 else args.data_parallel
    if n_dp != world:
        raise ValueError(f"--data-parallel {args.data_parallel} but the process group has "
                         f"world size {world}: start one process per card with "
                         "torch.distributed.run and pass its world size (or 0)")
    config.setdefault("is_test", True)
    if args.device_metrics:
        config["device_metrics"] = True
    if args.device_pesq:
        config["device_pesq"] = True
    if args.batch_size is None:
        device_lane = config.get("device_metrics") or config.get("device_pesq")
        args.batch_size = 16 if device_lane else 8
        logger.info("batch size %d: the default %s", args.batch_size,
                    "of the device metric lane (device_metrics or device_pesq)" if device_lane
                    else "without the device metric lane")
    else:
        logger.info("batch size %d: from --batch-size", args.batch_size)
    if n_dp > 1:
        if args.batch_size % n_dp:
            parser.error(f"--batch-size {args.batch_size} must be divisible "
                         f"by the data-parallel degree {n_dp}")
        logger.info("Data-parallel eval over %d processes: whole batches each, rows in "
                    "proc<i>/ and merged by process 0.", n_dp)
    if config.get("lstm_backend") is not None:
        logger.info("lstm_backend %r ignored: the port runs its own kernels",
                    config["lstm_backend"])
    spe, InferencerClass = inference_components(args.mode)
    device = resolve_device(args.device)

    logger.info("Initializing test set....")
    test_set = dataset_for(config, "test", spe)
    logger.info("test set len: %d", len(test_set))

    reporter = Reporter(config, logger)
    model = build_model(model_config(config))
    inferencer = InferencerClass(model, config, device=device, reporter=reporter)
    final = inferencer.run(test_set, batch_size=args.batch_size, n_buckets=args.n_buckets)
    logger.info("FINAL: %s", final)
    reporter.wandb_finish()
    return final


if __name__ == "__main__":
    main()
