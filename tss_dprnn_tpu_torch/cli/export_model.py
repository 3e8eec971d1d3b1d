"""Export a trained model to a serving artifact (counterpart of
``tss_dprnn_tpu/cli/export_model.py``; ``torch.export`` in place of
``jax.export``).

    python -m tss_dprnn_tpu_torch.cli.export_model --config test.yaml --mode tss_spe \
        --out dprnn_spe.tssx --batch 8 --secs 10 --secs 20 --backend pallas --dtype bf16

The artifact bakes the checkpoint weights in, one exported bucket per
``--secs`` value (each also at batch 1 for low-latency single requests), and
is driven without the model code:

    from tss_dprnn_tpu_torch.inference.export import load_artifact
    sep = load_artifact("dprnn_spe.tssx")
    wav = sep.call(mix, aux, aux_len)     # [b, n_src, t]

``--backend pallas`` (the default) records the serving scans as the port's
operators, so a card artifact runs the hand-written kernels and loading it
needs the port importable; ``--backend xla`` decomposes them into their plain
versions' PyTorch ops (hermetic), for ``--device cpu`` only. The artifact is
exported on, and by default runs on, the card unless ``--device`` (or the
JAX CLI's spelling, ``--platform``) names another device. The checkpoint is
a port or reference ``.pt`` file (the JAX package's orbax directories
raise); a config's ``lstm_backend`` is logged and ignored.
"""

from __future__ import annotations

import argparse

from tss_dprnn_tpu_torch.cli.common import MODES, get_logger
from tss_dprnn_tpu_torch.models.registry import build_model
from tss_dprnn_tpu_torch.utils.config import load_config, model_config

def main(argv=None):
    parser = argparse.ArgumentParser(description="tss_dprnn_tpu_torch serving export")
    parser.add_argument("--config", required=True)
    parser.add_argument("--mode", default="tss_spe", choices=MODES)
    parser.add_argument("--set", action="extend", nargs="*", default=[])
    parser.add_argument("--out", required=True, help="output artifact path (.tssx)")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--secs", type=float, action="append",
                        help="bucket length(s) in seconds (repeatable; default 10)")
    parser.add_argument("--backend", default="pallas", choices=("pallas", "xla"),
                        help="pallas = the port's kernels as operators (loading needs the "
                             "port); xla = plain PyTorch ops, hermetic, --device cpu only")
    parser.add_argument("--dtype", default="bf16", choices=("bf16", "fp32"))
    parser.add_argument("--device", "--platform", dest="device", default=None,
                        help="torch device to export for and run on, e.g. cpu (default: the "
                             "current CUDA card); --platform is the JAX CLI's spelling")
    args = parser.parse_args(argv)

    from tss_dprnn_tpu_torch.device import resolve_device
    from tss_dprnn_tpu_torch.inference.export import (
        _aux_rate_factor,
        _spe_like,
        export_separation,
        save_artifact,
    )
    from tss_dprnn_tpu_torch.utils.checkpoint import load_model

    logger = get_logger("export")
    config = load_config(args.config, args.set)
    if config.get("lstm_backend") is not None:
        logger.info("lstm_backend %r ignored: --backend picks the artifact's scans",
                    config["lstm_backend"])
    device = resolve_device(args.device)

    mc = model_config(config)
    if args.dtype == "bf16":
        # params stay fp32; the dual-path core computes in bf16 (the bf16 lane)
        mc["dtype"] = "bfloat16"
    model = build_model(mc)

    sr = int(config.get("data", {}).get("sample_rate", 8000))
    secs = args.secs or [10.0]
    checkpoint_path = config.get("checkpoint_path")
    if checkpoint_path is None:
        raise ValueError("checkpoint_path is required for export")
    load_model(checkpoint_path, model)

    buckets = []
    shapes = sorted({(b, int(s * sr)) for s in secs for b in {1, args.batch}})
    for B, T in shapes:
        logger.info("Exporting bucket batch=%d samples=%d (%s, %s)...",
                    B, T, args.backend, args.dtype)
        buckets.append(export_separation(model, B, T, backend=args.backend, device=device))
    meta = {
        "mode": args.mode,
        "spe": _spe_like(model),
        "aux_factor": _aux_rate_factor(model),
        "sample_rate": sr,
        "backend": args.backend,
        "dtype": args.dtype,
        "model": mc,
        "checkpoint": str(checkpoint_path),
        "device": device.type,
    }
    save_artifact(args.out, buckets, meta)
    logger.info("Wrote %s (%d buckets, platforms=%s).", args.out, len(buckets), (device.type,))


if __name__ == "__main__":
    main()
