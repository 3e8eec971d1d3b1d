"""Manifest generator (counterpart of ``tss_dprnn_tpu/cli/generate_manifests.py``):
freezes crops and reference picks into JSON manifests.

    python -m tss_dprnn_tpu_torch.cli.generate_manifests --config configs/generate_manifests.yaml

Config keys: dataset_type ('librimix'|'librimix_spe'), sample_rate, n_src,
segment, seed, and per split {train,eval,test}_path CSVs, nrows_<split> and
<split>_out output paths. The test split keeps full lengths.
"""

from __future__ import annotations

import argparse

from tss_dprnn_tpu_torch.cli.common import get_logger
from tss_dprnn_tpu_torch.data.manifest import build_manifest, save_manifest
from tss_dprnn_tpu_torch.utils.config import load_config


def main(argv=None):
    parser = argparse.ArgumentParser(description="freeze dataset manifests")
    parser.add_argument("--config", required=True)
    parser.add_argument("--set", action="extend", nargs="*", default=[])
    args = parser.parse_args(argv)
    logger = get_logger("generate_manifests")
    config = load_config(args.config, args.set)

    spe = config.get("dataset_type", "librimix") == "librimix_spe"
    sample_rate = config.get("sample_rate", 8000)
    n_src = config.get("n_src", 2)
    seed = config.get("seed", 0)
    for split in ("train", "eval", "test"):
        csv_path = config.get(f"{split}_path")
        out_path = config.get(f"{split}_out")
        if not csv_path or not out_path:
            continue
        segment = None if split == "test" else config.get("segment", 3)
        m = build_manifest(csv_path, sample_rate, n_src, segment,
                           nrows=config.get(f"nrows_{split}"), spe=spe, seed=seed)
        save_manifest(m, out_path)
        logger.info("%s: %d entries -> %s (dropped %d short)",
                    split, len(m["entries"]), out_path, m["dropped_short"])


if __name__ == "__main__":
    main()
