"""Shared CLI plumbing (counterpart of ``tss_dprnn_tpu/cli/common.py``): mode
dispatch, datasets from the config, the eval mixtures, and the log handler."""

from __future__ import annotations

import logging
import sys
import functools
from typing import Any, Dict

from tss_dprnn_tpu_torch.data.librimix import Librimix, LibrimixSpe
from tss_dprnn_tpu_torch.data.loader import collate_bss, collate_spe

MODES = ("bss", "tss_spe", "tss_rawnet")


class _StdoutHandler(logging.StreamHandler):
    """Writes to whatever ``sys.stdout`` is when a record is emitted."""

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, _value):
        pass


def get_logger(name: str, level: int = logging.INFO) -> logging.Logger:
    """The CLI's logger, writing to stdout; the port's own module loggers
    (``tss_dprnn_tpu_torch.*``) write through the same handler."""
    root = logging.getLogger("tss_dprnn_tpu_torch")
    if not root.handlers:
        handler = _StdoutHandler()
        handler.setFormatter(
            logging.Formatter("[%(asctime)s] %(name)s %(levelname)s: %(message)s", "%H:%M:%S"))
        root.addHandler(handler)
    root.setLevel(level)
    return logging.getLogger(f"tss_dprnn_tpu_torch.cli.{name}")


def dataset_for(config: Dict[str, Any], split: str, spe: bool):
    """split: 'train' | 'eval' | 'test'. A frozen manifest when
    ``data.use_generated_<split>`` is set (a JSON manifest, or the
    reference's pickled Dataset when the name ends in ``.pkl``), else built
    from the ``data.<split>_path`` CSV (full length for 'test')."""
    data = config["data"]
    cls = LibrimixSpe if spe else Librimix
    cache_wav = bool(data.get("cache_wav", False))
    manifest_path = data.get(f"use_generated_{split}")
    if manifest_path:
        if str(manifest_path).endswith(".pkl"):
            from tss_dprnn_tpu_torch.data.reference_compat import load_reference_pickle

            manifest = load_reference_pickle(manifest_path, path_prefix=data.get("path_prefix"))
            return cls(manifest=manifest, cache_wav=cache_wav)
        return cls(manifest_path=manifest_path, cache_wav=cache_wav)
    csv_path = data.get(f"{split}_path")
    if not csv_path:
        raise ValueError(f"config.data needs use_generated_{split} or {split}_path")
    return cls(
        csv_path=csv_path,
        sample_rate=data.get("sample_rate", 8000),
        n_src=data.get("n_src", 2),
        nrows=data.get(f"nrows_{split}"),
        segment=data.get("segment") if split != "test" else None,
        seed=data.get("seed", 0),
        cache_wav=cache_wav,
    )


def train_components(mode: str):
    """(spe?, collate_fn, TrainerClass) for a mode."""
    from tss_dprnn_tpu_torch.training import Trainer, TrainerRawNet, TrainerSpe

    if mode == "bss":
        return False, collate_bss, Trainer
    if mode == "tss_spe":
        return True, collate_spe, TrainerSpe
    if mode == "tss_rawnet":
        return True, functools.partial(collate_spe, resample_ref_to=16000), TrainerRawNet
    raise ValueError(f"Invalid mode: {mode} (choose from {MODES})")


def inference_components(mode: str):
    """(spe?, InferencerClass) for a mode."""
    from tss_dprnn_tpu_torch.inference import Inferencer, InferencerRawNet, InferencerSpe

    if mode == "bss":
        return False, Inferencer
    if mode == "tss_spe":
        return True, InferencerSpe
    if mode == "tss_rawnet":
        return True, InferencerRawNet
    raise ValueError(f"Invalid mode: {mode} (choose from {MODES})")


def eval_mixtures_from(config, eval_set, spe: bool, logger=None):
    """The demo mixtures of ``logs.metadata.ids`` (reference train.py:51-75)."""
    logger = logger or get_logger("common")
    ids = ((config.get("logs") or {}).get("metadata") or {}).get("ids") or []
    mixtures = {}
    for id_ in ids:
        if id_ >= len(eval_set):
            logger.info("Mixture id is out of bound (len of eval_set is %d)!", len(eval_set))
            raise ValueError(f"eval mixture id {id_} out of bounds")
        if spe:
            mix, target, reference, _ = eval_set[id_]
            mixtures[id_] = {"mix": mix, "target": target, "reference": reference}
        else:
            mix, sources = eval_set[id_]
            mixtures[id_] = {"mix": mix, "s1_target": sources[0], "s2_target": sources[1]}
    return mixtures
