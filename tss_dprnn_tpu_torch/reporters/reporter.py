"""The run reporter, log only (counterpart of
``tss_dprnn_tpu/reporters/reporter.py``).

The same modes as the JAX class ('train', 'eval', 'test', 'test_final',
'inference', 'inference_spe', 'inference_no_ref') and the same local log
lines that it writes when wandb is off. The port never imports wandb, so a
config's ``logs.wandb_credentials`` are read and reported as unusable once,
as the JAX class does when the package is missing, and every record goes to
the log. Nothing here reads audio: a 'test' row needs only its id and
metrics, and an inference pass only the number of its mixtures.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

MODES = ("train", "eval", "test", "test_final", "inference", "inference_spe",
         "inference_no_ref")


class Reporter:
    def __init__(self, config: Dict[str, Any], logger: Optional[logging.Logger] = None):
        self.logger = logger or logging.getLogger(__name__)
        self.sample_rate = int((config.get("data") or {}).get("sample_rate", 8000))
        self.is_test = bool(config.get("is_test", False))
        # the JAX class's line when wandb is missing, with or without a key
        self.logger.info("Reporter: wandb disabled (no credentials, package unavailable) "
                         "— logging locally.")
        self.wandb = None
        self.mode = "train"

    def add_and_report(self, logs: Optional[Dict[str, Any]] = None, mode: str = "train") -> None:
        if mode not in MODES:
            raise ValueError(f"unknown reporter mode {mode!r}")
        self.mode = mode
        if mode in ("train", "eval"):
            self.logger.info("[%s] step=%s loss=%.4f metrics=%s", mode, logs["step"],
                             logs["loss"], logs.get("metrics"))
        elif mode == "test":
            self.logger.info("[test] id=%s si_sdr=%s stoi=%s pesq=%s", logs["id"],
                             logs["si_sdr"], logs["stoi"], logs["pesq"])
        elif mode == "test_final":
            self.logger.info("ADDING FINAL RESULTS!")
        else:
            self.logger.info("[%s] %d demo mixtures at step %s", mode, len(logs["mixtures"]),
                             logs["step"])

    def wandb_finish(self) -> None:
        """Nothing to flush: every record went to the log."""
