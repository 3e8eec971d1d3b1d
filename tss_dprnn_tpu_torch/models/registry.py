"""Model registry: config string -> model class (counterpart of
``tss_dprnn_tpu/models/registry.py``). Takes the short names and the
reference's fully qualified ``src.models.*`` targets, so reference YAML
configs port unchanged.

Every family builds: DPRNN-TasNet, DPRNN-Spe-TasNet with every fusion,
DPRNN-Spe-IRA-TasNet and DPRNN-RawNet-TasNet, with every ``rnn_type``
(LSTM, GRU, RNN), in either lane: ``dtype`` absent or float32, or
bfloat16 (the bf16 lane: fp32 parameters, the dual-path core computing in
bf16, as the JAX models built with ``dtype=jnp.bfloat16``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from tss_dprnn_tpu_torch.models.dprnn import DPRNNTasNet
from tss_dprnn_tpu_torch.models.dprnn_rawnet import DPRNNRawNetTasNet
from tss_dprnn_tpu_torch.models.dprnn_spe import DPRNNSpeTasNet
from tss_dprnn_tpu_torch.models.dprnn_spe_ira import DPRNNSpeIRATasNet

MODEL_REGISTRY = {
    "dprnn_tasnet": DPRNNTasNet,
    "dprnn_spe_tasnet": DPRNNSpeTasNet,
    "dprnn_spe_ira_tasnet": DPRNNSpeIRATasNet,
    "dprnn_rawnet_tasnet": DPRNNRawNetTasNet,
    # reference Hydra targets (config_bss.yaml:15 / config_tss.yaml:17 ...)
    "src.models.dprnn.DPRNNTasNet": DPRNNTasNet,
    "src.models.dprnn_spe.DPRNNSpeTasNet": DPRNNSpeTasNet,
    "src.models.dprnn_spe_ira.DPRNNSpeIRATasNet": DPRNNSpeIRATasNet,
    "src.models.dprnn_rawnet.DPRNNRawNetTasNet": DPRNNRawNetTasNet,
}


def model_dtype(dtype: Any) -> Optional[torch.dtype]:
    """A config's ``dtype`` as the models take it: None (the fp32 lane) for
    None, ``torch.float32`` or a float32 spelling numpy reads ('float32',
    'f4', 'single', ...), ``torch.bfloat16`` for itself or 'bfloat16' (the
    spellings the JAX registry's ``jnp.dtype`` reads as those two). Anything
    else raises ValueError."""
    if dtype is None or dtype is torch.float32:
        return None
    if dtype in (torch.bfloat16, "bfloat16"):
        return torch.bfloat16
    if isinstance(dtype, str):
        try:
            if np.dtype(dtype) == np.float32:
                return None
        except TypeError:
            pass
    raise ValueError(f"model dtype {dtype!r}: the port runs float32 or bfloat16")


def build_model(model_config: Dict[str, Any]):
    """Instantiate a model from a config dict with a ``target`` (or Hydra
    ``_target_``) key; remaining keys are constructor kwargs. ``dtype`` goes
    through :func:`model_dtype`."""
    cfg = dict(model_config)
    target = cfg.pop("target", None) or cfg.pop("_target_", None)
    if target is None:
        raise ValueError("model config needs a 'target' (or '_target_') key")
    if target not in MODEL_REGISTRY:
        raise ValueError(f"unknown model target {target!r}; known: {sorted(MODEL_REGISTRY)}")
    cls = MODEL_REGISTRY[target]
    dtype = model_dtype(cfg.pop("dtype", None))
    return cls(**cfg, dtype=dtype)
