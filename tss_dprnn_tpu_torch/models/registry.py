"""Model registry: config string -> model class (counterpart of
``tss_dprnn_tpu/models/registry.py``). Takes the short names and the
reference's fully qualified ``src.models.*`` targets, so reference YAML
configs port unchanged.

Every fusion of DPRNN-Spe-TasNet and every ``rnn_type`` (LSTM, GRU, RNN)
builds. The families and options the port does not have yet (IRA, RawNet,
``dtype: bfloat16``) raise ``NotImplementedError`` naming the ROADMAP item
that ports them.
"""

from __future__ import annotations

from typing import Any, Dict

from tss_dprnn_tpu_torch.models.dprnn import DPRNNTasNet
from tss_dprnn_tpu_torch.models.dprnn_spe import DPRNNSpeTasNet

# a family not ported yet maps to the ROADMAP item that ports it
_IRA = "ROADMAP §1 item 7 (models/dprnn_spe_ira.py)"
_RAWNET = "ROADMAP §1 item 8 (the RawNet family)"

MODEL_REGISTRY = {
    "dprnn_tasnet": DPRNNTasNet,
    "dprnn_spe_tasnet": DPRNNSpeTasNet,
    "dprnn_spe_ira_tasnet": _IRA,
    "dprnn_rawnet_tasnet": _RAWNET,
    # reference Hydra targets (config_bss.yaml:15 / config_tss.yaml:17 ...)
    "src.models.dprnn.DPRNNTasNet": DPRNNTasNet,
    "src.models.dprnn_spe.DPRNNSpeTasNet": DPRNNSpeTasNet,
    "src.models.dprnn_spe_ira.DPRNNSpeIRATasNet": _IRA,
    "src.models.dprnn_rawnet.DPRNNRawNetTasNet": _RAWNET,
}


def build_model(model_config: Dict[str, Any]):
    """Instantiate a model from a config dict with a ``target`` (or Hydra
    ``_target_``) key; remaining keys are constructor kwargs. ``dtype`` may
    be absent or ``float32``; ``bfloat16`` raises until the bf16 lane."""
    cfg = dict(model_config)
    target = cfg.pop("target", None) or cfg.pop("_target_", None)
    if target is None:
        raise ValueError("model config needs a 'target' (or '_target_') key")
    if target not in MODEL_REGISTRY:
        raise ValueError(f"unknown model target {target!r}; known: {sorted(MODEL_REGISTRY)}")
    cls = MODEL_REGISTRY[target]
    if isinstance(cls, str):
        raise NotImplementedError(f"model {target!r} is not ported yet: {cls}")
    dtype = cfg.pop("dtype", None)
    if dtype not in (None, "float32"):
        raise NotImplementedError(f"model dtype {dtype!r}: the port runs float32 until the "
                                  "bf16 lane, ROADMAP §1 item 10")
    return cls(**cfg)
