"""Model registry: config string -> model class (counterpart of
``tss_dprnn_tpu/models/registry.py``). Takes the short names and the
reference's fully qualified ``src.models.*`` targets, so reference YAML
configs port unchanged.

Every family builds: DPRNN-TasNet, DPRNN-Spe-TasNet with every fusion,
DPRNN-Spe-IRA-TasNet and DPRNN-RawNet-TasNet, with every ``rnn_type``
(LSTM, GRU, RNN). ``dtype: bfloat16`` raises ``NotImplementedError``
naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Any, Dict

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
    dtype = cfg.pop("dtype", None)
    if dtype not in (None, "float32"):
        raise NotImplementedError(f"model dtype {dtype!r}: the port runs float32 until the "
                                  "bf16 lane, ROADMAP §1 item 10")
    return cls(**cfg)
