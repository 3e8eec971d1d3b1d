"""Inference of the port: masked, bucketed evaluation on the card."""

from tss_dprnn_tpu_torch.inference.inferencer import Inferencer  # noqa: F401
from tss_dprnn_tpu_torch.inference.inferencer_rawnet import InferencerRawNet  # noqa: F401
from tss_dprnn_tpu_torch.inference.inferencer_spe import InferencerSpe  # noqa: F401
