"""Models of the port: DPRNN-TasNet (BSS) and DPRNN-Spe-TasNet ('att' fusion)."""

from tss_dprnn_tpu_torch.models.dprnn import DPRNNTasNet  # noqa: F401
from tss_dprnn_tpu_torch.models.dprnn_spe import DPRNNSpeTasNet  # noqa: F401
