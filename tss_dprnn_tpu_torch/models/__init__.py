"""Models of the port (so far the DPRNN-Spe-TasNet serving path)."""

from tss_dprnn_tpu_torch.models.dprnn_spe import DPRNNSpeTasNet  # noqa: F401
