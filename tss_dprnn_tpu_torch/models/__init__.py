"""Models of the port: DPRNN-TasNet (BSS), DPRNN-Spe-TasNet (five fusions),
DPRNN-Spe-IRA-TasNet and DPRNN-RawNet-TasNet."""

from tss_dprnn_tpu_torch.models.dprnn import DPRNNTasNet  # noqa: F401
from tss_dprnn_tpu_torch.models.dprnn_rawnet import DPRNNRawNetTasNet  # noqa: F401
from tss_dprnn_tpu_torch.models.dprnn_spe import DPRNNSpeTasNet  # noqa: F401
from tss_dprnn_tpu_torch.models.dprnn_spe_ira import DPRNNSpeIRATasNet  # noqa: F401
