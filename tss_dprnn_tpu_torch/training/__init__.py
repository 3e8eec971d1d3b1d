"""Training: the BSS, TSS and RawNet trainers, their optimizer and schedulers."""

from tss_dprnn_tpu_torch.training.trainer import Trainer
from tss_dprnn_tpu_torch.training.trainer_rawnet import TrainerRawNet
from tss_dprnn_tpu_torch.training.trainer_spe import TrainerSpe

__all__ = ["Trainer", "TrainerRawNet", "TrainerSpe"]
