"""Training: the TSS trainer, its optimizer and schedulers."""

from tss_dprnn_tpu_torch.training.trainer import Trainer
from tss_dprnn_tpu_torch.training.trainer_spe import TrainerSpe

__all__ = ["Trainer", "TrainerSpe"]
