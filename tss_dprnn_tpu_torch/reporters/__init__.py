"""The run reporter: local log lines, no wandb."""

from tss_dprnn_tpu_torch.reporters.reporter import Reporter  # noqa: F401
