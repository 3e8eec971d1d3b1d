"""Device selection for the port's entry points.

The port runs on the card. The CPU is used only when a caller asks for it by
name (the CPU tests do), never as a silent fallback: a CPU run is a run of
the kernels' plain versions and says nothing about the card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> the current CUDA device, or raise when there is none.

    ``"cpu"`` (or any explicit device) is honoured as given. On a CUDA
    device the fp32 lane is pinned to full fp32: cuDNN would otherwise run
    float32 convolutions in TF32, which keeps about three decimal digits.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
