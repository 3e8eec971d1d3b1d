"""Device selection for the port's entry points.

The port runs on the card. The CPU is used only when a caller asks for it by
name (the CPU tests do), never as a silent fallback: a CPU run is a run of
the kernels' plain versions and says nothing about the card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from tss_dprnn_tpu_torch.parallel.mesh import is_distributed, local_rank


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> the current CUDA device, or raise when there is none;
    in a process group (``parallel``), the card of this process's
    ``LOCAL_RANK``, or raise when the host has no such card (ranks never
    wrap round onto a card another rank holds).

    ``"cpu"`` (or any explicit device) is honoured as given, so that two
    processes may share ``cuda:0``. On a CUDA device the fp32 lane is pinned
    to full fp32: cuDNN would otherwise run float32 convolutions in TF32,
    which keeps about three decimal digits; in a process group the device
    becomes the process's current one, where NCCL's collectives run.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU")
        if is_distributed():
            rank, cards = local_rank(), torch.cuda.device_count()
            if rank >= cards:
                raise RuntimeError(f"LOCAL_RANK {rank} but the host has {cards} CUDA card(s): "
                                   "start one process per card, or name a device")
            device = torch.device("cuda", rank)
        else:
            device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if is_distributed():
            torch.cuda.set_device(device)
    return device
