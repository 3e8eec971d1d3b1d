"""DPRNN-RawNet-TasNet: DPRNN-Spe with the ResNet speaker branch swapped for
a RawNet3 embedder of the raw 16 kHz reference waveform
(counterpart of ``tss_dprnn_tpu/models/dprnn_rawnet.py:23-106``).

The reference reaches the model resampled to 16 kHz by the input pipeline
(``data/loader.py``'s ``resample_ref_to``), not through the TasNet encoder.
``aux_len`` holds its true 16 kHz sample counts for the embedder's masked
pools; without it the embedder reads the whole row, as the reference's
forward, which takes no length, does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tss_dprnn_tpu_torch.models.dprnn_spe import DPRNNSpe, DPRNNSpeTasNet
from tss_dprnn_tpu_torch.models.rawnet import RawNet3


class DPRNNRawNet(DPRNNSpe):
    """The separation module with RawNet3 as ``spk_encoder``:
    ``forward(x [B, L, N], aux_wav [B, Ta] at 16 kHz, aux_len=None,
    lengths=None) -> (masks [B, 2, L, N], logits)``."""

    def __init__(self, *args, rawnet_C: int = 1024, rawnet_scale: int = 8,
                 rawnet_sinc_stride: int = 10, rawnet_sample_rate: float = 16000.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.spk_encoder = RawNet3(rawnet_C, rawnet_scale, self.pred_linear.in_features,
                                   rawnet_sinc_stride, rawnet_sample_rate)

    def embed(self, aux_wav: torch.Tensor, aux_len: Optional[torch.Tensor]) -> torch.Tensor:
        return self.spk_encoder(aux_wav, aux_len)


class DPRNNRawNetTasNet(DPRNNSpeTasNet):
    """DPRNN-RawNet-TasNet. ``forward(mix [B, T] at 8 kHz, aux [B, Ta] raw at
    16 kHz, aux_len=None, lengths=None) -> (target_wav, logits)``;
    ``rawnet_C``, ``rawnet_scale``, ``rawnet_sinc_stride`` and
    ``rawnet_sample_rate`` as :class:`DPRNNRawNet` has them (1024, 8, 10,
    16 kHz); ``O`` and ``P`` are accepted and unused."""

    separation_cls = DPRNNRawNet

    def aux_input(self, aux: torch.Tensor) -> torch.Tensor:
        return aux  # the raw waveform

    def forward(self, mix: torch.Tensor, aux: torch.Tensor, aux_len: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        return super().forward(mix, aux, aux_len, lengths)
