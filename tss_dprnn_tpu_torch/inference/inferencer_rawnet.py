"""RawNet TSS inferencer (counterpart of
``tss_dprnn_tpu/inference/inferencer_rawnet.py``): :class:`InferencerSpe`
with the references resampled to 16 kHz by the eval collate, as the
reference inferencer resamples them before its forward
(``inferencer_rawnet.py:36``); ``ref_len`` then counts 16 kHz samples."""

from __future__ import annotations

from tss_dprnn_tpu_torch.inference.inferencer_spe import InferencerSpe


class InferencerRawNet(InferencerSpe):
    resample_ref_to = 16000
