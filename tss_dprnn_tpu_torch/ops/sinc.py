"""The parametrised sinc filterbank of RawNet3's front end (SincNet /
asteroid ``ParamSincFB``); the port's copy of ``tss_dprnn_tpu/ops/sinc.py``.

Each of ``n_band`` bands has learnable absolute offsets (``low_hz_``,
``band_hz_``); band i gives a cosine-phase band-pass FIR and its
odd-symmetric (Hilbert-pair) sine-phase partner, interleaved: 2 n_band
filters. The filters are recomputed from the two parameters on every
forward, so their gradient reaches them.
"""

from __future__ import annotations

import numpy as np
import torch


def mel_init_bands(n_band: int, sample_rate: float, min_low_hz: float = 50.0,
                   min_band_hz: float = 50.0):
    """Mel-spaced initial (low_hz_, band_hz_), each a float32 [n_band, 1] array."""
    high_hz = sample_rate / 2 - (min_low_hz + min_band_hz)
    mel = np.linspace(2595.0 * np.log10(1.0 + min_low_hz / 700.0),
                      2595.0 * np.log10(1.0 + high_hz / 700.0), n_band + 1)
    hz = 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    return (hz[:-1].reshape(-1, 1).astype(np.float32),
            np.diff(hz).reshape(-1, 1).astype(np.float32))


def sinc_window(kernel_size: int, sample_rate: float):
    """(the left half of the Hamming window [K // 2], the angular sample
    times 2 pi n / sample_rate for n = -K // 2 .. -1), float32 arrays as the
    JAX package computes them: the reference's ``window_`` and ``n_``."""
    half = kernel_size // 2
    two_pi_n = 2.0 * np.pi * np.arange(-half, 0.0, dtype=np.float32)
    return (np.hamming(kernel_size)[:half].astype(np.float32),
            two_pi_n / np.float32(sample_rate))


def sinc_filters(low_hz: torch.Tensor, band_hz: torch.Tensor, kernel_size: int,
                 sample_rate: float, min_low_hz: float = 50.0,
                 min_band_hz: float = 50.0) -> torch.Tensor:
    """(low_hz_ [n, 1], band_hz_ [n, 1]) -> filters [2n, 1, kernel_size] in
    the parameters' dtype (fp32 in the port's models)."""
    window, n_neg = (torch.from_numpy(a).to(low_hz.device, low_hz.dtype)
                     for a in sinc_window(kernel_size, sample_rate))

    low = min_low_hz + low_hz.abs()  # [n, 1]
    high = torch.clamp(low + min_band_hz + band_hz.abs(), min_low_hz, sample_rate / 2)
    band = (high - low)[:, 0]  # [n]

    f_lo, f_hi = low * n_neg[None, :], high * n_neg[None, :]
    half_n = n_neg[None, :] / 2.0
    bp_left = ((torch.sin(f_hi) - torch.sin(f_lo)) / half_n) * window[None, :]
    cos_f = torch.cat([bp_left, 2.0 * band[:, None], bp_left.flip(1)], dim=1)
    cos_f = cos_f / (2.0 * band[:, None])
    sp_left = ((torch.cos(f_lo) - torch.cos(f_hi)) / half_n) * window[None, :]
    sin_f = torch.cat([sp_left, torch.zeros_like(band)[:, None], -sp_left.flip(1)], dim=1)
    sin_f = sin_f / (2.0 * band[:, None])
    n = low_hz.shape[0]
    return torch.stack([cos_f, sin_f], dim=1).reshape(2 * n, 1, kernel_size)


def sinc_buffers(kernel_size: int, sample_rate: float):
    """The reference's frozen ``window_`` [K // 2] and ``n_`` [1, K // 2]
    tensors for its state_dict (``torch_export.py:97-101`` of the JAX package)."""
    window, n_neg = sinc_window(kernel_size, sample_rate)
    return torch.from_numpy(window), torch.from_numpy(n_neg.reshape(1, -1))
