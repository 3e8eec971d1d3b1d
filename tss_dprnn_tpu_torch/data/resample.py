"""Windowed-sinc polyphase resampling (torchaudio-style); the port's copy of
``tss_dprnn_tpu/data/resample.py``. STOI resamples to 10 kHz through it.

Replaces the host-side ``torchaudio.transforms.Resample(8000, 16000)`` the
reference applies to RawNet reference waveforms (src/trainers/
trainer_rawnet.py:14-16,31; inferencer_rawnet.py:36). Implements the same
kernel construction as torchaudio's ``_get_sinc_resample_kernel`` (hann
window, lowpass_filter_width=6, rolloff=0.99): for each output phase, a
sinc lowpass at ``rolloff * min(orig, new)/2`` sampled at the phase offsets.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=32)
def _kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
            rolloff: float = 0.99):
    gcd = math.gcd(orig_freq, new_freq)
    orig = orig_freq // gcd
    new = new_freq // gcd
    base_freq = min(orig, new) * rolloff / 2.0  # cycles per (1/gcd-sec) sample... relative
    # torchaudio works in units of the original sample rate:
    # kernel[p, w] = sinc filter evaluated at t = (-w + p/new) for window
    # half-width ``width`` original samples around each output time p/new.
    width = math.ceil(lowpass_filter_width * orig / (min(orig, new) * rolloff))
    idx = np.arange(-width, width + orig, dtype=np.float64) / orig  # [W]
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx[None, :]  # [new, W]
    f = min(orig, new) * rolloff / 2.0  # in units of orig-rate cycles? use torchaudio's formula
    t_scaled = t * f * 2 * np.pi
    window = np.cos(t * f / lowpass_filter_width * np.pi) ** 2
    window[np.abs(t * f / lowpass_filter_width) >= 0.5] = 0.0  # hann support
    kernel = np.where(t_scaled == 0, 1.0, np.sin(t_scaled) / np.where(t_scaled == 0, 1.0, t_scaled))
    kernel = kernel * window * (2 * f / orig)
    return kernel.astype(np.float32), width, orig, new


def resample(waveform: np.ndarray, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99) -> np.ndarray:
    """[T] or [..., T] float32 -> resampled along the last axis."""
    if orig_freq == new_freq:
        return np.asarray(waveform, np.float32)
    kernel, width, orig, new = _kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)
    x = np.asarray(waveform, np.float32)
    shape = x.shape
    T = shape[-1]
    x2 = x.reshape(-1, T)
    num_wavs = x2.shape[0]
    pad = width + orig
    xp = np.pad(x2, ((0, 0), (width, pad)))
    W = kernel.shape[1]
    target_len = int(math.ceil(new * T / orig))
    # output frame m (phase p = m % new, block k = m // new) reads
    # xp[:, k*orig : k*orig + W] . kernel[p]
    n_blocks = -(-target_len // new)
    outs = np.zeros((num_wavs, n_blocks * new), np.float32)
    # vectorized: strided view [num, n_blocks, W]
    from numpy.lib.stride_tricks import as_strided

    need = (n_blocks - 1) * orig + W
    if xp.shape[1] < need:
        xp = np.pad(xp, ((0, 0), (0, need - xp.shape[1])))
    s0, s1 = xp.strides
    blocks = as_strided(xp, (num_wavs, n_blocks, W), (s0, s1 * orig, s1))
    outs = np.einsum("nbw,pw->nbp", blocks, kernel).reshape(num_wavs, -1)
    return outs[:, :target_len].reshape(shape[:-1] + (target_len,))
