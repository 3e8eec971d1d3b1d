"""First-party PESQ (ITU-T P.862 style), narrowband (8 kHz) and wideband (16 kHz).

The port's copy of ``tss_dprnn_tpu/ops/pesq.py``, unchanged apart from this
docstring: numpy in float64, so the two packages score alike.

The reference obtains PESQ through ``asteroid.metrics.get_metrics`` ->
``pesq`` C extension (reference src/inferencers/inferencer.py:64-70). The
port does not use that extension; this module is a from-scratch
implementation with the full P.862 processing chain (Rix et al., ICASSP 2001;
ITU-T P.862 / P.862.1 / P.862.2):

  1.  level alignment of both signals to a fixed target power measured over
      the 350-3250 Hz band,
  2.  IRS receive filtering (narrowband) / 100 Hz high-pass (wideband),
  3.  envelope-based time alignment (constant-delay variant: the utterance
      splitting + per-utterance realignment of P.862 is not implemented
      because this framework's estimates are sample-aligned by construction),
  4.  perceptual model: 32 ms Hann frames at 50% overlap -> power spectrum ->
      Bark-band "pitch power densities" -> partial compensation of linear
      frequency response (bounded per-band ratio) and of short-term gain
      (bounded, time-smoothed per-frame ratio) -> Zwicker-law loudness,
  5.  disturbance processing: masking deadzone of 0.25*min(loudness),
      asymmetry factor ((deg+50)/(ref+50))**1.2 gated to [3, 12],
  6.  aggregation: Bark-width-weighted L3 (symmetric) / L1 (asymmetric) over
      bands, frame weighting by reference audible power**0.04, L6 over 320 ms
      "syllable" intervals (hop 10 frames), L2 over intervals,
  7.  raw PESQ = 4.5 - 0.1*D - 0.0309*DA, then the P.862.1 (nb) / P.862.2
      (wb) logistic mapping to MOS-LQO — same output convention as the
      ``pesq`` package the reference stack uses.

Deliberate deviation (documented; see PARITY.md): ITU's tabulated band data
(centre/width/threshold per band) are proprietary-calibrated constants not
reproducible here, so the 42 (nb) / 49 (wb) Bark bands are derived from the
traditional Bark transform with uniform Bark spacing, and the absolute
hearing threshold from Terhardt's formula. Identical signals score exactly
4.5 raw (== 4.549 MOS-LQO nb, matching the ITU implementation), and scores
are monotonic in distortion (tests/test_pesq.py). Measured error envelope
(scripts/perf/pesq_battery.py, PARITY.md): additive noise tracks the
published P.862 curve within ~0.1 MOS; band-limiting lands inside the
ITU-typical windows after the in-domain cushion re-scale (see
_FREQ_COMP_OFFSET below); hard clipping and very coarse companding remain
lenient by up to ~+1 MOS at the extremes.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

# Target mean power over the 350-3250 Hz band after level alignment
# (P.862's TARGET_AVG_POWER).
_TARGET_POWER = 1e7
# The aligned signal is interpreted as presented at 79 dB SPL; band powers are
# rescaled into an "SPL power" domain where the absolute hearing threshold is
# 10**(threshold_dB/10).
_LISTENING_LEVEL_DB = 79.0
_ZWICKER_POWER = 0.23
# Calibrated (with the derived band tables) so that speech + white noise at
# SNR 35/25/15/5 dB maps to MOS-LQO ~= 4.0/3.4/2.6/2.0, the published P.862
# narrowband behavior; identical signals give 4.549 for any value here.
_LOUDNESS_SCALE = 0.35
_D_WEIGHT = 0.1
_DA_WEIGHT = 0.0309
_DATA_PADDING_SEC = 0.32
# Cushion offsets of the partial compensations and the asymmetry ratio.
# P.862 defines these as +1000 (freq response), +5e3 (short-term gain) and
# +50 (asymmetry) in ITS pitch-power-density domain. This implementation's
# SPL-power domain runs ~1e4 hotter (typical active-band densities 1e6-5e7
# here vs ~1e3-1e4 in the ITU domain), so the frequency-response cushion is
# re-scaled in-domain: with the raw +1000, a band-killing degradation drives
# the compensation ratio straight into its 0.01 clip and the compensation
# erases most of the missing-band loudness — scoring band-limits ~+1.5 MOS
# lenient. 3e7 (~1000 x the domain ratio, selected on the calibration
# battery) restores ITU-like band-limit penalties while leaving the additive
# -noise anchor curve unchanged; see PARITY.md / scripts/perf/pesq_battery.py.
# The gain/asymmetry offsets stay at the ITU values: both are near-zero
# cushions in either domain (battery-verified that domain-scaling them only
# degrades the noise anchors).
_FREQ_COMP_OFFSET = 3e7
_GAIN_OFFSET = 5e3
_ASYM_OFFSET = 50.0

# IRS receive characteristic, (Hz, dB) breakpoints, linearly interpolated in
# log-frequency; applied to both signals in narrowband mode.
_IRS_RECEIVE_DB = np.array(
    [
        (8.0, -200.0), (50.0, -40.0), (100.0, -20.0), (125.0, -12.0),
        (160.0, -6.0), (200.0, 0.0), (250.0, 4.0), (300.0, 6.0),
        (350.0, 8.0), (400.0, 10.0), (500.0, 11.0), (600.0, 12.0),
        (800.0, 12.0), (1000.0, 12.0), (1300.0, 12.0), (1600.0, 12.0),
        (2000.0, 12.0), (2500.0, 12.0), (3000.0, 12.0), (3250.0, 12.0),
        (3500.0, 4.0), (4000.0, -200.0), (8000.0, -200.0),
    ]
)


def _bark(f: np.ndarray) -> np.ndarray:
    """Traditional (Zwicker/Terhardt) Hz -> Bark transform."""
    f = np.asarray(f, np.float64)
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _terhardt_threshold_db(f: np.ndarray) -> np.ndarray:
    """Absolute threshold of hearing in dB SPL (Terhardt 1979)."""
    khz = np.maximum(np.asarray(f, np.float64), 20.0) / 1000.0
    return (
        3.64 * khz**-0.8
        - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
        + 1e-3 * khz**4
    )


@lru_cache(maxsize=4)
def _band_layout(fs: int) -> Tuple[np.ndarray, ...]:
    """Uniform-Bark band layout.

    Returns (bin_band [n_bins] int band index or -1, centre_hz [Nb],
    width_bark [Nb], abs_thresh_power [Nb], n_bands).
    """
    if fs == 8000:
        n_bands, f_lo, f_hi, nf = 42, 60.0, 3700.0, 256
    elif fs == 16000:
        n_bands, f_lo, f_hi, nf = 49, 60.0, 7400.0, 512
    else:  # pragma: no cover - guarded by pesq()
        raise ValueError(f"PESQ supports 8/16 kHz, got {fs}")
    edges_bark = np.linspace(_bark(f_lo), _bark(f_hi), n_bands + 1)
    # invert the bark transform on a dense grid
    grid = np.linspace(1.0, fs / 2.0, 16384)
    edges_hz = np.interp(edges_bark, _bark(grid), grid)
    centre_hz = np.sqrt(edges_hz[:-1] * edges_hz[1:])
    width_bark = np.diff(edges_bark)
    abs_thresh = 10.0 ** (_terhardt_threshold_db(centre_hz) / 10.0)
    freqs = np.fft.rfftfreq(nf, 1.0 / fs)
    bin_band = np.digitize(freqs, edges_hz) - 1
    bin_band[(freqs < edges_hz[0]) | (freqs >= edges_hz[-1])] = -1
    return bin_band, centre_hz, width_bark, abs_thresh, np.int64(n_bands)


# --------------------------------------------------------------- pre-processing


def _fft_filter_db(x: np.ndarray, fs: int, breakpoints: np.ndarray) -> np.ndarray:
    """Apply a piecewise-linear-in-log-f magnitude response via FFT."""
    n = len(x)
    spec = np.fft.rfft(x)
    f = np.maximum(np.fft.rfftfreq(n, 1.0 / fs), 1.0)
    gain_db = np.interp(np.log(f), np.log(breakpoints[:, 0]), breakpoints[:, 1])
    return np.fft.irfft(spec * 10.0 ** (gain_db / 20.0), n)


def _bandpass_power(x: np.ndarray, fs: int, lo: float, hi: float) -> float:
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(len(x), 1.0 / fs)
    spec[(f < lo) | (f > hi)] = 0.0
    return float(np.mean(np.fft.irfft(spec, len(x)) ** 2))


def _level_align(x: np.ndarray, fs: int) -> np.ndarray:
    p = _bandpass_power(x, fs, 350.0, 3250.0)
    return x * np.sqrt(_TARGET_POWER / (p + 1e-20))


def _estimate_delay(ref: np.ndarray, deg: np.ndarray, fs: int) -> int:
    """Constant-delay estimate: coarse on 4 ms energy envelopes, then a
    fine full-rate cross-correlation pass around the coarse peak."""
    block = fs // 250  # 4 ms
    n = min(len(ref), len(deg)) // block * block
    env_r = np.abs(ref[:n]).reshape(-1, block).sum(1)
    env_d = np.abs(deg[:n]).reshape(-1, block).sum(1)
    env_r -= env_r.mean()
    env_d -= env_d.mean()
    m = len(env_r)
    size = 2 ** int(np.ceil(np.log2(2 * m)))
    xc = np.fft.irfft(
        np.fft.rfft(env_d, size) * np.conj(np.fft.rfft(env_r, size)), size
    )
    lags = np.concatenate([np.arange(m), np.arange(-(size - m), 0)])
    coarse = int(lags[np.argmax(xc)]) * block
    # fine search +-1.5 blocks around the coarse lag. One FFT
    # cross-correlation of the full signals yields every candidate lag's
    # dot product at once (the explicit per-lag np.dot loop was ~3*block
    # full-length dots, ~60% of a PESQ call's host time — profiled
    # 2026-08-20). Tie-break caveat: argmax keeps the FIRST max, like the
    # loop it replaces, but irfft rounding (~1e-10 rel) can split an EXACT
    # per-lag tie and resolve to a different lag — acceptable within the
    # measured PESQ envelope (tests/test_pesq.py tolerances).
    lag_w = np.arange(coarse - block - block // 2,
                      coarse + block + block // 2 + 1)
    lag_w = lag_w[(n - np.abs(lag_w)) >= block]  # k < block skipped
    if len(lag_w) == 0:
        return coarse
    # linear (non-circular) correlation needs size >= n + max|lag| + 1 only —
    # half the FFT of the generic 2n padding when the coarse lag is small
    size2 = 2 ** int(np.ceil(np.log2(n + int(np.abs(lag_w).max()) + 1)))
    cc = np.fft.irfft(
        np.fft.rfft(deg[:n], size2) * np.conj(np.fft.rfft(ref[:n], size2)), size2
    )
    vals = cc[np.where(lag_w >= 0, lag_w, size2 + lag_w)]
    return int(lag_w[np.argmax(vals)])


def _apply_delay(deg: np.ndarray, delay: int) -> np.ndarray:
    if delay > 0:
        return np.concatenate([deg[delay:], np.zeros(delay)])
    if delay < 0:
        return np.concatenate([np.zeros(-delay), deg[:delay]])
    return deg


# ------------------------------------------------------------ perceptual model


def _pitch_power_densities(x: np.ndarray, fs: int) -> np.ndarray:
    """[n_frames, n_bands] Bark-band power densities in the SPL-power domain."""
    bin_band, _, _, _, n_bands = _band_layout(fs)
    nf = 256 if fs == 8000 else 512
    hop = nf // 2
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(nf) / nf))
    n_frames = max(0, (len(x) - nf) // hop + 1)
    idx = np.arange(nf)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx] * win[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2
    # Parseval normalisation: sum over bins == mean square of the (un-windowed)
    # frame, so band powers live in the same power units as the time signal.
    spec *= 2.0 / (nf * np.sum(win**2))
    valid = bin_band >= 0
    bands = np.zeros((n_frames, int(n_bands)))
    np.add.at(bands.T, bin_band[valid], spec[:, valid].T)
    # time-domain target power 1e7 <-> listening level 79 dB SPL
    return bands * (10.0 ** (_LISTENING_LEVEL_DB / 10.0) / _TARGET_POWER)


def _total_audible(frames: np.ndarray, abs_thresh: np.ndarray, factor: float) -> np.ndarray:
    audible = np.where(frames > factor * abs_thresh[None, :], frames, 0.0)
    return audible.sum(axis=1)


def _loudness(pp: np.ndarray, abs_thresh: np.ndarray) -> np.ndarray:
    t = abs_thresh[None, :]
    s = (
        _LOUDNESS_SCALE
        * (t / 0.5) ** _ZWICKER_POWER
        * ((0.5 + 0.5 * pp / t) ** _ZWICKER_POWER - 1.0)
    )
    return np.where(pp > t, s, 0.0)


def _lp(x: np.ndarray, w: np.ndarray, p: float) -> np.ndarray:
    """Weighted Lp norm over the last axis with normalised weights."""
    wn = w / w.sum()
    return (np.sum(wn[None, :] * np.abs(x) ** p, axis=-1)) ** (1.0 / p)


def _disturbances(ref: np.ndarray, deg: np.ndarray, fs: int) -> Tuple[float, float]:
    """(D, DA): aggregated symmetric / asymmetric disturbance of the
    (preprocessed, aligned, padded) signal pair."""
    _, _, width_bark, abs_thresh, _ = _band_layout(fs)
    pp_ref = _pitch_power_densities(ref, fs)
    pp_deg = _pitch_power_densities(deg, fs)
    n = min(len(pp_ref), len(pp_deg))
    if n == 0:
        return 0.0, 0.0
    pp_ref, pp_deg = pp_ref[:n], pp_deg[:n]

    # silent frames: > 35 dB below the nominal listening level
    total_ref = _total_audible(pp_ref, abs_thresh, 1.0)
    silent = total_ref < 10.0 ** ((_LISTENING_LEVEL_DB - 35.0) / 10.0)
    speech = ~silent
    if not np.any(speech):
        return 0.0, 0.0

    # partial compensation of the linear frequency response (applied to ref)
    avg_ref = pp_ref[speech].mean(axis=0)
    avg_deg = pp_deg[speech].mean(axis=0)
    band_ratio = np.clip((avg_deg + _FREQ_COMP_OFFSET) / (avg_ref + _FREQ_COMP_OFFSET), 0.01, 100.0)
    pp_ref_c = pp_ref * band_ratio[None, :]

    # partial compensation of short-term gain (applied to deg, smoothed)
    aud_ref = _total_audible(pp_ref_c, abs_thresh, 1.0)
    aud_deg = _total_audible(pp_deg, abs_thresh, 1.0)
    ratio = (aud_ref + _GAIN_OFFSET) / (aud_deg + _GAIN_OFFSET)
    gain = np.empty(n)
    g = 1.0
    for i in range(n):
        g = ratio[i] if i == 0 else 0.2 * ratio[i] + 0.8 * g
        gain[i] = np.clip(g, 3e-4, 5.0)
    pp_deg_c = pp_deg * gain[:, None]

    loud_ref = _loudness(pp_ref_c, abs_thresh)
    loud_deg = _loudness(pp_deg_c, abs_thresh)

    # masked disturbance
    d = loud_deg - loud_ref
    m = 0.25 * np.minimum(loud_deg, loud_ref)
    d = np.sign(d) * np.maximum(np.abs(d) - m, 0.0)

    # asymmetry factor
    asym = ((pp_deg_c + _ASYM_OFFSET) / (pp_ref_c + _ASYM_OFFSET)) ** 1.2
    asym = np.where(asym < 3.0, 0.0, np.minimum(asym, 12.0))

    d_frame = _lp(d, width_bark, 3.0)
    da_frame = np.sum(
        (width_bark / width_bark.sum())[None, :] * np.abs(d) * asym, axis=1
    )
    # weight frames by the audible power of the reference
    h = ((total_ref + 1e5) / 10.0 ** (_LISTENING_LEVEL_DB / 10.0)) ** 0.04
    d_frame = np.minimum(d_frame / h, 45.0)
    da_frame = np.minimum(da_frame / h, 45.0)

    # L6 over 320 ms intervals (20 frames, hop 10), then L2 over intervals
    def _aggregate(x: np.ndarray) -> float:
        starts = range(0, max(1, len(x) - 9), 10)
        vals = [np.mean(x[s : s + 20] ** 6.0) ** (1.0 / 6.0) for s in starts]
        return float(np.sqrt(np.mean(np.square(vals))))

    return _aggregate(d_frame), _aggregate(da_frame)


def _raw_pesq(ref: np.ndarray, deg: np.ndarray, fs: int) -> float:
    d, da = _disturbances(ref, deg, fs)
    return 4.5 - _D_WEIGHT * d - _DA_WEIGHT * da


# ------------------------------------------------------------------ public API


def pesq(fs: int, ref: np.ndarray, deg: np.ndarray, mode: str = "nb") -> float:
    """PESQ MOS-LQO, same call convention as ``pesq.pesq`` from the C package.

    mode 'nb' (fs must be 8000 or 16000) maps through P.862.1; mode 'wb'
    (fs must be 16000) maps through P.862.2.
    """
    if mode not in ("nb", "wb"):
        raise ValueError(f"mode must be 'nb' or 'wb', got {mode!r}")
    if fs not in (8000, 16000):
        raise ValueError(f"fs must be 8000 or 16000, got {fs}")
    if mode == "wb" and fs != 16000:
        raise ValueError("wideband PESQ requires fs=16000")
    ref = np.asarray(ref, np.float64).ravel()
    deg = np.asarray(deg, np.float64).ravel()
    if len(ref) < fs // 4 or len(deg) < fs // 4:
        raise ValueError("signals too short for PESQ (< 0.25 s)")

    ref = _level_align(ref, fs)
    deg = _level_align(deg, fs)
    if mode == "nb":
        ref = _fft_filter_db(ref, fs, _IRS_RECEIVE_DB)
        deg = _fft_filter_db(deg, fs, _IRS_RECEIVE_DB)
    else:
        hp = np.array([(8.0, -200.0), (50.0, -40.0), (100.0, 0.0), (8000.0, 0.0)])
        ref = _fft_filter_db(ref, fs, hp)
        deg = _fft_filter_db(deg, fs, hp)

    deg = _apply_delay(deg, _estimate_delay(ref, deg, fs))
    pad = np.zeros(int(_DATA_PADDING_SEC * fs))
    ref = np.concatenate([ref, pad])
    deg = np.concatenate([deg, pad])

    raw = np.clip(_raw_pesq(ref, deg, fs), -0.5, 4.5)
    if mode == "nb":
        return float(0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607)))
    return float(0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224)))
