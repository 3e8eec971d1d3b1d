"""Host-side evaluation metrics with the asteroid ``get_metrics`` schema
(counterpart of ``tss_dprnn_tpu/ops/metrics.py``), numpy in float64:

- ``si_sdr`` — numpy, same math as the device loss (ops/losses.py);
- ``stoi``  — the first-party short-time objective intelligibility measure
  (Taal et al. 2011) of the JAX package: 10 kHz resample
  (data/resample.py), silent-frame removal at 40 dB dynamic range, 512-pt
  STFT of 256-sample hann frames hop 128, 15 one-third-octave bands from
  150 Hz, 30-frame segments, -15 dB SDR clipping;
- ``pesq``  — the first-party P.862 chain of ``ops/pesq.py``. The JAX
  package prefers the ``pesq`` C extension where it is importable; the port
  never imports it, so both machines score with the same code.

Returns ``{metric: value, 'input_' + metric: value-of-mixture}`` like
asteroid, so the ``*_imp`` improvement columns of final_metrics.json are
computable downstream. A metric that fails gives None, as in the JAX package.
"""

from __future__ import annotations

import warnings
from functools import lru_cache
from typing import Dict, Optional, Sequence

import numpy as np

from tss_dprnn_tpu_torch.data.resample import resample as _resample
from tss_dprnn_tpu_torch.ops.pesq import pesq as _pesq

EPS = 1e-8

def si_sdr(est: np.ndarray, target: np.ndarray) -> float:
    est = np.asarray(est, np.float64)
    target = np.asarray(target, np.float64)
    est = est - est.mean()
    target = target - target.mean()
    dot = np.sum(est * target)
    s_t = dot * target / (np.sum(target**2) + EPS)
    e = est - s_t
    return float(10 * np.log10(np.sum(s_t**2) / (np.sum(e**2) + EPS) + EPS))


# ----------------------------------------------------------------------- STOI

_FS = 10000
_N_FRAME = 256
_HOP = 128
_NFFT = 512
_NUM_BANDS = 15
_MIN_FREQ = 150
_N_SEG = 30
_BETA = -15.0
_DYN_RANGE = 40.0


@lru_cache(maxsize=1)
def _third_octave_matrix():
    f = np.linspace(0, _FS, _NFFT + 1)[: _NFFT // 2 + 1]
    k = np.arange(_NUM_BANDS, dtype=np.float64)
    cf = (2.0 ** (k / 3.0)) * _MIN_FREQ
    f_low = cf * 2 ** (-1.0 / 6.0)
    f_high = cf * 2 ** (1.0 / 6.0)
    obm = np.zeros((_NUM_BANDS, len(f)))
    for i in range(_NUM_BANDS):
        lo = int(np.argmin((f - f_low[i]) ** 2))
        hi = int(np.argmin((f - f_high[i]) ** 2))
        obm[i, lo:hi] = 1.0
    return obm


def _frames(x: np.ndarray, win: np.ndarray) -> np.ndarray:
    n = 1 + max(0, (len(x) - _N_FRAME)) // _HOP
    idx = np.arange(_N_FRAME)[None, :] + _HOP * np.arange(n)[:, None]
    return x[idx] * win[None, :]


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    win = np.hanning(_N_FRAME + 2)[1:-1]
    xf = _frames(x, win)
    yf = _frames(y, win)
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) / np.sqrt(_N_FRAME) + EPS)
    mask = energies > (np.max(energies) - _DYN_RANGE)
    xf, yf = xf[mask], yf[mask]
    n = len(xf)
    if n == 0:
        return np.zeros(0), np.zeros(0)
    out_len = _N_FRAME + (n - 1) * _HOP
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    # overlap-add (windows sum to ~1 at 50% hann overlap), vectorized: with
    # hop | frame the frames split into frame/hop interleaved classes whose
    # members are disjoint and contiguous — one ravel-add per class instead
    # of a Python loop over every frame (same interleave trick as
    # ops/chunking.py's overlap_add)
    assert _N_FRAME % _HOP == 0, "interleave-class overlap-add needs hop | frame"
    r = _N_FRAME // _HOP
    for j in range(r):
        fj = xf[j::r]
        gj = yf[j::r]
        start = j * _HOP
        xs[start : start + fj.size] += fj.ravel()
        ys[start : start + gj.size] += gj.ravel()
    return xs, ys


def _band_spectrogram(x: np.ndarray) -> np.ndarray:
    win = np.hanning(_N_FRAME + 2)[1:-1]
    frames = _frames(x, win)
    spec = np.fft.rfft(frames, _NFFT, axis=1)  # [n_frames, 257]
    power = np.abs(spec) ** 2
    obm = _third_octave_matrix()
    return np.sqrt(power @ obm.T + EPS)  # [n_frames, 15]


def stoi(clean: np.ndarray, denoised: np.ndarray, sample_rate: int) -> float:
    """Classic (non-extended) STOI in [~0, 1]."""
    clean = np.asarray(clean, np.float64)
    denoised = np.asarray(denoised, np.float64)
    if sample_rate != _FS:
        clean = _resample(clean.astype(np.float32), sample_rate, _FS).astype(np.float64)
        denoised = _resample(denoised.astype(np.float32), sample_rate, _FS).astype(np.float64)
    clean, denoised = _remove_silent_frames(clean, denoised)
    if len(clean) < _N_FRAME + (_N_SEG - 1) * _HOP:
        warnings.warn("STOI: signal too short after silent-frame removal")
        return float("nan")
    X = _band_spectrogram(clean)  # [n_frames, bands]
    Y = _band_spectrogram(denoised)
    n_frames = X.shape[0]
    if n_frames < _N_SEG:
        return float("nan")
    c = 10 ** (-_BETA / 20.0)
    # all segments at once: [n_segs, bands, 30] sliding windows over the
    # frame axis, in the reduction order of a per-segment loop
    Xs = np.lib.stride_tricks.sliding_window_view(X, _N_SEG, axis=0)
    Ys = np.lib.stride_tricks.sliding_window_view(Y, _N_SEG, axis=0)
    alpha = np.sqrt(np.sum(Xs**2, axis=-1) / (np.sum(Ys**2, axis=-1) + EPS))
    Yp = np.minimum(Ys * alpha[..., None], Xs * (1 + c))
    xn = Xs - Xs.mean(axis=-1, keepdims=True)
    yn = Yp - Yp.mean(axis=-1, keepdims=True)
    num = np.sum(xn * yn, axis=-1)
    den = np.sqrt(np.sum(xn**2, axis=-1)) * np.sqrt(np.sum(yn**2, axis=-1)) + EPS
    return float(np.mean(num / den))


# ------------------------------------------------------------------ PESQ gate


def pesq_score(clean: np.ndarray, denoised: np.ndarray, sample_rate: int) -> Optional[float]:
    mode = "nb" if sample_rate < 16000 else "wb"
    try:
        return float(_pesq(sample_rate, np.asarray(clean), np.asarray(denoised), mode))
    except Exception as e:  # a row the chain cannot score gets None, not a failed run
        warnings.warn(f"pesq failed: {e}")
        return None


# ------------------------------------------------------- asteroid-style facade


def get_metrics(
    mix: np.ndarray,
    clean: np.ndarray,
    estimate: np.ndarray,
    sample_rate: int = 8000,
    metrics_list: Sequence[str] = ("si_sdr", "stoi", "pesq"),
) -> Dict[str, Optional[float]]:
    """mix [T] or [1, T]; clean/estimate [T] or [n_src, T]. Averages over
    sources and adds ``input_*`` entries (mixture vs clean), like asteroid."""
    mix = np.atleast_2d(np.asarray(mix))[0]
    clean = np.atleast_2d(np.asarray(clean))
    estimate = np.atleast_2d(np.asarray(estimate))
    fns = {
        "si_sdr": lambda c, e: si_sdr(e, c),
        "stoi": lambda c, e: stoi(c, e, sample_rate),
        "pesq": lambda c, e: pesq_score(c, e, sample_rate),
    }
    out: Dict[str, Optional[float]] = {}
    for name in metrics_list:
        fn = fns[name]
        vals = [fn(c, e) for c, e in zip(clean, estimate)]
        ivals = [fn(c, mix) for c in clean]
        out[name] = None if any(v is None for v in vals) else float(np.mean(vals))
        out["input_" + name] = None if any(v is None for v in ivals) else float(np.mean(ivals))
    return out
