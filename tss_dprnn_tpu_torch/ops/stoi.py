"""STOI on the device, batched over rows (counterpart of
``tss_dprnn_tpu/ops/stoi_jax.py``).

The same short-time objective intelligibility measure as the host
``ops/metrics.stoi`` (Taal et al. 2011), for a batch of zero-padded rows with
their true lengths, with the JAX package's design:

- the 8 -> 10 kHz resample is the polyphase windowed sinc of
  ``data/resample.py`` (the same coefficients), over strided windows;
- frames fully inside a row's true length are valid; the silent frames are
  dropped by an index gather of the kept ones, in order (exact, where the
  JAX package multiplies by a one-hot matrix);
- overlap-add and re-framing at hop 128 are reshapes; the 512-point rfft,
  the third-octave band sums and all 30-frame segments at once.

Arithmetic is fp32 as in the JAX package, except the two small contractions
(resample taps and band sums), which run in float64 so that no setting of
TF32 can change a score. Rows too short for one 30-frame segment score NaN,
as on the host.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from tss_dprnn_tpu_torch.data.resample import _kernel as _resample_kernel
from tss_dprnn_tpu_torch.ops.metrics import (_DYN_RANGE, _FS, _HOP, _N_FRAME, _N_SEG, _NFFT,
                                              _third_octave_matrix)

EPS = 1e-8
_BETA_C = 10.0 ** (15.0 / 20.0)  # 10 ** (-BETA / 20), BETA = -15 dB


def _mm64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float64, returned as float32: no TF32 on any device."""
    return (a.double() @ b.double()).float()


@lru_cache(maxsize=8)
def _consts(device: torch.device):
    win = torch.tensor(np.hanning(_N_FRAME + 2)[1:-1], dtype=torch.float32, device=device)
    obm_t = torch.tensor(_third_octave_matrix().T, dtype=torch.float64, device=device)
    return win, obm_t  # [256], [257, 15]


def resample_batch(x: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """[B, T] -> [B, ceil(T new / orig)]: ``data/resample.resample`` of each
    row, up to the order of its sums."""
    if orig_freq == new_freq:
        return x
    kernel, width, orig, new = _resample_kernel(orig_freq, new_freq)
    B, T = x.shape
    W = kernel.shape[1]
    target_len = int(math.ceil(new * T / orig))
    n_blocks = -(-target_len // new)
    need = (n_blocks - 1) * orig + W
    xp = torch.nn.functional.pad(x, (width, max(need - T - width, 0)))
    wins = xp.unfold(1, W, orig)[:, :n_blocks]  # [B, n_blocks, W]: block k reads xp[k orig:]
    k = torch.as_tensor(kernel, device=x.device)
    return _mm64(wins, k.T).reshape(B, n_blocks * new)[:, :target_len]


def _frame(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, L] -> [B, n, 256]: frames at hop 128 from two interleaved reshapes."""
    a = x[:, : (n + 1) * _HOP].reshape(x.shape[0], n + 1, _HOP)
    return torch.cat([a[:, :-1], a[:, 1:]], dim=-1)


def _overlap_add(frames: torch.Tensor, out_len: int) -> torch.Tensor:
    """[B, n, 256] -> [B, out_len] at hop 128: the even and the odd frames
    each tile the signal, so each adds as one contiguous stream."""
    B = frames.shape[0]
    xs = frames.new_zeros(B, out_len)
    for j in range(2):
        fj = frames[:, j::2].reshape(B, -1)
        xs[:, j * _HOP: j * _HOP + fj.shape[1]] += fj
    return xs


def _band_spec(frames: torch.Tensor, win: torch.Tensor, obm_t: torch.Tensor) -> torch.Tensor:
    spec = torch.fft.rfft(frames * win, _NFFT, dim=-1)  # [B, n, 257]
    power = spec.real ** 2 + spec.imag ** 2
    return torch.sqrt(_mm64(power, obm_t) + EPS)  # [B, n, 15]


def _stoi_rows(clean: torch.Tensor, deg: torch.Tensor, l10: torch.Tensor) -> torch.Tensor:
    """Rows at 10 kHz, zero past ``l10`` -> [B] scores (NaN when too short)."""
    win, obm_t = _consts(clean.device)
    B, T10 = clean.shape
    n = 1 + max(0, T10 - _N_FRAME) // _HOP
    if n < _N_SEG:  # the padded length itself is too short for one segment
        return clean.new_full((B,), float("nan"))
    cf = _frame(clean, n) * win
    df = _frame(deg, n) * win
    # the frames the exactly cropped row has
    nv = 1 + torch.div(l10 - _N_FRAME, _HOP, rounding_mode="floor")
    t = torch.arange(n, device=clean.device)
    valid = t[None, :] < nv[:, None]
    energies = 20.0 * torch.log10(torch.linalg.vector_norm(cf, dim=-1) / math.sqrt(_N_FRAME) + EPS)
    emax = torch.where(valid, energies, -torch.inf).amax(dim=1, keepdim=True)
    mask = valid & (energies > emax - _DYN_RANGE)
    m = mask.sum(dim=1)
    # compaction: the kept frames first, in order (a stable sort of ~mask),
    # everything after the m-th zeroed
    order = torch.sort((~mask).to(torch.uint8), dim=1, stable=True).indices
    kept = (t[None, :] < m[:, None])[:, :, None]
    cxf = torch.where(kept, cf.gather(1, order[:, :, None].expand_as(cf)), 0.0)
    dxf = torch.where(kept, df.gather(1, order[:, :, None].expand_as(df)), 0.0)

    out_len = (n + 1) * _HOP
    X = _band_spec(_frame(_overlap_add(cxf, out_len), n), win, obm_t)  # [B, n, 15]
    Y = _band_spec(_frame(_overlap_add(dxf, out_len), n), win, obm_t)

    ns = n - (_N_SEG - 1)
    Xs = X.unfold(1, _N_SEG, 1)  # [B, ns, 15, 30]: every 30-frame segment
    Ys = Y.unfold(1, _N_SEG, 1)
    alpha = torch.sqrt(Xs.square().sum(-1) / (Ys.square().sum(-1) + EPS))
    Yp = torch.minimum(Ys * alpha[..., None], Xs * (1.0 + _BETA_C))
    xn = Xs - Xs.mean(dim=-1, keepdim=True)
    yn = Yp - Yp.mean(dim=-1, keepdim=True)
    num = (xn * yn).sum(-1)
    den = torch.sqrt(xn.square().sum(-1)) * torch.sqrt(yn.square().sum(-1)) + EPS
    corr = num / den  # [B, ns, 15]

    m_seg = m - (_N_SEG - 1)  # the segments of the compacted row
    seg_ok = (torch.arange(ns, device=clean.device)[None, :] < m_seg[:, None])[:, :, None]
    d = torch.where(seg_ok, corr, 0.0).sum(dim=(1, 2)) / (
        m_seg.clamp_min(1).to(torch.float32) * corr.shape[2])
    return torch.where(m_seg >= 1, d, float("nan"))


def stoi_batch(clean: torch.Tensor, deg: torch.Tensor, lengths: torch.Tensor,
               sample_rate: int = 8000) -> torch.Tensor:
    """STOI of each row: clean, deg [B, T] at ``sample_rate``, zero past
    ``lengths`` [B] -> [B] fp32, NaN for a row too short after the 10 kHz
    resample. A row scores what the host scores on the row cut to its length,
    within fp32 rounding."""
    clean, deg = clean.float(), deg.float()
    lengths = lengths.to(device=clean.device, dtype=torch.int64)
    if sample_rate != _FS:
        _, _, orig, new = _resample_kernel(sample_rate, _FS)
        clean = resample_batch(clean, sample_rate, _FS)
        deg = resample_batch(deg, sample_rate, _FS)
        l10 = -torch.div(-lengths * new, orig, rounding_mode="floor")  # ceil
    else:
        l10 = lengths
    # the resample filter's tail past each row's end is not in the cropped row
    keep = torch.arange(clean.shape[1], device=clean.device)[None, :] < l10[:, None]
    clean = torch.where(keep, clean, 0.0)
    deg = torch.where(keep, deg, 0.0)
    if clean.shape[1] < _N_FRAME + _HOP:
        return clean.new_full((clean.shape[0],), float("nan"))
    return _stoi_rows(clean, deg, l10)
