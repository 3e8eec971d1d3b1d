"""PESQ on the device, batched over rows (counterpart of
``tss_dprnn_tpu/ops/pesq_jax.py``).

The P.862 chain of the host ``ops/pesq.py`` for a batch of zero-padded rows
with their true lengths, with the JAX package's design: level alignment and
the receive filter in one rfft/irfft pair per row on the padded length, the
two-stage delay search (coarse argmax over the 4 ms-envelope correlation,
fine argmax over +-1.5 blocks of one full-rate FFT correlation), the
Bark-band perceptual model, disturbance processing and the L6/L2
aggregation, with every row's length a mask.

Where the JAX package runs a ``lax.scan``, the short-term gain smoother
(g_t = 0.8 g_(t-1) + 0.2 r_t from g_0 = r_0, one step per frame) is its
closed form in float64 over 64-frame blocks: within a block a
lower-triangular Toeplitz product, across blocks the carry's own closed
form, two products in all and no loop over frames. 0.8^64 = 6.3e-7, so no
coefficient overflows, and the ones that underflow weigh under 1e-300: the
result is the recurrence's up to float64 rounding (about 1e-15 relative),
then cast to fp32. The other contractions (band sums) also run in float64,
so no TF32 setting changes a score; the rest is fp32. Per-row shifts are
gathers on ``(t + delay) mod T``.

Divergences from the host chain are those of the JAX package: the filters
and the level-align band power act on the padded length's frequency grid,
and the arithmetic is fp32 (|delta MOS| under 0.05 against the host, the
JAX package's bar). Rows shorter than 0.25 s score NaN.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from tss_dprnn_tpu_torch.ops.pesq import (_ASYM_OFFSET, _D_WEIGHT, _DA_WEIGHT,
                                          _DATA_PADDING_SEC, _FREQ_COMP_OFFSET, _GAIN_OFFSET,
                                          _IRS_RECEIVE_DB, _LISTENING_LEVEL_DB, _LOUDNESS_SCALE,
                                          _TARGET_POWER, _ZWICKER_POWER, _band_layout)
from tss_dprnn_tpu_torch.ops.stoi import _mm64

_SMOOTH_BLOCK = 64


@lru_cache(maxsize=8)
def _consts(fs: int, T: int, mode: str, device: torch.device):
    """The constants of one (rate, padded length, mode) on ``device``."""
    bin_band, _, width_bark, abs_thresh, n_bands = _band_layout(fs)
    nf = 256 if fs == 8000 else 512
    # the receive filter's gains on the padded length's rfft grid
    f = np.maximum(np.fft.rfftfreq(T, 1.0 / fs), 1.0)
    bp = _IRS_RECEIVE_DB if mode == "nb" else np.array(
        [(8.0, -200.0), (50.0, -40.0), (100.0, 0.0), (8000.0, 0.0)])
    gain_db = np.interp(np.log(f), np.log(bp[:, 0]), bp[:, 1])
    irs_gain = 10.0 ** (gain_db / 20.0)
    fr = np.fft.rfftfreq(T, 1.0 / fs)
    level_mask = (fr >= 350.0) & (fr <= 3250.0)
    # rfft of a real signal counts each interior bin twice (Parseval)
    parseval = np.ones(T // 2 + 1)
    parseval[0] = 0.5
    if T % 2 == 0:
        parseval[-1] = 0.5
    n_bins = nf // 2 + 1
    grouping = np.zeros((n_bins, int(n_bands)))
    valid = bin_band >= 0
    grouping[np.arange(n_bins)[valid], bin_band[valid]] = 1.0
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(nf) / nf))

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return dict(irs_gain=f32(irs_gain), level=f32(level_mask * parseval),
                grouping=torch.tensor(grouping, dtype=torch.float64, device=device),
                win=f32(win), power_scale=2.0 / (nf * float(np.sum(win ** 2))),
                width=f32(width_bark / width_bark.sum()),
                abs_thresh=f32(abs_thresh))


@lru_cache(maxsize=8)
def _smoother(n_blocks: int, device: torch.device):
    """The gain smoother's closed form over 64-frame blocks, float64:
    (A [L, L], pw [L], Q [n_blocks, n_blocks + 1]) with A[j, k] = 0.2 0.8^(j-k)
    (k <= j), pw[j] = 0.8^(j+1), and Q the carries' weights: the carry out of
    block b is Q[b, 0] g_(-1) + sum_c Q[b, c+1] (A r_c)[L-1]."""
    L = _SMOOTH_BLOCK
    j = torch.arange(L, dtype=torch.float64)
    d = j[:, None] - j[None, :]
    A = torch.where(d >= 0, 0.2 * 0.8 ** d.clamp_min(0), 0.0)
    q = 0.8 ** L
    b = torch.arange(n_blocks, dtype=torch.float64)
    e = b[:, None] - b[None, :]
    Q = torch.cat([(q ** (b + 1))[:, None], torch.where(e >= 0, q ** e.clamp_min(0), 0.0)], 1)
    return A.to(device), (0.8 ** (j + 1)).to(device), Q.to(device)


def _smooth_gain(ratio: torch.Tensor) -> torch.Tensor:
    """[B, N] -> g [B, N] of g_t = 0.8 g_(t-1) + 0.2 r_t, g_0 = r_0 (that is,
    g_(-1) = r_0), unclipped, in float64 and returned as fp32."""
    B, N = ratio.shape
    L = _SMOOTH_BLOCK
    nb = -(-N // L)
    A, pw, Q = _smoother(nb, ratio.device)
    r = torch.nn.functional.pad(ratio.double(), (0, nb * L - N)).reshape(B, nb, L)
    local = r @ A.T  # [B, nb, L]: each block from a zero carry
    # carries out of each block, then the carry into each block
    out = torch.cat([r[:, :1, 0], local[:, :, -1]], dim=1) @ Q.T  # [B, nb]
    carry_in = torch.cat([r[:, :1, 0], out[:, :-1]], dim=1)  # g_(-1) = r_0 into block 0
    g = local + carry_in[:, :, None] * pw
    return g.reshape(B, nb * L)[:, :N].float()


def _frames_hop_half(x: torch.Tensor, nf: int) -> torch.Tensor:
    """[B, T] -> [B, n, nf] frames at hop nf/2 from two interleaved reshapes."""
    hop = nf // 2
    n = (x.shape[1] - nf) // hop + 1
    a = x[:, : (n + 1) * hop].reshape(x.shape[0], n + 1, hop)
    return torch.cat([a[:, :-1], a[:, 1:]], dim=-1)


def _align_and_filter(x: torch.Tensor, l: torch.Tensor, c) -> torch.Tensor:
    """Level alignment (350-3250 Hz band power to the target) and the receive
    filter, one rfft/irfft pair per row."""
    T = x.shape[1]
    spec = torch.fft.rfft(x, dim=1)
    p_band = spec.real ** 2 + spec.imag ** 2
    p = 2.0 * (p_band * c["level"]).sum(dim=1) / (T * l.clamp_min(1.0))
    s = torch.sqrt(_TARGET_POWER / (p + 1e-20))
    return torch.fft.irfft(spec * (s[:, None] * c["irs_gain"]), T, dim=1)


def _estimate_delay(ref: torch.Tensor, deg: torch.Tensor, l: torch.Tensor, fs: int
                    ) -> torch.Tensor:
    """The constant delay of each row, as ``ops/pesq._estimate_delay`` finds
    it on the row cut to its length: [B] int64 samples."""
    block = fs // 250
    B, T = ref.shape
    dev = ref.device
    M = T // block
    n_blk = torch.div(l, block, rounding_mode="floor")  # whole blocks of the row
    env_r = ref[:, : M * block].abs().reshape(B, M, block).sum(-1)
    env_d = deg[:, : M * block].abs().reshape(B, M, block).sum(-1)
    bvalid = torch.arange(M, device=dev)[None, :] < n_blk[:, None]
    nb = n_blk.clamp_min(1).to(torch.float32)[:, None]
    env_r = torch.where(bvalid, env_r - (env_r * bvalid).sum(1, keepdim=True) / nb, 0.0)
    env_d = torch.where(bvalid, env_d - (env_d * bvalid).sum(1, keepdim=True) / nb, 0.0)
    size = 2 ** int(math.ceil(math.log2(2 * M)))
    xc = torch.fft.irfft(torch.fft.rfft(env_d, size) * torch.conj(torch.fft.rfft(env_r, size)),
                         size)
    # circular lags [0 .. M-1, -(size-M) .. -1], |lag| below the row's blocks
    lags = torch.cat([torch.arange(M, device=dev), torch.arange(-(size - M), 0, device=dev)])
    ok = lags.abs()[None, :] < n_blk.clamp_min(1)[:, None]
    coarse = lags[torch.where(ok, xc, -torch.inf).argmax(dim=1)] * block  # first maximum

    # fine: +-1.5 blocks around coarse in one full-rate correlation, linear
    # for every admissible lag (size >= 2T)
    n = n_blk * block
    size2 = 2 ** int(math.ceil(math.log2(2 * T)))
    inside = torch.arange(T, device=dev)[None, :] < n[:, None]
    cc = torch.fft.irfft(
        torch.fft.rfft(torch.where(inside, deg, 0.0), size2)
        * torch.conj(torch.fft.rfft(torch.where(inside, ref, 0.0), size2)), size2)
    w = torch.arange(-(block + block // 2), block + block // 2 + 1, device=dev)
    lag_w = coarse[:, None] + w[None, :]
    vals = cc.gather(1, torch.remainder(lag_w, size2))  # floor modulo, as jnp.mod
    okf = (n[:, None] - lag_w.abs()) >= block
    fine = lag_w.gather(1, torch.where(okf, vals, -torch.inf).argmax(dim=1, keepdim=True))[:, 0]
    return torch.where(okf.any(dim=1), fine, coarse)


def _apply_delay(deg: torch.Tensor, delay: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Each row shifted left by its delay within its length, zero elsewhere:
    a gather on (t + delay) mod T, then the host's window [lo, hi)."""
    T = deg.shape[1]
    t = torch.arange(T, device=deg.device)[None, :]
    rolled = deg.gather(1, torch.remainder(t + delay[:, None], T))
    lo = (-delay).clamp_min(0)[:, None]
    hi = (l - delay.clamp_min(0))[:, None]
    return torch.where((t >= lo) & (t < hi), rolled, 0.0)


def _pitch_powers(x: torch.Tensor, c, nf: int) -> torch.Tensor:
    frames = _frames_hop_half(x, nf) * c["win"]
    spec = torch.fft.rfft(frames, dim=-1)
    p = (spec.real ** 2 + spec.imag ** 2) * c["power_scale"]
    return _mm64(p, c["grouping"]) * (10.0 ** (_LISTENING_LEVEL_DB / 10.0) / _TARGET_POWER)


def _total_audible(pp: torch.Tensor, abs_thresh: torch.Tensor) -> torch.Tensor:
    return torch.where(pp > abs_thresh, pp, 0.0).sum(-1)


def _loudness(pp: torch.Tensor, abs_thresh: torch.Tensor) -> torch.Tensor:
    s = (_LOUDNESS_SCALE * (abs_thresh / 0.5) ** _ZWICKER_POWER
         * ((0.5 + 0.5 * pp / abs_thresh) ** _ZWICKER_POWER - 1.0))
    return torch.where(pp > abs_thresh, s, 0.0)


def _aggregate(x: torch.Tensor, n_frames: torch.Tensor) -> torch.Tensor:
    """L6 over 20-frame windows at hop 10 (a window past the row's frames is
    cut there, as the host slices), then L2 over the windows that start
    before the last 9 frames. x [B, N], zero past each row's frames."""
    B, N = x.shape
    dev = x.device
    W = max(1, -(-max(1, N - 9) // 10))
    starts = 10 * torch.arange(W, device=dev)
    offs = starts[:, None] + torch.arange(20, device=dev)[None, :]  # [W, 20]
    xw = torch.where(offs < N, x[:, offs.clamp_max(N - 1)], 0.0)  # [B, W, 20]
    cnt = torch.minimum(torch.full_like(starts, 20)[None, :],
                        n_frames[:, None] - starts[None, :]).clamp_min(1)
    l6 = (xw.pow(6.0).sum(-1) / cnt.to(torch.float32)) ** (1.0 / 6.0)
    wvalid = starts[None, :] < (n_frames - 9).clamp_min(1)[:, None]
    nw = wvalid.sum(1).to(torch.float32).clamp_min(1.0)
    return torch.sqrt(torch.where(wvalid, l6.square(), 0.0).sum(1) / nw)


def _pesq_rows(ref: torch.Tensor, deg: torch.Tensor, l: torch.Tensor, fs: int, mode: str
               ) -> torch.Tensor:
    B, T = ref.shape
    c = _consts(fs, T, mode, ref.device)
    lf = l.to(torch.float32)
    t = torch.arange(T, device=ref.device)[None, :]
    keep = t < l[:, None]
    # the circular filter rings a little into the padding: zero it again
    ref = torch.where(keep, _align_and_filter(ref, lf, c), 0.0)
    deg = torch.where(keep, _align_and_filter(deg, lf, c), 0.0)
    deg = _apply_delay(deg, _estimate_delay(ref, deg, l, fs), l)

    nf = 256 if fs == 8000 else 512
    hop = nf // 2
    abs_thresh = c["abs_thresh"]
    pp_ref = _pitch_powers(ref, c, nf)  # [B, N, bands]
    pp_deg = _pitch_powers(deg, c, nf)
    N = pp_ref.shape[1]
    # the host's frames: the row's own plus 0.32 s of zeros (zero here too)
    n_frames = torch.div(l + int(_DATA_PADDING_SEC * fs) - nf, hop,
                         rounding_mode="floor").add(1).clamp_max(N)
    fvalid = torch.arange(N, device=ref.device)[None, :] < n_frames[:, None]

    total_ref = _total_audible(pp_ref, abs_thresh)
    silent_thr = 10.0 ** ((_LISTENING_LEVEL_DB - 35.0) / 10.0)
    speech = fvalid & (total_ref >= silent_thr)
    n_speech = speech.sum(1).to(torch.float32)
    ns = n_speech.clamp_min(1.0)[:, None]
    avg_ref = torch.where(speech[:, :, None], pp_ref, 0.0).sum(1) / ns
    avg_deg = torch.where(speech[:, :, None], pp_deg, 0.0).sum(1) / ns
    band_ratio = ((avg_deg + _FREQ_COMP_OFFSET) / (avg_ref + _FREQ_COMP_OFFSET)).clamp(0.01, 100.0)
    pp_ref_c = pp_ref * band_ratio[:, None, :]

    ratio = ((_total_audible(pp_ref_c, abs_thresh) + _GAIN_OFFSET)
             / (_total_audible(pp_deg, abs_thresh) + _GAIN_OFFSET))
    pp_deg_c = pp_deg * _smooth_gain(ratio).clamp(3e-4, 5.0)[:, :, None]

    loud_ref = _loudness(pp_ref_c, abs_thresh)
    loud_deg = _loudness(pp_deg_c, abs_thresh)
    d = loud_deg - loud_ref
    m = 0.25 * torch.minimum(loud_deg, loud_ref)
    d = torch.sign(d) * (d.abs() - m).clamp_min(0.0)
    asym = ((pp_deg_c + _ASYM_OFFSET) / (pp_ref_c + _ASYM_OFFSET)) ** 1.2
    asym = torch.where(asym < 3.0, 0.0, asym.clamp_max(12.0))

    wn = c["width"]
    d_frame = (wn * d.abs() ** 3.0).sum(-1) ** (1.0 / 3.0)
    da_frame = (wn * d.abs() * asym).sum(-1)
    h = ((total_ref + 1e5) / 10.0 ** (_LISTENING_LEVEL_DB / 10.0)) ** 0.04
    d_frame = torch.where(fvalid, (d_frame / h).clamp_max(45.0), 0.0)
    da_frame = torch.where(fvalid, (da_frame / h).clamp_max(45.0), 0.0)

    any_speech = n_speech > 0
    D = torch.where(any_speech, _aggregate(d_frame, n_frames), 0.0)
    DA = torch.where(any_speech, _aggregate(da_frame, n_frames), 0.0)
    raw = (4.5 - _D_WEIGHT * D - _DA_WEIGHT * DA).clamp(-0.5, 4.5)
    if mode == "nb":
        return 0.999 + 4.0 / (1.0 + torch.exp(-1.4945 * raw + 4.6607))
    return 0.999 + 4.0 / (1.0 + torch.exp(-1.3669 * raw + 3.8224))


def pesq_batch(ref: torch.Tensor, deg: torch.Tensor, lengths: torch.Tensor, fs: int = 8000,
               mode: str = "nb") -> torch.Tensor:
    """PESQ (MOS-LQO) of each row: ref, deg [B, T] at ``fs``, zero past
    ``lengths`` [B] -> [B] fp32, NaN for a row under 0.25 s (where the host
    raises). 'nb' at 8 kHz, 'wb' at 16 kHz."""
    if mode not in ("nb", "wb"):
        raise ValueError(f"mode must be 'nb' or 'wb', got {mode!r}")
    if fs not in (8000, 16000):
        raise ValueError(f"fs must be 8000 or 16000, got {fs}")
    if mode == "wb" and fs != 16000:
        raise ValueError("wideband PESQ requires fs=16000")
    lengths = lengths.to(device=ref.device, dtype=torch.int64)
    T = ref.shape[1]
    nf = 256 if fs == 8000 else 512
    Tp = T + int(_DATA_PADDING_SEC * fs)
    Tp = -(-(Tp - nf) // (nf // 2)) * (nf // 2) + nf  # on the frame grid
    keep = torch.arange(Tp, device=ref.device)[None, :] < lengths[:, None]
    ref, deg = (torch.where(keep, torch.nn.functional.pad(x.float(), (0, Tp - T)), 0.0)
                for x in (ref, deg))
    out = _pesq_rows(ref, deg, lengths, fs, mode)
    return torch.where(lengths >= fs // 4, out, float("nan"))
