"""Constant-memory separation of arbitrarily long audio (counterpart of
``tss_dprnn_tpu/inference/long_audio.py``).

One fixed-window forward runs over overlapping windows, and the window
estimates are stitched with weight-normalised crossfades: device memory is
O(window), input length is unbounded, and every forward has the same
``[batch, window]`` shape (ragged tails are padded with zero rows), as the
JAX package's one jitted graph serves every request. The reference has no
equivalent (its eval loop is one full-length forward per utterance,
src/inferencers/inferencer.py:48-78).

BSS outputs are permutation-aligned across windows: a separation model's
source order is arbitrary per forward, so each window's sources are
reordered to best correlate with the running estimate over the overlap
before they are blended in.

The model-backed helpers take a port ``nn.Module`` (weights loaded) and a
device, and run the forward eagerly under ``torch.inference_mode()``: on the
card that is the serving route of the hand-written kernels. One departure
from the JAX package: :func:`bss_windowed` returns the exact fp32 estimates
unless it is asked for the int16 wire (``wire=True``; the JAX default).
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional, Union

import numpy as np
import torch

from tss_dprnn_tpu_torch.device import resolve_device
from tss_dprnn_tpu_torch.ops.rnn import serving_time_major


def _crossfade_weight(window: int, overlap: int) -> np.ndarray:
    """Per-sample blend weight: linear ramps over the overlapped edges,
    1 in the interior. Stitching divides by the accumulated weight, so
    reconstruction is exact wherever window estimates agree (and edge
    windows, covered once, pass through untouched)."""
    w = np.ones(window, np.float32)
    if overlap > 0:
        ramp = np.arange(1, overlap + 1, dtype=np.float32) / (overlap + 1)
        w[:overlap] = ramp
        w[-overlap:] = ramp[::-1]
    return w


def _best_permutation(prev: np.ndarray, cur: np.ndarray) -> tuple:
    """Source order of ``cur`` [n_src, ov] best matching ``prev`` [n_src, ov]
    by summed normalized cross-correlation over the overlap."""
    n = prev.shape[0]
    pn = prev / (np.linalg.norm(prev, axis=-1, keepdims=True) + 1e-12)
    cn = cur / (np.linalg.norm(cur, axis=-1, keepdims=True) + 1e-12)
    score = pn @ cn.T  # [prev_src, cur_src]
    best, best_v = tuple(range(n)), -np.inf
    for p in itertools.permutations(range(n)):
        v = sum(score[j, p[j]] for j in range(n))
        if v > best_v:
            best_v, best = v, p
    return best


class WindowedSeparator:
    """Stream an arbitrarily long waveform through a fixed-window forward.

    ``forward``: callable ``[B, window] float32 -> [B, n_src, window]``
    (see :func:`bss_windowed` / :func:`spe_windowed`). Called with a constant
    batch shape — ragged tails are padded with zero rows.

    ``__call__(mix [T]) -> [n_src, T]``.
    """

    def __init__(self, forward: Callable[[np.ndarray], np.ndarray], window: int,
                 hop: Optional[int] = None, batch_size: int = 8,
                 align_sources: bool = True):
        if hop is None:
            hop = window // 2
        if not 0 < hop <= window:
            raise ValueError(f"hop must be in (0, window], got {hop} vs {window}")
        self.forward = forward
        self.window = int(window)
        self.hop = int(hop)
        self.batch_size = int(batch_size)
        self.align_sources = align_sources

    def _window_starts(self, T: int):
        if T <= self.window:
            return [0]
        starts = list(range(0, T - self.window, self.hop))
        starts.append(T - self.window)  # flush right; stitching renormalizes
        return starts

    def __call__(self, mix: np.ndarray) -> np.ndarray:
        mix = np.asarray(mix, np.float32)
        if mix.ndim != 1:
            raise ValueError(f"mix must be 1-D [T], got shape {mix.shape}")
        T = len(mix)
        W = self.window
        padded_T = max(T, W)
        x = np.zeros(padded_T, np.float32)
        x[:T] = mix
        starts = self._window_starts(padded_T)

        # batched forwards at a constant [batch_size, W] shape
        frames = np.stack([x[s:s + W] for s in starts])
        ests = []
        for i in range(0, len(frames), self.batch_size):
            chunk = frames[i:i + self.batch_size]
            pad = self.batch_size - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad, W), np.float32)])
            out = np.asarray(self.forward(chunk))
            ests.append(out[: len(frames) - i])
        est = np.concatenate(ests)  # [n_win, n_src, W]
        n_src = est.shape[1]

        weight = _crossfade_weight(W, W - self.hop)
        num = np.zeros((n_src, padded_T), np.float32)
        den = np.zeros(padded_T, np.float32)
        for k, s in enumerate(starts):
            e = est[k]
            if self.align_sources and n_src > 1 and k > 0:
                ov_prev = num[:, s:s + W] / np.maximum(den[s:s + W], 1e-12)
                valid = den[s:s + W] > 0
                if valid.any():
                    perm = _best_permutation(ov_prev[:, valid], e[:, valid])
                    e = e[list(perm)]
            num[:, s:s + W] += e * weight
            den[s:s + W] += weight
        return (num / np.maximum(den, 1e-12))[:, :T]


def _wire_decode(pcm, scale) -> np.ndarray:
    return np.asarray(pcm).astype(np.float32) * np.asarray(scale)


def _wire_encode(est: torch.Tensor):
    """The int16 wire on the device (the JAX package's arithmetic,
    ``long_audio.py:151-154``): per row the peak, ``scale = 32767 /
    max(peak, 1e-9)``, the estimate times scale clipped to +-32767 and
    truncated to int16, and the fp32 ``1 / scale``."""
    peak = est.abs().amax(dim=-1, keepdim=True)
    scale = 32767.0 / peak.clamp_min(1e-9)
    return (est * scale).clamp(-32767, 32767).to(torch.int16), (1.0 / scale).float()


def _on_device(model: torch.nn.Module, device) -> torch.device:
    device = resolve_device(device)
    model.to(device).eval()
    return device


def bss_windowed(model: torch.nn.Module, window: int, hop: Optional[int] = None,
                 batch_size: int = 8, device: Optional[Union[str, torch.device]] = None,
                 wire: bool = False) -> WindowedSeparator:
    """WindowedSeparator over a BSS model (``DPRNNTasNet``: ``model(mix) ->
    [B, n_src, T]``), moved to ``device`` (default: the card) in eval mode.

    ``wire``: move the window estimates device->host as int16 PCM and a
    per-row fp32 scale (the JAX package's format, quantization at -96 dBFS)
    instead of fp32, halving that transfer; the default ``False`` is the
    exact fp32 path (the JAX package's default is the wire)."""
    device = _on_device(model, device)

    def forward(mix_batch: np.ndarray) -> np.ndarray:
        with torch.inference_mode(), serving_time_major(model):
            est = model(torch.from_numpy(mix_batch).to(device))
            if not wire:
                return est.float().cpu().numpy()
            pcm, inv_scale = _wire_encode(est)
            return _wire_decode(pcm.cpu().numpy(), inv_scale.cpu().numpy())

    return WindowedSeparator(forward, window, hop, batch_size)


def spe_windowed(model: torch.nn.Module, reference: np.ndarray, ref_len: Optional[float] = None,
                 window: int = 80000, hop: Optional[int] = None, batch_size: int = 8,
                 device: Optional[Union[str, torch.device]] = None) -> WindowedSeparator:
    """WindowedSeparator over a target-speech model (DPRNN-Spe, -IRA or
    -RawNet-TasNet: ``model(mix, aux, aux_len) -> (wav [B, T], logits)``),
    moved to ``device`` (default: the card) in eval mode.

    The speaker reference is embedded per window batch with the same tiled
    waveform — single target, so no cross-window source alignment is needed."""
    device = _on_device(model, device)
    reference = np.asarray(reference, np.float32).ravel()
    if ref_len is None:
        ref_len = float(len(reference))
    aux = torch.from_numpy(np.tile(reference, (batch_size, 1))).to(device)
    aux_len = torch.full((batch_size,), float(ref_len), dtype=torch.float32, device=device)

    def forward(mix_batch: np.ndarray) -> np.ndarray:
        with torch.inference_mode(), serving_time_major(model):
            wav, _ = model(torch.from_numpy(mix_batch).to(device), aux, aux_len)
            return wav.float().cpu().numpy()[:, None, :]

    return WindowedSeparator(forward, window, hop, batch_size, align_sources=False)
