"""Minimal RIFF/WAVE I/O on numpy (counterpart of
``tss_dprnn_tpu/data/wav.py``): PCM16 / PCM24 / PCM32 / IEEE float32, partial
reads of frame ranges without reading the whole file.

One deliberate difference from the JAX package: a read that yields fewer
frames than it asked for raises :class:`ShortReadError`, naming the file.
That covers a file cut short (its header promises more data than it holds)
and a range past the end of the data; the JAX reader returns the frames it
found, and its batch decoder zero-pads them.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np


class WavFormatError(ValueError):
    pass


class ShortReadError(IOError):
    """A WAV read returned fewer frames than requested."""


def short_read(path: str, start: int, want: int, got: int) -> ShortReadError:
    return ShortReadError(f"{path}: asked for {want} frames from frame {start}, "
                          f"the file holds {got} there (truncated file or a range past its end)")


def _find_chunks(f) -> Tuple[dict, int, int]:
    """Parse RIFF headers; returns (fmt dict, data_offset, data_size)."""
    head = f.read(12)
    if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
        raise WavFormatError("not a RIFF/WAVE file")
    fmt = None
    data_off = data_size = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"fmt ":
            blob = f.read(size)
            (audio_fmt, n_ch, sr, _, block_align, bits) = struct.unpack("<HHIIHH", blob[:16])
            if audio_fmt == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                audio_fmt = struct.unpack("<H", blob[24:26])[0]
            fmt = dict(fmt=audio_fmt, channels=n_ch, rate=sr, block=block_align, bits=bits)
        elif cid == b"data":
            data_off = f.tell()
            data_size = size
            f.seek(size + (size & 1), 1)
        else:
            f.seek(size + (size & 1), 1)
        if fmt is not None and data_off is not None:
            break
    if fmt is None or data_off is None:
        raise WavFormatError("missing fmt/data chunk")
    return fmt, data_off, data_size


def info(path: str) -> dict:
    """{'rate', 'channels', 'frames'} from the header, without reading samples."""
    with open(path, "rb") as f:
        fmt, _, data_size = _find_chunks(f)
    return dict(rate=fmt["rate"], channels=fmt["channels"], frames=data_size // fmt["block"])


def read(path: str, start: int = 0, stop: Optional[int] = None, dtype=np.float32,
         prefer_native: bool = True):
    """Read frames [start, stop) (``stop=None``: to the end the header gives)
    as float32 in [-1, 1]; returns (data, rate). Mono files give [T];
    multichannel [T, C]. Raises :class:`ShortReadError` when the file holds
    fewer frames than that.

    Mono files go through the native decoder (data/native.py) when it is
    built; the numpy path below is the reference implementation."""
    with open(path, "rb") as f:
        fmt, data_off, data_size = _find_chunks(f)
        n_frames = data_size // fmt["block"]
        stop = n_frames if stop is None else stop
        count = max(stop - start, 0)
        if prefer_native and fmt["channels"] == 1:
            from tss_dprnn_tpu_torch.data import native

            if native.available():
                return native.read(path, start, count).astype(dtype, copy=False), fmt["rate"]
        f.seek(data_off + start * fmt["block"])
        raw = f.read(min(count, max(n_frames - start, 0)) * fmt["block"])
    if len(raw) != count * fmt["block"]:
        raise short_read(path, start, count, len(raw) // fmt["block"])
    n_ch, bits, afmt = fmt["channels"], fmt["bits"], fmt["fmt"]
    if afmt == 1:  # PCM
        if bits == 16:
            data = np.frombuffer(raw, "<i2").astype(dtype) / 32768.0
        elif bits == 32:
            data = np.frombuffer(raw, "<i4").astype(dtype) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            as32 = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            as32 = (as32 << 8) >> 8  # sign-extend
            data = as32.astype(dtype) / 8388608.0
        elif bits == 8:
            data = (np.frombuffer(raw, np.uint8).astype(dtype) - 128.0) / 128.0
        else:
            raise WavFormatError(f"unsupported PCM bit depth {bits}")
    elif afmt == 3:  # IEEE float
        data = np.frombuffer(raw, "<f4" if bits == 32 else "<f8").astype(dtype)
    else:
        raise WavFormatError(f"unsupported WAVE format code {afmt}")
    if n_ch > 1:
        data = data.reshape(-1, n_ch)
    return data, fmt["rate"]


def write(path: str, data: np.ndarray, rate: int, bits: int = 16) -> None:
    """Write mono/multichannel float data as PCM16 (default) or float32."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    n_frames, n_ch = data.shape
    if bits == 16:
        payload = np.clip(np.round(data * 32767.0), -32768, 32767).astype("<i2").tobytes()
        afmt, block = 1, 2 * n_ch
    elif bits == 32:
        payload = data.astype("<f4").tobytes()
        afmt, block = 3, 4 * n_ch
    else:
        raise WavFormatError("write supports bits=16 (PCM) or 32 (float)")
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, afmt, n_ch, rate, rate * block, block, bits))
        f.write(b"data" + struct.pack("<I", len(payload)))
        f.write(payload)
