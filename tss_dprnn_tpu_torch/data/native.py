"""ctypes bindings for the native WAV decoder, ``native/wavio.cpp`` (counterpart
of ``tss_dprnn_tpu/data/native.py``).

The library is built with g++ at first use into ``tss_dprnn_tpu_torch/_build/``
(listed in .gitignore), under a name that carries a hash of the source, so an
edited decoder is rebuilt. Where g++ is missing or the build fails, the
numpy reader of ``data/wav.py`` decodes instead; that is logged once. This is
the host's WAV decoder, not a device path.

Every read checks the frames decoded against the frames asked for and raises
:class:`~tss_dprnn_tpu_torch.data.wav.ShortReadError` on a short one.
``read_batch`` decodes a whole batch of crops with a thread pool.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from tss_dprnn_tpu_torch.data.wav import short_read

PKG_DIR = Path(__file__).resolve().parent.parent
SRC = PKG_DIR / "native" / "wavio.cpp"
BUILD_DIR = PKG_DIR / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
logger = logging.getLogger(__name__)


def _build() -> ctypes.CDLL:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libwavio-{digest}.so"
    if not so.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed on {SRC}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent builder sees all or nothing
    lib = ctypes.CDLL(str(so))
    lib.wavio_read.restype = ctypes.c_long
    lib.wavio_read.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                               ctypes.POINTER(ctypes.c_float)]
    lib.wavio_read_batch.restype = ctypes.c_int
    lib.wavio_read_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long), ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_long), ctypes.c_int,
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The decoder library, built at the first call; None where it cannot be
    built (logged once)."""
    global _lib, _build_failed
    if _lib is None and not _build_failed:
        with _lock:
            if _lib is None and not _build_failed:
                try:
                    _lib = _build()
                except (RuntimeError, OSError) as exc:
                    _build_failed = True
                    logger.warning("native WAV decoder unavailable (%s); decoding with numpy",
                                   exc)
    return _lib


def available() -> bool:
    return get_lib() is not None


def read(path: str, start: int, count: int) -> np.ndarray:
    """``count`` frames of channel 0 from frame ``start``, float32 in [-1, 1]."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native WAV decoder is not built")
    out = np.empty(count, np.float32)
    got = lib.wavio_read(path.encode(), start, count,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if got < 0:
        raise IOError(f"wavio_read({path}) failed: {got}")
    if got != count:
        raise short_read(path, start, count, got)
    return out


def read_batch(paths: Sequence[str], starts: Sequence[int], counts: Sequence[int],
               seg_len: int, n_threads: int = 4) -> np.ndarray:
    """Decode ``len(paths)`` crops concurrently -> [n, seg_len] float32, crop
    ``i`` in the first ``counts[i]`` columns of row ``i`` and zeros after."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native WAV decoder is not built")
    n = len(paths)
    if any(c < 0 or c > seg_len for c in counts):
        raise ValueError(f"every count must lie in [0, seg_len={seg_len}]: {list(counts)}")
    out = np.zeros((n, seg_len), np.float32)
    got = np.zeros(n, np.int64)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_starts = (ctypes.c_long * n)(*[int(s) for s in starts])
    c_counts = (ctypes.c_long * n)(*[int(c) for c in counts])
    rc = lib.wavio_read_batch(
        c_paths, c_starts, c_counts, n, seg_len,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        got.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n_threads,
    )
    if rc != 0:
        raise IOError(f"wavio_read_batch failed: {rc}")
    for p, s, c, g in zip(paths, starts, counts, got):
        if g != c:
            raise short_read(p, int(s), int(c), int(g))
    return out
