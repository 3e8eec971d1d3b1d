"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with nvcc for
``sm_90a`` into a shared library loaded with ctypes. The build happens at
first use, from the sources in the checkout, into ``tss_dprnn_tpu_torch/_build/``
(listed in .gitignore); the library's file name carries a hash of the source
and of the headers beside it (``csrc/*.cuh``), so an edited kernel is rebuilt.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# where a CUDA toolkit is looked for after $CUDA_HOME and $PATH
CUDA_ROOTS = ("/usr/local/cuda",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[Path, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # library name -> nvcc's output (registers, spills)


def find_nvcc() -> Optional[str]:
    roots = [os.environ.get("CUDA_HOME", "")] + list(CUDA_ROOTS)
    for root in roots:
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    return shutil.which("nvcc")


def load_library(name: str, build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and load it. Raises when nvcc is
    missing or the build fails; there is no fallback."""
    src = CSRC_DIR / f"{name}.cu"
    sources = [src, *sorted(CSRC_DIR.glob("*.cuh"))]  # any source may include any header
    digest = hashlib.sha256(b"".join(f.read_bytes() for f in sources)).hexdigest()[:16]
    so = Path(build_dir) / f"lib{name}-{digest}.so"
    if so in _loaded:
        return _loaded[so]
    if not so.exists():
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                f"nvcc not found: the {name} kernel is built from {src} at first use. "
                "Install the CUDA toolkit or point $CUDA_HOME at it.")
        so.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
        os.close(fd)
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        build_logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {src}:\n{build_logs[name]}")
        os.replace(tmp, so)  # atomic: a concurrent builder sees all or nothing
    _loaded[so] = ctypes.CDLL(str(so))
    return _loaded[so]

