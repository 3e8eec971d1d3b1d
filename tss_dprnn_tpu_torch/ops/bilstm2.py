"""Fused bidirectional LSTM scan: public entries, kernel wrapper and plain
version (counterpart of the bilstm2 section of
``tss_dprnn_tpu/ops/pallas_lstm.py:698-1063``).

Replaces the TPU kernel ``_bilstm2_kernel`` (pallas_lstm.py:698) in its
unmasked and masked inference modes with ``csrc/bilstm2.cu``, CUDA C++ for
``sm_90a``. Both directions run in one launch and both outputs come back in
forward time. Layout and argument order are the JAX entries':
``bilstm2_forward(x [B, T, F], w_ih2 [2, F, 4H], b2 [2, 4H], w_hh2 [2, H, 4H])``.

What bounds the kernel on the H100: fp32 FMAs. A row-step costs
2 (F + H) 4H FLOP per direction against a few hundred bytes of input and
output, far above the card's bandwidth line; the time loop is sequential,
so parallelism comes only from rows and directions. The design (one block
per direction and 32-row tile, h in shared memory, c in registers, the
weights streamed from L2 in double-buffered chunks and reused across the
tile's rows) is the simple one; the source's header gives the details.

On a CPU tensor each entry runs :func:`bilstm2_reference`, the plain PyTorch
version with the same contract. On a CUDA tensor it launches the kernel or
raises. Each entry counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from tss_dprnn_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def bilstm2_reference(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                      w_hh2: torch.Tensor, lens: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: a Python loop over T.

    Per step ``g = x_t @ W_ih + h @ W_hh + b`` in fp32, torch gate order
    i, f, g, o, fp32 c, and h rounded to x's type before it feeds the next
    step. Weights are rounded to x's type first, as the TPU kernel consumes
    them. With ``lens`` direction 1 holds its zero state while t >= len."""
    B, T, _ = x.shape
    H = w_hh2.shape[1]
    dt = x.dtype
    w_ih = w_ih2.to(dt).float()
    w_hh = w_hh2.to(dt).float()
    b = b2.float()
    xf = x.float()
    outs = []
    for d in (0, 1):
        xp = xf @ w_ih[d]  # [B, T, 4H]: the per-step x_t @ W_ih, all steps at once
        h = xf.new_zeros(B, H)
        c = xf.new_zeros(B, H)
        out = x.new_empty(B, T, H)
        for t in (range(T) if d == 0 else range(T - 1, -1, -1)):
            g = xp[:, t] + h @ w_hh[d] + b[d]
            i, f, gg, o = g.split(H, dim=-1)
            i = 1.0 / (1.0 + torch.exp(-i))
            f = 1.0 / (1.0 + torch.exp(-f))
            o = 1.0 / (1.0 + torch.exp(-o))
            c_new = f * c + i * torch.tanh(gg)
            h_new = (o * torch.tanh(c_new)).to(dt).float()
            if lens is not None and d == 1:
                valid = (t < lens)[:, None]
                c = torch.where(valid, c_new, c)
                h = torch.where(valid, h_new, h)
            else:
                c, h = c_new, h_new
            out[:, t] = h.to(dt)
        outs.append(out)
    return outs[0], outs[1]


def _launch(entry, x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
            w_hh2: torch.Tensor, lens: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check what the kernel takes, allocate the outputs and launch on the
    current stream; a launch adds one to ``entry.launches``. Raises on
    anything the kernel does not take."""
    if not x.is_cuda:
        raise ValueError(f"bilstm2 kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"bilstm2 kernel streams float32 or bfloat16, got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"x must be [B, T, F], got {tuple(x.shape)}")
    B, T, F = x.shape
    H = w_hh2.shape[1]
    if w_ih2.shape != (2, F, 4 * H) or w_hh2.shape != (2, H, 4 * H) or b2.shape != (2, 4 * H):
        raise ValueError(
            f"weights must be w_ih2 [2, {F}, 4H], w_hh2 [2, H, 4H], b2 [2, 4H]; got "
            f"{tuple(w_ih2.shape)}, {tuple(w_hh2.shape)}, {tuple(b2.shape)}")
    if F % 16 or H % 16 or not 16 <= H <= 128:
        raise ValueError(f"bilstm2 kernel needs F, H multiples of 16 and H <= 128; F={F} H={H}")
    if T * max(F, H) >= 2 ** 31:  # the kernel's offsets within a row are 32-bit
        raise ValueError(f"bilstm2 kernel needs T * max(F, H) < 2^31; T={T}")
    tensors = [w_ih2, w_hh2, b2] + ([] if lens is None else [lens])
    if any(t.device != x.device for t in tensors):
        raise ValueError("bilstm2: x, weights and lens must be on one device")
    x = x.contiguous()
    # the kernel reads fp32 weights holding values of the stream type; for
    # fp32 weights and streams these are no-ops
    w_ih2 = w_ih2.to(x.dtype).float().contiguous()
    w_hh2 = w_hh2.to(x.dtype).float().contiguous()
    b2 = b2.float().contiguous()
    if lens is not None:
        if lens.shape != (B,):
            raise ValueError(f"lens must be [B]={B}, got {tuple(lens.shape)}")
        lens = lens.to(torch.int32).contiguous()
    # 16-byte copies and stores: a view that starts mid-row would fault
    for name, t in (("x", x), ("w_ih2", w_ih2), ("w_hh2", w_hh2), ("b2", b2)):
        if t.data_ptr() % 16:
            raise ValueError(f"bilstm2 kernel needs {name} 16-byte aligned; pass a copy")
    out0 = torch.empty(B, T, H, dtype=x.dtype, device=x.device)
    out1 = torch.empty_like(out0)
    if B == 0 or T == 0:
        return out0, out1
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.bilstm2_forward(
            _DTYPE_CODES[x.dtype], x.data_ptr(), w_ih2.data_ptr(), w_hh2.data_ptr(),
            b2.data_ptr(), None if lens is None else lens.data_ptr(), out0.data_ptr(),
            out1.data_ptr(), B, T, F, H, stream)
    if rc != 0:
        raise RuntimeError(f"bilstm2 kernel launch failed: "
                           f"{lib.bilstm2_error_string(rc).decode()} ({rc})")
    entry.launches += 1
    return out0, out1


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library, with its C
    signatures set once."""
    lib = _build.load_library("bilstm2")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bilstm2_forward.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.bilstm2_forward.restype = i
    lib.bilstm2_error_string.argtypes = [i]
    lib.bilstm2_error_string.restype = ctypes.c_char_p
    return lib


def bilstm2_forward(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                    w_hh2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference: x [B, T, F] -> (out0, out1), each [B, T, H], both in
    forward time."""
    if x.device.type == "cpu":
        return bilstm2_reference(x, w_ih2, b2, w_hh2)
    return _launch(bilstm2_forward, x, w_ih2, b2, w_hh2, None)


def bilstm2_forward_masked(x: torch.Tensor, lens: torch.Tensor, w_ih2: torch.Tensor,
                           b2: torch.Tensor, w_hh2: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask-aware inference: x [B, T, F], lens [B] -> (out0, out1), each
    [B, T, H], both in forward time. Direction 1 holds its zero state while
    t >= lens[row], so its first real step reads x[len - 1] and
    out1[t >= len] = 0; out0[t >= len] is unspecified (finite)."""
    if x.device.type == "cpu":
        return bilstm2_reference(x, w_ih2, b2, w_hh2, lens)
    return _launch(bilstm2_forward_masked, x, w_ih2, b2, w_hh2, lens)


bilstm2_forward.launches = 0
bilstm2_forward_masked.launches = 0


def launch_count() -> int:
    """Kernel launches of both entries since their counts were last zeroed."""
    return bilstm2_forward.launches + bilstm2_forward_masked.launches


def reset_launch_counts() -> None:
    bilstm2_forward.launches = 0
    bilstm2_forward_masked.launches = 0
