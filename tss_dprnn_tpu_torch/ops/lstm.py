"""LSTM scan over stacked directions and its backward: public entries, kernel
wrappers and plain versions (counterpart of the ``_lstm_kernel``,
``_lstm_manual_kernel`` and ``_lstm_bwd_kernel`` sections of
``tss_dprnn_tpu/ops/pallas_lstm.py:57-465, 498-669``).

Replaces the TPU kernel ``_lstm_kernel`` (pallas_lstm.py:57) in its h-only
and ``want_resid`` modes (fp32 and bf16 streams) with the input product of
``csrc/products.cu`` followed by the cluster scans of
``csrc/bilstm2_serve.cu`` and ``csrc/bilstm2_resid.cu`` (the fused
bidirectional LSTM's, which take D stacked directions too; bf16
``want_resid`` runs the serving scan's bf16 training mode after the
bf16-operand input product), in its
``reverse_dir1`` mode with the fused pair's serving route (its outputs side
by side), in its ``want_cs`` mode (fp32 and bf16) with ``csrc/lstm.cu``,
``_lstm_manual_kernel`` (pallas_lstm.py:275) with the h-only route (its
bf16 streams through the bf16-operand input product and the serving scan's
rounding of that kernel), and ``_lstm_bwd_kernel`` (pallas_lstm.py:498,
fp32 and bf16) with ``csrc/lstm_bwd.cu``, CUDA C++ for
``sm_90a``. D directions run in one
launch, each on its own input and each in forward time: a caller that wants
a reversed direction flips its input, as the JAX entries' callers do. With
D = 1 this is the unidirectional inter-chunk scan of a causal DPRNN
(``bidirectional: false``). Argument order is the JAX entries'; the layout
is the port's own, batch-major with no time or row padding::

    lstm_forward(x [D, R, T, F], w_ih [D, F, 4H], b [D, 4H], w_hh [D, H, 4H])
        -> h [D, R, T, H]

The JAX package's test-only entries keep their own argument order (x, w_ih,
w_hh, b): :func:`lstm_scan` (``lstm_scan_pallas`` :148, the h-only mode
again), :func:`bilstm_fused` (``bilstm_pallas_fused`` :171: two directions on
one shared x [R, T, F], direction 1 reversed inside the kernel, outputs
concatenated to [R, T, 2H]), and the manual-DMA kernel's two entries
:func:`lstm_scan_v2` (:418, stacked) and :func:`bilstm_v2` (:402, shared and
reversed), which compute the same function but, in a 16-bit stream type,
round where that TPU kernel rounds (:func:`lstm_v2_reference`). On the card
all but :func:`lstm_scan` take bf16 x as it is to the bf16-operand input
product. :func:`bilstm_fused` and :func:`bilstm_v2` run the fused pair's
serving route with its two outputs written side by side: ``bilstm_fused``
is ``bilstm2_forward`` (fp32) or ``bilstm2_forward_bm`` (bf16) with that
output stride, bit for bit, since ``_lstm_kernel`` rounds as
``_bilstm2_kernel`` does; ``bilstm_v2`` in bf16 with the serving scan's
rounding of the manual-DMA kernel. :func:`lstm_scan_v2` runs the stack's
h-only route with that rounding.

The residual streams are a tuple ``(hp, cp, tc, pre)``: h and c before each
step and tanh(c) after it, [D, R, T, H] in the stream type (fp32 or bf16,
rounded where the TPU kernel's bf16 mode rounds), and the gate pre-activations
``x_t @ W_ih + h_prev @ W_hh + b`` of every row-step, [D, R, T, 4H] fp32, so
that the backward recomputes no gate. There are no lengths:
steps past a row's valid length compute on whatever the input holds, and the
consumer masks them (the DPRNN block's masked norm does, and its zero
cotangent there keeps the backward exact).

What bounds the kernels on the H100: the arithmetic, 2 (F + H) 4H FLOP per
row-step and direction forward and twice that backward. The h-only and
residual forwards split the work by what is sequential, as the fused pair's do
(``ops/bilstm2.py``): per direction one launch of the 3xTF32 product kernel
computes the input half of every gate at once, P[d] = x[d] @ W_ih[d] + b[d]
into a [D, R, T, 4H] fp32 buffer (bf16 h-only x upcast, exactly; the bf16
residual mode's x through the bf16-operand product as it is), then one launch
of a recurrent scan over all D directions (2-CTA clusters, each CTA holding
half of W_hh[d] in shared memory for the whole scan, the tile height from
:func:`plan_tiles`) adds h @ W_hh step by step: the serving scan (on the
tensor cores, 3xTF32 or one bf16 product) reads P and writes only h; the
training forward's scan writes the full gate pre-activations back into the
buffer, which is the saved ``pre``, and the other residual streams. The
``want_cs`` mode keeps the first design (``csrc/lstm.cu``): 16-row tiles,
W = [W_ih; W_hh] streamed from L2 every step. The backward splits the work in two: the scan of
``csrc/lstm_bwd.cu`` (2-CTA clusters holding W_hh^T in shared memory) turns
the saved pre-activations and the carried dh/dc into dpre, then the 3xTF32
product and column-sum kernels of ``csrc/products.cu`` give dx (per
direction) and the fixed partials of dW and db, summed here in a fixed
order (no atomics: a run repeats itself bit for bit); bf16 streams run the
scan's bf16 mode (dpre @ W_hh^T in bf16 mma.sync, dpre stored bf16) and the
bf16-operand products on x, hp and dpre as they are (dx with a bf16
output, dW in the column layout). The cluster scans take
D <= 2 on the card. As in ``ops/bilstm2.py``, the wrappers zero-pad F and H
to multiples of 16 (``bilstm2.padded``, ``bilstm2.padded_backward``) and cut
the pad off what they return.

On a CPU tensor each entry runs its plain PyTorch version
(:func:`lstm_reference`, :func:`lstm_cs_reference`,
:func:`lstm_resid_reference`, :func:`bilstm_fused_reference`,
:func:`lstm_v2_reference`, :func:`bilstm_v2_reference`,
:func:`lstm_backward_reference`) with the same contract. On a CUDA tensor it launches the kernel or raises. Each entry
counts its launches in ``.launches`` (one per call that launched its kernels).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from tss_dprnn_tpu_torch.ops import _build
from tss_dprnn_tpu_torch.ops.bilstm2 import (
    _DTYPE_CODES,
    _V2_CODE,
    BWD_BF16_HEIGHTS,
    TILE_HEIGHTS,
    Grads,
    TilePlan,
    _check_aligned,
    _colsum,
    _gates,
    _gemm,
    _gemm_bf16,
    _gemm_bf16_col,
    _launch_serve,
    _library_products,
    _library_resid,
    _library_serve,
    _plan,
    _raise_on,
    _row_sum,
    bwd_weight_layout_bf16,
    padded,
    padded_backward,
    plan_tiles,
    resid_weight_layout,
    serve_weight_layout,
    serve_weight_layout_bf16,
)

Resid = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

_MODE_H, _MODE_CS, _MODE_RESID = 0, 1, 2
# extra fp32 streams per mode, by their width in units of H
_STREAM_WIDTHS = {_MODE_H: (), _MODE_CS: (1,), _MODE_RESID: (1, 1, 1, 4)}


def _scan_reference(x, w_ih, b, w_hh, mode: int):
    D, R, T, _ = x.shape
    H = w_hh.shape[1]
    dt = x.dtype
    w_ih = w_ih.to(dt).float()
    w_hh = w_hh.to(dt).float()
    b = b.float()
    xf = x.float()
    xp = torch.einsum("drtf,dfg->drtg", xf, w_ih)  # x_t @ W_ih, all steps at once
    h = xf.new_zeros(D, R, H)
    c = xf.new_zeros(D, R, H)
    out = x.new_empty(D, R, T, H)
    # the residual mode's h, c and tanh(c) in the stream type (a bf16 store
    # rounds c and tanh(c)); the cell states of want_cs and pre fp32
    streams = [(x if mode == _MODE_RESID and n == 1 else xf).new_empty(D, R, T, n * H)
               for n in _STREAM_WIDTHS[mode]]
    for t in range(T):
        g = xp[:, :, t] + torch.bmm(h, w_hh) + b[:, None]
        i, f, gg, o = _gates(g, H)
        c_new = f * c + i * gg
        tc = torch.tanh(c_new)
        if mode == _MODE_RESID:
            for stream, v in zip(streams, (h, c, tc, g)):
                stream[:, :, t] = v
        elif mode == _MODE_CS:
            streams[0][:, :, t] = c_new
        c, h = c_new, (o * tc).to(dt).float()
        out[:, :, t] = h.to(dt)
    return out, tuple(streams)


def lstm_reference(x: torch.Tensor, w_ih: torch.Tensor, b: torch.Tensor,
                   w_hh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: a Python loop over T, all
    directions at once. Per step ``g = x_t @ W_ih + h @ W_hh + b`` in fp32,
    torch gate order i, f, g, o, fp32 c, and h rounded to x's type before it
    feeds the next step. Weights are rounded to x's type first, as the TPU
    kernel consumes them."""
    return _scan_reference(x, w_ih, b, w_hh, _MODE_H)[0]


def lstm_cs_reference(x: torch.Tensor, w_ih: torch.Tensor, b: torch.Tensor,
                      w_hh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``want_cs`` mode: :func:`lstm_reference`'s h and
    the fp32 cell state after every step, [D, R, T, H]."""
    out, (cs,) = _scan_reference(x, w_ih, b, w_hh, _MODE_CS)
    return out, cs


def lstm_cs_step_reference(x: torch.Tensor, w_ih: torch.Tensor, b: torch.Tensor,
                           w_hh: torch.Tensor, h: torch.Tensor, cs: torch.Tensor
                           ) -> torch.Tensor:
    """The ``want_cs`` mode's cell state recomputed one step at a time from a
    launch's own outputs: ``c_t = f * c_(t-1) + i * g`` with the gates of x_t
    and h_(t-1), where h_(t-1) and c_(t-1) are read from ``h`` and ``cs``
    (zeros before step 0); [D, R, T, H] fp32. It holds every cell-state store
    at fp32 rounding, where :func:`lstm_cs_reference`'s own state drifts from
    the kernel's once a bf16 h rounds the other way."""
    dt = x.dtype
    hp = torch.cat([torch.zeros_like(h[:, :, :1]), h[:, :, :-1]], dim=2).float()
    cp = torch.cat([torch.zeros_like(cs[:, :, :1]), cs[:, :, :-1]], dim=2)
    g = (torch.einsum("drtf,dfg->drtg", x.float(), w_ih.to(dt).float())
         + torch.einsum("drth,dhg->drtg", hp, w_hh.to(dt).float()) + b.float()[:, None, None])
    i, f, gg, _ = _gates(g, w_hh.shape[1])
    return f * cp + i * gg


def lstm_resid_reference(x: torch.Tensor, w_ih: torch.Tensor, b: torch.Tensor,
                         w_hh: torch.Tensor) -> Tuple[torch.Tensor, Resid]:
    """Plain version of the residual mode: :func:`lstm_reference`'s h and
    ``(hp, cp, tc, pre)``: h and c before each step and tanh(c) after it
    ([D, R, T, H] in x's type; in bf16 c and tanh(c) are rounded there, as
    the TPU kernel stores them) and the gate pre-activations (fp32,
    [D, R, T, 4H])."""
    return _scan_reference(x, w_ih, b, w_hh, _MODE_RESID)


def _bidirectional(scan, x: torch.Tensor, w_ih2: torch.Tensor, w_hh2: torch.Tensor,
                   b2: torch.Tensor) -> torch.Tensor:
    """Two directions of ``scan`` on one x [R, T, F], direction 1 reading it
    reversed: [R, T, 2H], both halves in forward time."""
    out = scan(torch.stack([x, x.flip(1)]), w_ih2, b2, w_hh2)
    return torch.cat([out[0], out[1].flip(1)], dim=-1)


def bilstm_fused_reference(x: torch.Tensor, w_ih2: torch.Tensor, w_hh2: torch.Tensor,
                           b2: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``reverse_dir1`` mode: :func:`lstm_reference` on
    x and on x reversed in time, the second output reversed back, the two
    concatenated."""
    return _bidirectional(lstm_reference, x, w_ih2, w_hh2, b2)


def _v2_scan(x, w_ih, b, w_hh):
    """:func:`lstm_reference` with the manual-DMA kernel's rounding points."""
    D, R, T, _ = x.shape
    H = w_hh.shape[1]
    dt = x.dtype

    def rnd(v):  # to the stream type and back: a no-op for fp32
        return v.to(dt).float()

    w_ih = w_ih.to(dt).float()
    w_hh = w_hh.to(dt).float()
    xp = torch.einsum("drtf,dfg->drtg", x.float(), w_ih)
    h = xp.new_zeros(D, R, H)
    c = xp.new_zeros(D, R, H)
    out = x.new_empty(D, R, T, H)
    def sigmoid(v):  # 1 / (1 + exp(-v)), each operation in the stream type
        return rnd(1.0 / rnd(1.0 + rnd(torch.exp(-v))))

    for t in range(T):
        g = rnd(xp[:, :, t] + torch.bmm(h, w_hh) + b.float()[:, None])
        i, f, gg, o = g.split(H, dim=-1)
        i, f, gg, o = sigmoid(i), sigmoid(f), rnd(torch.tanh(gg)), sigmoid(o)
        c = f * c + rnd(i * gg)
        h = rnd(o * rnd(torch.tanh(c)))
        out[:, :, t] = h.to(dt)
    return out


def lstm_v2_reference(x2: torch.Tensor, w_ih2: torch.Tensor, w_hh2: torch.Tensor,
                      b2: torch.Tensor) -> torch.Tensor:
    """Plain version of the manual-DMA kernel over stacked directions
    (x2 [D, R, T, F] -> [D, R, T, H], each direction in forward time). In
    fp32 it is :func:`lstm_reference`. In a 16-bit stream type it rounds
    where the TPU kernel's source computes in that type (pallas_lstm.py:
    334-340): the gates after the bias; each operation of the activations
    (the sigmoid's exp, 1 + and 1 /, and tanh), each in fp32 from rounded
    operands; i * g; tanh(c) before o *; and h. :func:`lstm_reference`
    rounds only h."""
    return _v2_scan(x2, w_ih2, b2, w_hh2)


def bilstm_v2_reference(x: torch.Tensor, w_ih2: torch.Tensor, w_hh2: torch.Tensor,
                        b2: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`bilstm_v2`: :func:`lstm_v2_reference` on x and
    on x reversed in time, concatenated in forward time ([R, T, 2H])."""
    return _bidirectional(_v2_scan, x, w_ih2, w_hh2, b2)


def lstm_backward_reference(x: torch.Tensor, resid: Resid, g: torch.Tensor, w_ih: torch.Tensor,
                            b: torch.Tensor, w_hh: torch.Tensor) -> Grads:
    """Plain version of the backward: a Python loop over T from the last step
    to the first, all directions at once, with the kernel's arithmetic (the
    gates read from the saved pre-activations ``resid[3]``, not recomputed).
    Returns (dx [D, R, T, F] in x's type, dw_ih, db, dw_hh fp32). bf16
    streams (the TPU kernel's bf16 mode, pallas_lstm.py:559-578): the saved
    streams and the cotangent are bf16; dpre is rounded to bf16 before
    dpre @ W_hh^T and before the dx and dW products, db sums the unrounded
    dpre, and dx is rounded to bf16."""
    D, R, T, F = x.shape
    H = w_hh.shape[1]
    hp, cp, tc, pre = resid
    dt = x.dtype
    xf = x.float()
    # rounded to x's type, as the kernel consumes them; b's part is in the saved pre
    w_ih, w_hh = w_ih.to(dt).float(), w_hh.to(dt).float()
    dpre = xf.new_zeros(D, R, T, 4 * H)
    dpre_db = dpre if dt == torch.float32 else xf.new_zeros(D, R, T, 4 * H)  # unrounded
    dh = xf.new_zeros(D, R, H)
    dc = xf.new_zeros(D, R, H)
    w_hh_t = w_hh.transpose(1, 2)
    for t in range(T - 1, -1, -1):
        i, f, gg, o = _gates(pre[:, :, t], H)
        tct = tc[:, :, t].float()
        dh_t = g[:, :, t].float() + dh
        dc_t = dc + dh_t * (o * (1.0 - tct * tct))
        p = torch.cat([dc_t * (gg * i * (1.0 - i)), dc_t * (cp[:, :, t].float() * f * (1.0 - f)),
                       dc_t * (i * (1.0 - gg * gg)), dh_t * (tct * o * (1.0 - o))], -1)
        dpre_db[:, :, t] = p
        p = p.to(dt).float()
        dpre[:, :, t], dh, dc = p, torch.bmm(p, w_hh_t), dc_t * f
    return (torch.einsum("drtg,dfg->drtf", dpre, w_ih).to(dt),
            torch.einsum("drtf,drtg->dfg", xf, dpre),
            torch.stack([_row_sum(p.reshape(-1, 4 * H)) for p in dpre_db]),
            torch.einsum("drth,drtg->dhg", hp.float(), dpre))


def _checked(x: torch.Tensor, w_ih: torch.Tensor, b: torch.Tensor, w_hh: torch.Tensor):
    """What every kernel here takes: raises on anything else, and returns
    (x, w_ih, b, w_hh) contiguous, the weights fp32 holding values of x's
    type."""
    if not x.is_cuda:
        raise ValueError(f"lstm kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"lstm kernel streams float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"x must be [D, R, T, F], got {tuple(x.shape)}")
    D, R, T, F = x.shape
    H = w_hh.shape[1]
    if w_ih.shape != (D, F, 4 * H) or w_hh.shape != (D, H, 4 * H) or b.shape != (D, 4 * H):
        raise ValueError(
            f"weights must be w_ih [{D}, {F}, 4H], w_hh [{D}, H, 4H], b [{D}, 4H]; got "
            f"{tuple(w_ih.shape)}, {tuple(w_hh.shape)}, {tuple(b.shape)}")
    if F % 16 or H % 16 or not 16 <= H <= 128:
        raise ValueError(f"lstm kernel needs F, H multiples of 16 and H <= 128; F={F} H={H}")
    if T * max(F, H) >= 2 ** 31:  # the kernels' offsets within a row are 32-bit
        raise ValueError(f"lstm kernel needs T * max(F, H) < 2^31; T={T}")
    if any(t.device != x.device for t in (w_ih, w_hh, b)):
        raise ValueError("lstm: x and the weights must be on one device")
    x = x.contiguous()
    # the kernel reads fp32 weights holding values of the stream type; for
    # fp32 weights and streams these are no-ops
    w_ih = w_ih.to(x.dtype).float().contiguous()
    w_hh = w_hh.to(x.dtype).float().contiguous()
    b = b.float().contiguous()
    _check_aligned(x=x, w_ih=w_ih, w_hh=w_hh, b=b)
    return x, w_ih, b, w_hh


def _launch(entry, mode: int, x: torch.Tensor, w_ih: torch.Tensor, b: torch.Tensor,
            w_hh: torch.Tensor):
    """Check what the kernel takes, allocate the outputs and launch on the
    current stream; a launch adds one to ``entry.launches``. Returns
    (h, streams). The h-only and residual modes run the product and cluster
    scan (:func:`_launch_scan`), the cell-state mode ``csrc/lstm.cu``; each
    takes fp32 and bf16 streams."""
    if mode != _MODE_CS:
        return _launch_scan(entry, mode, x, w_ih, b, w_hh)
    x, w_ih, b, w_hh = _checked(x, w_ih, b, w_hh)
    D, R, T, F = x.shape
    H = w_hh.shape[1]
    out = torch.empty(D, R, T, H, dtype=x.dtype, device=x.device)
    streams = tuple(torch.empty(D, R, T, n * H, dtype=torch.float32, device=x.device)
                    for n in _STREAM_WIDTHS[mode])
    if D and R and T:
        lib = _library()
        with torch.cuda.device(x.device):
            rc = lib.lstm_forward(
                _DTYPE_CODES[x.dtype], mode, x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(),
                b.data_ptr(), out.data_ptr(), streams[0].data_ptr() if streams else None,
                D, R, T, F, H, torch.cuda.current_stream(x.device).cuda_stream)
        _raise_on(rc, "lstm kernel", lib, "lstm_error_string")
        entry.launches += 1
    return out, streams


def _launch_scan(entry, mode: int, x: torch.Tensor, w_ih: torch.Tensor, b: torch.Tensor,
                 w_hh: torch.Tensor, v2: bool = False):
    """The h-only and the residual modes on the current stream: per
    direction d one launch of the product kernel, P[d] = x[d] @ W_ih[d] + b[d]
    into pre [D, R, T, 4H] fp32, then one launch of a cluster scan over the D
    directions, each in forward time: the serving scan (h only: it reads P
    and writes h) or the training forward's (it overwrites pre with the gate
    pre-activations and writes h and the residual streams: fp32
    csrc/bilstm2_resid.cu, bf16 the serving scan's training mode). bf16 h-only
    streams run the serving scan's bf16 mode after x is upcast, exactly, for
    the 3xTF32 products. With ``v2`` (h only) bf16 x goes as it is to the
    bf16-operand product kernel and the serving scan rounds as the
    manual-DMA TPU kernel does; the bf16 residual mode takes that product
    too. fp32 is unchanged. One call adds one to ``entry.launches`` (and D to
    its product kernel's). Returns (h, streams) as :func:`_launch`."""
    resid = mode == _MODE_RESID
    x, w_ih, b, w_hh = _checked(x, w_ih, b, w_hh)
    dt = x.dtype
    low = dt != torch.float32
    bf16_product = low and (v2 or resid)
    v2 = v2 and low
    fp32_resid = resid and not low  # csrc/bilstm2_resid.cu; everything else the serving scan
    D, R, T, F = x.shape
    H = w_hh.shape[1]
    G, M = 4 * H, R * T
    out = torch.empty(D, R, T, H, dtype=x.dtype, device=x.device)
    hcs = tuple(torch.empty_like(out) for _ in range(3)) if resid else ()  # hp, cp, tc
    pre = torch.empty(D, R, T, G, dtype=torch.float32, device=x.device)
    if D * M == 0:
        return out, hcs + (pre,) if resid else ()
    if D > 2:
        raise ValueError(f"lstm cluster scans take D <= 2 directions, got {D}")
    if not bf16_product:
        x = x.float()
    # a direction's slices are passed as pointers: each must be 16-byte aligned
    named = {"x": x, "w_ih": w_ih, "b": b, "pre": pre, "out": out,
             **dict(zip(("hp", "cp", "tc"), hcs))}
    _check_aligned(**{f"{n}[{d}]": t[d] for n, t in named.items() for d in range(D)})

    def per_dir(t):  # direction 0's and 1's; with D = 1 the kernel reads only the first
        return [t[min(d, D - 1)].data_ptr() for d in range(2)]

    which = "resid" if fp32_resid else "serve_resid" if resid else "serve"
    plan = _plan(which, R, H, x.device, dirs=D, dtype=dt)
    if fp32_resid:
        w_res = resid_weight_layout(w_hh)
    else:
        w_res = (serve_weight_layout_bf16 if low else serve_weight_layout)(w_hh)
    products = _library_products()
    lib = _library_resid() if fp32_resid else _library_serve()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        w_bf16 = w_ih.bfloat16() if bf16_product else None
        for d in range(D):
            if bf16_product:
                _gemm_bf16(products, stream, x, d * M * F, w_bf16[d], M, G, b[d], pre, d * M * G,
                           G)
            else:
                _gemm(products, stream, False, [(x, d * M * F, F, w_ih, d * F * G, G, F)], M, G,
                      out=pre, out_off=d * M * G, ldc=G, bias=b[d])
        # [D, R, T, 4H]: a direction's gates R T 4H on, a row-step's 4H on
        pre_layout = (M * G, G)
        scan = (0, D, R, T, H, stream)  # no direction reversed, no lengths
        if resid:
            streams = [t[min(d, D - 1)].data_ptr() for d in range(2) for t in hcs]
            run = lib.bilstm2_resid_scan if fp32_resid else lib.bilstm2_serve_resid_scan
            rc = run(plan.height, pre.data_ptr(), w_res.data_ptr(), None, *per_dir(out), *streams,
                     *pre_layout, *scan)
        else:  # outputs [D, R, T, H]: a row-step H on
            rc = lib.bilstm2_serve_scan(plan.height, _V2_CODE if v2 else _DTYPE_CODES[dt],
                                        pre.data_ptr(), w_res.data_ptr(), None, *per_dir(out),
                                        *pre_layout, H, *scan)
    name = "resid" if fp32_resid else "serve"
    _raise_on(rc, f"lstm {which} scan kernel", lib, f"bilstm2_{name}_error_string")
    entry.launches += 1
    return out, hcs + (pre,) if resid else ()


@functools.lru_cache(maxsize=None)
def _max_clusters(H: int, device: int, height: int, dtype: torch.dtype) -> int:
    """How many clusters of the backward scan at tile ``height`` in the
    stream type ``dtype`` the card runs at once
    (cudaOccupancyMaxActiveClusters)."""
    lib = _library_scan()
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.lstm_bwd_max_clusters(height, _DTYPE_CODES[dtype], H, ctypes.byref(n))
    _raise_on(rc, "lstm backward scan occupancy query", lib, "lstm_bwd_error_string")
    return n.value


def plan_backward(D: int, R: int, H: int, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> TilePlan:
    """The backward scan's row tiles on the card (:func:`plan_tiles`): fp32
    from the smallest height's occupancy (at H = 128 every height takes most
    of an SM's shared memory, so one answer serves all), bf16 from each of
    its heights' (a 16-row bf16 tile may fit two CTAs on an SM)."""
    if dtype == torch.float32:
        n = _max_clusters(H, device.index, TILE_HEIGHTS[0], dtype)
        return plan_tiles(R, dict.fromkeys(TILE_HEIGHTS, n), dirs=D)
    counts = {h: _max_clusters(H, device.index, h, dtype) for h in BWD_BF16_HEIGHTS}
    return plan_tiles(R, counts, dirs=D, heights=BWD_BF16_HEIGHTS)


def _launch_backward(entry, x: torch.Tensor, resid: Resid, g: torch.Tensor, w_ih: torch.Tensor,
                     b: torch.Tensor, w_hh: torch.Tensor) -> Grads:
    """The backward's launches (see the module docstring) on the current
    stream; one call adds one to ``entry.launches``. bf16 streams: the scan's
    bf16 mode (dpre @ W_hh^T on the tensor cores) writes dpre in bf16 and
    db's partial sums, which the column-sum kernel adds up; the products read
    x, hp and dpre as they are: dx through the bf16-operand product with a
    bf16 output (rounded once), dW through the column-layout one."""
    x, w_ih, b, w_hh = _checked(x, w_ih, b, w_hh)
    D, R, T, F = x.shape
    H = w_hh.shape[1]
    G = 4 * H
    M = R * T
    low = x.dtype != torch.float32
    if len(resid) != 4:
        raise ValueError(f"lstm backward: resid must be the forward's 4 streams (hp, cp, tc, "
                         f"pre), got {len(resid)}")
    streams = [t.contiguous() for t in (*resid[:3], g)]
    for t in streams:
        if t.shape != (D, R, T, H) or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"lstm backward: residual streams and cotangent must be "
                             f"[{D}, {R}, {T}, {H}] {x.dtype} on {x.device}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    pre = resid[3].contiguous()
    if pre.shape != (D, R, T, G) or pre.dtype != torch.float32 or pre.device != x.device:
        raise ValueError(f"lstm backward: pre must be [{D}, {R}, {T}, {G}] float32 on "
                         f"{x.device}; got {tuple(pre.shape)} {pre.dtype} on {pre.device}")
    _check_aligned(**dict(zip(("hp", "cp", "tc", "g"), streams)), pre=pre)
    hp, cp, tc, g = streams
    # fp32, or with bf16 streams dx rounded once from the product's fp32 sum
    dx = torch.empty(D, R, T, F, dtype=x.dtype, device=x.device)
    if D * M == 0:
        return dx.zero_(), torch.zeros_like(w_ih), torch.zeros_like(b), torch.zeros_like(w_hh)
    if D > 2:
        raise ValueError(f"lstm backward kernel takes D <= 2 directions, got {D}")
    # pre stays as saved: a second backward gives the same; bf16 dpre is bf16
    dpre = torch.empty(D, R, T, G, dtype=x.dtype, device=x.device)
    if low:
        w_split = bwd_weight_layout_bf16(w_hh)
    else:  # CTA (d, c)'s rows of W_hh[d]^T: [4 gates, H/2 units of half c, H k]
        w_split = w_hh.view(D, H, 4, 2, H // 2).permute(0, 3, 2, 4, 1).contiguous()
    w_ih_t = w_ih.transpose(1, 2).contiguous()  # [D, 4H, F]
    tiles = plan_backward(D, R, H, x.device, x.dtype)
    # bf16: db's partial sums, one row per (tile, row group), the D directions side by side
    dbpart = torch.empty(tiles.tiles * 8, D * G, device=x.device) if low else None
    products, lib = _library_products(), _library_scan()
    dw_ih, dw_hh, db = [], [], []
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.lstm_bwd_scan(tiles.height, _DTYPE_CODES[x.dtype], pre.data_ptr(),
                               dpre.data_ptr(), cp.data_ptr(), tc.data_ptr(), g.data_ptr(),
                               w_split.data_ptr(), None if dbpart is None else dbpart.data_ptr(),
                               D, R, T, H, stream)
        _raise_on(rc, "lstm backward scan kernel", lib, "lstm_bwd_error_string")
        if low:
            w_ih_t = w_ih_t.bfloat16()
        for d in range(D):
            if low:
                _gemm_bf16(products, stream, dpre, d * M * G, w_ih_t[d], M, F, None, dx, d * M * F,
                           F)
                dw_ih.append(_gemm_bf16_col(products, stream, x, d * M * F, F, dpre, d * M * G, G,
                                            M, F, G))
                dw_hh.append(_gemm_bf16_col(products, stream, hp, d * M * H, H, dpre, d * M * G, G,
                                            M, H, G))
                db.append(_colsum(products, stream, dbpart, d * G, D * G, dbpart.shape[0], G))
            else:
                _gemm(products, stream, False, [(dpre, d * M * G, G, w_ih_t, d * G * F, F, G)], M,
                      F, out=dx, out_off=d * M * F, ldc=F)
                dw_ih.append(_gemm(products, stream, True,
                                   [(x, d * M * F, F, dpre, d * M * G, G, M)], F, G))
                dw_hh.append(_gemm(products, stream, True,
                                   [(hp, d * M * H, H, dpre, d * M * G, G, M)], H, G))
                db.append(_colsum(products, stream, dpre, d * M * G, G, M, G))
    entry.launches += 1
    return dx, torch.stack(dw_ih), torch.stack(db), torch.stack(dw_hh)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (at first use) and load the forward's library, with its C
    signatures set once."""
    lib = _build.load_library("lstm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_forward.argtypes = [i, i] + [p] * 6 + [i] * 5 + [p]
    lib.lstm_forward.restype = i
    lib.lstm_error_string.argtypes = [i]
    lib.lstm_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library_scan() -> ctypes.CDLL:
    """Build (at first use) and load the backward scan's library."""
    lib = _build.load_library("lstm_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_bwd_scan.argtypes = [i, i] + [p] * 7 + [i] * 4 + [p]
    lib.lstm_bwd_scan.restype = i
    lib.lstm_bwd_max_clusters.argtypes = [i, i, i, p]
    lib.lstm_bwd_max_clusters.restype = i
    lib.lstm_bwd_error_string.argtypes = [i]
    lib.lstm_bwd_error_string.restype = ctypes.c_char_p
    return lib


def lstm_forward(x: torch.Tensor, w_ih: torch.Tensor, b: torch.Tensor,
                 w_hh: torch.Tensor) -> torch.Tensor:
    """Inference: x [D, R, T, F] -> h [D, R, T, H], every direction in
    forward time on its own input. float32 or bfloat16 streams."""
    if x.device.type == "cpu":
        return lstm_reference(x, w_ih, b, w_hh)
    return padded(functools.partial(_launch, lstm_forward, _MODE_H), x, w_ih, b, w_hh)[0]


def lstm_forward_with_cs(x: torch.Tensor, w_ih: torch.Tensor, b: torch.Tensor,
                         w_hh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward for a segment-checkpointed backward (fp32 or bf16
    streams): x [D, R, T, F] -> (h, cs), h in x's type and cs the fp32 cell
    state after every step, [D, R, T, H]."""
    if x.device.type == "cpu":
        return lstm_cs_reference(x, w_ih, b, w_hh)
    out, (cs,) = padded(functools.partial(_launch, lstm_forward_with_cs, _MODE_CS),
                             x, w_ih, b, w_hh)
    return out, cs


def lstm_forward_resid(x: torch.Tensor, w_ih: torch.Tensor, b: torch.Tensor,
                       w_hh: torch.Tensor) -> Tuple[torch.Tensor, Resid]:
    """Training forward (fp32 or bf16 streams): x [D, R, T, F] -> (h, (hp,
    cp, tc, pre)), the output of :func:`lstm_forward` and the residual
    streams, [D, R, T, H] in x's type, and the gate pre-activations
    [D, R, T, 4H] fp32."""
    if x.device.type == "cpu":
        return lstm_resid_reference(x, w_ih, b, w_hh)
    return padded(functools.partial(_launch, lstm_forward_resid, _MODE_RESID),
                       x, w_ih, b, w_hh)


def lstm_scan(x2: torch.Tensor, w_ih2: torch.Tensor, w_hh2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """``lstm_scan_pallas`` (pallas_lstm.py:148): :func:`lstm_forward` in the
    JAX entry's argument order, x2 [D, R, T, F] -> [D, R, T, H]."""
    if x2.device.type == "cpu":
        return lstm_reference(x2, w_ih2, b2, w_hh2)
    return padded(functools.partial(_launch, lstm_scan, _MODE_H), x2, w_ih2, b2, w_hh2)[0]


def bilstm_fused(x: torch.Tensor, w_ih2: torch.Tensor, w_hh2: torch.Tensor,
                 b2: torch.Tensor) -> torch.Tensor:
    """``bilstm_pallas_fused`` (pallas_lstm.py:171): both directions on one
    x [R, T, F], direction 1 scanning it backwards inside the kernel, ->
    [R, T, 2H] (forward ++ backward, both in forward time). float32 or
    bfloat16 streams; on the card the fused pair's serving route with its
    outputs side by side, bf16 x through the bf16-operand input product."""
    if x.device.type == "cpu":
        return bilstm_fused_reference(x, w_ih2, w_hh2, b2)
    return padded(functools.partial(_launch_serve, bilstm_fused, bf16_product=True,
                                    side_by_side=True), x, w_ih2, b2, w_hh2, None)


def lstm_scan_v2(x2: torch.Tensor, w_ih2: torch.Tensor, w_hh2: torch.Tensor,
                 b2: torch.Tensor) -> torch.Tensor:
    """``lstm_scan_pallas_v2`` (pallas_lstm.py:418): the manual-DMA kernel
    over stacked directions, x2 [D, R, T, F] -> [D, R, T, H], each direction
    in forward time on its own input. float32 or bfloat16 streams, rounded
    as :func:`lstm_v2_reference` says; fp32 equals :func:`lstm_forward`."""
    if x2.device.type == "cpu":
        return lstm_v2_reference(x2, w_ih2, w_hh2, b2)
    return padded(functools.partial(_launch_scan, lstm_scan_v2, _MODE_H, v2=True), x2, w_ih2,
                  b2, w_hh2)[0]


def bilstm_v2(x: torch.Tensor, w_ih2: torch.Tensor, w_hh2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """``bilstm_pallas_v2`` (pallas_lstm.py:402): the manual-DMA kernel on
    one x [R, T, F], direction 1 walking it backwards, -> [R, T, 2H]; fp32
    equals :func:`bilstm2_forward`'s two outputs side by side."""
    if x.device.type == "cpu":
        return bilstm_v2_reference(x, w_ih2, w_hh2, b2)
    return padded(functools.partial(_launch_serve, bilstm_v2, bf16_product=True,
                                    side_by_side=True, v2=True), x, w_ih2, b2, w_hh2, None)


def lstm_backward(x: torch.Tensor, resid: Resid, g: torch.Tensor, w_ih: torch.Tensor,
                  b: torch.Tensor, w_hh: torch.Tensor) -> Grads:
    """Backward of :func:`lstm_forward_resid`: the cotangent g [D, R, T, H]
    of h, in x's type -> (dx [D, R, T, F] per direction in x's type, dw_ih
    [D, F, 4H], db [D, 4H], dw_hh [D, H, 4H] fp32). D <= 2 on the card."""
    if x.device.type == "cpu":
        return lstm_backward_reference(x, resid, g, w_ih, b, w_hh)
    return padded_backward(functools.partial(_launch_backward, lstm_backward), x, resid, (g,),
                           w_ih, b, w_hh)


ENTRIES = (lstm_forward, lstm_forward_with_cs, lstm_forward_resid, lstm_backward, lstm_scan,
           bilstm_fused, lstm_scan_v2, bilstm_v2)
for _entry in ENTRIES:
    _entry.launches = 0


def launch_count() -> int:
    """Kernel launches of every entry since their counts were last zeroed."""
    return sum(e.launches for e in ENTRIES)


def reset_launch_counts() -> None:
    for e in ENTRIES:
        e.launches = 0
