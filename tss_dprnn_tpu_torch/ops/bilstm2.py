"""Fused bidirectional LSTM scan and its backward: public entries, kernel
wrappers and plain versions (counterpart of the bilstm2 section of
``tss_dprnn_tpu/ops/pallas_lstm.py:698-1224, 1224-1464``).

Replaces the TPU kernel ``_bilstm2_kernel`` (pallas_lstm.py:698) in its
unmasked, masked and dense modes, fp32 and bf16 streams (the serving scans),
with the input product of ``csrc/products.cu`` followed by the serving scan
of ``csrc/bilstm2_serve.cu`` (the dense mode's then followed by its two
SplitDense products, ``csrc/products.cu`` again), in its residual (training)
mode with ``csrc/bilstm2_resid.cu`` after the same input product (fp32
streams) or, for bf16 streams, the bf16-operand input product and the
serving scan's bf16 training mode,
``_bilstm2_bm_kernel`` (pallas_lstm.py:1088) with the same serving route
(its bf16 streams through the bf16-operand input product), and
``_bilstm2_bwd_kernel`` (pallas_lstm.py:1224, fp32 and bf16) with
``csrc/bilstm2_bwd.cu`` and the products of ``csrc/products.cu`` (bf16:
its bf16-operand and column-layout products), CUDA C++ for ``sm_90a``.
Both directions run in one launch and both outputs come back in forward
time. Layout and argument order are the JAX entries':
``bilstm2_forward(x [B, T, F], w_ih2 [2, F, 4H], b2 [2, 4H], w_hh2 [2, H, 4H])``.
The dense mode (``bilstm2_dense_forward``, opt-in ``TSS_FUSED_DENSE=1`` in
``ops/rnn.py``) returns the SplitDense products y_d = h_d @ wo2[d], [B, T,
Fo] in place of h_d: the TPU kernel runs them in each step's epilogue, the
card after the scan, over all row-steps at once, from an H-wide scratch of
the two outputs side by side (:func:`_launch_serve_dense`); the batch-major
twin (``bilstm2_forward_bm``, opt-in ``TSS_BM=1``) computes the unmasked
inference function, which the serving route computes batch-major already.
The residual streams are the port's own layout: a tuple
``(hp0, cp0, tc0, hp1, cp1, tc1, pre)``: per direction h and c before each
step and tanh(c) after it, [B, T, H] in the stream type in forward time, and
the gate pre-activations ``x_t @ W_ih[d] + h_prev @ W_hh[d] + b[d]`` of
every row-step and direction, [B, T, 2, 4H] fp32, with no time or row
padding. The backward reads ``pre`` and recomputes no gate. The training
pair takes fp32 and bf16 streams; bf16 rounds where the TPU kernels' bf16
mode rounds (h, the saved c and tanh(c), dpre before its products, dx per
direction; :func:`bilstm2_backward_reference` gives the list).

What bounds the scans on the H100: the operations. A row-step costs
2 (F + H) 4H FLOP per direction against a few hundred bytes of input and
output, far above the card's bandwidth line; the time loop is sequential,
so parallelism comes only from rows and directions.

The serving route and the training pair split the work by what is
sequential: the product kernel computes the input half of every gate at
once, P = x @ [W_ih[0] | W_ih[1]] + b into a [B, T, 2, 4H] fp32 buffer (bf16
x upcast, exactly, for the default serving route; the batch-major entry's
and the training pair's bf16 x goes to the bf16-operand product kernel as
it is, :func:`gemm_bf16_reference`), then a recurrent scan adds ``h @
W_hh`` step by step.
The serving scan reads P and writes only the two outputs in the stream
type, with ``h @ W_hh`` on the tensor cores: in 3xTF32 for fp32 streams, in
one bf16 product for bf16 streams (:func:`serve_weight_layout` and
:func:`serve_weight_layout_bf16` give the fragment orders it reads W_hh
in). The training forward's scan writes the full pre-activations back into
``pre``: in fp32 ``csrc/bilstm2_resid.cu`` (FMAs), in bf16 the serving
scan's training mode (one bf16 mma per gate and k-step, as its serving
mode). Backward: the reverse scan turns ``pre`` and the carried dh/dc into
dpre (bf16: its dpre @ W_hh^T in bf16 mma.sync, W_hh^T in
:func:`bwd_weight_layout_bf16`'s order, dpre stored bf16), then the product
kernel gives dx and the per-split partials of dW (a column-sum kernel those
of db), which are summed here in a fixed order; bf16 reads x, h_prev and
dpre as they are, dx through the bf16-operand product with a bf16 output
and dW through the column-layout one (:func:`gemm_bf16_col_reference`,
:func:`split_plan`). The three recurrent scans run as 2-CTA thread-block
clusters, one per (direction, row tile), each CTA holding half of W_hh in
shared memory for the whole scan; :func:`plan_tiles` picks the tile height. The serving and
training forward scans find a direction's gates in P through a stride pair
and reverse direction 1 only when told, so ``ops/lstm.py`` runs its D
stacked directions (each in forward time, P [D, R, T, 4H]) through the same
two kernels. The sources' headers give the details.

The products run on the tensor cores in 3xTF32 (``csrc/products.cu``): each
fp32 operand is split into two TF32 parts and three TF32 products are summed
in fp32, which keeps about 22 of fp32's 24 mantissa bits.
:func:`gemm_reference` is the kernel's plain version (fp32) and, with
``tf32x3=True``, an emulation of that arithmetic (the TF32 rounding done on
the bits). bf16 x (and the dense mode's bf16 h) goes to the bf16-operand
product kernel instead, whose products of bf16 values are exact in fp32
(:func:`gemm_bf16_reference`; a bf16 output is rounded once from the fp32
sum).

The kernels take F and H in multiples of 16 (H <= 128). The wrappers on the
card zero-pad other widths up to the next multiple of 16 (:class:`Widths`):
x and the rows of W_ih in F, and in H each gate block of W_ih, W_hh and b,
the rows of W_hh and of the dense mode's wo (whose columns the dense route
pads to the product kernel's multiple and cuts off again). That is exact: a
padded unit's pre-activations are 0, so its c stays 0.5 * 0 + 0.5 * tanh(0)
= 0 and its h 0.5 * tanh(0) = 0, and its zero rows of W_hh feed nothing; in
the backward its dpre is 0. The pad is sliced off the outputs, the residual
streams and the gradients, so callers see their own widths.

The five time-major entries (``*_tm``, the JAX package's real hosts of
these kernels, ``pallas_lstm.py:1028-1056, 1213, 1366``) take and give
every row-step tensor as [T, R, ...] in place of [R, T, ...]: x [T, R, F],
the outputs and the six H-wide streams [T, R, H], pre [T, R, 2, 4H]. Their
launches are the batch-major ones with the scans' time-major layout (a
template parameter of each scan; the products run over all T R row-steps
in either order), so on transposed inputs the outputs, the streams, pre and
dx equal the batch-major route's bit for bit, while dW and db sum the
row-steps in the other order. Their plain versions are the batch-major
ones on transposed views.

On a CPU tensor each entry runs its plain PyTorch version
(:func:`bilstm2_reference`, :func:`bilstm2_resid_reference`,
:func:`bilstm2_dense_reference`, :func:`bilstm2_bm_reference`,
:func:`bilstm2_backward_reference`) with the same contract. On a CUDA tensor
it launches the kernel or raises. Each entry counts its launches in
``.launches`` (one per call that launched its kernels). The four serving
entries are torch operators (:func:`serving_op`, namespace
``tss_dprnn_tpu_torch``) with shape-only versions, so ``torch.export``
records them as single nodes; their bodies keep that device rule.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, NamedTuple, Optional, Tuple

import torch

from tss_dprnn_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the serving scan's bf16 streams rounded as the manual-DMA TPU kernel rounds
_V2_CODE = 2
# ... and its bf16 training forward (the residual streams besides the outputs)
_RESID_CODE = 3


Resid = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor, torch.Tensor]
Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _pad_last(t: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, n - t.shape[-1])) if n != t.shape[-1] else t


class Widths(NamedTuple):
    """A call's F and H and the kernels' widths Fp, Hp, each rounded up to a
    multiple of 16; the wrappers pad with :meth:`feat`, :meth:`hid`,
    :meth:`gates`, :meth:`w_ih`, :meth:`w_hh` and slice with the ``cut_``
    methods (see the module docstring). With nothing to pad every method
    returns its input."""

    F: int
    H: int
    Fp: int
    Hp: int

    @classmethod
    def of(cls, F: int, H: int) -> "Widths":
        if not 0 < H <= 128:
            raise ValueError(f"the LSTM kernels take 0 < H <= 128; H={H}")
        return cls(F, H, _round16(F), _round16(H))

    @property
    def padded(self) -> bool:
        return self.Fp != self.F or self.Hp != self.H

    def feat(self, t: torch.Tensor) -> torch.Tensor:
        """[..., F] -> [..., Fp]"""
        return _pad_last(t, self.Fp)

    def hid(self, t: torch.Tensor) -> torch.Tensor:
        """[..., H] -> [..., Hp]"""
        return _pad_last(t, self.Hp)

    def gates(self, t: torch.Tensor) -> torch.Tensor:
        """[..., 4H] -> [..., 4Hp], each gate block padded"""
        if self.Hp == self.H:
            return t
        return _pad_last(t.unflatten(-1, (4, self.H)), self.Hp).flatten(-2)

    def w_ih(self, w: torch.Tensor) -> torch.Tensor:
        """[..., F, 4H] -> [..., Fp, 4Hp]"""
        return self.gates(_pad_last(w.transpose(-1, -2), self.Fp).transpose(-1, -2))

    def w_hh(self, w: torch.Tensor) -> torch.Tensor:
        """[..., H, 4H] -> [..., Hp, 4Hp]"""
        return self.gates(_pad_last(w.transpose(-1, -2), self.Hp).transpose(-1, -2))

    def pad(self, x: torch.Tensor, w_ih: torch.Tensor, b: torch.Tensor, w_hh: torch.Tensor):
        """A call's (x, w_ih, b, w_hh) at the kernels' widths."""
        return self.feat(x), self.w_ih(w_ih), self.gates(b), self.w_hh(w_hh)

    def widen(self, t: torch.Tensor) -> torch.Tensor:
        """A saved stream or cotangent [..., H] or pre-activations [..., 4H]
        -> the kernels' widths, zero in the pad (as the padded forward
        leaves them)."""
        return self.gates(t) if t.shape[-1] == 4 * self.H else self.hid(t)

    def cut(self, out):
        """What a scan returns at the kernels' widths (a tensor or nested
        tuples) -> the call's widths: a tensor's last dimension is Hp (h, c,
        tanh(c)), 2 Hp (two directions side by side) or 4 Hp (the gate
        pre-activations)."""
        if isinstance(out, tuple):
            return tuple(self.cut(o) for o in out)
        n, H, Hp = out.shape[-1], self.H, self.Hp
        if n == 4 * Hp:
            return out.unflatten(-1, (4, Hp))[..., :H].flatten(-2).contiguous()
        if n == 2 * Hp:
            return torch.cat([out[..., :H], out[..., Hp:Hp + H]], dim=-1)
        return out[..., :H].contiguous()

    def cut_grads(self, grads: Grads) -> Grads:
        """(dx, dw_ih, db, dw_hh) at the kernels' widths -> the call's."""
        dx, dw_ih, db, dw_hh = grads
        return (dx[..., :self.F].contiguous(), self.cut(dw_ih[..., :self.F, :]), self.cut(db),
                self.cut(dw_hh[..., :self.H, :]))


def padded(run, x: torch.Tensor, w_ih: torch.Tensor, b: torch.Tensor, w_hh: torch.Tensor,
           *rest):
    """``run(x, w_ih, b, w_hh, *rest)`` at the kernels' widths (x [..., F]);
    what it returns cut back by :meth:`Widths.cut`."""
    p = Widths.of(x.shape[-1], w_hh.shape[-2])
    if not p.padded:
        return run(x, w_ih, b, w_hh, *rest)
    return p.cut(run(*p.pad(x, w_ih, b, w_hh), *rest))


def padded_dense(run, x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                 w_hh2: torch.Tensor, wo2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense mode at the kernels' widths: wo2 [2, H, Fo] gets zero rows
    for the padded units; the outputs are Fo wide already."""
    p = Widths.of(x.shape[-1], w_hh2.shape[1])
    if not p.padded:
        return run(x, w_ih2, b2, w_hh2, wo2)
    wo2 = _pad_last(wo2.transpose(-1, -2), p.Hp).transpose(-1, -2)
    return run(*p.pad(x, w_ih2, b2, w_hh2), wo2)


def padded_backward(run, x: torch.Tensor, resid, cotangents, w_ih: torch.Tensor,
                    b: torch.Tensor, w_hh: torch.Tensor, *lens) -> Grads:
    """``run(x, resid, *cotangents, w_ih, b, w_hh, *lens)`` at the kernels'
    widths (the saved streams and the cotangents widened by
    :meth:`Widths.widen`), the gradients cut back."""
    p = Widths.of(x.shape[-1], w_hh.shape[-2])
    if not p.padded:
        return run(x, resid, *cotangents, w_ih, b, w_hh, *lens)
    xp, w_ihp, bp, w_hhp = p.pad(x, w_ih, b, w_hh)
    return p.cut_grads(run(xp, tuple(map(p.widen, resid)), *map(p.widen, cotangents), w_ihp, bp,
                           w_hhp, *lens))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 explicit mantissa bits), ties away
    from zero, as the card's ``cvt.rna.tf32.f32`` rounds: on the bits, add
    half the range of the 13 dropped bits to the magnitude and clear them
    (finite inputs)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x = big + small + rest: big = tf32(x), small = tf32(x - big) (the
    difference is exact in fp32), |rest| <= 2^-22 |x|."""
    big = tf32_round(x)
    return big, tf32_round(x.float() - big)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype = torch.float32
                  ) -> torch.Tensor:
    """a @ b with the product kernel's arithmetic (3xTF32): both operands
    split by :func:`tf32_split`, then small @ big + big @ small + big @ big
    summed in ``dtype`` (fp32, as the tensor cores accumulate; float64
    leaves only the split's own error, the dropped small @ small and the
    roundings of small, below 3 * 2^-22 of |a| @ |b|), returned as fp32."""
    (ab, asm), (bb, bsm) = tf32_split(a), tf32_split(b)

    def mm(u, v):
        return torch.matmul(u.to(dtype), v.to(dtype))

    return (mm(asm, bb) + mm(ab, bsm) + mm(ab, bb)).float()


def gemm_reference(parts, bias: Optional[torch.Tensor] = None, kps: Optional[int] = None,
                   tf32x3: bool = False) -> torch.Tensor:
    """Plain version of the product kernel (``products_gemm``): C = the sum
    over ``parts`` ((A, B) pairs, A [M, K_p], B [K_p, N]; a column-layout A
    is the transpose of its [K_p, M] array) of A @ B, plus ``bias`` [N]. With
    ``kps`` the concatenated k-range is cut into splits of kps and the
    partials are summed in order, as the wrapper sums the kernel's. fp32
    products, or with ``tf32x3`` :func:`tf32x3_matmul` (the kernel's
    arithmetic)."""
    a = torch.cat([p[0] for p in parts], dim=1).float()
    b = torch.cat([p[1] for p in parts], dim=0).float()
    mm = tf32x3_matmul if tf32x3 else torch.matmul
    K = a.shape[1]
    step = kps or max(K, 1)
    out = None
    for k0 in range(0, K, step):
        part = mm(a[:, k0:k0 + step], b[k0:k0 + step])
        out = part if out is None else out + part
    if out is None:
        out = a.new_zeros(a.shape[0], b.shape[1])
    return out if bias is None else out + bias.float()


def gemm_bf16_reference(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of the bf16-operand product kernel
    (``products_gemm_bf16``): C = a @ b (+ bias) in fp32, a [M, K] and b
    [K, N] holding bf16 values (products of two are exact in fp32; the
    kernel sums them in another order), returned in ``out_dtype``: fp32, or
    bf16 rounded once from the fp32 sum."""
    out = a.float() @ b.float()
    out = out if bias is None else out + bias.float()
    return out.to(out_dtype)


def gemm_bf16_col_reference(a: torch.Tensor, b: torch.Tensor,
                            kps: Optional[int] = None) -> torch.Tensor:
    """Plain version of the column-layout bf16-operand product kernel
    (``products_gemm_bf16_col``): C = a^T @ b in fp32, a [K, M] and b [K, N]
    holding bf16 values (products of two are exact in fp32; the kernel sums
    them in another order), the k-range cut into splits of ``kps`` (default
    :func:`split_plan`'s) whose fp32 partials are summed in order, as the
    wrapper sums the kernel's."""
    K, M = a.shape
    kps = kps or split_plan(M, b.shape[1], K)[1]
    a, b = a.float(), b.float()
    out = a.new_zeros(M, b.shape[1])
    for k0 in range(0, K, kps):
        out = out + a[k0:k0 + kps].T @ b[k0:k0 + kps]
    return out


def _row_sum(t: torch.Tensor) -> torch.Tensor:
    """[M, N] -> [N], each column summed in row order: a sequential sum,
    whose bits do not depend on N (a padded call gives the unpadded one's),
    as the column-sum kernel sums a split's rows in order."""
    return t.cumsum(0)[-1] if t.shape[0] else t.new_zeros(t.shape[1:])


def _gates(g: torch.Tensor, H: int):
    """Pre-activations [..., 4H] -> (i, f, g, o) activations, torch order."""
    i, f, gg, o = g.split(H, dim=-1)
    return (1.0 / (1.0 + torch.exp(-i)), 1.0 / (1.0 + torch.exp(-f)), torch.tanh(gg),
            1.0 / (1.0 + torch.exp(-o)))


def _scan_reference(x, w_ih2, b2, w_hh2, lens, want_resid: bool):
    B, T, _ = x.shape
    H = w_hh2.shape[1]
    dt = x.dtype
    w_ih = w_ih2.to(dt).float()
    w_hh = w_hh2.to(dt).float()
    b = b2.float()
    xf = x.float()
    outs, resid = [], []
    pre = xf.new_empty(B, T, 2, 4 * H) if want_resid else None
    for d in (0, 1):
        xp = xf @ w_ih[d]  # [B, T, 4H]: the per-step x_t @ W_ih, all steps at once
        h = xf.new_zeros(B, H)
        c = xf.new_zeros(B, H)
        hs = []  # h in the stream type, in scan order
        # h, c, tanh(c) in the stream type: a bf16 store rounds c and tanh(c)
        streams = [x.new_empty(B, T, H) for _ in range(3)] if want_resid else None
        for t in (range(T) if d == 0 else range(T - 1, -1, -1)):
            g = xp[:, t] + h @ w_hh[d] + b[d]
            i, f, gg, o = _gates(g, H)
            c_new = f * c + i * gg
            tc = torch.tanh(c_new)
            h_new = (o * tc).to(dt).float()
            if want_resid:
                streams[0][:, t], streams[1][:, t], streams[2][:, t] = h, c, tc
                pre[:, t, d] = g
            if lens is not None and d == 1:
                valid = (t < lens)[:, None]
                c = torch.where(valid, c_new, c)
                h = torch.where(valid, h_new, h)
            else:
                c, h = c_new, h_new
            hs.append(h.to(dt))
        outs.append(torch.stack(hs if d == 0 else hs[::-1], dim=1) if T else x.new_empty(B, T, H))
        resid += streams or []
    return (outs[0], outs[1]), tuple(resid) + ((pre,) if want_resid else ())


def bilstm2_reference(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                      w_hh2: torch.Tensor, lens: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: a Python loop over T.

    Per step ``g = x_t @ W_ih + h @ W_hh + b`` in fp32, torch gate order
    i, f, g, o, fp32 c, and h rounded to x's type before it feeds the next
    step. Weights are rounded to x's type first, as the TPU kernel consumes
    them. With ``lens`` direction 1 holds its zero state while t >= len."""
    return _scan_reference(x, w_ih2, b2, w_hh2, lens, want_resid=False)[0]


def bilstm2_resid_reference(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                            w_hh2: torch.Tensor, lens: Optional[torch.Tensor] = None
                            ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], Resid]:
    """Plain version of the residual mode: :func:`bilstm2_reference`'s
    outputs and, per direction, h and c before each step and tanh(c) after
    it ([B, T, H] in x's type, forward time; in bf16 c and tanh(c) are
    rounded there, as the TPU kernel stores them, while the scan carries c
    in fp32), then the gate pre-activations of every step and direction
    (fp32, [B, T, 2, 4H]). With ``lens`` direction 1's h and c stay at the
    zero state on held steps."""
    return _scan_reference(x, w_ih2, b2, w_hh2, lens, want_resid=True)


def bilstm2_dense_reference(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                            w_hh2: torch.Tensor, wo2: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dense mode: :func:`bilstm2_reference`, then each
    direction's h_d @ wo2[d] in fp32 (wo2 [2, H, Fo] rounded to x's type
    first), cast to x's type."""
    wo = wo2.to(x.dtype).float()
    outs = bilstm2_reference(x, w_ih2, b2, w_hh2)
    return tuple((o.float() @ wo[d]).to(x.dtype) for d, o in enumerate(outs))


def bilstm2_bm_reference(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                         w_hh2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the batch-major kernel: the unmasked
    :func:`bilstm2_reference`, whose function it computes."""
    return bilstm2_reference(x, w_ih2, b2, w_hh2)


def bilstm2_backward_reference(x: torch.Tensor, resid: Resid, g0: torch.Tensor,
                               g1: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                               w_hh2: torch.Tensor, lens: Optional[torch.Tensor] = None,
                               matmul=torch.matmul) -> Grads:
    """Plain version of the backward: a Python loop over T per direction, in
    the reverse of its scan, with the kernel's arithmetic (the gates read
    from the saved pre-activations ``resid[6]``, not recomputed). Returns
    (dx, dw_ih2, db2, dw_hh2): dx in x's type, the rest fp32. With ``lens``
    the steps t >= len[row] of both directions give no dpre and pass the
    carries through. dx, dW_ih and dW_hh, which the card computes in the
    product kernel, go through ``matmul`` (e.g. :func:`tf32x3_matmul`, that
    kernel's arithmetic).

    bf16 streams (the TPU kernel's bf16 mode, pallas_lstm.py:1281-1313): the
    saved streams and the cotangents are bf16; dpre is rounded to bf16
    before dpre @ W_hh^T and before the dx and dW products, db sums the
    unrounded dpre, and each direction's dx is rounded to bf16 before the
    two are added in bf16."""
    B, T, F = x.shape
    H = w_hh2.shape[1]
    dt = x.dtype
    xf = x.float()
    # rounded to x's type, as the kernel consumes them; b2's part is in the saved pre
    w_ih, w_hh = w_ih2.to(dt).float(), w_hh2.to(dt).float()
    dx = None
    dw_ih, dw_hh, db = [], [], []
    for d, (hp, cp, tc, g) in enumerate(((*resid[:3], g0), (*resid[3:6], g1))):
        pre = resid[6][:, :, d]  # [B, T, 4H], saved by the forward
        dpre = xf.new_zeros(B, T, 4 * H)
        dpre_db = dpre if dt == torch.float32 else xf.new_zeros(B, T, 4 * H)  # unrounded
        dh = xf.new_zeros(B, H)
        dc = xf.new_zeros(B, H)
        for t in (range(T - 1, -1, -1) if d == 0 else range(T)):
            i, f, gg, o = _gates(pre[:, t], H)
            tct = tc[:, t].float()
            dh_t = g[:, t].float() + dh
            dc_t = dc + dh_t * (o * (1.0 - tct * tct))
            p = torch.cat([dc_t * (gg * i * (1.0 - i)), dc_t * (cp[:, t].float() * f * (1.0 - f)),
                           dc_t * (i * (1.0 - gg * gg)), dh_t * (tct * o * (1.0 - o))], -1)
            if lens is not None:
                p = torch.where((t < lens)[:, None], p, 0.0)
            dpre_db[:, t] = p
            p = p.to(dt).float()
            dh_new, dc_new = p @ w_hh[d].T, dc_t * f
            if lens is not None:
                live = (t < lens)[:, None]
                dh_new = torch.where(live, dh_new, dh)
                dc_new = torch.where(live, dc_new, dc)
            dpre[:, t], dh, dc = p, dh_new, dc_new
        dx_d = matmul(dpre, w_ih[d].T).to(dt)
        dx = dx_d if dx is None else dx + dx_d
        dw_ih.append(matmul(xf.reshape(-1, F).T, dpre.reshape(-1, 4 * H)))
        dw_hh.append(matmul(hp.float().reshape(-1, H).T, dpre.reshape(-1, 4 * H)))
        db.append(_row_sum(dpre_db.reshape(-1, 4 * H)))
    return dx, torch.stack(dw_ih), torch.stack(db), torch.stack(dw_hh)


def bilstm2_tm_reference(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                         w_hh2: torch.Tensor, lens: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the time-major serving entries: x [T, R, F] ->
    (out0, out1) [T, R, H], :func:`bilstm2_reference` on the transposed
    view."""
    return _time_major(bilstm2_reference(x.transpose(0, 1), w_ih2, b2, w_hh2, lens))


def bilstm2_resid_tm_reference(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                               w_hh2: torch.Tensor, lens: Optional[torch.Tensor] = None
                               ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], Resid]:
    """Plain version of the time-major training forwards: the outputs and
    the seven streams of :func:`bilstm2_resid_reference`, each [T, R, ...]."""
    outs, resid = bilstm2_resid_reference(x.transpose(0, 1), w_ih2, b2, w_hh2, lens)
    return _time_major(outs), _time_major(resid)


def bilstm2_backward_tm_reference(x: torch.Tensor, resid: Resid, g0: torch.Tensor,
                                  g1: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                                  w_hh2: torch.Tensor, lens: Optional[torch.Tensor] = None
                                  ) -> Grads:
    """Plain version of the time-major backward: x [T, R, F], the streams
    and cotangents [T, R, ...] -> (dx [T, R, F], dw_ih2, db2, dw_hh2),
    :func:`bilstm2_backward_reference` on the transposed views."""
    def bm(t):
        return t.transpose(0, 1)

    dx, *rest = bilstm2_backward_reference(bm(x), tuple(map(bm, resid)), bm(g0), bm(g1), w_ih2,
                                           b2, w_hh2, lens)
    return (bm(dx).contiguous(), *rest)


def _time_major(out):
    """Row-step tensors (nested tuples) [R, T, ...] -> contiguous [T, R, ...]."""
    if isinstance(out, tuple):
        return tuple(_time_major(o) for o in out)
    return out.transpose(0, 1).contiguous()


def _checked(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor, w_hh2: torch.Tensor,
             lens: Optional[torch.Tensor], time_major: bool = False):
    """What every bilstm2 kernel takes: raises on anything else, and returns
    (x, w_ih2, b2, w_hh2, lens) contiguous, the weights fp32 holding values
    of x's type, lens int32. x is [B, T, F], or [T, B, F] ``time_major``."""
    if not x.is_cuda:
        raise ValueError(f"bilstm2 kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"bilstm2 kernel streams float32 or bfloat16, got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"x must be {'[T, B, F]' if time_major else '[B, T, F]'}, got "
                         f"{tuple(x.shape)}")
    B, T, F = _rows_steps(x, time_major) + (x.shape[2],)
    H = w_hh2.shape[1]
    if w_ih2.shape != (2, F, 4 * H) or w_hh2.shape != (2, H, 4 * H) or b2.shape != (2, 4 * H):
        raise ValueError(
            f"weights must be w_ih2 [2, {F}, 4H], w_hh2 [2, H, 4H], b2 [2, 4H]; got "
            f"{tuple(w_ih2.shape)}, {tuple(w_hh2.shape)}, {tuple(b2.shape)}")
    if F % 16 or H % 16 or not 16 <= H <= 128:  # Widths pads them before this
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
    _check_aligned(x=x, w_ih2=w_ih2, w_hh2=w_hh2, b2=b2)
    return x, w_ih2, b2, w_hh2, lens


def _rows_steps(x: torch.Tensor, time_major: bool) -> Tuple[int, int]:
    """(rows, steps) of a row-step tensor: [R, T, ...], or [T, R, ...]
    ``time_major``."""
    return (x.shape[1], x.shape[0]) if time_major else (x.shape[0], x.shape[1])


def _check_aligned(**tensors: torch.Tensor) -> None:
    # 16-byte copies and stores: a view that starts mid-row would fault
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"bilstm2 kernel needs {name} 16-byte aligned; pass a copy")


def _ptr(t: Optional[torch.Tensor], offset: int = 0) -> Optional[int]:
    """Device address of ``t`` plus ``offset`` elements (fp32 or int32)."""
    return None if t is None else t.data_ptr() + 4 * offset


def _raise_on(rc: int, what: str, lib: ctypes.CDLL, error_string: str) -> None:
    if rc != 0:
        msg = getattr(lib, error_string)(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


# split-K of the dW products: about this many blocks, two waves of the product
# kernel (2 blocks per SM of an H100)
_SPLIT_BLOCKS = 528
_BM = _BN = 128  # the product kernel's block tile
_BK = 32         # ... and its k-depth

# the training scans' compiled tile heights (csrc/bilstm2_resid.cu, bilstm2_bwd.cu)
TILE_HEIGHTS = (16, 24, 32, 40, 48)
# the serving scan's (csrc/bilstm2_serve.cu, and its bf16 training forward):
# multiples of its 16-row m-tile
SERVE_HEIGHTS = (16, 32)
# the backward scan's in bf16: whole 16-row m-tiles of its dpre @ W_hh^T
BWD_BF16_HEIGHTS = (16, 32, 48)


class TilePlan(NamedTuple):
    """Row tiles of a training scan: ``tiles`` tiles of ``height`` rows, one
    2-CTA cluster per tile and direction (``dirs`` of them)."""

    height: int
    tiles: int
    dirs: int = 2

    @property
    def clusters(self) -> int:
        return self.dirs * self.tiles


def plan_tiles(R: int, max_clusters: Mapping[int, int], dirs: int = 2,
               heights: Tuple[int, ...] = TILE_HEIGHTS) -> TilePlan:
    """The tile height, one of ``heights``, of a cluster scan over R rows and
    ``dirs`` directions when the card runs ``max_clusters[height]`` clusters
    at once (a height of which it runs none is left out): the smallest
    height whose grid fits one wave; where none does, the fewest waves times
    height (the time of one step is about proportional to the height), then
    the fewer waves."""
    heights = tuple(h for h in heights if max_clusters[h] >= 1)
    if not heights:
        raise ValueError(f"the card runs no cluster of the scan ({max_clusters})")
    plans = [TilePlan(h, max(1, -(-R // h)), dirs) for h in heights]
    for plan in plans:
        if plan.clusters <= max_clusters[plan.height]:
            return plan
    waves = [-(-p.clusters // max_clusters[p.height]) for p in plans]
    return min(zip(plans, waves), key=lambda pw: (pw[1] * pw[0].height, pw[1]))[0]


@functools.lru_cache(maxsize=None)
def _max_clusters(which: str, H: int, device: int, height: int, dtype: torch.dtype) -> int:
    """How many clusters of a cluster scan (``which``: "resid", the fp32
    training forward; "serve_resid", the bf16 one; "bwd" or "serve") at tile
    ``height`` the card runs at once, from cudaOccupancyMaxActiveClusters.
    The serving and backward scans are asked per stream type (``dtype``):
    their bf16 W slices are half the fp32 ones, so a short bf16 tile may fit
    two CTAs on an SM. The fp32 training forward takes fp32 only."""
    lib = _library_resid() if which == "resid" else (
        _library_bwd() if which == "bwd" else _library_serve())
    code = _RESID_CODE if which == "serve_resid" else _DTYPE_CODES[dtype]
    args = (height,) if which == "resid" else (height, code)
    name = "serve" if which == "serve_resid" else which
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = getattr(lib, f"bilstm2_{name}_max_clusters")(*args, H, ctypes.byref(n))
    _raise_on(rc, f"bilstm2 {which} scan occupancy query", lib, f"bilstm2_{name}_error_string")
    return n.value


def _plan(which: str, R: int, H: int, device: torch.device, dirs: int = 2,
          dtype: torch.dtype = torch.float32) -> TilePlan:
    """A cluster scan's tile plan on ``device``. The serving scan's (and its
    bf16 training forward's, ``which`` "serve_resid") and the bf16
    backward's from their occupancy at each of their heights in the stream
    type ``dtype``; the fp32 training scans' from their smallest height's (at
    H = 128 every height takes most of an SM's shared memory, one CTA per SM,
    so one answer serves all)."""
    heights = (SERVE_HEIGHTS if which in ("serve", "serve_resid") else
               BWD_BF16_HEIGHTS if which == "bwd" and dtype != torch.float32 else None)
    if heights is not None:
        counts = {h: _max_clusters(which, H, device.index, h, dtype) for h in heights}
        return plan_tiles(R, counts, dirs=dirs, heights=heights)
    n = _max_clusters(which, H, device.index, TILE_HEIGHTS[0], dtype)
    return plan_tiles(R, dict.fromkeys(TILE_HEIGHTS, n), dirs=dirs, heights=TILE_HEIGHTS)


def split_plan(M: int, N: int, K: int) -> Tuple[int, int]:
    """(splits, kps) of a product over a long k-range into a small C[M, N]:
    about _SPLIT_BLOCKS blocks of the product kernel's 128 x 128 tiles, each
    split kps deep (a multiple of its 32-deep k-tile). It depends on the
    shapes alone, so the partials and the order they are summed in repeat
    from run to run."""
    tiles = -(-M // _BM) * -(-N // _BN)
    splits = max(1, min(-(-_SPLIT_BLOCKS // tiles), -(-K // _BK)))
    kps = max(-(-K // (splits * _BK)) * _BK, _BK)
    return max(1, -(-K // kps)), kps


def _gemm(lib, stream, a_col: bool, parts, M: int, N: int, out: Optional[torch.Tensor] = None,
          out_off: int = 0, ldc: Optional[int] = None, bias: Optional[torch.Tensor] = None):
    """One launch of the product kernel (csrc/products.cu): C[M, N] = sum
    over ``parts`` of A @ B (+ bias). ``parts``: up to two (a, a_off, lda, b,
    b_off, ldb, K), offsets in elements. With ``out`` C is written there (no
    split); without, the k-range is split into fixed partials, summed here."""
    (a1, ao1, lda1, b1, bo1, ldb1, k1), *rest = parts
    a2, ao2, lda2, b2, bo2, ldb2, k2 = rest[0] if rest else (None, 0, 0, None, 0, 0, 0)
    K = k1 + k2
    if bias is not None and out is None:  # each split's partial would add it
        raise ValueError("product kernel: a bias needs out= (one split)")
    if out is not None:
        splits, kps, partial, stride = 1, -(-K // _BK) * _BK, out, 0
    else:
        splits, kps = split_plan(M, N, K)
        partial = torch.empty(splits, M, N, dtype=torch.float32, device=a1.device)
        ldc, stride = N, M * N
    rc = lib.products_gemm(int(a_col), _ptr(a1, ao1), lda1, _ptr(b1, bo1), ldb1, k1,
                           _ptr(a2, ao2), lda2, _ptr(b2, bo2), ldb2, k2, _ptr(bias),
                           _ptr(partial, out_off), ldc, M, N, splits, kps, stride, stream)
    _raise_on(rc, "product kernel", lib, "products_error_string")
    _gemm.launches += 1
    return None if out is not None else partial.sum(0)


def _gemm_bf16(lib, stream, a: torch.Tensor, a_off: int, b: torch.Tensor, M: int, N: int,
               bias: Optional[torch.Tensor], out: torch.Tensor, out_off: int, ldc: int,
               lda: Optional[int] = None) -> None:
    """One launch of the bf16-operand product kernel (csrc/products.cu):
    out[M, N] (at ``out_off`` elements, row pitch ``ldc``) = a[M, K] @ b[K,
    N] + bias, a (``a_off`` in elements, row pitch ``lda``, K by default)
    and b (contiguous rows) bf16; out fp32, or bf16 rounded once from the
    fp32 sum."""
    K = b.shape[0]
    rc = lib.products_gemm_bf16(a.data_ptr() + a.element_size() * a_off, K if lda is None else lda,
                                b.data_ptr(), N, K, _ptr(bias),
                                out.data_ptr() + out.element_size() * out_off, ldc, M, N,
                                int(out.dtype == torch.bfloat16), stream)
    _raise_on(rc, "bf16 product kernel", lib, "products_error_string")
    _gemm_bf16.launches += 1


def _gemm_bf16_col(lib, stream, a: torch.Tensor, a_off: int, lda: int, b: torch.Tensor,
                   b_off: int, ldb: int, K: int, M: int, N: int) -> torch.Tensor:
    """One launch of the column-layout bf16-operand product kernel
    (csrc/products.cu): C[M, N] = sum over k < K of a[k, m] b[k, n], a and b
    bf16 (``a_off``, ``b_off`` in elements, row pitches ``lda``, ``ldb``). The
    k-range is split (:func:`split_plan`) into fixed fp32 partials, summed
    here in order; returns C fp32."""
    splits, kps = split_plan(M, N, K)
    partial = torch.empty(splits, M, N, dtype=torch.float32, device=a.device)
    rc = lib.products_gemm_bf16_col(a.data_ptr() + a.element_size() * a_off, lda,
                                    b.data_ptr() + b.element_size() * b_off, ldb, K,
                                    partial.data_ptr(), M * N, M, N, splits, kps, stream)
    _raise_on(rc, "column-layout bf16 product kernel", lib, "products_error_string")
    _gemm_bf16_col.launches += 1
    return partial.sum(0)


def _colsum(lib, stream, a: torch.Tensor, a_off: int, lda: int, K: int, N: int) -> torch.Tensor:
    """One launch of the column-sum kernel: the sums over the K rows of
    a[K, N] (``a_off`` in elements, row pitch ``lda``), as fixed partials
    summed here."""
    splits = min(-(-K // 256), 256)
    kps = -(-K // splits)
    splits = -(-K // kps)
    partial = torch.empty(splits, N, dtype=torch.float32, device=a.device)
    rc = lib.products_colsum(_ptr(a, a_off), lda, K, N, partial.data_ptr(), splits, kps, stream)
    _raise_on(rc, "column-sum kernel", lib, "products_error_string")
    _colsum.launches += 1
    return partial.sum(0)


def resid_weight_layout(w_hh: torch.Tensor) -> torch.Tensor:
    """W_hh [D, H, 4H] (the pair's D = 2, or D stacked directions) as the
    training forward's scan reads it: [D d, 2 c, H k, 4 gates, H/2 units],
    CTA (d, c)'s slice (the gate columns of hidden units [c H/2,
    (c + 1) H/2)) contiguous."""
    D, H = w_hh.shape[:2]
    return w_hh.view(D, H, 4, 2, H // 2).permute(0, 3, 1, 2, 4).contiguous()


def serve_weight_layout(w_hh: torch.Tensor) -> torch.Tensor:
    """W_hh [D, H, 4H] as the serving scan reads it, in mma fragment order:
    [D d, 2 c, H/8 k-steps, H/16 unit groups, 8 lg, 4 lt, 4 gates, 2 j], the
    element W_hh[d][8 ks + lt + 4 j][gate * H + c H/2 + 8 w + lg] (CTA c's
    unit group w is units c H/2 + 8 w .. + 8; lane 4 lg + lt's B fragment of
    gate g at k-step ks is its two j values)."""
    D, H = w_hh.shape[:2]
    w = w_hh.reshape(D, H // 8, 2, 4, 4, 2, H // 16, 8)  # d, ks, j, lt, gate, c, w, lg
    return w.permute(0, 5, 1, 6, 7, 3, 4, 2).contiguous()


def serve_weight_layout_bf16(w_hh: torch.Tensor) -> torch.Tensor:
    """W_hh [D, H, 4H] (holding bf16 values) as the serving scan's bf16 mode
    reads it, in the fragment order of mma m16n8k16: [D d, 2 c, H/16
    k-steps, H/16 unit groups, 2 j, 8 lg, 4 lt, 4 gates, 2 e] in bf16, the
    element W_hh[d][16 ks + 8 j + 2 lt + e][gate * H + c H/2 + 8 w + lg]
    (lane 4 lg + lt's B fragment register j of gate g at k-step ks is its two
    e values; its four gates' registers j are 16 contiguous bytes)."""
    D, H = w_hh.shape[:2]
    w = w_hh.reshape(D, H // 16, 2, 4, 2, 4, 2, H // 16, 8)  # d, ks, j, lt, e, gate, c, w, lg
    return w.permute(0, 6, 1, 7, 2, 8, 3, 5, 4).to(torch.bfloat16).contiguous()


def bwd_weight_layout_bf16(w_hh: torch.Tensor) -> torch.Tensor:
    """W_hh [D, H, 4H] (holding bf16 values) as the backward scan's bf16 mode
    reads it: CTA (d, c)'s rows of W_hh[d]^T, WT_c[k][u] = W_hh[d][u][gate H
    + c H/2 + j] for k = gate H/2 + j (its dpre tile's columns), in the
    fragment order of mma m16n8k16's B: [D d, 2 c, H/8 k-steps, H/16 warps,
    8 lg, 4 lt, 2 nt, 2 j, 2 e] in bf16, the element WT_c[16 ks + 8 j + 2 lt
    + e][16 w + 8 nt + lg] (warp w's n-tile nt is units 16 w + 8 nt .. + 8;
    lane 4 lg + lt's registers of both its n-tiles are 16 contiguous
    bytes)."""
    D, H = w_hh.shape[:2]
    wt = w_hh.view(D, H, 4, 2, H // 2).permute(0, 3, 2, 4, 1)  # d, c, gate, j, u: [D, 2, 2H, H]
    w = wt.reshape(D, 2, H // 8, 2, 4, 2, H // 16, 2, 8)  # d, c, ks, j, lt, e, w, nt, lg
    return w.permute(0, 1, 2, 6, 8, 4, 7, 3, 5).to(torch.bfloat16).contiguous()


def _input_product(products, stream: int, x: torch.Tensor, w_ih2: torch.Tensor,
                   b2: torch.Tensor, pre: torch.Tensor, bf16: bool = False) -> None:
    """One launch of a product kernel: pre [B, T, 2, 4H] = x @ [W_ih[0] |
    W_ih[1]] + b, both directions' input halves of every gate at once. x
    fp32 through the 3xTF32 kernel, or with ``bf16`` bf16 x through the
    bf16-operand one."""
    F, G = w_ih2.shape[1:]
    w_cat = w_ih2.transpose(0, 1).reshape(F, 2 * G)  # [F, 8H]
    M = x.shape[0] * x.shape[1]
    if bf16:
        _gemm_bf16(products, stream, x, 0, w_cat.bfloat16().contiguous(), M, 2 * G, b2, pre, 0,
                   2 * G)
    else:
        _gemm(products, stream, False, [(x, 0, F, w_cat.contiguous(), 0, 2 * G, F)], M, 2 * G,
              out=pre, ldc=2 * G, bias=b2)


def _launch_resid(entry, x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                  w_hh2: torch.Tensor, lens: Optional[torch.Tensor], time_major: bool = False):
    """The training forward's launches on the current stream: the input
    product P = x @ [W_ih[0] | W_ih[1]] + b into ``pre``, then the recurrent
    scan, which overwrites ``pre`` with the full gate pre-activations; one
    call adds one to ``entry.launches`` (and one to its product kernel's).
    Returns ((out0, out1), resid), the outputs and the six H-wide streams in
    x's type. fp32: the 3xTF32 product and csrc/bilstm2_resid.cu's scan.
    bf16: x as it is through the bf16-operand product, then the serving
    scan's bf16 training mode (csrc/bilstm2_serve.cu, mode 3: h @ W_hh in
    bf16 mma.sync on W_hh in :func:`serve_weight_layout_bf16`'s order).
    ``time_major``: x [T, B, F] and every row-step tensor [T, B, ...], the
    scan's time-major instantiation."""
    x, w_ih2, b2, w_hh2, lens = _checked(x, w_ih2, b2, w_hh2, lens, time_major)
    B, T = _rows_steps(x, time_major)
    H = w_hh2.shape[1]
    low = x.dtype != torch.float32
    out0 = torch.empty(*x.shape[:2], H, dtype=x.dtype, device=x.device)
    out1 = torch.empty_like(out0)
    streams = tuple(torch.empty_like(out0) for _ in range(6))
    pre = torch.empty(*x.shape[:2], 2, 4 * H, dtype=torch.float32, device=x.device)
    if B and T:
        w_res = (serve_weight_layout_bf16 if low else resid_weight_layout)(w_hh2)
        plan = _plan("serve_resid" if low else "resid", B, H, x.device, dtype=x.dtype)
        products, lib = _library_products(), _library_serve() if low else _library_resid()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            _input_product(products, stream, x if low else x.float(), w_ih2, b2, pre, bf16=low)
            # [B, T, 2, 4H] (or [T, B, 2, 4H]): a direction's gates 4H on, a
            # row-step's 8H on; direction 1 reversed
            scan = lib.bilstm2_serve_resid_scan if low else lib.bilstm2_resid_scan
            rc = scan(plan.height, pre.data_ptr(), w_res.data_ptr(), _ptr(lens), out0.data_ptr(),
                      out1.data_ptr(), *(t.data_ptr() for t in streams), 4 * H, 8 * H, 1, 2, B, T,
                      H, int(time_major), stream)
        which = "serve" if low else "resid"
        _raise_on(rc, f"bilstm2 {which} resid scan kernel", lib, f"bilstm2_{which}_error_string")
        entry.launches += 1
    return (out0, out1), streams + (pre,)


def _launch_serve(entry, x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                  w_hh2: torch.Tensor, lens: Optional[torch.Tensor], bf16_product: bool = False,
                  side_by_side: bool = False, v2: bool = False, time_major: bool = False):
    """The serving route (unmasked and masked, fp32 or bf16 streams) on the
    current stream: the input product P into a [B, T, 2, 4H] fp32 buffer
    (bf16 x upcast, exactly, for the 3xTF32 kernel; with ``bf16_product``
    bf16 x goes as it is to the bf16-operand kernel), then the serving
    cluster scan in the stream type, which reads P and writes only the two
    outputs; one call adds one to ``entry.launches`` (and one to its product
    kernel's). With ``side_by_side`` the two outputs go into one [B, T, 2H]
    (unmasked only). With ``v2`` the bf16 scan rounds as the manual-DMA TPU
    kernel does (fp32 rounds nowhere: the same scan). Raises on anything the
    kernels do not take. Returns (out0, out1), or with ``side_by_side`` the
    [B, T, 2H]. ``time_major`` (not with ``side_by_side`` or ``v2``): x [T,
    B, F], P and the outputs [T, B, ...], the scan's time-major
    instantiation."""
    if time_major and (side_by_side or v2):
        raise ValueError("the time-major serving scan writes the outputs apart, rounded as h")
    x, w_ih2, b2, w_hh2, lens = _checked(x, w_ih2, b2, w_hh2, lens, time_major)
    B, T = _rows_steps(x, time_major)
    H = w_hh2.shape[1]
    low = x.dtype != torch.float32
    if side_by_side:  # direction 1's units H elements on, a row-step 2H on
        out = torch.empty(B, T, 2 * H, dtype=x.dtype, device=x.device)
        ptrs = (out.data_ptr(), out.data_ptr() + H * out.element_size())
    else:
        out = tuple(torch.empty(*x.shape[:2], H, dtype=x.dtype, device=x.device)
                    for _ in range(2))
        ptrs = tuple(o.data_ptr() for o in out)
    if B and T:
        w_frag = (serve_weight_layout_bf16 if low else serve_weight_layout)(w_hh2)
        plan = _plan("serve", B, H, x.device, dtype=x.dtype)
        products, lib = _library_products(), _library_serve()
        pre = torch.empty(*x.shape[:2], 2, 4 * H, dtype=torch.float32, device=x.device)
        code = _V2_CODE if v2 and low else _DTYPE_CODES[x.dtype]
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            if bf16_product and low:
                _input_product(products, stream, x, w_ih2, b2, pre, bf16=True)
            else:
                _input_product(products, stream, x.float(), w_ih2, b2, pre)
            rc = lib.bilstm2_serve_scan(plan.height, code, pre.data_ptr(), w_frag.data_ptr(),
                                        _ptr(lens), *ptrs, 4 * H, 8 * H,
                                        2 * H if side_by_side else H, 1, 2, B, T, H,
                                        int(time_major), stream)
        _raise_on(rc, "bilstm2 serving scan kernel", lib, "bilstm2_serve_error_string")
        entry.launches += 1
    return out


def _launch_serve_dense(entry, x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                        w_hh2: torch.Tensor, wo2: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense mode on the serving route (current stream): the pair's
    serving launches (:func:`_launch_serve`, bf16 x through the bf16-operand
    input product) with the two outputs side by side in a scratch h [B, T,
    2H] in x's type, then per direction the SplitDense product y_d = h_d @
    wo2[d] over all row-steps on the tensor cores: fp32 in 3xTF32
    (``products_gemm``), bf16 through the bf16-operand kernel with a bf16
    output, rounded once from its fp32 sum as the TPU kernel rounds
    (pallas_lstm.py:766-769). wo2 [2, H, Fo] takes any Fo >= 1: its columns
    are zero-padded to the product kernel's multiple (4 fp32, 8 bf16) and the
    outputs cut back. One call adds one to ``entry.launches`` and three to
    its product kernel's. Returns (y0, y1), each [B, T, Fo] in x's type."""
    B, T = x.shape[:2]
    H = w_hh2.shape[1]
    if wo2.ndim != 3 or wo2.shape[:2] != (2, H) or wo2.shape[2] < 1:
        raise ValueError(f"wo2 must be [2, H={H}, Fo >= 1], got {tuple(wo2.shape)}")
    if wo2.device != x.device:
        raise ValueError("bilstm2: x and wo2 must be on one device")
    h = _launch_serve(entry, x, w_ih2, b2, w_hh2, None, bf16_product=True, side_by_side=True)
    Fo = wo2.shape[2]
    low = x.dtype != torch.float32
    n = -(-Fo // 8) * 8 if low else -(-Fo // 4) * 4
    ys = [torch.empty(B, T, n, dtype=x.dtype, device=x.device) for _ in range(2)]
    if B and T:
        # wo2 as the kernels consume it: the stream type's values, columns padded
        wo = _pad_last(wo2.to(x.dtype), n).contiguous()
        products = _library_products()
        M = B * T
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            for d, y in enumerate(ys):  # h_d: H columns at d H of the 2H-wide rows
                if low:
                    _gemm_bf16(products, stream, h, d * H, wo[d], M, n, None, y, 0, n,
                               lda=2 * H)
                else:
                    _gemm(products, stream, False, [(h, d * H, 2 * H, wo, d * H * n, n, H)], M,
                          n, out=y, ldc=n)
    del h  # the scratch goes back to the allocator once the products are queued
    if n != Fo:
        ys = [y[..., :Fo].contiguous() for y in ys]
    return ys[0], ys[1]


def _launch_backward(entry, x: torch.Tensor, resid: Resid, g0: torch.Tensor, g1: torch.Tensor,
                     w_ih2: torch.Tensor, b2: torch.Tensor, w_hh2: torch.Tensor,
                     lens: Optional[torch.Tensor], time_major: bool = False):
    """The backward's launches (see the module docstring) on the current
    stream; one call adds one to ``entry.launches``. bf16 streams: the scan's
    bf16 mode (dpre @ W_hh^T on the tensor cores, W_hh^T in
    :func:`bwd_weight_layout_bf16`'s order) writes dpre in bf16 and db's
    partial sums, which the column-sum kernel adds up; every product reads
    bf16 operands as they are (no fp32 copy of x, hp or dpre): dx is one
    bf16-operand product per direction with a bf16 output, rounded once, the
    two added in bf16 (as the TPU kernel's dx0 + dx1), dW_ih and dW_hh the
    column-layout product's fixed partials. ``time_major``: x, the streams,
    the cotangents and dx [T, B, ...], the scan's time-major instantiation
    (the products then sum the row-steps in time-major order)."""
    x, w_ih2, b2, w_hh2, lens = _checked(x, w_ih2, b2, w_hh2, lens, time_major)
    B, T = _rows_steps(x, time_major)
    F = x.shape[2]
    rs = x.shape[:2]  # a row-step tensor's leading dimensions
    H = w_hh2.shape[1]
    G = 4 * H
    M = B * T
    low = x.dtype != torch.float32
    if len(resid) != 7:
        raise ValueError(f"bilstm2 backward: resid must be the forward's 7 streams, got "
                         f"{len(resid)}")
    pre = resid[6].contiguous()
    streams = [t.contiguous() for t in (*resid[:6], g0, g1)]
    for t in streams:
        if t.shape != (*rs, H) or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"bilstm2 backward: residual streams and cotangents must be "
                             f"{[*rs, H]} {x.dtype} on {x.device}; got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if pre.shape != (*rs, 2, G) or pre.dtype != torch.float32 or pre.device != x.device:
        raise ValueError(f"bilstm2 backward: pre must be {[*rs, 2, G]} float32 on "
                         f"{x.device}; got {tuple(pre.shape)} {pre.dtype} on {pre.device}")
    _check_aligned(**dict(zip(("hp0", "cp0", "tc0", "hp1", "cp1", "tc1", "g0", "g1"), streams)),
                   pre=pre)
    hp0, cp0, tc0, hp1, cp1, tc1, g0, g1 = streams
    if M == 0:
        return (torch.zeros(*rs, F, dtype=x.dtype, device=x.device), torch.zeros_like(w_ih2),
                torch.zeros_like(b2), torch.zeros_like(w_hh2))
    # pre stays as saved: a second backward gives the same; bf16 dpre is bf16
    dpre = torch.empty(*rs, 2, G, dtype=x.dtype, device=x.device)
    if low:
        w_split = bwd_weight_layout_bf16(w_hh2)
    else:  # CTA (d, c)'s rows of W_hh[d]^T: [4 gates, H/2 units of half c, H k]
        w_split = w_hh2.view(2, H, 4, 2, H // 2).permute(0, 3, 2, 4, 1).contiguous()
    w_ih_t = w_ih2.transpose(1, 2).reshape(2 * G, F).contiguous()  # [8H, F]
    plan = _plan("bwd", B, H, x.device, dtype=x.dtype)
    # bf16: db's partial sums, one row per (tile, row group), both directions
    dbpart = torch.empty(plan.tiles * 8, 2 * G, device=x.device) if low else None
    products, lib = _library_products(), _library_bwd()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.bilstm2_bwd_scan(plan.height, _DTYPE_CODES[x.dtype], pre.data_ptr(),
                                  dpre.data_ptr(), cp0.data_ptr(), tc0.data_ptr(), g0.data_ptr(),
                                  cp1.data_ptr(), tc1.data_ptr(), g1.data_ptr(),
                                  w_split.data_ptr(), _ptr(lens), _ptr(dbpart), B, T, H,
                                  int(time_major), stream)
        _raise_on(rc, "bilstm2 backward scan kernel", lib, "bilstm2_bwd_error_string")
        if low:
            w_ih_t = w_ih_t.bfloat16()
            dxs = torch.empty(2, M, F, dtype=x.dtype, device=x.device)
            for d in (0, 1):  # dpre_d: 4H columns at d 4H of the 8H-wide rows
                _gemm_bf16(products, stream, dpre, d * G, w_ih_t[d * G:(d + 1) * G], M, F, None,
                           dxs, d * M * F, F, lda=2 * G)
            dx = (dxs[0] + dxs[1]).view(*rs, F)
            dw_ih = _gemm_bf16_col(products, stream, x, 0, F, dpre, 0, 2 * G, M, F, 2 * G)
            dw_hh = [_gemm_bf16_col(products, stream, hp, 0, H, dpre, d * G, 2 * G, M, H, G)
                     for d, hp in ((0, hp0), (1, hp1))]
            db = _colsum(products, stream, dbpart, 0, 2 * G, dbpart.shape[0], 2 * G)
        else:
            dx = torch.empty(*rs, F, dtype=torch.float32, device=x.device)
            _gemm(products, stream, False, [(dpre, 0, 2 * G, w_ih_t, 0, F, 2 * G)], M, F,
                  out=dx, ldc=F)
            dw_ih = _gemm(products, stream, True, [(x, 0, F, dpre, 0, 2 * G, M)], F, 2 * G)
            dw_hh = [_gemm(products, stream, True, [(hp, 0, H, dpre, d * G, 2 * G, M)], H, G)
                     for d, hp in ((0, hp0), (1, hp1))]
            db = _colsum(products, stream, dpre, 0, 2 * G, M, 2 * G)
    entry.launches += 1
    return (dx, dw_ih.reshape(F, 2, G).transpose(0, 1).contiguous(), db.reshape(2, G),
            torch.stack(dw_hh))


@functools.lru_cache(maxsize=None)
def _library_products() -> ctypes.CDLL:
    """Build (at first use) and load the product and column-sum kernels."""
    lib = _build.load_library("products")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.products_gemm.argtypes = [i, p, ll, p, ll, i, p, ll, p, ll, i, p, p, ll, i, i, i, i, ll, p]
    lib.products_gemm.restype = i
    lib.products_gemm_bf16.argtypes = [p, ll, p, ll, i, p, p, ll, i, i, i, p]
    lib.products_gemm_bf16.restype = i
    lib.products_gemm_bf16_col.argtypes = [p, ll, p, ll, i, p, ll, i, i, i, i, p]
    lib.products_gemm_bf16_col.restype = i
    lib.products_colsum.argtypes = [p, ll, i, i, p, i, i, p]
    lib.products_colsum.restype = i
    lib.products_error_string.argtypes = [i]
    lib.products_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library_resid() -> ctypes.CDLL:
    """Build (at first use) and load the training forward's scan."""
    lib = _build.load_library("bilstm2_resid")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bilstm2_resid_scan.argtypes = [i] + [p] * 11 + [ctypes.c_longlong] + [i] * 7 + [p]
    lib.bilstm2_resid_scan.restype = i
    lib.bilstm2_resid_max_clusters.argtypes = [i, i, p]
    lib.bilstm2_resid_max_clusters.restype = i
    lib.bilstm2_resid_error_string.argtypes = [i]
    lib.bilstm2_resid_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library_serve() -> ctypes.CDLL:
    """Build (at first use) and load the serving scan."""
    lib = _build.load_library("bilstm2_serve")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bilstm2_serve_scan.argtypes = [i, i] + [p] * 5 + [ctypes.c_longlong] + [i] * 8 + [p]
    lib.bilstm2_serve_scan.restype = i
    lib.bilstm2_serve_resid_scan.argtypes = [i] + [p] * 11 + [ctypes.c_longlong] + [i] * 7 + [p]
    lib.bilstm2_serve_resid_scan.restype = i
    lib.bilstm2_serve_cs_scan.argtypes = [i, i] + [p] * 6 + [ctypes.c_longlong] + [i] * 4 + [p]
    lib.bilstm2_serve_cs_scan.restype = i
    lib.bilstm2_serve_max_clusters.argtypes = [i, i, i, p]
    lib.bilstm2_serve_max_clusters.restype = i
    lib.bilstm2_serve_error_string.argtypes = [i]
    lib.bilstm2_serve_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library_bwd() -> ctypes.CDLL:
    """Build (at first use) and load the backward's scan."""
    lib = _build.load_library("bilstm2_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bilstm2_bwd_scan.argtypes = [i, i] + [p] * 11 + [i, i, i, i, p]
    lib.bilstm2_bwd_scan.restype = i
    lib.bilstm2_bwd_max_clusters.argtypes = [i, i, i, p]
    lib.bilstm2_bwd_max_clusters.restype = i
    lib.bilstm2_bwd_error_string.argtypes = [i]
    lib.bilstm2_bwd_error_string.restype = ctypes.c_char_p
    return lib


# the serving entries' operators; eager callers and ``torch.export``
# (``inference/export.py``) go through the same ones
OPS_NAMESPACE = "tss_dprnn_tpu_torch"
# each operator's body (the plain version on a CPU tensor): what the
# hermetic export decomposes the operators into
PLAIN_BODIES: dict = {}


def serving_op(name: str, body, fake):
    """Register ``body`` as the operator ``OPS_NAMESPACE::name`` (no input
    mutated, no output aliasing an input or another output) with ``fake`` as
    its shape-only version, and return the operator."""
    op = torch.library.custom_op(f"{OPS_NAMESPACE}::{name}", body, mutates_args=())
    op.register_fake(fake)
    PLAIN_BODIES[getattr(getattr(torch.ops, OPS_NAMESPACE), name).default] = body
    return op


def _forward_impl(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                  w_hh2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`bilstm2_forward`'s operator body: the plain version on a CPU
    tensor, else the serving route."""
    if x.device.type == "cpu":
        return bilstm2_reference(x, w_ih2, b2, w_hh2)
    return padded(functools.partial(_launch_serve, bilstm2_forward), x, w_ih2, b2, w_hh2, None)


def _forward_masked_impl(x: torch.Tensor, lens: torch.Tensor, w_ih2: torch.Tensor,
                         b2: torch.Tensor, w_hh2: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`bilstm2_forward_masked`'s operator body."""
    if x.device.type == "cpu":
        return bilstm2_reference(x, w_ih2, b2, w_hh2, lens)
    return padded(functools.partial(_launch_serve, bilstm2_forward_masked), x, w_ih2, b2, w_hh2,
                  lens)


def _dense_forward_impl(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                        w_hh2: torch.Tensor, wo2: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`bilstm2_dense_forward`'s operator body."""
    if x.device.type == "cpu":
        return bilstm2_dense_reference(x, w_ih2, b2, w_hh2, wo2)
    return padded_dense(functools.partial(_launch_serve_dense, bilstm2_dense_forward), x, w_ih2,
                        b2, w_hh2, wo2)


def _forward_bm_impl(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                     w_hh2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`bilstm2_forward_bm`'s operator body."""
    if x.device.type == "cpu":
        return bilstm2_bm_reference(x, w_ih2, b2, w_hh2)
    return padded(functools.partial(_launch_serve, bilstm2_forward_bm, bf16_product=True), x,
                  w_ih2, b2, w_hh2, None)


def _forward_tm_impl(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                     w_hh2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`bilstm2_forward_tm`'s operator body."""
    if x.device.type == "cpu":
        return bilstm2_tm_reference(x, w_ih2, b2, w_hh2)
    return padded(functools.partial(_launch_serve, bilstm2_forward_tm, time_major=True), x,
                  w_ih2, b2, w_hh2, None)


def _forward_masked_tm_impl(x: torch.Tensor, lens: torch.Tensor, w_ih2: torch.Tensor,
                            b2: torch.Tensor, w_hh2: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`bilstm2_forward_masked_tm`'s operator body."""
    if x.device.type == "cpu":
        return bilstm2_tm_reference(x, w_ih2, b2, w_hh2, lens)
    return padded(functools.partial(_launch_serve, bilstm2_forward_masked_tm, time_major=True),
                  x, w_ih2, b2, w_hh2, lens)


def _pair_fake(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor, w_hh2: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out0, out1), each [B, T, H] (time-major [T, R, H]) in x's type."""
    B, T = x.shape[:2]
    H = w_hh2.shape[1]
    return x.new_empty(B, T, H), x.new_empty(B, T, H)


def _masked_fake(x: torch.Tensor, lens: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                 w_hh2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return _pair_fake(x, w_ih2, b2, w_hh2)


def _dense_fake(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor, w_hh2: torch.Tensor,
                wo2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y0, y1), each [B, T, Fo] in x's type."""
    B, T = x.shape[:2]
    return x.new_empty(B, T, wo2.shape[2]), x.new_empty(B, T, wo2.shape[2])


_FORWARD_OP = serving_op("bilstm2_forward", _forward_impl, _pair_fake)
_FORWARD_MASKED_OP = serving_op("bilstm2_forward_masked", _forward_masked_impl, _masked_fake)
_DENSE_FORWARD_OP = serving_op("bilstm2_dense_forward", _dense_forward_impl, _dense_fake)
_FORWARD_BM_OP = serving_op("bilstm2_forward_bm", _forward_bm_impl, _pair_fake)
_FORWARD_TM_OP = serving_op("bilstm2_forward_tm", _forward_tm_impl, _pair_fake)
_FORWARD_MASKED_TM_OP = serving_op("bilstm2_forward_masked_tm", _forward_masked_tm_impl,
                                   _masked_fake)


def bilstm2_forward(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                    w_hh2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference: x [B, T, F] -> (out0, out1), each [B, T, H], both in
    forward time. The operator ``tss_dprnn_tpu_torch::bilstm2_forward``."""
    return _FORWARD_OP(x, w_ih2, b2, w_hh2)


def bilstm2_forward_masked(x: torch.Tensor, lens: torch.Tensor, w_ih2: torch.Tensor,
                           b2: torch.Tensor, w_hh2: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask-aware inference: x [B, T, F], lens [B] -> (out0, out1), each
    [B, T, H], both in forward time. Direction 1 holds its zero state while
    t >= lens[row], so its first real step reads x[len - 1] and
    out1[t >= len] = 0; out0[t >= len] is unspecified (finite). The operator
    ``tss_dprnn_tpu_torch::bilstm2_forward_masked``."""
    return _FORWARD_MASKED_OP(x, lens, w_ih2, b2, w_hh2)


def bilstm2_dense_forward(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                          w_hh2: torch.Tensor, wo2: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference with the SplitDense product: x [B, T, F], wo2 [2, H, Fo]
    (any Fo >= 1) -> (y0, y1), each [B, T, Fo] = h_d @ wo2[d] in x's type,
    both in forward time. Unmasked only, as the JAX core asserts
    (pallas_lstm.py:854). On the card the serving route with its outputs in
    an H-wide scratch, then the two products (:func:`_launch_serve_dense`).
    The operator ``tss_dprnn_tpu_torch::bilstm2_dense_forward``."""
    return _DENSE_FORWARD_OP(x, w_ih2, b2, w_hh2, wo2)


def bilstm2_forward_bm(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                       w_hh2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference, the batch-major kernel's entry: the contract of
    :func:`bilstm2_forward` (x [B, T, F] -> (out0, out1), each [B, T, H],
    both in forward time), on its route. fp32 streams run its launches as
    they are (the same outputs bit for bit); bf16 x goes to the
    bf16-operand input product without an upcast. The operator
    ``tss_dprnn_tpu_torch::bilstm2_forward_bm``."""
    return _FORWARD_BM_OP(x, w_ih2, b2, w_hh2)


def bilstm2_forward_resid(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                          w_hh2: torch.Tensor
                          ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], Resid]:
    """Training forward (fp32 or bf16 streams): x [B, T, F] -> ((out0,
    out1), resid), the outputs of :func:`bilstm2_forward` and the residual
    streams ``(hp0, cp0, tc0, hp1, cp1, tc1, pre)``: six [B, T, H] in x's
    type and the gate pre-activations [B, T, 2, 4H] fp32."""
    if x.device.type == "cpu":
        return bilstm2_resid_reference(x, w_ih2, b2, w_hh2)
    return padded(functools.partial(_launch_resid, bilstm2_forward_resid), x, w_ih2, b2, w_hh2,
                  None)


def bilstm2_forward_resid_masked(x: torch.Tensor, lens: torch.Tensor, w_ih2: torch.Tensor,
                                 b2: torch.Tensor, w_hh2: torch.Tensor
                                 ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], Resid]:
    """Mask-aware training forward (fp32 or bf16 streams): the outputs of
    :func:`bilstm2_forward_masked` and the residual streams. Direction 1's h
    and c stay at the zero state on held steps; every stream past a row's
    length is unspecified (finite)."""
    if x.device.type == "cpu":
        return bilstm2_resid_reference(x, w_ih2, b2, w_hh2, lens)
    return padded(functools.partial(_launch_resid, bilstm2_forward_resid_masked), x, w_ih2, b2,
                  w_hh2, lens)


def bilstm2_backward(x: torch.Tensor, resid: Resid, g0: torch.Tensor, g1: torch.Tensor,
                     w_ih2: torch.Tensor, b2: torch.Tensor, w_hh2: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`bilstm2_forward_resid`: the cotangents g0, g1
    [B, T, H] of the two outputs, in x's type -> (dx [B, T, F] in x's type,
    dw_ih2 [2, F, 4H], db2 [2, 4H], dw_hh2 [2, H, 4H] fp32)."""
    if x.device.type == "cpu":
        return bilstm2_backward_reference(x, resid, g0, g1, w_ih2, b2, w_hh2)
    return padded_backward(functools.partial(_launch_backward, bilstm2_backward), x, resid,
                           (g0, g1), w_ih2, b2, w_hh2, None)


def bilstm2_backward_masked(x: torch.Tensor, resid: Resid, g0: torch.Tensor, g1: torch.Tensor,
                            w_ih2: torch.Tensor, b2: torch.Tensor, w_hh2: torch.Tensor,
                            lens: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`bilstm2_forward_resid_masked`: steps t >= lens[row]
    give nothing in either direction (direction 1 held its zero state there;
    out0 is unspecified there, so its cotangent is discarded) and dx there
    is 0. The TPU kernel skips only direction 1's held steps, since its
    forward runs direction 0 to the end; the two agree when out0's cotangent
    is zero past the length, as the DPRNN block's masked norm makes it."""
    if x.device.type == "cpu":
        return bilstm2_backward_reference(x, resid, g0, g1, w_ih2, b2, w_hh2, lens)
    return padded_backward(functools.partial(_launch_backward, bilstm2_backward_masked), x, resid,
                           (g0, g1), w_ih2, b2, w_hh2, lens)


def bilstm2_forward_tm(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                       w_hh2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference, time-major: x [T, R, F] -> (out0, out1), each [T, R, H],
    both in forward time (pallas_lstm.py:1028). The operator
    ``tss_dprnn_tpu_torch::bilstm2_forward_tm``."""
    return _FORWARD_TM_OP(x, w_ih2, b2, w_hh2)


def bilstm2_forward_masked_tm(x: torch.Tensor, lens: torch.Tensor, w_ih2: torch.Tensor,
                              b2: torch.Tensor, w_hh2: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask-aware inference, time-major: x [T, R, F], lens [R] -> (out0,
    out1), each [T, R, H], the contract of :func:`bilstm2_forward_masked`
    (pallas_lstm.py:1039). The operator
    ``tss_dprnn_tpu_torch::bilstm2_forward_masked_tm``."""
    return _FORWARD_MASKED_TM_OP(x, lens, w_ih2, b2, w_hh2)


def bilstm2_forward_resid_tm(x: torch.Tensor, w_ih2: torch.Tensor, b2: torch.Tensor,
                             w_hh2: torch.Tensor
                             ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], Resid]:
    """Training forward, time-major (pallas_lstm.py:1213): x [T, R, F] ->
    ((out0, out1), resid), :func:`bilstm2_forward_resid`'s outputs and
    streams with every row-step tensor [T, R, ...] (pre [T, R, 2, 4H])."""
    if x.device.type == "cpu":
        return bilstm2_resid_tm_reference(x, w_ih2, b2, w_hh2)
    return padded(functools.partial(_launch_resid, bilstm2_forward_resid_tm, time_major=True), x,
                  w_ih2, b2, w_hh2, None)


def bilstm2_forward_resid_masked_tm(x: torch.Tensor, lens: torch.Tensor, w_ih2: torch.Tensor,
                                    b2: torch.Tensor, w_hh2: torch.Tensor
                                    ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], Resid]:
    """Mask-aware training forward, time-major (pallas_lstm.py:1056): the
    contract of :func:`bilstm2_forward_resid_masked` with every row-step
    tensor [T, R, ...]."""
    if x.device.type == "cpu":
        return bilstm2_resid_tm_reference(x, w_ih2, b2, w_hh2, lens)
    return padded(functools.partial(_launch_resid, bilstm2_forward_resid_masked_tm,
                                    time_major=True), x, w_ih2, b2, w_hh2, lens)


def bilstm2_backward_tm(x: torch.Tensor, resid: Resid, g0: torch.Tensor, g1: torch.Tensor,
                        w_ih2: torch.Tensor, b2: torch.Tensor, w_hh2: torch.Tensor,
                        lens: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of the time-major training forwards (pallas_lstm.py:1366):
    x [T, R, F], their streams, the cotangents g0, g1 [T, R, H] -> (dx [T, R,
    F], dw_ih2, db2, dw_hh2); with ``lens`` [R] the masked backward's
    contract (:func:`bilstm2_backward_masked`)."""
    if x.device.type == "cpu":
        return bilstm2_backward_tm_reference(x, resid, g0, g1, w_ih2, b2, w_hh2, lens)
    return padded_backward(functools.partial(_launch_backward, bilstm2_backward_tm,
                                             time_major=True), x, resid, (g0, g1), w_ih2, b2,
                           w_hh2, lens)


ENTRIES = (bilstm2_forward, bilstm2_forward_masked, bilstm2_dense_forward, bilstm2_forward_bm,
           bilstm2_forward_resid, bilstm2_forward_resid_masked, bilstm2_backward,
           bilstm2_backward_masked, bilstm2_forward_tm, bilstm2_forward_masked_tm,
           bilstm2_forward_resid_tm, bilstm2_forward_resid_masked_tm, bilstm2_backward_tm)
# the product and column-sum kernels, launched inside the entries (and
# ops/lstm.py's); counted apart from the entries
PRODUCTS = {"products_gemm": _gemm, "products_gemm_bf16": _gemm_bf16,
            "products_gemm_bf16_col": _gemm_bf16_col, "products_colsum": _colsum}
for _entry in (*ENTRIES, *PRODUCTS.values()):
    _entry.launches = 0


def launch_count() -> int:
    """Kernel launches of every entry since their counts were last zeroed."""
    return sum(e.launches for e in ENTRIES)


def product_launch_counts() -> dict:
    """Launches of the product and column-sum kernels, by kernel."""
    return {name: fn.launches for name, fn in PRODUCTS.items()}


def reset_launch_counts() -> None:
    for e in (*ENTRIES, *PRODUCTS.values()):
        e.launches = 0
