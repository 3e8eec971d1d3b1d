"""Recurrent op layer
(counterpart of ``tss_dprnn_tpu/ops/rnn.py:93-122, 140-303, 374-560,
574-838``).

A bidirectional DPRNN scan feeds a Dense(2H -> N), so :func:`lstm_pair`
returns the per-direction pair and leaves the concatenation out. Without
gradients the pair comes from the fused inference kernel; with them, from
:class:`BiLSTM2` / :class:`BiLSTM2Masked`, whose forward runs the residual
mode and whose backward runs the backward kernel (the counterparts of
``_recurrence3`` and ``_recurrence3_masked``). :func:`lstm_split_dense` is
the scan and its Dense together (without the bias).

Two switches of the JAX package, read from the environment at each call as
JAX reads them when it traces: ``TSS_FUSED_DENSE=1`` sends every unmasked
:func:`lstm_split_dense` through the fused kernel's dense mode
(``bilstm2_dense_forward``; with gradients :class:`BiLSTM2Dense`, the
counterpart of ``_recurrence3_dense``), and ``TSS_BM=1`` sends
:func:`lstm_pair`'s unmasked inference through the batch-major kernel
(``bilstm2_forward_bm``). With both on, the dense path wins for the scans it
takes, as in JAX. Both default to off: the JAX package measured each as a
net loss on the TPU.

A unidirectional scan (the inter-chunk scan of ``bidirectional: false``)
goes through :func:`lstm_stack`, the counterpart of ``_recurrence`` at
``lstm_save_every == 1``: the stacked-direction kernel of ``ops/lstm.py``
without gradients, :class:`LSTMStack` over its residual mode and backward
kernel with them. :func:`lstm` is the JAX package's functional entry over
both.

The time-major lane (JAX ``ops/rnn.py:93-109, 485-560, 655-690,
767-779``): :func:`lstm_pair_tm` and :func:`lstm_tm` take x [T, R, F] and
give [T, R, H] (the pair) or [T, R, 2H], through the time-major entries of
``ops/bilstm2.py`` (with gradients :class:`BiLSTM2TM` /
:class:`BiLSTM2MaskedTM`); ``TSS_FUSED_DENSE`` and ``TSS_BM`` do not apply
there, as in JAX. The DPRNN core takes it where
:func:`lstm_time_major_available` says so: a bidirectional scan without
``lstm_save_every``, and the ``lstm_time_major(on)`` context on, or
``TSS_TM=1`` (``TSS_TM=0`` turns it off whatever the context says). The
serving entry points set the context by :func:`serving_time_major`.

Two context variables of the JAX package (``ops/rnn.py:33-86``), which the
trainer sets around its own steps:

- ``lstm_save_every(q)``: with q > 1, every LSTM scan that autograd records
  keeps only the states entering each q-step segment
  (:class:`LSTMSegments`: the ``want_cs`` forward of ``ops/lstm.py``, then a
  segment-by-segment backward in plain PyTorch, as ``lax.scan`` in JAX).
  The bidirectional entries then leave the fused pair and run the stacked
  D = 2 scan over ``[x, masked_flip(x, lengths)]``, as JAX's ``lstm`` does.
  Without autograd it changes nothing: it is a residual policy.
- ``lstm_ignore_lengths(on)``: the LSTM entries treat ``lengths`` as None
  (the ``schedule_masks`` pragma: every row is full-length, the rest of
  the graph keeps its masks). The GRU and RNN cells do not read it.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import NamedTuple, Optional, Tuple

import torch

from tss_dprnn_tpu_torch.ops.bilstm2 import (
    bilstm2_backward,
    bilstm2_backward_masked,
    bilstm2_backward_tm,
    bilstm2_dense_forward,
    bilstm2_forward,
    bilstm2_forward_bm,
    bilstm2_forward_masked,
    bilstm2_forward_masked_tm,
    bilstm2_forward_resid,
    bilstm2_forward_resid_masked,
    bilstm2_forward_resid_masked_tm,
    bilstm2_forward_resid_tm,
    bilstm2_forward_tm,
)
from tss_dprnn_tpu_torch.ops.lstm import (
    lstm_backward,
    lstm_forward,
    lstm_forward_resid,
    lstm_forward_with_cs,
)
from tss_dprnn_tpu_torch.ops.masking import masked_flip

_LSTM_SAVE_EVERY: contextvars.ContextVar = contextvars.ContextVar("lstm_save_every", default=1)
_LSTM_IGNORE_LENGTHS: contextvars.ContextVar = contextvars.ContextVar(
    "lstm_ignore_lengths", default=False)
_LSTM_TM: contextvars.ContextVar = contextvars.ContextVar("lstm_tm", default=False)
# The serving entry points' layout for the bf16 lane. The JAX Inferencer
# serves its bf16 lane time-major (a win on the TPU, whose batch-major entry
# paid a swapaxes around every scan). The port's scans are batch-major
# natively, and on an H100 the time-major lane served the flagship 2 % slower
# at batch 8 and at 32 (chip_smoke.py phase 19, PERF.md), so it stays opt-in
# there (TSS_TM=1).
SERVE_BF16_TIME_MAJOR = False


@contextlib.contextmanager
def lstm_save_every(q: int):
    """Segment-checkpointed LSTM residuals every ``q`` steps (1: every step)."""
    token = _LSTM_SAVE_EVERY.set(max(1, int(q)))
    try:
        yield
    finally:
        _LSTM_SAVE_EVERY.reset(token)


@contextlib.contextmanager
def lstm_ignore_lengths(on: bool = True):
    """The LSTM entries scan every row to its end, whatever ``lengths`` say."""
    token = _LSTM_IGNORE_LENGTHS.set(bool(on))
    try:
        yield
    finally:
        _LSTM_IGNORE_LENGTHS.reset(token)


@contextlib.contextmanager
def lstm_time_major(on: bool = True):
    """The time-major lane for the DPRNN scans within (see
    :func:`lstm_time_major_available`)."""
    token = _LSTM_TM.set(bool(on))
    try:
        yield
    finally:
        _LSTM_TM.reset(token)


def lstm_time_major_available(bidirectional: bool, lengths: Optional[torch.Tensor] = None
                              ) -> bool:
    """Whether a scan takes the time-major lane: bidirectional, without
    segment checkpointing (``lstm_save_every(q > 1)``), and wanted:
    ``TSS_TM=1`` or ``TSS_TM=0`` in the environment, read at each call, or
    else the :func:`lstm_time_major` context. Masked scans qualify too
    (``lengths`` does not decide). JAX's gate also asks for its Pallas
    backend; the port has one."""
    env = os.environ.get("TSS_TM", "")
    want = _LSTM_TM.get() if env == "" else env == "1"
    return bidirectional and _LSTM_SAVE_EVERY.get() <= 1 and want


def serving_time_major(model: torch.nn.Module):
    """The serving entry points' context: :func:`lstm_time_major` on for a
    model that computes in bf16 when :data:`SERVE_BF16_TIME_MAJOR` says so
    (the JAX Inferencer's default, ``inference/inferencer.py:98-104``)."""
    bf16 = any(getattr(m, "dtype", None) == torch.bfloat16 for m in model.modules())
    return lstm_time_major(SERVE_BF16_TIME_MAJOR and bf16)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as the JAX package computes it: in fp32 one
    rounding (``torch.sigmoid``); in bf16 XLA expands it to 1 / (1 +
    exp(-x)) and rounds each of the three operations to bf16, so the port
    does the same."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def _read_lengths(lengths: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if _LSTM_IGNORE_LENGTHS.get() else lengths


class LSTMWeights(NamedTuple):
    """One direction's weights, laid out for x @ W:

    w_ih: [F, 4H]   (torch weight_ih_l0.T)
    w_hh: [H, 4H]   (torch weight_hh_l0.T)
    b:    [4H]      (torch bias_ih_l0 + bias_hh_l0)
    """

    w_ih: torch.Tensor
    w_hh: torch.Tensor
    b: torch.Tensor


def stack_directions(*directions: LSTMWeights
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The D directions in the kernels' layout: (w_ih [D, F, 4H], b [D, 4H],
    w_hh [D, H, 4H]), contiguous."""
    return (torch.stack([d.w_ih for d in directions]), torch.stack([d.b for d in directions]),
            torch.stack([d.w_hh for d in directions]))


def _records_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _switch(name: str) -> bool:
    """An opt-in switch of the JAX package (``TSS_FUSED_DENSE``, ``TSS_BM``):
    on when the environment holds "1"."""
    return os.environ.get(name, "0") == "1"


def _as_inputs(grads, *inputs):
    """Each gradient in its input's type, as ``_recurrence3_vjp_bwd`` casts
    them (JAX ``ops/rnn.py:411-424``): in the bf16 lane the fp32 dW and db
    reach the fp32 parameters through a bf16 cotangent."""
    return tuple(g.to(t.dtype) for g, t in zip(grads, inputs))


class BiLSTM2(torch.autograd.Function):
    """(x, w_ih2, b2, w_hh2) -> (out_f, out_b), differentiable in all four;
    on a CPU tensor both passes run the kernels' plain versions."""

    @staticmethod
    def forward(ctx, x, w_ih2, b2, w_hh2):
        outs, resid = bilstm2_forward_resid(x, w_ih2, b2, w_hh2)
        ctx.save_for_backward(x, w_ih2, b2, w_hh2, *resid)
        return outs

    @staticmethod
    def backward(ctx, g0, g1):
        x, w_ih2, b2, w_hh2, *resid = ctx.saved_tensors
        return _as_inputs(bilstm2_backward(x, tuple(resid), g0, g1, w_ih2, b2, w_hh2),
                          x, w_ih2, b2, w_hh2)


class BiLSTM2Masked(torch.autograd.Function):
    """(x, lens, w_ih2, b2, w_hh2) -> (out_f, out_b) with direction 1 held
    while t >= lens; lens gets no gradient, and neither do steps past it."""

    @staticmethod
    def forward(ctx, x, lens, w_ih2, b2, w_hh2):
        outs, resid = bilstm2_forward_resid_masked(x, lens, w_ih2, b2, w_hh2)
        ctx.save_for_backward(x, lens, w_ih2, b2, w_hh2, *resid)
        return outs

    @staticmethod
    def backward(ctx, g0, g1):
        x, lens, w_ih2, b2, w_hh2, *resid = ctx.saved_tensors
        dx, dw_ih2, db2, dw_hh2 = _as_inputs(
            bilstm2_backward_masked(x, tuple(resid), g0, g1, w_ih2, b2, w_hh2, lens),
            x, w_ih2, b2, w_hh2)
        return dx, None, dw_ih2, db2, dw_hh2


class BiLSTM2Dense(torch.autograd.Function):
    """(x, w_ih2, b2, w_hh2, wo2) -> (y0, y1), y_d = out_d @ wo2[d],
    differentiable in all five (fp32). The counterpart of
    ``_recurrence3_dense``'s VJP (JAX ``ops/rnn.py:579-615``): the forward
    runs the residual kernel and the two products, the backward the two
    products' transposes and the backward kernel. As in JAX, the products
    are plain matrix products outside any kernel."""

    @staticmethod
    def forward(ctx, x, w_ih2, b2, w_hh2, wo2):
        (o0, o1), resid = bilstm2_forward_resid(x, w_ih2, b2, w_hh2)
        ctx.save_for_backward(x, w_ih2, b2, w_hh2, wo2, o0, o1, *resid)
        return o0 @ wo2[0], o1 @ wo2[1]

    @staticmethod
    def backward(ctx, gy0, gy1):
        x, w_ih2, b2, w_hh2, wo2, o0, o1, *resid = ctx.saved_tensors
        H, Fo = wo2.shape[1:]
        dwo2 = torch.stack([o.reshape(-1, H).T @ gy.reshape(-1, Fo)
                            for o, gy in ((o0, gy0), (o1, gy1))])
        grads = bilstm2_backward(x, tuple(resid), gy0 @ wo2[0].T, gy1 @ wo2[1].T, w_ih2, b2,
                                 w_hh2)
        return (*_as_inputs(grads, x, w_ih2, b2, w_hh2), dwo2)


class BiLSTM2TM(torch.autograd.Function):
    """Time-major :class:`BiLSTM2`: (x [T, R, F], w_ih2, b2, w_hh2) ->
    (out_f, out_b) [T, R, H], the counterpart of ``_recurrence3_tm``'s VJP
    (JAX ``ops/rnn.py:485-519``)."""

    @staticmethod
    def forward(ctx, x, w_ih2, b2, w_hh2):
        outs, resid = bilstm2_forward_resid_tm(x, w_ih2, b2, w_hh2)
        ctx.save_for_backward(x, w_ih2, b2, w_hh2, *resid)
        return outs

    @staticmethod
    def backward(ctx, g0, g1):
        x, w_ih2, b2, w_hh2, *resid = ctx.saved_tensors
        return _as_inputs(bilstm2_backward_tm(x, tuple(resid), g0, g1, w_ih2, b2, w_hh2),
                          x, w_ih2, b2, w_hh2)


class BiLSTM2MaskedTM(torch.autograd.Function):
    """Time-major :class:`BiLSTM2Masked`: (x [T, R, F], lens [R], w_ih2, b2,
    w_hh2) -> (out_f, out_b) [T, R, H], the counterpart of
    ``_recurrence3_masked_tm``'s VJP (JAX ``ops/rnn.py:523-560``); lens gets
    no gradient."""

    @staticmethod
    def forward(ctx, x, lens, w_ih2, b2, w_hh2):
        outs, resid = bilstm2_forward_resid_masked_tm(x, lens, w_ih2, b2, w_hh2)
        ctx.save_for_backward(x, lens, w_ih2, b2, w_hh2, *resid)
        return outs

    @staticmethod
    def backward(ctx, g0, g1):
        x, lens, w_ih2, b2, w_hh2, *resid = ctx.saved_tensors
        dx, dw_ih2, db2, dw_hh2 = _as_inputs(
            bilstm2_backward_tm(x, tuple(resid), g0, g1, w_ih2, b2, w_hh2, lens),
            x, w_ih2, b2, w_hh2)
        return dx, None, dw_ih2, db2, dw_hh2


def lstm_pair_tm(x: torch.Tensor, stacked: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                 lengths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-major :func:`lstm_pair`: x [T, R, F] -> (out_f, out_b), each [T,
    R, H]; ``lengths`` [R] as there (``lstm_ignore_lengths`` drops them).
    For callers that :func:`lstm_time_major_available` admits: when
    autograd records the time-major training entries run
    (:class:`BiLSTM2TM`, :class:`BiLSTM2MaskedTM`), otherwise the inference
    ones."""
    lengths = _read_lengths(lengths)
    w_ih2, b2, w_hh2 = stacked
    if _records_grad(x, w_ih2, b2, w_hh2):
        if lengths is None:
            return BiLSTM2TM.apply(x, w_ih2, b2, w_hh2)
        return BiLSTM2MaskedTM.apply(x, lengths, w_ih2, b2, w_hh2)
    if lengths is None:
        return bilstm2_forward_tm(x, w_ih2, b2, w_hh2)
    return bilstm2_forward_masked_tm(x, lengths, w_ih2, b2, w_hh2)


def lstm_tm(x: torch.Tensor, stacked: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
            ) -> torch.Tensor:
    """Bidirectional LSTM over time-major [T, R, F] -> [T, R, 2H], full
    length (JAX ``lstm_tm``): :func:`lstm_pair_tm` concatenated."""
    return torch.cat(lstm_pair_tm(x, stacked), dim=-1)


def lstm_pair(x: torch.Tensor, stacked: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
              lengths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional LSTM over [B, T, F] -> (out_f, out_b), each [B, T, H],
    zero initial state. ``stacked`` is :func:`stack_directions` of the two
    directions. With ``lengths`` the backward direction reads each row
    reversed within its valid length; out_f past the length is unspecified
    and masked downstream. When autograd records (grad enabled and an input
    requires grad) the training kernels run, or under ``lstm_save_every(q >
    1)`` the segment-checkpointed stacked scan; otherwise the inference one,
    batch-major with ``TSS_BM=1`` when unmasked."""
    lengths = _read_lengths(lengths)
    w_ih2, b2, w_hh2 = stacked
    if _records_grad(x, w_ih2, b2, w_hh2):
        if _LSTM_SAVE_EVERY.get() > 1:
            xr = masked_flip(x, lengths)
            h = LSTMSegments.apply(_LSTM_SAVE_EVERY.get(), torch.stack([x, xr]), *stacked)
            return h[0], masked_flip(h[1], lengths)
        if lengths is None:
            return BiLSTM2.apply(x, w_ih2, b2, w_hh2)
        return BiLSTM2Masked.apply(x, lengths, w_ih2, b2, w_hh2)
    if lengths is None:
        if _switch("TSS_BM"):
            return bilstm2_forward_bm(x, w_ih2, b2, w_hh2)
        return bilstm2_forward(x, w_ih2, b2, w_hh2)
    return bilstm2_forward_masked(x, lengths, w_ih2, b2, w_hh2)


def lstm_split_dense(x: torch.Tensor, stacked: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                     wo2: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BiLSTM -> Dense(2H -> Fo) without its bias: ``out_f @ wo2[0] + out_b @
    wo2[1]`` over [B, T, F] -> [B, T, Fo], wo2 [2, H, Fo] the Dense's two
    halves. With ``TSS_FUSED_DENSE=1`` and no lengths the product runs in the
    fused kernel's epilogue (:class:`BiLSTM2Dense` when autograd records);
    otherwise (and always under ``lstm_save_every(q > 1)``) :func:`lstm_pair`
    and the two half-products."""
    lengths = _read_lengths(lengths)
    if lengths is None and _LSTM_SAVE_EVERY.get() <= 1 and _switch("TSS_FUSED_DENSE"):
        if _records_grad(x, wo2, *stacked):
            y0, y1 = BiLSTM2Dense.apply(x, *stacked, wo2)
        else:
            y0, y1 = bilstm2_dense_forward(x, *stacked, wo2)
        return y0 + y1
    o0, o1 = lstm_pair(x, stacked, lengths)
    return o0 @ wo2[0] + o1 @ wo2[1]


class LSTMStack(torch.autograd.Function):
    """(x [D, R, T, F], w_ih, b, w_hh) -> h [D, R, T, H], differentiable in
    all four; on a CPU tensor both passes run the kernels' plain versions.
    The forward saves the residual mode's four streams (h and c before each
    step, tanh(c), and the gate pre-activations), which the backward reads
    without recomputing a gate."""

    @staticmethod
    def forward(ctx, x, w_ih, b, w_hh):
        out, resid = lstm_forward_resid(x, w_ih, b, w_hh)
        ctx.save_for_backward(x, w_ih, b, w_hh, *resid)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w_ih, b, w_hh, *resid = ctx.saved_tensors
        return _as_inputs(lstm_backward(x, tuple(resid), g, w_ih, b, w_hh), x, w_ih, b, w_hh)


class LSTMSegments(torch.autograd.Function):
    """(q, x [D, R, T, F], w_ih, b, w_hh) -> h [D, R, T, H] with
    segment-checkpointed residuals, the counterpart of ``_recurrence`` at
    ``save_every = q > 1`` (JAX ``ops/rnn.py:198-372``).

    The forward is one launch of ``lstm_forward_with_cs`` and keeps only the
    states entering each of the S = ceil(T / q) segments: zeros for segment
    0, h and c after step s q - 1 for segment s. The backward walks the
    segments in reverse: each runs its q steps forward again from its
    boundary state and then the reverse gate recursion on that segment
    alone, in plain PyTorch (a ``lax.scan`` in JAX; the kernels start from a
    zero state), so one segment's gates are alive at a time. A tail segment
    that q does not fill is zero-padded: zero cotangents, zero gradients.

    In x's type ``cdt`` (fp32, or bf16 in the bf16 lane) it rounds where the
    JAX backward rounds when XLA compiles it: XLA keeps a bf16 op's result
    in fp32 for a use that casts it to fp32 (``xla_allow_excess_precision``),
    so such a use skips the op's last rounding. The input projection and its
    bias add are rounded; the re-forward (``_recurrence_fwd_scan``) rounds h
    @ W_hh, the gate pre-activations, i (its sigmoid's three operations,
    :func:`sigmoid`), g and h, and takes f, o (their sigmoids' last operation
    unrounded) and i * g in fp32, with c in fp32; ``_bwd_steps`` rounds the
    activations and the per-step factors (stored as bf16 arrays) and each
    gate block of dpre, carries dh and dc in fp32 and multiplies dc by the
    unrounded f. The weight gradients sum fp32 casts over the segments, in
    segment order, and are cast to the weights' type at the end; dx is
    rounded to x's type. In fp32 every rounding is a no-op and every sigmoid
    is ``torch.sigmoid``, the forward kernel's; the weight gradients then
    differ from a running sum only in the order of the fp32 additions
    (ulp-level)."""

    @staticmethod
    def forward(ctx, q, x, w_ih, b, w_hh):
        h, cs = lstm_forward_with_cs(x, w_ih, b, w_hh)
        T = x.shape[2]
        ends = torch.arange(q - 1, T - 1, q, device=x.device)
        bh = torch.cat([torch.zeros_like(h[:, :, :1]), h[:, :, ends]], dim=2)
        bc = torch.cat([torch.zeros_like(cs[:, :, :1]), cs[:, :, ends]], dim=2)
        ctx.q = q
        ctx.save_for_backward(x, w_ih, b, w_hh, bh, bc)
        return h

    @staticmethod
    def backward(ctx, g):
        x, w_ih, b, w_hh, bh, bc = ctx.saved_tensors
        q = ctx.q
        cdt = x.dtype
        D, R, T, F = x.shape
        H = w_hh.shape[1]
        S = bh.shape[2]
        pad = S * q - T
        xp = torch.nn.functional.pad(x, (0, 0, 0, pad))
        gp = torch.nn.functional.pad(g, (0, 0, 0, pad))
        w_ih32, w_hh_c = w_ih.float(), w_hh.to(cdt)
        w_hh_t = w_hh.float().transpose(1, 2)

        def sigmoid_f32(v):  # XLA's sigmoid in cdt but for its last rounding
            if cdt == torch.float32:
                return torch.sigmoid(v)
            return 1 / (1 + torch.exp(-v)).float()

        dx = torch.empty_like(xp)
        parts = []  # each segment's (dw_ih, db, dw_hh), fp32
        dh = x.new_zeros(D, R, H, dtype=torch.float32)
        dc = torch.zeros_like(dh)
        for s in reversed(range(S)):
            seg = slice(s * q, (s + 1) * q)
            xs = xp[:, :, seg]
            # the input projection in fp32, rounded, then its bias added in cdt
            pre = torch.einsum("drtf,dfg->drtg", xs.float(), w_ih32).to(cdt) + b[:, None, None]
            # the q steps again, from the boundary state (h in cdt, c fp32); a
            # product in cdt accumulates in fp32 and rounds once, as XLA's
            h, c = bh[:, :, s], bc[:, :, s]
            h_prev, c_prev, gates, cs = [], [], [], []
            for t in range(q):
                gt = pre[:, :, t] + torch.bmm(h, w_hh_c)
                si, sf = sigmoid_f32(gt[..., :2 * H]).split(H, dim=-1)
                so = sigmoid_f32(gt[..., 3 * H:])
                h_prev.append(h)
                c_prev.append(c)
                c = sf * c + si.to(cdt) * torch.tanh(gt[..., 2 * H:3 * H]).float()
                h = (so * torch.tanh(c)).to(cdt)
                gates.append(gt)
                cs.append(c)
            # the reverse recursion; per-step factors first, all steps at once, in cdt
            gi, gf, gg, go = torch.stack(gates, dim=2).split(H, dim=-1)
            fg = sigmoid_f32(gf)  # dc's factor: f as an fp32 use reads it
            i, f, o = (sigmoid(v) for v in (gi, gf, go))
            gg = torch.tanh(gg)
            tc = torch.tanh(torch.stack(cs, dim=2)).to(cdt)
            cp = torch.stack(c_prev, dim=2).to(cdt)
            d_i, d_f, d_g = gg * i * (1 - i), cp * f * (1 - f), i * (1 - gg * gg)
            d_o, dcdh = tc * o * (1 - o), o * (1 - tc * tc)
            d_i, d_f, d_g, d_o, dcdh = (v.float() for v in (d_i, d_f, d_g, d_o, dcdh))
            gs = gp[:, :, seg]
            dpre = x.new_empty(D, R, q, 4 * H)
            for t in reversed(range(q)):
                dh = gs[:, :, t].float() + dh
                dc = dc + dh * dcdh[:, :, t]
                dpre_t = torch.cat([dc * d_i[:, :, t], dc * d_f[:, :, t], dc * d_g[:, :, t],
                                    dh * d_o[:, :, t]], dim=-1).to(cdt)
                dpre[:, :, t] = dpre_t
                dh = torch.bmm(dpre_t.float(), w_hh_t)
                dc = dc * fg[:, :, t]
            dpre32 = dpre.float()
            hp32 = torch.stack(h_prev, dim=2).float()
            parts.append((torch.einsum("drtf,drtg->dfg", xs.float(), dpre32),
                          dpre32.sum(dim=(1, 2)), torch.einsum("drth,drtg->dhg", hp32, dpre32)))
            dx[:, :, seg] = torch.einsum("drtg,dfg->drtf", dpre32, w_ih32).to(cdt)
        dw_ih, db, dw_hh = (torch.stack(p[::-1]).sum(0) for p in zip(*parts))
        return (None, dx[:, :, :T], dw_ih.to(w_ih.dtype), db.to(b.dtype),
                dw_hh.to(w_hh.dtype))


def lstm_stack(x: torch.Tensor, stacked: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
               ) -> torch.Tensor:
    """LSTM over D stacked directions, x [D, R, T, F] -> [D, R, T, H], each
    direction on its own input in forward time, zero initial state.
    ``stacked`` is :func:`stack_directions` of the D directions. When
    autograd records the training kernels run (:class:`LSTMSegments` under
    ``lstm_save_every(q > 1)``); otherwise the inference one."""
    if _records_grad(x, *stacked):
        if _LSTM_SAVE_EVERY.get() > 1:
            return LSTMSegments.apply(_LSTM_SAVE_EVERY.get(), x, *stacked)
        return LSTMStack.apply(x, *stacked)
    return lstm_forward(x, *stacked)


def lstm(x: torch.Tensor, fwd: LSTMWeights, bwd: Optional[LSTMWeights] = None,
         lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Bi)LSTM over [B, T, F] -> [B, T, H * ndir], zero initial state.

    With ``bwd`` this is :func:`lstm_pair`, concatenated. Without, one
    forward direction: ``lengths`` are not used, and outputs at padded steps
    are unspecified by construction (the consumer masks them, as it masks the
    bidirectional scan's forward direction)."""
    if bwd is not None:
        return torch.cat(lstm_pair(x, stack_directions(fwd, bwd), lengths), dim=-1)
    return lstm_stack(x[None], stack_directions(fwd))[0]


# (w_ih [F, G], w_hh [H, G], b_ih [G], b_hh [G]) of one direction of a GRU
# (G = 3H, torch gate order r, z, n) or a tanh RNN (G = H)
CellWeights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _scan(xs: torch.Tensor, w_hh: torch.Tensor, step) -> torch.Tensor:
    """h_t = step(xp_t, h_(t-1)) from a zero state over xs [B, T, G] -> [B, T, H]."""
    B, T, _ = xs.shape
    h = xs.new_zeros(B, w_hh.shape[0])
    outs = []
    for t in range(T):
        h = step(xs[:, t], h)
        outs.append(h)
    return torch.stack(outs, dim=1)


def _both_directions(run, x: torch.Tensor, fwd: CellWeights, bwd: Optional[CellWeights],
                     lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Direction 0 over x; direction 1 over each row reversed within its
    length, its output reversed back; concatenated on the feature axis."""
    out = run(x, *fwd)
    if bwd is None:
        return out
    out_b = masked_flip(run(masked_flip(x, lengths), *bwd), lengths)
    return torch.cat([out, out_b], dim=-1)


def vanilla_rnn(x: torch.Tensor, fwd: CellWeights, bwd: Optional[CellWeights] = None,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Bi) tanh RNN over [B, T, F] (torch nn.RNN): h = tanh(x W_ih + b_ih +
    b_hh + h W_hh) -> [B, T, H * ndir]."""
    def run(xs, w_ih, w_hh, b_ih, b_hh):
        return _scan(xs @ w_ih + b_ih + b_hh, w_hh,
                     lambda xp_t, h: torch.tanh(xp_t + h @ w_hh))

    return _both_directions(run, x, fwd, bwd, lengths)


def gru(x: torch.Tensor, fwd: CellWeights, bwd: Optional[CellWeights] = None,
        lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Bi)GRU over [B, T, F] (torch nn.GRU: gate order r, z, n, separate
    input and hidden biases) -> [B, T, H * ndir]."""
    def run(xs, w_ih, w_hh, b_ih, b_hh):
        H = w_hh.shape[0]

        def step(xp_t, h):
            hp = h @ w_hh + b_hh
            r = sigmoid(xp_t[:, :H] + hp[:, :H])
            z = sigmoid(xp_t[:, H:2 * H] + hp[:, H:2 * H])
            n = torch.tanh(xp_t[:, 2 * H:] + r * hp[:, 2 * H:])
            return (1 - z) * n + z * h

        return _scan(xs @ w_ih + b_ih, w_hh, step)

    return _both_directions(run, x, fwd, bwd, lengths)
