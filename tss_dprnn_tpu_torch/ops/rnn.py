"""Bidirectional LSTM op layer
(counterpart of ``tss_dprnn_tpu/ops/rnn.py:112-122, 374-481, 745-764``).

Every DPRNN scan is a bidirectional LSTM feeding a Dense(2H -> N), so the
layer returns the per-direction pair and leaves the concatenation out.
Without gradients the pair comes from the inference kernel; with them, from
:class:`BiLSTM2` / :class:`BiLSTM2Masked`, whose forward runs the residual
mode and whose backward runs the backward kernel (the counterparts of
``_recurrence3`` and ``_recurrence3_masked``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from tss_dprnn_tpu_torch.ops.bilstm2 import (
    bilstm2_backward,
    bilstm2_backward_masked,
    bilstm2_forward,
    bilstm2_forward_masked,
    bilstm2_forward_resid,
    bilstm2_forward_resid_masked,
)


class LSTMWeights(NamedTuple):
    """One direction's weights, laid out for x @ W:

    w_ih: [F, 4H]   (torch weight_ih_l0.T)
    w_hh: [H, 4H]   (torch weight_hh_l0.T)
    b:    [4H]      (torch bias_ih_l0 + bias_hh_l0)
    """

    w_ih: torch.Tensor
    w_hh: torch.Tensor
    b: torch.Tensor


def stack_directions(fwd: LSTMWeights, bwd: LSTMWeights
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pair in the kernel's layout: (w_ih2 [2, F, 4H], b2 [2, 4H],
    w_hh2 [2, H, 4H]), contiguous."""
    return (torch.stack([fwd.w_ih, bwd.w_ih]), torch.stack([fwd.b, bwd.b]),
            torch.stack([fwd.w_hh, bwd.w_hh]))


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
        return bilstm2_backward(x, tuple(resid), g0, g1, w_ih2, b2, w_hh2)


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
        dx, dw_ih2, db2, dw_hh2 = bilstm2_backward_masked(x, tuple(resid), g0, g1, w_ih2, b2,
                                                          w_hh2, lens)
        return dx, None, dw_ih2, db2, dw_hh2


def lstm_pair(x: torch.Tensor, stacked: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
              lengths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional LSTM over [B, T, F] -> (out_f, out_b), each [B, T, H],
    zero initial state. ``stacked`` is :func:`stack_directions` of the two
    directions. With ``lengths`` the backward direction reads each row
    reversed within its valid length; out_f past the length is unspecified
    and masked downstream. When autograd records (grad enabled and an input
    requires grad) the training kernels run; otherwise the inference one."""
    w_ih2, b2, w_hh2 = stacked
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w_ih2, b2, w_hh2)):
        if lengths is None:
            return BiLSTM2.apply(x, w_ih2, b2, w_hh2)
        return BiLSTM2Masked.apply(x, lengths, w_ih2, b2, w_hh2)
    if lengths is None:
        return bilstm2_forward(x, w_ih2, b2, w_hh2)
    return bilstm2_forward_masked(x, lengths, w_ih2, b2, w_hh2)
