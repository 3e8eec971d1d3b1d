"""Bidirectional LSTM op layer
(counterpart of ``tss_dprnn_tpu/ops/rnn.py:112-122, 745-764``).

Every DPRNN scan is a bidirectional LSTM feeding a Dense(2H -> N), so the
layer returns the per-direction pair and leaves the concatenation out.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from tss_dprnn_tpu_torch.ops.bilstm2 import bilstm2_forward, bilstm2_forward_masked


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


def lstm_pair(x: torch.Tensor, stacked: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
              lengths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional LSTM over [B, T, F] -> (out_f, out_b), each [B, T, H],
    zero initial state. ``stacked`` is :func:`stack_directions` of the two
    directions (the JAX op stacks them on every call; a model here stacks
    them once). With ``lengths`` the backward direction reads each row
    reversed within its valid length; out_f past the length is unspecified
    and masked downstream."""
    w_ih2, b2, w_hh2 = stacked
    if lengths is None:
        return bilstm2_forward(x, w_ih2, b2, w_hh2)
    return bilstm2_forward_masked(x, lengths, w_ih2, b2, w_hh2)
