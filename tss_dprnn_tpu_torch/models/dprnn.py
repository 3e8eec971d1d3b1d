"""DPRNN core, encoder and decoder
(counterpart of ``tss_dprnn_tpu/models/dprnn.py:47-386``).

Channels-last inside the core ([B, L, N] and [B, S, K, N]); segmentation
and overlap-add from ``ops/chunking.py``; every bidirectional LSTM goes
through the fused kernel (``ops/bilstm2.py``), unmasked for the intra-chunk
scan and masked by chunk counts for the inter-chunk scan. Module and
parameter names follow the reference's torch model, which keeps the
dual-path stack directly on its separation module; :class:`DPRNNCore`
therefore carries those names and the separation modules subclass it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tss_dprnn_tpu_torch.models.layers import Dense, GlobalNorm, PReLU, RNNCore, SplitDense
from tss_dprnn_tpu_torch.ops import chunking
from tss_dprnn_tpu_torch.ops.conv import conv1d, conv_transpose1d


class DPRNNBlock(nn.Module):
    """One dual-path block: intra-chunk BiLSTM + inter-chunk BiLSTM, each
    followed by Linear + global norm + residual. [B, S, K, N] -> same.
    ``chunk_lengths`` ([B] true chunk counts) masks the padded-S region."""

    def __init__(self, feature_size: int, hidden_size: int, norm_type: str = "gLN"):
        super().__init__()
        N, H = feature_size, hidden_size
        self.intra_rnn = RNNCore(N, H)
        self.intra_linear = SplitDense(2 * H, N)
        self.intra_norm = GlobalNorm(N, norm_type)
        self.inter_rnn = RNNCore(N, H)
        self.inter_linear = SplitDense(2 * H, N)
        self.inter_norm = GlobalNorm(N, norm_type)

    def forward(self, x: torch.Tensor, chunk_lengths: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        B, S, K, N = x.shape
        chunk_mask = None
        inter_lengths = None
        if chunk_lengths is not None:
            s = torch.arange(S, device=x.device)
            chunk_mask = (s[None, :] < chunk_lengths[:, None]).to(x.dtype)[:, :, None, None]
            inter_lengths = chunk_lengths.repeat_interleave(K)

        # intra-chunk pass: sequences of length K over B*S rows, unmasked
        # (padded chunks carry zeros; the norm's mask drops their outputs)
        h = self.intra_linear(*self.intra_rnn(x.reshape(B * S, K, N)))
        x = x + self.intra_norm(h.reshape(B, S, K, N), chunk_mask)

        # inter-chunk pass: sequences of length S over B*K rows
        h = x.transpose(1, 2).reshape(B * K, S, N)
        h = self.inter_linear(*self.inter_rnn(h, inter_lengths))
        h = h.reshape(B, K, S, N).transpose(1, 2)
        return x + self.inter_norm(h, chunk_mask)


class DPRNNCore(nn.Module):
    """Segmentation -> n_repeats blocks -> mask head -> overlap-add.
    ``forward(h [B, L, F], time_mask, chunk_lengths) -> masks [B, 2, L, N]``."""

    def __init__(self, input_size: int, feature_size: int, hidden_size: int,
                 chunk_length: int, hop_length: Optional[int], n_repeats: int,
                 norm_type: str = "gLN", activation_type: str = "sigmoid"):
        super().__init__()
        if activation_type not in ("sigmoid", "relu"):
            raise ValueError(f"activation_type must be sigmoid/relu, got {activation_type}")
        self.input_size = input_size
        self.chunk_length = chunk_length
        self.hop_length = hop_length if hop_length is not None else chunk_length // 2
        self.activation_type = activation_type
        Fs = feature_size
        self.dprnn_blocks = nn.ModuleList(
            DPRNNBlock(Fs, hidden_size, norm_type) for _ in range(n_repeats))
        self.prelu = PReLU()
        self.conv2d = Dense(Fs, 2 * Fs, conv_dims=2)
        self.out = nn.Sequential(Dense(Fs, Fs, conv_dims=1))
        self.gate = nn.Sequential(Dense(Fs, Fs, conv_dims=1))
        self.end_conv1x1 = Dense(Fs, input_size, bias=False, conv_dims=1)

    def forward(self, h: torch.Tensor, time_mask: Optional[torch.Tensor] = None,
                chunk_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, L, Fs = h.shape
        if time_mask is not None:
            h = h * time_mask  # the padded tail is exactly zero before segmentation
        h = chunking.segment_cl(h, self.chunk_length, self.hop_length)  # [B, S, K, F]
        for block in self.dprnn_blocks:
            h = block(h, chunk_lengths)
        h = self.conv2d(self.prelu(h))  # [B, S, K, 2F]
        S, K = h.shape[1], h.shape[2]
        # channel c = j*F + f belongs to source j (torch's reshape(B*2, F, K, S))
        h = h.reshape(B, S, K, 2, Fs).permute(0, 3, 1, 2, 4).reshape(B * 2, S, K, Fs)
        h = chunking.overlap_add_cl(h, L, self.hop_length)  # [2B, L, F]
        h = torch.tanh(self.out(h)) * torch.sigmoid(self.gate(h))
        h = self.end_conv1x1(h)
        h = torch.sigmoid(h) if self.activation_type == "sigmoid" else torch.relu(h)
        return h.reshape(B, 2, L, self.input_size)


class _Conv1dWeight(nn.Module):
    """Holds a bias-free Conv1d weight under the name ``weight``."""

    def __init__(self, out_channels: int, in_channels: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))


class Encoder(nn.Module):
    """TasNet encoder: Conv1d(1 -> N, kernel, stride, no bias) + ReLU.
    [B, T] -> [B, L, N] channels-last."""

    def __init__(self, kernel_size: int, output_size: int, stride: int):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.conv1d = _Conv1dWeight(output_size, 1, kernel_size)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        feats = conv1d(wav[:, None, :], self.conv1d.weight, stride=self.stride)
        return torch.relu(feats).transpose(1, 2)


class Decoder(nn.Module):
    """TasNet decoder: ConvTranspose1d(N -> 1, kernel, stride, no bias).
    [B, L, N] -> [B, T_out]."""

    def __init__(self, input_size: int, kernel_size: int, stride: int):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(input_size, 1, kernel_size))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return conv_transpose1d(feats.transpose(1, 2), self.weight, stride=self.stride)[:, 0]


def _fit_length(wav: torch.Tensor, T: int) -> torch.Tensor:
    """Pad or crop decoder output to the input length."""
    Tp = wav.shape[-1]
    if Tp < T:
        return F.pad(wav, (0, T - Tp))
    return wav[:, :T]
