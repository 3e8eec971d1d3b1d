"""DPRNN core, encoder and decoder
and DPRNN-TasNet (counterpart of ``tss_dprnn_tpu/models/dprnn.py:47-449``).

Channels-last inside the core ([B, L, N] and [B, S, K, N]); segmentation
and overlap-add from ``ops/chunking.py``; every bidirectional LSTM goes
through the fused kernel (``ops/bilstm2.py``) together with its Dense
(``ops/rnn.py`` ``lstm_split_dense``: the opt-in switches pick the kernel),
unmasked for the intra-chunk scan and masked by chunk counts for the
inter-chunk scan; with
``bidirectional=False`` the inter-chunk scan is one forward direction
through the stacked-direction kernel (``ops/lstm.py``). Where
``ops/rnn.lstm_time_major_available`` says so (``TSS_TM=1``, or the
serving context), a bidirectional LSTM core runs its blocks time-major
([K, B, S, N]: each scan reads and writes the time-major entries' [T, R,
.]); only the layout differs, the parameters and the function are the
same. Module and
parameter names follow the reference's torch model, which keeps the
dual-path stack directly on its separation module; :class:`DPRNNCore`
therefore carries those names and the separation modules subclass it.

``dtype=torch.bfloat16`` (the bf16 lane, the JAX models' ``dtype``) runs
the core in bf16: the bottleneck's output is masked, then cast, before
segmentation; every block, the mask head and the overlap-add compute in
bf16 (the scans stream bf16); the masks come out bf16 and the mask-times-
features product promotes to fp32, so the encoder, decoder, bottleneck and
speaker branches stay fp32. Parameters stay fp32 in either lane, so a
checkpoint loads in both.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from tss_dprnn_tpu_torch.models.layers import Dense, GlobalNorm, PReLU, RNNCore, SplitDense
from tss_dprnn_tpu_torch.ops import chunking
from tss_dprnn_tpu_torch.ops import rnn as rnn_ops
from tss_dprnn_tpu_torch.ops.conv import conv1d, conv_transpose1d
from tss_dprnn_tpu_torch.ops.masking import length_mask


class DPRNNBlock(nn.Module):
    """One dual-path block: intra-chunk BiRNN + inter-chunk (Bi)RNN, each
    followed by Linear + global norm + residual. [B, S, K, N] -> same.
    ``chunk_lengths`` ([B] true chunk counts) masks the padded-S region.
    With ``bidirectional=False`` the inter-chunk scan is one forward
    direction feeding a Dense(H -> N); it does not use the chunk counts, and
    the masked norm drops what it computes on padded chunks. A bidirectional
    LSTM scan contracts with its Dense per direction; a GRU or RNN, as in the
    JAX block, returns the concatenation and its Dense takes that. With
    ``time_major`` (bidirectional LSTMs only) x is [K, B, S, N] (JAX
    ``DPRNNBlock._tm_call``, ``models/dprnn.py:119-161``)."""

    def __init__(self, feature_size: int, hidden_size: int, norm_type: str = "gLN",
                 bidirectional: bool = True, rnn_type: str = "LSTM",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        N, H = feature_size, hidden_size
        self.intra_rnn = RNNCore(N, H, True, rnn_type, dtype)
        self.intra_linear = SplitDense(2 * H, N, dtype=dtype)
        self.intra_norm = GlobalNorm(N, norm_type)
        self.inter_rnn = RNNCore(N, H, bidirectional, rnn_type, dtype)
        self.inter_linear = (SplitDense(2 * H, N, dtype=dtype) if bidirectional
                             else Dense(H, N, dtype=dtype))
        self.inter_norm = GlobalNorm(N, norm_type)

    def forward(self, x: torch.Tensor, chunk_lengths: Optional[torch.Tensor] = None,
                time_major: bool = False) -> torch.Tensor:
        if time_major:
            return self._tm_forward(x, chunk_lengths)
        B, S, K, N = x.shape
        chunk_mask = None
        inter_lengths = None
        if chunk_lengths is not None:
            s = torch.arange(S, device=x.device)
            chunk_mask = (s[None, :] < chunk_lengths[:, None]).to(x.dtype)[:, :, None, None]
            inter_lengths = chunk_lengths.repeat_interleave(K)

        lstm = self.intra_rnn.rnn_type == "LSTM"
        # intra-chunk pass: sequences of length K over B*S rows, unmasked
        # (padded chunks carry zeros; the norm's mask drops their outputs)
        h = x.reshape(B * S, K, N)
        if lstm:
            wo2, bias = self.intra_linear.halves()
            h = self.intra_rnn(h, dense_kernel=wo2) + bias
        else:
            h = self.intra_linear(self.intra_rnn(h))
        x = x + self.intra_norm(h.reshape(B, S, K, N), chunk_mask)

        # inter-chunk pass: sequences of length S over B*K rows
        h = x.transpose(1, 2).reshape(B * K, S, N)
        if lstm and self.inter_rnn.bidirectional:
            wo2, bias = self.inter_linear.halves()
            h = self.inter_rnn(h, inter_lengths, dense_kernel=wo2) + bias
        else:
            h = self.inter_linear(self.inter_rnn(h, inter_lengths))
        h = h.reshape(B, K, S, N).transpose(1, 2)
        return x + self.inter_norm(h, chunk_mask)

    def _tm_forward(self, x: torch.Tensor, chunk_lengths: Optional[torch.Tensor]
                    ) -> torch.Tensor:
        """The time-major body: x [K, B, S, N] -> the same. The intra scan
        runs over time K on B*S rows, the inter scan over time S on B*K rows
        (masked by the chunk counts); the two K <-> S transposes are the
        only relayouts. The chunk mask rides [1, B, S, 1] and the norms keep
        per-example statistics on axis 1; each scan's pair contracts with its
        Dense's halves. Bidirectional LSTMs only: the RNNCores raise on
        anything else."""
        K, B, S, N = x.shape
        chunk_mask = None
        inter_lengths = None
        if chunk_lengths is not None:
            s = torch.arange(S, device=x.device)
            chunk_mask = (s[None, :] < chunk_lengths[:, None]).to(x.dtype)[None, :, :, None]
            inter_lengths = chunk_lengths.repeat_interleave(K)

        def dense(linear, pair):
            wo2, bias = linear.halves()
            return pair[0] @ wo2[0] + pair[1] @ wo2[1] + bias

        # intra-chunk pass: time K, rows B*S, unmasked (as batch-major)
        h = self.intra_rnn(x.reshape(K, B * S, N), time_major=True, return_pair=True)
        h = dense(self.intra_linear, h).reshape(K, B, S, N)
        x = x + self.intra_norm(h, chunk_mask, batch_axis=1)

        # inter-chunk pass: time S, rows B*K
        x = x.permute(2, 1, 0, 3)  # [S, B, K, N]
        h = self.inter_rnn(x.reshape(S, B * K, N), inter_lengths, time_major=True,
                           return_pair=True)
        h = dense(self.inter_linear, h).reshape(S, B, K, N)
        inter_mask = None if chunk_mask is None else chunk_mask.permute(2, 1, 0, 3)
        x = x + self.inter_norm(h, inter_mask, batch_axis=1)
        return x.permute(2, 1, 0, 3)  # back to [K, B, S, N]


class DPRNNCore(nn.Module):
    """Segmentation -> n_repeats blocks -> mask head -> overlap-add.
    ``forward(h [B, L, F], time_mask, chunk_lengths) -> masks [B, 2, L, N]``."""

    def __init__(self, input_size: int, feature_size: int, hidden_size: int,
                 chunk_length: int, hop_length: Optional[int], n_repeats: int,
                 norm_type: str = "gLN", activation_type: str = "sigmoid",
                 bidirectional: bool = True, rnn_type: str = "LSTM",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if activation_type not in ("sigmoid", "relu"):
            raise ValueError(f"activation_type must be sigmoid/relu, got {activation_type}")
        self.input_size = input_size
        self.chunk_length = chunk_length
        self.hop_length = hop_length if hop_length is not None else chunk_length // 2
        self.n_repeats = n_repeats
        self.activation_type = activation_type
        self.dtype = dtype
        # the time-major lane takes bidirectional LSTM cores only
        self.tm_capable = bidirectional and rnn_type == "LSTM"
        Fs = feature_size
        self.dprnn_blocks = nn.ModuleList(
            DPRNNBlock(Fs, hidden_size, norm_type, bidirectional, rnn_type, dtype)
            for _ in range(n_repeats))
        self.prelu = PReLU()
        self.conv2d = Dense(Fs, 2 * Fs, conv_dims=2, dtype=dtype)
        self.out = nn.Sequential(Dense(Fs, Fs, conv_dims=1, dtype=dtype))
        self.gate = nn.Sequential(Dense(Fs, Fs, conv_dims=1, dtype=dtype))
        self.end_conv1x1 = Dense(Fs, input_size, bias=False, conv_dims=1, dtype=dtype)

    def forward(self, h: torch.Tensor, time_mask: Optional[torch.Tensor] = None,
                chunk_lengths: Optional[torch.Tensor] = None, checkpoint_blocks: int = 0,
                tap_block: Optional[int] = None,
                resume: Optional[Tuple[int, torch.Tensor]] = None):
        """``checkpoint_blocks`` k: under autograd the first k blocks run under
        ``torch.utils.checkpoint`` (non-reentrant): they keep no activation
        and run again in the backward, the JAX core's ``remat``; the values
        are the same for any k.

        ``tap_block`` k: also return the chunk-layout activation after block
        k (k = 0: the segmented input), as ``(masks, tap)``. ``resume=(k,
        tap)``: ``h`` is a delta, masked and segmented like an input, added
        onto ``tap``, and only blocks k..n_repeats-1 run. Segmentation and
        masking are linear, so ``resume=(0, tap)`` is exactly the call on the
        tapped input plus the delta (``tss_dprnn_tpu/models/dprnn.py:204-212,
        237-256``). The tap is in the blocks' working layout: [B, S, K, N],
        or [K, B, S, N] when the blocks run time-major
        (``rnn_ops.lstm_time_major_available``, decided at each call, as
        JAX's ``use_tm``, :226-232)."""
        B, L, Fs = h.shape
        if time_mask is not None:
            h = h * time_mask  # the padded tail is exactly zero before segmentation
        if self.dtype is not None:
            h = h.to(self.dtype)  # before segmentation: the chunked tensor is in the lane's type
        h = chunking.segment_cl(h, self.chunk_length, self.hop_length)  # [B, S, K, F]
        use_tm = self.tm_capable and rnn_ops.lstm_time_major_available(True, chunk_lengths)
        if use_tm:
            h = h.permute(2, 0, 1, 3)  # [K, B, S, F]
        start = 0
        if resume is not None:
            start, tap_in = resume
            h = tap_in + h  # the first blocks' residuals of the tapped call ride in
        tap = h if tap_block == 0 else None
        for i in range(start, len(self.dprnn_blocks)):
            block = self.dprnn_blocks[i]
            if i < checkpoint_blocks and torch.is_grad_enabled():
                h = torch.utils.checkpoint.checkpoint(block, h, chunk_lengths, use_tm,
                                                      use_reentrant=False)
            else:
                h = block(h, chunk_lengths, use_tm)
            if tap_block is not None and i + 1 == tap_block:
                tap = h
        if use_tm:
            h = h.permute(1, 2, 0, 3)  # back to [B, S, K, F]
        h = self.conv2d(self.prelu(h))  # [B, S, K, 2F]
        S, K = h.shape[1], h.shape[2]
        # channel c = j*F + f belongs to source j (torch's reshape(B*2, F, K, S))
        h = h.reshape(B, S, K, 2, Fs).permute(0, 3, 1, 2, 4).reshape(B * 2, S, K, Fs)
        h = chunking.overlap_add_cl(h, L, self.hop_length)  # [2B, L, F]
        h = torch.tanh(self.out(h)) * rnn_ops.sigmoid(self.gate(h))
        h = self.end_conv1x1(h)
        h = rnn_ops.sigmoid(h) if self.activation_type == "sigmoid" else torch.relu(h)
        masks = h.reshape(B, 2, L, self.input_size)
        return masks if tap_block is None else (masks, tap)


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


class DPRNN(DPRNNCore):
    """Dual-path separation module: bottleneck (norm + 1x1 conv) and the
    core. ``forward(features [B, L, N], lengths=None) -> masks [B, 2, L, N]``;
    ``lengths`` are feature-frame counts."""

    def __init__(self, input_size: int, feature_size: int = 128, hidden_size: int = 128,
                 chunk_length: int = 200, hop_length: Optional[int] = None, n_repeats: int = 6,
                 bidirectional: bool = True, rnn_type: str = "LSTM", norm_type: str = "gLN",
                 activation_type: str = "sigmoid", dtype: Optional[torch.dtype] = None):
        super().__init__(input_size, feature_size, hidden_size, chunk_length, hop_length,
                         n_repeats, norm_type, activation_type, bidirectional, rnn_type, dtype)
        self.bottleneck = nn.Sequential(GlobalNorm(input_size, norm_type),
                                        Dense(input_size, feature_size, conv_dims=1))

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        time_mask = chunk_lengths = None
        if lengths is not None:
            time_mask = length_mask(lengths, x.shape[1])[:, :, None]
            chunk_lengths = (lengths + self.chunk_length) // self.hop_length + 1
        norm, dense = self.bottleneck
        return super().forward(dense(norm(x, time_mask)), time_mask, chunk_lengths)


class DPRNNTasNet(nn.Module):
    """DPRNN-TasNet blind source separation.

    ``forward(mix [B, T], lengths=None) -> [B, 2, T]`` separated waveforms;
    ``lengths`` are the mixtures' true sample counts."""

    def __init__(self, input_size: int, feature_size: int = 128, hidden_size: int = 128,
                 chunk_length: int = 200, kernel_size: int = 2,
                 hop_length: Optional[int] = None, n_repeats: int = 6,
                 bidirectional: bool = True, rnn_type: str = "LSTM", norm_type: str = "ln",
                 activation_type: str = "sigmoid", dropout: float = 0.0,
                 stride: Optional[int] = None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        # dropout is accepted for config parity: a one-layer LSTM ignores it
        self.kernel_size = kernel_size
        self.stride = stride if stride is not None else kernel_size // 2
        self.encoder = Encoder(kernel_size, input_size, self.stride)
        self.separation = DPRNN(input_size, feature_size, hidden_size, chunk_length, hop_length,
                                n_repeats, bidirectional, rnn_type, norm_type, activation_type,
                                dtype)
        self.decoder = Decoder(input_size, kernel_size, self.stride)

    def feat_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return (lengths - self.kernel_size) // self.stride + 1

    def forward(self, mix: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T = mix.shape
        feats = self.encoder(mix)  # [B, L, N]
        f_lengths = None if lengths is None else self.feat_lengths(lengths)
        out = self.separation(feats, f_lengths) * feats[:, None]  # [B, 2, L, N]
        L, N = out.shape[2:]
        if f_lengths is not None:
            # padded frames would smear into the last valid sample
            out = out * length_mask(f_lengths, L, out.dtype)[:, None, :, None]
        return _fit_length(self.decoder(out.reshape(B * 2, L, N)), T).reshape(B, 2, T)
