"""DPRNN-Spe-TasNet: target speech separation with a SpEx+-style ResNet
speaker encoder and one of five fusions, 'cat', 'add', 'mul', 'film' or
'att' (counterpart of ``tss_dprnn_tpu/models/dprnn_spe.py:37-304``).

Reference quirks kept:
- the aux_T mean-pool divisor is float floor-division arithmetic with stride
  ``kernel_size // 2`` whatever the configured stride;
- the 'att' fusion's frozen depthwise average conv is a mean pool; its
  constant tensors stay registered as buffers (``separation.average.*``) so
  reference-format state_dicts load strictly;
- 'cat' widens the bottleneck 1x1 conv's input to N + E.
The reference keeps the fusion's parameters on its separation module
(``fusion_linear``; 'film' has ``fusion_linear_1`` and ``fusion_linear_2``,
'cat' none), so the fusion is a method of :class:`DPRNNSpe` rather than a
child module.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tss_dprnn_tpu_torch.models.dprnn import DPRNNCore, Decoder, Encoder, _fit_length
from tss_dprnn_tpu_torch.models.layers import BatchNorm, Dense, GlobalNorm, PReLU
from tss_dprnn_tpu_torch.ops import fusion as fusion_ops
from tss_dprnn_tpu_torch.ops.masking import length_mask


def _pool3_cl(x: torch.Tensor) -> torch.Tensor:
    """nn.MaxPool1d(3) on channels-last [B, L, C] -> [B, floor(L/3), C]."""
    B, L, C = x.shape
    n = L // 3
    return x[:, : n * 3].reshape(B, n, 3, C).amax(dim=2)


class ResBlock(nn.Module):
    """1x1 conv -> BN -> PReLU -> 1x1 conv -> BN -> (+skip) -> PReLU ->
    maxpool3. [B, L, C_in] -> [B, floor(L/3), C_out]. The BatchNorms follow
    ``module.training``: batch statistics in training, running ones in eval
    (the JAX package's ``train`` flag, models/dprnn_spe.py:53-58, 85-96)."""

    def __init__(self, in_dims: int, out_dims: int):
        super().__init__()
        self.conv1 = Dense(in_dims, out_dims, bias=False, conv_dims=1)
        self.batch_norm1 = BatchNorm(out_dims)
        self.prelu1 = PReLU()
        self.conv2 = Dense(out_dims, out_dims, bias=False, conv_dims=1)
        self.batch_norm2 = BatchNorm(out_dims)
        self.prelu2 = PReLU()
        if in_dims != out_dims:
            self.conv_downsample = Dense(in_dims, out_dims, bias=False, conv_dims=1)
        else:
            self.conv_downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.prelu1(self.batch_norm1(self.conv1(x)))
        y = self.batch_norm2(self.conv2(y))
        y = y + (x if self.conv_downsample is None else self.conv_downsample(x))
        return _pool3_cl(self.prelu2(y))


class SpeakerEncoder(nn.Sequential):
    """The reference's ``spk_encoder`` Sequential: GroupNorm, 1x1 conv,
    three ResBlocks, 1x1 conv, then a mean over the pooled frames.

    ``forward(feats [B, La, N], feat_lengths, aux_T) -> [B, E]``:
    ``feat_lengths`` masks the norm and picks the summed frames; ``aux_T``
    is the mean's divisor, computed from the reference-waveform length."""

    def __init__(self, N: int, O: int, P: int, embeddings_size: int):
        super().__init__(GlobalNorm(N, "ln"), Dense(N, O, conv_dims=1), ResBlock(O, O),
                         ResBlock(O, P), ResBlock(P, P), Dense(P, embeddings_size, conv_dims=1))

    def forward(self, feats: torch.Tensor, feat_lengths: Optional[torch.Tensor] = None,
                aux_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        norm, conv_in, res1, res2, res3, conv_out = self
        mask = None if feat_lengths is None else (
            length_mask(feat_lengths, feats.shape[1], feats.dtype)[:, :, None])
        h = conv_out(res3(res2(res1(conv_in(norm(feats, mask))))))  # [B, L3, E]
        if feat_lengths is None:
            total = h.sum(dim=1)
            count = torch.full((h.shape[0],), float(h.shape[1]), dtype=h.dtype, device=h.device)
        else:
            l3 = ((feat_lengths // 3) // 3) // 3  # valid frames after three maxpool3s
            total = (h * length_mask(l3, h.shape[1], h.dtype)[:, :, None]).sum(dim=1)
            count = l3.to(h.dtype)
        div = count if aux_T is None else aux_T.to(h.dtype)
        return total / div[:, None]


class _FrozenAverage(nn.Module):
    """The reference's frozen depthwise 'average' conv (weights 1/kernel,
    stride kernel). Its tensors are constants of the config; the forward
    computes the same thing as ``ops.fusion.mean_pool_time``."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.register_buffer("weight", torch.full((channels, 1, kernel_size), 1.0 / kernel_size))
        self.register_buffer("bias", torch.zeros(channels))


FUSION_TYPES = ("cat", "add", "mul", "film", "att")


class DPRNNSpe(DPRNNCore):
    """Dual-path core + speaker branch + fusion.

    ``forward(x [B, L, N], embeddings [B, La, N], aux_len [B], lengths=None)
    -> (masks [B, 2, L, N], logits [B, num_spks])``; ``aux_len`` holds the
    true reference-waveform sample counts."""

    def __init__(self, input_size: int, feature_size: int = 128, hidden_size: int = 128,
                 chunk_length: int = 200, hop_length: Optional[int] = None, n_repeats: int = 6,
                 norm_type: str = "gLN", activation_type: str = "sigmoid", O: int = 128,
                 P: int = 256, embeddings_size: int = 128, num_spks: int = 251,
                 kernel_size: int = 2, fusion_type: str = "att", bidirectional: bool = True,
                 rnn_type: str = "LSTM", dtype: Optional[torch.dtype] = None):
        if fusion_type not in FUSION_TYPES:
            raise ValueError(f"fusion_type must be one of {FUSION_TYPES}, got {fusion_type!r}")
        super().__init__(input_size, feature_size, hidden_size, chunk_length, hop_length,
                         n_repeats, norm_type, activation_type, bidirectional, rnn_type, dtype)
        N, E = input_size, embeddings_size
        self.kernel_size = kernel_size
        self.fusion_type = fusion_type
        fused = N + E if fusion_type == "cat" else N
        self.bottleneck = nn.Sequential(GlobalNorm(N, norm_type),
                                        Dense(fused, feature_size, conv_dims=1))
        self.spk_encoder = SpeakerEncoder(N, O, P, E)
        if fusion_type == "film":
            self.fusion_linear_1 = Dense(E, N)
            self.fusion_linear_2 = Dense(E, N)
        elif fusion_type != "cat":
            self.fusion_linear = Dense(E, N)
        if fusion_type == "att":
            self.average = _FrozenAverage(N, kernel_size)
        self.pred_linear = Dense(E, num_spks)

    def embed(self, embeddings: torch.Tensor, aux_len: torch.Tensor) -> torch.Tensor:
        """The reference's speaker embedding [B, E] from its encoder
        features [B, La, N] and its true waveform sample counts."""
        return self.spk_encoder(embeddings, self.aux_feat_len(aux_len.long()), self.aux_T(aux_len))

    def aux_feat_len(self, aux_len: torch.Tensor) -> torch.Tensor:
        """Speaker-encoder input length in frames, stride kernel_size // 2."""
        stride = max(self.kernel_size // 2, 1)
        return (aux_len - self.kernel_size) // stride + 1

    def aux_T(self, aux_len: torch.Tensor) -> torch.Tensor:
        """The reference's float mean-pool divisor."""
        stride = float(max(self.kernel_size // 2, 1))
        t = torch.div(aux_len.float() - self.kernel_size, stride, rounding_mode="floor") + 1.0
        for _ in range(3):
            t = torch.div(t, 3.0, rounding_mode="floor")
        return t

    def fuse(self, aux: torch.Tensor, h: torch.Tensor,
             lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """aux [B, E], h [B, L, N] normalised -> [B, L, N] ([B, L, N + E] for
        'cat'); only 'att' reads the lengths."""
        ft = self.fusion_type
        if ft == "cat":
            return fusion_ops.concatenation(aux, h)
        if ft == "add":
            return fusion_ops.addition(self.fusion_linear(aux), h)
        if ft == "mul":
            return fusion_ops.multiplication(self.fusion_linear(aux), h)
        if ft == "film":
            return fusion_ops.film(self.fusion_linear_1(aux), self.fusion_linear_2(aux), h)
        return fusion_ops.attention(self.fusion_linear(aux), h, self.kernel_size, lengths)

    def masks_for(self, lengths: Optional[torch.Tensor], L: int):
        """(time mask [B, L, 1], chunk counts [B]) of feature-frame lengths,
        or (None, None)."""
        if lengths is None:
            return None, None
        return (length_mask(lengths, L)[:, :, None],
                (lengths + self.chunk_length) // self.hop_length + 1)

    def forward(self, x: torch.Tensor, embeddings: torch.Tensor, aux_len: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        time_mask, chunk_lengths = self.masks_for(lengths, x.shape[1])
        aux = self.embed(embeddings, aux_len)  # [B, E]
        norm, dense = self.bottleneck
        h = dense(self.fuse(aux, norm(x, time_mask), lengths))
        return super().forward(h, time_mask, chunk_lengths), self.pred_linear(aux)


class DPRNNSpeTasNet(nn.Module):
    """DPRNN-Spe-TasNet: one shared encoder for mixture and reference; only
    the target (mask 0) is decoded.

    ``forward(mix [B, T], aux [B, Ta], aux_len [B], lengths=None)
    -> (target_wav [B, T], speaker_logits [B, num_spks])``. A subclass
    names its separation module in ``separation_cls``; keyword arguments
    beyond this class's go to it. ``dtype`` is the core's compute type (the
    speaker branch, fusion and bottleneck stay fp32, as in JAX)."""

    separation_cls = DPRNNSpe

    def __init__(self, input_size: int, feature_size: int = 128, hidden_size: int = 128,
                 chunk_length: int = 200, kernel_size: int = 2,
                 hop_length: Optional[int] = None, n_repeats: int = 6,
                 bidirectional: bool = True, norm_type: str = "gLN",
                 activation_type: str = "sigmoid", dropout: float = 0.0,
                 stride: Optional[int] = None, O: int = 128, P: int = 256,
                 embeddings_size: int = 128, num_spks: int = 251, fusion_type: str = "att",
                 rnn_type: str = "LSTM", dtype: Optional[torch.dtype] = None,
                 **separation_kwargs):
        super().__init__()
        # dropout is accepted for config parity: a one-layer LSTM ignores it
        self.kernel_size = kernel_size
        self.stride = stride if stride is not None else kernel_size // 2
        self.encoder = Encoder(kernel_size, input_size, self.stride)
        self.separation = self.separation_cls(
            input_size, feature_size, hidden_size, chunk_length, hop_length, n_repeats,
            norm_type, activation_type, O, P, embeddings_size, num_spks, kernel_size,
            fusion_type, bidirectional, rnn_type, dtype=dtype, **separation_kwargs)
        self.decoder = Decoder(input_size, kernel_size, self.stride)

    def feat_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return (lengths - self.kernel_size) // self.stride + 1

    def aux_input(self, aux: torch.Tensor) -> torch.Tensor:
        """What the speaker branch reads: the reference's encoder features."""
        return self.encoder(aux)

    def forward(self, mix: torch.Tensor, aux: torch.Tensor, aux_len: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        T = mix.shape[1]
        feats = self.encoder(mix)  # [B, L, N]
        f_lengths = None if lengths is None else self.feat_lengths(lengths)
        masks, logits = self.separation(feats, self.aux_input(aux), aux_len, f_lengths)
        target = masks[:, 0] * feats
        if f_lengths is not None:
            # padded frames would smear into the last valid sample
            target = target * length_mask(f_lengths, target.shape[1], target.dtype)[:, :, None]
        return _fit_length(self.decoder(target), T), logits
