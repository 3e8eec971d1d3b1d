"""RawNet3 speaker embedder (counterpart of ``tss_dprnn_tpu/models/rawnet.py:33-300``).

The reference wraps asteroid's ``ParamSincFB`` and builds its Res2Net blocks
in ``RawNet3.py`` / ``RawNetBasicBlock.py``; this module keeps their
``state_dict`` names (``preprocess``, ``conv1.filterbank``, ``layer1..4``,
``attention``, ``bn5``, ``fc6``; the ``bn1`` the reference defines and never
runs is kept, unused). The ECA encoder with context statistics and the
``summed`` branch topology, as DPRNN-RawNet builds it.

Channels-last and length-masked: the padded tail is zeroed before every
'same'-padded conv, so a bucketed run equals the run of each reference at
its own length (the reference's zero padding at the true end coincides
with the mask). The whole embedder runs in fp32, as the reference runs it
with autocast off.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tss_dprnn_tpu_torch.models.layers import BatchNorm, Dense
from tss_dprnn_tpu_torch.ops import sinc as sinc_ops
from tss_dprnn_tpu_torch.ops.conv import conv1d
from tss_dprnn_tpu_torch.ops.masking import length_mask, masked_softmax

SINC_KERNEL = 251  # asteroid ParamSincFB(C // 4, 251, stride) in the reference


def _time_mask(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, T, C] zeroed past each row's length; unchanged without lengths."""
    if lengths is None:
        return x
    return x * length_mask(lengths, x.shape[1], x.dtype)[:, :, None]


def _masked_time_mean(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, T, C] -> [B, 1, C], the mean over each row's valid frames."""
    if lengths is None:
        return x.mean(dim=1, keepdim=True)
    m = length_mask(lengths, x.shape[1], x.dtype)[:, :, None]
    return (x * m).sum(dim=1, keepdim=True) / m.sum(dim=1, keepdim=True).clamp_min(1.0)


def _max_pool_time(x: torch.Tensor, p: int) -> torch.Tensor:
    """nn.MaxPool1d(p) over time, channels-last: [B, T, C] -> [B, T // p, C]."""
    B, T, C = x.shape
    n = T // p
    return x[:, : n * p].reshape(B, n, p, C).amax(dim=2)


def pre_emphasis(wav: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """y[t] = x[t] - coef x[t-1], with x[-1] := x[1] (torch's reflect pad (1, 0))."""
    padded = torch.cat([wav[:, 1:2], wav], dim=1)
    return padded[:, 1:] - coef * padded[:, :-1]


def masked_instance_norm(x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                         eps: float = 1e-4, weight=1.0, bias=0.0) -> torch.Tensor:
    """nn.InstanceNorm1d(1, affine) over time of [B, T] signals, statistics
    over each row's valid samples (the input's tail is zeroed first)."""
    if lengths is None:
        mean = x.mean(dim=1, keepdim=True)
        var = (x - mean).square().mean(dim=1, keepdim=True)
    else:
        m = length_mask(lengths, x.shape[1], x.dtype)
        n = m.sum(dim=1, keepdim=True).clamp_min(1.0)
        mean = (x * m).sum(dim=1, keepdim=True) / n
        var = ((x - mean).square() * m).sum(dim=1, keepdim=True) / n
        x = x * m
    return (x - mean) / torch.sqrt(var + eps) * weight + bias


class Conv1d(nn.Module):
    """torch nn.Conv1d's parameters (``weight`` [O, I, K], ``bias`` [O]) and
    its 'same' dilated forward on channels-last input: [B, T, I] -> [B, T, O]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, dilation: int = 1):
        super().__init__()
        self.dilation = dilation
        self.padding = (kernel_size // 2) * dilation
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(x.transpose(1, 2), self.weight, self.bias, padding=self.padding,
                      dilation=self.dilation).transpose(1, 2)


class _PreEmphasis(nn.Module):
    """Holds the reference's frozen pre-emphasis filter (a constant)."""

    def __init__(self, coef: float = 0.97):
        super().__init__()
        self.register_buffer("flipped_filter", torch.tensor([[[-coef, 1.0]]]))


class _InstanceNormAffine(nn.Module):
    """The affine of the reference's nn.InstanceNorm1d(1, eps=1e-4, affine=True)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))
        self.bias = nn.Parameter(torch.empty(1))


class ParamSincFB(nn.Module):
    """The learnable sinc filterbank: ``n_filters // 2`` bands with learnable
    (``low_hz_``, ``band_hz_``), a cosine- and a sine-phase filter each; the
    reference's ``window_`` and ``n_`` are kept as buffers of the config."""

    def __init__(self, n_filters: int, kernel_size: int, sample_rate: float = 16000.0,
                 min_low_hz: float = 50.0, min_band_hz: float = 50.0):
        super().__init__()
        self.kernel_size, self.sample_rate = kernel_size, sample_rate
        self.min_low_hz, self.min_band_hz = min_low_hz, min_band_hz
        n_band = n_filters // 2
        self.low_hz_ = nn.Parameter(torch.empty(n_band, 1))
        self.band_hz_ = nn.Parameter(torch.empty(n_band, 1))
        window, n_ = sinc_ops.sinc_buffers(kernel_size, sample_rate)
        self.register_buffer("window_", window)
        self.register_buffer("n_", n_)

    def init_bands_(self) -> None:
        """The mel-spaced initial bands (asteroid's initialisation)."""
        low, band = sinc_ops.mel_init_bands(self.low_hz_.shape[0], self.sample_rate,
                                            self.min_low_hz, self.min_band_hz)
        with torch.no_grad():
            self.low_hz_.copy_(torch.from_numpy(low))
            self.band_hz_.copy_(torch.from_numpy(band))

    def filters(self) -> torch.Tensor:
        """[n_filters, 1, kernel_size], fp32, from the current parameters."""
        return sinc_ops.sinc_filters(self.low_hz_, self.band_hz_, self.kernel_size,
                                     self.sample_rate, self.min_low_hz, self.min_band_hz)


class _SincEncoder(nn.Module):
    """The reference's ``conv1``: the filterbank as a strided conv.
    [B, T] -> [B, (T - K) // stride + 1, n_filters]."""

    def __init__(self, n_filters: int, kernel_size: int, stride: int, sample_rate: float):
        super().__init__()
        self.stride = stride
        self.filterbank = ParamSincFB(n_filters, kernel_size, sample_rate)

    def out_length(self, lengths: torch.Tensor) -> torch.Tensor:
        return (lengths - self.filterbank.kernel_size) // self.stride + 1

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return conv1d(wav[:, None, :], self.filterbank.filters(), stride=self.stride).transpose(1, 2)


class AFMS(nn.Module):
    """Alpha feature-map scaling: (x + alpha) * sigmoid(fc(mean over time)),
    the mean over each row's valid frames. ``alpha`` is [C, 1] as the
    reference holds it."""

    def __init__(self, nb_dim: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(nb_dim, 1))
        self.fc = Dense(nb_dim, nb_dim)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = torch.sigmoid(self.fc(_masked_time_mean(x, lengths)[:, 0]))  # [B, C]
        return (x + self.alpha[:, 0]) * y[:, None, :]


class Bottle2neck(nn.Module):
    """Res2Net block with dilated convs and AFMS: [B, T, inplanes] ->
    ([B, T // pool, planes], the pooled lengths); pool 0 pools nothing."""

    def __init__(self, inplanes: int, planes: int, kernel_size: int = 3, dilation: int = 1,
                 scale: int = 4, pool: int = 0):
        super().__init__()
        width = planes // scale
        self.width, self.pool = width, pool
        self.conv1 = Dense(inplanes, width * scale, conv_dims=1)
        self.bn1 = BatchNorm(width * scale)
        self.convs = nn.ModuleList(Conv1d(width, width, kernel_size, dilation)
                                   for _ in range(scale - 1))
        self.bns = nn.ModuleList(BatchNorm(width) for _ in range(scale - 1))
        self.conv3 = Dense(width * scale, planes, conv_dims=1)
        self.bn3 = BatchNorm(planes)
        self.residual = (nn.Sequential(Dense(inplanes, planes, bias=False, conv_dims=1))
                         if inplanes != planes else None)
        self.afms = AFMS(planes)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        residual = x if self.residual is None else self.residual(x)
        out = self.bn1(torch.relu(self.conv1(x)))
        chunks = torch.split(out, self.width, dim=-1)
        outs = []
        sp = None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = chunks[i] if i == 0 else sp + chunks[i]
            sp = _time_mask(sp, lengths)  # the exact run's zero padding at the true end
            sp = bn(torch.relu(conv(sp)))
            outs.append(sp)
        outs.append(chunks[len(self.convs)])
        out = self.bn3(torch.relu(self.conv3(torch.cat(outs, dim=-1))))
        out = out + residual
        if self.pool:
            out = _max_pool_time(out, self.pool)
            lengths = None if lengths is None else lengths // self.pool
        return self.afms(out, lengths), lengths


class RawNet3(nn.Module):
    """RawNet3 embedder: ``forward(wav [B, T] at 16 kHz, lengths=None) ->
    [B, nOut]``; ``lengths`` are the true sample counts (the tail past them
    is ignored)."""

    def __init__(self, C: int = 1024, model_scale: int = 8, nOut: int = 256,
                 sinc_stride: int = 10, sample_rate: float = 16000.0):
        super().__init__()
        self.preprocess = nn.Sequential(_PreEmphasis(), _InstanceNormAffine())
        self.conv1 = _SincEncoder(C // 4, SINC_KERNEL, sinc_stride, sample_rate)
        self.bn1 = BatchNorm(C // 4)  # defined by the reference and never run
        self.layer1 = Bottle2neck(C // 4, C, 3, 2, model_scale, pool=5)
        self.layer2 = Bottle2neck(C, C, 3, 3, model_scale, pool=3)
        self.layer3 = Bottle2neck(C, C, 3, 4, model_scale, pool=0)
        self.layer4 = Dense(3 * C, 1536, conv_dims=1)
        self.attention = nn.Sequential(Dense(1536 * 3, 128, conv_dims=1), nn.ReLU(),
                                       BatchNorm(128), Dense(128, 1536, conv_dims=1))
        self.bn5 = BatchNorm(3072)
        self.fc6 = Dense(3072, nOut)

    def forward(self, wav: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        wav = wav.to(self.fc6.weight.dtype)  # fp32 in every model the port builds
        if lengths is not None:
            lengths = lengths.long()
        affine = self.preprocess[1]
        x = masked_instance_norm(pre_emphasis(wav), lengths, 1e-4, affine.weight[0],
                                 affine.bias[0])
        # the sinc front end: |conv|, log, mean over the valid frames removed
        x = torch.log(self.conv1(x).abs() + 1e-6)  # [B, T0, C / 4]
        l0 = None if lengths is None else self.conv1.out_length(lengths)
        x = _time_mask(x - _masked_time_mean(x, l0), l0)

        x1, l1 = self.layer1(x, l0)
        x2, l2 = self.layer2(x1, l1)
        mp_x1 = _max_pool_time(x1, 3)[:, : x2.shape[1]]
        x3, _ = self.layer3(mp_x1 + x2, l2)  # the summed topology
        x = _time_mask(torch.relu(self.layer4(torch.cat([mp_x1, x2, x3], dim=-1))), l2)

        # context statistics: the unbiased variance over the valid frames
        t = x.shape[1]
        tm = None if l2 is None else length_mask(l2, t, x.dtype)[:, :, None]
        if tm is None:
            mean = x.mean(dim=1, keepdim=True)
            var = (x - mean).square().mean(dim=1, keepdim=True) * (t / max(t - 1.0, 1.0))
        else:
            n = tm.sum(dim=1, keepdim=True).clamp_min(1.0)
            mean = (x * tm).sum(dim=1, keepdim=True) / n
            var = ((x - mean) * tm).square().sum(dim=1, keepdim=True) / (n - 1.0).clamp_min(1.0)
        sg = torch.sqrt(var.clamp(1e-4, 1e4))
        global_x = torch.cat([x, mean.expand_as(x), sg.expand_as(x)], dim=-1)

        conv_in, relu, bn, conv_out = self.attention
        w = masked_softmax(conv_out(bn(relu(conv_in(global_x)))), tm, dim=1)  # [B, t, 1536]
        mu = (x * w).sum(dim=1)
        sg = torch.sqrt((((x * x) * w).sum(dim=1) - mu * mu).clamp(1e-4, 1e4))
        return self.fc6(self.bn5(torch.cat([mu, sg], dim=-1)))
