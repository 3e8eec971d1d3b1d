"""Plain PyTorch reference of DPRNN-TasNet and DPRNN-Spe-TasNet ('att' fusion).

Written from the published description (Luo et al. 2020, arXiv:1910.06379;
the SpEx+ speaker encoder, arXiv:2005.04686) and the reference toolkit's
torch model as the configurations ship it: a TasNet encoder (Conv1d, ReLU),
a bottleneck (GroupNorm(1, N) + 1x1 conv), n_repeats dual-path blocks (an
intra-chunk and an inter-chunk bidirectional LSTM, each followed by a Linear,
a GroupNorm over the whole chunked tensor and a residual add), the mask head
(PReLU, 1x1 Conv2d to two sources, overlap-add, a tanh x sigmoid gate, a 1x1
conv, sigmoid) and a transposed-conv decoder. It imports nothing of the
program: the weights arrive as a dict keyed by the reference model's
``state_dict`` names, and every tensor the program derives from them
(stacked LSTM weights, lengths, masks) is worked out here again.

The recurrent layers are ``torch.nn.LSTM`` (cuDNN on the card) called with
these weights through ``torch.func.functional_call``; the products are
``torch.nn.functional.linear`` and the (de)convolutions unfolded products.
Everything runs in float32; :func:`precision` turns TF32 off (the reference)
or on (the control one precision below).

It runs one request at its own length, so the core needs no masks: the
program's masked, padded batch equals this on each row's valid samples.
Training batches are fixed-length crops whose references are zero-padded to
the batch's longest, so the speaker encoder takes each reference's true
length: its input norm and the mean over its pooled frames see only valid
frames, and its BatchNorms, in training, normalise over every frame of the
padded batch (the toolkit's layout).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

Params = Dict[str, torch.Tensor]

GROUPNORM_EPS = 1e-5  # torch GroupNorm(1, C), norm_type 'ln'
GLOBLN_EPS = 1e-8     # the toolkit's GlobLN, norm_type 'gLN'
BATCHNORM_EPS = 1e-5


@contextlib.contextmanager
def precision(tf32: bool) -> Iterator[None]:
    """float32 products with TF32 off (``tf32=False``, the reference) or on
    (the control), restored afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def dense(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """A Linear or 1x1 convolution on channels-last x."""
    w = p[f"{name}.weight"]
    return F.linear(x, w.reshape(w.shape[0], -1), p.get(f"{name}.bias"))


def norm(p: Params, name: str, x: torch.Tensor, norm_type: str,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm(1, C) ('ln') or GlobLN ('gLN') on channels-last x: one mean
    and biased variance per example over every other axis, over the frames
    where ``mask`` (broadcastable to x) is 1; masked frames come out 0."""
    wname, bname = ("weight", "bias") if norm_type == "ln" else ("gamma", "beta")
    eps = GROUPNORM_EPS if norm_type == "ln" else GLOBLN_EPS
    dims = tuple(range(1, x.ndim))
    if mask is None:
        var, mean = torch.var_mean(x, dim=dims, keepdim=True, correction=0)
        return (x - mean) / torch.sqrt(var + eps) * p[f"{name}.{wname}"] + p[f"{name}.{bname}"]
    m = mask.expand_as(x)
    count = m.sum(dim=dims, keepdim=True)
    mean = (x * m).sum(dim=dims, keepdim=True) / count
    var = ((x - mean) ** 2 * m).sum(dim=dims, keepdim=True) / count
    y = (x - mean) / torch.sqrt(var + eps) * p[f"{name}.{wname}"] + p[f"{name}.{bname}"]
    return y * m


def prelu(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.prelu(x, p[f"{name}.weight"])


def batch_norm(p: Params, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    """BatchNorm1d on channels-last [B, L, C]: batch statistics over every
    frame in training, the running ones in eval."""
    y = F.batch_norm(x.transpose(1, 2), None if train else p[f"{name}.running_mean"],
                     None if train else p[f"{name}.running_var"], p[f"{name}.weight"],
                     p[f"{name}.bias"], training=train, eps=BATCHNORM_EPS)
    return y.transpose(1, 2)


_LSTMS: Dict[Tuple[int, int, bool], torch.nn.LSTM] = {}


def lstm(p: Params, name: str, x: torch.Tensor, bidirectional: bool = True) -> torch.Tensor:
    """A one-layer torch LSTM over [R, T, F] (batch first) with the weights
    ``{name}.weight_ih_l0`` ...: [R, T, H * directions]."""
    H, Fin = p[f"{name}.weight_hh_l0"].shape[1], p[f"{name}.weight_ih_l0"].shape[1]
    key = (Fin, H, bidirectional)
    if key not in _LSTMS:
        _LSTMS[key] = torch.nn.LSTM(Fin, H, batch_first=True, bidirectional=bidirectional,
                                    device="meta")
    module = _LSTMS[key]
    module.train(torch.is_grad_enabled())  # cuDNN keeps what its backward needs only so
    weights = {k: p[f"{name}.{k}"] for k, _ in module.named_parameters()}
    return functional_call(module, weights, (x,))[0]


def encoder(p: Params, wav: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Conv1d(1 -> N, kernel, stride, no bias) + ReLU: [B, T] -> [B, L, N]."""
    w = p["encoder.conv1d.weight"]
    frames = wav.unfold(1, kernel, stride)  # [B, L, kernel]
    return torch.relu(frames @ w.reshape(w.shape[0], kernel).T)


def _overlap_add(frames: torch.Tensor, length: int, hop: int) -> torch.Tensor:
    """[B, S, K, C] frames laid at s * hop and summed: [B, length, C]."""
    B, S, K, C = frames.shape
    pos = (torch.arange(S, device=frames.device)[:, None] * hop
           + torch.arange(K, device=frames.device)[None, :]).reshape(-1)
    out = frames.new_zeros(B, length, C)
    return out.index_add(1, pos, frames.reshape(B, S * K, C))


def decoder(p: Params, feats: torch.Tensor, kernel: int, stride: int, T: int) -> torch.Tensor:
    """ConvTranspose1d(N -> 1, kernel, stride, no bias) on [B, L, N], padded
    with zeros or cut to T samples: [B, T]."""
    w = p["decoder.weight"]
    B, L, _ = feats.shape
    frames = (feats @ w.reshape(w.shape[0], kernel))[:, :, None, :]  # [B, L, 1, kernel]
    out = _overlap_add(frames.transpose(2, 3), (L - 1) * stride + kernel, stride)[..., 0]
    return F.pad(out, (0, T - out.shape[1])) if out.shape[1] < T else out[:, :T]


def segment(x: torch.Tensor, K: int, hop: int) -> torch.Tensor:
    """[B, L, N] zero-padded by K on both sides, cut into S chunks of K
    frames every hop frames: [B, S, K, N], S = (L + K) // hop + 1."""
    B, L, N = x.shape
    S = (L + K) // hop + 1
    padded = F.pad(x, (0, 0, K, K))
    idx = (torch.arange(S, device=x.device)[:, None] * hop
           + torch.arange(K, device=x.device)[None, :])
    return padded[:, idx]


def dprnn_block(p: Params, name: str, x: torch.Tensor, norm_type: str,
                bidirectional: bool) -> torch.Tensor:
    """One dual-path block on [B, S, K, N]."""
    B, S, K, N = x.shape
    h = lstm(p, f"{name}.intra_rnn.rnn", x.reshape(B * S, K, N))
    h = dense(p, f"{name}.intra_linear", h).reshape(B, S, K, N)
    x = x + norm(p, f"{name}.intra_norm", h, norm_type)
    h = lstm(p, f"{name}.inter_rnn.rnn", x.transpose(1, 2).reshape(B * K, S, N), bidirectional)
    h = dense(p, f"{name}.inter_linear", h).reshape(B, K, S, N).transpose(1, 2)
    return x + norm(p, f"{name}.inter_norm", h, norm_type)


def dprnn_core(p: Params, m: dict, h: torch.Tensor) -> torch.Tensor:
    """Chunking, the blocks and the mask head: [B, L, F] -> masks [B, 2, L, N]."""
    B, L, Fs = h.shape
    K, hop = m["chunk_length"], m["hop_length"]
    x = segment(h, K, hop)
    for i in range(m["n_repeats"]):
        x = dprnn_block(p, f"separation.dprnn_blocks.{i}", x, m["norm_type"],
                        m.get("bidirectional", True))
    x = dense(p, "separation.conv2d", prelu(p, "separation.prelu", x))  # [B, S, K, 2F]
    S = x.shape[1]
    # output channel j * F + f is source j's feature f
    x = x.reshape(B, S, K, 2, Fs).permute(0, 3, 1, 2, 4).reshape(2 * B, S, K, Fs)
    x = _overlap_add(x, L + 2 * K, hop)[:, K:K + L]
    x = torch.tanh(dense(p, "separation.out.0", x)) * torch.sigmoid(
        dense(p, "separation.gate.0", x))
    x = dense(p, "separation.end_conv1x1", x)
    x = torch.sigmoid(x) if m["activation_type"] == "sigmoid" else torch.relu(x)
    return x.reshape(B, 2, L, -1)


def _res_block(p: Params, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    y = prelu(p, f"{name}.prelu1", batch_norm(p, f"{name}.batch_norm1",
                                              dense(p, f"{name}.conv1", x), train))
    y = batch_norm(p, f"{name}.batch_norm2", dense(p, f"{name}.conv2", y), train)
    skip = dense(p, f"{name}.conv_downsample", x) if f"{name}.conv_downsample.weight" in p else x
    y = prelu(p, f"{name}.prelu2", y + skip)
    return F.max_pool1d(y.transpose(1, 2), 3).transpose(1, 2)


def speaker_embedding(p: Params, m: dict, feats: torch.Tensor, ref_len: torch.Tensor,
                      train: bool) -> torch.Tensor:
    """The ResNet speaker encoder on the reference's encoder features
    [B, La, N] with the references' true sample counts: [B, E], the mean of
    its output over the valid frames left after three max-pools of 3."""
    kernel = m["kernel_size"]
    frames = (ref_len.long() - kernel) // max(kernel // 2, 1) + 1
    t = torch.arange(feats.shape[1], device=feats.device)
    mask = (t[None, :] < frames[:, None]).to(feats.dtype)[:, :, None]
    h = dense(p, "separation.spk_encoder.1",
              norm(p, "separation.spk_encoder.0", feats, "ln", mask))
    for i in (2, 3, 4):
        h = _res_block(p, f"separation.spk_encoder.{i}", h, train)
    h = dense(p, "separation.spk_encoder.5", h)  # [B, L3, E]
    pooled = frames // 27
    t = torch.arange(h.shape[1], device=h.device)
    keep = (t[None, :] < pooled[:, None]).to(h.dtype)[:, :, None]
    return (h * keep).sum(dim=1) / pooled.to(h.dtype)[:, None]


def attention_fusion(p: Params, aux: torch.Tensor, h: torch.Tensor, kernel: int) -> torch.Tensor:
    """'att': h [B, L, N] scaled per frame by the nearest-upsampled
    softmax-over-time attention of the width-``kernel`` mean-pooled features
    with the projected embedding."""
    a = dense(p, "separation.fusion_linear", aux)[:, :, None]  # [B, N, 1]
    pooled = F.avg_pool1d(h.transpose(1, 2), kernel)            # [B, N, L // kernel]
    weights = torch.softmax((pooled * a).sum(dim=1, keepdim=True), dim=2)
    att = F.interpolate(weights * a + a, size=h.shape[1], mode="nearest")
    return h * att.transpose(1, 2)


def tss_forward(p: Params, m: dict, mix: torch.Tensor, ref: torch.Tensor,
                ref_len: torch.Tensor, train: bool = False,
                fusion: Callable = attention_fusion, speaker: Callable = speaker_embedding
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DPRNN-Spe-TasNet: (target estimate [B, T], speaker logits [B, spks]),
    with ``fusion(p, aux, h, kernel)`` between the bottleneck's norm and its
    1x1 conv ('att' by default) and the speaker branch
    ``speaker(p, m, feats, ref_len, train)`` (the ResNet by default)."""
    kernel = m["kernel_size"]
    stride = max(kernel // 2, 1)
    feats = encoder(p, mix, kernel, stride)
    aux = speaker(p, m, encoder(p, ref, kernel, stride), ref_len, train)
    h = norm(p, "separation.bottleneck.0", feats, m["norm_type"])
    h = dense(p, "separation.bottleneck.1", fusion(p, aux, h, kernel))
    masks = dprnn_core(p, m, h)
    est = decoder(p, masks[:, 0] * feats, kernel, stride, mix.shape[1])
    return est, dense(p, "separation.pred_linear", aux)


def bss_forward(p: Params, m: dict, mix: torch.Tensor) -> torch.Tensor:
    """DPRNN-TasNet: both sources' estimates [B, 2, T]."""
    kernel = m["kernel_size"]
    stride = max(kernel // 2, 1)
    feats = encoder(p, mix, kernel, stride)
    h = dense(p, "separation.bottleneck.1",
              norm(p, "separation.bottleneck.0", feats, m["norm_type"]))
    masks = dprnn_core(p, m, h)
    B, _, L, N = masks.shape
    est = decoder(p, (masks * feats[:, None]).reshape(2 * B, L, N), kernel, stride,
                  mix.shape[1])
    return est.reshape(B, 2, -1)
