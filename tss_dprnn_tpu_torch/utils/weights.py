"""JAX model variables -> the port's (reference-format) torch state_dict.

The port's own copy of the JAX package's exporter
(``tss_dprnn_tpu/utils/torch_export.py:31-128, 131-204``), every family:
``variables`` are the flax variables as nested dicts of numpy arrays
(``params`` plus ``batch_stats``); the result loads with ``strict=True``
into :class:`~tss_dprnn_tpu_torch.models.dprnn.DPRNNTasNet` (either
``bidirectional`` setting, every ``rnn_type``: the GRU's gates are 3H wide,
the RNN's H), :class:`~tss_dprnn_tpu_torch.models.dprnn_spe.DPRNNSpeTasNet`
(every fusion), :class:`~tss_dprnn_tpu_torch.models.dprnn_spe_ira.DPRNNSpeIRATasNet`
(``aux_linear``) and :class:`~tss_dprnn_tpu_torch.models.dprnn_rawnet.DPRNNRawNetTasNet`
(the RawNet3 tree). Frozen tensors the reference carries are synthesised:
they are functions of the config, not learned state (the 'att' average
conv, BatchNorm's ``num_batches_tracked``, the pre-emphasis filter, the
sinc filterbank's ``window_`` and ``n_``, and the defaults of the ``bn1``
RawNet3 defines and never runs).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(x) -> np.ndarray:
    return np.asarray(x).T.copy()


def _conv1x1(kernel) -> np.ndarray:  # Dense kernel [I, O] -> Conv1d weight [O, I, 1]
    return np.asarray(kernel).T[:, :, None].copy()


def _copy(x) -> np.ndarray:
    return np.asarray(x).copy()


def _rnn_entries(out, prefix, tree):
    for tag, sfx in (("f", ""), ("b", "_reverse")):
        if f"w_ih_{tag}" not in tree:  # a unidirectional RNN has no *_b parameters
            continue
        out[f"{prefix}.weight_ih_l0{sfx}"] = _t(tree[f"w_ih_{tag}"])
        out[f"{prefix}.weight_hh_l0{sfx}"] = _t(tree[f"w_hh_{tag}"])
        out[f"{prefix}.bias_ih_l0{sfx}"] = _copy(tree[f"b_ih_{tag}"])
        out[f"{prefix}.bias_hh_l0{sfx}"] = _copy(tree[f"b_hh_{tag}"])


def _norm_entries(out, prefix, tree, norm_type):
    wname, bname = ("gamma", "beta") if norm_type == "gLN" else ("weight", "bias")
    out[f"{prefix}.{wname}"] = _copy(tree["gamma"])
    out[f"{prefix}.{bname}"] = _copy(tree["beta"])


def _dense_entries(out, prefix, tree, conv: bool = False):
    out[f"{prefix}.weight"] = _conv1x1(tree["kernel"]) if conv else _t(tree["kernel"])
    if "bias" in tree:
        out[f"{prefix}.bias"] = _copy(tree["bias"])


def _bn_entries(out, prefix, params, stats):
    out[f"{prefix}.weight"] = _copy(params["scale"])
    out[f"{prefix}.bias"] = _copy(params["bias"])
    out[f"{prefix}.running_mean"] = _copy(stats["mean"])
    out[f"{prefix}.running_var"] = _copy(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def _resblock_entries(out, prefix, p, s):
    _dense_entries(out, f"{prefix}.conv1", p["conv1"], conv=True)
    _bn_entries(out, f"{prefix}.batch_norm1", p["batch_norm1"], s["batch_norm1"])
    out[f"{prefix}.prelu1.weight"] = _copy(p["prelu1"]["a"])
    _dense_entries(out, f"{prefix}.conv2", p["conv2"], conv=True)
    _bn_entries(out, f"{prefix}.batch_norm2", p["batch_norm2"], s["batch_norm2"])
    out[f"{prefix}.prelu2.weight"] = _copy(p["prelu2"]["a"])
    if "conv_downsample" in p:
        _dense_entries(out, f"{prefix}.conv_downsample", p["conv_downsample"], conv=True)


def _bn_default(out, prefix, channels: int):
    """torch's default BatchNorm tensors, for the ``bn1`` RawNet3 defines
    and never runs: its checkpoint values are untrained noise."""
    out[f"{prefix}.weight"] = np.ones(channels, np.float32)
    out[f"{prefix}.bias"] = np.zeros(channels, np.float32)
    out[f"{prefix}.running_mean"] = np.zeros(channels, np.float32)
    out[f"{prefix}.running_var"] = np.ones(channels, np.float32)
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def _rawnet_entries(out, prefix, sk, sk_stats, sinc_kernel: int, sample_rate: float):
    """The RawNet3 tree (``torch_export.py:83-128`` of the JAX package)
    under ``prefix`` ('separation.spk_encoder')."""
    from tss_dprnn_tpu_torch.ops.sinc import sinc_buffers

    out[f"{prefix}.preprocess.0.flipped_filter"] = np.array([[[-0.97, 1.0]]], np.float32)
    out[f"{prefix}.preprocess.1.weight"] = _copy(sk["inorm_weight"])
    out[f"{prefix}.preprocess.1.bias"] = _copy(sk["inorm_bias"])
    low = np.asarray(sk["conv1"]["low_hz_"])
    out[f"{prefix}.conv1.filterbank.low_hz_"] = low.copy()
    out[f"{prefix}.conv1.filterbank.band_hz_"] = _copy(sk["conv1"]["band_hz_"])
    window, n_ = sinc_buffers(sinc_kernel, sample_rate)
    out[f"{prefix}.conv1.filterbank.window_"] = window.numpy()
    out[f"{prefix}.conv1.filterbank.n_"] = n_.numpy()
    _bn_default(out, f"{prefix}.bn1", 2 * low.shape[0])  # C // 4 filters of C // 8 bands
    for name in ("layer1", "layer2", "layer3"):
        lp, p, s = f"{prefix}.{name}", sk[name], sk_stats.get(name, {})
        _dense_entries(out, f"{lp}.conv1", p["conv1"], conv=True)
        _bn_entries(out, f"{lp}.bn1", p["bn1"], s["bn1"])
        i = 0
        while f"convs_{i}_w" in p:
            out[f"{lp}.convs.{i}.weight"] = _copy(p[f"convs_{i}_w"])
            out[f"{lp}.convs.{i}.bias"] = _copy(p[f"convs_{i}_b"])
            _bn_entries(out, f"{lp}.bns.{i}", p[f"bns_{i}"], s[f"bns_{i}"])
            i += 1
        _dense_entries(out, f"{lp}.conv3", p["conv3"], conv=True)
        _bn_entries(out, f"{lp}.bn3", p["bn3"], s["bn3"])
        if "residual" in p:
            out[f"{lp}.residual.0.weight"] = _conv1x1(p["residual"]["kernel"])
        out[f"{lp}.afms.alpha"] = np.asarray(p["afms"]["alpha"]).reshape(-1, 1).copy()
        _dense_entries(out, f"{lp}.afms.fc", p["afms"]["fc"])
    _dense_entries(out, f"{prefix}.layer4", sk["layer4"], conv=True)
    _dense_entries(out, f"{prefix}.attention.0", sk["att_conv1"], conv=True)
    _bn_entries(out, f"{prefix}.attention.2", sk["att_bn"], sk_stats["att_bn"])
    _dense_entries(out, f"{prefix}.attention.3", sk["att_conv2"], conv=True)
    for bn in ("bn5", "bn6"):
        if bn in sk:
            _bn_entries(out, f"{prefix}.{bn}", sk[bn], sk_stats[bn])
    _dense_entries(out, f"{prefix}.fc6", sk["fc6"])


def state_dict_from_jax(variables: Mapping[str, Any], norm_type: str = "ln",
                        kernel_size: int = 2, fusion_type: str = "att",
                        sinc_kernel: int = 251, sinc_sample_rate: float = 16000.0
                        ) -> Dict[str, torch.Tensor]:
    """flax variables (params [+ batch_stats]) -> reference-format state_dict."""
    params = variables["params"]
    sep = params["separation"]
    sep_stats = variables.get("batch_stats", {}).get("separation", {})
    out: Dict[str, np.ndarray] = {}

    out["encoder.conv1d.weight"] = _copy(params["encoder"]["w"])
    out["decoder.weight"] = _copy(params["decoder"]["w"])
    _norm_entries(out, "separation.bottleneck.0", sep["bottleneck_norm"], norm_type)
    _dense_entries(out, "separation.bottleneck.1", sep["bottleneck_dense"], conv=True)

    core = sep["core"]
    i = 0
    while f"blocks_{i}" in core:
        blk = core[f"blocks_{i}"]
        prefix = f"separation.dprnn_blocks.{i}"
        for part in ("intra", "inter"):
            _rnn_entries(out, f"{prefix}.{part}_rnn.rnn", blk[f"{part}_rnn"])
            _dense_entries(out, f"{prefix}.{part}_linear", blk[f"{part}_linear"])
            _norm_entries(out, f"{prefix}.{part}_norm", blk[f"{part}_norm"], norm_type)
        i += 1
    out["separation.prelu.weight"] = _copy(core["prelu"]["a"])
    out["separation.conv2d.weight"] = np.asarray(core["mask_dense"]["kernel"]).T[:, :, None, None].copy()
    out["separation.conv2d.bias"] = _copy(core["mask_dense"]["bias"])
    _dense_entries(out, "separation.out.0", core["out_dense"], conv=True)
    _dense_entries(out, "separation.gate.0", core["gate_dense"], conv=True)
    out["separation.end_conv1x1.weight"] = _conv1x1(core["end_dense"]["kernel"])

    if "fusion" in sep:
        fz = sep["fusion"]
        for name in ("fusion_linear", "fusion_linear_1", "fusion_linear_2"):
            if name in fz:
                _dense_entries(out, f"separation.{name}", fz[name])
        if fusion_type == "att":
            N = out["encoder.conv1d.weight"].shape[0]
            out["separation.average.weight"] = (
                np.ones((N, 1, kernel_size), np.float32) / kernel_size)
            out["separation.average.bias"] = np.zeros(N, np.float32)

    if "spk_encoder" in sep:
        sk = sep["spk_encoder"]
        sk_stats = sep_stats.get("spk_encoder", {})
        if "norm" not in sk:  # RawNet3: no GroupNorm head
            _rawnet_entries(out, "separation.spk_encoder", sk, sk_stats, sinc_kernel,
                            sinc_sample_rate)
        else:
            out["separation.spk_encoder.0.weight"] = _copy(sk["norm"]["gamma"])
            out["separation.spk_encoder.0.bias"] = _copy(sk["norm"]["beta"])
            _dense_entries(out, "separation.spk_encoder.1", sk["conv_in"], conv=True)
            for idx, res in (("2", "res1"), ("3", "res2"), ("4", "res3")):
                _resblock_entries(out, f"separation.spk_encoder.{idx}", sk[res],
                                  sk_stats.get(res, {}))
            _dense_entries(out, "separation.spk_encoder.5", sk["conv_out"], conv=True)
    for name in ("pred_linear", "aux_linear"):
        if name in sep:
            _dense_entries(out, f"separation.{name}", sep[name])
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


@torch.no_grad()
def init_weights_(model: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Random weights by torch's default rules, drawn from ``generator``:
    U(+-1/sqrt(fan_in)) for linear, conv and recurrent tensors (fan_in = H
    for an LSTM, GRU or RNN), norm scales 1 and shifts 0, PReLU slopes 0.25;
    RawNet3's sinc bands mel-spaced, its AFMS alphas and instance-norm
    scale 1. Buffers (BN running statistics, the frozen tensors) keep their
    constructed values."""
    from tss_dprnn_tpu_torch.models.dprnn import Decoder, _Conv1dWeight
    from tss_dprnn_tpu_torch.models.layers import (
        BatchNorm, Dense, GlobalNorm, PReLU, _RNNParams)
    from tss_dprnn_tpu_torch.models.rawnet import (
        AFMS, Conv1d, ParamSincFB, _InstanceNormAffine)

    def uniform_(t: torch.Tensor, fan_in: int) -> None:
        k = fan_in ** -0.5
        t.copy_(torch.rand(t.shape, generator=generator) * (2 * k) - k)

    for m in model.modules():
        if isinstance(m, Dense):
            for p in m.parameters(recurse=False):
                uniform_(p, m.in_features)
        elif isinstance(m, _RNNParams):
            for p in m.parameters(recurse=False):
                uniform_(p, m.weight_hh_l0.shape[1])
        elif isinstance(m, (_Conv1dWeight, Decoder, Conv1d)):
            for p in m.parameters(recurse=False):
                uniform_(p, m.weight.shape[1] * m.weight.shape[2])
        elif isinstance(m, (GlobalNorm, BatchNorm, _InstanceNormAffine)):
            scale, shift = list(m.parameters(recurse=False))
            scale.fill_(1.0)
            shift.zero_()
        elif isinstance(m, ParamSincFB):
            m.init_bands_()
        elif isinstance(m, AFMS):
            m.alpha.fill_(1.0)
        elif isinstance(m, PReLU):
            m.weight.fill_(0.25)
    return model
