"""Serving export (counterpart of ``tss_dprnn_tpu/inference/export.py``):
record a separation forward with ``torch.export`` and drive it without the
model code.

- :func:`export_separation` — one (batch, samples) bucket of a model's
  masked forward -> a ``torch.export.ExportedProgram``, weights embedded;
- :func:`save_artifact` / :func:`load_artifact` — a zip holding
  ``meta.json`` and one ``torch.export.save`` payload per bucket;
- :class:`ServingModel` — picks the smallest bucket that fits an input,
  zero-pads batch and time, and crops the output back (the masked forward
  keeps the valid region of a padded row as an exact-shape run has it, the
  property the bucketed eval loader relies on).

Two backends, as the JAX package's CLI names them. ``pallas`` (the default)
records each serving scan as one call of the port's operator
(``tss_dprnn_tpu_torch::bilstm2_forward`` and its kin, ``ops.bilstm2`` and
``ops.lstm``), so a card artifact runs the hand-written kernels; loading it
needs the port importable (this module imports its operators), as a JAX
Pallas artifact needs the libtpu that built it. ``xla`` decomposes each of
those calls into its plain version's PyTorch ops after the export
(``ExportedProgram.run_decompositions``): a hermetic artifact, for the CPU
only (on the card it would replace the kernels). The scans are recorded in
the serving layout (``ops/rnn.serving_time_major``; under ``TSS_TM=1`` the
time-major operators, ``bilstm2_forward_tm`` and ``_masked_tm``).

The format is the port's own (``FORMAT``, ``FORMAT_VERSION``): a JAX
package artifact (``jax.export`` StableHLO buckets) does not load here.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from tss_dprnn_tpu_torch.ops import bilstm2, lstm  # noqa: F401  (registers the operators)
from tss_dprnn_tpu_torch.ops.rnn import serving_time_major

FORMAT = "tss_dprnn_tpu_torch.export"
FORMAT_VERSION = 1
BACKENDS = ("pallas", "xla")


def _spe_like(model) -> bool:
    """True when the forward takes (mix, aux, aux_len) — Spe/IRA/RawNet."""
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet

    return isinstance(model, DPRNNSpeTasNet)


def _aux_rate_factor(model) -> int:
    """RawNet references are 16 kHz raw waveforms (2x the 8 kHz mixture)."""
    from tss_dprnn_tpu_torch.models import DPRNNRawNetTasNet

    return 2 if isinstance(model, DPRNNRawNetTasNet) else 1


def example_args(model, batch_size: int, n_samples: int, with_lengths: bool = False,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """Zero inputs of one bucket: (mix [B, T],) or (mix, aux [B, Ta], aux_len
    [B]) for a TSS model, then ``lengths`` [B] int32 when asked for."""
    mix = torch.zeros(batch_size, n_samples, device=device)
    lengths = ((torch.full((batch_size,), n_samples, dtype=torch.int32, device=device),)
               if with_lengths else ())
    if not _spe_like(model):
        return (mix,) + lengths
    Ta = n_samples * _aux_rate_factor(model)
    aux = torch.zeros(batch_size, Ta, device=device)
    aux_len = torch.full((batch_size,), float(Ta), device=device)
    return (mix, aux, aux_len) + lengths


class _Separation(torch.nn.Module):
    """The forward an artifact records: ``(*inputs, lengths) -> waveforms``
    (BSS [B, n_src, T], TSS [B, T])."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args):
        out = self.model(*args[:-1], lengths=args[-1])
        return out[0] if isinstance(out, tuple) else out


def export_separation(model: torch.nn.Module, batch_size: int, n_samples: int, *,
                      backend: str = "pallas",
                      device: Optional[Union[str, torch.device]] = None
                      ) -> torch.export.ExportedProgram:
    """Record the masked forward of ``model`` (eval mode, waveform output
    only) at a fixed (batch, samples) bucket on ``device`` (default: the
    model's). The forward takes a trailing ``lengths`` [B] int32 argument:
    shorter requests zero-pad up to the bucket and the masks keep the valid
    region as an exact-shape run has it (the global norms' statistics would
    otherwise absorb the padded zeros). Traced under ``no_grad`` with the
    parameters frozen (restored afterwards), so the serving scans are what
    is recorded, one operator call each (``backend='pallas'``); ``'xla'``
    (CPU only) then decomposes each call into its plain version's ops."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if device is None:
        device = next(model.parameters()).device
    device = torch.device(device)
    if backend == "xla" and device.type != "cpu":
        raise ValueError(
            f"backend 'xla' records the kernels' plain PyTorch versions, so it exports for the "
            f"CPU only (--device cpu); on {device.type} it would replace the hand-written "
            "kernels: use backend 'pallas'")
    model = model.to(device).eval()
    args = example_args(model, batch_size, n_samples, with_lengths=True, device=device)
    frozen = [(p, p.requires_grad) for p in model.parameters()]
    try:
        for p, _ in frozen:
            p.requires_grad_(False)
        with torch.no_grad(), serving_time_major(model):  # the serving layout is recorded
            exported = torch.export.export(_Separation(model), args, strict=False)
    finally:
        for p, flag in frozen:
            p.requires_grad_(flag)
    if backend == "xla":  # each operator call becomes its plain version's ops
        exported = exported.run_decompositions(dict(bilstm2.PLAIN_BODIES))
    return exported


def _bucket_shape(exported: torch.export.ExportedProgram) -> Tuple[int, int]:
    """(B, T) of the artifact's first user input, the mixture."""
    first = exported.graph_signature.user_inputs[0]
    node = next(n for n in exported.graph.nodes if n.op == "placeholder" and n.name == first)
    B, T = node.meta["val"].shape
    return int(B), int(T)


def save_artifact(path: str, buckets: List[torch.export.ExportedProgram],
                  meta: Dict[str, Any]) -> None:
    """Zip container: ``meta.json`` + one ``bucket_<B>x<T>.pt2`` per shape."""
    entries = []
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for exp in buckets:
            B, T = _bucket_shape(exp)
            name = f"bucket_{B}x{T}.pt2"
            buf = io.BytesIO()
            torch.export.save(exp, buf)
            zf.writestr(name, buf.getvalue())
            entries.append({"batch": B, "samples": T, "file": name})
        zf.writestr("meta.json", json.dumps(
            {"format": FORMAT, "format_version": FORMAT_VERSION, "buckets": entries, **meta},
            indent=2))


def load_artifact(path: str, device: Optional[Union[str, torch.device]] = None
                  ) -> "ServingModel":
    """The artifact at ``path`` as a :class:`ServingModel` on ``device``
    (default: the device it was exported on)."""
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
        if meta.get("format") != FORMAT:
            raise ValueError(
                f"{path} is not an artifact of tss_dprnn_tpu_torch (a JAX package artifact "
                "holds jax.export StableHLO buckets): load it with the JAX package's "
                "inference.export.load_artifact, or export the .pt checkpoint with "
                "python -m tss_dprnn_tpu_torch.cli.export_model")
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(f"unsupported artifact version {meta.get('format_version')}")
        buckets = {(ent["batch"], ent["samples"]):
                   torch.export.load(io.BytesIO(zf.read(ent["file"])))
                   for ent in meta["buckets"]}
    return ServingModel(buckets, meta, device)


class ServingModel:
    """Callable over the exported buckets: pads (batch, time) up to the
    smallest bucket that fits, crops the result back to the true shape.

    ``call(mix [b, t], aux=None, aux_len=None, lengths=None) -> [b, n_out, t]``
    separated waveforms as numpy fp32 (n_out = 2 for BSS, 1 for TSS). Runs on
    ``device``, by default the device the artifact was exported on; another
    device gets the programs moved there first (their tensors and the
    devices recorded in their ops)."""

    def __init__(self, buckets: Dict[Tuple[int, int], torch.export.ExportedProgram],
                 meta: Dict[str, Any], device: Optional[Union[str, torch.device]] = None):
        self.buckets = buckets
        self.meta = meta
        self.spe = bool(meta.get("spe"))
        self.aux_factor = int(meta.get("aux_factor", 1))
        self.device = torch.device(device if device is not None else meta.get("device", "cpu"))
        if self.device.type != torch.device(meta.get("device", "cpu")).type:
            from torch.export.passes import move_to_device_pass

            buckets = {k: move_to_device_pass(exp, self.device) for k, exp in buckets.items()}
        self._fns = {k: exp.module() for k, exp in buckets.items()}

    def _pick(self, b: int, t: int) -> Tuple[int, int]:
        fits = [k for k in self.buckets if k[0] >= b and k[1] >= t]
        if not fits:
            raise ValueError(
                f"no exported bucket fits batch={b}, samples={t}; "
                f"available: {sorted(self.buckets)}"
            )
        return min(fits, key=lambda k: (k[1], k[0]))

    def call(self, mix: np.ndarray, aux: Optional[np.ndarray] = None,
             aux_len: Optional[np.ndarray] = None,
             lengths: Optional[np.ndarray] = None) -> np.ndarray:
        """``lengths`` [b] (optional): per-request valid samples when rows of
        ``mix`` are themselves padded; defaults to the full ``t``."""
        b, t = mix.shape
        B, T = self._pick(b, t)
        pad = lambda a, rows, cols: np.pad(  # noqa: E731
            np.asarray(a, np.float32), ((0, rows - a.shape[0]), (0, cols - a.shape[1]))
        )
        args: Tuple[np.ndarray, ...] = (pad(mix, B, T),)
        if self.spe:
            if aux is None:
                raise ValueError("this artifact is a TSS model: aux is required")
            Ta = T * self.aux_factor
            if aux.shape[1] > Ta:
                raise ValueError(f"aux has {aux.shape[1]} samples > bucket {Ta}")
            if aux_len is None:
                aux_len = np.full((aux.shape[0],), float(aux.shape[1]), np.float32)
            args += (
                pad(aux, B, Ta),
                # filler rows get aux_len=Ta, not 0: the SpEx+ mean-pool
                # divides by aux_T(aux_len) and a zero length would put
                # inf/nan in rows we crop anyway
                np.pad(np.asarray(aux_len, np.float32), (0, B - b),
                       constant_values=float(Ta)),
            )
        if lengths is None:
            lengths = np.full((b,), t, np.int32)
        # filler rows claim full length; their garbage is cropped below
        args += (np.pad(np.asarray(lengths, np.int32), (0, B - b), constant_values=T),)
        with torch.inference_mode():
            out = self._fns[(B, T)](*(torch.from_numpy(a).to(self.device) for a in args))
            out = out.float().cpu().numpy()
        if out.ndim == 2:  # TSS: [B, T] single target
            out = out[:, None, :]
        return out[:b, :, :t]

    def platforms(self) -> Tuple[str, ...]:
        return (self.device.type,)
