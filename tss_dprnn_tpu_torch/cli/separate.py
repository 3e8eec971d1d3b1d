"""Single-file separation (counterpart of ``tss_dprnn_tpu/cli/separate.py``):
serve a checkpoint on one WAV file.

    # blind separation -> out_s1.wav, out_s2.wav
    python -m tss_dprnn_tpu_torch.cli.separate --config configs/test_bss.yaml \
        --mode bss --mix mixture.wav --out out.wav [--set checkpoint_path=model.pt]

    # target speech separation -> out.wav
    python -m tss_dprnn_tpu_torch.cli.separate --config configs/test_tss.yaml \
        --mode tss_spe --mix mixture.wav --ref speaker.wav --out out.wav

``--window-secs N`` streams arbitrarily long inputs through the windowed
separator (``inference/long_audio.py``: O(window) device memory, one
``[batch, window]`` shape); 0 (default) runs one full-length forward. BSS
windows cross to the host on the int16 wire, as the JAX CLI's do. Model
hparams, ``checkpoint_path`` (a port or reference ``.pt`` file; the JAX
package's orbax directories raise) and ``model.dtype`` come from the config
(``--set`` overrides apply); a config's ``lstm_backend`` is logged and
ignored (the port has one backend). Runs on the card unless ``--device``
names another device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tss_dprnn_tpu_torch.cli.common import MODES, get_logger
from tss_dprnn_tpu_torch.data import wav
from tss_dprnn_tpu_torch.device import resolve_device
from tss_dprnn_tpu_torch.models.registry import build_model
from tss_dprnn_tpu_torch.utils.checkpoint import load_model
from tss_dprnn_tpu_torch.utils.config import load_config, model_config


def _mono(x: np.ndarray) -> np.ndarray:
    return x.mean(axis=1) if x.ndim == 2 else x


def main(argv=None):
    parser = argparse.ArgumentParser(description="tss_dprnn_tpu_torch single-file separation")
    parser.add_argument("--config", required=True)
    parser.add_argument("--mode", default="bss", choices=MODES)
    parser.add_argument("--set", action="extend", nargs="*", default=[])
    parser.add_argument("--mix", required=True, help="input mixture WAV")
    parser.add_argument("--ref", help="speaker reference WAV (tss modes)")
    parser.add_argument("--out", required=True, help="output WAV path; BSS writes "
                        "<out>_s1/_s2 per source")
    parser.add_argument("--window-secs", type=float, default=0.0,
                        help="stream through fixed windows of this many seconds "
                             "(0 = one full-length forward)")
    parser.add_argument("--hop-secs", type=float, default=None,
                        help="window hop (default: half the window)")
    parser.add_argument("--batch", type=int, default=4, help="windows per forward")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current CUDA card; 'cpu' runs the "
                             "kernels' plain versions)")
    args = parser.parse_args(argv)

    logger = get_logger("separate")
    config = load_config(args.config, args.set)
    sr = int(config.get("data", {}).get("sample_rate", 8000))
    if config.get("lstm_backend") is not None:
        logger.info("lstm_backend %r ignored: the port runs its own kernels",
                    config["lstm_backend"])
    spe = args.mode != "bss"
    if spe and not args.ref:
        raise ValueError(f"--ref is required for mode {args.mode}")

    mix, mix_rate = wav.read(args.mix)
    mix = _mono(mix)
    if mix_rate != sr:
        raise ValueError(f"{args.mix} is {mix_rate} Hz; config expects {sr} Hz")
    logger.info("mixture: %s (%.2f s @ %d Hz)", args.mix, len(mix) / sr, sr)

    ref = ref_len = None
    if spe:
        ref, ref_rate = wav.read(args.ref)
        ref = _mono(ref)
        want = 16000 if args.mode == "tss_rawnet" else sr
        if ref_rate != want:
            from tss_dprnn_tpu_torch.data.resample import resample

            logger.info("resampling reference %d -> %d Hz", ref_rate, want)
            ref = resample(ref, ref_rate, want)
        ref = np.asarray(ref, np.float32)
        ref_len = float(len(ref))

    model = build_model(model_config(config))
    checkpoint_path = config.get("checkpoint_path")
    if not checkpoint_path:
        raise ValueError("checkpoint_path is required (config or --set)")
    load_model(checkpoint_path, model)
    logger.info("loaded checkpoint: %s", checkpoint_path)
    device = resolve_device(args.device)

    if args.window_secs > 0:
        from tss_dprnn_tpu_torch.inference.long_audio import bss_windowed, spe_windowed

        window = int(args.window_secs * sr)
        hop = int(args.hop_secs * sr) if args.hop_secs else None
        if spe:
            sep = spe_windowed(model, ref, ref_len, window=window, hop=hop,
                               batch_size=args.batch, device=device)
        else:  # the JAX CLI's wire (its library default)
            sep = bss_windowed(model, window=window, hop=hop, batch_size=args.batch,
                               device=device, wire=True)
        est = sep(mix)  # [n_src, T]
    else:
        model.to(device).eval()
        x = torch.from_numpy(np.asarray(mix, np.float32)[None]).to(device)
        with torch.inference_mode():
            if spe:
                out, _ = model(x, torch.from_numpy(ref[None]).to(device),
                               torch.tensor([ref_len], dtype=torch.float32, device=device))
            else:
                out = model(x)[0]  # [n_src, T]
            est = out.float().cpu().numpy()

    est = np.atleast_2d(np.asarray(est, np.float32))
    peak = np.abs(est).max()
    if peak > 1.0:  # normalize only if clipping, preserve level otherwise
        est = est / peak
        logger.info("peak-normalized output by %.3f", peak)
    if est.shape[0] == 1:
        wav.write(args.out, est[0], sr)
        logger.info("wrote %s", args.out)
    else:
        base, ext = os.path.splitext(args.out)
        for j in range(est.shape[0]):
            p = f"{base}_s{j + 1}{ext or '.wav'}"
            wav.write(p, est[j], sr)
            logger.info("wrote %s", p)


if __name__ == "__main__":
    main()
