"""Serving benchmark of the PyTorch port: separated audio-seconds per
wall-clock second on one card.

    python scripts/port/bench_serve.py [--batch 32] [--secs 10] [--dtype fp32|bf16]

The flagship masked lane of ``bench.py`` (its lines 97-150) through the
port: DPRNN-Spe-TasNet at the flagship widths (random weights from a seed),
B utterances of 10 s at 8 kHz with their ``lengths`` passed in, so that the
inter-chunk scans run masked as in bucketed evaluation; fp32 by default,
``--dtype bf16`` the bf16 lane (``model.dtype: bfloat16``, bench.py's fast
lane, batch-major where bench.py runs time-major). One warm-up forward,
then 5 timed forwards between two synchronisations of the card.

Prints the card's name and power limit on stderr and, as the last line of
stdout, ``bench.py``'s JSON line: ``metric``, ``value``, ``unit``,
``vs_baseline`` (value / 50) and ``lane``. Runs on the card only.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FLAGSHIP = dict(
    input_size=64, feature_size=128, hidden_size=128, chunk_length=250,
    kernel_size=2, hop_length=125, n_repeats=6, bidirectional=True,
    norm_type="ln", activation_type="sigmoid", dropout=0,
    O=128, P=256, embeddings_size=128, num_spks=251, fusion_type="att",
)
SAMPLE_RATE = 8000
ITERS = 5


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--secs", type=float, default=10.0)
    parser.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_serve: no CUDA device; this benchmark runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tss_dprnn_tpu_torch.device import resolve_device
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"# {card}", file=sys.stderr, flush=True)
    dev = resolve_device()
    B, T = args.batch, int(args.secs * SAMPLE_RATE)
    dtype = torch.bfloat16 if args.dtype == "bf16" else None
    model = init_weights_(DPRNNSpeTasNet(**FLAGSHIP, dtype=dtype),
                          torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    g = torch.Generator().manual_seed(0)
    mix = torch.randn(B, T, generator=g).to(dev)
    aux = torch.randn(B, T, generator=g).to(dev)
    aux_len = torch.full((B,), float(T), device=dev)
    lengths = torch.full((B,), T, dtype=torch.int32, device=dev)

    with torch.inference_mode():
        model(mix, aux, aux_len, lengths=lengths)  # warm-up: kernel builds, allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            out, _ = model(mix, aux, aux_len, lengths=lengths)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    if not torch.isfinite(out).all():
        raise AssertionError("non-finite separated audio")
    realtime = ITERS * B * args.secs / dt
    print(json.dumps({"metric": "separated_audio_sec_per_sec_per_chip",
                      "value": round(realtime, 2), "unit": "audio-sec/sec",
                      "vs_baseline": round(realtime / 50.0, 3),
                      "lane": "bf16 masked" if dtype else "fp32"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
