#!/usr/bin/env python3
"""Time and profile the port's serving path on one NVIDIA card.

    python3 chip_profile.py [--batch 8] [--seconds 10] [--iters 5]

One bucketed batch of ``--batch`` ragged requests (one of ``--seconds``,
the others drawn from the seed between half that and the full length)
runs through ``InferencerSpe.forward`` with the flagship DPRNN-Spe-TasNet
at full width and depth (random weights from a seed, fp32). Prints:

- the steady-state forward time and audio-seconds per second: host clock
  around synchronised forwards, after one warm-up;
- from ``torch.profiler`` over one forward: device time by kernel, the
  bilstm2 kernel's share of it, and the device's busy share of the window.

Writes ``chiprun_out/chip_profile/summary.json`` and ``trace.json`` (Chrome
trace) under the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "chip_profile")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chip_smoke import FLAGSHIP, SAMPLE_RATE, SEED
    from tss_dprnn_tpu_torch.data.loader import make_collate_spe_eval
    from tss_dprnn_tpu_torch.inference import InferencerSpe
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.ops import bilstm2
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    os.makedirs(OUT_DIR, exist_ok=True)
    ckpt = os.path.join(OUT_DIR, "flagship_random.pt")
    torch.save(init_weights_(DPRNNSpeTasNet(**FLAGSHIP),
                             torch.Generator().manual_seed(SEED)).state_dict(), ckpt)
    inf = InferencerSpe(DPRNNSpeTasNet(**FLAGSHIP), {"checkpoint_path": ckpt})

    rng = np.random.default_rng(SEED)
    T = int(args.seconds * SAMPLE_RATE)
    lengths = [T] + [int(n) for n in rng.integers(T // 2, T + 1, args.batch - 1)]
    items = [(0.1 * rng.standard_normal(n).astype(np.float32),) * 2
             + (0.1 * rng.standard_normal(int(rng.uniform(2, 5) * SAMPLE_RATE))
                .astype(np.float32), 0) for n in lengths]
    batch = make_collate_spe_eval()(items, T)
    batch["lengths"] = np.asarray(lengths, np.int32)
    audio_s = sum(lengths) / SAMPLE_RATE

    with torch.inference_mode():
        inf.forward(batch)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            inf.forward(batch)
        torch.cuda.synchronize()
        fwd_s = (time.perf_counter() - t0) / args.iters

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            inf.forward(batch)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(os.path.join(OUT_DIR, "trace.json"))

    by_kernel = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] += e.time_range.end - e.time_range.start
    device_us = sum(by_kernel.values())
    lstm_us = sum(v for k, v in by_kernel.items() if "bilstm2_kernel" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    summary = {
        "card": smi, "batch": args.batch, "bucket_s": args.seconds, "audio_s": audio_s,
        "forward_ms": fwd_s * 1e3, "audio_s_per_s": audio_s / fwd_s,
        "profiled_window_ms": window_us / 1e3,
        "device_ms": device_us / 1e3 if device_us else "not measured",
        "device_busy_share": device_us / window_us if device_us else "not measured",
        "bilstm2_ms": lstm_us / 1e3 if device_us else "not measured",
        "bilstm2_share_of_device": lstm_us / device_us if device_us else "not measured",
        "launches_per_forward": 12, "kernels_top": [[k[:120], v / 1e3] for k, v in top],
    }
    with open(os.path.join(OUT_DIR, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"{smi}: B={args.batch} bucket {args.seconds} s, {audio_s:.2f} audio-s: forward "
          f"{fwd_s * 1e3:.2f} ms = {audio_s / fwd_s:.2f} audio-s/s")
    for k, v in top:
        print(f"  {v / 1e3:9.3f} ms  {k[:110]}")
    print(json.dumps({k: v for k, v in summary.items() if k != "kernels_top"}))
    if bilstm2.launch_count() != 12 * (args.iters + 2):
        raise RuntimeError(f"expected 12 bilstm2 launches per forward, got "
                           f"{bilstm2.launch_count()} over {args.iters + 2} forwards")
    return 0


if __name__ == "__main__":
    sys.exit(main())
