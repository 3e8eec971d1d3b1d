#!/usr/bin/env python3
"""Time one tree's serving-route kernels in a fresh process (card).

    python3 scripts/port/route_turns.py [--tree DIR] [--out FILE]

Imports ``tss_dprnn_tpu_torch`` from DIR (default: this checkout; DIR may be
another revision unpacked with ``git archive``), builds the kernels it
needs, and prints one JSON object: the card's name and power limit,
ptxas's registers and spills of every ``serve_scan_kernel`` and product
kernel instantiation, and the mean device ms (CUDA events, 5 calls after a
warm-up) at chip_smoke.py's shapes of 8 x 10 s of

- the default serving rows: ``bilstm2_forward`` unmasked (R=5136 T=250) and
  ``bilstm2_forward_masked`` (R=2000 T=642, ragged lengths), fp32 and bf16,
  and ``lstm_forward`` D=1 (R=2000 T=642), fp32 and bf16;
- the batch-major and manual-DMA kernels' entries, ``bilstm2_forward_bm`` and
  ``bilstm_v2`` (R=5136 T=250) and ``lstm_scan_v2`` D=1 (R=2000 T=642), the
  dense mode ``bilstm2_dense_forward`` (R=5136 T=250, Fo=128) and the
  shared-input pair ``bilstm_fused`` (R=5136 T=250), fp32 and bf16,
  whichever kernels the tree runs them on.

Run it on two trees in turns in one call (parent, change, change, parent)
to compare them on one card; each process starts with nothing loaded, and a
tree's second run reuses the libraries its first one built.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("route_turns: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from tss_dprnn_tpu_torch.ops import _build
    from tss_dprnn_tpu_torch.ops import bilstm2 as B
    from tss_dprnn_tpu_torch.ops import lstm as L

    if not os.path.dirname(B.__file__).startswith(tree):
        raise RuntimeError(f"imported {B.__file__}, not from {tree}")
    csrc = os.path.join(tree, "tss_dprnn_tpu_torch", "csrc")
    libs = [n for n in ("bilstm2_serve", "products", "bilstm2", "lstm")
            if os.path.exists(os.path.join(csrc, f"{n}.cu"))]
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(_build.load_library, libs))
    ptxas = cs.ptxas_report(_build.build_logs, ("serve_scan_kernel", "gemm_kernel",
                                                "bilstm2_kernel", "lstm_kernel"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    dev = torch.device("cuda")
    F = H = 128
    g = torch.Generator().manual_seed(cs.SEED + 16)
    k = H ** -0.5
    w_ih2, b2, w_hh2 = ((torch.rand(*s, generator=g) * 2 * k - k).to(dev)
                        for s in ((2, F, 4 * H), (2, 4 * H), (2, H, 4 * H)))
    w1 = (w_ih2[:1], b2[:1], w_hh2[:1])
    shapes = cs.serving_shapes(torch, g, dev)
    (Ru, Tu, _), (Rm, Tm, lens) = shapes["unmasked"], shapes["masked"]
    xu = torch.randn(Ru, Tu, F, generator=g).to(dev)
    xm = torch.randn(Rm, Tm, F, generator=g).to(dev)
    wo2 = (torch.rand(2, H, 128, generator=g) * 2 * k - k).to(dev)
    calls = {
        "bilstm2_forward": lambda x: B.bilstm2_forward(x, w_ih2, b2, w_hh2),
        "bilstm2_forward_masked": lambda x: B.bilstm2_forward_masked(x, lens, w_ih2, b2, w_hh2),
        "lstm_forward": lambda x: L.lstm_forward(x[None], *w1),
        "bilstm2_forward_bm": lambda x: B.bilstm2_forward_bm(x, w_ih2, b2, w_hh2),
        "bilstm_v2": lambda x: L.bilstm_v2(x, w_ih2, w_hh2, b2),
        "lstm_scan_v2": lambda x: L.lstm_scan_v2(x[None], w1[0], w1[2], w1[1]),
        "bilstm2_dense_forward": lambda x: B.bilstm2_dense_forward(x, w_ih2, b2, w_hh2, wo2),
        "bilstm_fused": lambda x: L.bilstm_fused(x, w_ih2, w_hh2, b2),
    }
    inputs = {"bilstm2_forward": xu, "bilstm2_forward_masked": xm, "lstm_forward": xm,
              "bilstm2_forward_bm": xu, "bilstm_v2": xu, "lstm_scan_v2": xm,
              "bilstm2_dense_forward": xu, "bilstm_fused": xu}
    rows = {}
    for name, fn in calls.items():
        for dt, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            x = inputs[name].to(dt)
            rows[f"{name}_{tag}"] = cs.time_ms(lambda: fn(x), 5)
            del x
            torch.cuda.empty_cache()
    out = {"tree": tree, "card": smi, "ptxas": ptxas, "ms": rows,
           "shapes": {"unmasked": [Ru, Tu], "masked": [Rm, Tm]}}
    text = json.dumps(out)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
