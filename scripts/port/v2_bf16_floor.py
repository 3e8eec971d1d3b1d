#!/usr/bin/env python3
"""How far two valid bf16 runs of the manual-DMA LSTM scan may drift (CPU).

    python scripts/port/v2_bf16_floor.py [--rows 2000] [--steps 642] [--seed 0]

The bf16 streams of ``lstm_scan_v2`` and ``bilstm_v2`` (the serving cluster
scan's dtype 2 in ``csrc/bilstm2_serve.cu``) round as the source of the TPU
kernel they replace (``_lstm_manual_kernel``) computes in bf16: the gates,
each operation of the activations, i * g, tanh(c) and h, six roundings per
unit and step where the port's other scan kernels round h alone. A gate
summed in another order then lands on the other side of a bf16 rounding more
often, and the flip lives on in c, so the kernel cannot match its plain
version as closely as the other kernels match theirs. At one direction, F =
H = 128, weights at PyTorch's LSTM scale and x ~ N(0, 1) in bf16, this script
prints:

- the plain version (``lstm_v2_reference``, fp32 gate sums) against the same
  rounding with the gates summed in fp64: the drift of one valid summation
  order from another (two fp32 orders, as kernel and plain version are,
  drift about 3 dB further, twice the variance);
- ``lstm_reference`` (h rounded alone) against the plain version: what a
  kernel with the other kernels' rounding points would score.

chip_smoke.py's bar for the bf16 v2 kernels (``V2_BF16_SNR_DB``) lies between
the two.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from tss_dprnn_tpu_torch.ops import lstm as L  # noqa: E402


def snr_db(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float(10 * torch.log10(want.pow(2).sum() / (got - want).pow(2).sum()))


def v2_fp64_gates(x, w_ih, w_hh, b):
    """The plain version's rounding with every gate summed in fp64."""
    H = w_hh.shape[1]

    def rnd(v):
        return v.bfloat16().float()

    def sigmoid(v):
        return rnd(1.0 / rnd(1.0 + rnd(torch.exp(-v))))

    D, R, T, _ = x.shape
    xp = torch.einsum("drtf,dfg->drtg", x.double(), w_ih.double())
    h = torch.zeros(D, R, H)
    c = torch.zeros(D, R, H)
    out = []
    for t in range(T):
        g = xp[:, :, t] + torch.bmm(h.double(), w_hh.double()) + b.double()[:, None]
        i, f, gg, o = rnd(g.float()).split(H, -1)
        i, f, gg, o = sigmoid(i), sigmoid(f), rnd(torch.tanh(gg)), sigmoid(o)
        c = f * c + rnd(i * gg)
        h = rnd(o * rnd(torch.tanh(c)))
        out.append(h)
    return torch.stack(out, 2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=642)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.manual_seed(args.seed)
    F = H = 128
    k = H ** -0.5
    x = torch.randn(1, args.rows, args.steps, F).bfloat16()
    w_ih = (torch.rand(1, F, 4 * H) * 2 * k - k).bfloat16().float()
    w_hh = (torch.rand(1, H, 4 * H) * 2 * k - k).bfloat16().float()
    b = torch.rand(1, 4 * H) * 2 * k - k
    plain = L.lstm_v2_reference(x, w_ih, w_hh, b).float()
    alt = v2_fp64_gates(x, w_ih, w_hh, b)
    h_only = L.lstm_reference(x, w_ih, b, w_hh).float()
    print(f"R={args.rows} T={args.steps}: plain version vs fp64 gate sums {snr_db(plain, alt):.2f} "
          f"dB (max|diff| {float((plain - alt).abs().max()):.4g}); h-only rounding vs plain "
          f"version {snr_db(h_only, plain):.2f} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
