#!/usr/bin/env python3
"""Where the cluster scans' time goes: time the fused bidirectional LSTM's
training pair and its fp32 serving route with parts of their cluster scans
cut out.

    python3 scripts/port/scan_probe.py [variant ...]

Needs one CUDA card. Each variant is a copy of ``tss_dprnn_tpu_torch/csrc``
with one edit made to ``bilstm2_resid.cu``, ``cluster_scan.cuh`` (the
backward's scan) and ``bilstm2_serve.cu``, written under ``chiprun_out/scan_probe/<variant>/`` and
built and timed in a process of its own (``_build.CSRC_DIR`` pointed at the
copy):

- ``base``: the sources as they are;
- ``no_fma``: the recurrent products (h @ W_hh forward and serving, dpre @
  W_hh^T backward) skipped: what is left is each step's fixed cost (the
  staged inputs, the cell or gate arithmetic, the stores, the exchange and
  the cluster barrier);
- ``no_cell``: the sigmoid and tanh of every gate replaced by the identity;
- ``no_store``: the per-step stores to device memory skipped (pre and the
  residual streams forward, dpre backward, the outputs serving).

Only ``base`` computes the function; the others are timing probes. Each
prints one JSON line ``RESULT {...}`` with, at the training batch's intra
(R=970 T=250) and inter (R=1250 T=194) shapes, the residual forward's and
the backward's ms (CUDA events, mean of 5 after a warm-up) and the input
product's ms on its own, so that the scan's share is forward minus input
product; and the same for the serving route (``bilstm2_forward`` unmasked at
R=5136 T=250, ``bilstm2_forward_masked`` at R=2000 T=642 with ragged lengths
drawn as chip_smoke.py phase 2 draws them), with the serving scan's tile
plan, and the serving scan alone at each of its tile heights; and the bf16
serving route at the same shapes taken apart: the whole call, the upcast of
x to fp32, the input product on the upcast x, and the scan's bf16 mode alone
at each tile height (its tile plan and the waves it takes). The variants
run in turns, base first and last.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
OUT = HERE / "chiprun_out" / "scan_probe"
SRC = HERE / "tss_dprnn_tpu_torch" / "csrc"

# variant -> [(file, text, replacement, count)]
EDITS = {
    "base": [],
    "no_fma": [("bilstm2_resid.cu", "for (int k = 0; k < H; k += 4) {",
                "for (int k = 0; k < 0; k += 4) {", 1),
               ("cluster_scan.cuh", "for (int k = 0; k < 2 * H; k += 4) {",
                "for (int k = 0; k < 0; k += 4) {", 1),
               ("bilstm2_serve.cu", "for (int ks = 0; ks < H / 8; ++ks) {",
                "for (int ks = 0; ks < 0; ++ks) {", 1),
               ("bilstm2_serve.cu", "for (int ks = 0; ks < H / 16; ++ks) {",
                "for (int ks = 0; ks < 0; ++ks) {", 1)],
    "no_cell": [("bilstm2_resid.cu", "sigmoid_f(", "(", 3), ("bilstm2_resid.cu", "tanhf(", "(", 2),
                ("cluster_scan.cuh", "sigmoid_f(", "(", 3), ("cluster_scan.cuh", "tanhf(", "(", 1),
                ("bilstm2_serve.cu", "sigmoid_f(", "(", 3), ("bilstm2_serve.cu", "tanhf(", "(", 4)],
    "no_store": [("bilstm2_resid.cu", "      if (gr < R) {\n        float* pp = pre_at(gr, t);",
                  "      if (gr < 0) {\n        float* pp = pre_at(gr, t);", 1),
                 ("cluster_scan.cuh", "      if (gr < R) {\n        float* gp = dpre + gate_off(gr, t);",
                  "      if (gr < 0) {\n        float* gp = dpre + gate_off(gr, t);", 1),
                 ("bilstm2_serve.cu", "if (gr < R) st2(out_at(gr, t), hv);",
                  "if (gr < 0) st2(out_at(gr, t), hv);", 1)],
}


def make_variant(name: str) -> Path:
    """Copy the sources and apply the variant's edits (each must match
    exactly the stated number of times)."""
    dst = OUT / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(SRC, dst)
    for fname, text, repl, count in EDITS[name]:
        path = dst / fname
        src = path.read_text()
        if src.count(text) != count:
            raise RuntimeError(f"{name}: {fname} holds {src.count(text)} of {text!r}, not {count}")
        path.write_text(src.replace(text, repl))
    return dst


def measure(name: str) -> dict:
    """Build the variant's kernels and time the training pair (in this
    process, which must not have loaded any kernel yet)."""
    import torch

    sys.path.insert(0, str(HERE))
    from tss_dprnn_tpu_torch.ops import _build

    _build.CSRC_DIR = make_variant(name)
    import chip_smoke
    from tss_dprnn_tpu_torch.device import resolve_device
    from tss_dprnn_tpu_torch.ops import bilstm2 as B2

    dev = resolve_device()
    F = H = 128
    g = torch.Generator().manual_seed(chip_smoke.SEED + 5)
    k = H ** -0.5
    w_ih2, b2, w_hh2 = ((torch.rand(*s, generator=g) * 2 * k - k).to(dev)
                        for s in ((2, F, 4 * H), (2, 4 * H), (2, H, 4 * H)))
    w = (w_ih2, b2, w_hh2)
    lib = B2._library_products()
    stream = torch.cuda.current_stream().cuda_stream
    out = {"variant": name, "card": torch.cuda.get_device_name(0)}
    for shape, (R, T) in chip_smoke.train_shapes().items():
        x = torch.randn(R, T, F, generator=g).to(dev)
        g0, g1 = (torch.randn(R, T, H, generator=g).to(dev) for _ in range(2))
        _, resid = B2.bilstm2_forward_resid(x, *w)
        w_cat = w_ih2.transpose(0, 1).reshape(F, 8 * H).contiguous()
        pre = torch.empty(R, T, 2, 4 * H, device=dev)
        out[shape] = {
            "R": R, "T": T,
            "fwd_ms": chip_smoke.time_ms(lambda: B2.bilstm2_forward_resid(x, *w), 5),
            "bwd_ms": chip_smoke.time_ms(lambda: B2.bilstm2_backward(x, resid, g0, g1, *w), 5),
            "input_product_ms": chip_smoke.time_ms(
                lambda: B2._gemm(lib, stream, False, [(x, 0, F, w_cat, 0, 8 * H, F)], R * T,
                                 8 * H, out=pre, ldc=8 * H, bias=b2), 5)}
        del x, g0, g1, resid, pre
        torch.cuda.empty_cache()
    # the serving route at phase 2's shapes
    for mode, (R, T, lens) in chip_smoke.serving_shapes(torch, g, dev).items():
        x = torch.randn(R, T, F, generator=g).to(dev)
        pre = torch.empty(R, T, 2, 4 * H, device=dev)
        w_cat = w_ih2.transpose(0, 1).reshape(F, 8 * H).contiguous()
        plan = B2._plan("serve", R, H, x.device)
        out[f"serve_{mode}"] = {
            "R": R, "T": T, "tile_plan": plan._asdict(),
            "ms": chip_smoke.time_ms(lambda: B2.bilstm2_forward(x, *w) if lens is None
                                     else B2.bilstm2_forward_masked(x, lens, *w), 5),
            "input_product_ms": chip_smoke.time_ms(
                lambda: B2._gemm(lib, stream, False, [(x, 0, F, w_cat, 0, 8 * H, F)], R * T,
                                 8 * H, out=pre, ldc=8 * H, bias=b2), 5)}
        serve = B2._library_serve()

        def scan_by_height(dtype, layout):
            """The serving scan alone on ``pre`` in stream type ``dtype``, at
            each tile height, with the waves its grid takes there."""
            w_frag = layout(w_hh2)
            o0, o1 = (torch.empty(R, T, H, dtype=dtype, device=dev) for _ in range(2))
            code = B2._DTYPE_CODES[dtype]

            def scan(height):
                rc = serve.bilstm2_serve_scan(height, code, pre.data_ptr(), w_frag.data_ptr(),
                                              B2._ptr(lens), o0.data_ptr(), o1.data_ptr(), 4 * H,
                                              8 * H, H, 1, 2, R, T, H, stream)
                B2._raise_on(rc, "serving scan", serve, "bilstm2_serve_error_string")

            res = {}
            for h in B2.SERVE_HEIGHTS:
                n = B2._max_clusters("serve", H, x.device.index, h, dtype)
                res[h] = {"ms": chip_smoke.time_ms(lambda: scan(h), 5), "max_clusters": n,
                          "waves": -(-2 * -(-R // h) // n)}
            return res

        out[f"serve_{mode}"]["scan_ms_by_height"] = scan_by_height(torch.float32,
                                                                   B2.serve_weight_layout)
        # the bf16 route taken apart: upcast, input product, scan
        xb = x.bfloat16()
        xu = xb.float()
        out[f"serve_{mode}_bf16"] = {
            "R": R, "T": T,
            "tile_plan": B2._plan("serve", R, H, x.device, dtype=torch.bfloat16)._asdict(),
            "ms": chip_smoke.time_ms(lambda: B2.bilstm2_forward(xb, *w) if lens is None
                                     else B2.bilstm2_forward_masked(xb, lens, *w), 5),
            "upcast_ms": chip_smoke.time_ms(lambda: xb.float(), 5),
            "input_product_ms": chip_smoke.time_ms(
                lambda: B2._input_product(lib, stream, xu, w_ih2, b2, pre), 5),
            "scan_ms_by_height": scan_by_height(torch.bfloat16, B2.serve_weight_layout_bf16)}
        del x, xb, xu, pre
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print("RESULT " + json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("scan_probe: no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or [n for n in EDITS if n != "base"]
    order = ["base", *names, "base"]
    rc = 0
    for name in order:
        proc = subprocess.run([sys.executable, __file__, "--one", name], capture_output=True,
                              text=True, timeout=600, env=dict(os.environ))
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(f"{name}: failed ({proc.returncode})\n{proc.stderr[-3000:]}", flush=True)
            rc = 1
            continue
        print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
