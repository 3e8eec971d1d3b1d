#!/usr/bin/env python3
"""Time and profile the port's serving or training path on one NVIDIA card.

    python3 chip_profile.py [--bss] [--batch 8] [--seconds 10] [--iters 5]
    python3 chip_profile.py --train [--bss] [--iters 5]

One bucketed batch of ``--batch`` ragged requests (one of ``--seconds``,
the others drawn from the seed between half that and the full length)
runs through ``InferencerSpe.forward`` with the flagship DPRNN-Spe-TasNet
at full width and depth (random weights from a seed, fp32). Prints:

- the steady-state forward time and audio-seconds per second: host clock
  around synchronised forwards, after one warm-up;
- from ``torch.profiler`` over one forward: device time by kernel, the
  fused bidirectional scans' share of it (fp32: the input products and the
  serving cluster scans; under a switch its kernel), and the device's busy
  share of the window;
- the peak device memory of the steady-state forwards
  (``torch.cuda.max_memory_allocated``).

Writes ``chiprun_out/chip_profile/summary.json`` and ``trace.json`` (Chrome
trace) under the checkout.

``--train`` times ``TrainerSpe.train_step`` instead, on one batch of 5 crops
of 3 s (the reference's training batch) with the flagship model, fp32:
steady-state ms/step (host clock around synchronised steps after two
warm-up steps), and from the profiler over one step the device time of the
bilstm2 autograd Function's forward and backward (their kernels, and apart
the torch ops of their wrappers), the optimizer (gradient clipping and
Adam) and the rest (glue), with the device's busy share.
Writes ``summary_train.json`` and ``trace_train.json.gz``.

``--bss`` profiles the blind-source-separation family instead: DPRNN-TasNet
at the width and depth of configs/train_bss.yaml with ``bidirectional:
false`` (``chip_smoke.BSS``), through the BSS ``Inferencer.forward`` or
``Trainer.train_step``. The unidirectional inter-chunk scans run the same
kernels as the fused pair (the input product and a cluster scan), so they
are told apart by call site: in serving every kernel launched inside
``lstm_forward`` (wrapped here in a profiler range of that name, as
``ops/rnn.py`` calls it; a kernel counts when it ran inside the range's span
on the device) counts as ``lstm_ms`` (the scan plus its input products),
and in a train step every kernel inside the ``LSTMStack`` Function. Its files carry the suffix ``_bss``.

The JAX package's opt-in switches apply as they do to any caller (ops/rnn.py
reads them at each call):

    TSS_FUSED_DENSE=1 python3 chip_profile.py --batch 8   # dense-mode intra scans
    TSS_BM=1 python3 chip_profile.py --batch 8            # batch-major intra scans

The launch check expects the switched kernel for the intra-chunk scans, the
fused-scan time counts its kernel (``bilstm2_kernel`` in dense mode; the
batch-major entry runs the serving route's ``gemm_kernel`` and
``serve_scan_kernel``), and the summary records the switches;
``--train`` under TSS_FUSED_DENSE=1 attributes the ``BiLSTM2Dense``
Function's kernels as it does ``BiLSTM2``'s.
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


def intra_kernel() -> str:
    """The wrapper the unmasked intra-chunk scans launch under the switches
    (TSS_FUSED_DENSE wins, as in ops/rnn.py)."""
    if os.environ.get("TSS_FUSED_DENSE", "0") == "1":
        return "bilstm2_dense_forward"
    if os.environ.get("TSS_BM", "0") == "1":
        return "bilstm2_forward_bm"
    return "bilstm2_forward"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--train", action="store_true", help="profile a training step")
    ap.add_argument("--bss", action="store_true", help="the DPRNN-TasNet (BSS) family")
    args = ap.parse_args()
    if args.train:
        return profile_train(args.iters, "bss" if args.bss else "tss")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chip_smoke import (BSS, FLAGSHIP, SAMPLE_RATE, SEED, SWITCHES, all_launches,
                            product_launches, reset_launches, with_products)
    from tss_dprnn_tpu_torch.data.loader import collate_bss_eval, make_collate_spe_eval
    from tss_dprnn_tpu_torch.inference import Inferencer, InferencerSpe
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet, DPRNNTasNet
    from tss_dprnn_tpu_torch.ops import rnn as rnn_ops
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    os.makedirs(OUT_DIR, exist_ok=True)
    suffix = "_bss" if args.bss else ""
    make_model = (lambda: DPRNNTasNet(**BSS)) if args.bss else (lambda: DPRNNSpeTasNet(**FLAGSHIP))
    ckpt = os.path.join(OUT_DIR, f"random{suffix}.pt")
    torch.save(init_weights_(make_model(), torch.Generator().manual_seed(SEED)).state_dict(), ckpt)
    inf = (Inferencer if args.bss else InferencerSpe)(make_model(), {"checkpoint_path": ckpt,
                                                               "metrics": ["si_sdr"]})

    rng = np.random.default_rng(SEED)
    T = int(args.seconds * SAMPLE_RATE)
    lengths = [T] + [int(n) for n in rng.integers(T // 2, T + 1, args.batch - 1)]
    if args.bss:
        items = [(0.1 * rng.standard_normal(n).astype(np.float32),
                  0.1 * rng.standard_normal((2, n)).astype(np.float32)) for n in lengths]
        batch = collate_bss_eval(items, T)
    else:
        items = [(0.1 * rng.standard_normal(n).astype(np.float32),) * 2
                 + (0.1 * rng.standard_normal(int(rng.uniform(2, 5) * SAMPLE_RATE))
                    .astype(np.float32), 0) for n in lengths]
        batch = make_collate_spe_eval()(items, T)
    batch["lengths"] = np.asarray(lengths, np.int32)
    audio_s = sum(lengths) / SAMPLE_RATE

    # the stacked-direction scans' call site, for the attribution below
    stack_forward = rnn_ops.lstm_forward

    def lstm_forward_ranged(*args):
        with torch.profiler.record_function(STACK_RANGE):
            return stack_forward(*args)

    rnn_ops.lstm_forward = lstm_forward_ranged
    reset_launches()
    with torch.inference_mode():
        inf.forward(batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            inf.forward(batch)
        torch.cuda.synchronize()
        fwd_s = (time.perf_counter() - t0) / args.iters
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            inf.forward(batch)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(os.path.join(OUT_DIR, f"trace{suffix}.json"))

    # the profiler range shows on the device as one span per call, from its
    # first kernel's start to its last kernel's end: a kernel inside a span
    # ran inside lstm_forward
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in device if e.name == STACK_RANGE]
    by_kernel, in_stack = defaultdict(float), defaultdict(float)
    for e in device:
        if e.name == STACK_RANGE:
            continue
        by_kernel[e.name] += e.time_range.end - e.time_range.start
        if any(a <= e.time_range.start and e.time_range.end <= b for a, b in spans):
            in_stack[e.name] += e.time_range.end - e.time_range.start
    device_us = sum(by_kernel.values())

    def pair_us(*names):  # the fused pair's kernels of these names, outside lstm_forward
        return sum(v - in_stack.get(k, 0.0) for k, v in by_kernel.items()
                   if any(n in k for n in names))

    scan_us = pair_us("bilstm2_kernel", "scan_kernel")
    product_us = pair_us("gemm_kernel")
    lstm_us = scan_us + product_us
    stack_us = sum(in_stack.values())  # the scans plus their input products
    stack_product_us = sum(v for k, v in in_stack.items() if "gemm_kernel" in k)
    launches = {k: v // (args.iters + 2)
                for k, v in dict(all_launches(), **product_launches()).items() if v}
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    summary = {
        "card": smi, "switches": {k: os.environ.get(k, "0") for k in SWITCHES},
        "batch": args.batch, "bucket_s": args.seconds, "audio_s": audio_s,
        "forward_ms": fwd_s * 1e3, "audio_s_per_s": audio_s / fwd_s,
        "peak_memory_gb": peak_gb, "profiled_window_ms": window_us / 1e3,
        "device_ms": device_us / 1e3 if device_us else "not measured",
        "device_busy_share": device_us / window_us if device_us else "not measured",
        "bilstm2_ms": lstm_us / 1e3 if device_us else "not measured",
        "bilstm2_share_of_device": lstm_us / device_us if device_us else "not measured",
        "bilstm2_scan_ms": scan_us / 1e3 if device_us else "not measured",
        "bilstm2_input_product_ms": product_us / 1e3 if device_us else "not measured",
        "lstm_ms": stack_us / 1e3 if device_us else "not measured",
        "lstm_share_of_device": stack_us / device_us if device_us else "not measured",
        "lstm_input_product_ms": stack_product_us / 1e3 if device_us else "not measured",
        "lstm_calls_profiled": len(spans),
        "lstm_by_kernel_ms": {k[:120]: v / 1e3 for k, v in in_stack.items()},
        "launches_per_forward": launches, "kernels_top": [[k[:120], v / 1e3] for k, v in top],
    }
    with open(os.path.join(OUT_DIR, f"summary{suffix}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"{smi}: B={args.batch} bucket {args.seconds} s, {audio_s:.2f} audio-s: forward "
          f"{fwd_s * 1e3:.2f} ms = {audio_s / fwd_s:.2f} audio-s/s, peak memory {peak_gb:.2f} GB")
    for k, v in top:
        print(f"  {v / 1e3:9.3f} ms  {k[:110]}")
    print(json.dumps({k: v for k, v in summary.items() if k != "kernels_top"}))
    n = BSS["n_repeats"]
    want = with_products({intra_kernel(): n, "lstm_forward": n} if args.bss
                         else {intra_kernel(): 6, "bilstm2_forward_masked": 6})
    if launches != want:
        raise RuntimeError(f"expected {want} launches per forward, counted {launches} per "
                           f"forward over {args.iters + 2} forwards")
    return 0


# the profiler range around each stacked-direction forward (ops/lstm.py's
# lstm_forward, as ops/rnn.py calls it) in a serving profile
STACK_RANGE = "lstm_forward"
# the port's kernels by name: "scan_kernel" matches the training scans'
# resid_scan_kernel and bwd_scan_kernel (the fused pair's and, since both
# backwards share it, lstm_bwd.cu's);
# gemm_kernel (bf16_gemm_kernel too) and colsum_kernel are
# csrc/products.cu's (the residual forward's input product among them)
PORT_KERNELS = ("bilstm2_kernel", "lstm_kernel", "gemm_kernel", "scan_kernel", "colsum_kernel")


def train_part(op, kernel: str) -> str:
    """The part of a training step a device kernel belongs to. A kernel
    launched inside the forward or backward of the bilstm2 autograd Function
    (or of LSTMStack, the stacked-direction scan's) belongs to it, the
    wrapper's torch ops (the backward's partial sums, weight transposes and
    stack) under their own name; any other by its name."""
    own = any(k in kernel for k in PORT_KERNELS)
    while op is not None:
        if op.name in ("BiLSTM2", "BiLSTM2Masked", "BiLSTM2Dense"):
            return "resid forward" if own else "resid forward (torch ops)"
        if op.name in ("BiLSTM2Backward", "BiLSTM2MaskedBackward", "BiLSTM2DenseBackward"):
            return "backward" if own else "backward (torch ops)"
        if op.name == "LSTMStack":
            return "lstm resid forward" if own else "lstm resid forward (torch ops)"
        if op.name == "LSTMStackBackward":
            return "lstm backward" if own else "lstm backward (torch ops)"
        op = op.cpu_parent
    if "lstm_kernel" in kernel or "bilstm2_kernel" in kernel:
        return "inference forward"
    if "multi_tensor_apply" in kernel or "adam" in kernel.lower():
        return "optimizer"
    return "glue"


def profile_train(iters: int, family: str) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chip_smoke import (SEED, SWITCHES, TRAIN_BATCH, TRAIN_SECONDS, all_launches,
                            expect_launches, reset_launches, training_family)
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    fam = training_family(family)
    suffix = "_bss" if family == "bss" else ""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    os.makedirs(OUT_DIR, exist_ok=True)
    model = init_weights_(fam["model"](), torch.Generator().manual_seed(SEED))
    # the trainer's checkpoint directory; this script saves nothing there
    ckpt_dir = os.path.join(OUT_DIR, "train_ckpt_unused")
    tr = fam["trainer"](model, dict(fam["config"], new_checkpoints_path=ckpt_dir))
    os.rmdir(ckpt_dir)
    batch = fam["collate"](fam["crops"](SEED, TRAIN_BATCH, TRAIN_SECONDS).items)
    for _ in range(2):  # warm-up
        tr.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        tr.train_step(batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / iters
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    reset_launches()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tr.train_step(batch)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(os.path.join(OUT_DIR, f"trace_train{suffix}.json.gz"))
    launches = all_launches()

    by_kernel = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] += e.time_range.end - e.time_range.start
    device_us = sum(by_kernel.values())
    # each kernel hangs off the innermost op around its launch
    by_class = defaultdict(float)
    for e in prof.events():
        for k in e.kernels:
            by_class[train_part(e, k.name)] += k.duration
    unattributed = device_us - sum(by_class.values())
    if abs(unattributed) > 1e-3 * device_us:
        by_class["not linked to an op"] = unattributed
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    measured = bool(device_us)
    summary = {
        "card": smi, "switches": {k: os.environ.get(k, "0") for k in SWITCHES},
        "batch": TRAIN_BATCH, "crop_s": TRAIN_SECONDS,
        "ms_per_step": step_s * 1e3, "audio_s_per_s": TRAIN_BATCH * TRAIN_SECONDS / step_s,
        "peak_memory_gb": peak_gb, "profiled_window_ms": window_us / 1e3,
        "device_ms": device_us / 1e3 if measured else "not measured",
        "device_busy_share": device_us / window_us if measured else "not measured",
        "device_ms_by_part": ({k: v / 1e3 for k, v in sorted(by_class.items())} if measured
                              else "not measured"),
        "share_by_part": ({k: v / device_us for k, v in sorted(by_class.items())} if measured
                          else "not measured"),
        "launches_per_step": {k: v for k, v in launches.items() if v},
        "kernels_top": [[k[:120], v / 1e3] for k, v in top],
    }
    with open(os.path.join(OUT_DIR, f"summary_train{suffix}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"{smi}: train step B={TRAIN_BATCH} x {TRAIN_SECONDS} s: {step_s * 1e3:.2f} ms/step, "
          f"peak memory {peak_gb:.2f} GB")
    for k, v in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {v / 1e3:9.3f} ms  {100 * v / max(device_us, 1):5.1f} %  {k}")
    for k, v in top:
        print(f"  {v / 1e3:9.3f} ms  {k[:110]}")
    print(json.dumps({k: v for k, v in summary.items() if k != "kernels_top"}))
    expect_launches(launches, fam["per_train_step"], 1, f"{family} train step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
