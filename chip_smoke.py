#!/usr/bin/env python3
"""Drive the PyTorch port (tss_dprnn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the script (nonzero exit, no result line):
1. set-up: the card's name and power limit, torch and CUDA versions, and
   the nvcc build of the fused BiLSTM kernel from csrc/ (with ptxas's
   register and spill report);
2. kernel vs plain: the bilstm2 kernel against its plain PyTorch version on
   the card, unmasked at the intra-chunk shape and masked at the
   inter-chunk shape of a batch of 8 x 10 s, in fp32 (max abs error
   <= 1e-4) and bf16 (>= 40 dB SNR against the fp32 plain version, and
   >= BF16_SNR_DB and within BF16_ATOL of the bf16 plain version), timed
   beside the plain
   version and cuDNN's LSTM on the same weights (on a PackedSequence in
   masked mode);
3. the main path: InferencerSpe.run over 12 requests with the flagship
   DPRNN-Spe-TasNet at full width and depth (random weights from a seed);
   the kernel must have been launched 12 times per batch (6 blocks x an
   intra and an inter scan), every SI-SDR finite;
4. card vs CPU on one 2 s request (>= 50 dB SNR, fp32) and the request
   bucketed with a longer one against the request run alone.

The line before the last is {"kernels": [...]} with the kernel's numbers;
the last line is {"ok": true, "device": {...}}. Files go to
chiprun_out/chip_smoke/ under the checkout.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "chip_smoke")

# the flagship DPRNN-Spe-TasNet, 'att' fusion (FLAGSHIP of the JAX package)
FLAGSHIP = dict(
    input_size=64, feature_size=128, hidden_size=128, chunk_length=250,
    kernel_size=2, hop_length=125, n_repeats=6, bidirectional=True,
    norm_type="ln", activation_type="sigmoid", dropout=0,
    O=128, P=256, embeddings_size=128, num_spks=251, fusion_type="att",
)
SAMPLE_RATE = 8000
SEED = 0
# published H100 SXM peaks: fp32 outside the tensor cores, dense bf16, HBM3
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
# bf16 kernel vs bf16 plain version. The two sum a gate in different orders,
# so a rounded h may differ by a bf16 ulp (2^-8 for |h| in [0.5, 1)): the
# kernel is 1 ulp off at most and about 80 dB SNR on an H100, where a kernel
# that fed h back unrounded was also 1 ulp off but about 60 dB. The SNR bound
# is the one that holds the rounding.
BF16_ATOL = 2.0 ** -7
BF16_SNR_DB = 70.0


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def snr_db(got, want) -> float:
    got, want = got.double(), want.double()
    return float(10 * math.log10(want.pow(2).sum() / (got - want).pow(2).sum().clamp_min(1e-300)))


def bound(rows_steps: int, R: int, T: int, F: int, H: int, itemsize: int, peak: float):
    """Least time for the work: the FLOPs the data needs (both directions over
    ``rows_steps`` row-steps) over the named peak, or each input read once
    (the row-steps' x, the fp32 weights and biases) and both outputs written
    once over the HBM rate."""
    flops = 2 * rows_steps * 2 * (F + H) * 4 * H
    nbytes = rows_steps * F * itemsize + 2 * R * T * H * itemsize + 2 * (F + H + 1) * 4 * H * 4
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def cudnn_lstm(torch, w_ih2, b2, w_hh2, dtype):
    """torch.nn.LSTM (cuDNN) holding the kernel's weights: the library
    yardstick, timed here and never called by the port."""
    F, H = w_ih2.shape[1], w_hh2.shape[1]
    lstm = torch.nn.LSTM(F, H, batch_first=True, bidirectional=True).to(w_ih2.device)
    with torch.no_grad():
        for d, sfx in enumerate(("", "_reverse")):
            getattr(lstm, f"weight_ih_l0{sfx}").copy_(w_ih2[d].T)
            getattr(lstm, f"weight_hh_l0{sfx}").copy_(w_hh2[d].T)
            getattr(lstm, f"bias_ih_l0{sfx}").copy_(b2[d])
            getattr(lstm, f"bias_hh_l0{sfx}").zero_()
    lstm = lstm.to(dtype)
    lstm.flatten_parameters()
    return lstm


def phase_kernel(torch, dev):
    """Phase 2: the kernel against its plain version at the main path's shapes."""
    from tss_dprnn_tpu_torch.ops.bilstm2 import (
        bilstm2_forward, bilstm2_forward_masked, bilstm2_reference)

    F = H = 128
    K, hop = FLAGSHIP["chunk_length"], FLAGSHIP["hop_length"]
    B, L = 8, 10 * SAMPLE_RATE - 1            # 8 x 10 s, encoder frames
    S = (L + K) // hop + 1
    g = torch.Generator(device="cpu").manual_seed(SEED)
    k = H ** -0.5
    w_ih2, w_hh2, b2 = ((torch.rand(*s, generator=g) * 2 * k - k).to(dev)
                        for s in ((2, F, 4 * H), (2, H, 4 * H), (2, 4 * H)))
    # chunk counts of ragged utterances (5-10 s), one per batch row, over K rows
    secs = torch.rand(B, generator=g) * 5 + 5
    utt_chunks = ((secs * SAMPLE_RATE).long() - 1 + K) // hop + 1
    shapes = {
        "unmasked": (B * S, K, None),                                   # intra scan
        "masked": (B * K, S, utt_chunks.repeat_interleave(K).int().to(dev)),  # inter scan
    }
    entries = []
    for mode, (R, T, lens) in shapes.items():
        x = torch.randn(R, T, F, generator=g).to(dev)
        rows_steps = R * T if lens is None else int(lens.sum())
        valid = None if lens is None else torch.arange(T, device=dev)[None, :] < lens[:, None]

        def run(xx, kernel=True):
            if not kernel:
                return bilstm2_reference(xx, w_ih2, b2, w_hh2, lens)
            if lens is None:
                return bilstm2_forward(xx, w_ih2, b2, w_hh2)
            return bilstm2_forward_masked(xx, lens, w_ih2, b2, w_hh2)

        if lens is None:
            def library(lstm, xx):
                return lstm(xx)[0]
        else:  # cuDNN's variable-length LSTM: direction 1 starts at x[len - 1]
            lens_cpu = lens.cpu()
            pack = torch.nn.utils.rnn.pack_padded_sequence

            def library(lstm, xx):
                return lstm(pack(xx, lens_cpu, batch_first=True, enforce_sorted=False))[0]

        def region(out):  # out0 is compared on t < len only
            o0, o1 = out
            o0 = o0.float() if valid is None else o0.float()[valid]
            return torch.cat([o0.flatten(), o1.float().flatten()])

        ref32 = region(run(x, kernel=False))
        got32 = region(run(x))
        torch.cuda.synchronize()
        err32 = float((got32 - ref32).abs().max())
        xb = x.bfloat16()
        got16 = region(run(xb))
        snr16 = snr_db(got16, ref32)
        ref16 = region(run(xb, kernel=False))
        plain16_err = float((got16 - ref16).abs().max())
        plain16_snr = snr_db(got16, ref16)
        log(f"[kernel] {mode} R={R} T={T}: fp32 max|err|={err32:.3e}  bf16 SNR={snr16:.2f} dB "
            f"(bf16 kernel vs bf16 plain max|err|={plain16_err:.3e}, SNR {plain16_snr:.2f} dB)")
        if not err32 <= 1e-4:
            raise AssertionError(f"bilstm2 {mode} fp32 disagrees with its plain version: {err32}")
        if not snr16 >= 40.0:
            raise AssertionError(f"bilstm2 {mode} bf16 SNR {snr16:.2f} dB < 40 dB")
        if not (plain16_err <= BF16_ATOL and plain16_snr >= BF16_SNR_DB):
            raise AssertionError(f"bilstm2 {mode} bf16 disagrees with its bf16 plain version: "
                                 f"max|err| {plain16_err} (<= {BF16_ATOL}), "
                                 f"SNR {plain16_snr:.2f} dB (>= {BF16_SNR_DB})")

        # cuDNN's LSTM computes the same function: the yardstick
        lstms = {dt: cudnn_lstm(torch, w_ih2, b2, w_hh2, dt)
                 for dt in (torch.float32, torch.bfloat16)}
        with torch.no_grad():
            out = library(lstms[torch.float32], x)
            if lens is not None:
                out = torch.nn.utils.rnn.pad_packed_sequence(out, batch_first=True,
                                                             total_length=T)[0]
            library_err = float((region(out.split(H, dim=-1)) - ref32).abs().max())
        log(f"[kernel] {mode} cuDNN fp32 vs plain max|err|={library_err:.3e}")
        entry = {"name": "bilstm2_forward" if lens is None else "bilstm2_forward_masked",
                 "mode": mode, "dtype": "float32", "route": "cuda", "source": "tss_dprnn_tpu_torch/csrc/bilstm2.cu",
                 "replaces": "tss_dprnn_tpu/ops/pallas_lstm.py:698",
                 "shape": {"R": R, "T": T, "F": F, "H": H},
                 "max_abs_err": err32, "library_max_abs_err": library_err}
        for dt, key, peak, size in ((torch.float32, None, PEAK_FP32, 4),
                                    (torch.bfloat16, "bf16", PEAK_BF16, 2)):
            xx = x.to(dt)
            ms = time_ms(lambda: run(xx), 5)
            plain_ms = time_ms(lambda: run(xx, kernel=False), 2)
            with torch.no_grad():
                library_ms = time_ms(lambda: library(lstms[dt], xx), 3)
            bound_ms, bound_by = bound(rows_steps, R, T, F, H, size, peak)
            nums = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms}
            if key is None:
                entry.update(nums)
            else:
                entry[key] = dict(nums, snr_db=snr16, plain_max_abs_err=plain16_err,
                                  plain_snr_db=plain16_snr)
            log(f"[kernel] {mode} {dt}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                f"cuDNN {library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})")
        entries.append(entry)
        del x, xb, lstms
        torch.cuda.empty_cache()
    return entries


class Requests:
    """In-memory requests: ds[i] -> (mix, target, reference, spk_idx)."""

    def __init__(self, seed: int, n: int):
        import numpy as np

        rng = np.random.default_rng(seed)
        secs = list(rng.uniform(2, 6, n - 1)) + [10.0]
        self.items = []
        for s in secs:
            target = 0.1 * rng.standard_normal(int(s * SAMPLE_RATE)).astype(np.float32)
            mix = target + 0.1 * rng.standard_normal(target.shape).astype(np.float32)
            ref = 0.1 * rng.standard_normal(int(rng.uniform(2, 5) * SAMPLE_RATE)).astype(np.float32)
            self.items.append((mix, target, ref, int(rng.integers(0, 251))))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        return [len(it[0]) for it in self.items]


def phase_main_path(torch, dev, ckpt):
    """Phase 3: InferencerSpe.run at full flagship width over 12 requests."""
    from tss_dprnn_tpu_torch.data.loader import BucketedEvalLoader, make_collate_spe_eval
    from tss_dprnn_tpu_torch.inference import InferencerSpe
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.ops import bilstm2

    ds = Requests(SEED, 12)
    batch_size, n_buckets = 4, 2
    n_batches = len(BucketedEvalLoader(ds, batch_size, make_collate_spe_eval(), ds.lengths(),
                                       n_buckets=n_buckets))
    savedir = os.path.join(OUT_DIR, "metrics")
    config = {"checkpoint_path": ckpt, "test_savedir": savedir, "metrics": ["si_sdr"],
              "data": {"sample_rate": SAMPLE_RATE}}
    inf = InferencerSpe(DPRNNSpeTasNet(**FLAGSHIP), config, device=dev)
    bilstm2.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final = inf.run(ds, batch_size=batch_size, n_buckets=n_buckets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"unmasked": bilstm2.bilstm2_forward.launches,
                "masked": bilstm2.bilstm2_forward_masked.launches}
    audio_s = sum(ds.lengths()) / SAMPLE_RATE
    log(f"[main] {len(ds)} requests, {n_batches} batches, {audio_s:.2f} audio-s in {wall:.3f} s "
        f"= {audio_s / wall:.2f} audio-s/s (first run, includes warm-up); launches {launches}; "
        f"final {final}")
    if launches != {"unmasked": 6 * n_batches, "masked": 6 * n_batches}:
        raise AssertionError(f"expected 12 launches per batch over {n_batches} batches: {launches}")
    with open(os.path.join(savedir, "all_metrics.csv")) as f:
        rows = f.read().strip().splitlines()[1:]
    si = [float(r.split(",")[1]) for r in rows]
    if len(si) != len(ds) or not all(math.isfinite(v) for v in si):
        raise AssertionError(f"non-finite or missing si_sdr rows: {si}")
    if not os.path.exists(os.path.join(savedir, "final_metrics.json")):
        raise AssertionError("final_metrics.json was not written")
    return inf, launches, audio_s / wall


def phase_card_vs_cpu(torch, inf_gpu, ckpt):
    """Phase 4: card vs CPU on one 2 s request; bucketed vs alone on the card."""
    import numpy as np

    from tss_dprnn_tpu_torch.data.loader import make_collate_spe_eval
    from tss_dprnn_tpu_torch.inference import InferencerSpe
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet

    rng = np.random.default_rng(SEED + 1)
    n, n_long = 2 * SAMPLE_RATE, 3 * SAMPLE_RATE
    items = [(0.1 * rng.standard_normal(m).astype(np.float32),) * 2
             + (0.1 * rng.standard_normal(r).astype(np.float32), 0)
             for m, r in ((n, 3 * SAMPLE_RATE), (n_long, 2 * SAMPLE_RATE + 777))]
    collate = make_collate_spe_eval()

    def batch_of(its, T):
        b = collate(its, T)
        b["lengths"] = np.array([len(it[0]) for it in its], np.int32)
        return b

    inf_cpu = InferencerSpe(DPRNNSpeTasNet(**FLAGSHIP), {"checkpoint_path": ckpt},
                            device="cpu")

    def alone(inf):  # the request at its exact shape, no lengths
        mix, _, ref, _ = items[0]
        ref_len = torch.tensor([float(len(ref))], device=inf.device)
        return inf.model(torch.from_numpy(mix).to(inf.device)[None],
                         torch.from_numpy(ref).to(inf.device)[None], ref_len)[0].cpu()

    with torch.inference_mode():
        est_gpu = alone(inf_gpu)
        est_cpu = alone(inf_cpu)
        bucketed = inf_gpu.forward(batch_of(items, n_long)).cpu()
    s_cpu = snr_db(est_gpu[0], est_cpu[0])
    s_bucket = snr_db(bucketed[0, :n], est_gpu[0])
    err_bucket = float((bucketed[0, :n] - est_gpu[0]).abs().max())
    log(f"[check] card vs CPU: {s_cpu:.2f} dB SNR; bucketed vs alone: {s_bucket:.2f} dB SNR, "
        f"max|err|={err_bucket:.3e}")
    if not s_cpu >= 50.0:
        raise AssertionError(f"card vs CPU SNR {s_cpu:.2f} dB < 50 dB")
    if not torch.allclose(bucketed[0, :n], est_gpu[0], atol=2e-4, rtol=1e-4):
        raise AssertionError(f"bucketed row differs from the request alone: {err_bucket}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from tss_dprnn_tpu_torch.device import resolve_device
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.ops import _build
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = resolve_device()
    log(f"[setup] {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load_library("bilstm2")
    log(f"[setup] bilstm2 kernel built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_logs.get("bilstm2", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[setup] ptxas: {line.strip()}")

    t0 = time.perf_counter()
    entries = phase_kernel(torch, dev)
    log(f"[kernel] phase done in {time.perf_counter() - t0:.1f} s")

    os.makedirs(OUT_DIR, exist_ok=True)
    ckpt = os.path.join(OUT_DIR, "flagship_random.pt")
    model = init_weights_(DPRNNSpeTasNet(**FLAGSHIP), torch.Generator().manual_seed(SEED))
    torch.save(model.state_dict(), ckpt)
    t0 = time.perf_counter()
    inf, launches, rate = phase_main_path(torch, dev, ckpt)
    log(f"[main] phase done in {time.perf_counter() - t0:.1f} s; "
        f"{rate:.2f} audio-s/s on {smi}")
    for e in entries:
        e["launches"] = launches[e["mode"]]

    t0 = time.perf_counter()
    phase_card_vs_cpu(torch, inf, ckpt)
    log(f"[check] phase done in {time.perf_counter() - t0:.1f} s; "
        f"total {time.perf_counter() - t_start:.1f} s")

    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
