#!/usr/bin/env python3
"""Time one tree's serving-route and training kernels in a fresh process
(card).

    python3 scripts/port/route_turns.py [--tree DIR] [--out FILE]
        [--rows serve,train,step,cs,save_every]

Imports ``tss_dprnn_tpu_torch`` from DIR (default: this checkout; DIR may be
another revision unpacked with ``git archive``), builds the kernels it
needs, and prints one JSON object: the card's name and power limit,
ptxas's registers and spills of every kernel instantiation of the tree's
sources, and the mean device ms (CUDA events, 5 calls after a warm-up) at
chip_smoke.py's shapes of 8 x 10 s of

- the default serving rows: ``bilstm2_forward`` unmasked (R=5136 T=250) and
  ``bilstm2_forward_masked`` (R=2000 T=642, ragged lengths), fp32 and bf16,
  and ``lstm_forward`` D=1 (R=2000 T=642), fp32 and bf16;
- the batch-major and manual-DMA kernels' entries, ``bilstm2_forward_bm`` and
  ``bilstm_v2`` (R=5136 T=250) and ``lstm_scan_v2`` D=1 (R=2000 T=642), the
  dense mode ``bilstm2_dense_forward`` (R=5136 T=250, Fo=128) and the
  shared-input pair ``bilstm_fused`` (R=5136 T=250), fp32 and bf16,
  whichever kernels the tree runs them on;
- (``--rows train``) the training pair's residual forward and backward,
  ``bilstm2_forward_resid`` / ``bilstm2_backward`` at the 5 x 3 s step's
  intra (R=970 T=250) and inter (R=1250 T=194) shapes and their masked
  entries at 8 x 10 s (R=2000 T=642, ragged) and at phase 16's varlen inter
  shape (R=1250 T=322, ragged), and the stack's ``lstm_forward_resid`` /
  ``lstm_backward`` D=1 (R=1250 T=194), fp32 and bf16 (each backward on its
  own forward's saved streams, its ms alone), with a digest of every fp32
  output and gradient (two int64 sums of their bits), equal between two
  trees whose fp32 training pair gives the same bits;
- (``--rows step``) a 5 x 3 s flagship ``TrainerSpe`` step (host clock
  around a synchronised step, mean of 3 after two warm-up steps), fp32 and
  ``model.dtype: bfloat16``, from one seeded initialisation;
- (``--rows cs``) the cell-state forward ``lstm_forward_with_cs``, fp32 and
  bf16, at D=1 R=2000 T=642 (the causal BSS inter scan of 8 x 10 s), D=2
  R=1610 T=250 (chip_smoke.py phase 16's largest variable-length bucket,
  intra) and D=2 R=970 T=250 (the 5 x 3 s step's intra scan), with a digest
  of its fp32 outputs;
- (``--rows save_every``) the ``step`` rows' 5 x 3 s step under
  ``lstm_save_every: 10``, both lanes.

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
    ap.add_argument("--rows", default="serve,train,step",
                    help="comma-separated: serve, train, step, cs, save_every")
    args = ap.parse_args()
    which = set(args.rows.split(","))
    if not which <= {"serve", "train", "step", "cs", "save_every"}:
        ap.error(f"--rows takes serve, train, step, cs, save_every; got {args.rows}")
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
    libs = sorted(n[:-3] for n in os.listdir(csrc) if n.endswith(".cu"))  # the tree's own
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(_build.load_library, libs))
    ptxas = cs.ptxas_report(_build.build_logs, ("_kernel",))
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
    for name, fn in calls.items() if "serve" in which else ():
        for dt, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            x = inputs[name].to(dt)
            rows[f"{name}_{tag}"] = cs.time_ms(lambda: fn(x), 5)
            del x
            torch.cuda.empty_cache()
    del xu, xm
    digests = {}
    if "train" in which:
        rows.update(_training_rows(torch, cs, B, L, g, dev, (w_ih2, b2, w_hh2), lens, digests))
    if "cs" in which:
        rows.update(_cs_rows(torch, cs, L, g, dev, digests))
    if "step" in which:
        rows.update(_step_rows(torch, cs, dev))
    if "save_every" in which:
        rows.update(_step_rows(torch, cs, dev, save_every=10))
    out = {"tree": tree, "card": smi, "ptxas": ptxas, "ms": rows, "fp32_digests": digests,
           "shapes": {"unmasked": [Ru, Tu], "masked": [Rm, Tm]}}
    text = json.dumps(out)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return 0


def _digest(torch, tensors):
    """Two int64 sums over the bits of every tensor (fp32): the plain sum and
    the sum weighted by (index mod 251) + 1, wrapping, in chunks."""
    plain = weighted = 0
    for t in tensors:
        bits = t.detach().contiguous().view(-1).view(torch.int32)
        for i in range(0, bits.numel(), 1 << 26):
            chunk = bits[i:i + (1 << 26)].to(torch.int64)
            w = torch.arange(i, i + chunk.numel(), device=chunk.device) % 251 + 1
            plain += int(chunk.sum())
            weighted += int((chunk * w).sum())
    return [plain % 2 ** 64, weighted % 2 ** 64]


def _training_rows(torch, cs, B, L, g, dev, w, masked_lens, digests):
    """The training pair's and the stack's forward and backward ms, fp32 and
    bf16, and the fp32 outputs' digests into ``digests`` (see the module
    docstring)."""
    shapes = cs.train_shapes()
    Rv, Tv = 1250, 322
    varlen_lens = torch.randint(Tv // 2, Tv + 1, (Rv,), generator=g).int().to(dev)
    cases = [("intra", *shapes["intra"], None), ("inter", *shapes["inter"], None),
             ("masked", 2000, 642, masked_lens), ("varlen", Rv, Tv, varlen_lens)]
    w1 = tuple(t[:1] for t in w)
    rows = {}
    for dt, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for name, R, T, lens in cases:
            x = torch.randn(R, T, 128, generator=g).to(dev).to(dt)
            cots = [torch.randn(R, T, 128, generator=g).to(dev).to(dt) for _ in range(2)]
            if lens is None:
                def fwd():
                    return B.bilstm2_forward_resid(x, *w)

                def bwd(resid):
                    return B.bilstm2_backward(x, resid, *cots, *w)
            else:
                valid = torch.arange(T, device=dev)[None, :] < lens[:, None]
                cots[0] = cots[0] * valid[..., None]  # out0 past a row's length is discarded

                def fwd():
                    return B.bilstm2_forward_resid_masked(x, lens, *w)

                def bwd(resid):
                    return B.bilstm2_backward_masked(x, resid, *cots, *w, lens)
            rows[f"bilstm2_forward_resid_{name}_{tag}"] = cs.time_ms(fwd, 5)
            outs, resid = fwd()
            rows[f"bilstm2_backward_{name}_{tag}"] = cs.time_ms(lambda: bwd(resid), 5)
            if dt == torch.float32:
                digests[f"bilstm2_forward_resid_{name}"] = _digest(torch, (*outs, *resid))
                digests[f"bilstm2_backward_{name}"] = _digest(torch, bwd(resid))
            del x, cots, outs, resid
            torch.cuda.empty_cache()
        R, T = shapes["inter"]
        x = torch.randn(1, R, T, 128, generator=g).to(dev).to(dt)
        cot = torch.randn(1, R, T, 128, generator=g).to(dev).to(dt)
        rows[f"lstm_forward_resid_inter_{tag}"] = cs.time_ms(
            lambda: L.lstm_forward_resid(x, *w1), 5)
        h, resid = L.lstm_forward_resid(x, *w1)
        rows[f"lstm_backward_inter_{tag}"] = cs.time_ms(
            lambda: L.lstm_backward(x, resid, cot, *w1), 5)
        if dt == torch.float32:
            digests["lstm_forward_resid_inter"] = _digest(torch, (h, *resid))
            digests["lstm_backward_inter"] = _digest(torch, L.lstm_backward(x, resid, cot, *w1))
        del x, cot, h, resid
        torch.cuda.empty_cache()
    return rows


def _cs_rows(torch, cs, L, g, dev, digests):
    """lstm_forward_with_cs's ms at its three shapes, fp32 and bf16, and its
    fp32 outputs' digests into ``digests``."""
    F = H = 128
    k = H ** -0.5
    rows = {}
    for D, R, T in ((1, 2000, 642), (2, 1610, 250), (2, *cs.train_shapes()["intra"])):
        w = [(torch.rand(*s, generator=g) * 2 * k - k).to(dev)
             for s in ((D, F, 4 * H), (D, 4 * H), (D, H, 4 * H))]
        x = torch.randn(D, R, T, F, generator=g).to(dev)
        name = f"lstm_forward_with_cs_D{D}_R{R}_T{T}"
        digests[name] = _digest(torch, L.lstm_forward_with_cs(x, *w))
        for dt, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            xd = x.to(dt)
            rows[f"{name}_{tag}"] = cs.time_ms(lambda: L.lstm_forward_with_cs(xd, *w), 5)
            del xd
        del x, w
        torch.cuda.empty_cache()
    return rows


def _step_rows(torch, cs, dev, save_every: int = 1):
    """A 5 x 3 s flagship TrainerSpe step's ms in both lanes (under
    ``lstm_save_every: save_every`` when it is above 1)."""
    import time

    from tss_dprnn_tpu_torch import training
    from tss_dprnn_tpu_torch.data import loader
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    start = init_weights_(DPRNNSpeTasNet(**cs.FLAGSHIP),
                          torch.Generator().manual_seed(cs.SEED + 71)).state_dict()
    batch = loader.collate_spe(cs.Crops(cs.SEED + 72, cs.TRAIN_BATCH, cs.TRAIN_SECONDS).items)
    rows = {}
    for kw, tag in (({}, "fp32"), ({"dtype": torch.bfloat16}, "bf16")):
        model = DPRNNSpeTasNet(**cs.FLAGSHIP, **kw)
        model.load_state_dict(start, strict=True)
        config = dict(cs.TRAIN_CONFIG, new_checkpoints_path=os.path.join(
            cs.OUT_DIR, "route_turns_ckpt_unused"))
        if save_every > 1:
            config["lstm_save_every"] = save_every
        t = training.TrainerSpe(model, config, device=dev)
        t.model.train()
        for _ in range(2):
            t.train_step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            t.train_step(batch)
        torch.cuda.synchronize()
        suffix = f"_save_every{save_every}" if save_every > 1 else ""
        rows[f"tss_train_step_5x3s{suffix}_{tag}"] = (time.perf_counter() - t0) * 1e3 / 3
        del t, model
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    sys.exit(main())
