#!/usr/bin/env python3
"""Readings that set a cell's correctness limits (``checks/<cell>.json``), in
one process on the card.

    python3 benchmark/tools/calibrate.py --workload <cell> --seeds 1,2,...,12 \
        --controls 21,22,23 [--faults half,altered] [--fault-seeds 31,32,33] \
        [--seconds 4] [--completed 400] [--out .bench_out/calibrate/<cell>.jsonl]

- the program: a run per seed (``run_cell``, a short window at the cell's
  own load), its compared numbers;
- the control: the reference in TF32 put in the program's place, against
  the reference in float32, over what a run compares (for serving, the
  sample a run that completed ``--completed`` requests would draw);
- faults (training cells): the program with a fault planted in its timed
  path, against the reference: ``half`` (half of each batch left out, the
  loss the mean over the rest), ``altered`` (the estimate altered where the
  model produces it). A step that leaves the state unchanged reads 1 by the
  measure and needs no run.
Each reading is a JSON line in ``--out``; the summary gives, per reading
(the compared numbers and the others, such as each step's loss gap), the
largest program reading and the smallest control and fault readings.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark.lib import harness, port  # noqa: E402
from benchmark.lib.registry import Registry  # noqa: E402
from benchmark.lib.weights import seeded_state  # noqa: E402


def fault(kind: str):
    """A patch planting ``kind`` in a training loop's timed path."""
    def patch(loop):
        tr = loop.tr
        if kind == "half":
            to_device = tr._to_device

            def half(batch):
                b = to_device(batch)
                n = (b["mix"].shape[0] + 1) // 2
                return {k: v[:n] for k, v in b.items()}

            tr._to_device = half
        elif kind == "altered":
            def altered(_module, _inputs, out):
                est = out[0] if isinstance(out, tuple) else out
                est = est + 1e-3 * est.roll(1, -1)
                return (est,) + tuple(out[1:]) if isinstance(out, tuple) else est

            tr.model.register_forward_hook(altered)
        else:
            raise ValueError(kind)
    return patch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--controls", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--completed", type=int, default=400)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    reg = Registry()
    cell = reg.cell(args.workload)
    config, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    out = Path(args.out or ROOT / ".bench_out" / "calibrate" / f"{args.workload}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    readings = {}

    def record(kind, seed, checks, wall):
        line = {"workload": args.workload, "kind": kind, "seed": seed, "checks": checks,
                "wall_s": wall, "card": torch.cuda.get_device_name(device)}
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
        for k, v in checks.items():
            readings.setdefault(kind, {}).setdefault(k, []).append(v)

    for seed in ints(args.seeds):
        t0 = time.perf_counter()
        result = harness.run_cell(reg, args.workload, seed, args.seconds, False, device, t0)
        record("program", seed, dict(result["notes"], **{k: v["value"] for k, v
                                                         in result["checks"].items()}),
               time.perf_counter() - t0)
    for kind, seeds in [("control", ints(args.controls))] + [
            (f, ints(args.fault_seeds)) for f in args.faults.split(",") if f]:
        for seed in seeds:
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as scratch:
                loop = harness.make_loop(reg, config, traffic, seed, device, scratch)
                if kind == "control" and traffic["loop"] == "serve":
                    loop.state = seeded_state(port.template(config), seed, device)
                    checks = loop.control(args.completed)
                elif kind == "control":
                    loop.setup(False)
                    loop.free()
                    checks = loop.control()
                else:
                    loop.setup(False, fault(kind))
                    loop.free()
                    checks = loop.check()
            record(kind, seed, checks, time.perf_counter() - t0)
            torch.cuda.empty_cache()
    for kind, nums in readings.items():
        for k, vs in nums.items():
            edge = max(vs) if kind == "program" else min(vs)
            print(f"{args.workload} {kind} {k}: {'max' if kind == 'program' else 'min'} "
                  f"{edge!r} over {len(vs)}: {vs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
