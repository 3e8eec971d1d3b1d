#!/usr/bin/env python3
"""Runs of one cell in turn, each a process of its own, and their spread.

    python3 benchmark/tools/series.py --workload <cell> --seeds 11,12,13 \
        --seconds 20 [--trace 0] [--out .bench_out/series/<cell>.jsonl]

Each run is ``benchmark/run.py`` as the check runs it; its result line and
the end of its standard error go to ``--out`` (one JSON object a run). The
summary gives each metric's values, median and spread: the distance between
the first and third quartile (``statistics.quantiles(n=4)``) over the
median.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = Path(args.out or ROOT / ".bench_out" / "series" / f"{args.workload}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    values = {}
    with open(out, "a") as f:
        for seed in [int(s) for s in args.seeds.split(",")]:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", args.workload,
                                   "--seed", str(seed), "--seconds", str(args.seconds),
                                   "--trace", str(args.trace)],
                                  cwd=ROOT, capture_output=True, text=True, env=dict(os.environ))
            wall = time.perf_counter() - t0
            lines = proc.stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                result = None
            rec = {"workload": args.workload, "seed": seed, "trace": args.trace, "rc": proc.returncode,
                   "wall_s": wall, "result": result, "stderr_tail": proc.stderr[-3000:]}
            f.write(json.dumps(rec) + "\n")
            f.flush()
            if result is None:
                print(f"{args.workload} seed {seed}: rc {proc.returncode}, no result\n"
                      f"{proc.stderr[-2500:]}", flush=True)
                continue
            ms = {k: v["value"] for k, v in result["metrics"].items()}
            for k, v in ms.items():
                values.setdefault(k, []).append(v)
            checks = {k: v["value"] for k, v in result.get("checks", {}).items()}
            print(f"{args.workload} seed {seed} trace {args.trace}: rc {proc.returncode} "
                  f"wall {wall:.1f} s correct {result['correct']} attempted {result['attempted']} "
                  f"metrics {json.dumps(ms)} checks {json.dumps(checks)} "
                  f"peak {result['device'].get('memory_peak_bytes')}", flush=True)
    for k, vs in values.items():
        s = spread(vs)
        print(f"  {k}: median {statistics.median(vs)!r} spread {s!r} values {vs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
