#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the NVIDIA cards the cell
asks for; without them it exits non-zero and prints no result. The run
makes its weights and traffic from ``--seed``, warms up, measures for
``--seconds``, checks the timed path's outputs against the plain reference
(``benchmark/reference/``) and prints one JSON object as the last line of
standard output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a profiled stretch of the window.
The numbers compared, each with its limit, are the last lines of standard
error and the result's last key, ``checks``.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# caches a library could keep: in the checkout, at fixed paths
CACHE_DIRS = {"TRITON_CACHE_DIR": ROOT / ".bench_cache" / "triton",
              "TORCH_EXTENSIONS_DIR": ROOT / ".bench_cache" / "torch_extensions"}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    for var, path in CACHE_DIRS.items():
        os.environ[var] = str(path)
    sys.path[0] = str(ROOT)  # the checkout, in place of this script's directory

    from benchmark.lib.registry import Registry

    registry = Registry()
    cell = registry.cell(args.workload)
    import tss_dprnn_tpu_torch

    if ROOT not in Path(tss_dprnn_tpu_torch.__file__).resolve().parents:
        print(f"benchmark: the program was loaded from {tss_dprnn_tpu_torch.__file__}, not "
              f"from this checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA card; the benchmark runs on the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from benchmark.lib.harness import forbidden_modules, result_line, run_cell

    device = torch.device("cuda", 0)
    result = run_cell(registry, args.workload, args.seed, args.seconds, bool(args.trace),
                      device, STARTED)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print("setup phases (s): " + json.dumps(result["setup_phases"]), file=sys.stderr)
    line, err = result_line(result, dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                                         power_limit=power_limit()))
    print(line, flush=True)
    print("\n".join(err), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
