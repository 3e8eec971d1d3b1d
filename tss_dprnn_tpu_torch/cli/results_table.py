"""Aggregate final_metrics.json files into the reference README's results
table (counterpart of ``tss_dprnn_tpu/cli/results_table.py``; reference
README.md:36-45 is hand-transcribed from metrics/*/final_metrics.json; this
renders it mechanically). Host JSON only: no device, no model.

    python -m tss_dprnn_tpu_torch.cli.results_table results/**/final_metrics*.json
    python -m tss_dprnn_tpu_torch.cli.results_table --compare-reference results/...

``--compare-reference`` reads the reference's shipped ``metrics/`` tree at
``REFERENCE_METRICS`` only when that directory is there.
"""

from __future__ import annotations

import argparse
import json
import os


def _label(path: str) -> str:
    """'<family> <variant>' from .../<family>/final_metrics[_<variant>].json.

    Shared by our results and the reference's shipped metrics/ tree so
    `--compare-reference` can match rows (e.g. 'dprnn-spe attention').
    """
    family = os.path.basename(os.path.dirname(os.path.abspath(path)))
    stem = os.path.splitext(os.path.basename(path))[0]
    variant = stem[len("final_metrics"):].lstrip("_")
    return f"{family} {variant}".strip()


def load_rows(paths):
    rows = []
    for p in paths:
        with open(p) as f:
            m = json.load(f)
        rows.append((_label(p), m))
    return rows


def render(rows, reference_rows=None):
    cols = ["si_sdr", "si_sdr_imp", "pesq", "stoi"]
    header = "| model | SI-SDR | SI-SDRi | PESQ | STOI |"
    sep = "|---|---|---|---|---|"
    lines = [header, sep]
    refmap = dict(reference_rows or [])
    for label, m in rows:
        cells = []
        for c in cols:
            v = m.get(c)
            cells.append("—" if v is None else f"{v:.2f}" if "stoi" not in c else f"{v:.3f}")
        line = f"| {label} | " + " | ".join(cells) + " |"
        lines.append(line)
        ref = refmap.get(label)
        if ref:
            delta = {c: (m.get(c) - ref.get(c)) for c in cols
                     if m.get(c) is not None and ref.get(c) is not None}
            lines.append(
                "| ↳ Δ vs reference | "
                + " | ".join(f"{delta.get(c, 0):+.2f}" if c in delta else "—" for c in cols)
                + " |"
            )
    return "\n".join(lines)


REFERENCE_METRICS = "/root/reference/metrics"


def reference_rows(root=None):
    """The reference's shipped metric JSONs, when mounted."""
    rows = []
    root = REFERENCE_METRICS if root is None else root
    if not os.path.isdir(root):
        return rows
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.startswith("final_metrics") and f.endswith(".json"):
                p = os.path.join(dirpath, f)
                with open(p) as fh:
                    rows.append((_label(p), json.load(fh)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description="render a results table from final_metrics.json files")
    ap.add_argument("paths", nargs="*", help="final_metrics.json files")
    ap.add_argument("--compare-reference", action="store_true",
                    help="append a Δ-vs-reference row under each matching model")
    ap.add_argument("--reference", action="store_true",
                    help="also print the reference's shipped table")
    args = ap.parse_args(argv)
    if args.paths:
        refs = reference_rows() if args.compare_reference else None
        print(render(load_rows(args.paths), reference_rows=refs))
    if args.reference or not args.paths:
        rows = reference_rows()
        if rows:
            print("\nReference (shipped metrics/):")
            print(render(rows))
    return 0


if __name__ == "__main__":
    main()
