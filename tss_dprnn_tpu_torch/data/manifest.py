"""Frozen dataset manifests (counterpart of ``tss_dprnn_tpu/data/manifest.py``):
a LibriMix metadata CSV -> a JSON manifest that freezes the crops and the
same-speaker reference picks.

    {"kind": "librimix"|"librimix_spe", "sample_rate": 8000, "n_src": 2,
     "segment": 3 | null,
     "entries": [{"mixture_path", "source_paths": [...], "length",
                  "start", "stop",                        # frozen crop
                  "speaker_id", "speaker_idx",            # TSS only
                  "reference_path", "start_ref", "stop_ref"}, ...],
     "speakers": {"1234": 0, ...}}

The CSV is read with the ``csv`` module: the card's machine has no pandas.
The manifest equals the JAX package's for the same CSV, ``nrows``,
``segment`` and ``seed``: rows in file order, the first ``nrows`` of them,
the ``length >= seg_len`` filter, the speaker map in row order and the
seeded ``random.Random`` draws in the same order.
"""

from __future__ import annotations

import csv
import json
import os
import random
from typing import Dict, List, Optional


def _stem(path: str) -> str:
    return os.path.basename(path).rsplit(".", 1)[0]


def _mixture_utt_ids(mixture_path: str) -> List[str]:
    # '5400-34479-0005_4973-24515-0007.wav' -> ['5400-34479-0005', ...]
    return _stem(mixture_path).split("_")


def _speaker_of(utt_id: str) -> str:
    return utt_id.split("-")[0]


def _number(text: str):
    """A numeric CSV cell: int, else float. pandas types the whole column
    float when one cell is; the filter and ``int()`` give the same either way."""
    try:
        return int(text)
    except ValueError:
        return float(text)


def load_csv(csv_path: str, nrows: Optional[int] = None) -> List[Dict]:
    """The CSV's first ``nrows`` data rows (all when None), each a dict by
    column name with ``length`` as a number."""
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        rows = []
        for row in reader:
            if nrows is not None and len(rows) >= nrows:
                break
            row["length"] = _number(row["length"])
            rows.append(row)
    return rows


def build_manifest(
    csv_path: str,
    sample_rate: int = 8000,
    n_src: int = 2,
    segment: Optional[float] = 3,
    nrows: Optional[int] = None,
    spe: bool = False,
    seed: int = 0,
) -> dict:
    """CSV -> manifest dict. ``spe=True`` adds speaker map + reference picks
    (LibrimixSpe); ``segment=None`` keeps full lengths (test mode)."""
    rng = random.Random(seed)
    rows = load_csv(csv_path, nrows)
    seg_len = int(segment * sample_rate) if segment is not None else None
    n_total = len(rows)
    if seg_len is not None:
        rows = [row for row in rows if row["length"] >= seg_len]
    src_cols = [f"source_{i + 1}_path" for i in range(n_src)]

    entries = []
    speakers: Dict[str, int] = {}
    if spe:
        # speaker map in row order
        for row in rows:
            spk = _speaker_of(_mixture_utt_ids(row["mixture_path"])[0])
            if spk not in speakers:
                speakers[spk] = len(speakers)
        # candidate pool: speaker -> list of (utt_id, path, length)
        pool: Dict[str, List] = {}
        for row in rows:
            utt_ids = _mixture_utt_ids(row["mixture_path"])
            for col, utt in zip(src_cols, utt_ids):
                pool.setdefault(_speaker_of(utt), []).append(
                    (utt, row[col], int(row["length"])))

    for row in rows:
        length = int(row["length"])
        if seg_len is not None:
            start = rng.randint(0, length - seg_len)
            stop = start + seg_len
        else:
            start, stop = 0, None
        e = dict(
            mixture_path=row["mixture_path"],
            source_paths=[row[c] for c in src_cols],
            length=length,
            start=start,
            stop=stop,
        )
        if spe:
            target_utt = _mixture_utt_ids(row["mixture_path"])[0]
            spk = _speaker_of(target_utt)
            candidates = [c for c in pool.get(spk, []) if c[0] != target_utt]
            if not candidates:  # degenerate tiny sets: allow same utterance
                candidates = pool.get(spk, [])
            _, ref_path, ref_len = rng.choice(candidates)
            if seg_len is not None:
                start_ref = rng.randint(0, max(ref_len - seg_len, 0))
                stop_ref = start_ref + seg_len
            else:
                start_ref, stop_ref = 0, None
            e.update(
                speaker_id=spk,
                speaker_idx=speakers[spk],
                reference_path=ref_path,
                start_ref=start_ref,
                stop_ref=stop_ref,
            )
        entries.append(e)

    manifest = dict(
        kind="librimix_spe" if spe else "librimix",
        csv_path=os.path.abspath(csv_path),
        sample_rate=sample_rate,
        n_src=n_src,
        segment=segment,
        dropped_short=n_total - len(rows),
        seed=seed,
        entries=entries,
    )
    if spe:
        manifest["speakers"] = speakers
    return manifest


def save_manifest(manifest: dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(manifest, f)


def load_manifest(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
