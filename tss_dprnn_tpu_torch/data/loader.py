"""Length-bucketed evaluation batches
(counterpart of ``tss_dprnn_tpu/data/loader.py:91-94, 315-437``).

Utterances are grouped into a few length buckets; each batch is zero-padded
to its bucket size and carries the true ``lengths``, and the masked model
forward then equals per-utterance exact evaluation on the valid region.
Batches are dicts of numpy arrays. Single process, no prefetch thread.

Dataset protocol: ``ds[i] -> (mix, target, reference, spk_idx)`` and
``ds.lengths()`` (mixture sample counts).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import numpy as np

Batch = Dict[str, np.ndarray]


def _pad_to(x: np.ndarray, T: int) -> np.ndarray:
    if x.shape[0] >= T:
        return x[:T]
    return np.pad(x, [(0, T - x.shape[0])] + [(0, 0)] * (x.ndim - 1))


def bucket_boundaries(lengths: Sequence[int], n_buckets: int = 8,
                      multiple: int = 2000) -> List[int]:
    """Length quantiles rounded up to ``multiple`` -> static bucket sizes."""
    ls = np.sort(np.asarray(lengths))
    qs = np.linspace(0, 1, n_buckets + 1)[1:]
    bounds = sorted({int(-(-int(ls[min(int(q * (len(ls) - 1)), len(ls) - 1)]) // multiple) * multiple)
                     for q in qs})
    if bounds and bounds[-1] < ls[-1]:
        bounds[-1] = int(-(-int(ls[-1]) // multiple) * multiple)
    return bounds


def make_collate_spe_eval(ref_bucket_multiple: int = 2000) -> Callable[[list, int], Batch]:
    """Eval collate for target speech separation: mixture and target padded
    to the bucket, references to their rounded-up common length; the true
    ``ref_len`` is kept for masking."""

    def collate(items, bucket_T: int) -> Batch:
        mix = np.stack([_pad_to(np.asarray(it[0], np.float32), bucket_T) for it in items])
        target = np.stack([_pad_to(np.asarray(it[1], np.float32), bucket_T) for it in items])
        refs = [np.asarray(it[2], np.float32) for it in items]
        ref_len = np.array([r.shape[0] for r in refs], np.float32)
        Tr = max(r.shape[0] for r in refs)
        Tr = -(-Tr // ref_bucket_multiple) * ref_bucket_multiple
        ref = np.stack([_pad_to(r, Tr) for r in refs])
        spk = np.array([it[3] for it in items], np.int32)
        return {"mix": mix, "target": target, "reference": ref, "ref_len": ref_len,
                "spk_idx": spk}

    return collate


class BucketedEvalLoader:
    """Iterates bucketed, padded batches with true ``lengths`` and the
    dataset ``indices`` of their rows. ``collate_fn(items, bucket_T)``."""

    def __init__(self, dataset, batch_size: int, collate_fn: Callable[[list, int], Batch],
                 lengths: Sequence[int], n_buckets: int = 8, multiple: int = 2000):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.lengths = np.asarray(lengths)
        self.bounds = bucket_boundaries(lengths, n_buckets, multiple)

    def _bucket_of(self, length: int) -> int:
        for b in self.bounds:
            if length <= b:
                return b
        return self.bounds[-1]

    def batch_plan(self) -> List[Tuple[int, List[int]]]:
        """[(bucket_T, dataset indices)] in bucket order."""
        groups: Dict[int, List[int]] = {}
        for i, length in enumerate(self.lengths):
            groups.setdefault(self._bucket_of(int(length)), []).append(i)
        return [(bucket_T, idxs[i0 : i0 + self.batch_size])
                for bucket_T, idxs in sorted(groups.items())
                for i0 in range(0, len(idxs), self.batch_size)]

    def __len__(self) -> int:
        return len(self.batch_plan())

    def __iter__(self) -> Iterator[Batch]:
        for bucket_T, chunk in self.batch_plan():
            batch = self.collate_fn([self.dataset[i] for i in chunk], bucket_T)
            batch["lengths"] = self.lengths[chunk].astype(np.int32)
            batch["indices"] = np.asarray(chunk, np.int32)
            yield batch
