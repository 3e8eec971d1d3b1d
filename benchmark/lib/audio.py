"""The benchmark's inputs, made from the seed.

Lengths are drawn fresh from the seed for every cycle of ``n`` requests (or
items): one length uniform inside each of ``n`` equal strata of a mix's
``[lo, hi]`` seconds, in an order of its own. So lengths are continuous and
no cycle repeats another's, as users' recordings do not, while every seed
and every cycle carries about the same amount of audio. Audio is
noise-like: slices of one seeded Gaussian pool, at offsets drawn per item,
so an item costs a slice and not a draw. The same ``(seed, stream, index)``
always gives the same item, which is how the correctness check finds a
request's inputs again.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

POOL_SAMPLES = 1 << 20  # 131 s at 8 kHz
AMPLITUDE = 0.1


def stratified_lengths(seconds: Sequence[float], n: int, sample_rate: int,
                       rng: np.random.Generator) -> np.ndarray:
    """n lengths in samples, one drawn uniformly inside each of n equal
    strata of [lo, hi] seconds, permuted."""
    lo, hi = seconds
    u = rng.random(n)
    lengths = np.round((lo + (hi - lo) * (np.arange(n) + u) / n) * sample_rate).astype(np.int64)
    return lengths[rng.permutation(n)]


class Source:
    """Seeded audio: ``signal(key, length)`` is a slice of the pool."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self.pool = (AMPLITUDE * np.random.default_rng([self.seed, 0]).standard_normal(
            POOL_SAMPLES)).astype(np.float32)

    def rng(self, *key: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, *key])

    def signal(self, length: int, *key: int) -> np.ndarray:
        start = int(self.rng(1, *key).integers(0, POOL_SAMPLES - length + 1))
        return self.pool[start:start + length]


class Requests:
    """A stream of requests (``stream`` tells streams of one seed apart):
    request i has a mixture of ``mix_len(i)`` and a reference of
    ``ref_len(i)`` samples, each drawn with :func:`stratified_lengths` for
    the cycle of ``cycle`` requests that holds i; ``signal(i, tag, n)`` is
    its audio number ``tag``, ``label(i, k)`` a label in ``[0, k)``."""

    def __init__(self, source: Source, mix_seconds: Sequence[float],
                 ref_seconds: Sequence[float], cycle: int, sample_rate: int, stream: int = 0):
        self.source, self.n, self.stream = source, int(cycle), int(stream)
        self.seconds = (mix_seconds, ref_seconds)
        self.sample_rate = sample_rate
        self._lengths: Dict[Tuple[int, int], np.ndarray] = {}

    def _length(self, i: int, which: int) -> int:
        key = (i // self.n, which)
        if key not in self._lengths:
            self._lengths[key] = stratified_lengths(
                self.seconds[which], self.n, self.sample_rate,
                self.source.rng(3, self.stream, key[0], which))
        return int(self._lengths[key][i % self.n])

    def mix_len(self, i: int) -> int:
        return self._length(i, 0)

    def ref_len(self, i: int) -> int:
        return self._length(i, 1)

    def signal(self, i: int, tag: int, length: int) -> np.ndarray:
        return self.source.signal(length, self.stream, i, tag)

    def label(self, i: int, k: int) -> int:
        return int(self.source.rng(4, self.stream, i).integers(k))


class Items:
    """A dataset in the protocol of the program's loaders: item k is
    request ``ids[k]`` as a family's ``make(requests, i)`` gives it."""

    def __init__(self, requests: Requests, make, ids: Sequence[int]):
        self.requests, self.make, self.ids = requests, make, ids

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, k):
        return self.make(self.requests, int(self.ids[int(k)]))

    def lengths(self) -> np.ndarray:
        """The items' mixture lengths in samples."""
        return np.array([self.requests.mix_len(int(i)) for i in self.ids], np.int64)
