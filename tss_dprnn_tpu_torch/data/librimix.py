"""Librimix / LibrimixSpe datasets over frozen manifests or CSVs (counterpart
of ``tss_dprnn_tpu/data/librimix.py``). Items are numpy float32 arrays.

As in the JAX package: randomness is frozen in the JSON manifest; crops can
be re-drawn per epoch (``crop_mode='per_epoch'``); ``cache_wav=True``
memoizes decoded files in RAM. Deliberate differences: a WAV read that
yields fewer frames than the manifest asks for raises and names the file
(``data/wav.py``), on the per-item and the batched path, where the JAX
package zero-pads a batched read silently; and the MiniLibriMix download
helpers are not ported (the port fetches nothing over the network).
"""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np

from tss_dprnn_tpu_torch.data import manifest as manifest_mod
from tss_dprnn_tpu_torch.data import native, wav


class Librimix:
    """BSS dataset: (mixture [T], sources [n_src, T]) (+ ids)."""

    _spe = False

    def __init__(
        self,
        csv_path: Optional[str] = None,
        sample_rate: int = 8000,
        n_src: int = 2,
        nrows: Optional[int] = None,
        segment: Optional[float] = 3,
        return_id: bool = False,
        manifest: Optional[dict] = None,
        manifest_path: Optional[str] = None,
        crop_mode: str = "frozen",  # 'frozen' | 'per_epoch'
        seed: int = 0,
        cache_wav: bool = False,
    ):
        if manifest is None and manifest_path is not None:
            manifest = manifest_mod.load_manifest(manifest_path)
        if manifest is None:
            if csv_path is None:
                raise ValueError("need csv_path or manifest/manifest_path")
            manifest = manifest_mod.build_manifest(
                csv_path, sample_rate, n_src, segment, nrows,
                spe=self._spe, seed=seed,
            )
        self.manifest = manifest
        self.entries = manifest["entries"]
        self.sample_rate = manifest["sample_rate"]
        self.n_src = manifest["n_src"]
        self.segment = manifest["segment"]
        self.seg_len = int(self.segment * self.sample_rate) if self.segment else None
        self.return_id = return_id
        self.crop_mode = crop_mode
        self._rng = random.Random(seed ^ 0x5EED)
        self.cache_wav = cache_wav
        self._wav_cache: dict = {}

    def __len__(self):
        return len(self.entries)

    def _crop(self, entry):
        if self.seg_len is None or self.crop_mode == "frozen":
            return entry["start"], entry["stop"]
        start = self._rng.randint(0, max(entry["length"] - self.seg_len, 0))
        return start, start + self.seg_len

    def _read(self, path, start=0, stop=None):
        """wav.read with optional whole-file memoization (``cache_wav``)."""
        if not self.cache_wav:
            return wav.read(path, start, stop)[0]
        full = self._wav_cache.get(path)
        if full is None:
            full = self._wav_cache[path] = wav.read(path)[0]
        stop = len(full) if stop is None else stop
        if stop > len(full):
            raise wav.short_read(path, start, stop - start, max(len(full) - start, 0))
        return full[start:stop]

    def __getitem__(self, idx):
        e = self.entries[idx]
        start, stop = self._crop(e)
        sources = [self._read(p, start, stop) for p in e["source_paths"]]
        mixture = self._read(e["mixture_path"], start, stop)
        sources = np.stack(sources, axis=0)
        if not self.return_id:
            return mixture, sources
        ids = manifest_mod._mixture_utt_ids(e["mixture_path"])
        return mixture, sources, ids

    def lengths(self):
        if self.seg_len is not None:
            return [self.seg_len] * len(self)
        return [e["length"] for e in self.entries]

    # ------------------------------------------------- batched native decode

    def _batch_specs(self, idx):
        """(paths, starts, counts) of every WAV read item ``idx`` needs:
        mixture first, then sources."""
        e = self.entries[idx]
        start, stop = self._crop(e)
        count = (stop - start) if stop is not None else (e["length"] - start)
        paths = [e["mixture_path"]] + list(e["source_paths"])
        return paths, [start] * len(paths), [count] * len(paths)

    def _assemble(self, idx, rows, counts):
        mixture = rows[0][: counts[0]]
        sources = np.stack([rows[1 + j][: counts[1 + j]]
                            for j in range(len(rows) - 1)], axis=0)
        return mixture, sources

    def items_batch(self, indices):
        """Decode a whole batch of items with one call into the native
        threaded decoder (``native.read_batch``), every crop checked against
        its frame count. Falls back to per-item ``__getitem__`` where the
        library is not built or a mode needs the Python path (return_id,
        cache_wav). The items equal ``__getitem__``'s bit for bit."""
        if self.return_id or self.cache_wav or not native.available():
            return [self[int(i)] for i in indices]
        specs = [self._batch_specs(int(i)) for i in indices]
        paths = [p for s in specs for p in s[0]]
        starts = [st for s in specs for st in s[1]]
        counts = [c for s in specs for c in s[2]]
        seg_len = max(counts) if counts else 0
        flat = native.read_batch(paths, starts, counts, seg_len,
                                 n_threads=min(4, os.cpu_count() or 1))
        items, off = [], 0
        for i, (p, _s, c) in zip(indices, specs):
            items.append(self._assemble(int(i), flat[off : off + len(p)], c))
            off += len(p)
        return items


class LibrimixSpe(Librimix):
    """TSS dataset: (mixture [T], target [T], reference [Tr], speaker_idx)
    (+ first-speaker utterance id). Reference selection frozen in the
    manifest (same speaker, different utterance)."""

    _spe = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.speakers_mapping = self.manifest.get("speakers", {})

    @property
    def num_speakers(self):
        return len(self.speakers_mapping)

    def __getitem__(self, idx):
        e = self.entries[idx]
        start, stop = self._crop(e)
        mixture = self._read(e["mixture_path"], start, stop)
        target = self._read(e["source_paths"][0], start, stop)
        reference = self._read(e["reference_path"], e["start_ref"], e["stop_ref"])
        spk_idx = int(e["speaker_idx"])
        if not self.return_id:
            return mixture, target, reference, spk_idx
        utt_id = manifest_mod._mixture_utt_ids(e["mixture_path"])[0]
        return mixture, target, reference, spk_idx, utt_id

    def ref_lengths(self):
        if self.seg_len is not None:
            return [self.seg_len] * len(self)
        return [wav.info(e["reference_path"])["frames"] for e in self.entries]

    def _batch_specs(self, idx):
        e = self.entries[idx]
        start, stop = self._crop(e)
        count = (stop - start) if stop is not None else (e["length"] - start)
        ref_stop = e["stop_ref"]
        if ref_stop is None:  # full-length reference (segment=null manifests)
            ref_stop = wav.info(e["reference_path"])["frames"]
        paths = [e["mixture_path"], e["source_paths"][0], e["reference_path"]]
        return paths, [start, start, e["start_ref"]], [count, count, ref_stop - e["start_ref"]]

    def _assemble(self, idx, rows, counts):
        e = self.entries[idx]
        return (rows[0][: counts[0]], rows[1][: counts[1]], rows[2][: counts[2]],
                int(e["speaker_idx"]))
