"""Training and evaluation batches
(counterpart of ``tss_dprnn_tpu/data/loader.py:24-205, 315-437``; the BSS
collates are :97 and :327).

Training: :class:`TrainLoader` yields fixed-shape shuffled batches (shuffle
keyed on (seed, epoch), ``drop_last``), optionally built ahead by one
prefetch thread whose exceptions reach the consumer;
:class:`VarLenTrainLoader` (JAX ``data/loader.py:208-312``) yields whole
utterances in length buckets with their true ``lengths``. Evaluation:
utterances are grouped into a few length buckets; each batch is zero-padded
to its bucket size and carries the true ``lengths``, and the masked model
forward then equals per-utterance exact evaluation on the valid region.
Batches are dicts of numpy arrays.

Data parallelism (``parallel``): ``process_index`` / ``process_count``
default to this process's place in the process group, (0, 1) without one,
as the JAX loaders default to ``jax.process_index()`` /
``jax.process_count()`` (``data/loader.py:120-131``). Every process walks
the same ``(seed, epoch)`` plan, so ``len()`` is the same on each; the
training loaders give each process its share of every global batch
(:func:`process_rows`), the bucketed eval loader whole batches,
``plan[i::n]``.

Dataset protocol: ``ds[i] -> (mix, target, reference, spk_idx)`` for target
speech separation and ``ds[i] -> (mix, sources [n_src, T])`` for blind source
separation; for the bucketed loader also ``ds.lengths()`` (mixture sample
counts). A dataset with ``items_batch(indices)`` (``data/librimix.py``)
decodes a whole batch in one call, as in the JAX loader.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tss_dprnn_tpu_torch import parallel
from tss_dprnn_tpu_torch.data.resample import resample

Batch = Dict[str, np.ndarray]


def _get_items(dataset, indices) -> List:
    """A batch's items: one batched decode when the dataset has
    ``items_batch`` (the LibriMix datasets, through the native decoder), else
    ``dataset[i]`` item by item."""
    get_batch = getattr(dataset, "items_batch", None)
    if get_batch is not None:
        return get_batch([int(i) for i in indices])
    return [dataset[int(i)] for i in indices]


def _pad_to(x: np.ndarray, T: int) -> np.ndarray:
    if x.shape[0] >= T:
        return x[:T]
    return np.pad(x, [(0, T - x.shape[0])] + [(0, 0)] * (x.ndim - 1))


def collate_bss(items) -> Batch:
    """Training batch for blind source separation: fixed-length mixtures
    [B, T] and their sources [B, n_src, T] stacked."""
    mix = np.stack([it[0] for it in items]).astype(np.float32)
    src = np.stack([it[1] for it in items]).astype(np.float32)
    return {"mix": mix, "sources": src}


def _references(items, resample_ref_to: Optional[int], sample_rate: int) -> List[np.ndarray]:
    """The items' references, resampled on the host to ``resample_ref_to``
    when it is given (the RawNet family's 16 kHz references)."""
    refs = [np.asarray(it[2], np.float32) for it in items]
    if resample_ref_to is not None:
        refs = [resample(r, sample_rate, resample_ref_to) for r in refs]
    return refs


def collate_spe(items, resample_ref_to: Optional[int] = None, sample_rate: int = 8000) -> Batch:
    """Training batch for target speech separation: fixed-length mixtures
    and targets stacked, references zero-padded to the longest with their
    true ``ref_len``; with ``resample_ref_to`` the references are first
    resampled from ``sample_rate`` (the reference trainer's
    ``trainer_rawnet.py:14-16,31``)."""
    mix = np.stack([it[0] for it in items]).astype(np.float32)
    target = np.stack([it[1] for it in items]).astype(np.float32)
    refs = _references(items, resample_ref_to, sample_rate)
    ref_len = np.array([r.shape[0] for r in refs], np.float32)
    T = max(r.shape[0] for r in refs)
    ref = np.stack([_pad_to(r, T) for r in refs]).astype(np.float32)
    spk = np.array([it[3] for it in items], np.int32)
    return {"mix": mix, "target": target, "reference": ref, "ref_len": ref_len, "spk_idx": spk}


class _WorkerError:
    """Carries a prefetch thread's exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _prefetch_iter(make_items: Callable[[], Iterator[Batch]], prefetch: int) -> Iterator[Batch]:
    """Yield ``make_items()``'s batches, built ahead by one thread. An
    exception in the thread is raised here, never a silent early end; a
    consumer that stops early releases the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    stop = object()
    cancel = threading.Event()

    def put(item) -> bool:
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in make_items():
                if not put(batch):
                    return
        except BaseException as exc:  # raised on the consumer's side
            put(_WorkerError(exc))
            return
        put(stop)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, _WorkerError):
                raise item.exc
            yield item
    finally:
        cancel.set()


def _resolve_process(process_index: Optional[int],
                     process_count: Optional[int]) -> Tuple[int, int]:
    """This process's place in the data axis: the given one, else the
    process group's (JAX ``data/loader.py:120-131``)."""
    if process_count is None:
        process_index, process_count = parallel.process_index(), parallel.process_count()
    return int(process_index or 0), int(process_count)


def _process_share(batch_size: int, process_index: Optional[int],
                   process_count: Optional[int], accum_steps: int):
    """(process_index, process_count, this process's rows of a global batch)
    for a training loader; raises when the shares would be unequal."""
    index, count = _resolve_process(process_index, process_count)
    if batch_size % count:
        raise ValueError(
            f"global batch_size {batch_size} must divide by process_count "
            f"{count} (per-host rows must be equal)")
    if count > 1 and accum_steps > 1 and batch_size % (accum_steps * count):
        raise ValueError(
            f"global batch_size {batch_size} must divide by accum_steps {accum_steps} x "
            f"process_count {count} (each process's share of every micro-batch "
            "must be equal)")
    return index, count, process_rows(batch_size, index, count, accum_steps)


def process_rows(batch_size: int, process_index: int, process_count: int,
                 accum_steps: int = 1) -> np.ndarray:
    """The positions in a global batch of ``batch_size`` rows that process
    ``process_index`` of ``process_count`` holds.

    With ``accum_steps`` 1 the JAX loaders' contiguous slice
    ``[i B/n, (i+1) B/n)``. Under gradient accumulation the JAX trainer's
    micro-batch k is the global rows ``[k m, (k+1) m)``, m = B / accum_steps
    (``training/trainer.py:285-287``), and its BatchNorm takes each
    micro-batch's statistics; so process i holds ``[k m + i m/n,
    k m + (i+1) m/n)`` of every k, in k order. Its k-th local micro-batch
    (the trainer splits the local rows into ``accum_steps`` equal slices) is
    then its share of global micro-batch k, and each global micro-batch
    holds the rows it holds in JAX. Needs B % (accum_steps n) == 0."""
    if process_count == 1:
        return np.arange(batch_size)
    m = batch_size // accum_steps
    share = m // process_count
    return np.concatenate([np.arange(k * m + process_index * share,
                                     k * m + (process_index + 1) * share)
                           for k in range(accum_steps)])


class TrainLoader:
    """Shuffled fixed-shape batches, with an optional prefetch thread.

    The shuffle is keyed on ``(seed, epoch)``, so a resumed run replays the
    batch order of the uninterrupted one; the trainer calls ``set_epoch``,
    and plain iteration without it advances an internal epoch counter.
    ``collate_fn(items) -> batch``. ``batch_size`` is the global batch: each
    process gets its rows of it (:func:`process_rows`, with the trainer's
    ``accum_steps``)."""

    def __init__(self, dataset, batch_size: int, collate_fn: Callable[[list], Batch],
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                 prefetch: int = 2, process_index: Optional[int] = None,
                 process_count: Optional[int] = None, accum_steps: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.process_index, self.process_count, self._rows = _process_share(
            batch_size, process_index, process_count, accum_steps)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self) -> List[np.ndarray]:
        """This epoch's dataset indices, batch by batch: this process's rows
        of each global batch."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(idx)
        batches = [idx[i * self.batch_size : (i + 1) * self.batch_size] for i in range(len(self))]
        if self.process_count == 1:
            return batches
        return [b[self._rows[self._rows < len(b)]] for b in batches]

    def peek(self) -> Batch:
        """This epoch's first batch, without advancing the epoch or starting
        the prefetch thread."""
        return self.collate_fn(_get_items(self.dataset, self._index_batches()[0]))

    def __iter__(self) -> Iterator[Batch]:
        batches = self._index_batches()
        self._epoch += 1

        def make_items():
            for b in batches:
                yield self.collate_fn(_get_items(self.dataset, b))

        if self.prefetch <= 0:
            yield from make_items()
        else:
            yield from _prefetch_iter(make_items, self.prefetch)


class VarLenTrainLoader:
    """Variable-length training batches: whole utterances, shuffled, grouped
    in length buckets and zero-padded to their bucket, each batch with the
    true per-row ``lengths`` (capped at ``max_len`` and at the bucket) that
    the masked scans and the masked PIT loss read.

    Every batch is ``[batch_size, bucket_T]`` for one of the ``n_buckets``
    sizes of :func:`bucket_boundaries`. Batches are formed within buckets
    from the ``(seed, epoch)``-keyed shuffle, each bucket's ragged tail is
    dropped, and the batch order is shuffled across buckets.
    ``collate_fn(items, bucket_T) -> batch`` (:func:`collate_bss_eval`,
    :func:`make_collate_spe_eval`); an item longer than its bucket is cut
    to it by the collate. As in :class:`TrainLoader`, every process builds
    the same global plan and materialises its rows of each batch."""

    def __init__(self, dataset, batch_size: int, collate_fn: Callable[[list, int], Batch],
                 lengths: Sequence[int], shuffle: bool = True, seed: int = 0,
                 n_buckets: int = 4, multiple: int = 2000, max_len: Optional[int] = None,
                 prefetch: int = 2, process_index: Optional[int] = None,
                 process_count: Optional[int] = None, accum_steps: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        eff = np.asarray(lengths, np.int64)
        if max_len is not None:
            eff = np.minimum(eff, int(max_len))
        self.lengths = eff
        self.bounds = bucket_boundaries(eff, n_buckets, multiple)
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.process_index, self.process_count, self._rows = _process_share(
            batch_size, process_index, process_count, accum_steps)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def _bucket_of(self, length: int) -> int:
        return next((b for b in self.bounds if length <= b), self.bounds[-1])

    def batch_plan(self) -> List[Tuple[int, np.ndarray]]:
        """This epoch's [(bucket_T, dataset indices)] of the global batches."""
        idx = np.arange(len(self.dataset))
        rng = np.random.default_rng((self.seed, self._epoch))
        if self.shuffle:
            rng.shuffle(idx)
        groups: Dict[int, List[int]] = {}
        for i in idx:
            groups.setdefault(self._bucket_of(int(self.lengths[i])), []).append(int(i))
        plan = [(bucket_T, np.asarray(idxs[i0:i0 + self.batch_size]))
                for bucket_T, idxs in sorted(groups.items())
                for i0 in range(0, len(idxs) - self.batch_size + 1, self.batch_size)]
        if self.shuffle:
            rng.shuffle(plan)
        return plan

    def __len__(self) -> int:
        return len(self.batch_plan())

    def _materialize(self, bucket_T: int, chunk: np.ndarray) -> Batch:
        chunk = chunk[self._rows]
        batch = self.collate_fn(_get_items(self.dataset, chunk), bucket_T)
        batch["lengths"] = np.minimum(self.lengths[chunk], bucket_T).astype(np.int32)
        return batch

    def peek(self) -> Batch:
        """A batch of the largest bucket, without advancing the epoch."""
        return self._materialize(*max(self.batch_plan(), key=lambda p: p[0]))

    def __iter__(self) -> Iterator[Batch]:
        plan = self.batch_plan()
        self._epoch += 1

        def make_items():
            for bucket_T, chunk in plan:
                yield self._materialize(bucket_T, chunk)

        if self.prefetch <= 0:
            yield from make_items()
        else:
            yield from _prefetch_iter(make_items, self.prefetch)


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


def collate_bss_eval(items, bucket_T: int) -> Batch:
    """Eval collate for blind source separation: mixture and every source
    zero-padded to the bucket."""
    mix = np.stack([_pad_to(np.asarray(it[0], np.float32), bucket_T) for it in items])
    src = np.stack([np.stack([_pad_to(np.asarray(s, np.float32), bucket_T) for s in it[1]])
                    for it in items])
    return {"mix": mix, "sources": src}


def make_collate_spe_eval(resample_ref_to: Optional[int] = None, sample_rate: int = 8000,
                          ref_bucket_multiple: int = 2000,
                          ref_pad_to: Optional[int] = None) -> Callable[[list, int], Batch]:
    """Eval collate for target speech separation: mixture and target padded
    to the bucket, references (resampled as :func:`collate_spe` does) to
    their rounded-up common length; the true ``ref_len`` is kept for
    masking. ``ref_pad_to`` pins the reference axis to one length for the
    whole run (variable-length training), cropping longer references and
    capping ``ref_len`` there, as in JAX (``data/loader.py:335-362``)."""

    def collate(items, bucket_T: int) -> Batch:
        mix = np.stack([_pad_to(np.asarray(it[0], np.float32), bucket_T) for it in items])
        target = np.stack([_pad_to(np.asarray(it[1], np.float32), bucket_T) for it in items])
        refs = _references(items, resample_ref_to, sample_rate)
        ref_len = np.array([min(r.shape[0], ref_pad_to) if ref_pad_to else r.shape[0]
                            for r in refs], np.float32)
        if ref_pad_to is not None:
            Tr = ref_pad_to
        else:
            Tr = max(r.shape[0] for r in refs)
            Tr = -(-Tr // ref_bucket_multiple) * ref_bucket_multiple
        ref = np.stack([_pad_to(r, Tr) for r in refs])
        spk = np.array([it[3] for it in items], np.int32)
        return {"mix": mix, "target": target, "reference": ref, "ref_len": ref_len,
                "spk_idx": spk}

    return collate


class BucketedEvalLoader:
    """Iterates bucketed, padded batches with true ``lengths`` and the
    dataset ``indices`` of their rows. ``collate_fn(items, bucket_T)``.

    With more than one process each takes whole batches, ``plan[i::n]``
    (JAX ``data/loader.py:409-410``): processes may run different numbers of
    batches, and no batch is split over them, so the JAX loader's
    ``pad_to_batch`` (padding a tail batch to a multiple of the mesh) has no
    use here and is not ported."""

    def __init__(self, dataset, batch_size: int, collate_fn: Callable[[list, int], Batch],
                 lengths: Sequence[int], n_buckets: int = 8, multiple: int = 2000,
                 process_index: Optional[int] = None, process_count: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.lengths = np.asarray(lengths)
        self.bounds = bucket_boundaries(lengths, n_buckets, multiple)
        self.process_index, self.process_count = _resolve_process(process_index, process_count)

    def _bucket_of(self, length: int) -> int:
        for b in self.bounds:
            if length <= b:
                return b
        return self.bounds[-1]

    def batch_plan(self) -> List[Tuple[int, List[int]]]:
        """This process's [(bucket_T, dataset indices)], in bucket order."""
        groups: Dict[int, List[int]] = {}
        for i, length in enumerate(self.lengths):
            groups.setdefault(self._bucket_of(int(length)), []).append(i)
        plan = [(bucket_T, idxs[i0 : i0 + self.batch_size])
                for bucket_T, idxs in sorted(groups.items())
                for i0 in range(0, len(idxs), self.batch_size)]
        return plan[self.process_index :: self.process_count]

    def __len__(self) -> int:
        return len(self.batch_plan())

    def __iter__(self) -> Iterator[Batch]:
        for bucket_T, chunk in self.batch_plan():
            batch = self.collate_fn(_get_items(self.dataset, chunk), bucket_T)
            batch["lengths"] = self.lengths[chunk].astype(np.int32)
            batch["indices"] = np.asarray(chunk, np.int32)
            yield batch
