"""Loader for the reference's pickled Dataset artifacts (counterpart of
``tss_dprnn_tpu/data/reference_compat.py``).

The reference freezes its datasets by pickling whole ``Librimix`` /
``LibrimixSpe`` instances (``datasets/{bss,tss}/*.pkl``), each holding its
metadata as a pandas DataFrame (``df``) beside the frozen crop lists, the
reference picks and the speaker map. The card's machine has no pandas, so
this module unpickles with an unpickler of its own:

- the reference's classes (``src.datasets.librimix[_spe]``) become attribute
  bags;
- pandas' classes and reconstructors become records of their arguments and
  state, from which the DataFrame's columns are read back from
  numpy-backed blocks, as pandas stores object and int64 columns (the
  reference's pickles were written by pandas 1.x). A column stored another
  way (an Arrow string array, as pandas 3 writes strings by default) raises;
- numpy's array reconstructors and ``builtins.slice`` load as themselves;
  any other global raises, so a pickle cannot run code through this loader.

The result is the manifest the JAX package's loader gives for the same file.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional

import numpy as np

_NUMPY_GLOBALS = {
    ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
    ("numpy", "ndarray"), ("numpy", "dtype"), ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
}
_BLOCK_FORMAT = "0.14.1"


class _Record:
    """A pickled object of a class this loader does not import: the global's
    name, the arguments it was built or called with, and its state."""

    qualname = ""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args, obj.kwargs, obj.state = args, kwargs, None
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _ShimLibrimix(_Record):
    """Stands in for the reference's ``Librimix``."""


class _ShimLibrimixSpe(_ShimLibrimix):
    """Stands in for the reference's ``LibrimixSpe``."""


class _Unpickler(pickle.Unpickler):
    def __init__(self, f):
        super().__init__(f)
        self._records: Dict[str, type] = {}

    def find_class(self, module: str, name: str):
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        if (module, name) == ("builtins", "slice"):
            return slice
        if module == "src.datasets.librimix" and name == "Librimix":
            return _ShimLibrimix
        if module == "src.datasets.librimix_spe" and name == "LibrimixSpe":
            return _ShimLibrimixSpe
        if module.split(".")[0] == "pandas":
            qual = f"{module}.{name}"
            if qual not in self._records:
                self._records[qual] = type(name, (_Record,), {"qualname": qual})
            return self._records[qual]
        raise pickle.UnpicklingError(f"the reference-pickle loader does not load {module}.{name}")


def _index_values(ax) -> list:
    """A pandas Index record (``_new_Index(cls, d)``, or an Index built
    directly) -> its labels."""
    if isinstance(ax, np.ndarray):
        return ax.tolist()
    if isinstance(ax, _Record):
        if ax.qualname.endswith("_new_Index"):
            cls, d = ax.args
            if cls.qualname.endswith("RangeIndex"):
                return list(range(d.get("start", 0), d["stop"], d.get("step", 1)))
            return _index_values(d["data"])
        if ax.qualname.endswith("RangeIndex") and isinstance(ax.state, dict):
            return list(range(ax.state.get("start", 0), ax.state["stop"],
                              ax.state.get("step", 1)))
    raise pickle.UnpicklingError(f"unsupported DataFrame axis: {getattr(ax, 'qualname', ax)}")


def _block_parts(block):
    """(values [n_cols, n_rows], column positions) of one block, from the
    state's dict form or a ``_unpickle_block(values, placement, ndim)``
    record."""
    if isinstance(block, dict):
        values, locs = block["values"], block["mgr_locs"]
    elif isinstance(block, _Record) and block.qualname.endswith("_unpickle_block"):
        values, locs = block.args[0], block.args[1]
    else:
        raise pickle.UnpicklingError(f"unsupported DataFrame block: {block!r}")
    if not isinstance(values, np.ndarray):
        raise pickle.UnpicklingError(
            f"a DataFrame column is stored as {getattr(values, 'qualname', type(values))}; "
            "the loader reads numpy-backed columns (pandas' object and number dtypes)")
    if isinstance(locs, slice):
        locs = list(range(locs.start or 0, locs.stop, locs.step or 1))
    return np.atleast_2d(values), [int(i) for i in np.asarray(locs).ravel()]


def frame_columns(df: _Record) -> Dict[str, list]:
    """A pickled DataFrame record -> {column: values in row order}. Its
    ``BlockManager`` carries the blocks and axes either in its state (format
    "0.14.1", pandas 0.14 to 2.x) or as its constructor's arguments
    (``(blocks, axes)``, pandas 3)."""
    state = df.state
    mgr = state.get("_mgr", state.get("_data")) if isinstance(state, dict) else state
    mstate = mgr.state
    if isinstance(mstate, tuple) and len(mstate) >= 4 and _BLOCK_FORMAT in mstate[3]:
        blocks, axes = mstate[3][_BLOCK_FORMAT]["blocks"], mstate[3][_BLOCK_FORMAT]["axes"]
    elif mstate is None and len(mgr.args) == 2:
        blocks, axes = mgr.args
    else:
        raise pickle.UnpicklingError("unsupported DataFrame pickle: a BlockManager with "
                                     f"neither the {_BLOCK_FORMAT} state nor (blocks, axes)")
    names = _index_values(axes[0])
    columns: Dict[str, list] = {}
    for block in blocks:
        values, locs = _block_parts(block)
        for row, loc in zip(values, locs):
            columns[names[loc]] = row.tolist()
    return {name: columns[name] for name in names}


def load_reference_pickle(path: str, path_prefix: Optional[str] = None) -> dict:
    """Reference ``*_set.pkl`` -> manifest dict.

    ``path_prefix``: optional replacement for the relative ``../../Libri2Mix``
    roots stored inside the pickles (reference ran from scripts/ dirs).
    """
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    if not isinstance(obj, _ShimLibrimix):
        raise pickle.UnpicklingError(f"{path} does not hold a reference Librimix dataset")
    state: Dict[str, Any] = obj.state or {}
    cols = frame_columns(state["df"])
    spe = isinstance(obj, _ShimLibrimixSpe) or "reference" in cols
    n_src = int(state.get("n_src", 2))
    sample_rate = int(state.get("sample_rate", 8000))
    segment = state.get("segment")
    starts = list(state.get("start", []))
    stops = list(state.get("stop", []))
    starts_ref = list(state.get("start_ref", []))
    stops_ref = list(state.get("stop_ref", []))
    speakers = dict(state.get("speakers_mapping", {}))

    def fix(p):
        if path_prefix is None or not isinstance(p, str):
            return p
        marker = "Libri2Mix/"
        i = p.find(marker)
        return path_prefix.rstrip("/") + "/" + p[i:] if i >= 0 else p

    def at(seq: List, pos: int):
        """``seq[pos]`` as an int; None stays None."""
        return None if seq[pos] is None else int(seq[pos])

    src_cols = [f"source_{i + 1}_path" for i in range(n_src)]
    entries = []
    for pos in range(len(cols["mixture_path"])):
        mixture_path = cols["mixture_path"][pos]
        e = dict(
            mixture_path=fix(mixture_path),
            source_paths=[fix(cols[c][pos]) for c in src_cols],
            length=int(cols["length"][pos]),
            start=int(starts[pos]) if pos < len(starts) else 0,
            stop=at(stops, pos) if pos < len(stops) else None,
        )
        if spe:
            stem = str(mixture_path).split("/")[-1].split(".")[0]
            spk = stem.split("_")[0].split("-")[0]
            e.update(
                speaker_id=spk,
                speaker_idx=int(speakers.get(spk, 0)),
                reference_path=fix(cols["reference"][pos]),
                start_ref=int(starts_ref[pos]) if pos < len(starts_ref) else 0,
                stop_ref=at(stops_ref, pos) if pos < len(stops_ref) else None,
            )
        entries.append(e)

    manifest = dict(
        kind="librimix_spe" if spe else "librimix",
        csv_path=str(state.get("csv_path")),
        sample_rate=sample_rate,
        n_src=n_src,
        segment=segment,
        dropped_short=0,
        seed=None,
        source="reference_pickle:" + path,
        entries=entries,
    )
    if spe:
        manifest["speakers"] = speakers
    return manifest
