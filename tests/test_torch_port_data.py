"""The port's data layer against the JAX package's on the same synthetic
LibriMix corpora: WAV I/O, the native decoder, frozen manifests (built from
the CSV with the csv module), the datasets item by item and batch by batch,
the loaders over them, and the reference-pickle loader. Short WAV reads,
which the JAX package zero-pads, raise in the port."""

import json
import os
import pickle
import sys
import types

import numpy as np
import pandas as pd
import pytest

from tests.fixtures import make_mini_librimix
from tss_dprnn_tpu.data import librimix as jlibrimix
from tss_dprnn_tpu.data import loader as jloader
from tss_dprnn_tpu.data import manifest as jmanifest
from tss_dprnn_tpu.data import reference_compat as jref
from tss_dprnn_tpu.data import wav as jwav
from tss_dprnn_tpu_torch.data import librimix, loader, manifest, native, reference_compat, wav


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 two-speaker mixtures of 2-4.5 s: some fall under a 3 s segment."""
    return make_mini_librimix(str(tmp_path_factory.mktemp("c2")), n_mix=12, n_speakers=4,
                              min_sec=2.0, max_sec=4.5, seed=3)


@pytest.fixture(scope="module")
def corpus3(tmp_path_factory):
    """A three-speaker (Libri3Mix-style) corpus with a noise floor."""
    return make_mini_librimix(str(tmp_path_factory.mktemp("c3")), n_mix=8, n_speakers=5,
                              min_sec=2.0, max_sec=4.0, seed=5, n_src=3, noisy=True)


def _items_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
        else:
            assert x == y and type(x) is type(y)


# ------------------------------------------------------------------ manifest

@pytest.mark.parametrize("spe", [False, True], ids=["bss", "spe"])
@pytest.mark.parametrize("segment", [3, None], ids=["seg3", "full"])
@pytest.mark.parametrize("nrows,seed", [(None, 0), (7, 1), (10, 11)])
def test_build_manifest_equals_jax(corpus, spe, segment, nrows, seed):
    want = jmanifest.build_manifest(corpus, 8000, 2, segment, nrows, spe=spe, seed=seed)
    got = manifest.build_manifest(corpus, 8000, 2, segment, nrows, spe=spe, seed=seed)
    assert got == want
    assert json.dumps(got) == json.dumps(want)  # key order and types too
    if segment is not None and nrows is None:
        assert got["dropped_short"] > 0  # the filter ran and dropped rows


@pytest.mark.parametrize("spe", [False, True], ids=["bss", "spe"])
def test_build_manifest_three_sources_equals_jax(corpus3, spe):
    want = jmanifest.build_manifest(corpus3, 8000, 3, 3, None, spe=spe, seed=2)
    assert manifest.build_manifest(corpus3, 8000, 3, 3, None, spe=spe, seed=2) == want


def test_manifest_json_crosses_both_ways(corpus, tmp_path):
    """A manifest the JAX package wrote loads in the port and the reverse,
    and the datasets over them give the same items."""
    jpath, ppath = str(tmp_path / "j" / "m.json"), str(tmp_path / "p" / "m.json")
    jmanifest.save_manifest(jmanifest.build_manifest(corpus, spe=True, seed=4), jpath)
    manifest.save_manifest(manifest.build_manifest(corpus, spe=True, seed=4), ppath)
    assert manifest.load_manifest(jpath) == jmanifest.load_manifest(ppath)
    a = librimix.LibrimixSpe(manifest_path=jpath)
    b = jlibrimix.LibrimixSpe(manifest_path=ppath)
    for i in range(len(a)):
        _items_equal(a[i], b[i])


def test_load_csv_reads_the_length_column_as_pandas(tmp_path):
    """Integer lengths read as ints, a column with a decimal as floats; nrows
    takes the first rows, as pandas.read_csv."""
    path = tmp_path / "m.csv"
    path.write_text("mixture_ID,mixture_path,length\na,/x/1-2-3_4-5-6.wav,24000\n"
                    "b,/x/1-2-4_4-5-7.wav,24001.0\nc,/x/1-2-5_4-5-8.wav,30000\n")
    rows = manifest.load_csv(str(path), nrows=2)
    df = pd.read_csv(path, nrows=2)
    assert [r["length"] for r in rows] == df["length"].tolist()
    assert [int(r["length"]) for r in rows] == [24000, 24001]
    assert [r["mixture_path"] for r in manifest.load_csv(str(path))] == \
        pd.read_csv(path)["mixture_path"].tolist()


# -------------------------------------------------------------------- items

@pytest.mark.parametrize("cls_name", ["Librimix", "LibrimixSpe"])
@pytest.mark.parametrize("segment", [3, None], ids=["seg3", "full"])
def test_items_equal_jax_bit_for_bit(corpus, cls_name, segment):
    j = getattr(jlibrimix, cls_name)(csv_path=corpus, segment=segment, seed=6)
    p = getattr(librimix, cls_name)(csv_path=corpus, segment=segment, seed=6)
    assert len(p) == len(j) and p.lengths() == j.lengths()
    if cls_name == "LibrimixSpe":
        assert p.ref_lengths() == j.ref_lengths() and p.num_speakers == j.num_speakers
    idx = list(range(len(j)))
    for a, b in zip(p.items_batch(idx), j.items_batch(idx)):
        _items_equal(a, b)
    for i in idx:
        _items_equal(p[i], j[i])
        _items_equal(p.items_batch([i])[0], j[i])


@pytest.mark.parametrize("kw", [dict(crop_mode="per_epoch"), dict(cache_wav=True),
                                dict(return_id=True)], ids=["per_epoch", "cache_wav", "ids"])
def test_dataset_modes_equal_jax(corpus3, kw):
    j = jlibrimix.LibrimixSpe(csv_path=corpus3, n_src=3, seed=9, **kw)
    p = librimix.LibrimixSpe(csv_path=corpus3, n_src=3, seed=9, **kw)
    for _ in range(2):  # per_epoch draws a new crop on every access
        for i in range(len(j)):
            _items_equal(p[i], j[i])
    _items_equal(p.items_batch([1])[0], j.items_batch([1])[0])


def test_bss_three_sources_equal_jax(corpus3):
    j = jlibrimix.Librimix(csv_path=corpus3, n_src=3, segment=None)
    p = librimix.Librimix(csv_path=corpus3, n_src=3, segment=None)
    for a, b in zip(p.items_batch(range(len(j))), j.items_batch(range(len(j)))):
        _items_equal(a, b)


def test_loaders_over_the_dataset_equal_jax(corpus):
    """The port's loaders take the datasets unchanged: the same batches as
    the JAX loaders, fixed crops and bucketed full length."""
    pt = librimix.LibrimixSpe(csv_path=corpus, segment=2, seed=1)
    jt = jlibrimix.LibrimixSpe(csv_path=corpus, segment=2, seed=1)
    pl = loader.TrainLoader(pt, 3, loader.collate_spe, seed=4, prefetch=1)
    jl = jloader.TrainLoader(jt, 3, jloader.collate_spe, seed=4, prefetch=0)
    assert len(pl) == len(jl) >= 2
    for a, b in zip(pl, jl):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    pe = librimix.LibrimixSpe(csv_path=corpus, segment=None)
    je = jlibrimix.LibrimixSpe(csv_path=corpus, segment=None)
    pb = loader.BucketedEvalLoader(pe, 4, loader.make_collate_spe_eval(), pe.lengths(), 2)
    jb = jloader.BucketedEvalLoader(je, 4, jloader.make_collate_spe_eval(), je.lengths(), 2,
                                    prefetch=0)
    n = 0
    for a, b in zip(pb, jb):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        n += 1
    assert n == len(pb) >= 2


# ------------------------------------------------------------------ WAV I/O

@pytest.mark.parametrize("bits,channels", [(16, 1), (32, 1), (16, 2)])
def test_wav_round_trip_equals_jax(tmp_path, bits, channels):
    data = np.random.default_rng(0).uniform(-0.9, 0.9, (1234, channels)).astype(np.float32)
    data = data[:, 0] if channels == 1 else data
    wav.write(str(tmp_path / "p.wav"), data, 16000, bits=bits)
    jwav.write(str(tmp_path / "j.wav"), data, 16000, bits=bits)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    assert wav.info(str(tmp_path / "p.wav")) == jwav.info(str(tmp_path / "j.wav"))
    for start, stop in ((0, None), (100, 900)):
        a, ra = wav.read(str(tmp_path / "p.wav"), start, stop)
        b, rb = jwav.read(str(tmp_path / "j.wav"), start, stop)
        assert ra == rb and a.dtype == b.dtype and np.array_equal(a, b)


def test_native_read_equals_numpy_read(corpus):
    assert native.available()
    ds = librimix.LibrimixSpe(csv_path=corpus, segment=None)
    e = ds.entries[0]
    paths = [e["mixture_path"], e["source_paths"][1], e["reference_path"]]
    for p in paths:
        for start, stop in ((0, None), (37, 4000)):
            a, _ = wav.read(p, start, stop, prefer_native=True)
            b, _ = wav.read(p, start, stop, prefer_native=False)
            assert np.array_equal(a, b)
    counts = [3000, 2500, 10]
    batch = native.read_batch(paths, [5, 0, 17], counts, 3000, n_threads=2)
    for row, p, s, c in zip(batch, paths, [5, 0, 17], counts):
        assert np.array_equal(row[:c], wav.read(p, s, s + c, prefer_native=False)[0])
        assert not row[c:].any()


@pytest.fixture()
def truncated(tmp_path):
    """A mono PCM16 WAV whose header promises 8000 frames and whose data ends
    after 6000, in a one-row LibriMix corpus (mixture and sources cut alike)."""
    rows = []
    for d in ("mix_clean", "s1", "s2"):
        os.makedirs(tmp_path / d)
    x = np.random.default_rng(1).uniform(-0.5, 0.5, 8000).astype(np.float32)
    stem = "1-2-3_4-5-6"
    paths = {d: str(tmp_path / d / f"{stem}.wav") for d in ("mix_clean", "s1", "s2")}
    for p in paths.values():
        wav.write(p, x, 8000)
        with open(p, "r+b") as f:
            f.truncate(44 + 2 * 6000)
    rows.append(dict(mixture_ID=stem, mixture_path=paths["mix_clean"],
                     source_1_path=paths["s1"], source_2_path=paths["s2"], length=8000))
    csv_path = tmp_path / "m.csv"
    pd.DataFrame(rows).to_csv(csv_path, index=False)
    return str(csv_path), paths["mix_clean"]


@pytest.mark.parametrize("prefer_native", [True, False], ids=["native", "numpy"])
def test_short_read_raises_and_names_the_file(truncated, prefer_native, monkeypatch):
    csv_path, path = truncated
    with pytest.raises(wav.ShortReadError, match=path):
        wav.read(path, prefer_native=prefer_native)
    with pytest.raises(wav.ShortReadError, match=path):
        wav.read(path, 5000, 7000, prefer_native=prefer_native)
    assert len(wav.read(path, 1000, 6000, prefer_native=prefer_native)[0]) == 5000
    if not prefer_native:
        monkeypatch.setattr(native, "available", lambda: False)
    ds = librimix.Librimix(csv_path=csv_path, segment=None)
    with pytest.raises(wav.ShortReadError, match="1-2-3_4-5-6"):
        ds[0]
    with pytest.raises(wav.ShortReadError, match="1-2-3_4-5-6"):
        ds.items_batch([0])


def test_read_past_the_end_raises(corpus):
    path = librimix.Librimix(csv_path=corpus, segment=None).entries[0]["mixture_path"]
    n = wav.info(path)["frames"]
    for prefer_native in (True, False):
        with pytest.raises(wav.ShortReadError):
            wav.read(path, n - 10, n + 10, prefer_native=prefer_native)
    with pytest.raises(wav.ShortReadError):
        native.read_batch([path], [n - 10], [20], 20)


# -------------------------------------------------------- reference pickles

def _reference_class(monkeypatch, module: str, name: str):
    """A class pickled under the reference's name (``src.datasets.*``)."""
    for parent in ("src", "src.datasets"):
        monkeypatch.setitem(sys.modules, parent, sys.modules.get(parent) or
                            types.ModuleType(parent))
    mod = types.ModuleType(module)
    cls = type(name, (), {"__module__": module})
    setattr(mod, name, cls)
    monkeypatch.setitem(sys.modules, module, mod)
    return cls


def _reference_state(corpus, spe):
    with pd.option_context("future.infer_string", False):  # object columns, as pandas 1.x
        df = pd.read_csv(corpus)
        df = df[df["length"] >= 16000]
        if spe:
            df["reference"] = df["source_2_path"]
    n = len(df)
    state = dict(df=df, n_src=2, sample_rate=8000, segment=2, seg_len=16000,
                 start=list(range(n)), stop=[i + 16000 for i in range(n - 1)] + [None],
                 csv_path=corpus)
    if spe:
        state.update(start_ref=[2 * i for i in range(n)], stop_ref=[None] * n,
                     speakers_mapping={"1000": 0, "1001": 1, "1002": 2, "1003": 3})
    return state


@pytest.mark.parametrize("spe", [False, True], ids=["bss", "spe"])
def test_reference_pickle_gives_the_jax_manifest(corpus, tmp_path, monkeypatch, spe):
    module, name = (("src.datasets.librimix_spe", "LibrimixSpe") if spe
                    else ("src.datasets.librimix", "Librimix"))
    obj = _reference_class(monkeypatch, module, name)()
    obj.__dict__.update(_reference_state(corpus, spe))
    path = str(tmp_path / "set.pkl")
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    want = jref.load_reference_pickle(path, path_prefix="/data")
    got = reference_compat.load_reference_pickle(path, path_prefix="/data")
    assert got == want and len(got["entries"]) == len(obj.df)


def test_reference_pickle_legacy_block_state(corpus, tmp_path, monkeypatch):
    """pandas before 3 keeps a DataFrame's blocks in the BlockManager's
    "0.14.1" state, the form of the reference's pickles: the same manifest."""
    state = _reference_state(corpus, spe=True)
    df = state["df"]
    managers = sys.modules["pandas.core.internals.managers"]

    class LegacyManager:
        def __reduce__(self):
            blocks = [{"values": df[c].to_numpy(object)[None], "mgr_locs": slice(i, i + 1, 1)}
                      for i, c in enumerate(df.columns)]
            axes = [pd.Index(list(df.columns), dtype=object), df.index]
            return LegacyManager, (), (axes, [], [], {"0.14.1": {"axes": axes, "blocks": blocks}})

    class LegacyFrame:
        def __reduce__(self):
            return LegacyFrame, (), {"_mgr": LegacyManager(), "_typ": "dataframe"}

    for cls in (LegacyManager, LegacyFrame):
        cls.__module__, cls.__qualname__ = managers.__name__, cls.__name__
        monkeypatch.setattr(managers, cls.__name__, cls, raising=False)
    cls = _reference_class(monkeypatch, "src.datasets.librimix_spe", "LibrimixSpe")
    paths = {}
    for kind, frame in (("legacy", LegacyFrame()), ("want", df)):
        obj = cls()
        obj.__dict__.update(state, df=frame)
        paths[kind] = str(tmp_path / f"{kind}.pkl")
        with open(paths[kind], "wb") as f:
            pickle.dump(obj, f)
    got = reference_compat.load_reference_pickle(paths["legacy"])
    want = jref.load_reference_pickle(paths["want"])
    assert got.pop("source").endswith("legacy.pkl") and want.pop("source").endswith("want.pkl")
    assert got == want


def test_reference_pickle_refuses_what_it_cannot_read(corpus, tmp_path, monkeypatch):
    obj = _reference_class(monkeypatch, "src.datasets.librimix", "Librimix")()
    obj.__dict__.update(_reference_state(corpus, spe=False))
    with pd.option_context("future.infer_string", True):  # Arrow-backed strings
        obj.df = pd.read_csv(corpus)
    path = str(tmp_path / "arrow.pkl")
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    with pytest.raises(pickle.UnpicklingError):
        reference_compat.load_reference_pickle(path)
    with open(path, "wb") as f:
        pickle.dump({"df": os.system}, f)
    with pytest.raises(pickle.UnpicklingError, match="does not load"):
        reference_compat.load_reference_pickle(path)
