"""The port's host metrics against the JAX package's on seeded signals (the
same float64 numpy, so within 1e-9), and the host metric lane of the port's
inferencers: the thread pool gives the serial loop's rows, and each row's
STOI and PESQ are ``get_metrics`` on the estimate the model gave."""

import csv
import logging

import numpy as np
import pytest
import torch

from tss_dprnn_tpu.data import resample as jresample
from tss_dprnn_tpu.ops import metrics as jmetrics
from tss_dprnn_tpu.ops import pesq as jpesq
from tss_dprnn_tpu_torch.data import resample
from tss_dprnn_tpu_torch.inference import Inferencer, InferencerSpe
from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet, DPRNNTasNet
from tss_dprnn_tpu_torch.ops import metrics
from tss_dprnn_tpu_torch.utils.weights import init_weights_

TOL = 1e-9
TINY = dict(input_size=8, feature_size=12, hidden_size=10, chunk_length=40, kernel_size=2,
            hop_length=20, n_repeats=1, norm_type="ln")
TINY_SPE = dict(TINY, O=8, P=12, embeddings_size=8, num_spks=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: in the suite's parallel workers
    torch's idle pool threads spin against each other's and every small op
    waits on the scheduler (test_torch_port_device_metrics.py measures it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def first_party_jax_pesq(monkeypatch):
    """The JAX package prefers the ``pesq`` C extension where it is
    importable; the port never does. Compare the first-party chains."""
    monkeypatch.setattr(jmetrics, "_pesq_fn", None)


def _signals(seed, n, sr):
    """A clean harmonic signal with pauses, a degraded copy, and a mixture."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    clean = (0.3 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 1.3 * t) > -0.3)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
    est = (clean + 0.08 * rng.standard_normal(n)).astype(np.float32)
    mix = (clean + 0.2 * rng.standard_normal(n)).astype(np.float32)
    return mix, clean, est


@pytest.mark.parametrize("sr,secs", [(8000, 2.5), (16000, 1.5)])
def test_si_sdr_and_stoi_equal_jax(sr, secs):
    _, clean, est = _signals(0, int(sr * secs), sr)
    assert metrics.si_sdr(est, clean) == pytest.approx(jmetrics.si_sdr(est, clean), abs=TOL)
    got, want = metrics.stoi(clean, est, sr), jmetrics.stoi(clean, est, sr)
    assert 0.0 < got < 1.0 and got == pytest.approx(want, abs=TOL)


@pytest.mark.parametrize("sr,mode", [(8000, "nb"), (16000, "wb")])
def test_pesq_score_equals_jax(sr, mode):
    _, clean, est = _signals(1, int(sr * 2), sr)
    got, want = metrics.pesq_score(clean, est, sr), jmetrics.pesq_score(clean, est, sr)
    assert 1.0 < got < 4.6 and got == pytest.approx(want, abs=TOL)
    assert got == pytest.approx(jpesq.pesq(sr, clean, est, mode), abs=TOL)


def test_pesq_score_is_none_where_the_chain_fails():
    with pytest.warns(UserWarning, match="pesq failed"):
        got = metrics.pesq_score(np.zeros(0, np.float32), np.zeros(0, np.float32), 8000)
    with pytest.warns(UserWarning, match="pesq failed"):
        want = jmetrics.pesq_score(np.zeros(0, np.float32), np.zeros(0, np.float32), 8000)
    assert got is None and want is None


@pytest.mark.parametrize("n_src", [1, 2])
def test_get_metrics_equals_jax(n_src):
    sr = 8000
    sigs = [_signals(10 + j, sr * 2, sr) for j in range(n_src)]
    mix = np.sum([s[0] for s in sigs], axis=0)
    clean = np.stack([s[1] for s in sigs])
    est = np.stack([s[2] for s in sigs])
    got = metrics.get_metrics(mix, clean, est, sr, ["si_sdr", "stoi", "pesq"])
    want = jmetrics.get_metrics(mix, clean, est, sr, ["si_sdr", "stoi", "pesq"])
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=TOL), k


def test_resample_equals_jax():
    x = np.random.default_rng(2).standard_normal((2, 3001)).astype(np.float32)
    for orig, new in ((8000, 10000), (8000, 16000), (16000, 8000)):
        assert np.array_equal(resample.resample(x, orig, new), jresample.resample(x, orig, new))


def test_stoi_too_short_is_nan_in_both():
    _, clean, est = _signals(3, 2000, 8000)
    with pytest.warns(UserWarning):
        assert np.isnan(metrics.stoi(clean, est, 8000))
    with pytest.warns(UserWarning):
        assert np.isnan(jmetrics.stoi(clean, est, 8000))


# ------------------------------------------------------ the inferencers' lane

class _Requests:
    """TSS requests of 1-2 s: ds[i] -> (mix, target, reference, spk_idx)."""

    def __init__(self, n):
        self.items = []
        for i in range(n):
            mix, clean, _ = _signals(20 + i, 8000 + 1000 * i, 8000)
            self.items.append((mix, clean, clean[: 6000 + 300 * i].copy(), i % 8))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        return [len(it[0]) for it in self.items]


class _Mixtures:
    """BSS mixtures of 1-2 s: ds[i] -> (mix, sources [2, T])."""

    def __init__(self, n):
        self.items = []
        for i in range(n):
            a = _signals(40 + i, 8000 + 1500 * i, 8000)[1]
            b = np.roll(_signals(60 + i, 8000 + 1500 * i, 8000)[2], 400)
            self.items.append((a + b, np.stack([a, b])))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        return [len(it[0]) for it in self.items]


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("family", ["tss", "bss"])
def test_host_lane_pool_equals_serial_and_get_metrics(tmp_path, family):
    """``run(overlap_metrics=True)`` (4 workers) writes the rows of the
    serial loop, and each row's STOI / PESQ are ``get_metrics`` on the
    estimate of the model, cut to the row's length (BSS: reordered)."""
    if family == "tss":
        model_fn, cls, ds = (lambda: DPRNNSpeTasNet(**TINY_SPE)), InferencerSpe, _Requests(6)
    else:
        model_fn, cls, ds = (lambda: DPRNNTasNet(**TINY)), Inferencer, _Mixtures(5)
    path = tmp_path / "model.pt"
    torch.save(init_weights_(model_fn(), torch.Generator().manual_seed(3)).state_dict(), path)
    results = {}
    for overlap in (True, False):
        savedir = tmp_path / str(overlap)
        inf = cls(model_fn(), {"checkpoint_path": str(path), "test_savedir": str(savedir)},
                  device="cpu")
        results[overlap] = inf.run(ds, batch_size=2, n_buckets=2, overlap_metrics=overlap,
                                   metrics_workers=4)
        results[str(overlap)] = _rows(savedir / "all_metrics.csv")
    assert results[True] == results[False] and results["True"] == results["False"]
    rows = results["True"]
    assert list(rows[0]) == ["index", "si_sdr", "input_si_sdr", "stoi", "input_stoi", "pesq",
                             "input_pesq"]
    with torch.inference_mode():
        for r in rows:
            item = ds[int(r["index"])]
            if family == "tss":
                mix, target, ref, _ = item
                est, _ = inf.model(torch.from_numpy(mix)[None], torch.from_numpy(ref)[None],
                                   torch.tensor([float(len(ref))]))
                est, clean = est[0].numpy(), target
            else:
                mix, clean = item
                out = inf.model(torch.from_numpy(mix)[None])[0].numpy()
                est = max((out[list(p)] for p in ([0, 1], [1, 0])),
                          key=lambda e: np.mean([metrics.si_sdr(e[j], clean[j]) for j in range(2)]))
            want = metrics.get_metrics(mix, clean, est, 8000, ["stoi", "pesq"])
            for k in want:  # the bucketed forward vs the request alone
                assert float(r[k]) == pytest.approx(want[k], abs=1e-4 if "stoi" in k else 1e-2), k


def test_final_metrics_skip_unscored_rows_as_jax(tmp_path):
    """A row whose metric is None (PESQ failed) or NaN (STOI on too short a
    signal) is left out of the means, as the JAX package's pandas mean
    skips it; a metric no row could score is None."""
    from tss_dprnn_tpu.inference.inferencer import Inferencer as JaxInferencer

    rows = [{"index": 1, "si_sdr": 3.0, "input_si_sdr": 1.0, "stoi": float("nan"),
             "input_stoi": 0.5, "pesq": None, "input_pesq": 2.0},
            {"index": 0, "si_sdr": 5.0, "input_si_sdr": 2.5, "stoi": 0.75,
             "input_stoi": 0.25, "pesq": None, "input_pesq": None}]
    finals = []
    for cls in (Inferencer, JaxInferencer):
        inf = cls.__new__(cls)
        inf.metrics, inf.test_savedir = ["si_sdr", "stoi", "pesq"], str(tmp_path / cls.__module__)
        inf.logger = logging.getLogger(__name__)
        finals.append(inf._save_result([dict(r) for r in rows]))
    got, want = finals
    assert got == {"si_sdr": 4.0, "si_sdr_imp": 2.25, "stoi": 0.75, "stoi_imp": 0.5,
                   "pesq": None, "pesq_imp": None}
    assert got == {k: (None if v is None else float(v)) for k, v in want.items()}
