"""STOI and PESQ on the device (``ops/stoi.py``, ``ops/pesq_device.py``) and
the Inferencers' device metric lane, on the CPU against the JAX package's
``ops/stoi_jax.py`` / ``ops/pesq_jax.py`` and its Inferencers, with the same
numpy inputs from a seed (speech-like rows of 2-4 s, B <= 3, ragged lengths
with one row too short to score).

Bars: STOI within 1e-4 and PESQ within 1e-3 MOS of JAX, NaN where JAX gives
NaN (measured on the CPU: 2e-7 and 0 MOS, the same fp32 chain with the
contractions in float64 here); a padded row within 2e-5 (STOI) of the row
cut to its length; and against the host chain in float64 the JAX package's
own bars (STOI 2e-3, PESQ 0.05 MOS). The Inferencers' rows against the JAX
Inferencers with ``device_metrics`` and ``device_pesq``: SI-SDR within 1e-3
dB, STOI within 1e-4, PESQ within 1e-3 MOS; with ``device_pesq`` no estimate
reaches the host (the CLI test of ``--device-pesq`` checks that no metric
pool starts either; here the host metrics run serially, as thread pools of
numpy metrics thrash when the suite runs in parallel). The ``cuda`` cases hold the card
against the port's CPU run at 8 x 10 s (they skip without a card).

JAX is imported inside the tests: the card's machine has none.
"""

import csv
import json

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch.inference import Inferencer, InferencerSpe
from tss_dprnn_tpu_torch.inference import inferencer as inferencer_mod
from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet, DPRNNTasNet
from tss_dprnn_tpu_torch.ops import pesq_device, stoi
from tss_dprnn_tpu_torch.utils.weights import state_dict_from_jax

STOI_TOL, PESQ_TOL = 1e-4, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module's CPU work: the suite runs in
    parallel workers, and torch's idle pool threads then spin against each
    other's (measured: a lane test took 24 s alone and 352 s beside five
    copies of itself with the default threads, 24 s with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _speechish(rng, T, sr):
    """A voiced-speech stand-in: four harmonics under a syllable-rate
    envelope, a little noise."""
    t = np.arange(T) / sr
    f0 = rng.uniform(120, 220)
    x = sum(a * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6))
            for h, a in enumerate([1.0, 0.5, 0.25, 0.12], start=1))
    x = x * np.clip(np.sin(2 * np.pi * rng.uniform(1.5, 3.0) * t), 0, None)
    x = x + 0.01 * rng.standard_normal(T)
    return (0.4 * x / (np.abs(x).max() + 1e-9)).astype(np.float32)


def _rows(sr, seed, lens, T):
    """(clean, degraded, lengths): zero past each length; the degraded rows
    noisy and delayed by 20 ms."""
    rng = np.random.default_rng(seed)
    clean = np.zeros((len(lens), T), np.float32)
    deg = np.zeros_like(clean)
    for b, n in enumerate(lens):
        c = _speechish(rng, n, sr)
        d = np.concatenate([np.zeros(sr // 50, np.float32), c])[:n]
        clean[b, :n] = c
        deg[b, :n] = d + (0.05 * (b + 1)) * rng.standard_normal(n).astype(np.float32)
    return clean, deg, np.asarray(lens, np.int32)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _assert_close_nan(got, want, tol):
    assert np.array_equal(np.isnan(got), np.isnan(want)), (got, want)
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], atol=tol, rtol=0)


# ------------------------------------------------------------ the metrics

@pytest.fixture(scope="module")
def rows8k():
    return _rows(8000, 0, [24000, 17011, 1500], 24000)


def test_resample_batch_equals_jax(rows8k):
    from tss_dprnn_tpu.ops.stoi_jax import resample_batch as jax_resample

    x = rows8k[0]
    want = np.asarray(jax_resample(x, 8000, 10000))
    got = stoi.resample_batch(torch.from_numpy(x), 8000, 10000).numpy()
    assert got.shape == want.shape == (3, 30000)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("sr", [8000, 10000])
def test_stoi_batch_equals_jax(rows8k, sr):
    """At 8 kHz through the resample, and at STOI's own 10 kHz without it."""
    from tss_dprnn_tpu.ops.metrics import stoi as host_stoi
    from tss_dprnn_tpu.ops.stoi_jax import stoi_batch as jax_stoi

    clean, deg, lens = rows8k if sr == 8000 else _rows(sr, 1, [30000, 21000, 2000], 30000)
    want = np.asarray(jax_stoi(clean, deg, lens, sr))
    got = stoi.stoi_batch(*_t(clean, deg, lens), sr).numpy()
    assert got.dtype == np.float32 and np.isnan(got[2])  # too short to score
    _assert_close_nan(got, want, STOI_TOL)
    host = np.array([host_stoi(clean[b, :n], deg[b, :n], sr) for b, n in enumerate(lens[:2])])
    np.testing.assert_allclose(got[:2], host, atol=2e-3)


@pytest.mark.parametrize("fs,mode", [(8000, "nb"), (16000, "wb")])
def test_pesq_batch_equals_jax(fs, mode):
    from tss_dprnn_tpu.ops.pesq import pesq as host_pesq
    from tss_dprnn_tpu.ops.pesq_jax import pesq_batch as jax_pesq

    clean, deg, lens = _rows(fs, 2, [3 * fs, int(2.3 * fs) + 7, fs // 5], 3 * fs)
    want = np.asarray(jax_pesq(clean, deg, lens, fs=fs, mode=mode))
    got = pesq_device.pesq_batch(*_t(clean, deg, lens), fs, mode).numpy()
    assert got.dtype == np.float32 and np.isnan(got[2])  # under 0.25 s
    _assert_close_nan(got, want, PESQ_TOL)
    host = np.array([host_pesq(fs, clean[b, :n], deg[b, :n], mode)
                     for b, n in enumerate(lens[:2])])
    np.testing.assert_allclose(got[:2], host, atol=0.05)


def test_metrics_are_padding_invariant(rows8k):
    """A row zero-padded by a further second scores what it scores alone."""
    clean, deg, lens = rows8k
    pad = lambda a: np.pad(a[:2], ((0, 0), (0, 8000)))  # noqa: E731
    for fn, tol in ((lambda *a: stoi.stoi_batch(*a, 8000), 2e-5),
                    (lambda *a: pesq_device.pesq_batch(*a, 8000, "nb"), 0.05)):
        alone = [float(fn(*_t(clean[b:b + 1, :n], deg[b:b + 1, :n], lens[b:b + 1]))[0])
                 for b, n in enumerate(lens[:2])]
        padded = fn(*_t(pad(clean), pad(deg), lens[:2])).numpy()
        np.testing.assert_allclose(padded, alone, atol=tol)


def test_pesq_gain_smoother_is_the_recurrence(rng):
    """The blocked closed form against the frame-by-frame recurrence in
    float64, over lengths around the 64-frame block."""
    for N in (1, 63, 64, 65, 700):
        r = torch.from_numpy(rng.uniform(0.01, 5.0, (2, N)).astype(np.float32))
        want = torch.empty(2, N, dtype=torch.float64)
        g = r[:, 0].double()
        for t in range(N):
            g = 0.8 * g + 0.2 * r[:, t].double()
            want[:, t] = g
        got = pesq_device._smooth_gain(r)
        torch.testing.assert_close(got.double(), want, atol=0, rtol=2 ** -23)


def test_pesq_batch_rejects_bad_modes():
    x = torch.zeros(1, 4000)
    for fs, mode in ((8000, "xb"), (11025, "nb"), (8000, "wb")):
        with pytest.raises(ValueError):
            pesq_device.pesq_batch(x, x, torch.tensor([4000]), fs, mode)


# ------------------------------------------------------------- the lane

TINY = dict(input_size=8, feature_size=12, hidden_size=10, chunk_length=100, kernel_size=2,
            hop_length=50, n_repeats=1, norm_type="ln")
TINY_SPE = dict(TINY, O=8, P=12, embeddings_size=8, num_spks=5, fusion_type="att")
METRICS = ["si_sdr", "stoi", "pesq"]
ROW_TOL = {"si_sdr": 1e-3, "stoi": STOI_TOL, "pesq": PESQ_TOL}


class _Corpus:
    """ds[i] -> (mix, target, reference, spk) or (mix, sources [2, T])."""

    def __init__(self, spe, seed=3):
        rng = np.random.default_rng(seed)
        self.items = []
        for n in (32000, 23011, 16000):
            s = np.stack([_speechish(rng, n, 8000), _speechish(rng, n, 8000)])
            if spe:
                self.items.append((s.sum(0), s[0], _speechish(rng, 12000, 8000), 0))
            else:
                self.items.append((s.sum(0), s))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        return [len(it[0]) for it in self.items]


def _read_rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("family,flag", [("tss", "device_metrics"), ("tss", "device_pesq"),
                                         ("bss", "device_pesq")])
def test_device_lane_matches_jax_inferencer(tmp_path, family, flag):
    import jax

    from tss_dprnn_tpu.inference import Inferencer as JaxInferencer
    from tss_dprnn_tpu.inference import InferencerSpe as JaxInferencerSpe
    from tss_dprnn_tpu.models import DPRNNSpeTasNet as JaxDPRNNSpeTasNet
    from tss_dprnn_tpu.models import DPRNNTasNet as JaxDPRNNTasNet
    from tss_dprnn_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager

    spe = family == "tss"
    ds = _Corpus(spe)
    cfg = TINY_SPE if spe else TINY
    jmodel = (JaxDPRNNSpeTasNet if spe else JaxDPRNNTasNet)(**cfg)
    args = (np.zeros((1, 400), np.float32),) + (
        (np.zeros((1, 300), np.float32), np.full((1,), 300.0, np.float32)) if spe else ())
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), *args)))
    jpath = JaxCheckpointManager(str(tmp_path / "jax_ckpt")).save(
        1, {"epoch": 1, "params": variables["params"],
            "batch_stats": variables.get("batch_stats", {})}, best=True)
    config = {"metrics": METRICS, flag: True, "data": {"sample_rate": 8000}}
    jinf = (JaxInferencerSpe if spe else JaxInferencer)(
        jmodel, dict(config, checkpoint_path=jpath, test_savedir=str(tmp_path / "jax")))
    # serially, here and below: thread pools of numpy metrics thrash when
    # the suite runs in parallel (the pool has its own tests)
    jinf.run(ds, batch_size=3, n_buckets=1, bucket_multiple=100, overlap_metrics=False)

    path = tmp_path / "model.pt"
    torch.save(state_dict_from_jax(variables, "ln", 2, "att" if spe else None), path)
    inf = (InferencerSpe if spe else Inferencer)(
        (DPRNNSpeTasNet if spe else DPRNNTasNet)(**cfg),
        dict(config, checkpoint_path=str(path), test_savedir=str(tmp_path / "port")), device="cpu")
    assert inf.device_metrics and inf.host_metrics == ([] if flag == "device_pesq" else ["pesq"])
    before = dict(inferencer_mod.host_counts)
    final = inf.run(ds, batch_size=3, n_buckets=1, bucket_multiple=100, overlap_metrics=False)
    moved = {k: inferencer_mod.host_counts[k] - before[k] for k in before}
    assert moved == {"estimates": 0 if flag == "device_pesq" else 1, "pools": 0}
    got, want = _read_rows(tmp_path / "port" / "all_metrics.csv"), _read_rows(
        tmp_path / "jax" / "all_metrics.csv")
    assert [int(r["index"]) for r in got] == list(range(len(ds)))
    for r, jr in zip(got, want):
        for metric, tol in ROW_TOL.items():
            for key in (metric, "input_" + metric):
                assert abs(float(r[key]) - float(jr[key])) <= tol, (key, r[key], jr[key])
    saved = json.loads((tmp_path / "port" / "final_metrics.json").read_text())
    assert saved == pytest.approx(final) and all(np.isfinite(v) for v in final.values())


def test_device_lane_equals_host_lane_within_the_jax_bars(tmp_path):
    """One port model, both lanes: the device rows against the host rows."""
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    ds = _Corpus(True)
    path = tmp_path / "model.pt"
    torch.save(init_weights_(DPRNNSpeTasNet(**TINY_SPE), torch.Generator().manual_seed(1))
               .state_dict(), path)
    rows = {}
    for lane, extra in (("host", {}), ("device", {"device_pesq": True})):
        InferencerSpe(DPRNNSpeTasNet(**TINY_SPE),
                      dict(extra, metrics=METRICS, checkpoint_path=str(path),
                           test_savedir=str(tmp_path / lane)), device="cpu").run(
            ds, batch_size=3, n_buckets=1, bucket_multiple=100, overlap_metrics=False)
        rows[lane] = _read_rows(tmp_path / lane / "all_metrics.csv")
    for metric, tol in (("stoi", 2e-3), ("pesq", 0.05), ("si_sdr", 1e-9)):
        errs = [abs(float(d[k]) - float(h[k])) for d, h in zip(rows["device"], rows["host"])
                for k in (metric, "input_" + metric)]
        assert max(errs) <= tol, (metric, errs)


# ----------------------------------------------------------- on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the card's run is compared with the CPU's")


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["stoi", "pesq"])
def test_device_metrics_on_card_match_cpu(metric):
    """8 x 10 s ragged rows (one too short), the stacked 2B-row call of the
    lane: the card against the port's CPU run at the JAX bars."""
    _needs_card()
    clean, deg, lens = _rows(8000, 4, [80000, 71234, 65000, 52111, 40000, 33333, 20000, 1000],
                             80000)
    fn = (lambda *a: stoi.stoi_batch(*a, 8000)) if metric == "stoi" else (
        lambda *a: pesq_device.pesq_batch(*a, 8000, "nb"))
    cpu = fn(*_t(clean, deg, lens)).numpy()
    card = fn(*(a.cuda() for a in _t(clean, deg, lens))).cpu().numpy()
    assert np.isnan(card[-1]) and np.isnan(cpu[-1])
    err = np.abs(card[:-1] - cpu[:-1])
    bar, median = (2e-3, 5e-4) if metric == "stoi" else (0.05, 0.02)
    assert err.max() <= bar and np.median(err) <= median, err
