"""The port's serving path on the CPU: the bucketed loader against the JAX
package's, and InferencerSpe.run end to end over an in-memory dataset."""

import csv
import json
import math

import numpy as np
import pytest
import torch

from tss_dprnn_tpu.data import loader as jloader
from tss_dprnn_tpu_torch.data import loader
from tss_dprnn_tpu_torch.inference import InferencerSpe
from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
from tss_dprnn_tpu_torch.ops.losses import masked_si_sdr
from tss_dprnn_tpu_torch.utils.weights import init_weights_

SMALL = dict(input_size=8, feature_size=16, hidden_size=16, chunk_length=8, kernel_size=2,
             hop_length=4, n_repeats=1, norm_type="ln", O=8, P=12, embeddings_size=8,
             num_spks=5, fusion_type="att")


class _Utterances:
    """In-memory dataset: ds[i] -> (mix, target, reference, spk_idx)."""

    def __init__(self, seed, mix_lens, ref_lens):
        rng = np.random.default_rng(seed)
        self.items = []
        for n, nr in zip(mix_lens, ref_lens):
            target = rng.standard_normal(n).astype(np.float32)
            mix = target + rng.standard_normal(n).astype(np.float32)
            self.items.append((mix, target, rng.standard_normal(nr).astype(np.float32),
                               int(rng.integers(0, 5))))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        return [len(it[0]) for it in self.items]


@pytest.fixture
def dataset():
    return _Utterances(0, [301, 250, 420, 199, 333], [260, 300, 190, 222, 251])


@pytest.fixture
def checkpoint(tmp_path):
    model = init_weights_(DPRNNSpeTasNet(**SMALL), torch.Generator().manual_seed(0))
    path = tmp_path / "model.pt"
    torch.save(model.state_dict(), path)
    return path


@pytest.mark.parametrize("n_buckets,multiple", [(2, 100), (3, 64), (1, 2000)])
def test_loader_matches_jax(dataset, n_buckets, multiple):
    lengths = dataset.lengths()
    assert loader.bucket_boundaries(lengths, n_buckets, multiple) == \
        jloader.bucket_boundaries(lengths, n_buckets, multiple)
    want = jloader.BucketedEvalLoader(dataset, 2, jloader.make_collate_spe_eval(), lengths,
                                      n_buckets=n_buckets, multiple=multiple,
                                      process_index=0, process_count=1, prefetch=0)
    got = loader.BucketedEvalLoader(dataset, 2, loader.make_collate_spe_eval(), lengths,
                                    n_buckets=n_buckets, multiple=multiple)
    got_batches, want_batches = list(got), list(want)
    assert len(got_batches) == len(want_batches) == len(got)
    for g, w in zip(got_batches, want_batches):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_inferencer_spe_run(dataset, checkpoint, tmp_path):
    out_dir = tmp_path / "metrics"
    config = {"checkpoint_path": str(checkpoint), "test_savedir": str(out_dir),
              "metrics": ["si_sdr"], "data": {"sample_rate": 8000}}
    inf = InferencerSpe(DPRNNSpeTasNet(**SMALL), config, device="cpu")
    final = inf.run(dataset, batch_size=2, n_buckets=2, bucket_multiple=100)
    assert set(final) == {"si_sdr", "si_sdr_imp"}
    assert all(math.isfinite(v) for v in final.values())
    assert json.loads((out_dir / "final_metrics.json").read_text()) == pytest.approx(final)
    with open(out_dir / "all_metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["index"]) for r in rows] == list(range(len(dataset)))
    # each bucketed row scores what the utterance scores alone, at its exact shape
    model = inf.model
    with torch.inference_mode():
        for r in rows:
            mix, target, ref, _ = dataset[int(r["index"])]
            est, _ = model(torch.from_numpy(mix)[None], torch.from_numpy(ref)[None],
                           torch.tensor([float(len(ref))]))
            alone = masked_si_sdr(est, torch.from_numpy(target)[None]).item()
            assert float(r["si_sdr"]) == pytest.approx(alone, abs=1e-3)
            assert math.isfinite(float(r["input_si_sdr"]))


def test_inferencer_needs_card_unless_cpu_is_asked(checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferencerSpe(DPRNNSpeTasNet(**SMALL), {"checkpoint_path": str(checkpoint),
                                                "metrics": ["si_sdr"]})


@pytest.mark.parametrize("metrics", [["si_sdr", "sisnr"], ["pesq"]])
def test_inferencer_rejects_unported_metrics(checkpoint, metrics):
    """A metric outside si_sdr / stoi / pesq raises; PESQ asked for on the
    device (``device_pesq``, the second case), refused until it was ported,
    goes to the device lane and turns ``device_metrics`` on."""
    config = {"checkpoint_path": str(checkpoint), "metrics": metrics,
              "device_pesq": metrics == ["pesq"]}
    if metrics == ["pesq"]:
        inf = InferencerSpe(DPRNNSpeTasNet(**SMALL), config, device="cpu")
        assert inf.device_metrics and inf.device_lane == ["pesq"] and inf.host_metrics == []
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        InferencerSpe(DPRNNSpeTasNet(**SMALL), config, device="cpu")


def test_inferencer_default_metrics_raise_until_ported(checkpoint):
    """A config without ``metrics`` asks for the JAX default; since STOI and
    PESQ are ported it no longer raises, and the two run on the host."""
    inf = InferencerSpe(DPRNNSpeTasNet(**SMALL), {"checkpoint_path": str(checkpoint)},
                        device="cpu")
    assert inf.metrics == ["si_sdr", "stoi", "pesq"]
    assert inf.host_metrics == ["stoi", "pesq"]


def test_inferencer_default_metrics_equal_jax():
    """The port's default metric list is the JAX Inferencer's (read from an
    instance whose __init__ stops at the missing checkpoint, after setting it)."""
    from tss_dprnn_tpu.inference.inferencer import Inferencer as JaxInferencer
    from tss_dprnn_tpu_torch.inference.inferencer import DEFAULT_METRICS

    jinf = JaxInferencer.__new__(JaxInferencer)
    with pytest.raises(ValueError, match="checkpoint_path is required"):
        jinf.__init__(None, {})
    assert list(DEFAULT_METRICS) == jinf.metrics == ["si_sdr", "stoi", "pesq"]


def test_inferencer_requires_checkpoint():
    with pytest.raises(ValueError, match="checkpoint_path is required"):
        InferencerSpe(DPRNNSpeTasNet(**SMALL), {"metrics": ["si_sdr"]}, device="cpu")
