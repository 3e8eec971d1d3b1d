"""The port's blind-source-separation family (DPRNN-TasNet, the BSS
Inferencer and Trainer) and the ``bidirectional=False`` setting of both model
families, on the CPU at small widths, against the JAX package.

- ``DPRNNBlock(bidirectional=False)`` with chunk lengths against the JAX block
  on its Pallas lane (interpret mode): the forward on the valid chunks and
  ``jax.grad`` of a loss, every gradient within 1e-4 of its tensor's max
  |grad|. The unidirectional inter-chunk scan ignores the lengths in both
  packages; this pins that the masked norm makes that exact.
- ``DPRNNTasNet`` (``bidirectional`` true and false, masked and unmasked) and
  ``DPRNNSpeTasNet(bidirectional=False)`` from JAX-initialised weights
  (``state_dict_from_jax``, ``strict=True``): output SNR >= 60 dB on each
  row's valid region, the bar the JAX package holds against its torch oracle.
- ``collate_bss`` / ``collate_bss_eval`` equal to the JAX package's.
- The BSS ``Inferencer.run`` against the JAX ``Inferencer`` with
  ``device_metrics`` (SI-SDR and SI-SDRi within 1e-3 dB), a bucketed row
  against the request alone, and permuted estimates.
- One BSS ``Trainer`` step against the JAX trainer's loss and gradients (run
  eagerly), then ``Trainer.run`` -> checkpoint -> ``Inferencer``.
"""

import csv
import functools
import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tss_dprnn_tpu.data import loader as jloader
from tss_dprnn_tpu.models import DPRNNSpeTasNet as JaxDPRNNSpeTasNet
from tss_dprnn_tpu.models import DPRNNTasNet as JaxDPRNNTasNet
from tss_dprnn_tpu.utils.torch_export import export_state_dict
from tss_dprnn_tpu_torch.data import loader
from tss_dprnn_tpu_torch.inference import Inferencer
from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet, DPRNNTasNet
from tss_dprnn_tpu_torch.ops import bilstm2, lstm as lstm_ops
from tss_dprnn_tpu_torch.ops.losses import masked_si_sdr
from tss_dprnn_tpu_torch.training import Trainer
from tss_dprnn_tpu_torch.utils import weights
from tss_dprnn_tpu_torch.utils.weights import init_weights_, state_dict_from_jax

SMALL = dict(input_size=8, feature_size=16, hidden_size=16, chunk_length=8, kernel_size=2,
             hop_length=4, n_repeats=2, norm_type="ln", activation_type="sigmoid")
TINY = dict(SMALL, n_repeats=1)
SPE = dict(SMALL, O=8, P=12, embeddings_size=8, num_spks=5, fusion_type="att")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: in the suite's parallel workers
    torch's idle pool threads spin against each other's and every small op
    waits on the scheduler (test_torch_port_device_metrics.py measures it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _snr_db(got, want):
    return 10 * np.log10(np.sum(want ** 2) / max(np.sum((got - want) ** 2), 1e-30))


def _numpy_tree(variables):
    return jax.tree_util.tree_map(np.asarray, dict(variables))


class _Mixtures:
    """In-memory BSS dataset: ds[i] -> (mix [T], sources [2, T])."""

    def __init__(self, seed, lengths):
        rng = np.random.default_rng(seed)
        self.items = []
        for n in lengths:
            sources = rng.standard_normal((2, n)).astype(np.float32)
            self.items.append((sources.sum(0), sources))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        return [len(it[0]) for it in self.items]


# ------------------------------------------------------------------- block

def _block_state_dict(tree):
    """A JAX DPRNNBlock's params (or their gradients) under the port's names."""
    out = {}
    for part in ("intra", "inter"):
        weights._rnn_entries(out, f"{part}_rnn.rnn", tree[f"{part}_rnn"])
        weights._dense_entries(out, f"{part}_linear", tree[f"{part}_linear"])
        weights._norm_entries(out, f"{part}_norm", tree[f"{part}_norm"], "ln")
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def test_unidirectional_block_matches_jax_with_chunk_lengths(rng, interpret):
    from tss_dprnn_tpu.models.dprnn import DPRNNBlock as JaxBlock
    from tss_dprnn_tpu.ops import rnn as jax_rnn
    from tss_dprnn_tpu_torch.models.dprnn import DPRNNBlock

    B, S, K, N, H = 2, 7, 5, 16, 16
    x = rng.standard_normal((B, S, K, N)).astype(np.float32)
    cot = rng.standard_normal((B, S, K, N)).astype(np.float32)
    chunk_lengths = np.array([7, 3], np.int32)
    x[1, 3:] = 0  # padded chunks carry zeros, as segmentation of a masked input leaves them
    jblock = JaxBlock(N, H, norm_type="ln", bidirectional=False)
    params = jblock.init(jax.random.PRNGKey(0), x, chunk_lengths)["params"]
    assert "w_ih_b" not in params["inter_rnn"] and "w_ih_b" in params["intra_rnn"]

    def jax_loss(params, x):
        return jnp.sum(jblock.apply({"params": params}, x, chunk_lengths) * cot)

    with jax_rnn.lstm_backend("pallas"):  # forward and backward both read the backend
        want_out = jblock.apply({"params": params}, x, chunk_lengths)
        want_loss, (want_params, want_dx) = jax.value_and_grad(jax_loss, argnums=(0, 1))(params, x)

    block = DPRNNBlock(N, H, "ln", bidirectional=False)
    sd = _block_state_dict(params)
    assert not any("_reverse" in k for k in sd if k.startswith("inter_rnn"))
    assert sd["inter_linear.weight"].shape == (N, H)
    block.load_state_dict(sd, strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    before = (bilstm2.launch_count(), lstm_ops.launch_count())
    out = block(xt, torch.from_numpy(chunk_lengths))
    loss = (out * torch.from_numpy(cot)).sum()
    loss.backward()
    assert (bilstm2.launch_count(), lstm_ops.launch_count()) == before  # the plain versions ran
    for b, n in enumerate(chunk_lengths):  # the forward on the valid chunks
        np.testing.assert_allclose(out.detach().numpy()[b, :n], np.asarray(want_out)[b, :n],
                                   atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = dict(_block_state_dict(want_params), x=torch.from_numpy(np.array(want_dx)))
    got = dict(((k, p.grad) for k, p in block.named_parameters()), x=xt.grad)
    assert set(got) == set(want)
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, atol=1e-4 * float(w.abs().max()), rtol=0, msg=k)


def test_rnn_core_rejects_other_cells():
    """An unknown cell raises; 'GRU' and 'RNN', refused until they were
    ported, build with their torch gate widths (3H, H) and run no kernel."""
    from tss_dprnn_tpu_torch.models.layers import RNNCore

    with pytest.raises(ValueError, match="LSTM/GRU/RNN"):
        RNNCore(8, 8, True, "LSTM2")
    assert RNNCore(8, 8, True, "GRU").rnn.weight_ih_l0_reverse.shape == (24, 8)
    model = init_weights_(DPRNNTasNet(**dict(TINY, rnn_type="RNN")),
                          torch.Generator().manual_seed(0))
    assert model.separation.dprnn_blocks[0].inter_rnn.rnn.weight_hh_l0.shape == (
        TINY["hidden_size"],) * 2
    before = (bilstm2.launch_count(), lstm_ops.launch_count())
    with torch.inference_mode():
        assert torch.isfinite(model(torch.ones(1, 160))).all()
    assert (bilstm2.launch_count(), lstm_ops.launch_count()) == before


# ------------------------------------------------------------------ models

@pytest.fixture(scope="module")
def batch():
    """A bucketed batch of 3 ragged rows, zero-padded past the true lengths."""
    rng = np.random.default_rng(3)
    lengths = np.array([400, 317, 251], np.int32)
    mix = rng.standard_normal((3, 400)).astype(np.float32)
    for b in range(3):
        mix[b, lengths[b]:] = 0
    return mix, lengths


@pytest.fixture(scope="module", params=[True, False], ids=["bidirectional", "unidirectional"])
def tasnet_pair(request, batch):
    """(JAX model, its variables, the port's model loaded from them)."""
    cfg = dict(SMALL, bidirectional=request.param)
    jmodel = JaxDPRNNTasNet(**cfg)
    variables = _numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch[0][:1]))
    sd = state_dict_from_jax(variables, "ln", 2)
    model = DPRNNTasNet(**cfg).eval()
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)
    return jmodel, variables, model


def test_bss_state_dict_equals_export(tasnet_pair):
    _, variables, model = tasnet_pair
    got = state_dict_from_jax(variables, norm_type="ln", kernel_size=2)
    want = export_state_dict(variables, norm_type="ln", kernel_size=2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    reverse = [k for k in got if "inter_rnn" in k and k.endswith("_reverse")]
    assert bool(reverse) == model.separation.dprnn_blocks[0].inter_rnn.bidirectional


def test_tasnet_matches_jax_bucketed(batch, tasnet_pair):
    jmodel, variables, model = tasnet_pair
    mix, lengths = batch
    want = np.asarray(jax.jit(jmodel.apply)(variables, mix, lengths))
    with torch.inference_mode():
        got = model(torch.from_numpy(mix), torch.from_numpy(lengths)).numpy()
    assert got.shape == want.shape == (3, 2, 400)
    for b, n in enumerate(lengths):
        assert _snr_db(got[b, :, :n], want[b, :, :n]) >= 60.0


def test_tasnet_matches_jax_unmasked(batch, tasnet_pair):
    jmodel, variables, model = tasnet_pair
    mix = batch[0][:1]
    want = np.asarray(jax.jit(jmodel.apply)(variables, mix))
    with torch.inference_mode():
        got = model(torch.from_numpy(mix)).numpy()
    assert _snr_db(got, want) >= 60.0


def test_tasnet_masked_bucket_equals_exact_shape(batch, tasnet_pair):
    model = tasnet_pair[2]
    mix, lengths = (torch.from_numpy(a) for a in batch)
    with torch.inference_mode():
        padded = model(mix, lengths)
        for b in range(3):
            n = int(lengths[b])
            torch.testing.assert_close(padded[b, :, :n], model(mix[b : b + 1, :n])[0],
                                       atol=2e-4, rtol=1e-4)


def test_unidirectional_spe_tasnet_matches_jax(batch):
    mix, lengths = batch
    rng = np.random.default_rng(5)
    ref_len = np.array([300, 222, 181], np.float32)
    ref = rng.standard_normal((3, 300)).astype(np.float32)
    for b in range(3):
        ref[b, int(ref_len[b]):] = 0
    cfg = dict(SPE, bidirectional=False)
    jmodel = JaxDPRNNSpeTasNet(**cfg)
    variables = _numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(1), mix[:1], ref[:1],
                                                 ref_len[:1]))
    model = DPRNNSpeTasNet(**cfg).eval()
    model.load_state_dict(state_dict_from_jax(variables, "ln", 2, "att"), strict=True)
    want_wav, want_logits = jax.jit(jmodel.apply)(variables, mix, ref, ref_len, lengths)
    with torch.inference_mode():
        wav, logits = model(*(torch.from_numpy(a) for a in (mix, ref, ref_len, lengths)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=1e-4, rtol=0)
    for b, n in enumerate(lengths):
        assert _snr_db(wav[b, :n].numpy(), np.asarray(want_wav)[b, :n]) >= 60.0


# ------------------------------------------------------------------ loader

def test_bss_collates_match_jax():
    ds = _Mixtures(0, [240] * 4)
    got, want = loader.collate_bss(ds.items), jloader.collate_bss(ds.items)
    assert set(got) == set(want) == {"mix", "sources"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ragged = _Mixtures(1, [301, 250, 420, 199, 333])
    lengths = ragged.lengths()
    want = jloader.BucketedEvalLoader(ragged, 2, jloader.collate_bss_eval, lengths, n_buckets=2,
                                      multiple=100, process_index=0, process_count=1, prefetch=0)
    got = loader.BucketedEvalLoader(ragged, 2, loader.collate_bss_eval, lengths, n_buckets=2,
                                    multiple=100)
    got_batches, want_batches = list(got), list(want)
    assert len(got_batches) == len(want_batches)
    for g, w in zip(got_batches, want_batches):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# --------------------------------------------------------------- inferencer

def test_bss_inferencer_matches_jax(tmp_path):
    from tss_dprnn_tpu.inference import Inferencer as JaxInferencer
    from tss_dprnn_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager

    cfg = dict(TINY, bidirectional=False)
    ds = _Mixtures(2, [301, 250, 420, 199, 333])
    jmodel = JaxDPRNNTasNet(**cfg)
    variables = _numpy_tree(jmodel.init(jax.random.PRNGKey(0), np.zeros((1, 200), np.float32)))
    jpath = JaxCheckpointManager(str(tmp_path / "jax_ckpt")).save(
        1, {"epoch": 1, "params": variables["params"], "batch_stats": {}}, best=True)
    jinf = JaxInferencer(jmodel, {"checkpoint_path": jpath, "metrics": ["si_sdr"],
                                  "test_savedir": str(tmp_path / "jax_metrics"),
                                  "device_metrics": True, "data": {"sample_rate": 8000}})
    want = jinf.run(ds, batch_size=2, n_buckets=2, bucket_multiple=100)

    path = tmp_path / "model.pt"
    torch.save(state_dict_from_jax(variables, "ln", 2), path)
    out_dir = tmp_path / "metrics"
    inf = Inferencer(DPRNNTasNet(**cfg), {"checkpoint_path": str(path), "metrics": ["si_sdr"],
                                          "test_savedir": str(out_dir)}, device="cpu")
    got = inf.run(ds, batch_size=2, n_buckets=2, bucket_multiple=100)
    assert set(got) == {"si_sdr", "si_sdr_imp"}
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=1e-3), k
    assert json.loads((out_dir / "final_metrics.json").read_text()) == pytest.approx(got)
    with open(out_dir / "all_metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["index"]) for r in rows] == list(range(len(ds)))
    with open(tmp_path / "jax_metrics" / "all_metrics.csv") as f:
        jax_rows = list(csv.DictReader(f))
    for r, jr in zip(rows, jax_rows):
        assert float(r["si_sdr"]) == pytest.approx(float(jr["si_sdr"]), abs=1e-3)
        assert float(r["input_si_sdr"]) == pytest.approx(float(jr["input_si_sdr"]), abs=1e-3)
    # each bucketed row scores what the mixture scores alone, at its exact shape
    with torch.inference_mode():
        for r in rows:
            mix, sources = ds[int(r["index"])]
            est = inf.model(torch.from_numpy(mix)[None])
            src = torch.from_numpy(sources)[None]
            best = max(masked_si_sdr(est[:, p], src).mean().item() for p in ([0, 1], [1, 0]))
            assert float(r["si_sdr"]) == pytest.approx(best, abs=1e-3)


def test_bss_inferencer_reorders_permuted_estimates(tmp_path):
    """Estimates that come out in the other source order are scored in
    source order: the PIT reorder runs before the metric."""
    ds = _Mixtures(4, [300, 260])
    model = init_weights_(DPRNNTasNet(**TINY), torch.Generator().manual_seed(0))
    path = tmp_path / "model.pt"
    torch.save(model.state_dict(), path)
    inf = Inferencer(DPRNNTasNet(**TINY), {"checkpoint_path": str(path), "metrics": ["si_sdr"],
                                          "test_savedir": str(tmp_path / "m")}, device="cpu")
    batch = next(iter(inf._make_loader(ds, 2, 1, 100)))
    noise = 0.01 * np.random.default_rng(0).standard_normal(batch["sources"].shape)
    swapped = torch.from_numpy((batch["sources"][:, ::-1] + noise).astype(np.float32))
    inf.forward = lambda b: swapped
    rows, _ = inf._batch_rows(batch)
    assert [r["index"] for r in rows] == [0, 1]
    assert all(r["si_sdr"] > 30.0 and r["input_si_sdr"] < 5.0 for r in rows)


@pytest.mark.parametrize("metrics", [["si_sdr", "sisnr"], ["pesq"]])
def test_bss_inferencer_rejects_unported_metrics(tmp_path, metrics):
    """As the TSS test: an unknown metric raises; PESQ on the device, ported
    since, is taken by the device lane."""
    path = tmp_path / "model.pt"
    torch.save(init_weights_(DPRNNTasNet(**TINY), torch.Generator().manual_seed(0)).state_dict(),
               path)
    config = {"checkpoint_path": str(path), "metrics": metrics,
              "device_pesq": metrics == ["pesq"]}
    if metrics == ["pesq"]:
        inf = Inferencer(DPRNNTasNet(**TINY), config, device="cpu")
        assert inf.device_metrics and inf.device_lane == ["pesq"] and inf.host_metrics == []
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        Inferencer(DPRNNTasNet(**TINY), config, device="cpu")


def test_bss_inferencer_default_metrics_raise_until_ported(tmp_path):
    """Since STOI and PESQ are ported the JAX default runs: every row has
    the three metrics and their inputs, each STOI in [0, 1]."""
    path = tmp_path / "model.pt"
    torch.save(init_weights_(DPRNNTasNet(**TINY), torch.Generator().manual_seed(0))
               .state_dict(), path)
    inf = Inferencer(DPRNNTasNet(**TINY), {"checkpoint_path": str(path),
                                           "test_savedir": str(tmp_path / "m")}, device="cpu")
    final = inf.run(_Mixtures(3, [6000, 5000]), batch_size=2, n_buckets=1)
    assert sorted(final) == ["pesq", "pesq_imp", "si_sdr", "si_sdr_imp", "stoi", "stoi_imp"]
    assert all(np.isfinite(v) for v in final.values())
    assert 0.0 <= final["stoi"] <= 1.0


# ------------------------------------------------------------------ trainer

def test_bss_trainer_step_matches_jax(tmp_path):
    """Loss and gradients of one step against the JAX trainer's, run eagerly
    on its default LSTM lane; then the parameters after clip + decay + Adam."""
    from tss_dprnn_tpu.training.train_state import TrainState, make_optimizer
    from tss_dprnn_tpu.training.trainer import Trainer as JaxTrainer

    cfg = dict(SMALL, bidirectional=False)
    batch = loader.collate_bss(_Mixtures(6, [240] * 3).items)
    config = {"optimizer": {"lr": 1e-3, "weight_decay": 1e-2}, "clip_norm": 5, "print_freq": 1}
    jmodel = JaxDPRNNTasNet(**cfg)
    jtrainer = JaxTrainer(jmodel, dict(config, new_checkpoints_path=str(tmp_path / "j")))
    tx = make_optimizer(1e-3, 1e-2, 5.0)
    params = jmodel.init(jax.random.PRNGKey(0), batch["mix"][:1])["params"]
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=tx.init(params), tx=tx)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        return jtrainer._forward_loss({"params": params}, jbatch, train=True)[0]

    want_loss, grads = jax.value_and_grad(loss_fn)(state.params)
    new_state = state.apply_gradients(grads)

    def port_tree(params):
        return state_dict_from_jax(_numpy_tree({"params": params}), "ln", 2)

    start, want_grads, want_after = (port_tree(p) for p in (state.params, grads,
                                                            new_state.params))

    def fresh_trainer(directory):
        model = DPRNNTasNet(**cfg)
        model.load_state_dict(start, strict=True)
        return Trainer(model, dict(config, new_checkpoints_path=str(directory)), device="cpu")

    tr = fresh_trainer(tmp_path / "a")
    tr.model.train()
    loss, aux = tr._forward_loss(tr._to_device(batch), train=True)
    loss.backward()
    assert aux == {}
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got_grads = {k: p.grad for k, p in tr.model.named_parameters()}
    assert set(got_grads) == set(want_grads)
    for k, g in got_grads.items():
        w = want_grads[k]
        assert float(w.abs().max()) > 0, k  # every parameter takes part in the loss
        torch.testing.assert_close(g, w, atol=1e-4 * float(w.abs().max()), rtol=0, msg=k)

    tr = fresh_trainer(tmp_path / "b")
    step_loss, _ = tr.train_step(batch)
    np.testing.assert_allclose(step_loss.item(), float(want_loss), rtol=1e-5)
    got_after = tr.model.state_dict()
    clip = min(1.0, 5.0 / sum(float(g.pow(2).sum()) for g in want_grads.values()) ** 0.5)
    for k, w in want_after.items():
        # Adam's first update is lr * g / (|g| + eps) of the clipped, decayed
        # gradient g = clip * grad + weight_decay * w: where that all but
        # cancels (|g| < 1e-6) the gradients' own rounding decides the
        # update, up to 2 lr
        settled = (clip * want_grads[k] + 1e-2 * start[k]).abs() >= 1e-6
        assert settled.float().mean() > 0.99, k
        torch.testing.assert_close(got_after[k][settled], w[settled], atol=1e-6, rtol=0, msg=k)
        torch.testing.assert_close(got_after[k], w, atol=2e-3, rtol=0, msg=k)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_bss_trainer_run_and_checkpoint_serves(tmp_path, bidirectional):
    """Two real epochs on the plain versions, then the best checkpoint loads
    into the BSS Inferencer and serves."""
    cfg = dict(TINY, bidirectional=bidirectional)
    model = init_weights_(DPRNNTasNet(**cfg), torch.Generator().manual_seed(0))
    config = {"optimizer": {"lr": 1e-3, "weight_decay": 1e-5}, "clip_norm": 5, "print_freq": 1,
              "new_checkpoints_path": str(tmp_path / "ck"), "save_optimizer": True,
              "lr_scheduler": {"factor": 0.5, "patience": 0}}
    tr = Trainer(model, config, device="cpu")
    train_loader = loader.TrainLoader(_Mixtures(0, [240] * 6), 2, loader.collate_bss, seed=3)
    eval_loader = loader.TrainLoader(_Mixtures(9, [240] * 4), 2, loader.collate_bss,
                                     shuffle=False, prefetch=0)
    tr.run(train_loader, eval_loader, n_epochs=2, early_stop=5)
    files = os.listdir(tmp_path / "ck")
    assert "2_last" in files and any(f.endswith("_best") for f in files)
    assert tr.step == 2 * len(train_loader)
    best = sorted(f for f in files if f.endswith("_best"))[-1]
    inf = Inferencer(DPRNNTasNet(**cfg), {"checkpoint_path": str(tmp_path / "ck" / best),
                                         "test_savedir": str(tmp_path / "metrics"),
                                         "metrics": ["si_sdr"]}, device="cpu")
    final = inf.run(_Mixtures(5, [300, 222, 260]), batch_size=2, n_buckets=1)
    assert all(math.isfinite(v) for v in final.values())
    # a checkpoint of the other setting does not load
    with pytest.raises(RuntimeError, match="state_dict"):
        Inferencer(DPRNNTasNet(**dict(cfg, bidirectional=not bidirectional)),
                   {"checkpoint_path": str(tmp_path / "ck" / best), "metrics": ["si_sdr"]},
                   device="cpu")
