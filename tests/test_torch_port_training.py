"""The port's training path (tss_dprnn_tpu_torch.training and the modules it
runs) on the CPU, against the JAX package where it has a counterpart.

- BatchNorm's training mode, the PIT SI-SDR loss, cross-entropy, the
  schedulers and the training loader against the JAX package's.
- One TrainerSpe step of a small DPRNN-Spe-TasNet from JAX-initialised
  weights against the JAX trainer's loss and gradients (its Pallas LSTM
  lane in interpret mode, run eagerly): loss within 1e-5 relative, every
  gradient within
  1e-4 of max |grad| of its tensor (fp32 sums in another order through two
  dual-path blocks), the parameters after clip + decay + Adam within 1e-6,
  and the BatchNorm running statistics within 1e-6.
- Trainer.run: checkpoint names and retention, early stop, the plateau lr,
  exact resume (bit for bit on the CPU), a checkpoint that serves through
  InferencerSpe, and the knobs refused until they were ported.
"""

import functools
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tss_dprnn_tpu.data import loader as jloader
from tss_dprnn_tpu.ops import losses as jlosses
from tss_dprnn_tpu.training import schedulers as jsched
from tss_dprnn_tpu_torch.data import loader
from tss_dprnn_tpu_torch.inference import InferencerSpe
from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
from tss_dprnn_tpu_torch.models.layers import BatchNorm
from tss_dprnn_tpu_torch.ops import bilstm2, losses
from tss_dprnn_tpu_torch.training import TrainerSpe, schedulers
from tss_dprnn_tpu_torch.training.trainer import Trainer
from tss_dprnn_tpu_torch.utils.weights import init_weights_, state_dict_from_jax

SMALL = dict(input_size=8, feature_size=16, hidden_size=16, chunk_length=8, kernel_size=2,
             hop_length=4, n_repeats=2, norm_type="ln", activation_type="sigmoid", O=8, P=12,
             embeddings_size=8, num_spks=5, fusion_type="att")
TINY = dict(SMALL, n_repeats=1)


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


class _Crops:
    """In-memory training items: ds[i] -> (mix, target, reference, spk_idx),
    fixed-length crops and references of ragged length."""

    def __init__(self, seed, n, samples=240):
        rng = np.random.default_rng(seed)
        self.items = []
        for _ in range(n):
            target = rng.standard_normal(samples).astype(np.float32)
            mix = target + rng.standard_normal(samples).astype(np.float32)
            ref = rng.standard_normal(int(rng.integers(150, 260))).astype(np.float32)
            self.items.append((mix, target, ref, int(rng.integers(0, 5))))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        return [len(it[0]) for it in self.items]


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("shape", [(3, 7, 6), (5, 6)])
def test_batchnorm_train_matches_flax(rng, shape):
    from tss_dprnn_tpu.models.layers import BatchNorm as JaxBatchNorm

    C = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    shift = (0.1 * rng.standard_normal(C)).astype(np.float32)
    mean0 = (0.1 * rng.standard_normal(C)).astype(np.float32)
    var0 = (0.5 + rng.random(C)).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": shift},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, updates = JaxBatchNorm(C).apply(variables, x, use_running_average=False,
                                          mutable=["batch_stats"])
    bn = BatchNorm(C)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(shift),
                        "running_mean": torch.from_numpy(mean0),
                        "running_var": torch.from_numpy(var0),
                        "num_batches_tracked": torch.tensor(0)})
    got = bn.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(), updates["batch_stats"]["mean"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), updates["batch_stats"]["var"],
                               atol=1e-6, rtol=0)
    # eval mode normalises with the running statistics and leaves them alone
    before = bn.running_mean.clone()
    want_eval = JaxBatchNorm(C).apply({"params": variables["params"],
                                       "batch_stats": updates["batch_stats"]}, x)
    np.testing.assert_allclose(bn.eval()(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want_eval), atol=1e-5, rtol=0)
    assert torch.equal(bn.running_mean, before)


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_pit_sisdr_loss_matches_jax(rng, n, with_lengths):
    B, T = 4, 300
    est = rng.standard_normal((B, n, T)).astype(np.float32)
    target = (est[:, ::-1] + 0.5 * rng.standard_normal((B, n, T))).astype(np.float32)
    lengths = np.array([300, 211, 150, 299], np.int32) if with_lengths else None
    want_loss, want_est = jlosses.pit_sisdr_loss(est, target, return_est=True, lengths=lengths)
    lt = None if lengths is None else torch.from_numpy(lengths)
    got_loss, got_est = losses.pit_sisdr_loss(torch.from_numpy(est), torch.from_numpy(target),
                                              return_est=True, lengths=lt)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_est.numpy(), np.asarray(want_est))
    plain = losses.pit_sisdr_loss(torch.from_numpy(est), torch.from_numpy(target), lengths=lt)
    assert plain.item() == got_loss.item()


def test_cross_entropy_matches_jax_and_torch(rng):
    logits = (rng.standard_normal((6, 5)) * 3).astype(np.float32)
    labels = np.array([0, 4, 2, 2, 1, 3], np.int32)
    got = losses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(jlosses.cross_entropy(logits, labels)),
                               rtol=1e-6)
    torch.testing.assert_close(got, torch.nn.functional.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels).long()))


# -------------------------------------------------------------- schedulers

def test_schedulers_match_jax():
    metrics = [-3.0, -4.0, -3.9, -3.95, -3.99, -5.0, -4.9, -4.8, -4.7, 2.0, 1.0, 1.0]
    got, want = schedulers.ReduceLROnPlateau(1e-3, 0.5, 1), jsched.ReduceLROnPlateau(1e-3, 0.5, 1)
    assert [got.step(m) for m in metrics] == [want.step(m) for m in metrics]
    assert got.state_dict() == want.state_dict()
    got, want = schedulers.ExponentialDecay(1e-3, 0.98), jsched.ExponentialDecay(1e-3, 0.98)
    assert [got.step() for _ in range(5)] == [want.step() for _ in range(5)]
    restored = schedulers.ReduceLROnPlateau(1.0)
    restored.load_state_dict({"lr": 0.25, "best": -4.0, "num_bad": 1})
    assert (restored.lr, restored.best, restored.num_bad) == (0.25, -4.0, 1)


# ------------------------------------------------------------------ loader

@pytest.mark.parametrize("seed,batch_size,drop_last", [(0, 3, True), (7, 4, False)])
def test_train_loader_matches_jax(seed, batch_size, drop_last):
    ds = _Crops(1, 10)
    got = loader.TrainLoader(ds, batch_size, loader.collate_spe, seed=seed, drop_last=drop_last,
                             prefetch=2)
    want = jloader.TrainLoader(ds, batch_size, jloader.collate_spe, seed=seed,
                               drop_last=drop_last, prefetch=0, process_index=0,
                               process_count=1)
    assert len(got) == len(want)
    for epoch in (3, 1, 3):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        gb, wb = list(got), list(want)
        assert len(gb) == len(wb) == len(got)
        for g, w in zip(gb, wb):
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    got.set_epoch(5)
    want.set_epoch(5)
    for k, v in want.peek().items():
        np.testing.assert_array_equal(got.peek()[k], v)


def test_train_loader_prefetch_raises_worker_errors():
    class Broken(_Crops):
        def __getitem__(self, i):
            if i == 4:
                raise OSError("unreadable item 4")
            return super().__getitem__(i)

    ld = loader.TrainLoader(Broken(0, 8), 2, loader.collate_spe, shuffle=False, prefetch=2)
    seen = []
    with pytest.raises(OSError, match="unreadable item 4"):
        for batch in ld:
            seen.append(batch)
    assert len(seen) == 2


def test_collate_spe_rejects_resampling():
    """Refused until the RawNet family was ported: ``resample_ref_to``
    resamples each reference on the host, as the JAX collate does."""
    items = _Crops(0, 2).items
    got = loader.collate_spe(items, resample_ref_to=16000)
    want = jloader.collate_spe(items, resample_ref_to=16000)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["ref_len"].tolist() == [2 * len(it[2]) for it in items]


# ---------------------------------------------------- one step against JAX

def _batch(ds, idx):
    return loader.collate_spe([ds[i] for i in idx])


def _port_grads_as_tree(model):
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def test_trainer_spe_step_matches_jax(tmp_path, interpret):
    from tss_dprnn_tpu.models import DPRNNSpeTasNet as JaxDPRNNSpeTasNet
    from tss_dprnn_tpu.ops import rnn as jax_rnn
    from tss_dprnn_tpu.training.train_state import TrainState, make_optimizer
    from tss_dprnn_tpu.training.trainer_spe import TrainerSpe as JaxTrainerSpe

    ds = _Crops(2, 3)
    batch = _batch(ds, [0, 1, 2])
    config = {"optimizer": {"lr": 1e-3, "weight_decay": 1e-2}, "clip_norm": 5,
              "ce_gamma": 0.5, "print_freq": 1, "lstm_backend": "pallas"}

    # the JAX side: its trainer's loss, jax.value_and_grad, then its optimizer
    jmodel = JaxDPRNNSpeTasNet(**SMALL)
    jtrainer = JaxTrainerSpe(jmodel, dict(config, new_checkpoints_path=str(tmp_path / "j")))
    tx = make_optimizer(1e-3, 1e-2, 5.0)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch["mix"][:1],
                                     batch["reference"][:1], batch["ref_len"][:1])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), tx=tx)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        with jax_rnn.lstm_backend("pallas"):
            loss, new_bs, _ = jtrainer._forward_loss(
                {"params": params, "batch_stats": state.batch_stats}, jbatch, train=True)
        return loss, new_bs

    # eagerly, op by op as the port runs: XLA's fused program of the same
    # step moves the speaker encoder's gradients upstream of its max pools
    # by up to their own size (measured against eager JAX on this batch:
    # the pools' ties in padded reference frames split their gradient
    # another way, scripts/port/spk_grad_ties.py), so only the eager run is
    # a reference at a tight bar
    (want_loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    new_state = state.apply_gradients(grads)

    def port_tree(params, stats):
        return state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          {"params": params, "batch_stats": stats}),
                                   "ln", 2, "att")

    start = port_tree(state.params, state.batch_stats)
    want_grads = port_tree(grads, state.batch_stats)
    want_after = port_tree(new_state.params, new_bs)

    # the port: the gradient of the same loss, then one whole train_step
    def fresh_trainer(directory):
        model = DPRNNSpeTasNet(**SMALL)
        model.load_state_dict(start, strict=True)
        return TrainerSpe(model, dict(config, new_checkpoints_path=str(directory)), device="cpu")

    tr = fresh_trainer(tmp_path / "a")
    tr.model.train()
    loss, _ = tr._forward_loss(tr._to_device(batch), train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got_grads = _port_grads_as_tree(tr.model)
    assert set(got_grads) == {k for k, _ in tr.model.named_parameters()}
    for k, g in got_grads.items():
        w = want_grads[k]
        assert float(w.abs().max()) > 0, k  # every parameter takes part in the loss
        torch.testing.assert_close(g, w, atol=1e-4 * float(w.abs().max()), rtol=0, msg=k)

    tr = fresh_trainer(tmp_path / "b")
    before = bilstm2.launch_count()
    step_loss, aux = tr.train_step(batch)
    assert bilstm2.launch_count() == before  # CPU tensors launch no kernel
    np.testing.assert_allclose(step_loss.item(), float(want_loss), rtol=1e-5)
    assert set(aux) == {"l", "ce"}
    got_after = tr.model.state_dict()
    for k, w in want_after.items():
        if k.endswith("num_batches_tracked"):
            continue
        torch.testing.assert_close(got_after[k], w, atol=1e-6, rtol=0, msg=k)


# ------------------------------------------------------------- Trainer.run

def _run_config(directory, **over):
    cfg = {"optimizer": {"lr": 1e-3, "weight_decay": 1e-5}, "clip_norm": 5, "print_freq": 2,
           "new_checkpoints_path": str(directory), "save_optimizer": True,
           "lr_scheduler": {"factor": 0.5, "patience": 0}}
    cfg.update(over)
    return cfg


def _trainer(directory, seed=0, **over):
    model = init_weights_(DPRNNSpeTasNet(**TINY), torch.Generator().manual_seed(seed))
    return TrainerSpe(model, _run_config(directory, **over), device="cpu")


def _loaders(n=6):
    ds = _Crops(0, n)
    return (loader.TrainLoader(ds, 2, loader.collate_spe, seed=3, prefetch=2),
            loader.TrainLoader(_Crops(9, 4), 2, loader.collate_spe, shuffle=False, prefetch=0))


def test_trainer_run_best_last_early_stop_and_plateau(tmp_path, monkeypatch):
    """Scripted eval losses make best tracking, early stop and the plateau
    lr exact: -5 (best), -4 and -4.5 (no improvement) -> stop at epoch 3."""
    scripted = iter([-5.0, -4.0, -4.5, -6.0])
    monkeypatch.setattr(Trainer, "eval", lambda self, dl: next(scripted))
    tr = _trainer(tmp_path, lr_scheduler={"factor": 0.5, "patience": 0})
    train_loader, eval_loader = _loaders()
    lrs = []
    real_set = tr.optimizer.set_learning_rate
    monkeypatch.setattr(tr.optimizer, "set_learning_rate", lambda lr: (lrs.append(lr),
                                                                       real_set(lr)))
    tr.run(train_loader, eval_loader, n_epochs=10, early_stop=2)
    assert tr.cur_epoch == 3
    assert sorted(os.listdir(tmp_path)) == ["1_best", "3_last"]
    want = jsched.ReduceLROnPlateau(1e-3, 0.5, 0)
    assert lrs == [want.step(m) for m in (-5.0, -4.0, -4.5)] == [1e-3, 5e-4, 2.5e-4]
    assert tr.optimizer.learning_rate == 2.5e-4
    ckpt = torch.load(tmp_path / "3_last", weights_only=True)
    assert ckpt["epoch"] == 3 and ckpt["run"] == {"best_loss": -5.0, "no_improve_cnt": 2}
    assert ckpt["scheduler"]["lr"] == 2.5e-4 and ckpt["step"] == 9


def test_trainer_run_keeps_the_newest_checkpoints(tmp_path, monkeypatch):
    scripted = iter([-1.0, -2.0, -3.0])
    monkeypatch.setattr(Trainer, "eval", lambda self, dl: next(scripted))
    tr = _trainer(tmp_path, n_checkpoints=2, lr_scheduler={"decay_rate": 0.5})
    tr.run(*_loaders(), n_epochs=3, early_stop=5)
    assert sorted(os.listdir(tmp_path)) == ["3_best", "3_last"]
    assert tr.optimizer.learning_rate == 1e-3 * 0.5 ** 3


def test_trainer_run_real_epochs_and_checkpoint_serves(tmp_path):
    """Two real epochs (train and eval on the plain versions), then the best
    checkpoint loads into InferencerSpe and serves."""
    tr = _trainer(tmp_path / "ck", print_freq=1)
    train_loader, eval_loader = _loaders()
    tr.run(train_loader, eval_loader, n_epochs=2, early_stop=5)
    files = os.listdir(tmp_path / "ck")
    assert "2_last" in files and any(f.endswith("_best") for f in files)
    assert tr.step == 2 * len(train_loader)
    best = sorted(f for f in files if f.endswith("_best"))[-1]
    config = {"checkpoint_path": str(tmp_path / "ck" / best),
              "test_savedir": str(tmp_path / "metrics"), "metrics": ["si_sdr"]}
    inf = InferencerSpe(DPRNNSpeTasNet(**TINY), config, device="cpu")
    final = inf.run(_Crops(5, 3), batch_size=2, n_buckets=1)
    assert all(math.isfinite(v) for v in final.values())
    last = torch.load(tmp_path / "ck" / "2_last", weights_only=True)["model"]
    for k, v in tr.model.state_dict().items():
        assert torch.equal(last[k], v), k


def test_exact_resume_is_bitwise(tmp_path):
    """run(2) equals run(1) + resume(1) bit for bit: weights, BatchNorm
    statistics, Adam moments, scheduler and counters."""
    full = _trainer(tmp_path / "full")
    full.run(*_loaders(), n_epochs=2, early_stop=5)
    half = _trainer(tmp_path / "half")
    half.run(*_loaders(), n_epochs=1, early_stop=5)
    resumed = _trainer(tmp_path / "half", seed=1,
                       checkpoint_path=str(tmp_path / "half" / "1_last"))
    assert resumed.cur_epoch == 1 and resumed.step == half.step
    resumed.run(*_loaders(), n_epochs=2, early_stop=5)
    a = torch.load(tmp_path / "full" / "2_last", weights_only=True)
    b = torch.load(tmp_path / "half" / "2_last", weights_only=True)
    assert a["step"] == b["step"] and a["run"] == b["run"] and a["scheduler"] == b["scheduler"]
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for pa, pb in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values()):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k


def test_warm_start_from_mismatched_checkpoint_fails(tmp_path):
    other = init_weights_(DPRNNSpeTasNet(**dict(TINY, hidden_size=8)),
                          torch.Generator().manual_seed(0))
    path = tmp_path / "other.pt"
    torch.save({"epoch": 3, "model": other.state_dict()}, path)
    with pytest.raises(RuntimeError, match="size mismatch"):
        _trainer(tmp_path / "ck", checkpoint_path=str(path))


@pytest.mark.parametrize("over,match", [
    ({"accum_steps": 2}, "accum_steps"),
    ({"lstm_save_every": 4}, "lstm_save_every"),
    ({"schedule_masks": True}, "schedule_masks"),
    ({"is_metrics": True}, "is_metrics"),
])
def test_trainer_rejects_unported_knobs(tmp_path, over, match):
    """Refused until they were ported; each knob now takes one step with a
    finite loss (tests/test_torch_port_train_knobs.py holds them against
    JAX)."""
    tr = _trainer(tmp_path, **over)
    assert getattr(tr, match) == over[match]
    loss, aux = tr.train_step(_batch(_Crops(0, 2), [0, 1]))
    assert math.isfinite(loss.item())
    assert ("est" in aux) == (match == "is_metrics")


def test_trainer_rejects_batches_with_lengths(tmp_path):
    """Refused until variable-length training was ported: a batch with
    lengths now takes one step with a finite loss
    (tests/test_torch_port_varlen_training.py holds it against JAX)."""
    tr = _trainer(tmp_path, lstm_backend="pallas")  # accepted and ignored
    batch = _batch(_Crops(0, 2), [0, 1])
    batch["lengths"] = np.array([240, 200], np.int32)
    loss, _ = tr.train_step(batch)
    assert tr._varlen and math.isfinite(loss.item())
