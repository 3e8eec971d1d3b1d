"""Variable-length training in the port (``data.loader.VarLenTrainLoader``,
the segment-checkpointed LSTM of ``ops.rnn.LSTMSegments`` and the trainers'
``lengths``) on the CPU at small widths, against the JAX package.

- ``VarLenTrainLoader``'s batch plans, ``lengths`` and arrays equal the JAX
  loader's for one dataset, seed and epoch, exactly: ``collate_bss_eval``
  and ``make_collate_spe_eval`` with and without ``ref_pad_to`` (at 8 kHz
  and resampled to 16 kHz).
- The segment-checkpointed recurrence under ``lstm_save_every(q)`` against
  JAX's ``_recurrence`` at the same q (its forward on the Pallas
  ``want_cs`` kernel in interpret mode), q in {3, 4} with T = 10: D = 1
  through ``lstm_stack`` and D = 2 with ragged lengths through
  ``lstm_pair``. h within 1e-6; dx, dW_ih, db and dW_hh >= 60 dB.
- One variable-length ``Trainer`` step (causal BSS) and one ``TrainerSpe``
  step against the JAX trainer's loss and
  gradients, run eagerly (loss within 1e-5 relative, the parameters after
  clip + decay + Adam as the fixed-crop step tests hold them, BatchNorm's
  running statistics within 1e-6).
- The port's own invariants, as the JAX package's
  ``tests/test_varlen_training.py`` holds them: garbage past the lengths
  moves neither the loss nor the update, and all rows at full length equal
  the batch without lengths.

JAX is imported inside the tests; the ``cuda`` cases are in
``tests/test_torch_port_train_knobs.py``.
"""

import functools

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch.data import loader
from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet, DPRNNTasNet
from tss_dprnn_tpu_torch.ops import rnn
from tss_dprnn_tpu_torch.training import Trainer, TrainerSpe
from tss_dprnn_tpu_torch.utils.weights import init_weights_, state_dict_from_jax

SMALL = dict(input_size=8, feature_size=16, hidden_size=16, chunk_length=8, kernel_size=2,
             hop_length=4, n_repeats=1, norm_type="ln", activation_type="sigmoid")
SPE = dict(SMALL, O=8, P=12, embeddings_size=8, num_spks=5, fusion_type="att")
CONFIG = {"optimizer": {"lr": 1e-3, "weight_decay": 1e-2}, "clip_norm": 5, "ce_gamma": 0.5,
          "print_freq": 1}


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
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return 10 * np.log10(np.sum(want ** 2) / max(np.sum((got - want) ** 2), 1e-300))


def _numpy_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, dict(tree))


class _Ragged:
    """In-memory utterances of ragged length: ds[i] -> (mix, target,
    reference, spk_idx) with ``spe``, else (mix, sources [2, T])."""

    def __init__(self, seed, lengths, spe):
        rng = np.random.default_rng(seed)
        self.items = []
        for n in lengths:
            sources = rng.standard_normal((2, n)).astype(np.float32)
            if spe:
                ref = rng.standard_normal(int(rng.integers(150, 330))).astype(np.float32)
                self.items.append((sources.sum(0), sources[0], ref, int(rng.integers(0, 5))))
            else:
                self.items.append((sources.sum(0), sources))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        return [len(it[0]) for it in self.items]


LENGTHS = [310, 450, 620, 800, 380, 700, 560, 290, 760, 505, 640, 330, 470, 790]


# ------------------------------------------------------------------- loader

@pytest.mark.parametrize("collate", ["bss", "spe", "spe_ref_pad", "spe_ref_pad_16k"])
def test_varlen_loader_matches_jax(collate):
    """Plans, lengths and arrays equal the JAX loader's, shuffled over two
    epochs and in order, with ``max_len`` capping rows; ``peek`` too."""
    from tss_dprnn_tpu.data import loader as jloader

    ds = _Ragged(0, LENGTHS, spe=collate != "bss")
    # below the longest reference (329 samples, 658 at 16 kHz): ref_len is capped
    ref_pad = {"spe_ref_pad": 300, "spe_ref_pad_16k": 600}.get(collate)
    if collate == "bss":
        port_fn, jax_fn = loader.collate_bss_eval, jloader.collate_bss_eval
    else:
        kw = {} if ref_pad is None else dict(ref_pad_to=ref_pad)
        if collate.endswith("16k"):
            kw.update(resample_ref_to=16000, sample_rate=8000)
        port_fn, jax_fn = loader.make_collate_spe_eval(**kw), jloader.make_collate_spe_eval(**kw)
    for shuffle in (True, False):
        kw = dict(shuffle=shuffle, seed=4, n_buckets=3, multiple=100, max_len=700)
        got = loader.VarLenTrainLoader(ds, 2, port_fn, ds.lengths(), prefetch=2, **kw)
        want = jloader.VarLenTrainLoader(ds, 2, jax_fn, ds.lengths(), prefetch=0, **kw)
        assert got.bounds == want.bounds
        for epoch in (0, 1):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            plan = got.batch_plan()
            assert [(b, i.tolist()) for b, i in plan] == \
                [(b, i.tolist()) for b, i in want._batch_plan()]
            assert len(got) == len(want) == len(plan) > 2
            pairs = [(got.peek(), want.peek())]
            got.set_epoch(epoch)
            pairs += list(zip(got, want, strict=True))
            for g, w in pairs:
                assert set(g) == set(w)
                for k in w:
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                assert g["lengths"].max() <= 700
                if ref_pad is not None:
                    assert g["reference"].shape[1] == ref_pad >= g["ref_len"].max()


# -------------------------------------------------------------- recurrence

@pytest.mark.parametrize("D,q", [(1, 3), (1, 4), (2, 3), (2, 4)])
def test_segment_recurrence_matches_jax(rng, interpret, monkeypatch, D, q):
    """T = 10, which neither q divides. D = 1: the unidirectional scan; D =
    2: the bidirectional pair with ragged lengths (0 and T among them),
    which under lstm_save_every leaves the fused pair for the stacked scan
    over [x, masked_flip(x)]."""
    import jax
    import jax.numpy as jnp

    from tss_dprnn_tpu.ops import rnn as jrnn

    R, T, F, H = 4, 10, 6, 5
    x = rng.standard_normal((R, T, F)).astype(np.float32)
    w_ih = (0.4 * rng.standard_normal((D, F, 4 * H))).astype(np.float32)
    b = (0.2 * rng.standard_normal((D, 4 * H))).astype(np.float32)
    w_hh = (0.4 * rng.standard_normal((D, H, 4 * H))).astype(np.float32)
    g = rng.standard_normal((D, R, T, H)).astype(np.float32)
    lengths = np.array([10, 7, 0, 4], np.int32) if D == 2 else None

    def jax_loss(x, w_ih, b, w_hh):
        dirs = [jrnn.LSTMWeights(w_ih[d], w_hh[d], b[d]) for d in range(D)]
        with jrnn.lstm_backend("pallas"), jrnn.lstm_save_every(q):
            if D == 1:
                outs = [jrnn.lstm(x, dirs[0])]
            else:
                outs = jrnn.lstm_pair(x, *dirs, lengths=jnp.asarray(lengths))
        h = jnp.stack(outs)
        return jnp.sum(h * g), h

    with jrnn.lstm_backend("pallas"):  # _recurrence's backward reads the backend when traced
        (_, want_h), want = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(
            x, w_ih, b, w_hh)

    calls = []
    real = rnn.lstm_forward_with_cs
    monkeypatch.setattr(rnn, "lstm_forward_with_cs",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    for other in ("LSTMStack", "BiLSTM2", "BiLSTM2Masked"):
        monkeypatch.setattr(getattr(rnn, other), "apply", None)  # must not run
    ts = [torch.tensor(a, requires_grad=True) for a in (x, w_ih, b, w_hh)]
    with rnn.lstm_save_every(q):
        if D == 1:
            h = rnn.lstm_stack(ts[0][None], tuple(ts[1:]))
        else:
            h = torch.stack(rnn.lstm_pair(ts[0], tuple(ts[1:]), torch.from_numpy(lengths)))
    (h * torch.from_numpy(g)).sum().backward()
    assert calls == [(D, R, T, F)]
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h), atol=1e-6, rtol=0)
    for name, t, w in zip(("dx", "dW_ih", "db", "dW_hh"), ts, want):
        assert _snr_db(t.grad.numpy(), np.asarray(w)) >= 60, name


def test_save_every_one_and_no_grad_keep_the_kernels(monkeypatch):
    """q = 1 leaves the routing as it was, and without autograd the policy
    changes nothing: the inference kernels run."""
    monkeypatch.setattr(rnn.LSTMSegments, "apply", None)  # must not run
    x = torch.randn(3, 6, 4)
    stacked = tuple(torch.randn(*s) for s in ((2, 4, 12), (2, 12), (2, 3, 12)))
    with rnn.lstm_save_every(1):
        want = rnn.lstm_pair(x.requires_grad_(), stacked)
    with rnn.lstm_save_every(4), torch.no_grad():
        got = rnn.lstm_pair(x, stacked)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b.detach(), atol=0, rtol=0)


def test_ignore_lengths_reaches_only_the_lstm():
    """Under lstm_ignore_lengths the LSTM pair scans every row to its end;
    the GRU does not read it (JAX ops/rnn.py:782-838)."""
    x = torch.randn(3, 6, 4)
    lengths = torch.tensor([6, 3, 1])
    stacked = tuple(torch.randn(*s) for s in ((2, 4, 12), (2, 12), (2, 3, 12)))
    cells = [tuple(torch.randn(*s) for s in ((4, 9), (3, 9), (9,), (9,))) for _ in range(2)]
    with rnn.lstm_ignore_lengths(True):
        lstm_on = rnn.lstm_pair(x, stacked, lengths)
        gru_on = rnn.gru(x, *cells, lengths)
    for a, b in zip(lstm_on, rnn.lstm_pair(x, stacked)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    torch.testing.assert_close(gru_on, rnn.gru(x, *cells, lengths), atol=0, rtol=0)
    assert not torch.equal(gru_on, rnn.gru(x, *cells))


# ------------------------------------------------------- trainer steps vs JAX

def _bss_batch(seed):
    ds = _Ragged(seed, [160, 117, 71, 133], spe=False)
    batch = loader.collate_bss_eval(ds.items, 160)
    batch["lengths"] = np.array(ds.lengths(), np.int32)
    return batch


def _spe_batch(seed):
    ds = _Ragged(seed, [160, 117, 71, 133], spe=True)
    batch = loader.make_collate_spe_eval(ref_pad_to=300)(ds.items, 160)
    batch["lengths"] = np.array(ds.lengths(), np.int32)
    return batch


def _assert_step(tr, batch, want_loss, start, want_grads, want_after, settle):
    step_loss, _ = tr.train_step(batch)
    np.testing.assert_allclose(step_loss.item(), float(want_loss), rtol=1e-5)
    got_after = tr.model.state_dict()
    for k, w in want_after.items():
        if k.endswith("num_batches_tracked"):
            continue
        if not settle:
            torch.testing.assert_close(got_after[k], w, atol=1e-6, rtol=0, msg=k)
            continue
        clip = min(1.0, 5.0 / sum(float(g.pow(2).sum()) for g in want_grads.values()) ** 0.5)
        # as test_bss_trainer_step_matches_jax: where the clipped, decayed
        # gradient all but cancels, Adam's first update is the gradients'
        # rounding, up to 2 lr
        settled = (clip * want_grads[k] + 1e-2 * start[k]).abs() >= 1e-6
        assert settled.float().mean() > 0.99, k
        torch.testing.assert_close(got_after[k][settled], w[settled], atol=1e-6, rtol=0, msg=k)
        torch.testing.assert_close(got_after[k], w, atol=2e-3, rtol=0, msg=k)


def test_varlen_bss_step_matches_jax(tmp_path):
    """The causal DPRNN-TasNet of configs/train_bss.yaml: the JAX trainer's
    loss on the batch's true lengths on its default lane (jitted: this model
    has no speaker encoder, whose max-pool ties make only eager JAX a tight
    reference, test_torch_port_training.py), then its optimizer; the port's
    whole train_step. (The masked training pair of
    the bidirectional scan is the TSS step's.)"""
    import jax
    import jax.numpy as jnp

    from tss_dprnn_tpu.models import DPRNNTasNet as JaxDPRNNTasNet
    from tss_dprnn_tpu.training.train_state import TrainState, make_optimizer
    from tss_dprnn_tpu.training.trainer import Trainer as JaxTrainer

    cfg = dict(SMALL, bidirectional=False)
    batch = _bss_batch(1)
    jmodel = JaxDPRNNTasNet(**cfg)
    jtrainer = JaxTrainer(jmodel, dict(CONFIG, new_checkpoints_path=str(tmp_path / "j")))
    tx = make_optimizer(1e-3, 1e-2, 5.0)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch["mix"][:1])["params"]
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=tx.init(params), tx=tx)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtrainer._forward_loss({"params": p}, jbatch, train=True)[0]))(state.params)
    new_state = state.apply_gradients(grads)
    start, want_grads, want_after = (
        state_dict_from_jax(_numpy_tree({"params": p}), "ln", 2)
        for p in (state.params, grads, new_state.params))

    model = DPRNNTasNet(**cfg)
    model.load_state_dict(start, strict=True)
    tr = Trainer(model, dict(CONFIG, new_checkpoints_path=str(tmp_path / "p")), device="cpu")
    _assert_step(tr, batch, want_loss, start, want_grads, want_after, settle=True)


def test_varlen_trainer_spe_step_matches_jax(tmp_path, interpret):
    """The JAX TrainerSpe's loss on the batch's true lengths (its Pallas
    lane in interpret mode, the masked training pair), eagerly, then its
    optimizer and the BatchNorm statistics; the port's whole train_step."""
    import jax
    import jax.numpy as jnp

    from tss_dprnn_tpu.models import DPRNNSpeTasNet as JaxDPRNNSpeTasNet
    from tss_dprnn_tpu.ops import rnn as jrnn
    from tss_dprnn_tpu.training.train_state import TrainState, make_optimizer
    from tss_dprnn_tpu.training.trainer_spe import TrainerSpe as JaxTrainerSpe

    batch = _spe_batch(2)
    config = dict(CONFIG, lstm_backend="pallas")
    jmodel = JaxDPRNNSpeTasNet(**SPE)
    jtrainer = JaxTrainerSpe(jmodel, dict(config, new_checkpoints_path=str(tmp_path / "j")))
    tx = make_optimizer(1e-3, 1e-2, 5.0)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch["mix"][:1],
                                     batch["reference"][:1], batch["ref_len"][:1])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), tx=tx)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        with jrnn.lstm_backend("pallas"):
            loss, new_bs, _ = jtrainer._forward_loss(
                {"params": params, "batch_stats": state.batch_stats}, jbatch, train=True)
        return loss, new_bs

    with jrnn.lstm_backend("pallas"):
        (want_loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    new_state = state.apply_gradients(grads)

    def port_tree(params, stats):
        return state_dict_from_jax(_numpy_tree({"params": params, "batch_stats": stats}),
                                   "ln", 2, "att")

    start = port_tree(state.params, state.batch_stats)
    want_grads = port_tree(grads, state.batch_stats)
    want_after = port_tree(new_state.params, new_bs)
    model = DPRNNSpeTasNet(**SPE)
    model.load_state_dict(start, strict=True)
    tr = TrainerSpe(model, dict(config, new_checkpoints_path=str(tmp_path / "p")), device="cpu")
    _assert_step(tr, batch, want_loss, start, want_grads, want_after, settle=False)


# ------------------------------------------------------------ port invariants

def _step(kind, batch, **over):
    if kind == "bss":
        model, cls = DPRNNTasNet(**SMALL), Trainer
    else:
        model, cls = DPRNNSpeTasNet(**SPE), TrainerSpe
    init_weights_(model, torch.Generator().manual_seed(3))
    tr = cls(model, dict(CONFIG, new_checkpoints_path="unused", **over), device="cpu")
    loss, _ = tr.train_step(batch)
    return loss.item(), {k: v.clone() for k, v in tr.model.state_dict().items()}


def _garbage(batch, rng, keys):
    """The batch with large values past each row's length in ``keys``."""
    out = dict(batch)
    T = batch["mix"].shape[-1]
    past = np.arange(T)[None, :] >= batch["lengths"][:, None]
    for k in keys:
        noise = (37.0 * rng.standard_normal(batch[k].shape)).astype(np.float32)
        mask = past if batch[k].ndim == 2 else past[:, None, :]
        out[k] = np.where(mask, noise, batch[k])
    return out


@pytest.mark.parametrize("kind", ["bss", "spe"])
@pytest.mark.parametrize("save_every", [1, 3])
def test_varlen_step_ignores_padding(rng, kind, save_every):
    """Garbage past the lengths (mixture and targets) moves neither the loss
    nor the parameters after the step (JAX: rtol 1e-5, params rtol 1e-4
    atol 1e-6), on the masked kernels and under lstm_save_every."""
    batch = _bss_batch(5) if kind == "bss" else _spe_batch(5)
    keys = ("mix", "sources") if kind == "bss" else ("mix", "target")
    l1, p1 = _step(kind, batch, lstm_save_every=save_every)
    l2, p2 = _step(kind, _garbage(batch, rng, keys), lstm_save_every=save_every)
    assert np.isfinite(l1)
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
    for k in p1:
        torch.testing.assert_close(p2[k], p1[k], rtol=1e-4, atol=1e-6, msg=k)


@pytest.mark.parametrize("kind", ["bss", "spe"])
def test_varlen_full_lengths_equal_fixed_batch(kind):
    """Every row at full length: the step equals the step without lengths
    (JAX: loss rtol 1e-4, params rtol 5e-3 atol 5e-4; the masked norms
    reduce in another order)."""
    batch = _bss_batch(6) if kind == "bss" else _spe_batch(6)
    batch["lengths"] = np.full_like(batch["lengths"], batch["mix"].shape[1])
    fixed = {k: v for k, v in batch.items() if k != "lengths"}
    l1, p1 = _step(kind, fixed)
    l2, p2 = _step(kind, batch)
    np.testing.assert_allclose(l2, l1, rtol=1e-4)
    for k in p1:
        torch.testing.assert_close(p2[k].float(), p1[k].float(), rtol=5e-3, atol=5e-4, msg=k)
