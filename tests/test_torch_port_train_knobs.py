"""The JAX trainer's knobs in the port's trainers, on the CPU at small
widths, against the JAX package.

- ``accum_steps``: a BSS step with 2 micro-batches equals the whole-batch
  step (1e-5, as ``tests/test_grad_accum.py`` holds JAX); a TSS step with 2
  equals the JAX trainer's own jitted step with 2 (loss 1e-5 relative,
  parameters and BatchNorm's running statistics within 1e-6: only the last
  micro-batch's statistics count, once).
- ``schedule_masks``: a step equals the JAX trainer's with the pragma (all
  rows full-length, the scans unmasked) and, within 1e-4, the step without
  it; with lengths in the batch it turns itself off.
- ``is_metrics``: the epoch's host metrics equal JAX ``_accumulate_metrics``
  on the same estimates (SI-SDR 1e-4 dB, STOI 1e-6, PESQ 1e-4 MOS), and the
  combination with ``accum_steps > 1``, which fails in JAX, is refused.
- ``cli.train --set data.variable_length=true`` runs one epoch for
  ``tss_spe``, ``tss_rawnet`` and ``bss`` on a corpus frozen with
  ``segment: null`` and writes a checkpoint.
- ``cuda`` cases (skipped without a card; ``python -m pytest --noconftest
  -m cuda tests/test_torch_port_train_knobs.py``): the three kernel modes
  that variable-length training and ``lstm_save_every`` launch, against
  their plain versions at small variable-length shapes, and a
  variable-length TSS step card vs CPU with its launches.

JAX is imported inside the tests.
"""

import json
import logging

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch.data import loader
from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet, DPRNNTasNet
from tss_dprnn_tpu_torch.ops import bilstm2, lstm as lstm_ops, rnn
from tss_dprnn_tpu_torch.training import Trainer, TrainerSpe
from tss_dprnn_tpu_torch.utils.weights import init_weights_, state_dict_from_jax

SMALL = dict(input_size=8, feature_size=16, hidden_size=16, chunk_length=8, kernel_size=2,
             hop_length=4, n_repeats=1, norm_type="ln", activation_type="sigmoid")
SPE = dict(SMALL, O=8, P=12, embeddings_size=8, num_spks=5, fusion_type="att")
CONFIG = {"optimizer": {"lr": 1e-3, "weight_decay": 1e-2}, "clip_norm": 5, "ce_gamma": 0.5,
          "print_freq": 1}
# host metric agreement, port vs JAX on the same estimates (the test CLI's row bars)
METRIC_TOL = {"si_sdr": 1e-4, "stoi": 1e-6, "pesq": 1e-4}


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
    import functools

    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _numpy_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _bss_batch(rng, B=4, T=160):
    sources = rng.standard_normal((B, 2, T)).astype(np.float32)
    return {"mix": sources.sum(1), "sources": sources}


def _spe_batch(rng, B=4, T=160, ref=200):
    """Fixed crops; every reference the batch's full width, so no padded
    reference frame feeds the speaker encoder's max pools."""
    target = rng.standard_normal((B, T)).astype(np.float32)
    return {"mix": target + rng.standard_normal((B, T)).astype(np.float32), "target": target,
            "reference": rng.standard_normal((B, ref)).astype(np.float32),
            "ref_len": np.full(B, ref, np.float32),
            "spk_idx": rng.integers(0, 5, B).astype(np.int32)}


def _trainer(kind, seed=3, **over):
    model = DPRNNTasNet(**SMALL) if kind == "bss" else DPRNNSpeTasNet(**SPE)
    init_weights_(model, torch.Generator().manual_seed(seed))
    cls = Trainer if kind == "bss" else TrainerSpe
    return cls(model, dict(CONFIG, new_checkpoints_path="unused", **over), device="cpu")


def _step(kind, batch, seed=3, **over):
    tr = _trainer(kind, seed, **over)
    loss, _ = tr.train_step(batch)
    return loss.item(), {k: v.clone() for k, v in tr.model.state_dict().items()}


def jax_train_step(jax_trainer_cls, jmodel, config, batch, tmp_path):
    """The JAX trainer's own jitted train step (``_train_step``) from
    JAX-initialised weights: (loss, the start and the result as the port's
    state_dict)."""
    import jax
    import jax.numpy as jnp

    from tss_dprnn_tpu.parallel import make_mesh
    from tss_dprnn_tpu.training.train_state import TrainState, make_optimizer

    jtrainer = jax_trainer_cls(jmodel, dict(config, new_checkpoints_path=str(tmp_path / "j")))
    opt = config["optimizer"]
    tx = make_optimizer(opt["lr"], opt["weight_decay"], float(config["clip_norm"]))
    args = [batch["mix"][:1]]
    if "reference" in batch:
        args += [batch["reference"][:1], batch["ref_len"][:1]]
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *args)
    stats = variables.get("batch_stats", {})
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=stats, opt_state=tx.init(variables["params"]), tx=tx)
    jtrainer.mesh = make_mesh(data=1)
    jtrainer._varlen = "lengths" in batch
    jtrainer._build_steps()
    spe = "reference" in batch

    def port_tree(s):
        tree = {"params": s.params, **({"batch_stats": s.batch_stats} if spe else {})}
        return state_dict_from_jax(_numpy_tree(tree), "ln", 2, *(["att"] if spe else []))

    start = port_tree(state)  # the step donates its state
    new, loss, _ = jtrainer._train_step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), start, port_tree(new)


def _port_step_from(kind, start, batch, **over):
    model = DPRNNTasNet(**SMALL) if kind == "bss" else DPRNNSpeTasNet(**SPE)
    model.load_state_dict(start, strict=True)
    cls = Trainer if kind == "bss" else TrainerSpe
    tr = cls(model, dict(CONFIG, new_checkpoints_path="unused", **over), device="cpu")
    loss, _ = tr.train_step(batch)
    return loss.item(), tr.model.state_dict()


# -------------------------------------------------------------- accum_steps

def test_accum_steps_bss_equals_full_batch(rng):
    """accum_steps=2 (4 rows, causal and bidirectional) equals one step on
    the whole batch, as tests/test_grad_accum.py holds JAX; a batch that
    does not divide is refused."""
    batch = _bss_batch(rng)
    for bidirectional in (False, True):
        SMALL["bidirectional"] = bidirectional
        try:
            l1, p1 = _step("bss", batch)
            l2, p2 = _step("bss", batch, accum_steps=2)
        finally:
            del SMALL["bidirectional"]
        np.testing.assert_allclose(l2, l1, rtol=1e-5)
        for k in p1:
            torch.testing.assert_close(p2[k], p1[k], atol=1e-5, rtol=1e-5, msg=k)
    with pytest.raises(ValueError, match="does not divide by accum_steps 3"):
        _trainer("bss", accum_steps=3).train_step(batch)


def test_accum_steps_tss_matches_jax(rng, tmp_path, interpret):
    """accum_steps=2 on 4 rows: the JAX trainer's own jitted step (its
    Pallas lane in interpret mode; every reference unpadded, so jitted JAX
    is a tight reference here) and the port's: the loss, every parameter
    and BatchNorm's running statistics (the last micro-batch's statistics
    applied once to those of before the step, trainer.py:302)."""
    from tss_dprnn_tpu.models import DPRNNSpeTasNet as JaxDPRNNSpeTasNet
    from tss_dprnn_tpu.training.trainer_spe import TrainerSpe as JaxTrainerSpe

    batch = _spe_batch(rng)
    config = dict(CONFIG, accum_steps=2, lstm_backend="pallas")
    want_loss, start, want = jax_train_step(JaxTrainerSpe, JaxDPRNNSpeTasNet(**SPE), config,
                                            batch, tmp_path)
    loss, got = _port_step_from("spe", start, batch, accum_steps=2)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(start[k]) + 1, k  # one update per step
            continue
        torch.testing.assert_close(got[k], w, atol=1e-6, rtol=0, msg=k)
    # the whole batch's statistics would differ: the test sees the rule
    _, whole = _port_step_from("spe", start, batch)
    assert any(not torch.allclose(whole[k], got[k], atol=1e-6, rtol=0) for k in stats)


# ----------------------------------------------------------- schedule_masks

def test_schedule_masks_matches_jax(rng, tmp_path, monkeypatch):
    """Bidirectional BSS: the JAX trainer's jitted step with the pragma and
    the port's (loss 1e-5 relative, parameters within 1e-5); the port's
    scans run unmasked (the masked Function never runs) and the step is
    value-neutral against the one without the pragma (1e-4 relative)."""
    from tss_dprnn_tpu.models import DPRNNTasNet as JaxDPRNNTasNet
    from tss_dprnn_tpu.training.trainer import Trainer as JaxTrainer

    batch = _bss_batch(rng)
    SMALL["bidirectional"] = True
    try:
        config = dict(CONFIG, schedule_masks=True)
        want_loss, start, want = jax_train_step(JaxTrainer, JaxDPRNNTasNet(**SMALL), config,
                                                batch, tmp_path)
        seen = []
        real = Trainer._forward_loss
        monkeypatch.setattr(Trainer, "_forward_loss",
                            lambda self, b, train: seen.append(self._lengths_for(b)[0])
                            or real(self, b, train))
        monkeypatch.setattr(rnn.BiLSTM2Masked, "apply", None)  # must not run
        loss, got = _port_step_from("bss", start, batch, schedule_masks=True)
        monkeypatch.undo()
        plain_loss, _ = _port_step_from("bss", start, batch)
    finally:
        del SMALL["bidirectional"]
    assert seen[0].tolist() == [160] * 4 and seen[0].dtype == torch.int32
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(plain_loss, loss, rtol=1e-4)
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, atol=1e-5, rtol=0, msg=k)


def test_schedule_masks_turns_off_with_lengths(rng, caplog):
    """With lengths in the batch the pragma is off for the run (JAX's log
    line): the masked scans run and garbage past the lengths changes
    nothing."""
    batch = _spe_batch(rng)
    batch["lengths"] = np.array([160, 111, 70, 133], np.int32)
    garbage = dict(batch, mix=np.where(np.arange(160)[None] < batch["lengths"][:, None],
                                       batch["mix"], 55.0).astype(np.float32))
    before = bilstm2.bilstm2_forward_resid_masked.launches
    with caplog.at_level(logging.INFO):
        tr = _trainer("spe", schedule_masks=True)
        l1, _ = tr.train_step(batch)
    assert tr._varlen and "schedule_masks disabled" in caplog.text
    l2, _ = _trainer("spe", schedule_masks=True).train_step(garbage)
    np.testing.assert_allclose(l2.item(), l1.item(), rtol=1e-5)
    assert bilstm2.bilstm2_forward_resid_masked.launches == before  # CPU: the plain versions


# --------------------------------------------------------------- is_metrics

class _Records:
    """A reporter that keeps what it is given."""

    def __init__(self):
        self.logs = []

    def add_and_report(self, logs=None, mode="train"):
        self.logs.append((mode, logs))


@pytest.mark.parametrize("kind", ["bss", "spe"])
def test_is_metrics_summary_matches_jax(rng, tmp_path, kind):
    """One epoch of two batches of 1 s crops: the metrics that the train and
    the eval epoch report (as in JAX, the eval epoch reports the train
    epoch's) equal the JAX trainer's ``_accumulate_metrics`` over the same
    batches and the estimates the port's steps returned."""
    from tss_dprnn_tpu.training.trainer import Trainer as JaxTrainer

    T = 8000
    batches = [_bss_batch(rng, B=2, T=T) if kind == "bss" else _spe_batch(rng, B=2, T=T)
               for _ in range(2)]
    tr = _trainer(kind, is_metrics=True)
    tr.reporter = _Records()
    ests = []
    real = tr.train_step

    def train_step(batch):
        loss, aux = real(batch)
        ests.append(aux["est"].numpy())
        return loss, aux

    tr.train_step = train_step
    tr.train(batches)
    tr.eval(batches)
    (m_train, train_logs), (m_eval, eval_logs) = tr.reporter.logs
    assert (m_train, m_eval) == ("train", "eval")
    assert eval_logs["metrics"] == train_logs["metrics"]

    jtr = JaxTrainer(None, {"is_metrics": True, "new_checkpoints_path": str(tmp_path)})
    jtr._metric_sums, jtr._metric_cnt = {}, 0
    for batch, est in zip(batches, ests):
        jtr._accumulate_metrics(batch, {"est": est})
    want = {k: v / jtr._metric_cnt for k, v in jtr._metric_sums.items()}
    got = train_logs["metrics"]
    assert set(got) == set(want) == set(METRIC_TOL)
    for k, tol in METRIC_TOL.items():
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


def test_is_metrics_with_accum_steps_refused():
    """The JAX trainer scores the whole batch against the last micro-batch's
    estimates and raises IndexError; the port refuses the pair."""
    with pytest.raises(ValueError, match="is_metrics with accum_steps > 1"):
        _trainer("bss", is_metrics=True, accum_steps=2)


# ------------------------------------------------------------------------ CLI

TINY = dict(input_size=8, feature_size=12, hidden_size=10, chunk_length=40, kernel_size=2,
            hop_length=20, n_repeats=1, norm_type="ln")
MODELS = {
    "bss": dict(TINY, target="dprnn_tasnet"),
    "tss_spe": dict(TINY, target="dprnn_spe_tasnet", O=8, P=12, embeddings_size=8, num_spks=8,
                    fusion_type="att"),
    "tss_rawnet": dict(TINY, target="dprnn_rawnet_tasnet", O=8, P=12, embeddings_size=8,
                       num_spks=8, fusion_type="att", rawnet_C=32, rawnet_scale=4,
                       rawnet_sinc_stride=16),
}


def _block_yaml(cfg, indent=""):
    """A nested dict of scalars in block style, which the port's reader takes."""
    lines = []
    for k, v in cfg.items():
        if isinstance(v, dict):
            lines.append(f"{indent}{k}:\n{_block_yaml(v, indent + '  ')}")
        else:
            lines.append(f"{indent}{k}: {json.dumps(v)}")
    return "\n".join(lines) + ("\n" if not indent else "")


@pytest.fixture(scope="module")
def varlen_corpus(tmp_path_factory):
    """A small LibriMix corpus of 0.8-2 s mixtures, its manifests frozen by
    the port's generate_manifests with ``segment: null``."""
    from tests.fixtures import make_mini_librimix
    from tss_dprnn_tpu_torch.cli import generate_manifests

    tmp = tmp_path_factory.mktemp("varlen")
    csv = make_mini_librimix(str(tmp / "wavs"), n_mix=10, min_sec=0.8, max_sec=2.0)
    out = {s: str(tmp / "m" / f"{s}.json") for s in ("train", "eval", "test")}
    gen = tmp / "gen.yaml"
    gen.write_text("\n".join([
        "dataset_type: librimix_spe", "sample_rate: 8000", "n_src: 2", "segment: null",
        "seed: 0", f"train_path: {csv}", f"eval_path: {csv}", f"test_path: {csv}",
        *(f"{s}_out: {p}" for s, p in out.items())]) + "\n")
    generate_manifests.main(["--config", str(gen)])
    return tmp, out


@pytest.mark.parametrize("mode", ["tss_spe", "tss_rawnet", "bss"])
def test_cli_train_variable_length(varlen_corpus, mode, monkeypatch):
    """One epoch of ``cli.train --set data.variable_length=true`` on the CPU:
    every batch carries lengths within its bucket (rows capped at
    ``data.max_segment``), a TSS run's references share one width (16 kHz
    for tss_rawnet), and a checkpoint is written."""
    from tss_dprnn_tpu_torch.cli import train as train_cli

    tmp, manifests = varlen_corpus
    seen = []
    real = Trainer.train_step
    monkeypatch.setattr(Trainer, "train_step", lambda self, b: seen.append(b) or real(self, b))
    cfg = {
        "name": "v", "is_test": False,
        "data": {"use_generated_train": manifests["train"],
                 "use_generated_eval": manifests["eval"], "batch_size": 2,
                 "sample_rate": 8000, "seed": 0},
        "model": MODELS[mode], "optimizer": {"lr": 1e-3, "weight_decay": 1e-5},
        "lr_scheduler": {"patience": 2, "factor": 0.5, "decay_rate": None},
        "logs": {"metadata": {"ids": []}}, "print_freq": 100, "clip_norm": 5, "epochs": 1,
        "early_stop": 10, "ce_gamma": 0.5, "checkpoint_path": None, "n_checkpoints": 5,
        "new_checkpoints_path": str(tmp / f"ck_{mode}")}
    path = tmp / f"train_{mode}.yaml"
    path.write_text(_block_yaml(cfg))
    train_cli.main(["--config", str(path), "--mode", mode, "--device", "cpu", "--set",
                    "data.variable_length=true", "data.n_buckets=2", "data.max_segment=1.6"])
    assert seen and all("lengths" in b for b in seen)
    for b in seen:
        assert b["lengths"].max() <= min(b["mix"].shape[1], 12800)
    if mode != "bss":
        widths = {b["reference"].shape[1] for b in seen}
        assert len(widths) == 1 and widths.pop() % 2000 == 0
    assert (tmp / f"ck_{mode}" / "1_last").exists()


# ---------------------------------------------------------------- the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _weights(g, D, F, H, dev):
    return [(s * torch.randn(*shape, generator=g)).to(dev)
            for s, shape in ((0.3, (D, F, 4 * H)), (0.1, (D, 4 * H)), (0.3, (D, H, 4 * H)))]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["resid_masked", "backward_masked", "with_cs"])
def test_training_modes_on_card(mode):
    """The inter scans of a variable-length step (R = B K rows over a
    bucket's chunk count, lengths 0 and T among them) and the want_cs
    forward at D = 2, against their plain versions: 1e-4 on the outputs and
    streams, dx 1e-4, dW and db within 1e-4 of their max."""
    _needs_card()
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    if mode == "with_cs":
        x = torch.randn(2, 40, 23, 32, generator=g).to(dev)
        w = _weights(g, 2, 32, 32, dev)
        before = lstm_ops.lstm_forward_with_cs.launches
        h, cs = lstm_ops.lstm_forward_with_cs(x, *w)
        assert lstm_ops.lstm_forward_with_cs.launches == before + 1
        want_h, want_cs = lstm_ops.lstm_cs_reference(x, *w)
        torch.testing.assert_close(h, want_h, atol=1e-4, rtol=0)
        torch.testing.assert_close(cs, want_cs, atol=1e-4, rtol=0)
        return
    R, T, F, H = 40, 23, 32, 32
    x = torch.randn(R, T, F, generator=g).to(dev)
    w = _weights(g, 2, F, H, dev)
    lens = torch.randint(1, T + 1, (R,), generator=g, dtype=torch.int32)
    lens[::5], lens[1::7] = 0, T
    lens = lens.to(dev)
    valid = torch.arange(T, device=dev)[None, :] < lens[:, None]
    outs, resid = bilstm2.bilstm2_forward_resid_masked(x, lens, *w)
    want_outs, want_resid = bilstm2.bilstm2_resid_reference(x, *w, lens)
    if mode == "resid_masked":
        torch.testing.assert_close(outs[1], want_outs[1], atol=1e-4, rtol=0)
        torch.testing.assert_close(outs[0][valid], want_outs[0][valid], atol=1e-4, rtol=0)
        for a, b in zip(resid, want_resid):
            torch.testing.assert_close(a[valid], b[valid], atol=1e-4, rtol=0)
        return
    g0, g1 = (torch.randn(R, T, H, generator=g).to(dev) * valid[..., None] for _ in range(2))
    before = bilstm2.bilstm2_backward_masked.launches
    got = bilstm2.bilstm2_backward_masked(x, resid, g0, g1, *w, lens)
    assert bilstm2.bilstm2_backward_masked.launches == before + 1
    want = bilstm2.bilstm2_backward_reference(x, want_resid, g0, g1, *w, lens)
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("save_every", [1, 3])
def test_varlen_tss_step_on_card(save_every):
    """A variable-length TrainerSpe step of one block on the card against
    the CPU (loss 1e-4 relative, gradients >= 40 dB). save_every 1: the
    intra scan through the unmasked training pair, the inter scan through
    the masked one (one launch each); save_every 3: both scans through the
    want_cs forward (2 launches) and no pair."""
    _needs_card()
    rng = np.random.default_rng(1)
    batch = _spe_batch(rng)
    batch["lengths"] = np.array([160, 111, 70, 133], np.int32)
    grads, losses = {}, {}
    for dev in ("cuda", "cpu"):
        model = init_weights_(DPRNNSpeTasNet(**SPE), torch.Generator().manual_seed(3))
        tr = TrainerSpe(model, dict(CONFIG, lstm_save_every=save_every,
                                    new_checkpoints_path="unused"), device=dev)
        bilstm2.reset_launch_counts()
        lstm_ops.reset_launch_counts()
        tr.model.train()
        with tr._scans(train=True):
            loss, _ = tr._forward_loss(tr._to_device(batch), train=True)
            loss.backward()
        losses[dev] = loss.item()
        grads[dev] = torch.cat([p.grad.flatten().cpu() for p in tr.model.parameters()])
        if dev == "cuda":
            counts = {e.__name__: e.launches for e in (*bilstm2.ENTRIES, *lstm_ops.ENTRIES)
                      if e.launches}
            want = ({"bilstm2_forward_resid": 1, "bilstm2_backward": 1,
                     "bilstm2_forward_resid_masked": 1, "bilstm2_backward_masked": 1}
                    if save_every == 1 else {"lstm_forward_with_cs": 2})
            assert counts == want
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    err = (grads["cuda"] - grads["cpu"]).double()
    assert 10 * torch.log10(grads["cpu"].double().pow(2).sum() / err.pow(2).sum()) >= 40
