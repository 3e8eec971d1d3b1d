"""``lstm_save_every`` in the bf16 lane, on the CPU, against the JAX package's
Pallas entries in interpret mode.

- The plain version of the bf16 ``want_cs`` mode (``lstm_cs_reference`` on
  bf16 inputs, the kernel's contract on the card) against JAX's
  ``lstm_forward_with_cs``: h (bf16, fed back rounded) within CS_H_ATOL and
  the fp32 cell state after every step within CS_ATOL.
- ``LSTMSegments`` on bf16 inputs (q = 3, T = 10, which q does not divide;
  D = 1 and 2) against ``jax.grad`` of ``_recurrence(3, ...)`` on the Pallas
  lane: h as above, and each gradient in its input's type (bf16) at
  SEGMENT_GRAD_SNR_DB.
- One bf16 ``TrainerSpe`` step under ``lstm_save_every=3`` against the JAX
  trainer's (jitted; bf16 on the Pallas lane, fp32 on its XLA lane), at the
  bars of tests/test_torch_port_bf16_training.py's
  ``test_train_step_bf16_matches_jax``: the loss within 1e-2 of JAX bf16's,
  the gradients' SNR against JAX fp32 no more than GRAD_SLACK_DB below JAX
  bf16's own.

Why the segment backward's gradients are held at an SNR and not bit for
bit: the port rounds where XLA rounds (on the CPU it reads JAX's gradients
exactly here), but another order of a gate's sum, or another exp or tanh,
can round one dpre to the neighbouring bf16 value; the bar is the bf16
training kernels' (``scripts/port/bf16_grad_floor.py``: over 12 seeds a
backward that rounds as the TPU kernel does reads at least 64.6 dB (dx) and
70.2 dB (dW) against it, one that does not round dpre at most 52.7 and 56.7
dB).

``lstm_cs_step_reference`` (the cell state recomputed step by step from a
launch's own h and c) holds JAX's cell state at fp32 rounding and tells a
bf16-rounded store from it. The ``cuda`` case holds the bf16 ``want_cs``
kernel against its plain version on the card, free-running and per step.
"""

import functools

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
except ImportError:  # the card's machine has no JAX: only the cuda case runs there
    jax = jnp = None

from tss_dprnn_tpu_torch.ops import bilstm2 as B
from tss_dprnn_tpu_torch.ops import lstm as L
from tss_dprnn_tpu_torch.ops import rnn

Q = 3
# h is bf16, fed back rounded: a gate summed in another order may round an h
# to its neighbour (2^-8 for |h| in [0.5, 1)), and the steps after it follow
CS_H_ATOL = 2.0 ** -7
CS_ATOL = 1e-6
# the card's bf16 want_cs cell state against its plain version, relative to
# max(1, |ref|): free-running (the two h sequences part where a bf16 h rounds
# the other way; a sound kernel read 2.9e-4 at the training shape), and per
# step from the kernel's own h and c (lstm_cs_step_reference: only the order
# of fp32 sums and exp/tanh differ). A store rounded to bf16 reads up to
# 2^-9 (1.95e-3) in either.
CS_FREE_RTOL = 1e-3
CS_STEP_RTOL = 1e-4
SEGMENT_GRAD_SNR_DB = 60.0
GRAD_SLACK_DB = 2.0


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


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _bf16(rng, shape, scale=1.0):
    """An array rounded to bf16: (torch bf16, JAX bf16)."""
    t = torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _case(rng, D, R, T, F=16, H=16):
    """bf16 x [D, R, T, F], weights (w_ih, b, w_hh) and a cotangent [D, R, T, H],
    each as (torch, JAX)."""
    x = _bf16(rng, (D, R, T, F))
    w = [_bf16(rng, s, k) for s, k in (((D, F, 4 * H), 0.3), ((D, 4 * H), 0.1),
                                       ((D, H, 4 * H), 0.3))]
    return x, w, _bf16(rng, (D, R, T, H))


def _tm(a):
    """JAX's time-major [T, D, R, H] -> the port's [D, R, T, H]."""
    return np.transpose(_f32(a), (1, 2, 0, 3))


@pytest.mark.parametrize("D,R,T", [(1, 9, 10), (2, 5, 7)])
def test_want_cs_bf16_plain_matches_pallas(rng, interpret, D, R, T):
    from tss_dprnn_tpu.ops import pallas_lstm

    (x, xj), w, _ = _case(rng, D, R, T)
    want_h, want_cs = pallas_lstm.lstm_forward_with_cs(xj, *(j for _, j in w))
    h, cs = L.lstm_cs_reference(x, *(t for t, _ in w))
    assert h.dtype == torch.bfloat16 and cs.dtype == torch.float32
    np.testing.assert_allclose(h.float().numpy(), _tm(want_h), atol=CS_H_ATOL, rtol=0)
    np.testing.assert_allclose(cs.numpy(), _tm(want_cs), atol=CS_ATOL, rtol=0)
    # the entry on a CPU tensor is the plain version
    eh, ecs = L.lstm_forward_with_cs(x, *(t for t, _ in w))
    assert torch.equal(eh, h) and torch.equal(ecs, cs)


def _rel(got, want):
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


@pytest.mark.parametrize("D,R,T", [(1, 9, 10), (2, 5, 7)])
def test_cs_step_reference_holds_each_store(rng, interpret, D, R, T):
    """lstm_cs_step_reference on JAX's lstm_forward_with_cs outputs gives
    their fp32 cell state within CS_STEP_RTOL; on a cell state stored rounded
    to bf16 (the fault it is there to catch) it reads more than ten times
    that."""
    from tss_dprnn_tpu.ops import pallas_lstm

    (x, xj), w, _ = _case(rng, D, R, T)
    want_h, want_cs = pallas_lstm.lstm_forward_with_cs(xj, *(j for _, j in w))
    h = torch.from_numpy(_tm(want_h).copy()).bfloat16()
    cs = torch.from_numpy(_tm(want_cs).copy())
    wt = [t for t, _ in w]
    assert _rel(L.lstm_cs_step_reference(x, *wt, h, cs), cs) <= CS_STEP_RTOL
    rounded = cs.bfloat16().float()
    assert _rel(L.lstm_cs_step_reference(x, *wt, h, rounded), rounded) > 10 * CS_STEP_RTOL


@pytest.mark.parametrize("D", [1, 2])
def test_segments_bf16_match_jax_grad(rng, interpret, monkeypatch, D):
    """LSTMSegments (q = 3 over T = 10) on bf16 leaves against jax.grad of
    _recurrence(3, ...) on the Pallas lane: h, then dx, dW_ih, db, dW_hh, each
    bf16."""
    from tss_dprnn_tpu.ops import rnn as jrnn

    R, T = 6, 10
    (x, xj), w, (g, gj) = _case(rng, D, R, T)
    wj = [j for _, j in w]

    def jax_loss(xv, w_ih, b, w_hh):
        hs = jrnn._recurrence(Q, xv, w_ih, b, w_hh)  # [T, D, R, H]
        return (jnp.sum(hs.astype(jnp.float32)
                        * jnp.transpose(gj, (2, 0, 1, 3)).astype(jnp.float32)), hs)

    with jrnn.lstm_backend("pallas"):  # _recurrence's backward reads the backend when traced
        (_, want_h), want = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3),
                                                       has_aux=True))(xj, *wj)
    calls = []
    real = rnn.lstm_forward_with_cs
    monkeypatch.setattr(rnn, "lstm_forward_with_cs",
                        lambda *a: calls.append(a[0].dtype) or real(*a))
    monkeypatch.setattr(rnn.LSTMStack, "apply", None)  # must not run
    leaves = [t.clone().requires_grad_() for t in (x, *(t for t, _ in w))]
    with rnn.lstm_save_every(Q):
        h = rnn.lstm_stack(leaves[0], tuple(leaves[1:]))
    (h.float() * g.float()).sum().backward()
    assert calls == [torch.bfloat16]
    np.testing.assert_allclose(h.detach().float().numpy(), _tm(want_h), atol=CS_H_ATOL, rtol=0)
    for name, leaf, ref in zip(("dx", "dw_ih", "db", "dw_hh"), leaves, want):
        assert leaf.grad.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16, name
        db = _snr_db(leaf.grad.float().numpy(), _f32(ref))
        assert db >= SEGMENT_GRAD_SNR_DB, (name, db)


SMALL = dict(input_size=8, feature_size=16, hidden_size=16, chunk_length=8, kernel_size=2,
             hop_length=4, n_repeats=1, norm_type="ln", activation_type="sigmoid")
SPE = dict(SMALL, O=8, P=12, embeddings_size=8, num_spks=5, fusion_type="att")
TRAIN_CONFIG = {"optimizer": {"lr": 1e-3, "weight_decay": 1e-2}, "clip_norm": 5,
                "ce_gamma": 0.5, "print_freq": 1, "lstm_save_every": Q}


def _flat(tree):
    return np.concatenate([np.asarray(v, np.float64).ravel() for _, v in sorted(tree.items())])


def test_train_step_bf16_save_every_matches_jax(interpret, tmp_path, monkeypatch):
    """One bf16 TrainerSpe step with lstm_save_every=3 (every scan through
    LSTMSegments, the pair as two stacked directions over [x, masked_flip(x)])
    against the JAX trainer's: the loss within 1e-2 of JAX bf16's, the
    gradients (every parameter, concatenated) against JAX fp32 no more than
    GRAD_SLACK_DB below JAX bf16's own SNR."""
    from tss_dprnn_tpu.models import DPRNNSpeTasNet as JaxSpe
    from tss_dprnn_tpu.ops import rnn as jrnn
    from tss_dprnn_tpu.training.trainer_spe import TrainerSpe as JaxTrainerSpe
    from tss_dprnn_tpu_torch.data import loader
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.training import TrainerSpe
    from tss_dprnn_tpu_torch.utils.weights import state_dict_from_jax

    rng = np.random.default_rng(31)
    batch = loader.collate_spe([(rng.standard_normal(240).astype(np.float32),
                                 rng.standard_normal(240).astype(np.float32),
                                 rng.standard_normal(200).astype(np.float32), i)
                                for i in range(2)])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodels = {"fp32": JaxSpe(**SPE), "bf16": JaxSpe(**SPE, dtype=jnp.bfloat16)}
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(jmodels["fp32"].init)(
        jax.random.PRNGKey(2), batch["mix"][:1], batch["reference"][:1], batch["ref_len"][:1])))
    jtrainers = {dt: JaxTrainerSpe(jm, dict(TRAIN_CONFIG, new_checkpoints_path=str(tmp_path / "j")))
                 for dt, jm in jmodels.items()}

    @jax.jit
    def steps(variables):  # the fp32 step on JAX's XLA lane, the bf16 one on its Pallas lane
        out = {}
        for dt, jtr in jtrainers.items():
            def loss_fn(params, jtr=jtr):
                return jtr._forward_loss({**variables, "params": params}, jbatch, train=True)[0]

            with jrnn.lstm_backend("pallas" if dt == "bf16" else "xla"), \
                    jrnn.lstm_save_every(Q):
                out[dt] = jax.value_and_grad(loss_fn)(variables["params"])
        return out

    want = steps(variables)
    kw = dict(norm_type="ln", kernel_size=2, fusion_type="att")
    grads = {dt: state_dict_from_jax(jax.tree_util.tree_map(np.asarray, {
        **variables, "params": g}), **kw) for dt, (_, g) in want.items()}
    names = [k for k in grads["fp32"] if k in dict(DPRNNSpeTasNet(**SPE).named_parameters())]
    ref32 = _flat({k: grads["fp32"][k] for k in names})
    jax_db = _snr_db(_flat({k: grads["bf16"][k] for k in names}), ref32)

    for other in ("LSTMStack", "BiLSTM2", "BiLSTM2Masked"):
        monkeypatch.setattr(getattr(rnn, other), "apply", None)  # must not run
    model = DPRNNSpeTasNet(**SPE, dtype=torch.bfloat16)
    model.load_state_dict(state_dict_from_jax(variables, **kw), strict=True)
    tr = TrainerSpe(model, dict(TRAIN_CONFIG, new_checkpoints_path=str(tmp_path / "p")),
                    device="cpu")
    tr.model.train()
    with tr._scans(train=True):
        loss, _ = tr._forward_loss(tr._to_device(batch), train=True)
    loss.backward()
    got = {k: p.grad for k, p in tr.model.named_parameters()}
    assert set(got) == set(names) and all(g.dtype == torch.float32 for g in got.values())
    port_db = _snr_db(_flat({k: got[k].numpy() for k in names}), ref32)
    print(f"lstm_save_every={Q}: gradient SNR against JAX fp32: port bf16 {port_db:.2f} dB, "
          f"JAX bf16 {jax_db:.2f} dB")
    np.testing.assert_allclose(loss.item(), float(want["bf16"][0]), rtol=1e-2)
    assert port_db >= jax_db - GRAD_SLACK_DB, (port_db, jax_db)


# ----------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("D,R,T,F,H", [(1, 2000, 21, 128, 128), (2, 37, 9, 128, 128),
                                       (2, 19, 11, 12, 10)])
def test_want_cs_bf16_kernel_on_card(D, R, T, F, H):
    """The bf16 want_cs mode (the bf16-operand input product, then the
    serving scan's cell-state mode) against its plain version on the card: h
    at a bf16 ulp and 70 dB, the fp32 cell state within CS_FREE_RTOL of
    max(1, |ref|) free-running and within CS_STEP_RTOL per step from the
    kernel's own h and c; bit for bit on a second call; h bit for bit bf16
    lstm_forward_resid's (the same product and arithmetic); one launch and D
    bf16 products per call; fp16 raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(D + R)
    k = H ** -0.5
    x = torch.randn(D, R, T, F, generator=gen).bfloat16().cuda()
    w = [((torch.rand(*s, generator=gen) * 2 - 1) * k).cuda()
         for s in ((D, F, 4 * H), (D, 4 * H), (D, H, 4 * H))]
    before = L.lstm_forward_with_cs.launches, B.product_launch_counts()["products_gemm_bf16"]
    h, cs = L.lstm_forward_with_cs(x, *w)
    assert (L.lstm_forward_with_cs.launches, B.product_launch_counts()["products_gemm_bf16"]) == (
        before[0] + 1, before[1] + D)
    assert h.dtype == torch.bfloat16 and cs.dtype == torch.float32
    h2, cs2 = L.lstm_forward_with_cs(x, *w)
    assert torch.equal(h, h2) and torch.equal(cs, cs2)
    assert torch.equal(h, L.lstm_forward_resid(x, *w)[0])
    launches = L.lstm_forward_with_cs.launches
    ph, pcs = L.lstm_cs_reference(x.cpu(), *(t.cpu() for t in w))
    err = float((h.cpu().float() - ph.float()).abs().max())
    snr = _snr_db(h.cpu().float().numpy(), ph.float().numpy())
    step = L.lstm_cs_step_reference(x.cpu(), *(t.cpu() for t in w), h.cpu(), cs.cpu())
    cs_err, step_err = _rel(cs.cpu(), pcs), _rel(cs.cpu(), step)
    assert err <= 2.0 ** -7 and snr >= 70.0, (err, snr)
    assert cs_err <= CS_FREE_RTOL and step_err <= CS_STEP_RTOL, (cs_err, step_err)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        L.lstm_forward_with_cs(x.half(), *w)
    assert L.lstm_forward_with_cs.launches == launches
