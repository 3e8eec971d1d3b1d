"""The bf16 streams of the four training kernels and the bf16 train step, on
the CPU, against the JAX package's Pallas entries in interpret mode.

On a CPU tensor each entry runs its plain PyTorch version, so these tests
hold the bf16 modes' contract against the TPU kernels':

- the residual forward of the fused pair (unmasked and masked) and of the
  stacked-direction scan: outputs and the saved h, c and tanh(c) streams,
  bf16, on every valid step within BF16_ATOL of the TPU kernel's (of
  max(1, |ref|) for c, whose ulp grows past 1) and at BF16_SNR_DB;
- the backward of each, fed the TPU kernel's own saved streams: dx (bf16)
  within BF16_ATOL, and dx, dW and db at BF16_GRAD_SNR_DB, and closer to
  the TPU kernel than the same backward without the bf16 rounding of dpre
  is, by at least ROUNDING_MARGIN_DB on dW;
- the autograd Functions (``BiLSTM2``, ``BiLSTM2Masked``, ``LSTMStack``) on
  bf16 inputs against ``jax.grad`` through ``_recurrence3`` /
  ``_recurrence3_masked`` / ``_recurrence`` on the Pallas lane, each gradient
  in its input's type;
- one bf16 ``TrainerSpe`` step and one causal-BSS ``Trainer`` step against
  the JAX trainer's (jitted, Pallas lane): loss within 1e-2 relative, and
  the gradients' SNR against the JAX fp32 step no more than 2 dB below the
  JAX bf16 step's own.

Why dW and db are held at an SNR and not at DW_REL_TOL (the fp32 lane's
1e-4 of max |ref|): the TPU kernel rounds dpre to bf16 before its products,
so a gate that another valid implementation sums or activates in another
order (XLA's exp and tanh are not torch's) can round one dpre to the
neighbouring bf16 value. At these sizes one such flip moves a dW entry by up
to 1.1e-3 of max |dW|: over 12 seeds the plain backward reads at least 64.6
dB (dx), 70.2 dB (dW) and 81.1 dB (db) against the TPU kernel, and the
backward without that rounding at most 52.7, 56.7 and 66.7 dB
(``scripts/port/bf16_grad_floor.py``), so the bars sit between the two.

The ``cuda`` cases hold each bf16 training kernel against its plain version
on the card.
"""

import functools

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
except ImportError:  # the card's machine has no JAX: only the cuda cases run there
    jax = jnp = None

from tss_dprnn_tpu_torch.ops import bilstm2 as B2
from tss_dprnn_tpu_torch.ops import lstm as L
from tss_dprnn_tpu_torch.ops import rnn as port_rnn

BF16_ATOL = 2.0 ** -7
BF16_SNR_DB = 70.0
BF16_GRAD_SNR_DB = 60.0
ROUNDING_MARGIN_DB = 3.0
STREAMS = ("hp0", "cp0", "tc0", "hp1", "cp1", "tc1")


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
    return 10 * np.log10(np.sum(want ** 2) / max(np.sum((got - want) ** 2), 1e-30))


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _bf16_pair(a):
    """An array rounded to bf16: (torch bf16, JAX bf16)."""
    t = torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _weights(rng, D, F, H):
    """bf16-valued weights: (torch fp32 holding bf16 values, JAX bf16)."""
    arrays = ((rng.standard_normal((D, F, 4 * H)) * 0.3), (rng.standard_normal((D, 4 * H)) * 0.1),
              (rng.standard_normal((D, H, 4 * H)) * 0.3))
    pairs = [_bf16_pair(a) for a in arrays]
    return [t.float() for t, _ in pairs], [j for _, j in pairs]


def _assert_stream(name, got, want, valid=None):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if valid is not None:
        got, want = got[valid], want[valid]
    scale = np.maximum(np.abs(want), 1.0) if name.startswith("cp") else 1.0
    err = float(np.max(np.abs(got - want) / scale)) if got.size else 0.0
    assert err <= BF16_ATOL, (name, err)
    assert _snr_db(got, want) >= BF16_SNR_DB, (name, _snr_db(got, want))


def _assert_grads(got, want, no_rounding=None):
    """dx (bf16) within BF16_ATOL; every gradient at BF16_GRAD_SNR_DB; dW
    closer to ``want`` than ``no_rounding`` (the backward without the bf16
    rounding of dpre) by ROUNDING_MARGIN_DB."""
    names = ("dx", "dw_ih", "db", "dw_hh")
    assert got[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in got[1:])
    err = float(np.abs(got[0].float().numpy() - _f32(want[0])).max())
    assert err <= BF16_ATOL, ("dx", err)
    for name, a, b in zip(names, got, want):
        db = _snr_db(a.float().numpy(), _f32(b))
        assert db >= BF16_GRAD_SNR_DB, (name, db)
    if no_rounding is not None:
        for i in (1, 3):
            right = _snr_db(got[i].numpy(), _f32(want[i]))
            wrong = _snr_db(no_rounding[i].numpy(), _f32(want[i]))
            assert right >= wrong + ROUNDING_MARGIN_DB, (names[i], right, wrong)


def _no_rounding(backward, x, resid, cotangents, *rest):
    """The plain backward with fp32 arithmetic on the same (bf16-valued)
    inputs: dpre never rounded, dx summed in fp32."""
    up = [t.float() for t in cotangents]
    return backward(x.float(), tuple(t.float() for t in resid), *up, *rest)


# ------------------------------------------------------- the fused pair

PAIR = [(11, 12, None), (9, 6, [6, 6, 5, 4, 3, 2, 1, 6, 2])]


def _pair_case(rng, R, T, lens, F=16, H=32):
    from tss_dprnn_tpu.ops import pallas_lstm

    x, xj = _bf16_pair(rng.standard_normal((R, T, F)))
    w, wj = _weights(rng, 2, F, H)
    ln = None if lens is None else np.asarray(lens, np.int32)
    if ln is None:
        outs, resid = pallas_lstm.bilstm2_forward_resid(xj, *wj)
    else:
        outs, resid = pallas_lstm.bilstm2_forward_resid_masked(xj, ln, *wj)
    g0, g0j = _bf16_pair(rng.standard_normal((R, T, H)))
    g1, g1j = _bf16_pair(rng.standard_normal((R, T, H)))
    if ln is not None:  # out0's cotangent past each length is 0, as the masked norm makes it
        past = torch.from_numpy(np.arange(T)[None, :] >= ln[:, None])
        g0[past] = 0
        g0j = jnp.asarray(g0.float().numpy(), jnp.bfloat16)
    if ln is None:
        grads = pallas_lstm.bilstm2_backward(*resid, g0j, g1j, *wj)
    else:
        grads = pallas_lstm.bilstm2_backward_masked(*resid, g0j, g1j, *wj, ln)
    streams = [np.swapaxes(_f32(s)[:T, :R], 0, 1) for s in resid[1:]]
    lt = None if ln is None else torch.from_numpy(ln)
    valid = (np.ones((R, T), bool) if ln is None else np.arange(T)[None, :] < ln[:, None])
    return dict(x=x, w=w, lens=lt, valid=valid, outs=[_f32(o) for o in outs], streams=streams,
                g=(g0, g1), grads=grads)


@pytest.mark.parametrize("R,T,lens", PAIR)
def test_pair_resid_forward_bf16_matches_pallas(rng, interpret, R, T, lens):
    c = _pair_case(rng, R, T, lens)
    before = B2.launch_count()
    if c["lens"] is None:
        (o0, o1), resid = B2.bilstm2_forward_resid(c["x"], *c["w"])
    else:
        (o0, o1), resid = B2.bilstm2_forward_resid_masked(c["x"], c["lens"], *c["w"])
    assert B2.launch_count() == before  # a CPU tensor runs the plain version
    assert o0.dtype == o1.dtype == torch.bfloat16 and resid[6].dtype == torch.float32
    _assert_stream("out0", o0, c["outs"][0], c["valid"])
    _assert_stream("out1", o1, c["outs"][1])
    for name, got, want in zip(STREAMS, resid[:6], c["streams"]):
        assert got.dtype == torch.bfloat16, name
        _assert_stream(name, got, want, c["valid"])


def _pre_from_streams(x, w, hp0, hp1):
    """The gate pre-activations the port's forward would save, from given h
    streams: (x @ W_ih + h_prev @ W_hh) + b in fp32, [R, T, 2, 4H]."""
    w_ih, b, w_hh = (t.float() for t in w)
    return torch.stack([(x.float() @ w_ih[d] + hp.float() @ w_hh[d]) + b[d]
                        for d, hp in ((0, hp0), (1, hp1))], dim=2)


@pytest.mark.parametrize("R,T,lens", PAIR)
def test_pair_backward_bf16_matches_pallas(rng, interpret, R, T, lens):
    """The backward fed the TPU kernel's own saved streams (and the gates
    built from them), so only the backward's arithmetic is compared."""
    c = _pair_case(rng, R, T, lens)
    streams = [torch.from_numpy(s).bfloat16() for s in c["streams"]]
    resid = (*streams, _pre_from_streams(c["x"], c["w"], streams[0], streams[3]))
    if c["lens"] is None:
        run = B2.bilstm2_backward
        rest = tuple(c["w"])
    else:
        run = functools.partial(B2.bilstm2_backward_masked)
        rest = (*c["w"], c["lens"])
    got = run(c["x"], resid, *c["g"], *rest)
    _assert_grads(got, c["grads"], _no_rounding(run, c["x"], resid, c["g"], *rest))


# ------------------------------------------------- the stacked directions

STACK = [(1, 13, 12), (2, 7, 10)]


def _stack_case(rng, D, R, T, F=16, H=32):
    from tss_dprnn_tpu.ops import pallas_lstm

    x, xj = _bf16_pair(rng.standard_normal((D, R, T, F)))
    w, wj = _weights(rng, D, F, H)
    hs, xk, hp, cp, tc = pallas_lstm.lstm_forward_resid(xj, *wj)
    g, gj = _bf16_pair(rng.standard_normal((D, R, T, H)))
    grads = pallas_lstm.lstm_backward(xk, hp, cp, tc, jnp.transpose(gj, (2, 0, 1, 3)), *wj)
    streams = [np.swapaxes(_f32(s)[:, :T, :R], 1, 2) for s in (hp, cp, tc)]
    return dict(x=x, w=w, h=np.transpose(_f32(hs), (1, 2, 0, 3)), streams=streams, g=g,
                grads=grads)


@pytest.mark.parametrize("D,R,T", STACK)
def test_stack_resid_forward_bf16_matches_pallas(rng, interpret, D, R, T):
    c = _stack_case(rng, D, R, T)
    before = L.launch_count()
    h, resid = L.lstm_forward_resid(c["x"], *c["w"])
    assert L.launch_count() == before
    assert h.dtype == torch.bfloat16 and resid[3].dtype == torch.float32
    _assert_stream("h", h, c["h"])
    for name, got, want in zip(("hp", "cp", "tc"), resid[:3], c["streams"]):
        assert got.dtype == torch.bfloat16, name
        _assert_stream(name, got, want)


@pytest.mark.parametrize("D,R,T", STACK)
def test_stack_backward_bf16_matches_pallas(rng, interpret, D, R, T):
    c = _stack_case(rng, D, R, T)
    hp, cp, tc = (torch.from_numpy(s).bfloat16() for s in c["streams"])
    w_ih, b, w_hh = c["w"]
    pre = (torch.einsum("drtf,dfg->drtg", c["x"].float(), w_ih)
           + torch.einsum("drth,dhg->drtg", hp.float(), w_hh)) + b[:, None, None]
    resid = (hp, cp, tc, pre)
    got = L.lstm_backward(c["x"], resid, c["g"], *c["w"])
    _assert_grads(got, c["grads"], _no_rounding(L.lstm_backward, c["x"], resid, (c["g"],),
                                                *c["w"]))


# ------------------------------------------------ the autograd Functions

def _leaves(*tensors):
    return [t.clone().requires_grad_() for t in tensors]


@pytest.mark.parametrize("kind", ["pair", "pair-masked", "stack"])
def test_functions_bf16_match_jax_grad(rng, interpret, kind):
    """Loss sum(out * g) through the port's Function and through JAX's
    custom-VJP recurrence on the Pallas lane, inputs in bf16: the gradient
    of each input in its type and at the backward's bars."""
    from tss_dprnn_tpu.ops import rnn as jax_rnn

    R, T, F, H = 8, 10, 16, 16
    D = 1 if kind == "stack" else 2
    lens = np.array([10, 3, 7, 10, 1, 9, 5, 8], np.int32) if kind == "pair-masked" else None
    xs = (rng.standard_normal((R, T, F)) if D == 2 else rng.standard_normal((1, R, T, F)))
    x, xj = _bf16_pair(xs)
    w, wj = _weights(rng, D, F, H)
    wt = [_bf16_pair(t.numpy())[0] for t in w]  # bf16 leaves, as the lane's casts give them
    gshape = (R, T, H) if D == 2 else (1, R, T, H)
    gs = [_bf16_pair(rng.standard_normal(gshape)) for _ in range(D)]
    if lens is not None:
        past = np.arange(T)[None, :] >= lens[:, None]
        g0 = gs[0][0].clone()
        g0[torch.from_numpy(past)] = 0
        gs[0] = (g0, jnp.asarray(g0.float().numpy(), jnp.bfloat16))

    def jax_loss(xv, w_ih, b, w_hh):
        if kind == "stack":
            hs = jax_rnn._recurrence(1, xv, w_ih, b, w_hh)  # [T, 1, R, H]
            return jnp.sum(hs.astype(jnp.float32)
                           * jnp.transpose(gs[0][1], (2, 0, 1, 3)).astype(jnp.float32))
        if lens is None:
            o0, o1 = jax_rnn._recurrence3(xv, w_ih, b, w_hh)
        else:
            o0, o1 = jax_rnn._recurrence3_masked(xv, jnp.asarray(lens), w_ih, b, w_hh)
        return sum(jnp.sum(o.astype(jnp.float32) * g.astype(jnp.float32))
                   for o, (_, g) in zip((o0, o1), gs))

    with jax_rnn.lstm_backend("pallas"):
        want = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2, 3)))(xj, *wj)
    leaves = _leaves(x, *wt)
    if kind == "stack":
        outs = (port_rnn.LSTMStack.apply(*leaves),)
    elif lens is None:
        outs = port_rnn.BiLSTM2.apply(*leaves)
    else:
        outs = port_rnn.BiLSTM2Masked.apply(leaves[0], torch.from_numpy(lens), *leaves[1:])
    sum((o.float() * g.float()).sum() for o, (g, _) in zip(outs, gs)).backward()
    for name, leaf, ref in zip(("dx", "dw_ih", "db", "dw_hh"), leaves, want):
        assert leaf.grad.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16, name
        db = _snr_db(leaf.grad.float().numpy(), _f32(ref))
        assert db >= BF16_GRAD_SNR_DB, (name, db)


# ------------------------------------------------------------ train steps

SMALL = dict(input_size=8, feature_size=16, hidden_size=16, chunk_length=8, kernel_size=2,
             hop_length=4, n_repeats=1, norm_type="ln", activation_type="sigmoid")
SPE = dict(SMALL, O=8, P=12, embeddings_size=8, num_spks=5, fusion_type="att")
TRAIN_CONFIG = {"optimizer": {"lr": 1e-3, "weight_decay": 1e-2}, "clip_norm": 5,
                "ce_gamma": 0.5, "print_freq": 1}
GRAD_SLACK_DB = 2.0


def _flat(tree):
    return np.concatenate([np.asarray(v, np.float64).ravel() for _, v in sorted(tree.items())])


@pytest.mark.parametrize("family", ["tss", "bss-causal"])
def test_train_step_bf16_matches_jax(interpret, tmp_path, family):
    """One train step's loss and gradients, bf16 lane: the port's gradients
    (every parameter, concatenated) against the JAX fp32 step's are no more
    than GRAD_SLACK_DB below the JAX bf16 step's own SNR; the loss within
    1e-2 of the JAX bf16 step's."""
    from tss_dprnn_tpu.models import DPRNNSpeTasNet as JaxSpe
    from tss_dprnn_tpu.models import DPRNNTasNet as JaxBss
    from tss_dprnn_tpu.ops import rnn as jax_rnn
    from tss_dprnn_tpu.training.trainer import Trainer as JaxTrainer
    from tss_dprnn_tpu.training.trainer_spe import TrainerSpe as JaxTrainerSpe
    from tss_dprnn_tpu_torch.data import loader
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet, DPRNNTasNet
    from tss_dprnn_tpu_torch.training import Trainer, TrainerSpe
    from tss_dprnn_tpu_torch.utils.weights import state_dict_from_jax

    rng = np.random.default_rng(31)
    if family == "tss":
        cfg, jcls, jtr_cls, cls, tr_cls = SPE, JaxSpe, JaxTrainerSpe, DPRNNSpeTasNet, TrainerSpe
        batch = loader.collate_spe([(rng.standard_normal(240).astype(np.float32),
                                     rng.standard_normal(240).astype(np.float32),
                                     rng.standard_normal(200).astype(np.float32), i)
                                    for i in range(2)])
        init_args = (batch["mix"][:1], batch["reference"][:1], batch["ref_len"][:1])
    else:
        cfg, jcls, jtr_cls = dict(SMALL, bidirectional=False), JaxBss, JaxTrainer
        cls, tr_cls = DPRNNTasNet, Trainer
        sources = rng.standard_normal((2, 2, 240)).astype(np.float32)
        batch = loader.collate_bss([(s.sum(0), s) for s in sources])
        init_args = (batch["mix"][:1],)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodels = {"fp32": jcls(**cfg), "bf16": jcls(**cfg, dtype=jnp.bfloat16)}
    variables = jax.tree_util.tree_map(np.asarray, dict(
        jax.jit(jmodels["fp32"].init)(jax.random.PRNGKey(2), *init_args)))

    jtrainers = {dt: jtr_cls(jm, dict(TRAIN_CONFIG, new_checkpoints_path=str(tmp_path / "j")))
                 for dt, jm in jmodels.items()}

    @jax.jit
    def steps(variables):  # the fp32 step on JAX's XLA lane, the bf16 one on its Pallas lane
        out = {}
        for dt, jtr in jtrainers.items():
            def loss_fn(params, jtr=jtr):
                return jtr._forward_loss({**variables, "params": params}, jbatch, train=True)[0]

            with jax_rnn.lstm_backend("pallas" if dt == "bf16" else "xla"):
                out[dt] = jax.value_and_grad(loss_fn)(variables["params"])
        return out

    want = steps(variables)
    kw = dict(norm_type="ln", kernel_size=2, fusion_type="att")
    start = state_dict_from_jax(variables, **kw)
    grads = {dt: state_dict_from_jax(jax.tree_util.tree_map(np.asarray, {
        **variables, "params": g}), **kw) for dt, (_, g) in want.items()}
    names = [k for k in grads["fp32"] if k in dict(cls(**cfg).named_parameters())]
    ref32 = _flat({k: grads["fp32"][k] for k in names})
    jax_db = _snr_db(_flat({k: grads["bf16"][k] for k in names}), ref32)

    model = cls(**cfg, dtype=torch.bfloat16)
    model.load_state_dict(start, strict=True)
    tr = tr_cls(model, dict(TRAIN_CONFIG, new_checkpoints_path=str(tmp_path / "p")),
                device="cpu")
    tr.model.train()
    loss, _ = tr._forward_loss(tr._to_device(batch), train=True)
    loss.backward()
    got = {k: p.grad for k, p in tr.model.named_parameters()}
    assert set(got) == set(names)
    assert all(g.dtype == torch.float32 for g in got.values())
    port_db = _snr_db(_flat({k: got[k].numpy() for k in names}), ref32)
    print(f"{family}: gradient SNR against JAX fp32: port bf16 {port_db:.2f} dB, JAX bf16 "
          f"{jax_db:.2f} dB")
    np.testing.assert_allclose(loss.item(), float(want["bf16"][0]), rtol=1e-2)
    assert port_db >= jax_db - GRAD_SLACK_DB, (port_db, jax_db)


# grads recovered from the JAX trainer's own step: its optimizer replaced by
# this scale (a power of two), so that params_after = params + GRAD_SCALE * g
GRAD_SCALE = 2.0 ** 10


def _varlen_spe_batch(seed):
    """4 rows of 160 samples with their lengths (zeros past each), and
    references of 300 samples each: a padded reference frame would feed the
    speaker encoder's max pools ties that jitted JAX breaks its own way (in
    fp32 too), so every reference is unpadded, as in
    test_torch_port_train_knobs.py."""
    rng = np.random.default_rng(seed)
    lengths = np.array([160, 117, 71, 133], np.int32)
    past = np.arange(160)[None, :] >= lengths[:, None]
    target = np.where(past, 0, rng.standard_normal((4, 160))).astype(np.float32)
    mix = np.where(past, 0, target + rng.standard_normal((4, 160))).astype(np.float32)
    ref = rng.standard_normal((4, 300)).astype(np.float32)
    ref_len = np.full(4, 300, np.float32)
    return {"mix": mix, "target": target, "reference": ref, "ref_len": ref_len,
            "spk_idx": rng.integers(0, 5, 4).astype(np.int32), "lengths": lengths}


def test_varlen_accum_step_bf16_matches_jax(interpret, tmp_path):
    """A variable-length TrainerSpe step with accum_steps=2 in the bf16 lane
    (the masked training pair on the inter scans), against the JAX trainer's
    own jitted step (its accumulation over micro-batches, bf16 on the Pallas
    lane, fp32 on the XLA lane; its optimizer a scale, so that the update is
    the gradient): the loss within 1e-2 of JAX bf16's, BatchNorm's running
    statistics those of JAX's last micro-batch (the speaker encoder stays
    fp32 in both lanes), and the bf16 lane's gradient SNR against its own
    package's fp32 step no more than GRAD_SLACK_DB below JAX's.

    Each bf16 lane is read against its own package's fp32 step, not both
    against JAX fp32: under jit, JAX's speaker-encoder gradients move by up
    to their size where its max pools hold ties
    (scripts/port/spk_grad_ties.py), so the port's fp32 step itself reads
    only about 47 dB against the jitted JAX fp32 step here, and that gap,
    which is no bf16 rounding, would hide the bf16 lane's. The port's fp32
    step is held to JAX's by tests/test_torch_port_varlen_training.py and
    tests/test_torch_port_train_knobs.py."""
    import optax

    from tss_dprnn_tpu.models import DPRNNSpeTasNet as JaxSpe
    from tss_dprnn_tpu.parallel import make_mesh
    from tss_dprnn_tpu.training.train_state import TrainState
    from tss_dprnn_tpu.training.trainer_spe import TrainerSpe as JaxTrainerSpe
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.training import TrainerSpe
    from tss_dprnn_tpu_torch.utils.weights import state_dict_from_jax

    batch = _varlen_spe_batch(33)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    config = dict(TRAIN_CONFIG, accum_steps=2)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(JaxSpe(**SPE).init)(
        jax.random.PRNGKey(5), batch["mix"][:1], batch["reference"][:1], batch["ref_len"][:1])))
    tx = optax.scale(GRAD_SCALE)

    def port_tree(params, stats):
        return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, {
            "params": params, "batch_stats": stats}), "ln", 2, "att")

    start = port_tree(variables["params"], variables["batch_stats"])
    want, got = {}, {}
    for dt, backend, dtype in (("fp32", "xla", None), ("bf16", "pallas", jnp.bfloat16)):
        jtr = JaxTrainerSpe(JaxSpe(**SPE, dtype=dtype),
                            dict(config, lstm_backend=backend,
                                 new_checkpoints_path=str(tmp_path / f"j{dt}")))
        jtr.mesh = make_mesh(data=1)
        jtr._varlen = True
        jtr._build_steps()
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                              variables["batch_stats"]),
                           opt_state=tx.init(params), tx=tx)
        new, loss, _ = jtr._train_step(state, jbatch)
        grads = jax.tree_util.tree_map(lambda a, b: (np.asarray(a) - b) / GRAD_SCALE,
                                       new.params, variables["params"])
        want[dt] = (float(loss), port_tree(grads, variables["batch_stats"]),
                    port_tree(new.params, new.batch_stats))

        model = DPRNNSpeTasNet(**SPE, dtype=torch.bfloat16 if dt == "bf16" else None)
        model.load_state_dict(start, strict=True)
        tr = TrainerSpe(model, dict(config, new_checkpoints_path=str(tmp_path / f"p{dt}")),
                        device="cpu")
        tr.model.train()
        tr.optimizer.zero_grad()
        with tr._scans(train=True):
            loss, _ = tr._accumulated(tr._to_device(batch))
        got[dt] = (loss.item(), {k: p.grad for k, p in tr.model.named_parameters()},
                   tr.model.state_dict())
    names = sorted(got["bf16"][1])

    def snr(a, b):
        return _snr_db(_flat({k: a[k] for k in names}), _flat({k: b[k] for k in names}))

    port_db = snr({k: v.numpy() for k, v in got["bf16"][1].items()},
                  {k: v.numpy() for k, v in got["fp32"][1].items()})
    jax_db = snr(want["bf16"][1], want["fp32"][1])
    print(f"varlen accum_steps=2: gradient SNR of the bf16 lane against its package's fp32 "
          f"step: port {port_db:.2f} dB, JAX {jax_db:.2f} dB; against JAX fp32: port bf16 "
          f"{snr({k: v.numpy() for k, v in got['bf16'][1].items()}, want['fp32'][1]):.2f} dB, "
          f"port fp32 {snr({k: v.numpy() for k, v in got['fp32'][1].items()}, want['fp32'][1]):.2f}"
          f" dB")
    np.testing.assert_allclose(got["fp32"][0], want["fp32"][0], rtol=1e-5)
    np.testing.assert_allclose(got["bf16"][0], want["bf16"][0], rtol=1e-2)
    assert port_db >= jax_db - GRAD_SLACK_DB, (port_db, jax_db)
    stats = [k for k in want["bf16"][2] if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        torch.testing.assert_close(got["bf16"][2][k], want["bf16"][2][k], atol=1e-6, rtol=0,
                                   msg=k)


class _Records:
    """A reporter that keeps what it is given."""

    def __init__(self):
        self.logs = []

    def add_and_report(self, logs=None, mode="train"):
        self.logs.append((mode, logs))


def test_is_metrics_bf16_scores_fp32_estimates(tmp_path):
    """A bf16 causal-BSS trainer with is_metrics: its steps' estimates are
    fp32, and the epoch's metrics equal the JAX trainer's
    ``_accumulate_metrics`` over the same estimates."""
    from tss_dprnn_tpu.training.trainer import Trainer as JaxTrainer
    from tss_dprnn_tpu_torch.models import DPRNNTasNet
    from tss_dprnn_tpu_torch.training import Trainer
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    rng = np.random.default_rng(34)
    sources = rng.standard_normal((2, 2, 8000)).astype(np.float32)
    batch = {"mix": sources.sum(1), "sources": sources}
    model = init_weights_(DPRNNTasNet(**SMALL, bidirectional=False, dtype=torch.bfloat16),
                          torch.Generator().manual_seed(3))
    tr = Trainer(model, dict(TRAIN_CONFIG, is_metrics=True,
                             new_checkpoints_path=str(tmp_path / "p")), device="cpu")
    tr.reporter = _Records()
    ests = []
    real = tr.train_step

    def train_step(b):
        loss, aux = real(b)
        ests.append(aux["est"])
        return loss, aux

    tr.train_step = train_step
    tr.train([batch])
    assert ests[0].dtype == torch.float32
    jtr = JaxTrainer(None, {"is_metrics": True, "new_checkpoints_path": str(tmp_path / "j")})
    jtr._metric_sums, jtr._metric_cnt = {}, 0
    jtr._accumulate_metrics(batch, {"est": ests[0].numpy()})
    want = {k: v / jtr._metric_cnt for k, v in jtr._metric_sums.items()}
    (mode, got), = tr.reporter.logs
    assert mode == "train" and set(got["metrics"]) == set(want)
    for k, tol in {"si_sdr": 1e-4, "stoi": 1e-6, "pesq": 1e-4}.items():
        assert abs(got["metrics"][k] - want[k]) <= tol, (k, got["metrics"][k], want[k])


# ----------------------------------------------------------------- on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _card_pair(R, T, lens_fn=None, F=128, H=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    k = H ** -0.5
    x = torch.randn(R, T, F, generator=g).bfloat16().cuda()
    w = [((torch.rand(*s, generator=g) * 2 - 1) * k).cuda()
         for s in ((2, F, 4 * H), (2, 4 * H), (2, H, 4 * H))]
    lens = None if lens_fn is None else torch.tensor([lens_fn(r) for r in range(R)],
                                                     dtype=torch.int32).cuda()
    cot = [torch.randn(R, T, H, generator=g).bfloat16().cuda() for _ in range(2)]
    if lens is not None:
        cot[0][torch.arange(T, device="cuda")[None, :] >= lens[:, None]] = 0
    return x, w, lens, cot


def _card_grads_close(got, want):
    got, want = [t.cpu() for t in got], [t.cpu() for t in want]
    err = float((got[0].float() - want[0].float()).abs().max())
    assert err <= BF16_ATOL, ("dx", err)
    for name, a, b in zip(("dx", "dw_ih", "db", "dw_hh"), got, want):
        db = _snr_db(a.float().cpu().numpy(), b.float().cpu().numpy())
        assert db >= BF16_GRAD_SNR_DB, (name, db)


@pytest.mark.cuda
@pytest.mark.parametrize("R,T,masked", [(37, 9, False), (203, 13, True), (970, 25, False)])
def test_pair_bf16_training_kernels_on_card(R, T, masked):
    """The bf16 residual forward and backward of the fused pair against
    their plain versions on the card, bit for bit on a second call."""
    _needs_card()
    x, w, lens, (g0, g1) = _card_pair(R, T, (lambda r: (r * 7) % (T + 1)) if masked else None)
    before = B2.bilstm2_forward_resid_masked.launches if masked else (
        B2.bilstm2_forward_resid.launches)
    if masked:
        (o0, o1), resid = B2.bilstm2_forward_resid_masked(x, lens, *w)
        (p0, p1), presid = B2.bilstm2_resid_reference(x.cpu(), *(t.cpu() for t in w), lens.cpu())
    else:
        (o0, o1), resid = B2.bilstm2_forward_resid(x, *w)
        (p0, p1), presid = B2.bilstm2_resid_reference(x.cpu(), *(t.cpu() for t in w))
    after = B2.bilstm2_forward_resid_masked.launches if masked else (
        B2.bilstm2_forward_resid.launches)
    assert after == before + 1
    valid = (torch.ones(R, T, dtype=torch.bool) if lens is None
             else torch.arange(T)[None, :] < lens.cpu()[:, None]).numpy()
    _assert_stream("out0", o0.cpu(), p0.float().numpy(), valid)
    _assert_stream("out1", o1.cpu(), p1.float().numpy())
    for name, a, b in zip(STREAMS, resid[:6], presid[:6]):
        assert a.dtype == torch.bfloat16
        _assert_stream(name, a.cpu(), b.float().numpy(), valid)
    # the backward on the card's own saved streams, against the plain one on the same
    args = (x, resid, g0, g1, *w) + ((lens,) if masked else ())
    run = B2.bilstm2_backward_masked if masked else B2.bilstm2_backward
    got = run(*args)
    again = run(*args)
    want = run(*(a.cpu() if isinstance(a, torch.Tensor) else tuple(t.cpu() for t in a)
                 for a in args))
    _card_grads_close(got, want)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("D,R,T", [(1, 1250, 19), (2, 37, 9)])
def test_stack_bf16_training_kernels_on_card(D, R, T):
    _needs_card()
    g = torch.Generator().manual_seed(1)
    F = H = 128
    k = H ** -0.5
    x = torch.randn(D, R, T, F, generator=g).bfloat16().cuda()
    w = [((torch.rand(*s, generator=g) * 2 - 1) * k).cuda()
         for s in ((D, F, 4 * H), (D, 4 * H), (D, H, 4 * H))]
    cot = torch.randn(D, R, T, H, generator=g).bfloat16().cuda()
    before = L.lstm_forward_resid.launches
    h, resid = L.lstm_forward_resid(x, *w)
    assert L.lstm_forward_resid.launches == before + 1
    ph, presid = L.lstm_resid_reference(x.cpu(), *(t.cpu() for t in w))
    _assert_stream("h", h.cpu(), ph.float().numpy())
    for name, a, b in zip(("hp", "cp", "tc"), resid[:3], presid[:3]):
        _assert_stream(name, a.cpu(), b.float().numpy())
    got = L.lstm_backward(x, resid, cot, *w)
    again = L.lstm_backward(x, resid, cot, *w)
    want = L.lstm_backward(x.cpu(), tuple(t.cpu() for t in resid), cot.cpu(),
                           *(t.cpu() for t in w))
    _card_grads_close(got, want)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_training_kernels_reject_fp16():
    """The training kernels stream fp32 or bf16; fp16 raises before any launch."""
    _needs_card()
    x, w, _, (g0, g1) = _card_pair(4, 3, F=16, H=16)
    before = B2.launch_count(), L.launch_count()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        B2.bilstm2_forward_resid(x.half(), *w)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        L.lstm_forward_resid(x[None].half(), *(t[:1] for t in w))
    assert (B2.launch_count(), L.launch_count()) == before
