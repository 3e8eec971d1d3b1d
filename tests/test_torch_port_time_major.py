"""The port's time-major lane against the JAX package's (``TSS_TM``).

- The five time-major entries of ``tss_dprnn_tpu_torch/ops/bilstm2.py``
  (``bilstm2_forward_tm``, ``_masked_tm``, ``_resid_tm``,
  ``_resid_masked_tm``, ``bilstm2_backward_tm``) against their Pallas
  entries in interpret mode, masked and unmasked, at an H of 8 and at
  F = 12, H = 20 (widths that are not multiples of 16): outputs and streams
  within 1e-5, pre within 1e-5 of the one built from the JAX streams, the
  backward within 1e-4 (dW and db sum every row-step), as
  ``test_torch_port_bilstm2_grad.py`` holds the batch-major entries.
- ``ops/rnn.lstm_tm`` and ``lstm_pair_tm`` and their gradients (the
  autograd Functions ``BiLSTM2TM``, ``BiLSTM2MaskedTM``) against
  ``jax.grad`` of the JAX ops, within 1e-5.
- A ``DPRNNTasNet`` (one block, 'ln') under ``TSS_TM=1``, with and without
  lengths: forward and every parameter's gradient >= 60 dB against the JAX
  model's time-major block, and >= 80 dB against the port's own
  batch-major model.
- The switch: the context, ``TSS_TM`` overriding it both ways,
  unidirectional or ``lstm_save_every > 1`` turning it off, and the
  serving entry points' default by the model's dtype.
- The time-major serving forward exported: one operator node per scan,
  and decomposed through ``PLAIN_BODIES`` into the same values.
- On the card (``cuda``): each entry bit for bit the batch-major route on
  the transposed input (outputs, the seven streams, dx; dW and db sum the
  row-steps in the other order, so within DW_REL_TOL of their max).
"""

import functools

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch.inference import export
from tss_dprnn_tpu_torch.models.dprnn import DPRNNCore, DPRNNTasNet
from tss_dprnn_tpu_torch.ops import bilstm2 as B
from tss_dprnn_tpu_torch.ops import rnn as R
from tss_dprnn_tpu_torch.utils.weights import init_weights_, state_dict_from_jax

ATOL_FWD = 1e-5
ATOL_BWD = 1e-4
ATOL_GRAD = 1e-5
MODEL_SNR_DB = 60.0
LAYOUT_SNR_DB = 80.0
DW_REL_TOL = 1e-4
# (T, R, F, H, lens): T = 11 is not a multiple of the TPU kernel's unroll
SHAPES = {"h8": (11, 3, 16, 8, None), "f12_h20": (7, 5, 12, 20, None),
          "f12_h20_masked": (7, 5, 12, 20, [7, 1, 5, 7, 3])}
TINY = dict(input_size=12, feature_size=8, hidden_size=6, chunk_length=10, kernel_size=2,
            n_repeats=1, norm_type="ln")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module (see test_torch_port_config_cli.py)."""
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


def _case(name, seed=0):
    T, Rr, F, H, lens = SHAPES[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, Rr, F)).astype(np.float32)
    w = [(rng.standard_normal((2, F, 4 * H)) * 0.3).astype(np.float32),
         (rng.standard_normal((2, 4 * H)) * 0.1).astype(np.float32),
         (rng.standard_normal((2, H, 4 * H)) * 0.3).astype(np.float32)]
    g0 = rng.standard_normal((T, Rr, H)).astype(np.float32)
    g1 = rng.standard_normal((T, Rr, H)).astype(np.float32)
    if lens is not None:
        lens = np.asarray(lens, np.int32)
        g0[np.arange(T)[:, None] >= lens[None, :]] = 0  # as the block's masked norm makes it
    return x, lens, w, (g0, g1)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


# ------------------------------------------------------------- the entries

@pytest.mark.parametrize("name", ["h8", "f12_h20_masked"])
def test_entries_match_pallas(interpret, name):
    """The five entries on a CPU tensor (their plain versions; no launch)
    against the Pallas entries; masked: out1 and every stream on t < len,
    out0 on t < len, direction 1's h and c zero past it."""
    import jax

    from tss_dprnn_tpu.ops import pallas_lstm as P

    x, lens, w, (g0, g1) = _case(name)
    T, Rr, F = x.shape
    xt, lt, *wt = _t(x, lens, *w)
    def pallas(x, lens, g0, g1, *w):  # the three JAX entries, compiled as one program
        if lens is None:
            out = P.bilstm2_forward_tm(x, *w)
            outs, resid = P.bilstm2_forward_resid_tm(x, *w)
        else:
            out = P.bilstm2_forward_masked_tm(x, lens, *w)
            outs, resid = P.bilstm2_forward_resid_masked_tm(x, lens, *w)
        return out, outs, resid, P.bilstm2_backward_tm(*resid, g0, g1, *w, T=T, R=Rr, lens=lens)

    want_out, want_outs, want_resid, want_grads = jax.jit(pallas)(x, lens, g0, g1, *w)
    before = B.launch_count()
    if lens is None:
        got_out = B.bilstm2_forward_tm(xt, *wt)
        got_outs, got_resid = B.bilstm2_forward_resid_tm(xt, *wt)
        live = np.ones((T, Rr), bool)
    else:
        got_out = B.bilstm2_forward_masked_tm(xt, lt, *wt)
        got_outs, got_resid = B.bilstm2_forward_resid_masked_tm(xt, lt, *wt)
        live = np.arange(T)[:, None] < lens[None, :]
    for got, want in ((got_out, want_out), (got_outs, want_outs)):
        for d in (0, 1):
            assert got[d].shape == (T, Rr, w[2].shape[1])
            np.testing.assert_allclose(got[d].numpy()[live], np.asarray(want[d])[live],
                                       atol=ATOL_FWD, rtol=0)
        if lens is not None:  # direction 1 is exactly 0 past each row's length
            assert np.all(got[1].numpy()[~live] == 0)
    streams = [np.asarray(s)[:T, :Rr] for s in want_resid[1:]]
    for i, (got, want) in enumerate(zip(got_resid[:6], streams)):
        np.testing.assert_allclose(got.numpy()[live], want[live], atol=ATOL_FWD, rtol=0,
                                   err_msg=f"stream {i}")
    pre = got_resid[6].numpy()
    w64 = [a.astype(np.float64) for a in w]
    want_pre = np.stack([x.astype(np.float64) @ w64[0][d] + streams[3 * d].astype(np.float64)
                         @ w64[2][d] + w64[1][d] for d in (0, 1)], axis=2)
    assert pre.shape == (T, Rr, 2, 4 * w[2].shape[1])
    np.testing.assert_allclose(pre[live], want_pre[live], atol=ATOL_FWD, rtol=0)
    got_grads = B.bilstm2_backward_tm(xt, got_resid, *_t(g0, g1), *wt, lt)
    for label, got, want in zip(("dx", "dw_ih2", "db2", "dw_hh2"), got_grads, want_grads):
        assert got.shape == np.asarray(want).shape, label
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_BWD, rtol=0,
                                   err_msg=label)
    assert B.launch_count() == before


@pytest.mark.parametrize("name", ["h8", "f12_h20_masked"])
def test_entries_are_the_batch_major_ones_transposed(name):
    """Each plain version is the batch-major one on the transposed views:
    the outputs, the seven streams and dx bit for bit, dW and db too (the
    plain backward sums in the batch-major order)."""
    x, lens, w, g = _case(name, seed=1)
    xt, lt, *wt = _t(x, lens, *w)
    g0, g1 = _t(*g)
    bm = lambda t: t.transpose(0, 1)  # noqa: E731
    outs, resid = B.bilstm2_forward_resid_tm(xt, *wt) if lens is None else \
        B.bilstm2_forward_resid_masked_tm(xt, lt, *wt)
    want_outs, want_resid = B.bilstm2_resid_reference(bm(xt), *wt, lt)
    for got, want in zip((*outs, *resid), (*want_outs, *want_resid)):
        assert got.is_contiguous() and torch.equal(bm(got), want)
    grads = B.bilstm2_backward_tm(xt, resid, g0, g1, *wt, lt)
    want = B.bilstm2_backward_reference(bm(xt), want_resid, bm(g0), bm(g1), *wt, lt)
    assert torch.equal(bm(grads[0]), want[0])
    assert all(torch.equal(a, b) for a, b in zip(grads[1:], want[1:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_serving_operators_pass_opcheck(dtype, masked):
    """The two serving entries are operators with shape-only versions:
    opcheck, and the outputs their plain versions' bit for bit."""
    x, lens, w, _ = _case("f12_h20_masked" if masked else "f12_h20", seed=2)
    xt, lt, *wt = _t(x, lens, *w)
    xt = xt.to(dtype)
    name = "bilstm2_forward_masked_tm" if masked else "bilstm2_forward_tm"
    op = getattr(torch.ops.tss_dprnn_tpu_torch, name)
    args = (xt, lt, *wt) if masked else (xt, *wt)
    torch.library.opcheck(op.default, args)
    got = getattr(B, name)(*args)
    want = B.bilstm2_tm_reference(xt, *wt, lt)
    assert all(a.dtype == dtype and torch.equal(a, b) for a, b in zip(got, want))
    assert op.default in B.PLAIN_BODIES


# ------------------------------------------------------------------ the ops

@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_lstm_tm_ops_and_grads_match_jax(interpret, masked):
    """lstm_pair_tm (and lstm_tm, unmasked) and their gradients through the
    autograd Functions against jax.grad of the JAX ops."""
    import jax
    import jax.numpy as jnp

    from tss_dprnn_tpu.ops import rnn as jax_rnn

    x, lens, w, (c0, c1) = _case("f12_h20_masked" if masked else "h8", seed=3)
    H = w[2].shape[1]

    def directions(w_ih2, b2, w_hh2):
        return [jax_rnn.LSTMWeights(w_ih2[d], w_hh2[d], b2[d]) for d in (0, 1)]

    def jax_loss(x, w_ih2, b2, w_hh2):
        fwd, bwd = directions(w_ih2, b2, w_hh2)
        o0, o1 = jax_rnn.lstm_pair_tm(x, fwd, bwd, None if lens is None else jnp.asarray(lens))
        return jnp.sum(o0 * c0) + jnp.sum(o1 * c1)

    want_loss, want = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3)))(x, *w)
    leaves = [t.clone().requires_grad_() for t in _t(x, *w)]
    lt = None if lens is None else torch.from_numpy(lens)
    o0, o1 = R.lstm_pair_tm(leaves[0], tuple(leaves[1:]), lt)
    assert type(o0.grad_fn).__name__ == ("BiLSTM2MaskedTMBackward" if masked
                                         else "BiLSTM2TMBackward")
    loss = (o0 * torch.from_numpy(c0)).sum() + (o1 * torch.from_numpy(c1)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for label, t, b in zip(("dx", "dw_ih2", "db2", "dw_hh2"), leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(b), atol=ATOL_GRAD, rtol=0,
                                   err_msg=label)
    if not masked:  # lstm_tm: the pair concatenated, as JAX's
        fwd, bwd = directions(*w)
        with torch.no_grad():
            got = R.lstm_tm(_t(x)[0], tuple(_t(*w)))
        assert got.shape == (x.shape[0], x.shape[1], 2 * H)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_rnn.lstm_tm(x, fwd, bwd)),
                                   atol=ATOL_FWD, rtol=0)


def test_ignore_lengths_pragma_reaches_the_lane():
    """lstm_ignore_lengths: lstm_pair_tm scans every row to its end."""
    x, lens, w, _ = _case("f12_h20_masked", seed=4)
    xt, lt, *wt = _t(x, lens, *w)
    with torch.no_grad(), R.lstm_ignore_lengths():
        got = R.lstm_pair_tm(xt, tuple(wt), lt)
    want = B.bilstm2_tm_reference(xt, *wt)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# --------------------------------------------------------------- the switch

def test_switch_resolution(monkeypatch):
    monkeypatch.delenv("TSS_TM", raising=False)
    assert not R.lstm_time_major_available(True, None)
    with R.lstm_time_major():
        assert R.lstm_time_major_available(True, None)
        assert R.lstm_time_major_available(True, torch.tensor([3]))  # masked qualifies
        assert not R.lstm_time_major_available(False, None)  # unidirectional
        with R.lstm_save_every(4):
            assert not R.lstm_time_major_available(True, None)
        with R.lstm_time_major(False):
            assert not R.lstm_time_major_available(True, None)
        monkeypatch.setenv("TSS_TM", "0")  # overrides the context
        assert not R.lstm_time_major_available(True, None)
    monkeypatch.setenv("TSS_TM", "1")  # ... both ways
    assert R.lstm_time_major_available(True, None)
    assert not R.lstm_time_major_available(False, None)
    with R.lstm_save_every(2):
        assert not R.lstm_time_major_available(True, None)
    monkeypatch.delenv("TSS_TM")
    # the serving entry points: on for a bf16 model when the default says so
    for default in (False, True):
        monkeypatch.setattr(R, "SERVE_BF16_TIME_MAJOR", default)
        for dtype in (None, torch.bfloat16):
            with R.serving_time_major(DPRNNTasNet(**TINY, dtype=dtype)):
                assert R.lstm_time_major_available(True, None) == (default and dtype is not None)


def test_core_takes_the_lane_only_where_it_applies(monkeypatch):
    """The core permutes to [K, B, S, N] only for bidirectional LSTM blocks:
    a GRU core and a causal core run batch-major under TSS_TM=1, unchanged."""
    monkeypatch.setenv("TSS_TM", "1")
    seen = []
    for cfg in (dict(TINY, rnn_type="GRU"), dict(TINY, bidirectional=False)):
        model = init_weights_(DPRNNTasNet(**cfg), torch.Generator().manual_seed(0)).eval()
        block = model.separation.dprnn_blocks[0]
        hook = block.register_forward_pre_hook(lambda m, args: seen.append(args[2]))
        mix = torch.randn(2, 160)
        with torch.no_grad():
            on = model(mix)
            monkeypatch.setenv("TSS_TM", "0")
            off = model(mix)
            monkeypatch.setenv("TSS_TM", "1")
        hook.remove()
        assert torch.equal(on, off)
    assert seen == [False] * 4


# --------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX DPRNNTasNet, its variables, the port's model on those weights):
    the port's seeded weights, carried to JAX by the JAX package's converter
    (no JAX init) and back by ``state_dict_from_jax``."""
    from tss_dprnn_tpu.models.dprnn import DPRNNTasNet as JaxTasNet
    from tss_dprnn_tpu.utils.torch_convert import convert_state_dict

    seeded = init_weights_(DPRNNTasNet(**TINY), torch.Generator().manual_seed(1))
    variables = convert_state_dict(seeded.state_dict())
    port = DPRNNTasNet(**TINY)
    port.load_state_dict(state_dict_from_jax(variables, "ln", 2), strict=True)
    return JaxTasNet(**TINY, remat=True), variables, port


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_time_major_model_matches_jax_and_batch_major(tiny_pair, interpret, monkeypatch, masked):
    import jax
    import jax.numpy as jnp

    from tss_dprnn_tpu.ops import rnn as jax_rnn

    jmodel, variables, port = tiny_pair
    B_, T = 3, 100
    mix = np.random.default_rng(8).standard_normal((B_, T)).astype(np.float32)
    lengths = np.array([100, 71, 38], np.int32) if masked else None
    tmask = (np.arange(T)[None, :] < (lengths if masked else np.full(B_, T))[:, None])
    tmask = tmask.astype(np.float32)[:, None, :]
    monkeypatch.setenv("TSS_TM", "1")

    def jax_loss(params):
        out = jmodel.apply({"params": params}, mix,
                           lengths=None if lengths is None else jnp.asarray(lengths))
        return jnp.sum(jnp.square(out * tmask)), out

    with jax_rnn.lstm_backend("pallas"):  # read when traced, as TSS_TM
        (_, want_out), want_g = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
            variables["params"])
    want_g = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, {"params": want_g}), "ln",
                                 2)

    def port_run(tm):
        monkeypatch.setenv("TSS_TM", "1" if tm else "0")
        port.zero_grad(set_to_none=True)
        out = port(torch.from_numpy(mix), None if lengths is None else torch.from_numpy(lengths))
        (out * torch.from_numpy(tmask)).square().sum().backward()
        return out.detach().numpy() * tmask, {k: p.grad.clone() for k, p in
                                              port.named_parameters()}

    calls = []
    real = R.lstm_pair_tm
    monkeypatch.setattr(R, "lstm_pair_tm", lambda *a, **k: calls.append(1) or real(*a, **k))
    out_tm, g_tm = port_run(True)
    assert len(calls) == 2 * TINY["n_repeats"]  # both scans of every block took the lane
    out_bm, g_bm = port_run(False)
    assert len(calls) == 2 * TINY["n_repeats"]
    assert _snr_db(out_tm, np.asarray(want_out) * tmask) >= MODEL_SNR_DB
    assert _snr_db(out_tm, out_bm) >= LAYOUT_SNR_DB
    assert set(g_tm) == set(want_g)
    for k, g in g_tm.items():
        assert _snr_db(g.numpy(), want_g[k].numpy()) >= MODEL_SNR_DB, k
        assert _snr_db(g.numpy(), g_bm[k].numpy()) >= LAYOUT_SNR_DB, k


def test_checkpointed_blocks_and_tap_keep_the_layout(tiny_pair, monkeypatch):
    """Under TSS_TM=1 checkpoint_blocks gives the same gradients, and a
    resumed call (IRA's second pass) gives the full call's masks: the tap is
    in the blocks' working layout."""
    _, _, port = tiny_pair
    monkeypatch.setenv("TSS_TM", "1")
    sep = port.separation
    h = torch.randn(2, 80, TINY["feature_size"])
    chunk_lengths = torch.tensor([17, 9])
    grads = []
    for k in (0, 1):
        port.zero_grad(set_to_none=True)
        out = DPRNNCore.forward(sep, h, None, chunk_lengths, checkpoint_blocks=k)
        out.square().sum().backward()
        grads.append({n: p.grad.clone() for n, p in sep.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() and all(
        torch.equal(grads[0][n], grads[1][n]) for n in grads[0])
    with torch.no_grad():
        _, tap = DPRNNCore.forward(sep, h, None, chunk_lengths, tap_block=0)
        assert tap.shape[:2] == (TINY["chunk_length"], 2)  # [K, B, S, N]
        resumed = DPRNNCore.forward(sep, 0.5 * h, None, chunk_lengths, resume=(0, tap))
        want = DPRNNCore.forward(sep, 1.5 * h, None, chunk_lengths)
    torch.testing.assert_close(resumed, want, atol=1e-5, rtol=0)


# -------------------------------------------------------------- the export

def test_time_major_export_one_node_per_scan_and_decomposes(tiny_pair, monkeypatch):
    _, _, port = tiny_pair
    monkeypatch.setenv("TSS_TM", "1")
    T = 160
    exp = export.export_separation(port, 2, T)
    calls = [str(n.target) for n in exp.graph.nodes if n.op == "call_function"
             and B.OPS_NAMESPACE in str(n.target)]
    assert calls == [f"{B.OPS_NAMESPACE}.bilstm2_forward_tm.default",
                     f"{B.OPS_NAMESPACE}.bilstm2_forward_masked_tm.default"]
    mix = torch.from_numpy(np.random.default_rng(9).standard_normal((2, T)).astype(np.float32))
    lengths = torch.tensor([T, 101], dtype=torch.int32)
    with torch.no_grad():
        want = port(mix, lengths=lengths)
        got = exp.module()(mix, lengths)
        plain = exp.run_decompositions(dict(B.PLAIN_BODIES))  # what backend "xla" runs
        targets = [str(n.target) for n in plain.graph.nodes if n.op == "call_function"]
        assert not [t for t in targets if B.OPS_NAMESPACE in t]
        got_plain = plain.module()(mix, lengths)
    assert torch.equal(got, want) and torch.equal(got_plain, want)


# ----------------------------------------------------------------- the card

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_card_entries_equal_batch_major_route(dtype, masked):
    """On the card each time-major entry equals the batch-major route on the
    transposed input: the outputs, the seven streams, dx bit for bit; dW and
    db within DW_REL_TOL of their max (the products sum the row-steps in the
    other order). Ragged R and a width that is not a multiple of 16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    T, Rr, F, H = 37, 83, 20, 24
    g = torch.Generator().manual_seed(5)
    x = torch.randn(T, Rr, F, generator=g).to(dtype).to(dev)
    w = [(torch.randn(*s, generator=g) * k).to(dev) for s, k in
         (((2, F, 4 * H), 0.3), ((2, 4 * H), 0.1), ((2, H, 4 * H), 0.3))]
    lens = (torch.randint(0, T + 1, (Rr,), generator=g).int().to(dev) if masked else None)
    g0, g1 = (torch.randn(T, Rr, H, generator=g).to(dtype).to(dev) for _ in range(2))
    if masked:
        g0 = g0 * (torch.arange(T, device=dev)[:, None] < lens[None, :])[..., None]
    xb = x.transpose(0, 1).contiguous()

    def bm(t):
        return t.transpose(0, 1).contiguous()

    before = B.bilstm2_forward_tm.launches + B.bilstm2_forward_masked_tm.launches
    if masked:
        out = B.bilstm2_forward_masked_tm(x, lens, *w)
        want = B.bilstm2_forward_masked(xb, lens, *w)
        outs, resid = B.bilstm2_forward_resid_masked_tm(x, lens, *w)
        want_outs, want_resid = B.bilstm2_forward_resid_masked(xb, lens, *w)
        grads = B.bilstm2_backward_tm(x, resid, g0, g1, *w, lens)
        want_grads = B.bilstm2_backward_masked(xb, want_resid, bm(g0), bm(g1), *w, lens)
    else:
        out = B.bilstm2_forward_tm(x, *w)
        want = B.bilstm2_forward(xb, *w)
        outs, resid = B.bilstm2_forward_resid_tm(x, *w)
        want_outs, want_resid = B.bilstm2_forward_resid(xb, *w)
        grads = B.bilstm2_backward_tm(x, resid, g0, g1, *w)
        want_grads = B.bilstm2_backward(xb, want_resid, bm(g0), bm(g1), *w)
    assert B.bilstm2_forward_tm.launches + B.bilstm2_forward_masked_tm.launches == before + 1
    for got, ref in zip((*out, *outs, *resid, grads[0]),
                        (*want, *want_outs, *want_resid, want_grads[0])):
        assert torch.equal(bm(got), ref)
    for got, ref in zip(grads[1:], want_grads[1:]):
        assert float((got - ref).abs().max()) <= DW_REL_TOL * float(ref.abs().max())
