"""The training side of the port's fused bidirectional LSTM: the residual
forward and the backward (tss_dprnn_tpu_torch.ops.bilstm2), and the
autograd Function that ``lstm_pair`` takes when gradients are recorded,
against the JAX package's Pallas entries in interpret mode on the CPU.

On a CPU tensor each entry runs its plain PyTorch version, so these tests
hold those versions' contract against the TPU kernels'. Tolerances: 1e-5
absolute for the forward and its residual streams, the saved gate
pre-activations among them (fp32, sums in another order); 1e-4 absolute for
the backward, whose dW and db are sums over all
R * T row-steps. The plain backward is also held against torch.autograd
through the plain forward, an oracle independent of the hand derivation.
The CUDA kernels are compared with the plain versions on the card (the
``cuda`` tests below and chip_smoke.py)."""

import functools

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch.ops import bilstm2 as port
from tss_dprnn_tpu_torch.ops import rnn as port_rnn

ATOL_FWD = 1e-5
ATOL_BWD = 1e-4
STREAMS = ("hp0", "cp0", "tc0", "hp1", "cp1", "tc1")


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _weights(rng, F, H):
    w_ih2 = (rng.standard_normal((2, F, 4 * H)) * 0.3).astype(np.float32)
    b2 = (rng.standard_normal((2, 4 * H)) * 0.1).astype(np.float32)
    w_hh2 = (rng.standard_normal((2, H, 4 * H)) * 0.3).astype(np.float32)
    return w_ih2, b2, w_hh2


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _jax_streams(resid, R, T):
    """The JAX entries' padded time-major streams [Tp, Rp, H] -> [R, T, H]."""
    return [np.swapaxes(np.asarray(s)[:T, :R], 0, 1) for s in resid[1:]]


def _cotangents(rng, R, T, H, lens=None):
    g0 = rng.standard_normal((R, T, H)).astype(np.float32)
    g1 = rng.standard_normal((R, T, H)).astype(np.float32)
    if lens is not None:  # as the DPRNN block's masked norm makes it (tested below)
        g0[np.arange(T)[None, :] >= lens[:, None]] = 0
    return g0, g1


# R not a multiple of 8, T not a multiple of the TPU kernel's unroll (5)
SHAPES = [(3, 12), (11, 7), (6, 10)]
MASKED = [(5, 13, [13, 1, 7, 12, 4]), (9, 6, [6, 6, 5, 4, 3, 2, 1, 6, 2])]


@pytest.mark.parametrize("R,T", SHAPES)
def test_resid_forward_matches_pallas(rng, interpret, R, T):
    from tss_dprnn_tpu.ops import pallas_lstm

    F, H = 16, 16
    x = rng.standard_normal((R, T, F)).astype(np.float32)
    w = _weights(rng, F, H)
    (want0, want1), want_resid = pallas_lstm.bilstm2_forward_resid(x, *w)
    before = port.launch_count()
    (got0, got1), got_resid = port.bilstm2_forward_resid(*_torch(x, *w))
    assert port.launch_count() == before  # a CPU tensor runs the plain version
    np.testing.assert_allclose(got0.numpy(), np.asarray(want0), atol=ATOL_FWD, rtol=0)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=ATOL_FWD, rtol=0)
    for name, got, want in zip(STREAMS, got_resid, _jax_streams(want_resid, R, T)):
        assert got.shape == (R, T, H) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL_FWD, rtol=0, err_msg=name)


@pytest.mark.parametrize("R,T,lens", MASKED)
def test_resid_forward_masked_matches_pallas(rng, interpret, R, T, lens):
    from tss_dprnn_tpu.ops import pallas_lstm

    F, H = 16, 16
    lens = np.asarray(lens, np.int32)
    x = rng.standard_normal((R, T, F)).astype(np.float32)
    w = _weights(rng, F, H)
    (want0, want1), want_resid = pallas_lstm.bilstm2_forward_resid_masked(x, lens, *w)
    (got0, got1), got_resid = port.bilstm2_forward_resid_masked(*_torch(x, lens, *w))
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=ATOL_FWD, rtol=0)
    want_streams = _jax_streams(want_resid, R, T)
    held = np.arange(T)[None, :] >= lens[:, None]
    for name, got, want in zip(STREAMS, got_resid, want_streams):
        for r, n in enumerate(lens):  # every stream on t < len
            np.testing.assert_allclose(got.numpy()[r, :n], want[r, :n], atol=ATOL_FWD, rtol=0,
                                       err_msg=name)
    for name in ("hp1", "cp1"):  # direction 1 holds the zero state on held steps
        assert np.all(got_resid[STREAMS.index(name)].numpy()[held] == 0)
        assert np.all(want_streams[STREAMS.index(name)][held] == 0)
    for r, n in enumerate(lens):
        np.testing.assert_allclose(got0.numpy()[r, :n], np.asarray(want0)[r, :n], atol=ATOL_FWD,
                                   rtol=0)


def _pre_from_jax(x, w, jax_resid, R, T):
    """x @ W_ih[d] + h_prev @ W_hh[d] + b[d] from the JAX entries' h_prev
    streams, in float64: [R, T, 2, 4H]."""
    w_ih2, b2, w_hh2 = (np.asarray(a, np.float64) for a in w)
    hp = _jax_streams(jax_resid, R, T)
    return np.stack([x.astype(np.float64) @ w_ih2[d] + hp[3 * d].astype(np.float64) @ w_hh2[d]
                     + b2[d] for d in (0, 1)], axis=2)


@pytest.mark.parametrize("R,T,lens", [(R, T, None) for R, T in SHAPES] + MASKED)
def test_resid_pre_matches_jax_streams(rng, interpret, R, T, lens):
    """The seventh residual stream: the gate pre-activations of every
    row-step and direction, as the backward reads them, against the ones
    built from the JAX entries' h_prev streams (on live steps when masked)."""
    from tss_dprnn_tpu.ops import pallas_lstm

    F, H = 16, 16
    x = rng.standard_normal((R, T, F)).astype(np.float32)
    w = _weights(rng, F, H)
    if lens is None:
        _, jax_resid = pallas_lstm.bilstm2_forward_resid(x, *w)
        _, resid = port.bilstm2_forward_resid(*_torch(x, *w))
        live = np.ones((R, T), bool)
    else:
        lens = np.asarray(lens, np.int32)
        _, jax_resid = pallas_lstm.bilstm2_forward_resid_masked(x, lens, *w)
        _, resid = port.bilstm2_forward_resid_masked(*_torch(x, lens, *w))
        live = np.arange(T)[None, :] < lens[:, None]
    assert len(resid) == 7
    pre = resid[6]
    assert pre.shape == (R, T, 2, 4 * H) and pre.dtype == torch.float32
    np.testing.assert_allclose(pre.numpy()[live], _pre_from_jax(x, w, jax_resid, R, T)[live],
                               atol=ATOL_FWD, rtol=0)


def test_backward_reads_saved_pre(rng):
    """The backward takes the gates from the saved pre-activations and
    recomputes none: moving one saved gate moves that direction's dW_hh
    and no other, and another forward's pre moves db."""
    R, T, F, H = 4, 6, 16, 16
    x = rng.standard_normal((R, T, F)).astype(np.float32)
    w = _weights(rng, F, H)
    g0, g1 = _cotangents(rng, R, T, H)
    xt, *wt = _torch(x, *w)
    gt = _torch(g0, g1)
    _, resid = port.bilstm2_resid_reference(xt, *wt)
    want = port.bilstm2_backward_reference(xt, resid, *gt, *wt)
    moved = resid[6].clone()
    moved[1, 2, 0, :H] += 0.5  # direction 0's input gate at one row-step
    got = port.bilstm2_backward_reference(xt, (*resid[:6], moved), *gt, *wt)
    assert not torch.equal(got[3][0], want[3][0])
    torch.testing.assert_close(got[3][1], want[3][1], atol=0, rtol=0)  # direction 1 untouched
    # x's own streams with another forward's gates: db follows the gates
    x2 = torch.from_numpy(rng.standard_normal((R, T, F)).astype(np.float32))
    _, resid2 = port.bilstm2_resid_reference(x2, *wt)
    swapped = port.bilstm2_backward_reference(xt, (*resid[:6], resid2[6]), *gt, *wt)
    assert not torch.allclose(swapped[2], want[2])


@pytest.mark.parametrize("R", [1, 15, 970, 1250, 2000, 5136])
@pytest.mark.parametrize("max_clusters", [1, 8, 62, 66, 132])
def test_tile_planner(R, max_clusters):
    """Every row in exactly one tile; one wave where a compiled height gives
    one, and then the smallest such height."""
    plan = port.plan_tiles(R, dict.fromkeys(port.TILE_HEIGHTS, max_clusters))
    assert plan.height in port.TILE_HEIGHTS
    covered = np.zeros(R, int)
    for tile in range(plan.tiles):  # tile i holds rows i * height .. (i + 1) * height - 1
        first = tile * plan.height
        assert first < R
        covered[first:first + plan.height] += 1
    assert np.all(covered == 1)
    fits = [h for h in port.TILE_HEIGHTS if 2 * -(-R // h) <= max_clusters]
    if fits:
        assert plan.clusters <= max_clusters and plan.height == fits[0]
    else:
        waves = -(-plan.clusters // max_clusters)
        assert all(waves * plan.height <= -(-2 * -(-R // h) // max_clusters) * h
                   for h in port.TILE_HEIGHTS)


def test_tile_planner_rejects_no_cluster():
    with pytest.raises(ValueError, match="no cluster"):
        port.plan_tiles(970, dict.fromkeys(port.TILE_HEIGHTS, 0))


@pytest.mark.parametrize("R,T", SHAPES)
def test_backward_matches_pallas(rng, interpret, R, T):
    from tss_dprnn_tpu.ops import pallas_lstm

    F, H = 16, 16
    x = rng.standard_normal((R, T, F)).astype(np.float32)
    w = _weights(rng, F, H)
    g0, g1 = _cotangents(rng, R, T, H)
    _, jax_resid = pallas_lstm.bilstm2_forward_resid(x, *w)
    want = pallas_lstm.bilstm2_backward(*jax_resid, g0, g1, *w)
    xt, *wt = _torch(x, *w)
    _, resid = port.bilstm2_forward_resid(xt, *wt)
    got = port.bilstm2_backward(xt, resid, *_torch(g0, g1), *wt)
    for name, a, b in zip(("dx", "dw_ih2", "db2", "dw_hh2"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL_BWD, rtol=0, err_msg=name)


@pytest.mark.parametrize("R,T,lens", MASKED)
def test_backward_masked_matches_pallas(rng, interpret, R, T, lens):
    """Direction 1's held steps give nothing; out0's cotangent is zero past
    each row's length, as every consumer of the masked scan masks there."""
    from tss_dprnn_tpu.ops import pallas_lstm

    F, H = 16, 16
    lens = np.asarray(lens, np.int32)
    x = rng.standard_normal((R, T, F)).astype(np.float32)
    w = _weights(rng, F, H)
    g0, g1 = _cotangents(rng, R, T, H, lens)
    _, jax_resid = pallas_lstm.bilstm2_forward_resid_masked(x, lens, *w)
    want = pallas_lstm.bilstm2_backward_masked(*jax_resid, g0, g1, *w, lens)
    xt, lt, *wt = _torch(x, lens, *w)
    _, resid = port.bilstm2_forward_resid_masked(xt, lt, *wt)
    got = port.bilstm2_backward_masked(xt, resid, *_torch(g0, g1), *wt, lt)
    for name, a, b in zip(("dx", "dw_ih2", "db2", "dw_hh2"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL_BWD, rtol=0, err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_plain_backward_matches_autograd(rng, masked):
    """The hand-derived plain backward against torch.autograd through the
    plain forward: an oracle that shares none of its arithmetic."""
    R, T, F, H = 7, 9, 16, 16
    lens = np.array([9, 1, 4, 9, 6, 2, 8], np.int32) if masked else None
    x = rng.standard_normal((R, T, F)).astype(np.float32)
    w = _weights(rng, F, H)
    g0, g1 = _cotangents(rng, R, T, H, lens)
    xt, *wt = _torch(x, *w)
    lt = None if lens is None else torch.from_numpy(lens)
    leaves = [t.clone().requires_grad_() for t in (xt, *wt)]
    out0, out1 = port.bilstm2_reference(*leaves, lt)
    (out0 * torch.from_numpy(g0) + out1 * torch.from_numpy(g1)).sum().backward()
    want = [t.grad for t in leaves]  # dx, dw_ih2, db2, dw_hh2
    _, resid = port.bilstm2_resid_reference(xt, *wt, lt)
    got = port.bilstm2_backward_reference(xt, resid, *_torch(g0, g1), *wt, lt)
    for name, a, b in zip(("dx", "dw_ih2", "db2", "dw_hh2"), got, want):
        torch.testing.assert_close(a, b, atol=ATOL_BWD, rtol=0, msg=name)


def _lstm_weights(w_ih2, b2, w_hh2):
    """Direction d of the stacked weights as LSTMWeights of either package."""
    from tss_dprnn_tpu.ops import rnn as jax_rnn

    return [jax_rnn.LSTMWeights(w_ih2[d], w_hh2[d], b2[d]) for d in (0, 1)]


@pytest.mark.parametrize("lens", [None, [9, 3, 7, 1, 9]])
def test_lstm_pair_grad_matches_jax(rng, interpret, lens):
    """The Function's gradients against jax.grad of the JAX package's
    lstm_pair on its Pallas lane (the kernels' custom VJPs)."""
    import jax
    import jax.numpy as jnp

    from tss_dprnn_tpu.ops import rnn as jax_rnn

    R, T, F, H = 5, 9, 16, 16
    lens = None if lens is None else np.asarray(lens, np.int32)
    x = rng.standard_normal((R, T, F)).astype(np.float32)
    w = _weights(rng, F, H)
    c0, c1 = _cotangents(rng, R, T, H, lens)

    def jax_loss(x, w_ih2, b2, w_hh2):
        fwd, bwd = _lstm_weights(w_ih2, b2, w_hh2)
        with jax_rnn.lstm_backend("pallas"):
            o0, o1 = jax_rnn.lstm_pair(x, fwd, bwd, None if lens is None else jnp.asarray(lens))
        return jnp.sum(o0 * c0) + jnp.sum(o1 * c1)

    want_loss, want = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3))(x, *w)
    leaves = [t.clone().requires_grad_() for t in _torch(x, *w)]
    lt = None if lens is None else torch.from_numpy(lens)
    before = port.launch_count()
    o0, o1 = port_rnn.lstm_pair(leaves[0], tuple(leaves[1:]), lt)
    assert type(o0.grad_fn).__name__.startswith("BiLSTM2")  # the training Function
    loss = (o0 * torch.from_numpy(c0)).sum() + (o1 * torch.from_numpy(c1)).sum()
    loss.backward()
    assert port.launch_count() == before  # CPU tensors launch no kernel
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for name, t, b in zip(("dx", "dw_ih2", "db2", "dw_hh2"), leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(b), atol=ATOL_BWD, rtol=0,
                                   err_msg=name)


def _block_state_dict(tree):
    """A JAX DPRNNBlock's params (or their gradients) under the port's names."""
    from tss_dprnn_tpu_torch.utils import weights

    out = {}
    for part in ("intra", "inter"):
        weights._rnn_entries(out, f"{part}_rnn.rnn", tree[f"{part}_rnn"])
        weights._dense_entries(out, f"{part}_linear", tree[f"{part}_linear"])
        weights._norm_entries(out, f"{part}_norm", tree[f"{part}_norm"], "ln")
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def test_masked_block_grad_matches_jax(rng, interpret):
    """Chunk lengths through a DPRNN block, the masked scan's consumer.

    The port's masked backward gives nothing for steps past a row's length
    in either direction, where the JAX kernel skips only direction 1's. The
    two agree only if out0's cotangent is zero past the length. Here it
    comes from the block's own masked norm, so the gradients of every
    parameter and of x must match ``jax.grad`` of the JAX block (its Pallas
    lane), within 1e-4 of each tensor's max |grad|."""
    import jax
    import jax.numpy as jnp

    from tss_dprnn_tpu.models.dprnn import DPRNNBlock as JaxBlock
    from tss_dprnn_tpu.ops import rnn as jax_rnn
    from tss_dprnn_tpu_torch.models.dprnn import DPRNNBlock

    B, S, K, N, H = 2, 7, 5, 16, 16
    x = rng.standard_normal((B, S, K, N)).astype(np.float32)
    cot = rng.standard_normal((B, S, K, N)).astype(np.float32)
    chunk_lengths = np.array([7, 3], np.int32)
    jblock = JaxBlock(N, H, norm_type="ln")
    params = jblock.init(jax.random.PRNGKey(0), x, chunk_lengths)["params"]

    def jax_loss(params, x):
        with jax_rnn.lstm_backend("pallas"):
            return jnp.sum(jblock.apply({"params": params}, x, chunk_lengths) * cot)

    want_loss, (want_params, want_dx) = jax.value_and_grad(jax_loss, argnums=(0, 1))(params, x)
    block = DPRNNBlock(N, H, "ln")
    block.load_state_dict(_block_state_dict(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    out = block(xt, torch.from_numpy(chunk_lengths))
    assert out.grad_fn is not None
    loss = (out * torch.from_numpy(cot)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = dict(_block_state_dict(want_params), x=torch.from_numpy(np.array(want_dx)))
    got = dict(((k, p.grad) for k, p in block.named_parameters()), x=xt.grad)
    assert set(got) == set(want)
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, atol=1e-4 * float(w.abs().max()), rtol=0, msg=k)


def test_lstm_pair_without_grad_takes_inference_entry(rng):
    R, T, F, H = 3, 5, 16, 16
    x = torch.from_numpy(rng.standard_normal((R, T, F)).astype(np.float32))
    w = [t.requires_grad_() for t in _torch(*_weights(rng, F, H))]
    with torch.no_grad():
        o0, o1 = port_rnn.lstm_pair(x, tuple(w))
    assert o0.grad_fn is None and o1.grad_fn is None
    g0, g1 = port_rnn.lstm_pair(x, tuple(w))
    torch.testing.assert_close(g0, o0, atol=0, rtol=0)
    torch.testing.assert_close(g1, o1, atol=0, rtol=0)


# ---------------------------------------------------------------- on the card

def _card_case(masked, R=70, T=33, F=128, H=128, seed=0, edge_lens=False):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((R, T, F)).astype(np.float32)).cuda()
    w = [t.cuda() for t in _torch(*_weights(rng, F, H))]
    w = [w[0] * 0.3, w[1], w[2] * 0.3]
    lens = None
    if masked:
        ln = rng.integers(0 if edge_lens else 1, T + 1, R).astype(np.int32)
        if edge_lens:  # rows of length 0 and T
            ln[::3], ln[1::5] = 0, T
        lens = torch.from_numpy(ln).cuda()
    g0, g1 = (torch.from_numpy(g).cuda()
              for g in _cotangents(rng, R, T, H, None if lens is None else lens.cpu().numpy()))
    return x, w, lens, g0, g1


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_resid_kernel_matches_reference_on_card(masked):
    """On the card (``python -m pytest --noconftest -m cuda
    tests/test_torch_port_bilstm2_grad.py``): 1e-4 absolute, fp32, on the
    region the contract specifies, the saved pre-activations included."""
    _needs_card()
    x, w, lens, _, _ = _card_case(masked)
    before = port.bilstm2_forward_resid_masked.launches if masked else \
        port.bilstm2_forward_resid.launches
    if masked:
        got = port.bilstm2_forward_resid_masked(x, lens, *w)
        assert port.bilstm2_forward_resid_masked.launches == before + 1
    else:
        got = port.bilstm2_forward_resid(x, *w)
        assert port.bilstm2_forward_resid.launches == before + 1
    want = port.bilstm2_resid_reference(x, *w, lens)
    T = x.shape[1]
    valid = (torch.ones(x.shape[:2], dtype=torch.bool, device="cuda") if lens is None
             else torch.arange(T, device="cuda")[None, :] < lens[:, None])
    torch.testing.assert_close(got[0][1], want[0][1], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[0][0][valid], want[0][0][valid], atol=1e-4, rtol=0)
    for name, a, b in zip(STREAMS + ("pre",), got[1], want[1]):
        torch.testing.assert_close(a[valid], b[valid], atol=1e-4, rtol=0, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_backward_kernel_matches_reference_on_card(masked):
    """dx within 1e-4; dW and db within 1e-3 of the plain version, as
    sums over R * T = 2,310 row-steps in another order, and bit for bit
    the same on a second call (fixed summation order, no atomics)."""
    _needs_card()
    x, w, lens, g0, g1 = _card_case(masked)
    _, resid = port.bilstm2_resid_reference(x, *w, lens)
    entry = port.bilstm2_backward_masked if masked else port.bilstm2_backward

    def run():
        if masked:
            return port.bilstm2_backward_masked(x, resid, g0, g1, *w, lens)
        return port.bilstm2_backward(x, resid, g0, g1, *w)

    before = entry.launches
    got = run()
    again = run()
    assert entry.launches == before + 2
    want = port.bilstm2_backward_reference(x, resid, g0, g1, *w, lens)
    for name, a, b, again_ in zip(("dx", "dw_ih2", "db2", "dw_hh2"), got, want, again):
        torch.testing.assert_close(a, b, atol=1e-4 if name == "dx" else 1e-3, rtol=0, msg=name)
        assert torch.equal(a, again_), name


# ragged R that no tile height divides, T = 1, lengths of 0 and T
RAGGED_CARD = [(37, 9, False), (1001, 17, False), (37, 1, False), (1001, 1, True),
               (37, 21, True), (203, 13, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,T,masked", RAGGED_CARD)
def test_training_pair_ragged_on_card(R, T, masked):
    """Both cluster scans and their products on shapes the tile planner
    cannot tile evenly: the forward's outputs and seven streams within 1e-4
    on the contract's region, the backward's dx within 1e-4 and dW/db within
    1e-3, both bit for bit the same on a second call."""
    _needs_card()
    x, w, lens, g0, g1 = _card_case(masked, R=R, T=T, edge_lens=masked)

    def fwd():
        if masked:
            return port.bilstm2_forward_resid_masked(x, lens, *w)
        return port.bilstm2_forward_resid(x, *w)

    got, again = fwd(), fwd()
    want = port.bilstm2_resid_reference(x, *w, lens)
    valid = (torch.ones(R, T, dtype=torch.bool, device="cuda") if lens is None
             else torch.arange(T, device="cuda")[None, :] < lens[:, None])
    torch.testing.assert_close(got[0][1], want[0][1], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[0][0][valid], want[0][0][valid], atol=1e-4, rtol=0)
    for name, a, b, a2 in zip(STREAMS + ("pre",), got[1], want[1], again[1]):
        torch.testing.assert_close(a[valid], b[valid], atol=1e-4, rtol=0, msg=name)
        assert torch.equal(a, a2), name
    resid = want[1]
    if masked:
        g0 = g0 * valid[..., None]
        grads = [port.bilstm2_backward_masked(x, resid, g0, g1, *w, lens) for _ in range(2)]
    else:
        grads = [port.bilstm2_backward(x, resid, g0, g1, *w) for _ in range(2)]
    ref = port.bilstm2_backward_reference(x, resid, g0, g1, *w, lens)
    for name, a, b, a2 in zip(("dx", "dw_ih2", "db2", "dw_hh2"), grads[0], ref, grads[1]):
        torch.testing.assert_close(a, b, atol=1e-4 if name == "dx" else 1e-3, rtol=0, msg=name)
        assert torch.equal(a, a2), name


@pytest.mark.cuda
@pytest.mark.parametrize("a_col,two_parts,split,bias", [
    (False, False, False, True), (False, True, False, False), (True, False, True, False),
    (False, False, True, False), (True, True, True, False)])
def test_product_kernel_on_card(a_col, two_parts, split, bias):
    """csrc/products.cu against a float64 product: ragged M and N, one or two
    parts, row or column layout of A, split-K partials; within 1e-4 of the
    largest |C| and bit for bit the same on a second call."""
    _needs_card()
    g = torch.Generator().manual_seed(3)
    # column layout takes M a multiple of 4
    M, N, k1, k2 = 1004 if a_col else 1003, 196, 144, 128 if two_parts else 0
    lib = port._library_products()
    stream = torch.cuda.current_stream().cuda_stream
    mats = [torch.randn(M, k1, generator=g), torch.randn(k1, N, generator=g),
            torch.randn(M, k2, generator=g), torch.randn(k2, N, generator=g)]
    want = mats[0].double() @ mats[1].double() + mats[2].double() @ mats[3].double()
    b = torch.randn(N, generator=g)
    if bias:
        want += b.double()
    a1, b1, a2, b2 = (t.cuda() for t in mats)
    if a_col:  # A given as its transpose, element (m, k) at a[k * M + m]
        a1, a2 = a1.T.contiguous(), a2.T.contiguous()
    lda = (M, M) if a_col else (k1, k2)
    parts = [(a1, 0, lda[0], b1, 0, N, k1)] + ([(a2, 0, lda[1], b2, 0, N, k2)] if two_parts else [])

    def run():
        if split:
            return port._gemm(lib, stream, a_col, parts, M, N)
        out = torch.empty(M, N, device="cuda")
        port._gemm(lib, stream, a_col, parts, M, N, out=out, ldc=N,
                   bias=b.cuda() if bias else None)
        return out

    got, again = run(), run()
    torch.cuda.synchronize()
    torch.testing.assert_close(got.double().cpu(), want, atol=1e-4 * float(want.abs().max()),
                               rtol=0)
    assert torch.equal(got, again)
