"""The port's stacked-direction LSTM scan (tss_dprnn_tpu_torch.ops.lstm): the
three forward modes, the backward and the autograd Function that
``ops.rnn.lstm_stack`` takes when gradients are recorded, against the JAX
package's Pallas entries in interpret mode on the CPU.

On a CPU tensor each entry runs its plain PyTorch version, so these tests
hold those versions' contract (D directions, each on its own input in
forward time; torch gate order; fp32 cell state) against the TPU kernels'.
The JAX entries are time-major and pad time to their unroll (5) and rows to
8: T = 11 and R = 3 exercise both pads, and the results are transposed to the
port's [D, R, T, .] layout. Tolerances: 2e-5 (absolute and relative) for the
forward modes (fp32, sums in another order); gradients within 1e-4 of each
tensor's max |ref| (dW and db are sums over all R * T row-steps). The plain
backward is also held against torch.autograd through the plain forward, an
oracle independent of the hand derivation. The CUDA kernels are compared with
the plain versions on the card (the ``cuda`` tests below and chip_smoke.py)."""

import functools

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch.ops import lstm as port
from tss_dprnn_tpu_torch.ops import rnn as port_rnn

TOL_FWD = dict(atol=2e-5, rtol=2e-5)
GRAD_REL = 1e-4
GRADS = ("dx", "dw_ih", "db", "dw_hh")
# (D, R, T): T = 11 pads the TPU kernel's unroll, R = 3 its 8-row tiles
SHAPES = [(1, 3, 11), (2, 3, 11), (1, 9, 10), (2, 5, 1)]


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _case(rng, D, R, T, F=16, H=16):
    x = rng.standard_normal((D, R, T, F)).astype(np.float32)
    w_ih = (rng.standard_normal((D, F, 4 * H)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((D, 4 * H)) * 0.1).astype(np.float32)
    w_hh = (rng.standard_normal((D, H, 4 * H)) * 0.3).astype(np.float32)
    return x, (w_ih, b, w_hh)


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _from_tm(a):
    """The JAX entries' [T, D, R, H] -> the port's [D, R, T, H]."""
    return np.transpose(np.asarray(a), (1, 2, 0, 3))


def _from_kernel_layout(a, R, T):
    """The JAX residual streams' padded [D, Tp, Rp, H] -> [D, R, T, H]."""
    return np.swapaxes(np.asarray(a)[:, :T, :R], 1, 2)


def _assert_grads_close(got, want):
    for name, a, b in zip(GRADS, got, want):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), b, atol=GRAD_REL * np.abs(b).max(), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("D,R,T", SHAPES)
def test_lstm_forward_matches_pallas(rng, interpret, D, R, T):
    from tss_dprnn_tpu.ops import pallas_lstm

    x, w = _case(rng, D, R, T)
    want = _from_tm(pallas_lstm.lstm_forward(x, *w))
    before = port.launch_count()
    got = port.lstm_forward(*_torch(x, *w))
    assert port.launch_count() == before  # a CPU tensor runs the plain version
    np.testing.assert_allclose(got.numpy(), want, **TOL_FWD)


@pytest.mark.parametrize("D,R,T", SHAPES)
def test_lstm_forward_with_cs_matches_pallas(rng, interpret, D, R, T):
    from tss_dprnn_tpu.ops import pallas_lstm

    x, w = _case(rng, D, R, T)
    want_h, want_c = (_from_tm(a) for a in pallas_lstm.lstm_forward_with_cs(x, *w))
    got_h, got_c = port.lstm_forward_with_cs(*_torch(x, *w))
    assert got_c.dtype == torch.float32
    np.testing.assert_allclose(got_h.numpy(), want_h, **TOL_FWD)
    np.testing.assert_allclose(got_c.numpy(), want_c, **TOL_FWD)


@pytest.mark.parametrize("D,R,T", SHAPES)
def test_lstm_forward_resid_matches_pallas(rng, interpret, D, R, T):
    from tss_dprnn_tpu.ops import pallas_lstm

    x, w = _case(rng, D, R, T)
    want_h, _, *want_streams = pallas_lstm.lstm_forward_resid(x, *w)
    got_h, got_streams = port.lstm_forward_resid(*_torch(x, *w))
    np.testing.assert_allclose(got_h.numpy(), _from_tm(want_h), **TOL_FWD)
    assert len(got_streams) == 4
    for name, got, want in zip(("hp", "cp", "tc"), got_streams, want_streams):
        assert got.shape == (D, R, T, 16) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), _from_kernel_layout(want, R, T), **TOL_FWD,
                                   err_msg=name)
    assert torch.all(got_streams[0][:, :, 0] == 0) and torch.all(got_streams[1][:, :, 0] == 0)
    # the saved gate pre-activations: x_t @ W_ih + h_prev @ W_hh + b from the
    # JAX kernel's own h_prev stream
    w_ih, b, w_hh = w
    hp = _from_kernel_layout(want_streams[0], R, T)
    want_pre = (np.einsum("drtf,dfg->drtg", x, w_ih) + np.einsum("drth,dhg->drtg", hp, w_hh)
                + b[:, None, None])
    assert got_streams[3].shape == (D, R, T, 64) and got_streams[3].dtype == torch.float32
    np.testing.assert_allclose(got_streams[3].numpy(), want_pre, **TOL_FWD, err_msg="pre")


@pytest.mark.parametrize("D,R,T", SHAPES)
def test_lstm_backward_matches_pallas(rng, interpret, D, R, T):
    from tss_dprnn_tpu.ops import pallas_lstm

    x, w = _case(rng, D, R, T)
    g = rng.standard_normal((D, R, T, 16)).astype(np.float32)
    _, *jax_resid = pallas_lstm.lstm_forward_resid(x, *w)
    want = pallas_lstm.lstm_backward(*jax_resid, np.transpose(g, (2, 0, 1, 3)), *w)
    xt, *wt = _torch(x, *w)
    _, resid = port.lstm_forward_resid(xt, *wt)
    _assert_grads_close(port.lstm_backward(xt, resid, torch.from_numpy(g), *wt), want)


@pytest.mark.parametrize("D", [1, 2])
def test_plain_backward_matches_autograd(rng, D):
    """The hand-derived plain backward against torch.autograd through the
    plain forward: an oracle that shares none of its arithmetic. dx stays per
    direction: each direction has its own input."""
    R, T = 7, 9
    x, w = _case(rng, D, R, T)
    g = torch.from_numpy(rng.standard_normal((D, R, T, 16)).astype(np.float32))
    xt, *wt = _torch(x, *w)
    leaves = [t.clone().requires_grad_() for t in (xt, *wt)]
    (port.lstm_reference(*leaves) * g).sum().backward()
    _, resid = port.lstm_resid_reference(xt, *wt)
    _assert_grads_close(port.lstm_backward_reference(xt, resid, g, *wt),
                        [t.grad.numpy() for t in leaves])


def test_lstm_reference_bf16_rounds_h(rng):
    """bf16 streams: the output is bf16 and close to the fp32 run (h is
    rounded to bf16 before it feeds the next step)."""
    x, w = _case(rng, 2, 6, 10)
    xt, *wt = _torch(x, *w)
    lo = port.lstm_reference(xt.bfloat16(), *wt)
    hi = port.lstm_reference(xt.bfloat16().float(), *wt)
    assert lo.dtype == torch.bfloat16
    err = (lo.float() - hi).pow(2).sum() / hi.pow(2).sum()
    assert 10 * torch.log10(err) < -30  # >= 30 dB at this tiny size


def _jax_direction(w, d):
    from tss_dprnn_tpu.ops import rnn as jax_rnn

    w_ih, b, w_hh = w
    return jax_rnn.LSTMWeights(w_ih[d], w_hh[d], b[d])


def test_unidirectional_lstm_grad_matches_jax(rng, interpret):
    """``lstm(x, fwd, None)``: the Function's gradients against jax.grad of
    the JAX package's entry on its Pallas lane (``_recurrence``'s custom VJP
    at ``save_every == 1``). Lengths do not reach a forward-only scan."""
    import jax
    import jax.numpy as jnp

    from tss_dprnn_tpu.ops import rnn as jax_rnn

    R, T, H = 3, 11, 16
    x, w = _case(rng, 1, R, T)
    cot = rng.standard_normal((R, T, H)).astype(np.float32)
    lens = np.array([11, 4, 7], np.int32)

    def jax_loss(x, w_ih, b, w_hh):
        out = jax_rnn.lstm(x, _jax_direction((w_ih, b, w_hh), 0), None, jnp.asarray(lens))
        return jnp.sum(out * cot)

    with jax_rnn.lstm_backend("pallas"):  # the backward reads the backend too
        want_loss, want = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3))(x[0], *w)
    xt, w_ih, b, w_hh = (t.clone().requires_grad_() for t in _torch(x[0], *w))
    before = port.launch_count()
    out = port_rnn.lstm(xt, port_rnn.LSTMWeights(w_ih[0], w_hh[0], b[0]), None,
                        torch.from_numpy(lens))
    assert out.shape == (R, T, H)
    loss = (out * torch.from_numpy(cot)).sum()
    loss.backward()
    assert port.launch_count() == before  # CPU tensors launch no kernel
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _assert_grads_close([t.grad for t in (xt, w_ih, b, w_hh)], want)


def test_lstm_stack_grad_matches_jax(rng, interpret):
    """D = 2 through ``lstm_stack`` against jax.grad of ``_recurrence`` on its
    Pallas lane: different inputs per direction, dx per direction."""
    import jax
    import jax.numpy as jnp

    from tss_dprnn_tpu.ops import rnn as jax_rnn

    D, R, T, H = 2, 3, 11, 16
    x, w = _case(rng, D, R, T)
    cot = rng.standard_normal((D, R, T, H)).astype(np.float32)

    def jax_loss(x, w_ih, b, w_hh):
        hs = jax_rnn._recurrence(1, x, w_ih, b, w_hh)  # [T, D, R, H]
        return jnp.sum(jnp.transpose(hs, (1, 2, 0, 3)) * cot)

    with jax_rnn.lstm_backend("pallas"):  # the backward reads the backend too
        want_loss, want = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3))(x, *w)
    leaves = [t.clone().requires_grad_() for t in _torch(x, *w)]
    out = port_rnn.lstm_stack(leaves[0], tuple(leaves[1:]))
    assert type(out.grad_fn).__name__.startswith("LSTMStack")  # the training Function
    loss = (out * torch.from_numpy(cot)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _assert_grads_close([t.grad for t in leaves], want)


def test_lstm_stack_saves_four_streams_and_backs_twice_alike(rng, interpret):
    """LSTMStack's saved residual is the 4-tuple (hp, cp, tc, pre), pre
    against the Pallas entry's streams; a second backward through the same
    graph gives the same gradients (the backward writes dpre into its own
    buffer, never into the saved pre)."""
    from tss_dprnn_tpu.ops import pallas_lstm

    D, R, T, H = 2, 3, 11, 16
    x, w = _case(rng, D, R, T)
    cot = torch.from_numpy(rng.standard_normal((D, R, T, H)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in _torch(x, *w)]
    out = port_rnn.lstm_stack(leaves[0], tuple(leaves[1:]))
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 8 and saved[7].shape == (D, R, T, 4 * H)
    _, _, *want_streams = pallas_lstm.lstm_forward_resid(x, *w)
    for got, want in zip(saved[4:7], want_streams):
        np.testing.assert_allclose(got.numpy(), _from_kernel_layout(want, R, T), **TOL_FWD)
    first = torch.autograd.grad(out, leaves, cot, retain_graph=True)
    second = torch.autograd.grad(out, leaves, cot)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_lstm_without_grad_takes_inference_entry(rng):
    x, w = _case(rng, 1, 3, 5)
    xt, w_ih, b, w_hh = _torch(x[0], *w)
    fwd = port_rnn.LSTMWeights(w_ih[0].requires_grad_(), w_hh[0], b[0])
    with torch.no_grad():
        plain = port_rnn.lstm(xt, fwd)
    assert plain.grad_fn is None
    recorded = port_rnn.lstm(xt, fwd)
    assert recorded.grad_fn is not None
    torch.testing.assert_close(recorded, plain, atol=0, rtol=0)
    torch.testing.assert_close(plain, port.lstm_reference(xt[None], *_torch(*w))[0], atol=0, rtol=0)


def test_lstm_with_both_directions_is_the_concatenated_pair(rng):
    x, w = _case(rng, 2, 4, 6)
    xt, w_ih, b, w_hh = _torch(x[0], *w)
    fwd, bwd = (port_rnn.LSTMWeights(w_ih[d], w_hh[d], b[d]) for d in (0, 1))
    lens = torch.tensor([6, 2, 5, 1])
    out = port_rnn.lstm(xt, fwd, bwd, lens)
    o0, o1 = port_rnn.lstm_pair(xt, (w_ih, b, w_hh), lens)
    torch.testing.assert_close(out, torch.cat([o0, o1], -1), atol=0, rtol=0)
    # its forward half is the unidirectional scan
    torch.testing.assert_close(out[..., :16], port_rnn.lstm(xt, fwd), atol=0, rtol=0)


# ---------------------------------------------------------------- on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _card_case(D, R=70, T=33, F=128, H=128, seed=0):
    """R not a multiple of 8 or of the 16-row tile, T not a multiple of 5,
    different inputs per direction."""
    rng = np.random.default_rng(seed)
    x, (w_ih, b, w_hh) = _case(rng, D, R, T, F, H)
    g = rng.standard_normal((D, R, T, H)).astype(np.float32)
    xt, w_ih, b, w_hh, g = (t.cuda() for t in _torch(x, w_ih, b, w_hh, g))
    return xt, (w_ih * 0.3, b, w_hh * 0.3), g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_lstm_kernel_matches_reference_on_card(D, dtype):
    """On the card (the machine there has no JAX: run with
    ``python -m pytest --noconftest -m cuda tests/test_torch_port_lstm.py``).
    fp32: 1e-4 absolute. bf16 streams: 2^-7 and 70 dB against the bf16 plain
    version, which rounds h to bf16 before every next step as the kernel
    must."""
    _needs_card()
    x, w, _ = _card_case(D)
    x = x.to(dtype)
    before = port.lstm_forward.launches
    got = port.lstm_forward(x, *w)
    assert port.lstm_forward.launches == before + 1
    want = port.lstm_reference(x, *w)
    assert got.dtype == dtype
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, atol=1e-4 if dtype == torch.float32 else 2.0 ** -7,
                               rtol=0)
    if dtype == torch.bfloat16:
        snr = 10 * torch.log10(want.pow(2).sum() / (got - want).pow(2).sum().clamp_min(1e-30))
        assert snr >= 70.0


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 2, 3])
def test_lstm_training_forwards_match_reference_on_card(D):
    _needs_card()
    x, w, _ = _card_case(D)
    before = port.launch_count()
    h_cs, cs = port.lstm_forward_with_cs(x, *w)
    h, resid = port.lstm_forward_resid(x, *w)
    assert port.launch_count() == before + 2
    # the cell-state route is the h-only one's product and arithmetic, bit for
    # bit, and repeats itself
    again = port.lstm_forward_with_cs(x, *w)
    assert torch.equal(h_cs, port.lstm_forward(x, *w))
    assert torch.equal(h_cs, again[0]) and torch.equal(cs, again[1])
    want_h, want_cs = port.lstm_cs_reference(x, *w)
    _, want_resid = port.lstm_resid_reference(x, *w)
    torch.testing.assert_close(h_cs, want_h, atol=1e-4, rtol=0)
    torch.testing.assert_close(h, want_h, atol=1e-4, rtol=0)
    torch.testing.assert_close(cs, want_cs, atol=1e-4, rtol=0)
    for name, a, b in zip(("hp", "cp", "tc", "pre"), resid, want_resid, strict=True):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 2, 3])
def test_lstm_backward_kernel_matches_reference_on_card(D):
    """dx within 1e-4; dW and db within 1e-3 of the plain version, as sums
    over R * T = 2,310 row-steps in another order, and bit for bit the same
    on a second call (fixed summation order, no atomics)."""
    _needs_card()
    x, w, g = _card_case(D)
    _, resid = port.lstm_resid_reference(x, *w)
    before = port.lstm_backward.launches
    got = port.lstm_backward(x, resid, g, *w)
    again = port.lstm_backward(x, resid, g, *w)
    assert port.lstm_backward.launches == before + 2
    want = port.lstm_backward_reference(x, resid, g, *w)
    for name, a, b, again_ in zip(GRADS, got, want, again):
        torch.testing.assert_close(a, b, atol=1e-4 if name == "dx" else 1e-3, rtol=0, msg=name)
        assert torch.equal(a, again_), name


@pytest.mark.cuda
def test_lstm_want_cs_rejects_fp16():
    """The want_cs mode streams fp32 or bf16 (its bf16 mode is
    tests/test_torch_port_bf16_save_every.py's); fp16 raises before any
    launch."""
    _needs_card()
    x, w, g = _card_case(1, R=4, T=3, F=16, H=16)
    before = port.launch_count()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        port.lstm_forward_with_cs(x.half(), *w)
    assert port.launch_count() == before
