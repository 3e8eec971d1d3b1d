"""Widths the kernels do not take natively: the wrappers of the port's LSTM
kernels (ops/bilstm2.py, ops/lstm.py) zero-pad F and H up to multiples of 16
(H per gate block of i, f, g, o) and cut the pad off what they return.

The padding is exact: a padded unit's pre-activations are 0, so its c stays
0 and its h 0.5 * tanh(0) = 0, and its zero rows of W_hh feed nothing. So on
the CPU the padded composition the wrappers run on the card (pad, the
kernel's plain version at the padded widths, cut) must equal the plain
version at the call's own widths bit for bit, for every forward mode and both
backwards. On the card (``cuda`` tests, run there with ``python -m pytest
--noconftest -m cuda tests/test_torch_port_widths.py``) the kernels at these
widths are held against the plain versions: fp32 1e-4 absolute, dW and db
1e-3 (sums over R * T row-steps in another order)."""

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch.ops import bilstm2 as B
from tss_dprnn_tpu_torch.ops import lstm as L

WIDTHS = [(12, 10), (20, 24)]  # (F, H): neither a multiple of 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _weights(rng, D, F, H):
    return (_t((rng.standard_normal((D, F, 4 * H)) * 0.3).astype(np.float32)),
            _t((rng.standard_normal((D, 4 * H)) * 0.1).astype(np.float32)),
            _t((rng.standard_normal((D, H, 4 * H)) * 0.3).astype(np.float32)))


def _case(rng, F, H, R=5, T=7):
    x = _t(rng.standard_normal((R, T, F)).astype(np.float32))
    lens = torch.tensor([7, 1, 4, 6, 3][:R], dtype=torch.int32)
    return x, _weights(rng, 2, F, H), lens


def _assert_equal(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_equal(g, w)
        return
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)


def test_widths_pad_per_gate_block():
    p = B.Widths.of(12, 10)
    assert (p.Fp, p.Hp, p.padded) == (16, 16, True)
    b = torch.arange(40.0)
    got = p.gates(b)
    assert got.shape == (64,)
    for k in range(4):  # gate k's 10 units first, then 6 zeros
        assert torch.equal(got[16 * k:16 * k + 10], b[10 * k:10 * k + 10])
        assert torch.all(got[16 * k + 10:16 * (k + 1)] == 0)
    assert torch.equal(p.cut(got), b) and torch.equal(p.widen(b), got)
    w = torch.randn(2, 10, 40)
    assert p.w_hh(w).shape == (2, 16, 64) and torch.equal(p.cut(p.w_hh(w))[:, :10], w)
    h2 = torch.randn(3, 32)  # two directions side by side, 16 wide each
    assert torch.equal(p.cut(h2), torch.cat([h2[:, :10], h2[:, 16:26]], -1))
    assert not B.Widths.of(128, 128).padded
    x = torch.randn(3, 128)
    assert B.Widths.of(128, 128).feat(x) is x


@pytest.mark.parametrize("H", [0, 129, 256])
def test_widths_reject_h_outside_the_kernels(H):
    with pytest.raises(ValueError, match="H <= 128"):
        B.Widths.of(16, H)


@pytest.mark.parametrize("F,H", WIDTHS)
def test_padded_bilstm2_forwards_equal_unpadded(rng, F, H):
    x, w, lens = _case(rng, F, H)
    _assert_equal(B.padded(B.bilstm2_reference, x, *w), B.bilstm2_reference(x, *w))
    _assert_equal(B.padded(B.bilstm2_reference, x, *w, lens), B.bilstm2_reference(x, *w, lens))
    _assert_equal(B.padded(B.bilstm2_bm_reference, x, *w), B.bilstm2_bm_reference(x, *w))
    _assert_equal(B.padded(B.bilstm2_resid_reference, x, *w), B.bilstm2_resid_reference(x, *w))
    _assert_equal(B.padded(B.bilstm2_resid_reference, x, *w, lens),
                  B.bilstm2_resid_reference(x, *w, lens))
    wo2 = _t((rng.standard_normal((2, H, F)) * 0.3).astype(np.float32))  # SplitDense 2H -> F
    _assert_equal(B.padded_dense(B.bilstm2_dense_reference, x, *w, wo2),
                  B.bilstm2_dense_reference(x, *w, wo2))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("F,H", WIDTHS)
def test_padded_bilstm2_backward_equals_unpadded(rng, F, H, masked):
    x, w, lens = _case(rng, F, H)
    ln = (lens,) if masked else ()
    _, resid = B.bilstm2_resid_reference(x, *w, *ln)
    g0, g1 = (_t(rng.standard_normal((5, 7, H)).astype(np.float32)) for _ in range(2))
    if masked:  # out0's cotangent is zero past the length (the masked norm's)
        g0 = g0 * (torch.arange(7)[None, :] < lens[:, None])[..., None]
    got = B.padded_backward(B.bilstm2_backward_reference, x, resid, (g0, g1), *w, *ln)
    _assert_equal(got, B.bilstm2_backward_reference(x, resid, g0, g1, *w, *ln))


def _stacked(rng, F, H, D=2, R=5, T=7):
    return _t(rng.standard_normal((D, R, T, F)).astype(np.float32)), _weights(rng, D, F, H)


@pytest.mark.parametrize("F,H", WIDTHS)
def test_padded_lstm_forwards_equal_unpadded(rng, F, H):
    x, w = _stacked(rng, F, H)
    for ref in (L.lstm_reference, L.lstm_cs_reference, L.lstm_resid_reference):
        _assert_equal(B.padded(ref, x, *w), ref(x, *w))
    _, resid = B.padded(L.lstm_resid_reference, x, *w)
    assert resid[3].shape == (2, 5, 7, 4 * H)  # the pre-activations, cut per gate block

    def v2(x2, w_ih2, b2, w_hh2):  # the JAX entries' argument order
        return L.lstm_v2_reference(x2, w_ih2, w_hh2, b2)

    _assert_equal(B.padded(v2, x, *w), v2(x, *w))
    xs = x[0]
    for shared in (L.bilstm_fused_reference, L.bilstm_v2_reference):
        def run(xx, w_ih2, b2, w_hh2, shared=shared):
            return shared(xx, w_ih2, w_hh2, b2)

        got = B.padded(run, xs, *w)
        assert got.shape == (5, 7, 2 * H)
        _assert_equal(got, run(xs, *w))


@pytest.mark.parametrize("F,H", WIDTHS)
def test_padded_lstm_backward_equals_unpadded(rng, F, H):
    x, w = _stacked(rng, F, H)
    _, resid = L.lstm_resid_reference(x, *w)
    g = _t(rng.standard_normal((2, 5, 7, H)).astype(np.float32))
    got = B.padded_backward(L.lstm_backward_reference, x, resid, (g,), *w)
    _assert_equal(got, L.lstm_backward_reference(x, resid, g, *w))


# ---------------------------------------------------------------- on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _close(got, want, atol=1e-4):
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w, atol)
        return
    assert got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def _card(seed, F, H, D=2, R=37, T=9):
    rng = np.random.default_rng(seed)
    x = _t(rng.standard_normal((D, R, T, F)).astype(np.float32)).cuda()
    w = tuple(t.cuda() for t in _weights(rng, D, F, H))
    g = _t(rng.standard_normal((D, R, T, H)).astype(np.float32)).cuda()
    lens = torch.from_numpy(rng.integers(0, T + 1, R).astype(np.int32)).cuda()
    return x, w, g, lens


@pytest.mark.cuda
@pytest.mark.parametrize("F,H", WIDTHS)
def test_bilstm2_kernels_at_unaligned_widths_on_card(F, H):
    _needs_card()
    x, w, g, lens = _card(1, F, H)
    x, g0, g1 = x[0], g[0], g[1]
    before = B.launch_count()
    _close(B.bilstm2_forward(x, *w), B.bilstm2_reference(x, *w))
    _close(B.bilstm2_forward_bm(x, *w), B.bilstm2_reference(x, *w))
    wo2 = torch.randn(2, H, F, device="cuda") * 0.3
    _close(B.bilstm2_dense_forward(x, *w, wo2), B.bilstm2_dense_reference(x, *w, wo2))
    valid = torch.arange(x.shape[1], device="cuda")[None, :] < lens[:, None]
    (o0, o1), resid = B.bilstm2_forward_resid_masked(x, lens, *w)
    (p0, p1), presid = B.bilstm2_resid_reference(x, *w, lens)
    _close(o1, p1)
    _close(o0[valid], p0[valid])
    for a, b in zip(resid, presid):
        _close(a[valid], b[valid])
    (m0, m1) = B.bilstm2_forward_masked(x, lens, *w)
    _close(m1, p1)
    _close(m0[valid], p0[valid])
    got = B.bilstm2_forward_resid(x, *w)
    _close(got, B.bilstm2_resid_reference(x, *w))
    _, resid = B.bilstm2_resid_reference(x, *w)
    for name, grads, want in (
            ("unmasked", B.bilstm2_backward(x, resid, g0, g1, *w),
             B.bilstm2_backward_reference(x, resid, g0, g1, *w)),
            ("masked", B.bilstm2_backward_masked(x, presid, g0 * valid[..., None], g1, *w, lens),
             B.bilstm2_backward_reference(x, presid, g0 * valid[..., None], g1, *w, lens))):
        assert grads[0].shape == x.shape, name
        _close(grads[0], want[0])
        _close(grads[1:], want[1:], atol=1e-3)
    assert B.launch_count() == before + 8


@pytest.mark.cuda
@pytest.mark.parametrize("F,H", WIDTHS)
def test_lstm_kernels_at_unaligned_widths_on_card(F, H):
    _needs_card()
    x, w, g, _ = _card(2, F, H)
    before = L.launch_count()
    _close(L.lstm_forward(x, *w), L.lstm_reference(x, *w))
    _close(L.lstm_forward_with_cs(x, *w), L.lstm_cs_reference(x, *w))
    got_h, resid = L.lstm_forward_resid(x, *w)
    _close((got_h, resid), L.lstm_resid_reference(x, *w))
    w_ih, b, w_hh = w
    _close(L.lstm_scan(x, w_ih, w_hh, b), L.lstm_reference(x, *w))
    _close(L.lstm_scan_v2(x, w_ih, w_hh, b), L.lstm_v2_reference(x, w_ih, w_hh, b))
    _close(L.bilstm_fused(x[0], w_ih, w_hh, b), L.bilstm_fused_reference(x[0], w_ih, w_hh, b))
    _close(L.bilstm_v2(x[0], w_ih, w_hh, b), L.bilstm_v2_reference(x[0], w_ih, w_hh, b))
    got = L.lstm_backward(x, resid, g, *w)
    want = L.lstm_backward_reference(x, resid, g, *w)
    _close(got[0], want[0])
    _close(got[1:], want[1:], atol=1e-3)
    assert L.launch_count() == before + 8


@pytest.mark.cuda
def test_wrappers_reject_h_over_128_on_card():
    _needs_card()
    x, w, g, _ = _card(3, 16, 136, R=4, T=3)
    with pytest.raises(ValueError, match="H <= 128"):
        L.lstm_forward(x, *w)
    with pytest.raises(ValueError, match="H <= 128"):
        B.bilstm2_forward(x[0], *w)
