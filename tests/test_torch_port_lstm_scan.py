"""The fp32 stacked-direction LSTM on the card's cluster scans
(``lstm_forward`` / ``lstm_forward_resid`` on a CUDA fp32 tensor: per
direction the input product of csrc/products.cu, then one launch of the
serving scan of csrc/bilstm2_serve.cu or the training forward's scan of
csrc/bilstm2_resid.cu) and the host-side pieces that generalised those two
scans from the fused pair to D stacked directions.

Both scans find direction d's gate column j at row-step (r, t) at
``pre[d * pre_dir + (r * T + t) * pre_step + j]`` and run direction 1 in
reverse time only when ``reverse1`` is set: (4H, 8H, 1) for the pair's
[R, T, 2, 4H] buffer, (R T 4H, 4H, 0) for the stack's [D, R, T, 4H]. Here a
plain emulation of that addressing (P read, and in the residual mode the
gate pre-activations written back, through the flat offsets) is held
against ``lstm_reference`` / ``lstm_resid_reference`` and
``bilstm2_reference`` / ``bilstm2_resid_reference``, and the stacked case
against the JAX package's Pallas entries in interpret mode (pallas_lstm.py
:453, :574), at D = 1 and 2 and at padded widths: 1e-5 absolute on h and the
streams (fp32, sums in another order). The weight layouts are checked to map
back to W_hh at D = 1 and 2, the tile planner at the BSS shapes with one
direction, and the wrapper's routing with the launches stubbed.

On the card (``cuda`` tests, run there with ``python -m pytest --noconftest
-m cuda tests/test_torch_port_lstm_scan.py``) the route is held against the
plain version at the BSS serving and training shapes, two-direction shapes,
ragged R and T and tiny widths: 1e-4 absolute (3xTF32 products keep about 22
mantissa bits; h lies in (-1, 1)), bit for bit on a second call, one entry
launch and D product launches per call; lstm_backward on the route's
residual streams against its plain version on the same streams (dx 1e-4,
dW and db 1e-4 of max |ref|)."""

import functools
import itertools

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch.ops import bilstm2 as B
from tss_dprnn_tpu_torch.ops import lstm as L

ATOL = 1e-5
CARD_ATOL = 1e-4
# the backward's dW and db against the plain version on the card: fp32 sums
# over R T row-steps (up to 1.3e6) in another order, as chip_smoke.py holds them
DW_REL_TOL = 1e-4


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _weights(rng, D, F, H):
    return ((rng.standard_normal((D, F, 4 * H)) * 0.3).astype(np.float32),
            (rng.standard_normal((D, 4 * H)) * 0.1).astype(np.float32),
            (rng.standard_normal((D, H, 4 * H)) * 0.3).astype(np.float32))


def emulate_scan(pre, w_hh, pre_dir, pre_step, reverse1, dirs, R, T, lens=None, resid=False):
    """The cluster scans' arithmetic on their flat addressing: ``pre`` (1-D,
    fp32) holds P at direction d's row-step (r, t), gate column j, at
    d * pre_dir + (r * T + t) * pre_step + j; direction 1 runs t = T-1..0 when
    ``reverse1`` and, with ``lens``, holds its zero state while t >= len[r].
    Returns the outputs of each direction ([R, T, H], forward time) and, with
    ``resid``, its (hp, cp, tc); the gate pre-activations are written back
    into ``pre`` as the training scan writes them."""
    H = w_hh.shape[1]
    G = 4 * H
    outs, streams = [], []
    cols = torch.arange(G)
    for d in range(dirs):
        rev = d == 1 and reverse1
        h = torch.zeros(R, H)
        c = torch.zeros(R, H)
        out = torch.zeros(R, T, H)
        hcs = [torch.zeros(R, T, H) for _ in range(3)]
        for t in (range(T - 1, -1, -1) if rev else range(T)):
            idx = d * pre_dir + (torch.arange(R)[:, None] * T + t) * pre_step + cols[None, :]
            g = pre[idx] + h @ w_hh[d]
            i, f, gg, o = B._gates(g, H)
            c_new = f * c + i * gg
            tc = torch.tanh(c_new)
            update = (torch.ones(R, dtype=torch.bool) if lens is None or not rev
                      else t < lens)[:, None]
            h_new = torch.where(update, o * tc, h)
            if resid:
                pre[idx] = g
                for s, v in zip(hcs, (h, c, tc)):
                    s[:, t] = v
            c = torch.where(update, c_new, c)
            h = h_new
            out[:, t] = h
        outs.append(out)
        streams.append(hcs)
    return outs, streams


def stacked_route(x, w_ih, b, w_hh, resid=False):
    """lstm_forward(_resid)'s route as the card runs it, with the scan
    emulated: P[d] = x[d] @ W_ih[d] + b[d] into [D, R, T, 4H], then one scan
    over D directions at (R T 4H, 4H, no reverse). Returns h [D, R, T, H] and,
    with ``resid``, (hp, cp, tc, pre) as lstm_forward_resid does."""
    D, R, T, _ = x.shape
    G = w_hh.shape[2]
    pre = (torch.einsum("drtf,dfg->drtg", x, w_ih) + b[:, None, None]).flatten()
    outs, streams = emulate_scan(pre, w_hh, R * T * G, G, False, D, R, T, resid=resid)
    h = torch.stack(outs)
    if not resid:
        return h
    return h, (*(torch.stack(s) for s in zip(*streams)), pre.view(D, R, T, G))


def pair_route(x, w_ih2, b2, w_hh2, lens=None, resid=False):
    """bilstm2_forward(_resid)(_masked)'s route, the scan emulated: P = x @
    [W_ih[0] | W_ih[1]] + b into [R, T, 2, 4H], then one scan at (4H, 8H,
    direction 1 reversed). Returns (out0, out1) and, with ``resid``, the
    seven residual streams as bilstm2_forward_resid does."""
    R, T, _ = x.shape
    G = w_hh2.shape[2]
    w_cat = w_ih2.transpose(0, 1).reshape(-1, 2 * G)
    pre = (x @ w_cat + b2.reshape(-1)).flatten()
    outs, streams = emulate_scan(pre, w_hh2, G, 2 * G, True, 2, R, T, lens=lens, resid=resid)
    if not resid:
        return tuple(outs)
    return tuple(outs), (*streams[0], *streams[1], pre.view(R, T, 2, G))


def _assert_close(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, w)
        return
    assert got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=0)


# (D, R, T, F, H): padded widths F=12 H=10 among them (the wrapper pads them
# to 16 before the route); T = 11 pads the TPU kernel's unroll
STACKED = [(1, 3, 11, 16, 16), (2, 5, 6, 16, 16), (1, 4, 7, 12, 10), (2, 3, 5, 12, 10)]


@pytest.mark.parametrize("D,R,T,F,H", STACKED)
def test_stacked_route_matches_reference_and_pallas(rng, interpret, D, R, T, F, H):
    """h only: the emulated route (padded to the kernels' widths as the
    wrapper pads, then cut) against lstm_reference and the JAX entry."""
    from tss_dprnn_tpu.ops import pallas_lstm

    x = rng.standard_normal((D, R, T, F)).astype(np.float32)
    w = _weights(rng, D, F, H)
    got = B.padded(stacked_route, _t(x), *map(_t, w))
    _assert_close(got, L.lstm_reference(_t(x), *map(_t, w)))
    want = np.transpose(np.asarray(pallas_lstm.lstm_forward(x, *w)), (1, 2, 0, 3))
    _assert_close(got, want)


@pytest.mark.parametrize("D,R,T,F,H", STACKED)
def test_stacked_resid_route_matches_reference_and_pallas(rng, interpret, D, R, T, F, H):
    """The residual mode: h, hp, cp, tc and the gate pre-activations written
    back into P, against lstm_resid_reference and the JAX entry's h and
    streams (its pre from its own h_prev stream)."""
    from tss_dprnn_tpu.ops import pallas_lstm

    x = rng.standard_normal((D, R, T, F)).astype(np.float32)
    w = _weights(rng, D, F, H)
    got = B.padded(functools.partial(stacked_route, resid=True), _t(x), *map(_t, w))
    _assert_close(got, L.lstm_resid_reference(_t(x), *map(_t, w)))
    h, _, *streams = pallas_lstm.lstm_forward_resid(x, *w)
    streams = [np.swapaxes(np.asarray(s)[:, :T, :R], 1, 2) for s in streams]
    w_ih, b, w_hh = w
    want_pre = (np.einsum("drtf,dfg->drtg", x, w_ih) + np.einsum("drth,dhg->drtg", streams[0], w_hh)
                + b[:, None, None])
    _assert_close(got, (np.transpose(np.asarray(h), (1, 2, 0, 3)), (*streams, want_pre)))


@pytest.mark.parametrize("resid", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("R,T,F,H", [(5, 7, 16, 16), (4, 6, 12, 10)])
def test_pair_route_matches_reference(rng, R, T, F, H, masked, resid):
    """The same emulation at the pair's addressing (the values the bilstm2
    wrappers pass) against bilstm2_reference / bilstm2_resid_reference:
    unmasked and with ragged lengths (0 and T among them)."""
    x = _t(rng.standard_normal((R, T, F)).astype(np.float32))
    w = tuple(map(_t, _weights(rng, 2, F, H)))
    lens = torch.tensor([T, 0, 3, 1, T - 2][:R], dtype=torch.int32) if masked else None
    got = B.padded(functools.partial(pair_route, resid=resid), x, *w, lens)
    want = (B.bilstm2_resid_reference if resid else B.bilstm2_reference)(x, *w, lens)
    if masked:  # out0 and the streams past a row's length are unspecified
        valid = torch.arange(T)[None, :] < lens[:, None]
        (g0, g1), (w0, w1) = (got[0], want[0]) if resid else (got, want)
        _assert_close(g1, w1)
        _assert_close(g0[valid], w0[valid])
        if resid:
            for a, b in zip(got[1][:6], want[1][:6]):
                _assert_close(a[valid], b[valid])
            _assert_close(got[1][6][valid], want[1][6][valid])
        return
    _assert_close(got, want)


def test_pair_route_matches_pallas(rng, interpret):
    from tss_dprnn_tpu.ops import pallas_lstm

    R, T, F, H = 5, 7, 12, 10
    x = rng.standard_normal((R, T, F)).astype(np.float32)
    w = _weights(rng, 2, F, H)
    got = B.padded(pair_route, _t(x), *map(_t, w))
    _assert_close(got, [np.asarray(o) for o in pallas_lstm.bilstm2_forward(x, *w)])


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("H", [16, 128])
def test_serve_weight_layout_maps_back_stacked(D, H):
    """Element (d, c, ks, w, lg, lt, gate, j) of the serving layout of a
    [D, H, 4H] W_hh is W_hh[d][8 ks + lt + 4 j][gate H + c H/2 + 8 w + lg]:
    every element once."""
    w = torch.arange(D * H * 4 * H, dtype=torch.float32).reshape(D, H, 4 * H)
    got = L.serve_weight_layout(w)
    assert got.shape == (D, 2, H // 8, H // 16, 8, 4, 4, 2) and got.is_contiguous()
    d, c, ks, wp, lg, lt, g, j = torch.tensor(list(itertools.product(
        range(D), range(2), range(H // 8), range(H // 16), range(8), range(4), range(4),
        range(2)))).T
    assert torch.equal(got.flatten(), w[d, 8 * ks + lt + 4 * j, g * H + c * (H // 2) + 8 * wp + lg])
    assert torch.equal(torch.sort(got.flatten()).values, w.flatten())


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("H", [16, 128])
def test_resid_weight_layout_maps_back_stacked(D, H):
    """The training forward's layout of a [D, H, 4H] W_hh: element
    (d, c, k, gate, u) is W_hh[d][k][gate H + c H/2 + u]."""
    w = torch.arange(D * H * 4 * H, dtype=torch.float32).reshape(D, H, 4 * H)
    got = L.resid_weight_layout(w)
    assert got.shape == (D, 2, H, 4, H // 2) and got.is_contiguous()
    d, c, k, g, u = torch.tensor(list(itertools.product(
        range(D), range(2), range(H), range(4), range(H // 2)))).T
    assert torch.equal(got.flatten(), w[d, k, g * H + c * (H // 2) + u])


# the BSS inter scan's rows with one direction (8 x 10 s serving: R = 2000;
# 5 x 3 s training: R = 1250) at the H100's 66 clusters -> (height, tiles)
@pytest.mark.parametrize("R,heights,want", [
    (2000, B.SERVE_HEIGHTS, (32, 63)),   # BSS serving, h only: one wave
    (1250, B.SERVE_HEIGHTS, (32, 40)),   # BSS eval step, h only
    (1250, B.TILE_HEIGHTS, (24, 53)),    # BSS training, the residual mode: one wave
    (2000, B.TILE_HEIGHTS, (32, 63)),
])
def test_stacked_tile_plan(R, heights, want):
    plan = B.plan_tiles(R, dict.fromkeys(heights, 66), dirs=1, heights=heights)
    assert (plan.height, plan.tiles, plan.dirs, plan.clusters) == (*want, 1, want[1])
    assert plan.clusters <= 66  # one wave
    assert all(-(-R // h) > 66 for h in heights if h < plan.height)  # the smallest that fits


def test_fp32_stacked_modes_take_the_cluster_route(monkeypatch):
    """The kernel wrapper sends every forward mode, h only, residual and cell
    state, fp32 and bf16 streams alike, to the product + cluster scan route
    (no other library is left: csrc/lstm.cu is gone), whose checks refuse a
    tensor that is not on the card."""
    assert not hasattr(L, "_library")
    calls = []
    monkeypatch.setattr(L, "_launch_scan", lambda *a: calls.append(a) or "scan")
    w = [torch.zeros(1, 16, 64), torch.zeros(1, 64), torch.zeros(1, 16, 64)]
    x = torch.zeros(1, 3, 5, 16)
    xb = x.bfloat16()
    cases = [(entry, mode, xx) for xx in (x, xb)
             for entry, mode in ((L.lstm_forward, L._MODE_H), (L.lstm_forward_resid, L._MODE_RESID),
                                 (L.lstm_scan, L._MODE_H), (L.lstm_forward_with_cs, L._MODE_CS))]
    for entry, mode, xx in cases:
        assert L._launch(entry, mode, xx, *w) == "scan"
        assert calls[-1][:3] == (entry, mode, xx)
    assert len(calls) == 8
    monkeypatch.undo()
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            L._launch(L.lstm_forward_with_cs, L._MODE_CS, x.to(dtype), *w)


def test_cluster_route_has_no_cpu_fallback():
    """The route itself refuses a CPU tensor (the entries send CPU tensors to
    the plain version before they reach it)."""
    w = [torch.zeros(1, 16, 64), torch.zeros(1, 64), torch.zeros(1, 16, 64)]
    before = L.lstm_forward.launches
    for mode in (L._MODE_H, L._MODE_RESID, L._MODE_CS):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            L._launch_scan(L.lstm_forward, mode, torch.zeros(1, 3, 5, 16), *w)
    assert L.lstm_forward.launches == before


# ---------------------------------------------------------------- on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _card_case(D, R, T, F, H, seed):
    g = torch.Generator().manual_seed(seed)
    k = H ** -0.5
    x = torch.randn(D, R, T, F, generator=g).cuda()
    w = [(torch.rand(*s, generator=g) * 2 * k - k).cuda()
         for s in ((D, F, 4 * H), (D, 4 * H), (D, H, 4 * H))]
    return x, w


def _check_on_card(D, R, T, F, H, resid, seed):
    x, w = _card_case(D, R, T, F, H, seed)
    entry = L.lstm_forward_resid if resid else L.lstm_forward
    before = (entry.launches, B.product_launch_counts()["products_gemm"], L.launch_count())
    got = entry(x, *w)
    again = entry(x, *w)
    torch.cuda.synchronize()
    assert (entry.launches, B.product_launch_counts()["products_gemm"], L.launch_count()) == (
        before[0] + 2, before[1] + 2 * D, before[2] + 2)
    want = (L.lstm_resid_reference if resid else L.lstm_reference)(x, *w)
    flat = [got] if not resid else [got[0], *got[1]]
    flat_again = [again] if not resid else [again[0], *again[1]]
    flat_want = [want] if not resid else [want[0], *want[1]]
    for a, b, c in zip(flat, flat_again, flat_want, strict=True):
        assert a.shape == c.shape and torch.isfinite(a).all()
        assert torch.equal(a, b)  # no float atomics
        torch.testing.assert_close(a, c, atol=CARD_ATOL, rtol=0)
    if resid:  # the backward reads the route's Resid as it read lstm.cu's
        g = torch.randn(D, R, T, H, generator=torch.Generator().manual_seed(seed)).cuda()
        got_g = L.lstm_backward(x, got[1], g, *w)
        want_g = L.lstm_backward_reference(x, got[1], g, *w)
        for name, a, b in zip(("dx", "dw_ih", "db", "dw_hh"), got_g, want_g):
            # dW and db are sums over all R T row-steps: DW_REL_TOL of max |ref|
            atol = CARD_ATOL if name == "dx" else DW_REL_TOL * float(b.abs().max())
            torch.testing.assert_close(a, b, atol=atol, rtol=0, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("resid", [False, True])
@pytest.mark.parametrize("D,R,T", [(1, 2000, 642), (1, 1250, 194), (2, 203, 33)])
def test_cluster_route_matches_reference_on_card(D, R, T, resid):
    """The BSS inter scan at 8 x 10 s serving and 5 x 3 s training, and a
    small two-direction case, F = H = 128."""
    _needs_card()
    _check_on_card(D, R, T, 128, 128, resid, seed=3)


@pytest.mark.cuda
@pytest.mark.parametrize("resid", [False, True])
def test_cluster_route_wide_two_directions_on_card(resid):
    """Two stacked directions at the intra-chunk shape of 8 x 10 s: several
    waves of clusters."""
    _needs_card()
    _check_on_card(2, 5136, 250, 128, 128, resid, seed=4)


@pytest.mark.cuda
@pytest.mark.parametrize("resid", [False, True])
@pytest.mark.parametrize("D,R,T,F,H", [(1, 37, 21, 12, 10), (2, 90, 17, 20, 24),
                                       (1, 1, 1, 128, 128), (2, 300, 9, 128, 128)])
def test_cluster_route_small_shapes_on_card(D, R, T, F, H, resid):
    """Padded widths, and row counts and steps no multiple of any tile
    height or unroll."""
    _needs_card()
    _check_on_card(D, R, T, F, H, resid, seed=5)
