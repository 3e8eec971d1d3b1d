"""The fp32 serving route of the port's fused bidirectional LSTM
(``bilstm2_forward`` / ``bilstm2_forward_masked`` on a CUDA fp32 tensor: the
input product of csrc/products.cu, then the serving cluster scan of
csrc/bilstm2_serve.cu) and its host-side pieces.

On the CPU the entries run their plain version, ``bilstm2_reference``; here
it is held against the JAX package's Pallas entries in interpret mode
(pallas_lstm.py:935, :949) at 1e-5 absolute (fp32 rounding: the two sides
sum the gate products in different orders), with ragged lengths (0 and T
among them), padded widths and row counts that are no multiple of a tile
height. The scan's weight layouts are checked to map back to ``w_hh2``
exactly, and the mma fragments the kernel's lanes read from the serving
layout are checked to give h @ W_hh (emulated here in float64). The serving
tile planner is pure Python.

On the card (``cuda`` tests, run there with ``python -m pytest --noconftest
-m cuda tests/test_torch_port_serve_scan.py``) the route is held against the
plain version at chip_smoke.py phase 2's shapes and at padded widths: 1e-4
absolute (3xTF32 products keep about 22 mantissa bits and the gate sums run
in another order; h lies in (-1, 1)), and bit for bit on a second call."""

import functools
import itertools

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch.ops import bilstm2 as B

ATOL = 1e-5
CARD_ATOL = 1e-4


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _weights(rng, F, H):
    return ((rng.standard_normal((2, F, 4 * H)) * 0.3).astype(np.float32),
            (rng.standard_normal((2, 4 * H)) * 0.1).astype(np.float32),
            (rng.standard_normal((2, H, 4 * H)) * 0.3).astype(np.float32))


# (R, T, F, H, lens): R no multiple of 16; lens with 0 and T; padded widths
CASES = [
    (19, 9, 16, 16, [9, 0, 4, 9, 1, 7, 0, 3, 9, 2, 5, 6, 8, 9, 1, 0, 4, 9, 3]),
    (5, 7, 12, 10, [7, 0, 4, 6, 3]),
    (6, 6, 20, 24, [6, 1, 0, 5, 2, 6]),
]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("R,T,F,H,lens", CASES)
def test_serving_forward_matches_pallas(rng, interpret, R, T, F, H, lens, masked):
    """The CPU entries (the plain version), and the padded composition the
    card runs at widths that are no multiple of 16, against the JAX
    entries."""
    from tss_dprnn_tpu.ops import pallas_lstm

    lens = np.asarray(lens, np.int32)
    x = rng.standard_normal((R, T, F)).astype(np.float32)
    w = _weights(rng, F, H)
    if masked:
        want = pallas_lstm.bilstm2_forward_masked(x, lens, *w)
        got = B.bilstm2_forward_masked(_t(x), _t(lens), *map(_t, w))
        padded = B.padded(B.bilstm2_reference, _t(x), *map(_t, w), _t(lens))
    else:
        want = pallas_lstm.bilstm2_forward(x, *w)
        got = B.bilstm2_forward(_t(x), *map(_t, w))
        padded = B.padded(B.bilstm2_reference, _t(x), *map(_t, w))
    want = [np.asarray(o) for o in want]
    for out in (got, padded):
        o0, o1 = (o.numpy() for o in out)
        assert o0.shape == o1.shape == (R, T, H)
        np.testing.assert_allclose(o1, want[1], atol=ATOL, rtol=0)  # everywhere
        if not masked:
            np.testing.assert_allclose(o0, want[0], atol=ATOL, rtol=0)
            continue
        assert np.all(o1[np.arange(T)[None, :] >= lens[:, None]] == 0)
        for r, n in enumerate(lens):  # out0 past the length is unspecified
            np.testing.assert_allclose(o0[r, :n], want[0][r, :n], atol=ATOL, rtol=0)


@pytest.mark.parametrize("H", [16, 32, 128])
def test_serve_weight_layout_maps_back(H):
    """Element (d, c, ks, w, lg, lt, gate, j) of the serving layout is
    W_hh[d][8 ks + lt + 4 j][gate H + c H/2 + 8 w + lg]: every element of
    w_hh2 once."""
    w = torch.arange(2 * H * 4 * H, dtype=torch.float32).reshape(2, H, 4 * H)
    got = B.serve_weight_layout(w)
    assert got.shape == (2, 2, H // 8, H // 16, 8, 4, 4, 2) and got.is_contiguous()
    idx = torch.tensor(list(itertools.product(
        range(2), range(2), range(H // 8), range(H // 16), range(8), range(4), range(4),
        range(2))))
    d, c, ks, wp, lg, lt, g, j = idx.T
    want = w[d, 8 * ks + lt + 4 * j, g * H + c * (H // 2) + 8 * wp + lg]
    assert torch.equal(got.flatten(), want)
    assert torch.equal(torch.sort(got.flatten()).values, w.flatten())


@pytest.mark.parametrize("H", [16, 128])
def test_resid_weight_layout_maps_back(H):
    """The training forward's layout: element (d, c, k, gate, u) is
    W_hh[d][k][gate H + c H/2 + u]."""
    w = torch.arange(2 * H * 4 * H, dtype=torch.float32).reshape(2, H, 4 * H)
    got = B.resid_weight_layout(w)
    assert got.shape == (2, 2, H, 4, H // 2) and got.is_contiguous()
    d, c, k, g, u = torch.tensor(list(itertools.product(
        range(2), range(2), range(H), range(4), range(H // 2)))).T
    assert torch.equal(got.flatten(), w[d, k, g * H + c * (H // 2) + u])


@pytest.mark.parametrize("H,MT", [(16, 1), (32, 2)])
def test_serve_fragments_give_h_at_w(H, MT):
    """The serving scan's product as its lanes compute it: lane 4 lg + lt of
    a warp of unit group w reads B fragments b_j = wfrag[d, c, ks, w, lg, lt,
    gate, j] (k = 8 ks + lt + 4 j, column lg) and, by ldmatrix from the h tile, A
    fragments a_q = h[16 mt + lg + 8 (q & 1)][8 ks + lt + 4 (q >> 1)];
    mma.m16n8k8 gives it C[lg + 8 (q >> 1)][2 lt + (q & 1)], which the cell
    update reads as gate `gate` of row 16 mt + lg + 8 hh and unit
    c H/2 + 8 w + 2 lt + j. Together: h @ W_hh[d] for every (row, unit,
    gate) of both CTAs, each exactly once."""
    rng = np.random.default_rng(0)
    M, Hh = 16 * MT, H // 2
    w_hh2 = torch.from_numpy(rng.standard_normal((2, H, 4 * H))).double()
    h = torch.from_numpy(rng.standard_normal((M, H))).double()
    frag = B.serve_weight_layout(w_hh2)
    lg, lt = torch.arange(32) // 4, torch.arange(32) % 4
    for d, c in itertools.product(range(2), range(2)):
        got = torch.full((M, 4, Hh), float("nan"), dtype=torch.float64)
        for wp, mt, g in itertools.product(range(H // 16), range(MT), range(4)):
            acc = torch.zeros(32, 4, dtype=torch.float64)  # [lane][q]
            for ks in range(H // 8):
                b = frag[d, c, ks, wp, lg, lt, g]  # [lane][j]
                rows = 16 * mt + lg[:, None] + 8 * torch.tensor([0, 1, 0, 1])
                ks_ = 8 * ks + lt[:, None] + 4 * torch.tensor([0, 0, 1, 1])
                a = h[rows, ks_]  # [lane][q]
                A = torch.zeros(16, 8, dtype=torch.float64)  # rebuilt from the lanes
                A[rows - 16 * mt, ks_ - 8 * ks] = a
                Bm = torch.zeros(8, 8, dtype=torch.float64)
                Bm[lt, lg], Bm[lt + 4, lg] = b[:, 0], b[:, 1]
                C = A @ Bm
                acc += C[lg[:, None] + 8 * torch.tensor([0, 0, 1, 1]),
                         2 * lt[:, None] + torch.tensor([0, 1, 0, 1])]
            for hh, j in itertools.product(range(2), range(2)):
                got[16 * mt + lg + 8 * hh, g, 8 * wp + 2 * lt + j] = acc[:, 2 * hh + j]
        want = (h @ w_hh2[d]).view(M, 4, 2, Hh)[:, :, c]
        assert not torch.isnan(got).any()
        torch.testing.assert_close(got, want, atol=1e-12, rtol=0)


def test_fp32_streams_take_the_serving_route(monkeypatch):
    """The entries' operator bodies send a tensor that is not on the CPU
    (here on the meta device) to the serving route (input product + serving
    scan), fp32 and, since bf16 serving left csrc/bilstm2.cu, bf16 streams
    alike; through the operators a meta tensor gets their shape-only
    versions and reaches no route; the route's checks refuse a tensor that
    is not on the card."""
    calls = []
    real = B._launch_serve
    monkeypatch.setattr(B, "_launch_serve", lambda *a: calls.append(a) or ("serve", "serve"))
    w = [torch.zeros(2, 16, 64), torch.zeros(2, 64), torch.zeros(2, 16, 64)]
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(3, 5, 16, dtype=dtype, device="meta")
        lens = torch.zeros(3, dtype=torch.int32, device="meta")
        assert B._forward_impl(x, *w) == ("serve", "serve")  # the operators' bodies
        assert B._forward_masked_impl(x, lens, *w) == ("serve", "serve")
        assert [c[0] for c in calls[-2:]] == [B.bilstm2_forward, B.bilstm2_forward_masked]
        assert calls[-2][1] is x and calls[-2][5] is None and calls[-1][5] is lens
        for out in (B.bilstm2_forward(x, *w), B.bilstm2_forward_masked(x, lens, *w)):
            assert [(o.device.type, o.dtype, tuple(o.shape)) for o in out] == [
                ("meta", dtype, (3, 5, 16))] * 2
    assert len(calls) == 4
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        real(B.bilstm2_forward, torch.zeros(3, 5, 16).bfloat16(), *w, None)


# (R, max clusters) -> (height, tiles): one wave where the card allows it
# (the smallest such height), else the fewest waves x height, then fewer waves
@pytest.mark.parametrize("R,max_clusters,want", [
    (2000, 66, (32, 63)),     # the inter shape of 8 x 10 s: 2 waves x 32 ties 4 x 16
    (5136, 66, (32, 161)),    # the intra shape: 5 waves x 32 ties 10 x 16
    (100, 66, (16, 7)),
    (1, 66, (16, 1)),
    (5136, 1000, (16, 321)),  # a larger card: one wave of the smallest tiles
    (5136, 1, (16, 321)),     # one cluster at a time: 2 x 321 x 16 < 2 x 161 x 32
])
def test_serving_tile_plan(R, max_clusters, want):
    plan = B.plan_tiles(R, dict.fromkeys(B.SERVE_HEIGHTS, max_clusters), heights=B.SERVE_HEIGHTS)
    assert (plan.height, plan.tiles, plan.dirs) == (*want, 2)
    assert plan.tiles * plan.height >= R > (plan.tiles - 1) * plan.height
    waves = -(-plan.clusters // max_clusters)
    others = [B.TilePlan(h, -(-R // h)) for h in B.SERVE_HEIGHTS]
    if waves == 1:
        assert all(p.clusters > max_clusters for p in others if p.height < plan.height)
    else:
        assert all(-(-p.clusters // max_clusters) > 1 for p in others)
        assert all(-(-p.clusters // max_clusters) * p.height >= waves * plan.height
                   for p in others)


def test_serving_tile_plan_rejects_no_cluster():
    with pytest.raises(ValueError, match="no cluster"):
        B.plan_tiles(10, dict.fromkeys(B.SERVE_HEIGHTS, 0), heights=B.SERVE_HEIGHTS)


# ---------------------------------------------------------------- on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _card_case(R, T, F, H, seed, ragged):
    g = torch.Generator().manual_seed(seed)
    k = H ** -0.5
    x = torch.randn(R, T, F, generator=g).cuda()
    w = [(torch.rand(*s, generator=g) * 2 * k - k).cuda()
         for s in ((2, F, 4 * H), (2, 4 * H), (2, H, 4 * H))]
    lens = (torch.randint(0, T + 1, (R,), generator=g) if ragged
            else torch.full((R,), T)).int().cuda()
    lens[:2] = torch.tensor([0, T])
    return x, w, lens


def _check_on_card(R, T, F, H, masked, seed):
    x, w, lens = _card_case(R, T, F, H, seed, ragged=masked)
    before = (B.bilstm2_forward.launches, B.bilstm2_forward_masked.launches,
              B.product_launch_counts()["products_gemm"])
    run = ((lambda: B.bilstm2_forward_masked(x, lens, *w)) if masked
           else (lambda: B.bilstm2_forward(x, *w)))
    got = run()
    again = run()
    torch.cuda.synchronize()
    after = (B.bilstm2_forward.launches, B.bilstm2_forward_masked.launches,
             B.product_launch_counts()["products_gemm"])
    assert after == (before[0] + 2 * (not masked), before[1] + 2 * masked, before[2] + 2)
    want = B.bilstm2_reference(x, *w, lens if masked else None)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no float atomics
    if masked:
        valid = torch.arange(T, device="cuda")[None, :] < lens[:, None]
        assert torch.all(got[1][~valid] == 0)
        got, want = ([o[0][valid], o[1]] for o in (got, want))
    got, want = (torch.cat([o.flatten() for o in out]) for out in (got, want))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=CARD_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("masked,R,T", [(False, 5136, 250), (True, 2000, 642)])
def test_serving_route_matches_reference_on_card(masked, R, T):
    """chip_smoke.py phase 2's shapes (8 x 10 s: the intra scan unmasked,
    the inter scan masked with ragged lengths)."""
    _needs_card()
    _check_on_card(R, T, 128, 128, masked, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("R,T,F,H", [(37, 21, 12, 10), (90, 17, 20, 24), (300, 9, 128, 128)])
def test_serving_route_small_shapes_on_card(R, T, F, H, masked):
    """Padded widths, and row counts no multiple of any tile height."""
    _needs_card()
    _check_on_card(R, T, F, H, masked, seed=2)
