"""The bf16 training route: the bf16 streams of the training pair and of the
stacked-direction scan on bf16 tensor-core scans and bf16-operand products.

On the card a bf16 ``bilstm2_forward_resid(_masked)`` / ``lstm_forward_resid``
is the bf16-operand input product (``products_gemm_bf16``, x read as it is)
and then the serving cluster scan's bf16 training mode
(``bilstm2_serve_resid_scan``: h @ W_hh in bf16 mma.sync on W_hh in
``serve_weight_layout_bf16``'s order; it writes the gate pre-activations and
the residual streams); a bf16 ``bilstm2_backward(_masked)`` / ``lstm_backward``
is the backward scan's bf16 mode (dpre @ W_hh^T in bf16 mma.sync on W_hh^T in
``bwd_weight_layout_bf16``'s order, dpre stored bf16), then per direction dx
through the bf16-operand product with a bf16 output and dW_ih, dW_hh through
the column-layout bf16 product (``products_gemm_bf16_col``, fixed split-K
partials), and db through the column sum of the scan's unrounded partial
sums. fp32 streams keep their launches. The cell-state forward
(``lstm_forward_with_cs``) is the input product (fp32: 3xTF32, bf16: the
bf16-operand one on x as it is) and the serving scan's cell-state mode
(``bilstm2_serve_cs_scan``). Every stacked scan takes two directions to a
launch: D = 3 runs two launches of each scan, at the right offsets.

On the CPU: the route's arguments on a stand-in card (``torch.Tensor.is_cuda``
patched true, the libraries replaced by recorders), with no
``products_gemm`` and no fp32 copy of x, hp or dpre in bf16, and the fp32
launches as they were; the column-layout product's plain version against a
float64 product of the same bf16 values, splits included; the backward
scan's bf16 weight layout maps back to W_hh, and the fragments its lanes
read give dpre @ W_hh^T in an emulation of ldmatrix and mma.m16n8k16; the
column-layout product's transposed A fragments (ldmatrix.trans from a [k][m]
tile) give a^T @ b in the same emulation.

The card cases of this route are in tests/test_torch_port_bf16_training.py
(``cuda``-marked): each kernel against its plain version, ragged masked
rows, the launch counts, bit for bit on a second call.
"""

import contextlib
import itertools
import types

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch.ops import bilstm2 as B
from tss_dprnn_tpu_torch.ops import lstm as L


def _bf16_values(rng, shape, scale=1.0):
    """float64 holding bf16 values (products of two are exact in float64)."""
    return torch.from_numpy(scale * rng.standard_normal(shape)).bfloat16().double()


class _Recorder:
    """A stand-in for a kernel library: records each call, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        if fn.endswith("error_string"):
            return lambda rc: b"recorded"

        def call(*args):
            self.calls.append((fn, args))
            return 0
        return call


@pytest.fixture
def stand_in_card(monkeypatch):
    """CPU tensors pass for CUDA ones and the libraries record their calls;
    the card runs 66 clusters of every scan at every height. Records the
    weight layouts the wrappers hand over, and the shape of every
    ``Tensor.float`` call on a bf16 tensor (an fp32 copy; the weights are
    rounded to bf16 values and back, as every kernel takes them)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    libs = {name: _Recorder() for name in ("products", "serve", "resid", "bwd", "lstm_bwd")}
    for mod in (B, L):
        monkeypatch.setattr(mod, "_library_products", lambda: libs["products"])
        monkeypatch.setattr(mod, "_library_serve", lambda: libs["serve"])
        monkeypatch.setattr(mod, "_library_resid", lambda: libs["resid"])
    monkeypatch.setattr(B, "_library_bwd", lambda: libs["bwd"])
    monkeypatch.setattr(L, "_library_scan", lambda: libs["lstm_bwd"])
    monkeypatch.setattr(B, "_max_clusters", lambda which, H, device, height, dtype: 66)
    monkeypatch.setattr(L, "_max_clusters", lambda H, device, height, dtype: 66)
    layouts = []
    for name in ("resid_weight_layout", "serve_weight_layout", "serve_weight_layout_bf16",
                 "bwd_weight_layout_bf16"):
        real = getattr(B, name)

        def record(w, real=real, name=name):
            out = real(w)
            layouts.append((name, out))
            return out
        monkeypatch.setattr(B, name, record)
        monkeypatch.setattr(L, name, record, raising=False)
    upcasts = []
    real_float = torch.Tensor.float

    def recorded_float(self, *a, **k):
        if self.dtype == torch.bfloat16:
            upcasts.append(tuple(self.shape))
        return real_float(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "float", recorded_float)
    return libs, layouts, upcasts


def _weights(D, F, H, seed=0):
    g = torch.Generator().manual_seed(D * F + H + seed)
    return [torch.randn(*s, generator=g) * 0.1 for s in ((D, F, 4 * H), (D, 4 * H), (D, H, 4 * H))]


def _counts():
    return B.product_launch_counts()


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items() if v != before[k]}


def _pair_streams(R, T, H, dtype):
    g = torch.Generator().manual_seed(5)
    resid = tuple(torch.randn(R, T, H, generator=g).to(dtype) for _ in range(6))
    pre = torch.randn(R, T, 2, 4 * H, generator=g)
    cots = tuple(torch.randn(R, T, H, generator=g).to(dtype) for _ in range(2))
    return resid + (pre,), cots


@pytest.mark.parametrize("masked", [False, True])
def test_pair_bf16_forward_reaches_bf16_product_and_training_scan(stand_in_card, masked):
    libs, layouts, upcasts = stand_in_card
    R, T, F, H = 40, 6, 16, 32
    x = torch.randn(R, T, F).bfloat16()
    lens = torch.randint(0, T + 1, (R,)).int() if masked else None
    entry = B.bilstm2_forward_resid_masked if masked else B.bilstm2_forward_resid
    before, launches = _counts(), entry.launches
    (o0, o1), resid = B._launch_resid(entry, x, *_weights(2, F, H), lens)
    assert entry.launches == launches + 1
    assert _delta(before) == {"products_gemm_bf16": 1}
    assert all(t.dtype == torch.bfloat16 and t.shape == (R, T, H) for t in (o0, o1, *resid[:6]))
    pre = resid[6]
    assert pre.dtype == torch.float32 and pre.shape == (R, T, 2, 4 * H)
    (gemm, gargs), = libs["products"].calls
    # (a, lda, b, ldb, K, bias, c, ldc, M, N, c_bf16, stream): x's own storage, P fp32
    assert gemm == "products_gemm_bf16" and gargs[:2] == (x.data_ptr(), F)
    assert gargs[3:5] == (8 * H, F) and gargs[6:11] == (pre.data_ptr(), 8 * H, R * T, 8 * H, 0)
    (scan, args), = libs["serve"].calls
    (layout, frag), = layouts
    assert layout == "serve_weight_layout_bf16" and frag.dtype == torch.bfloat16
    # (height, pre, wfrag, lens, out0, out1, hp0, cp0, tc0, hp1, cp1, tc1, pre_dir, pre_step,
    #  reverse1, dirs, R, T, H, time_major, stream)
    assert scan == "bilstm2_serve_resid_scan"
    assert args[:3] == (16, pre.data_ptr(), frag.data_ptr()) and (args[3] is not None) == masked
    assert args[4:12] == tuple(t.data_ptr() for t in (o0, o1, *resid[:6]))
    assert args[12:] == (4 * H, 8 * H, 1, 2, R, T, H, 0, 7)
    assert not libs["resid"].calls and x.shape not in upcasts


@pytest.mark.parametrize("masked", [False, True])
def test_pair_bf16_backward_reaches_bf16_products(stand_in_card, masked):
    libs, layouts, upcasts = stand_in_card
    R, T, F, H = 40, 6, 16, 32
    G, M = 4 * H, R * T
    x = torch.randn(R, T, F).bfloat16()
    resid, (g0, g1) = _pair_streams(R, T, H, torch.bfloat16)
    lens = torch.randint(0, T + 1, (R,)).int() if masked else None
    entry = B.bilstm2_backward_masked if masked else B.bilstm2_backward
    before, launches = _counts(), entry.launches
    dx, dw_ih, db, dw_hh = B._launch_backward(entry, x, resid, g0, g1, *_weights(2, F, H), lens)
    assert entry.launches == launches + 1
    assert _delta(before) == {"products_gemm_bf16": 2, "products_gemm_bf16_col": 3,
                              "products_colsum": 1}
    assert dx.dtype == torch.bfloat16 and dx.shape == (R, T, F)
    assert (dw_ih.shape, db.shape, dw_hh.shape) == ((2, F, G), (2, G), (2, H, G))
    (scan, args), = libs["bwd"].calls
    (layout, wt), = layouts
    assert layout == "bwd_weight_layout_bf16" and wt.dtype == torch.bfloat16
    # (height, dtype, pre, dpre, cp0, tc0, g0, cp1, tc1, g1, wsplit, lens, dbpart, R, T, H, s)
    assert scan == "bilstm2_bwd_scan" and args[:3] == (16, 1, resid[6].data_ptr())
    streams = (resid[1], resid[2], g0, resid[4], resid[5], g1)
    assert args[4:10] == tuple(t.data_ptr() for t in streams)
    assert args[10] == wt.data_ptr() and (args[11] is not None) == masked
    assert args[12] is not None and args[13:] == (R, T, H, 0, 7)
    dpre = args[3]
    calls = libs["products"].calls
    assert [c[0] for c in calls] == ["products_gemm_bf16"] * 2 + ["products_gemm_bf16_col"] * 3 + [
        "products_colsum"]
    for d, (_, a) in enumerate(calls[:2]):  # dpre_d: 4H of the 8H-wide bf16 rows, bf16 out
        assert a[0] == dpre + 2 * d * G and a[1] == 2 * G and a[4] == G and a[-2] == 1
    # (a, lda, b, ldb, K, c, split_stride, M, N, splits, kps, stream): x, hp0, hp1 in place
    col = [a for _, a in calls[2:5]]
    assert [(a[0], a[1]) for a in col] == [(x.data_ptr(), F), (resid[0].data_ptr(), H),
                                           (resid[3].data_ptr(), H)]
    assert [(a[2], a[3], a[4]) for a in col] == [(dpre, 2 * G, M), (dpre, 2 * G, M),
                                                 (dpre + 2 * G, 2 * G, M)]
    assert [(a[7], a[8]) for a in col] == [(F, 2 * G), (H, G), (H, G)]
    for a in col:
        splits, kps = a[9], a[10]
        assert (splits, kps) == B.split_plan(a[7], a[8], M) and kps % 32 == 0
        assert (splits - 1) * kps < M <= splits * kps
    assert not {x.shape, (R, T, H), (R, T, 2, G)} & set(upcasts)


@pytest.mark.parametrize("D", [1, 2])
def test_stack_bf16_training_reaches_bf16_route(stand_in_card, D):
    libs, layouts, upcasts = stand_in_card
    R, T, F, H = 20, 5, 16, 16
    G, M = 4 * H, R * T
    x = torch.randn(D, R, T, F).bfloat16()
    w = _weights(D, F, H)
    before, launches = _counts(), L.lstm_forward_resid.launches
    h, (hp, cp, tc, pre) = L._launch(L.lstm_forward_resid, L._MODE_RESID, x, *w)
    assert L.lstm_forward_resid.launches == launches + 1
    assert _delta(before) == {"products_gemm_bf16": D}
    assert [a[:2] for _, a in libs["products"].calls] == [
        (x.data_ptr() + 2 * d * M * F, F) for d in range(D)]
    (scan, args), = libs["serve"].calls
    (layout, frag), = layouts
    assert scan == "bilstm2_serve_resid_scan" and layout == "serve_weight_layout_bf16"
    assert args[:4] == (16, pre.data_ptr(), frag.data_ptr(), None)
    assert args[12:] == (M * G, G, 0, D, R, T, H, 0, 7)
    assert not libs["resid"].calls and x.shape not in upcasts
    libs["products"].calls.clear()
    layouts.clear()

    g = torch.randn(D, R, T, H).bfloat16()
    before, launches = _counts(), L.lstm_backward.launches
    dx, dw_ih, db, dw_hh = L._launch_backward(L.lstm_backward, x, (hp, cp, tc, pre), g, *w)
    assert L.lstm_backward.launches == launches + 1
    assert _delta(before) == {"products_gemm_bf16": D, "products_gemm_bf16_col": 2 * D,
                              "products_colsum": D}
    assert dx.dtype == torch.bfloat16 and dx.shape == (D, R, T, F)
    (scan, args), = libs["lstm_bwd"].calls
    (layout, wt), = layouts
    assert scan == "lstm_bwd_scan" and layout == "bwd_weight_layout_bf16"
    assert args[:3] == (16, 1, pre.data_ptr()) and args[7] == wt.data_ptr()
    dpre = args[3]
    calls = libs["products"].calls
    kinds = ["products_gemm_bf16", "products_gemm_bf16_col", "products_gemm_bf16_col",
             "products_colsum"]
    assert [c[0] for c in calls] == kinds * D
    for d in range(D):
        gemm, dwi, dwh = (a for _, a in calls[4 * d:4 * d + 3])
        assert gemm[0] == dpre + 2 * d * M * G and gemm[6] == dx.data_ptr() + 2 * d * M * F
        assert dwi[:3] == (x.data_ptr() + 2 * d * M * F, F, dpre + 2 * d * M * G)
        assert dwh[:3] == (hp.data_ptr() + 2 * d * M * H, H, dpre + 2 * d * M * G)
    assert not {x.shape, hp.shape, pre.shape} & set(upcasts)


def test_fp32_training_keeps_its_launches(stand_in_card):
    """fp32 streams: the 3xTF32 products and the fp32 scans, as before."""
    libs, layouts, _ = stand_in_card
    R, T, F, H = 24, 5, 16, 16
    x = torch.randn(R, T, F)
    w = _weights(2, F, H)
    before = _counts()
    _, resid = B._launch_resid(B.bilstm2_forward_resid, x, *w, None)
    assert _delta(before) == {"products_gemm": 1}
    (scan, args), = libs["resid"].calls
    (layout, ws), = layouts
    assert scan == "bilstm2_resid_scan" and layout == "resid_weight_layout"
    assert args[:3] == (16, resid[6].data_ptr(), ws.data_ptr()) and args[12:] == (
        4 * H, 8 * H, 1, 2, R, T, H, 0, 7)
    before = _counts()
    g = torch.randn(R, T, H)
    B._launch_backward(B.bilstm2_backward, x, resid, g, g, *w, None)
    assert _delta(before) == {"products_gemm": 4, "products_colsum": 1}
    (scan, args), = libs["bwd"].calls
    assert scan == "bilstm2_bwd_scan" and args[1] == 0 and args[12] is None
    assert not libs["serve"].calls

    xs = torch.randn(2, R, T, F)
    before = _counts()
    _, (hp, cp, tc, pre) = L._launch(L.lstm_forward_resid, L._MODE_RESID, xs, *w)
    assert _delta(before) == {"products_gemm": 2}
    assert libs["resid"].calls[-1][0] == "bilstm2_resid_scan"
    before = _counts()
    L._launch_backward(L.lstm_backward, xs, (hp, cp, tc, pre), torch.randn(2, R, T, H), *w)
    assert _delta(before) == {"products_gemm": 6, "products_colsum": 2}
    (scan, args), = libs["lstm_bwd"].calls
    assert args[1] == 0 and args[8] is None
    assert not libs["serve"].calls


def test_fp32_want_cs_reaches_product_and_cs_scan(stand_in_card):
    """fp32 lstm_forward_with_cs: per direction the 3xTF32 input product of
    x into its slice of P, then one cell-state scan (mode 4, dtype 0) over
    both directions reading P, on W_hh in the serving layout, with h and the
    fp32 cell state of each direction; no other scan."""
    libs, layouts, _ = stand_in_card
    D, R, T, F, H = 2, 20, 5, 16, 16
    G, M = 4 * H, R * T
    x = torch.randn(D, R, T, F)
    before, launches = _counts(), L.lstm_forward_with_cs.launches
    h, (cs,) = L._launch(L.lstm_forward_with_cs, L._MODE_CS, x, *_weights(D, F, H))
    assert L.lstm_forward_with_cs.launches == launches + 1
    assert _delta(before) == {"products_gemm": D}
    assert h.dtype == cs.dtype == torch.float32 and h.shape == cs.shape == (D, R, T, H)
    # products_gemm (a_col, a, lda, b, ldb, K, ..., bias, c, ldc, M, N, ...)
    prods = [a for _, a in libs["products"].calls]
    assert [a[1] for a in prods] == [x.data_ptr() + 4 * d * M * F for d in range(D)]
    pre = [a[12] for a in prods]
    assert pre[1] - pre[0] == 4 * M * G and [a[13:16] for a in prods] == [(G, M, G)] * D
    (scan, args), = libs["serve"].calls
    (layout, frag), = layouts
    assert scan == "bilstm2_serve_cs_scan" and layout == "serve_weight_layout"
    assert args[:4] == (16, 0, pre[0], frag.data_ptr())
    assert args[4:8] == (h.data_ptr(), h[1].data_ptr(), cs.data_ptr(), cs[1].data_ptr())
    assert args[8:] == (M * G, G, D, R, T, H, 7)
    assert not (libs["resid"].calls or libs["lstm_bwd"].calls)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stack_runs_directions_in_pairs(stand_in_card, dtype):
    """D = 3: each forward mode runs 3 input products, then its scan twice,
    directions (0, 1) and then 2 alone (dirs 2 and 1, every pointer of the
    second launch at direction 2's slice, its second direction's pointers
    repeating the first); the backward runs its scan twice the same way and
    then each direction's products, db from its own pair's partial sums."""
    libs, layouts, _ = stand_in_card
    D, R, T, F, H = 3, 20, 5, 16, 16
    G, M = 4 * H, R * T
    low = dtype == torch.bfloat16
    e = 2 if low else 4  # bytes per element of the streams
    x = torch.randn(D, R, T, F).to(dtype)
    w = _weights(D, F, H)
    expected_scan = {L._MODE_H: "bilstm2_serve_scan", L._MODE_CS: "bilstm2_serve_cs_scan",
                     L._MODE_RESID: "bilstm2_serve_resid_scan" if low else "bilstm2_resid_scan"}
    for mode, scan_name in expected_scan.items():
        for lib in libs.values():
            lib.calls.clear()
        layouts.clear()
        h, streams = L._launch(L.lstm_forward, mode, x, *w)
        prods = [a for _, a in libs["products"].calls]
        assert len(prods) == D
        pre = [a[6] if mode != L._MODE_H and low else a[12] for a in prods]
        assert [p - pre[0] for p in pre] == [4 * d * M * G for d in range(D)]
        scans = [c for lib in ("serve", "resid") for c in libs[lib].calls]
        assert [c[0] for c in scans] == [scan_name] * 2
        (_, frag), = layouts
        step = frag[0].numel() * frag.element_size()  # one direction's W_hh fragments
        (_, a0), (_, a1) = scans
        if mode == L._MODE_RESID:
            hp, cp, tc, pre_t = streams
            assert pre_t.data_ptr() == pre[0]
            # (height, pre, wfrag, lens, out0, out1, hp0, cp0, tc0, hp1, cp1, tc1, pre_dir,
            #  pre_step, reverse1, dirs, R, T, H, time_major, stream)
            for a, d0, n in ((a0, 0, 2), (a1, 2, 1)):
                dd = (d0, d0 + n - 1)
                assert a[1:3] == (pre[d0], frag.data_ptr() + d0 * step)
                assert a[4:12] == (h[dd[0]].data_ptr(), h[dd[1]].data_ptr(),
                                   *(t[d].data_ptr() for d in dd for t in (hp, cp, tc)))
                assert a[12:] == (M * G, G, 0, n, R, T, H, 0, 7)
        elif mode == L._MODE_CS:
            (cs,) = streams
            for a, d0, n in ((a0, 0, 2), (a1, 2, 1)):
                dd = (d0, d0 + n - 1)
                assert a[:4] == (16, int(low), pre[d0], frag.data_ptr() + d0 * step)
                assert a[4:8] == (h[dd[0]].data_ptr(), h[dd[1]].data_ptr(),
                                  cs[dd[0]].data_ptr(), cs[dd[1]].data_ptr())
                assert a[8:] == (M * G, G, n, R, T, H, 7)
        else:
            for a, d0, n in ((a0, 0, 2), (a1, 2, 1)):
                dd = (d0, d0 + n - 1)
                assert a[:4] == (16, int(low), pre[d0], frag.data_ptr() + d0 * step)
                assert a[5:7] == (h[dd[0]].data_ptr(), h[dd[1]].data_ptr())
                assert a[7:] == (M * G, G, H, 0, n, R, T, H, 0, 7)
    for lib in libs.values():  # the backward reads the residual mode's streams (run last)
        lib.calls.clear()
    layouts.clear()
    g = torch.randn(D, R, T, H).to(dtype)
    before = _counts()
    L._launch_backward(L.lstm_backward, x, (hp, cp, tc, pre_t), g, *w)
    # (height, dtype, pre, dpre, cp, tc, g, wsplit, dbpart, D, R, T, H, stream)
    (n0, a0), (n1, a1) = libs["lstm_bwd"].calls
    assert n0 == n1 == "lstm_bwd_scan"
    for a, d0, n in ((a0, 0, 2), (a1, 2, 1)):
        assert a[2] == pre_t[d0].data_ptr() and a[4:7] == tuple(
            t[d0].data_ptr() for t in (cp, tc, g))
        assert a[9:] == (n, R, T, H, 7) and (a[8] is not None) == low
    # dpre[2] and W_hh[2]^T (4H H elements a direction in either layout)
    assert (a1[3] - a0[3], a1[7] - a0[7]) == (2 * M * G * e, 2 * G * H * e)
    assert len(libs["products"].calls) == 4 * D  # dx, dW_ih, dW_hh, db
    calls = libs["products"].calls
    if low:
        assert _delta(before) == {"products_gemm_bf16": D, "products_gemm_bf16_col": 2 * D,
                                  "products_colsum": D}
        # products_colsum (a, lda, K, N, partial, splits, kps, stream): pair 0's partial sums
        # 2G wide, direction 1 at column G; direction 2's its own pair's, G wide
        sums = [a for name, a in calls if name == "products_colsum"]
        assert [(a[0], a[1], a[3]) for a in sums] == [
            (a0[8], 2 * G, G), (a0[8] + 4 * G, 2 * G, G), (a1[8], G, G)]
    else:
        assert _delta(before) == {"products_gemm": 3 * D, "products_colsum": D}


@pytest.mark.parametrize("K,M,N,kps", [(1000, 16, 64, 96), (4096, 128, 1024, None),
                                       (33, 8, 8, 32)])
def test_col_product_reference_against_float64(K, M, N, kps):
    """The plain version of the column-layout bf16 product, split into fp32
    partials summed in order, within a few fp32 ulps of the float64 product
    of the same bf16 values (whose products are exact)."""
    rng = np.random.default_rng(K + M)
    a, b = _bf16_values(rng, (K, M)), _bf16_values(rng, (K, N))
    got = B.gemm_bf16_col_reference(a.bfloat16(), b.bfloat16(), kps)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    want = a.T @ b
    bound = 2.0 ** -24 * 4 * K ** 0.5 * float((a.abs().T @ b.abs()).max())
    assert float((got.double() - want).abs().max()) <= bound
    step = kps or B.split_plan(M, N, K)[1]
    parts = [a[k:k + step].float().T @ b[k:k + step].float() for k in range(0, K, step)]
    assert torch.equal(got, sum(parts[1:], parts[0]))  # the splits, summed in order


def test_split_plan_depends_on_the_shapes_only():
    assert B.split_plan(128, 1024, 1_284_000) == (66, 19456)
    assert B.split_plan(128, 512, 1_284_000) == (132, 9728)
    assert B.split_plan(128, 1024, 100) == (4, 32)
    assert B.split_plan(16, 64, 0) == (1, 32)


@pytest.mark.parametrize("D,H", [(1, 16), (2, 48), (2, 128)])
def test_bwd_weight_layout_bf16_maps_back(D, H):
    """Element (d, c, ks, w, lg, lt, nt, j, e) of the backward's bf16 layout
    is W_hh[d][u][gate H + c H/2 + jj] with u = 16 w + 8 nt + lg and k = 16 ks
    + 8 j + 2 lt + e = gate H/2 + jj: every element of w_hh once, in bf16."""
    w = torch.arange(D * H * 4 * H, dtype=torch.float32).reshape(D, H, 4 * H) % 251
    got = B.bwd_weight_layout_bf16(w)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert got.shape == (D, 2, H // 8, H // 16, 8, 4, 2, 2, 2)
    idx = torch.tensor(list(itertools.product(
        range(D), range(2), range(H // 8), range(H // 16), range(8), range(4), range(2), range(2),
        range(2))))
    d, c, ks, wp, lg, lt, nt, j, e = idx.T
    k, u = 16 * ks + 8 * j + 2 * lt + e, 16 * wp + 8 * nt + lg
    col = (k // (H // 2)) * H + c * (H // 2) + k % (H // 2)
    assert torch.equal(got.flatten().float(), w[d, u, col])
    flat = (d * H + u) * 4 * H + col
    assert torch.equal(torch.sort(flat).values, torch.arange(D * H * 4 * H))


def _ldmatrix(tile, rows, cols, trans):
    """ldmatrix.x4 (.b16) as a warp runs it: lane L gives the address of row
    rows[L] at column cols[L] of ``tile``; register q of lane T receives
    matrix q's row T // 4, elements 2 (T % 4) and the next (without .trans),
    or its elements [2 (T % 4)][T // 4] and [2 (T % 4) + 1][T // 4] (.trans).
    Returns [32 lanes][4 q][2 e]."""
    lane = torch.arange(32)
    out = torch.empty(32, 4, 2, dtype=tile.dtype)
    for q in range(4):
        mat = torch.stack([tile[rows[8 * q + i], cols[8 * q + i]:cols[8 * q + i] + 8]
                           for i in range(8)])  # the 8 rows lanes 8q..8q+7 address
        for e in range(2):
            if trans:
                out[:, q, e] = mat[2 * (lane % 4) + e, lane // 4]
            else:
                out[:, q, e] = mat[lane // 4, 2 * (lane % 4) + e]
    return out


def _mma(a_regs, b0, b1):
    """mma.m16n8k16 (row A, col B): A register q of lane 4 lg + lt holds rows
    lg + 8 (q & 1), k 2 lt + 8 (q >> 1) + e; B registers j hold k 2 lt + 8 j +
    e of column lg. Returns C [32 lanes][4]: C[lg + 8 (q >> 1)][2 lt + (q &
    1)]."""
    lane = torch.arange(32)
    lg, lt = lane // 4, lane % 4
    A = torch.full((16, 16), float("nan"), dtype=torch.float64)
    Bm = torch.full((16, 8), float("nan"), dtype=torch.float64)
    for q, e in itertools.product(range(4), range(2)):
        A[lg + 8 * (q & 1), 2 * lt + 8 * (q >> 1) + e] = a_regs[:, q, e]
    for e in range(2):
        Bm[2 * lt + e, lg] = b0[:, e]
        Bm[2 * lt + 8 + e, lg] = b1[:, e]
    assert not (torch.isnan(A).any() or torch.isnan(Bm).any())
    C = A @ Bm
    return torch.stack([C[lg + 8 * (q >> 1), 2 * lt + (q & 1)] for q in range(4)], 1)


@pytest.mark.parametrize("H,MT", [(16, 1), (48, 3), (32, 2)])
def test_bwd_fragments_bf16_give_dpre_at_w_t(H, MT):
    """The bf16 backward scan's product as its lanes compute it: warp w's A
    fragments by ldmatrix from the dpre tile [16 MT][2H] (lane L addresses row
    16 mt + L % 16 at k 16 ks + 8 (L // 16)), its B registers the 16 bytes of
    wfrag[d, c, ks, w, lg, lt] (n-tile nt's j = 0, 1), and fragment (mt, nt)
    read as rows 16 mt + lg (+ 8), units 16 w + 8 nt + 2 lt (+ 1): together
    CTA c's partial dh = dpre_c @ W_hh[d]^T over its 2H gate columns, for every
    row and unit once."""
    rng = np.random.default_rng(H)
    RT = 16 * MT
    w_hh = _bf16_values(rng, (2, H, 4 * H))
    frag = B.bwd_weight_layout_bf16(w_hh.float()).double()
    lane = torch.arange(32)
    lg, lt = lane // 4, lane % 4
    for d, c in itertools.product(range(2), range(2)):
        dps = _bf16_values(rng, (RT, 2 * H))  # gate g's units j of half c at column g H/2 + j
        got = torch.full((RT, H), float("nan"), dtype=torch.float64)
        for wp, mt in itertools.product(range(H // 16), range(MT)):
            acc = torch.zeros(2, 32, 4, dtype=torch.float64)
            for ks in range(H // 8):
                a = _ldmatrix(dps, 16 * mt + lane % 16, 16 * ks + 8 * (lane // 16), trans=False)
                regs = frag[d, c, ks, wp, lg, lt]  # [32][nt][j][e]
                for nt in range(2):
                    acc[nt] += _mma(a, regs[:, nt, 0], regs[:, nt, 1])
            for nt, q in itertools.product(range(2), range(4)):
                row, unit = 16 * mt + lg + 8 * (q >> 1), 16 * wp + 8 * nt + 2 * lt + (q & 1)
                got[row, unit] = acc[nt, :, q]
        cols = [g * H + c * (H // 2) + j for g in range(4) for j in range(H // 2)]
        want = dps @ w_hh[d][:, cols].T
        assert not torch.isnan(got).any()
        assert torch.equal(got, want)


def test_col_product_fragments_give_a_t_at_b():
    """The column-layout product's A fragments: ldmatrix.trans from the
    [k][m] tile, lane L addressing k-row 16 h + L % 8 + 8 (L // 16) at m 16 mt
    + 8 ((L // 8) % 2), chained over the tile's two k-steps with the B
    fragments of the row layout (ldmatrix.trans from [k][n], lane L at k-row
    16 h + L % 8 + 8 ((L // 8) % 2), column 16 np + 8 (L // 16)): a 32-deep
    k-tile's a^T @ b for a warp's 32 x 64 outputs."""
    rng = np.random.default_rng(7)
    a, b = _bf16_values(rng, (32, 32)), _bf16_values(rng, (32, 64))  # [k][m], [k][n]
    lane = torch.arange(32)
    lg, lt = lane // 4, lane % 4
    got = torch.full((32, 64), float("nan"), dtype=torch.float64)
    for mt, np_ in itertools.product(range(2), range(4)):
        part = torch.zeros(2, 32, 4, dtype=torch.float64)
        for h in range(2):
            af = _ldmatrix(a, 16 * h + lane % 8 + 8 * (lane // 16), 16 * mt + 8 * ((lane // 8) % 2),
                           trans=True)
            bf = _ldmatrix(b, 16 * h + lane % 8 + 8 * ((lane // 8) % 2),
                           16 * np_ + 8 * (lane // 16), trans=True)
            for e in range(2):
                part[e] += _mma(af, bf[:, 2 * e], bf[:, 2 * e + 1])
        for e, q in itertools.product(range(2), range(4)):
            got[16 * mt + lg + 8 * (q >> 1), 16 * np_ + 8 * e + 2 * lt + (q & 1)] = part[e, :, q]
    assert not torch.isnan(got).any()
    assert torch.equal(got, a.T @ b)
