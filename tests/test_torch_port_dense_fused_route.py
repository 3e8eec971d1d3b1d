"""The dense mode of ``_bilstm2_kernel`` and the ``reverse_dir1`` mode of
``_lstm_kernel`` on the serving route.

``bilstm2_dense_forward`` (``TSS_FUSED_DENSE=1``) runs on the card as the
fused pair's serving launches (the input product of csrc/products.cu, then
the serving cluster scan of csrc/bilstm2_serve.cu) with the two outputs side
by side in an H-wide scratch, then the two SplitDense products y_d = h_d @
wo2[d] (csrc/products.cu: 3xTF32 for fp32, the bf16-operand product with a
bf16 output, rounded once, for bf16), wo2's columns zero-padded to the
product kernel's multiple and the outputs cut back, so any Fo >= 1 runs.
``bilstm_fused`` (``bilstm_pallas_fused``) is the pair's serving route with
its outputs side by side: ``bilstm2_forward``'s launches in fp32,
``bilstm2_forward_bm``'s in bf16 (bf16 x through the bf16-operand product).

On the CPU: (a) the bf16-output product's plain version is the exact
products summed in fp32 and rounded once to bf16; (b) the entries' routing
(meta tensors) and that a CPU tensor launches nothing; (c) the route's
arguments on a stand-in card (libraries replaced by recorders); (d) the
dense plain version against ``bilstm2_dense_forward`` in Pallas interpret
mode for Fo below, above and at H. On the card (``cuda`` tests, run there
with ``python -m pytest --noconftest -m cuda
tests/test_torch_port_dense_fused_route.py``): each entry against its plain
version (fp32 1e-4; bf16 2^-7 and 70 dB), ``bilstm_fused`` bit for bit the
default routes' outputs side by side, ragged shapes, padded widths, Fo in
{6, 64, 128, 130}, and the launches of the product and scan kernels."""

import contextlib
import functools
import types

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch.ops import bilstm2 as B
from tss_dprnn_tpu_torch.ops import lstm as L

BF16_ATOL = 2.0 ** -7
BF16_SNR_DB = 70.0


def _bf16_values(rng, shape, scale=1.0):
    return torch.from_numpy(scale * rng.standard_normal(shape)).bfloat16()


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |v| (8 significant bits)."""
    return 2.0 ** (torch.floor(torch.log2(v.abs().double().clamp_min(2.0 ** -126))) - 7)


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("M,K,N", [(300, 128, 96), (37, 16, 8)])
def test_bf16_output_product_plain_version_rounds_once(M, K, N):
    """``gemm_bf16_reference(..., out_dtype=bf16)`` is the fp32 sum of the
    exact products (a product of two bf16 values is exact in fp32) rounded
    once to bf16: bit for bit its fp32 output rounded, that fp32 sum within
    K + 1 fp32 roundings of float64, and the bf16 value within half a bf16
    ulp of the fp32 sum."""
    rng = np.random.default_rng(M + N)
    a, b = _bf16_values(rng, (M, K)), _bf16_values(rng, (K, N), 0.1)
    bias = torch.from_numpy(rng.standard_normal(N) * 0.1).float()
    for bb in (None, bias):
        got = B.gemm_bf16_reference(a, b, bb, out_dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16 and got.shape == (M, N)
        fp32 = B.gemm_bf16_reference(a, b, bb)
        assert fp32.dtype == torch.float32
        assert torch.equal(got, fp32.bfloat16())
        exact = a.double() @ b.double() + (0.0 if bb is None else bb.double())
        scale = a.double().abs() @ b.double().abs() + (0.0 if bb is None else bb.double().abs())
        assert ((fp32.double() - exact).abs() <= (K + 1) * 2.0 ** -24 * scale).all()
        assert ((got.double() - fp32.double()).abs() <= _bf16_ulp(fp32) / 2).all()
    # each product exact in fp32: the fp32 products of one k equal float64's
    assert torch.equal((a[:, :1].float() * b[:1].float()).double(),
                       a[:, :1].double() * b[:1].double())


# ------------------------------------------------------------------ (b)

def test_entries_take_the_serving_route(monkeypatch):
    """A tensor that is not on the CPU (here on the meta device) goes to the
    serving route: ``bilstm_fused`` as the pair with the bf16 product and its
    outputs side by side, no manual-DMA rounding; ``bilstm2_dense_forward``
    (its operator's body; through the operator a meta tensor gets the
    shape-only version) to the dense route. A CPU tensor runs the plain
    version and launches nothing."""
    calls = []

    def record(name):
        return lambda *a, **k: calls.append((name, a, k)) or ("out", "out")

    monkeypatch.setattr(B, "_launch_serve", record("serve"))
    monkeypatch.setattr(L, "_launch_serve", record("serve"))
    monkeypatch.setattr(B, "_launch_serve_dense", record("dense"))
    w_ih, b, w_hh = torch.zeros(2, 16, 64), torch.zeros(2, 64), torch.zeros(2, 16, 64)
    wo2 = torch.zeros(2, 16, 6)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(3, 5, 16, dtype=dtype, device="meta")
        L.bilstm_fused(x, w_ih, w_hh, b)
        B._dense_forward_impl(x, w_ih, b, w_hh, wo2)
        assert [o.shape for o in B.bilstm2_dense_forward(x, w_ih, b, w_hh, wo2)] == [(3, 5, 6)] * 2
    assert [(c[0], c[1][0]) for c in calls] == [
        ("serve", L.bilstm_fused), ("dense", B.bilstm2_dense_forward)] * 2
    for c in calls[::2]:
        assert c[2] == {"bf16_product": True, "side_by_side": True}  # v2 stays False
        assert c[1][-1] is None  # no lengths
    assert all(c[1][-1] is wo2 for c in calls[1::2])
    before = B.launch_count(), L.launch_count(), dict(B.product_launch_counts())
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(3, 5, 16).to(dtype)
        L.bilstm_fused(x, w_ih, w_hh, b)
        B.bilstm2_dense_forward(x, w_ih, b, w_hh, wo2)
    assert (B.launch_count(), L.launch_count(), B.product_launch_counts()) == before
    assert len(calls) == 4


# ------------------------------------------------------------------ (c)

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
    """CPU tensors pass for CUDA ones and the libraries record their calls.
    Every buffer ``torch.empty`` gives stays alive until the test ends, so
    no address recorded in a call is handed out again: two recorded
    addresses are equal only where the route passed one buffer twice (the
    CPU allocator would otherwise recycle a freed buffer, the input
    product's among them, depending on what ran before)."""
    kept, empty = [], torch.empty

    def empty_kept(*args, **kwargs):
        kept.append(empty(*args, **kwargs))
        return kept[-1]

    monkeypatch.setattr(torch, "empty", empty_kept)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    libs = {"products": _Recorder(), "serve": _Recorder()}
    for mod in (B, L):
        monkeypatch.setattr(mod, "_library_products", lambda: libs["products"])
        monkeypatch.setattr(mod, "_library_serve", lambda: libs["serve"])
    monkeypatch.setattr(B, "_max_clusters", lambda which, H, device, height, dtype: 66)
    return libs


def _weights(F, H):
    g = torch.Generator().manual_seed(F + H)
    return [torch.randn(*s, generator=g) * 0.1 for s in ((2, F, 4 * H), (2, 4 * H), (2, H, 4 * H))]


def _counts(fn):
    return {fn.__name__: fn.launches, **B.product_launch_counts()}


def _moved(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


# scan arguments: (height, dtype code, pre, wfrag, lens, out0, out1, pre_dir, pre_step,
# out_step, reverse1, dirs, R, T, H, time_major, stream)

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_route_arguments(stand_in_card, dtype):
    """bilstm_fused's launches: one input product into [R, T, 2, 4H] (fp32:
    the 3xTF32 kernel; bf16: the bf16 product on x itself, fp32 C), then one
    serving scan with dtype code 0 or 1 (h-only rounding), direction 1
    reversed and the outputs side by side (out1 = out0 + H, out_step 2H)."""
    libs = stand_in_card
    R, T, F, H = 40, 6, 16, 32
    x = torch.randn(R, T, F).to(dtype)
    low = dtype == torch.bfloat16
    before = _counts(L.bilstm_fused)
    out = B._launch_serve(L.bilstm_fused, x, *_weights(F, H), None, bf16_product=True,
                          side_by_side=True)
    assert out.shape == (R, T, 2 * H) and out.dtype == dtype
    kind = "products_gemm_bf16" if low else "products_gemm"
    assert _moved(before, _counts(L.bilstm_fused)) == {"bilstm_fused": 1, kind: 1}
    (gemm, gargs), = libs["products"].calls
    assert gemm == kind and gargs[0] == (x.data_ptr() if low else 0)
    if low:  # (a, lda, b, ldb, K, bias, c, ldc, M, N, c_bf16, stream)
        assert gargs[1:2] + gargs[3:5] + gargs[7:] == (F, 8 * H, F, 8 * H, R * T, 8 * H, 0, 7)
    (scan, args), = libs["serve"].calls
    assert scan == "bilstm2_serve_scan" and args[2] == gargs[6 if low else 12]
    assert args[1] == int(low) and args[4] is None
    assert args[5:7] == (out.data_ptr(), out.data_ptr() + H * out.element_size())
    assert args[7:] == (4 * H, 8 * H, 2 * H, 1, 2, R, T, H, 0, 7)


@pytest.mark.parametrize("Fo", [6, 32, 34])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_route_arguments(stand_in_card, dtype, Fo):
    """The dense route's launches: the fused route's product and scan (its
    outputs side by side into the scratch), then per direction one product
    whose A is exactly where the scan wrote that direction (row pitch 2H, K =
    H) and whose B is wo2[d] padded to N = Fo rounded up to 4 (fp32, the
    3xTF32 kernel, no bias, one split) or 8 (bf16: the bf16 product with its
    bf16-output flag), written with ldc = N; y0 and y1 each [R, T, Fo] in
    x's type."""
    libs = stand_in_card
    R, T, F, H = 40, 6, 16, 32
    x = torch.randn(R, T, F).to(dtype)
    w_ih, b, w_hh = _weights(F, H)
    wo2 = torch.randn(2, H, Fo) * 0.1
    low = dtype == torch.bfloat16
    n = -(-Fo // (8 if low else 4)) * (8 if low else 4)
    before = _counts(B.bilstm2_dense_forward)
    y0, y1 = B._launch_serve_dense(B.bilstm2_dense_forward, x, w_ih, b, w_hh, wo2)
    assert y0.shape == y1.shape == (R, T, Fo) and y0.dtype == y1.dtype == dtype
    kind = "products_gemm_bf16" if low else "products_gemm"
    assert _moved(before, _counts(B.bilstm2_dense_forward)) == {"bilstm2_dense_forward": 1,
                                                                 kind: 3}
    (scan, args), = libs["serve"].calls
    assert args[1] == int(low) and args[4] is None and args[6] - args[5] == H * x.element_size()
    assert args[7:] == (4 * H, 8 * H, 2 * H, 1, 2, R, T, H, 0, 7)
    (g_in, a_in), *outs = libs["products"].calls
    assert g_in == kind and args[2] == a_in[6 if low else 12]  # the scan reads the input product
    assert [g for g, _ in outs] == [kind, kind]
    ys = [a[6 if low else 12] for _, a in outs]
    assert ys[0] != ys[1] and a_in[6 if low else 12] not in ys
    if n == Fo:  # no columns to cut: the products write the outputs themselves
        assert ys == [y0.data_ptr(), y1.data_ptr()]
    wo_ptrs = [a[2] if low else a[3] for _, a in outs]
    assert wo_ptrs[1] - wo_ptrs[0] == H * n * x.element_size()  # wo2[1] after wo2[0], padded
    M = R * T
    for d, (_, a) in enumerate(outs):
        if low:  # (a, lda, b, ldb, K, bias, c, ldc, M, N, c_bf16, stream)
            assert a[0] == args[5 + d]
            assert a[1:2] + a[3:6] + a[7:] == (2 * H, n, H, None, n, M, n, 1, 7)
        else:  # (a_col, a1, lda1, b1, ldb1, k1, a2, lda2, b2, ldb2, k2, bias, c, ldc, M, N,
            #  splits, kps, split_stride, stream)
            assert a[0] == 0 and a[1] == args[5 + d]
            assert a[2:3] + a[4:12] + a[13:17] == (2 * H, n, H, None, 0, None, 0, 0, None, n, M,
                                                   n, 1)
            assert a[17] % 32 == 0 and a[17] >= H and a[19] == 7


def test_dense_route_refuses_a_wrong_wo2(stand_in_card):
    libs = stand_in_card
    x = torch.randn(4, 3, 16)
    w = _weights(16, 16)
    before = B.launch_count(), dict(B.product_launch_counts())
    for wo2 in (torch.zeros(2, 32, 8), torch.zeros(1, 16, 8), torch.zeros(2, 16, 0)):
        with pytest.raises(ValueError, match="wo2 must be"):
            B._launch_serve_dense(B.bilstm2_dense_forward, x, *w, wo2)
    assert (B.launch_count(), B.product_launch_counts()) == before
    assert not any(lib.calls for lib in libs.values())


# ------------------------------------------------------------------ (d)

@pytest.fixture
def interpret(monkeypatch):
    pytest.importorskip("jax")
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Fo", [6, 18, 128])
def test_dense_plain_version_matches_pallas(interpret, Fo, dtype):
    """F = H = 16, R = 24, T = 11 (the TPU entry pads time): Fo below H and
    no multiple of 4 or 8, H + 2, and 128, which the first design of the
    card's kernel refused. fp32 within 1e-5; bf16 (the weights holding bf16
    values, as both consume them) within one bf16 ulp of each value."""
    import jax.numpy as jnp

    from tss_dprnn_tpu.ops import pallas_lstm

    F = H = 16
    rng = np.random.default_rng(Fo)
    x = rng.standard_normal((24, 11, F)).astype(np.float32)
    w_ih = (rng.standard_normal((2, F, 4 * H)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((2, 4 * H)) * 0.1).astype(np.float32)
    w_hh = (rng.standard_normal((2, H, 4 * H)) * 0.3).astype(np.float32)
    wo = (rng.standard_normal((2, H, Fo)) * 0.3).astype(np.float32)
    if dtype == torch.bfloat16:
        w_ih, w_hh, wo = (torch.from_numpy(w).bfloat16().float().numpy() for w in (w_ih, w_hh, wo))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = pallas_lstm.bilstm2_dense_forward(jnp.asarray(x, jdt), w_ih, b, w_hh, wo)
    got = B.bilstm2_dense_forward(torch.from_numpy(x).to(dtype),
                                  *(torch.from_numpy(a) for a in (w_ih, b, w_hh, wo)))
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        assert g.shape == (24, 11, Fo) and g.dtype == dtype
        g = g.float()
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
        else:
            assert ((g - w).abs().double() <= _bf16_ulp(torch.maximum(g.abs(), w.abs()))).all()


# ---------------------------------------------------------------- on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _card_weights(F, H, g):
    k = H ** -0.5
    return [((torch.rand(*s, generator=g) * 2 - 1) * k).cuda()
            for s in ((2, F, 4 * H), (2, 4 * H), (2, H, 4 * H))]


def _snr_db(got, want):
    got, want = got.double(), want.double()
    return float(10 * torch.log10(want.pow(2).sum() / (got - want).pow(2).sum().clamp_min(1e-300)))


def _close(got, want, dtype):
    got = torch.cat([o.float().flatten() for o in got]) if isinstance(got, tuple) else got
    want = torch.cat([o.float().flatten() for o in want]) if isinstance(want, tuple) else want
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    if dtype == torch.float32:
        assert err <= 1e-4, err
    else:
        assert err <= BF16_ATOL and _snr_db(got, want) >= BF16_SNR_DB, (err, _snr_db(got, want))


def _all_counts():
    return {**{e.__name__: e.launches for e in (*B.ENTRIES, *L.ENTRIES)},
            **B.product_launch_counts()}


def _check_fused(R, T, F, H, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    w_ih, b, w_hh = _card_weights(F, H, g)
    x = torch.randn(R, T, F, generator=g).to(dtype).cuda()
    before = _all_counts()
    got = L.bilstm_fused(x, w_ih, w_hh, b)
    torch.cuda.synchronize()
    product = "products_gemm" if dtype == torch.float32 else "products_gemm_bf16"
    assert _moved(before, _all_counts()) == {"bilstm_fused": 1, product: 1}
    assert got.shape == (R, T, 2 * H) and got.dtype == dtype
    _close(got, L.bilstm_fused_reference(x, w_ih, w_hh, b), dtype)
    # the same launches as the default (fp32) or batch-major (bf16) pair, the
    # outputs side by side: bit for bit
    pair = B.bilstm2_forward if dtype == torch.float32 else B.bilstm2_forward_bm
    assert torch.equal(got, torch.cat(pair(x, w_ih, b, w_hh), dim=-1))
    assert torch.equal(got, L.bilstm_fused(x, w_ih, w_hh, b))  # no float atomics


def _check_dense(R, T, F, H, Fo, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    w_ih, b, w_hh = _card_weights(F, H, g)
    wo2 = ((torch.rand(2, H, Fo, generator=g) * 2 - 1) * H ** -0.5).cuda()
    x = torch.randn(R, T, F, generator=g).to(dtype).cuda()
    before = _all_counts()
    got = B.bilstm2_dense_forward(x, w_ih, b, w_hh, wo2)
    torch.cuda.synchronize()
    product = "products_gemm" if dtype == torch.float32 else "products_gemm_bf16"
    assert _moved(before, _all_counts()) == {"bilstm2_dense_forward": 1, product: 3}
    assert all(y.shape == (R, T, Fo) and y.dtype == dtype and y.is_contiguous() for y in got)
    _close(got, B.bilstm2_dense_reference(x, w_ih, b, w_hh, wo2), dtype)
    again = B.bilstm2_dense_forward(x, w_ih, b, w_hh, wo2)
    assert all(torch.equal(u, v) for u, v in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,T,F,H", [(5136, 250, 128, 128), (203, 33, 128, 128),
                                     (37, 21, 12, 10), (90, 17, 20, 24)])
def test_fused_matches_reference_on_card(R, T, F, H, dtype):
    """chip_smoke.py's shape (8 x 10 s, the intra scan), a ragged one and
    widths that are no multiple of 16."""
    _needs_card()
    _check_fused(R, T, F, H, dtype, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Fo", [6, 64, 128, 130])
def test_dense_matches_reference_on_card(Fo, dtype):
    """Ragged R and T at F = H = 128, Fo below, at and above H."""
    _needs_card()
    _check_dense(203, 33, 128, 128, Fo, dtype, seed=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,T,F,H,Fo", [(5136, 250, 128, 128, 128), (37, 21, 12, 10, 6),
                                        (90, 17, 20, 24, 26)])
def test_dense_shapes_on_card(R, T, F, H, Fo, dtype):
    """chip_smoke.py's shape and padded widths (H padded to 16 or 32, Fo
    padded to the product kernel's multiple)."""
    _needs_card()
    _check_dense(R, T, F, H, Fo, dtype, seed=3)
