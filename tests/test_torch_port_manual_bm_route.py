"""The batch-major and manual-DMA kernels' entries on the serving route.

``bilstm2_forward_bm`` (``_bilstm2_bm_kernel``) and ``lstm_scan_v2`` /
``bilstm_v2`` (``_lstm_manual_kernel``) run on the card as the fused pair's
and the stack's serving route: the input product P = x @ W_ih + b
(csrc/products.cu), then the serving cluster scan (csrc/bilstm2_serve.cu).
fp32 streams take the default route's launches as they are; bf16 x goes to
the bf16-operand product (``products_gemm_bf16``, no upcast), and the
manual-DMA entries' bf16 scan rounds as that TPU kernel's source does
(dtype 2: the gates, each operation of the activations, i * g, tanh(c), h).

On the CPU: (a) the bf16 product's plain version (``gemm_bf16_reference``)
on bf16 values is their exact products summed in fp32, the same as the
3xTF32 product of those values (whose small parts are 0); (b) the manual-DMA
function in the route's order (P first, then + h @ W_hh, rounded as
``ops/lstm._v2_scan`` rounds) against ``lstm_scan_pallas_v2`` and
``bilstm_pallas_v2`` in Pallas interpret mode; the entries' routing (meta
tensors), and the route's arguments on a stand-in card (libraries replaced
by recorders). On the card (``cuda`` tests, run there with ``python -m
pytest --noconftest -m cuda tests/test_torch_port_manual_bm_route.py``):
each entry against its plain version (fp32 1e-4; bf16 2^-7 and 70 dB, 55 dB
for the manual-DMA rounding) and in fp32 bit for bit against the default
route, ragged shapes, padded widths, the launches of the product and scan
kernels, and the bf16 product against its plain version and float64."""

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
V2_BF16_SNR_DB = 55.0


def _snr_db(got, want):
    got, want = got.double(), want.double()
    return float(10 * torch.log10(want.pow(2).sum() / (got - want).pow(2).sum().clamp_min(1e-300)))


def _bf16_values(rng, shape, scale=1.0):
    return torch.from_numpy(scale * rng.standard_normal(shape)).bfloat16()


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("M,K,N", [(300, 128, 96), (37, 16, 64)])
def test_bf16_product_plain_version_is_the_exact_products(M, K, N):
    """On bf16 values the plain version is within fp32 rounding of float64
    (each product exact, K + 1 roundings of the sum), and equals the 3xTF32
    product of the same values bit for bit: a bf16 value is a TF32 value, so
    the split's small parts are 0 and two of its three products are 0."""
    rng = np.random.default_rng(M)
    a, b = _bf16_values(rng, (M, K)), _bf16_values(rng, (K, N), 0.1)
    bias = torch.from_numpy(rng.standard_normal(N) * 0.1).float()
    got = B.gemm_bf16_reference(a, b, bias)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    ref = a.double() @ b.double() + bias.double()
    scale = a.double().abs() @ b.double().abs() + bias.double().abs()
    assert ((got.double() - ref).abs() <= (K + 1) * 2.0 ** -24 * scale).all()
    for t in (a, b):
        big, small = B.tf32_split(t.float())
        assert torch.equal(big, t.float()) and not small.any()
    assert torch.equal(B.tf32x3_matmul(a.float(), b.float()) + bias, got)
    assert torch.equal(B.gemm_reference([(a, b)], bias), got)


# ------------------------------------------------------------------ (b)

def _route_v2(x, w_ih, b, w_hh):
    """The manual-DMA function as the route computes it: per direction
    P = x @ W_ih + b (:func:`gemm_bf16_reference`, fp32), then each step's
    gates round(P_t + h @ W_hh) and the rest rounded as ``ops/lstm._v2_scan``
    rounds (fp32 streams round nowhere). x [D, R, T, F] -> [D, R, T, H]."""
    D, R, T, F = x.shape
    H = w_hh.shape[1]
    dt = x.dtype

    def rnd(v):
        return v.to(dt).float()

    def sigmoid(v):
        return rnd(1.0 / rnd(1.0 + rnd(torch.exp(-v))))

    w_ih, w_hh = w_ih.to(dt), w_hh.to(dt).float()
    P = torch.stack([B.gemm_bf16_reference(x[d].reshape(R * T, F), w_ih[d], b[d]).view(R, T, -1)
                     for d in range(D)])
    h = P.new_zeros(D, R, H)
    c = P.new_zeros(D, R, H)
    out = x.new_empty(D, R, T, H)
    for t in range(T):
        i, f, gg, o = rnd(P[:, :, t] + torch.bmm(h, w_hh)).split(H, dim=-1)
        i, f, gg, o = sigmoid(i), sigmoid(f), rnd(torch.tanh(gg)), sigmoid(o)
        c = f * c + rnd(i * gg)
        h = rnd(o * rnd(torch.tanh(c)))
        out[:, :, t] = h.to(dt)
    return out


@pytest.fixture
def interpret(monkeypatch):
    pytest.importorskip("jax")
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry", ["lstm_scan_v2", "bilstm_v2"])
def test_route_order_matches_pallas(interpret, entry, dtype):
    """R = 24, T = 33 (the TPU entry pads T to its chunks), F = H = 32: the
    route's order against the Pallas entry, fp32 within 1e-5. bf16: within
    2^-7 of it, and at >= 55 dB against the plain version that rounds as the
    TPU source does (``lstm_v2_reference``; the gates summed in another order
    may flip one of the six roundings). Against the interpret run the bar is
    the plain version's own score, within 1 dB, and 2 dB above the h-only
    rounding's: XLA on the CPU drops two of the source's roundings (f's last
    operation and i * g, widened to fp32 right after), so the plain version
    itself reads about 49 dB there, and the h-only rounding about 46."""
    import jax.numpy as jnp

    from tss_dprnn_tpu.ops import pallas_lstm

    rng = np.random.default_rng(5)
    R, T, F, H = 24, 33, 32, 32
    k = H ** -0.5
    w_ih, b, w_hh = (torch.from_numpy(rng.uniform(-k, k, s).astype(np.float32))
                     for s in ((2, F, 4 * H), (2, 4 * H), (2, H, 4 * H)))
    w_ih, w_hh = (w.to(dtype).float() for w in (w_ih, w_hh))  # as the kernels consume them
    shape = (2, R, T, F) if entry == "lstm_scan_v2" else (R, T, F)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    fn = {"lstm_scan_v2": pallas_lstm.lstm_scan_pallas_v2,
          "bilstm_v2": pallas_lstm.bilstm_pallas_v2}[entry]
    want = torch.from_numpy(np.asarray(fn(jnp.asarray(x.float().numpy(), jdt), w_ih.numpy(),
                                          w_hh.numpy(), b.numpy()).astype(jnp.float32)))
    if entry == "lstm_scan_v2":
        got = _route_v2(x, w_ih, b, w_hh)
        plain = L.lstm_v2_reference(x, w_ih, w_hh, b)
        h_only = L.lstm_reference(x, w_ih, b, w_hh)
    else:  # the pair on one x, direction 1 reversed, side by side
        out = _route_v2(torch.stack([x, x.flip(1)]), w_ih, b, w_hh)
        got = torch.cat([out[0], out[1].flip(1)], dim=-1)
        plain = L.bilstm_v2_reference(x, w_ih, w_hh, b)
        h_only = L.bilstm_fused_reference(x, w_ih, w_hh, b)
    assert got.shape == want.shape and got.dtype == dtype
    got, plain, h_only = got.float(), plain.float(), h_only.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        assert float((got - want).abs().max()) <= BF16_ATOL
        assert _snr_db(got, plain) >= V2_BF16_SNR_DB
        snr = _snr_db(got, want)
        assert snr >= _snr_db(plain, want) - 1.0 and snr >= _snr_db(h_only, want) + 2.0


# ------------------------------------------------------- routing on the CPU

def test_entries_take_the_serving_route(monkeypatch):
    """A tensor that is not on the CPU (here on the meta device) goes to the
    serving route: the batch-major pair with the bf16 product (its
    operator's body; through the operator a meta tensor gets the shape-only
    version), bilstm_v2 as the pair with the bf16 product and the manual-DMA
    rounding side by side, lstm_scan_v2 as the stack's h-only route with
    both; a CPU tensor runs the plain version and launches nothing."""
    calls = []

    def record(name):
        return lambda *a, **k: calls.append((name, a, k)) or (("out", "out") if name == "serve"
                                                                else ("out", ()))

    monkeypatch.setattr(B, "_launch_serve", record("serve"))
    monkeypatch.setattr(L, "_launch_serve", record("serve"))
    monkeypatch.setattr(L, "_launch_scan", record("scan"))
    w1 = [torch.zeros(1, 16, 64), torch.zeros(1, 16, 64), torch.zeros(1, 64)]  # w_ih, w_hh, b
    w2 = [torch.zeros(2, 16, 64), torch.zeros(2, 64), torch.zeros(2, 16, 64)]  # w_ih, b, w_hh
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(3, 5, 16, dtype=dtype, device="meta")
        B._forward_bm_impl(x, *w2)
        L.bilstm_v2(x, w2[0], w2[2], w2[1])
        L.lstm_scan_v2(x[None], *w1)
        assert [o.shape for o in B.bilstm2_forward_bm(x, *w2)] == [(3, 5, 16)] * 2
    assert [(c[0], c[1][0], c[2]) for c in calls[:3]] == [
        ("serve", B.bilstm2_forward_bm, {"bf16_product": True}),
        ("serve", L.bilstm_v2, {"bf16_product": True, "side_by_side": True, "v2": True}),
        ("scan", L.lstm_scan_v2, {"v2": True})]
    assert calls[2][1][1] == L._MODE_H and len(calls) == 6
    before = B.launch_count(), L.launch_count(), dict(B.product_launch_counts())
    x = torch.randn(3, 5, 16).bfloat16()
    B.bilstm2_forward_bm(x, *w2)
    L.lstm_scan_v2(x[None], *w1)
    assert (B.launch_count(), L.launch_count(), B.product_launch_counts()) == before


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
    """CPU tensors pass for CUDA ones and the libraries record their calls."""
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


def _weights(D, F, H):
    g = torch.Generator().manual_seed(D * F + H)
    return [torch.randn(*s, generator=g) * 0.1 for s in ((D, F, 4 * H), (D, 4 * H), (D, H, 4 * H))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry", ["bilstm2_forward_bm", "bilstm_v2"])
def test_pair_entries_route_arguments(stand_in_card, entry, dtype):
    """The pair: one product into [R, T, 2, 4H] (fp32: the 3xTF32 kernel on
    the upcast x, as the default route; bf16: the bf16 product on x itself,
    W_ih as [F, 8H] bf16), then one serving scan with direction 1 reversed;
    bilstm_v2's outputs side by side (out1 = out0 + H, row-steps 2H apart)
    and, in bf16, dtype 2."""
    libs = stand_in_card
    R, T, F, H = 40, 6, 16, 32
    x = torch.randn(R, T, F).to(dtype)
    w_ih, b, w_hh = _weights(2, F, H)
    v2 = entry == "bilstm_v2"
    fn = getattr(L if v2 else B, entry)
    low = dtype == torch.bfloat16
    before = fn.launches, dict(B.product_launch_counts())
    out = B._launch_serve(fn, x, w_ih, b, w_hh, None, bf16_product=True, side_by_side=v2, v2=v2)
    (gemm, gargs), = libs["products"].calls
    if low:
        # (a, lda, b, ldb, K, bias, c, ldc, M, N, c_bf16, stream)
        assert gemm == "products_gemm_bf16" and gargs[0] == x.data_ptr()
        assert gargs[1:2] + gargs[3:5] + gargs[7:] == (F, 8 * H, F, 8 * H, R * T, 8 * H, 0, 7)
    else:
        assert gemm == "products_gemm" and gargs[0] == 0 and gargs[-6:-4] == (R * T, 8 * H)
    pre = gargs[6] if low else gargs[12]
    (scan, args), = libs["serve"].calls
    assert scan == "bilstm2_serve_scan" and args[2] == pre
    assert args[1] == (2 if v2 and low else int(low)) and args[4] is None
    if v2:
        assert out.shape == (R, T, 2 * H) and out.dtype == dtype
        assert args[5:7] == (out.data_ptr(), out.data_ptr() + H * out.element_size())
    else:
        assert all(o.shape == (R, T, H) and o.dtype == dtype for o in out)
        assert args[5:7] == (out[0].data_ptr(), out[1].data_ptr())
    # (pre_dir, pre_step, out_step, reverse1, dirs, R, T, H, time_major, stream)
    assert args[7:] == (4 * H, 8 * H, 2 * H if v2 else H, 1, 2, R, T, H, 0, 7)
    counts = B.product_launch_counts()
    kind = "products_gemm_bf16" if low else "products_gemm"
    assert fn.launches == before[0] + 1
    assert {k: counts[k] - before[1][k] for k in counts} == {
        k: int(k == kind) for k in counts}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stack_entry_route_arguments(stand_in_card, dtype):
    """lstm_scan_v2 over D = 2 stacked directions: per direction one product
    (bf16: the bf16 product at x[d]'s offset, W_ih[d] bf16 [F, 4H]) into
    [D, R, T, 4H], then one serving scan, no direction reversed, dtype 2 in
    bf16."""
    libs = stand_in_card
    D, R, T, F, H = 2, 20, 5, 16, 16
    x = torch.randn(D, R, T, F).to(dtype)
    w_ih, b, w_hh = _weights(D, F, H)
    low = dtype == torch.bfloat16
    before = L.lstm_scan_v2.launches
    out, streams = L._launch_scan(L.lstm_scan_v2, L._MODE_H, x, w_ih, b, w_hh, v2=True)
    assert out.shape == (D, R, T, H) and out.dtype == dtype and streams == ()
    assert L.lstm_scan_v2.launches == before + 1
    calls = libs["products"].calls
    assert [c[0] for c in calls] == ["products_gemm_bf16" if low else "products_gemm"] * D
    M, G = R * T, 4 * H
    if low:
        assert [c[1][0] - x.data_ptr() for c in calls] == [2 * d * M * F for d in range(D)]
        assert [(c[1][1], c[1][3], c[1][4], c[1][7], c[1][8], c[1][9]) for c in calls] == [
            (F, G, F, G, M, G)] * D
        assert calls[1][1][6] - calls[0][1][6] == 4 * M * G  # P[d] at d R T 4H
    (scan, args), = libs["serve"].calls
    assert args[1] == (2 if low else 0) and args[4] is None
    assert args[5:7] == (out[0].data_ptr(), out[1].data_ptr())
    assert args[7:] == (M * G, G, H, 0, D, R, T, H, 0, 7)


# ---------------------------------------------------------------- on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _card_weights(D, F, H, g):
    k = H ** -0.5
    return [((torch.rand(*s, generator=g) * 2 - 1) * k).cuda()
            for s in ((D, F, 4 * H), (D, 4 * H), (D, H, 4 * H))]


def _close(got, want, dtype, snr_bar):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    if dtype == torch.float32:
        assert err <= 1e-4, err
    else:
        assert err <= BF16_ATOL and _snr_db(got, want) >= snr_bar, (err, _snr_db(got, want))


def _counts():
    return {**{e.__name__: e.launches for e in (*B.ENTRIES, *L.ENTRIES)},
            **B.product_launch_counts()}


def _check_entry(entry, R, T, F, H, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    D = 1 if entry == "lstm_scan_v2" else 2
    w_ih, b, w_hh = _card_weights(D, F, H, g)
    shape = (D, R, T, F) if entry == "lstm_scan_v2" else (R, T, F)
    x = torch.randn(*shape, generator=g).to(dtype).cuda()
    fn, plain, default = {
        "bilstm2_forward_bm": (lambda: B.bilstm2_forward_bm(x, w_ih, b, w_hh),
                               lambda: B.bilstm2_bm_reference(x, w_ih, b, w_hh),
                               lambda: B.bilstm2_forward(x, w_ih, b, w_hh)),
        "bilstm_v2": (lambda: L.bilstm_v2(x, w_ih, w_hh, b),
                      lambda: L.bilstm_v2_reference(x, w_ih, w_hh, b),
                      lambda: torch.cat(B.bilstm2_forward(x, w_ih, b, w_hh), dim=-1)),
        "lstm_scan_v2": (lambda: L.lstm_scan_v2(x, w_ih, w_hh, b),
                         lambda: L.lstm_v2_reference(x, w_ih, w_hh, b),
                         lambda: L.lstm_forward(x, w_ih, b, w_hh)),
    }[entry]
    before = _counts()
    got = fn()
    torch.cuda.synchronize()
    after = _counts()
    product = "products_gemm" if dtype == torch.float32 else "products_gemm_bf16"
    # the pair's one product covers both directions; the stack runs one per direction
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        entry: 1, product: D if entry == "lstm_scan_v2" else 1}
    got = torch.cat([o.flatten() for o in got]) if isinstance(got, tuple) else got.flatten()
    want = plain()
    want = torch.cat([o.flatten() for o in want]) if isinstance(want, tuple) else want.flatten()
    assert got.dtype == dtype
    _close(got, want, dtype, V2_BF16_SNR_DB if entry != "bilstm2_forward_bm" else BF16_SNR_DB)
    if dtype == torch.float32:  # the default route's launches: the same outputs bit for bit
        ref = default()
        ref = torch.cat([o.flatten() for o in ref]) if isinstance(ref, tuple) else ref.flatten()
        assert torch.equal(got, ref)
    again = fn()
    again = torch.cat([o.flatten() for o in again]) if isinstance(again, tuple) else again.flatten()
    assert torch.equal(got, again)  # no float atomics


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry,R,T", [("bilstm2_forward_bm", 5136, 250), ("bilstm_v2", 5136, 250),
                                       ("lstm_scan_v2", 2000, 642)])
def test_entries_match_reference_on_card(entry, R, T, dtype):
    """chip_smoke.py's shapes (8 x 10 s)."""
    _needs_card()
    _check_entry(entry, R, T, 128, 128, dtype, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry", ["bilstm2_forward_bm", "bilstm_v2", "lstm_scan_v2"])
@pytest.mark.parametrize("R,T,F,H", [(203, 33, 128, 128), (37, 21, 12, 10), (90, 17, 20, 24)])
def test_entries_ragged_and_padded_on_card(entry, R, T, F, H, dtype):
    """Row counts no multiple of a tile, and widths no multiple of 16 (the
    wrappers zero-pad them)."""
    _needs_card()
    _check_entry(entry, R, T, F, H, dtype, seed=2)


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", [(1000, 1024, 128), (203 * 33, 512, 128), (77, 64, 16),
                                   (300, 96, 48)])
def test_bf16_product_matches_reference_on_card(M, N, K):
    """The bf16-operand product against its plain version (fp32 sums of the
    same exact products: within a few fp32 ulps of the sum's scale) and
    float64 (2^-16 of max |ref|), ragged M and N, K not a multiple of its
    32-deep k-tiles."""
    _needs_card()
    g = torch.Generator().manual_seed(M + N + K)
    a = torch.randn(M, K, generator=g).bfloat16().cuda()
    w = (torch.randn(K, N, generator=g) * K ** -0.5).bfloat16().cuda()
    bias = torch.randn(N, generator=g).cuda()
    out = torch.full((M, N + 8), float("nan"), device="cuda")  # ldc past N: untouched columns
    before = B.product_launch_counts()["products_gemm_bf16"]
    with torch.cuda.device(a.device):
        B._gemm_bf16(B._library_products(), torch.cuda.current_stream().cuda_stream, a, 0, w, M,
                     N, bias, out, 0, N + 8)
    torch.cuda.synchronize()
    assert B.product_launch_counts()["products_gemm_bf16"] == before + 1
    assert torch.isnan(out[:, N:]).all()
    got = out[:, :N]
    plain = B.gemm_bf16_reference(a, w, bias)
    scale = float((a.double().abs() @ w.double().abs() + bias.double().abs()).max())
    assert float((got - plain).abs().max()) <= 64 * 2.0 ** -24 * scale
    ref = a.double() @ w.double() + bias.double()
    assert float((got.double() - ref).abs().max()) <= 2.0 ** -16 * float(ref.abs().max())
