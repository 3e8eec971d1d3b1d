"""The bf16 serving route: ``bilstm2_forward`` / ``bilstm2_forward_masked``
and ``lstm_forward`` on a CUDA bf16 tensor run the input product of
csrc/products.cu (x upcast, exactly, into an fp32 buffer) and then the bf16
mode of the serving cluster scan (csrc/bilstm2_serve.cu, h @ W_hh in one
bf16 mma.sync per gate and k-step), as the fp32 streams do in 3xTF32.

On the CPU: the scan's bf16 weight layout (``serve_weight_layout_bf16``)
maps back to W_hh, and the fragments its lanes read give h @ W_hh in an
emulation of ldmatrix and mma.m16n8k16 (float64, exact on bf16 values); the
route on a stand-in card (``torch.Tensor.is_cuda`` patched true, the
libraries replaced by recorders) reaches the product and the serving scan
with the stream type's code and layout (the cell-state mode the scan's mode
4 after the bf16-operand product), and fp16 raises before any launch.

On the card (``cuda`` tests, run there with ``python -m pytest --noconftest
-m cuda tests/test_torch_port_bf16_serve.py``) the route is held against the
bf16 plain version (``bilstm2_reference`` / ``lstm_reference`` on bf16
inputs) at chip_smoke.py's shapes and at widths that are no multiple of 16:
max |err| within BF16_ATOL and SNR at least BF16_SNR_DB (a rounded h may
differ by a bf16 ulp where the two sum a gate in another order), direction
1 exactly 0 past each row's length, bit for bit on a second call."""

import contextlib
import itertools
import types

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch.ops import bilstm2 as B
from tss_dprnn_tpu_torch.ops import lstm as L

BF16_ATOL = 2.0 ** -7
BF16_SNR_DB = 70.0


def _bf16_values(rng, shape, scale=1.0):
    """float64 holding bf16 values (products of two are exact in float64)."""
    return torch.from_numpy(scale * rng.standard_normal(shape)).bfloat16().double()


@pytest.mark.parametrize("D,H", [(2, 16), (1, 48), (2, 128)])
def test_serve_weight_layout_bf16_maps_back(D, H):
    """Element (d, c, ks, w, j, lg, lt, gate, e) of the bf16 serving layout is
    W_hh[d][16 ks + 8 j + 2 lt + e][gate H + c H/2 + 8 w + lg]: every element
    of w_hh once, in bf16."""
    w = torch.arange(D * H * 4 * H, dtype=torch.float32).reshape(D, H, 4 * H)
    w = w % 251  # integers below 256 are bf16 values
    got = B.serve_weight_layout_bf16(w)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert got.shape == (D, 2, H // 16, H // 16, 2, 8, 4, 4, 2)
    idx = torch.tensor(list(itertools.product(
        range(D), range(2), range(H // 16), range(H // 16), range(2), range(8), range(4),
        range(4), range(2))))
    d, c, ks, wp, j, lg, lt, g, e = idx.T
    k, col = 16 * ks + 8 * j + 2 * lt + e, g * H + c * (H // 2) + 8 * wp + lg
    assert torch.equal(got.flatten().float(), w[d, k, col])
    flat = (d * H + k) * 4 * H + col  # every element of w_hh exactly once
    assert torch.equal(torch.sort(flat).values, torch.arange(D * H * 4 * H))


@pytest.mark.parametrize("H,MT", [(16, 1), (32, 2), (48, 1)])
def test_serve_fragments_bf16_give_h_at_w(H, MT):
    """The bf16 scan's product as its lanes compute it. Lane L = 4 lg + lt of
    a warp of unit group w: ldmatrix.x4 from the h tile, lane L giving the
    address of row 16 mt + (L % 16) at k 16 ks + 8 (L // 16), returns in
    register q row lg of 8 x 8 matrix q (those of lanes 8 q .. 8 q + 7), k 2
    lt and 2 lt + 1; its B registers j are wfrag[d, c, ks, w, j, lg, lt, gate,
    0..1] (k 16 ks + 8 j + 2 lt + e, column lg). mma.m16n8k16 reads A
    register q as rows lg + 8 (q & 1), k 2 lt + 8 (q >> 1) + e and gives C[lg
    + 8 (q >> 1)][2 lt + (q & 1)], which the cell update reads as gate
    `gate` of row 16 mt + lg + 8 hh and unit c H/2 + 8 w + 2 lt + j.
    Together: h @ W_hh[d] for every (row, unit, gate) of both CTAs, each
    exactly once."""
    rng = np.random.default_rng(0)
    M, Hh = 16 * MT, H // 2
    w_hh2 = _bf16_values(rng, (2, H, 4 * H))
    h = _bf16_values(rng, (M, H))
    frag = B.serve_weight_layout_bf16(w_hh2.float()).double()
    lane = torch.arange(32)
    lg, lt = lane // 4, lane % 4
    for d, c in itertools.product(range(2), range(2)):
        got = torch.full((M, 4, Hh), float("nan"), dtype=torch.float64)
        for wp, mt, g in itertools.product(range(H // 16), range(MT), range(4)):
            acc = torch.zeros(32, 4, dtype=torch.float64)  # [lane][q]
            for ks in range(H // 16):
                # ldmatrix: the row each lane addresses, then register q of each lane
                src_row = 16 * mt + lane % 16
                src_k = 16 * ks + 8 * (lane // 16)
                regs = torch.empty(32, 4, 2, dtype=torch.float64)  # [lane][q][e]
                for q in range(4):
                    addr = 8 * q + lg  # the lane whose address gives this lane's row
                    for e in range(2):
                        regs[:, q, e] = h[src_row[addr], src_k[addr] + 2 * lt + e]
                A = torch.full((16, 16), float("nan"), dtype=torch.float64)
                for q, e in itertools.product(range(4), range(2)):
                    A[lg + 8 * (q & 1), 2 * lt + 8 * (q >> 1) + e] = regs[:, q, e]
                Bm = torch.full((16, 8), float("nan"), dtype=torch.float64)
                for j, e in itertools.product(range(2), range(2)):
                    Bm[2 * lt + 8 * j + e, lg] = frag[d, c, ks, wp, j, lg, lt, g, e]
                assert not (torch.isnan(A).any() or torch.isnan(Bm).any())
                C = A @ Bm
                acc += torch.stack([C[lg + 8 * (q >> 1), 2 * lt + (q & 1)] for q in range(4)], 1)
            for hh, j in itertools.product(range(2), range(2)):
                got[16 * mt + lg + 8 * hh, g, 8 * wp + 2 * lt + j] = acc[:, 2 * hh + j]
        want = (h @ w_hh2[d]).view(M, 4, 2, Hh)[:, :, c]
        assert not torch.isnan(got).any()
        assert torch.equal(got, want)  # exact: bf16 products and few terms in float64


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
    neither ops module loads a library of its own besides the product and
    scan kernels' (csrc/bilstm2.cu, the dense mode's first design, and
    csrc/lstm.cu, the cell-state mode's, are gone). The card runs 132
    clusters of 16-row bf16 tiles at once and 66 of everything else."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    libs = {name: _Recorder() for name in ("products", "serve")}
    for mod in (B, L):
        monkeypatch.setattr(mod, "_library_products", lambda: libs["products"])
        monkeypatch.setattr(mod, "_library_serve", lambda: libs["serve"])
        assert not hasattr(mod, "_library")

    def max_clusters(which, H, device, height, dtype):
        return 132 if (which, height, dtype) == ("serve", 16, torch.bfloat16) else 66

    monkeypatch.setattr(B, "_max_clusters", max_clusters)
    layouts = []
    for name in ("serve_weight_layout", "serve_weight_layout_bf16"):
        real = getattr(B, name)

        def record(w, real=real, name=name):
            out = real(w)
            layouts.append((name, out))
            return out
        monkeypatch.setattr(B, name, record)
        monkeypatch.setattr(L, name, record)
    return libs, layouts


def _weights(D, F, H):
    g = torch.Generator().manual_seed(D * F + H)
    return [torch.randn(*s, generator=g) * 0.1 for s in ((D, F, 4 * H), (D, 4 * H), (D, H, 4 * H))]


@pytest.mark.parametrize("dtype,masked", [(torch.bfloat16, False), (torch.bfloat16, True),
                                          (torch.float32, False)])
def test_pair_streams_reach_product_and_serving_scan(stand_in_card, dtype, masked):
    libs, layouts = stand_in_card
    R, T, F, H = 40, 6, 16, 32
    x = torch.randn(R, T, F).to(dtype)
    lens = torch.randint(0, T + 1, (R,)).int() if masked else None
    entry = B.bilstm2_forward_masked if masked else B.bilstm2_forward
    before = entry.launches, B.product_launch_counts()["products_gemm"]
    out0, out1 = B._launch_serve(entry, x, *_weights(2, F, H), lens)
    assert out0.dtype == out1.dtype == dtype and out0.shape == (R, T, H)
    assert (entry.launches, B.product_launch_counts()["products_gemm"]) == (
        before[0] + 1, before[1] + 1)
    (gemm, gargs), = libs["products"].calls
    assert gemm == "products_gemm" and gargs[0] == 0 and gargs[-6:-4] == (R * T, 8 * H)
    (scan, args), = libs["serve"].calls
    (layout, frag), = layouts
    low = dtype == torch.bfloat16
    assert layout == ("serve_weight_layout_bf16" if low else "serve_weight_layout")
    assert frag.dtype == dtype
    # (height, dtype code, pre, wfrag, lens, out0, out1, pre_dir, pre_step, out_step, reverse1,
    #  dirs, R, T, H, time_major, stream)
    assert scan == "bilstm2_serve_scan" and args[1] == int(low) and args[3] == frag.data_ptr()
    assert args[0] == 16 and (args[4] is not None) == masked
    assert args[5:7] == (out0.data_ptr(), out1.data_ptr())
    assert args[7:] == (4 * H, 8 * H, H, 1, 2, R, T, H, 0, 7)


@pytest.mark.parametrize("D", [1, 2])
def test_stack_streams_reach_product_and_serving_scan(stand_in_card, D):
    """bf16 lstm_forward: D input products and one serving scan over the D
    stacked directions (none reversed); the want_cs mode: D bf16-operand
    products on x as it is, then one cell-state scan (mode 4) with the bf16
    code and a cs pointer per direction, and no other scan."""
    libs, layouts = stand_in_card
    R, T, F, H = 20, 5, 16, 16
    x = torch.randn(D, R, T, F).bfloat16()
    w = _weights(D, F, H)
    before = L.lstm_forward.launches
    h, streams = L._launch(L.lstm_forward, L._MODE_H, x, *w)
    assert h.dtype == torch.bfloat16 and h.shape == (D, R, T, H) and streams == ()
    assert L.lstm_forward.launches == before + 1
    assert [c[0] for c in libs["products"].calls] == ["products_gemm"] * D
    (scan, args), = libs["serve"].calls
    (layout, frag), = layouts
    assert layout == "serve_weight_layout_bf16" and args[3] == frag.data_ptr()
    assert args[:2] == (16, 1) and args[4] is None
    assert args[7:] == (R * T * 4 * H, 4 * H, H, 0, D, R, T, H, 0, 7)
    libs["products"].calls.clear()
    libs["serve"].calls.clear()
    layouts.clear()
    before = L.lstm_forward_with_cs.launches
    h, (cs,) = L._launch(L.lstm_forward_with_cs, L._MODE_CS, x, *w)
    assert h.dtype == torch.bfloat16 and cs.dtype == torch.float32 and cs.shape == h.shape
    assert L.lstm_forward_with_cs.launches == before + 1
    M, G = R * T, 4 * H
    calls = libs["products"].calls
    assert [c[0] for c in calls] == ["products_gemm_bf16"] * D
    assert [a[0] for _, a in calls] == [x.data_ptr() + 2 * d * M * F for d in range(D)]
    (scan, args), = libs["serve"].calls
    (layout, frag), = layouts
    assert scan == "bilstm2_serve_cs_scan" and layout == "serve_weight_layout_bf16"
    # (height, dtype, pre, wfrag, out0, out1, cs0, cs1, pre_dir, pre_step, dirs, R, T, H)
    assert args[:2] == (16, 1) and args[2] == calls[0][1][6] and args[3] == frag.data_ptr()
    last = D - 1
    assert args[4:8] == (h.data_ptr(), h[last].data_ptr(), cs.data_ptr(), cs[last].data_ptr())
    assert args[8:] == (M * G, G, D, R, T, H, 7)


def test_fp16_raises_before_any_launch(stand_in_card):
    libs, _ = stand_in_card
    w = _weights(2, 16, 16)
    before = B.launch_count(), L.launch_count()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        B._launch_serve(B.bilstm2_forward, torch.zeros(4, 3, 16).half(), *w, None)
    for entry, mode in ((L.lstm_forward, L._MODE_H), (L.lstm_forward_with_cs, L._MODE_CS)):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            L._launch(entry, mode, torch.zeros(2, 4, 3, 16).half(), *w)
    assert (B.launch_count(), L.launch_count()) == before
    assert not any(lib.calls for lib in libs.values())


def test_bf16_tile_plan_reads_each_height():
    """The serving plan takes a count per height: where the card runs twice
    as many 16-row clusters (two bf16 CTAs on an SM), 16-row tiles take the
    grid in fewer waves x height than 32-row ones."""
    counts = {16: 132, 32: 66}
    plan = B.plan_tiles(5136, counts, heights=B.SERVE_HEIGHTS)
    assert (plan.height, plan.tiles) == (16, 321)  # 5 waves x 16 against 5 x 32
    assert B.plan_tiles(5136, {16: 66, 32: 66}, heights=B.SERVE_HEIGHTS).height == 32
    assert B.plan_tiles(2000, counts, dirs=1, heights=B.SERVE_HEIGHTS) == B.TilePlan(16, 125, 1)
    assert B.plan_tiles(100, {16: 0, 32: 66}, heights=B.SERVE_HEIGHTS).height == 32
    with pytest.raises(ValueError, match="no cluster"):
        B.plan_tiles(100, {16: 0, 32: 0}, heights=B.SERVE_HEIGHTS)


# ---------------------------------------------------------------- on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _snr_db(got, want):
    got, want = got.double(), want.double()
    return float(10 * torch.log10(want.pow(2).sum() / (got - want).pow(2).sum().clamp_min(1e-300)))


def _close(got, want):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    assert err <= BF16_ATOL and _snr_db(got, want) >= BF16_SNR_DB, (err, _snr_db(got, want))


def _card_weights(D, F, H, g):
    k = H ** -0.5
    return [((torch.rand(*s, generator=g) * 2 - 1) * k).cuda()
            for s in ((D, F, 4 * H), (D, 4 * H), (D, H, 4 * H))]


def _check_pair(R, T, F, H, masked, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(R, T, F, generator=g).bfloat16().cuda()
    w = _card_weights(2, F, H, g)
    lens = torch.randint(0, T + 1, (R,), generator=g).int().cuda() if masked else None
    if masked:
        lens[:2] = torch.tensor([0, T], dtype=torch.int32)
    entry = B.bilstm2_forward_masked if masked else B.bilstm2_forward
    before = entry.launches, B.product_launch_counts()["products_gemm"]
    run = (lambda: entry(x, lens, *w)) if masked else (lambda: entry(x, *w))
    got, again = run(), run()
    torch.cuda.synchronize()
    assert (entry.launches, B.product_launch_counts()["products_gemm"]) == (
        before[0] + 2, before[1] + 2)
    assert all(o.dtype == torch.bfloat16 for o in got)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no float atomics
    want = B.bilstm2_reference(x, *w, lens)
    if masked:
        valid = torch.arange(T, device="cuda")[None, :] < lens[:, None]
        assert torch.all(got[1][~valid] == 0)
        got, want = ([o[0][valid], o[1]] for o in (got, want))
    _close(torch.cat([o.flatten() for o in got]), torch.cat([o.flatten() for o in want]))


@pytest.mark.cuda
@pytest.mark.parametrize("masked,R,T", [(False, 5136, 250), (True, 2000, 642)])
def test_bf16_serving_route_matches_reference_on_card(masked, R, T):
    """chip_smoke.py's shapes (8 x 10 s: the intra scan unmasked, the inter
    scan masked with ragged lengths)."""
    _needs_card()
    _check_pair(R, T, 128, 128, masked, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("R,T,F,H", [(37, 21, 12, 10), (90, 17, 20, 24), (300, 9, 128, 128)])
def test_bf16_serving_route_small_shapes_on_card(R, T, F, H, masked):
    """Padded widths, and row counts no multiple of any tile height."""
    _needs_card()
    _check_pair(R, T, F, H, masked, seed=2)


@pytest.mark.cuda
@pytest.mark.parametrize("D,R,T,F,H", [(1, 2000, 642, 128, 128), (2, 203, 33, 128, 128),
                                       (1, 37, 9, 12, 10)])
def test_bf16_stacked_route_matches_reference_on_card(D, R, T, F, H):
    """bf16 lstm_forward: BSS serving's causal inter scan, two directions on
    their own inputs, and a padded width."""
    _needs_card()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(D, R, T, F, generator=g).bfloat16().cuda()
    w = _card_weights(D, F, H, g)
    before = L.lstm_forward.launches, B.product_launch_counts()["products_gemm"]
    got, again = L.lstm_forward(x, *w), L.lstm_forward(x, *w)
    torch.cuda.synchronize()
    assert (L.lstm_forward.launches, B.product_launch_counts()["products_gemm"]) == (
        before[0] + 2, before[1] + 2 * D)
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    _close(got, L.lstm_reference(x, *w))
