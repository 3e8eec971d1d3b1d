"""The product kernel's arithmetic (csrc/products.cu, 3xTF32 on the tensor
cores) as a plain emulation on the CPU, and the fused pair's backward run
with it against the JAX block.

The kernel splits each fp32 operand x into big = tf32(x) and small =
tf32(x - big), TF32 rounding to nearest with ties away from zero
(``cvt.rna.tf32.f32``), and accumulates small @ big + big @ small + big @ big
in fp32. ``bilstm2.tf32_round`` does the rounding on the bits, and
``bilstm2.gemm_reference(..., tf32x3=True)`` the whole contract (both A
layouts, two parts, bias, split-k partials summed in order).

Error bound, against the float64 product of the same fp32 inputs: the split
leaves |x - big - small| <= 2^-22 |x| and |small| <= 2^-11 |x|, so the dropped
terms (small @ small and the two roundings of small) are below
3.01 * 2^-22 * (|A| @ |B|) elementwise; summing in float64 adds nothing
measurable, summing in fp32 (as the kernel and the emulation do) at most
(K + 3) 2^-24 (|A| @ |B|) more. One TF32 product alone misses the first bound
more than 32 times over. The card's kernel is held against the same emulation and
against torch.matmul in fp32 by the ``cuda`` tests (run there with
``python -m pytest --noconftest -m cuda tests/test_torch_port_products.py``)
and by chip_smoke.py."""

import functools
import math

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch.ops import bilstm2 as B

SPLIT_BOUND = 3.01 * 2.0 ** -22


def test_tf32_round_on_the_bits():
    one = 1.0
    cases = {
        one: one,
        one + 2 ** -11: one + 2 ** -10,          # a tie: away from zero
        -(one + 2 ** -11): -(one + 2 ** -10),
        one + 2 ** -11 - 2 ** -23: one,          # just below the tie
        one + 3 * 2 ** -12: one + 2 ** -10,
        2.0 - 2 ** -23: 2.0,                     # the carry reaches the exponent
        0.0: 0.0,
    }
    x = torch.tensor(list(cases), dtype=torch.float32)
    got = B.tf32_round(x)
    assert got.tolist() == list(cases.values())
    bits = got.view(torch.int32)
    assert torch.all(bits & 0x1FFF == 0)  # 10 explicit mantissa bits left


def test_tf32_split_leaves_22_bits(rng):
    x = torch.from_numpy(rng.standard_normal(10_000).astype(np.float32) * 1e3)
    big, small = B.tf32_split(x)
    assert torch.all(B.tf32_round(big) == big) and torch.all(B.tf32_round(small) == small)
    rest = x.double() - big.double() - small.double()
    assert float((rest.abs() / x.double().abs()).max()) <= 2.0 ** -22
    assert float((small.double().abs() / x.double().abs()).max()) <= 2.0 ** -11


def _operands(rng, M, N, ks, a_col):
    """Parts (A, B) with A [M, K_p] handed over as the kernel sees it: the
    transpose of a [K_p, M] array in column layout."""
    parts = []
    for k in ks:
        a = rng.standard_normal((k, M) if a_col else (M, k)).astype(np.float32)
        b = rng.standard_normal((k, N)).astype(np.float32)
        a = torch.from_numpy(a)
        parts.append((a.T if a_col else a, torch.from_numpy(b)))
    return parts


@pytest.mark.parametrize("a_col,two_parts,bias,kps", [
    (False, False, True, None), (False, True, False, None), (True, False, False, 48),
    (True, True, False, 32), (False, True, True, None), (False, False, False, 64)])
def test_tf32x3_emulation_within_its_bound(rng, a_col, two_parts, bias, kps):
    M, N = 37, 20
    ks = (144, 128) if two_parts else (144,)
    parts = _operands(rng, M, N, ks, a_col)
    bvec = torch.from_numpy(rng.standard_normal(N).astype(np.float32)) if bias else None
    a = torch.cat([p[0] for p in parts], 1).double()
    b = torch.cat([p[1] for p in parts], 0).double()
    exact = a @ b + (0 if bvec is None else bvec.double())
    scale = a.abs() @ b.abs() + (0 if bvec is None else bvec.double().abs())
    K = a.shape[1]
    got = B.gemm_reference(parts, bias=bvec, kps=kps, tf32x3=True)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    err = (got.double() - exact).abs()
    assert torch.all(err <= (SPLIT_BOUND + (K + 3) * 2.0 ** -24) * scale)
    # the split's own error, summed in float64, and one TF32 product for contrast
    split_only = B.tf32x3_matmul(a.float(), b.float(), torch.float64).double()
    assert torch.all((split_only - a @ b).abs() <= SPLIT_BOUND * (a.abs() @ b.abs()))
    one_pass = B.tf32_round(a.float()).double() @ B.tf32_round(b.float()).double()
    assert float(((one_pass - a @ b).abs() / (a.abs() @ b.abs())).max()) > 32 * SPLIT_BOUND
    # the plain fp32 version of the same contract
    plain = B.gemm_reference(parts, bias=bvec, kps=kps)
    assert torch.all((plain.double() - exact).abs() <= (K + 3) * 2.0 ** -24 * scale)


def _snr_db(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return 10 * math.log10(np.sum(want ** 2) / max(np.sum((got - want) ** 2), 1e-300))


def _block_state_dict(tree):
    """A JAX DPRNNBlock's params (or their gradients) under the port's names."""
    from tss_dprnn_tpu_torch.utils import weights

    out = {}
    for part in ("intra", "inter"):
        weights._rnn_entries(out, f"{part}_rnn.rnn", tree[f"{part}_rnn"])
        weights._dense_entries(out, f"{part}_linear", tree[f"{part}_linear"])
        weights._norm_entries(out, f"{part}_norm", tree[f"{part}_norm"], "ln")
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


@pytest.mark.parametrize("masked", [False, True])
def test_block_grad_with_tf32x3_products_matches_jax(rng, monkeypatch, masked):
    """A DPRNN block whose fused pair's backward computes dx, dW_ih and dW_hh
    with the product kernel's 3xTF32 arithmetic, against jax.grad of the JAX
    block (its Pallas lane in interpret mode): every gradient >= 60 dB and
    within 1e-4 of its max |ref|, as the fp32 products are."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from tss_dprnn_tpu.models.dprnn import DPRNNBlock as JaxBlock
    from tss_dprnn_tpu.ops import rnn as jax_rnn
    from tss_dprnn_tpu_torch.models.dprnn import DPRNNBlock

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    reference = B.bilstm2_backward_reference
    emulated = []

    def with_tf32x3(*args, **kw):
        emulated.append(1)
        return reference(*args, **kw, matmul=B.tf32x3_matmul)

    monkeypatch.setattr(B, "bilstm2_backward_reference", with_tf32x3)
    Bt, S, K, N, H = 2, 7, 5, 16, 16
    x = rng.standard_normal((Bt, S, K, N)).astype(np.float32)
    cot = rng.standard_normal((Bt, S, K, N)).astype(np.float32)
    chunk_lengths = np.array([7, 3], np.int32) if masked else None
    jblock = JaxBlock(N, H, norm_type="ln")
    params = jblock.init(jax.random.PRNGKey(0), x, chunk_lengths)["params"]

    def jax_loss(params, x):
        with jax_rnn.lstm_backend("pallas"):
            return jnp.sum(jblock.apply({"params": params}, x, chunk_lengths) * cot)

    want_loss, (want_params, want_dx) = jax.value_and_grad(jax_loss, argnums=(0, 1))(params, x)
    block = DPRNNBlock(N, H, "ln")
    block.load_state_dict(_block_state_dict(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    lens = None if chunk_lengths is None else torch.from_numpy(chunk_lengths)
    loss = (block(xt, lens) * torch.from_numpy(cot)).sum()
    loss.backward()
    assert len(emulated) == 2  # the intra and the inter scan
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = dict(_block_state_dict(want_params), x=torch.from_numpy(np.array(want_dx)))
    got = dict(((k, p.grad) for k, p in block.named_parameters()), x=xt.grad)
    assert set(got) == set(want)
    for k, w in want.items():
        assert _snr_db(got[k], w) >= 60.0, k
        torch.testing.assert_close(got[k], w, atol=1e-4 * float(w.abs().max()), rtol=0, msg=k)


# ---------------------------------------------------------------- on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("a_col", [False, True])
def test_product_kernel_tracks_its_emulation_on_card(a_col):
    """The kernel against the 3xTF32 emulation and against torch.matmul in
    fp32 (TF32 off): within the emulation's bound of the float64 product,
    and within 1e-4 of max |ref| of torch.matmul, at a split-k shape."""
    _needs_card()
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(5)
    M, N, K = (1004 if a_col else 1003), 196, 1040
    (a, b), = _operands(rng, M, N, (K,), a_col)
    lib = B._library_products()
    stream = torch.cuda.current_stream().cuda_stream
    ac, bc = a.cuda(), b.cuda()
    arr = ac.T.contiguous() if a_col else ac.contiguous()  # the layout the kernel reads
    got = B._gemm(lib, stream, a_col, [(arr, 0, M if a_col else K, bc, 0, N, K)], M, N)
    torch.cuda.synchronize()
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    err = (got.double().cpu() - exact).abs()
    assert torch.all(err <= (SPLIT_BOUND + (K + 3) * 2.0 ** -24) * scale)
    want = (ac @ bc).double().cpu()
    assert float((got.double().cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())
