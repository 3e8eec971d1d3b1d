"""The port's fused bidirectional LSTM (tss_dprnn_tpu_torch.ops.bilstm2)
against the JAX package's Pallas entries, run in interpret mode on the CPU.

On a CPU tensor the port's entries run their plain PyTorch version, so this
holds that version's contract (both directions in forward time, the masked
direction-1 hold, h rounded to the stream type) against the TPU kernel's.
Tolerance: 1e-5 absolute, fp32 rounding (the two sides sum the gate
products in different orders). The CUDA kernel itself is compared with the
plain version on the card (the ``cuda`` test below and chip_smoke.py)."""

import functools

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch.ops import _build
from tss_dprnn_tpu_torch.ops.bilstm2 import (
    bilstm2_forward,
    bilstm2_forward_masked,
    bilstm2_reference,
    launch_count,
)

ATOL = 1e-5
# the bf16 kernel against the bf16 plain version on the card: they sum a
# gate in different orders, so a rounded h may differ by a bf16 ulp (2^-8 for
# |h| in [0.5, 1)) and max |err| alone cannot tell a kernel that skips the
# rounding of h (also 1 ulp off, but about 59 dB SNR on an H100 at this test's
# shape, against about 80 dB for the kernel)
BF16_ATOL = 2.0 ** -7
BF16_SNR_DB = 70.0


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
    return [torch.from_numpy(a) for a in arrays]


# T not divisible by the TPU kernel's unroll (5); R not a multiple of 8
@pytest.mark.parametrize("R,T", [(3, 12), (11, 7), (5, 1)])
def test_bilstm2_forward_matches_pallas(rng, interpret, R, T):
    from tss_dprnn_tpu.ops import pallas_lstm

    F, H = 16, 16
    x = rng.standard_normal((R, T, F)).astype(np.float32)
    w = _weights(rng, F, H)
    want0, want1 = (np.asarray(o) for o in pallas_lstm.bilstm2_forward(x, *w))
    before = launch_count()
    got0, got1 = bilstm2_forward(*_torch(x, *w))
    assert launch_count() == before  # a CPU tensor runs the plain version
    np.testing.assert_allclose(got0.numpy(), want0, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got1.numpy(), want1, atol=ATOL, rtol=0)


@pytest.mark.parametrize("R,T,lens", [
    (5, 13, [13, 1, 7, 12, 4]),          # len = T and len = 1
    (9, 6, [6, 6, 5, 4, 3, 2, 1, 6, 2]),  # R not a multiple of 8
])
def test_bilstm2_forward_masked_matches_pallas(rng, interpret, R, T, lens):
    from tss_dprnn_tpu.ops import pallas_lstm

    F, H = 16, 16
    lens = np.asarray(lens, np.int32)
    x = rng.standard_normal((R, T, F)).astype(np.float32)
    w = _weights(rng, F, H)
    want0, want1 = (np.asarray(o) for o in pallas_lstm.bilstm2_forward_masked(x, lens, *w))
    got0, got1 = (o.numpy() for o in bilstm2_forward_masked(*_torch(x, lens, *w)))
    np.testing.assert_allclose(got1, want1, atol=ATOL, rtol=0)  # everywhere
    assert np.all(got1[np.arange(T)[None, :] >= lens[:, None]] == 0)
    for r, n in enumerate(lens):  # out0 past the length is unspecified
        np.testing.assert_allclose(got0[r, :n], want0[r, :n], atol=ATOL, rtol=0)


def test_bilstm2_masked_full_length_equals_unmasked(rng):
    R, T, F, H = 4, 9, 16, 16
    x = torch.from_numpy(rng.standard_normal((R, T, F)).astype(np.float32))
    w = _torch(*_weights(rng, F, H))
    full = torch.full((R,), T, dtype=torch.int32)
    for a, b in zip(bilstm2_forward(x, *w), bilstm2_forward_masked(x, full, *w)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_bilstm2_reference_bf16_rounds_h(rng):
    """bf16 streams: outputs are bf16 and close to the fp32 run (h is
    rounded to bf16 before it feeds the next step)."""
    R, T, F, H = 6, 10, 16, 16
    x = torch.from_numpy(rng.standard_normal((R, T, F)).astype(np.float32))
    w = _torch(*_weights(rng, F, H))
    lo = bilstm2_reference(x.bfloat16(), *w)
    hi = bilstm2_reference(x.bfloat16().float(), *w)
    for a, b in zip(lo, hi):
        assert a.dtype == torch.bfloat16
        err = (a.float() - b).pow(2).sum() / b.pow(2).sum()
        assert 10 * torch.log10(err) < -30  # >= 30 dB at this tiny size


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_ROOTS", ())
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("bilstm2_serve", build_dir=tmp_path)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_bilstm2_kernel_matches_reference_on_card(masked, dtype):
    """On the card (the machine there has no JAX: run with
    ``python -m pytest --noconftest -m cuda tests/test_torch_port_bilstm2.py``).
    fp32: 1e-4 absolute. bf16 streams: BF16_ATOL and BF16_SNR_DB against
    the bf16 plain version, which rounds h to bf16 before every next step
    as the kernel must."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    atol = 1e-4 if dtype == torch.float32 else BF16_ATOL
    rng = np.random.default_rng(0)
    R, T, F, H = 70, 33, 128, 128
    x = torch.from_numpy(rng.standard_normal((R, T, F)).astype(np.float32)).cuda().to(dtype)
    w = [t.cuda() for t in _torch(*_weights(rng, F, H))]
    w = [w[0] * 0.3, w[1], w[2] * 0.3]
    lens = torch.from_numpy(rng.integers(1, T + 1, R).astype(np.int32)).cuda()
    if masked:
        got = bilstm2_forward_masked(x, lens, *w)
        want = bilstm2_reference(x, *w, lens)
        valid = torch.arange(T, device="cuda")[None, :] < lens[:, None]
        got, want = ([o[0][valid], o[1]] for o in (got, want))
    else:
        got = bilstm2_forward(x, *w)
        want = bilstm2_reference(x, *w)
    assert all(o.dtype == dtype for o in got)
    got, want = (torch.cat([o.float().flatten() for o in out]) for out in (got, want))
    torch.testing.assert_close(got, want, atol=atol, rtol=0)
    if dtype == torch.bfloat16:
        snr = 10 * torch.log10(want.pow(2).sum() / (got - want).pow(2).sum().clamp_min(1e-30))
        assert snr >= BF16_SNR_DB


@pytest.mark.cuda
def test_bilstm2_kernel_rejects_misaligned_input():
    """The kernel copies and stores 16 bytes at a time: a view that does not
    start on a 16-byte boundary is refused before the launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    R, T, F, H = 3, 5, 16, 16
    x = torch.zeros(R * T * F + 1, device="cuda")[1:].view(R, T, F)
    w = [t.cuda() for t in _torch(*_weights(np.random.default_rng(0), F, H))]
    before = launch_count()
    with pytest.raises(ValueError, match="16-byte aligned"):
        bilstm2_forward(x, *w)
    assert launch_count() == before
