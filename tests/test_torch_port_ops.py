"""Op parity: the port's plain PyTorch ops against the JAX package's on the
same numpy inputs. Tolerance: 1e-5 absolute (fp32 rounding; the two sides
reduce in different orders). Index-valued results must match exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tss_dprnn_tpu.ops import chunking as jchunking
from tss_dprnn_tpu.ops import conv as jconv
from tss_dprnn_tpu.ops import fusion as jfusion
from tss_dprnn_tpu.ops import losses as jlosses
from tss_dprnn_tpu.ops import masking as jmasking
from tss_dprnn_tpu.ops import norms as jnorms
from tss_dprnn_tpu_torch.ops import chunking, conv, fusion, losses, masking, norms

ATOL = 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("L,K,hop", [(37, 8, 4), (64, 10, 5), (5, 6, 3), (23, 9, 4)])
def test_chunking_matches_jax(rng, L, K, hop):
    x = rng.standard_normal((2, L, 3)).astype(np.float32)
    seg = chunking.segment_cl(torch.from_numpy(x), K, hop)
    want = jchunking.segment_cl(x, K, hop)
    assert seg.shape[1] == chunking.num_chunks(L, K, hop) == jchunking.num_chunks(L, K, hop)
    _close(seg, want, atol=0)
    y = rng.standard_normal(seg.shape).astype(np.float32)
    _close(chunking.overlap_add_cl(torch.from_numpy(y), L, hop),
           jchunking.overlap_add_cl(y, L, hop))


@pytest.mark.parametrize("eps", [jnorms.GLOBLN_EPS, jnorms.GROUPNORM_EPS])
@pytest.mark.parametrize("masked", [False, True])
def test_global_channel_norm_matches_jax(rng, eps, masked):
    x = (rng.standard_normal((3, 7, 5, 6)) * 2 + 0.5).astype(np.float32)
    gamma = rng.standard_normal(6).astype(np.float32)
    beta = rng.standard_normal(6).astype(np.float32)
    mask = None
    if masked:
        mask = (np.arange(7)[None, :] < np.array([7, 4, 1])[:, None]).astype(np.float32)
        mask = mask[:, :, None, None]
    got = norms.global_channel_norm_cl(
        *(torch.from_numpy(a) for a in (x, gamma, beta)), eps,
        None if mask is None else torch.from_numpy(mask))
    _close(got, jnorms.global_channel_norm_cl(x, gamma, beta, eps=eps, mask=mask))


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_matches_jax(rng, stride):
    x = rng.standard_normal((2, 1, 40)).astype(np.float32)
    w = rng.standard_normal((8, 1, 2)).astype(np.float32)
    _close(conv.conv1d(torch.from_numpy(x), torch.from_numpy(w), stride=stride),
           jconv.conv1d(x, w, stride=stride))
    f = rng.standard_normal((2, 8, 21)).astype(np.float32)
    wt = rng.standard_normal((8, 1, 2)).astype(np.float32)
    _close(conv.conv_transpose1d(torch.from_numpy(f), torch.from_numpy(wt), stride=stride),
           jconv.conv_transpose1d(f, wt, stride=stride))


def test_masked_softmax_matches_jax(rng):
    x = (rng.standard_normal((3, 9, 1)) * 4).astype(np.float32)
    mask = (np.arange(9)[None, :, None] < np.array([9, 3, 1])[:, None, None]).astype(np.float32)
    _close(masking.masked_softmax(torch.from_numpy(x), torch.from_numpy(mask), dim=1),
           jmasking.masked_softmax(x, mask, axis=1))
    _close(masking.masked_softmax(torch.from_numpy(x), None, dim=1),
           jmasking.masked_softmax(x, None, axis=1))
    lengths = np.array([4, 0, 6], np.int32)
    _close(masking.length_mask(torch.from_numpy(lengths), 6),
           jmasking.length_mask(lengths, 6), atol=0)


@pytest.mark.parametrize("L,lengths", [(41, [41, 30, 17]), (100, [99, 100, 3]), (64, None)])
def test_attention_fusion_matches_jax(rng, L, lengths):
    N, k = 6, 2
    out = rng.standard_normal((3, L, N)).astype(np.float32)
    aux = rng.standard_normal((3, N)).astype(np.float32)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    got = fusion.attention(torch.from_numpy(aux), torch.from_numpy(out), k,
                           None if lens is None else torch.from_numpy(lens))
    _close(got, jfusion.attention(aux, out, k, lens))


@pytest.mark.parametrize("L,L_in,lengths", [
    (1000, 500, [1000, 999, 637, 3]),
    (333, 111, [333, 301, 7, 100]),
])
def test_nearest_upsample_indices_match_jax(L, L_in, lengths):
    """Values equal to their own index expose the chosen source frame."""
    x = np.broadcast_to(np.arange(L_in, dtype=np.float32)[None, :, None], (4, L_in, 2)).copy()
    out_len = np.asarray(lengths, np.int32)
    in_len = out_len // (L // L_in)
    got = fusion.nearest_upsample_to(torch.from_numpy(x), L, torch.from_numpy(in_len),
                                     torch.from_numpy(out_len))
    _close(got, jfusion.nearest_upsample_to(jnp.asarray(x), L, in_len, out_len), atol=0)
    _close(fusion.nearest_upsample_to(torch.from_numpy(x), L),
           jfusion.nearest_upsample_to(jnp.asarray(x), L), atol=0)


@pytest.mark.parametrize("lengths", [None, [300, 171, 1]])
def test_si_sdr_matches_jax(rng, lengths):
    target = rng.standard_normal((3, 300)).astype(np.float32)
    est = (target + 0.3 * rng.standard_normal((3, 300))).astype(np.float32)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    got = losses.masked_si_sdr(torch.from_numpy(est), torch.from_numpy(target),
                               None if lens is None else torch.from_numpy(lens))
    _close(got, jlosses.masked_si_sdr(est, target, lens))
