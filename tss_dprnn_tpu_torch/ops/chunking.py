"""Chunk segmentation and overlap-add, channels-last
(counterpart of ``tss_dprnn_tpu/ops/chunking.py:22-163``).

The feature sequence [B, L, N] is zero-padded by a full chunk K on both
sides and cut into S overlapping chunks of length K with hop ``hop``;
overlap-add is the exact adjoint: overlaps are summed, not normalised.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def num_chunks(L: int, chunk_length: int, hop_length: int) -> int:
    """S for an input of length L: floor((L + 2K - K) / hop) + 1."""
    return (L + chunk_length) // hop_length + 1


def segment_cl(x: torch.Tensor, chunk_length: int, hop_length: int) -> torch.Tensor:
    """[B, L, N] -> [B, S, K, N] overlapping chunks."""
    K = chunk_length
    padded = F.pad(x, (0, 0, K, K))  # [B, L + 2K, N]
    # unfold gives exactly num_chunks(L, K, hop) windows: (L+2K-K)//hop + 1
    return padded.unfold(1, K, hop_length).permute(0, 1, 3, 2)


def overlap_add_cl(x: torch.Tensor, L: int, hop_length: int) -> torch.Tensor:
    """[B, S, K, N] -> [B, L, N]; adjoint of :func:`segment_cl`. Overlaps are
    summed in x's type: a bf16 x adds in bf16, in the JAX function's order
    (``tss_dprnn_tpu/ops/chunking.py:140-163``: with K a multiple of the hop,
    r = K / hop strips of every r-th chunk, added strip by strip; otherwise
    chunk by chunk)."""
    if x.dtype == torch.bfloat16:
        return _overlap_add_in_type(x, L, hop_length)
    B, S, K, N = x.shape
    cols = x.permute(0, 3, 2, 1).reshape(B, N * K, S)
    out = F.fold(cols, output_size=(1, L + 2 * K), kernel_size=(1, K),
                 stride=(1, hop_length))  # [B, N, 1, L + 2K]
    return out[:, :, 0, K : K + L].transpose(1, 2)


def _overlap_add_in_type(x: torch.Tensor, L: int, hop: int) -> torch.Tensor:
    B, S, K, N = x.shape
    Lp = L + 2 * K
    if K % hop:
        total = x.new_zeros(B, Lp + K, N)
        for s in range(S):
            total[:, s * hop:s * hop + K] += x[:, s]
        return total[:, K:K + L]
    r = K // hop
    total = None
    for j in range(r):
        n_j = (S - j + r - 1) // r
        if n_j <= 0:
            continue
        strip = x[:, j::r].reshape(B, n_j * K, N)
        start = j * hop
        strip = F.pad(strip, (0, 0, start, max(Lp - (start + n_j * K), 0)))[:, :Lp]
        total = strip if total is None else total + strip
    return total[:, K:K + L]
