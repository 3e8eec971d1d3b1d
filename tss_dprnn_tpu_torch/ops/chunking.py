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
    """[B, S, K, N] -> [B, L, N]; adjoint of :func:`segment_cl`."""
    B, S, K, N = x.shape
    cols = x.permute(0, 3, 2, 1).reshape(B, N * K, S)
    out = F.fold(cols, output_size=(1, L + 2 * K), kernel_size=(1, K),
                 stride=(1, hop_length))  # [B, N, 1, L + 2K]
    return out[:, :, 0, K : K + L].transpose(1, 2)
