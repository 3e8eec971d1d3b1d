"""Operations and bytes of the DPRNN family (DPRNN-TasNet, DPRNN-Spe-TasNet),
counted from the configuration's widths and each request's true lengths.

Every product and convolution counts 2 operations a multiply-add, whatever
runs it; element-wise work (activations, norms, masks) is not counted. A
training step counts its forward 3 times (the backward is twice the
forward). One LSTM row-step of one direction with the Dense that follows it
costs 2 (F + H) 4H (gates) + 2 H N (its half of the Dense): 262,144 + 32,768
at F = H = N = 128.

The LSTM calls' bytes count each input and output once, in float32: x and
the output of the Dense over the row-steps, every weight once a call; a
backward reads x, the output's gradient and the weights and writes the input's
gradient and the weights' gradients. Nothing a kernel keeps for its backward
counts, so the count is the same whatever implements the scan.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

FLOAT_BYTES = 4


def frames(model: dict, samples: int) -> int:
    """Encoder frames of a signal of ``samples`` samples."""
    k = model["kernel_size"]
    return (samples - k) // max(k // 2, 1) + 1


def chunks(model: dict, samples: int) -> int:
    """Chunks S of the segmented features of a mixture."""
    return (frames(model, samples) + model["chunk_length"]) // model["hop_length"] + 1


def lstm_rowstep_flops(model: dict) -> int:
    """One direction, one row-step, with its half of the following Dense."""
    F, H = model["feature_size"], model["hidden_size"]
    return 2 * (F + H) * 4 * H + 2 * H * F


def speaker_flops(model: dict, ref_samples: int) -> int:
    N, O, P, E = model["input_size"], model["O"], model["P"], model["embeddings_size"]
    k = model["kernel_size"]
    la = frames(model, ref_samples)
    total = 2 * la * N * k + 2 * la * N * O          # encoder on the reference, conv in
    total += 2 * la * O * O * 2                        # ResBlock(O, O)
    l1 = la // 3
    total += 2 * l1 * (O * P + P * P + O * P)          # ResBlock(O, P) with its downsample
    l2 = l1 // 3
    total += 2 * l2 * P * P * 2                        # ResBlock(P, P)
    total += 2 * (l2 // 3) * P * E                     # conv out
    total += 2 * E * N + 2 * E * model["num_spks"]     # fusion projection, speaker logits
    return total


def forward_flops(model: dict, mix_samples: int, ref_samples: int = 0) -> int:
    """One request's forward."""
    N, F = model["input_size"], model["feature_size"]
    k, K = model["kernel_size"], model["chunk_length"]
    L = frames(model, mix_samples)
    S = chunks(model, mix_samples)
    sources = 2
    total = 2 * L * N * k                              # encoder
    total += 2 * L * N * F                             # bottleneck
    total += 2 * 2 * S * K * model["n_repeats"] * lstm_rowstep_flops(model)  # 2 scans x 2 dirs
    total += 2 * S * K * F * 2 * F                     # mask conv to two sources
    total += 2 * (sources * L) * F * (2 * F + N)       # out, gate, end conv
    decoded = 1 if "fusion_type" in model else sources
    total += 2 * decoded * L * N * k                   # decoder
    if "fusion_type" in model:
        total += speaker_flops(model, ref_samples) + 2 * (L // k) * N
    return total


def step_flops(model: dict, mix_samples: Iterable[int], ref_samples: Iterable[int]) -> int:
    """A training step over a batch: forward and backward."""
    return 3 * sum(forward_flops(model, m, r) for m, r in zip(mix_samples, ref_samples))


def lstm_calls(model: dict, mix_samples: Iterable[int], train: bool
               ) -> List[Tuple[int, int]]:
    """(operations, bytes) of every LSTM call one batch of these mixtures
    makes: per block its intra and inter scan over the whole batch, and in
    training each one's backward."""
    F, H, N = model["feature_size"], model["hidden_size"], model["feature_size"]
    K = model["chunk_length"]
    rowsteps = sum(chunks(model, m) * K for m in mix_samples)  # the same for both scans
    dirs = 2
    weights = dirs * (F * 4 * H + H * 4 * H + 4 * H + H * N)
    fwd = (dirs * rowsteps * lstm_rowstep_flops(model),
           FLOAT_BYTES * (rowsteps * (F + N) + weights))
    bwd = (2 * fwd[0], FLOAT_BYTES * (rowsteps * (F + N + F) + 2 * weights))
    per_block = [fwd, fwd] + ([bwd, bwd] if train else [])
    return per_block * model["n_repeats"]


def lstm_bound_s(model: dict, mix_samples: Iterable[int], train: bool, peak_flops: float,
                 peak_bytes: float) -> float:
    """The least time the LSTM calls of one batch could take on the card:
    per call the larger of operations over the peak and bytes over the
    bandwidth, summed."""
    return sum(max(f / peak_flops, b / peak_bytes)
               for f, b in lstm_calls(model, list(mix_samples), train))
