"""DPRNN-Spe-IRA-TasNet: two-pass iterative refined adaptation
(counterpart of ``tss_dprnn_tpu/models/dprnn_spe_ira.py:31-134``).

Pass 1 embeds the reference (v0) and separates; the pass-1 target estimate
d0, in encoder space, is embedded again by the same speaker encoder (v1),
``aux_linear`` merges [v0, v1], and the same fusion, bottleneck and dual-path
core run again. Every heavy module is one instance called twice, as the
reference reuses its modules; in training each speaker-encoder call moves
BatchNorm's running statistics, in order.

Reference quirks kept:
- pass 2 embeds d0 with the mixture-domain frame counts but divides by the
  reference-length ``aux_T`` (the reference's ``dprnn_spe_ira.py:84``);
- one ``bottleneck_norm`` output serves both passes;
- the model returns the encoder-space pass-2 target, and the TasNet wrapper
  decodes it directly, with no second mask multiply.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tss_dprnn_tpu_torch.models.dprnn import DPRNNCore, _fit_length
from tss_dprnn_tpu_torch.models.dprnn_spe import DPRNNSpe, DPRNNSpeTasNet
from tss_dprnn_tpu_torch.models.layers import Dense
from tss_dprnn_tpu_torch.ops.masking import length_mask


class DPRNNSpeIRA(DPRNNSpe):
    """The two-pass separation module.

    ``forward(x [B, L, N], embeddings [B, La, N], aux_len [B], lengths=None)
    -> (target [B, L, N], logits [B, num_spks])``: the masked encoder-space
    target of pass 2, not the masks.

    ``pass1_remat``: ``None`` checkpoints every pass-1 block under autograd
    (the JAX core's default ``remat``), an int k the first k; pass 2 never
    checkpoints. ``share_blocks`` k (0 by default, the reference's two full
    passes): pass 2 adds its bottleneck delta onto pass 1's activation
    after block k and runs only blocks k..n_repeats-1. It adds no parameter,
    so a checkpoint loads under any k; ``utils/checkpoint.py`` records k and
    refuses another.
    """

    def __init__(self, *args, pass1_remat: Optional[int] = None, share_blocks: int = 0,
                 **kwargs):
        super().__init__(*args, **kwargs)
        n = len(self.dprnn_blocks)
        if not 0 <= int(share_blocks) < n:
            raise ValueError(f"share_blocks must be in [0, n_repeats), got {share_blocks}")
        self.pass1_remat = pass1_remat
        self.share_blocks = int(share_blocks)
        E = self.pred_linear.in_features
        self.aux_linear = Dense(2 * E, E)

    def forward(self, x: torch.Tensor, embeddings: torch.Tensor, aux_len: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        time_mask, chunk_lengths = self.masks_for(lengths, x.shape[1])
        k = self.share_blocks
        n_remat = len(self.dprnn_blocks) if self.pass1_remat is None else int(self.pass1_remat)
        norm, dense = self.bottleneck

        # pass 1
        v0 = self.embed(embeddings, aux_len)
        out_norm = norm(x, time_mask)  # shared by both passes
        h1 = dense(self.fuse(v0, out_norm, lengths))
        masks = DPRNNCore.forward(self, h1, time_mask, chunk_lengths, n_remat,
                                  tap_block=k if k else None)
        if k:
            masks, tap = masks
        d0 = masks[:, 0] * x

        # pass 2: d0 with the mixture's frame counts, the reference's divisor
        v1 = self.spk_encoder(d0, lengths, self.aux_T(aux_len))
        v1 = self.aux_linear(torch.cat([v0, v1], dim=-1))
        h2 = dense(self.fuse(v1, out_norm, lengths))
        if k:
            masks = DPRNNCore.forward(self, h2 - h1, time_mask, chunk_lengths, resume=(k, tap))
        else:
            masks = DPRNNCore.forward(self, h2, time_mask, chunk_lengths)
        return masks[:, 0] * x, self.pred_linear(v1)


class DPRNNSpeIRATasNet(DPRNNSpeTasNet):
    """DPRNN-Spe-IRA-TasNet: decodes the pass-2 encoder-space target.
    ``pass1_remat`` and ``share_blocks`` as :class:`DPRNNSpeIRA` has them."""

    separation_cls = DPRNNSpeIRA

    def forward(self, mix: torch.Tensor, aux: torch.Tensor, aux_len: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        T = mix.shape[1]
        feats = self.encoder(mix)  # [B, L, N]
        f_lengths = None if lengths is None else self.feat_lengths(lengths)
        target, logits = self.separation(feats, self.encoder(aux), aux_len, f_lengths)
        if f_lengths is not None:
            # padded frames would smear into the last valid sample
            target = target * length_mask(f_lengths, target.shape[1], target.dtype)[:, :, None]
        return _fit_length(self.decoder(target), T), logits
