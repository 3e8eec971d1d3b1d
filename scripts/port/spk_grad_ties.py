#!/usr/bin/env python3
"""Why the JAX trainer's speaker-encoder gradients move under jit (CPU).

    python scripts/port/spk_grad_ties.py

Takes the batch and the small DPRNN-Spe-TasNet of the port's one-step test
(``tests/test_torch_port_training.py``: 3 crops, JAX-initialised weights,
the Pallas LSTM lane in interpret mode) and computes the JAX trainer's
gradient of one step eagerly and under ``jax.jit``, with the speaker
encoder's max pool in three forms:

- ``tie_split``: the package's own ``_pool3_cl`` (``jnp.max`` over windows
  of 3, whose gradient is split among equal values; the port's ``amax``
  does the same);
- ``barrier``: the same behind ``jax.lax.optimization_barrier``;
- ``first_argmax``: the whole gradient of a window to its first maximum.

For each it prints the largest difference between the eager and the jitted
gradient of a tensor, over that tensor's max |grad|. It then reads, from the
eager run, how many pool windows hold an exact tie and how many of those
ties lie among valid (unpadded) reference frames, and the smallest and
median batch variance of each speaker-encoder BatchNorm channel.
"""

from __future__ import annotations

import functools
import os
import sys
import tempfile

import numpy as np

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from jax.experimental import pallas as pl  # noqa: E402

pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)

from test_torch_port_training import SMALL, _batch, _Crops  # noqa: E402
from tss_dprnn_tpu.models import DPRNNSpeTasNet, dprnn_spe  # noqa: E402
from tss_dprnn_tpu.ops import rnn as jax_rnn  # noqa: E402
from tss_dprnn_tpu.training.trainer_spe import TrainerSpe  # noqa: E402


def first_argmax_pool(x):
    B, L, C = x.shape
    w = x[:, : (L // 3) * 3].reshape(B, L // 3, 3, C)
    i = jnp.argmax(jax.lax.stop_gradient(w), axis=2)[:, :, None]
    return jnp.take_along_axis(w, i, axis=2)[:, :, 0]


def main() -> int:
    batch = _batch(_Crops(2, 3), [0, 1, 2])
    model = DPRNNSpeTasNet(**SMALL)
    with tempfile.TemporaryDirectory() as unused:  # the trainer wants a checkpoint directory
        trainer = TrainerSpe(model, {"optimizer": {"lr": 1e-3, "weight_decay": 1e-2},
                                     "clip_norm": 5, "ce_gamma": 0.5, "print_freq": 1,
                                     "lstm_backend": "pallas", "new_checkpoints_path": unused})
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), batch["mix"][:1],
                                    batch["reference"][:1], batch["ref_len"][:1])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        with jax_rnn.lstm_backend("pallas"):
            loss, stats, _ = trainer._forward_loss(
                {"params": params, "batch_stats": variables["batch_stats"]}, jbatch, train=True)
        return loss, stats

    tie_split = dprnn_spe._pool3_cl
    pools = {"tie_split": tie_split,
             "barrier": lambda x: tie_split(jax.lax.optimization_barrier(x)),
             "first_argmax": first_argmax_pool}
    for name, pool in pools.items():
        dprnn_spe._pool3_cl = pool
        grad = jax.value_and_grad(loss_fn, has_aux=True)  # a new function: no cached trace
        (_, stats), eager = grad(variables["params"])
        _, jitted = jax.jit(grad)(variables["params"])
        worst, where = 0.0, ""
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(eager),
                                jax.tree_util.tree_leaves(jitted)):
            a, b = np.asarray(a), np.asarray(b)
            d = float(np.abs(a - b).max() / max(float(np.abs(a).max()), 1e-30))
            if d > worst:
                worst, where = d, jax.tree_util.keystr(path)
        print(f"{name}: eager vs jit, worst tensor {worst:.4e} of its max |grad| at {where}")

    # the pool inputs of the eager run, and where their ties lie
    inputs = []

    def recording_pool(x):
        jax.debug.callback(lambda v: inputs.append(np.asarray(v)), x)
        return tie_split(x)

    dprnn_spe._pool3_cl = recording_pool
    (_, stats), _ = grad(variables["params"])
    dprnn_spe._pool3_cl = tie_split
    # encoder frames (kernel 2, stride 1) of each reference, then pooled
    valid = np.asarray(batch["ref_len"]).astype(int) - 1
    for x in inputs:
        B, L, C = x.shape
        n = L // 3
        w = x[:, : n * 3].reshape(B, n, 3, C)
        at_max = w == w.max(axis=2, keepdims=True)
        frame = np.arange(n * 3).reshape(n, 3)
        padded = frame[None, :, :, None] >= valid[:, None, None, None]
        ties = int((at_max.sum(axis=2) > 1).sum())
        valid_ties = int(((at_max & ~padded).sum(axis=2) > 1).sum())
        print(f"pool input {x.shape}: {ties} of {B * n * C} windows tie, {valid_ties} of them "
              f"among valid frames (valid frames {valid.tolist()})")
        valid = valid // 3
    # flax keeps running var = 0.9 * 1 + 0.1 * unbiased batch var after one step
    enc = stats["separation"]["spk_encoder"]
    for res in ("res1", "res2", "res3"):
        for bn in ("batch_norm1", "batch_norm2"):
            var = (np.asarray(enc[res][bn]["var"]) - 0.9) / 0.1
            print(f"{res}.{bn}: batch variance min {var.min():.4g}, median {np.median(var):.4g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
