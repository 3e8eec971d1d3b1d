#!/usr/bin/env python3
"""How far two fp32 runs of the last two families' train steps can agree (CPU).

    python scripts/port/fp32_conditioning.py

Takes the batches and the small models of ``tests/test_torch_port_ira_rawnet.py``
(JAX-initialised weights) and prints:

- RawNet3 in training mode on the 4 training references (16 kHz): the
  smallest |sinc filterbank output| (the log's argument), the largest
  embedding, and the distance of the port's fp32 embedding, eager JAX's and
  jitted JAX's from the port's float64 one (the same math: the tests hold
  the port's float64 embedder against eager JAX in float64 within 1e-9); and,
  for a fixed random projection of the embedding, the largest distance
  between the port's fp32 and float64 gradients of a RawNet3 tensor, over
  that tensor's max |grad| (tensors whose float64 gradient is rounding
  noise left out);
- DPRNN-Spe-IRA-TasNet (share_blocks 0): the largest distance of a tensor's
  gradient of one JAX trainer step jitted, and eagerly, from the port's, over
  that tensor's max |grad|.
"""

from __future__ import annotations

import copy
import os
import sys
import tempfile

import numpy as np
import torch

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT]

from tests.test_torch_port_ira_rawnet import (RAW_SMALL, SMALL, TRAIN_CONFIG,  # noqa: E402
                                              _port_rawnet3, make_batches)
from tss_dprnn_tpu.models import DPRNNRawNetTasNet as JaxRawNet  # noqa: E402
from tss_dprnn_tpu.models import DPRNNSpeIRATasNet as JaxIRA  # noqa: E402
from tss_dprnn_tpu.models.rawnet import RawNet3 as JaxRawNet3  # noqa: E402
from tss_dprnn_tpu.training.trainer_spe import TrainerSpe as JaxTrainerSpe  # noqa: E402
from tss_dprnn_tpu_torch.models import DPRNNSpeIRATasNet  # noqa: E402
from tss_dprnn_tpu_torch.training import TrainerSpe  # noqa: E402
from tss_dprnn_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402


def tree(t):
    return jax.tree_util.tree_map(np.asarray, dict(t))


def rawnet(b):
    raw, train = b["raw"], b["raw_train"]
    jmodel = JaxRawNet(**RAW_SMALL)
    v = tree(jax.jit(jmodel.init)(jax.random.PRNGKey(5), raw["mix"][:1], raw["reference"][:1],
                                  raw["ref_len"][:1]))
    start = state_dict_from_jax(v, "ln", 2, "att")
    ref, ref_len = train["reference"], train["ref_len"]
    emb = _port_rawnet3(start).train()
    emb64 = copy.deepcopy(emb).double()
    sinc = emb.conv1(torch.from_numpy(ref))
    e32 = emb(torch.from_numpy(ref), torch.from_numpy(ref_len))
    e64 = emb64(torch.from_numpy(ref).double(), torch.from_numpy(ref_len))
    jemb = JaxRawNet3(model_scale=4, C=32, nOut=SMALL["embeddings_size"], sinc_stride=16)
    jv = {"params": v["params"]["separation"]["spk_encoder"],
          "batch_stats": v["batch_stats"]["separation"]["spk_encoder"]}

    def apply(jv):
        return jemb.apply(jv, ref, ref_len, train=True, mutable=["batch_stats"])[0]

    e_eager, e_jit = np.asarray(apply(jv)), np.asarray(jax.jit(apply)(jv))
    ref64 = e64.detach().numpy()
    print(f"RawNet3, training mode, {ref.shape[0]} references of {ref.shape[1]} samples: "
          f"min |sinc output| {float(sinc.detach().abs().min()):.3e}, max |embedding| "
          f"{float(np.abs(ref64).max()):.4f}")
    for name, e in (("port fp32", e32.detach().numpy()), ("eager JAX fp32", e_eager),
                    ("jitted JAX fp32", e_jit)):
        print(f"  {name} embedding vs the port's float64: max |diff| "
              f"{float(np.abs(e - ref64).max()):.3e}")
    proj = np.random.default_rng(8).standard_normal(e32.shape)
    (e32 * torch.from_numpy(proj).float()).sum().backward()
    (e64 * torch.from_numpy(proj)).sum().backward()
    grads = [(k, p.grad.double(), q.grad) for (k, p), q in zip(emb.named_parameters(),
                                                                emb64.parameters())
             if p.grad is not None]
    # a tensor whose float64 gradient is rounding noise (BatchNorm's bias
    # before the softmax over time: zero in exact arithmetic) has no scale
    top = max(float(g.abs().max()) for _, _, g in grads)
    worst = max((float((g32 - g).abs().max() / g.abs().max()), k) for k, g32, g in grads
                if float(g.abs().max()) > 1e-6 * top)
    print(f"  fp32 vs float64 gradients: the largest {worst[0]:.3f} of max |grad| ({worst[1]})")


def ira(b):
    jmodel = JaxIRA(**SMALL, remat=False)
    spe, batch = b["spe"], b["train"]
    v = tree(jax.jit(jmodel.init)(jax.random.PRNGKey(3), spe["mix"][:1], spe["reference"][:1],
                                  spe["ref_len"][:1]))
    jtrainer = JaxTrainerSpe(jmodel, dict(TRAIN_CONFIG, new_checkpoints_path=tempfile.mkdtemp()))
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}

    def loss_fn(params):
        return jtrainer._forward_loss({"params": params, "batch_stats": v["batch_stats"]},
                                      jbatch, train=True)[0]

    start = state_dict_from_jax(v, "ln", 2, "att")
    model = DPRNNSpeIRATasNet(**SMALL)
    model.load_state_dict(start, strict=True)
    tr = TrainerSpe(model, dict(TRAIN_CONFIG, new_checkpoints_path=tempfile.mkdtemp()),
                    device="cpu")
    tr.model.train()
    loss, _ = tr._forward_loss(tr._to_device(batch), train=True)
    loss.backward()
    for name, fn in (("jitted", jax.jit(jax.grad(loss_fn))), ("eager", jax.grad(loss_fn))):
        g = state_dict_from_jax(tree({"params": fn(v["params"]),
                                      "batch_stats": v["batch_stats"]}), "ln", 2, "att")
        worst = max((float((p.grad - g[k]).abs().max() / g[k].abs().max()), k)
                    for k, p in tr.model.named_parameters())
        print(f"IRA train step, {name} JAX vs the port: the largest gradient distance "
              f"{worst[0]:.3e} of max |grad| ({worst[1]})")


if __name__ == "__main__":
    torch.set_num_threads(4)
    batches = make_batches()
    rawnet(batches)
    ira(batches)
