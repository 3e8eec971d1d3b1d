"""The port's DPRNN-Spe-TasNet ('att' fusion, 'ln' norm) against the JAX
package's at small widths, with JAX-initialised weights carried across by
``tss_dprnn_tpu_torch.utils.weights.state_dict_from_jax``.

Bars: output SNR >= 60 dB on each row's valid region (the bar the JAX
package holds against its torch oracle, PARITY.md:198-201) and speaker
logits within 1e-4; the JAX side runs its default 'xla' LSTM backend."""

import numpy as np
import pytest
import torch

import jax

from tss_dprnn_tpu.models import DPRNNSpeTasNet as JaxDPRNNSpeTasNet
from tss_dprnn_tpu.utils.torch_export import export_state_dict
from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
from tss_dprnn_tpu_torch.utils.weights import init_weights_, state_dict_from_jax

SMALL = dict(input_size=8, feature_size=16, hidden_size=16, chunk_length=8, kernel_size=2,
             hop_length=4, n_repeats=2, norm_type="ln", activation_type="sigmoid", O=8, P=12,
             embeddings_size=8, num_spks=5, fusion_type="att")


def _snr_db(got, want):
    return 10 * np.log10(np.sum(want ** 2) / max(np.sum((got - want) ** 2), 1e-30))


@pytest.fixture(scope="module")
def batch():
    """A bucketed batch of 3 ragged rows with ragged references, zero-padded
    past the true lengths as the bucketed loader pads them."""
    rng = np.random.default_rng(3)
    lengths = np.array([400, 317, 251], np.int32)
    ref_len = np.array([300, 222, 181], np.float32)
    mix = rng.standard_normal((3, 400)).astype(np.float32)
    ref = rng.standard_normal((3, 300)).astype(np.float32)
    for b in range(3):
        mix[b, lengths[b]:] = 0
        ref[b, int(ref_len[b]):] = 0
    return mix, ref, ref_len, lengths


@pytest.fixture(scope="module")
def jax_model(batch):
    """The JAX model and its variables as numpy trees, BatchNorm running
    statistics moved off their defaults so the eval-mode BN is exercised."""
    mix, ref, ref_len, _ = batch
    model = JaxDPRNNSpeTasNet(**SMALL)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), mix[:1], ref[:1], ref_len[:1])
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    rng = np.random.default_rng(4)

    def perturb(path, v):
        name = path[-1].key
        if name == "mean":
            return (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        return (0.5 + rng.random(v.shape)).astype(np.float32)

    variables["batch_stats"] = jax.tree_util.tree_map_with_path(perturb, variables["batch_stats"])
    return model, variables


@pytest.fixture(scope="module")
def port_model(jax_model):
    _, variables = jax_model
    model = DPRNNSpeTasNet(**SMALL).eval()
    model.load_state_dict(state_dict_from_jax(variables, "ln", 2, "att"), strict=True)
    return model


def test_state_dict_from_jax_equals_export(jax_model):
    _, variables = jax_model
    got = state_dict_from_jax(variables, norm_type="ln", kernel_size=2, fusion_type="att")
    want = export_state_dict(variables, norm_type="ln", kernel_size=2, fusion_type="att")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_port_model_loads_strict(jax_model):
    _, variables = jax_model
    model = DPRNNSpeTasNet(**SMALL)
    sd = state_dict_from_jax(variables, "ln", 2, "att")
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)


def test_port_matches_jax_bucketed(batch, jax_model, port_model):
    model, variables = jax_model
    mix, ref, ref_len, lengths = batch
    want_wav, want_logits = jax.jit(model.apply)(variables, mix, ref, ref_len, lengths)
    with torch.inference_mode():
        wav, logits = port_model(*(torch.from_numpy(a) for a in (mix, ref, ref_len, lengths)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=1e-4, rtol=0)
    for b, n in enumerate(lengths):
        assert _snr_db(wav[b, :n].numpy(), np.asarray(want_wav)[b, :n]) >= 60.0


def test_port_matches_jax_unmasked(batch, jax_model, port_model):
    model, variables = jax_model
    mix, ref, ref_len, _ = batch
    want_wav, want_logits = jax.jit(model.apply)(variables, mix[:1], ref[:1], ref_len[:1])
    with torch.inference_mode():
        wav, logits = port_model(*(torch.from_numpy(a) for a in (mix[:1], ref[:1], ref_len[:1])))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=1e-4, rtol=0)
    assert _snr_db(wav.numpy(), np.asarray(want_wav)) >= 60.0


def test_masked_bucket_equals_exact_shape(batch, port_model):
    """The port's counterpart of tests/test_masked_eval.py: each padded row
    reproduces its exact-shape run on the valid region (same tolerance)."""
    mix, ref, ref_len, lengths = (torch.from_numpy(a) for a in batch)
    with torch.inference_mode():
        wav_p, logits_p = port_model(mix, ref, ref_len, lengths)
        for b in range(3):
            n, na = int(lengths[b]), int(ref_len[b])
            wav_e, logits_e = port_model(mix[b : b + 1, :n], ref[b : b + 1, :na], ref_len[b : b + 1])
            torch.testing.assert_close(logits_p[b], logits_e[0], atol=2e-4, rtol=1e-4)
            torch.testing.assert_close(wav_p[b, :n], wav_e[0], atol=2e-4, rtol=1e-4)


def test_stacked_lstm_weights_follow_load_state_dict(batch, jax_model, port_model):
    """Each RNNCore stacks its LSTM weights once; loading new weights after
    a forward must rebuild the stack, not reuse the stale one."""
    _, variables = jax_model
    args = [torch.from_numpy(a) for a in batch]
    model = init_weights_(DPRNNSpeTasNet(**SMALL).eval(), torch.Generator().manual_seed(1))
    with torch.inference_mode():
        model(*args)  # stacks the random weights
        model.load_state_dict(state_dict_from_jax(variables, "ln", 2, "att"), strict=True)
        got = model(*args)
        want = port_model(*args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
