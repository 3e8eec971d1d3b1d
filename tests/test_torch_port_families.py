"""The port's other fusions and recurrent cells on the CPU, at small widths,
against the JAX package.

- DPRNN-Spe-TasNet with each of the fusions 'add', 'cat', 'mul' and 'film',
  from JAX-initialised weights (``state_dict_from_jax``, ``strict=True``):
  the bucketed forward with ragged lengths (output SNR >= 60 dB on each
  row's valid region, logits within 1e-4), and one ``TrainerSpe`` step's
  loss (1e-5 relative) and gradients (each within 1e-4 of its tensor's max
  |grad|) against ``jax.value_and_grad`` of the JAX trainer's loss, on
  references of one length: jitted JAX splits max-pool ties in padded
  reference frames its own way (``scripts/port/spk_grad_ties.py``), and
  without padding it is a tight reference.
- ``masked_flip`` exactly equal to the JAX one.
- ``RNNCore`` with 'GRU' and 'RNN', uni- and bidirectional, with lengths,
  within 1e-5 of the JAX core; a small DPRNN-TasNet with each against the
  JAX model (forward >= 60 dB, one ``Trainer`` step's loss and gradients as
  above), running no kernel of the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tss_dprnn_tpu.models import DPRNNSpeTasNet as JaxDPRNNSpeTasNet
from tss_dprnn_tpu.models import DPRNNTasNet as JaxDPRNNTasNet
from tss_dprnn_tpu_torch.data import loader
from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet, DPRNNTasNet
from tss_dprnn_tpu_torch.ops import bilstm2, lstm as lstm_ops
from tss_dprnn_tpu_torch.training import Trainer, TrainerSpe
from tss_dprnn_tpu_torch.utils.weights import state_dict_from_jax

SMALL = dict(input_size=8, feature_size=16, hidden_size=16, chunk_length=8, kernel_size=2,
             hop_length=4, n_repeats=1, norm_type="ln", activation_type="sigmoid")
SPE = dict(SMALL, O=8, P=12, embeddings_size=8, num_spks=5)
TRAIN_CONFIG = {"optimizer": {"lr": 1e-3, "weight_decay": 1e-2}, "clip_norm": 5,
                "ce_gamma": 0.5, "print_freq": 1}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: in the suite's parallel workers
    torch's idle pool threads spin against each other's and every small op
    waits on the scheduler (test_torch_port_device_metrics.py measures it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _snr_db(got, want):
    return 10 * np.log10(np.sum(want ** 2) / max(np.sum((got - want) ** 2), 1e-30))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _launches():
    return bilstm2.launch_count(), lstm_ops.launch_count()


def _assert_grads(model, want_grads):
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == {k for k in want_grads if k in got} == set(got)
    for k, g in got.items():
        w = want_grads[k]
        assert float(w.abs().max()) > 0, k  # every parameter takes part in the loss
        torch.testing.assert_close(g, w, atol=1e-4 * float(w.abs().max()), rtol=0, msg=k)


@pytest.fixture(scope="module")
def spe_batch():
    """A bucketed TSS batch of 3 ragged rows (zero past each length) and a
    training batch of 2 fixed crops, from a seed."""
    rng = np.random.default_rng(7)
    lengths = np.array([400, 317, 251], np.int32)
    ref_len = np.array([300, 222, 181], np.float32)
    mix = rng.standard_normal((3, 400)).astype(np.float32)
    ref = rng.standard_normal((3, 300)).astype(np.float32)
    for b in range(3):
        mix[b, lengths[b]:] = 0
        ref[b, int(ref_len[b]):] = 0
    items = [(rng.standard_normal(240).astype(np.float32),
              rng.standard_normal(240).astype(np.float32),
              rng.standard_normal(200).astype(np.float32), i) for i in range(2)]
    return mix, lengths, ref, ref_len, loader.collate_spe(items)


# ------------------------------------------------------------------ fusions

@pytest.fixture(scope="module", params=["add", "cat", "mul", "film"])
def fusion_pair(request, spe_batch, tmp_path_factory):
    """(fusion, the JAX variables, the JAX outputs, the port's model loaded
    from the variables). The outputs, from one jitted program: the bucketed
    forward, and the loss and gradients of the JAX trainer's train step on
    the training batch."""
    from tss_dprnn_tpu.training.trainer_spe import TrainerSpe as JaxTrainerSpe

    mix, lengths, ref, ref_len, batch = spe_batch
    cfg = dict(SPE, fusion_type=request.param)
    jmodel = JaxDPRNNSpeTasNet(**cfg)
    variables = _numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(3), mix[:1], ref[:1],
                                                 ref_len[:1]))
    jtrainer = JaxTrainerSpe(jmodel, dict(TRAIN_CONFIG, new_checkpoints_path=str(
        tmp_path_factory.mktemp("jax"))))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        loss, _, _ = jtrainer._forward_loss(
            {"params": params, "batch_stats": variables["batch_stats"]}, jbatch, train=True)
        return loss

    @jax.jit
    def outputs(variables):
        return (jmodel.apply(variables, mix, ref, ref_len, lengths),
                jax.value_and_grad(loss_fn)(variables["params"]))

    (wav, logits), (loss, grads) = outputs(variables)
    want = dict(wav=np.asarray(wav), logits=np.asarray(logits), loss=float(loss),
                grads=state_dict_from_jax(_numpy_tree({"params": grads, "batch_stats":
                                                       variables["batch_stats"]}),
                                          "ln", 2, request.param))
    model = DPRNNSpeTasNet(**cfg).eval()
    sd = state_dict_from_jax(variables, "ln", 2, request.param)
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)
    return request.param, sd, want, model


def test_fusion_state_dict_names(fusion_pair):
    fusion, _, _, model = fusion_pair
    names = {k.split(".")[1] for k in model.state_dict() if k.startswith("separation.fusion")}
    want = {"film": {"fusion_linear_1", "fusion_linear_2"}, "cat": set()}.get(
        fusion, {"fusion_linear"})
    assert names == want
    N, E = SPE["input_size"], SPE["embeddings_size"]
    width = N + E if fusion == "cat" else N
    assert model.state_dict()["separation.bottleneck.1.weight"].shape == (
        SPE["feature_size"], width, 1)


def test_fusion_matches_jax_bucketed(spe_batch, fusion_pair):
    _, _, want, model = fusion_pair
    mix, lengths, ref, ref_len, _ = spe_batch
    before = _launches()
    with torch.inference_mode():
        wav, logits = model(*(torch.from_numpy(a) for a in (mix, ref, ref_len, lengths)))
    assert _launches() == before  # CPU tensors: the plain versions ran
    np.testing.assert_allclose(logits.numpy(), want["logits"], atol=1e-4, rtol=0)
    for b, n in enumerate(lengths):
        assert _snr_db(wav[b, :n].numpy(), want["wav"][b, :n]) >= 60.0


def test_fusion_train_step_matches_jax(spe_batch, fusion_pair, tmp_path):
    fusion, start, want, _ = fusion_pair
    model = DPRNNSpeTasNet(**dict(SPE, fusion_type=fusion))
    model.load_state_dict(start, strict=True)
    tr = TrainerSpe(model, dict(TRAIN_CONFIG, new_checkpoints_path=str(tmp_path)), device="cpu")
    tr.model.train()
    loss, _ = tr._forward_loss(tr._to_device(spe_batch[4]), train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-5)
    _assert_grads(tr.model, want["grads"])


def test_unknown_fusion_raises():
    with pytest.raises(ValueError, match="fusion_type"):
        DPRNNSpeTasNet(**dict(SPE, fusion_type="sum"))


# ------------------------------------------------------------ masked_flip

@pytest.mark.parametrize("time_axis", [1, 2])
def test_masked_flip_equals_jax(rng, time_axis):
    from tss_dprnn_tpu.ops.masking import masked_flip as jax_masked_flip
    from tss_dprnn_tpu_torch.ops.masking import masked_flip

    x = rng.standard_normal((3, 5, 9, 4)).astype(np.float32)
    T = x.shape[time_axis]
    lengths = np.array([T, 3, 0], np.int32)
    for lens in (lengths, None):
        want = np.asarray(jax_masked_flip(jnp.asarray(x), None if lens is None
                                          else jnp.asarray(lens), time_axis))
        got = masked_flip(torch.from_numpy(x), None if lens is None else torch.from_numpy(lens),
                          time_axis).numpy()
        np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------- GRU and RNN

@pytest.mark.parametrize("rnn_type", ["GRU", "RNN"])
@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_rnn_core_matches_jax(rng, rnn_type, bidirectional):
    from tss_dprnn_tpu.models.layers import RNNCore as JaxRNNCore
    from tss_dprnn_tpu_torch.models.layers import RNNCore
    from tss_dprnn_tpu_torch.utils import weights

    B, T, F, H = 3, 11, 6, 5
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    lengths = np.array([11, 7, 2], np.int32)
    jcore = JaxRNNCore(H, bidirectional, rnn_type)
    params = _numpy_tree(jcore.init(jax.random.PRNGKey(0), x, lengths)["params"])
    G = {"GRU": 3, "RNN": 1}[rnn_type] * H
    assert params["w_ih_f"].shape == (F, G)
    core = RNNCore(F, H, bidirectional, rnn_type)
    sd = {}
    weights._rnn_entries(sd, "rnn", params)
    core.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                         strict=True)
    for lens in (lengths, None):
        want = np.asarray(jcore.apply({"params": params}, x,
                                      None if lens is None else jnp.asarray(lens)))
        before = _launches()
        got = core(torch.from_numpy(x), None if lens is None else torch.from_numpy(lens))
        assert _launches() == before
        assert got.shape == want.shape == (B, T, H * (2 if bidirectional else 1))
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", params=["GRU", "RNN"])
def cell_pair(request, spe_batch):
    cfg = dict(SMALL, rnn_type=request.param, bidirectional=request.param == "GRU")
    jmodel = JaxDPRNNTasNet(**cfg)
    variables = _numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(4), spe_batch[0][:1]))
    model = DPRNNTasNet(**cfg).eval()
    model.load_state_dict(state_dict_from_jax(variables, "ln", 2), strict=True)
    return cfg, jmodel, variables, model


def test_cell_tasnet_matches_jax(spe_batch, cell_pair):
    _, jmodel, variables, model = cell_pair
    mix, lengths = spe_batch[:2]
    want = np.asarray(jax.jit(jmodel.apply)(variables, mix, lengths))
    before = _launches()
    with torch.inference_mode():
        got = model(torch.from_numpy(mix), torch.from_numpy(lengths)).numpy()
    assert _launches() == before
    for b, n in enumerate(lengths):
        assert _snr_db(got[b, :, :n], want[b, :, :n]) >= 60.0


def test_cell_tasnet_train_step_matches_jax(cell_pair, tmp_path):
    from tss_dprnn_tpu.ops import losses as jlosses

    cfg, jmodel, variables, _ = cell_pair
    rng = np.random.default_rng(8)
    sources = rng.standard_normal((2, 2, 240)).astype(np.float32)
    batch = loader.collate_bss([(s.sum(0), s) for s in sources])

    def loss_fn(params):
        out = jmodel.apply({"params": params}, jnp.asarray(batch["mix"]))
        return jlosses.pit_sisdr_loss(out, jnp.asarray(batch["sources"]))

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    want_grads = state_dict_from_jax(_numpy_tree({"params": grads}), "ln", 2)
    model = DPRNNTasNet(**cfg)
    model.load_state_dict(state_dict_from_jax(variables, "ln", 2), strict=True)
    tr = Trainer(model, dict(TRAIN_CONFIG, new_checkpoints_path=str(tmp_path)), device="cpu")
    tr.model.train()
    loss, _ = tr._forward_loss(tr._to_device(batch), train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _assert_grads(tr.model, want_grads)
