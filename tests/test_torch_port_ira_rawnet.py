"""The port's last two model families on the CPU, at small widths, against
the JAX package: DPRNN-Spe-IRA-TasNet and DPRNN-RawNet-TasNet.

Weights come from the JAX models' own initialisers and reach the port
through ``state_dict_from_jax`` with ``strict=True``; inputs are drawn from a
numpy seed. Bars: forwards >= 60 dB output SNR on each row's valid region,
speaker logits within 1e-4; one train step's loss within 1e-5 relative,
every gradient within 1e-4 of its tensor's max |grad|, and BatchNorm's
running statistics after the step within 1e-6 of the JAX ``batch_stats``
(IRA's speaker encoder moves them twice per step). The JAX train steps run
eagerly, as ``tests/test_torch_port_training.py`` runs them: jitted JAX
splits the speaker encoder's max-pool ties its own way
(``scripts/port/spk_grad_ties.py``), and IRA's second embedding pools the
ReLU zeros of its pass-1 estimate.

Also: ``pass1_remat`` None and 0 give the same values bit for bit (the
checkpointed blocks run again in the backward); ``share_blocks`` is
recorded in the trainer's checkpoints and a different value is refused;
``sinc_filters`` / ``mel_init_bands``; the resampling collates; the plain
ops of the JAX package's ``ops/conv.py`` and ``ops/norms.py``; the
reference-format torch oracle of ``tests/torch_oracle.py`` as a second
reference; and the RawNet trainer's demo references, resampled to 16 kHz
where the JAX trainer does not resample them.

JAX is imported inside the tests, so the ``cuda`` case at the end runs on
a machine without it (``python -m pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch.data import loader
from tss_dprnn_tpu_torch.models import DPRNNRawNetTasNet, DPRNNSpeIRATasNet
from tss_dprnn_tpu_torch.models.rawnet import RawNet3
from tss_dprnn_tpu_torch.ops import bilstm2, lstm as lstm_ops
from tss_dprnn_tpu_torch.training import TrainerRawNet, TrainerSpe
from tss_dprnn_tpu_torch.utils import weights
from tss_dprnn_tpu_torch.utils.weights import init_weights_, state_dict_from_jax

SMALL = dict(input_size=8, feature_size=16, hidden_size=16, chunk_length=8, kernel_size=2,
             hop_length=4, n_repeats=2, norm_type="ln", activation_type="sigmoid", O=8, P=12,
             embeddings_size=8, num_spks=5, fusion_type="att")
RAW = dict(rawnet_C=32, rawnet_scale=4, rawnet_sinc_stride=16)
RAW_SMALL = dict(SMALL, n_repeats=1, **RAW)
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
    import jax

    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _launches():
    return bilstm2.launch_count(), lstm_ops.launch_count()


def _assert_grads(model, want_grads):
    got = {k: p.grad for k, p in model.named_parameters()}
    for k, g in got.items():
        w = want_grads[k]
        assert float(w.abs().max()) > 0, k  # every parameter takes part in the loss
        torch.testing.assert_close(g, w, atol=1e-4 * float(w.abs().max()), rtol=0, msg=k)


def _assert_running_stats(model, want_sd):
    got = model.state_dict()
    keys = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        torch.testing.assert_close(got[k], want_sd[k], atol=1e-6, rtol=0, msg=k)


@pytest.fixture(scope="module")
def batches():
    return make_batches()


def make_batches():
    """A bucketed TSS batch of 3 ragged rows at 8 kHz (references at 8 kHz
    and their 16 kHz resampling, zero past each length) and training
    batches of 4 fixed crops whose references share one length (4 rows:
    RawNet3's last BatchNorm normalises [B, 3072] over the batch, and at 2
    rows its outputs are +-1 whatever the input)."""
    rng = np.random.default_rng(11)
    lengths = np.array([400, 317, 251], np.int32)
    mix = rng.standard_normal((3, 400)).astype(np.float32)
    for b in range(3):
        mix[b, lengths[b]:] = 0
    refs = [rng.standard_normal(n).astype(np.float32) for n in (300, 222, 181)]
    items = [(mix[b, :lengths[b]], mix[b, :lengths[b]], refs[b], b) for b in range(3)]
    spe = loader.make_collate_spe_eval()(items, 400)
    raw = loader.make_collate_spe_eval(resample_ref_to=16000)(
        [(m, t, rng.standard_normal(n).astype(np.float32), s)
         for (m, t, _, s), n in zip(items, (4000, 3100, 2500))], 400)
    for bt in (spe, raw):
        bt["lengths"] = lengths
    crops = [(rng.standard_normal(240).astype(np.float32),
              rng.standard_normal(240).astype(np.float32),
              rng.standard_normal(200).astype(np.float32), i) for i in range(4)]
    raw_crops = [(m, t, rng.standard_normal(3000).astype(np.float32), s)
                 for m, t, _, s in crops]
    return dict(spe=spe, raw=raw, train=loader.collate_spe(crops),
                raw_train=loader.collate_spe(raw_crops, resample_ref_to=16000))


def _jax_outputs(jmodel, trainer_cls, variables, bucketed, train_batch, tmp_path,
                 eager_step=True, interceptor=None):
    """The JAX model's bucketed and unmasked forwards (jitted) and the loss,
    gradients and new batch_stats of its trainer's train step (eager by
    default, under the flax method ``interceptor`` when one is given)."""
    import contextlib

    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    jtrainer = trainer_cls(jmodel, dict(TRAIN_CONFIG, new_checkpoints_path=str(tmp_path)))
    jbatch = {k: jnp.asarray(v) for k, v in train_batch.items()}
    args = [bucketed[k] for k in ("mix", "reference", "ref_len")]

    def loss_fn(params):
        loss, new_bs, _ = jtrainer._forward_loss(
            {"params": params, "batch_stats": variables["batch_stats"]}, jbatch, train=True)
        return loss, new_bs

    @jax.jit
    def forwards(variables):
        return (jmodel.apply(variables, *args, lengths=bucketed["lengths"]),
                jmodel.apply(variables, *args))

    bucket, exact = forwards(variables)
    step = jax.value_and_grad(loss_fn, has_aux=True)
    with nn.intercept_methods(interceptor) if interceptor else contextlib.nullcontext():
        (loss, new_bs), grads = (step if eager_step else jax.jit(step))(variables["params"])
    return dict(bucketed=[np.asarray(a) for a in bucket], exact=[np.asarray(a) for a in exact],
                loss=float(loss), grads=_numpy_tree({"params": grads,
                                                     "batch_stats": variables["batch_stats"]}),
                after=_numpy_tree({"params": variables["params"], "batch_stats": new_bs}))


def _check_forward(model, batch, want):
    ins = [torch.from_numpy(np.asarray(batch[k])) for k in ("mix", "reference", "ref_len")]
    before = _launches()
    with torch.inference_mode():
        for name, kw in (("bucketed", {"lengths": torch.from_numpy(batch["lengths"])}),
                         ("exact", {})):
            wav, logits = model(*ins, **kw)
            np.testing.assert_allclose(logits.numpy(), want[name][1], atol=1e-4, rtol=0)
            n = batch["lengths"] if name == "bucketed" else [wav.shape[1]] * wav.shape[0]
            for b, nb in enumerate(n):
                assert _snr_db(wav[b, :nb].numpy(), want[name][0][b, :nb]) >= 60.0, (name, b)
    assert _launches() == before  # CPU tensors: the plain versions ran


# ---------------------------------------------------------------------- IRA

@pytest.fixture(scope="module", params=[0, 1], ids=["share0", "share1"])
def ira_pair(request, batches, tmp_path_factory):
    """(share_blocks, the JAX variables as a port state_dict, the JAX
    outputs); the JAX model keeps pass 1 rematerialised (its default)."""
    import jax

    from tss_dprnn_tpu.models import DPRNNSpeIRATasNet as JaxIRA
    from tss_dprnn_tpu.training.trainer_spe import TrainerSpe as JaxTrainerSpe

    k = request.param
    # the train step runs eagerly, op by op as the port runs: XLA's fused
    # program moves the speaker encoder's gradients by up to 3x their own
    # size (its second embedding max-pools the ReLU zeros of d0), eager JAX
    # is within 5e-5 of their max (scripts/port/fp32_conditioning.py). No remat: JAX gives the same values under any
    # remat policy (tests/test_training.py), and eagerly it costs 10x the time
    jmodel = JaxIRA(**SMALL, share_blocks=k, remat=False)
    spe = batches["spe"]
    variables = _numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(3), spe["mix"][:1],
                                                 spe["reference"][:1], spe["ref_len"][:1]))
    want = _jax_outputs(jmodel, JaxTrainerSpe, variables, spe, batches["train"],
                        tmp_path_factory.mktemp("jax_ira"))
    return k, state_dict_from_jax(variables, "ln", 2, "att"), want


def _ira(k, start, pass1_remat=None):
    model = DPRNNSpeIRATasNet(**SMALL, share_blocks=k, pass1_remat=pass1_remat)
    model.load_state_dict(start, strict=True)
    return model


def test_ira_state_dict_names(ira_pair):
    _, start, _ = ira_pair
    model = DPRNNSpeIRATasNet(**SMALL)
    assert set(model.state_dict()) == set(start)
    E = SMALL["embeddings_size"]
    assert model.state_dict()["separation.aux_linear.weight"].shape == (E, 2 * E)


@pytest.mark.parametrize("pass1_remat", [None, 0], ids=["remat", "no_remat"])
def test_ira_matches_jax(batches, ira_pair, pass1_remat):
    k, start, want = ira_pair
    _check_forward(_ira(k, start, pass1_remat).eval(), batches["spe"], want)


def test_ira_train_step_matches_jax(batches, ira_pair, tmp_path):
    """One TrainerSpe step with pass 1 checkpointed and without: the same
    loss and gradients bit for bit, against the JAX trainer's; BatchNorm's
    running statistics after the step (two updates) against JAX's."""
    k, start, want = ira_pair
    runs = {}
    for pass1_remat in (None, 0):
        tr = TrainerSpe(_ira(k, start, pass1_remat), dict(TRAIN_CONFIG, new_checkpoints_path=str(
            tmp_path)), device="cpu")
        tr.model.train()
        calls = []
        # a pre-hook: the recomputation stops once it has rebuilt every
        # saved tensor, before the block returns
        hooks = [b.register_forward_pre_hook(lambda *a: calls.append(1))
                 for b in tr.model.separation.dprnn_blocks]
        loss, _ = tr._forward_loss(tr._to_device(batches["train"]), train=True)
        forwards = len(calls)
        loss.backward()
        for h in hooks:
            h.remove()
        n = SMALL["n_repeats"]
        # pass 1 runs n blocks, pass 2 n - k; each checkpointed block once more
        assert (forwards, len(calls)) == (2 * n - k, 2 * n - k + (n if pass1_remat is None
                                                                 else 0))
        runs[pass1_remat] = (loss, {n_: p.grad for n_, p in tr.model.named_parameters()})
        _assert_running_stats(tr.model, state_dict_from_jax(want["after"], "ln", 2, "att"))
    (loss_r, grads_r), (loss_0, grads_0) = runs[None], runs[0]
    assert torch.equal(loss_r, loss_0)
    for name, g in grads_r.items():
        assert torch.equal(g, grads_0[name]), name
    np.testing.assert_allclose(loss_r.item(), want["loss"], rtol=1e-5)
    _assert_grads(tr.model, state_dict_from_jax(want["grads"], "ln", 2, "att"))


def test_ira_share_blocks_range():
    for k in (-1, SMALL["n_repeats"]):
        with pytest.raises(ValueError, match="share_blocks"):
            DPRNNSpeIRATasNet(**SMALL, share_blocks=k)


@pytest.mark.parametrize("saved,loaded", [(1, 0), (1, 1), (None, 1)],
                         ids=["refused", "same", "unrecorded"])
def test_share_blocks_checkpoint_guard(tmp_path, saved, loaded, caplog):
    """The trainer records share_blocks; another value is refused, the same
    loads, and a file without the record (a reference .pt) loads with a log
    line naming the model's k."""
    from tss_dprnn_tpu_torch.utils.checkpoint import load_model

    model = init_weights_(DPRNNSpeIRATasNet(**SMALL, share_blocks=saved or 0),
                          torch.Generator().manual_seed(2))
    if saved is None:
        path = tmp_path / "bare.pt"
        torch.save(model.state_dict(), path)
    else:
        tr = TrainerSpe(model, dict(TRAIN_CONFIG, new_checkpoints_path=str(tmp_path)),
                        device="cpu")
        path = tr._save_checkpoint(best=False)
        assert torch.load(path, weights_only=True)["share_blocks"] == saved
    target = DPRNNSpeIRATasNet(**SMALL, share_blocks=loaded)
    if saved is not None and saved != loaded:
        with pytest.raises(ValueError, match=f"share_blocks={saved}"):
            load_model(str(path), target)
        return
    with caplog.at_level("INFO", logger="tss_dprnn_tpu_torch"):
        load_model(str(path), target)
    for k, v in model.state_dict().items():
        assert torch.equal(target.state_dict()[k], v), k
    logged = any(f"share_blocks={loaded}" in r.getMessage() for r in caplog.records)
    assert logged == (saved is None)


# ------------------------------------------------------------------- RawNet

@pytest.fixture(scope="module")
def rawnet_pair(batches, tmp_path_factory):
    """The JAX RawNet model's variables (also as a port state_dict) and
    outputs. Its train step is jitted with RawNet3's output replaced, in
    value, by a fixed embedding (the port's, in training mode): in training
    mode the fp32 embedding is ill-conditioned (see
    :func:`test_rawnet_train_step_matches_jax`), and the rest of the step is
    held on the same embedding on both sides."""
    import jax

    from tss_dprnn_tpu.models import DPRNNRawNetTasNet as JaxRawNet
    from tss_dprnn_tpu.models.rawnet import RawNet3 as JaxRawNet3
    from tss_dprnn_tpu.training.trainer_rawnet import TrainerRawNet as JaxTrainerRawNet

    jmodel = JaxRawNet(**RAW_SMALL)
    raw, train = batches["raw"], batches["raw_train"]
    variables = _numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(5), raw["mix"][:1],
                                                 raw["reference"][:1], raw["ref_len"][:1]))
    start = state_dict_from_jax(variables, "ln", 2, "att")
    emb = _port_rawnet3(start).train()
    with torch.no_grad():
        fixed = emb(torch.from_numpy(train["reference"]), torch.from_numpy(train["ref_len"]))

    def as_fixed(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, JaxRawNet3) and context.method_name == "__call__":
            return out + jax.lax.stop_gradient(fixed.numpy() - out)
        return out

    want = _jax_outputs(jmodel, JaxTrainerRawNet, variables, raw, train,
                        tmp_path_factory.mktemp("jax_raw"), eager_step=False,
                        interceptor=as_fixed)
    want["embedding"] = fixed
    return jmodel, variables, start, want


def _port_rawnet3(start):
    """The port's RawNet3 (C 32, scale 4, stride 16) from a model state_dict."""
    emb = RawNet3(32, 4, SMALL["embeddings_size"], 16)
    prefix = "separation.spk_encoder."
    emb.load_state_dict({k[len(prefix):]: v for k, v in start.items() if k.startswith(prefix)},
                        strict=True)
    return emb


def test_rawnet_state_dict_names(rawnet_pair):
    *_, start, _ = rawnet_pair
    model = DPRNNRawNetTasNet(**RAW_SMALL)
    assert set(model.state_dict()) == set(start)
    sd = model.state_dict()
    p = "separation.spk_encoder."
    assert sd[p + "layer1.afms.alpha"].shape == (32, 1)
    assert sd[p + "conv1.filterbank.low_hz_"].shape == (4, 1)
    assert sd[p + "preprocess.0.flipped_filter"].shape == (1, 1, 2)
    assert p + "layer1.residual.0.weight" in sd and p + "layer2.residual.0.weight" not in sd
    for k in ("window_", "n_"):  # frozen tensors of the config
        torch.testing.assert_close(sd[p + f"conv1.filterbank.{k}"],
                                   start[p + f"conv1.filterbank.{k}"], atol=0, rtol=0)


def test_rawnet_tasnet_matches_jax(batches, rawnet_pair):
    """Exact (no lengths) and bucketed (ragged lengths) forwards."""
    *_, start, want = rawnet_pair
    model = DPRNNRawNetTasNet(**RAW_SMALL)
    model.load_state_dict(start, strict=True)
    _check_forward(model.eval(), batches["raw"], want)


def test_rawnet_train_step_matches_jax(batches, rawnet_pair, tmp_path):
    """One TrainerRawNet step. In training mode RawNet3's fp32 embedding is
    ill-conditioned: its front end takes the log of the sinc filterbank's
    magnitude, a filter output near zero turns an fp32 rounding into a
    percent, and the batch statistics carry it to every row (on this batch
    the port's fp32 embedding is 2.7e-3 from its float64 one, eager JAX's
    6.4e-3 and jitted JAX's 3.3e-2, of 1.55), and its parameters' fp32
    gradients differ from the float64 ones by up to 51 % of a tensor's max
    (scripts/port/fp32_conditioning.py).
    So the step runs on one fixed embedding on both sides (RawNet3 runs and
    takes its gradient, its output replaced in value), and the loss is held
    within 1e-5 relative and every gradient outside the embedder within
    1e-4 of its tensor's max. The embedder itself is held in float64 in
    training mode (the next test), where its gradients are autograd's
    derivatives of that forward."""
    *_, start, want = rawnet_pair
    model = DPRNNRawNetTasNet(**RAW_SMALL)
    model.load_state_dict(start, strict=True)
    tr = TrainerRawNet(model, dict(TRAIN_CONFIG, new_checkpoints_path=str(tmp_path)),
                       device="cpu")
    tr.model.train()
    hook = model.separation.spk_encoder.register_forward_hook(
        lambda module, args, out: out + (want["embedding"] - out).detach())
    loss, _ = tr._forward_loss(tr._to_device(batches["raw_train"]), train=True)
    loss.backward()
    hook.remove()
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-5)
    want_grads = state_dict_from_jax(want["grads"], "ln", 2, "att")
    for k, p in model.named_parameters():
        if k.startswith("separation.spk_encoder."):
            assert (p.grad is None) == (".bn1." in k and "layer" not in k), k
            continue
        w = want_grads[k]
        assert float(w.abs().max()) > 0, k  # every parameter takes part in the loss
        torch.testing.assert_close(p.grad, w, atol=1e-4 * float(w.abs().max()), rtol=0, msg=k)


@pytest.mark.parametrize("mode", ["eval_exact", "eval_masked", "train_masked"])
def test_rawnet_embedder_float64_matches_jax(batches, rawnet_pair, monkeypatch, mode):
    """RawNet3 alone against the JAX embedder, both in float64, where the
    front end's conditioning costs nothing (in fp32 the log of a sinc
    output near zero turns a rounding into 2e-3 of the embedding, see
    :func:`test_rawnet_train_step_matches_jax`): unmasked on references of
    one length, and on ragged references with their lengths, in eval and
    in training mode. The embedding within 1e-9 of its max and, in
    training, the running statistics after the forward within 1e-9. JAX
    runs eagerly (its fused float64 program is not exact),
    and its convolutions, which accumulate in float32 by request, through
    ``lax.conv`` in float64. In fp32, each masked row equals the port's
    run of that reference alone."""
    import jax
    from jax import lax

    import tss_dprnn_tpu.models.rawnet as jax_rawnet

    def conv1d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        out = lax.conv_general_dilated(x, w.astype(x.dtype), (stride,), [(padding, padding)],
                                       rhs_dilation=(dilation,),
                                       dimension_numbers=("NCH", "OIH", "NCH"),
                                       feature_group_count=groups,
                                       precision=lax.Precision.HIGHEST)
        return out if b is None else out + b.astype(x.dtype)[None, :, None]

    monkeypatch.setattr(jax_rawnet, "conv1d", conv1d)
    _, variables, start, _ = rawnet_pair
    train, masked = mode.startswith("train"), mode.endswith("masked")
    bt = batches["raw" if masked else "raw_train"]
    ref = bt["reference"].astype(np.float64)
    ref_len = bt["ref_len"] if masked else None
    jemb = jax_rawnet.RawNet3(model_scale=4, C=32, nOut=SMALL["embeddings_size"],
                              sinc_stride=16)
    jvars = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64),
        {"params": variables["params"]["separation"]["spk_encoder"],
         "batch_stats": variables["batch_stats"]["separation"]["spk_encoder"]})
    with jax.enable_x64(True):
        want_e, upd = jemb.apply(jvars, ref, None if ref_len is None else
                                 ref_len.astype(np.float64), train=train,
                                 mutable=["batch_stats"])
        want_e, stats = np.asarray(want_e), _numpy_tree(upd.get("batch_stats", {}))
    assert want_e.dtype == np.float64
    emb = _port_rawnet3(start).double().train(train)
    with torch.no_grad():
        e = emb(torch.from_numpy(ref), None if ref_len is None else torch.from_numpy(ref_len))
    torch.testing.assert_close(e, torch.from_numpy(want_e),
                               atol=1e-9 * float(np.abs(want_e).max()), rtol=0)
    if train:
        out = {}
        weights._rawnet_entries(out, "e", jvars["params"], stats, 251, 16000.0)
        for k, v in emb.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                torch.testing.assert_close(v, torch.from_numpy(np.asarray(out["e." + k],
                                                                          np.float64)),
                                           atol=1e-9, rtol=0, msg=k)
    if masked and not train:
        emb32 = _port_rawnet3(start).eval()
        with torch.inference_mode():
            got = emb32(torch.from_numpy(bt["reference"]), torch.from_numpy(ref_len))
            for b, n in enumerate(ref_len.astype(int)):
                alone = emb32(torch.from_numpy(bt["reference"][b:b + 1, :n]))
                torch.testing.assert_close(got[b:b + 1], alone, atol=1e-5, rtol=0)


def test_trainer_rawnet_resamples_demo_references(batches, rawnet_pair, tmp_path):
    """The demo mixtures come from the eval set at 8 kHz. The JAX trainer
    hands their references to the 16 kHz embedder as they are; the port
    resamples them to 16 kHz first, as the reference trainer does."""
    from tss_dprnn_tpu_torch.data.resample import resample

    *_, start, _ = rawnet_pair
    model = DPRNNRawNetTasNet(**RAW_SMALL)
    model.load_state_dict(start, strict=True)
    tr = TrainerRawNet(model, dict(TRAIN_CONFIG, new_checkpoints_path=str(tmp_path)),
                       device="cpu")
    rng = np.random.default_rng(4)
    item = {"mix": rng.standard_normal(400).astype(np.float32),
            "reference": rng.standard_normal(1500).astype(np.float32)}
    tr.model.eval()
    with torch.no_grad():
        got = tr._estimate_mixture(dict(item))["estimated"]
        ref16 = torch.from_numpy(resample(item["reference"], 8000, 16000))[None]
        want, _ = tr.model(torch.from_numpy(item["mix"])[None], ref16,
                           torch.tensor([float(ref16.shape[1])]))
        as_is, _ = tr.model(torch.from_numpy(item["mix"])[None],
                            torch.from_numpy(item["reference"])[None], torch.tensor([1500.0]))
    assert ref16.shape[1] == 3000
    np.testing.assert_array_equal(got, want[0].numpy())
    assert not np.allclose(got, as_is[0].numpy())


# ---------------------------------------------------- the reference oracle

@pytest.mark.parametrize("family", ["ira", "rawnet"])
def test_matches_torch_oracle(rng, family):
    """The port loaded with the oracle's reference-format state_dict against
    the oracle's forward on the unpadded batch (RawNet's logits plus three
    times the embedder's fp32 floor)."""
    import copy

    from tests.torch_oracle import (Cfg, RawCfg, make_rawnet_model_sd, make_spe_sd, oracle_ira,
                                    oracle_rawnet)

    cfg = Cfg(fusion_type="att", n_repeats=1)
    kw = dict(input_size=cfg.input_size, feature_size=cfg.feature_size,
              hidden_size=cfg.hidden_size, chunk_length=cfg.chunk_length,
              hop_length=cfg.hop_length, kernel_size=cfg.kernel_size, n_repeats=cfg.n_repeats,
              norm_type=cfg.norm_type, O=cfg.O, P=cfg.P, embeddings_size=cfg.embeddings_size,
              num_spks=cfg.num_spks, fusion_type="att")
    mix = torch.from_numpy(rng.standard_normal((2, 800)).astype(np.float32))
    if family == "ira":
        sd = make_spe_sd(cfg, seed=3, ira=True)
        aux = torch.from_numpy(rng.standard_normal((2, 700)).astype(np.float32))
        aux_len = torch.full((2,), 700.0)
        want_wav, want_logits = oracle_ira(sd, cfg, mix, aux, aux_len)
        model = DPRNNSpeIRATasNet(**kw)
    else:
        rcfg = RawCfg(C=32, model_scale=4, nOut=cfg.embeddings_size)
        sd = make_rawnet_model_sd(cfg, rcfg, seed=3)
        bank = RawNet3(32, 4).conv1.filterbank  # the frozen tensors the oracle leaves out
        for name in ("window_", "n_"):
            sd[f"separation.spk_encoder.conv1.filterbank.{name}"] = getattr(bank, name)
        aux = torch.from_numpy(rng.standard_normal((2, 6000)).astype(np.float32))
        aux_len = torch.full((2,), 6000.0)
        want_wav, want_logits = oracle_rawnet(sd, cfg, rcfg, mix, aux)
        model = DPRNNRawNetTasNet(**kw, rawnet_C=32, rawnet_scale=4, rawnet_sinc_stride=16)
    model.load_state_dict(sd, strict=True)
    floor = 0.0
    with torch.inference_mode():
        wav, logits = model.eval()(mix, aux, aux_len)
        if family == "rawnet":  # RawNet3's fp32 floor: its distance from a float64 copy
            sep = copy.deepcopy(model.separation).double()
            logits64 = sep.pred_linear(sep.spk_encoder(aux.double(), aux_len))
            floor = float((logits.double() - logits64).abs().max())
    torch.testing.assert_close(logits, want_logits, atol=1e-4 + 3 * floor, rtol=0)
    for b in range(2):
        assert _snr_db(wav[b].numpy(), want_wav[b].detach().numpy()) >= 60.0


# ----------------------------------------------------------- plain pieces

def test_sinc_filters_and_mel_bands_match_jax():
    from tss_dprnn_tpu.ops import sinc as jsinc
    from tss_dprnn_tpu_torch.ops import sinc

    for n_band, sr in ((4, 16000.0), (128, 16000.0), (16, 8000.0)):
        low, band = sinc.mel_init_bands(n_band, sr)
        jlow, jband = jsinc.mel_init_bands(n_band, sr)
        np.testing.assert_array_equal(low, jlow)
        np.testing.assert_array_equal(band, jband)
        scale = np.random.default_rng(n_band).uniform(0.9, 1.1, low.shape).astype(np.float32)
        want = np.asarray(jsinc.sinc_filters(low * scale, band, 251, sr))
        got = sinc.sinc_filters(torch.from_numpy(low * scale), torch.from_numpy(band), 251, sr)
        assert got.shape == (2 * n_band, 1, 251) and got.dtype == torch.float32
        # fp32 rounding: an ulp of sin or cos (the two libraries') divided
        # by n / 2 = pi n / sample_rate next to the centre tap, then by 2 band
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_resampling_collates_match_jax(kind):
    from tss_dprnn_tpu.data import loader as jloader

    rng = np.random.default_rng(6)
    items = [(rng.standard_normal(300).astype(np.float32),
              rng.standard_normal(300).astype(np.float32),
              rng.standard_normal(n).astype(np.float32), i) for i, n in enumerate((1700, 2301))]
    for to in (None, 16000):
        if kind == "train":
            got = loader.collate_spe(items, resample_ref_to=to)
            want = jloader.collate_spe(items, resample_ref_to=to)
        else:
            got = loader.make_collate_spe_eval(resample_ref_to=to, sample_rate=8000)(items, 400)
            want = jloader.make_collate_spe_eval(resample_ref_to=to, sample_rate=8000)(items, 400)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["ref_len"].tolist() == ([1700, 2301] if to is None else [3400, 4602])


@pytest.mark.parametrize("op", ["avg_pool1d_exact", "max_pool1d"])
def test_pools_match_jax(rng, op):
    from tss_dprnn_tpu.ops import conv as jconv
    from tss_dprnn_tpu_torch.ops import conv

    x = rng.standard_normal((2, 3, 17)).astype(np.float32)
    for k in (1, 2, 5):
        got = getattr(conv, op)(torch.from_numpy(x), k).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jconv, op)(x, k)), atol=1e-6, rtol=0)
        assert got.shape == (2, 3, 17 // k)


@pytest.mark.parametrize("op", ["masked_mean_var", "z_norm", "glob_ln", "chan_ln",
                                "global_channel_norm"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_norms_match_jax(rng, op, masked):
    import jax.numpy as jnp

    from tss_dprnn_tpu.ops import norms as jnorms
    from tss_dprnn_tpu_torch.ops import norms

    x = rng.standard_normal((3, 4, 11)).astype(np.float32)
    gamma, beta = (rng.standard_normal(4).astype(np.float32) for _ in range(2))
    mask = (np.arange(11)[None, None, :] < np.array([11, 6, 1])[:, None, None]).astype(
        np.float32) if masked else None
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    if op in ("masked_mean_var", "z_norm"):
        got = getattr(norms, op)(torch.from_numpy(x), (1, 2), mask=tm)
        want = getattr(jnorms, op)(jnp.asarray(x), (1, 2), mask=jm)
    elif op == "global_channel_norm":
        got = norms.global_channel_norm(torch.from_numpy(x), torch.from_numpy(gamma),
                                        torch.from_numpy(beta), 1e-5, tm)
        want = jnorms.global_channel_norm(jnp.asarray(x), gamma, beta, 1e-5, jm)
    else:
        got = getattr(norms, op)(torch.from_numpy(x), torch.from_numpy(gamma),
                                 torch.from_numpy(beta), tm)
        want = getattr(jnorms, op)(jnp.asarray(x), gamma, beta, jm)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------- on the card

@pytest.mark.cuda
def test_ira_train_step_checkpointed_on_card(tmp_path):
    """An IRA train step on the card with pass 1 checkpointed and without:
    the checkpointed blocks run their residual forwards again in the
    backward (3 n + 3 n launches against 2 n + 2 n, 2 n + 2 n backward
    either way); the losses equal bit for bit, the gradients within the
    kernels' determinism; both against the CPU step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the card's run is compared with the CPU's")
    rng = np.random.default_rng(12)
    items = [(rng.standard_normal(2000).astype(np.float32),
              rng.standard_normal(2000).astype(np.float32),
              rng.standard_normal(1500).astype(np.float32), i) for i in range(2)]
    batch = loader.collate_spe(items)
    start = init_weights_(DPRNNSpeIRATasNet(**SMALL), torch.Generator().manual_seed(7)
                          ).state_dict()
    n = SMALL["n_repeats"]
    steps = {}
    for device, pass1_remat in (("cuda", None), ("cuda", 0), ("cpu", None)):
        tr = TrainerSpe(_ira(0, start, pass1_remat), dict(TRAIN_CONFIG, new_checkpoints_path=str(
            tmp_path)), device=device)
        tr.model.train()
        bilstm2.reset_launch_counts()
        loss, _ = tr._forward_loss(tr._to_device(batch), train=True)
        loss.backward()
        resid = bilstm2.bilstm2_forward_resid.launches
        bwd = bilstm2.bilstm2_backward.launches
        if device == "cuda":
            assert (resid, bwd) == ((6 if pass1_remat is None else 4) * n, 4 * n)
        steps[(device, pass1_remat)] = (loss.item(), torch.cat(
            [p.grad.detach().cpu().flatten() for _, p in sorted(tr.model.named_parameters())]))
    (l_r, g_r), (l_0, g_0), (l_c, g_c) = steps.values()
    assert l_r == l_0
    torch.testing.assert_close(g_r, g_0, atol=1e-6 * float(g_0.abs().max()), rtol=0)
    assert abs(l_r - l_c) <= 1e-4 * abs(l_c)
    assert _snr_db(g_r.double().numpy(), g_c.double().numpy()) >= 40.0
