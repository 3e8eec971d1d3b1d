"""The port's long-audio separation and single-file CLI against the JAX
package's (``tss_dprnn_tpu_torch/inference/long_audio.py``,
``tss_dprnn_tpu_torch/cli/separate.py``).

- The numpy helpers and ``WindowedSeparator`` equal JAX's exactly on the
  same forward callables (the cases of ``tests/test_long_audio.py``).
- ``bss_windowed`` / ``spe_windowed`` with JAX-initialised weights
  (``utils/weights.state_dict_from_jax``) against JAX's on its 'xla'
  backend: >= 60 dB (the port's fidelity bar for a model); with the int16
  wire, within one int16 step of the window's scale.
- ``cli.separate``, port against the JAX CLI on one checkpoint (a ``.pt``
  for the port, orbax for JAX): BSS full length, TSS windowed, RawNet with
  its 8 kHz reference resampled to 16 kHz; the WAVs' PCM within 1 LSB. The
  CLIs' error cases raise alike.
"""

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch.cli import separate as separate_cli
from tss_dprnn_tpu_torch.data import wav
from tss_dprnn_tpu_torch.inference import long_audio
from tss_dprnn_tpu_torch.models.registry import build_model
from tss_dprnn_tpu_torch.utils.weights import init_weights_, state_dict_from_jax

SR = 8000
# the port's widths are padded to 16 on the card only: on the CPU these run as
# they are (small chunks keep the plain scans short)
SMALL = dict(input_size=8, feature_size=12, hidden_size=10, chunk_length=8, kernel_size=2,
             hop_length=4, n_repeats=1, norm_type="ln")
SMALL_SPE = dict(SMALL, O=8, P=12, embeddings_size=8, num_spks=8, fusion_type="att")
SMALL_RAWNET = dict(SMALL, embeddings_size=8, num_spks=8, fusion_type="att", rawnet_C=32,
                    rawnet_scale=4, rawnet_sinc_stride=16)
MODEL_SNR_DB = 60.0
LSB = 1.0 / 32768


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module (see test_torch_port_config_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noise(T, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(T)).astype(np.float32)


def _snr_db(got, want):
    return 10 * np.log10(np.sum(want.astype(np.float64) ** 2)
                         / max(np.sum((got.astype(np.float64) - want) ** 2), 1e-300))


# ------------------------------------------------------------ numpy helpers

def test_crossfade_and_permutation_equal_jax():
    from tss_dprnn_tpu.inference import long_audio as jla

    for window, overlap in [(100, 30), (1024, 512), (7, 0), (5, 4)]:
        got = long_audio._crossfade_weight(window, overlap)
        want = jla._crossfade_weight(window, overlap)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    rng = np.random.default_rng(0)
    for n in (1, 2, 3):
        prev, cur = rng.standard_normal((2, n, 50))
        cur = cur[::-1] + 0.1 * prev[::-1]
        assert long_audio._best_permutation(prev, cur) == jla._best_permutation(prev, cur)


def _flipping():
    """test_long_audio's forward that flips its source order on every other
    call, with a call count of its own."""
    calls = {"n": 0}

    def fwd(x):
        est = np.stack([x, -x], axis=1)
        if calls["n"] % 2 == 1:
            est = est[:, ::-1]
        calls["n"] += 1
        return est
    return fwd


@pytest.mark.parametrize("case", [
    "stitch-1024-512", "stitch-1024-1000", "stitch-1000-333", "stitch-4096-2048",
    "stitch-8192-4096", "single-window", "permutation", "permutation-unaligned", "ragged-tail"])
def test_windowed_separator_equals_jax(case):
    """The port's separator and JAX's, each on the same forward, give the
    same array bit for bit (and the same forward calls)."""
    from tss_dprnn_tpu.inference import long_audio as jla

    kind = case.split("-")[0]
    align = case != "permutation-unaligned"
    if kind == "stitch":
        window, hop = map(int, case.split("-")[1:])
        args, mix, batch = (window, hop), _noise(4096), 3
        make = lambda: lambda x: np.stack([x, -0.5 * x], axis=1)  # noqa: E731
    elif kind == "single":
        args, mix, batch = (1024,), _noise(700, 1), 2
        make = lambda: lambda x: np.stack([np.tanh(x), x ** 2], axis=1)  # noqa: E731
    elif kind == "permutation":
        args, mix, batch = (1024, 512), _noise(6000, 2), 1
        make = _flipping
    else:
        args, mix, batch = (1024, 512), _noise(5000, 3), 4
        make = lambda: lambda x: np.stack([x, x], axis=1)  # noqa: E731
    outs, shapes = [], []
    for cls in (long_audio.WindowedSeparator, jla.WindowedSeparator):
        fwd = make()
        seen = []
        sep = cls(lambda x, fwd=fwd, seen=seen: seen.append(x.shape) or fwd(x), *args,
                  batch_size=batch, align_sources=align)
        outs.append(sep(mix))
        shapes.append(seen)
    assert outs[0].dtype == outs[1].dtype and np.array_equal(outs[0], outs[1])
    assert shapes[0] == shapes[1] and all(s == (batch, args[0]) for s in shapes[0])
    assert outs[0].shape == (2, len(mix))


@pytest.mark.parametrize("args,mix", [((100,), np.zeros(100)), ((100, 0), np.zeros(100)),
                                      ((100, 101), np.zeros(100)), ((100,), np.zeros((2, 100)))])
def test_rejects_bad_args_as_jax(args, mix):
    from tss_dprnn_tpu.inference import long_audio as jla

    def fwd(x):
        return np.stack([x], axis=1)

    errors = []
    for cls in (long_audio.WindowedSeparator, jla.WindowedSeparator):
        try:
            out = cls(fwd, *args)(mix.astype(np.float32))
            errors.append(out.shape)
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]


# ------------------------------------------------------- model-backed helpers

# mode -> the registry config both packages build
FAMILIES = {
    "bss": dict(SMALL, target="dprnn_tasnet"),
    "tss_spe": dict(SMALL_SPE, target="dprnn_spe_tasnet"),
    "tss_rawnet": dict(SMALL_RAWNET, target="dprnn_rawnet_tasnet"),
}


class _KnownInit:
    """A JAX model whose ``init`` gives the variables the ``models`` fixture
    built once for its family: the JAX CLIs' eager init compiles each
    primitive apart (~14 s a model here; jitted, 1-2 s each call) only to
    make the tree the checkpoint's values are restored into, and the
    fixture's tree has that structure."""

    def __init__(self, model, variables):
        self._model = model
        self._variables = variables

    def init(self, *args, **kwargs):
        import jax
        import jax.numpy as jnp

        return jax.tree_util.tree_map(jnp.asarray, self._variables)

    def __getattr__(self, name):
        return getattr(self._model, name)


@pytest.fixture(scope="module")
def models():
    """Per mode: (JAX model, its variables, the port's model in eval mode),
    on one set of weights: the port's, drawn from a seed, carried to JAX by
    the JAX package's ``utils/torch_convert.convert_state_dict`` (JAX's own
    init compiles for seconds a model) and back by the port's
    ``state_dict_from_jax`` (the LSTM biases come back summed)."""
    from tss_dprnn_tpu.models.registry import build_model as jbuild
    from tss_dprnn_tpu.utils.torch_convert import convert_state_dict

    out = {}
    for seed, (mode, cfg) in enumerate(FAMILIES.items()):
        seeded = init_weights_(build_model(dict(cfg)), torch.Generator().manual_seed(seed))
        variables = convert_state_dict(seeded.state_dict())
        port = build_model(dict(cfg))
        port.load_state_dict(state_dict_from_jax(variables, "ln", 2, "att"), strict=True)
        out[mode] = (jbuild(dict(cfg)), variables, port.eval())
    return out


def test_bss_windowed_equals_jax(models):
    """Exact fp32 path (the port's default) and the int16 wire, each against
    JAX's at the same window, hop and batch."""
    from tss_dprnn_tpu.inference import long_audio as jla

    jmodel, variables, port = models["bss"]
    W, T = 800, 2300
    mix = _noise(T, 4, 0.3)
    got = long_audio.bss_windowed(port, window=W, batch_size=2, device="cpu")(mix)
    want = jla.bss_windowed(jmodel, variables, window=W, batch_size=2, lstm_backend="xla",
                            wire=False)(mix)
    assert got.shape == want.shape == (2, T)
    for j in range(2):
        assert _snr_db(got[j], want[j]) >= MODEL_SNR_DB
    peaks = []
    sep = long_audio.bss_windowed(port, window=W, batch_size=2, device="cpu", wire=True)
    fwd = sep.forward
    sep.forward = lambda x: peaks.append(np.abs(out := fwd(x)).max()) or out
    got_wire = sep(mix)
    want_wire = jla.bss_windowed(jmodel, variables, window=W, batch_size=2,
                                 lstm_backend="xla", wire=True)(mix)
    # a decoded window row's peak is its own peak: one int16 step is peak / 32767
    step = max(peaks) / 32767
    assert np.abs(got_wire - want_wire).max() <= step * (1 + 1e-5)
    assert np.abs(got_wire - got).max() <= step * (1 + 1e-5)


def test_spe_windowed_equals_jax(models):
    from tss_dprnn_tpu.inference import long_audio as jla

    jmodel, variables, port = models["tss_spe"]
    W, T = 800, 1900
    ref, mix = _noise(600, 5, 0.3), _noise(T, 6, 0.3)
    got = long_audio.spe_windowed(port, ref, window=W, batch_size=2, device="cpu")(mix)
    want = jla.spe_windowed(jmodel, variables, ref, window=W, batch_size=2,
                            lstm_backend="xla")(mix)
    assert got.shape == want.shape == (1, T)
    assert _snr_db(got[0], want[0]) >= MODEL_SNR_DB


def test_one_window_equals_the_forward(models):
    """An input of one window or less, with a hop of one window (weight 1),
    is the model's forward on the zero-padded window, bit for bit."""
    _, _, port = models["bss"]
    W = 800
    for T in (W, 613):
        mix = _noise(T, 7, 0.3)
        got = long_audio.bss_windowed(port, window=W, hop=W, batch_size=1, device="cpu")(mix)
        padded = np.zeros((1, W), np.float32)
        padded[0, :T] = mix
        with torch.inference_mode():
            want = port(torch.from_numpy(padded))[0, :, :T].numpy()
        assert np.array_equal(got, want)


def test_helpers_run_on_the_card_by_default(models):
    """Without ``device`` the helpers run on the card, or raise without one."""
    _, _, port = models["bss"]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is fine")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        long_audio.bss_windowed(port, window=800)


# ------------------------------------------------------------- cli.separate

def _config(path, model_cfg, ckpt):
    """A config both packages' readers take (block mappings only)."""
    lines = ["name: s", "is_test: true", "data:", f"  sample_rate: {SR}", "model:"]
    lines += [f"  {k}: {v}" for k, v in model_cfg.items()]
    lines.append(f"checkpoint_path: {ckpt}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, models):
    """Per mode: (the JAX package's config, the port's config) on one set of
    weights, saved as orbax for JAX and as ``.pt`` for the port."""
    from tss_dprnn_tpu.utils.checkpoint import CheckpointManager, to_pure_tree

    tmp = tmp_path_factory.mktemp("separate")
    out = {}
    for mode, cfg in FAMILIES.items():
        _, variables, port = models[mode]
        variables = {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})}
        ck = CheckpointManager(str(tmp / f"ck_{mode}"))
        jckpt = ck.save(1, {"epoch": 1, "params": to_pure_tree(variables["params"]),
                            "batch_stats": to_pure_tree(variables.get("batch_stats", {}))},
                        best=True)
        pt = tmp / f"{mode}.pt"
        torch.save(port.state_dict(), pt)
        out[mode] = (_config(tmp / f"{mode}_jax.yaml", cfg, jckpt),
                     _config(tmp / f"{mode}_port.yaml", cfg, pt))
    wav.write(str(tmp / "mix.wav"), _noise(int(1.3 * SR), 8, 0.3), SR)
    wav.write(str(tmp / "ref.wav"), _noise(int(0.6 * SR), 9, 0.3), SR)  # 8 kHz, RawNet too
    out["tmp"] = tmp
    return out


@pytest.mark.parametrize("mode,extra", [
    ("bss", []),
    ("tss_spe", ["--window-secs", "0.25", "--batch", "2"]),
    ("tss_rawnet", []),
])
def test_cli_separate_equals_jax_cli(models, checkpoints, mode, extra, monkeypatch):
    """BSS full length (two files), TSS windowed, RawNet with its reference
    resampled to 16 kHz: the same files, PCM within 1 LSB."""
    from tss_dprnn_tpu.cli import separate as jseparate

    build = jseparate.build_model
    monkeypatch.setattr(jseparate, "build_model",
                        lambda cfg: _KnownInit(build(cfg), models[mode][1]))

    tmp = checkpoints["tmp"]
    jcfg, pcfg = checkpoints[mode]
    common = ["--mode", mode, "--mix", str(tmp / "mix.wav")]
    if mode != "bss":
        common += ["--ref", str(tmp / "ref.wav")]
    separate_cli.main(["--config", pcfg, *common, "--out", str(tmp / f"{mode}_port.wav"),
                       "--device", "cpu", *extra])
    jseparate.main(["--config", jcfg, *common, "--out", str(tmp / f"{mode}_jax.wav"), *extra])
    names = ["_s1", "_s2"] if mode == "bss" else [""]
    mix, _ = wav.read(str(tmp / "mix.wav"))
    for sfx in names:
        got, rate = wav.read(str(tmp / f"{mode}_port{sfx}.wav"))
        want, jrate = wav.read(str(tmp / f"{mode}_jax{sfx}.wav"))
        assert rate == jrate == SR and got.shape == want.shape == mix.shape
        assert np.isfinite(got).all() and np.abs(got).max() > 0
        assert np.abs(got - want).max() <= LSB * (1 + 1e-6)


@pytest.mark.parametrize("case", ["no_ref", "rate", "no_checkpoint"])
def test_cli_separate_errors_as_jax(checkpoints, case):
    """--ref missing for a TSS mode, a mixture at another rate and a config
    without checkpoint_path raise alike in both CLIs."""
    from tss_dprnn_tpu.cli import separate as jseparate

    tmp = checkpoints["tmp"]
    mix = str(tmp / "mix.wav")
    if case == "rate":
        mix = str(tmp / "mix16k.wav")
        wav.write(mix, _noise(1600, 10, 0.3), 16000)
    messages = []
    for main, cfg, extra in ((separate_cli.main, checkpoints["tss_spe"][1], ["--device", "cpu"]),
                             (jseparate.main, checkpoints["tss_spe"][0], [])):
        argv = ["--config", cfg, "--mode", "tss_spe", "--mix", mix, "--out",
                str(tmp / "x.wav"), *extra]
        if case != "no_ref":
            argv += ["--ref", str(tmp / "ref.wav")]
        if case == "no_checkpoint":
            argv += ["--set", "checkpoint_path=null"]
        with pytest.raises(ValueError) as err:
            main(argv)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_cli_separate_refuses_an_orbax_directory(checkpoints, tmp_path):
    """The port loads .pt files; the JAX package's orbax checkpoint raises
    and says how to convert it."""
    jcfg, _ = checkpoints["bss"]
    with pytest.raises(ValueError, match="orbax"):
        separate_cli.main(["--config", jcfg, "--mode", "bss", "--mix",
                           str(checkpoints["tmp"] / "mix.wav"), "--out", str(tmp_path / "o.wav"),
                           "--device", "cpu"])
