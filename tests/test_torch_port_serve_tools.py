"""The port's serving tools against the JAX package's: ``cli.results_table``,
the serving entries as torch operators, and the serving export
(``tss_dprnn_tpu_torch/inference/export.py``, ``cli/export_model.py``).

- ``results_table``: labels, rendered tables and the CLI's output equal
  JAX's, strings for strings.
- The five serving entries (``bilstm2_forward``, ``_masked``, ``_bm``,
  ``bilstm2_dense_forward``, ``lstm_forward``) pass
  ``torch.library.opcheck`` and give their plain versions' outputs bit for
  bit through the operator (what they gave before they became operators).
- A CPU artifact (BSS and TSS, a request smaller than its bucket in batch
  and time) equals the eager port on the same padding bit for bit, and
  reads >= 60 dB against JAX's ``ServingModel`` on the same weights; the
  exported graph holds one operator call per scan and no other.
- The export CLI end to end, its version and "no bucket fits" errors, a JAX
  artifact refused, and ``--backend xla`` (plain PyTorch ops, hermetic) at
  the smallest shape.
- On the card (``cuda``): the card artifact equals the eager forward bit for
  bit and launches the serving kernels.
"""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch.cli import export_model
from tss_dprnn_tpu_torch.cli import results_table as rt
from tss_dprnn_tpu_torch.inference import export
from tss_dprnn_tpu_torch.models.registry import build_model
from tss_dprnn_tpu_torch.ops import bilstm2 as B
from tss_dprnn_tpu_torch.ops import lstm as L
from tss_dprnn_tpu_torch.utils.weights import init_weights_, state_dict_from_jax

SR = 8000
SMALL = dict(input_size=8, feature_size=12, hidden_size=10, chunk_length=8, kernel_size=2,
             hop_length=4, n_repeats=1, norm_type="ln")
SMALL_SPE = dict(SMALL, O=8, P=12, embeddings_size=8, num_spks=8, fusion_type="att")
MODEL_SNR_DB = 60.0
OPS = torch.ops.tss_dprnn_tpu_torch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module (see test_torch_port_config_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _snr_db(got, want):
    return 10 * np.log10(np.sum(want.astype(np.float64) ** 2)
                         / max(np.sum((got.astype(np.float64) - want) ** 2), 1e-300))


# ------------------------------------------------------------ results_table

def _write(path, payload):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def test_results_table_equals_jax(tmp_path, capsys, monkeypatch):
    """The cases of tests/test_results_table.py through both modules: the
    same labels, rows, rendered tables and CLI output."""
    from tss_dprnn_tpu.cli import results_table as jrt

    root = str(tmp_path / "metrics")
    _write(os.path.join(root, "dprnn-tasnet/final_metrics.json"),
           {"si_sdr": 15.76, "pesq": 3.15, "stoi": 0.939})
    _write(os.path.join(root, "dprnn-spe/final_metrics_FiLM.json"),
           {"si_sdr": 12.97, "pesq": 2.97, "stoi": 0.891})
    ours = [
        _write(str(tmp_path / "out/dprnn-tasnet/final_metrics.json"),
               {"si_sdr": 15.9, "si_sdr_imp": 15.8, "pesq": 3.1, "stoi": 0.94}),
        _write(str(tmp_path / "out/dprnn-spe/final_metrics_FiLM.json"),
               {"si_sdr": 13.5, "si_sdr_imp": 13.4, "pesq": None, "stoi": 0.9}),
        _write(str(tmp_path / "out/dprnn-spe/final_metrics_attention.json"), {}),
    ]
    assert [rt._label(p) for p in ours] == [jrt._label(p) for p in ours]
    assert rt.load_rows(ours) == jrt.load_rows(ours)
    assert rt.reference_rows(root) == jrt.reference_rows(root)
    refs = rt.reference_rows(root)
    assert rt.render(rt.load_rows(ours), reference_rows=refs) == jrt.render(
        jrt.load_rows(ours), reference_rows=refs)
    assert rt.reference_rows(str(tmp_path / "absent")) == []
    outputs = []
    for mod in (rt, jrt):
        monkeypatch.setattr(mod, "REFERENCE_METRICS", root)
        for argv in (["--compare-reference", *ours], ours, ["--reference", ours[0]], []):
            assert mod.main(argv) == 0
            outputs.append(capsys.readouterr().out)
    assert outputs[:4] == outputs[4:]
    assert "| ↳ Δ vs reference | +0.14 | — | -0.05 | +0.00 |" in outputs[0]


# ------------------------------------------------------- the serving operators

def _pair_inputs(dtype, masked=False, Fo=None):
    g = torch.Generator().manual_seed(11)
    B_, T, F, H = 3, 7, 12, 10
    x = torch.randn(B_, T, F, generator=g).to(dtype)
    w = [torch.randn(2, F, 4 * H, generator=g) * 0.3, torch.randn(2, 4 * H, generator=g) * 0.1,
         torch.randn(2, H, 4 * H, generator=g) * 0.3]
    if masked:
        return (x, torch.tensor([7, 3, 0], dtype=torch.int32), *w)
    if Fo:
        return (x, *w, torch.randn(2, H, Fo, generator=g) * 0.3)
    return (x, *w)


def _stack_inputs(dtype):
    g = torch.Generator().manual_seed(12)
    D, R, T, F, H = 2, 3, 6, 12, 10
    return (torch.randn(D, R, T, F, generator=g).to(dtype),
            torch.randn(D, F, 4 * H, generator=g) * 0.3, torch.randn(D, 4 * H, generator=g) * 0.1,
            torch.randn(D, H, 4 * H, generator=g) * 0.3)


# (entry, its operator, inputs, its plain version as the parent tree ran it on the CPU)
CASES = {
    "bilstm2_forward": (B.bilstm2_forward, OPS.bilstm2_forward, _pair_inputs,
                        B.bilstm2_reference),
    "bilstm2_forward_masked": (
        B.bilstm2_forward_masked, OPS.bilstm2_forward_masked,
        lambda dt: _pair_inputs(dt, masked=True),
        lambda x, lens, *w: B.bilstm2_reference(x, *w, lens)),
    "bilstm2_forward_bm": (B.bilstm2_forward_bm, OPS.bilstm2_forward_bm, _pair_inputs,
                           B.bilstm2_bm_reference),
    "bilstm2_dense_forward": (B.bilstm2_dense_forward, OPS.bilstm2_dense_forward,
                              lambda dt: _pair_inputs(dt, Fo=6), B.bilstm2_dense_reference),
    "lstm_forward": (L.lstm_forward, OPS.lstm_forward, _stack_inputs, L.lstm_reference),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_serving_operator_passes_opcheck(name, dtype):
    """opcheck (schema, autograd registration, the fake against the real
    outputs, AOT dispatch); the entry's outputs are its plain version's bit
    for bit, and none aliases an input or another output."""
    entry, op, inputs, plain = CASES[name]
    args = inputs(dtype)
    torch.library.opcheck(op.default, args)
    got, want = entry(*args), plain(*args)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ptrs = [t.untyped_storage().data_ptr() for t in (*got, *args)]
    assert len(set(ptrs)) == len(ptrs)
    assert op.default.name() == f"{B.OPS_NAMESPACE}::{name}"


# ----------------------------------------------------------------- artifacts

@pytest.fixture(scope="module")
def pair():
    """Per family: (JAX model, its variables, the port's model with those
    weights), one set of seeded weights (the port's, carried to JAX by the
    JAX package's converter and back by ``state_dict_from_jax``)."""
    from tss_dprnn_tpu.models import DPRNNSpeTasNet as JSpe
    from tss_dprnn_tpu.models import DPRNNTasNet as JBss
    from tss_dprnn_tpu.utils.torch_convert import convert_state_dict

    out = {}
    for seed, (name, jcls, cfg, target) in enumerate((
            ("bss", JBss, SMALL, "dprnn_tasnet"),
            ("spe", JSpe, SMALL_SPE, "dprnn_spe_tasnet"))):
        seeded = init_weights_(build_model(dict(cfg, target=target)),
                               torch.Generator().manual_seed(seed))
        variables = convert_state_dict(seeded.state_dict())
        port = build_model(dict(cfg, target=target))
        port.load_state_dict(state_dict_from_jax(variables, "ln", 2, "att"), strict=True)
        out[name] = (jcls(**cfg), variables, port.eval())
    return out


def _eager(model, args):
    with torch.inference_mode():
        out = model(*map(torch.from_numpy, args[:-1]), lengths=torch.from_numpy(args[-1]))
    return (out[0] if isinstance(out, tuple) else out).numpy()


@pytest.mark.parametrize("family", ["bss", "spe"])
def test_artifact_round_trip_equals_eager_and_jax(pair, family, tmp_path):
    """Bucket (4, T); 3 requests of t < T through the zip and back: the
    eager port on the bucket's padding bit for bit, and JAX's ServingModel
    on the same weights at >= 60 dB; the graph holds one operator call per
    scan (2 per block: intra unmasked, inter masked)."""
    from tss_dprnn_tpu.inference import export as jexport

    jmodel, variables, port = pair[family]
    T, b, t = 400, 3, 330
    exp = export.export_separation(port, 4, T)
    calls = [str(n.target) for n in exp.graph.nodes if n.op == "call_function"
             and B.OPS_NAMESPACE in str(n.target)]
    assert calls == [f"{B.OPS_NAMESPACE}.bilstm2_forward.default",
                     f"{B.OPS_NAMESPACE}.bilstm2_forward_masked.default"]
    spe = family == "spe"
    path = str(tmp_path / "model.tssx")
    export.save_artifact(path, [exp], {"spe": spe, "aux_factor": 1, "device": "cpu"})
    sep = export.load_artifact(path)
    assert sorted(sep.buckets) == [(4, T)] and sep.platforms() == ("cpu",)
    rng = np.random.default_rng(5)
    mix = rng.standard_normal((b, t)).astype(np.float32)
    aux = rng.standard_normal((b, 250)).astype(np.float32)
    aux_len = np.array([250, 200, 180], np.float32)
    lengths = np.array([t, 300, 257], np.int32)
    call = (mix, aux, aux_len) if spe else (mix,)
    got = sep.call(*call, lengths=lengths)
    assert got.shape == (b, 1 if spe else 2, t)
    # the eager port on the padding ServingModel.call gives it
    padded = [np.pad(mix, ((0, 1), (0, T - t)))]
    if spe:
        padded += [np.pad(aux, ((0, 1), (0, T - 250))), np.append(aux_len, float(T))]
    padded.append(np.append(lengths, T).astype(np.int32))
    want = _eager(port, padded)
    want = (want[:, None] if spe else want)[:b, :, :t]
    assert np.array_equal(got, want)
    # JAX's own artifact of the same weights on its fp32 'xla' backend
    jpath = str(tmp_path / "jax.tssx")
    jexport.save_artifact(jpath, [jexport.export_separation(jmodel, variables, 4, T,
                                                            lstm_backend="xla")],
                          {"spe": spe, "aux_factor": 1})
    jwant = jexport.load_artifact(jpath).call(*call, lengths=lengths)
    for r in range(b):  # each row's valid region
        n = int(lengths[r])
        assert _snr_db(got[r, :, :n], jwant[r, :, :n]) >= MODEL_SNR_DB
    # a JAX artifact is refused, and says what it is
    with pytest.raises(ValueError, match="not an artifact of tss_dprnn_tpu_torch"):
        export.load_artifact(jpath)
    if spe:
        with pytest.raises(ValueError, match="aux is required"):
            sep.call(mix)


def _export_config(tmp_path, model_cfg, ckpt):
    lines = ["data:", f"  sample_rate: {SR}", "model:"]
    lines += [f"  {k}: {v}" for k, v in model_cfg.items()]
    lines.append(f"checkpoint_path: {ckpt}")
    path = tmp_path / "export.yaml"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def configs(pair, tmp_path_factory):
    """Per family: the export CLI's config over the ``pair`` weights saved
    once as a ``.pt`` checkpoint."""
    out = {}
    for name, cfg in (("bss", dict(SMALL, target="dprnn_tasnet")),
                      ("spe", dict(SMALL_SPE, target="dprnn_spe_tasnet"))):
        tmp = tmp_path_factory.mktemp(f"export_{name}")
        ckpt = tmp / f"{name}.pt"
        torch.save(pair[name][2].state_dict(), ckpt)
        out[name] = _export_config(tmp, cfg, ckpt)
    return out


def test_export_cli_end_to_end(pair, configs, tmp_path):
    """Checkpoint on disk -> CLI -> artifact -> serving call; the version
    check and "no bucket fits"."""
    _, _, port = pair["spe"]
    cfg = configs["spe"]
    out = str(tmp_path / "model.tssx")
    T = 400  # 0.05 s at 8 kHz
    export_model.main(["--config", cfg, "--mode", "tss_spe", "--out", out, "--batch", "2",
                       "--secs", "0.05", "--dtype", "fp32", "--platform", "cpu"])
    sep = export.load_artifact(out)
    assert sep.spe and sep.meta["sample_rate"] == SR and sep.meta["backend"] == "pallas"
    assert sep.meta["device"] == "cpu" and sep.meta["dtype"] == "fp32"
    assert sorted(sep.buckets) == [(1, T), (2, T)]
    assert sep._pick(1, 100) == (1, T) and sep._pick(2, 1) == (2, T)
    rng = np.random.default_rng(6)
    mix = rng.standard_normal((2, T)).astype(np.float32)
    aux = rng.standard_normal((2, T)).astype(np.float32)
    got = sep.call(mix, aux)
    want = _eager(port, (mix, aux, np.full(2, float(T), np.float32), np.full(2, T, np.int32)))
    assert np.array_equal(got[:, 0], want)
    with pytest.raises(ValueError, match="no exported bucket fits"):
        sep.call(rng.standard_normal((3, T)).astype(np.float32), aux)
    # an artifact of another format version
    with zipfile.ZipFile(out) as zf:
        files = {n: zf.read(n) for n in zf.namelist()}
    meta = json.loads(files["meta.json"])
    meta["format_version"] = export.FORMAT_VERSION + 1
    files["meta.json"] = json.dumps(meta).encode()
    other = str(tmp_path / "other.tssx")
    with zipfile.ZipFile(other, "w") as zf:
        for n, data in files.items():
            zf.writestr(n, data)
    with pytest.raises(ValueError, match="unsupported artifact version"):
        export.load_artifact(other)


def test_export_cli_xla_backend_is_hermetic(pair, configs, tmp_path):
    """--backend xla at the smallest shape (batch 1, 20 samples: every scan
    step is a node of the graph): the plain versions' PyTorch ops and no
    operator of the port, equal to the eager forward bit for bit; any other
    device is refused."""
    _, _, port = pair["bss"]
    cfg = configs["bss"]
    out = str(tmp_path / "xla.tssx")
    export_model.main(["--config", cfg, "--mode", "bss", "--out", out, "--batch", "1",
                       "--secs", "0.0025", "--backend", "xla", "--dtype", "fp32",
                       "--platform", "cpu"])
    sep = export.load_artifact(out)
    (shape, exp), = sep.buckets.items()
    assert shape == (1, 20) and sep.meta["backend"] == "xla"
    targets = [str(n.target) for n in exp.graph.nodes if n.op == "call_function"]
    assert "aten.sigmoid.default" in targets or "aten.exp.default" in targets
    assert not [t for t in targets if B.OPS_NAMESPACE in t]
    mix = np.random.default_rng(7).standard_normal((1, 20)).astype(np.float32)
    assert np.array_equal(sep.call(mix), _eager(port, (mix, np.array([20], np.int32))))
    with pytest.raises(ValueError, match="CPU only"):
        export_model.main(["--config", cfg, "--out", out, "--backend", "xla",
                           "--device", "cuda"])


# ---------------------------------------------------------------- the card

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_card_artifact_equals_eager(tmp_path, dtype):
    """A card artifact of the verify skill's tiny TSS model (widths padded
    to 16 by the wrappers) calls the serving kernels (1 + 1 scans and 2
    input products a call) and equals the eager forward on the same padding
    bit for bit, after a round trip through the zip; loaded for the CPU, it
    equals the eager forward there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cfg = dict(SMALL_SPE, chunk_length=40, hop_length=20,
               dtype=None if dtype == "fp32" else "bfloat16")
    model = init_weights_(build_model(dict(cfg, target="dprnn_spe_tasnet")),
                          torch.Generator().manual_seed(3)).cuda().eval()
    T = 1600
    path = str(tmp_path / "card.tssx")
    export.save_artifact(path, [export.export_separation(model, 4, T)],
                         {"spe": True, "aux_factor": 1, "device": "cuda"})
    sep = export.load_artifact(path)
    rng = np.random.default_rng(8)
    mix = rng.standard_normal((3, 1500)).astype(np.float32)
    aux = rng.standard_normal((3, 900)).astype(np.float32)
    lengths = np.array([1500, 1200, 700], np.int32)
    B.reset_launch_counts()
    L.reset_launch_counts()
    got = sep.call(mix, aux, lengths=lengths)
    assert (B.bilstm2_forward.launches, B.bilstm2_forward_masked.launches) == (1, 1)
    assert B.product_launch_counts()["products_gemm"] == 2 and L.launch_count() == 0
    padded = [np.pad(mix, ((0, 1), (0, T - 1500))), np.pad(aux, ((0, 1), (0, T - 900))),
              np.full(4, 900.0, np.float32), np.append(lengths, T).astype(np.int32)]
    padded[2][3] = float(T)
    with torch.inference_mode():
        want = model(*(torch.from_numpy(a).cuda() for a in padded[:3]),
                     lengths=torch.from_numpy(padded[3]).cuda())[0]
    want = want.float().cpu().numpy()[:3, None, :1500]
    assert np.array_equal(got, want)
    # told to run elsewhere, the programs move there first: on the CPU the
    # operators run their plain versions, as the eager model does there
    on_cpu = export.load_artifact(path, device="cpu")
    assert on_cpu.platforms() == ("cpu",)
    with torch.inference_mode():
        want_cpu = model.cpu()(*map(torch.from_numpy, padded[:3]),
                               lengths=torch.from_numpy(padded[3]))[0]
    want_cpu = want_cpu.float().numpy()[:3, None, :1500]
    assert np.array_equal(on_cpu.call(mix, aux, lengths=lengths), want_cpu)
