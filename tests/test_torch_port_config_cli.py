"""The port's config reader, model registry and CLIs against the JAX
package's: every shipped config reads as ``yaml.safe_load`` reads it; the
overrides parse alike; what the reader does not take raises; and the
verify flow (manifests -> train -> test) runs through the port's CLIs on
the CPU, its test CLI writing the rows the JAX test CLI writes for the same
``.pt`` checkpoint and corpus."""

import csv
import json
import pathlib

import numpy as np
import pytest
import torch
import yaml

from tests.fixtures import make_mini_librimix
from tss_dprnn_tpu.cli import generate_manifests as jgen
from tss_dprnn_tpu.cli import test as jtest_cli
from tss_dprnn_tpu.utils import config as jconfig
from tss_dprnn_tpu_torch.cli import generate_manifests, test as test_cli, train as train_cli
from tss_dprnn_tpu_torch.models import (DPRNNRawNetTasNet, DPRNNSpeIRATasNet, DPRNNSpeTasNet,
                                        DPRNNTasNet)
from tss_dprnn_tpu_torch.models.registry import MODEL_REGISTRY, build_model
from tss_dprnn_tpu_torch.utils import config
from tss_dprnn_tpu_torch.utils.weights import init_weights_

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))
# the verify skill's tiny model
TINY = dict(input_size=8, feature_size=12, hidden_size=10, chunk_length=40, kernel_size=2,
            hop_length=20, n_repeats=1, norm_type="ln")
TINY_SPE = dict(TINY, target="dprnn_spe_tasnet", O=8, P=12, embeddings_size=8, num_spks=8,
                fusion_type="att")
# all_metrics.csv agreement, port on the CPU vs the JAX package (its host
# lane in float64 on its own forward): SI-SDR in dB, STOI, PESQ in MOS. The
# worst rows measured on the CPU, TSS and BSS: SI-SDR 1.4e-6 dB, STOI 1.2e-8,
# PESQ 2.2e-8; the bars keep two orders of magnitude above that.
ROW_TOL = {"si_sdr": 1e-4, "stoi": 1e-6, "pesq": 1e-4}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: in the suite's parallel workers
    torch's idle pool threads spin against each other's and every small op
    waits on the scheduler (test_torch_port_device_metrics.py measures it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _SubsetDumper(yaml.SafeDumper):
    """Writes mappings in block style and lists in flow style, on one line."""


_SubsetDumper.add_representer(
    dict, lambda d, v: d.represent_mapping("tag:yaml.org,2002:map", v, flow_style=False))
_SubsetDumper.add_representer(
    list, lambda d, v: d.represent_sequence("tag:yaml.org,2002:seq", v, flow_style=True))


def _dump(path, cfg):
    """A config as YAML in the reader's subset."""
    path.write_text(yaml.dump(cfg, Dumper=_SubsetDumper, width=1 << 20))
    return str(path)


# -------------------------------------------------------------------- config

@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_shipped_configs_read_as_yaml_safe_load(path):
    text = path.read_text()
    assert config.parse_yaml(text, str(path)) == yaml.safe_load(text)


def test_config_subset_reads_as_yaml_safe_load():
    """Every construct of the subset, with YAML 1.1's number quirks."""
    text = (
        "# a comment\n"
        "a: 1            # trailing comment\n"
        "b:\n"
        "  c: 1.0e-5\n"
        "  d: 5e-4\n"
        "  e: [x, 'y, z', \"q\\tr\", [1, 2.5], -3, 0x1F, 017, 1_000, .inf, -.5]\n"
        "  f:\n"
        "    g: ~\n"
        "    h: null\n"
        "k: http://host:80/p#frag\n"
        "l: 'it''s'\n"
        "m: true\n"
        "n: FALSE\n"
        "o: 08\n"
        "p: []\n"
        "12: twelve\n"
        "r: a b  c\n"
    )
    assert config.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("raw", ["5e-4", "007", "1_2", "[1, 2]", "null", "true", "a plain string",
                                 "-1.5E+3", "1.0e-5", "'5e-4'", "", "x # comment"])
def test_parse_override_equals_jax(raw):
    got, want = config._parse_override(raw), jconfig._parse_override(raw)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("text", [
    "a: &anchor 1", "a: *alias", "a: !!float 1", "a: |\n  block", "a: >\n  folded",
    "---\na: 1\n---\nb: 2", "a:\n  - 1\n  - 2", "a: {b: 1}", "a: yes", "a: No", "a: on",
    "a: OFF", "a: 1:30", "a: 2024-01-02", "a: b\n  continued", "a: [1,\n  2]",
    "a:\n\tb: 1", "a: 'open", "%YAML 1.1\na: 1", "a: b: c",
], ids=lambda t: t.replace("\n", "|"))
def test_unsupported_yaml_raises(text):
    with pytest.raises(config.YamlSubsetError):
        config.parse_yaml(text)


def test_load_config_equals_jax_with_overrides(tmp_path):
    overrides = ["optimizer.lr=5e-4", "data.batch_size=8", "logs.metadata.ids=[]",
                 "name=007", "model.dtype=float32", "new.key=[a, 1]"]
    path = str(ROOT / "configs" / "train_tss.yaml")
    assert config.load_config(path, overrides) == jconfig.load_config(path, overrides)
    with_jax = tmp_path / "c.yaml"
    with_jax.write_text("a: 1\njax:\n  compilation_cache_dir: null\n")
    assert config.load_config(str(with_jax)) == {"a": 1, "jax": {"compilation_cache_dir": None}}


# ------------------------------------------------------------------ registry

@pytest.mark.parametrize("target,cls", [
    ("dprnn_tasnet", DPRNNTasNet), ("src.models.dprnn.DPRNNTasNet", DPRNNTasNet),
    ("dprnn_spe_tasnet", DPRNNSpeTasNet), ("src.models.dprnn_spe.DPRNNSpeTasNet", DPRNNSpeTasNet)])
def test_build_model_resolves_names(target, cls):
    cfg = dict(TINY_SPE if cls is DPRNNSpeTasNet else TINY, target=target, dropout=0,
               bidirectional=True, activation_type="sigmoid")
    assert type(build_model(cfg)) is cls
    assert type(build_model(dict(cfg, dtype="float32", **{"_target_": cfg.pop("target")}))) is cls


@pytest.mark.parametrize("cfg,match", [
    (dict(TINY_SPE, target="dprnn_spe_ira_tasnet", share_blocks=0), DPRNNSpeIRATasNet),
    (dict(TINY_SPE, target="src.models.dprnn_rawnet.DPRNNRawNetTasNet", rawnet_C=32,
          rawnet_scale=4), DPRNNRawNetTasNet),
    (dict(TINY_SPE, dtype="bfloat16"), DPRNNSpeTasNet),
    (dict(TINY_SPE, fusion_type="cat"), None),
], ids=["ira", "rawnet", "bfloat16", "cat"])
def test_build_model_raises_for_the_unported(cfg, match):
    """What is not ported raises naming its ROADMAP item; 'cat', refused
    until the fusions were ported, builds with its widened bottleneck, and
    IRA, RawNet and ``dtype: bfloat16``, refused until their families and
    the bf16 lane were ported, build their classes."""
    if match is None:
        model = build_model(cfg)
        assert model.separation.bottleneck[1].in_features == cfg["input_size"] + cfg[
            "embeddings_size"]
        return
    if isinstance(match, type):
        assert type(build_model(cfg)) is match
        return
    with pytest.raises(NotImplementedError, match=match):
        build_model(cfg)


def test_registry_keys_equal_jax():
    from tss_dprnn_tpu.models.registry import MODEL_REGISTRY as JAX_REGISTRY

    assert sorted(MODEL_REGISTRY) == sorted(JAX_REGISTRY)
    with pytest.raises(ValueError, match="unknown model target"):
        build_model({"target": "dprnn"})


# ---------------------------------------------------------------------- CLIs

@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    """The verify flow's first two steps through the port: manifests (equal
    to the JAX generator's), then 2 epochs of training on the CPU."""
    tmp = tmp_path_factory.mktemp("flow")
    csv_path = make_mini_librimix(str(tmp / "wavs"), n_mix=8, min_sec=1.0, max_sec=1.5)
    manifests = {}
    for name, gen in (("port", generate_manifests), ("jax", jgen)):
        out = {s: str(tmp / name / f"{s}.json") for s in ("train", "eval", "test")}
        cfg = dict(dataset_type="librimix_spe", sample_rate=8000, n_src=2, segment=0.5, seed=0,
                   train_path=csv_path, eval_path=csv_path, test_path=csv_path,
                   **{f"{s}_out": p for s, p in out.items()})
        gen.main(["--config", _dump(tmp / f"gen_{name}.yaml", cfg)])
        manifests[name] = out
    train_cfg = dict(
        name="t", is_test=False,
        data=dict(use_generated_train=manifests["port"]["train"],
                  use_generated_eval=manifests["port"]["eval"], batch_size=4, sample_rate=8000,
                  seed=0),
        model=TINY_SPE, optimizer=dict(lr=1e-3, weight_decay=1e-5),
        lr_scheduler=dict(patience=2, factor=0.5, decay_rate=None),
        logs=dict(metadata=dict(ids=[0])), print_freq=100, clip_norm=5, cur_epoch=0,
        epochs=2, early_stop=10, ce_gamma=0.5, checkpoint_path=None, n_checkpoints=5,
        new_checkpoints_path=str(tmp / "chkpts"))
    path = _dump(tmp / "train.yaml", train_cfg)
    train_cli.main(["--config", path, "--mode", "tss_spe", "--device", "cpu"])
    return dict(tmp=tmp, csv=csv_path, manifests=manifests, train_config=path)


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _run_both(tmp, mode, cfg, n_rows):
    """The port's and the JAX package's test CLI on one config; their
    all_metrics.csv rows, row for row (both sorted by dataset index)."""
    rows = {}
    for name, main, extra in (("port", test_cli.main, ["--device", "cpu"]),
                              ("jax", jtest_cli.main, [])):
        savedir = tmp / f"metrics_{mode}_{name}"
        path = _dump(tmp / f"test_{mode}_{name}.yaml", dict(cfg, test_savedir=str(savedir)))
        final = main(["--config", path, "--mode", mode, "--batch-size", "4", "--n-buckets", "2",
                      *extra])
        rows[name] = _rows(savedir / "all_metrics.csv")
        saved = json.loads((savedir / "final_metrics.json").read_text())
        assert set(saved) == {f"{m}{s}" for m in ROW_TOL for s in ("", "_imp")}
        assert all(np.isfinite(v) for v in final.values())
    assert len(rows["port"]) == len(rows["jax"]) == n_rows
    assert [int(r["index"]) for r in rows["port"]] == list(range(n_rows))
    worst = {}
    for p, j in zip(rows["port"], rows["jax"]):
        for metric, tol in ROW_TOL.items():
            for key in (metric, "input_" + metric):
                err = abs(float(p[key]) - float(j[key]))
                worst[key] = max(worst.get(key, 0.0), err)
                assert err <= tol, (key, p[key], j[key])
    return worst


def test_cli_flow_equals_jax_cli(flow):
    """Manifests equal; training wrote 2_best and 2_last; the port's test CLI
    and the JAX one score the trained checkpoint alike, row for row."""
    for split in ("train", "eval", "test"):
        port = json.loads(pathlib.Path(flow["manifests"]["port"][split]).read_text())
        jax_ = json.loads(pathlib.Path(flow["manifests"]["jax"][split]).read_text())
        assert port == jax_
    ckpts = sorted(p.name for p in (flow["tmp"] / "chkpts").iterdir())
    assert "2_best" in ckpts and "2_last" in ckpts
    cfg = dict(name="e", is_test=True,
               data=dict(use_generated_test=flow["manifests"]["port"]["test"], sample_rate=8000),
               model=TINY_SPE, checkpoint_path=str(flow["tmp"] / "chkpts" / "2_best"),
               metrics=["si_sdr", "stoi", "pesq"])
    _run_both(flow["tmp"], "tss_spe", cfg, 8)


def test_cli_bss_equals_jax_cli(flow):
    """--mode bss on the CSV (full length), a seeded DPRNN-TasNet the port
    saved: the two CLIs' rows agree after each one's PIT reorder."""
    path = flow["tmp"] / "bss.pt"
    torch.save(init_weights_(DPRNNTasNet(**TINY), torch.Generator().manual_seed(5)).state_dict(),
               path)
    cfg = dict(name="b", is_test=True, data=dict(test_path=flow["csv"], sample_rate=8000),
               model=dict(TINY, target="dprnn_tasnet"), checkpoint_path=str(path),
               metrics=["si_sdr", "stoi", "pesq"])
    _run_both(flow["tmp"], "bss", cfg, 8)


@pytest.mark.parametrize("case", ["orbax_dir", "no_checkpoint", "data_parallel", "device_pesq",
                                  "rawnet"])
def test_cli_test_refuses_what_is_not_ported(flow, case):
    """What is not ported raises; ``--device-pesq``, refused until PESQ ran
    on the device, scores the triple there, and ``--mode tss_rawnet``,
    refused until the RawNet family was ported, serves a tiny RawNet
    checkpoint on 16 kHz references."""
    ckpt = flow["tmp"] / "chkpts" / "2_best"
    cfg = dict(data=dict(use_generated_test=flow["manifests"]["port"]["test"]), model=TINY_SPE,
               checkpoint_path=str(ckpt), metrics=["si_sdr"],
               test_savedir=str(flow["tmp"] / f"refused_{case}"))
    if case == "rawnet":
        from tss_dprnn_tpu_torch.inference import InferencerRawNet

        model_cfg = dict(TINY_SPE, target="dprnn_rawnet_tasnet", rawnet_C=32, rawnet_scale=4,
                         rawnet_sinc_stride=16)
        path = flow["tmp"] / "rawnet.pt"
        torch.save(init_weights_(build_model(model_cfg), torch.Generator().manual_seed(6))
                   .state_dict(), path)
        seen = []
        real = InferencerRawNet._make_loader

        def loader(self, *args):  # the batches as the inferencer collates them
            ld = real(self, *args)
            seen.extend(ld)
            return ld

        InferencerRawNet._make_loader, restore = loader, real
        try:
            final = test_cli.main(["--config", _dump(flow["tmp"] / "rawnet.yaml", dict(
                cfg, model=model_cfg, checkpoint_path=str(path))), "--mode", "tss_rawnet",
                "--device", "cpu", "--batch-size", "4", "--n-buckets", "2"])
        finally:
            InferencerRawNet._make_loader = restore
        assert set(final) == {"si_sdr", "si_sdr_imp"} and all(map(np.isfinite, final.values()))
        rows = _rows(flow["tmp"] / f"refused_{case}" / "all_metrics.csv")
        assert len(rows) == 8
        from tss_dprnn_tpu_torch.data.librimix import LibrimixSpe

        test_set = LibrimixSpe(manifest_path=flow["manifests"]["port"]["test"])
        assert sorted(i for b in seen for i in b["indices"]) == list(range(len(test_set)))
        for b in seen:  # every reference resampled to 16 kHz, its length counted there
            assert b["ref_len"].tolist() == [2 * len(test_set[i][2]) for i in b["indices"]]
        return
    if case == "device_pesq":
        from tss_dprnn_tpu_torch.inference.inferencer import host_counts

        path = _dump(flow["tmp"] / "device_pesq.yaml", dict(cfg, metrics=list(ROW_TOL)))
        before = dict(host_counts)
        final = test_cli.main(["--config", path, "--mode", "tss_spe", "--device", "cpu",
                               "--device-pesq"])
        assert host_counts == before  # no estimate reached the host, no pool started
        assert set(final) == {f"{m}{s}" for m in ROW_TOL for s in ("", "_imp")}
        assert all(np.isfinite(v) for v in final.values())
        return
    path = _dump(flow["tmp"] / f"refuse_{case}.yaml", cfg)
    argv = ["--config", path, "--mode", "tss_spe", "--device", "cpu"]
    err, match = NotImplementedError, "not ported"
    if case == "orbax_dir":
        argv += ["--set", f"checkpoint_path={flow['tmp'] / 'chkpts'}"]
        err, match = ValueError, "orbax"
    elif case == "no_checkpoint":
        argv += ["--set", "checkpoint_path=null"]
        err, match = ValueError, "checkpoint_path is required"
    elif case == "data_parallel":
        # refused until data-parallel eval was ported; in one process a
        # world of 2 is refused, naming both
        argv += ["--data-parallel", "2"]
        err, match = ValueError, "--data-parallel 2 but the process group has world size 1"
    with pytest.raises(err, match=match):
        test_cli.main(argv)


@pytest.mark.parametrize("override,match", [
    ("data.variable_length=true", "variable_length"),
    ("accum_steps=2", "accum_steps"),
    ("logs.metadata.ids=[0]", None),
])
def test_cli_train_refuses_what_is_not_ported(flow, override, match, capsys):
    """Each was refused until it was ported. Eval mixtures are separated
    after the best epoch and logged; ``data.variable_length`` (on manifests
    of 0.5 s crops: one bucket) and ``accum_steps`` train one epoch and
    write its checkpoint."""
    ckpts = flow["tmp"] / f"ck_{match}"
    train_cli.main(["--config", flow["train_config"], "--mode", "tss_spe", "--device", "cpu",
                    "--set", override, "epochs=1", f"new_checkpoints_path={ckpts}"])
    assert (ckpts / "1_last").exists()
    if match is None:
        assert "[inference_spe] 1 demo mixtures at step 1" in capsys.readouterr().out
