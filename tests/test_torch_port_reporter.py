"""The port's log-only reporter and what feeds it, on the CPU against the
JAX package:

- every mode's log lines equal the JAX ``Reporter``'s with wandb off, with
  and without a ``wandb_key`` (the port never imports wandb);
- ``cli.train`` on the shipped ``configs/train_tss.yaml`` and
  ``configs/train_bss.yaml`` (tiny widths and the data through ``--set``,
  in-range ``logs.metadata.ids``, every other logs key as shipped), both
  CLIs warm-started from one ``.pt``: the port's reporter logs the 'train',
  'eval' and 'inference(_spe)' lines, and the demo mixtures' estimates
  equal the JAX CLI's (>= 60 dB SNR);
- ``cli.test``'s batch size: 16 with ``--device-metrics`` or
  ``--device-pesq``, 8 otherwise, and the log line that says so.
"""

import copy
import logging

import numpy as np
import pytest
import torch

from tests.fixtures import make_mini_librimix
from tss_dprnn_tpu_torch.cli import test as test_cli, train as train_cli
from tss_dprnn_tpu_torch.inference import InferencerSpe
from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet, DPRNNTasNet
from tss_dprnn_tpu_torch.reporters import Reporter
from tss_dprnn_tpu_torch.reporters import reporter as reporter_mod
from tss_dprnn_tpu_torch.utils.weights import init_weights_

TINY = dict(input_size=8, feature_size=12, hidden_size=10, chunk_length=40, kernel_size=2,
            hop_length=20, n_repeats=1)
TINY_SPE = dict(TINY, O=8, P=12, embeddings_size=8)
IDS = [0, 2]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: in the suite's parallel workers
    torch's idle pool threads spin against each other's and every small op
    waits on the scheduler (test_torch_port_device_metrics.py measures it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logger(name):
    logger = logging.getLogger(f"tests.reporter.{name}")
    logger.handlers[:] = [_Records()]
    logger.propagate = False
    logger.setLevel(logging.INFO)
    return logger


def _drive(reporter_cls, config, logger):
    wav = np.zeros(80, np.float32)
    rep = reporter_cls(config, logger)
    rep.add_and_report({"step": 1, "loss": -10.0, "metrics": None}, mode="train")
    rep.add_and_report({"step": 1, "loss": -9.0, "metrics": {"si_sdr": 10.0}}, mode="eval")
    rep.add_and_report({"id": 3, "mix": wav, "target": wav, "estimated": wav, "reference": wav,
                        "si_sdr": 10.0, "stoi": 0.9, "pesq": None, "si_sdr_imp": 5.0,
                        "stoi_imp": 0.1, "pesq_imp": None}, mode="test")
    rep.add_and_report(None, mode="test_final")
    mixtures = {0: {"mix": wav}, 7: {"mix": wav}}
    for mode in ("inference", "inference_spe", "inference_no_ref"):
        rep.add_and_report({"step": 2, "mixtures": mixtures}, mode=mode)
    with pytest.raises(ValueError, match="unknown reporter mode"):
        rep.add_and_report({}, mode="nope")
    rep.wandb_finish()
    return logger.handlers[0].lines


@pytest.mark.parametrize("key", [None, "a-key"], ids=["no_key", "wandb_key"])
def test_reporter_lines_equal_jax_without_wandb(monkeypatch, key):
    from tss_dprnn_tpu.reporters import reporter as jax_reporter_mod

    monkeypatch.setattr(jax_reporter_mod, "_wandb", None)  # as on the card's machine
    config = {"data": {"sample_rate": 8000}, "is_test": True,
              "logs": {"wandb_credentials": {"wandb_key": key, "wandb_project": "p"}}}
    got = _drive(Reporter, config, _logger("port"))
    want = _drive(jax_reporter_mod.Reporter, config, _logger("jax"))
    assert got == want
    assert len(got) == 8 and "wandb disabled" in got[0]
    assert "wandb" not in reporter_mod.__dict__


# ------------------------------------------------------------- cli.train

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reporter")
    return tmp, make_mini_librimix(str(tmp / "wavs"), n_mix=8, min_sec=1.0, max_sec=1.5)


def _capture_mixtures(monkeypatch, cls, store):
    """Records a deep copy of each inference pass's mixtures that ``cls``
    (a Reporter class) is handed."""
    add = cls.add_and_report

    def add_and_report(self, logs=None, mode="train"):
        if mode.startswith("inference"):
            store.append((mode, logs["step"], copy.deepcopy(logs["mixtures"])))
        return add(self, logs, mode)

    monkeypatch.setattr(cls, "add_and_report", add_and_report)


@pytest.mark.parametrize("family", ["tss", "bss"])
def test_cli_train_shipped_config_equals_jax_cli(corpus, family, monkeypatch, capsys):
    from tss_dprnn_tpu.cli import train as jax_train_cli
    from tss_dprnn_tpu.reporters import reporter as jax_reporter_mod

    tmp, csv_path = corpus
    spe = family == "tss"
    mode = "tss_spe" if spe else "bss"
    model = (DPRNNSpeTasNet(**dict(TINY_SPE, norm_type="ln", num_spks=251)) if spe
             else DPRNNTasNet(**dict(TINY, norm_type="ln")))
    start = tmp / f"{family}_start.pt"
    torch.save({"epoch": 0, "model": init_weights_(model, torch.Generator().manual_seed(2))
                .state_dict()}, start)
    overrides = [f"data.train_path={csv_path}", f"data.eval_path={csv_path}", "data.segment=0.5",
                 "data.batch_size=4", "epochs=1", f"logs.metadata.ids=[{IDS[0]}, {IDS[1]}]",
                 f"checkpoint_path={start}", "optimizer.lr=1e-5", "print_freq=100",
                 *(f"model.{k}={v}" for k, v in (TINY_SPE if spe else TINY).items())]
    config = f"configs/train_{family}.yaml"
    seen = {}
    for name, main, cls, extra in (
            ("port", train_cli.main, Reporter, ["--device", "cpu"]),
            ("jax", jax_train_cli.main, jax_reporter_mod.Reporter, [])):
        seen[name] = []
        _capture_mixtures(monkeypatch, cls, seen[name])
        main(["--config", config, "--mode", mode, "--set", *overrides,
              f"new_checkpoints_path={tmp / f'{family}_{name}'}", *extra])
        if name == "port":
            out = capsys.readouterr().out
    kind = "inference_spe" if spe else "inference"
    for line in ("[train] step=1 loss=", "[eval] step=1 loss=",
                 f"[{kind}] {len(IDS)} demo mixtures at step 1"):
        assert line in out, line
    (got_mode, got_step, got), (_, want_step, want) = seen["port"][0], seen["jax"][0]
    assert len(seen["port"]) == len(seen["jax"]) == 1 and got_mode == kind
    assert got_step == want_step == 1 and sorted(got) == sorted(want) == IDS
    keys = ("estimated",) if spe else ("s1_estimated", "s2_estimated")
    for i in IDS:
        for k in keys:
            g, w = got[i][k], np.asarray(want[i][k])
            assert g.shape == w.shape == got[i]["mix"].shape
            snr = 10 * np.log10(np.sum(w ** 2) / np.sum((g - w) ** 2))
            assert snr >= 60.0, (i, k, snr)


# -------------------------------------------------------------- cli.test

@pytest.mark.parametrize("flags,batch,why", [
    ([], 8, "without the device metric lane"),
    (["--device-metrics"], 16, "of the device metric lane"),
    (["--device-pesq"], 16, "of the device metric lane"),
    (["--batch-size", "4", "--device-pesq"], 4, "from --batch-size"),
], ids=["host", "device_metrics", "device_pesq", "explicit"])
def test_cli_test_batch_default_and_its_log_line(corpus, monkeypatch, capsys, flags, batch, why):
    tmp, csv_path = corpus
    ckpt = tmp / "spe.pt"
    torch.save(init_weights_(DPRNNSpeTasNet(**dict(TINY_SPE, norm_type="ln", num_spks=251)),
                             torch.Generator().manual_seed(3)).state_dict(), ckpt)
    ran = {}

    def run(self, test_set, batch_size=8, n_buckets=8, **kw):
        ran.update(batch_size=batch_size, device_metrics=self.device_metrics,
                   device_pesq=self.device_pesq)
        return {}

    monkeypatch.setattr(InferencerSpe, "run", run)
    test_cli.main(["--config", "configs/test_tss.yaml", "--mode", "tss_spe", "--device", "cpu",
                   "--set", f"data.test_path={csv_path}", f"checkpoint_path={ckpt}",
                   f"test_savedir={tmp / 'unused'}",
                   *(f"model.{k}={v}" for k, v in TINY_SPE.items()), *flags])
    assert ran["batch_size"] == batch
    assert ran["device_metrics"] == bool({"--device-metrics", "--device-pesq"} & set(flags))
    assert ran["device_pesq"] == ("--device-pesq" in flags)
    line = next(ln for ln in capsys.readouterr().out.splitlines() if "batch size" in ln)
    assert f"batch size {batch}: " in line and why in line
