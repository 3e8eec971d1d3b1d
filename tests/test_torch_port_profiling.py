"""The port's profiling hooks (``tss_dprnn_tpu_torch.utils.profiling``, the
counterpart of ``tss_dprnn_tpu/utils/profiling.py``) and the trainer's
``profile_dir`` (JAX ``training/trainer.py:323-341``): a two-epoch run
writes one ``torch.profiler`` trace, of epoch 1's train steps; ``trace``
without a directory does nothing; ``StepTimer`` keeps a rolling window. The
``cuda`` case traces a flagship TSS step on the card and finds the port's
training scans in it."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch.data import loader
from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
from tss_dprnn_tpu_torch.training import TrainerSpe
from tss_dprnn_tpu_torch.utils import profiling
from tss_dprnn_tpu_torch.utils.weights import init_weights_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_port_ddp_worker", os.path.join(REPO, "tests", "torch_port_ddp_worker.py"))
worker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(worker)
# the flagship DPRNN-Spe-TasNet (__graft_entry__.py:17-22)
FLAGSHIP = dict(input_size=64, feature_size=128, hidden_size=128, chunk_length=250,
                kernel_size=2, hop_length=125, n_repeats=6, bidirectional=True, norm_type="ln",
                activation_type="sigmoid", dropout=0, O=128, P=256, embeddings_size=128,
                num_spks=251, fusion_type="att")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # a traced step of the plain scans is ~10^5 tiny ops, which crawl when
    # every test process runs a thread per core
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _run(tmp_path, model, device, crops, batch, epochs):
    config = dict(worker.run_config(str(tmp_path / "ckpt")), profile_dir=str(tmp_path / "prof"),
                  is_metrics=False)
    trainer = TrainerSpe(model, config, device=device)
    trainer.run(loader.TrainLoader(crops, batch, loader.collate_spe, seed=3, prefetch=0),
                loader.TrainLoader(crops, batch, loader.collate_spe, shuffle=False, prefetch=0),
                epochs, early_stop=10)
    return trainer


def test_trainer_traces_epoch_one_only(tmp_path):
    """profile_dir set, two epochs of two steps: one trace file, this
    process's, holding two train steps (epoch 1's) and the model's ops."""
    torch.manual_seed(0)
    model = init_weights_(DPRNNSpeTasNet(**worker.TINY), torch.Generator().manual_seed(0))
    trainer = _run(tmp_path, model, "cpu", worker.Crops(0, 8), 4, 2)
    assert trainer.cur_epoch == 2
    assert os.listdir(tmp_path / "prof") == ["rank0.pt.trace.json"]
    events = _events(tmp_path / "prof" / "rank0.pt.trace.json")
    assert sum(e.get("name") == "train_step" for e in events) == 2
    assert any("conv1d" in str(e.get("name")) for e in events)


def test_trace_without_a_directory_does_nothing(tmp_path):
    with profiling.trace(None) as prof:
        torch.ones(3).sum()
    assert prof is None
    with profiling.trace(str(tmp_path / "t")) as prof:
        with torch.profiler.record_function("marked"):
            torch.ones(3).sum()
    assert prof is not None
    names = [e.get("name") for e in _events(profiling.trace_path(str(tmp_path / "t")))]
    assert "marked" in names


def test_step_timer_keeps_a_rolling_window():
    timer = profiling.StepTimer(window=2)
    for _ in range(3):
        timer.start()
        assert timer.stop("cpu") >= 0.0
    assert len(timer.times) == 2
    assert timer.mean_ms == pytest.approx(1000.0 * np.mean(timer.times))


@pytest.mark.cuda
def test_card_trace_of_a_flagship_step_names_the_scan_kernels(tmp_path):
    """One epoch of one flagship 5 x 3 s step traced on the card: the trace
    holds the port's residual forward and backward scans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = init_weights_(DPRNNSpeTasNet(**FLAGSHIP), torch.Generator().manual_seed(0))
    _run(tmp_path, model, "cuda", worker.Crops(0, 5, samples=24000, ref_range=(16000, 40000)),
         5, 1)
    names = {str(e.get("name")) for e in _events(tmp_path / "prof" / "rank0.pt.trace.json")
             if e.get("cat") == "kernel"}
    for kernel in ("resid_scan_kernel", "bwd_scan_kernel"):
        assert any(kernel in n for n in names), (kernel, sorted(names)[:40])
