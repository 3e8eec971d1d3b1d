"""Every cell runs end to end at tiny widths on the CPU (the harness's look
for a card skipped) and builds a well-formed result line; with the timed
path broken underneath, ``correct`` comes out false; without a card the
command fails and prints no result."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
from conftest import shrink

from benchmark.lib.harness import forbidden_modules, result_line, run_cell
from benchmark.lib.registry import Registry

ROOT = Path(__file__).resolve().parents[2]
REG = Registry()
CELLS = [w["name"] for w in REG.spec["workloads"]]
SEED = 2**31 + 99


def _run(cell, trace=False, patch=None, seed=SEED):
    return run_cell(REG, cell, seed, 0.3, trace, torch.device("cpu"), time.perf_counter(),
                    patch=patch, override=shrink)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_builds_a_well_formed_line(cell, trace):
    result = _run(cell, trace)
    line, err = result_line(result, {"platform": "cpu-test", "kind": "cpu"})
    out = json.loads(line)
    assert list(out) == (["correct", "attempted", "failed", "metrics", "device"]
                         + (["breakdown"] if trace else []) + ["notes", "checks"])
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in REG.metrics_of(cell, kind)}
    if trace:  # a CPU trace has no kernels: only the counted and host-clock metrics
        assert set(out["metrics"]) <= want
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == want - {"peak_mem_gb"}  # no device memory on the CPU
    for m in out["metrics"].values():
        assert m["value"] == m["value"] and m["unit"]
    assert set(out["checks"]) == set(REG.limits(cell))
    assert err[len(err) - len(out["checks"]):] == [
        f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in out["checks"].items()]
    assert len(err) == len(out["notes"]) + len(out["checks"])
    assert not forbidden_modules()


def _serve_fault(kind):
    def patch(loop):
        forward = loop.inf.forward

        def broken(batch):
            est = forward(batch)
            if kind == "unchanged":  # the input handed back
                return torch.from_numpy(batch["mix"]).reshape(est.shape)
            if kind == "half":
                est = est.clone()
                est[est.shape[0] // 2:] = 0
                return est
            return est * 1.01  # every answer altered

        loop.inf.forward = broken
    return patch


def _train_fault(kind):
    def patch(loop):
        tr = loop.tr
        if kind == "unchanged":
            tr.optimizer.step = lambda: None
        elif kind == "half":
            to_device = tr._to_device

            def half(batch):
                b = to_device(batch)
                n = (b["mix"].shape[0] + 1) // 2
                return {k: v[:n] for k, v in b.items()}

            tr._to_device = half
        else:
            def altered(_module, _inputs, out):
                est = out[0] if isinstance(out, tuple) else out
                est = est + 1e-2 * est.roll(1, -1)
                return (est,) + tuple(out[1:]) if isinstance(out, tuple) else est

            tr.model.register_forward_hook(altered)
    return patch


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    loop = REG.traffic(REG.cell(cell)["traffic"])["loop"]
    patch = _serve_fault(fault) if loop == "serve" else _train_fault(fault)
    result = _run(cell, patch=patch)
    assert result["correct"] is False, result["checks"]


def _command(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                           "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def test_without_a_card_the_command_fails_and_prints_no_result():
    proc = _command(ROOT)
    assert proc.returncode != 0 and not proc.stdout.strip()
    assert "no CUDA card" in proc.stderr


def test_without_the_program_the_command_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _command(tmp_path, {"PYTHONPATH": ""})
    assert proc.returncode != 0 and not proc.stdout.strip()
    assert "tss_dprnn_tpu_torch" in proc.stderr
