"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
every configuration, traffic mix, limit and metric reader by name, a new
one from its files alone."""

import json
import re
import shutil
import subprocess
from pathlib import Path

import pytest

from benchmark.lib.registry import Registry

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries():
    names = ([c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and len(c["why"]) <= 200
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}" and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for cell in m["workloads"]:  # each cell that reads it reports what it moves
            assert cell in e2e[m["moves"]].get("workloads", [cell])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_is_found_by_name(cell):
    reg = Registry()
    w = reg.cell(cell)
    config, traffic = reg.config(w["config"]), reg.traffic(w["traffic"])
    assert config["name"] == w["config"]
    assert reg.loop(traffic["loop"]).Loop and reg.family(config["family"]).item
    assert reg.limits(cell)
    assert reg.flops(config["flops"]).forward_flops
    e2e = [m["name"] for m in reg.metrics_of(cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = reg.metrics_of(cell, "per_layer")
    assert layer
    for m in reg.metrics_of(cell, "end_to_end") + layer:
        assert callable(reg.reader(m["name"]).read)


def test_a_new_cell_is_picked_up_from_files_alone(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench, ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((bench / "traffic" / "serve_b8.json").read_text())
    traffic["batch_size"] = 32
    (bench / "traffic" / "serve_b32.json").write_text(json.dumps(traffic))
    (bench / "checks" / "dprnn_spe_att.serve_b32.json").write_text(
        json.dumps({"limits": {"est_rel_err": {"limit": 1e-4}}}))
    (bench / "metrics" / "served_requests.py").write_text(
        "def read(ctx):\n    return float(ctx.stats['attempted'])\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "dprnn_spe_att.serve_b32", "config": "dprnn_spe_att",
                              "traffic": "serve_b32", "chips": 1, "why": "batch 32"})
    spec["end_to_end"][0]["workloads"].append("dprnn_spe_att.serve_b32")
    spec["per_layer"].append({"name": "served_requests.serve", "unit": "requests",
                              "better": "higher", "source": "program_counter",
                              "layer": "batching", "moves": "serve_audio_s_per_s",
                              "workloads": ["dprnn_spe_att.serve_b32"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    reg = Registry(path, bench)
    assert reg.traffic(reg.cell("dprnn_spe_att.serve_b32")["traffic"])["batch_size"] == 32
    assert reg.limits("dprnn_spe_att.serve_b32") == {"est_rel_err": 1e-4}
    names = [m["name"] for m in reg.metrics_of("dprnn_spe_att.serve_b32", "per_layer")]
    assert "served_requests.serve" in names
    assert reg.reader("served_requests.serve").read(type("C", (), {"stats": {"attempted": 3}})) == 3


def test_a_new_loop_and_family_are_picked_up_from_files_alone(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench, ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "loops" / "replay.py").write_text("class Loop:\n    kind = 'replay'\n")
    (bench / "families" / "other.py").write_text("def item(config, requests, i):\n"
                                                 "    return ('other', i)\n")
    config = json.loads((bench / "configs" / "dprnn_tasnet.json").read_text())
    config.update(name="other_model", family="other")
    (bench / "configs" / "other_model.json").write_text(json.dumps(config))
    (bench / "traffic" / "replay_b1.json").write_text(json.dumps({"loop": "replay"}))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "other_model", "source": "a paper", "reduced": [],
                            "file": "benchmark/configs/other_model.json", "why": "another"})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    reg = Registry(path, bench)
    assert reg.family(reg.config("other_model")["family"]).item({}, None, 3) == ("other", 3)
    assert reg.loop(reg.traffic("replay_b1")["loop"]).Loop.kind == "replay"


def test_every_limit_records_its_readings():
    for w in SPEC["workloads"]:
        doc = json.loads((ROOT / "benchmark" / "checks" / f"{w['name']}.json").read_text())
        for name, entry in doc["limits"].items():
            assert entry["limit"] > 0, (w["name"], name)


def test_no_file_of_the_benchmark_is_ignored_by_git():
    """A checkout holds only what git commits: a file the repository's
    ``.gitignore`` hid would be missing where the benchmark runs."""
    if not (ROOT / ".git").exists() or shutil.which("git") is None:
        pytest.skip("not a git checkout")
    files = [str(p.relative_to(ROOT)) for p in (ROOT / "benchmark").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts]
    proc = subprocess.run(["git", "check-ignore", "--stdin"], cwd=ROOT, input="\n".join(files),
                          capture_output=True, text=True)
    assert proc.stdout.strip() == ""


def test_lengths_are_continuous_fresh_each_cycle_and_the_same_for_a_seed():
    from benchmark.lib import audio

    def stream(seed):
        return audio.Requests(audio.Source(seed), [2, 10], [2, 10], 64, 8000)

    a, b = stream(2**31 + 3), stream(2**31 + 3)
    mix = [a.mix_len(i) for i in range(640)]
    assert mix == [b.mix_len(i) for i in range(640)]
    assert len(set(mix)) > 600  # continuous: hardly a length comes back
    for c in range(10):  # each cycle one length in each of 64 strata of 0.125 s
        cyc = sorted(mix[64 * c:64 * (c + 1)])
        assert all(16_000 + 1_000 * k <= n <= 16_000 + 1_000 * (k + 1) for k, n in enumerate(cyc))
    other = stream(2**31 + 4)
    assert [other.mix_len(i) for i in range(64)] != mix[:64]
    assert [a.ref_len(i) for i in range(64)] != mix[:64]
