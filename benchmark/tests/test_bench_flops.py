"""The operation and byte counts against hand counts, and the readers that
turn them into shares."""

import json
from pathlib import Path

import pytest

from benchmark.lib.registry import Registry

ROOT = Path(__file__).resolve().parents[2]
REG = Registry()
FL = REG.flops("dprnn")
SPE = REG.config("dprnn_spe_att")["model"]
BSS = REG.config("dprnn_tasnet")["model"]


def test_a_row_step_is_perf_mds_262144_plus_its_dense():
    assert 2 * (128 + 128) * 4 * 128 == 262_144
    assert FL.lstm_rowstep_flops(SPE) == 262_144 + 2 * 128 * 128


def test_frames_and_chunks_match_the_program():
    from tss_dprnn_tpu_torch.ops.chunking import num_chunks

    for n in (16_000, 24_000, 80_000, 80_001):
        L = n - 1  # kernel 2, stride 1
        assert FL.frames(SPE, n) == L
        assert FL.chunks(SPE, n) == num_chunks(L, 250, 125)


def test_a_3s_crop_has_the_training_scans_rows():
    # PERF.md: intra R=970 T=250 and inter R=1250 T=194 at 5 x 3 s
    assert FL.chunks(SPE, 24_000) == 194
    assert 5 * FL.chunks(SPE, 24_000) * 250 == 242_500


def test_lstm_calls_by_hand():
    calls = FL.lstm_calls(BSS, [24_000] * 5, train=True)
    assert len(calls) == 6 * 4
    rowsteps = 242_500
    fwd_ops = 2 * rowsteps * (262_144 + 32_768)
    weights = 2 * (128 * 512 + 128 * 512 + 512 + 128 * 128)
    assert calls[0] == (fwd_ops, 4 * (rowsteps * 256 + weights))
    assert calls[2] == (2 * fwd_ops, 4 * (rowsteps * 384 + 2 * weights))
    bound = FL.lstm_bound_s(BSS, [24_000] * 5, True, 165e12, 3.35e12)
    assert bound == pytest.approx(6 * (2 * fwd_ops + 2 * 2 * fwd_ops) / 165e12)


def test_forward_by_hand_at_tiny_widths():
    m = dict(input_size=2, feature_size=3, hidden_size=4, chunk_length=4, hop_length=2,
             kernel_size=2, n_repeats=1)
    T = 11  # L = 10 frames, S = (10 + 4) // 2 + 1 = 8 chunks
    L, S, K = 10, 8, 4
    row = 2 * (3 + 4) * 16 + 2 * 4 * 3
    want = (2 * L * 2 * 2 + 2 * L * 2 * 3 + 2 * 2 * S * K * row + 2 * S * K * 3 * 6
            + 2 * 2 * L * 3 * (6 + 2) + 2 * 2 * L * 2 * 2)
    assert FL.forward_flops(m, T) == want
    assert FL.step_flops(m, [T, T], [0, 0]) == 6 * want


def test_the_speaker_branch_by_hand():
    m = dict(SPE)
    la = 8_000 - 1
    l1, l2 = la // 3, la // 9
    want = (2 * la * 64 * 2 + 2 * la * 64 * 128 + 2 * la * 128 * 128 * 2
            + 2 * l1 * (128 * 256 + 256 * 256 + 128 * 256) + 2 * l2 * 256 * 256 * 2
            + 2 * (l2 // 3) * 256 * 128 + 2 * 128 * 64 + 2 * 128 * 251)
    assert FL.speaker_flops(m, 8_000) == want


class _Trace:
    busy_s = 0.8

    def __init__(self, ranges):
        self.ranges = ranges

    def in_range(self, name):
        return self.ranges.get(name, 0.0)

    def has_range(self, name):
        return name in self.ranges


class _Ctx:
    def __init__(self, trace=None, records=(), units=(), stretch_s=1.0, **stats):
        self.trace, self.stretch_s, self.units = trace, stretch_s, list(units)
        self.stats = dict(records=list(records), **stats)
        self.peaks = json.loads((ROOT / "benchmark" / "lib" / "peaks.json").read_text())
        self.traffic = {"loop": "serve", "bucketed": True}

    @property
    def profiled(self):
        return [self.stats["records"][i] for i in self.units]


def test_readers_on_hand_made_numbers():
    recs = [{"flops": 33e12, "lstm_bound_s": 0.1, "samples": 100, "padded": 25}] * 2
    ctx = _Ctx(_Trace({"bench.rnn": 0.5, "bench.optimizer": 0.1}), recs, [0], 1.0,
               window_s=2.0, audio_s=300.0, loader_wait_s=0.02, steps=4)
    assert REG.reader("mfu.serve").read(ctx) == pytest.approx(20.0)
    assert REG.reader("lstm_roofline.train").read(ctx) == pytest.approx(20.0)
    assert REG.reader("device_idle_pct.serve").read(ctx) == pytest.approx(20.0)
    assert REG.reader("glue_ms_per_step.train").read(ctx) == pytest.approx(200.0)
    assert REG.reader("optimizer_ms_per_step.train").read(ctx) == pytest.approx(100.0)
    assert REG.reader("padding_pct.serve").read(ctx) == pytest.approx(25.0)
    assert REG.reader("loader_wait_pct.train").read(ctx) == pytest.approx(1.0)
    assert REG.reader("serve_audio_s_per_s").read(ctx) == pytest.approx(150.0)
    assert REG.reader("train_step_ms").read(ctx) == pytest.approx(500.0)


def test_readers_find_nothing_without_a_trace():
    ctx = _Ctx(None, [], [], 0.0, window_s=1.0)
    for name in ("mfu.serve", "lstm_roofline.serve", "device_idle_pct.train",
                 "glue_ms_per_step.train", "optimizer_ms_per_step.train"):
        assert REG.reader(name).read(ctx) is None
    assert REG.reader("request_p95_ms").read(ctx) is None


def test_p95_is_the_nearest_rank():
    ctx = _Ctx(latencies_s=[i / 1000 for i in range(1, 101)], window_s=1.0)
    assert REG.reader("request_p95_ms").read(ctx) == pytest.approx(95.0)
