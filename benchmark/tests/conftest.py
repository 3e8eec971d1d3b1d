"""Shared pieces of the benchmark's CPU tests: the repository root on the
path, tiny widths and traffic for a run on the CPU, and the CPU pinned to a
couple of threads."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_MODEL = dict(input_size=8, feature_size=16, hidden_size=16, chunk_length=10,
                  hop_length=5, n_repeats=1, O=8, P=12, embeddings_size=8, num_spks=10)


def shrink(config: dict, traffic: dict) -> None:
    """Tiny widths, 20-60 ms at 8 kHz, a cycle of 8 requests, short traced
    stretches: a whole run in about a second on the CPU."""
    model = config["model"]
    for k, v in TINY_MODEL.items():
        if k in model:
            model[k] = v
    traffic["ref_seconds"] = [0.02, 0.06]
    if traffic["loop"] == "serve":
        traffic.update(mix_seconds=[0.02, 0.06], cycle=8, warm_up=min(traffic["warm_up"], 8),
                       check_requests=3)
        if traffic["bucketed"]:
            traffic.update(batch_size=4, n_buckets=2, multiple=100, ref_multiple=100)
    else:
        traffic.update(crop_seconds=0.04, items=10)
    traffic["trace"] = {"start": 0, "units": 2}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
