"""CPU tests of the benchmark: ``python -m pytest benchmark/tests -q`` from
the repository's root.  Tests marked ``card`` need a CUDA card and skip
elsewhere, deciding inside the test."""

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def tiny_spec(cell: str, **mix) -> dict:
    """The cell's spec from ``BENCHMARK.json`` on a tiny model of the same
    token layout (the kernels' CPU paths): d 64, 2 heads, one layer each,
    3 s windows, 40 positions."""
    from benchmark import run

    spec = copy.deepcopy(run.load_spec(ROOT, cell))
    spec["cfg"].update(d_model=64, encoder_layers=1, decoder_layers=1, encoder_attention_heads=2,
                       decoder_attention_heads=2, encoder_ffn_dim=256, decoder_ffn_dim=256,
                       max_source_positions=150, max_target_positions=40)
    spec["cfg"]["serving"]["decode_buckets"] = [16]
    if spec["mix"]["kind"] == "batch":
        spec["mix"].update(clip_s=3.0, pool_windows=2)
    spec["mix"].update(mix)
    return spec


def bench_json() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)
