"""On the card: a traced run at the test sizes reads every per-layer
metric of its cell (the device's share and the kernels' roofline from the
profiler, where the cell has them) and stays correct; the test-only v6 +
L7 world's too, through the CUDA kernels' v6 and L7 paths. Run on a
machine with a CUDA device:

    python -m pytest benchmark/tests/test_bench_card.py -m cuda -q
"""

import time

import pytest

from benchmark.harness.runner import run_cell
from benchmark.tests import v6_l7
from benchmark.tests.helpers import SEED, load


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cfg5.serve", "cfg3.serve", v6_l7.NAME])
def test_a_traced_run_reads_the_device(card, name):
    cell = load(name)
    res, _notes = run_cell(cell, SEED, 6.0, True, "cuda",
                           time.perf_counter(), test_sizes=True)
    assert res["correct"] is True
    dev = res["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    for m in cell.per_layer:
        assert m["name"] in res["metrics"], m["name"]
    if "kernels_roofline" in res["metrics"]:
        assert 0 < res["metrics"]["kernels_roofline"]["value"] <= 100
    assert res["breakdown"]["device_ops"]
