"""Without a CUDA device a run fails and prints no result: a measurement
path that finds no card does not fall back to the CPU."""

import os
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_a_run_without_a_card_fails(no_card):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "cfg5.serve", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=ROOT, env=env)
    assert r.returncode != 0
    assert "correct" not in r.stdout
