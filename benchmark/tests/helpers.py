"""Runs of a cell on the CPU at its test sizes (``test_sizes`` of its
configuration, ``test_flows`` of its mix); the cells of ``BENCHMARK.json``
and the test-only world of ``v6_l7.py``."""

import time

from benchmark.harness import cell as cells
from benchmark.harness.runner import run_cell
from benchmark.tests import v6_l7

SEED = 2**31 + 12345
CELLS = ("cfg5.serve", "cfg3.serve")


def load(name):
    """A cell of ``BENCHMARK.json``, or the test-only v6 + L7 world's."""
    return v6_l7.cell() if name == v6_l7.NAME else cells.load(name)


def cpu_run(name, seed=SEED, seconds=2.0, trace=False, control=False):
    return run_cell(load(name), seed, seconds, trace, "cpu",
                    time.perf_counter(), test_sizes=True, control=control)
