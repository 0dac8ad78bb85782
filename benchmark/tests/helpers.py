"""Runs of a cell on the CPU at its test sizes (``test_sizes`` of its
configuration, ``test_flows`` of its mix)."""

import time

from benchmark.harness import cell as cells
from benchmark.harness.runner import run_cell

SEED = 2**31 + 12345
CELLS = ("cfg5.serve", "cfg3.serve")


def cpu_run(name, seed=SEED, seconds=2.0, trace=False, control=False):
    return run_cell(cells.load(name), seed, seconds, trace, "cpu",
                    time.perf_counter(), test_sizes=True, control=control)
