"""Submit → result p95 (ms) of the batches submitted in the traced run's
host-timed part (before any profiler session or call counting)."""

import numpy as np


def read(rec):
    a, b = rec["part1"]
    lat = [(r - s) / 1e6 for s, r, _n in rec["batches"] if a <= s < b]
    return float(np.percentile(lat, 95)) if len(lat) >= 20 else None
