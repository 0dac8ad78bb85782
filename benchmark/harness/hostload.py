"""What the host did during the window, from the process's own usage.

``HostSampler.sample`` is called from the loop's thread between
submissions and keeps at most one reading a second: the rows resolved so
far and the process's user and system CPU seconds. ``series`` turns the
readings into per-interval rates. ``threads`` reads each thread's CPU
seconds by name (``/proc/self/task``, read only).
"""

from __future__ import annotations

import os
import resource
import threading
import time
from typing import Dict, List

_TICK = os.sysconf("SC_CLK_TCK")


def threads() -> Dict[str, float]:
    """CPU seconds (user + system) of each of this process's threads,
    summed by name (Python's name for a Python thread)."""
    out: Dict[str, float] = {}
    names = {t.native_id: t.name for t in threading.enumerate()}
    base = "/proc/self/task"
    try:
        tids = os.listdir(base)
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"{base}/{tid}/stat") as f:
                s = f.read()
        except OSError:
            continue
        name = names.get(int(tid), s[s.index("(") + 1:s.rindex(")")])
        rest = s[s.rindex(")") + 2:].split()
        out[name] = out.get(name, 0.0) + (int(rest[11]) + int(rest[12])) \
            / _TICK
    return out


class HostSampler:
    def __init__(self, every_s: float = 1.0):
        self.every_s = every_s
        self.readings: List[tuple] = []
        self._next = 0.0

    def sample(self, rows_done: int, force: bool = False) -> None:
        t = time.perf_counter()
        if not force and t < self._next:
            return
        self._next = t + self.every_s
        ru = resource.getrusage(resource.RUSAGE_SELF)
        self.readings.append((t, rows_done, ru.ru_utime, ru.ru_stime))

    def series(self) -> Dict[str, List[float]]:
        """Per interval between readings: ``rate`` (rows/s), ``user`` and
        ``sys`` (the process's CPU seconds a second)."""
        out = {k: [] for k in ("rate", "user", "sys")}
        for a, b in zip(self.readings, self.readings[1:]):
            dt = b[0] - a[0]
            if dt <= 0:
                continue
            for k, j in (("rate", 1), ("user", 2), ("sys", 3)):
                out[k].append((b[j] - a[j]) / dt)
        return out
