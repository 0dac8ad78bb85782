"""The traced part of a window: ``torch.profiler`` over the card's
activity (no host ops recorded), and what its device events give: the seconds in
which some operation ran on the device (the union of their intervals),
each kernel's launches and device seconds, the operations that took most
time, and the longest idle gaps, each named by the host call that was
running at its middle (the benchmark's own timers, on the same clock:
the profiler's timestamps are the host's epoch nanoseconds)."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

#: idle gaps shorter than this are the launches' own spacing
SHORT_GAP_NS = 20_000


def _short(name: str) -> str:
    """A kernel's name without its template arguments and signature."""
    name = name.removeprefix("void ")
    cut = min([i for i in (name.find("<"), name.find("(")) if i > 0],
              default=len(name))
    return name[:cut][:120]


class DeviceTrace:
    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        t = time.perf_counter()
        self.prof.start()
        torch.cuda.synchronize()
        self.t0_ns = time.time_ns()
        self.start_s = time.perf_counter() - t
        self.t1_ns = None

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        t = time.perf_counter()
        self.prof.stop()
        self.stop_s = time.perf_counter() - t

    def events(self) -> List[Tuple[str, int, int]]:
        """(name, start ns, end ns) of every device operation."""
        from torch.autograd import DeviceType
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
                out.append((e.name(), e.start_ns(), e.end_ns()))
        return out

    def summary(self, host_spans: List[Tuple[str, int, int]]) -> Dict:
        ev = sorted(self.events(), key=lambda x: x[1])
        window_s = (self.t1_ns - self.t0_ns) / 1e9
        busy_ns, gaps = 0, []
        cur_s = cur_e = None
        last_end = self.t0_ns
        for _name, s, e in ev:
            s, e = max(s, self.t0_ns), min(e, self.t1_ns)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy_ns += cur_e - cur_s
                gaps.append((last_end, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
            last_end = cur_e
        if cur_e is not None:
            busy_ns += cur_e - cur_s
        gaps.append((last_end, self.t1_ns))
        by_name = defaultdict(float)
        short = defaultdict(float)
        launches = defaultdict(int)
        for name, s, e in ev:
            by_name[name] += (e - s) / 1e9
            short[_short(name)] += (e - s) / 1e9
            launches[name] += 1
        idle = defaultdict(float)
        names = [n for n, _s, _e in host_spans]
        starts = np.asarray([s for _n, s, _e in host_spans], np.int64)
        ends = np.asarray([e for _n, _s, e in host_spans], np.int64)
        for a, b in gaps:
            if b - a < SHORT_GAP_NS:
                idle["between launches (gaps under 20 us)"] += (b - a) / 1e9
                continue
            mid = (a + b) // 2
            cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = names[cover[np.argmin(ends[cover] - starts[cover])]] \
                if cover.size else "host: none of the timed calls"
            idle[label] += (b - a) / 1e9
        top = sorted(short.items(), key=lambda x: -x[1])[:10]
        return {"busy_s": busy_ns / 1e9, "window_s": window_s,
                "device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in sorted(
                    idle.items(), key=lambda x: -x[1])[:10]],
                "kernel_s": dict(by_name), "launches": dict(launches),
                "events": len(ev), "start_s": self.start_s,
                "stop_s": self.stop_s}
