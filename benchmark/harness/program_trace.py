"""The traced part read from inside the program as well: ``ProgramTrace``
is ``DeviceTrace`` with the program's own span tracer
(``cilium_tpu_torch.observe.trace.TRACER``) armed over the same part, at
sample rate 1 in a ring of ``CAPACITY`` spans. Its spans are stamped on
the host's epoch clock, the profiler's, so each idle gap of the device is
named by the innermost program span open at its middle, on the pipeline's
worker (the thread that launches the step) first. The benchmark's wrappers
(``serve.Recorder``) name a gap only where no program span covers it.

A program whose tracer has no ``export()`` is left alone: the summary is
then ``DeviceTrace``'s. Armed only between the profiler's start and its
stop, so the window's host-timed first half and every untraced run run
the program as before.

The summary gains ``program_spans`` (the spans that start in the traced
part, as ``Tracer.export()`` gives them) and ``program_spans_dropped`` (the
ring's drop count), which the readers below take: each reads no value
when the ring dropped a span or holds none of its spans.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from benchmark.harness.trace import SHORT_GAP_NS, DeviceTrace

#: the ring the tracer is armed with: cfg3.serve records ~15 spans a batch
#: at ~20 batches/s, ~8,000 in a 26 s traced part
CAPACITY = 1 << 16
#: a short gap's label where no program span covers it (``DeviceTrace``'s)
BETWEEN = "between launches (gaps under 20 us)"
#: a long gap's label where neither a program span nor a wrapper covers it
NONE = "host: none of the timed calls"


def arm():
    """The program's tracer, reset and armed at rate 1 in a ring of
    ``CAPACITY``, with its former rate and capacity; None when the program
    has no ``export()``."""
    from cilium_tpu_torch.observe import trace
    tracer = getattr(trace, "TRACER", None)
    if not hasattr(tracer, "export"):
        return None
    before = (tracer.sample_rate, tracer.stats()["capacity"])
    tracer.configure(sample_rate=1.0, capacity=CAPACITY)
    tracer.reset()
    return tracer, before


def collect(armed) -> Tuple[List[Dict], int]:
    """(every span in the ring, the ring's drop count); the tracer set
    back to its former rate and capacity, and emptied."""
    tracer, (rate, capacity) = armed
    spans, dropped = tracer.export(), tracer.spans_dropped_total
    tracer.configure(sample_rate=rate, capacity=capacity)
    tracer.reset()
    return spans, dropped


def idle_intervals(events, t0: int, t1: int) -> List[Tuple[int, int]]:
    """The gaps in [t0, t1] in which no device operation ran (the
    complement of the union of ``events``' intervals, as
    ``DeviceTrace.summary`` takes it)."""
    gaps, cur_e, last_end = [], None, t0
    for _name, s, e in sorted(events, key=lambda x: x[1]):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            gaps.append((last_end, s))
            cur_e = e
        else:
            cur_e = max(cur_e, e)
        last_end = cur_e
    gaps.append((last_end, t1))
    return gaps


class _Timeline:
    """The innermost span open at each instant on one thread (spans opened
    with ``span()`` on one thread nest; a child's end, rounded apart from
    its parent's, is held to the parent's)."""

    def __init__(self, spans: List[Dict]):
        self.bounds: List[int] = []
        self.inner: List[Optional[Tuple[str, int]]] = []
        stack: List[Tuple[int, int, str]] = []
        for sp in sorted(spans, key=lambda s: (s["start_ns"],
                                               -s["end_ns"])):
            start = sp["start_ns"]
            while stack and stack[-1][1] <= start:
                self._close(stack)
            end = min(sp["end_ns"], stack[-1][1]) if stack else sp["end_ns"]
            stack.append((start, end, sp["name"]))
            self._mark(start, stack[-1])
        while stack:
            self._close(stack)

    def _mark(self, t: int, sp: Optional[Tuple[int, int, str]]) -> None:
        self.bounds.append(t)
        self.inner.append(None if sp is None else (sp[2], sp[1] - sp[0]))

    def _close(self, stack: List[Tuple[int, int, str]]) -> None:
        _start, end, _name = stack.pop()
        self._mark(end, stack[-1] if stack else None)

    def at(self, t: int) -> Optional[Tuple[str, int]]:
        """(name, length ns) of the innermost span covering ``t``."""
        i = bisect.bisect_right(self.bounds, t) - 1
        return self.inner[i] if i >= 0 else None


def _cover(worker: Optional[_Timeline], others: List[_Timeline],
           t: int) -> Optional[str]:
    """The name of the innermost program span covering ``t``: the
    worker's where it has one, else the shortest of the other threads'."""
    if worker is not None:
        got = worker.at(t)
        if got is not None:
            return got[0]
    found = [x for x in (tl.at(t) for tl in others) if x is not None]
    return min(found, key=lambda x: x[1])[0] if found else None


def name_gaps(gaps: List[Tuple[int, int]], program: List[Dict],
              host_spans: List[Tuple[str, int, int]]) -> Dict[str, float]:
    """Idle seconds by name. A gap of ``SHORT_GAP_NS`` or more takes the
    innermost program span at its middle, else the shortest wrapper
    covering it, else ``NONE``; a shorter gap is ``between launches:
    <span>``, or ``BETWEEN`` where no program span covers it."""
    by_thread = defaultdict(list)
    for sp in program:
        if sp["thread"] is not None:
            by_thread[sp["thread"]].append(sp)
    launches = Counter(sp["thread"] for sp in program
                       if sp["name"] == "pipeline.dispatch"
                       and sp["thread"] is not None)
    main = launches.most_common(1)[0][0] if launches else None
    worker = _Timeline(by_thread[main]) if main is not None else None
    others = [_Timeline(v) for k, v in by_thread.items() if k != main]
    names = [n for n, _s, _e in host_spans]
    starts = np.asarray([s for _n, s, _e in host_spans], np.int64)
    ends = np.asarray([e for _n, _s, e in host_spans], np.int64)
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        if b <= a:
            continue
        mid = (a + b) // 2
        span = _cover(worker, others, mid)
        if b - a < SHORT_GAP_NS:
            label = BETWEEN if span is None else f"between launches: {span}"
        elif span is not None:
            label = span
        else:
            cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = names[cover[np.argmin(ends[cover] - starts[cover])]] \
                if cover.size else NONE
        idle[label] += (b - a) / 1e9
    return dict(idle)


class ProgramTrace(DeviceTrace):
    """``DeviceTrace`` with the program's tracer armed over the traced
    part (see the module's docstring)."""

    def __init__(self):
        super().__init__()
        self._armed = arm()
        self.program: Optional[Tuple[List[Dict], int]] = None
        self.idle: Optional[Dict[str, float]] = None

    def stop(self) -> None:
        super().stop()
        if self._armed is not None:
            self.program = collect(self._armed)
            self._armed = None

    def summary(self, host_spans: List[Tuple[str, int, int]]) -> Dict:
        out = super().summary(host_spans)
        if self.program is None:
            return out
        spans, dropped = self.program
        kept = [s for s in spans if self.t0_ns <= s["start_ns"] < self.t1_ns]
        self.idle = name_gaps(idle_intervals(self.events(), self.t0_ns,
                                             self.t1_ns), kept, host_spans)
        out["idle_gaps"] = [[n, s] for n, s in sorted(
            self.idle.items(), key=lambda x: -x[1])[:10]]
        out["program_spans"] = kept
        out["program_spans_dropped"] = dropped
        return out


def _named(summary: Optional[Dict], name: str) -> Optional[List[Dict]]:
    """The traced part's program spans called ``name``; None when there is
    no export, the ring dropped a span, or it holds none of them."""
    if not summary or summary.get("program_spans_dropped", 1):
        return None
    got = [s for s in summary.get("program_spans", ()) if s["name"] == name]
    return got or None


def _mean_ms(spans: Optional[List[Dict]]) -> Optional[float]:
    if not spans:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in spans) / 1e6 / len(spans)


def queue_wait_ms(summary: Optional[Dict]) -> Optional[float]:
    """Mean ``pipeline.admission``: a submission's wait from submit to its
    dispatch."""
    return _mean_ms(_named(summary, "pipeline.admission"))


def device_wait_ms(summary: Optional[Dict]) -> Optional[float]:
    """Mean ``datapath.compute``: the finalize's wait on its dispatch's
    outputs, one a dispatch."""
    return _mean_ms(_named(summary, "datapath.compute"))


def salvage_ms(summary: Optional[Dict]) -> Optional[float]:
    """``engine.fold.salvage`` ms a finalized batch: their sum over the
    number of ``engine.fold.metrics`` spans (one a batch)."""
    salvage = _named(summary, "engine.fold.salvage")
    batches = _named(summary, "engine.fold.metrics")
    if not salvage or not batches:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in salvage) / 1e6 \
        / len(batches)
