"""Sampled span tracing for the serving path: one record per occurrence
of a stage (the pipeline's admission, dispatch and finalize, the
datapath's pack, transfer and the wait on the device, the engine's
finalize folds, GC ticks and regenerations), kept in a ring in memory.
``metrics.span`` keeps the cheap aggregate timers beside it.

Why another mechanism: SpanStat aggregates (count/total/max) cannot answer
"which *stage* made cfg4's p99 3.8x its p50" — that needs per-occurrence
records with a shared trace id across stages, and it must cost ~nothing on
the hot path. So:

- **Sampling is a counter, not an RNG.** ``maybe_sample()`` draws from an
  ``itertools.count`` (atomic under the GIL) and returns a trace id every
  Nth event (N = round(1/sample_rate)); every other event pays one
  ``next()`` + a modulo. Deterministic → tests can assert exact sample
  counts. At rate 0 nothing is drawn and ``span(None, ...)`` returns one
  shared no-op context.
- **Fixed-capacity ring.** Spans land in a preallocated ring (drop-oldest,
  every overwritten span counted in ``spans_dropped_total``); recording
  takes a lock only on the *sampled* path.
- **Trace context is a thread-local.** The pipeline worker (or classify
  caller) enters ``context(trace_id)``; downstream layers (the datapath's
  pack/transfer/compute split, the engine's folds) attach spans to
  whatever trace is current (:func:`active`) without any signature changes
  across the DatapathBackend boundary.
- **Attributes.** ``span(..., **attrs)`` gives a span its attributes;
  ``annotate(**attrs)`` on the entered span adds those the spanned work
  finds (a no-op on an unsampled span).
- **Span ids and parents.** A span opened with ``span()`` gets an id, and
  its parent is the innermost span still open on the same thread (the same
  thread-local), so a stage's self time is its duration less its
  children's. It carries its thread's ident. A span written after the
  fact with ``record()`` (``pipeline.admission``: one submission's queue
  wait) has an id but no parent and no thread.

Read sides: ``spans()``, ``summary()`` and ``stats()`` (the REST and CLI
surfaces, stamps on the monotonic clock) and ``export()``: every span in
the ring, oldest first, with its ids, its thread and its start and end in
integer nanoseconds on the host's epoch clock, the clock ``time.time_ns()``
reads and ``torch.profiler`` stamps device events with, so a span can be
laid beside the device's timeline. The monotonic stamps are moved onto it
by the offset between the two clocks read when the tracer is armed.

One process-wide instance (``TRACER``) mirrors the ``FAULTS`` singleton so
instrumentation points need no plumbing; independent ``Tracer`` objects
exist for unit tests.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

#: span tuple layout: (trace_id, name, t0_monotonic, duration_s, attrs|None,
#: span_id, parent span_id|None, thread ident|None)
_Span = Tuple[int, str, float, float, Optional[dict], int, Optional[int],
              Optional[int]]

DEFAULT_CAPACITY = 4096

#: Live-state fast-path span names. PATCH_APPLY_SPAN wraps the
#: device-side scatter-apply of a sparse policy delta
#: (TorchDatapath.place_patch — the "device-apply" half of a live rule
#: update; the host compile half rides the existing engine.regen.patch
#: span). CT_GC_SPAN wraps one GC tick's chunk-sweep enqueue
#: (TorchDatapath.sweep_step); the device runs the sweep later, in stream
#: order.
PATCH_APPLY_SPAN = "datapath.patch.apply"
CT_GC_SPAN = "datapath.ct.gc"


class _NullSpan:
    """Shared no-op context for unsampled events (no allocation per call)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    __slots__ = ("_tracer", "_tid", "_name", "_attrs", "_t0", "_sid",
                 "_outer")

    def __init__(self, tracer: "Tracer", tid: int, name: str, attrs):
        self._tracer = tracer
        self._tid = tid
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        self._sid = next(self._tracer._span_ids)
        self._outer = getattr(_ACTIVE, "open", None)
        _ACTIVE.open = (self._tracer, self._sid)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        dur = time.monotonic() - self._t0
        outer = self._outer
        _ACTIVE.open = outer
        parent = outer[1] if outer is not None \
            and outer[0] is self._tracer else None
        self._tracer._put((self._tid, self._name, self._t0, dur,
                           self._attrs, self._sid, parent,
                           threading.get_ident()))
        return False

    def annotate(self, **attrs) -> None:
        """Add attributes known only inside the span (a count the spanned
        work found)."""
        self._attrs = {**(self._attrs or {}), **attrs}


#: thread-local trace context: ``entry`` is (tracer, trace_id) of the
#: innermost ``Tracer.context`` block, ``open`` (tracer, span_id) of the
#: innermost span still open on the thread (the next span's parent).
#: Module-level (not per-Tracer) so downstream layers attach spans to
#: whichever tracer set the context — a Pipeline constructed with an
#: injected test tracer still gets its datapath spans.
_ACTIVE = threading.local()


def active() -> Tuple["Tracer", Optional[int]]:
    """The cross-layer read point: (tracer, trace_id) of the thread's
    current trace context, or (TRACER, None) when none is set."""
    entry = getattr(_ACTIVE, "entry", None)
    return entry if entry is not None else (TRACER, None)


class _TraceCtx:
    """Sets/restores the thread-local current trace context."""

    __slots__ = ("_tracer", "_tid", "_prev")

    def __init__(self, tracer: "Tracer", tid: Optional[int]):
        self._tracer = tracer
        self._tid = tid

    def __enter__(self):
        self._prev = getattr(_ACTIVE, "entry", None)
        _ACTIVE.entry = (self._tracer, self._tid)
        return self._tid

    def __exit__(self, *exc):
        _ACTIVE.entry = self._prev
        return False


class Tracer:
    def __init__(self, sample_rate: float = 0.0,
                 capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._events = itertools.count()
        self._trace_ids = itertools.count(1)
        self._span_ids = itertools.count(1)
        self._epoch_offset_ns = 0   # epoch ns − monotonic ns, when armed
        self._ring: List[Optional[_Span]] = []
        self._widx = 0
        self._filled = 0           # occupied ring slots (O(1) stats read)
        self.sampled_total = 0     # counter-sampled events (maybe_sample)
        self.forced_total = 0      # always-traced events (regen, autotune)
        # drop-oldest accounting: the ring used to wrap
        # silently — a span summary over a storm looked complete while
        # thousands of spans had been overwritten. Every overwritten slot
        # counts; wraps counts full ring cycles.
        self.spans_dropped_total = 0
        self.ring_wraps = 0
        self.configure(sample_rate=sample_rate, capacity=capacity)

    # -- configuration -------------------------------------------------------
    def configure(self, sample_rate: Optional[float] = None,
                  capacity: Optional[int] = None) -> None:
        """Set the sampling rate (0 disables tracing entirely; 1.0 samples
        every event; 1/64 samples every 64th) and/or the ring capacity."""
        with self._lock:
            if sample_rate is not None:
                if sample_rate <= 0:
                    self._every = 0                  # disabled
                elif sample_rate >= 1.0:
                    self._every = 1
                else:
                    self._every = max(1, round(1.0 / sample_rate))
                if self._every:
                    # export()'s clock: spans keep their monotonic stamps
                    self._epoch_offset_ns = time.time_ns() \
                        - time.monotonic_ns()
            if capacity is not None:
                if capacity < 1:
                    raise ValueError("trace capacity must be >= 1")
                # reallocate (discarding spans) only on an actual change —
                # re-stating the current capacity must not wipe the ring
                if capacity != len(self._ring):
                    self._ring = [None] * capacity
                    self._widx = 0
                    self._filled = 0

    @property
    def enabled(self) -> bool:
        return self._every > 0

    @property
    def sample_rate(self) -> float:
        return 0.0 if self._every == 0 else 1.0 / self._every

    def reset(self) -> None:
        with self._lock:
            self._ring = [None] * len(self._ring)
            self._widx = 0
            self._filled = 0
            self.sampled_total = 0
            self.forced_total = 0
            self.spans_dropped_total = 0
            self.ring_wraps = 0
            self._events = itertools.count()
            self._trace_ids = itertools.count(1)
            self._span_ids = itertools.count(1)

    # -- hot path ------------------------------------------------------------
    def maybe_sample(self) -> Optional[int]:
        """The per-event sampling decision. Unsampled cost: one atomic
        counter draw + a modulo — this is what the hot path pays."""
        every = self._every
        if every == 0:
            return None
        n = next(self._events)
        if every != 1 and n % every:
            return None
        # the sampled branch is the rare one — fine to take the lock here
        # (an unlocked += would lose increments across producer threads)
        with self._lock:
            self.sampled_total += 1
        return next(self._trace_ids)

    def force_sample(self) -> Optional[int]:
        """A trace id regardless of the sampling counter (rare events worth
        always recording — regenerations, autotune decisions). Still None
        when tracing is disabled outright."""
        if self._every == 0:
            return None
        with self._lock:
            # a separate counter: forced traces (regen, autotune decisions)
            # must not skew the sampled-submission count that coverage math
            # (sampled_total x 1/rate ~= submissions) relies on
            self.forced_total += 1
        return next(self._trace_ids)

    def span(self, trace_id: Optional[int], name: str, **attrs):
        """Context manager recording one span when ``trace_id`` is not None
        (the no-op path allocates nothing)."""
        if trace_id is None:
            return _NULL_SPAN
        return _SpanCtx(self, trace_id, name, attrs or None)

    def record(self, trace_id: Optional[int], name: str, t0: float,
               duration_s: float, attrs: Optional[dict] = None) -> None:
        """Write a span after the fact (``t0`` on ``time.monotonic()``):
        it gets an id, but no parent and no thread."""
        if trace_id is None:
            return
        self._put((trace_id, name, t0, duration_s, attrs,
                   next(self._span_ids), None, None))

    def _put(self, span: _Span) -> None:
        with self._lock:
            ring = self._ring
            overwrote = ring[self._widx] is not None
            if not overwrote:
                self._filled += 1
            else:
                # drop-oldest: the evicted span is LOST to every later
                # summary/export — count it so /v1/trace can say how much
                # of the story the ring no longer holds
                self.spans_dropped_total += 1
            ring[self._widx] = span
            self._widx = (self._widx + 1) % len(ring)
            # a wrap is a completed cycle of LOSS, so the initial free
            # fill doesn't count — keeps drops == wraps * capacity (+
            # the partial cycle) mutually consistent
            if self._widx == 0 and overwrote:
                self.ring_wraps += 1

    def event(self, name: str, **attrs) -> Optional[int]:
        """Record a zero-duration decision event (always, when enabled)."""
        tid = self.force_sample()
        if tid is not None:
            self.record(tid, name, time.monotonic(), 0.0, attrs or None)
        return tid

    # -- trace-context propagation -------------------------------------------
    def current(self) -> Optional[int]:
        """The thread's current trace id (whichever tracer set it)."""
        entry = getattr(_ACTIVE, "entry", None)
        return entry[1] if entry is not None else None

    def context(self, trace_id: Optional[int]) -> _TraceCtx:
        """Make ``trace_id`` the thread's current trace for the with-block
        (downstream spans attach via :func:`active` / :meth:`current`)."""
        return _TraceCtx(self, trace_id)

    # -- read side -----------------------------------------------------------
    def _snapshot(self) -> List[_Span]:
        """Ring contents oldest→newest."""
        with self._lock:
            ring, w = list(self._ring), self._widx
        ordered = ring[w:] + ring[:w]
        return [s for s in ordered if s is not None]

    def spans(self, limit: int = 100, name: Optional[str] = None,
              trace_id: Optional[int] = None) -> List[Dict]:
        out = []
        for tid, nm, t0, dur, attrs, *_ids in self._snapshot():
            if name is not None and nm != name:
                continue
            if trace_id is not None and tid != trace_id:
                continue
            d = {"trace_id": tid, "name": nm, "start_mono": round(t0, 6),
                 "duration_ms": round(dur * 1e3, 6)}
            if attrs:
                d["attrs"] = attrs
            out.append(d)
        return out[-limit:]

    def summary(self) -> Dict[str, Dict]:
        """Per-stage aggregate over the spans currently in the ring:
        count + p50/p99/max/total (ms) — the bench/CLI surface."""
        by_name: Dict[str, List[float]] = {}
        for _tid, nm, _t0, dur, *_rest in self._snapshot():
            by_name.setdefault(nm, []).append(dur)
        out = {}
        for nm in sorted(by_name):
            v = np.asarray(by_name[nm], dtype=np.float64) * 1e3
            out[nm] = {
                "count": int(v.size),
                "p50_ms": round(float(np.percentile(v, 50)), 4),
                "p99_ms": round(float(np.percentile(v, 99)), 4),
                "max_ms": round(float(v.max()), 4),
                "total_ms": round(float(v.sum()), 4),
            }
        return out

    def export(self) -> List[Dict]:
        """Every span in the ring, oldest first: ``trace_id``, ``span_id``,
        ``parent_id`` (None for a root or a recorded span), ``name``,
        ``start_ns`` and ``end_ns`` (integer nanoseconds on the host's
        epoch clock, ``time.time_ns()``'s), ``thread`` (the ident of the
        thread that opened it; None for a recorded span) and ``attrs``."""
        off = self._epoch_offset_ns
        out = []
        for tid, nm, t0, dur, attrs, sid, parent, thread in self._snapshot():
            start = round(t0 * 1e9) + off
            out.append({"trace_id": tid, "span_id": sid, "parent_id": parent,
                        "name": nm, "start_ns": start,
                        "end_ns": start + round(dur * 1e9),
                        "thread": thread, "attrs": attrs})
        return out

    def stats(self) -> Dict:
        # O(1) under the lock — this runs on every /v1/status scrape and
        # must not stall hot-path record() for a full-ring scan
        with self._lock:
            recorded = self._filled
            capacity = len(self._ring)
        return {
            "enabled": self.enabled,
            "sample_rate": self.sample_rate,
            "sampled_total": self.sampled_total,
            "forced_total": self.forced_total,
            "spans_in_ring": recorded,
            "capacity": capacity,
            # drop-oldest accounting: spans overwritten before
            # any export saw them + full ring cycles — the "how much of
            # the story is gone" fields the CLI prints
            "spans_dropped_total": self.spans_dropped_total,
            "ring_wraps": self.ring_wraps,
        }


#: process-wide tracer (the FAULTS-singleton idiom): instrumentation points
#: in pipeline/engine/datapath use this; DaemonConfig.trace_* configures it.
TRACER = Tracer()
