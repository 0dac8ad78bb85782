"""The port's observability layer against the JAX package's, case for case
with ``tests/test_observe.py``: the tracer's counter sampling and span
ring, tracing through the pipeline and the engine, the flow-metrics
windows, the autotuner's hysteresis against a stub pipeline, and the
engine's integration (the autotune controller, the dirty mark, the REST
routes, the metrics textfile).

Each case runs the reference's body once on each package (the engines on
each package's ``FakeDatapath``, the port's with ``device="cpu"``),
asserts the reference's expectations on both, and holds a side-neutral
observation equal: sampling decisions, span names and counts (never their
wall-clock durations), flow-metric windows and their Prometheus text,
knob trajectories, verdict columns, counters and REST documents with
their timings left out. ``TestTraceOverheadSoak`` keeps ``slow``.
"""

import threading
import time

import numpy as np
import pytest

from tests.test_torch_datapath import SIDES
from tests.test_torch_pipeline import (POLICY, EchoDispatch, assert_parity,
                                       fake_engine, host, mk_chunks, pkt,
                                       sub_batch)


def both(case):
    """Run ``case(m)`` on each package's modules. → the port's
    observation, held equal to the reference's."""
    obs = {s: case(host(s)) for s in SIDES}
    assert obs["jax"] == obs["torch"]
    return obs["torch"]


@pytest.fixture(autouse=True)
def _quiet_tracer():
    """Engines configure each package's process-wide TRACER from their
    DaemonConfig; leave both disabled and empty for the next test."""
    yield
    for s in SIDES:
        m = host(s)
        m.trace.TRACER.configure(sample_rate=0.0)
        m.trace.TRACER.reset()
        m.faults.FAULTS.reset()


def span_names(spans):
    return [s["name"] for s in spans]


def counts(summary):
    """A tracer summary's span counts by name (its ms are wall clock)."""
    return {k: v["count"] for k, v in summary.items()}


class TestTracer:
    def test_disabled_costs_nothing_and_records_nothing(self):
        @both
        def _(m):
            t = m.trace.Tracer(sample_rate=0.0, capacity=8)
            assert not t.enabled
            assert t.maybe_sample() is None and t.force_sample() is None
            with t.span(None, "x"):
                pass
            t.record(None, "x", 0.0, 1.0)
            assert t.spans() == [] and t.summary() == {}
            assert t.event("decision") is None
            return t.stats()

    def test_counter_sampling_is_deterministic(self):
        @both
        def _(m):
            t = m.trace.Tracer(sample_rate=0.25, capacity=64)
            decisions = [t.maybe_sample() is not None for _ in range(12)]
            assert decisions == [True, False, False, False] * 3
            assert t.sampled_total == 3
            return decisions, t.sampled_total

    def test_rate_one_samples_everything(self):
        @both
        def _(m):
            t = m.trace.Tracer(sample_rate=1.0, capacity=64)
            ids = [t.maybe_sample() for _ in range(10)]
            assert all(i is not None for i in ids)
            return ids

    def test_ring_keeps_newest(self):
        @both
        def _(m):
            t = m.trace.Tracer(sample_rate=1.0, capacity=4)
            for i in range(10):
                t.record(i + 1, f"s{i}", 0.0, 0.001 * i)
            spans = t.spans(limit=100)
            assert span_names(spans) == ["s6", "s7", "s8", "s9"]
            return spans

    def test_span_context_manager_and_summary(self):
        @both
        def _(m):
            t = m.trace.Tracer(sample_rate=1.0, capacity=64)
            tid = t.maybe_sample()
            for _ in range(5):
                with t.span(tid, "stage.a"):
                    pass
            t.record(tid, "stage.b", 0.0, 0.010)
            s = t.summary()
            assert s["stage.a"]["count"] == 5
            assert s["stage.b"]["p50_ms"] == pytest.approx(10.0, rel=0.01)
            assert s["stage.a"]["p99_ms"] >= s["stage.a"]["p50_ms"]
            return counts(s), s["stage.b"]

    def test_trace_context_is_thread_local(self):
        @both
        def _(m):
            t = m.trace.Tracer(sample_rate=1.0, capacity=16)
            seen = {}
            with t.context(42):
                assert t.current() == 42

                def peek():
                    seen["other"] = t.current()
                th = threading.Thread(target=peek)
                th.start()
                th.join()
                with t.context(7):
                    assert t.current() == 7
                assert t.current() == 42
            assert t.current() is None and seen["other"] is None
            return seen

    def test_context_propagates_across_tracer_instances(self):
        @both
        def _(m):
            t1 = m.trace.Tracer(sample_rate=1.0, capacity=8)
            t2 = m.trace.Tracer(sample_rate=1.0, capacity=8)
            with t1.context(5):
                tr, tid = m.trace.active()
                assert tr is t1 and tid == 5
                assert t2.current() == 5
            tr, tid2 = m.trace.active()
            assert tr is m.trace.TRACER and tid2 is None
            return tid, tid2

    def test_event_records_with_attrs(self):
        @both
        def _(m):
            t = m.trace.Tracer(sample_rate=1 / 64, capacity=16)
            t.event("autotune.decision", knob="flush_ms", old=2.0, new=1.0)
            spans = t.spans(name="autotune.decision")
            assert len(spans) == 1
            assert spans[0]["attrs"]["knob"] == "flush_ms"
            return [(s["name"], s["trace_id"], s["attrs"]) for s in spans]

    def test_stats_shape(self):
        @both
        def _(m):
            t = m.trace.Tracer(sample_rate=0.5, capacity=8)
            tid = t.maybe_sample()
            t.record(tid, "x", 0.0, 0.001)
            st = t.stats()
            assert st["enabled"] and st["capacity"] == 8
            assert st["spans_in_ring"] == 1 and st["sample_rate"] == 0.5
            return st

    def test_forced_events_do_not_skew_sampled_total(self):
        @both
        def _(m):
            t = m.trace.Tracer(sample_rate=0.25, capacity=16)
            for _ in range(8):
                t.maybe_sample()
            t.force_sample()
            t.event("autotune.decision", knob="flush_ms")
            st = t.stats()
            assert st["sampled_total"] == 2
            assert st["forced_total"] == 2
            return st

    def test_reconfigure_same_capacity_preserves_ring(self):
        @both
        def _(m):
            t = m.trace.Tracer(sample_rate=1.0, capacity=8)
            t.record(t.maybe_sample(), "x", 0.0, 0.001)
            t.configure(sample_rate=1.0, capacity=8)
            kept = len(t.spans())
            assert kept == 1
            t.configure(capacity=4)
            assert t.spans() == []
            return kept, t.stats()

    def test_engine_with_tracing_off_leaves_global_tracer_alone(self):
        @both
        def _(m):
            tracer = m.trace.TRACER
            tracer.configure(sample_rate=1.0, capacity=32)
            tid = tracer.maybe_sample()
            tracer.record(tid, "pre.existing", 0.0, 0.001)
            eng = fake_engine(m)
            assert tracer.enabled
            names = span_names(tracer.spans())
            assert "pre.existing" in names
            eng.stop()
            return names


class TestPipelineTracing:
    def test_stage_spans_recorded_at_rate_one(self):
        @both
        def _(m):
            d = EchoDispatch()
            tr = m.trace.Tracer(sample_rate=1.0, capacity=256)
            pl = m.pipeline.Pipeline(d, min_bucket=4, max_bucket=16,
                                     flush_ms=1.0, tracer=tr)
            try:
                pl.submit(sub_batch(m, 16, start=100)).result(timeout=5)
                for i in range(6):
                    pl.submit(sub_batch(m, 3, start=i * 4))
                assert pl.drain(timeout=10)
                s = tr.summary()
                assert s["pipeline.admission"]["count"] == 7
                assert s["pipeline.microbatch"]["count"] == 6
                assert s["pipeline.dispatch"]["count"] >= 2
                assert s["pipeline.finalize"]["count"] \
                    == s["pipeline.dispatch"]["count"]
                # the deadline flushes' grouping follows the wall clock:
                # the counts compared are those the scheduler fixes
                return ({k: s[k]["count"] for k in ("pipeline.admission",
                                                    "pipeline.microbatch")},
                        d.sports_seen)
            finally:
                pl.close(timeout=5)

    def test_unsampled_pipeline_records_nothing(self):
        @both
        def _(m):
            d = EchoDispatch()
            tr = m.trace.Tracer(sample_rate=0.0, capacity=64)
            pl = m.pipeline.Pipeline(d, min_bucket=4, max_bucket=16,
                                     flush_ms=1.0, tracer=tr)
            try:
                for i in range(5):
                    pl.submit(sub_batch(m, 4, start=i * 4))
                assert pl.drain(timeout=10)
                assert tr.spans() == []
                return tr.stats(), d.sports_seen
            finally:
                pl.close(timeout=5)

    def test_runtime_knob_setters_validate(self):
        @both
        def _(m):
            d = EchoDispatch()
            pl = m.pipeline.Pipeline(d, min_bucket=4, max_bucket=16,
                                     flush_ms=2.0)
            try:
                pl.set_flush_ms(7.5)
                assert pl.flush_ms == pytest.approx(7.5)
                pl.set_min_bucket(8)
                assert pl.min_bucket == 8
                st = pl.stats()
                assert st["min_bucket"] == 8
                assert st["flush_ms"] == pytest.approx(7.5)
                refused = []
                for call, arg in ((pl.set_min_bucket, 12),
                                  (pl.set_min_bucket, 32),
                                  (pl.set_flush_ms, 0)):
                    with pytest.raises(ValueError) as e:
                        call(arg)
                    refused.append(str(e.value))
                out = pl.submit(sub_batch(m, 8, start=0)).result(timeout=5)
                assert pl.flush_reasons["direct"] >= 1
                return (pl.flush_ms, pl.min_bucket, refused,
                        out["reason"].tolist(), pl.flush_reasons["direct"])
            finally:
                pl.close(timeout=5)

    def test_engine_parity_bit_identical_with_tracing_at_one(self):
        @both
        def _(m):
            engines = []
            for _ in range(2):
                eng = fake_engine(m, trace_sample_rate=1.0,
                                  pipeline_min_bucket=16,
                                  pipeline_flush_ms=1.0)
                eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",),
                                 ep_id=1)
                eng.apply_policy(POLICY)
                engines.append(eng)
            ser, piped = engines
            chunks = mk_chunks(m, ser.active.snapshot.ep_slot_of,
                               n_chunks=18, rows_per_chunk=5)
            obs = assert_parity(ser, piped, chunks)
            names = set(m.trace.TRACER.summary())
            want = {"pipeline.admission", "pipeline.dispatch",
                    "pipeline.finalize", "engine.classify"}
            assert want <= names
            piped.stop()
            ser.stop()
            return obs, sorted(want & names)


class TestFlowMetrics:
    @staticmethod
    def _batch_out():
        n = 8
        batch = {
            "valid": np.array([1, 1, 1, 1, 1, 1, 0, 0], bool),
            "proto": np.array([6, 6, 17, 6, 6, 1, 6, 6], np.int32),
            "dport": np.array([443, 443, 53, 80, 443, 0, 9, 9], np.int32),
        }
        out = {
            "allow": np.array([1, 1, 1, 0, 0, 1, 1, 1], bool),
            "reason": np.zeros(n, np.int32),
            "remote_identity": np.array([5, 5, 7, 5, 9, 7, 1, 1], np.int32),
        }
        out["reason"][3] = 133
        out["reason"][4] = 133
        return batch, out

    def test_vectorized_counts(self):
        @both
        def _(m):
            fm = m.flowmetrics.FlowMetrics(window_s=10, n_windows=4, top_k=3)
            batch, out = self._batch_out()
            fm.add_batch(batch, out, now=105)
            [w] = fm.series()
            assert w["window_start"] == 100
            assert w["forwarded"] == 4 and w["dropped"] == 2
            assert sum(w["drop_reasons"].values()) == 2
            assert w["protos"] == {"TCP": 4, "UDP": 1, "ICMP": 1}
            assert w["top_ports"][0] == {"port": 443, "count": 3}
            assert {d["identity"]: d["count"]
                    for d in w["top_identities"]} == {5: 3, 7: 2, 9: 1}
            assert all(p["port"] != 9 for p in w["top_ports"])
            return w

    def test_windows_advance_and_cap(self):
        @both
        def _(m):
            fm = m.flowmetrics.FlowMetrics(window_s=10, n_windows=3, top_k=3)
            batch, out = self._batch_out()
            for now in (5, 15, 25, 35, 45):
                fm.add_batch(batch, out, now=now)
            series = fm.series()
            assert [w["window_start"] for w in series] == [20, 30, 40]
            t = fm.totals()
            assert t["forwarded"] == 4 * 5 and t["batches"] == 5
            return series, t

    def test_same_window_accumulates(self):
        @both
        def _(m):
            fm = m.flowmetrics.FlowMetrics(window_s=10, n_windows=3)
            batch, out = self._batch_out()
            fm.add_batch(batch, out, now=100)
            fm.add_batch(batch, out, now=109)
            [w] = fm.series()
            assert w["forwarded"] == 8 and w["dropped"] == 4
            return w

    def test_axis_cardinality_bounded(self):
        @both
        def _(m):
            fmod = m.flowmetrics
            fm = fmod.FlowMetrics(window_s=10, n_windows=2, top_k=5)
            n = fmod.AXIS_CAP + 50
            batch = {"valid": np.ones(n, bool),
                     "proto": np.full(n, 6, np.int32),
                     "dport": np.arange(n, dtype=np.int32)}
            out = {"allow": np.ones(n, bool),
                   "reason": np.zeros(n, np.int32),
                   "remote_identity": np.zeros(n, np.int32)}
            fm.add_batch(batch, out, now=10)
            with fm._lock:
                kept = len(fm._totals.ports)
                assert kept <= fmod.AXIS_CAP
                total = (sum(fm._totals.ports.values())
                         + fm._totals.ports_other)
            assert total == n
            text = fm.render_prometheus()
            assert 'ciliumtpu_flow_port_total{port="other"}' in text
            return fmod.AXIS_CAP, kept, total, text

    def test_totals_series_stay_monotone_under_churn(self):
        @both
        def _(m):
            fmod = m.flowmetrics

            def parse(text):
                return {ln.rpartition(" ")[0]: int(ln.rpartition(" ")[2])
                        for ln in text.splitlines()
                        if ln.startswith("ciliumtpu_flow_port_total")}

            fm = fmod.FlowMetrics(window_s=10, n_windows=2, top_k=5)
            rng = np.random.default_rng(3)
            prev = {}
            for round_i in range(6):
                n = fmod.AXIS_CAP
                batch = {"valid": np.ones(n, bool),
                         "proto": np.full(n, 6, np.int32),
                         "dport": (rng.integers(0, 2 * fmod.AXIS_CAP, n)
                                   + round_i * 37).astype(np.int32)}
                out = {"allow": np.ones(n, bool),
                       "reason": np.zeros(n, np.int32),
                       "remote_identity": np.zeros(n, np.int32)}
                fm.add_batch(batch, out, now=round_i * 10)
                cur = parse(fm.render_prometheus())
                for series, value in prev.items():
                    assert series in cur, f"series vanished: {series}"
                    assert cur[series] >= value, f"decreased: {series}"
                prev = cur
            return prev

    def test_prometheus_render(self):
        @both
        def _(m):
            fm = m.flowmetrics.FlowMetrics(window_s=10, n_windows=2, top_k=2)
            batch, out = self._batch_out()
            fm.add_batch(batch, out, now=7)
            text = fm.render_prometheus()
            assert ('ciliumtpu_flow_verdicts_total{verdict="FORWARDED"} 4'
                    in text)
            assert ('ciliumtpu_flow_verdicts_total{verdict="DROPPED"} 2'
                    in text)
            assert 'ciliumtpu_flow_proto_total{proto="TCP"} 4' in text
            assert 'ciliumtpu_flow_port_total{port="443"} 3' in text
            for ident, k in ((5, 3), (7, 2), (9, 1)):
                assert (f'ciliumtpu_flow_identity_total{{identity='
                        f'"{ident}"}} {k}') in text
            assert 'identity="other"' not in text
            return text


class _StubPipeline:
    """``test_observe.py``'s duck-typed pipeline: the test scripts the
    interval deltas and the queue-wait observations go straight into the
    shared metrics histogram."""

    def __init__(self, metrics, flush_ms=2.0, min_bucket=256,
                 max_bucket=8192):
        self.metrics = metrics
        self._flush_ms = flush_ms
        self._min_bucket = min_bucket
        self._max_bucket = max_bucket
        self.dispatched = 0
        self.fill_rows = 0
        self.bucket_rows = 0
        self.reasons = {"direct": 0, "full": 0, "deadline": 0, "drain": 0}

    flush_ms = property(lambda self: self._flush_ms)
    min_bucket = property(lambda self: self._min_bucket)
    max_bucket = property(lambda self: self._max_bucket)

    def set_flush_ms(self, v):
        self._flush_ms = v

    def set_min_bucket(self, v):
        self._min_bucket = v

    def stats(self):
        return {"dispatched_batches": self.dispatched,
                "fill_rows": self.fill_rows,
                "bucket_rows": self.bucket_rows,
                "flush_reasons": dict(self.reasons)}

    def interval(self, batches=10, fill=0.9, wait_ms=1.0, reason="full"):
        h = self.metrics.histogram("pipeline_queue_wait_seconds")
        for _ in range(batches):
            h.observe(wait_ms / 1e3)
        self.dispatched += batches
        self.bucket_rows += batches * 1024
        self.fill_rows += int(batches * 1024 * fill)
        self.reasons[reason] += batches


def mk_autotuner(m, pl, metrics, **kw):
    kw.setdefault("flush_ms_min", 0.5)
    kw.setdefault("flush_ms_max", 16.0)
    kw.setdefault("min_bucket_floor", 64)
    kw.setdefault("queue_wait_p99_budget_ms", 5.0)
    kw.setdefault("hysteresis", 3)
    kw.setdefault("step_factor", 2.0)
    return m.autotune.Autotuner(
        pl, metrics, tracer=m.trace.Tracer(sample_rate=1.0, capacity=64),
        **kw)


def adjustments(at):
    """The autotuner's decisions without their wall-clock stamps."""
    return [{k: v for k, v in a.items() if k not in ("t", "ts", "time")}
            for a in at.adjustments]


class TestAutotuner:
    def test_needs_hysteresis_before_acting(self):
        @both
        def _(m):
            metrics = m.metrics.Metrics()
            pl = _StubPipeline(metrics)
            at = mk_autotuner(m, pl, metrics)
            pl.interval(wait_ms=50.0)
            assert at.step() is None
            for _ in range(2):
                pl.interval(wait_ms=50.0)
                at.step()
            assert pl.flush_ms == 2.0
            pl.interval(wait_ms=50.0)
            obs = at.step()
            assert pl.flush_ms == 1.0
            assert obs["adjusted"][0]["knob"] == "flush_ms"
            return pl.flush_ms, adjustments(at)

    def test_converges_down_under_sustained_burst_and_respects_floor(self):
        @both
        def _(m):
            metrics = m.metrics.Metrics()
            pl = _StubPipeline(metrics, flush_ms=8.0)
            at = mk_autotuner(m, pl, metrics)
            history = []
            for _ in range(30):
                pl.interval(wait_ms=40.0, fill=0.9)
                at.step()
                history.append(pl.flush_ms)
            assert pl.flush_ms == 0.5
            assert all(b <= a for a, b in zip(history, history[1:]))
            return history

    def test_raises_flush_when_underfilled_and_fast(self):
        @both
        def _(m):
            metrics = m.metrics.Metrics()
            pl = _StubPipeline(metrics, flush_ms=1.0)
            at = mk_autotuner(m, pl, metrics)
            history = []
            for _ in range(8):
                pl.interval(wait_ms=0.5, fill=0.2, reason="deadline")
                at.step()
                history.append((pl.flush_ms, pl.min_bucket))
            assert pl.flush_ms > 1.0
            return history

    def test_dead_band_is_stable(self):
        @both
        def _(m):
            metrics = m.metrics.Metrics()
            pl = _StubPipeline(metrics)
            at = mk_autotuner(m, pl, metrics)
            for _ in range(12):
                pl.interval(wait_ms=1.0, fill=0.8)
                at.step()
            assert pl.flush_ms == 2.0 and not at.adjustments
            return pl.flush_ms, pl.min_bucket

    def test_alternating_load_never_oscillates(self):
        @both
        def _(m):
            metrics = m.metrics.Metrics()
            pl = _StubPipeline(metrics)
            at = mk_autotuner(m, pl, metrics)
            for i in range(20):
                if i % 2:
                    pl.interval(wait_ms=50.0, fill=0.9)
                else:
                    pl.interval(wait_ms=0.5, fill=0.2)
                at.step()
            assert not at.adjustments and pl.flush_ms == 2.0
            return pl.flush_ms, pl.min_bucket

    def test_bucket_floor_down_on_deadline_dominated_low_fill(self):
        @both
        def _(m):
            metrics = m.metrics.Metrics()
            pl = _StubPipeline(metrics, min_bucket=1024)
            at = mk_autotuner(m, pl, metrics)
            history = []
            for _ in range(8):
                pl.interval(wait_ms=1.0, fill=0.3, reason="deadline")
                at.step()
                history.append((pl.flush_ms, pl.min_bucket))
            assert 64 <= pl.min_bucket < 1024
            return history

    def test_bucket_floor_shrink_clamps_lane_bucket(self):
        @both
        def _(m):
            metrics = m.metrics.Metrics()
            pl = _StubPipeline(metrics, min_bucket=1024)
            pl.lane_bucket = 1024
            pl.set_lane_bucket = lambda v: setattr(pl, "lane_bucket", v)
            at = mk_autotuner(m, pl, metrics)
            for _ in range(8):
                pl.interval(wait_ms=1.0, fill=0.3, reason="deadline")
                at.step()
            assert pl.min_bucket < 1024
            assert pl.lane_bucket <= pl.min_bucket
            assert any(a["knob"] == "lane_bucket" for a in at.adjustments)
            shrunk = (pl.min_bucket, pl.lane_bucket, adjustments(at))
            metrics = m.metrics.Metrics()
            pl = _StubPipeline(metrics, min_bucket=256)
            at = mk_autotuner(m, pl, metrics)
            for _ in range(8):
                pl.interval(wait_ms=1.0, fill=0.97, reason="full")
                at.step()
            assert pl.min_bucket > 256
            return shrunk, pl.min_bucket

    def test_idle_interval_is_skipped(self):
        @both
        def _(m):
            metrics = m.metrics.Metrics()
            pl = _StubPipeline(metrics)
            at = mk_autotuner(m, pl, metrics)
            pl.interval(wait_ms=50.0)
            at.step()
            assert at.step() is None
            assert pl.flush_ms == 2.0
            return pl.flush_ms

    def test_decisions_are_traced_and_counted(self):
        @both
        def _(m):
            metrics = m.metrics.Metrics()
            pl = _StubPipeline(metrics)
            at = mk_autotuner(m, pl, metrics, hysteresis=1)
            pl.interval(wait_ms=50.0)
            at.step()
            pl.interval(wait_ms=50.0)
            at.step()
            total = metrics.counters["autotune_adjustments_total"]
            assert total >= 1
            ev = at.tracer.spans(name="autotune.decision")
            assert ev and ev[0]["attrs"]["knob"] == "flush_ms"
            st = at.status()
            assert st["adjustments_total"] == len(at.adjustments)
            return (total, [e["attrs"] for e in ev], st["adjustments_total"],
                    st["bounds"])

    def test_config_rejects_nonsense_autotune_knobs(self):
        @both
        def _(m):
            refused = []
            for kw in ({"autotune_target_fill": 0.0},
                       {"autotune_target_fill": 1.5},
                       {"autotune_queue_wait_p99_ms": -1.0},
                       {"autotune_interval_s": 0.0},
                       {"trace_sample_rate": 1.5},
                       {"trace_capacity": 0},
                       {"flowmetrics_window_s": 0},
                       {"autotune_flush_ms_min": 0.0},
                       {"autotune_step_factor": 1.0}):
                with pytest.raises(ValueError) as e:
                    m.config.DaemonConfig(**kw)
                refused.append(str(e.value))
            return refused

    def test_quantile_from_deltas(self):
        @both
        def _(m):
            metrics = m.metrics.Metrics()
            h = metrics.histogram("pipeline_queue_wait_seconds")
            for v in (0.001,) * 90 + (0.2,) * 10:
                h.observe(v)
            buckets, cnt, _t, _n = h.snapshot()
            p50 = m.metrics.quantile_from(buckets, cnt, 0.5)
            p99 = m.metrics.quantile_from(buckets, cnt, 0.99)
            assert p50 < 0.01 and p99 > 0.05
            assert m.metrics.quantile_is_empty(
                m.metrics.quantile_from(buckets, [0] * len(cnt), 0.99))
            return p50, p99, list(buckets), list(cnt)


class TestEngineIntegration:
    def test_autotune_controller_steps_through_engine(self):
        @both
        def _(m):
            eng = fake_engine(m, autotune_enabled=True,
                              pipeline_flush_ms=2.0, pipeline_min_bucket=16)
            eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",),
                             ep_id=1)
            eng.apply_policy(POLICY)
            assert eng._autotune_step() is None
            assert eng.autotune_status() is None
            slot_of = eng.active.snapshot.ep_slot_of
            for i in range(8):
                eng.submit(m.records.batch_from_records(
                    [pkt(m, "192.168.1.10", "10.1.2.3", 40000 + i, 443)],
                    slot_of), now=100 + i)
            assert eng.drain(timeout=10)
            eng._autotune_step()
            st = eng.autotune_status()
            assert st is not None
            lo, hi = st["bounds"]["flush_ms"]
            assert lo <= eng._pipeline.flush_ms <= hi
            eng.stop()
            return st["bounds"], sorted(st)

    def test_dirty_mark_during_compile_survives_regeneration(self):
        @both
        def _(m):
            eng = fake_engine(m)
            eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",),
                             ep_id=1)
            eng.apply_policy(POLICY)
            eng.regenerate()
            assert not eng._dirty
            orig_place = eng.datapath.place

            def place_and_mark(snap):
                eng._mark_dirty()
                return orig_place(snap)

            eng.datapath.place = place_and_mark
            eng.regenerate(force=True)
            survived = bool(eng._dirty)
            assert survived
            eng.datapath.place = orig_place
            eng.regenerate()
            assert not eng._dirty
            revision = eng.active.revision
            eng.stop()
            return survived, revision

    def test_failed_regen_leaves_engine_dirty(self):
        @both
        def _(m):
            eng = fake_engine(m)
            eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",),
                             ep_id=1)
            eng.apply_policy(POLICY)
            eng.regenerate()
            try:
                m.faults.FAULTS.arm("regen.compile", mode="fail", times=1)
                eng._mark_dirty()
                eng.regenerate()
                assert eng._dirty
                return (bool(eng._dirty), eng.health()["state"],
                        eng.metrics.counters.get("regen_failures_total"))
            finally:
                m.faults.FAULTS.reset()
                eng.stop()

    def test_api_routes(self, tmp_path):
        @both
        def _(m):
            eng = fake_engine(m, trace_sample_rate=1.0, flowlog_mode="all")
            eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",),
                             ep_id=1)
            eng.apply_policy(POLICY)
            slot_of = eng.active.snapshot.ep_slot_of
            eng.classify(m.records.batch_from_records(
                [pkt(m, "192.168.1.10", "10.1.2.3", 40000, 443),
                 pkt(m, "192.168.1.10", "10.1.2.3", 40001, 80)], slot_of),
                now=1000)
            sock = str(tmp_path / f"{m.side}.sock")
            srv = m.api.APIServer(eng, sock)
            srv.start()
            try:
                client = m.api.UnixAPIClient(sock)
                code, metrics_doc = client.get("/v1/flows/metrics")
                assert code == 200
                assert metrics_doc["totals"]["forwarded"] == 1
                assert metrics_doc["totals"]["dropped"] == 1
                assert metrics_doc["windows"][0]["window_start"] == 1000
                code, last = client.get("/v1/flows/metrics?last=1")
                assert code == 200 and len(last["windows"]) == 1
                code, tr = client.get("/v1/trace?limit=5")
                assert code == 200 and tr["stats"]["enabled"]
                assert "engine.classify" in tr["summary"]
                code, named = client.get("/v1/trace?name=engine.classify")
                assert code == 200
                assert all(s["name"] == "engine.classify"
                           for s in named["spans"])
                code, text = client.get("/v1/metrics")
                assert code == 200
                assert "ciliumtpu_flow_verdicts_total" in text
                code, st = client.get("/v1/status")
                assert code == 200 and st["trace"]["enabled"]
                assert st["autotune"] is None
                # the port adds its synchronous classify's fold spans
                # (engine.fold.*, all but the CT-salvage note); the rest
                # is held to the reference
                folds = {n for n in tr["summary"]
                         if n.startswith("engine.fold.")}
                assert folds == (set() if m.side == "jax" else {
                    f"engine.fold.{f}" for f in (
                        "metrics", "flowlog", "flowmetrics", "blackbox",
                        "audit_capture", "rule_hits")})
                return (metrics_doc, last, sorted(set(tr["summary"]) - folds),
                        span_names(named["spans"]))
            finally:
                srv.stop()
                eng.stop()

    def test_metrics_textfile_includes_flowmetrics(self, tmp_path):
        @both
        def _(m):
            path = tmp_path / f"{m.side}.prom"
            eng = fake_engine(m, metrics_path=str(path), flowlog_mode="all")
            eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",),
                             ep_id=1)
            eng.apply_policy(POLICY)
            eng.classify(m.records.batch_from_records(
                [pkt(m, "192.168.1.10", "10.1.2.3", 40000, 443)],
                eng.active.snapshot.ep_slot_of), now=50)
            eng.flush_observability()
            text = path.read_text()
            assert "ciliumtpu_packets_total" in text
            assert ('ciliumtpu_flow_verdicts_total{verdict="FORWARDED"} 1'
                    in text)
            eng.stop()
            return [ln for ln in text.splitlines()
                    if ln.startswith(("ciliumtpu_flow_",
                                      "ciliumtpu_packets_total"))]


@pytest.mark.slow
class TestTraceOverheadSoak:
    def test_sampled_1_64_overhead_under_2pct(self):
        """The reference's soak on each package: 1/64 sampling adds under
        2% of the measured per-submission pipeline cost (per-event
        sampling delta), and an interleaved off/on soak stays within 15%.
        Wall-clock bounds, held on each side; nothing to compare."""
        import gc
        for side in SIDES:
            m = host(side)
            d = EchoDispatch()
            tr = m.trace.Tracer(sample_rate=0.0, capacity=4096)
            pl = m.pipeline.Pipeline(d, min_bucket=64, max_bucket=256,
                                     flush_ms=0.5, queue_batches=512,
                                     tracer=tr)
            batch = sub_batch(m, 64, start=0)

            def one_pass(n=1000):
                t0 = time.perf_counter()
                for _ in range(n):
                    pl.submit(batch)
                assert pl.drain(timeout=60)
                return time.perf_counter() - t0

            reps = 100_000

            def micro_pass():
                t0 = time.perf_counter()
                for _ in range(reps):
                    tid = tr.maybe_sample()
                    if tid is not None:
                        for name in "abcd":
                            tr.record(tid, name, 0.0, 0.0)
                return (time.perf_counter() - t0) / reps

            try:
                for _ in range(3):
                    one_pass(300)
                gc_was = gc.isenabled()
                gc.disable()
                try:
                    micro_pass()
                    tr.configure(sample_rate=0.0)
                    micro_off = min(micro_pass() for _ in range(5))
                    tr.configure(sample_rate=1 / 64)
                    micro_on = min(micro_pass() for _ in range(5))
                    off, on = [], []
                    for _i in range(5):
                        tr.configure(sample_rate=0.0)
                        off.append(one_pass())
                        tr.configure(sample_rate=1 / 64)
                        on.append(one_pass())
                finally:
                    if gc_was:
                        gc.enable()
                frac = (micro_on - micro_off) / (min(off) / 1000)
                assert frac < 0.02, f"{side}: {frac:.2%} of the submit path"
                assert min(on) <= min(off) * 1.15
                assert tr.sampled_total > 0
            finally:
                pl.close(timeout=10)
