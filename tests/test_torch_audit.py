"""The port's verdict provenance against the JAX package's, case for case
with ``tests/test_audit.py``: the shadow-oracle parity auditor (counter
sampling, the bounded capture pool, the ``audit.corrupt`` drill, fault
tolerance, pipelined and 8-shard steered batches), the flight recorder,
the end-to-end latency plumbing, the empty-window quantile sentinel, the
feeder's metric families, scrape races, trace-ring wraparound and the
debug-bundle surfaces (REST and CLI).

Each case runs the reference's body once on each package (each
package's ``FakeDatapath``, the port's with ``device="cpu"``; the 8-shard
fake is ``ShardedFake`` over each package's own), asserts the reference's
expectations on both, and holds a side-neutral observation equal: audit
statistics, mismatch diffs, health states, metric counters, flight
recorder events and bundles with their wall-clock stamps left out.

Not mirrored: ``TestBenchCompare`` (4 cases) tests the reference's
``bench.py``, and the port has no bench script yet. ``TestAuditSoak``
keeps ``slow``.
"""

import json
import math
import threading
import time

import numpy as np
import pytest

from tests.test_torch_datapath import SIDES
from tests.test_torch_pipeline import (POLICY, fake_engine, host, mk_chunks,
                                       pkt)

#: wall-clock fields of audit, recorder and bundle documents
CLOCK_KEYS = ("t", "ts", "time", "at", "wall", "mono", "captured_at",
              "frozen_at", "uptime_s", "age_s", "last_replay_s", "replay_s",
              "seconds", "duration_ms", "start_ms", "p50_ms", "p99_ms",
              "mean_ms", "max_ms", "e2e_p50_ms", "e2e_p99_ms", "since_s")


def both(case):
    """Run ``case(m)`` on each package's modules. → the port's
    observation, held equal to the reference's."""
    obs = {s: case(host(s)) for s in SIDES}
    assert obs["jax"] == obs["torch"]
    return obs["torch"]


def timeless(doc):
    """``doc`` (a JSON-like value) without its wall-clock fields and with
    numpy scalars as Python numbers."""
    if isinstance(doc, dict):
        return {k: timeless(v) for k, v in doc.items()
                if k not in CLOCK_KEYS}
    if isinstance(doc, (list, tuple)):
        return [timeless(v) for v in doc]
    if isinstance(doc, np.ndarray):
        return timeless(doc.tolist())
    if isinstance(doc, np.generic):
        return doc.item()
    return doc


@pytest.fixture(autouse=True)
def _clean():
    for s in SIDES:
        host(s).faults.FAULTS.reset()
    yield
    for s in SIDES:
        m = host(s)
        m.faults.FAULTS.reset()
        m.trace.TRACER.configure(sample_rate=0.0)
        m.trace.TRACER.reset()


def audited_engine(m, **kw):
    kw.setdefault("audit_enabled", True)
    kw.setdefault("audit_sample_rate", 1.0)
    return fake_engine(m, **kw)


_SHARDED = {}


def sharded_fake(m):
    """``test_audit.py``'s ``ShardedFake`` over ``m``'s ``FakeDatapath``:
    the class attribute shadows the base property, so the engine builds
    the 8-segment steered staging ring over the oracle."""
    if m.side not in _SHARDED:
        _SHARDED[m.side] = type("ShardedFake", (m.datapath.FakeDatapath,),
                                {"pipeline_shards": 8})
    return _SHARDED[m.side]


def sharded_audited_engine(m, **kw):
    kw.setdefault("ct_capacity", 4096)
    kw.setdefault("auto_regen", False)
    kw.setdefault("batch_size", 64)
    kw.setdefault("audit_enabled", True)
    kw.setdefault("audit_sample_rate", 1.0)
    if m.side == "torch":
        kw.setdefault("device", "cpu")
    cfg = m.config.DaemonConfig(**kw)
    return m.engine.Engine(cfg, datapath=sharded_fake(m)(cfg))


def web_batch(m, eng, dports=(443, 80, 22)):
    slot_of = eng.active.snapshot.ep_slot_of
    recs = [pkt(m, "192.168.1.10", "10.1.2.3", 40000 + dp, dp)
            for dp in dports]
    return m.records.batch_from_records(recs, slot_of)


def setup_web(eng):
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
    eng.apply_policy(POLICY)
    return eng


def audit_obs(eng):
    """The auditor's statistics, health and its labeled counters."""
    return {"stats": timeless(eng.auditor.stats()),
            "health": eng.health()["state"],
            "counters": {k: v for k, v in eng.metrics.counters.items()
                         if k.startswith("parity_audit")}}


def bundle_obs(bundle):
    """A debug bundle's stable surface: frozen, reason, detail (its rows'
    diffs and flows), the audit document and the event kinds."""
    return timeless({"frozen": bundle["frozen"], "reason": bundle["reason"],
                     "detail": bundle.get("detail"),
                     "audit": bundle.get("engine", {}).get("audit"),
                     "events": [e["kind"] for e in bundle.get("events", [])]})


# --------------------------------------------------------------------------- #
# shadow auditor
# --------------------------------------------------------------------------- #
class TestAuditorUnit:
    def test_counter_sampling_is_deterministic(self):
        @both
        def _(m):
            eng = setup_web(audited_engine(m, audit_sample_rate=0.25))
            b = web_batch(m, eng)
            for i in range(8):
                eng.classify(dict(b), now=100 + i)
            eng.audit_step()
            st = eng.auditor.stats()
            assert st["captured_batches"] == 2
            assert st["checked_batches"] == 2
            obs = audit_obs(eng)
            eng.stop()
            return obs

    def test_clean_engine_audits_clean(self):
        @both
        def _(m):
            eng = setup_web(audited_engine(m))
            b = web_batch(m, eng)
            for i in range(5):
                eng.classify(dict(b), now=100 + i)
            eng.audit_step()
            st = eng.auditor.stats()
            assert st["checked_rows"] == 15 and st["mismatched_rows"] == 0
            assert eng.auditor.healthy
            assert eng.health()["state"] == m.C.HEALTH_OK
            assert not any("parity_audit_mismatched" in k
                           for k in eng.metrics.counters)
            assert eng.metrics.counters["parity_audit_checked_total"] == 15
            obs = audit_obs(eng)
            eng.stop()
            return obs

    def test_disabled_auditor_captures_nothing(self):
        @both
        def _(m):
            eng = setup_web(fake_engine(m))
            eng.classify(web_batch(m, eng), now=100)
            assert eng.auditor.sample_rate == 0.0
            assert eng.auditor.stats()["captured_batches"] == 0
            obs = audit_obs(eng)
            eng.stop()
            return obs

    def test_bounded_pool_sheds_with_skipped_accounting(self):
        @both
        def _(m):
            eng = setup_web(audited_engine(m, audit_pool_batches=2))
            b = web_batch(m, eng)
            for i in range(6):
                eng.classify(dict(b), now=100 + i)
            st = eng.auditor.stats()
            assert st["captured_batches"] == 2 and st["skipped_batches"] == 4
            assert eng.metrics.counters["parity_audit_skipped_total"] == 4
            before = audit_obs(eng)
            eng.audit_step()
            st = eng.auditor.stats()
            assert st["checked_batches"] == 2 and st["mismatched_rows"] == 0
            obs = (before, audit_obs(eng))
            eng.stop()
            return obs

    def test_corruption_drill_detects_degrades_and_freezes(self):
        @both
        def _(m):
            C, FAULTS = m.C, m.faults.FAULTS
            eng = setup_web(audited_engine(m))
            b = web_batch(m, eng)
            eng.classify(dict(b), now=100)
            eng.audit_step()
            assert eng.auditor.healthy
            rev = eng.active.revision
            with FAULTS.inject("audit.corrupt", mode="fail", times=1):
                eng.classify(dict(b), now=101)
            eng.classify(dict(b), now=102)
            eng.audit_step()
            st = eng.auditor.stats()
            assert st["mismatched_batches"] == 1
            assert st["mismatched_rows"] == 3
            assert st["last_mismatch_revision"] == rev
            h = eng.health()
            assert h["state"] == C.HEALTH_DEGRADED
            assert h["audit"]["mismatched_rows"] == 3
            key = f'parity_audit_mismatched_total{{revision="{rev}"}}'
            assert eng.metrics.counters[key] == 3
            bundle = eng.debug_bundle()
            assert bundle["frozen"] and bundle["reason"] == "parity-mismatch"
            assert bundle["detail"]["revision"] == rev
            assert bundle["detail"]["rows"]
            assert bundle["detail"]["rows"][0]["diffs"]["allow"]
            assert bundle["engine"]["audit"]["mismatched_rows"] == 3
            json.dumps(bundle, default=str)
            obs = (audit_obs(eng), bundle_obs(bundle))
            eng.stop()
            return obs

    def test_clear_rearms_health_and_next_mismatch_freezes_again(self):
        @both
        def _(m):
            C, FAULTS = m.C, m.faults.FAULTS
            eng = setup_web(audited_engine(m))
            b = web_batch(m, eng)
            with FAULTS.inject("audit.corrupt", mode="fail", times=1):
                eng.classify(dict(b), now=100)
            eng.audit_step()
            assert eng.health()["state"] == C.HEALTH_DEGRADED
            eng.debug_bundle(clear=True)
            assert eng.health()["state"] == C.HEALTH_OK
            assert not eng.blackbox.stats()["frozen"]
            assert eng.auditor.healthy
            assert any("parity_audit_mismatched" in k
                       for k in eng.metrics.counters)
            rearmed = audit_obs(eng)
            with FAULTS.inject("audit.corrupt", mode="fail", times=1):
                eng.classify(dict(b), now=200)
            eng.audit_step()
            assert eng.health()["state"] == C.HEALTH_DEGRADED
            bundle = eng.debug_bundle()
            assert bundle["frozen"]
            obs = (rearmed, audit_obs(eng), bundle_obs(bundle))
            eng.stop()
            return obs

    def test_mismatch_diff_names_the_field_and_flow(self):
        @both
        def _(m):
            eng = setup_web(audited_engine(m))
            with m.faults.FAULTS.inject("audit.corrupt", mode="fail",
                                        times=1):
                eng.classify(web_batch(m, eng, dports=(443,)), now=100)
            eng.audit_step()
            (mm,) = list(eng.auditor.mismatches)
            row = mm["rows"][0]
            assert row["diffs"]["allow"] == {"want": True, "got": False}
            assert row["diffs"]["ct_delta"] == {"want": "create",
                                                "got": "none"}
            assert row["flow"]["dport"] == 443 and row["flow"]["ep_id"] == 1
            assert mm["corrupt_injected"] is True
            eng.stop()
            return timeless(mm)

    def test_capture_crash_never_reaches_serving(self, monkeypatch):
        @both
        def _(m):
            eng = setup_web(audited_engine(m))
            monkeypatch.setattr(eng.auditor, "_capture",
                                lambda *a, **k: 1 / 0)
            out = eng.classify(web_batch(m, eng), now=100)
            assert out["allow"][0]
            assert eng.auditor.stats()["capture_errors"] == 1
            assert eng.metrics.counters[
                "parity_audit_capture_errors_total"] == 1
            obs = (np.asarray(out["allow"]).tolist(), audit_obs(eng))
            eng.stop()
            return obs

    def test_replay_crash_is_counted_not_fatal(self, monkeypatch):
        @both
        def _(m):
            eng = setup_web(audited_engine(m))
            eng.classify(web_batch(m, eng), now=100)
            monkeypatch.setattr(eng.auditor, "_oracle_for",
                                lambda snap: 1 / 0)
            res = eng.audit_step()
            assert res["replayed"] == 1
            assert eng.auditor.stats()["replay_errors"] == 1
            obs = (timeless(res), audit_obs(eng))
            eng.stop()
            return obs

    def test_wedged_auditor_never_stalls_serving(self):
        @both
        def _(m):
            eng = setup_web(audited_engine(m, audit_pool_batches=2))
            b = web_batch(m, eng)
            release = threading.Event()

            def wedged_step():
                release.wait(30)
                return eng.audit_step()

            t = threading.Thread(target=wedged_step, daemon=True)
            t.start()
            outs = [eng.classify(dict(b), now=100 + i) for i in range(10)]
            assert all(bool(o["allow"][0]) for o in outs)
            skipped = eng.auditor.stats()["skipped_batches"]
            assert skipped >= 8
            release.set()
            t.join(10)
            assert not t.is_alive()
            assert eng.auditor.stats()["mismatched_rows"] == 0
            obs = ([np.asarray(o["allow"]).tolist() for o in outs], skipped,
                   audit_obs(eng))
            eng.stop()
            return obs

    def test_audit_controller_runs_in_background(self):
        @both
        def _(m):
            eng = setup_web(audited_engine(m, audit_interval_s=0.05))
            eng.start_background()
            try:
                eng.classify(web_batch(m, eng), now=100)
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    if eng.auditor.stats()["checked_batches"] >= 1:
                        break
                    time.sleep(0.02)
                st = eng.auditor.stats()
                assert st["checked_batches"] >= 1
                assert st["mismatched_rows"] == 0
                return (st["checked_batches"], st["checked_rows"],
                        st["mismatched_rows"])
            finally:
                eng.stop()

    def test_replay_against_superseded_revision(self):
        @both
        def _(m):
            eng = setup_web(audited_engine(m))
            b = web_batch(m, eng)
            first = eng.classify(dict(b), now=100)
            old_rev = eng.active.revision
            eng.replace_policy(["k8s:app=web"], [{
                "endpointSelector": {"matchLabels": {"app": "web"}},
                "egressDeny": [{"toCIDR": ["10.0.0.0/8"]}]}])
            eng.regenerate(force=True)
            assert eng.active.revision > old_rev
            second = eng.classify(dict(b), now=101)
            eng.audit_step()
            st = eng.auditor.stats()
            assert st["checked_batches"] == 2 and st["mismatched_rows"] == 0
            obs = ([np.asarray(o["allow"]).tolist() for o in (first, second)],
                   [np.asarray(o["reason"]).tolist()
                    for o in (first, second)], audit_obs(eng))
            eng.stop()
            return obs


class TestAuditorPipelined:
    def test_pipelined_batches_audit_clean(self):
        @both
        def _(m):
            eng = setup_web(audited_engine(m, pipeline_min_bucket=16))
            chunks = mk_chunks(m, eng.active.snapshot.ep_slot_of,
                               n_chunks=12, rows_per_chunk=8, repeats=True)
            tickets = [eng.submit(dict(ch), now=100 + i)
                       for i, ch in enumerate(chunks)]
            assert eng.drain(timeout=30)
            outs = [np.asarray(t.result(timeout=5)["allow"]).tolist()
                    for t in tickets]
            while eng.audit_step()["replayed"]:
                pass
            st = eng.auditor.stats()
            assert st["checked_rows"] > 0 and st["mismatched_rows"] == 0
            # how chunks coalesce into buckets follows the flush deadline:
            # the rows checked are every valid row either way
            obs = (outs, st["checked_rows"], st["mismatched_rows"])
            eng.stop()
            return obs

    def test_pipelined_corruption_detected(self):
        @both
        def _(m):
            FAULTS = m.faults.FAULTS
            eng = setup_web(audited_engine(m, pipeline_min_bucket=16))
            chunks = mk_chunks(m, eng.active.snapshot.ep_slot_of,
                               n_chunks=6, rows_per_chunk=8)
            FAULTS.arm("audit.corrupt", mode="fail", times=1)
            for i, ch in enumerate(chunks):
                eng.submit(dict(ch), now=100 + i)
            assert eng.drain(timeout=30)
            FAULTS.disarm("audit.corrupt")
            while eng.audit_step()["replayed"]:
                pass
            assert eng.auditor.stats()["mismatched_rows"] > 0
            assert eng.health()["state"] == m.C.HEALTH_DEGRADED
            bundle = eng.debug_bundle()
            assert bundle["frozen"]
            obs = (eng.health()["state"], bundle["reason"],
                   eng.auditor.stats()["mismatched_batches"])
            eng.stop()
            return obs


# --------------------------------------------------------------------------- #
# flight recorder
# --------------------------------------------------------------------------- #
class TestFlightRecorder:
    def test_event_ring_is_bounded(self):
        @both
        def _(m):
            fr = m.blackbox.FlightRecorder(capacity=4,
                                           metrics=m.metrics.Metrics())
            for i in range(10):
                fr.record_event("regen", revision=i)
            st = fr.stats()
            assert st["events_in_ring"] == 4 and st["events_total"] == 10
            assert not st["frozen"]
            return timeless(st), timeless(fr.bundle()["events"])

    def test_first_anomaly_wins(self):
        @both
        def _(m):
            fr = m.blackbox.FlightRecorder(metrics=m.metrics.Metrics())
            fr.record_event("regen", revision=1)
            fr.record_event("watchdog", action="restart", reason="stall")
            fr.record_event("breaker", old="closed", new="open")
            st = fr.stats()
            assert st["frozen"] and st["freezes_total"] == 2
            assert st["frozen_reason"].startswith("watchdog")
            b = fr.bundle()
            kinds = [e["kind"] for e in b["events"]]
            assert kinds[0] == "regen"
            fr.clear()
            assert not fr.stats()["frozen"]
            return timeless(st), kinds, timeless(fr.stats())

    def test_breaker_close_does_not_freeze(self):
        @both
        def _(m):
            fr = m.blackbox.FlightRecorder(metrics=m.metrics.Metrics())
            fr.record_event("breaker", old="open", new="half-open")
            fr.record_event("breaker", old="half-open", new="closed")
            assert not fr.stats()["frozen"]
            return timeless(fr.stats())

    def test_shed_spike_freezes_single_shed_does_not(self):
        @both
        def _(m):
            fr = m.blackbox.FlightRecorder(shed_spike=5, shed_window_s=10.0,
                                           metrics=m.metrics.Metrics())
            fr.record_event("shed", reason="flush")
            single = fr.stats()["frozen"]
            assert not single
            for _ in range(5):
                fr.record_event("shed", reason="flush")
            st = fr.stats()
            assert st["frozen"] and st["frozen_reason"].startswith(
                "shed-spike")
            return single, timeless(st)

    def test_verdict_summaries_and_span_tail_ride_the_bundle(self):
        @both
        def _(m):
            C = m.C
            tr = m.trace.Tracer(sample_rate=1.0, capacity=32)
            tid = tr.maybe_sample()
            tr.record(tid, "pipeline.dispatch", 0.0, 0.002)
            fr = m.blackbox.FlightRecorder(metrics=m.metrics.Metrics(),
                                           tracer=tr)
            out = {"allow": np.array([True, False, False]),
                   "reason": np.array([0, int(C.DropReason.POLICY),
                                       int(C.DropReason.POLICY)], np.int32)}
            fr.record_verdicts(out, n_valid=3, now=100)
            b = fr.freeze("parity-mismatch", detail={"revision": 7})
            (vs,) = b["verdict_summaries"]
            assert vs["allowed"] == 1 and vs["dropped"] == 2
            assert vs["top_reasons"] == {"POLICY": 2}
            assert b["spans"][0]["name"] == "pipeline.dispatch"
            assert b["detail"]["revision"] == 7
            return (timeless(vs), [s["name"] for s in b["spans"]],
                    b["detail"], b["reason"])

    def test_pipeline_guard_events_reach_the_recorder(self):
        @both
        def _(m):
            FAULTS = m.faults.FAULTS
            eng = setup_web(fake_engine(m, pipeline_stall_timeout_s=30.0,
                                        pipeline_restart_backoff_s=0.05))
            pl = eng.start_pipeline()
            pl.set_stall_timeout_s(0.5)
            FAULTS.arm("pipeline.dispatch", mode="hang", delay_s=5.0,
                       times=1)
            for i in range(3):
                eng.submit(web_batch(m, eng), now=100 + i)
            eng.drain(timeout=20)
            FAULTS.disarm("pipeline.dispatch")
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline \
                    and not eng.blackbox.stats()["frozen"]:
                time.sleep(0.05)
            st = eng.blackbox.stats()
            assert st["frozen"] and st["frozen_reason"].startswith(
                "watchdog")
            bundle = eng.debug_bundle()
            kinds = [e["kind"] for e in bundle["events"]]
            assert "watchdog" in kinds
            eng.stop()
            return st["frozen"], st["frozen_reason"].split(":")[0]


# --------------------------------------------------------------------------- #
# end-to-end latency SLO plumbing
# --------------------------------------------------------------------------- #
class _StubShim:
    batch_size = 8

    def __init__(self, m):
        self.m = m

    def make_poll_buffer(self):
        b = self.m.records.empty_batch(8)
        b["_ep_raw"] = np.zeros(8, np.int64)
        return b

    def apply_verdicts(self, allow):
        pass


class _StubTicket:
    def done(self):
        return True

    def result(self, timeout=None):
        return {"allow": np.ones(8, bool)}


class TestE2ELatency:
    def test_ingest_mono_rides_the_ticket(self):
        @both
        def _(m):
            eng = setup_web(fake_engine(m))
            stamp = time.monotonic() - 0.25
            t = eng.submit(web_batch(m, eng), now=100, ingest_mono=stamp)
            out = t.result(timeout=10)
            assert t.ingest_mono == stamp
            t2 = eng.submit(web_batch(m, eng), now=101)
            t2.result(timeout=10)
            assert t2.ingest_mono is None
            eng.stop()
            return np.asarray(out["allow"]).tolist(), t2.ingest_mono

    def test_feeder_observes_e2e_and_burns_slo(self):
        @both
        def _(m):
            metrics = m.metrics.Metrics()
            fd = m.feeder.ShimFeeder(_StubShim(m), engine=None,
                                     pool_batches=1, slo_ms=50.0,
                                     metrics=metrics)
            buf = fd._free[0]
            fd._apply_one(_StubTicket(), buf,
                          ingest_mono=time.monotonic() - 0.2)
            fd._apply_one(_StubTicket(), buf,
                          ingest_mono=time.monotonic() - 0.001)
            h = metrics.histograms["ingest_e2e_latency_seconds"]
            assert h.count == 2
            assert metrics.counters["ingest_e2e_slo_burn_total"] == 1
            st = fd.stats()
            assert st["slo_burns"] == 1 and st["e2e_p99_ms"] > 50
            return h.count, st["slo_burns"], sorted(metrics.counters.items())

    def test_per_shard_e2e_families_and_type_dedupe(self):
        @both
        def _(m):
            metrics = m.metrics.Metrics()
            fd = m.feeder.ShimFeeder(_StubShim(m), engine=None,
                                     pool_batches=1, n_shards=4, slo_ms=10.0,
                                     metrics=metrics)
            buf = fd._free[0]
            buf["_shard"][:] = m.scheduler.shard_bin_encode(
                np.array([0, 0, 1, 1, 3, 3, 3, 3]), revision=1)
            buf["valid"][:6] = True
            fd._apply_one(_StubTicket(), buf,
                          ingest_mono=time.monotonic() - 0.1)
            hists = metrics.histograms
            assert 'ingest_e2e_latency_seconds{shard="0"}' in hists
            assert 'ingest_e2e_latency_seconds{shard="3"}' in hists
            assert 'ingest_e2e_latency_seconds{shard="2"}' not in hists
            assert metrics.counters[
                'ingest_e2e_slo_burn_total{shard="0"}'] == 1
            text = metrics.render_prometheus()
            type_lines = [ln for ln in text.splitlines()
                          if ln.startswith("# TYPE ciliumtpu_ingest_e2e"
                                           "_latency_seconds ")]
            assert len(type_lines) == 1
            assert ('ciliumtpu_ingest_e2e_latency_seconds_bucket'
                    '{shard="3",le="+Inf"} 1') in text
            assert ('ciliumtpu_ingest_e2e_latency_seconds_sum{shard="3"}'
                    in text)
            assert not any("{" in ln for ln in text.splitlines()
                           if ln.startswith("# TYPE"))
            return (sorted(hists), sorted(metrics.counters.items()),
                    type_lines)


# --------------------------------------------------------------------------- #
# satellites: metrics sentinel, feeder families, scrape races, trace ring
# --------------------------------------------------------------------------- #
class TestQuantileSentinel:
    def test_empty_window_returns_sentinel(self):
        @both
        def _(m):
            mm = m.metrics
            buckets, counts, _t, _c = mm.Histogram().snapshot()
            v = mm.quantile_from(buckets, counts, 0.99)
            assert mm.quantile_is_empty(v) and math.isnan(v)
            assert math.isnan(mm.EMPTY_QUANTILE)
            return list(buckets), list(counts), repr(v)

    def test_display_quantile_still_reads_zero_when_empty(self):
        @both
        def _(m):
            v = m.metrics.Histogram().quantile(0.5)
            assert v == 0.0
            return v

    def test_delta_window_with_counts_is_unchanged(self):
        @both
        def _(m):
            mm = m.metrics
            h = mm.Histogram()
            for v in (0.001, 0.002, 0.004):
                h.observe(v)
            b, c, _t, _n = h.snapshot()
            q = mm.quantile_from(b, c, 0.5)
            assert q > 0.0 and not mm.quantile_is_empty(q)
            return q, list(c)

    def test_autotuner_skips_empty_window(self):
        @both
        def _(m):
            class _StubPipeline:
                flush_ms = 2.0
                min_bucket = 256
                max_bucket = 8192

                def __init__(self):
                    self.d = 0

                def stats(self):
                    self.d += 10
                    return {"fill_rows": 0, "bucket_rows": 0,
                            "dispatched_batches": self.d,
                            "flush_reasons": {}}

                def set_flush_ms(self, v):
                    raise AssertionError("must not adjust on empty window")

                def set_min_bucket(self, v):
                    raise AssertionError("must not adjust on empty window")

            metrics = m.metrics.Metrics()
            metrics.histogram("pipeline_queue_wait_seconds")
            at = m.autotune.Autotuner(_StubPipeline(), metrics)
            first = at.step()
            assert first is None
            at.pipeline.stats = lambda: {"fill_rows": 100,
                                         "bucket_rows": 200,
                                         "dispatched_batches": 100,
                                         "flush_reasons": {}}
            at._last_fill = (0, 0)
            second = at.step()
            assert second is None
            return first, second, list(at.adjustments)


class TestFeederMetricFamilies:
    def test_feeder_stats_exported_as_families(self):
        @both
        def _(m):
            eng = setup_web(fake_engine(m))

            class _FakeFeeder:
                def stats(self):
                    return {"alive": True, "pool_free": 3, "pending": 1,
                            "harvested_batches": 5}

            eng._feeder = _FakeFeeder()
            text = eng.render_metrics()
            assert "# TYPE ciliumtpu_feeder_alive gauge" in text
            assert "ciliumtpu_feeder_alive 1" in text
            assert ("ciliumtpu_feeder_pool_free 3.0" in text
                    or "ciliumtpu_feeder_pool_free 3" in text)
            assert "ciliumtpu_feeder_pending 1" in text
            eng._feeder = None
            eng.stop()
            return [ln for ln in text.splitlines() if "feeder" in ln]


class TestScrapeRaces:
    def test_concurrent_scrape_races_sharded_soak(self):
        @both
        def _(m):
            FAULTS = m.faults.FAULTS
            eng = sharded_audited_engine(m, pipeline_restart_backoff_s=0.05)
            setup_web(eng)
            chunks = mk_chunks(m, eng.active.snapshot.ep_slot_of,
                               n_chunks=16, rows_per_chunk=8)
            errors = []
            stop = threading.Event()

            def scraper():
                while not stop.is_set():
                    try:
                        text = eng.render_metrics()
                        for ln in text.splitlines():
                            if ln.startswith("# TYPE"):
                                assert "{" not in ln, f"labeled TYPE: {ln}"
                    except Exception as e:   # noqa: BLE001
                        errors.append(e)
                        return

            threads = [threading.Thread(target=scraper, daemon=True)
                       for _ in range(2)]
            for t in threads:
                t.start()
            allows = []
            try:
                pl = eng.start_pipeline()
                assert pl.stats()["n_shards"] == 8
                for round_ in range(6):
                    tickets = [eng.submit(dict(ch), now=100 + i)
                               for i, ch in enumerate(chunks)]
                    assert eng.drain(timeout=30)
                    allows.append([np.asarray(
                        t.result(timeout=5)["allow"]).tolist()
                        for t in tickets])
                    if round_ == 2:
                        pl.set_stall_timeout_s(0.4)
                        FAULTS.arm("pipeline.dispatch", mode="hang",
                                   delay_s=4.0, times=1)
                        eng.submit(dict(chunks[0]), now=500)
                        eng.drain(timeout=20)
                        FAULTS.disarm("pipeline.dispatch")
                        deadline = time.monotonic() + 10
                        while time.monotonic() < deadline and \
                                (eng.pipeline_stats() or {}).get(
                                    "state") != "ok":
                            time.sleep(0.05)
                        pl.set_stall_timeout_s(30.0)
                eng.audit_step(budget=None)
                st = eng.auditor.stats()
                assert st["checked_rows"] > 0 and st["mismatched_rows"] == 0
            finally:
                stop.set()
                for t in threads:
                    t.join(5)
                eng.stop()
            assert not errors, errors[:1]
            return allows, st["mismatched_rows"]


#: the spans the port's synchronous classify adds to the reference's: its
#: finalize folds (all but the CT-salvage note, which only the pipelined
#: finalize applies)
SYNC_FOLD_SPANS = 6


class TestTraceRingWraparound:
    def test_trace_ring_wraps_with_audit_capture_armed(self):
        """Held to the reference plus exactly the fold spans the port
        adds: its drops are the reference's plus ``SYNC_FOLD_SPANS`` a
        classified batch, its ring wraps follow from its drops as the
        reference's do, and the names left in its ring, less
        ``engine.fold.*``, are among the reference's."""
        def case(m):
            TRACER = m.trace.TRACER
            TRACER.configure(sample_rate=1.0, capacity=16)
            TRACER.reset()
            eng = setup_web(audited_engine(m, trace_sample_rate=1.0,
                                           trace_capacity=16))
            b = web_batch(m, eng)
            for i in range(40):
                eng.classify(dict(b), now=100 + i)
                if i % 8 == 0:
                    eng.audit_step()
            eng.audit_step()
            st = eng.auditor.stats()
            assert st["mismatched_rows"] == 0 and st["checked_rows"] > 0
            tr = TRACER.stats()
            assert tr["spans_in_ring"] == 16
            spans = TRACER.spans(limit=100)
            for sp in spans:
                assert sp["trace_id"] > 0 and sp["duration_ms"] >= 0
            bundle = eng.debug_bundle()
            assert len(bundle["spans"]) <= 16
            # drop-oldest: every recorded span past the first ring-full
            # is a drop, and each ring-full after the first a wrap
            cap = tr["capacity"]
            assert tr["ring_wraps"] \
                == (tr["spans_dropped_total"] + cap) // cap - 1
            obs = (audit_obs(eng), timeless(tr), len(bundle["spans"]))
            eng.stop()
            return obs, {sp["name"] for sp in spans}

        got = {s: case(host(s)) for s in SIDES}
        (ref, ref_names), (port, port_names) = got["jax"], got["torch"]
        added = 40 * SYNC_FOLD_SPANS
        assert port[1]["spans_dropped_total"] \
            == ref[1]["spans_dropped_total"] + added
        assert port[1]["ring_wraps"] > ref[1]["ring_wraps"]
        keep = ("spans_dropped_total", "ring_wraps")
        assert {k: v for k, v in port[1].items() if k not in keep} \
            == {k: v for k, v in ref[1].items() if k not in keep}
        assert port[0] == ref[0] and port[2] == ref[2]
        assert {n for n in port_names
                if not n.startswith("engine.fold.")} <= ref_names


# --------------------------------------------------------------------------- #
# export surfaces: REST route + CLI
# --------------------------------------------------------------------------- #
def live_engine(m, tmp_path):
    """The reference's ``live`` fixture on ``m``'s package: an audited web
    engine behind an API server. → (engine, socket, client, server)."""
    sock = str(tmp_path / f"{m.side}.sock")
    eng = setup_web(audited_engine(m))
    srv = m.api.APIServer(eng, sock)
    srv.start()
    return eng, sock, m.api.UnixAPIClient(sock), srv


class TestDebugBundleSurfaces:
    def test_rest_bundle_live_then_frozen_then_cleared(self, tmp_path):
        @both
        def _(m):
            eng, _sock, client, srv = live_engine(m, tmp_path)
            try:
                code, doc = client.get("/v1/debug/bundle")
                assert code == 200 and doc["frozen"] is False
                with m.faults.FAULTS.inject("audit.corrupt", mode="fail",
                                            times=1):
                    eng.classify(web_batch(m, eng), now=100)
                eng.audit_step()
                code, frozen = client.get("/v1/debug/bundle?clear=1")
                assert code == 200 and frozen["frozen"] is True
                assert frozen["reason"] == "parity-mismatch"
                assert frozen["engine"]["audit"]["mismatched_rows"] > 0
                assert frozen["detail"]["rows"]
                code, doc = client.get("/v1/debug/bundle")
                assert code == 200 and doc["frozen"] is False
                code, st = client.get("/v1/status")
                assert code == 200
                assert st["audit"]["mismatched_rows"] == 0
                assert st["audit"]["checked_rows"] > 0
                assert st["blackbox"]["freezes_total"] >= 1
                return (bundle_obs(frozen), doc["frozen"],
                        timeless(st["audit"]),
                        st["blackbox"]["freezes_total"])
            finally:
                srv.stop()
                eng.stop()

    def test_cli_debug_bundle_writes_file(self, tmp_path, capsys):
        @both
        def _(m):
            eng, sock, _client, srv = live_engine(m, tmp_path)
            try:
                with m.faults.FAULTS.inject("audit.corrupt", mode="fail",
                                            times=1):
                    eng.classify(web_batch(m, eng), now=100)
                eng.audit_step()
                out_path = tmp_path / f"{m.side}-bundle.json"
                rc = m.cli.main(["debug-bundle", "--api", sock,
                                 "--out", str(out_path), "--clear"])
                assert rc == 0
                doc = json.loads(out_path.read_text())
                assert doc["frozen"] and doc["reason"] == "parity-mismatch"
                assert "written to" in capsys.readouterr().out
                return rc, bundle_obs(doc)
            finally:
                srv.stop()
                eng.stop()


# --------------------------------------------------------------------------- #
# slow: the audit-smoke soak, on each package
# --------------------------------------------------------------------------- #
@pytest.mark.slow
class TestAuditSoak:
    N_SUBMISSIONS = 10_000

    def test_soak_clean_then_corruption_detected(self):
        @both
        def _(m):
            C, FAULTS = m.C, m.faults.FAULTS
            eng = setup_web(audited_engine(
                m, pipeline_min_bucket=16, audit_pool_batches=64,
                audit_interval_s=0.05))
            eng.start_background()
            try:
                chunks = mk_chunks(m, eng.active.snapshot.ep_slot_of,
                                   n_chunks=32, rows_per_chunk=8,
                                   repeats=True)
                n = 0
                while n < self.N_SUBMISSIONS:
                    tickets = [eng.submit(dict(ch), now=100 + n + i)
                               for i, ch in enumerate(chunks)]
                    n += len(tickets)
                    assert eng.drain(timeout=60)
                    for t in tickets:
                        t.result(timeout=5)
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline \
                        and eng.auditor.stats()["pending"] > 0:
                    time.sleep(0.05)
                eng.audit_step()
                st = eng.auditor.stats()
                assert st["checked_rows"] > 0
                assert st["mismatched_rows"] == 0
                assert eng.health()["state"] == C.HEALTH_OK
                FAULTS.arm("audit.corrupt", mode="fail", times=4)
                tickets = [eng.submit(dict(ch), now=50_000 + i)
                           for i, ch in enumerate(chunks)]
                assert eng.drain(timeout=60)
                for t in tickets:
                    t.result(timeout=5)
                FAULTS.disarm("audit.corrupt")
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline \
                        and eng.auditor.stats()["mismatched_rows"] == 0:
                    eng.audit_step()
                    time.sleep(0.02)
                assert eng.auditor.stats()["mismatched_rows"] > 0
                assert eng.health()["state"] == C.HEALTH_DEGRADED
                bundle = eng.debug_bundle()
                assert bundle["frozen"] \
                    and bundle["reason"] == "parity-mismatch"
                assert bundle["detail"]["rows"]
                assert bundle["detail"]["revision"] == eng.active.revision
                return eng.health()["state"], bundle["reason"]
            finally:
                eng.stop()

    def test_sharded_soak_audits_clean(self):
        @both
        def _(m):
            eng = sharded_audited_engine(m, audit_pool_batches=64,
                                         audit_interval_s=0.05)
            setup_web(eng)
            eng.start_background()
            try:
                chunks = mk_chunks(m, eng.active.snapshot.ep_slot_of,
                                   n_chunks=32, rows_per_chunk=8,
                                   repeats=True)
                n = 0
                while n < 2000:
                    tickets = [eng.submit(dict(ch), now=100 + n + i)
                               for i, ch in enumerate(chunks)]
                    n += len(tickets)
                    assert eng.drain(timeout=60)
                    for t in tickets:
                        t.result(timeout=5)
                while eng.audit_step()["replayed"]:
                    pass
                st = eng.auditor.stats()
                assert st["checked_rows"] > 0
                assert st["mismatched_rows"] == 0
                assert not any("parity_audit_mismatched" in k
                               for k in eng.metrics.counters)
                assert eng.metrics.counters["parity_audit_checked_total"] > 0
                return st["mismatched_rows"]
            finally:
                eng.stop()

    def test_auditor_overhead_under_two_percent(self):
        """The reference's <2% capture-cost contract on each package:
        wall-clock bounds, held on each side; nothing to compare."""
        import gc
        for side in SIDES:
            m = host(side)
            eng = setup_web(audited_engine(m, audit_sample_rate=1 / 64,
                                           audit_pool_batches=4096,
                                           pipeline_min_bucket=16))
            snap = eng.active.snapshot
            b = web_batch(m, eng)
            out = eng.classify(dict(b), now=99)
            aud = eng.auditor
            chunks = mk_chunks(m, snap.ep_slot_of, n_chunks=16,
                               rows_per_chunk=8)

            def one_pass(n_rounds=4):
                t0 = time.perf_counter()
                n = 0
                for _r in range(n_rounds):
                    for i, ch in enumerate(chunks):
                        eng.submit(dict(ch), now=1000 + i)
                        n += 1
                    assert eng.drain(timeout=60)
                return (time.perf_counter() - t0) / n

            reps = 20_000

            def micro_pass():
                t0 = time.perf_counter()
                for _ in range(reps):
                    aud.maybe_capture(b, out, snap, 100)
                dt = (time.perf_counter() - t0) / reps
                aud.step()
                return dt

            one_pass(2)
            gc_was = gc.isenabled()
            gc.disable()
            try:
                micro_pass()
                aud.configure(sample_rate=0.0)
                micro_off = min(micro_pass() for _ in range(5))
                aud.configure(sample_rate=1 / 64)
                micro_on = min(micro_pass() for _ in range(5))
                off, on = [], []
                for _i in range(4):
                    aud.configure(sample_rate=0.0)
                    off.append(one_pass())
                    aud.configure(sample_rate=1 / 64)
                    on.append(one_pass())
                    aud.step()
            finally:
                if gc_was:
                    gc.enable()
            frac = (micro_on - micro_off) / min(off)
            assert frac < 0.02, f"{side}: {frac:.2%} of the submit path"
            assert min(on) <= min(off) * 1.15
            assert aud.stats()["mismatched_rows"] == 0
            eng.stop()
