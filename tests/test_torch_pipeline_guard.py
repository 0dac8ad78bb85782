"""The pipeline guard of the port against the JAX package's, case for case
with ``test_pipeline_guard.py``: deadline sheds at ingest and at flush,
the circuit breaker (open, fail fast, half-open probe, close), the
watchdog's restarts and hard fail, ``close`` sweeps and shutdown races,
the hang fault mode, the engine's health fold and the REST serving route.

Each case runs the reference's scenario on each package's modules (a raw
``Pipeline`` over the recording ``EchoDispatch``, or an ``Engine`` on each
package's ``FakeDatapath``), asserts the reference's expectations on both,
and holds the two observations equal, exactly: exception classes (by
name), the rows each dispatch saw, shed reasons, breaker transitions and
counters, verdict columns, health documents and REST codes. Left out,
because they depend on the wall clock and the threads' interleaving:
elapsed seconds, how many submissions a breaker or a hang caught in
flight (the reference's own tests bound them), and retry timers.
"""

import importlib
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from cilium_tpu.kernels.records import batch_from_records
from cilium_tpu.utils import constants as C
from tests.test_pipeline_guard import (POLICY, EchoDispatch, pkt,
                                       sub_batch, unique_chunks)

SIDES = ("jax", "torch")
PKG = {"jax": "cilium_tpu", "torch": "cilium_tpu_torch"}
MODS = {"pipeline": "pipeline", "trace": "observe.trace",
        "config": "runtime.config", "datapath": "runtime.datapath",
        "engine": "runtime.engine", "faults": "runtime.faults",
        "api": "runtime.api"}
OUT_KEYS = ("allow", "reason", "status", "remote_identity", "svc",
            "nat_dst", "nat_dport", "rnat", "rnat_src", "rnat_sport")


def P(side):
    return SimpleNamespace(side=side, **{
        k: importlib.import_module(f"{PKG[side]}.{v}")
        for k, v in MODS.items()})


def both(case):
    obs = {s: case(P(s)) for s in SIDES}
    assert obs["jax"] == obs["torch"]
    return obs["torch"]


@pytest.fixture(autouse=True)
def _clean_faults():
    for s in SIDES:
        P(s).faults.FAULTS.reset()
    yield
    for s in SIDES:
        P(s).faults.FAULTS.reset()


def guarded(m, d, **kw):
    kw.setdefault("min_bucket", 4)
    kw.setdefault("max_bucket", 16)
    kw.setdefault("flush_ms", 1000.0)
    kw.setdefault("restart_backoff_s", 0.01)
    return m.pipeline.Pipeline(d, **kw)


def fake_engine(m, **kw):
    kw.setdefault("ct_capacity", 4096)
    kw.setdefault("auto_regen", False)
    kw.setdefault("batch_size", 64)
    if m.side == "torch":
        kw["device"] = "cpu"
    cfg = m.config.DaemonConfig(**kw)
    return m.engine.Engine(cfg, datapath=m.datapath.FakeDatapath(cfg))


def outcome(t, timeout=5):
    """A ticket's outcome: its ``reason`` column, or its exception's
    class name."""
    try:
        return t.result(timeout=timeout)["reason"].tolist()
    except Exception as e:   # noqa: BLE001
        return type(e).__name__


def breaker_counters(mt):
    return {k: v for k, v in mt.counters.items()
            if k.startswith("pipeline_breaker")}


# --------------------------------------------------------------------------- #
class TestDeadlines:
    def test_shed_at_ingest_while_worker_busy(self):
        def case(m):
            d = EchoDispatch()
            d.gate.clear()
            pl = guarded(m, d)
            try:
                hog = pl.submit(sub_batch(4, start=0))
                time.sleep(0.05)
                stale = pl.submit(sub_batch(4, start=100), deadline_ms=10)
                time.sleep(0.05)
                d.gate.set()
                with pytest.raises(m.pipeline.PipelineDeadlineExceeded):
                    stale.result(timeout=5)
                assert hog.result(timeout=5)["allow"].all()
                assert 100 not in d.sports_seen
                s = pl.stats()
                assert s["shed_total"] == 1
                assert s["shed_reasons"] == {"ingest": 1}
                assert pl.metrics.counters[
                    'pipeline_shed_total{reason="ingest"}'] == 1
                return d.sports_seen, s["shed_reasons"], outcome(stale)
            finally:
                d.gate.set()
                pl.close(timeout=5)
        both(case)

    def test_shed_at_flush_masks_rows(self):
        def case(m):
            d = EchoDispatch()
            pl = guarded(m, d, flush_ms=60_000.0)
            try:
                doomed = pl.submit(sub_batch(3, start=10), deadline_ms=30)
                keeper = pl.submit(sub_batch(3, start=20))
                time.sleep(0.08)
                assert pl.drain(timeout=5)
                with pytest.raises(m.pipeline.PipelineDeadlineExceeded):
                    doomed.result(timeout=1)
                assert keeper.result(timeout=1)["reason"].tolist() == \
                    [20, 21, 22]
                assert d.sports_seen == [20, 21, 22]
                assert pl.stats()["shed_reasons"] == {"flush": 1}
                return d.sports_seen, outcome(doomed), outcome(keeper)
            finally:
                pl.close(timeout=5)
        both(case)

    def test_default_deadline_from_ctor(self):
        def case(m):
            d = EchoDispatch()
            d.gate.clear()
            pl = guarded(m, d, deadline_ms=10)
            try:
                pl.submit(sub_batch(4, start=0))
                time.sleep(0.05)
                late = pl.submit(sub_batch(4, start=50))
                time.sleep(0.05)
                d.gate.set()
                with pytest.raises(m.pipeline.PipelineDeadlineExceeded):
                    late.result(timeout=5)
                return outcome(late), pl.stats()["shed_reasons"]
            finally:
                d.gate.set()
                pl.close(timeout=5)
        both(case)

    def test_shed_counter_renders_one_type_line(self):
        def case(m):
            pl = guarded(m, EchoDispatch())
            try:
                pl.metrics.inc_counter('pipeline_shed_total{reason="ingest"}')
                pl.metrics.inc_counter('pipeline_shed_total{reason="flush"}')
                text = pl.metrics.render_prometheus()
                assert text.count("# TYPE ciliumtpu_pipeline_shed_total "
                                  "counter") == 1
                assert 'ciliumtpu_pipeline_shed_total{reason="flush"} 1' \
                    in text
                assert 'ciliumtpu_pipeline_shed_total{reason="ingest"} 1' \
                    in text
                return [ln for ln in text.splitlines()
                        if "pipeline_shed_total" in ln]
            finally:
                pl.close(timeout=5)
        both(case)


# --------------------------------------------------------------------------- #
class TestCircuitBreaker:
    def test_opens_fast_fails_probes_and_closes(self):
        def case(m):
            d = EchoDispatch()
            tracer = m.trace.Tracer(sample_rate=1.0, capacity=512)
            pl = guarded(m, d, breaker_threshold=5, breaker_cooldown_s=0.15,
                         tracer=tracer)
            faults = m.faults.FAULTS
            try:
                faults.arm("pipeline.dispatch", mode="fail")
                first = pl.submit(sub_batch(4, start=0))
                with pytest.raises(m.pipeline.PipelineUnavailable):
                    first.result(timeout=10)
                assert pl.dispatch_faults <= 6
                states = [pl.breaker.state, pl.state()]
                assert states == ["open", "breaker-open"]
                for _ in range(3):
                    with pytest.raises(m.pipeline.PipelineUnavailable):
                        pl.submit(sub_batch(4, start=8))
                assert pl.stats()["unavailable_total"] >= 3
                time.sleep(0.2)
                probe = pl.submit(sub_batch(4, start=16))
                with pytest.raises(m.pipeline.PipelineUnavailable):
                    probe.result(timeout=5)
                states.append(pl.breaker.state)
                assert pl.breaker.state == "open"
                faults.disarm("pipeline.dispatch")
                time.sleep(0.2)
                ok = pl.submit(sub_batch(4, start=24))
                assert ok.result(timeout=5)["reason"].tolist() == \
                    [24, 25, 26, 27]
                states += [pl.breaker.state, pl.state()]
                assert states[-2:] == ["closed", "ok"]
                mt = pl.metrics
                counters = breaker_counters(mt)
                assert counters[
                    'pipeline_breaker_transitions_total{to="open"}'] == 2
                assert counters[
                    'pipeline_breaker_transitions_total{to="half-open"}'] \
                    == 2
                assert counters[
                    'pipeline_breaker_transitions_total{to="closed"}'] == 1
                assert mt.gauges["pipeline_breaker_state"] == 0
                tos = [e["attrs"]["to"] for e in
                       tracer.spans(limit=100, name="pipeline.breaker")]
                assert tos.count("open") == 2 and tos.count("closed") == 1
                return states, counters, tos, d.sports_seen
            finally:
                faults.reset()
                pl.close(timeout=5)
        both(case)

    def test_real_errors_feed_breaker_and_suppress_queued(self):
        def case(m):
            d = EchoDispatch()
            d.fail_always = ValueError
            pl = guarded(m, d, breaker_threshold=3, breaker_cooldown_s=30.0)
            try:
                tickets, fast_fails = [], 0
                for i in range(6):
                    try:
                        tickets.append(pl.submit(sub_batch(4, start=4 * i)))
                    except m.pipeline.PipelineUnavailable:
                        fast_fails += 1
                assert pl.drain(timeout=10)
                for t in tickets:
                    with pytest.raises(m.pipeline.PipelineError):
                        t.result(timeout=1)
                assert pl.breaker.state == "open"
                assert pl.dispatch_errors == 3
                assert d.batches == []
                assert len(tickets) + fast_fails == 6
                return pl.breaker.state, pl.dispatch_errors, d.batches, \
                    breaker_counters(pl.metrics)
            finally:
                pl.close(timeout=5)
        both(case)

    def test_finalize_faults_feed_breaker(self):
        def case(m):
            d = EchoDispatch()
            pl = guarded(m, d, breaker_threshold=2, breaker_cooldown_s=30.0)
            try:
                m.faults.FAULTS.arm("pipeline.finalize", mode="fail")
                t1 = pl.submit(sub_batch(4, start=0))
                with pytest.raises(m.pipeline.PipelineError):
                    t1.result(timeout=5)
                t2 = pl.submit(sub_batch(4, start=4))
                with pytest.raises(m.pipeline.PipelineError):
                    t2.result(timeout=5)
                assert pl.breaker.state == "open"
                return outcome(t1), outcome(t2), pl.breaker.state
            finally:
                m.faults.FAULTS.reset()
                pl.close(timeout=5)
        both(case)


# --------------------------------------------------------------------------- #
class TestWatchdogRestart:
    def test_parity_across_forced_restart(self):
        """A hang-mode fault wedges the worker mid-stream and the watchdog
        restarts it: every ticket resolves or is rejected, every resolved
        verdict equals the serial path's on its own package, and the
        serial paths and the post-restart verdicts of both packages are
        equal."""
        def case(m):
            ser = fake_engine(m)
            pipe = fake_engine(m, pipeline_min_bucket=16,
                               pipeline_flush_ms=1.0,
                               pipeline_stall_timeout_s=0.2,
                               pipeline_restart_backoff_s=0.02,
                               pipeline_max_restarts=3)
            for eng in (ser, pipe):
                eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",),
                                 ep_id=1)
                eng.apply_policy(POLICY)
            slot_of = ser.active.snapshot.ep_slot_of
            chunks = unique_chunks(slot_of, n_chunks=10, rows=5)
            serial = [ser.classify(dict(ch), now=100 + i)
                      for i, ch in enumerate(chunks)]
            m.faults.FAULTS.arm("pipeline.dispatch", mode="hang",
                                delay_s=2.0, times=1)
            tickets = [pipe.submit(dict(ch), now=100 + i)
                       for i, ch in enumerate(chunks)]
            assert pipe.drain(timeout=30)
            m.faults.FAULTS.disarm("pipeline.dispatch")
            assert all(t.done() for t in tickets)
            rejected = 0
            for i, t in enumerate(tickets):
                try:
                    got = t.result(timeout=1)
                except m.pipeline.PipelineError:
                    rejected += 1
                    continue
                for k in OUT_KEYS:
                    np.testing.assert_array_equal(got[k], serial[i][k])
            assert rejected >= 1
            assert pipe.pipeline_stats()["restarts"] == 1
            post = unique_chunks(slot_of, n_chunks=6, rows=5, base=50000)
            post_serial = [ser.classify(dict(ch), now=200 + i)
                           for i, ch in enumerate(post)]
            post_tickets = [pipe.submit(dict(ch), now=200 + i)
                            for i, ch in enumerate(post)]
            assert pipe.drain(timeout=30)
            post_outs = []
            for t, want in zip(post_tickets, post_serial):
                got = t.result(timeout=5)
                for k in OUT_KEYS:
                    np.testing.assert_array_equal(got[k], want[k])
                post_outs.append({k: got[k].tolist() for k in OUT_KEYS})
            assert pipe.pipeline_stats()["state"] == "ok"
            pipe.stop()
            ser.stop()
            return ([{k: o[k].tolist() for k in OUT_KEYS} for o in serial],
                    post_outs, 1)
        both(case)

    def test_hard_fail_past_restart_budget(self):
        def case(m):
            d = EchoDispatch()
            pl = guarded(m, d, max_restarts=1)
            bad = {"valid": np.ones(3, bool),
                   "sport": np.arange(3, dtype=np.int32)}
            seen = []
            for _ in range(2):
                t = pl.submit(dict(bad))
                with pytest.raises(m.pipeline.PipelineError):
                    t.result(timeout=5)
                seen.append(outcome(t))
                time.sleep(0.05)
            deadline = time.monotonic() + 5
            while pl.state() != "failed" and time.monotonic() < deadline:
                time.sleep(0.01)
            assert pl.state() == "failed"
            with pytest.raises(m.pipeline.PipelineUnavailable):
                pl.submit(sub_batch(4, start=0))
            assert pl.drain(timeout=5)
            assert pl.stats()["outstanding"] == 0
            assert pl.metrics.counters["pipeline_hard_failures_total"] == 1
            pl.close(timeout=5)
            return seen, pl.state(), pl.stats()["restarts"]
        both(case)

    def test_close_timeout_sweeps_stranded_tickets(self):
        def case(m):
            d = EchoDispatch()
            d.gate.clear()
            pl = guarded(m, d, queue_batches=32)
            tickets = [pl.submit(sub_batch(4, start=4 * i))
                       for i in range(5)]
            t0 = time.monotonic()
            pl.close(timeout=0.3)
            assert time.monotonic() - t0 < 5
            for t in tickets:
                assert t.done()
                with pytest.raises(m.pipeline.PipelineError):
                    t.result(timeout=1)
            assert pl.stats()["outstanding"] == 0
            d.gate.set()
            time.sleep(0.1)
            with pytest.raises(m.pipeline.PipelineClosed):
                pl.submit(sub_batch(4, start=0))
            return [outcome(t) for t in tickets], pl.stats()["outstanding"]
        both(case)

    def test_close_without_timeout_never_hangs_on_wedged_worker(self):
        def case(m):
            d = EchoDispatch()
            d.gate.clear()
            pl = guarded(m, d, stall_timeout_s=0.2)
            tickets = [pl.submit(sub_batch(4, start=4 * i))
                       for i in range(3)]
            t0 = time.monotonic()
            pl.close()
            assert time.monotonic() - t0 < 10
            for t in tickets:
                assert t.done()
                with pytest.raises(m.pipeline.PipelineError):
                    t.result(timeout=1)
            assert pl.stats()["outstanding"] == 0
            d.gate.set()
            return all(t.done() for t in tickets), \
                pl.stats()["outstanding"]
        both(case)

    def test_close_without_timeout_after_hard_fail_zombie(self):
        def case(m):
            d = EchoDispatch()
            d.gate.clear()
            pl = guarded(m, d, stall_timeout_s=0.05, max_restarts=0)
            t = pl.submit(sub_batch(4, start=0))
            with pytest.raises(m.pipeline.PipelineError):
                t.result(timeout=10)
            deadline = time.monotonic() + 5
            while pl.state() != "failed" and time.monotonic() < deadline:
                time.sleep(0.01)
            assert pl.state() == "failed"
            t0 = time.monotonic()
            pl.close()
            assert time.monotonic() - t0 < 10
            d.gate.set()
            return outcome(t), "failed"
        both(case)

    def test_engine_health_folds_pipeline_state(self):
        def case(m):
            eng = fake_engine(m, pipeline_breaker_threshold=3,
                              pipeline_breaker_cooldown_s=0.2)
            eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",),
                             ep_id=1)
            eng.apply_policy(POLICY)
            slot_of = eng.active.snapshot.ep_slot_of
            assert "pipeline" not in eng.health()
            m.faults.FAULTS.arm("pipeline.dispatch", mode="fail")
            t = eng.submit(batch_from_records(
                [pkt("192.168.1.10", "10.1.2.3", 40000, 443)], slot_of),
                now=100)
            with pytest.raises(m.pipeline.PipelineUnavailable):
                t.result(timeout=10)
            h = eng.health()
            assert h["state"] == C.HEALTH_DEGRADED
            assert h["pipeline"]["state"] == "breaker-open"
            assert h["pipeline"]["breaker"]["consecutive_failures"] >= 3
            text = eng.render_metrics()
            assert 'pipeline_breaker_transitions_total{to="open"} 1' in text
            assert "ciliumtpu_pipeline_state 1" in text
            open_ = (h["state"], h["pipeline"]["state"])
            m.faults.FAULTS.disarm("pipeline.dispatch")
            time.sleep(0.25)
            out = eng.submit(batch_from_records(
                [pkt("192.168.1.10", "10.1.2.3", 40001, 443)], slot_of),
                now=101).result(timeout=10)
            assert out["allow"].all()
            h = eng.health()
            assert h["state"] == C.HEALTH_OK
            assert h["pipeline"]["state"] == "ok"
            eng.stop()
            return open_, (h["state"], h["pipeline"]["state"]), \
                {k: out[k].tolist() for k in OUT_KEYS}
        both(case)


# --------------------------------------------------------------------------- #
class TestShutdownRaces:
    def test_drain_racing_close(self):
        def case(m):
            d = EchoDispatch()
            d.gate.clear()
            pl = guarded(m, d, queue_batches=32)
            for i in range(6):
                pl.submit(sub_batch(4, start=4 * i))
            results = {}
            th = threading.Thread(target=lambda: results.setdefault(
                "drained", pl.drain(timeout=10)))
            th.start()
            time.sleep(0.05)
            d.gate.set()
            pl.close(timeout=10)
            th.join(timeout=10)
            assert not th.is_alive()
            assert results["drained"] is True
            assert pl.stats()["outstanding"] == 0
            return results, d.sports_seen
        both(case)

    def test_drain_racing_wedged_close(self):
        def case(m):
            d = EchoDispatch()
            d.gate.clear()
            pl = guarded(m, d, queue_batches=32)
            for i in range(4):
                pl.submit(sub_batch(4, start=4 * i))
            results = {}
            th = threading.Thread(target=lambda: results.setdefault(
                "drained", pl.drain(timeout=10)))
            th.start()
            time.sleep(0.05)
            pl.close(timeout=0.3)
            th.join(timeout=10)
            assert not th.is_alive()
            assert results["drained"] is True
            assert pl.stats()["outstanding"] == 0
            d.gate.set()
            return results, pl.stats()["outstanding"]
        both(case)

    def test_submit_blocked_at_admission_sees_close(self):
        def case(m):
            d = EchoDispatch()
            d.gate.clear()
            pl = guarded(m, d, queue_batches=1, block_timeout_s=30.0)
            first = pl.submit(sub_batch(4, start=0))
            time.sleep(0.05)
            second = pl.submit(sub_batch(4, start=4))
            errors = {}

            def blocked_submit():
                try:
                    pl.submit(sub_batch(4, start=8))
                except BaseException as e:   # noqa: BLE001
                    errors["exc"] = e

            th = threading.Thread(target=blocked_submit)
            th.start()
            time.sleep(0.1)
            assert th.is_alive()
            d.gate.set()
            pl.close(timeout=10)
            th.join(timeout=10)
            assert not th.is_alive()
            assert isinstance(errors.get("exc"), m.pipeline.PipelineClosed)
            assert first.result(timeout=1)["allow"].all()
            assert second.result(timeout=1)["allow"].all()
            assert pl.stats()["outstanding"] == 0
            assert pl.drain(timeout=1)
            return (type(errors["exc"]).__name__, outcome(first),
                    outcome(second), d.sports_seen)
        both(case)


# --------------------------------------------------------------------------- #
class TestHangFaultMode:
    def test_hang_is_bounded_and_disarm_releases(self):
        def case(m):
            faults = m.faults.FAULTS
            faults.arm("pipeline.dispatch", mode="hang", delay_s=5.0)
            t0 = time.monotonic()
            released = {}

            def firer():
                faults.fire("pipeline.dispatch")
                released["after"] = time.monotonic() - t0

            th = threading.Thread(target=firer)
            th.start()
            time.sleep(0.1)
            faults.disarm("pipeline.dispatch")
            th.join(timeout=5)
            assert not th.is_alive()
            assert released["after"] < 1.0
            fired = faults.stats()["pipeline.dispatch"]["fired"]
            assert fired >= 1
            return fired
        both(case)

    def test_hang_cap_is_clamped(self):
        def case(m):
            spec = m.faults.FaultSpec(mode="hang", delay_s=10_000.0)
            assert spec.delay_s == 10_000.0
            assert m.faults.HANG_HARD_CAP_S <= 30.0
            return spec.delay_s, m.faults.HANG_HARD_CAP_S
        both(case)

    def test_new_points_registered_and_env_grammar(self):
        def case(m):
            f = m.faults
            assert "pipeline.finalize" in f.POINTS
            assert "datapath.transfer" in f.POINTS
            inj = f.FaultInjector(env={})
            assert inj.load_spec("pipeline.finalize=hang:0.05;"
                                 "datapath.transfer=fail:2") == 2
            armed = inj.armed()
            assert armed["pipeline.finalize"].mode == "hang"
            assert armed["pipeline.finalize"].delay_s == 0.05
            assert armed["datapath.transfer"].times == 2
            return sorted(f.POINTS), {k: (v.mode, v.delay_s, v.times)
                                      for k, v in armed.items()}
        both(case)


# --------------------------------------------------------------------------- #
def live_engine(m, tmp_path):
    sock = str(tmp_path / f"{m.side}.sock")
    eng = fake_engine(m, api_socket=sock, pipeline_breaker_threshold=3,
                      pipeline_breaker_cooldown_s=30.0,
                      pipeline_request_timeout_s=5.0)
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
    eng.apply_policy(POLICY)
    eng.regenerate()
    eng.start_background()
    return eng, m.api.UnixAPIClient(sock)


def served(case, tmp_path):
    """``case(m, eng, client)`` on each package's live engine."""
    def run(m):
        eng, client = live_engine(m, tmp_path)
        try:
            return case(m, eng, client)
        finally:
            eng.stop()
            m.faults.FAULTS.reset()
    return both(run)


class TestServingAPI:
    def test_classify_route_serves_verdicts(self, tmp_path):
        def case(m, eng, client):
            code, doc = client.post("/v1/classify", {"records": [
                {"src": "192.168.1.10", "dst": "10.1.2.3", "sport": 40000,
                 "dport": 443, "proto": "TCP", "ep": 1},
                {"src": "192.168.1.10", "dst": "10.1.2.3", "sport": 40001,
                 "dport": 80, "proto": "TCP", "ep": 1}]})
            assert code == 200 and doc["count"] == 2
            assert doc["verdicts"][0]["allow"] is True
            assert doc["verdicts"][1]["allow"] is False
            out = eng.classify(batch_from_records(
                [pkt("192.168.1.10", "10.1.2.3", 40002, 443)],
                eng.active.snapshot.ep_slot_of))
            assert bool(out["allow"][0]) is True
            return code, doc, {k: out[k].tolist() for k in OUT_KEYS}
        served(case, tmp_path)

    def test_classify_route_maps_unavailable_to_503(self, tmp_path):
        def case(m, eng, client):
            m.faults.FAULTS.arm("pipeline.dispatch", mode="fail")
            rec = {"src": "192.168.1.10", "dst": "10.1.2.3", "sport": 41000,
                   "dport": 443, "proto": "TCP", "ep": 1}
            code, doc = client.post("/v1/classify", {"records": [rec]})
            assert code == 503 and doc["kind"] == "PipelineUnavailable"
            code2, doc2 = client.post("/v1/classify", {"records": [rec]})
            assert code2 == 503 and "error" in doc2
            code3, h = client.get("/v1/healthz")
            assert code3 == 200 and h["pipeline"]["state"] == "breaker-open"
            assert h["state"] == C.HEALTH_DEGRADED
            return (code, doc["kind"], code2, doc2.get("kind"), code3,
                    h["state"], h["pipeline"]["state"])
        served(case, tmp_path)

    def test_classify_route_validates_body(self, tmp_path):
        def case(m, eng, client):
            code, doc = client.post("/v1/classify", {})
            assert code == 400
            code2, doc2 = client.post("/v1/classify",
                                      {"records": [{"src": "10.0.0.1"}]})
            assert code2 == 400 and "missing" in doc2["error"]
            return code, doc, code2, doc2
        served(case, tmp_path)

    def test_serving_error_mapping(self):
        def case(m):
            p = m.pipeline
            se = m.api.serving_error
            got = [se(p.PipelineDrop("q full"))[0],
                   se(p.PipelineDeadlineExceeded("late"))[0],
                   se(p.PipelineUnavailable("open"))[0],
                   se(p.PipelineClosed("closed"))[0],
                   se(TimeoutError("slow"))[0],
                   se(p.PipelineError("other"))[0],
                   se(ValueError("bug"))]
            assert got == [429, 429, 503, 503, 503, 503, None]
            return got
        both(case)


# --------------------------------------------------------------------------- #
@pytest.mark.slow
class TestWatchdogSoak:
    def test_soak_10k_submissions_through_forced_restarts(self):
        """10k submissions with a hang fault tripping three times (three
        watchdog restarts) on each package: every resolved row reached the
        dispatch exactly once, in order; the restarts and the end state
        are equal."""
        def case(m):
            d = EchoDispatch()
            pl = m.pipeline.Pipeline(
                d, min_bucket=4, max_bucket=16, flush_ms=0.5,
                queue_batches=256, block_timeout_s=30.0,
                stall_timeout_s=0.1, restart_backoff_s=0.01,
                max_restarts=10)
            m.faults.FAULTS.arm("pipeline.dispatch", mode="hang",
                                delay_s=0.6, times=3)
            n_sub = 10_000
            tickets = [pl.submit(sub_batch(4, start=4 * i))
                       for i in range(n_sub)]
            assert pl.drain(timeout=180)
            m.faults.FAULTS.disarm("pipeline.dispatch")
            assert all(t.done() for t in tickets)
            expected, rejected = [], 0
            for i, t in enumerate(tickets):
                try:
                    t.result(timeout=1)
                    expected.extend(range(4 * i, 4 * i + 4))
                except m.pipeline.PipelineError:
                    rejected += 1
            assert d.sports_seen == expected
            stats = pl.stats()
            assert stats["restarts"] == 3
            assert 3 <= rejected < n_sub // 10
            assert stats["state"] == "ok" and stats["outstanding"] == 0
            pl.close(timeout=10)
            return stats["restarts"], stats["state"]
        both(case)
