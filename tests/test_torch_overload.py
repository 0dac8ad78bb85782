"""The overload ladder of the port against the JAX package's, case for case
with ``test_overload.py``: OK → PRESSURE → OVERLOAD → SHED-NEW, priority
shedding at the admission queue, SHED-NEW at harvest, the flight
recorder's shed-reason split and the labelled-metrics scrape race.

Each case runs the reference's scenario once on each package's modules,
asserts the reference's expectations on both, and holds the two
observations equal, exactly: ladder states and their trail, shed counts
and reasons, the rows each dispatch saw, counters, gauges, health and
``status_doc`` keys. Left out of the observations, because they depend on
the wall clock: dwell and ``since`` seconds, trail time stamps, the
engine's shed rate (rows over the seconds between two steps; only its side
of the shed thresholds is kept) and which
submission fails fast (the reference's own test asserts only that one
does, within a second).
"""

import importlib
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from tests.test_pipeline import EchoDispatch, sub_batch

SIDES = ("jax", "torch")
PKG = {"jax": "cilium_tpu", "torch": "cilium_tpu_torch"}
MODS = {"guard": "pipeline.guard", "pipeline": "pipeline",
        "blackbox": "observe.blackbox", "metrics": "runtime.metrics",
        "feeder": "shim.feeder", "config": "runtime.config",
        "datapath": "runtime.datapath", "engine": "runtime.engine",
        "faults": "runtime.faults", "api": "runtime.api"}


def P(side):
    """``side``'s modules by short name."""
    return SimpleNamespace(side=side, **{
        k: importlib.import_module(f"{PKG[side]}.{v}")
        for k, v in MODS.items()})


def both(case):
    """Run ``case`` on each package. → the port's observation, held equal
    to the reference's."""
    obs = {s: case(P(s)) for s in SIDES}
    assert obs["jax"] == obs["torch"]
    return obs["torch"]


def config(m, **kw):
    if m.side == "torch":
        kw.setdefault("device", "cpu")
    return m.config.DaemonConfig(**kw)


def fake_engine(m, **kw):
    cfg = config(m, **kw)
    return m.engine.Engine(cfg, datapath=m.datapath.FakeDatapath(cfg))


def shed_side(rate, high, low):
    """Where a shed rate stands against the ladder's shed latch: the
    engine's rate is shed rows over the wall-clock time between two steps,
    so only its side of the thresholds is the same on both packages."""
    return "high" if rate >= high else "low" if rate <= low else "between"


def untimed_inputs(inputs, high, low):
    inputs = dict(inputs)
    if "shed_rate" in inputs:
        inputs["shed_rate"] = shed_side(inputs["shed_rate"], high, low)
    return inputs


def untimed_ladder(st, shed_high=50.0, shed_low=5.0):
    """An ``OverloadLadder.status()`` without its clock readings: dwell and
    ``since`` seconds and trail time stamps are dropped, and each observed
    shed rate is replaced by its side of the shed thresholds (``ladder``'s
    by default)."""
    st = dict(st)
    st.pop("since_s")
    st.pop("dwell_s")
    st["trail"] = [{k: untimed_inputs(v, shed_high, shed_low)
                    if k == "inputs" else v
                    for k, v in t.items() if k != "t"}
                   for t in st["trail"]]
    st["inputs"] = untimed_inputs(st["inputs"], shed_high, shed_low)
    return st


@pytest.fixture(autouse=True)
def _clean_faults():
    for s in SIDES:
        P(s).faults.FAULTS.reset()
    yield
    for s in SIDES:
        P(s).faults.FAULTS.reset()


# --------------------------------------------------------------------------- #
# the ladder state machine
# --------------------------------------------------------------------------- #
def ladder(m, **kw):
    kw.setdefault("up_ticks", 2)
    kw.setdefault("down_ticks", 3)
    return m.guard.OverloadLadder(queue_high=0.75, queue_low=0.25,
                                  shed_high=50.0, shed_low=5.0,
                                  ct_high=0.85, ct_low=0.6, **kw)


class TestOverloadLadder:
    def test_single_signal_holds_pressure(self):
        def case(m):
            lad = ladder(m)
            seen = [lad.observe(0.9, 0.0, 0.0) for _ in range(10)]
            assert seen[-1][0] == m.guard.OVERLOAD_PRESSURE
            return seen, untimed_ladder(lad.status())
        both(case)

    def test_two_signals_escalate_to_shed_new(self):
        def case(m):
            lad = ladder(m)
            states = [lad.observe(0.9, 100.0, 0.0)[0] for _ in range(8)]
            assert states[-1] == m.guard.OVERLOAD_SHED_NEW
            assert m.guard.OVERLOAD_OVERLOAD in states
            return states, untimed_ladder(lad.status())
        both(case)

    def test_hysteresis_latch_keeps_signal_lit_between_thresholds(self):
        def case(m):
            lad = ladder(m, up_ticks=1)
            seen = [lad.observe(0.9, 0.0, 0.0)]
            seen += [lad.observe(0.5, 0.0, 0.0) for _ in range(10)]
            assert seen[-1][0] == m.guard.OVERLOAD_PRESSURE
            seen += [lad.observe(0.1, 0.0, 0.0) for _ in range(10)]
            assert seen[-1][0] == 0
            return seen, untimed_ladder(lad.status())
        both(case)

    def test_descent_is_slow(self):
        def case(m):
            lad = ladder(m, up_ticks=1, down_ticks=4)
            ups = [lad.observe(0.9, 100.0, 0.9)[0] for _ in range(6)]
            assert lad.state == m.guard.OVERLOAD_SHED_NEW
            downs = [lad.observe(0.0, 0.0, 0.0)[0] for _ in range(12)]
            assert downs[-1] == 0
            assert downs[2] == m.guard.OVERLOAD_SHED_NEW
            # one rung at a time on the way down
            assert all(a - b in (0, 1) for a, b in zip(downs, downs[1:]))
            return ups, downs, untimed_ladder(lad.status())
        both(case)

    def test_dwell_and_trail_recorded(self):
        def case(m):
            lad = ladder(m, up_ticks=1)
            time.sleep(0.02)
            lad.observe(0.9, 100.0, 0.0)
            time.sleep(0.02)
            lad.observe(0.9, 100.0, 0.0)
            st = lad.status()
            assert st["level"] >= m.guard.OVERLOAD_PRESSURE
            assert st["dwell_s"]["ok"] > 0
            assert st["transitions"] >= 1
            assert st["trail"][0]["frm"] == "ok"
            assert st["inputs"]["severity"] >= 2
            return sorted(st["dwell_s"]), untimed_ladder(st)
        both(case)

    @pytest.mark.parametrize("kw", [dict(queue_high=0.2, queue_low=0.5),
                                    dict(up_ticks=0)])
    def test_bad_thresholds_rejected(self, kw):
        def case(m):
            with pytest.raises(ValueError) as e:
                m.guard.OverloadLadder(**kw)
            return str(e.value)
        both(case)


# --------------------------------------------------------------------------- #
# priority shedding at the admission queue
# --------------------------------------------------------------------------- #
def prio_batch(m, n_rows, start, prio):
    b = sub_batch(n_rows, start)
    b["_prio"] = np.full((n_rows,), prio, dtype=np.int8)
    return b


def mk_pipeline(m, d, **kw):
    kw.setdefault("max_bucket", 16)
    kw.setdefault("min_bucket", 1)
    kw.setdefault("queue_batches", 3)
    kw.setdefault("flush_ms", 2.0)
    kw.setdefault("block_timeout_s", 0.05)
    return m.pipeline.Pipeline(d, **kw)


PRIO = 'pipeline_shed_total{reason="priority"}'


class TestPriorityShed:
    def test_established_batch_displaces_flood_batch(self):
        def case(m):
            g = m.guard
            d = EchoDispatch()
            d.gate.clear()
            pl = mk_pipeline(m, d)
            pl.set_overload_state(g.OVERLOAD_PRESSURE)
            try:
                flood = [pl.submit(prio_batch(m, 4, 100 + 10 * i,
                                              g.PRIO_NEW))
                         for i in range(4)]
                legit = pl.submit(prio_batch(m, 4, 900, g.PRIO_ESTABLISHED))
                assert not legit.dropped
                victims = [t for t in flood if t.done()]
                assert len(victims) == 1
                with pytest.raises(m.pipeline.PipelineDrop):
                    victims[0].result(timeout=1)
                assert pl.metrics.counters[PRIO] == 1
                assert pl.stats()["shed_reasons"] == {"priority": 1}
                assert victims[0] is flood[-1]
                d.gate.set()
                assert pl.drain(timeout=10)
                outs = [t.result(timeout=5)["reason"].tolist()
                        for t in flood[:-1] + [legit]]
                assert d.sports_seen == [100, 101, 102, 103, 110, 111, 112,
                                         113, 120, 121, 122, 123, 900, 901,
                                         902, 903]
                return outs, d.sports_seen, pl.metrics.counters[PRIO]
            finally:
                d.gate.set()
                pl.close(timeout=5)
        both(case)

    def test_same_class_keeps_fifo_admission(self):
        def case(m):
            d = EchoDispatch()
            d.gate.clear()
            pl = mk_pipeline(m, d)
            pl.set_overload_state(m.guard.OVERLOAD_PRESSURE)
            try:
                for i in range(4):
                    pl.submit(prio_batch(m, 4, 100 + 10 * i,
                                         m.guard.PRIO_NEW))
                t = pl.submit(prio_batch(m, 4, 900, m.guard.PRIO_NEW))
                assert t.dropped
                assert pl.metrics.counters.get(PRIO, 0) == 0
                return t.dropped, pl.stats()["shed_reasons"]
            finally:
                d.gate.set()
                pl.close(timeout=5)
        both(case)

    def test_overload_level_fails_fast_without_blocking(self):
        def case(m):
            d = EchoDispatch()
            d.gate.clear()
            pl = mk_pipeline(m, d, block_timeout_s=5.0)
            pl.set_overload_state(m.guard.OVERLOAD_OVERLOAD)
            try:
                t0 = time.monotonic()
                dropped = None
                for i in range(8):
                    t = pl.submit(prio_batch(m, 4, 100 + 10 * i,
                                             m.guard.PRIO_NEW))
                    if t.dropped:
                        dropped = t
                        break
                assert dropped is not None
                assert time.monotonic() - t0 < 1.0
                with pytest.raises(m.pipeline.PipelineDrop) as e:
                    dropped.result(timeout=1)
                return "overload fail-fast" in str(e.value)
            finally:
                d.gate.set()
                pl.close(timeout=5)
        assert both(case)

    def test_level_zero_changes_nothing(self):
        def case(m):
            d = EchoDispatch()
            d.gate.clear()
            pl = mk_pipeline(m, d)
            try:
                for i in range(4):
                    pl.submit(prio_batch(m, 4, 100 + 10 * i,
                                         m.guard.PRIO_NEW))
                t = pl.submit(prio_batch(m, 4, 900,
                                         m.guard.PRIO_ESTABLISHED))
                assert t.dropped
                assert pl.metrics.counters.get(PRIO, 0) == 0
                return t.dropped, pl.stats()["shed_reasons"]
            finally:
                d.gate.set()
                pl.close(timeout=5)
        both(case)


# --------------------------------------------------------------------------- #
# SHED-NEW harvest shedding + priority classing
# --------------------------------------------------------------------------- #
class TestShedNew:
    def test_shed_new_rows_drops_exactly_the_low_prio(self):
        def case(m):
            g = m.guard
            b = sub_batch(8, 100)
            b["_prio"] = np.asarray(
                [g.PRIO_ESTABLISHED, g.PRIO_NEW, g.PRIO_UNKNOWN,
                 g.PRIO_ESTABLISHED, g.PRIO_NEW, g.PRIO_NEW,
                 g.PRIO_ESTABLISHED, g.PRIO_UNKNOWN], dtype=np.int8)
            shed = m.feeder.shed_new_rows(b)
            assert shed == 5
            assert b["valid"].tolist() == [True, False, False, True, False,
                                           False, True, False]
            return shed, b["valid"].tolist()
        both(case)

    def test_shed_new_events_ride_the_relaxed_spike_class(self):
        def case(m):
            fr = m.blackbox.FlightRecorder(shed_spike=4, shed_window_s=60.0,
                                           shed_spike_relaxed=1000)
            mt = m.metrics.Metrics()
            ns = SimpleNamespace(metrics=mt, prio_shed_rows=0,
                                 _event_sink=fr.record_event)
            sheds = []
            for _ in range(20):
                b = sub_batch(8, 100)
                b["_prio"] = np.full((8,), m.guard.PRIO_NEW, dtype=np.int8)
                sheds.append(m.feeder.ShimFeeder._shed_new(ns, b))
            assert sheds == [8] * 20 and ns.prio_shed_rows == 160
            assert mt.counters[
                'feeder_prio_shed_rows_total{class="new"}'] == 160
            st = fr.stats()
            assert st["events_total"] == 20
            assert st["frozen"] is False
            return sheds, dict(mt.counters), st["events_total"], \
                [e["kind"] for e in fr._events]
        both(case)

    def test_engine_ladder_propagates_to_pipeline_and_health(self):
        def case(m):
            g = m.guard
            eng = fake_engine(m, ct_capacity=1024, auto_regen=False,
                              overload_up_ticks=1, overload_down_ticks=2,
                              overload_shed_rate_high=10.0,
                              overload_shed_rate_low=1.0)
            eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",),
                             ep_id=1)
            eng.regenerate()
            try:
                pl = eng.start_pipeline()
                levels = [eng.overload_step()["level"]]
                eng.metrics.set_gauge("ct_occupancy", 0.95)
                for _ in range(5):
                    pl.shed_total += 500
                    levels.append(eng.overload_step()["level"])
                assert levels[-1] == g.OVERLOAD_SHED_NEW
                assert pl.stats()["overload_level"] == g.OVERLOAD_SHED_NEW
                assert eng.metrics.gauges["overload_state"] == \
                    g.OVERLOAD_SHED_NEW
                assert eng.metrics.counters[
                    'overload_transitions_total{to="shed-new"}'] == 1
                health = eng.health()
                assert health["overload"]["state"] == "shed-new"
                assert health["state"] == "DEGRADED"
                kinds = [e["kind"] for e in eng.blackbox._events]
                assert kinds.count("overload") >= 3
                assert eng.blackbox.stats()["frozen"] is False
                up = (health["state"], health["overload"]["state"],
                      kinds.count("overload"))
                eng.metrics.set_gauge("ct_occupancy", 0.0)
                for _ in range(12):
                    levels.append(eng.overload_step()["level"])
                assert levels[-1] == 0
                assert eng.health()["state"] == "OK"
                doc = m.api.status_doc(eng)
                assert doc["overload"]["state"] == "ok"
                counters = {k: v for k, v in eng.metrics.counters.items()
                            if k.startswith("overload_")}
                return levels, up, counters, \
                    untimed_ladder(doc["overload"], 10.0, 1.0)
            finally:
                eng.stop()
        both(case)

    def test_overload_decide_fault_leaves_state_standing(self):
        def case(m):
            eng = fake_engine(m, ct_capacity=1024, auto_regen=False,
                              overload_up_ticks=1,
                              overload_shed_rate_high=10.0,
                              overload_shed_rate_low=1.0)
            eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",),
                             ep_id=1)
            eng.regenerate()
            try:
                pl = eng.start_pipeline()
                eng.metrics.set_gauge("ct_occupancy", 0.95)
                for _ in range(4):
                    pl.shed_total += 500
                    eng.overload_step()
                level = eng.overload_status()["level"]
                assert level >= m.guard.OVERLOAD_OVERLOAD
                m.faults.FAULTS.arm("overload.decide", mode="fail", times=3)
                for _ in range(3):
                    with pytest.raises(m.faults.FaultInjected):
                        eng.overload_step()
                assert pl.stats()["overload_level"] == level
                assert eng.overload_status()["level"] == level
                return level, m.faults.FAULTS.stats()["overload.decide"]
            finally:
                eng.stop()
        both(case)


# --------------------------------------------------------------------------- #
# blackbox shed-reason split
# --------------------------------------------------------------------------- #
def recorder_state(fr):
    st = fr.stats()
    return ({k: st[k] for k in ("frozen", "frozen_reason", "events_total")},
            [(e["kind"], e.get("reason")) for e in fr._events])


class TestBlackboxShedSplit:
    def test_relaxed_reasons_do_not_freeze_at_strict_threshold(self):
        def case(m):
            fr = m.blackbox.FlightRecorder(shed_spike=4, shed_window_s=60.0,
                                           shed_spike_relaxed=1000)
            for i in range(100):
                fr.record_event("shed", reason="priority", seq=i)
            for i in range(100):
                fr.record_event("shed", reason="shed-new", seq=i)
            assert fr.stats()["frozen"] is False
            before = recorder_state(fr)
            for i in range(4):
                fr.record_event("shed", reason="flush", seq=i)
            st = fr.stats()
            assert st["frozen"] is True
            assert st["frozen_reason"] == "shed-spike"
            return before, recorder_state(fr)
        both(case)

    def test_relaxed_spike_still_freezes_eventually(self):
        def case(m):
            fr = m.blackbox.FlightRecorder(shed_spike=1000,
                                           shed_window_s=60.0,
                                           shed_spike_relaxed=8)
            for i in range(8):
                fr.record_event("shed", reason="priority", seq=i)
            assert fr.stats()["frozen"] is True
            return recorder_state(fr)
        both(case)

    def test_ladder_events_record_without_freezing(self):
        def case(m):
            fr = m.blackbox.FlightRecorder()
            fr.record_event("overload", state="shed-new", queue_frac=1.0)
            fr.record_event("ct-emergency", action="enter", occupancy=0.9)
            assert fr.stats()["frozen"] is False
            kinds = [e["kind"] for e in fr._events]
            assert kinds == ["overload", "ct-emergency"]
            return recorder_state(fr)
        both(case)


# --------------------------------------------------------------------------- #
# labeled-metrics scrape race
# --------------------------------------------------------------------------- #
class TestLabeledScrapeRace:
    def test_priority_and_class_label_families_race_render(self):
        def case(m):
            mt = m.metrics.Metrics()
            stop = threading.Event()
            errors, renders = [], []

            def scraper():
                try:
                    while not stop.is_set():
                        renders.append(mt.render_prometheus())
                except Exception as e:   # noqa: BLE001
                    errors.append(e)

            threads = [threading.Thread(target=scraper) for _ in range(2)]
            for t in threads:
                t.start()
            n = 400
            for i in range(n):
                mt.inc_counter(PRIO)
                mt.inc_counter('pipeline_shed_total{reason="ingest"}')
                mt.inc_counter('feeder_prio_shed_rows_total{class="new"}', 3)
                mt.inc_counter(
                    'feeder_prio_shed_rows_total{class="unknown"}', 1)
                mt.inc_counter(f'overload_transitions_total{{to='
                               f'"{("pressure", "overload")[i % 2]}"}}')
                mt.set_gauge("overload_state", i % 4)
                mt.histogram(
                    'ingest_e2e_latency_seconds{shard="0"}').observe(1e-4)
            stop.set()
            for t in threads:
                t.join(timeout=10)
            assert not errors
            final = mt.render_prometheus()
            for base in ("pipeline_shed_total", "feeder_prio_shed_rows_total",
                         "overload_transitions_total"):
                assert final.count(f"# TYPE ciliumtpu_{base} counter") == 1
            assert f'pipeline_shed_total{{reason="priority"}} {n}' in final
            assert f'feeder_prio_shed_rows_total{{class="new"}} {3 * n}' \
                in final
            assert final.count(
                "# TYPE ciliumtpu_ingest_e2e_latency_seconds histogram") == 1
            assert f'ingest_e2e_latency_seconds_count{{shard="0"}} {n}' \
                in final
            for doc in renders[:: max(1, len(renders) // 16)]:
                for base in ("pipeline_shed_total",
                             "overload_transitions_total"):
                    assert doc.count(
                        f"# TYPE ciliumtpu_{base} counter") <= 1
            return final
        both(case)
