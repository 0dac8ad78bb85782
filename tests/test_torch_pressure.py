"""The resource pressure ledger of the port against the JAX package's, case
for case with ``test_pressure.py``: ledger mechanics (registration,
high-water, time-to-exhaustion forecasts and their latch, gauge sweeps,
provider isolation), the engine's registrations, the CT row against the
``ct_occupancy`` gauge, the health detail, the ladder's fourth latch, the
scrape races, trace-ring drop accounting, departed-subject gauge sweeps,
the verifier's budget document and the device-memory ledger.

Each case runs the reference's scenario on each package's modules (the
engines on each package's ``FakeDatapath``, or ``JITDatapath`` on the CPU
against the port's ``TorchDatapath`` with ``device="cpu"``), asserts the
reference's expectations on both, and holds the two observations equal,
exactly: ledger reports, forecast events, gauges, health documents,
``status_doc`` and ``/v1/resources`` keys, wire-pool counts and the
ledger's byte groups. Left out: what the process-global tracer, the wall
clock or a racing thread decides (the resources that read the global
span ring, scrape interleavings), named where a case drops them.

The one case without a same-named function on the port:
``verifier.memory_stats`` reads an XLA executable's ``memory_analysis``;
the port's verifier measures a step with ``step_stats``, which must
report the same three keys.
"""

import importlib
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from cilium_tpu.kernels.records import batch_from_records, empty_batch
from cilium_tpu.utils import constants as C
from tests.test_datapath import pkt
from tests.test_pipeline import EchoDispatch, sub_batch

SIDES = ("jax", "torch")
PKG = {"jax": "cilium_tpu", "torch": "cilium_tpu_torch"}
MODS = {"pressure": "observe.pressure", "trace": "observe.trace",
        "config": "runtime.config", "datapath": "runtime.datapath",
        "engine": "runtime.engine", "metrics": "runtime.metrics",
        "faults": "runtime.faults", "guard": "pipeline.guard",
        "pipeline": "pipeline", "api": "runtime.api",
        "verifier": "compile.verifier", "mapstate": "policy.mapstate"}


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


def config(m, **kw):
    kw.setdefault("auto_regen", False)
    if m.side == "torch":
        kw["device"] = "cpu"
    return m.config.DaemonConfig(**kw)


def real_datapath(m, cfg):
    return (m.datapath.TorchDatapath if m.side == "torch"
            else m.datapath.JITDatapath)(cfg)


def fake_engine(m, **kw):
    cfg = config(m, **kw)
    eng = m.engine.Engine(cfg, datapath=m.datapath.FakeDatapath(cfg))
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.0.10",))
    eng.apply_policy([{"endpointSelector": {"matchLabels": {"app": "web"}},
                       "egress": [{"toCIDR": ["10.0.0.0/8"]}]}])
    eng.regenerate()
    return eng


# --------------------------------------------------------------------------- #
class TestResourceLedger:
    def test_poll_derives_pressure_and_high_water(self):
        def case(m):
            mt = m.metrics.Metrics()
            led = m.pressure.ResourceLedger(metrics=mt)
            occ = {"v": 25.0}
            led.register("p", lambda: {"r": (100, occ["v"])})
            rows = [led.poll(now=1.0)["resources"]["r"]]
            assert rows[0]["capacity"] == 100 and rows[0]["occupancy"] == 25
            assert rows[0]["pressure"] == 0.25
            assert rows[0]["high_water"] == 25
            occ["v"] = 60.0
            rows.append(led.poll(now=2.0)["resources"]["r"])
            occ["v"] = 10.0
            rows.append(led.poll(now=3.0)["resources"]["r"])
            assert rows[-1]["occupancy"] == 10
            assert rows[-1]["high_water"] == 60
            assert mt.gauges['resource_high_water{resource="r"}'] == 60
            assert mt.gauges['resource_pressure{resource="r"}'] == 0.1
            return rows, dict(mt.gauges)
        both(case)

    def test_explicit_pressure_passes_through_verbatim(self):
        def case(m):
            led = m.pressure.ResourceLedger()
            led.register("p", lambda: {"ring": (256, 256, 0.0)})
            row = led.poll(now=1.0)["resources"]["ring"]
            assert row["occupancy"] == 256 and row["pressure"] == 0.0
            assert led.pressured() == []
            return row, led.pressured()
        both(case)

    def test_eta_fires_before_exhaustion_then_freezes_on_it(self):
        def case(m):
            events = []
            led = m.pressure.ResourceLedger(
                eta_warn_s=50.0, warn=0.5, crit=0.9,
                event_sink=lambda kind, **a: events.append((kind, a)))
            occ = {"v": 0.0}
            led.register("p", lambda: {"ct": (100, occ["v"])})
            for t in range(8):
                occ["v"] = 10.0 * t
                led.poll(now=float(t))
            kinds = [k for k, _ in events]
            assert "resource-pressure" in kinds
            fc = dict(events)["resource-pressure"]
            assert fc["resource"] == "ct" and fc["eta_s"] > 0
            assert "resource-exhaustion" not in kinds
            assert kinds.count("resource-pressure") == 1
            occ["v"] = 100.0
            led.poll(now=8.0)
            assert [k for k, _ in events].count("resource-exhaustion") == 1
            assert led.report()["exhaustions_total"] == 1
            return events, led.report()
        both(case)

    def test_flat_or_shrinking_resource_has_no_eta(self):
        def case(m):
            led = m.pressure.ResourceLedger()
            led.register("p", lambda: {"r": (100, 50.0)})
            for t in range(4):
                led.poll(now=float(t))
            row = led.poll(now=5.0)["resources"]["r"]
            assert row["eta_s"] is None
            return row
        both(case)

    def test_forecast_rearms_after_recovery(self):
        def case(m):
            events = []
            led = m.pressure.ResourceLedger(
                eta_warn_s=100.0, warn=0.5, crit=0.99,
                event_sink=lambda kind, **a: events.append(kind))
            occ = {"v": 0.0}
            led.register("p", lambda: {"r": (100, occ["v"])})
            for t in range(7):
                occ["v"] = 10.0 * t
                led.poll(now=float(t))
            assert events.count("resource-pressure") == 1
            for t in range(7, 12):
                occ["v"] = 10.0
                led.poll(now=float(t))
            for t in range(12, 19):
                occ["v"] = 10.0 * (t - 11)
                led.poll(now=float(t))
            assert events.count("resource-pressure") == 2
            return events, led.report()
        both(case)

    def test_deregister_sweeps_every_gauge_family(self):
        def case(m):
            mt = m.metrics.Metrics()
            led = m.pressure.ResourceLedger(metrics=mt)
            led.register("p", lambda: {"a": (10, 9.0), "b": (10, 2.0)})
            led.poll(now=1.0)
            assert 'resource_occupancy{resource="a"}' in mt.gauges
            before = dict(mt.gauges)
            gone = led.deregister("p")
            assert sorted(gone) == ["a", "b"]
            for fam in m.pressure.GAUGE_FAMILIES:
                for r in ("a", "b"):
                    assert f'{fam}{{resource="{r}"}}' not in mt.gauges
            assert led.report()["resources"] == {}
            return before, sorted(gone), dict(mt.gauges), \
                m.pressure.GAUGE_FAMILIES
        both(case)

    def test_silently_departed_resource_is_swept(self):
        def case(m):
            mt = m.metrics.Metrics()
            led = m.pressure.ResourceLedger(metrics=mt)
            have = {"a": (10, 9.0), "b": (10, 2.0)}
            led.register("p", lambda: dict(have))
            led.poll(now=1.0)
            assert 'resource_pressure{resource="a"}' in mt.gauges
            del have["a"]
            rep = led.poll(now=2.0)
            assert "a" not in rep["resources"] and "b" in rep["resources"]
            for fam in m.pressure.GAUGE_FAMILIES:
                assert f'{fam}{{resource="a"}}' not in mt.gauges
            led.register("q", lambda: {"c": (10, 5.0)})
            led.poll(now=3.0)

            def boom():
                raise RuntimeError("transient")
            led.register("q", boom)
            rep2 = led.poll(now=4.0)
            assert "c" in rep2["resources"]
            return rep, rep2, dict(mt.gauges)
        both(case)

    def test_failing_provider_is_isolated_and_counted(self):
        def case(m):
            led = m.pressure.ResourceLedger()

            def bad():
                raise RuntimeError("boom")
            led.register("bad", bad)
            led.register("good", lambda: {"r": (10, 5.0)})
            rep = led.poll(now=1.0)
            assert rep["resources"]["r"]["occupancy"] == 5
            assert rep["provider_errors_total"] == 1
            return rep
        both(case)

    def test_max_pressure_respects_exclusions(self):
        def case(m):
            led = m.pressure.ResourceLedger()
            led.register("p", lambda: {"ct_table": (10, 10.0),
                                       "other": (10, 3.0)})
            led.poll(now=1.0)
            got = (led.max_pressure(),
                   led.max_pressure(exclude=m.pressure.LADDER_EXCLUDE))
            assert got == (1.0, 0.3)
            return got, sorted(m.pressure.LADDER_EXCLUDE)
        both(case)

    @pytest.mark.parametrize("kw", [dict(warn=0.9, crit=0.5),
                                    dict(window=1), dict(eta_warn_s=0)])
    def test_validation(self, kw):
        def case(m):
            with pytest.raises(ValueError) as e:
                m.pressure.ResourceLedger(**kw)
            return str(e.value)
        both(case)


# --------------------------------------------------------------------------- #
#: resources whose rows read process-global state: the span tracer's ring,
#: which other tests on the same worker reconfigure, and each package's
#: classify-function memo (registered once the package's step module is
#: loaded; its size depends on what else ran in the process)
GLOBAL_ROWS = ("trace_ring", "classify_fn_cache")


def local_rows(rep):
    return {k: v for k, v in rep["resources"].items()
            if k not in GLOBAL_ROWS}


class TestEngineLedger:
    def test_at_least_twelve_resources_register(self):
        def case(m):
            eng = fake_engine(m)
            try:
                eng.start_pipeline()
                rep = eng.resource_step(now=1.0)
                assert len(rep["resources"]) >= 12, sorted(rep["resources"])
                for name in ("ct_table", "admission_queue", "flowlog_ring",
                             "trace_ring", "blackbox_events", "audit_pool",
                             "mapstate_overlay", "patch_budget"):
                    assert name in rep["resources"], name
                return sorted(local_rows(rep))
            finally:
                eng.stop()
        both(case)

    def test_ct_row_tracks_occupancy_gauge_exactly(self):
        def case(m):
            eng = fake_engine(m, ct_capacity=1 << 10)
            try:
                recs = [pkt("192.168.0.10", f"10.0.{i >> 8}.{i & 255}",
                            40000 + i, 443, ep_id=1) for i in range(64)]
                eng.classify(batch_from_records(
                    recs, eng.active.snapshot.ep_slot_of), now=1000)
                eng.sweep(now=1000)
                gauge = eng.metrics.gauges["ct_occupancy"]
                assert gauge > 0
                row = eng.resource_step(now=5.0)["resources"]["ct_table"]
                assert row["pressure"] == gauge
                assert row["occupancy"] == gauge * (1 << 10)
                return gauge, row
            finally:
                eng.stop()
        both(case)

    def test_health_resource_pressure_detail_and_degrade(self):
        def case(m):
            eng = fake_engine(m)
            try:
                assert "resources" not in eng.health()
                eng.ledger.register("drill",
                                    lambda: {"drill_pool": (10, 8.0)})
                eng.resource_step(now=1.0)
                h1 = eng.health()
                assert h1["resources"]["detail"] == C.RESOURCE_PRESSURE
                assert "drill_pool" in h1["resources"]["pressured"]
                assert h1["state"] == C.HEALTH_OK
                eng.ledger.register("drill",
                                    lambda: {"drill_pool": (10, 10.0)})
                eng.resource_step(now=2.0)
                h2 = eng.health()
                assert h2["resources"]["critical"]
                assert h2["state"] == C.HEALTH_DEGRADED
                eng.ledger.deregister("drill")
                assert "resources" not in eng.health()
                return (h1["state"], h1["resources"], h2["state"],
                        h2["resources"])
            finally:
                eng.stop()
        both(case)

    def test_overload_ladder_takes_resource_as_fourth_latch(self):
        def case(m):
            eng = fake_engine(m, overload_up_ticks=1)
            try:
                eng.ledger.register("drill",
                                    lambda: {"drill_pool": (10, 10.0)})
                eng.resource_step(now=1.0)
                st1 = eng.overload_step()
                assert st1["inputs"]["resource_pressure"] == 1.0
                assert st1["lit"]["resource"]
                st2 = eng.overload_step()
                assert st2["level"] == m.guard.OVERLOAD_PRESSURE
                eng.ledger.deregister("drill")
                eng.ledger.register("drill2",
                                    lambda: {"audit_pool": (8, 8.0)})
                eng.resource_step(now=2.0)
                st3 = eng.overload_step()
                assert st3["inputs"]["resource_pressure"] == 0.0
                return [(s["level"], s["lit"], s["inputs"]["severity"],
                         s["inputs"]["resource_pressure"])
                        for s in (st1, st2, st3)]
            finally:
                eng.stop()
        both(case)

    def test_past_patch_budget_consumption_is_not_standing_pressure(self):
        def case(m):
            eng = fake_engine(m)
            try:
                class _St:
                    delta_rows = 1000
                    new_identities = 500
                eng._last_update_stats = _St()
                rep = eng.resource_step(now=1.0)
                row = rep["resources"]["patch_budget"]
                assert row["occupancy"] == 1000
                assert row["pressure"] == 0.0
                assert "resources" not in eng.health()
                st = eng.overload_step()
                assert st["inputs"]["resource_pressure"] == 0.0
                return row, st["level"]
            finally:
                eng.stop()
        both(case)

    def test_ladder_caps_at_shed_new_with_all_four_signals_lit(self):
        def case(m):
            ladder = m.guard.OverloadLadder(up_ticks=1)
            states = [ladder.observe(1.0, 100.0, 1.0,
                                     resource_pressure=1.0)[0]
                      for _ in range(6)]
            assert states[-1] == m.guard.OVERLOAD_SHED_NEW
            assert ladder.status()["inputs"]["severity"] == 4
            return states, ladder.status()["inputs"]
        both(case)

    def test_wire_out_shed_on_failed_dispatch(self):
        def case(m):
            cfg = config(m, ct_capacity=1 << 10)
            eng = m.engine.Engine(cfg, datapath=real_datapath(m, cfg))
            faults = m.faults.FAULTS
            try:
                eng.add_endpoint(["k8s:app=web"], ips=("192.168.0.10",))
                eng.regenerate()
                b = empty_batch(64)
                faults.reset()
                faults.load_spec("ct.insert=fail:3")
                errors = []
                for _ in range(3):
                    with pytest.raises(Exception) as e:
                        eng.classify(dict(b), now=1000)
                    errors.append(type(e.value).__name__)
                faults.reset()
                seen = [eng.datapath.wire_pool_stats()["in_flight"]]
                assert seen[0] == 0
                eng.classify(dict(b), now=1000)
                seen.append(eng.datapath.wire_pool_stats()["in_flight"])
                assert seen[1] == 0
                return errors, seen
            finally:
                faults.reset()
                eng.stop()
        both(case)

    def test_wire_pool_occupancy_counts_checkouts_not_free(self):
        def case(m):
            dp = real_datapath(m, config(m, ct_capacity=1 << 10))
            seen = [dp.wire_pool_stats()]
            assert seen[0]["in_flight"] == 0
            with dp._pack_lock:
                buf = dp._wire_buf(256, 4)
            seen.append(dp.wire_pool_stats())
            assert seen[1]["in_flight"] == 1
            dp._wire_buf_release((256, 4), buf)
            seen.append(dp.wire_pool_stats())
            assert seen[2]["in_flight"] == 0 and seen[2]["free"] == 1
            return seen
        both(case)

    def test_register_deregister_under_engine_restart(self):
        def case(m):
            eng = fake_engine(m)
            eng.start_pipeline()
            eng.resource_step(now=1.0)
            fams = sorted(g for g in eng.metrics.gauges
                          if g.startswith("resource_")
                          and not any(r in g for r in GLOBAL_ROWS))
            assert fams
            eng.stop()
            assert not [g for g in eng.metrics.gauges
                        if g.startswith("resource_")]
            assert eng.ledger.report()["resources"] == {}
            eng2 = fake_engine(m)
            try:
                rep = eng2.resource_step(now=1.0)
                assert "ct_table" in rep["resources"]
                return fams, sorted(local_rows(rep))
            finally:
                eng2.stop()
        both(case)

    def test_resource_families_survive_concurrent_scrapes(self):
        def case(m):
            eng = fake_engine(m)
            eng.start_pipeline()
            errors = []
            stop = threading.Event()

            def scraper():
                try:
                    while not stop.is_set():
                        assert "ciliumtpu_" in eng.render_metrics()
                except Exception as e:   # noqa: BLE001
                    errors.append(e)

            def churn():
                try:
                    i = 0
                    while not stop.is_set():
                        i += 1
                        eng.ledger.register(
                            "churn", lambda: {"churn_pool": (64, 32.0)})
                        eng.resource_step(now=float(i))
                        eng.ledger.deregister("churn")
                except Exception as e:   # noqa: BLE001
                    errors.append(e)

            threads = [threading.Thread(target=scraper) for _ in range(2)] \
                + [threading.Thread(target=churn)]
            for t in threads:
                t.start()
            time.sleep(0.8)
            stop.set()
            for t in threads:
                t.join(5)
            left = sorted(g for g in eng.metrics.gauges
                          if 'resource="churn_pool"' in g)
            eng.stop()
            assert not errors
            return errors, left
        both(case)

    def test_status_doc_carries_resources_and_hbm(self):
        def case(m):
            eng = fake_engine(m)
            try:
                eng.resource_step(now=1.0)
                doc = m.api.status_doc(eng)
                assert "pressured" in doc["resources"]
                assert doc["hbm"]["ledger"] is None
                eng.note_verifier_budget({"worst_total_bytes": 123})
                doc2 = m.api.status_doc(eng)
                assert doc2["hbm"]["verifier"]["worst_total_bytes"] == 123
                return sorted(doc), doc["hbm"], doc2["hbm"], \
                    sorted(doc["resources"])
            finally:
                eng.stop()
        both(case)

    def test_resources_api_route(self, tmp_path):
        def case(m):
            eng = fake_engine(m)
            sock = str(tmp_path / f"{m.side}.sock")
            srv = m.api.APIServer(eng, sock)
            srv.start()
            try:
                eng.resource_step(now=1.0)
                client = m.api.UnixAPIClient(sock)
                status, doc = client.get("/v1/resources")
                assert status == 200
                assert "ct_table" in doc["resources"]
                assert doc["hbm"]["ledger"] is None
                polls = doc["polls_total"]
                status2, doc2 = client.get("/v1/resources")
                assert doc2["polls_total"] == polls
                return status, polls, doc2["polls_total"], \
                    local_rows(doc), doc["hbm"]
            finally:
                srv.stop()
                eng.stop()
        both(case)


# --------------------------------------------------------------------------- #
class TestTraceRingDropAccounting:
    def test_overwrites_count_and_wraps(self):
        def case(m):
            tr = m.trace.Tracer(sample_rate=1.0, capacity=4)
            for _ in range(10):
                tr.record(tr.maybe_sample(), "s", 0.0, 0.001)
            st = tr.stats()
            assert st["spans_in_ring"] == 4
            assert st["spans_dropped_total"] == 6
            assert st["ring_wraps"] == 1
            tr.reset()
            st2 = tr.stats()
            assert st2["spans_dropped_total"] == 0 and st2["ring_wraps"] == 0
            return st, st2
        both(case)

    def test_no_drops_while_ring_has_room(self):
        def case(m):
            tr = m.trace.Tracer(sample_rate=1.0, capacity=16)
            for _ in range(10):
                tr.record(tr.maybe_sample(), "s", 0.0, 0.001)
            st = tr.stats()
            assert st["spans_dropped_total"] == 0 and st["ring_wraps"] == 0
            return st
        both(case)

    def test_engine_exports_drop_counters(self):
        def case(m):
            tracer = m.trace.TRACER
            eng = fake_engine(m)
            try:
                tracer.reset()
                tracer.configure(sample_rate=1.0, capacity=4)
                for _ in range(9):
                    tracer.record(tracer.maybe_sample(), "drill", 0.0, 0.001)
                text = eng.render_metrics()
                assert "ciliumtpu_trace_spans_dropped_total 5" in text
                assert "ciliumtpu_trace_ring_wraps_total 1" in text
                return [ln for ln in text.splitlines()
                        if ln.startswith("ciliumtpu_trace_")]
            finally:
                tracer.configure(sample_rate=0.0, capacity=4096)
                tracer.reset()
                eng.stop()
        both(case)


# --------------------------------------------------------------------------- #
class TestDepartedSubjectSweeps:
    def test_pipeline_close_drops_shard_gauges(self):
        def case(m):
            mt = m.metrics.Metrics()
            echo = EchoDispatch()
            pl = m.pipeline.Pipeline(
                lambda b, now, steer_rev=None: echo(b, now), metrics=mt,
                max_bucket=64, min_bucket=8, n_shards=2,
                shard_fn=lambda b: np.zeros(b["valid"].shape[0],
                                            dtype=np.int64))
            out = pl.submit(sub_batch(8, 0)).result(timeout=10)
            assert 'pipeline_staged_rows{shard="0"}' in mt.gauges
            before = sorted(g for g in mt.gauges if "shard=" in g)
            pl.close(timeout=10)
            assert 'pipeline_staged_rows{shard="0"}' not in mt.gauges
            assert 'pipeline_staged_rows{shard="1"}' not in mt.gauges
            return out["reason"].tolist(), before, \
                sorted(g for g in mt.gauges if "shard=" in g)
        both(case)

    def test_mesh_withdraw_drops_peer_lag_gauges(self, tmp_path):
        def case(m):
            store = tmp_path / m.side
            store.mkdir()
            eng = fake_engine(m)
            eng2 = None
            try:
                mesh = eng.attach_mesh(store_dir=str(store), node_name="a")
                cfg2 = config(m)
                eng2 = m.engine.Engine(cfg2,
                                       datapath=m.datapath.FakeDatapath(cfg2))
                eng2.add_endpoint(["k8s:app=db"], ips=("192.168.1.20",))
                eng2.regenerate()
                mesh2 = eng2.attach_mesh(store_dir=str(store),
                                         node_name="b")
                mesh2.step()
                mesh.step()
                lag = 'clustermesh_peer_lag_seconds{peer="b"}'
                seen = [lag in eng.metrics.gauges]
                assert seen[0]
                mesh.withdraw()
                seen.append(lag in eng.metrics.gauges)
                assert not seen[1]
                return seen
            finally:
                eng.stop()
                if eng2 is not None:
                    eng2.stop()
        both(case)


# --------------------------------------------------------------------------- #
class TestVerifierBudgetDoc:
    def test_budget_doc_summarizes_worst_combo(self):
        def case(m):
            v = m.verifier
            reports = [
                v.ComboReport(name="a", ok=True, argument_bytes=100,
                              temp_bytes=50),
                v.ComboReport(name="b", ok=True, argument_bytes=400,
                              temp_bytes=100),
                v.ComboReport(name="c", ok=False, error="reject")]
            doc = v.budget_doc(reports, max_hbm_bytes=1 << 20)
            assert doc["combos"] == 3 and doc["accepted"] == 2
            assert doc["rejected"] == ["c"]
            assert doc["worst_combo"] == "b"
            assert doc["worst_total_bytes"] == 500
            assert doc["max_hbm_bytes"] == 1 << 20
            return doc
        both(case)

    def test_memory_stats_public_name(self):
        """The JAX verifier's ``memory_stats`` reads an XLA executable's
        ``memory_analysis``; the port's ``step_stats`` measures one step
        of the classify function: the same three keys, each a count of
        bytes."""
        import torch

        from cilium_tpu.compile import verifier as jv
        from cilium_tpu_torch.compile import verifier as tv

        class FakeCompiled:
            def memory_analysis(self):
                class M:
                    argument_size_in_bytes = 10
                    temp_size_in_bytes = 20
                    output_size_in_bytes = 30
                return M()
        want = jv.memory_stats(FakeCompiled())
        assert want == {"argument_bytes": 10, "temp_bytes": 20,
                        "output_bytes": 30}
        tensors = {"t": torch.zeros(4, dtype=torch.int32)}
        ct = {"expiry": torch.zeros(8, dtype=torch.int32)}

        def step(t, c, arg, now, world_index):
            return ({"allow": torch.zeros(2, dtype=torch.bool)},
                    {k: v.clone() for k, v in c.items()},
                    {"n": torch.zeros(3, dtype=torch.int64)})
        got = tv.step_stats(step, tensors, ct, None, 0, 2, "cpu")
        assert sorted(got) == sorted(want)
        assert got == {"argument_bytes": 16 + 32, "temp_bytes": 0,
                       "output_bytes": 2 + 24 + 32}


class TestMapstateOverlayStats:
    def test_overlay_copy_updates_module_stats(self):
        def case(m):
            ms = m.mapstate.MapState()
            clone = ms.overlay_copy()
            base = m.mapstate.overlay_stats()
            assert base["fold_budget"] == m.mapstate.MapState.OVERLAY_FOLD_KEYS
            clone2 = clone.overlay_copy()
            grew = m.mapstate.overlay_stats()["copies"] - base["copies"]
            assert grew > 0
            assert clone2 is not clone
            return base["fold_budget"], grew
        both(case)


class TestJITHBMLedger:
    def test_place_and_patch_account_groups(self):
        def case(m):
            cfg = config(m, ct_capacity=1 << 10, max_hbm_bytes=1 << 28)
            eng = m.engine.Engine(cfg, datapath=real_datapath(m, cfg))
            try:
                eng.add_endpoint(["k8s:app=web"], ips=("192.168.0.10",))
                eng.apply_policy([{
                    "endpointSelector": {"matchLabels": {"app": "web"}},
                    "egress": [{"toCIDR": ["10.0.0.0/8"]}]}])
                eng.regenerate()
                hl = eng.datapath.hbm_ledger()
                assert hl["places_total"] == 1
                for g in ("verdict", "tries", "policy", "ct"):
                    assert hl["groups"][g] > 0, g
                assert hl["device_bytes"] == sum(
                    v for k, v in hl["groups"].items() if k != "wire_pool")
                eng.apply_policy([{
                    "endpointSelector": {"matchLabels": {"app": "web"}},
                    "egress": [{"toCIDR": ["172.16.0.0/12"]}]}])
                eng.regenerate()
                hl2 = eng.datapath.hbm_ledger()
                assert hl2["places_total"] + hl2["patches_total"] >= 2
                row = eng.resource_step(now=1.0)["resources"]["hbm"]
                assert row["capacity"] == float(1 << 28)
                assert row["occupancy"] == hl2["device_bytes"]
                return hl, hl2, row
            finally:
                eng.stop()
        both(case)


# --------------------------------------------------------------------------- #
# slow: the cfg6-form pressure soak
# --------------------------------------------------------------------------- #
@pytest.mark.slow
class TestPressureSoak:
    def test_storm_ct_row_bit_identical_and_eta_before_shed_new(self):
        """A SYN flood saturates a tiny CT through each package's live
        pipelined engine (auditor at 1.0): every tick the ledger's ct_table
        row equals the ``ct_occupancy`` gauge, and the forecast fires
        before the ladder reaches SHED-NEW."""
        def case(m):
            rng = np.random.default_rng(7)
            cap = 1 << 10
            cfg = config(
                m, ct_capacity=cap, batch_size=256, pipeline_flush_ms=0.5,
                pipeline_queue_batches=8, pipeline_block_timeout_s=0.05,
                audit_enabled=True, audit_sample_rate=1.0,
                audit_pool_batches=64, flowlog_mode="none",
                ct_gc_chunk_rows=1 << 8, ct_pressure_high=0.8,
                ct_pressure_low=0.5, overload_up_ticks=1,
                overload_down_ticks=4, overload_shed_rate_high=15.0,
                overload_shed_rate_low=2.0, resource_eta_warn_s=1000.0)
            eng = m.engine.Engine(cfg, datapath=real_datapath(m, cfg))
            eng.auditor.configure(sample_rate=1.0)
            eng.add_endpoint(["k8s:app=web"], ips=("192.168.0.10",),
                             ep_id=1)
            eng.apply_policy([{
                "endpointSelector": {"matchLabels": {"app": "web"}},
                "ingress": [{"fromCIDR": ["10.0.0.0/8"],
                             "toPorts": [{"ports": [
                                 {"port": "80", "protocol": "TCP"}]}]}]}])
            eng.regenerate()

            def flood_batch(n=256):
                b = empty_batch(n)
                b["valid"][:] = True
                b["src"][:, 3] = (0x0A000000 + rng.integers(1, 1 << 24, n)
                                  ).astype(np.uint32)
                b["dst"][:, 3] = 0xC0A8000A
                b["dst"][:, 2] = 0xFFFF
                b["src"][:, 2] = 0xFFFF
                b["sport"][:] = rng.integers(1024, 65535, n)
                b["dport"][:] = 80
                b["proto"][:] = C.PROTO_TCP
                b["tcp_flags"][:] = 0x02
                b["direction"][:] = C.DIR_INGRESS
                b["_prio"] = np.ones((n,), np.int8)
                return b

            L = 50_000
            forecast_tick = shed_new_tick = None
            mismatches = []
            try:
                for tick in range(60):
                    L += 1
                    for _ in range(6):
                        try:
                            eng.submit(flood_batch(), now=L, deadline_ms=200)
                        except Exception:   # noqa: BLE001
                            pass
                    eng.drain(timeout=60)
                    st = eng.overload_step()
                    eng.sweep_step(now=L)
                    eng.audit_step(budget=32)
                    rep = eng.resource_step(now=float(L))
                    row = rep["resources"]["ct_table"]
                    gauge = float(eng.metrics.gauges.get("ct_occupancy",
                                                         0.0))
                    if row["pressure"] != gauge:
                        mismatches.append((tick, row["pressure"], gauge))
                    if forecast_tick is None and row["forecast"]:
                        forecast_tick = tick
                    if shed_new_tick is None \
                            and st["level"] >= m.guard.OVERLOAD_SHED_NEW:
                        shed_new_tick = tick
                    if shed_new_tick is not None \
                            and forecast_tick is not None:
                        break
                assert not mismatches, mismatches[:4]
                assert forecast_tick is not None
                if shed_new_tick is not None:
                    assert forecast_tick < shed_new_tick
                assert eng.auditor.stats()["mismatched_rows"] == 0
                return not mismatches, forecast_tick is not None
            finally:
                eng.stop()
        both(case)

    def test_8shard_audited_soak_scrape_race_with_restart(self):
        """The 8-shard audited soak with concurrent scrapes and a
        hang-forced watchdog restart, on the JAX mesh of 8 virtual CPU
        devices and on the port's 8-shard CPU mesh: the resource families
        stay scrapeable, serving resumes after the restart, the audit finds
        no mismatch, and both register the same resources."""
        def case(m):
            cfg = config(m, n_shards=8, batch_size=512, ct_capacity=1 << 12,
                         pipeline_flush_ms=0.5, audit_enabled=True,
                         audit_sample_rate=1.0, pipeline_stall_timeout_s=1.0,
                         pipeline_max_restarts=3,
                         pipeline_restart_backoff_s=0.05)
            eng = m.engine.Engine(cfg, datapath=real_datapath(m, cfg))
            eng.auditor.configure(sample_rate=1.0)
            eng.add_endpoint(["k8s:app=web"], ips=("192.168.0.10",),
                             ep_id=1)
            eng.apply_policy([{
                "endpointSelector": {"matchLabels": {"app": "web"}},
                "egress": [{"toCIDR": ["10.0.0.0/8"],
                            "toPorts": [{"ports": [
                                {"port": "443", "protocol": "TCP"}]}]}]}])
            eng.regenerate()
            errors = []
            stop = threading.Event()

            def scraper():
                try:
                    while not stop.is_set():
                        for ln in eng.render_metrics().splitlines():
                            if ln.startswith("ciliumtpu_resource_"):
                                float(ln.rsplit(" ", 1)[1])
                except Exception as e:   # noqa: BLE001
                    errors.append(e)
            threads = [threading.Thread(target=scraper) for _ in range(2)]
            for t in threads:
                t.start()

            def batch(i):
                recs = [pkt("192.168.0.10", f"10.0.{(i + j) % 250}.1",
                            40000 + j, 443, ep_id=1) for j in range(64)]
                return batch_from_records(recs,
                                          eng.active.snapshot.ep_slot_of)
            faults = m.faults.FAULTS
            try:
                faults.reset()
                for i in range(20):
                    eng.submit(batch(i), now=1000 + i)
                assert eng.drain(timeout=120)
                eng.resource_step(now=1.0)
                faults.load_spec("datapath.transfer=hang:4:1")
                try:
                    eng.submit(batch(99), now=2000)
                except Exception:   # noqa: BLE001
                    pass
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    ps = eng.pipeline_stats()
                    if ps and ps["restarts"] >= 1 and ps["state"] == "ok":
                        break
                    time.sleep(0.1)
                faults.reset()
                assert eng.pipeline_stats()["restarts"] >= 1
                for i in range(10):
                    eng.submit(batch(200 + i), now=3000 + i)
                assert eng.drain(timeout=120)
                for _ in range(50):
                    step = eng.audit_step(budget=128)
                    if not step or (not step.get("replayed")
                                    and not step.get("pending")):
                        break
                rep = eng.resource_step(now=10.0)
                assert "staging_segment_peak" in rep["resources"]
                assert len(rep["resources"]) >= 12
                assert eng.auditor.stats()["mismatched_rows"] == 0
                return sorted(local_rows(rep))
            finally:
                stop.set()
                for t in threads:
                    t.join(5)
                faults.reset()
                eng.stop()
                assert not errors
        both(case)
