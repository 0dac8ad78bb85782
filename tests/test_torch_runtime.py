"""The port's runtime against the JAX package's, case for case with
``tests/test_runtime.py``: the engine end to end against each package's
oracle, the policy update's revision fence, the CT sweep, the flow log and
metrics, services through the engine (LB, rev-NAT across service churn and
a restart), the health probe, the checkpoint, the config's layering, the
controllers, the flow log's sink cap, rotation and live follow, the
metrics histogram and the regeneration failure's visibility.

Each case runs the reference's body once on each package (the engine on
each package's default datapath: ``JITDatapath`` on the CPU, the port's
``TorchDatapath`` with ``device="cpu"``), asserts the reference's
expectations on both, and holds a side-neutral observation equal: every
out column the case reads, CT statistics, counters, flow-log records and
Prometheus lines. ``test_end_to_end_matches_oracle`` holds each engine
against its own package's oracle, and the two oracles' verdicts equal.

Not mirrored: ``TestDebugChecksHarness`` (1 case) runs the JAX datapath
under ``jax_debug_nans``, a JAX debugging mode the port has no
counterpart of.
"""

import importlib
import json
import logging
import time

import numpy as np
import pytest

from tests.test_torch_datapath import PKG, SIDES
from tests.test_torch_pipeline import host

POLICY = [{
    "endpointSelector": {"matchLabels": {"app": "web"}},
    "egress": [{"toCIDR": ["10.0.0.0/8"],
                "toPorts": [{"ports": [{"port": "443",
                                        "protocol": "TCP"}]}]}],
}]
#: the engine's logger on each package
ENGINE_LOGGER = {"jax": "cilium_tpu.engine",
                 "torch": "cilium_tpu_torch.engine"}
SVC_COLS = ("allow", "reason", "status", "svc", "nat_dst", "nat_dport",
            "rnat", "rnat_src", "rnat_sport")


def P(side):
    """``side``'s modules: ``host``'s and the runtime's own."""
    m = host(side)
    pkg = PKG[side]
    for k, v in {"checkpoint": "runtime.checkpoint",
                 "controller": "runtime.controller",
                 "flowlog": "runtime.flowlog",
                 "services": "model.services"}.items():
        setattr(m, k, importlib.import_module(f"{pkg}.{v}"))
    return m


def both(case):
    """Run ``case(m)`` on each package's modules. → the port's
    observation, held equal to the reference's."""
    obs = {s: case(P(s)) for s in SIDES}
    assert obs["jax"] == obs["torch"]
    return obs["torch"]


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    for s in SIDES:
        host(s).faults.FAULTS.reset()


def small_engine(m, **kw):
    """``test_runtime.py``'s ``small_engine``: the engine on its package's
    default datapath."""
    kw.setdefault("ct_capacity", 4096)
    kw.setdefault("auto_regen", False)
    kw.setdefault("flowlog_mode", "all")
    if m.side == "torch":
        kw.setdefault("device", "cpu")
    return m.engine.Engine(m.config.DaemonConfig(**kw))


def pkt(m, src, dst, sp, dp, proto=None, flags=None, ep_id=1,
        direction=None, method=None, path=b""):
    C = m.C
    s16, sv6 = m.ip.parse_addr(src)
    d16, dv6 = m.ip.parse_addr(dst)
    return m.oracle.PacketRecord(
        s16, d16, sp, dp, C.PROTO_TCP if proto is None else proto,
        C.TCP_SYN if flags is None else flags, sv6 or dv6, ep_id,
        C.DIR_EGRESS if direction is None else direction,
        C.HTTP_METHOD_ANY if method is None else method, path)


def classify(m, eng, recs, now):
    return eng.classify(m.records.batch_from_records(
        recs, eng.active.snapshot.ep_slot_of), now=now)


def cols(out, keys=("allow", "reason", "status")):
    return {k: np.asarray(out[k]).tolist() for k in keys}


def web_engine(m, **kw):
    eng = small_engine(m, **kw)
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
    eng.apply_policy(POLICY)
    return eng


class TestEngine:
    def test_end_to_end_matches_oracle(self):
        @both
        def _(m):
            C = m.C
            eng = web_engine(m)
            active = eng.active
            oracle = m.oracle.Oracle(dict(zip(active.snapshot.ep_ids,
                                              active.snapshot.policies)),
                                     eng.ctx.ipcache.snapshot())
            packets = [
                pkt(m, "192.168.1.10", "10.1.2.3", 40000, 443),
                pkt(m, "192.168.1.10", "10.1.2.3", 40000, 443,
                    flags=C.TCP_ACK),
                pkt(m, "192.168.1.10", "10.1.2.3", 40001, 80),
                pkt(m, "192.168.1.10", "8.8.8.8", 40002, 443),
            ]
            want = oracle.classify_batch_snapshot(packets, 100)
            out = classify(m, eng, packets, 100)
            for i, v in enumerate(want):
                assert bool(out["allow"][i]) == v.allow
                assert int(out["reason"][i]) == int(v.drop_reason)
            assert eng.ct_stats(now=100)["live"] == 1
            assert eng.metrics.packets_total == 4
            return ([(bool(v.allow), int(v.drop_reason)) for v in want],
                    cols(out, ("allow", "reason", "status",
                               "remote_identity")),
                    eng.ct_stats(now=100)["live"],
                    int(eng.metrics.packets_total))

    def test_policy_update_revision_fence(self):
        @both
        def _(m):
            C = m.C
            eng = web_engine(m)
            snap0 = eng.active
            out0 = classify(m, eng, [pkt(m, "192.168.1.10", "10.1.2.3",
                                         40000, 443)], 100)
            assert bool(out0["allow"][0])
            rev0 = snap0.revision
            eng.repo.clear()
            eng.apply_policy([{
                "endpointSelector": {"matchLabels": {"app": "web"}},
                "egress": [{"toCIDR": ["10.0.0.0/8"],
                            "toPorts": [{"ports": [
                                {"port": "80", "protocol": "TCP"}]}]}],
            }])
            rev1 = eng.active.revision
            assert rev1 > rev0
            out1 = classify(m, eng, [pkt(m, "192.168.1.10", "10.1.2.3",
                                         40000, 443, flags=C.TCP_ACK)], 101)
            assert bool(out1["allow"][0])
            assert int(out1["status"][0]) == C.CTStatus.ESTABLISHED
            out2 = classify(m, eng, [
                pkt(m, "192.168.1.10", "10.1.2.3", 41000, 443),
                pkt(m, "192.168.1.10", "10.1.2.3", 41001, 80)], 102)
            assert not bool(out2["allow"][0]) and bool(out2["allow"][1])
            return [cols(o) for o in (out0, out1, out2)], rev1 - rev0

    def test_sweep_controller(self):
        @both
        def _(m):
            eng = web_engine(m)
            classify(m, eng, [pkt(m, "192.168.1.10", "10.1.2.3", 40000,
                                  443)], 100)
            swept = eng.sweep(now=100 + m.C.CT_LIFETIME_SYN + 1)
            assert swept == 1
            live = eng.ct_stats(now=200)["live"]
            assert live == 0
            return swept, live

    def test_flowlog_and_metrics(self):
        @both
        def _(m):
            eng = web_engine(m)
            classify(m, eng, [
                pkt(m, "192.168.1.10", "10.1.2.3", 40000, 443),
                pkt(m, "192.168.1.10", "10.1.2.3", 40001, 22)], 100)
            logs = eng.flowlog.tail()
            assert len(logs) == 2
            drop = [r for r in logs if r["verdict"] == "DROPPED"][0]
            assert drop["dst_port"] == 22
            assert drop["drop_reason_desc"] == "POLICY"
            text = eng.metrics.render_prometheus()
            assert 'reason="OK",direction="egress"} 1' in text
            assert 'reason="POLICY"' in text
            return logs, [ln for ln in text.splitlines()
                          if "packets" in ln or "drop" in ln]

    def test_unenforced_endpoint_allows(self):
        @both
        def _(m):
            eng = small_engine(m)
            eng.add_endpoint(["k8s:app=lonely"], ips=("192.168.1.99",),
                             ep_id=5)
            out = classify(m, eng, [pkt(m, "192.168.1.99", "8.8.8.8", 40000,
                                        443, ep_id=5)], 100)
            assert bool(out["allow"][0])
            return cols(out)


class TestEngineServices:
    def test_service_lb_through_engine(self):
        @both
        def _(m):
            C, S = m.C, m.services
            eng = web_engine(m)
            eng.upsert_service(S.Service(
                name="api", namespace="prod",
                frontends=(S.Frontend("172.30.0.1", 443, C.PROTO_TCP),),
                lb_backends=(S.Backend("10.7.0.1", 443),
                             S.Backend("10.7.0.2", 443)),
            ))
            assert eng.active.snapshot.lb.n_frontends == 1
            out = classify(m, eng, [pkt(m, "192.168.1.10", "172.30.0.1",
                                        40000, 443)], 100)
            assert bool(out["allow"][0]) and bool(out["svc"][0])
            assert int(out["nat_dport"][0]) == 443
            eng.delete_service("prod", "api")
            out2 = classify(m, eng, [pkt(m, "192.168.1.10", "172.30.0.1",
                                         40001, 443)], 101)
            assert not bool(out2["svc"][0])
            return cols(out, SVC_COLS), cols(out2, SVC_COLS)

    def test_rnat_stable_across_service_churn(self):
        @both
        def _(m):
            C, S = m.C, m.services
            eng = web_engine(m)
            eng.upsert_service(S.Service(
                name="api", namespace="zzz",
                frontends=(S.Frontend("172.30.0.1", 443, C.PROTO_TCP),),
                lb_backends=(S.Backend("10.7.0.1", 443),)))
            out = classify(m, eng, [pkt(m, "192.168.1.10", "172.30.0.1",
                                        40000, 443)], 100)
            assert bool(out["svc"][0])
            eng.upsert_service(S.Service(
                name="aaa", namespace="aaa",
                frontends=(S.Frontend("172.31.0.9", 443, C.PROTO_TCP),),
                lb_backends=(S.Backend("10.8.0.1", 443),)))
            reply = pkt(m, "10.7.0.1", "192.168.1.10", 443, 40000,
                        flags=C.TCP_SYN | C.TCP_ACK, direction=C.DIR_INGRESS)
            out2 = classify(m, eng, [reply], 105)
            assert bool(out2["rnat"][0])
            vip16, _ = m.ip.parse_addr("172.30.0.1")
            assert m.ip.words_to_addr(out2["rnat_src"][0]) == vip16
            eng.delete_service("zzz", "api")
            out3 = classify(m, eng, [reply], 110)
            assert int(out3["status"][0]) == C.CTStatus.REPLY
            assert not bool(out3["rnat"][0])
            return [cols(o, SVC_COLS) for o in (out, out2, out3)]

    def test_service_flow_survives_restart(self, tmp_path):
        @both
        def _(m):
            C, S = m.C, m.services
            eng = web_engine(m)
            eng.upsert_service(S.Service(
                name="api", namespace="prod",
                frontends=(S.Frontend("172.30.0.1", 443, C.PROTO_TCP),),
                lb_backends=(S.Backend("10.7.0.1", 443),),
            ))
            out = classify(m, eng, [pkt(m, "192.168.1.10", "172.30.0.1",
                                        40000, 443)], 100)
            assert bool(out["svc"][0])
            path = str(tmp_path / f"{m.side}-ckpt")
            m.checkpoint.save(eng, path)
            eng2 = small_engine(m)
            m.checkpoint.restore(eng2, path)
            reply = pkt(m, "10.7.0.1", "192.168.1.10", 443, 40000,
                        flags=C.TCP_SYN | C.TCP_ACK, direction=C.DIR_INGRESS)
            out2 = classify(m, eng2, [reply], 105)
            assert int(out2["status"][0]) == C.CTStatus.REPLY
            assert bool(out2["rnat"][0])
            vip16, _ = m.ip.parse_addr("172.30.0.1")
            assert m.ip.words_to_addr(out2["rnat_src"][0]) == vip16
            assert int(out2["rnat_sport"][0]) == 443
            return cols(out, SVC_COLS), cols(out2, SVC_COLS)


class TestHealth:
    def test_health_probe(self):
        @both
        def _(m):
            eng = small_engine(m)
            eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",),
                             ep_id=1)
            eng.add_endpoint(["k8s:app=db"], ips=("192.168.1.20",), ep_id=2)
            eng.apply_policy(POLICY + [{
                "endpointSelector": {"matchLabels": {"app": "db"}},
                "ingress": [{"fromEndpoints": [{"matchLabels":
                                                {"app": "web"}}]}],
            }])
            rep = eng.health_probe(now=100)
            assert rep[1]["reachable"] is True
            assert rep[2]["reachable"] is False
            assert rep[2]["reason"] == "POLICY"
            eng.apply_policy([{
                "endpointSelector": {"matchLabels": {"app": "db"}},
                "ingress": [{"fromEntities": ["health"]}],
            }])
            rep2 = eng.health_probe(now=200)
            assert rep2[2]["reachable"] is True
            gauge = eng.metrics.gauges["health_reachable_endpoints"]
            assert gauge == 2
            return rep, rep2, gauge


class TestCheckpoint:
    def test_flows_survive_restart(self, tmp_path):
        @both
        def _(m):
            C = m.C
            eng = web_engine(m)
            classify(m, eng, [pkt(m, "192.168.1.10", "10.1.2.3", 40000,
                                  443)], 100)
            cidr_id = eng.ctx.ipcache.lookup("10.1.2.3")
            path = str(tmp_path / f"{m.side}-ckpt")
            m.checkpoint.save(eng, path)
            eng2 = small_engine(m)
            m.checkpoint.restore(eng2, path)
            assert eng2.ctx.ipcache.lookup("10.1.2.3") == cidr_id
            out = classify(m, eng2, [pkt(m, "192.168.1.10", "10.1.2.3",
                                         40000, 443, flags=C.TCP_ACK)], 105)
            assert bool(out["allow"][0])
            assert int(out["status"][0]) == C.CTStatus.ESTABLISHED
            return cidr_id, cols(out)

    def test_restore_requires_fresh_engine(self, tmp_path):
        @both
        def _(m):
            eng = small_engine(m)
            eng.add_endpoint(["k8s:app=web"], ep_id=1)
            path = str(tmp_path / f"{m.side}-c")
            m.checkpoint.save(eng, path)
            eng2 = small_engine(m)
            eng2.add_endpoint(["k8s:app=other"], ep_id=9)
            with pytest.raises(ValueError) as e:
                m.checkpoint.restore(eng2, path)
            return str(e.value)


class TestConfig:
    def test_env_overrides_file(self, tmp_path):
        @both
        def _(m):
            cfg_file = tmp_path / f"{m.side}-cfg.json"
            cfg_file.write_text(json.dumps({"ct_capacity": 4096,
                                            "enforcement_mode": "default"}))
            cfg = m.config.DaemonConfig.load(
                config_file=str(cfg_file),
                env={"CILIUM_TPU_ENFORCEMENT_MODE": "always"},
                argv=["--batch-size", "128"])
            assert cfg.ct_capacity == 4096
            assert cfg.enforcement_mode == "always"
            assert cfg.batch_size == 128
            return cfg.ct_capacity, cfg.enforcement_mode, cfg.batch_size

    def test_rejects_unknown_keys(self, tmp_path):
        @both
        def _(m):
            cfg_file = tmp_path / f"{m.side}-cfg.json"
            cfg_file.write_text(json.dumps({"bogus": 1}))
            with pytest.raises(ValueError) as e:
                m.config.DaemonConfig.load(config_file=str(cfg_file), env={})
            return str(e.value)

    def test_validation(self):
        @both
        def _(m):
            refused = []
            for kw in ({"ct_capacity": 1000},
                       {"enforcement_mode": "sometimes"}):
                with pytest.raises(ValueError) as e:
                    m.config.DaemonConfig(**kw)
                refused.append(str(e.value))
            return refused


class TestControllers:
    def test_retry_with_backoff_counts(self):
        @both
        def _(m):
            calls = []

            def flaky():
                calls.append(1)
                if len(calls) < 3:
                    raise RuntimeError("boom")

            ctrl = m.controller.Controller("test", flaky, interval=0.01,
                                           backoff_base=0.001)
            for _ in range(3):
                ctrl.run_once()
            st = ctrl.status
            assert st.failure_count == 2
            assert st.success_count == 1
            assert st.consecutive_failures == 0
            return (st.failure_count, st.success_count,
                    st.consecutive_failures, len(calls))

    def test_trigger_debounce(self):
        @both
        def _(m):
            fired = []
            trig = m.controller.Trigger(lambda: fired.append(1),
                                        min_interval=0.05)
            for _ in range(10):
                trig()
            time.sleep(0.15)
            assert len(fired) == 1
            assert trig.folds == 9
            return len(fired), trig.folds


def sink_batch_out(n):
    """``TestFlowLogSinkCap._mk_batch_out``: ``n`` forwarded TCP rows whose
    sports are 0..n-1."""
    batch = {
        "src": np.zeros((n, 4), np.uint32),
        "dst": np.zeros((n, 4), np.uint32),
        "sport": np.arange(n, dtype=np.uint32),
        "dport": np.zeros(n, np.uint32),
        "proto": np.full(n, 6, np.uint32),
        "direction": np.zeros(n, np.uint32),
        "ep_slot": np.zeros(n, np.uint32), "valid": np.ones(n, bool),
    }
    out = {
        "allow": np.ones(n, bool), "reason": np.zeros(n, np.uint32),
        "status": np.zeros(n, np.uint32),
        "remote_identity": np.zeros(n, np.uint32),
    }
    return batch, out


class TestFlowLogSinkCap:
    def test_sink_buf_bounded_drop_oldest(self, tmp_path, monkeypatch):
        @both
        def _(m):
            fl = m.flowlog
            monkeypatch.setattr(fl, "SINK_BUF_MAX", 10)
            log = fl.FlowLog(capacity=4, mode="all",
                             sink_path=str(tmp_path / f"{m.side}.jsonl"))
            batch, out = sink_batch_out(3)
            batch["sport"][:] = 0
            for t in range(8):
                log.append_batch(batch, out, now=t, ep_ids=(1,))
            assert len(log._sink_buf) <= 10
            assert log.sink_dropped == 8 * 3 - 10
            buffered = len(log._sink_buf)
            assert log.flush_sink() == 10
            assert log._sink_buf == []
            return buffered, log.sink_dropped, log.tail()

    def test_sink_rotation_at_rotate_bytes(self, tmp_path, monkeypatch):
        @both
        def _(m):
            fl = m.flowlog
            monkeypatch.setattr(fl, "SINK_ROTATE_BYTES", 256)
            path = tmp_path / f"{m.side}.jsonl"
            log = fl.FlowLog(capacity=8, mode="all", sink_path=str(path))
            batch, out = sink_batch_out(3)
            log.append_batch(batch, out, now=1, ep_ids=(1,))
            log.flush_sink()
            assert path.stat().st_size > 256
            first_gen = path.read_text()
            log.append_batch(batch, out, now=2, ep_ids=(1,))
            log.flush_sink()
            rotated = tmp_path / f"{m.side}.jsonl.1"
            assert rotated.exists() and rotated.read_text() == first_gen
            fresh = [json.loads(line) for line in
                     path.read_text().strip().splitlines()]
            assert len(fresh) == 3 and all(r["time"] == 2 for r in fresh)
            return first_gen, fresh

    def test_extract_capped_keeps_newest(self, monkeypatch):
        @both
        def _(m):
            fl = m.flowlog
            monkeypatch.setattr(fl, "APPEND_BATCH_MAX", 5)
            log = fl.FlowLog(capacity=16, mode="all")
            batch, out = sink_batch_out(12)
            log.append_batch(batch, out, now=1, ep_ids=(1,))
            assert log.extract_shed == 12 - 5
            assert log.total_seen == 12
            tail = log.tail()
            assert [r["src_port"] for r in tail] == list(range(7, 12))
            return log.extract_shed, log.total_seen, tail


def fill(log, n, start_port=0):
    batch, out = sink_batch_out(n)
    batch["sport"] = np.arange(start_port, start_port + n, dtype=np.uint32)
    log.append_batch(batch, out, now=1, ep_ids=(1,))


class TestFlowLogFollowEdges:
    def test_since_cursor_across_wraparound(self):
        @both
        def _(m):
            log = m.flowlog.FlowLog(capacity=8, mode="all")
            fill(log, 20)
            got = log.since(15)
            assert [r["seq"] for r in got] == [16, 17, 18, 19, 20]
            wrapped = log.since(0)
            assert [r["seq"] for r in wrapped] == list(range(13, 21))
            gap = log.since(5)
            assert gap[0] == {"gap": True, "dropped": 7, "resume_seq": 13}
            assert gap[1]["seq"] == 13
            assert log.follow_gaps == 1 and log.follow_gap_records == 7
            assert log.since(20) == []
            page = log.since(0, limit=3)
            assert [r["seq"] for r in page] == [13, 14, 15]
            return got, wrapped, gap, page, log.follow_gap_records

    def test_since_filters_apply_before_limit_cursor_advances(self):
        @both
        def _(m):
            log = m.flowlog.FlowLog(capacity=16, mode="all")
            fill(log, 10)
            got = log.since(0, src_port=7)
            assert len(got) == 1 and got[0]["src_port"] == 7
            assert log.since(got[0]["seq"], src_port=7) == []
            return got

    def test_tail_filter_typing_int_vs_str(self):
        @both
        def _(m):
            log = m.flowlog.FlowLog(capacity=16, mode="all")
            fill(log, 6)
            res = {"int": log.tail(src_port=3), "str": log.tail(src_port="3"),
                   "verdict": log.tail(verdict="FORWARDED"),
                   "bool": log.tail(verdict=True),
                   "unknown": log.tail(no_such_field=1),
                   "both": log.tail(verdict="FORWARDED", src_port=3)}
            assert len(res["int"]) == 1 and res["str"] == []
            assert len(res["verdict"]) == 6 and res["bool"] == []
            assert res["unknown"] == [] and len(res["both"]) == 1
            return res

    def test_since_typed_filters_across_wrap(self):
        @both
        def _(m):
            log = m.flowlog.FlowLog(capacity=4, mode="all")
            fill(log, 10)
            got = log.since(0, src_port=8)
            assert [r["src_port"] for r in got] == [8]
            assert log.since(0, src_port="8") == []
            return got


class TestMetricsHistogram:
    def test_observe_quantile_and_render(self):
        @both
        def _(m):
            mm = m.metrics
            metrics = mm.Metrics()
            h = metrics.histogram("pipeline_queue_wait_seconds")
            assert metrics.histogram("pipeline_queue_wait_seconds") is h
            for v in (0.0002, 0.0002, 0.003, 0.02, 7.0):
                h.observe(v)
            assert h.count == 5 and h.total == pytest.approx(7.0234)
            q50 = h.quantile(0.5)
            assert 0.0001 <= q50 <= 0.005
            assert h.quantile(0.999) == h.buckets[-1]
            text = metrics.render_prometheus()
            assert ("# TYPE ciliumtpu_pipeline_queue_wait_seconds histogram"
                    in text)
            assert 'pipeline_queue_wait_seconds_bucket{le="+Inf"} 5' in text
            assert "pipeline_queue_wait_seconds_count 5" in text
            assert mm.Histogram().quantile(0.5) == 0.0
            return q50, list(h.buckets), text

    def test_counter_geometry_from_constants(self):
        @both
        def _(m):
            C = m.C
            metrics = m.metrics.Metrics()
            shape = metrics.by_reason_dir.shape
            assert shape == (C.DROP_REASON_BINS * C.N_DIRECTIONS,)
            bad = {"by_reason_dir": np.zeros(512 + 2, np.uint32),
                   "insert_fail": np.uint32(0)}
            with pytest.raises(ValueError, match="geometry") as e:
                metrics.add_batch(bad, n_valid=0)
            return shape, str(e.value)


class TestRegenFailureVisibility:
    def test_regen_failure_logged_and_counted(self, caplog):
        @both
        def _(m):
            eng = web_engine(m, auto_regen=True)
            _ = eng.active
            eng._regen_trigger.cancel()
            caplog.clear()
            try:
                m.faults.FAULTS.arm("regen.compile", mode="fail", times=1)
                with caplog.at_level(logging.WARNING,
                                     logger=ENGINE_LOGGER[m.side]):
                    eng._mark_dirty_and_regen()
            finally:
                m.faults.FAULTS.reset()
            assert eng.metrics.counters.get("regen_failures_total") == 1
            msgs = [r.message for r in caplog.records
                    if "regeneration failed" in r.message]
            assert msgs
            assert "regen_failures_total 1" in eng.metrics.render_prometheus()
            eng.stop()
            return eng.metrics.counters.get("regen_failures_total"), len(msgs)
