"""The port's span tracer read through ``Tracer.export()``: stamps on the
host's epoch clock, span ids and parents, the engine's finalize folds as
``engine.fold.*`` spans, nothing recorded at rate 0, and the drop count of
a ring too small for its spans.

Port only: the reference's tracer has no ``export()``, no span ids and no
fold spans, so these cases hold the port to what it states, not to the
JAX package (no ``both``). Every case leaves the process-wide ``TRACER``
disarmed and empty, as ``tests/test_torch_observe.py``'s ``_quiet_tracer``
does: a tracer left armed makes other files' allocation counts wrong.
"""

import threading
import time

import numpy as np
import pytest

from cilium_tpu_torch.utils.ip import parse_addr
from cilium_tpu_torch.kernels.records import batch_from_records
from cilium_tpu_torch.observe.trace import TRACER, Tracer
from cilium_tpu_torch.oracle.datapath import PacketRecord
from cilium_tpu_torch.runtime.config import DaemonConfig
from cilium_tpu_torch.runtime.datapath import TorchDatapath
from cilium_tpu_torch.runtime.engine import Engine
from cilium_tpu_torch.utils import constants as C

#: the engine's finalize folds, in the order they run
FOLDS = ("engine.fold.metrics", "engine.fold.flowlog",
         "engine.fold.flowmetrics", "engine.fold.blackbox",
         "engine.fold.audit_capture", "engine.fold.rule_hits",
         "engine.fold.salvage")

POLICY = [{
    "endpointSelector": {"matchLabels": {"app": "web"}},
    "egress": [{"toCIDR": ["10.0.0.0/8"],
                "toPorts": [{"ports": [{"port": "443",
                                        "protocol": "TCP"}]}]}],
}]


@pytest.fixture(autouse=True)
def _quiet_tracer():
    yield
    TRACER.configure(sample_rate=0.0)
    TRACER.reset()


def web_engine(**kw):
    """A CPU engine on the port's ``TorchDatapath``: web may reach 10/8 on
    TCP 443."""
    cfg = DaemonConfig(device="cpu", ct_capacity=2048, auto_regen=False,
                       batch_size=64, **kw)
    eng = Engine(cfg, datapath=TorchDatapath(cfg))
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
    eng.apply_policy(POLICY)
    return eng


def web_batch(eng, i):
    """Four fresh egress SYNs, half of them to a denied port."""
    src, _ = parse_addr("192.168.1.10")
    dst, _ = parse_addr("10.1.2.3")
    recs = [PacketRecord(src, dst, 30000 + 8 * i + k, (443, 80)[k % 2],
                         C.PROTO_TCP, C.TCP_SYN, False, 1, C.DIR_EGRESS,
                         C.HTTP_METHOD_ANY, b"") for k in range(4)]
    return batch_from_records(recs, eng.active.snapshot.ep_slot_of)


def by_id(spans):
    return {s["span_id"]: s for s in spans}


def children(spans, parent):
    return [s for s in spans if s["parent_id"] == parent["span_id"]]


def test_export_stamps_fall_between_epoch_reads_around_the_span():
    t = Tracer(sample_rate=1.0)
    tid = t.maybe_sample()
    before = time.time_ns()
    time.sleep(0.002)
    with t.span(tid, "outer"):
        time.sleep(0.005)
    time.sleep(0.002)
    after = time.time_ns()
    (sp,) = t.export()
    assert before <= sp["start_ns"] <= sp["end_ns"] <= after
    assert sp["end_ns"] - sp["start_ns"] >= 5_000_000
    (old,) = t.spans()
    assert abs((sp["end_ns"] - sp["start_ns"]) / 1e6
               - old["duration_ms"]) < 1e-3
    assert isinstance(sp["start_ns"], int) and isinstance(sp["end_ns"], int)


def test_nested_spans_name_their_parent_and_thread():
    t = Tracer(sample_rate=1.0)
    tid = t.maybe_sample()
    seen = {}

    def other():
        # another thread's span has no parent on this thread
        with t.span(tid, "elsewhere"):
            seen["thread"] = threading.get_ident()

    with t.context(tid), t.span(tid, "outer"):
        with t.span(tid, "inner"):
            th = threading.Thread(target=other)
            th.start()
            th.join(timeout=10)
        t.record(tid, "recorded", time.monotonic(), 0.001)
    assert not th.is_alive()
    spans = {s["name"]: s for s in t.export()}
    outer, inner = spans["outer"], spans["inner"]
    assert outer["parent_id"] is None
    assert inner["parent_id"] == outer["span_id"]
    assert outer["thread"] == inner["thread"] == threading.get_ident()
    assert spans["elsewhere"]["parent_id"] is None
    assert spans["elsewhere"]["thread"] == seen["thread"]
    rec = spans["recorded"]
    assert rec["parent_id"] is None and rec["thread"] is None
    assert len({s["span_id"] for s in spans.values()}) == 4
    assert {s["trace_id"] for s in spans.values()} == {tid}
    # the existing read sides keep their format
    assert [s["name"] for s in t.spans()] \
        == [s["name"] for s in t.export()] \
        == ["elsewhere", "inner", "recorded", "outer"]
    assert set(t.spans()[0]) == {"trace_id", "name", "start_mono",
                                 "duration_ms"}


def test_datapath_spans_are_children_of_the_pipeline_stages():
    eng = web_engine(trace_sample_rate=1.0)
    try:
        eng.submit(web_batch(eng, 0), now=100).result(timeout=60)
        assert eng.drain(timeout=60)
        spans = TRACER.export()
        ids = by_id(spans)
        for name, parent in (("datapath.pack", "pipeline.dispatch"),
                             ("datapath.transfer", "pipeline.dispatch"),
                             ("datapath.compute", "pipeline.finalize")):
            got = [s for s in spans if s["name"] == name]
            assert got, name
            for s in got:
                assert ids[s["parent_id"]]["name"] == parent, name
                assert s["thread"] == ids[s["parent_id"]]["thread"]
        (adm,) = [s for s in spans if s["name"] == "pipeline.admission"]
        assert adm["parent_id"] is None and adm["thread"] is None
    finally:
        eng.stop()


def test_each_submitted_batch_yields_the_seven_folds_under_finalize():
    eng = web_engine(trace_sample_rate=1.0, audit_enabled=True,
                     audit_sample_rate=1.0)
    try:
        for i in range(5):
            eng.submit(web_batch(eng, i), now=100 + i).result(timeout=60)
        assert eng.drain(timeout=60)
        spans = TRACER.export()
        finals = [s for s in spans if s["name"] == "pipeline.finalize"]
        assert len(finals) == 5
        for fin in finals:
            folds = [s["name"] for s in children(spans, fin)
                     if s["name"].startswith("engine.fold.")]
            assert folds == list(FOLDS)
        assert sum(s["name"].startswith("engine.fold.")
                   for s in spans) == 5 * len(FOLDS)
        for s in spans:
            if s["name"].startswith("engine.fold."):
                fin = by_id(spans)[s["parent_id"]]
                assert fin["start_ns"] <= s["start_ns"] \
                    <= s["end_ns"] <= fin["end_ns"]
    finally:
        eng.stop()


def test_classify_folds_are_children_of_engine_classify():
    """The synchronous path folds all but the CT-salvage note, which only
    the pipelined finalize applies."""
    eng = web_engine(trace_sample_rate=1.0)
    try:
        for i in range(3):
            eng.classify(web_batch(eng, i), now=100 + i)
        spans = TRACER.export()
        calls = [s for s in spans if s["name"] == "engine.classify"]
        assert len(calls) == 3
        for call in calls:
            assert [s["name"] for s in children(spans, call)
                    if s["name"].startswith("engine.fold.")] \
                == list(FOLDS[:-1])
    finally:
        eng.stop()


def test_rate_zero_records_no_span_and_allocates_none():
    eng = web_engine()
    try:
        assert not TRACER.enabled
        eng.classify(web_batch(eng, 0), now=100)
        eng.submit(web_batch(eng, 1), now=101).result(timeout=60)
        assert eng.drain(timeout=60)
        assert TRACER.export() == []
        assert TRACER.stats()["spans_in_ring"] == 0
        assert TRACER.span(None, "engine.fold.metrics") \
            is TRACER.span(None, "engine.fold.salvage")
    finally:
        eng.stop()


def test_a_small_ring_counts_what_it_dropped():
    t = Tracer(sample_rate=1.0, capacity=4)
    tid = t.maybe_sample()
    for i in range(10):
        with t.span(tid, f"s{i}"):
            pass
    st = t.stats()
    assert st["spans_dropped_total"] == 6 and st["ring_wraps"] == 1
    out = t.export()
    assert [s["name"] for s in out] == ["s6", "s7", "s8", "s9"]
    assert [s["span_id"] for s in out] == [7, 8, 9, 10]
    starts = np.asarray([s["start_ns"] for s in out])
    assert (np.diff(starts) >= 0).all()


def test_reset_restarts_span_ids_and_empties_the_export():
    t = Tracer(sample_rate=1.0, capacity=8)
    tid = t.maybe_sample()
    with t.span(tid, "a"):
        pass
    t.reset()
    assert t.export() == []
    with t.span(t.maybe_sample(), "b"):
        pass
    (sp,) = t.export()
    assert sp["span_id"] == 1 and sp["trace_id"] == 1
