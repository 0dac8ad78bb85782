"""``harness/program_trace.py`` on the CPU: idle gaps named by the
program's spans before the benchmark's wrappers, short gaps split by their
covering span, the summary unchanged without an export, the three readings
and their no-value cases, and the tracer armed and set back. The device
events and the program's export are made by hand (a ``ProgramTrace``
built without a profiler)."""

import pytest

from benchmark.harness import program_trace as pt
from benchmark.harness.trace import DeviceTrace

T0 = 1_700_000_000_000_000_000
US = 1_000
WORKER, MAIN = 11, 22


def op(a_us, b_us, name="k"):
    return (name, T0 + a_us * US, T0 + b_us * US)


def span(name, a_us, b_us, thread=WORKER, sid=0, parent=None):
    return {"trace_id": 1, "span_id": sid, "parent_id": parent,
            "name": name, "start_ns": T0 + a_us * US,
            "end_ns": T0 + b_us * US, "thread": thread, "attrs": None}


def wrapper(name, a_us, b_us):
    return (name, T0 + a_us * US, T0 + b_us * US)


def traced(events, program=None, end_us=10_000, cls=pt.ProgramTrace):
    """A trace of ``cls`` over [T0, T0 + end_us] with ``events`` as its
    device operations and ``program`` as the tracer's (spans, drops)."""
    tr = cls.__new__(cls)
    tr.t0_ns, tr.t1_ns = T0, T0 + end_us * US
    tr.start_s = tr.stop_s = 0.0
    tr.events = lambda: list(events)
    if cls is pt.ProgramTrace:
        tr.program, tr.idle = program, None
    return tr


#: device operations leaving one long gap (100–1,000 us), short gaps of
#: 5 us at 2,000 and 3,000 us, and a long one from 3,105 us to the end
EVENTS = [op(0, 100), op(1_000, 2_000), op(2_005, 3_000), op(3_005, 3_105)]

#: one dispatch and one finalize on the worker; the salvage fold and the
#: transfer under them; a GC tick on the main thread
PROGRAM = [
    span("pipeline.dispatch", 1_900, 3_050, sid=1),
    span("datapath.transfer", 2_990, 3_040, sid=2, parent=1),
    span("pipeline.finalize", 50, 1_050, sid=3),
    span("engine.fold.salvage", 200, 900, sid=4, parent=3),
    span("datapath.ct.gc", 4_000, 4_500, thread=MAIN, sid=5),
]


def idle(tr, host_spans=()):
    return dict(tr.summary(list(host_spans))["idle_gaps"])


def test_a_program_span_names_the_gap_before_a_wrapper():
    tr = traced(EVENTS, (PROGRAM, 0))
    got = idle(tr, [wrapper("fold.salvage", 210, 890)])
    assert got["engine.fold.salvage"] == pytest.approx(900e-6)
    assert "fold.salvage" not in got


def test_a_gap_no_program_span_covers_keeps_the_wrappers_name():
    tr = traced(EVENTS, (PROGRAM[:4], 0))
    got = idle(tr, [wrapper("enqueue", 6_000, 7_000)])
    # the last gap, 3,105 us to the end, has its middle in the wrapper
    assert got["enqueue"] == pytest.approx(6_895e-6)
    tr = traced(EVENTS, (PROGRAM[:4], 0))
    assert idle(tr)[pt.NONE] == pytest.approx(6_895e-6)


def test_short_gaps_split_by_their_covering_span():
    tr = traced(EVENTS, (PROGRAM, 0))
    got = idle(tr)
    # 2,000–2,005 under the dispatch alone, 3,000–3,005 in the transfer
    assert got["between launches: pipeline.dispatch"] == pytest.approx(5e-6)
    assert got["between launches: datapath.transfer"] == pytest.approx(5e-6)
    assert pt.BETWEEN not in got
    tr = traced(EVENTS, ([PROGRAM[2], PROGRAM[3]], 0))
    assert idle(tr)[pt.BETWEEN] == pytest.approx(10e-6)


def test_the_worker_is_preferred_and_other_threads_name_the_rest():
    events = [op(0, 10), op(100, 110), op(5_000, 5_010)]
    program = [span("pipeline.dispatch", 0, 20, sid=1),
               span("pipeline.finalize", 20, 200, sid=2),
               span("datapath.ct.gc", 30, 90, thread=MAIN, sid=3),
               span("engine.classify", 1_000, 9_000, thread=MAIN, sid=4)]
    tr = traced(events, (program, 0))
    got = idle(tr)
    # 10–100: the worker's finalize covers it; the GC tick is not asked
    assert got["pipeline.finalize"] == pytest.approx(90e-6)
    assert "datapath.ct.gc" not in got
    # 110–5,000 and 5,010–10,000: only the main thread's span covers them
    assert got["engine.classify"] == pytest.approx((4_890 + 4_990) * 1e-6)


def test_idle_seconds_add_up_to_the_window_less_busy():
    tr = traced(EVENTS, (PROGRAM, 0))
    s = tr.summary([])
    assert sum(tr.idle.values()) == pytest.approx(s["window_s"] - s["busy_s"])
    assert s["program_spans"] == PROGRAM and s["program_spans_dropped"] == 0


def test_without_an_export_the_summary_is_device_traces():
    host = [wrapper("fold.salvage", 210, 890), wrapper("enqueue", 3_200,
                                                       9_000)]
    want = traced(EVENTS, cls=DeviceTrace).summary(list(host))
    assert traced(EVENTS, None).summary(list(host)) == want
    assert "program_spans" not in want


def test_spans_outside_the_traced_part_are_left_out():
    program = PROGRAM + [span("pipeline.admission", -50, 10, thread=None,
                              sid=9),
                         span("pipeline.admission", 10_000, 10_100,
                              thread=None, sid=10)]
    s = traced(EVENTS, (program, 0)).summary([])
    assert [x["span_id"] for x in s["program_spans"]] == [1, 2, 3, 4, 5]


def reading(spans, dropped=0):
    return {"program_spans": spans, "program_spans_dropped": dropped}


def test_the_readers_on_a_hand_made_reading():
    spans = [span("pipeline.admission", 0, 30_000, thread=None, sid=1),
             span("pipeline.admission", 0, 50_000, thread=None, sid=2),
             span("datapath.compute", 100, 300, sid=3),
             span("datapath.compute", 400, 500, sid=4),
             span("engine.fold.metrics", 0, 10, sid=5),
             span("engine.fold.metrics", 20, 30, sid=6),
             span("engine.fold.salvage", 40, 20_040, sid=7),
             span("engine.fold.salvage", 50, 25_050, sid=8)]
    r = reading(spans)
    assert pt.queue_wait_ms(r) == pytest.approx(40.0)
    assert pt.device_wait_ms(r) == pytest.approx(0.15)
    assert pt.salvage_ms(r) == pytest.approx(22.5)


@pytest.mark.parametrize("read", [pt.queue_wait_ms, pt.device_wait_ms,
                                  pt.salvage_ms])
def test_the_readers_read_nothing_when_spans_are_missing_or_dropped(read):
    full = [span(n, 0, 100, sid=i) for i, n in enumerate((
        "pipeline.admission", "datapath.compute", "engine.fold.metrics",
        "engine.fold.salvage"))]
    assert read(reading(full)) is not None
    assert read(reading(full, dropped=1)) is None
    assert read(reading([])) is None
    assert read(None) is None
    assert read({"busy_s": 1.0}) is None       # no export: the parent
    assert read(reading([s for s in full
                         if s["name"] != "engine.fold.metrics"
                         and s["name"] != "datapath.compute"
                         and s["name"] != "pipeline.admission"])) is None


def test_arm_and_collect_the_ports_tracer():
    from cilium_tpu_torch.observe.trace import TRACER
    assert not TRACER.enabled
    armed = pt.arm()
    try:
        assert TRACER.sample_rate == 1.0
        assert TRACER.stats()["capacity"] == pt.CAPACITY
        with TRACER.span(TRACER.maybe_sample(), "pipeline.dispatch"):
            pass
    finally:
        spans, dropped = pt.collect(armed)
    assert [s["name"] for s in spans] == ["pipeline.dispatch"]
    assert dropped == 0
    assert not TRACER.enabled and TRACER.stats()["capacity"] == 4096
    assert TRACER.export() == []


def test_a_tracer_without_export_is_left_alone(monkeypatch):
    from cilium_tpu_torch.observe import trace

    class Old:
        sample_rate = 0.0

    monkeypatch.setattr(trace, "TRACER", Old())
    assert pt.arm() is None
