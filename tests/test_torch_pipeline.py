"""The port's ingestion pipeline against the JAX package's, on the CPU.

- The scheduler unit cases of ``tests/test_pipeline.py`` (buckets and
  flush reasons, deadlines, admission drops, FIFO, fault retries) and the
  breaker sequence of ``tests/test_pipeline_guard.py``, each parametrised
  over both packages' ``Pipeline`` with the same echo dispatch (each row's
  sport echoed through ``reason``) and the same expectations.
- ``Engine.submit`` on ``TorchDatapath`` against ``Engine.submit`` on
  ``JITDatapath`` under a seeded ``pipeline.dispatch`` fault storm: every
  ticket's out columns, the metric counters and the CT arrays equal.
"""

import importlib
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from tests.test_torch_datapath import (PKG, SIDES, assert_engines_equal,
                                       assert_outs_equal, copy, mods,
                                       storm_engine, world_traffic)


def pipe(side):
    """One side's pipeline package, its fault registry and batch layout."""
    pkg = PKG[side]
    return SimpleNamespace(
        pl=importlib.import_module(f"{pkg}.pipeline"),
        faults=importlib.import_module(f"{pkg}.runtime.faults").FAULTS,
        empty_batch=importlib.import_module(
            f"{pkg}.kernels.records").empty_batch)


@pytest.fixture(params=SIDES)
def p(request):
    m = pipe(request.param)
    m.faults.reset()
    yield m
    m.faults.reset()


def sub_batch(p, n_rows, start, n_valid=None):
    """A submission whose rows carry ``sport = start + i``; the first
    ``n_valid`` rows are valid."""
    b = p.empty_batch(n_rows)
    b["sport"][:] = np.arange(start, start + n_rows, dtype=np.int32)
    b["valid"][: n_rows if n_valid is None else n_valid] = True
    return b


class EchoDispatch:
    """Records the valid-row sports of every dispatched batch and echoes
    each row's sport back through ``reason``."""

    def __init__(self):
        self.batches = []
        self.gate = threading.Event()
        self.gate.set()
        self.fail_next = None

    def __call__(self, batch, now):
        self.gate.wait(timeout=10)
        if self.fail_next is not None:
            exc, self.fail_next = self.fail_next, None
            raise exc
        valid = np.asarray(batch["valid"])
        self.batches.append(np.asarray(batch["sport"])[valid].tolist())
        out = {"allow": valid.copy(),
               "reason": np.asarray(batch["sport"], np.int32).copy(),
               "status": np.zeros(valid.shape[0], np.int32),
               "remote_identity": np.zeros(valid.shape[0], np.int32)}
        return lambda: out

    @property
    def sports_seen(self):
        return [s for b in self.batches for s in b]


def test_direct_dispatch_bypass(p):
    d = EchoDispatch()
    pl = p.pl.Pipeline(d, min_bucket=4, max_bucket=16, flush_ms=1000.0)
    try:
        out = pl.submit(sub_batch(p, 4, start=100)).result(timeout=5)
        assert out["reason"].tolist() == [100, 101, 102, 103]
        assert pl.flush_reasons["direct"] == 1
        assert d.batches == [[100, 101, 102, 103]]
    finally:
        pl.close(timeout=5)


def test_coalesce_full_flush_and_slice_mapping(p):
    d = EchoDispatch()
    pl = p.pl.Pipeline(d, min_bucket=4, max_bucket=8, flush_ms=1000.0)
    try:
        t1 = pl.submit(sub_batch(p, 5, start=10, n_valid=3))
        t2 = pl.submit(sub_batch(p, 3, start=20))
        t3 = pl.submit(sub_batch(p, 3, start=30))
        out1, out2 = t1.result(timeout=5), t2.result(timeout=5)
        assert pl.flush_reasons["full"] >= 1
        assert d.batches[0] == [10, 11, 12, 20, 21, 22]
        assert out1["reason"].tolist() == [10, 11, 12, 0, 0]
        assert out1["allow"].tolist() == [True, True, True, False, False]
        assert out2["reason"].tolist() == [20, 21, 22]
        pl.drain(timeout=5)
        assert t3.result(timeout=5)["reason"].tolist() == [30, 31, 32]
    finally:
        pl.close(timeout=5)


def test_deadline_flush(p):
    d = EchoDispatch()
    pl = p.pl.Pipeline(d, min_bucket=4, max_bucket=64, flush_ms=30.0)
    try:
        out = pl.submit(sub_batch(p, 3, start=1)).result(timeout=5)
        assert out["reason"].tolist() == [1, 2, 3]
        assert pl.flush_reasons["deadline"] == 1
    finally:
        pl.close(timeout=5)


def test_fifo_ordering_across_mixed_shapes(p):
    d = EchoDispatch()
    pl = p.pl.Pipeline(d, min_bucket=4, max_bucket=16, flush_ms=1.0)
    try:
        rng = np.random.default_rng(3)
        want, start = [], 0
        for _ in range(60):
            n = int(rng.integers(1, 12))
            pl.submit(sub_batch(p, n, start=start))
            want.extend(range(start, start + n))
            start += n
        assert pl.drain(timeout=30)
        assert d.sports_seen == want
    finally:
        pl.close(timeout=5)


def test_admission_drop_mode_accounts(p):
    d = EchoDispatch()
    d.gate.clear()
    pl = p.pl.Pipeline(d, min_bucket=4, max_bucket=4, queue_batches=2,
                       admission="drop", flush_ms=1000.0)
    try:
        tickets = [pl.submit(sub_batch(p, 4, start=4 * i)) for i in range(8)]
        dropped = [t for t in tickets if t.dropped]
        assert dropped and pl.admission_drops == len(dropped)
        for t in dropped:
            with pytest.raises(p.pl.PipelineDrop):
                t.result(timeout=1)
        assert pl.metrics.counters[
            "pipeline_admission_drops_total"] == len(dropped)
        d.gate.set()
        assert pl.drain(timeout=10)
        for t in tickets:
            if not t.dropped:
                t.result(timeout=5)
    finally:
        d.gate.set()
        pl.close(timeout=5)


def test_zero_valid_resolves_without_dispatch(p):
    d = EchoDispatch()
    pl = p.pl.Pipeline(d, min_bucket=4, max_bucket=16)
    try:
        out = pl.submit(sub_batch(p, 6, start=0, n_valid=0)).result(timeout=5)
        assert out["allow"].shape == (6,) and not out["allow"].any()
        assert d.batches == []
    finally:
        pl.close(timeout=5)


def test_dispatch_fault_retried_not_lost(p):
    d = EchoDispatch()
    pl = p.pl.Pipeline(d, min_bucket=4, max_bucket=16, flush_ms=1000.0)
    try:
        p.faults.arm("pipeline.dispatch", mode="fail", times=3)
        out = pl.submit(sub_batch(p, 4, start=7)).result(timeout=10)
        assert out["reason"].tolist() == [7, 8, 9, 10]
        assert pl.dispatch_faults == 3
        assert pl.metrics.counters["pipeline_dispatch_faults_total"] == 3
    finally:
        pl.close(timeout=5)


def test_dispatch_error_rejects_only_affected(p):
    d = EchoDispatch()
    pl = p.pl.Pipeline(d, min_bucket=4, max_bucket=16, flush_ms=1000.0)
    try:
        d.fail_next = ValueError("device fell over")
        bad = pl.submit(sub_batch(p, 4, start=0))
        with pytest.raises(p.pl.PipelineError):
            bad.result(timeout=5)
        ok = pl.submit(sub_batch(p, 4, start=50))
        assert ok.result(timeout=5)["reason"].tolist() == [50, 51, 52, 53]
        assert pl.dispatch_errors == 1
    finally:
        pl.close(timeout=5)


def test_close_completes_queued_work(p):
    d = EchoDispatch()
    d.gate.clear()
    pl = p.pl.Pipeline(d, min_bucket=4, max_bucket=4, queue_batches=32,
                       flush_ms=1000.0)
    tickets = [pl.submit(sub_batch(p, 4, start=4 * i)) for i in range(6)]
    d.gate.set()
    pl.close(timeout=10)
    for t in tickets:
        assert t.result(timeout=1)["allow"].all()
    with pytest.raises(p.pl.PipelineClosed):
        pl.submit(sub_batch(p, 4, start=0))


def test_breaker_opens_fails_fast_and_closes(p):
    d = EchoDispatch()
    pl = p.pl.Pipeline(d, min_bucket=4, max_bucket=16, flush_ms=1000.0,
                       restart_backoff_s=0.01, breaker_threshold=5,
                       breaker_cooldown_s=0.15)
    try:
        p.faults.arm("pipeline.dispatch", mode="fail")
        with pytest.raises(p.pl.PipelineUnavailable):
            pl.submit(sub_batch(p, 4, start=0)).result(timeout=10)
        assert pl.breaker.state == "open" and pl.state() == "breaker-open"
        for _ in range(3):
            with pytest.raises(p.pl.PipelineUnavailable):
                pl.submit(sub_batch(p, 4, start=8))
        p.faults.disarm("pipeline.dispatch")
        time.sleep(0.2)
        ok = pl.submit(sub_batch(p, 4, start=24)).result(timeout=5)
        assert ok["reason"].tolist() == [24, 25, 26, 27]
        assert pl.breaker.state == "closed" and pl.state() == "ok"
        m = pl.metrics
        assert m.counters[
            'pipeline_breaker_transitions_total{to="open"}'] == 1
        assert m.counters[
            'pipeline_breaker_transitions_total{to="closed"}'] == 1
    finally:
        pl.close(timeout=5)


def test_stats_shape(p):
    d = EchoDispatch()
    pl = p.pl.Pipeline(d, min_bucket=4, max_bucket=8, flush_ms=1.0)
    try:
        pl.submit(sub_batch(p, 3, start=0))
        assert pl.drain(timeout=5)
        s = pl.stats()
        assert s["submitted"] == 1 and s["outstanding"] == 0
        assert 0 < s["fill_ratio_avg"] <= 1.0
        assert "pipeline_queue_wait_seconds_bucket" in \
            pl.metrics.render_prometheus()
    finally:
        pl.close(timeout=5)


def test_stats_keys_equal_the_reference():
    docs = []
    for side in SIDES:
        m = pipe(side)
        pl = m.pl.Pipeline(EchoDispatch(), min_bucket=4, max_bucket=8,
                           flush_ms=1.0)
        try:
            pl.submit(sub_batch(m, 3, start=0))
            assert pl.drain(timeout=5)
            docs.append(pl.stats())
        finally:
            pl.close(timeout=5)
    assert set(docs[0]) == set(docs[1])


# --------------------------------------------------------------------------- #
# engine submit: the port against JAX under a dispatch fault storm
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [5])
def test_engine_submit_equals_jax_under_dispatch_faults(seed):
    """Bucket-shaped submissions through ``Engine.submit`` with
    ``pipeline.dispatch`` failing at a seeded rate: the retries hide every
    fault, and each ticket equals the JAX engine's ticket for the same
    submission (pipelining two batches in flight)."""
    engines = [storm_engine(s, pipeline_min_bucket=64, batch_size=64,
                            pipeline_inflight=2) for s in SIDES]
    slots = engines[0].active.snapshot.ep_slot_of
    rng = np.random.default_rng(seed)
    batches = [world_traffic("storm", slots, rng, n=64) for _ in range(12)]
    results = []
    for side, eng in zip(SIDES, engines):
        faults = mods(side).faults.FAULTS
        faults.arm("pipeline.dispatch", mode="prob", prob=0.3, seed=seed)
        try:
            tickets = [eng.submit(copy(b), now=1000 + i)
                       for i, b in enumerate(batches)]
            assert eng.drain(timeout=60)
            results.append([t.result(timeout=10) for t in tickets])
            stats = eng.pipeline_stats()
            assert stats["dispatch_faults"] > 0
        finally:
            faults.reset()
    for i, (want, got) in enumerate(zip(*results)):
        assert_outs_equal(want, got, f"ticket{i}")
    ej, et = engines
    assert_engines_equal(ej, et)
    assert ej.pipeline_stats()["dispatch_faults"] == \
        et.pipeline_stats()["dispatch_faults"]
    assert et.datapath.wire_pool_stats()["in_flight"] == 0
    for e in engines:
        e.stop()


# --------------------------------------------------------------------------- #
# test_pipeline.py's engine helpers on either package, for the host suites'
# mirrors (test_torch_observe.py, test_torch_audit.py)
# --------------------------------------------------------------------------- #
ORACLE = {"jax": "oracle", "torch": "cilium_tpu_torch.oracle"}
HOST_MODS = {"config": "runtime.config", "datapath": "runtime.datapath",
             "engine": "runtime.engine", "faults": "runtime.faults",
             "metrics": "runtime.metrics", "api": "runtime.api",
             "records": "kernels.records", "C": "utils.constants",
             "ip": "utils.ip", "trace": "observe.trace",
             "flowmetrics": "observe.flowmetrics",
             "autotune": "observe.autotune", "audit": "observe.audit",
             "blackbox": "observe.blackbox", "pipeline": "pipeline",
             "scheduler": "pipeline.scheduler", "feeder": "shim.feeder",
             "cli": "cli.main"}

#: ``test_pipeline.py``'s policy: web may reach 10/8 on TCP 443
POLICY = [{
    "endpointSelector": {"matchLabels": {"app": "web"}},
    "egress": [{"toCIDR": ["10.0.0.0/8"],
                "toPorts": [{"ports": [{"port": "443",
                                        "protocol": "TCP"}]}]}],
}]
PARITY_KEYS = ("allow", "reason", "status", "remote_identity", "svc",
               "nat_dst", "nat_dport", "rnat", "rnat_src", "rnat_sport")


def host(side):
    """``side``'s modules by the short names of ``HOST_MODS`` (and ``pl``,
    ``oracle``, ``empty_batch``, so that ``sub_batch`` takes it)."""
    ns = {k: importlib.import_module(f"{PKG[side]}.{v}")
          for k, v in HOST_MODS.items()}
    ns["oracle"] = importlib.import_module(ORACLE[side])
    return SimpleNamespace(side=side, pl=ns["pipeline"],
                           empty_batch=ns["records"].empty_batch, **ns)


def pkt(m, src, dst, sp, dp, flags=None, ep_id=1):
    """``test_pipeline.py``'s ``pkt`` on ``m``'s package (an egress TCP
    record, SYN by default)."""
    C = m.C
    s16, _ = m.ip.parse_addr(src)
    d16, _ = m.ip.parse_addr(dst)
    return m.oracle.PacketRecord(
        s16, d16, sp, dp, C.PROTO_TCP, C.TCP_SYN if flags is None else flags,
        False, ep_id, C.DIR_EGRESS, C.HTTP_METHOD_ANY, b"")


def fake_engine(m, **kw):
    """``test_pipeline.py``'s ``fake_engine``: each package's
    ``FakeDatapath`` (the port's on the CPU)."""
    kw.setdefault("ct_capacity", 4096)
    kw.setdefault("auto_regen", False)
    kw.setdefault("batch_size", 64)
    if m.side == "torch":
        kw.setdefault("device", "cpu")
    cfg = m.config.DaemonConfig(**kw)
    return m.engine.Engine(cfg, datapath=m.datapath.FakeDatapath(cfg))


def mk_chunks(m, slot_of, n_chunks, rows_per_chunk, seed=11, repeats=False):
    """``test_pipeline.py``'s ``mk_chunks`` on ``m``'s package: sub-full
    chunks of fresh SYNs to allowed and denied destinations; with
    ``repeats`` each later chunk also revisits an early flow with an
    ACK."""
    C = m.C
    rng = np.random.default_rng(seed)
    chunks = []
    for c in range(n_chunks):
        recs = []
        for r in range(rows_per_chunk):
            if repeats and c >= 2 and r == rows_per_chunk - 1:
                recs.append(pkt(m, "192.168.1.10", "10.1.2.3", 41000, 443,
                                flags=C.TCP_ACK))
                continue
            dp = int(rng.choice([443, 443, 80, 22]))
            dst = f"10.{rng.integers(0, 2)}.2.{rng.integers(1, 250)}"
            sp = 42000 + c * rows_per_chunk + r
            if (c, r) == (0, 0):
                sp, dp, dst = 41000, 443, "10.1.2.3"
            recs.append(pkt(m, "192.168.1.10", dst, sp, dp))
        chunks.append(m.records.batch_from_records(recs, slot_of))
    return chunks


def assert_parity(ser, piped, chunks):
    """``test_pipeline.py``'s ``_assert_parity``: ``chunks`` through the
    serial ``classify`` of ``ser`` and through ``piped.submit`` equal in
    every out column, CT occupancy and drop counter. → the pipelined
    outputs, the live count and the counters (to hold against the other
    package's)."""
    serial = [ser.classify(dict(ch), now=100 + i)
              for i, ch in enumerate(chunks)]
    tickets = [piped.submit(dict(ch), now=100 + i)
               for i, ch in enumerate(chunks)]
    assert piped.drain(timeout=30)
    outs = []
    for i, (t, want) in enumerate(zip(tickets, serial)):
        got = t.result(timeout=5)
        for k in PARITY_KEYS:
            np.testing.assert_array_equal(
                got[k], want[k], err_msg=f"chunk {i} field {k} diverged")
        outs.append({k: np.asarray(got[k]).tolist() for k in PARITY_KEYS})
    live = piped.ct_stats(now=200)["live"]
    assert live == ser.ct_stats(now=200)["live"]
    assert piped.metrics.packets_total == ser.metrics.packets_total
    np.testing.assert_array_equal(piped.metrics.by_reason_dir,
                                  ser.metrics.by_reason_dir)
    return {"outs": outs, "live": live,
            "packets": int(piped.metrics.packets_total),
            "by_reason_dir": np.asarray(
                piped.metrics.by_reason_dir).tolist()}
