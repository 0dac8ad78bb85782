"""The port's sharded serving path against the JAX package's on the CPU,
case for case with ``tests/test_sharded_pipeline.py``.

Each reference case runs its own body on each package (``P("jax")``,
``P("torch")``: the JAX engine on ``JITDatapath`` over the 8 virtual CPU
devices of ``tests/conftest.py``, the port's on a meshed ``TorchDatapath``
over ``cpu`` devices; both serial paths on each package's oracle-backed
``FakeDatapath``), asserts the reference's expectations on both, and holds
a side-neutral observation equal (``both``): the steered row order and the
FIFO un-steer of the echo dispatch, shed counts and reasons per shard,
revision stamps, every ticket's columns and the CT arrays against the
serial path, health's ``shards`` block, and the alloc-free assertion on
each side. ``TestShardedSoak::test_soak_10k_sharded_with_rx_faults`` and
``TestDegradedMeshParity``'s ``[8-5]`` keep ``slow``.

Beyond the mirrors: every mesh geometry (4 × 1, 8 × 1, 1 × 8, 4 × 2,
device RSS) serving and patching like the oracle, the rule-sharded delta
patch against the JAX mesh, and a slow 10k soak of the port's 8-shard
mesh under dispatch faults.
"""

import functools
import gc
import importlib
import os
import time
import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest

from cilium_tpu.kernels.records import batch_from_records
from cilium_tpu.utils import constants as C
from tests.test_datapath import FIXTURE_RULES, pkt
from tests.test_sharded_pipeline import (_mk_phase, _run_phase,
                                         fake_serial_engine,
                                         jit_pipeline_engine)
from tests.test_torch_datapath import (PORT_PACK_STATS, SIDES,
                                       assert_ct_equal, mods, reference_keys)
from tests.test_torch_faults import ref_shim_lib  # noqa: F401 (fixture)
from tests.test_torch_datapath import pkt as side_pkt
from tests.test_torch_pipeline import EchoDispatch
from tests.test_torch_pipeline import sub_batch as side_sub_batch

PKG = {"jax": "cilium_tpu", "torch": "cilium_tpu_torch"}
#: the reference's column sets: the full out geometry, and the columns
#: the oracle-backed fake reports
OUT_KEYS = ("allow", "reason", "status", "remote_identity", "redirect",
            "svc", "nat_dst", "nat_dport", "rnat", "rnat_src", "rnat_sport")
ORACLE_KEYS = ("allow", "reason", "status", "remote_identity", "redirect",
               "svc", "rnat")


@pytest.fixture(autouse=True)
def _clean_faults():
    for side in SIDES:
        mods(side).faults.FAULTS.reset()
    yield
    for side in SIDES:
        mods(side).faults.FAULTS.reset()


def P(side):
    """``side``'s objects by the names ``test_sharded_pipeline.py``
    imports, and its helpers bound to them: ``jit_pipeline_engine`` (the
    port's on a meshed ``TorchDatapath`` over ``cpu`` devices),
    ``fake_serial_engine``, ``_mk_phase``, ``_run_phase`` (which records
    every pipelined ticket's columns in ``seen``), ``pkt``,
    ``sub_batch`` and ``module(name)``, the package's module."""
    pkg = PKG[side]
    mod = importlib.import_module
    pl = mod(f"{pkg}.pipeline")
    dp = mod(f"{pkg}.runtime.datapath")
    cfg = mod(f"{pkg}.runtime.config").DaemonConfig
    if side == "torch":
        cfg = functools.partial(cfg, device="cpu")
    m = SimpleNamespace(
        side=side, pl=pl, Pipeline=pl.Pipeline,
        PipelineDeadlineExceeded=pl.PipelineDeadlineExceeded,
        PipelineDrop=pl.PipelineDrop, DaemonConfig=cfg,
        FakeDatapath=dp.FakeDatapath,
        JITDatapath=(dp.TorchDatapath if side == "torch"
                     else dp.JITDatapath),
        Engine=mod(f"{pkg}.runtime.engine").Engine,
        FAULTS=mod(f"{pkg}.runtime.faults").FAULTS,
        C=mod(f"{pkg}.utils.constants"),
        parse_addr=mod(f"{pkg}.utils.ip").parse_addr,
        PacketRecord=mod("oracle" if side == "jax"
                         else "cilium_tpu_torch.oracle").PacketRecord,
        shard_bin_encode=mod(f"{pkg}.pipeline.scheduler").shard_bin_encode,
        mesh=mod(f"{pkg}.parallel.mesh"),
        bindings=mod(f"{pkg}.shim.bindings"), seen=[],
        module=lambda name: mod(f"{pkg}.{name}"))
    records = mod(f"{pkg}.kernels.records")
    m.batch_from_records = records.batch_from_records
    m.empty_batch = records.empty_batch
    m.pkt = functools.partial(side_pkt, m)
    m.sub_batch = functools.partial(side_sub_batch, m)

    def engine(dp_cls, **kw):
        kw.setdefault("ct_capacity", 2048)
        kw.setdefault("auto_regen", False)
        kw.setdefault("flowlog_mode", "none")
        c = m.DaemonConfig(**kw)
        eng = m.Engine(c, datapath=dp_cls(c))
        _world(eng)
        return eng

    def jit_engine(n_shards, **kw):
        kw.setdefault("batch_size", 128)
        kw.setdefault("pipeline_flush_ms", 1.0)
        return engine(m.JITDatapath, n_shards=n_shards, **kw)

    m.jit_pipeline_engine = jit_engine
    m.fake_serial_engine = functools.partial(engine, m.FakeDatapath)
    m._mk_phase = functools.partial(mk_phase, m)
    m._run_phase = functools.partial(run_phase, m)
    return m


def both(case):
    obs = {s: case(P(s)) for s in SIDES}
    assert obs["jax"] == obs["torch"]
    return obs["torch"]


def mk_phase(m, slot_of, n_chunks, sizes, seed, revisit=None):
    """The reference's ``_mk_phase`` on ``m``'s package."""
    rng = np.random.default_rng(seed)
    chunks = []
    for c in range(n_chunks):
        recs = []
        if revisit and c == 0:
            recs.extend(m.pkt("192.168.1.10", dst, sp, dp, flags=flags)
                        for sp, dp, dst, flags in revisit)
        n = sizes[c % len(sizes)]
        for r in range(n):
            dp = int(rng.choice([443, 443, 80, 22]))
            dst = f"10.{rng.integers(0, 2)}.2.{rng.integers(1, 250)}"
            sp = 42000 + seed * 1000 + c * 64 + r
            recs.append(m.pkt("192.168.1.10", dst, sp, dp))
        chunks.append(m.batch_from_records(recs, slot_of,
                                           pad_to=len(recs) + (c % 3)))
    return chunks


def columns(out, keys=OUT_KEYS):
    return {k: np.asarray(out[k]).tolist() for k in keys}


def run_phase(m, serial, pipes, chunks, now0):
    """The reference's ``_run_phase`` on ``m``'s engines: each pipeline
    must match the oracle on ORACLE_KEYS and the pipelines each other on
    OUT_KEYS; every pipelined ticket's columns go to ``m.seen``. → the
    serial outs."""
    outs = [serial.classify(dict(ch), now=now0 + i)
            for i, ch in enumerate(chunks)]
    tickets = {id(p): [p.submit(dict(ch), now=now0 + i)
                       for i, ch in enumerate(chunks)] for p in pipes}
    got = {}
    for p in pipes:
        assert p.drain(timeout=60)
        got[id(p)] = [t.result(timeout=10) for t in tickets[id(p)]]
        for i, (g, want) in enumerate(zip(got[id(p)], outs)):
            for k in ORACLE_KEYS:
                np.testing.assert_array_equal(
                    g[k], want[k],
                    err_msg=f"chunk {i} field {k} diverged from oracle "
                            f"(shards={p.datapath.pipeline_shards})")
        m.seen.append([columns(g) for g in got[id(p)]])
    ref = pipes[0]
    for p in pipes[1:]:
        for i, (g, r) in enumerate(zip(got[id(p)], got[id(ref)])):
            for k in OUT_KEYS:
                np.testing.assert_array_equal(
                    g[k], r[k],
                    err_msg=f"chunk {i} field {k}: "
                            f"{p.datapath.pipeline_shards}-shard != "
                            f"{ref.datapath.pipeline_shards}-shard")
    return outs


def ct_bytes(eng):
    return sorted((k, v.tobytes()) for k, v in eng.ct_arrays().items())


class ViewEchoDispatch(EchoDispatch):
    """EchoDispatch with the sharded dispatch signature (the pipeline
    passes the bucket's steer revision) that also snapshots each
    dispatched batch view (the staging buffer is recycled, so layout
    assertions need a copy)."""

    def __init__(self):
        super().__init__()
        self.views = []
        self.steer_revs = []

    def __call__(self, batch, now, steer_rev=None):
        fin = super().__call__(batch, now)
        self.views.append({k: np.asarray(v).copy()
                           for k, v in batch.items()})
        self.steer_revs.append(steer_rev)
        return fin

    def layout(self):
        """Side-neutral: each dispatched view's valid rows and sports."""
        return [(v["valid"].tolist(), v["sport"].tolist())
                for v in self.views]


def shard_mod(n_shards):
    """Deterministic unit-test steering: shard by sport (the row tag the
    echo dispatch echoes back), so tests can predict each row's segment."""
    def fn(batch):
        return np.asarray(batch["sport"]) % n_shards
    return fn


def sharded_pipeline(m, d, n_shards=4, **kw):
    kw.setdefault("max_bucket", 16)
    kw.setdefault("min_bucket", 1)
    kw.setdefault("flush_ms", 5.0)
    kw.setdefault("shard_fn", shard_mod(n_shards))
    kw.setdefault("shard_headroom", 4)
    return m.Pipeline(d, n_shards=n_shards, **kw)


def shed_doc(pl):
    """A pipeline's shed counts and reasons, per shard included."""
    s = pl.stats()
    return (s["shed_reasons"], s["restarts"], s.get("shard_rows_total"),
            s["flush_reasons"])


# --------------------------------------------------------------------------- #
# Unit: the steered staging ring
# --------------------------------------------------------------------------- #
class TestSteeredStaging:
    def test_rows_grouped_by_shard_and_fifo_unsteer(self):
        """Dispatched buckets carry rows grouped into per-shard segments;
        each ticket's verdicts come back un-steered, in submission row
        order (the slice dst_rows gather)."""
        @both
        def _(m):
            d = ViewEchoDispatch()
            pl = sharded_pipeline(m, d, n_shards=4)
            try:
                seg = pl.stats()["shard_capacity"]
                t1 = pl.submit(m.sub_batch(6, start=100))
                t2 = pl.submit(m.sub_batch(5, start=200))
                assert pl.drain(timeout=10)
                r1 = t1.result(timeout=5)["reason"].tolist()
                r2 = t2.result(timeout=5)["reason"].tolist()
                assert r1 == list(range(100, 106))
                assert r2 == list(range(200, 205))
                assert len(d.batches) == 1
                view_sports = d.views[0]["sport"]
                view_valid = d.views[0]["valid"]
                assert view_valid.shape[0] == 4 * seg
                for row in np.nonzero(view_valid)[0]:
                    assert view_sports[row] % 4 == row // seg
                for s in range(4):
                    seg_sports = view_sports[s * seg:(s + 1) * seg][
                        view_valid[s * seg:(s + 1) * seg]]
                    in_100s = [x for x in seg_sports if x < 200]
                    in_200s = [x for x in seg_sports if x >= 200]
                    assert in_100s == sorted(in_100s)
                    assert in_200s == sorted(in_200s)
                    assert seg_sports.tolist() == in_100s + in_200s
                return seg, r1, r2, d.layout()
            finally:
                pl.close(timeout=5)

    def test_steer_batch_out_reuse_equivalent(self):
        """steer_batch(out=) into a reused buffer is byte-identical to the
        allocating steer, including after a larger previous use (stale
        rows restored to empty-batch defaults)."""
        @both
        def _(m):
            steer_batch, eb = m.mesh.steer_batch, m.empty_batch
            big = m.sub_batch(16, start=100)
            small = m.sub_batch(4, start=200)
            buf = eb(4 * 8)
            steer_batch(big, 4, per_shard=8, out=buf)
            seen = []
            for b in (small, big):
                want, ws, _ = steer_batch(b, 4, per_shard=8)
                got, gs, _ = steer_batch(b, 4, per_shard=8, out=buf)
                assert got is buf
                np.testing.assert_array_equal(ws, gs)
                for k in want:
                    np.testing.assert_array_equal(want[k], got[k], k)
                seen.append((gs.tolist(), sorted(
                    (k, v.tobytes()) for k, v in got.items())))
            with pytest.raises(ValueError):
                steer_batch(big, 4, per_shard=8, out=eb(8))
            return seen

    def test_no_direct_bypass_when_sharded(self):
        """A bucket-shaped submission still stages (its arbitrary row
        order carries no shard placement) — the 'direct' flush reason can
        never fire on a sharded pipeline."""
        @both
        def _(m):
            d = ViewEchoDispatch()
            pl = sharded_pipeline(m, d, n_shards=4, max_bucket=16,
                                  min_bucket=16)
            try:
                t = pl.submit(m.sub_batch(16, start=300))
                assert pl.drain(timeout=10)
                r = t.result(timeout=5)["reason"].tolist()
                assert r == list(range(300, 316))
                assert pl.stats()["flush_reasons"]["direct"] == 0
                return r, d.layout(), shed_doc(pl)
            finally:
                pl.close(timeout=5)

    def test_steer_overflow_sheds_with_reason(self):
        """A submission more skewed than the per-shard segment capacity is
        shed with reason="steer_overflow" (PipelineDrop, retryable); the
        worker survives and keeps serving."""
        @both
        def _(m):
            d = ViewEchoDispatch()
            pl = sharded_pipeline(m, d, n_shards=4, max_bucket=16,
                                  shard_headroom=1)
            try:
                seg = pl.stats()["shard_capacity"]
                skewed = m.sub_batch(16, start=400)
                skewed["sport"][:] = 400            # every row → shard 0
                assert seg < 16
                t = pl.submit(skewed)
                with pytest.raises(m.PipelineDrop) as e:
                    t.result(timeout=5)
                s = pl.stats()
                assert s["shed_reasons"] == {"steer_overflow": 1}
                assert pl.metrics.counters[
                    'pipeline_shed_total{reason="steer_overflow"}'] == 1
                assert s["restarts"] == 0
                ok = pl.submit(m.sub_batch(4, start=500))
                assert pl.drain(timeout=10)
                r = ok.result(timeout=5)["reason"].tolist()
                assert r == list(range(500, 504))
                return seg, type(e.value).__name__, r, shed_doc(pl)
            finally:
                pl.close(timeout=5)

    def test_skewed_flood_sheds_one_shard_others_keep_serving(self):
        """Adversarial skew: a flood whose flow hash lands in ONE shard
        segment sheds with reason="steer_overflow" FIFO-safely, while
        interleaved balanced traffic keeps serving through the other
        shards with verdict parity for every surviving row."""
        @both
        def _(m):
            d = ViewEchoDispatch()
            pl = sharded_pipeline(m, d, n_shards=4, max_bucket=16,
                                  shard_headroom=1)
            try:
                seg = pl.stats()["shard_capacity"]
                assert seg < 16
                outcomes = []
                for i in range(6):
                    if i % 2 == 0:
                        flood = m.sub_batch(16, start=1000 + 100 * i)
                        flood["sport"][:] = 1000 + 100 * i
                        outcomes.append((pl.submit(flood), "flood"))
                    else:
                        legit = m.sub_batch(4, start=2000 + 100 * i)
                        outcomes.append((pl.submit(legit), "legit"))
                assert pl.drain(timeout=10)
                got = []
                for t, kind in outcomes:
                    if kind == "flood":
                        with pytest.raises(m.PipelineDrop):
                            t.result(timeout=5)
                        got.append("shed")
                    else:
                        out = t.result(timeout=5)
                        start = int(out["reason"][0])
                        assert out["reason"].tolist() == \
                            list(range(start, start + 4))
                        got.append(out["reason"].tolist())
                s = pl.stats()
                assert s["shed_reasons"] == {"steer_overflow": 3}
                assert pl.metrics.counters[
                    'pipeline_shed_total{reason="steer_overflow"}'] == 3
                assert s["restarts"] == 0
                rows_total = s["shard_rows_total"]
                assert sum(rows_total) == 12 and max(rows_total) < 12
                return got, shed_doc(pl)
            finally:
                pl.close(timeout=5)

    def test_prebinned_shard_column_skips_hash(self):
        """A producer that pre-binned (the feeder's harvest hash) rides
        the ``_shard`` column (shard+1); shard_fn is never called."""
        @both
        def _(m):
            d = ViewEchoDispatch()
            calls = []

            def counting_fn(batch):
                calls.append(1)
                return np.asarray(batch["sport"]) % 4

            pl = sharded_pipeline(m, d, n_shards=4, shard_fn=counting_fn)
            try:
                seg = pl.stats()["shard_capacity"]
                b = m.sub_batch(8, start=600)
                b["_shard"] = (np.arange(600, 608, dtype=np.int32) % 4) + 1
                t = pl.submit(b)
                assert pl.drain(timeout=10)
                r1 = t.result(timeout=5)["reason"].tolist()
                assert r1 == list(range(600, 608))
                assert not calls
                view = d.views[0]
                for row in np.nonzero(view["valid"])[0]:
                    assert view["sport"][row] % 4 == row // seg
                b2 = m.sub_batch(4, start=700)
                b2["_shard"] = np.full(4, 99, dtype=np.int32)
                t2 = pl.submit(b2)
                assert pl.drain(timeout=10)
                r2 = t2.result(timeout=5)["reason"].tolist()
                assert r2 == list(range(700, 704))
                assert calls
                return r1, r2, len(calls), d.layout()
            finally:
                pl.close(timeout=5)

    def test_prebinned_shard_revision_gate(self):
        """A pre-bin is only trusted while its binning revision is still
        active: a stale bin re-hashes through shard_fn instead of
        mis-steering."""
        @both
        def _(m):
            d = ViewEchoDispatch()
            calls = []
            rev = [7]

            def counting_fn(batch):
                calls.append(1)
                return np.asarray(batch["sport"]) % 4

            pl = sharded_pipeline(m, d, n_shards=4, shard_fn=counting_fn,
                                  shard_rev_fn=lambda: rev[0])
            try:
                b = m.sub_batch(8, start=600)
                b["_shard"] = m.shard_bin_encode(
                    np.arange(600, 608, dtype=np.int64) % 4, 7)
                t = pl.submit(b)
                assert pl.drain(timeout=10)
                t.result(timeout=5)
                assert not calls               # fresh bin: trusted
                fresh = len(calls)
                rev[0] = 8                     # "regen" supersedes the bin
                b2 = m.sub_batch(4, start=700)
                b2["_shard"] = m.shard_bin_encode(
                    np.arange(700, 704, dtype=np.int64) % 4, 7)
                t2 = pl.submit(b2)
                assert pl.drain(timeout=10)
                r2 = t2.result(timeout=5)["reason"].tolist()
                assert r2 == list(range(700, 704))
                assert calls                   # stale bin: re-hashed
                return fresh, r2, d.layout()
            finally:
                pl.close(timeout=5)

    def test_steer_revision_rides_into_dispatch(self):
        """The bucket's steer revision reaches dispatch_fn: a
        single-revision bucket carries that revision, a mixed bucket the
        'mixed' sentinel."""
        @both
        def _(m):
            d = ViewEchoDispatch()
            rev = [7]
            pl = sharded_pipeline(m, d, n_shards=4, flush_ms=60_000.0,
                                  shard_rev_fn=lambda: rev[0])
            try:
                pl.submit(m.sub_batch(3, start=100))
                assert pl.drain(timeout=10)
                assert d.steer_revs == [7]
                pl.submit(m.sub_batch(3, start=200))
                end = time.time() + 5
                while pl.stats()["staged_rows"] < 3 and time.time() < end:
                    time.sleep(0.005)
                rev[0] = 8
                pl.submit(m.sub_batch(3, start=300))
                assert pl.drain(timeout=10)
                assert d.steer_revs == [7, -2]  # mixed bucket flagged
                return list(d.steer_revs), d.batches
            finally:
                pl.close(timeout=5)

    def test_flush_shed_masks_steered_rows(self):
        """A staged rider whose deadline expires before the bucket
        dispatches is valid-masked out of its scattered rows; co-staged
        riders still serve in FIFO order."""
        @both
        def _(m):
            d = ViewEchoDispatch()
            pl = sharded_pipeline(m, d, n_shards=4, flush_ms=60_000.0)
            try:
                doomed = pl.submit(m.sub_batch(3, start=10),
                                   deadline_ms=30)
                keeper = pl.submit(m.sub_batch(3, start=20))
                time.sleep(0.08)
                assert pl.drain(timeout=5)
                with pytest.raises(m.PipelineDeadlineExceeded):
                    doomed.result(timeout=1)
                r = keeper.result(timeout=1)["reason"].tolist()
                assert r == [20, 21, 22]
                assert sorted(d.batches[0]) == [20, 21, 22]
                assert pl.stats()["shed_reasons"] == {"flush": 1}
                return r, d.batches, shed_doc(pl)
            finally:
                pl.close(timeout=5)

    def test_segment_tails_reset_between_reuses(self):
        """A segment written full by one flush must not leak stale rows
        into a later, smaller flush from the same staging slot."""
        @both
        def _(m):
            d = ViewEchoDispatch()
            pl = sharded_pipeline(m, d, n_shards=2, max_bucket=8,
                                  inflight=1)
            try:
                seg = pl.stats()["shard_capacity"]
                for start in (800, 900):
                    t = pl.submit(m.sub_batch(8, start=start))
                    assert pl.drain(timeout=10)
                    t.result(timeout=5)
                small = pl.submit(m.sub_batch(2, start=1000))
                assert pl.drain(timeout=10)
                small.result(timeout=5)
                view = d.views[-1]
                assert int(view["valid"].sum()) == 2
                inv = ~view["valid"]
                assert not view["sport"][inv].any()
                assert (view["http_method"][inv]
                        == m.C.HTTP_METHOD_ANY).all()
                assert view["valid"].shape[0] == 2 * seg
                return seg, d.layout()
            finally:
                pl.close(timeout=5)


# --------------------------------------------------------------------------- #
# Integration: 1-shard vs 8-shard pipelines vs the oracle-backed serial path
# --------------------------------------------------------------------------- #
def _world(eng):
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
    eng.add_endpoint(["k8s:role=fe"], ips=("192.168.1.30",), ep_id=3)
    eng.apply_policy(FIXTURE_RULES)
    eng.regenerate()


def torch_pipeline_engine(n_shards, **kw):
    """``jit_pipeline_engine``'s twin: the port's engine on a meshed
    ``TorchDatapath`` over ``cpu`` devices."""
    m = mods("torch")
    kw.setdefault("ct_capacity", 2048)
    kw.setdefault("auto_regen", False)
    kw.setdefault("batch_size", 128)
    kw.setdefault("pipeline_flush_ms", 1.0)
    kw.setdefault("flowlog_mode", "none")
    cfg = m.config.DaemonConfig(n_shards=n_shards, device="cpu", **kw)
    eng = m.engine.Engine(cfg, datapath=m.datapath.TorchDatapath(cfg))
    _world(eng)
    return eng


def pipeline_engine(side, n_shards, **kw):
    return (jit_pipeline_engine if side == "jax"
            else torch_pipeline_engine)(n_shards, **kw)


def assert_mesh_engines_equal(ej, et, msg=""):
    """The CT arrays and the datapath counters of two meshed engines."""
    assert_ct_equal(ej.ct_arrays(), et.ct_arrays(), msg)
    mj, mt = ej.metrics, et.metrics
    np.testing.assert_array_equal(mj.by_reason_dir, mt.by_reason_dir, msg)
    for k in ("insert_fail", "ct_evicted", "packets_total"):
        assert getattr(mj, k) == getattr(mt, k), (msg, k)


class TestShardedParity:
    def test_8shard_pipeline_bit_identical_to_serial(self):
        """The acceptance pin: the same submission stream through the
        1-shard and the 8-shard pipelines produces verdicts bit-identical
        to the serial single-chip path — partial buckets, a deadline-shed
        submission, CT continuity across drained phases (direction-stable
        steering), and a mid-soak place_patch included."""
        @both
        def _(m):
            C = m.C
            serial = m.fake_serial_engine()
            eng1 = m.jit_pipeline_engine(1)
            eng8 = m.jit_pipeline_engine(8)
            pipes = [eng1, eng8]
            slot_of = serial.active.snapshot.ep_slot_of
            try:
                ch1 = m._mk_phase(slot_of, 6, (1, 5, 17, 32, 9, 23), seed=1)
                m._run_phase(serial, pipes, ch1, now0=1000)
                stale = m.batch_from_records(
                    [m.pkt("192.168.1.10", "10.0.2.9", 47999, 443)],
                    slot_of)
                for p in pipes:
                    t = p.submit(dict(stale), now=1100, deadline_ms=0.001)
                    with pytest.raises(m.PipelineDeadlineExceeded):
                        t.result(timeout=10)
                est = [m.pkt("192.168.1.10", "10.0.2.7", 48100 + i, 443)
                       for i in range(4)]
                pre = m.batch_from_records(est, slot_of)
                outs = m._run_phase(serial, pipes, [pre], now0=1200)
                assert outs[0]["allow"].all()
                reply = [m.pkt("10.0.2.7", "192.168.1.10", 443, 48100 + i,
                               flags=C.TCP_ACK, direction=C.DIR_INGRESS)
                         for i in range(4)]
                fwd_ack = [(48100 + i, 443, "10.0.2.7", C.TCP_ACK)
                           for i in range(2)]
                ch2 = [m.batch_from_records(reply, slot_of,
                                            pad_to=len(reply) + 2)]
                ch2 += m._mk_phase(slot_of, 3, (7, 13, 2), seed=2,
                                   revisit=fwd_ack)
                outs2 = m._run_phase(serial, pipes, ch2, now0=1210)
                assert (np.asarray(outs2[0]["status"])[:len(reply)]
                        == int(C.CTStatus.REPLY)).all()
                assert (np.asarray(outs2[1]["status"])[:2]
                        == int(C.CTStatus.ESTABLISHED)).all()
                patch_rule = [{
                    "endpointSelector": {"matchLabels": {"app": "web"}},
                    "egressDeny": [{"toCIDR": ["10.1.128.0/17"]}],
                }]
                for e in (serial, eng1, eng8):
                    e.apply_policy(patch_rule)
                    e.regenerate()
                ch3 = m._mk_phase(slot_of, 4, (11, 3, 29, 6), seed=3)
                m._run_phase(serial, pipes, ch3, now0=1400)
                live = serial.ct_stats(now=1500)["live"]
                assert eng1.ct_stats(now=1500)["live"] == live
                assert eng8.ct_stats(now=1500)["live"] == live
                ps = eng8.datapath.pack_stats
                assert ps["pack_fallback_steered"] == 0
                assert ps["pack_fallback_disabled"] == 0
                assert ps["pack_inplace"] > 0
                assert eng8.pipeline_stats()["n_shards"] == 8
                return (m.seen, live, ct_bytes(eng1), ct_bytes(eng8),
                        reference_keys(ps, PORT_PACK_STATS),
                        dict(eng8.datapath.patch_stats))
            finally:
                for e in (serial, eng1, eng8):
                    e.stop()

    def test_sharded_engine_health_carries_shards(self):
        @both
        def _(m):
            eng = m.jit_pipeline_engine(2)
            try:
                eng.submit(m.batch_from_records(
                    [m.pkt("192.168.1.10", "10.0.2.3", 40000, 443)],
                    eng.active.snapshot.ep_slot_of), now=100)
                assert eng.drain(timeout=30)
                h = eng.health()
                assert h["pipeline"]["shards"] == 2
                text = eng.render_metrics()
                assert "ciliumtpu_pipeline_mesh_shards 2" in text
                assert 'ciliumtpu_datapath_pack_fallback_total' \
                       '{reason="steered"}' not in text
                assert "ciliumtpu_datapath_pack_inplace_total" in text
                return h["pipeline"]["shards"], [
                    ln for ln in text.splitlines()
                    if ln.startswith("ciliumtpu_pipeline_mesh_shards")]
            finally:
                eng.stop()

    def test_zero_copy_disabled_still_bit_identical(self):
        """zero_copy_ingest=False falls back to the legacy dict dispatch —
        counted under reason="disabled" — with identical verdicts."""
        @both
        def _(m):
            serial = m.fake_serial_engine()
            eng = m.jit_pipeline_engine(4, zero_copy_ingest=False)
            slot_of = serial.active.snapshot.ep_slot_of
            try:
                ch = m._mk_phase(slot_of, 3, (5, 12, 3), seed=4)
                m._run_phase(serial, [eng], ch, now0=2000)
                ps = eng.datapath.pack_stats
                assert ps["pack_fallback_disabled"] > 0
                assert ps["pack_inplace"] == 0
                return m.seen, ct_bytes(eng), reference_keys(
                    ps, PORT_PACK_STATS)
            finally:
                serial.stop()
                eng.stop()


class TestSteeredStagingAllocFree:
    def test_steered_staging_steady_state_alloc_free(self):
        """The pack/stage path's tracemalloc contract on the steered path: after
        warmup, a 512-batch pipelined run through the 4-shard mesh adds no
        per-batch buffer allocations in the pack/stage/steer files (net
        growth under 64KB between two equal windows)."""
        @both
        def _(m):
            eng = m.jit_pipeline_engine(4, pipeline_flush_ms=0.5)
            slot_of = eng.active.snapshot.ep_slot_of
            chunks = m._mk_phase(slot_of, 8, (9, 17, 5, 30), seed=5)
            now = [3000]

            def run(n):
                for i in range(n):
                    now[0] += 1
                    eng.submit(dict(chunks[i % len(chunks)]), now=now[0])
                    if i % 16 == 15:
                        assert eng.drain(timeout=60)
                assert eng.drain(timeout=60)

            try:
                run(128)
                gc.collect()
                tracemalloc.start()
                run(256)
                gc.collect()
                flt = [tracemalloc.Filter(True, f"*{os.sep}{name}")
                       for name in ("records.py", "scheduler.py",
                                    "datapath.py", "mesh.py")]
                snap1 = tracemalloc.take_snapshot()
                for _attempt in range(2):
                    run(512)
                    gc.collect()
                    snap2 = tracemalloc.take_snapshot()
                    diff = snap2.filter_traces(flt).compare_to(
                        snap1.filter_traces(flt), "lineno")
                    growth = sum(d.size_diff for d in diff)
                    if growth < 64 * 1024:
                        break
                    snap1 = snap2
                tracemalloc.stop()
                ps = eng.datapath.pack_stats
                assert ps["pack_inplace"] > 0
                assert ps["pack_fallback_steered"] == 0
                assert growth < 64 * 1024, \
                    f"steered stage/pack path grew {growth}B:\n" + \
                    "\n".join(str(d) for d in diff[:10])
                return (ps["pack_inplace"] > 0, ps["pack_fallback_steered"],
                        growth < 64 * 1024)
            finally:
                tracemalloc.stop()
                eng.stop()


@pytest.mark.slow
class TestShardedSoak:
    def test_soak_10k_sharded_with_rx_faults(self, ref_shim_lib):
        """10k submissions through the 8-shard mesh behind one admission
        queue. With the C shim built the stream rides the mock rings +
        async feeder (harvest pre-binning) with ``shim.rx_ring`` faults
        armed; otherwise direct submissions with dispatch faults. Either
        way: every frame/submission resolves, the steered path never falls
        back to an allocating pack, and the guard never restarts. (The JAX
        side's library is the reference's, built privately:
        ``ref_shim_lib``; the port's builds its own.)"""
        @both
        def _(m):
            n = 10_000
            eng = m.jit_pipeline_engine(
                8, batch_size=256, pipeline_queue_batches=256,
                ingest_pool_batches=8, pipeline_flush_ms=0.5)
            bindings = m.bindings
            try:
                if m.side == "torch" or os.path.exists(bindings.LIB_PATH):
                    FlowShim, build_frame = (bindings.FlowShim,
                                             bindings.build_frame)
                    shim = FlowShim(batch_size=64, timeout_us=100)
                    shim.register_endpoint("192.168.1.10", 1)
                    shim.mock_rings_init(ring_size=64, frame_size=2048,
                                         n_frames=64)
                    feeder = eng.start_feeder(shim)
                    m.FAULTS.arm("shim.rx_ring", mode="prob", prob=0.05,
                                 seed=31)
                    end = time.time() + 300
                    for i in range(n):
                        f = build_frame(
                            "192.168.1.10",
                            f"10.{i % 2}.2.{1 + i % 250}",
                            40000 + (i % 20000), 443 if i % 4 else 80)
                        while shim.mock_rx_inject(f) != 0:
                            shim.mock_tx_drain(64)
                            if time.time() > end:
                                raise TimeoutError("rx ring wedged")
                            time.sleep(0.0002)
                    while time.time() < end:
                        shim.mock_tx_drain(64)
                        st = shim.stats()
                        if st["verdict_passes"] + st["verdict_drops"] \
                                + st["tx_full_drops"] >= n:
                            break
                        time.sleep(0.002)
                    m.FAULTS.reset()
                    st = shim.stats()
                    fstats = feeder.stats()
                    assert st["verdict_passes"] + st["verdict_drops"] \
                        + st["tx_full_drops"] >= n
                    assert fstats["harvested_records"] == n
                    resolved = fstats["harvested_records"]
                    eng.stop()
                    shim.close()
                else:
                    m.FAULTS.arm("pipeline.dispatch", mode="prob",
                                 prob=0.02, seed=7)
                    slot_of = eng.active.snapshot.ep_slot_of
                    rng = np.random.default_rng(9)
                    tickets = []
                    for i in range(n):
                        k = 1 + (i % 3)
                        recs = [m.pkt("192.168.1.10",
                                      f"10.{int(rng.integers(0, 2))}.2."
                                      f"{int(rng.integers(1, 250))}",
                                      40000 + (i % 20000) + r, 443)
                                for r in range(k)]
                        tickets.append(eng.submit(
                            m.batch_from_records(recs, slot_of),
                            now=100 + i))
                    assert eng.drain(timeout=300)
                    m.FAULTS.reset()
                    resolved = sum(1 for t in tickets if t.done())
                    assert resolved == n
                    eng.stop()
                ps = eng.datapath.pack_stats
                assert ps["pack_fallback_steered"] == 0
                assert ps["pack_inplace"] > 0
                return resolved, ps["pack_fallback_steered"]
            finally:
                m.FAULTS.reset()
                eng.stop()

    def test_soak_10k_sharded_with_dispatch_faults(self):
        """10k submissions through the port's 8-shard mesh behind one
        admission queue with ``pipeline.dispatch`` faults armed: every
        submission resolves and the steered path never falls back to an
        allocating pack."""
        n = 10_000
        faults = mods("torch").faults.FAULTS
        eng = torch_pipeline_engine(
            8, batch_size=256, pipeline_queue_batches=256,
            ingest_pool_batches=8, pipeline_flush_ms=0.5)
        try:
            faults.arm("pipeline.dispatch", mode="prob", prob=0.02, seed=7)
            slot_of = eng.active.snapshot.ep_slot_of
            rng = np.random.default_rng(9)
            tickets = []
            for i in range(n):
                m = 1 + (i % 3)
                recs = [pkt("192.168.1.10",
                            f"10.{int(rng.integers(0, 2))}.2."
                            f"{int(rng.integers(1, 250))}",
                            40000 + (i % 20000) + r, 443)
                        for r in range(m)]
                tickets.append(eng.submit(
                    batch_from_records(recs, slot_of), now=100 + i))
            assert eng.drain(timeout=300)
            faults.reset()
            assert sum(1 for t in tickets if t.done()) == n
            ps = eng.datapath.pack_stats
            assert ps["pack_fallback_steered"] == 0
            assert ps["pack_inplace"] > 0
        finally:
            faults.reset()
            eng.stop()


class TestDegradedMeshParity:
    @pytest.mark.parametrize("n_shards,victim", [
        (4, 1),
        pytest.param(8, 5, marks=pytest.mark.slow),
    ])
    def test_n_minus_1_bit_identical_to_serial(self, n_shards, victim):
        """Shrink the mesh BEFORE any traffic (a device latched dead, one
        remesh tick onto the survivors), then run the sharded parity
        phases on the degraded geometry: fresh flows with partial
        buckets, CT continuity in BOTH directions, and the shadow
        auditor at sampling 1.0 staying clean."""
        @both
        def _(m):
            C = m.C
            m.FAULTS.reset()
            serial = m.fake_serial_engine()
            eng = m.jit_pipeline_engine(n_shards, audit_enabled=True,
                                        audit_sample_rate=1.0,
                                        audit_pool_batches=64)
            eng.auditor.configure(sample_rate=1.0)
            slot_of = serial.active.snapshot.ep_slot_of
            try:
                eng.datapath.note_device_loss(victim, reason="drill")
                doc = eng.remesh_step()
                assert doc["remesh"]["from"] == n_shards
                assert doc["remesh"]["to"] == n_shards - 1
                assert victim not in \
                    eng.datapath.mesh_health()["live_ordinals"]
                ch1 = m._mk_phase(slot_of, 5, (1, 5, 17, 9, 23),
                                  seed=60 + n_shards)
                m._run_phase(serial, [eng], ch1, now0=1000)
                est = [m.pkt("192.168.1.10", "10.0.2.7", 49300 + i, 443)
                       for i in range(4)]
                outs = m._run_phase(serial, [eng],
                                    [m.batch_from_records(est, slot_of)],
                                    now0=1200)
                assert outs[0]["allow"].all()
                reply = [m.pkt("10.0.2.7", "192.168.1.10", 443, 49300 + i,
                               flags=C.TCP_ACK, direction=C.DIR_INGRESS)
                         for i in range(4)]
                outs2 = m._run_phase(
                    serial, [eng],
                    [m.batch_from_records(reply, slot_of, pad_to=6)],
                    now0=1210)
                assert (np.asarray(outs2[0]["status"])[:4]
                        == int(C.CTStatus.REPLY)).all()
                assert eng.pipeline_stats()["n_shards"] == n_shards - 1
                for _ in range(100):
                    step = eng.audit_step(budget=128)
                    if not step or (not step.get("replayed")
                                    and not step.get("pending")):
                        break
                st = eng.auditor.stats()
                assert st["checked_rows"] > 0
                assert st["mismatched_rows"] == 0
                return (doc["remesh"]["from"], doc["remesh"]["to"],
                        eng.datapath.mesh_health()["live_ordinals"],
                        m.seen, ct_bytes(eng), st["checked_rows"],
                        st["mismatched_rows"])
            finally:
                serial.stop()
                eng.stop()


@pytest.mark.parametrize("geometry", [
    dict(n_shards=4), dict(n_shards=8), dict(n_shards=1, rule_shards=8),
    dict(n_shards=4, rule_shards=2), dict(n_shards=8, rss_mode="device"),
], ids=["4x1", "8x1", "1x8", "4x2", "device8"])
def test_every_geometry_serves_and_patches_like_the_oracle(geometry):
    """The port's engine on each mesh geometry serves the oracle's
    verdicts through the pipeline, before and after a policy update, and
    the updated placement equals a fresh one on every device (each copy
    and each rule shard's rows)."""
    import torch
    serial = fake_serial_engine()
    eng = torch_pipeline_engine(**geometry)
    slot_of = serial.active.snapshot.ep_slot_of
    try:
        _run_phase(serial, [eng], _mk_phase(slot_of, 3, (5, 17, 9), seed=70),
                   now0=1000)
        rule = [{"endpointSelector": {"matchLabels": {"app": "web"}},
                 "egressDeny": [{"toCIDR": ["10.1.128.0/17"]}]}]
        for e in (serial, eng):
            e.apply_policy(rule)
            e.regenerate()
        fresh = eng.datapath.place(eng.active.snapshot)
        placed = eng.active.tensors
        assert set(fresh) == set(placed)
        for d in fresh:
            assert set(fresh[d]) == set(placed[d])
            for k in fresh[d]:
                assert torch.equal(fresh[d][k], placed[d][k]), (d, k)
        _run_phase(serial, [eng], _mk_phase(slot_of, 3, (11, 3, 6), seed=71),
                   now0=1100)
        assert eng.ct_stats(1200)["live"] == serial.ct_stats(1200)["live"]
    finally:
        serial.stop()
        eng.stop()


def test_rule_sharded_delta_patch_writes_each_rule_shard():
    """Live rule toggles on a 4 × 2 mesh ride the in-place delta path:
    each patch writes the verdict rows of the rule shard that owns them,
    on every copy; the placement equals a fresh one, every verdict and the
    patch counters equal the JAX mesh's."""
    import torch
    from tests.test_torch_datapath import (N_PEERS, assert_outs_equal, copy,
                                           peer_rule_docs, storm_engine,
                                           traffic, warm_geometry)
    ej, et = (storm_engine(s, n_shards=4, rule_shards=2) for s in SIDES)
    warm_geometry(ej, et)
    now = 1000
    try:
        for step in range(6):
            i, p = step % N_PEERS, (443, 8080)[step % 2]
            label = f"k8s:warm=w{i}-{p}"
            body = None if step % 3 == 2 else peer_rule_docs(i, p,
                                                             label=label)
            for e in (ej, et):
                e.replace_policy([label], body)
                e.regenerate()
            b = traffic(ej.active.snapshot.ep_slot_of)
            assert_outs_equal(ej.classify(copy(b), now=now),
                              et.classify(copy(b), now=now), f"step{step}")
            now += 10
        assert et.datapath.patch_stats == ej.datapath.patch_stats
        assert et.datapath.patch_stats["patch_delta"] >= 3
        fresh = et.datapath.place(et.active.snapshot)
        for d in fresh:
            for k in fresh[d]:
                assert torch.equal(fresh[d][k], et.active.tensors[d][k]), k
        assert_ct_equal(ej.ct_arrays(), et.ct_arrays())
    finally:
        ej.stop()
        et.stop()
