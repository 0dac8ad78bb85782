"""The port's device-side RSS (``cilium_tpu_torch/parallel/exchange.py``,
``DaemonConfig(rss_mode="device")``) against the JAX package's on the CPU,
case for case with ``tests/test_rss.py``.

Each reference case runs its own body on each package (``P("jax")``,
``P("torch")``, the sharded-pipeline mirror's namespace: the JAX engines
on ``JITDatapath`` over the 8 virtual CPU devices, the port's on a meshed
``TorchDatapath`` over ``cpu`` devices, each serial path on its package's
oracle-backed ``FakeDatapath``), asserts the reference's expectations on
both, and holds a side-neutral observation equal (``both``): the gathered
and scattered chunks by origin (the JAX side through ``shard_map``, the
port's through its explicit hops), every out column, the CT tables slot
for slot and the eviction and CT_FULL counters of the saturating flood
(the steered and the device step on each side), every pipelined ticket's
columns and the CT arrays, shed counts, the ``rss_exchange`` ledger row
and the ``exchange`` HBM group without the byte sizes that depend on the
package, auditor stats, and the exception type and message of each
refusal. ``TestDeviceRSSSoak`` and ``TestDeviceRSSDegradedMesh`` keep
``slow``.
"""

import numpy as np
import pytest

from tests.test_torch_datapath import SIDES, mods
from tests.test_torch_sharded_pipeline import P, both, ct_bytes


@pytest.fixture(autouse=True)
def _clean_faults():
    for side in SIDES:
        mods(side).faults.FAULTS.reset()
    yield
    for side in SIDES:
        mods(side).faults.FAULTS.reset()


# --------------------------------------------------------------------------- #
# Unit: the ring primitives
# --------------------------------------------------------------------------- #
def _shard_map_fn(body, mesh):
    """``jax.jit(shard_map(body))`` over the ``flows`` axis, as the
    reference builds it."""
    import inspect

    import jax
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as PS
    kw = {("check_vma" if "check_vma"
           in inspect.signature(shard_map).parameters
           else "check_rep"): False}
    return jax.jit(shard_map(body, mesh=mesh, in_specs=PS("flows"),
                             out_specs=PS("flows"), **kw))


class TestRingPrimitives:
    def test_ring_all_gather_orders_by_origin(self):
        @both
        def _(m):
            n = 4
            x = np.arange(n * 3, dtype=np.uint32).reshape(n * 3, 1)
            ex = m.module("parallel.exchange")
            if m.side == "jax":
                import jax.numpy as jnp
                fn = _shard_map_fn(
                    lambda b: ex.ring_all_gather(b, "flows", n),
                    m.mesh.make_mesh(n, 1))
                out = np.asarray(fn(jnp.asarray(x))).reshape(n, n, 3, 1)
            else:
                import torch
                parts = [torch.from_numpy(x[i * 3:(i + 1) * 3].view(np.int32))
                         for i in range(n)]
                out = np.stack([o.numpy().view(np.uint32).reshape(n, 3, 1)
                                for o in ex.ring_all_gather(parts)])
            # each chip's [n, L, 1] block must hold ALL chips' rows
            # indexed by origin
            for chip in range(n):
                np.testing.assert_array_equal(
                    out[chip].reshape(n * 3, 1), x,
                    err_msg=f"chip {chip} gathered a reordered request set")
            return out.tolist()

    def test_ring_reduce_scatter_routes_chunks_home(self):
        @both
        def _(m):
            n = 4
            ex = m.module("parallel.exchange")
            if m.side == "jax":
                import jax
                import jax.numpy as jnp

                def body(x):
                    # every chip contributes chunk c = 1000*my + c per
                    # element; chip c must end with sum over chips of
                    # (1000*chip + c)
                    my = jax.lax.axis_index("flows")
                    parts = (jnp.arange(n, dtype=jnp.uint32)[:, None, None]
                             + jnp.uint32(1000) * my.astype(jnp.uint32))
                    parts = jnp.broadcast_to(parts, (n, 2, 1))
                    return ex.ring_reduce_scatter(parts, "flows", n)
                fn = _shard_map_fn(body, m.mesh.make_mesh(n, 1))
                out = np.asarray(fn(jnp.zeros((n * 2, 1), np.uint32)))
                out = out.reshape(n, 2, 1)
            else:
                import torch
                parts = [(torch.arange(n, dtype=torch.int32)[:, None, None]
                          + 1000 * s).expand(n, 2, 1).contiguous()
                         for s in range(n)]
                out = np.stack([o.numpy().reshape(2, 1)
                                for o in ex.ring_reduce_scatter(parts)])
            base = 1000 * sum(range(n))
            for c in range(n):
                assert (out[c] == base + n * c).all(), \
                    f"chip {c} chunk mis-routed: {out[c].ravel()}"
            return out.astype(np.int64).tolist()


# --------------------------------------------------------------------------- #
# Unit: exchange vs steered bit-identity at the raw classify-fn level
# --------------------------------------------------------------------------- #
def _world_snapshot(m, ct_capacity):
    cfg = m.DaemonConfig(ct_capacity=ct_capacity, auto_regen=False,
                         flowlog_mode="none")
    eng = m.Engine(cfg, datapath=m.FakeDatapath(cfg))
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
    eng.apply_policy([{
        "endpointSelector": {"matchLabels": {"app": "web"}},
        "egress": [{"toCIDR": ["10.0.0.0/8"]}],
    }])
    eng.regenerate()
    snap = eng.active.snapshot
    eng.stop()
    return snap


def _raw_steps(m, snap, n_shards, capacity):
    """The steered and the device-RSS step of ``m``'s mesh on ``snap``,
    each as ``step(batch, now) → (out, counters)`` in numpy, each on its
    own CT; and ``tables()`` → both CTs as global numpy tables."""
    mesh = m.mesh
    if m.side == "jax":
        import jax.numpy as jnp
        from cilium_tpu.compile.ct_layout import CTConfig, make_ct_arrays
        jm = mesh.make_mesh(n_shards, 1)
        ct_host = make_ct_arrays(CTConfig(capacity, 8))
        mesh.shard_ct_arrays(ct_host, n_shards)
        tn = {k: jnp.asarray(v) for k, v in snap.tensors().items()}
        fns = {"steer": mesh.make_sharded_classify_fn(jm, donate_ct=False),
               "dev": mesh.make_unsteered_classify_fn(jm, donate_ct=False)}
        cts = {k: {a: jnp.asarray(v) for a, v in ct_host.items()}
               for k in fns}

        def step(name, b, now):
            out, cts[name], ctr = fns[name](
                tn, cts[name], {k: jnp.asarray(v) for k, v in b.items()},
                jnp.uint32(now), jnp.int32(snap.world_index))
            return ({k: np.asarray(v) for k, v in out.items()},
                    {k: np.asarray(v) for k, v in ctr.items()})

        def tables():
            return {k: {a: np.asarray(v) for a, v in c.items()}
                    for k, c in cts.items()}
    else:
        from cilium_tpu_torch.compile.ct_layout import (CTConfig,
                                                        make_ct_arrays)
        from cilium_tpu_torch.convert import to_numpy
        tm = mesh.make_mesh(n_shards, 1, device="cpu")
        ct_host = {k: v.numpy().view(np.uint32) for k, v in make_ct_arrays(
            CTConfig(capacity, 8), device="cpu").items()}
        placed = mesh.place_mesh_tensors(snap.tensors(), tm)
        fns = {"steer": mesh.make_sharded_classify_fn(tm, donate_ct=False),
               "dev": mesh.make_unsteered_classify_fn(tm, donate_ct=False)}
        cts = {k: mesh.split_ct(ct_host, tm) for k in fns}

        def step(name, b, now):
            out, cts[name], ctr = fns[name](
                placed, cts[name], {k: v.copy() for k, v in b.items()},
                now, snap.world_index)
            return to_numpy(out), to_numpy(ctr)

        def tables():
            return {k: mesh.join_ct(c) for k, c in cts.items()}
    return step, tables


class TestExchangeBitIdentity:
    def test_saturating_flood_ct_full_and_evict_order_identical(self):
        """Under a flood that saturates the per-shard CT tables, the
        exchange path must produce the SAME CT_FULL fail-closed verdicts,
        the SAME eviction counters, and byte-identical CT tables."""
        @both
        def _(m):
            snap = _world_snapshot(m, ct_capacity=128)
            slot_of = snap.ep_slot_of
            n_shards = 4
            step, tables = _raw_steps(m, snap, n_shards, 128)
            rows = 128
            tot_full = 0
            seen = []
            for i in range(6):             # 6*128 rows >> 128 CT slots
                rng = np.random.default_rng(i)
                recs = [m.pkt("192.168.1.10",
                              f"10.{rng.integers(0, 200)}."
                              f"{rng.integers(0, 250)}"
                              f".{rng.integers(1, 250)}",
                              int(1024 + rng.integers(0, 60000)), 443)
                        for _ in range(rows)]
                b = m.batch_from_records(recs, slot_of, pad_to=rows)
                now = 1000 + i
                sb, scatter, _per = m.mesh.steer_batch(b, n_shards,
                                                       round_to_pow2=True)
                out_s, ctr_s = step("steer", sb, now)
                out_s = m.mesh.unsteer_outputs(out_s, scatter)
                out_d, ctr_d = step("dev", b, now)
                v = np.asarray(b["valid"], dtype=bool)
                # the exchange step builds no ``est_fp`` column: the
                # reference's columns
                for k in out_d:
                    np.testing.assert_array_equal(
                        out_s[k][v], out_d[k][v],
                        err_msg=f"batch {i} out[{k}] diverged")
                for k in ctr_s:
                    np.testing.assert_array_equal(
                        ctr_s[k], ctr_d[k],
                        err_msg=f"batch {i} counter {k} diverged")
                tot_full += int(out_d["ct_full"][v].sum())
                seen.append(({k: out_d[k][v].astype(np.int64).tolist()
                              for k in sorted(out_d)},
                             {k: np.asarray(c).astype(np.int64).tolist()
                              for k, c in sorted(ctr_d.items())}))
            ct = tables()
            for k in ct["steer"]:
                np.testing.assert_array_equal(
                    ct["steer"][k], ct["dev"][k],
                    err_msg=f"CT table {k} diverged (evict order)")
            assert tot_full > 0, "flood never saturated — the pin is vacuous"
            return seen, tot_full, sorted(
                (k, v.astype(np.uint32).tobytes())
                for k, v in ct["dev"].items())


# --------------------------------------------------------------------------- #
# Integration: the device-RSS engine behind the pipeline
# --------------------------------------------------------------------------- #
class TestDeviceRSSEngine:
    def test_device_parity_vs_steered_and_oracle(self):
        """The same submission stream through the host-steered 4-shard
        mesh and the device-RSS 4-shard mesh is bit-identical, and both
        match the oracle-backed serial path, CT continuity included."""
        @both
        def _(m):
            C = m.C
            serial = m.fake_serial_engine()
            host = m.jit_pipeline_engine(4)
            dev = m.jit_pipeline_engine(4, rss_mode="device")
            slot_of = serial.active.snapshot.ep_slot_of
            try:
                assert dev.datapath.rss_state == {
                    "mode": "device", "shards": 4, "active": True}
                assert dev.datapath.pipeline_shards == 1
                ch1 = m._mk_phase(slot_of, 5, (1, 5, 17, 9, 23), seed=21)
                m._run_phase(serial, [host, dev], ch1, now0=1000)
                est = [m.pkt("192.168.1.10", "10.0.2.7", 48200 + i, 443)
                       for i in range(4)]
                m._run_phase(serial, [host, dev],
                             [m.batch_from_records(est, slot_of)],
                             now0=1200)
                reply = [m.pkt("10.0.2.7", "192.168.1.10", 443, 48200 + i,
                               flags=C.TCP_ACK, direction=C.DIR_INGRESS)
                         for i in range(4)]
                outs = m._run_phase(
                    serial, [host, dev],
                    [m.batch_from_records(reply, slot_of, pad_to=6)],
                    now0=1210)
                assert (np.asarray(outs[0]["status"])[:4]
                        == int(C.CTStatus.REPLY)).all()
                live = serial.ct_stats(now=1500)["live"]
                assert host.ct_stats(now=1500)["live"] == live
                assert dev.ct_stats(now=1500)["live"] == live
                ps = dev.pipeline_stats()
                assert ps["n_shards"] == 1 and ps["mesh_shards"] == 4
                assert ps["rss_mode"] == "device"
                assert ps["shed_total"] == 0
                assert dev.datapath.pack_stats["pack_fallback_steered"] == 0
                assert dev.datapath.pack_stats["pack_inplace"] > 0
                return (m.seen, live, ct_bytes(host), ct_bytes(dev),
                        dev.datapath.rss_state)
            finally:
                for e in (serial, host, dev):
                    e.stop()

    def test_sync_classify_pads_arbitrary_row_counts(self):
        """Control-plane entries arrive at arbitrary sizes: the device
        path pads to an equal pow2 per-chip slice and truncates on
        finalize — verdicts match the oracle."""
        @both
        def _(m):
            serial = m.fake_serial_engine()
            dev = m.jit_pipeline_engine(4, rss_mode="device")
            slot_of = serial.active.snapshot.ep_slot_of
            try:
                odd = m.batch_from_records(
                    [m.pkt("192.168.1.10", f"10.1.9.{i + 1}", 51000 + i, 443)
                     for i in range(5)], slot_of)
                o1 = serial.classify(dict(odd), now=1600)
                o2 = dev.classify(dict(odd), now=1600)
                assert o2["allow"].shape[0] == 5
                keys = ("allow", "reason", "status", "remote_identity")
                for k in keys:
                    np.testing.assert_array_equal(o1[k], o2[k], err_msg=k)
                return {k: np.asarray(o2[k]).tolist() for k in keys}
            finally:
                serial.stop()
                dev.stop()

    def test_skewed_and_alternating_arrivals_no_shed(self):
        """Every valid row hashing to ONE CT shard, and a strict
        alternating two-shard pattern: through the device path nothing
        sheds and verdicts match the bounded oracle bit-for-bit."""
        @both
        def _(m):
            serial = m.fake_serial_engine()
            dev = m.jit_pipeline_engine(4, rss_mode="device")
            slot_of = serial.active.snapshot.ep_slot_of
            n_shards = 4
            try:
                by_shard = {s: [] for s in range(n_shards)}
                rng = np.random.default_rng(5)
                while min(len(v) for v in by_shard.values()) < 24:
                    recs = [m.pkt("192.168.1.10",
                                  f"10.{rng.integers(0, 2)}.2."
                                  f"{rng.integers(1, 250)}",
                                  int(42000 + rng.integers(0, 20000)), 443)
                            for _ in range(64)]
                    b = m.batch_from_records(recs, slot_of)
                    sh = m.mesh.flow_shard_of(b, n_shards)
                    for i, s in enumerate(sh):
                        by_shard[int(s)].append(recs[i])
                chunks = [m.batch_from_records(by_shard[0][:24], slot_of),
                          m.batch_from_records(by_shard[0][24:48]
                                               or by_shard[0][:24], slot_of)]
                alt = [r for pair in zip(by_shard[1][:16], by_shard[2][:16])
                       for r in pair]
                chunks.append(m.batch_from_records(alt, slot_of))
                m._run_phase(serial, [dev], chunks, now0=3000)
                ps = dev.pipeline_stats()
                assert ps["shed_total"] == 0
                assert "steer_overflow" not in ps["shed_reasons"]
                return m.seen, ps["shed_total"], ps["shed_reasons"]
            finally:
                serial.stop()
                dev.stop()

    def test_cfg6_form_storm_matches_bounded_oracle(self):
        """A cfg6-form randomized-source SYN/junk storm through the
        device path: no shed class fires and every verdict matches the
        bounded oracle bit-for-bit."""
        @both
        def _(m):
            C = m.C
            serial = m.fake_serial_engine()
            dev = m.jit_pipeline_engine(4, rss_mode="device")
            slot_of = serial.active.snapshot.ep_slot_of
            rng = np.random.default_rng(17)
            try:
                chunks = []
                for c in range(6):
                    recs = []
                    for r in range(48):
                        proto = int(rng.choice(
                            [C.PROTO_TCP, C.PROTO_TCP, C.PROTO_UDP]))
                        recs.append(m.pkt(
                            "192.168.1.10",
                            f"10.{rng.integers(0, 2)}."
                            f"{rng.integers(0, 250)}"
                            f".{rng.integers(1, 250)}",
                            int(1024 + rng.integers(0, 60000)),
                            int(rng.choice([443, 80, 53, 22])), proto=proto,
                            flags=C.TCP_SYN if proto == C.PROTO_TCP else 0))
                    chunks.append(m.batch_from_records(
                        recs, slot_of, pad_to=48 + (c % 3)))
                m._run_phase(serial, [dev], chunks, now0=4000)
                ps = dev.pipeline_stats()
                assert ps["shed_total"] == 0 and ps["admission_drops"] == 0
                return m.seen, ct_bytes(dev)
            finally:
                serial.stop()
                dev.stop()

    def test_regen_between_stage_and_dispatch_plain_stamp_check(self):
        """With device RSS active, a policy regen landing between
        stage-write and dispatch must NOT trip the re-steer logic — the
        fence degrades to the plain revision stamp check, and the batch
        classifies correctly under the NEW snapshot."""
        @both
        def _(m):
            C = m.C
            dev = m.jit_pipeline_engine(4, rss_mode="device",
                                        pipeline_flush_ms=250.0)
            slot_of = dev.active.snapshot.ep_slot_of
            try:
                b = m.batch_from_records(
                    [m.pkt("192.168.1.10", "10.1.77.1", 45001, 443)],
                    slot_of)
                t = dev.submit(dict(b), now=5000)
                dev.apply_policy([{
                    "endpointSelector": {"matchLabels": {"app": "web"}},
                    "egressDeny": [{"toCIDR": ["10.1.77.0/24"]}],
                }])
                dev.regenerate()
                assert dev.drain(timeout=60)
                out = t.result(timeout=10)
                assert not out["allow"][0]
                assert out["reason"][0] == int(C.DropReason.POLICY_DENY)
                assert dev.datapath.pack_stats["pack_fallback_steered"] == 0
                return (bool(out["allow"][0]), int(out["reason"][0]),
                        dev.datapath.pack_stats["pack_fallback_steered"])
            finally:
                dev.stop()

    def test_ledger_and_gauge_surfaces(self):
        """The exchange buffers register in the resource ledger (+ the
        HBM ledger's ``exchange`` group), the unsteered staging ring keeps
        its ring row, and the steer-balance gauges / steer_overflow shed
        class are ABSENT from the export rather than frozen at zero."""
        @both
        def _(m):
            dev = m.jit_pipeline_engine(4, rss_mode="device")
            slot_of = dev.active.snapshot.ep_slot_of
            try:
                t = dev.submit(m.batch_from_records(
                    [m.pkt("192.168.1.10", "10.0.2.3", 40000, 443)],
                    slot_of), now=100)
                assert dev.drain(timeout=30)
                t.result(timeout=5)
                dev.resource_step()
                rep = dev.resources()
                assert "rss_exchange" in rep["resources"]
                assert "staging_ring" in rep["resources"]
                assert "staging_segment_peak" not in rep["resources"]
                ex = dev.datapath.rss_exchange_stats()
                assert ex["in_use"] > 0 and ex["capacity"] >= ex["peak"] > 0
                assert dev.datapath.hbm_ledger()["groups"]["exchange"] > 0
                text = dev.render_metrics()
                assert "ciliumtpu_pipeline_mesh_shards 4" in text
                assert 'pipeline_staged_rows{shard=' not in text
                assert "steer_overflow" not in text
                h = dev.health()
                assert h["pipeline"]["shards"] == 4
                assert h["pipeline"]["rss_mode"] == "device"
                rss = m.module("runtime.api").status_doc(dev)["rss"]
                assert rss["mode"] == "device"
                # the byte sizes are each package's own (its dtypes and
                # buffer layout); the row's shape and the surfaces are not
                row = rep["resources"]["rss_exchange"]
                return (sorted(row), sorted(ex), sorted(
                    k for k, v in dev.datapath.hbm_ledger()["groups"].items()
                    if v > 0), h["pipeline"]["shards"],
                    h["pipeline"]["rss_mode"], rss)
            finally:
                dev.stop()

    def test_audit_clean_at_sampling_one(self):
        """The shadow-oracle auditor at sampling 1.0 over the device
        path: every finalized batch replays clean against the oracle."""
        @both
        def _(m):
            dev = m.jit_pipeline_engine(4, rss_mode="device",
                                        audit_enabled=True,
                                        audit_sample_rate=1.0)
            slot_of = dev.active.snapshot.ep_slot_of
            try:
                chunks = m._mk_phase(slot_of, 4, (7, 13, 5, 22), seed=31)
                for i, ch in enumerate(chunks):
                    dev.submit(dict(ch), now=6000 + i)
                assert dev.drain(timeout=60)
                dev.audit_step()
                st = dev.auditor.stats()
                assert st["checked_rows"] > 0
                assert st["mismatched_rows"] == 0, \
                    list(dev.auditor.mismatches)
                assert st["replay_errors"] == 0
                return (st["checked_rows"], st["mismatched_rows"],
                        st["replay_errors"])
            finally:
                dev.stop()

    def test_min_bucket_clamped_to_mesh(self):
        """Buckets must divide the mesh's flow axis: an engine configured
        with a min bucket below the shard count clamps it up."""
        @both
        def _(m):
            dev = m.jit_pipeline_engine(8, rss_mode="device",
                                        pipeline_min_bucket=1)
            slot_of = dev.active.snapshot.ep_slot_of
            try:
                t = dev.submit(m.batch_from_records(
                    [m.pkt("192.168.1.10", "10.0.2.3", 40001, 443)],
                    slot_of), now=100)
                assert dev.drain(timeout=30)
                assert t.result(timeout=5)["allow"].shape[0] == 1
                assert dev._pipeline.min_bucket >= 8
                return dev._pipeline.min_bucket
            finally:
                dev.stop()


class TestPipelineRSSValidation:
    def test_device_mode_refuses_sharded_staging(self):
        @both
        def _(m):
            with pytest.raises(ValueError, match="rss_mode='device'") as e:
                m.Pipeline(lambda b, n: (lambda: {}), n_shards=4,
                           shard_fn=lambda b: np.zeros(1),
                           rss_mode="device")
            return type(e.value).__name__, str(e.value)

    def test_bad_rss_mode_rejected(self):
        @both
        def _(m):
            with pytest.raises(ValueError, match="bad rss_mode") as e1:
                m.Pipeline(lambda b, n: (lambda: {}), rss_mode="bogus")
            with pytest.raises(ValueError, match="bad rss_mode") as e2:
                m.DaemonConfig(rss_mode="bogus")
            return [(type(e.value).__name__, str(e.value))
                    for e in (e1, e2)]


# --------------------------------------------------------------------------- #
# Slow soak: 10k skewed rows through the device mesh
# --------------------------------------------------------------------------- #
@pytest.mark.slow
class TestDeviceRSSSoak:
    def test_soak_10k_skewed_device(self):
        """10k rows whose flows ALL hash to one CT shard through the
        device-RSS 4-shard mesh: every submission resolves, nothing
        sheds, the guard never restarts."""
        @both
        def _(m):
            dev = m.jit_pipeline_engine(4, rss_mode="device", batch_size=256,
                                        ct_capacity=1 << 15,
                                        pipeline_queue_batches=256,
                                        pipeline_flush_ms=0.5)
            slot_of = dev.active.snapshot.ep_slot_of
            try:
                pool = []
                rng = np.random.default_rng(77)
                while len(pool) < 2048:
                    recs = [m.pkt("192.168.1.10",
                                  f"10.{rng.integers(0, 2)}."
                                  f"{rng.integers(0, 250)}."
                                  f"{rng.integers(1, 250)}",
                                  int(1024 + rng.integers(0, 60000)), 443)
                            for _ in range(256)]
                    b = m.batch_from_records(recs, slot_of)
                    sh = m.mesh.flow_shard_of(b, 4)
                    pool.extend(r for r, s in zip(recs, sh) if s == 0)
                tickets = []
                n_rows = 0
                i = 0
                while n_rows < 10_000:
                    take = pool[(i * 64) % len(pool):][:64] or pool[:64]
                    tickets.append(dev.submit(
                        m.batch_from_records(take, slot_of), now=7000 + i))
                    n_rows += len(take)
                    i += 1
                assert dev.drain(timeout=300)
                for t in tickets:
                    t.result(timeout=10)
                ps = dev.pipeline_stats()
                assert ps["shed_total"] == 0
                assert ps["restarts"] == 0
                assert ps["state"] == "ok"
                assert dev.datapath.pack_stats["pack_fallback_steered"] == 0
                return n_rows, len(tickets), ct_bytes(dev)
            finally:
                dev.stop()


# --------------------------------------------------------------------------- #
# Degraded survivor geometry under device-side RSS
# --------------------------------------------------------------------------- #
class TestDeviceRSSDegradedMesh:
    @pytest.mark.slow
    def test_device_rss_n_minus_1_parity_and_audit_clean(self):
        """Both rss modes shrink 4 -> 3 BEFORE any traffic; the degraded
        device-RSS mesh must stay bit-identical to the degraded
        host-steered mesh and to the oracle-backed serial path, with the
        shadow auditor at sampling 1.0 clean on the device engine."""
        @both
        def _(m):
            C = m.C
            m.FAULTS.reset()
            serial = m.fake_serial_engine()
            host = m.jit_pipeline_engine(4)
            dev = m.jit_pipeline_engine(4, rss_mode="device",
                                        audit_enabled=True,
                                        audit_sample_rate=1.0,
                                        audit_pool_batches=64)
            dev.auditor.configure(sample_rate=1.0)
            slot_of = serial.active.snapshot.ep_slot_of
            try:
                for eng in (host, dev):
                    eng.datapath.note_device_loss(2, reason="drill")
                    doc = eng.remesh_step()
                    assert doc["remesh"]["to"] == 3
                assert dev.datapath.rss_state["shards"] == 3
                assert dev.datapath.pipeline_shards == 1
                assert host.datapath.pipeline_shards == 3
                ch1 = m._mk_phase(slot_of, 4, (1, 5, 17, 9), seed=91)
                m._run_phase(serial, [host, dev], ch1, now0=3000)
                est = [m.pkt("192.168.1.10", "10.0.2.7", 49500 + i, 443)
                       for i in range(4)]
                m._run_phase(serial, [host, dev],
                             [m.batch_from_records(est, slot_of)],
                             now0=3200)
                reply = [m.pkt("10.0.2.7", "192.168.1.10", 443, 49500 + i,
                               flags=C.TCP_ACK, direction=C.DIR_INGRESS)
                         for i in range(4)]
                outs = m._run_phase(
                    serial, [host, dev],
                    [m.batch_from_records(reply, slot_of, pad_to=6)],
                    now0=3210)
                assert (np.asarray(outs[0]["status"])[:4]
                        == int(C.CTStatus.REPLY)).all()
                live = serial.ct_stats(now=4000)["live"]
                assert host.ct_stats(now=4000)["live"] == live
                assert dev.ct_stats(now=4000)["live"] == live
                for _ in range(100):
                    step = dev.audit_step(budget=128)
                    if not step or (not step.get("replayed")
                                    and not step.get("pending")):
                        break
                st = dev.auditor.stats()
                assert st["checked_rows"] > 0
                assert st["mismatched_rows"] == 0
                return (m.seen, live, ct_bytes(host), ct_bytes(dev),
                        st["checked_rows"])
            finally:
                for eng in (serial, host, dev):
                    eng.stop()
