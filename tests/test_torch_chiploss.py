"""The port's device-loss path against the JAX package's on the CPU, case
for case with ``tests/test_chiploss.py``.

Each reference case runs its own body on each package (``P("jax")``,
``P("torch")``: the JAX engine on ``JITDatapath`` over the 8 virtual CPU
devices, the port's on a meshed ``TorchDatapath`` over ``cpu`` devices),
asserts the reference's expectations on both, and holds a side-neutral
observation equal (``both``): each classifier verdict, the fingerprint
bits and hits, the archive's arrays as bytes and its prune set, the
re-mesh documents (``took_s`` and the stamp ``t`` left out), every
ticket's columns, the CT's live entries, the snapshot-age gauge and the
health status. The reference's ``slow`` cases keep ``slow``.

Beyond the mirrors: the CUDA runtime's signatures of a lost card, and the
re-mesh cycle held against the JAX package's on the same batches (a
4-shard engine of each package loses ordinal 2, re-meshes to a width-3
mesh with its CT salvaged from the device, from the archive floor or
cold, serves degraded batches and heals back to 4; every out column, the
remesh counts and the CT arrays equal at every step).
"""

import functools
import os
import time
import zipfile

import numpy as np
import pytest

from cilium_tpu.utils import constants as C
from cilium_tpu_torch.runtime.datapath import dead_device_of
from tests.test_torch_datapath import (SIDES, assert_ct_equal,
                                       assert_outs_equal, copy, mods)
from tests.test_torch_sharded_pipeline import P as SP
from tests.test_torch_sharded_pipeline import _world


@pytest.fixture(autouse=True)
def _clean_faults():
    for side in SIDES:
        mods(side).faults.FAULTS.reset()
    yield
    for side in SIDES:
        mods(side).faults.FAULTS.reset()


def P(side):
    """The sharded-pipeline mirror's namespace of ``side`` plus the names
    ``test_chiploss.py`` imports and its ``_mk``/``_replies``."""
    m = SP(side)
    guard = m.module("pipeline.guard")
    m.DeviceLost, m.PipelineError = guard.DeviceLost, guard.PipelineError
    m.ckpt = m.module("runtime.checkpoint")
    m.dead_device_of = m.module("runtime.datapath").dead_device_of
    m.FaultInjected = m.module("runtime.faults").FaultInjected
    m.EstablishedFingerprints = m.module(
        "shim.feeder").EstablishedFingerprints
    m._mk = functools.partial(_mk, m)
    m._replies = functools.partial(_replies, m)
    return m


def both(case):
    obs = {s: case(P(s)) for s in SIDES}
    assert obs["jax"] == obs["torch"]
    return obs["torch"]


def _mk(m, slot_of, n, start, dst_octet=2):
    recs = [m.pkt("192.168.1.10", f"10.0.{dst_octet}.{(i % 200) + 1}",
                  52000 + start + i, 443) for i in range(n)]
    return m.batch_from_records(recs, slot_of)


def _replies(m, slot_of, n, start, dst_octet=2):
    recs = [m.pkt(f"10.0.{dst_octet}.{(i % 200) + 1}", "192.168.1.10",
                  443, 52000 + start + i, flags=m.C.TCP_ACK,
                  direction=m.C.DIR_INGRESS) for i in range(n)]
    return m.batch_from_records(recs, slot_of)


def remesh_doc(doc):
    """A re-mesh document without its wall-clock stamps (``took_s``,
    ``t``)."""
    if not isinstance(doc, dict):
        return doc
    return {k: v for k, v in doc.items() if k not in ("took_s", "t")}


def live_entries(eng):
    return int((eng.ct_arrays()["expiry"] > 0).sum())


def cols(out):
    return {k: np.asarray(out[k]).tolist()
            for k in ("allow", "reason", "status")}


# --------------------------------------------------------------------------- #
# dead-device classifier
# --------------------------------------------------------------------------- #
class TestDeadDeviceClassifier:
    def test_attributed_signature(self):
        @both
        def _(m):
            e = RuntimeError("DEVICE_UNAVAILABLE: chip fell off ici dev=3")
            assert m.dead_device_of(e) == 3
            return m.dead_device_of(e)

    def test_unattributed_signature(self):
        @both
        def _(m):
            got = m.dead_device_of(RuntimeError("hardware failure"))
            assert got == -1
            return got

    def test_drill_signature(self):
        @both
        def _(m):
            got = m.dead_device_of(
                m.FaultInjected("injected fault at device.fail: dev=1"))
            assert got == 1
            return got

    def test_transient_is_none(self):
        @both
        def _(m):
            got = m.dead_device_of(ValueError("bad batch geometry"))
            assert got is None
            return got

    def test_mention_of_devices_is_not_a_loss(self):
        # case-sensitive literal tokens only: a user exception that
        # merely talks about devices must stay breaker territory
        @both
        def _(m):
            got = m.dead_device_of(
                RuntimeError("all devices are fine, dev=2 ok"))
            assert got is None
            return got

    @pytest.mark.parametrize("text", [
        "uncorrectable ECC error encountered",
        "CUDA-capable device(s) is/are busy or unavailable",
        "unspecified launch failure",
        "uncorrectable NVLink error detected during the execution",
    ])
    def test_cuda_signatures_of_a_lost_card(self, text):
        """The CUDA runtime's own strings for a lost card, as torch raises
        them (``CUDA error: <cudaGetErrorString>``): a loss, unattributed
        unless the text names an ordinal; the same words in another case
        are not."""
        assert dead_device_of(RuntimeError(f"CUDA error: {text}")) == -1
        assert dead_device_of(RuntimeError(f"CUDA error: {text} dev=2")) == 2
        assert dead_device_of(RuntimeError(text.upper())) is None



# --------------------------------------------------------------------------- #
# the shared established-fingerprint filter
# --------------------------------------------------------------------------- #
class TestEstablishedFingerprints:
    @staticmethod
    def _buf(n):
        b = {k: np.zeros((n,), np.int32)
             for k in ("sport", "dport", "proto", "direction")}
        b["src"] = np.zeros((n, 4), np.uint32)
        b["dst"] = np.zeros((n, 4), np.uint32)
        b["valid"] = np.ones((n,), bool)
        b["src"][:, 3] = 0xC0A8010A
        b["dst"][:, 3] = 0x0A000200 + np.arange(n)
        b["sport"][:] = 40000 + np.arange(n)
        b["dport"][:] = 443
        b["proto"][:] = 6
        return b

    @staticmethod
    def _bits(fp):
        """The filter's stamp table as bytes."""
        return fp._tab.tobytes()

    def test_only_allowed_established_rows_stamp(self):
        @both
        def _(m):
            C = m.C
            fp = m.EstablishedFingerprints(slots=1 << 12)
            b = self._buf(4)
            out = {"allow": np.array([True, True, False, True]),
                   "status": np.array([int(C.CTStatus.ESTABLISHED),
                                       int(C.CTStatus.NEW),
                                       int(C.CTStatus.ESTABLISHED),
                                       int(C.CTStatus.REPLY)], np.int32)}
            fp.note(b, out)
            hits = fp.hits(b)
            assert hits.tolist() == [True, False, False, True]
            return hits.tolist(), self._bits(fp)

    def test_unknown_flow_never_hits(self):
        @both
        def _(m):
            fp = m.EstablishedFingerprints(slots=1 << 12)
            hits = fp.hits(self._buf(8))
            assert not hits.any()
            return hits.tolist(), self._bits(fp)

    def test_note_never_raises(self):
        @both
        def _(m):
            fp = m.EstablishedFingerprints(slots=1 << 12)
            fp.note({}, {})                 # missing columns: swallowed
            return self._bits(fp)

    def test_slots_must_be_pow2(self):
        @both
        def _(m):
            with pytest.raises(ValueError) as e:
                m.EstablishedFingerprints(slots=48)
            return type(e.value).__name__, str(e.value)


# --------------------------------------------------------------------------- #
# CT archive helpers
# --------------------------------------------------------------------------- #
class TestCTArchive:
    @staticmethod
    def _arrays(m, cap=64, live=5):
        if m.side == "jax":
            from cilium_tpu.compile.ct_layout import CTConfig, make_ct_arrays
            a = make_ct_arrays(CTConfig(capacity=cap))
        else:
            from cilium_tpu_torch.runtime.datapath import _empty_ct_np
            a = _empty_ct_np(cap)
        a["expiry"][:live] = 10_000 + np.arange(live)
        return a

    def test_roundtrip_and_prune(self, tmp_path):
        @both
        def _(m):
            ckpt = m.ckpt
            d = str(tmp_path / m.side)
            os.makedirs(d)
            assert ckpt.newest_ct_archive(d) is None
            assert ckpt.ct_archive_age_s(d) is None
            paths = [ckpt.save_ct_archive(d, self._arrays(m, live=i + 1),
                                          keep=2)
                     for i in range(3)]
            kept = ckpt.list_ct_archives(d)
            assert len(kept) == 2                      # pruned to keep
            assert ckpt.newest_ct_archive(d) == paths[-1]
            got = ckpt.load_ct_archive(paths[-1])
            assert got is not None
            assert int((got["expiry"] > 0).sum()) == 3
            assert "__ct_format__" not in got          # normalized out
            assert ckpt.ct_archive_age_s(d) >= 0.0
            return ([paths.index(p) for p in kept],
                    sorted((k, np.asarray(v).dtype.str,
                            np.asarray(v).tobytes())
                           for k, v in got.items()))

    def test_corrupt_archive_loads_as_none(self, tmp_path):
        @both
        def _(m):
            ckpt = m.ckpt
            d = str(tmp_path / m.side)
            os.makedirs(d)
            p = ckpt.save_ct_archive(d, self._arrays(m), keep=2)
            with open(p, "wb") as f:
                f.write(b"not a zip at all")
            first = ckpt.load_ct_archive(p)
            assert first is None
            with zipfile.ZipFile(p, "w") as z:
                z.writestr("garbage.npy", b"xx")
            second = ckpt.load_ct_archive(p)
            assert second is None
            return first, second


# --------------------------------------------------------------------------- #
# the engine protocol: loss -> fenced shrink -> degraded -> heal
# --------------------------------------------------------------------------- #
def _wait_device_lost(eng):
    deadline = time.monotonic() + 30
    while (eng.pipeline_stats() or {}).get("state") != "device-lost" \
            and time.monotonic() < deadline:
        time.sleep(0.02)


class TestEngineRemesh:
    @pytest.mark.slow
    def test_loss_remesh_degraded_then_heal(self):
        @both
        def _(m):
            C, FAULTS = m.C, m.FAULTS
            eng = m.jit_pipeline_engine(4, remesh_heal_hysteresis_s=0.0)
            slot_of = eng.active.snapshot.ep_slot_of
            try:
                t = eng.submit(m._mk(slot_of, 32, 0))
                assert eng.drain(timeout=30)
                assert int(np.asarray(t.result(5)["allow"]).sum()) == 32
                rev0 = eng.active.revision

                FAULTS.arm("device.fail", mode="fail", message="dev=1")
                trip = eng.submit(m._mk(slot_of, 16, 1000))
                _wait_device_lost(eng)
                assert eng.pipeline_stats()["state"] == "device-lost"
                queued = eng.submit(m._mk(slot_of, 8, 2000))

                doc = eng.remesh_step()
                assert doc["remesh"]["from"] == 4
                assert doc["remesh"]["to"] == 3
                assert doc["remesh"]["reason"] == "device-loss"
                shrink = remesh_doc(doc["remesh"])
                assert eng.drain(timeout=30)
                with pytest.raises(m.PipelineError):
                    trip.result(timeout=5)
                q = queued.result(5)
                assert int(np.asarray(q["allow"]).sum()) == 8
                assert eng.active.revision > rev0

                h = eng.health()
                assert h["state"] == C.HEALTH_DEGRADED
                assert h["devices"]["detail"] == C.DEVICE_LOST
                assert h["devices"]["dead"] == [1]
                width = eng._res_datapath()["mesh_width"]
                assert width[0] == 4 and width[1] == 3
                assert width[2] == pytest.approx(0.25)
                mh = eng.datapath.mesh_health()
                assert mh["live_ordinals"] == [0, 2, 3]
                assert mh["devices"][1]["state"] == "dead"
                t2 = eng.submit(m._mk(slot_of, 16, 3000))
                assert eng.drain(timeout=30)
                o2 = t2.result(5)
                assert int(np.asarray(o2["allow"]).sum()) == 16

                FAULTS.disarm("device.fail")
                doc = eng.remesh_step()
                assert doc["remesh"]["from"] == 3
                assert doc["remesh"]["to"] == 4
                assert doc["remesh"]["reason"] == "heal"
                heal = remesh_doc(doc["remesh"])
                assert eng.drain(timeout=30)
                t3 = eng.submit(m._mk(slot_of, 16, 4000))
                assert eng.drain(timeout=30)
                o3 = t3.result(5)
                assert int(np.asarray(o3["allow"]).sum()) == 16
                assert eng.health()["state"] == C.HEALTH_OK

                ctr = eng.metrics.counters
                assert ctr['device_loss_total{device="1"}'] == 1
                assert ctr['datapath_remesh_total{from="4",to="3"}'] == 1
                assert ctr['datapath_remesh_total{from="3",to="4"}'] == 1
                assert ctr["pipeline_remesh_total"] == 2
                assert ctr.get("pipeline_canary_ok_total", 0) >= 2
                bb = eng.blackbox.stats()
                assert bb["frozen"]
                assert bb["frozen_reason"].startswith("device-loss")
                # submissions carry no ``now``: CT stamps and the grace
                # window's remaining seconds are wall-clock readings
                devices = {k: v for k, v in h["devices"].items()
                           if k != "salvage_grace_remaining_s"}
                return (shrink, heal, cols(q), cols(o2), cols(o3),
                        h["state"], devices, list(width),
                        mh["live_ordinals"], live_entries(eng))
            finally:
                eng.stop()

    @pytest.mark.slow
    def test_grace_window_covers_lost_shard_then_expires(self):
        @both
        def _(m):
            C, FAULTS = m.C, m.FAULTS
            eng = m.jit_pipeline_engine(4, remesh_heal_hysteresis_s=0.0,
                                        remesh_grace_s=60.0)
            slot_of = eng.active.snapshot.ep_slot_of
            n = 64
            try:
                eng.submit(m._mk(slot_of, n, 0))
                assert eng.drain(timeout=30)
                t = eng.submit(m._replies(slot_of, n, 0))
                assert eng.drain(timeout=30)
                out = t.result(5)
                assert int(np.asarray(out["allow"]).sum()) == n
                assert (np.asarray(out["status"])[:n]
                        == int(C.CTStatus.REPLY)).all()

                FAULTS.arm("device.fail", mode="fail", message="dev=1")
                try:
                    eng.submit(m._mk(slot_of, 4, 9000)).result(timeout=30)
                except m.PipelineError:
                    pass
                _wait_device_lost(eng)
                doc = eng.remesh_step()
                assert doc["remesh"]["to"] == 3
                lost = doc["remesh"]["ct_lost"]
                assert lost > 0
                assert eng.drain(timeout=30)

                t = eng.submit(m._replies(slot_of, n, 0))
                assert eng.drain(timeout=30)
                inside = int(np.asarray(t.result(5)["allow"]).sum())
                assert inside == n
                hits = eng.metrics.counters.get(
                    "ct_salvage_grace_hits_total", 0)
                assert hits > 0
                assert eng.remesh_status()["salvage_grace_remaining_s"] > 0

                eng._salvage_until = 0.0
                t = eng.submit(m._replies(slot_of, n, 0))
                assert eng.drain(timeout=30)
                allowed = int(np.asarray(t.result(5)["allow"]).sum())
                assert allowed < n
                assert allowed >= n - lost
                assert eng.remesh_status()[
                    "salvage_grace_remaining_s"] == 0.0

                eng.submit(m._mk(slot_of, n, 0))
                assert eng.drain(timeout=30)
                t = eng.submit(m._replies(slot_of, n, 0))
                assert eng.drain(timeout=30)
                final = int(np.asarray(t.result(5)["allow"]).sum())
                assert final == n
                return (remesh_doc(doc["remesh"]), inside, hits, allowed,
                        final, live_entries(eng))
            finally:
                eng.stop()

    @pytest.mark.slow
    def test_heal_hysteresis_defers_and_flap_resets(self):
        @both
        def _(m):
            FAULTS = m.FAULTS
            eng = m.jit_pipeline_engine(4, remesh_heal_hysteresis_s=600.0)
            slot_of = eng.active.snapshot.ep_slot_of
            try:
                eng.submit(m._mk(slot_of, 8, 0))
                assert eng.drain(timeout=30)
                FAULTS.arm("device.fail", mode="fail", message="dev=2")
                try:
                    eng.submit(m._mk(slot_of, 4, 500)).result(timeout=30)
                except m.PipelineError:
                    pass
                _wait_device_lost(eng)
                assert eng.remesh_step()["remesh"]["to"] == 3
                assert eng.drain(timeout=30)
                FAULTS.disarm("device.fail")
                doc = eng.remesh_step()
                assert doc["remesh"] is None
                assert doc["heal_ok_s"] >= 0
                assert eng.datapath.mesh_health()["live"] == 3
                eng._on_device_loss(2, "flap drill")
                assert eng._heal_ok_since is None
                return (doc["remesh"], eng.datapath.mesh_health()["live"],
                        eng._heal_ok_since)
            finally:
                eng.stop()

    def test_no_survivors_refuses_remesh(self):
        @both
        def _(m):
            eng = m.jit_pipeline_engine(2)
            try:
                for o in (0, 1):
                    eng.datapath.note_device_loss(o, reason="drill")
                doc = eng.remesh_step()
                assert doc["remesh"] == "no-survivors"
                assert eng.datapath.mesh_health()["live"] == 2
                return doc["remesh"], eng.datapath.mesh_health()["live"]
            finally:
                eng.stop()

    def test_remesh_disabled_is_inert(self):
        @both
        def _(m):
            eng = m.jit_pipeline_engine(2, remesh_enabled=False)
            try:
                eng.datapath.note_device_loss(1, reason="drill")
                doc = eng.remesh_step()
                assert doc is None
                return doc
            finally:
                eng.stop()


def _classify_engine(side, tmp_path, **kw):
    """A 4-shard engine of one package, classify only (no pipeline)."""
    m = mods(side)
    cfg = dict(n_shards=4, ct_capacity=2048, auto_regen=False,
               flowlog_mode="none", remesh_heal_hysteresis_s=0.0,
               ct_snapshot_dir=str(tmp_path / side), **kw)
    if side == "torch":
        cfg["device"] = "cpu"
    cfg = m.config.DaemonConfig(**cfg)
    dp = (m.datapath.TorchDatapath if side == "torch"
          else m.datapath.JITDatapath)(cfg)
    eng = m.engine.Engine(cfg, datapath=dp)
    _world(eng)
    return eng


@pytest.mark.parametrize("source", ["device", "archive", "cold"])
def test_remesh_cycle_equals_jax(source, tmp_path):
    """Loss of ordinal 2 → width 3 (CT 3 · 2^9, the non-power-of-two
    table) → degraded batches → heal to 4, on both packages: the remesh
    counts (salvaged + lost + dropped = the gathered table's live
    entries), every out column and the CT arrays equal at every step."""
    ref = P("jax")
    engines = [_classify_engine(s, tmp_path) for s in SIDES]
    slot_of = engines[0].active.snapshot.ep_slot_of
    now = [1000]

    def step(batch):
        now[0] += 1
        outs = [e.classify(copy(batch), now=now[0]) for e in engines]
        assert_outs_equal(*outs, f"now {now[0]}")
        assert_ct_equal(engines[0].ct_arrays(), engines[1].ct_arrays(),
                        f"now {now[0]}")
        return outs[1]

    try:
        for i in range(3):
            step(_mk(ref, slot_of, 64, 100 * i))
        if source == "archive":
            for e in engines:
                assert e.ct_snapshot_step()["entries"] > 0
        live0 = int((engines[1].ct_arrays()["expiry"] > 0).sum())
        for i in range(2):                 # newer flows the archive misses
            step(_mk(ref, slot_of, 64, 5000 + 100 * i, dst_octet=3))
        gathered = int((engines[1].ct_arrays()["expiry"] > 0).sum())
        docs = []
        for side, e in zip(SIDES, engines):
            if source != "device":
                mods(side).faults.FAULTS.arm("device.collective",
                                             mode="fail")
            e.datapath.note_device_loss(2, reason="drill")
            docs.append(e.remesh_step()["remesh"])
            mods(side).faults.FAULTS.reset()
        dj, dt = docs
        assert dt["salvage_source"] == dj["salvage_source"] == source
        for k in ("from", "to", "live_ordinals", "ct_capacity",
                  "ct_salvaged", "ct_lost", "ct_dropped"):
            assert dt[k] == dj[k], k
        assert dt["to"] == 3 and dt["ct_capacity"] == 3 * 512
        if source == "device":
            assert dt["ct_lost"] > 0
            assert dt["ct_salvaged"] + dt["ct_lost"] + dt["ct_dropped"] \
                == gathered
        elif source == "archive":
            assert dt["ct_salvaged"] + dt["ct_dropped"] == live0
        else:
            assert dt["ct_salvaged"] == 0
        assert_ct_equal(engines[0].ct_arrays(), engines[1].ct_arrays(),
                        "salvaged")
        assert engines[1].ct_stats(0)["capacity"] == 3 * 512
        for i in range(3):
            out = step(_replies(ref, slot_of, 64, 100 * i))
        assert (out["status"] == int(C.CTStatus.REPLY)).any() \
            == (source != "cold")
        for i in range(2):
            step(_mk(ref, slot_of, 64, 7000 + 100 * i, dst_octet=4))
        docs = [e.remesh_step()["remesh"] for e in engines]
        assert docs[0]["to"] == docs[1]["to"] == 4
        assert docs[0]["ct_salvaged"] == docs[1]["ct_salvaged"]
        assert engines[1].ct_stats(0)["capacity"] == 2048
        for i in range(2):
            step(_replies(ref, slot_of, 64, 7000 + 100 * i, dst_octet=4))
        assert engines[1].datapath.remesh_stats == \
            engines[0].datapath.remesh_stats
    finally:
        for e in engines:
            e.stop()


# --------------------------------------------------------------------------- #
# the ct-snapshot controller tick + the archive as salvage floor
# --------------------------------------------------------------------------- #
class TestCTSnapshotController:
    def test_snapshot_age_gauge_and_stale_health(self, tmp_path):
        @both
        def _(m):
            C = m.C
            eng = m.jit_pipeline_engine(
                2, ct_snapshot_dir=str(tmp_path / m.side),
                checkpoint_max_age_s=300.0)
            slot_of = eng.active.snapshot.ep_slot_of
            try:
                h = eng.health()
                assert h["state"] == C.HEALTH_DEGRADED
                assert h["checkpoint"]["detail"] == C.CHECKPOINT_STALE
                seen = [(h["state"], h["checkpoint"]["detail"],
                         eng.metrics.gauges.get("checkpoint_age_seconds"))]
                eng.submit(m._mk(slot_of, 16, 0))
                assert eng.drain(timeout=30)
                doc = eng.ct_snapshot_step()
                assert doc["entries"] == 16
                assert eng.metrics.gauges["checkpoint_age_seconds"] >= 0.0
                assert eng.health()["state"] == C.HEALTH_OK
                seen.append((doc["entries"], eng.health()["state"]))
                old = time.time() - 10_000
                os.utime(doc["path"], (old, old))
                h = eng.health()
                assert h["state"] == C.HEALTH_DEGRADED
                assert h["checkpoint"]["detail"] == C.CHECKPOINT_STALE
                assert h["checkpoint"]["age_s"] > 300.0
                seen.append((h["state"], h["checkpoint"]["detail"]))
                return seen
            finally:
                eng.stop()

    def test_collective_fault_fails_tick_but_keeps_gauge(self, tmp_path):
        @both
        def _(m):
            eng = m.jit_pipeline_engine(
                2, ct_snapshot_dir=str(tmp_path / m.side))
            try:
                m.FAULTS.arm("device.collective", mode="fail")
                with pytest.raises(m.FaultInjected):
                    eng.ct_snapshot_step()
                gauge = eng.metrics.gauges["checkpoint_age_seconds"]
                assert gauge == -1.0
                return gauge
            finally:
                eng.stop()

    @pytest.mark.slow
    def test_archive_is_the_salvage_floor_when_gather_dies(self, tmp_path):
        @both
        def _(m):
            C, FAULTS = m.C, m.FAULTS
            eng = m.jit_pipeline_engine(
                4, remesh_heal_hysteresis_s=0.0,
                ct_snapshot_dir=str(tmp_path / m.side))
            slot_of = eng.active.snapshot.ep_slot_of
            try:
                eng.submit(m._mk(slot_of, 32, 0))
                assert eng.drain(timeout=30)
                assert eng.ct_snapshot_step()["entries"] == 32
                FAULTS.arm("device.collective", mode="fail")
                eng.datapath.note_device_loss(1, reason="drill")
                doc = eng.remesh_step()
                assert doc["remesh"]["salvage_source"] == "archive"
                assert doc["remesh"]["ct_salvaged"] > 0
                assert eng.datapath.remesh_stats[
                    "remesh_gather_failures"] == 1
                FAULTS.disarm("device.collective")
                t = eng.submit(m._replies(slot_of, 32, 0))
                assert eng.drain(timeout=30)
                out = t.result(5)
                n_reply = int((np.asarray(out["status"])
                               == int(C.CTStatus.REPLY)).sum())
                assert n_reply > 0
                return remesh_doc(doc["remesh"]), n_reply, cols(out)
            finally:
                eng.stop()
