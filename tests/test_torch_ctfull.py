"""CT exhaustion (insert-when-full) of the port against the JAX package's,
case for case with ``test_ctfull.py``.

The contract: a new allowed flow whose probe window holds no free slot
tail-evicts the window's soonest-expiring evictable entry (all but
established TCP), ties to the earliest probe offset, contested victims to
the lowest packet index; slots the batch probe-hit are protected; a flow
that still finds no slot fails closed with ``DropReason.CT_FULL``.

Each case runs the reference's scenario on each package (the JAX side as
its own tests run it: ``jax.numpy`` kernels, ``JITDatapath`` on the CPU,
its Pallas kernels in interpret mode, or ``FakeDatapath``; the port on
``TorchDatapath`` with ``device="cpu"``, where each kernel wrapper runs its
plain version, and on its own ``FakeDatapath``), asserts the reference's
expectations on both, and holds them equal, exactly: slots, fail and
eviction counts, the CT arrays (as ``uint32``), every out column,
counters, GC documents, oracle verdicts and audit counts.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from cilium_tpu.kernels.records import batch_from_records
from cilium_tpu.utils import constants as C
from cilium_tpu.utils.ip import parse_addr
from oracle import PacketRecord
from tests.test_torch_datapath import (assert_ct_equal, assert_engines_equal,
                                       assert_outs_equal, copy)

SIDES = ("jax", "torch")
PKG = {"jax": "cilium_tpu", "torch": "cilium_tpu_torch"}
ORACLE = {"jax": "oracle", "torch": "cilium_tpu_torch.oracle"}
OUT_KEYS = ("allow", "reason", "status", "ct_full", "remote_identity",
            "redirect")
CT_CAP = 256


def P(side):
    pkg = PKG[side]
    names = {"config": "runtime.config", "datapath": "runtime.datapath",
             "engine": "runtime.engine", "faults": "runtime.faults",
             "ct_layout": "compile.ct_layout", "ctk": "kernels.conntrack",
             "records": "kernels.records", "mapstate": "policy.mapstate",
             "repository": "policy.repository"}
    ns = {k: importlib.import_module(f"{pkg}.{v}") for k, v in names.items()}
    ns["oracle"] = importlib.import_module(f"{ORACLE[side]}.datapath")
    return SimpleNamespace(side=side, **ns)


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


def make_engine(m, dp="jit", fused="off", cap=CT_CAP, **kw):
    """``test_ctfull.py``'s ``make_engine`` on ``m``'s package: ``dp``
    "jit" is ``JITDatapath`` (``fused_kernels=fused``) on the JAX side and
    ``TorchDatapath`` on the port, "fake" each one's ``FakeDatapath``."""
    kw.update(ct_capacity=cap, auto_regen=False)
    if m.side == "torch":
        kw["device"] = "cpu"
    else:
        kw["fused_kernels"] = fused
    cfg = m.config.DaemonConfig(**kw)
    cls = (m.datapath.FakeDatapath if dp == "fake" else
           m.datapath.TorchDatapath if m.side == "torch" else
           m.datapath.JITDatapath)
    eng = m.engine.Engine(cfg, datapath=cls(cfg))
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
    eng.add_endpoint(["k8s:peer=p0", "k8s:group=g0"],
                     ips=("172.16.0.5",), ep_id=10)
    eng.apply_policy([{
        "endpointSelector": {"matchLabels": {"app": "web"}},
        "ingress": [{"fromEndpoints": [{"matchLabels": {"group": "g0"}}],
                     "toPorts": [{"ports": [
                         {"port": "80", "protocol": "TCP"}]}]}]}])
    eng.regenerate()
    return eng


def flows(slots, sports, flags=C.TCP_SYN, dport=80):
    s16, _ = parse_addr("172.16.0.5")
    d16, _ = parse_addr("192.168.1.10")
    return batch_from_records(
        [PacketRecord(s16, d16, sp, dport, C.PROTO_TCP, flags, False, 1,
                      C.DIR_INGRESS) for sp in sports], slots)


def outs_of(out):
    return {k: np.asarray(out[k]) for k in OUT_KEYS}


def assert_same(a, b, msg=""):
    for k in OUT_KEYS:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      f"{msg}:{k}")


# --------------------------------------------------------------------------- #
# predicate + kernel units
# --------------------------------------------------------------------------- #
class Kern:
    """One package's CT kernel calls on a host batch, in the reference's
    terms (``jax.numpy`` arrays on the JAX side, CPU tensors on the
    port)."""

    def __init__(self, m):
        self.m = m
        if m.side == "jax":
            import jax.numpy as jnp
            self.xp = jnp
        else:
            import torch
            self.xp = torch

    def arr(self, v, dtype=None):
        if self.m.side == "jax":
            return self.xp.asarray(v, dtype=dtype)
        import torch
        v = np.asarray(v)
        if v.dtype == np.uint32:
            v = v.view(np.int32)
        return torch.tensor(v)

    def table(self, cap, pd):
        ct = self.m.ct_layout.make_ct_arrays(
            self.m.ct_layout.CTConfig(cap, pd),
            **({"device": "cpu"} if self.m.side == "torch" else {}))
        return {k: self.arr(v) for k, v in ct.items()} \
            if self.m.side == "jax" else ct

    def batch(self, b):
        if self.m.side == "jax":
            return {k: self.xp.asarray(v) for k, v in b.items()}
        return self.m.records.batch_to_torch(b, "cpu")

    def keys(self, bt):
        if self.m.side == "jax":
            return self.m.ctk.ct_key_words_jnp(bt)
        return self.m.records.ct_key_words(bt)

    def now(self, t):
        return self.xp.uint32(t) if self.m.side == "jax" else t

    def insert(self, ct, keys, n, t, pd, **kw):
        want = self.arr(np.ones(n, bool))
        return self.m.ctk.ct_insert_new(ct, keys, want, self.now(t), pd,
                                        **kw)

    def apply(self, ct, bt, n, slot, nk, ncr, zm, t):
        return self.m.ctk.ct_apply(ct, bt, slot, self.arr(np.zeros(n, bool)),
                                   slot >= 0, self.now(t), new_keys=nk,
                                   new_created=ncr, zero_mask=zm)

    def mask(self, cap, at=()):
        v = np.zeros(cap, bool)
        v[list(at)] = True
        return self.arr(v)

    @staticmethod
    def np(v):
        v = np.asarray(v)
        return v.view(np.uint32) if v.dtype == np.int32 else v

    def ct_np(self, ct):
        return {k: self.np(v).copy() for k, v in ct.items()}


class TestEvictability:
    def test_established_tcp_protected_everything_else_fair_game(self):
        def case(m):
            k = Kern(m)
            protos = [C.PROTO_TCP] * 4 + [C.PROTO_UDP, C.PROTO_ICMP]
            flags = [0, C.CT_FLAG_SEEN_NON_SYN,
                     C.CT_FLAG_SEEN_NON_SYN | C.CT_FLAG_TX_CLOSING,
                     C.CT_FLAG_TX_CLOSING, C.CT_FLAG_SEEN_NON_SYN, 0]
            want = [True, False, True, True, True, True]
            got = np.asarray(m.ctk.ct_evictable(
                k.arr(protos), k.arr(np.asarray(flags, np.uint32)))).tolist()
            assert got == want
            host = [m.oracle._ct_expirable(p, f)
                    for p, f in zip(protos, flags)]
            assert host == want
            return got, host
        both(case)

    def test_insert_evicts_min_expiry_unprotected(self):
        def case(m):
            k = Kern(m)
            cap, pd = 8, 8
            ct = k.table(cap, pd)
            b0 = k.batch(flows({1: 0, 10: 1}, range(1000, 1012)))
            nk, ncr, zm, slot, fail, _ = k.insert(ct, k.keys(b0), 12, 100,
                                                  pd)
            ct = k.apply(ct, b0, 12, slot, nk, ncr, zm, 100)
            assert int((k.np(ct["expiry"]) > 100).sum()) == cap
            filled = k.ct_np(ct)
            exp = 200 + np.arange(cap, dtype=np.uint32) * 10
            ct = dict(ct)
            ct["expiry"] = k.arr(exp)
            one = k.batch(flows({1: 0, 10: 1}, [7777]))
            okeys = k.keys(one)
            seen = []
            for prot in (None, k.mask(cap, [0]), k.mask(cap, range(cap))):
                kw = {"evict": True}
                if prot is not None:
                    kw["protected"] = prot
                nk, ncr, zm, slot, fail, nev = k.insert(ct, okeys, 1, 150,
                                                        pd, **kw)
                seen.append((int(slot[0]), bool(k.np(fail)[0]), int(nev),
                             k.np(nk).tolist(), k.np(zm).tolist()))
            assert seen[0][:3] == (0, False, 1)
            assert seen[1][0] == 1 and seen[1][2] == 1
            assert seen[2][1] and seen[2][2] == 0
            return {k2: v.tolist() for k2, v in filled.items()}, seen
        both(case)

    def test_duplicates_adopt_evict_winner(self):
        def case(m):
            k = Kern(m)
            cap, pd = 8, 8
            ct = k.table(cap, pd)
            fj = k.batch(flows({1: 0, 10: 1}, range(2000, 2012)))
            nk, ncr, zm, slot, fail, _ = k.insert(ct, k.keys(fj), 12, 100,
                                                  pd)
            ct = k.apply(ct, fj, 12, slot, nk, ncr, zm, 100)
            dj = k.batch(flows({1: 0, 10: 1}, [9999, 9999, 9999]))
            nk, ncr, zm, slot, fail, nev = k.insert(ct, k.keys(dj), 3, 150,
                                                    pd, evict=True)
            s = k.np(slot)
            assert (s >= 0).all() and (s == s[0]).all()
            assert int(nev) == 1
            return s.tolist(), int(nev), k.np(nk).tolist(), \
                k.np(fail).tolist()
        both(case)


# --------------------------------------------------------------------------- #
# oracle bounded-table semantics
# --------------------------------------------------------------------------- #
def pkt(m, sport, flags=C.TCP_SYN):
    s16, _ = parse_addr("10.0.0.1")
    d16, _ = parse_addr("10.0.0.2")
    return m.oracle.PacketRecord(s16, d16, sport, 80, C.PROTO_TCP, flags)


def open_oracle(m, tab=None):
    """An oracle with one unenforced endpoint (ep 0): everything allows at
    the policy layer, so CT semantics are the only variable."""
    r = m.repository
    pol = r.EndpointPolicy(
        ep_id=0, identity_id=1, revision=1,
        egress=r.DirectionPolicy(False, m.mapstate.MapState()),
        ingress=r.DirectionPolicy(False, m.mapstate.MapState()))
    return m.oracle.Oracle({0: pol}, {}, ct=tab)


def verdict(v):
    return (bool(v.allow), int(v.drop_reason), int(v.ct_status),
            bool(v.ct_full))


def key(k):
    return None if k is None else repr(tuple(k))


class TestBoundedOracle:
    def test_create_fails_when_windows_full_of_established(self):
        def case(m):
            tab = m.oracle.ConntrackTable(capacity=4, probe_depth=4)
            keys = [key(tab.create(pkt(m, sp, flags=C.TCP_ACK), now=100))
                    for sp in range(100, 104)]
            assert None not in keys
            assert tab.create(pkt(m, 999), now=150) is None
            assert tab.insert_fail == 1
            return keys, tab.insert_fail, tab.evicted
        both(case)

    def test_create_evicts_soonest_expiring_syn(self):
        def case(m):
            tab = m.oracle.ConntrackTable(capacity=4, probe_depth=4)
            keys = [tab.create(pkt(m, sp), now=100 + i)
                    for i, sp in enumerate(range(200, 204))]
            assert all(k is not None for k in keys)
            assert tab.create(pkt(m, 888), now=150) is not None
            assert keys[0] not in tab.entries
            assert tab.evicted == 1
            return [key(k) for k in keys], sorted(map(key, tab.entries)), \
                tab.evicted
        both(case)

    def test_unbounded_default_never_fails(self):
        def case(m):
            tab = m.oracle.ConntrackTable()
            for sp in range(5000):
                assert tab.create(pkt(m, sp), now=100) is not None
            assert tab.insert_fail == 0
            return len(tab.entries), tab.insert_fail, tab.evicted
        both(case)

    def test_sequential_classify_emits_ct_full(self):
        def case(m):
            tab = m.oracle.ConntrackTable(capacity=4, probe_depth=4)
            oracle = open_oracle(m, tab)
            seen = []
            for sp in range(300, 304):
                v = oracle.classify(pkt(m, sp, flags=C.TCP_ACK), now=100)
                assert v.allow
                seen.append(verdict(v))
            v = oracle.classify(pkt(m, 777), now=150)
            assert not v.allow and not v.ct_status
            assert v.drop_reason == C.DropReason.CT_FULL and v.ct_full
            return seen + [verdict(v)]
        both(case)

    def test_replay_ct_full_only_excuses_demanded_creates(self):
        def case(m):
            oracle = open_oracle(m)
            p = pkt(m, 42)
            v, create = oracle.replay(p, C.CTStatus.NEW, ct_full=True)
            assert not v.allow and v.drop_reason == C.DropReason.CT_FULL
            assert not create
            v2, create2 = oracle.replay(p, C.CTStatus.ESTABLISHED,
                                        ct_full=True)
            assert v2.allow and v2.drop_reason == C.DropReason.OK
            return verdict(v), create, verdict(v2), create2
        both(case)


# --------------------------------------------------------------------------- #
# the bit-identity contract: the datapath against the bounded oracle
# --------------------------------------------------------------------------- #
def run_flood(eng_a, eng_b, label):
    """``test_ctfull.py``'s ``_run_flood``: an established population, four
    waves of distinct SYNs past the table's capacity, the population
    revisited. → every step's out columns and the counters."""
    slots = eng_a.active.snapshot.ep_slot_of
    now = 1000
    steps = []
    est = flows(slots, range(30000, 30016), flags=0x10)
    a, b = eng_a.classify(copy(est), now=now), eng_b.classify(copy(est),
                                                              now=now)
    assert_same(a, b, f"{label}:establish")
    steps.append(outs_of(a))
    for wave in range(4):
        now += 1
        fl = flows(slots, range(40000 + wave * CT_CAP,
                                40000 + (wave + 1) * CT_CAP))
        a, b = eng_a.classify(copy(fl), now=now), \
            eng_b.classify(copy(fl), now=now)
        assert_same(a, b, f"{label}:wave{wave}")
        steps.append(outs_of(a))
    now += 1
    a, b = eng_a.classify(copy(est), now=now), eng_b.classify(copy(est),
                                                              now=now)
    assert_same(a, b, f"{label}:revisit")
    steps.append(outs_of(a))
    v = np.asarray(est["valid"])
    assert (np.asarray(a["status"])[v] == int(C.CTStatus.ESTABLISHED)).all()
    assert bool(np.asarray(a["allow"])[v].all())
    assert eng_a.metrics.insert_fail == eng_b.metrics.insert_fail
    assert eng_a.metrics.ct_evicted == eng_b.metrics.ct_evicted
    assert eng_a.metrics.ct_evicted > 0
    rendered = eng_a.render_metrics()
    assert "ciliumtpu_ct_evicted_total" in rendered
    assert "ciliumtpu_ct_insert_fail_total" in rendered
    return steps, eng_a.metrics.insert_fail, eng_a.metrics.ct_evicted


def assert_steps_equal(want, got):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert_outs_equal(w, g, f"step{i}")


class TestSaturationParity:
    @pytest.mark.parametrize("fused", ["off", "on"], ids=[
        "jnp_vs_bounded_oracle_bit_identical_under_saturation",
        "fused_interpret_vs_bounded_oracle_under_saturation"])
    def test_datapath_vs_bounded_oracle(self, fused):
        """The reference's two cases: JAX's ``JITDatapath`` (its jnp core,
        then its Pallas kernels in interpret mode) against its bounded
        oracle, and the port's ``TorchDatapath`` against the port's; the
        two packages' steps and counters equal."""
        obs, engines = {}, {}
        for s in SIDES:
            m = P(s)
            a, b = make_engine(m, fused=fused), make_engine(m, dp="fake")
            try:
                obs[s] = run_flood(a, b, f"{s}:{fused}")
                engines[s] = a
            finally:
                b.stop()
        try:
            assert_steps_equal(obs["jax"][0], obs["torch"][0])
            assert obs["jax"][1:] == obs["torch"][1:]
            assert_engines_equal(engines["jax"], engines["torch"])
        finally:
            for e in engines.values():
                e.stop()

    def test_auditor_zero_mismatch_through_saturation(self):
        def case(m):
            eng = make_engine(m)
            eng.auditor.configure(sample_rate=1.0)
            try:
                slots = eng.active.snapshot.ep_slot_of
                now = 1000
                eng.classify(flows(slots, range(30000, 30016), flags=0x10),
                             now=now)
                for wave in range(4):
                    now += 1
                    eng.classify(flows(slots,
                                       range(41000 + wave * CT_CAP,
                                             41000 + (wave + 1) * CT_CAP)),
                                 now=now)
                    eng.audit_step(budget=16)
                for _ in range(50):
                    step = eng.audit_step(budget=64)
                    if not step or not (step.get("replayed")
                                        or step.get("pending")):
                        break
                st = eng.auditor.stats()
                assert st["checked_rows"] > 0
                assert st["mismatched_rows"] == 0
                assert eng.metrics.insert_fail > 0
                return (st["checked_rows"], st["checked_batches"],
                        eng.metrics.insert_fail, eng.metrics.ct_evicted)
            finally:
                eng.stop()
        both(case)


# --------------------------------------------------------------------------- #
# emergency GC
# --------------------------------------------------------------------------- #
class TestEmergencyGC:
    def test_hysteresis_latch_and_ttl_slash(self):
        def case(m):
            eng = make_engine(m, ct_gc_chunk_rows=64,
                              ct_gc_emergency_chunks=4,
                              ct_gc_emergency_ttl_slash_s=55,
                              ct_pressure_high=0.7, ct_pressure_low=0.3)
            try:
                slots = eng.active.snapshot.ep_slot_of
                now = 1000
                out = eng.classify(flows(slots, range(50000, 50224)),
                                   now=now)
                docs = [eng.sweep_step(now=now), eng.sweep_step(now=now)]
                occ = eng.metrics.gauges["ct_occupancy"]
                assert occ >= 0.7
                assert eng._ct_emergency
                assert eng.metrics.gauges["ct_emergency_gc"] == 1
                for _ in range(6):
                    now += 2
                    docs.append(eng.sweep_step(now=now))
                    assert docs[-1]["emergency"] in (True, False)
                assert eng.metrics.gauges["ct_occupancy"] <= 0.3
                assert not eng._ct_emergency
                assert eng.metrics.gauges["ct_emergency_gc"] == 0
                assert eng.metrics.counters.get(
                    "ct_emergency_sweeps_total", 0) > 0
                kinds = [e["kind"] for e in eng.blackbox._events]
                assert kinds.count("ct-emergency") >= 2
                assert eng.blackbox.stats()["frozen"] is False
                events = [(e["kind"], e.get("action"))
                          for e in eng.blackbox._events
                          if e["kind"] == "ct-emergency"]
                return (outs_of(out), docs, occ,
                        eng.metrics.counters["ct_emergency_sweeps_total"],
                        events, {k: v.tolist()
                                 for k, v in eng.ct_arrays().items()})
            finally:
                eng.stop()
        obs = {s: case(P(s)) for s in SIDES}
        assert_outs_equal(obs["jax"][0], obs["torch"][0])
        assert obs["jax"][1:] == obs["torch"][1:]

    def test_emergency_spares_established_flows(self):
        def case(m):
            eng = make_engine(m, ct_gc_chunk_rows=256,
                              ct_gc_emergency_ttl_slash_s=55,
                              ct_pressure_high=0.5, ct_pressure_low=0.1)
            try:
                slots = eng.active.snapshot.ep_slot_of
                est = flows(slots, range(60000, 60032), flags=0x10)
                eng.classify(copy(est), now=1000)
                eng.classify(flows(slots, range(61000, 61160)), now=1001)
                docs = [eng.sweep_step(now=1002 + 2 * i) for i in range(4)]
                assert eng._ct_emergency
                out = eng.classify(copy(est), now=1010)
                v = np.asarray(est["valid"])
                assert (np.asarray(out["status"])[v]
                        == int(C.CTStatus.ESTABLISHED)).all()
                return outs_of(out), docs, eng.ct_arrays()
            finally:
                eng.stop()
        (oj, dj, cj), (ot, dt, ct) = (case(P(s)) for s in SIDES)
        assert_outs_equal(oj, ot)
        assert dj == dt
        assert_ct_equal(cj, ct)


# --------------------------------------------------------------------------- #
# the slow flood soak
# --------------------------------------------------------------------------- #
@pytest.mark.slow
class TestFloodSoak:
    def test_soak_saturated_table_audited_with_ct_insert_faults(self):
        """Pipelined flood submissions saturate a small CT with
        ``ct.insert`` faults armed (the same seed on both packages) and the
        auditor at 1.0: zero mismatches, evictions and CT_FULL fails, every
        submission resolves, the established population classifies
        ESTABLISHED on both, with the same verdicts."""
        def case(m):
            eng = make_engine(m, cap=512)
            eng.auditor.configure(sample_rate=1.0)
            m.faults.FAULTS.arm("ct.insert", mode="prob", prob=0.02, seed=11)
            try:
                slots = eng.active.snapshot.ep_slot_of
                now = 1000
                est = flows(slots, range(30000, 30032), flags=0x10)
                eng.submit(copy(est), now=now).result(timeout=120)
                rng = np.random.default_rng(3)
                tickets = []
                for i in range(3000):
                    if i % 8 == 0:
                        now += 1
                    sports = rng.integers(32768, 65535, 48)
                    try:
                        tickets.append(eng.submit(
                            flows(slots, sports.tolist()), now=now))
                    except Exception:
                        pass
                    if i % 64 == 0:
                        eng.audit_step(budget=32)
                    if i % 256 == 0:
                        eng.sweep_step(now=now)
                assert eng.drain(timeout=300)
                resolved = failed = 0
                for t in tickets:
                    try:
                        t.result(timeout=30)
                        resolved += 1
                    except Exception:
                        failed += 1
                assert resolved + failed == len(tickets) and resolved > 0
                for _ in range(200):
                    step = eng.audit_step(budget=128)
                    if not step or not (step.get("replayed")
                                        or step.get("pending")):
                        break
                st = eng.auditor.stats()
                assert st["checked_rows"] > 0
                assert st["mismatched_rows"] == 0
                assert eng.metrics.ct_evicted > 0
                assert eng.metrics.insert_fail > 0
                out = eng.submit(copy(est), now=now + 1).result(timeout=120)
                v = np.asarray(est["valid"])
                assert (np.asarray(out["status"])[v]
                        == int(C.CTStatus.ESTABLISHED)).all()
                return outs_of(out)
            finally:
                m.faults.FAULTS.reset()
                eng.stop()
        oj, ot = (case(P(s)) for s in SIDES)
        assert_outs_equal(oj, ot)
