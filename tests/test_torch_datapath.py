"""``TorchDatapath`` against ``JITDatapath`` on the CPU, through the same
engine API calls on seeded inputs.

Each side is built from its own package (``cilium_tpu`` with
``fused_kernels="off"``; ``cilium_tpu_torch`` with ``device="cpu"``, so the
plain torch versions of the kernels), from the same rule documents,
endpoints and services, and is fed copies of the same numpy batches. The
tolerance is exact equality: every out column (dtype included), every
counter, the patch and pack statistics, and the seven CT arrays.

Covered: place → classify with LB, v6 and L7 worlds; the FIFO contract of
``classify_async``; ``place_patch`` (the in-place delta equals a full
place, ``patch_stats`` over a warm churn, the ``StalePlacement`` fence and
the engine's retry, the scatter-failure self-heal, ``delta_patch=False``);
the sticky wire flags; the chunked GC (``sweep_step``) against the whole
sweep; CT tables carried across the two backends both ways; the mesh
geometries (flow, rule and both shardings, device RSS) on one seeded
batch; and the configurations ``TorchDatapath`` refuses.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cilium_tpu.kernels.records import batch_from_records
from cilium_tpu.utils import constants as C
from cilium_tpu.utils.ip import parse_addr
from oracle import PacketRecord

SIDES = ("jax", "torch")
PKG = {"jax": "cilium_tpu", "torch": "cilium_tpu_torch"}
N_PEERS = 6


def mods(side):
    """The engine-level modules of one side's package."""
    pkg = PKG[side]
    names = {"config": "runtime.config", "datapath": "runtime.datapath",
             "engine": "runtime.engine", "faults": "runtime.faults",
             "services": "model.services"}
    return SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{v}")
                              for k, v in names.items()})


def make_config(side, fused="off", **kw):
    kw.setdefault("ct_capacity", 2048)
    kw.setdefault("auto_regen", False)
    if side == "torch":
        kw.setdefault("device", "cpu")
    else:
        kw["fused_kernels"] = fused
    return mods(side).config.DaemonConfig(**kw)


def make_datapath(side, cfg):
    dp = mods(side).datapath
    return (dp.TorchDatapath if side == "torch" else dp.JITDatapath)(cfg)


def bare_engine(side, fused="off", **kw):
    cfg = make_config(side, fused=fused, **kw)
    return mods(side).engine.Engine(cfg, datapath=make_datapath(side, cfg))


# --------------------------------------------------------------------------- #
# worlds, declared once over one side's engine
# --------------------------------------------------------------------------- #
WEB_INGRESS = {
    "endpointSelector": {"matchLabels": {"app": "web"}},
    "ingress": [{"fromEndpoints": [{"matchLabels": {"group": "g0"}}],
                 "toPorts": [{"ports": [{"port": "80",
                                         "protocol": "TCP"}]}]}]}


def peer_rule_docs(i, port=80, deny=False, label=None):
    """One labeled per-peer rule document (labels make replace_policy
    toggles work — the storm's add/remove primitive)."""
    key = "ingressDeny" if deny else "ingress"
    block = {"fromEndpoints": [{"matchLabels": {"peer": f"p{i}"}}]}
    if not deny:
        block["toPorts"] = [{"ports": [{"port": str(port),
                                        "protocol": "TCP"}]}]
    return [{"endpointSelector": {"matchLabels": {"app": "web"}},
             "labels": [label or f"k8s:storm=r{i}-{port}-{int(deny)}"],
             key: [block]}]


def storm_world(eng, n_peers=N_PEERS):
    """A web endpoint, ``n_peers`` peers in two groups, one group rule."""
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
    for i in range(n_peers):
        eng.add_endpoint([f"k8s:peer=p{i}", f"k8s:group=g{i % 2}"],
                         ips=(f"172.16.{i}.5",), ep_id=10 + i)
    eng.apply_policy([WEB_INGRESS])
    eng.regenerate()
    return eng


def storm_engine(side, fused="off", **kw):
    return storm_world(bare_engine(side, fused=fused, **kw))


def warm_geometry(*engines, ports=(443, 8080)):
    """Split every peer's identity class and every port boundary once, so
    later churn rides the pure delta path."""
    for i in range(N_PEERS):
        for p in ports:
            for e in engines:
                label = f"k8s:warm=w{i}-{p}"
                e.replace_policy([label], peer_rule_docs(i, p, label=label))
                e.regenerate()


def rich_world(eng, kind):
    """The storm world plus the surface ``kind`` exercises: ``lb`` a
    service with two frontends (Maglev backends), ``v6`` v6 endpoints and
    a v6 CIDR rule, ``l7`` an HTTP rule set."""
    svc = mods("torch" if type(eng).__module__.startswith(
        "cilium_tpu_torch") else "jax").services
    storm_world(eng)
    if kind == "lb":
        eng.apply_policy([{
            "endpointSelector": {"matchLabels": {"app": "web"}},
            "egress": [{"toCIDR": ["10.7.0.0/16"],
                        "toPorts": [{"ports": [{"port": "443",
                                                "protocol": "TCP"}]}]}]}])
        eng.upsert_service(svc.Service(
            name="api", namespace="prod",
            frontends=(svc.Frontend("172.30.0.1", 443, C.PROTO_TCP),),
            lb_backends=(svc.Backend("10.7.0.1", 443),
                         svc.Backend("10.7.0.2", 443),
                         svc.Backend("10.7.0.3", 443))))
        eng.upsert_service(svc.Service(
            name="db", namespace="prod",
            frontends=(svc.Frontend("172.30.0.2", 5432, C.PROTO_TCP),),
            lb_backends=(svc.Backend("10.7.1.1", 5432),)))
    elif kind == "v6":
        eng.add_endpoint(["k8s:app=web6"], ips=("fd00::10",), ep_id=2)
        for i in range(3):
            eng.add_endpoint([f"k8s:peer=v{i}", "k8s:group=g0"],
                             ips=(f"fd00:1::{i + 5}",), ep_id=20 + i)
        eng.apply_policy([{
            "endpointSelector": {"matchLabels": {"app": "web6"}},
            "ingress": [{"fromEndpoints": [
                {"matchLabels": {"group": "g0"}}]}],
            "egress": [{"toCIDR": ["fd00:2::/32"]}]}])
    elif kind == "l7":
        eng.add_endpoint(["k8s:role=fe"], ips=("192.168.1.30",), ep_id=3)
        eng.apply_policy([{
            "endpointSelector": {"matchLabels": {"app": "web"}},
            "ingress": [{"fromEndpoints": [{"matchLabels": {"role": "fe"}}],
                         "toPorts": [{
                             "ports": [{"port": "8080", "protocol": "TCP"}],
                             "rules": {"http": [
                                 {"method": "GET", "path": "/api"},
                                 {"method": "POST", "path": "/upload"}]}}]}]}])
    eng.regenerate()
    return eng


def rec(src, dst, sp, dp, flags=C.TCP_SYN, ep_id=1,
        direction=C.DIR_INGRESS, method=C.HTTP_METHOD_ANY, path=b""):
    s16, sv6 = parse_addr(src)
    d16, dv6 = parse_addr(dst)
    return PacketRecord(s16, d16, sp, dp, C.PROTO_TCP, flags, sv6 or dv6,
                        ep_id, direction, method, path)


def world_traffic(kind, slots, rng, n=64):
    """Seeded packets for a ``rich_world`` of ``kind``: new and repeated
    flows, both directions, with replies to earlier flows."""
    recs = []
    for i in range(n):
        sp = 30000 + int(rng.integers(0, 24))
        flags = int(rng.choice([C.TCP_SYN, C.TCP_ACK, C.TCP_ACK | C.TCP_FIN]))
        peer = int(rng.integers(0, N_PEERS))
        dport = int(rng.choice([80, 443, 8080]))
        r = int(rng.integers(0, 4))
        if kind == "lb" and r < 2:
            vip, vport = (("172.30.0.1", 443), ("172.30.0.2", 5432))[r]
            recs.append(rec("192.168.1.10", vip, sp, vport, flags,
                            direction=C.DIR_EGRESS))
        elif kind == "lb" and r == 2:
            recs.append(rec(f"10.7.0.{1 + i % 3}", "192.168.1.10", 443, sp,
                            C.TCP_SYN | C.TCP_ACK))
        elif kind == "v6" and r < 2:
            recs.append(rec(f"fd00:1::{5 + i % 3}", "fd00::10", sp, dport,
                            flags, ep_id=2))
        elif kind == "v6" and r == 2:
            recs.append(rec("fd00::10", f"fd00:2::{1 + i % 7}", sp, 443,
                            flags, ep_id=2, direction=C.DIR_EGRESS))
        elif kind == "l7" and r < 2:
            method, path = ((0, b"/api"), (1, b"/upload"),
                            (0, b"/admin"))[i % 3]
            recs.append(rec("192.168.1.30", "192.168.1.10", sp, 8080, flags,
                            method=method, path=path))
        else:
            recs.append(rec(f"172.16.{peer}.5", "192.168.1.10", sp, dport,
                            flags))
    return batch_from_records(recs, slots)


def traffic(slots, n_peers=N_PEERS, flags=C.TCP_SYN, sport0=30000):
    """Every peer to the web endpoint on ports 80, 443 and 8080."""
    recs = [rec(f"172.16.{i}.5", "192.168.1.10", sport0 + i, dp, flags)
            for i in range(n_peers) for dp in (80, 443, 8080)]
    return batch_from_records(recs, slots)


def copy(b):
    return {k: v.copy() for k, v in b.items()}


# --------------------------------------------------------------------------- #
# equality
# --------------------------------------------------------------------------- #
#: the port's own out column: the classify step's flow fingerprints, which
#: the engine's CT-salvage note stamps (the reference hashes them on the
#: host, and its step returns none)
PORT_OUT = ("est_fp",)
#: the port's own counter: the salvage note's stamped rows by where their
#: fingerprints came from
PORT_COUNTERS = ("ct_salvage_fp_rows_total",)
#: the port's own pack counters (rows that carry a request, v6 rows, the
#: unique paths of each L7 dictionary) and ledger group (the device copy
#: of the L7 path dictionary)
PORT_PACK_STATS = ("l7_rows", "v6_rows", "l7_dict_paths")
PORT_GROUPS = ("l7_dict",)


def reference_keys(d, port):
    """``d`` without the port's own keys ``port``."""
    return {k: v for k, v in d.items() if k not in port}


def reference_columns(out):
    """``out`` without the port's own columns (``PORT_OUT``)."""
    return {k: v for k, v in out.items() if k not in PORT_OUT}


def assert_outs_equal(want, got, msg=""):
    """Every column equal, dtype included. The port's own columns are
    compared where both sides have them; against a side without them (the
    reference's) the others are."""
    if any((k in want) != (k in got) for k in PORT_OUT):
        want, got = reference_columns(want), reference_columns(got)
    assert set(want) == set(got), (msg, sorted(set(want) ^ set(got)))
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert w.dtype == g.dtype, (msg, k, w.dtype, g.dtype)
        np.testing.assert_array_equal(w, g, f"{msg}:{k}")


def assert_ct_equal(want, got, msg=""):
    assert sorted(want) == sorted(got), msg
    for k in want:
        assert got[k].dtype == np.uint32, (msg, k, got[k].dtype)
        np.testing.assert_array_equal(want[k], got[k], f"{msg}:ct.{k}")


def assert_engines_equal(ej, et, msg=""):
    """CT arrays and every metric counter of two engines."""
    assert_ct_equal(ej.ct_arrays(), et.ct_arrays(), msg)
    mj, mt = ej.metrics, et.metrics
    np.testing.assert_array_equal(mj.by_reason_dir, mt.by_reason_dir, msg)
    for k in ("insert_fail", "ct_evicted", "packets_total", "batches_total"):
        assert getattr(mj, k) == getattr(mt, k), (msg, k)
    # each package's classify memo is process-global: its eviction count
    # depends on what else ran in this process; the port's own counters
    # have no reference
    cj, ct = ({k: v for k, v in m.counters.items()
               if not k.startswith(("classify_fn_cache", *PORT_COUNTERS))}
              for m in (mj, mt))
    assert cj == ct, msg


def per_side(fn, *args, **kw):
    return [fn(side, *args, **kw) for side in SIDES]


# --------------------------------------------------------------------------- #
# place → classify
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["lb", "v6", "l7"])
def test_place_then_classify_equals_jax(kind):
    ej, et = (rich_world(bare_engine(s), kind) for s in SIDES)
    slots = ej.active.snapshot.ep_slot_of
    assert slots == et.active.snapshot.ep_slot_of
    rng = np.random.default_rng(7)
    for step in range(4):
        b = world_traffic(kind, slots, rng)
        now = 1000 + 3 * step
        assert_outs_equal(ej.classify(copy(b), now=now),
                          et.classify(copy(b), now=now), f"{kind}{step}")
    assert_engines_equal(ej, et, kind)
    assert ej.datapath.pack_stats == reference_keys(
        et.datapath.pack_stats, PORT_PACK_STATS)
    if kind == "lb":
        assert ej.active.snapshot.lb.n_frontends == 2
    assert ej.datapath.hbm_ledger()["groups"] == reference_keys(
        et.datapath.hbm_ledger()["groups"], PORT_GROUPS)
    assert ej.ct_stats(now=1020) == et.ct_stats(now=1020)
    for e in (ej, et):
        e.stop()


def test_classify_async_is_fifo_over_interleaved_batches():
    """Four batches enqueued before any finalizes, finalized in reverse
    order: each equals the serial JAX engine's result for its batch (the
    CT advances in enqueue order, not finalize order)."""
    ej, et = (rich_world(bare_engine(s), "l7") for s in SIDES)
    slots = ej.active.snapshot.ep_slot_of
    rng = np.random.default_rng(11)
    batches = [world_traffic("l7", slots, rng, n=32) for _ in range(4)]
    want = [ej.classify(copy(b), now=500 + i) for i, b in enumerate(batches)]
    dp, act = et.datapath, et.active
    fins = [dp.classify_async(act.tensors, act.snapshot, copy(b), 500 + i)
            for i, b in enumerate(batches)]
    got = [None] * 4
    for i in reversed(range(4)):
        got[i] = fins[i]()[0]
    for i in range(4):
        assert_outs_equal(want[i], got[i], f"batch{i}")
    assert_ct_equal(ej.ct_arrays(), et.ct_arrays())
    assert dp.wire_pool_stats()["in_flight"] == 0


# --------------------------------------------------------------------------- #
# place_patch
# --------------------------------------------------------------------------- #
def test_delta_patched_image_equals_full_place():
    eng = storm_engine("torch")
    warm_geometry(eng)
    for step in range(6):
        label = f"k8s:warm=w{step % N_PEERS}-443"
        eng.replace_policy([label], None if step % 2 else peer_rule_docs(
            step % N_PEERS, 443, label=label))
        eng.regenerate()
    assert eng.datapath.patch_stats["patch_delta"] >= 3
    fresh = eng.datapath.place(eng.active.snapshot)
    for k in fresh:
        assert torch.equal(eng.active.tensors[k], fresh[k]), k


def test_patch_stats_equal_jax_over_warm_churn():
    ej, et = per_side(storm_engine)
    warm_geometry(ej, et)
    now = 1000
    for step in range(10):
        i, p = step % N_PEERS, (443, 8080)[step % 2]
        label = f"k8s:warm=w{i}-{p}"
        body = None if step % 3 == 2 else peer_rule_docs(i, p, label=label)
        for e in (ej, et):
            e.replace_policy([label], body)
            e.regenerate()
        b = traffic(ej.active.snapshot.ep_slot_of)
        assert_outs_equal(ej.classify(copy(b), now=now),
                          et.classify(copy(b), now=now), f"step{step}")
        assert ej.datapath.patch_stats == et.datapath.patch_stats, step
        now += 10
    assert et.datapath.patch_stats["patch_delta"] >= 5
    assert_engines_equal(ej, et)


def test_stale_placement_fence_and_engine_retry(monkeypatch):
    dp_mod = mods("torch").datapath
    eng = storm_engine("torch")
    warm_geometry(eng)
    eng.replace_policy(["k8s:warm=w0-443"],
                       peer_rule_docs(0, 443, label="k8s:warm=w0-443"))
    eng.regenerate()
    old = eng.active
    before = eng.datapath.patch_stats["patch_delta"]
    eng.replace_policy(["k8s:warm=w0-443"], None)
    eng.regenerate()
    assert eng.datapath.patch_stats["patch_delta"] == before + 1
    assert old.tensors.dead
    # the in-place patch shares the verdict tensor with the new handle
    assert old.tensors["verdict"] is eng.active.tensors["verdict"]
    b = traffic(old.snapshot.ep_slot_of)
    with pytest.raises(dp_mod.StalePlacement):
        eng.datapath.classify(old.tensors, old.snapshot, copy(b), 500)
    assert eng.datapath.patch_stats["patch_stale_fences"] == 1
    assert eng.datapath.wire_pool_stats()["in_flight"] == 0
    # the engine's retry: a stale handle captured by classify is retried
    # against the active snapshot
    calls = {"n": 0}
    real_active = type(eng).active

    def first_stale(obj):
        calls["n"] += 1
        return old if calls["n"] == 1 else real_active.fget(obj)
    monkeypatch.setattr(type(eng), "active", property(first_stale))
    out = eng.classify(traffic(old.snapshot.ep_slot_of), now=600)
    assert calls["n"] >= 2 and out["allow"].shape[0] == 3 * N_PEERS
    assert eng.datapath.patch_stats["patch_stale_fences"] == 2


def test_scatter_failure_self_heals_with_full_upload():
    ej, et = per_side(storm_engine)
    warm_geometry(ej, et)
    for e in (ej, et):
        e.replace_policy(["k8s:warm=w2-443"],
                         peer_rule_docs(2, 443, label="k8s:warm=w2-443"))
        e.regenerate()
    def flaky(dp):
        """``dp``'s scatter, failing its first call."""
        real, calls = dp._scatter_rows, []

        def scatter(verdict, rows, vals):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("injected scatter failure")
            return real(verdict, rows, vals)
        return scatter
    for e in (ej, et):
        e.datapath._scatter_rows = flaky(e.datapath)
        e.replace_policy(["k8s:warm=w2-443"], None)
        e.regenerate()               # must not raise
    assert ej.datapath.patch_stats == et.datapath.patch_stats
    assert et.datapath.patch_stats["patch_scatter_errors"] == 1
    fresh = et.datapath.place(et.active.snapshot)
    assert torch.equal(et.active.tensors["verdict"], fresh["verdict"])
    b = traffic(ej.active.snapshot.ep_slot_of)
    assert_outs_equal(ej.classify(copy(b), now=900),
                      et.classify(copy(b), now=900))


def test_legacy_row_patch_without_delta_equals_jax():
    ej, et = per_side(storm_engine, delta_patch=False)
    warm_geometry(ej, et)
    for step in range(4):
        label = f"k8s:warm=w{step}-8080"
        for e in (ej, et):
            e.replace_policy([label], None if step % 2 else peer_rule_docs(
                step, 8080, label=label))
            e.regenerate()
        b = traffic(ej.active.snapshot.ep_slot_of)
        assert_outs_equal(ej.classify(copy(b), now=100 + step),
                          et.classify(copy(b), now=100 + step))
    assert ej.datapath.patch_stats == et.datapath.patch_stats
    assert et.datapath.patch_stats["patch_delta"] == 0


# --------------------------------------------------------------------------- #
# the sticky wire flags (mirrors test_datapath.py::TestWireFlagReset)
# --------------------------------------------------------------------------- #
L7_POLICY = [{
    "endpointSelector": {"matchLabels": {"app": "web"}},
    "ingress": [{"toPorts": [{
        "ports": [{"port": "80", "protocol": "TCP"}],
        "rules": {"http": [{"method": "GET", "path": "/api"}]}}]}],
    "egress": [{"toCIDR": ["10.0.0.0/8"]}],
}]
PLAIN_POLICY = [{
    "endpointSelector": {"matchLabels": {"app": "web"}},
    "egress": [{"toCIDR": ["10.0.0.0/8"]}],
}]


def test_l7_burst_unsticks_after_l7_free_snapshot():
    """``TestWireFlagReset``'s case of the same name, on both packages."""
    both(WireFlagCases.l7_burst_unsticks_after_l7_free_snapshot)


def test_v6_burst_unsticks_after_clean_run():
    """``TestWireFlagReset``'s case of the same name, on both packages."""
    both(WireFlagCases.v6_burst_unsticks_after_clean_run)


# --------------------------------------------------------------------------- #
# overlapped CT GC (mirrors test_update_storm.py::TestOverlappedCTGC)
# --------------------------------------------------------------------------- #
def _filled(side, **kw):
    eng = storm_engine(side, ct_gc_chunk_rows=256, **kw)
    rng = np.random.default_rng(5)
    slots = eng.active.snapshot.ep_slot_of
    for step in range(3):
        eng.classify(world_traffic("storm", slots, rng, n=128),
                     now=1000 + 20 * step)
    return eng


def test_chunked_epoch_equals_whole_table_sweep():
    """One full epoch of ``sweep_step`` chunks leaves the table a whole
    ``sweep`` leaves, and reclaims as many entries; both equal JAX's."""
    a, b, j = _filled("torch"), _filled("torch"), _filled("jax")
    now = 1045
    n_whole = b.datapath.sweep(now)
    assert j.datapath.sweep(now) == n_whole > 0
    total = 0
    for _ in range(2048 // 256 + 1):      # +1: the last tick's harvest
        st = a.datapath.sweep_step(now, 256)
        total += st["reclaimed"]
    assert total == n_whole and st["epoch"] == 1
    assert_ct_equal(b.ct_arrays(), a.ct_arrays())
    assert_ct_equal(j.ct_arrays(), a.ct_arrays())
    assert st["live"] == a.ct_stats(now=now)["live"]


def test_sweep_step_equals_jax_tick_for_tick():
    ej, et = _filled("jax"), _filled("torch")
    for tick in range(12):
        now = 1030 + 7 * tick
        sj, st = ej.sweep_step(now=now), et.sweep_step(now=now)
        assert sj == st, tick
        assert_ct_equal(ej.ct_arrays(), et.ct_arrays(), f"tick{tick}")
    assert "ct_gc_reclaimed_total" in et.render_metrics()


def test_gc_is_semantics_free_under_traffic():
    eng_gc, eng_ref = storm_engine("torch"), storm_engine("torch")
    slots = eng_gc.active.snapshot.ep_slot_of
    for e in (eng_gc, eng_ref):
        e.classify(traffic(slots), now=1000)
    for step in range(6):
        now = 1005 + step
        eng_gc.sweep_step(now=now)
        a = eng_gc.classify(traffic(slots, flags=C.TCP_ACK), now=now)
        b = eng_ref.classify(traffic(slots, flags=C.TCP_ACK), now=now)
        assert_outs_equal(a, b, f"gc-step{step}")
    assert (a["status"] == int(C.CTStatus.ESTABLISHED)).any()


def test_ct_gc_fault_point():
    m = mods("torch").faults
    eng = storm_engine("torch")
    m.FAULTS.arm("ct.gc", mode="fail", times=1)
    try:
        with pytest.raises(m.FaultInjected):
            eng.sweep_step()
    finally:
        m.FAULTS.disarm("ct.gc")
    assert eng.sweep_step()["chunk_rows"] == eng.config.ct_gc_chunk_rows


# --------------------------------------------------------------------------- #
# CT export / import across the two backends
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("stamp", [False, True])
def test_ct_tables_cross_backends(direction, stamp):
    """A table exported by one backend loads into the other and classifies
    the same: the importer's table equals the exporter's, and the next
    batches give the same verdicts and CT on both."""
    src_side, dst_side = direction.split("_to_")
    src = rich_world(bare_engine(src_side), "lb")
    dst = rich_world(bare_engine(dst_side), "lb")
    slots = src.active.snapshot.ep_slot_of
    rng = np.random.default_rng(3)
    for step in range(3):
        src.classify(world_traffic("lb", slots, rng), now=700 + step)
    arrays = src.ct_arrays()
    if stamp:
        from cilium_tpu_torch.runtime.datapath import CT_FORMAT_VERSION
        arrays = dict(arrays, __ct_format__=np.array([CT_FORMAT_VERSION]))
    dst.load_ct_arrays(arrays)
    assert_ct_equal(src.ct_arrays(), dst.ct_arrays(), "loaded")
    for step in range(3):
        b = world_traffic("lb", slots, rng)
        assert_outs_equal(src.classify(copy(b), now=710 + step),
                          dst.classify(copy(b), now=710 + step), f"{step}")
    assert_ct_equal(src.ct_arrays(), dst.ct_arrays(), "after")


def test_ct_format_from_the_future_is_refused():
    eng = storm_engine("torch")
    arrays = dict(eng.ct_arrays(), __ct_format__=np.array([99]))
    with pytest.raises(ValueError, match="newer"):
        eng.load_ct_arrays(arrays)


def test_v1_checkpoint_without_rev_nat_loads():
    ej, et = per_side(storm_engine)
    ej.classify(traffic(ej.active.snapshot.ep_slot_of), now=100)
    arrays = ej.ct_arrays()
    del arrays["rev_nat"]
    et.load_ct_arrays(arrays)
    assert_ct_equal(ej.ct_arrays(), et.ct_arrays())


# --------------------------------------------------------------------------- #
# what TorchDatapath refuses
# --------------------------------------------------------------------------- #
def test_cuda_device_without_a_card_raises(monkeypatch):
    m = mods("torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.datapath.TorchDatapath(m.config.DaemonConfig(ct_capacity=1024))
    assert m.config.DaemonConfig().device == "cuda"


def test_fused_on_with_a_cpu_device_raises():
    m = mods("torch")
    with pytest.raises(ValueError, match="no CPU build"):
        m.datapath.TorchDatapath(m.config.DaemonConfig(
            ct_capacity=1024, device="cpu", fused_kernels="on"))
    for mode in ("auto", "off"):
        dp = m.datapath.TorchDatapath(m.config.DaemonConfig(
            ct_capacity=1024, device="cpu", fused_kernels=mode))
        assert dp._fused is False


@pytest.mark.parametrize("kw", [{"n_shards": 2}, {"rule_shards": 2},
                                {"n_shards": 2, "rule_shards": 2},
                                {"rss_mode": "device"}])
def test_mesh_configurations_raise(kw):
    """Each mesh geometry constructs (none raises), and a seeded batch
    through it, twice
    (the second pass hits the CT), equals the JAX package's
    ``JITDatapath`` of the same geometry in every out column and the CT
    arrays."""
    ej, et = (rich_world(bare_engine(s, ct_capacity=1024, **kw), "lb")
              for s in SIDES)
    assert et.datapath.rss_state == ej.datapath.rss_state
    slots = ej.active.snapshot.ep_slot_of
    rng = np.random.default_rng(17)
    b = world_traffic("lb", slots, rng, n=48)
    for step in range(2):
        assert_outs_equal(ej.classify(copy(b), now=300 + step),
                          et.classify(copy(b), now=300 + step),
                          f"{kw} step {step}")
    assert_ct_equal(ej.ct_arrays(), et.ct_arrays(), str(kw))
    assert ej.datapath.hbm_ledger()["groups"] == reference_keys(
        et.datapath.hbm_ledger()["groups"], PORT_GROUPS)
    for e in (ej, et):
        e.stop()


def test_bad_device_is_refused_by_the_config():
    with pytest.raises(ValueError, match="cuda | cpu"):
        mods("torch").config.DaemonConfig(device="tpu")


# --------------------------------------------------------------------------- #
# case for case with test_datapath.py
# --------------------------------------------------------------------------- #
# Each reference case runs its own body on each package (``P(side)``: the
# port's ``DaemonConfig`` on the CPU, its ``TorchDatapath`` where the
# reference builds a ``JITDatapath``), asserts the reference's expectations
# on both, and holds a side-neutral observation equal (``both``).
import functools  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = {"jax": "oracle", "torch": "cilium_tpu_torch.oracle"}


def P(side):
    """``side``'s objects by the names ``test_datapath.py`` imports."""
    pkg = PKG[side]
    mod = importlib.import_module
    dp = mod(f"{pkg}.runtime.datapath")
    cfg = mod(f"{pkg}.runtime.config").DaemonConfig
    if side == "torch":
        cfg = functools.partial(cfg, device="cpu")
    return SimpleNamespace(
        side=side, pkg=pkg, DaemonConfig=cfg, FakeDatapath=dp.FakeDatapath,
        JITDatapath=(dp.TorchDatapath if side == "torch"
                     else dp.JITDatapath),
        WIRE_RESET_CLEAN_BATCHES=dp.WIRE_RESET_CLEAN_BATCHES,
        Engine=mod(f"{pkg}.runtime.engine").Engine,
        batch_from_records=mod(f"{pkg}.kernels.records").batch_from_records,
        C=mod(f"{pkg}.utils.constants"),
        parse_addr=mod(f"{pkg}.utils.ip").parse_addr,
        PacketRecord=mod(ORACLE[side]).PacketRecord)


def both(case):
    obs = {s: case(P(s)) for s in SIDES}
    assert obs["jax"] == obs["torch"]
    return obs["torch"]


FIXTURE_RULES = [
    {
        "endpointSelector": {"matchLabels": {"app": "web"}},
        "egress": [
            {"toCIDRSet": [{"cidr": "10.0.0.0/8",
                            "except": ["10.96.0.0/12"]}],
             "toPorts": [{"ports": [{"port": "443", "protocol": "TCP"}]}]},
        ],
        "egressDeny": [{"toCIDR": ["10.66.0.0/16"]}],
        "ingress": [{"fromEndpoints": [{"matchLabels": {"role": "fe"}}]}],
    },
]


def fixture_engine(m, datapath):
    eng = m.Engine(m.DaemonConfig(ct_capacity=2048, auto_regen=False,
                                  flowlog_mode="all"), datapath=datapath)
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
    eng.add_endpoint(["k8s:role=fe"], ips=("192.168.1.30",), ep_id=3)
    eng.apply_policy(FIXTURE_RULES)
    return eng


def pkt(m, src, dst, sp, dp, proto=C.PROTO_TCP, flags=C.TCP_SYN, ep_id=1,
        direction=C.DIR_EGRESS):
    s16, sv6 = m.parse_addr(src)
    d16, dv6 = m.parse_addr(dst)
    return m.PacketRecord(s16, d16, sp, dp, proto, flags, sv6 or dv6,
                          ep_id, direction)


def fixture_traffic(m):
    return [
        pkt(m, "192.168.1.10", "10.1.2.3", 40000, 443),    # allow (CIDRSet)
        pkt(m, "192.168.1.10", "10.96.0.1", 40001, 443),   # drop (except)
        pkt(m, "192.168.1.10", "10.66.1.1", 40002, 443),   # drop (deny wins)
        pkt(m, "192.168.1.10", "10.1.2.3", 40003, 80),     # drop (port)
        pkt(m, "192.168.1.30", "192.168.1.10", 40004, 22,  # allow (fromEP)
            ep_id=1, direction=C.DIR_INGRESS),
    ]


def array_bytes(arrays):
    """A dict of arrays → (name, dtype, shape, bytes), sorted by name."""
    return sorted((k, np.asarray(v).dtype.str, np.asarray(v).shape,
                   np.asarray(v).tobytes()) for k, v in arrays.items())


def columns(out, keys):
    return {k: np.asarray(out[k]).tolist() for k in keys}


class TestFakeDatapath:
    def test_control_plane_replay_records_placements(self):
        """pkg/datapath/fake pattern: replay fixtures, assert what would be
        programmed (placed snapshot + tensor images), no device involved."""
        @both
        def _(m):
            C = m.C
            fake = m.FakeDatapath()
            eng = fixture_engine(m, fake)
            eng.regenerate()
            assert len(fake.placed) == 1
            snap, tensors = fake.placed[0]
            assert snap.revision == eng.active.revision
            decisions = tensors["verdict"] & C.VERDICT_DECISION_MASK
            assert (decisions == C.VERDICT_DENY).any()
            assert (decisions == C.VERDICT_ALLOW).any()
            eng.apply_policy([{
                "endpointSelector": {"matchLabels": {"app": "web"}},
                "egress": [{"toCIDR": ["11.0.0.0/8"]}]}])
            eng.regenerate()
            assert len(fake.placed) == 2
            assert fake.placed[1][0].revision > snap.revision
            return [(s.revision, array_bytes(t)) for s, t in fake.placed]

    def test_fake_matches_jit_verdicts(self):
        """The two backends implement the same semantics contract: identical
        fixture + traffic → bit-identical verdict columns and CT stats."""
        @both
        def _(m):
            C = m.C
            eng_fake = fixture_engine(m, m.FakeDatapath(
                m.DaemonConfig(ct_capacity=2048)))
            eng_jit = fixture_engine(m, m.JITDatapath(m.DaemonConfig(
                ct_capacity=2048, auto_regen=False)))
            slots = eng_fake.active.snapshot.ep_slot_of
            assert slots == eng_jit.active.snapshot.ep_slot_of
            batch = m.batch_from_records(fixture_traffic(m), slots)
            now = 1000
            out_f = eng_fake.classify(dict(batch), now=now)
            out_j = eng_jit.classify(dict(batch), now=now)
            keys = ("allow", "reason", "status", "remote_identity",
                    "redirect", "svc", "rnat")
            for k in keys:
                np.testing.assert_array_equal(
                    np.asarray(out_f[k]), np.asarray(out_j[k]), k)
            svc = np.asarray(out_j["svc"])
            rnat = np.asarray(out_j["rnat"])
            np.testing.assert_array_equal(
                np.asarray(out_f["nat_dport"])[svc],
                np.asarray(out_j["nat_dport"])[svc])
            np.testing.assert_array_equal(
                np.asarray(out_f["rnat_sport"])[rnat],
                np.asarray(out_j["rnat_sport"])[rnat])
            assert eng_fake.ct_stats(now) == eng_jit.ct_stats(now)
            out_f2 = eng_fake.classify(dict(batch), now=now + 5)
            out_j2 = eng_jit.classify(dict(batch), now=now + 5)
            np.testing.assert_array_equal(out_f2["status"], out_j2["status"])
            assert (np.asarray(out_f2["status"])[0]
                    == C.CTStatus.ESTABLISHED)
            return (columns(out_f, keys), columns(out_j, keys),
                    eng_jit.ct_stats(now), columns(out_f2, ("status",)),
                    columns(out_j2, ("status",)))

    def test_ct_arrays_roundtrip(self):
        """Fake CT export/import preserves entries (checkpoint path)."""
        @both
        def _(m):
            fake = m.FakeDatapath(m.DaemonConfig(ct_capacity=2048))
            eng = fixture_engine(m, fake)
            eng.classify(m.batch_from_records(
                fixture_traffic(m), eng.active.snapshot.ep_slot_of),
                now=1000)
            before = fake.ct_stats(1000)
            assert before["live"] > 0
            arrays = fake.ct_arrays()
            fake2 = m.FakeDatapath(m.DaemonConfig(ct_capacity=2048))
            fake2.load_ct_arrays(arrays)
            assert fake2.ct_stats(1000) == before
            assert fake2._ct_table.entries == fake._ct_table.entries
            return before, array_bytes(arrays), \
                array_bytes(fake2.ct_arrays())

    def test_sweep_reclaims(self):
        @both
        def _(m):
            fake = m.FakeDatapath()
            eng = fixture_engine(m, fake)
            eng.classify(m.batch_from_records(
                fixture_traffic(m), eng.active.snapshot.ep_slot_of),
                now=1000)
            assert fake.ct_stats(1000)["live"] > 0
            reclaimed = eng.sweep(now=10**9)
            assert reclaimed > 0
            assert fake.ct_stats(10**9)["live"] == 0
            return reclaimed, array_bytes(fake.ct_arrays())


#: the reference's boundary session; ``{pkg}``/``{oracle}`` name the
#: side's package and oracle, ``{poison}`` the modules that must never load
JAXFREE_SESSION = r"""
import sys
for name in {poison}:
    sys.modules[name] = None       # any import of them now raises
from {pkg}.runtime.config import DaemonConfig
from {pkg}.runtime.datapath import FakeDatapath
from {pkg}.runtime.engine import Engine
from {pkg}.kernels.records import batch_from_records
from {pkg}.utils.ip import parse_addr
from {oracle} import PacketRecord

eng = Engine(DaemonConfig(ct_capacity=1024, auto_regen=False),
             datapath=FakeDatapath())
eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
eng.apply_policy([{{"endpointSelector": {{"matchLabels": {{"app": "web"}}}},
                   "egress": [{{"toCIDR": ["10.0.0.0/8"]}}]}}])
s16, _ = parse_addr("192.168.1.10")
d16, _ = parse_addr("10.1.2.3")
p = PacketRecord(s16, d16, 40000, 443, 6, 0x02, False, 1, 0)
out = eng.classify(batch_from_records([p], eng.active.snapshot.ep_slot_of),
                   now=100)
assert bool(out["allow"][0]), out
assert eng.ct_stats(100)["live"] == 1
loaded = sorted(n for n in {poison} if sys.modules.get(n) is not None)
assert not loaded, loaded
print("JAXFREE_OK")
"""


class TestJaxFreeBoundary:
    def test_engine_with_fake_never_imports_jax(self):
        """The boundary is real only if an Engine(FakeDatapath) session runs
        with jax imports poisoned (on the port's side ``cilium_tpu`` and
        ``oracle`` too). Subprocess because conftest pre-imports jax in
        this process."""
        @both
        def _(m):
            poison = ["jax"] if m.side == "jax" else \
                ["jax", "jaxlib", "cilium_tpu", "oracle"]
            code = JAXFREE_SESSION.format(pkg=m.pkg, oracle=ORACLE[m.side],
                                          poison=poison)
            proc = subprocess.run([sys.executable, "-c", code],
                                  capture_output=True, text=True,
                                  timeout=120, cwd=ROOT)
            assert proc.returncode == 0, proc.stderr
            assert "JAXFREE_OK" in proc.stdout
            return proc.returncode, proc.stdout.split()


class WireFlagCases:
    """``TestWireFlagReset``'s bodies, each on one side's modules ``m``:
    the sticky ``_wire_l7``/``_wire_wide`` widening flags reset in
    ``place()`` when the NEW snapshot provably has no L7/v6 surface, while
    verdicts stay correct throughout. Each returns the wire flags after
    each burst."""

    L7_POLICY = L7_POLICY
    PLAIN_POLICY = PLAIN_POLICY

    @staticmethod
    def flags(eng):
        dp = eng.datapath
        return (bool(dp._wire_l7), bool(dp._wire_wide),
                dp._batches_since_wide,
                dp.pack_stats["wire_flag_resets"])

    @staticmethod
    def l7_batch(m, eng):
        recs = [pkt(m, "192.168.1.30", "192.168.1.10", 50000 + i, 80,
                    direction=m.C.DIR_INGRESS) for i in range(4)]
        b = m.batch_from_records(recs, eng.active.snapshot.ep_slot_of)
        b["http_method"][:] = 0
        b["http_path"][:, :4] = np.frombuffer(b"/api", np.uint8)
        return b

    @staticmethod
    def v4_batch(m, eng):
        recs = [pkt(m, "192.168.1.10", "10.1.2.3", 51000 + i, 443)
                for i in range(4)]
        return m.batch_from_records(recs, eng.active.snapshot.ep_slot_of)

    @classmethod
    def l7_burst_unsticks_after_l7_free_snapshot(cls, m):
        cfg = m.DaemonConfig(ct_capacity=2048, auto_regen=False,
                             device="cpu", batch_size=32)
        eng = m.Engine(cfg, datapath=m.JITDatapath(cfg))
        eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
        eng.add_endpoint(["k8s:role=fe"], ips=("192.168.1.30",), ep_id=3)
        eng.apply_policy(cls.L7_POLICY)
        eng.regenerate()
        out = eng.classify(cls.l7_batch(m, eng), now=100)
        assert bool(out["allow"].all())
        assert eng.datapath._wire_l7          # the burst widened the wire
        seen = [cls.flags(eng)]
        eng.repo.clear()
        eng.apply_policy(cls.PLAIN_POLICY)
        eng.regenerate(force=True)
        assert not eng.datapath._wire_l7      # place() reset the flag
        assert eng.datapath.pack_stats["wire_flag_resets"] >= 1
        seen.append(cls.flags(eng))
        out = eng.classify(cls.v4_batch(m, eng), now=200)
        assert bool(out["allow"].all())
        assert not eng.datapath._wire_l7
        seen.append(cls.flags(eng))
        eng.stop()
        return seen

    @classmethod
    def v6_burst_unsticks_after_clean_run(cls, m):
        cfg = m.DaemonConfig(ct_capacity=2048, auto_regen=False,
                             device="cpu", batch_size=32)
        eng = m.Engine(cfg, datapath=m.JITDatapath(cfg))
        eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
        eng.apply_policy(cls.PLAIN_POLICY)
        eng.regenerate()
        b = cls.v4_batch(m, eng)
        b["is_v6"][0] = True                  # one stray v6 record
        eng.classify(b, now=100)
        assert eng.datapath._wire_wide
        seen = [cls.flags(eng)]
        eng.regenerate(force=True)
        assert eng.datapath._wire_wide
        for i in range(m.WIRE_RESET_CLEAN_BATCHES):
            eng.classify(cls.v4_batch(m, eng), now=110 + i)
        seen.append(cls.flags(eng))
        eng.regenerate(force=True)
        assert not eng.datapath._wire_wide
        assert eng.datapath.pack_stats["wire_flag_resets"] >= 1
        out = eng.classify(cls.v4_batch(m, eng), now=300)
        assert bool(out["allow"].all())
        seen.append(cls.flags(eng))
        eng.stop()
        return seen

    @classmethod
    def stale_staging_tail_does_not_pin_wide(cls, m):
        cfg = m.DaemonConfig(ct_capacity=2048, auto_regen=False,
                             device="cpu", batch_size=64,
                             pipeline_flush_ms=1.0)
        eng = m.Engine(cfg, datapath=m.JITDatapath(cfg))
        eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
        eng.apply_policy(cls.PLAIN_POLICY)
        eng.regenerate()
        recs = [pkt(m, "192.168.1.10", "10.1.2.3", 52000 + i, 443)
                for i in range(40)]
        big = m.batch_from_records(recs, eng.active.snapshot.ep_slot_of)
        big["is_v6"][:] = False
        big["is_v6"][5] = True                # one v6 row mid-batch
        eng.submit(big, now=100)              # 40 rows: coalesced path
        assert eng.drain(timeout=30)
        assert eng.datapath._wire_wide
        seen = [cls.flags(eng)[:2]]
        small = m.batch_from_records(recs[:8],
                                     eng.active.snapshot.ep_slot_of)
        for i in range(5):                    # 8 rows: same slots reused
            eng.submit(dict(small), now=200 + i)
            assert eng.drain(timeout=30)
        assert eng.datapath._batches_since_wide >= 5, \
            "stale staging tail re-tripped the wide probe"
        seen.append(cls.flags(eng)[:2])
        eng.stop()
        return seen

    @classmethod
    def tokens_without_l7_policy_never_widen(cls, m):
        cfg = m.DaemonConfig(ct_capacity=2048, auto_regen=False,
                             device="cpu", batch_size=32)
        jit = m.Engine(cfg, datapath=m.JITDatapath(cfg))
        fake = m.Engine(cfg, datapath=m.FakeDatapath(cfg))
        for eng in (jit, fake):
            eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",),
                             ep_id=1)
            eng.apply_policy(cls.PLAIN_POLICY)
            eng.regenerate()
        b = cls.v4_batch(m, jit)
        b["http_method"][:] = 0               # shim tokenizes plain HTTP
        b["http_path"][:, :4] = np.frombuffer(b"/idx", np.uint8)
        out_j = jit.classify(dict(b), now=100)
        out_f = fake.classify(dict(b), now=100)
        keys = ("allow", "reason", "status", "remote_identity")
        for k in keys:
            np.testing.assert_array_equal(out_j[k], out_f[k])
        assert not jit.datapath._wire_l7      # tokens never widened it
        seen = (cls.flags(jit), columns(out_j, keys))
        jit.stop()
        fake.stop()
        return seen


class TestWireFlagReset:
    """``test_datapath.py``'s class of that name; its first two cases are
    this file's module-level twins, turned in place."""

    def test_stale_staging_tail_does_not_pin_wide(self):
        both(WireFlagCases.stale_staging_tail_does_not_pin_wide)

    def test_tokens_without_l7_policy_never_widen(self):
        both(WireFlagCases.tokens_without_l7_policy_never_widen)
