"""The port's ``Engine`` on ``TorchDatapath`` against the JAX package's
``Engine`` on ``JITDatapath``, on the CPU, through the same API calls on
seeded inputs; exact equality of every out column, metric counter and CT
array.

- the random policy storm of ``test_update_storm.py::TestRandomStorm``:
  rule toggles on the delta path interleaved with endpoint churn;
- CT saturation with tail evictions and ``CT_FULL`` (mirrors
  ``test_ctfull.py::TestSaturationParity``; the JAX side also with its
  Pallas kernels in interpret mode) and the emergency GC
  (``TestEmergencyGC``);
- the shadow auditor at sampling 1.0 on the port's engine (0 mismatches),
  and the port's oracle against the JAX package's on the same batches;
- QoS, a clustermesh store and the DNS proxy construct and serve as the
  JAX engine does, ``attach_mesh`` returns a ``ClusterMesh``; the API
  socket, the CT-snapshot archive and the shim feeder serve;
- ``health()`` and ``render_metrics()`` carry the JAX engine's keys, the
  ``classify_fn_cache`` lines included (each package's classify-fn
  memo).
"""

import random
import time

import pytest

from cilium_tpu.utils import constants as C
from oracle import Oracle as JaxOracle
from tests.test_torch_datapath import (N_PEERS, PORT_COUNTERS, SIDES,
                                       assert_ct_equal, assert_engines_equal,
                                       assert_outs_equal, bare_engine, copy,
                                       mods, peer_rule_docs, rec, storm_engine,
                                       traffic, warm_geometry)

from cilium_tpu_torch.oracle import Oracle as TorchOracle

CT_CAP = 256          # small enough for a test flood to saturate


@pytest.fixture(autouse=True)
def _clean_faults():
    for side in SIDES:
        mods(side).faults.FAULTS.reset()
    yield
    for side in SIDES:
        mods(side).faults.FAULTS.reset()


# --------------------------------------------------------------------------- #
# the random policy storm
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [3, 11])
def test_engine_storm_equals_jax(seed):
    rng = random.Random(seed)
    ej, et = (storm_engine(s) for s in SIDES)
    warm_geometry(ej, et)
    next_ep, added = 100, []
    now = 2000
    for step in range(14):
        op = rng.random()
        if op < 0.7:
            i, p = rng.randrange(N_PEERS), rng.choice((443, 8080))
            label = f"k8s:warm=w{i}-{p}"
            body = None if rng.random() < 0.4 else peer_rule_docs(
                i, p, deny=rng.random() < 0.3, label=label)
            for e in (ej, et):
                e.replace_policy([label], body)
        elif op < 0.85 or not added:
            ep_id, next_ep = next_ep, next_ep + 1
            added.append(ep_id)
            for e in (ej, et):
                e.add_endpoint([f"k8s:peer=px{ep_id}"],
                               ips=(f"172.18.{ep_id % 250}.9",), ep_id=ep_id)
        else:
            ep_id = added.pop(rng.randrange(len(added)))
            for e in (ej, et):
                e.remove_endpoint(ep_id)
        for e in (ej, et):
            e.regenerate()
        assert ej.active.revision == et.active.revision
        b = traffic(ej.active.snapshot.ep_slot_of,
                    flags=C.TCP_SYN if step % 3 else C.TCP_ACK)
        assert_outs_equal(ej.classify(copy(b), now=now),
                          et.classify(copy(b), now=now), f"{seed}-{step}")
        assert ej.datapath.patch_stats == et.datapath.patch_stats, step
        now += 7
    assert et.datapath.patch_stats["patch_delta"] >= 1
    assert_engines_equal(ej, et)


# --------------------------------------------------------------------------- #
# CT saturation and the emergency GC
# --------------------------------------------------------------------------- #
def flood_engine(side, fused="off", **kw):
    kw.setdefault("ct_capacity", CT_CAP)
    eng = bare_engine(side, fused=fused, **kw)
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
    eng.add_endpoint(["k8s:peer=p0", "k8s:group=g0"], ips=("172.16.0.5",),
                     ep_id=10)
    eng.apply_policy([{
        "endpointSelector": {"matchLabels": {"app": "web"}},
        "ingress": [{"fromEndpoints": [{"matchLabels": {"group": "g0"}}],
                     "toPorts": [{"ports": [{"port": "80",
                                             "protocol": "TCP"}]}]}]}])
    eng.regenerate()
    return eng


def flows(slots, sports, flags=C.TCP_SYN, dport=80):
    from cilium_tpu.kernels.records import batch_from_records
    return batch_from_records(
        [rec("172.16.0.5", "192.168.1.10", sp, dport, flags)
         for sp in sports], slots)


@pytest.mark.parametrize("jax_fused", ["off", "on"])
def test_saturation_with_evictions_and_ct_full_equals_jax(jax_fused):
    ej, et = flood_engine("jax", fused=jax_fused), flood_engine("torch")
    slots = ej.active.snapshot.ep_slot_of
    now = 1000
    est = flows(slots, range(30000, 30016), flags=C.TCP_ACK)
    assert_outs_equal(ej.classify(copy(est), now=now),
                      et.classify(copy(est), now=now), "establish")
    for wave in range(4):
        now += 1
        fl = flows(slots, range(40000 + wave * CT_CAP,
                                40000 + (wave + 1) * CT_CAP))
        assert_outs_equal(ej.classify(copy(fl), now=now),
                          et.classify(copy(fl), now=now), f"wave{wave}")
    now += 1
    out = et.classify(copy(est), now=now)
    assert_outs_equal(ej.classify(copy(est), now=now), out, "revisit")
    assert (out["status"] == int(C.CTStatus.ESTABLISHED)).all()
    assert et.metrics.ct_evicted > 0 and et.metrics.insert_fail > 0
    assert_engines_equal(ej, et)
    rendered = et.render_metrics()
    assert "ciliumtpu_ct_evicted_total" in rendered
    assert "ciliumtpu_ct_insert_fail_total" in rendered


def test_emergency_gc_latch_equals_jax():
    kw = dict(ct_gc_chunk_rows=64, ct_gc_emergency_chunks=4,
              ct_gc_emergency_ttl_slash_s=55, ct_pressure_high=0.7,
              ct_pressure_low=0.3)
    ej, et = (flood_engine(s, **kw) for s in SIDES)
    slots = ej.active.snapshot.ep_slot_of
    now = 1000
    b = flows(slots, range(50000, 50224))
    assert_outs_equal(ej.classify(copy(b), now=now),
                      et.classify(copy(b), now=now))
    docs = []
    for tick in range(8):
        sj, st = ej.sweep_step(now=now), et.sweep_step(now=now)
        assert sj == st, tick
        docs.append(st)
        assert ej._ct_emergency == et._ct_emergency
        assert ej.metrics.gauges.get("ct_occupancy") == \
            et.metrics.gauges.get("ct_occupancy")
        now += 2
    assert any(d["emergency"] for d in docs)
    assert not et._ct_emergency
    assert et.metrics.counters.get("ct_emergency_sweeps_total", 0) > 0
    kinds = [e["kind"] for e in et.blackbox._events]
    assert kinds.count("ct-emergency") >= 2
    assert_engines_equal(ej, et)


def test_emergency_gc_spares_established_flows():
    et = flood_engine("torch", ct_gc_chunk_rows=256,
                      ct_gc_emergency_ttl_slash_s=55, ct_pressure_high=0.5,
                      ct_pressure_low=0.1)
    slots = et.active.snapshot.ep_slot_of
    est = flows(slots, range(60000, 60032), flags=C.TCP_ACK)
    et.classify(copy(est), now=1000)
    et.classify(flows(slots, range(61000, 61160)), now=1001)
    for i in range(4):
        et.sweep_step(now=1002 + 2 * i)
    assert et._ct_emergency
    out = et.classify(copy(est), now=1010)
    assert (out["status"] == int(C.CTStatus.ESTABLISHED)).all()


# --------------------------------------------------------------------------- #
# the shadow auditor and the port's oracle
# --------------------------------------------------------------------------- #
def test_auditor_at_full_sampling_reports_no_mismatch():
    et = flood_engine("torch", audit_enabled=True, audit_sample_rate=1.0,
                      audit_max_rows=512)
    slots = et.active.snapshot.ep_slot_of
    now = 1000
    et.classify(flows(slots, range(30000, 30016), flags=C.TCP_ACK), now=now)
    for wave in range(4):
        now += 1
        et.classify(flows(slots, range(41000 + wave * CT_CAP,
                                       41000 + (wave + 1) * CT_CAP)),
                    now=now)
        et.audit_step(budget=16)
    for _ in range(50):
        step = et.audit_step(budget=64)
        if not step or not (step.get("replayed") or step.get("pending")):
            break
    st = et.auditor.stats()
    assert st["checked_rows"] > 0 and st["mismatched_rows"] == 0
    assert et.metrics.insert_fail > 0
    assert et.health()["state"] == C.HEALTH_OK


def test_port_oracle_equals_the_reference_oracle():
    """Both oracles, each over its own package's compiled snapshot of the
    same control plane, give the same verdicts batch after batch (their
    bounded CT tables carried across)."""
    from cilium_tpu.runtime.datapath import \
        _records_from_batch as jax_records
    from oracle.datapath import ConntrackTable as JaxCT

    from cilium_tpu_torch.oracle.datapath import ConntrackTable as TorchCT
    from cilium_tpu_torch.runtime.datapath import \
        _records_from_batch as torch_records
    ej, et = (flood_engine(s) for s in SIDES)
    oj = JaxOracle.for_snapshot(ej.active.snapshot,
                                ct=JaxCT(capacity=CT_CAP, probe_depth=8))
    ot = TorchOracle.for_snapshot(et.active.snapshot,
                                  ct=TorchCT(capacity=CT_CAP, probe_depth=8))
    slots = ej.active.snapshot.ep_slot_of
    batches = [flows(slots, range(30000, 30016), flags=C.TCP_ACK)] + [
        flows(slots, range(40000 + w * CT_CAP, 40000 + (w + 1) * CT_CAP))
        for w in range(3)]
    n = 0
    for i, b in enumerate(batches):
        rj = [r for r in jax_records(b, ej.active.snapshot.ep_ids) if r]
        rt = [r for r in torch_records(b, et.active.snapshot.ep_ids) if r]
        vj = oj.classify_batch_snapshot(rj, 1000 + i)
        vt = ot.classify_batch_snapshot(rt, 1000 + i)
        # each package has its own enum and key classes: compare by value
        assert [repr(vars(v)) for v in vj] == [repr(vars(v)) for v in vt], i
        n += len(vt)
    assert n == 16 + 3 * CT_CAP
    assert oj.ct.insert_fail == ot.ct.insert_fail > 0
    assert oj.ct.evicted == ot.ct.evicted


# --------------------------------------------------------------------------- #
# configurations and surfaces
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("feature", ["qos_enabled", "cluster_store",
                                     "fqdn_proxy_enabled"])
def test_feature_constructs_and_serves(feature, tmp_path):
    """QoS, a clustermesh store and the DNS proxy construct on
    ``TorchDatapath`` and serve: the storm world's traffic, classified
    and submitted through the pipeline, equals the JAX engine's with the
    same feature on."""
    outs = {}
    for side in SIDES:
        kw = {"qos_enabled": {"qos_enabled": True,
                              "qos_tenants": "gold=4:lane,bulk=1"},
              "cluster_store": {"cluster_store": str(tmp_path / side),
                                "node_name": f"n-{side}"},
              "fqdn_proxy_enabled": {"fqdn_proxy_enabled": True}}[feature]
        eng = storm_engine(side, batch_size=64, pipeline_flush_ms=1.0, **kw)
        try:
            b = traffic(eng.active.snapshot.ep_slot_of)
            served = eng.classify(copy(b), now=100)
            piped = eng.submit(copy(b), now=101).result(timeout=60)
            outs[side] = (served, piped)
        finally:
            eng.stop()
    for want, got in zip(outs["jax"], outs["torch"]):
        assert_outs_equal(want, got, feature)
    assert outs["torch"][0]["allow"].any()


def test_attach_mesh_returns_a_cluster_mesh(tmp_path):
    """``attach_mesh`` gives the engine its ``ClusterMesh`` (once), which
    publishes this node's pods and reports OK."""
    from cilium_tpu_torch.runtime.clustermesh import ClusterMesh
    store = str(tmp_path / "store")
    et = storm_engine("torch", cluster_store=store, node_name="n1")
    try:
        mesh = et.attach_mesh()
        assert isinstance(mesh, ClusterMesh)
        assert et.attach_mesh() is mesh
        mesh.publish()
        mesh.sync()
        assert mesh.status()["state"] == "OK"
        assert et.mesh_status()["state"] == "OK"
        with open(f"{store}/n1.json") as f:
            assert "192.168.1.10/32" in f.read()
    finally:
        et.stop()


def test_start_feeder_attaches_and_serves():
    """``start_feeder`` attaches the port's ``ShimFeeder`` to the engine on
    ``TorchDatapath``: frames injected into the port's shim come back
    forwarded or dropped as the JAX engine classifies the same records."""
    from cilium_tpu_torch.shim import bindings
    if bindings.cxx() is None:
        pytest.skip("no C++ compiler on PATH")
    ej = storm_engine("jax")
    b = traffic(ej.active.snapshot.ep_slot_of)
    allow = ej.classify(copy(b), now=int(time.time()))["allow"][:len(
        b["valid"])]
    et = storm_engine("torch", batch_size=64, pipeline_flush_ms=1.0)
    shim = bindings.FlowShim(batch_size=32, timeout_us=100)
    shim.register_endpoint("192.168.1.10", 1)
    shim.mock_rings_init(ring_size=64, frame_size=2048, n_frames=64)
    feeder = et.start_feeder(shim)
    assert et.start_feeder(shim) is feeder          # attaches once
    n = 3 * N_PEERS
    for i in range(n):
        d = (80, 443, 8080)[i % 3]
        assert shim.mock_rx_inject(bindings.build_frame(
            f"172.16.{i // 3}.5", "192.168.1.10", 30000 + i // 3, d,
            payload=b"x" * i)) == 0
    drained, end = [], time.time() + 60
    while shim.stats()["verdict_passes"] + shim.stats()["verdict_drops"] < n:
        assert time.time() < end, shim.stats()
        drained.extend(shim.mock_tx_drain(64))
        time.sleep(0.005)
    assert et.feeder_stats()["harvested_records"] == n
    et.stop()
    ej.stop()
    drained.extend(shim.mock_tx_drain(64))
    shim.close()
    assert [ln - 54 for _a, ln in drained] == \
        [i for i in range(n) if allow[i]]


def test_api_socket_answers_healthz(tmp_path):
    """``api_socket`` serves: the port's engine on ``TorchDatapath`` answers
    ``/v1/healthz`` with the revision the JAX engine reaches."""
    from cilium_tpu_torch.runtime.api import UnixAPIClient
    sock = str(tmp_path / "agent.sock")
    ej = storm_engine("jax")
    et = storm_engine("torch", api_socket=sock)
    et.start_background()
    try:
        code, doc = UnixAPIClient(sock).get("/v1/healthz")
        assert code == 200 and doc["status"] == "ok"
        assert doc["revision"] == ej.repo.revision
    finally:
        et.stop()
        ej.stop()
    assert not (tmp_path / "agent.sock").exists()


def test_ct_snapshot_step_writes_an_archive_the_reference_reads(tmp_path):
    """``ct_snapshot_dir``: one ``ct_snapshot_step`` writes an archive that
    the JAX package's ``load_ct_archive`` reads back equal to the port's
    CT, and to the JAX engine's after the same traffic."""
    from cilium_tpu.runtime.checkpoint import load_ct_archive
    ej = storm_engine("jax")
    et = storm_engine("torch", ct_snapshot_dir=str(tmp_path / "ct"))
    for e in (ej, et):
        e.classify(traffic(e.active.snapshot.ep_slot_of), now=100)
    doc = et.ct_snapshot_step(now=200.0)
    assert doc["entries"] > 0
    arrays = load_ct_archive(doc["path"])
    assert_ct_equal(ej.ct_arrays(), arrays)
    assert_ct_equal(et.ct_arrays(), arrays)
    assert et.metrics.gauges["checkpoint_age_seconds"] >= 0


def _metric_names(text):
    return {line.split(" ")[0].split("{")[0] for line in text.splitlines()
            if line and not line.startswith("#")}


def test_health_and_metrics_carry_the_reference_keys():
    ej, et = (storm_engine(s, audit_enabled=True) for s in SIDES)
    for e in (ej, et):
        b = traffic(e.active.snapshot.ep_slot_of)
        e.classify(copy(b), now=100)
        e.submit(copy(b), now=101).result(timeout=30)
        e.sweep_step(now=102)
        e.resource_step()
    hj, ht = ej.health(), et.health()
    assert set(hj) == set(ht)
    assert hj["state"] == ht["state"] == C.HEALTH_OK
    names_j = _metric_names(ej.render_metrics())
    names_t = _metric_names(et.render_metrics())
    # each package's classify memo and span tracer are process-global:
    # whether a memo has evicted, or a tracer dropped spans, depends on
    # what else ran in this process, so each of those counters' lines is
    # expected exactly when its source has counted
    from cilium_tpu.kernels.classify import fn_cache_stats as j_stats
    from cilium_tpu_torch.kernels.classify import fn_cache_stats as t_stats
    memo_j, memo_t = (
        {"ciliumtpu_classify_fn_cache_evictions_total"}
        if stats()["evictions"] > 0 else set() for stats in (j_stats, t_stats))
    trace_j, trace_t = (
        {f"ciliumtpu_trace_{name}" for key, name in (
            ("spans_dropped_total", "spans_dropped_total"),
            ("ring_wraps", "ring_wraps_total")) if e.tracer.stats()[key] > 0}
        for e in (ej, et))
    # the port's own counters (the salvage note's stamped rows) have no
    # reference; the served batch stamped its established rows
    port = {f"ciliumtpu_{name}" for name in PORT_COUNTERS}
    assert port <= names_t
    assert {"ciliumtpu_classify_fn_cache_size"} <= names_j & names_t
    assert names_j - names_t == (memo_j - memo_t) | (trace_j - trace_t)
    assert names_t - names_j == (memo_t - memo_j) | (trace_t - trace_j) | port
    for e in (ej, et):
        e.stop()


def test_profile_classify_writes_a_chrome_trace(tmp_path):
    et = storm_engine("torch")
    out = et.profile_classify(traffic(et.active.snapshot.ep_slot_of),
                              str(tmp_path), now=100, repeats=2)
    assert out["allow"].shape == (3 * N_PEERS,)
    assert (tmp_path / "classify_trace.json").stat().st_size > 0
