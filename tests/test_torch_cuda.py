"""The port's CUDA kernels on the card against their plain torch versions,
at test size (the smoke presets of both worlds). Marked ``cuda`` and
skipped without a CUDA device; on a machine with one::

    python -m pytest --noconftest tests/test_torch_cuda.py -q

``--noconftest`` because the suite's conftest imports JAX, which the
port's machine need not have. ``chip_smoke.py`` runs the same checks at
full width. The edge cases of ``kernels/edge_cases.py`` run here as they
do in ``chip_smoke.py``, and so do its phases tenants, fqdn, cluster,
chaos, goldengen, ddos, observe and profile, at the smoke preset and
shortened.
"""

import pytest
import torch

from cilium_tpu_torch.kernels import fused as fk
from cilium_tpu_torch.kernels.classify import make_classify_fn
from cilium_tpu_torch.kernels.edge_cases import (edge_cases,
                                                 fingerprint_rows, lpm_args,
                                                 policy_args, probe_args)
from cilium_tpu_torch.kernels.records import (batch_to_torch, unpack_wire,
                                              wire_to_torch)
from cilium_tpu_torch.world import make_world

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return "cuda"


def _batch(world):
    return unpack_wire(wire_to_torch(world.pack(world.next_batch()),
                                     "cuda"))


@pytest.mark.parametrize("config", ["cfg5", "mixed"])
def test_kernels_match_plain_versions(device, config):
    world = make_world(config, seed=2, device=device, preset="smoke")
    b = _batch(world)
    remote = torch.where((b["direction"] == 0)[:, None], b["dst"], b["src"])
    largs = (world.tensors["lpm_v4"], world.tensors["lpm_v6"], remote,
             b["is_v6"], world.world_index, world.v4_only)
    for g, w in zip(fk.lpm_lookup_fused(*largs), fk.lpm_lookup_plain(*largs)):
        assert torch.equal(g, w)
    idx = fk.lpm_lookup_plain(*largs)[0]
    est = torch.arange(idx.shape[0], device=device) % 3 == 0
    reply = torch.arange(idx.shape[0], device=device) % 5 == 1
    rows = (b["ep_slot"], b["direction"], idx, b["proto"], b["dport"],
            b["http_method"], b["http_path"], est, reply & ~est, b["valid"])
    for g, w in zip(fk.policy_verdict_fused(world.tensors, *rows),
                    fk.policy_verdict_plain(world.tensors, *rows)):
        assert torch.equal(g, w)
    fn = make_classify_fn(v4_only=world.v4_only, packed=True, fused=False,
                          device=device)
    fn(world.tensors, world.ct, world.pack(world.next_batch()), 1000,
       world.world_index)
    from cilium_tpu_torch.kernels.conntrack import ct_key_words_pair
    fwd, rev = ct_key_words_pair(b)
    for now in (1000, 1100):
        args = (world.ct, fwd, rev, now, 8)
        for g, w in zip(fk.ct_probe_pair_fused(*args),
                        fk.ct_probe_pair_plain(*args)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("config", ["cfg5", "mixed"])
def test_flow_fingerprint_matches_plain_version(device, config):
    """The fingerprint kernel against its plain version, synchronised
    after each launch, on a world's batch (as unpacked from its wire) and
    on 1,003 random rows (not a multiple of the block), and both against
    ``shim.feeder.flow_hashes`` of the same rows on the host."""
    import numpy as np
    from cilium_tpu_torch.shim.feeder import flow_hashes
    cols = ("src", "dst", "sport", "dport", "proto", "direction")
    world = make_world(config, seed=5, device=device, preset="smoke")
    fk.reset_launches()
    for b in (_batch(world), batch_to_torch(fingerprint_rows(1003, 5),
                                            device)):
        args = [b[k] for k in cols]
        got = fk.flow_fingerprint_fused(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, fk.flow_fingerprint_plain(*args))
        host = {k: b[k].cpu().numpy() for k in cols}
        assert np.array_equal(got.cpu().numpy().view(np.uint32),
                              flow_hashes(host))
    assert fk.LAUNCHES["flow_fingerprint_fused"] == 2


@pytest.mark.parametrize("config", ["cfg5", "mixed"])
def test_classify_kernel_path_matches_plain_path(device, config):
    world = make_world(config, seed=3, device=device, preset="smoke")
    fn = make_classify_fn(v4_only=world.v4_only, packed=True, device=device)
    fn_plain = make_classify_fn(v4_only=world.v4_only, packed=True,
                                fused=False, device=device)
    fk.reset_launches()
    for i in range(4):
        wire = world.pack(world.next_batch())
        ct_copy = {k: v.clone() for k, v in world.ct.items()}
        out_p, ct_p, cnt_p = fn_plain(world.tensors, ct_copy, wire, 1000 + i,
                                      world.world_index)
        out, ct, cnt = fn(world.tensors, world.ct, wire, 1000 + i,
                          world.world_index)
        for a, b in ((out_p, out), (cnt_p, cnt), (ct_p, ct)):
            for k in a:
                assert torch.equal(a[k], b[k]), (i, k)
    assert all(v == 4 for v in fk.LAUNCHES.values()), fk.LAUNCHES


@pytest.mark.parametrize("config", ["cfg5", "mixed"])
def test_scripted_step_equals_the_eager_step(device, config):
    """``make_classify_fn``'s scripted step (the kernel wrappers called
    from it) against ``classify_step`` called eagerly, kernels on, each
    on its own copy of the CT: every out column, counter and CT array
    equal, batch after batch, and each kernel launched by both."""
    from cilium_tpu_torch.kernels.classify import classify_step
    world = make_world(config, seed=4, device=device, preset="smoke")
    fn = make_classify_fn(v4_only=world.v4_only, packed=True, device=device)
    ct_e = {k: v.clone() for k, v in world.ct.items()}
    fk.reset_launches()
    for i in range(4):
        wire = world.pack(world.next_batch())
        out, ct, cnt = fn(world.tensors, world.ct, wire, 1000 + i,
                          world.world_index)
        out_e, ct_e, cnt_e = classify_step(
            world.tensors, ct_e, unpack_wire(wire_to_torch(wire, device)),
            1000 + i, world.world_index, v4_only=world.v4_only, inplace=True)
        for a, b in ((out_e, out), (cnt_e, cnt), (ct_e, ct)):
            for k in a:
                assert torch.equal(a[k], b[k]), (i, k)
    assert all(v == 8 for v in fk.LAUNCHES.values()), fk.LAUNCHES


def test_edge_cases_match_plain_versions(device):
    probe, policy, lpm = edge_cases(seed=0)
    for name, case in lpm.items():
        args = lpm_args(case, device)
        for g, w in zip(fk.lpm_lookup_fused(*args),
                        fk.lpm_lookup_plain(*args)):
            assert torch.equal(g, w), name
    for name, case in probe.items():
        args = probe_args(case, device)
        for g, w in zip(fk.ct_probe_pair_fused(*args),
                        fk.ct_probe_pair_plain(*args)):
            assert torch.equal(g, w), name
    for name, case in policy.items():
        args = policy_args(case, device)
        for g, w in zip(fk.policy_verdict_fused(*args),
                        fk.policy_verdict_plain(*args)):
            assert torch.equal(g, w), name


def test_wrappers_refuse_misaligned_inputs(device):
    """K2 reads key words as 8-byte pairs, K3 reads L7 prefixes and the
    fingerprint kernel addresses 16 bytes at a time; a view that breaks
    any of these alignments raises."""
    probe, policy, _lpm = edge_cases(seed=0)
    ct, fwd, rev, now, depth = probe_args(probe["wrap"], device)
    n = fwd.shape[0]
    shifted = torch.empty(n * 10 + 1, dtype=torch.int32,
                          device=device)[1:].view(n, 10)
    shifted.copy_(fwd)
    with pytest.raises(ValueError, match="aligned"):
        fk.ct_probe_pair_fused(ct, shifted, rev, now, depth)
    tensors, *rows = policy_args(policy["path_len_16"], device)
    path = tensors["l7_path"]
    moved = torch.empty(path.numel() + 4, dtype=torch.uint8,
                        device=device)[4:].view(path.shape)
    moved.copy_(path)
    with pytest.raises(ValueError, match="aligned"):
        fk.policy_verdict_fused({**tensors, "l7_path": moved}, *rows)
    b = batch_to_torch(fingerprint_rows(n, 1), device)
    shifted = torch.empty(n * 4 + 1, dtype=torch.int32,
                          device=device)[1:].view(n, 4)
    shifted.copy_(b["src"])
    with pytest.raises(ValueError, match="aligned"):
        fk.flow_fingerprint_fused(shifted, b["dst"], b["sport"], b["dport"],
                                  b["proto"], b["direction"])


def test_lpm_derived_tables_follow_in_place_edits(device):
    """An in-place edit of a trie on the card rebuilds K1's derived
    tables: the kernel then sees the edit."""
    world = make_world("mixed", seed=4, device=device, preset="smoke")
    b = _batch(world)
    remote = torch.where((b["direction"] == 0)[:, None], b["dst"], b["src"])
    v4 = world.tensors["lpm_v4"].clone()
    largs = (v4, world.tensors["lpm_v6"], remote, b["is_v6"],
             world.world_index, False)
    fk.lpm_lookup_fused(*largs)
    first = fk.lpm_derived(v4)
    v4[0, :, 1] = 1                  # every v4 address now matches /8
    v4[0, :, 2] = 8
    assert fk.lpm_derived(v4) is not first
    for g, w in zip(fk.lpm_lookup_fused(*largs), fk.lpm_lookup_plain(*largs)):
        assert torch.equal(g, w)


def test_classify_step_makes_no_host_sync(device):
    """One classify step on the card, with the wire uploaded from pinned
    memory, under ``set_sync_debug_mode("error")``: any operation that
    waits on the device (a read-back, a blocking copy) raises."""
    world = make_world("cfg5", seed=5, device=device, preset="smoke")
    fn = make_classify_fn(v4_only=world.v4_only, packed=True, device=device)

    def upload():
        host = torch.from_numpy(world.pack(world.next_batch()).view(
            "int32")).pin_memory()
        return host.to(device, non_blocking=True)
    fn(world.tensors, world.ct, upload(), 1000, world.world_index)
    wire = upload()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, _ct, counters = fn(world.tensors, world.ct, wire, 1001,
                                world.world_index)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out["allow"].shape[0] == world.batch
    assert int(counters["insert_fail"]) >= 0


def _serve_engine(fused, device, **mesh):
    from cilium_tpu_torch.runtime import DaemonConfig, Engine
    from cilium_tpu_torch.runtime.datapath import TorchDatapath
    cfg = DaemonConfig(device=device, ct_capacity=4096, batch_size=256,
                       auto_regen=False, fused_kernels=fused,
                       pipeline_inflight=2, **mesh)
    eng = Engine(cfg, datapath=TorchDatapath(cfg))
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
    for i in range(6):
        eng.add_endpoint([f"k8s:peer=p{i}", f"k8s:group=g{i % 2}"],
                         ips=(f"172.16.{i}.5",), ep_id=10 + i)
    eng.apply_policy([{
        "endpointSelector": {"matchLabels": {"app": "web"}},
        "ingress": [{"fromEndpoints": [{"matchLabels": {"group": "g0"}}],
                     "toPorts": [{"ports": [{"port": "80",
                                             "protocol": "TCP"}]}]}]}])
    eng.regenerate()
    return eng


def _peer_batches(n=8):
    import numpy as np
    from cilium_tpu_torch.kernels.records import empty_batch
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(n):
        b = empty_batch(256)
        peer = rng.integers(0, 6, 256)
        b["src"][:, 2] = b["dst"][:, 2] = 0xFFFF
        b["src"][:, 3] = 0xAC100005 + (peer << 8).astype(np.uint32)
        b["dst"][:, 3] = 0xC0A8010A
        b["sport"][:] = rng.integers(30000, 30100, 256)
        b["dport"][:] = rng.choice([80, 443], 256)
        b["proto"][:] = 6
        b["tcp_flags"][:] = rng.choice([2, 16], 256)
        b["valid"][:] = True
        batches.append(b)
    return batches


def test_engine_submit_on_the_card_equals_the_plain_engine(device):
    """``Engine.submit`` with the kernels against the same engine with
    ``fused_kernels="off"``, both on the card: every ticket's out columns
    and the CT arrays equal, and every dispatched batch launched the
    three kernels."""
    import numpy as np
    engines = [_serve_engine(f, device) for f in ("auto", "off")]
    batches = _peer_batches()
    fk.reset_launches()
    results = []
    for eng in engines:
        tickets = [eng.submit({k: v.copy() for k, v in b.items()},
                              now=100 + i) for i, b in enumerate(batches)]
        results.append([t.result(timeout=120) for t in tickets])
    assert all(v == len(batches) for v in fk.LAUNCHES.values()), \
        fk.LAUNCHES
    for want, got in zip(results[1], results[0]):
        for k in want:
            assert want[k].dtype == got[k].dtype
            assert np.array_equal(want[k], got[k]), k
    a, b = (e.ct_arrays() for e in engines)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert results[0][-1]["allow"].any()
    for eng in engines:
        eng.stop()


@pytest.mark.parametrize("mesh", [dict(n_shards=4),
                                  dict(n_shards=4, rss_mode="device")])
def test_mesh_on_the_card_equals_the_plain_mesh(device, mesh):
    """A 4-shard datapath (host-steered, then device RSS) with its shards
    sharing the card, against the same geometry with
    ``fused_kernels="off"``: every ticket's out columns and the CT arrays
    equal; K2 launches once per flow shard a dispatch; the host-steered
    step (one step over the co-located shards) launches K1 and K3 once a
    dispatch, device RSS K1 once per shard and K3 never (it runs the
    split policy core); the fingerprint kernel launches once a dispatch
    on the host-steered step, never on device RSS."""
    import numpy as np
    engines = [_serve_engine(f, device, **mesh) for f in ("auto", "off")]
    batches = _peer_batches()
    results = []
    fk.reset_launches()
    for eng in engines:
        tickets = [eng.submit({k: v.copy() for k, v in b.items()},
                              now=100 + i) for i, b in enumerate(batches)]
        results.append([t.result(timeout=120) for t in tickets])
        if eng is engines[0]:
            launches = dict(fk.LAUNCHES)
            dispatched = eng.pipeline_stats()["dispatched_batches"]
    device_rss = mesh.get("rss_mode") == "device"
    k1 = 4 * dispatched if device_rss else dispatched
    assert launches["lpm_lookup_fused"] == k1 > 0, launches
    assert launches["ct_probe_pair_fused"] == 4 * dispatched, launches
    k3 = 0 if device_rss else dispatched
    assert launches["policy_verdict_fused"] == k3, launches
    # the exchange step builds its outputs without a classify step
    fp = 0 if device_rss else dispatched
    assert launches["flow_fingerprint_fused"] == fp, launches
    for want, got in zip(results[1], results[0]):
        for k in want:
            assert np.array_equal(want[k], got[k]), k
    a, b = (e.ct_arrays() for e in engines)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    for eng in engines:
        eng.stop()


def _cuda_error_string(code):
    """``cudaGetErrorString(code)`` of the CUDA runtime library."""
    import ctypes
    import glob
    import os
    names = ["libcudart.so", "libcudart.so.12"]
    names += glob.glob(os.path.join(os.path.dirname(torch.__file__), "..",
                                    "nvidia", "cuda_runtime", "lib",
                                    "libcudart.so*"))
    names += glob.glob("/usr/local/cuda/lib64/libcudart.so*")
    for name in names:
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.cudaGetErrorString.restype = ctypes.c_char_p
        lib.cudaGetErrorString.argtypes = [ctypes.c_int]
        return lib.cudaGetErrorString(code).decode()
    raise RuntimeError("no CUDA runtime library found")


def test_dead_device_markers_are_the_runtime_strings(device):
    """The CUDA signatures ``dead_device_of`` matches are the runtime's own
    ``cudaGetErrorString`` texts for their codes."""
    from cilium_tpu_torch.runtime.datapath import (_DEAD_DEVICE_MARKERS,
                                                   CUDA_DEAD_DEVICE_ERRORS,
                                                   dead_device_of)
    for name, code in CUDA_DEAD_DEVICE_ERRORS.items():
        text = _cuda_error_string(code)
        assert text in _DEAD_DEVICE_MARKERS, (name, text)
        assert dead_device_of(RuntimeError(f"CUDA error: {text}")) == -1


def test_agent_oneshot_on_the_card_restores_the_kernel_path(device, tmp_path):
    """``agent run --oneshot`` on the card: a state dir saved by an engine
    on the kernel path restores into an agent on ``TorchDatapath`` with
    the kernels active, and its checkpoint keeps the CT the engine saved
    (every entry re-placed as a restore re-places it)."""
    import json
    import os
    import subprocess
    import sys

    import numpy as np
    from cilium_tpu_torch.parallel.mesh import rehash_ct_arrays
    from cilium_tpu_torch.runtime import DaemonConfig, Engine, checkpoint
    from cilium_tpu_torch.runtime.datapath import TorchDatapath
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = DaemonConfig(device=device, ct_capacity=4096, auto_regen=False)
    eng = Engine(cfg, datapath=TorchDatapath(cfg))
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
    eng.apply_policy([{"endpointSelector": {"matchLabels": {"app": "web"}},
                       "egress": [{"toCIDR": ["10.0.0.0/8"]}]}])
    eng.regenerate()
    from cilium_tpu_torch.kernels.records import empty_batch
    b = empty_batch(64)
    b["src"][:, 2] = b["dst"][:, 2] = 0xFFFF
    b["src"][:, 3] = 0xC0A8010A
    b["dst"][:, 3] = 0x0A000000 + np.arange(64)
    b["sport"][:], b["dport"][:], b["proto"][:] = 40000, 443, 6
    b["tcp_flags"][:] = 0x10
    b["ep_slot"][:] = eng.active.snapshot.ep_slot_of[1]
    b["direction"][:] = 1
    b["valid"][:] = True
    import time
    assert eng.classify(b, now=int(time.time()))["allow"].all()
    state = str(tmp_path / "state")
    checkpoint.save(eng, state)
    saved = eng.ct_arrays()
    eng.stop()
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps({"device": "cuda", "ct_capacity": 4096,
                                    "state_dir": state}))
    out = subprocess.run(
        [sys.executable, "-m", "cilium_tpu_torch.cli.main", "agent", "run",
         "--config", str(cfg_path), "--oneshot"],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "restored=True" in out.stderr
    host = checkpoint.load_host(state)
    want, _dropped = rehash_ct_arrays(saved, 1, cfg.probe_depth)
    for k in want:
        assert np.array_equal(host.ct[k], want[k]), k


# --------------------------------------------------------------------------- #
# the host layers' phases of chip_smoke.py, at the smoke preset
# --------------------------------------------------------------------------- #
@pytest.fixture
def smoke(device, monkeypatch):
    """``chip_smoke`` at the smoke preset on the card: its phases hold every
    dispatch against the plain path and count every kernel's launches."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "PRESET", "smoke")
    monkeypatch.setattr(chip_smoke, "DEVICE", device)
    # each case starts as a process with no profiler session and nothing
    # put off until phase profile
    monkeypatch.setattr(chip_smoke, "PROFILER_SESSIONS", [])
    monkeypatch.setattr(chip_smoke, "DEFERRED", [])
    return chip_smoke


def test_phase_tenants_on_the_card(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "TENANT_SHARE_S", 2.0)
    lines, snap, ipcache = smoke.phase_tenants(0, "test")
    assert lines[-1].startswith("tenants launches") and ipcache


def test_phase_fqdn_on_the_card(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "FQDN_TICKS", 6)
    lines = smoke.phase_fqdn(0, "test")
    assert lines[-1].startswith("fqdn launches")


def test_phase_cluster_on_the_card(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "CLUSTER_ROWS", 1024)
    monkeypatch.setattr(smoke, "CLUSTER_SERVE_BATCHES", 2)
    lines = smoke.phase_cluster(0, "test")
    assert lines[-1].startswith("cluster launches")


def test_phase_chaos_on_the_card(smoke):
    lines = smoke.phase_chaos("test")
    assert lines[-1].startswith("chaos launches")


def test_phase_goldengen_on_the_card(smoke):
    eng, _cfg, _s = smoke.serve_engine()
    snap, ipcache = eng.active.snapshot, eng.ctx.ipcache.snapshot()
    eng.stop()
    lines = smoke.phase_goldengen(snap, ipcache, 0, "test")
    assert lines[-1].startswith("goldengen launches")


def test_phase_ddos_on_the_card(smoke):
    lines = smoke.phase_ddos(0, "test")
    assert lines[-1].startswith("ddos launches")


def test_phase_parity_on_the_card(smoke, device):
    """Phase parity at the smoke preset: the kernels against the port's
    oracle, each part's every column and live CT entry (it raises on a
    mismatch); each kernel launched once a batch."""
    lines = smoke.phase_parity(
        make_world("cfg5", seed=0, device=device, preset="smoke"),
        make_world("mixed", seed=0, device=device, preset="smoke"), "test")
    assert lines[-1].startswith("parity launches")
    # a line a part, part (e)'s CT_FULL line, part (f)'s auditor line,
    # the launches
    assert len(lines) == len(smoke.PARITY_PARTS) + 3


def test_phase_observe_on_the_card(smoke):
    """Phase observe at the smoke preset: the flow observer on the served
    wire path held against the plain replay, the bench's overhead gate,
    the fault points (a 0.5 s breaker cooldown), every dispatch and the CT
    equal to the plain replay, each kernel launched once a dispatch."""
    from cilium_tpu_torch.world import cfg5_traffic
    eng, cfg, _s = smoke.serve_engine(ingest_poll_budget=8192,
                                      pipeline_breaker_cooldown_s=0.5)
    next_batch, _warm = cfg5_traffic(0, True)
    wire = smoke.feeder_wire(eng, cfg, next_batch,
                             smoke.DispatchLog(eng.datapath))
    lines = smoke.phase_observe(wire, "test")
    assert lines[-1].startswith("observe launches")


def test_phase_profile_on_the_card(smoke):
    """Phase profile at the smoke preset after phase ddos: K2's cold and
    hot device times at the saturated table (put off by phase ddos), the
    served path under the profiler (each kernel seen on the device by
    name, every dispatch and the CT equal to the plain replay) and each
    mesh geometry's device ms per launch; the host-bound phases refuse to
    start after it."""
    report = {k: {"name": k} for k in smoke.KERNELS}
    smoke.phase_ddos(0, "test", report)
    assert [label for label, _job in smoke.DEFERRED] == [
        "ct_probe_pair_fused cfg6_saturated"]
    lines = smoke.phase_profile(0, "test", report)
    assert not smoke.DEFERRED
    assert report["ct_probe_pair_fused"]["cfg6_saturated"]["ms"] > 0
    assert any(line.startswith("serve profile") for line in lines)
    assert all(set(report[k]["mesh_ms"]) == {"a", "b", "c"}
               for k in report)
    with pytest.raises(smoke.SmokeFailure, match="profiler session"):
        smoke.phase_serve(0, "test")
