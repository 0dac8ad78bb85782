"""The port's mesh (``cilium_tpu_torch/parallel/mesh.py``) against the JAX
package's on the CPU: the twin of ``tests/test_parallel.py``.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
provisions; the port's mesh is a grid of ``cpu`` devices in one process.
Both get the same seeded numpy inputs (the same snapshot tensors, the
same steered batches), and the tolerance is exact equality: every out
column, the counters and the CT arrays. Covered: the host steering
(direction-stable flow hash, steer round trip), the device-side shard hash
at a power-of-two and a non-power-of-two width, the steered classify step
on 4×1, 8×1, 1×8 and 4×2 meshes (also held against the oracle, as the
reference test does), and ``TorchDatapath`` on a mesh through the engine:
parity with ``JITDatapath`` of the same geometry and with the
oracle-backed fake, CT checkpoints carried across shard layouts, and the
rehash."""

import random

import numpy as np
import pytest

import jax.numpy as jnp

from cilium_tpu.compile.ct_layout import CTConfig, make_ct_arrays
from cilium_tpu.compile.snapshot import build_snapshot
from cilium_tpu.kernels.hashing import hash_words_np
from cilium_tpu.kernels.records import batch_from_records, ct_key_words
from cilium_tpu.parallel import mesh as jmesh
from cilium_tpu.utils import constants as C
from cilium_tpu_torch.convert import to_numpy
from cilium_tpu_torch.parallel import mesh as tmesh
from oracle import Oracle
from tests.test_datapath import FIXTURE_RULES, TRAFFIC
from tests.test_parity import (build_world, extract_device_ct,
                               oracle_live_ct, random_packet)
from tests.test_torch_datapath import (PORT_GROUPS, PORT_PACK_STATS, SIDES,
                                       assert_ct_equal, assert_outs_equal,
                                       copy, mods, reference_keys)


@pytest.fixture(scope="module")
def world():
    ctx, repo, eps = build_world()
    snap = build_snapshot(repo, ctx, eps, CTConfig(capacity=4096))
    return ctx, snap


def reversed_batch(fwd):
    rev = {k: v.copy() for k, v in fwd.items()}
    rev["src"], rev["dst"] = fwd["dst"].copy(), fwd["src"].copy()
    rev["sport"], rev["dport"] = fwd["dport"].copy(), fwd["sport"].copy()
    rev["direction"] = 1 - fwd["direction"]
    return rev


class TestSteering:
    def test_directions_agree(self, world):
        _ctx, snap = world
        rng = random.Random(3)
        fwd = batch_from_records([random_packet(rng, []) for _ in range(64)],
                                 snap.ep_slot_of)
        rev = reversed_batch(fwd)
        for n in (3, 4):
            got = tmesh.flow_shard_of(fwd, n)
            np.testing.assert_array_equal(got, tmesh.flow_shard_of(rev, n))
            np.testing.assert_array_equal(got, jmesh.flow_shard_of(fwd, n))

    def test_steer_roundtrip(self, world):
        _ctx, snap = world
        rng = random.Random(4)
        batch = batch_from_records(
            [random_packet(rng, []) for _ in range(50)], snap.ep_slot_of,
            pad_to=64)
        steered, scatter, per = tmesh.steer_batch(batch, 4)
        want, want_scatter, want_per = jmesh.steer_batch(batch, 4)
        assert per == want_per
        np.testing.assert_array_equal(scatter, want_scatter)
        for k in want:
            np.testing.assert_array_equal(steered[k], want[k], k)
        shard = tmesh.flow_shard_of(batch, 4)
        for i in range(64):
            if batch["valid"][i]:
                assert steered["valid"][scatter[i]]
                assert scatter[i] // per == shard[i]
        out = {"x": np.arange(steered["valid"].shape[0], dtype=np.int64)}
        back = tmesh.unsteer_outputs(out, scatter)
        np.testing.assert_array_equal(
            back["x"], jmesh.unsteer_outputs(out, want_scatter)["x"])


@pytest.mark.parametrize("n", [3, 8])
def test_flow_shard_of_keys_is_the_host_steer(world, n):
    """The device hash equals the host steer at a non-power-of-two width,
    where a signed modulo of the int32 hash would go wrong: hashes at and
    above 2^31 are in the sample."""
    from cilium_tpu_torch.kernels.records import batch_to_torch
    from cilium_tpu_torch.kernels import conntrack as tctk
    from cilium_tpu_torch.parallel.exchange import flow_shard_of_keys
    _ctx, snap = world
    rng = random.Random(30 + n)
    b = batch_from_records([random_packet(rng, []) for _ in range(256)],
                           snap.ep_slot_of)
    fwd_np = ct_key_words(b, reverse=False)
    rev_np = ct_key_words(b, reverse=True)
    h = hash_words_np(fwd_np) ^ hash_words_np(rev_np)
    assert (h >= np.uint32(1 << 31)).any() and (h < np.uint32(1 << 31)).any()
    fwd, rev = tctk.ct_key_words_pair(batch_to_torch(b, "cpu"))
    got = flow_shard_of_keys(fwd, rev, n).numpy()
    assert got.dtype == np.int32 and got.min() >= 0
    np.testing.assert_array_equal(got, (h % np.uint32(n)).astype(np.int32))
    np.testing.assert_array_equal(got, tmesh.flow_shard_of(b, n))
    np.testing.assert_array_equal(got, jmesh.flow_shard_of(b, n))
    np.testing.assert_array_equal(
        got, flow_shard_of_keys(rev, fwd, n).numpy())


def _run_mesh_parity(n_flow, n_rule, seed=5, n_batches=4, batch=96):
    """The steered classify step on an ``n_flow × n_rule`` mesh, JAX and
    the port, on the same steered batches: equal in every out column, the
    counters and the CT; the port also against the oracle."""
    rng = random.Random(seed)
    ctx, repo, eps = build_world()
    cap = 4096
    snap = build_snapshot(repo, ctx, eps, CTConfig(capacity=cap))
    jm = jmesh.make_mesh(n_flow, n_rule)
    tm = tmesh.make_mesh(n_flow, n_rule, device="cpu")
    tensors_np = jmesh.pad_snapshot_tensors(snap.tensors(), n_rule)
    tensors_j = {k: jnp.asarray(v) for k, v in tensors_np.items()}
    placed = tmesh.place_mesh_tensors(snap.tensors(), tm)
    ct_np = make_ct_arrays(CTConfig(capacity=cap))
    ct_j = {k: jnp.asarray(v) for k, v in ct_np.items()}
    ct_t = tmesh.split_ct(ct_np, tm)
    fn_j = jmesh.make_sharded_classify_fn(jm, donate_ct=False)
    fn_t = tmesh.make_sharded_classify_fn(tm, donate_ct=True)
    oracle = Oracle(dict(zip(snap.ep_ids, snap.policies)),
                    ctx.ipcache.snapshot())
    prior = []
    now = 1000
    for bi in range(n_batches):
        packets = [random_packet(rng, prior) for _ in range(batch)]
        want = oracle.classify_batch_snapshot(packets, now)
        raw = batch_from_records(packets, snap.ep_slot_of)
        steered, scatter, _per = jmesh.steer_batch(raw, n_flow,
                                                   per_shard=batch)
        out_j, ct_j, cnt_j = fn_j(
            tensors_j, ct_j, {k: jnp.asarray(v) for k, v in steered.items()},
            jnp.uint32(now), jnp.int32(snap.world_index))
        out_t, ct_t, cnt_t = fn_t(placed, ct_t, copy(steered), now,
                                  snap.world_index)
        out_j = {k: np.asarray(v) for k, v in out_j.items()}
        out_t = to_numpy(out_t)
        assert_outs_equal(out_j, out_t, f"{n_flow}x{n_rule} batch {bi}")
        assert_outs_equal({k: np.asarray(v) for k, v in cnt_j.items()},
                          to_numpy(cnt_t), f"counters {bi}")
        assert_ct_equal({k: np.asarray(v) for k, v in ct_j.items()},
                        tmesh.join_ct(ct_t), f"batch {bi}")
        got = tmesh.unsteer_outputs(out_t, scatter)
        for i, v in enumerate(want):
            assert bool(got["allow"][i]) == v.allow, (n_flow, n_rule, bi, i)
            assert int(got["reason"][i]) == int(v.drop_reason), (bi, i)
            assert int(got["status"][i]) == int(v.ct_status), (bi, i)
        assert extract_device_ct(tmesh.join_ct(ct_t), now) \
            == oracle_live_ct(oracle, now)
        by = to_numpy(cnt_t)["by_reason_dir"].reshape(256, 2)
        assert int(by.sum()) == len(packets)
        prior.extend(p for p, v in zip(packets, want)
                     if v.allow and v.ct_status == C.CTStatus.NEW)
        prior = prior[-150:]
        now += 40


class TestMeshParity:
    def test_dp_4x1(self):
        _run_mesh_parity(4, 1)

    def test_dp_8x1(self):
        _run_mesh_parity(8, 1, seed=6)

    def test_rule_sharded_1x8(self):
        _run_mesh_parity(1, 8, seed=7)

    def test_combined_4x2(self):
        _run_mesh_parity(4, 2, seed=8)


# --------------------------------------------------------------------------- #
# TorchDatapath on a mesh, through the engine
# --------------------------------------------------------------------------- #
def fixture_engine(side, **kw):
    """``tests/test_datapath.fixture_engine`` over one side's package, on
    its own datapath (``"fake"``: the oracle-backed one of the JAX
    package)."""
    m = mods("jax" if side == "fake" else side)
    base = dict(ct_capacity=2048, auto_regen=False, flowlog_mode="all")
    base.update(kw)
    if side == "torch":
        base["device"] = "cpu"
    cfg = m.config.DaemonConfig(**base)
    dp = (m.datapath.FakeDatapath if side == "fake"
          else m.datapath.TorchDatapath if side == "torch"
          else m.datapath.JITDatapath)(cfg)
    eng = m.engine.Engine(cfg, datapath=dp)
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
    eng.add_endpoint(["k8s:role=fe"], ips=("192.168.1.30",), ep_id=3)
    eng.apply_policy(FIXTURE_RULES)
    return eng


SHARDED = dict(n_shards=4, rule_shards=2)


class TestShardedEngine:
    def test_engine_sharded_parity_vs_fake(self):
        """A 4×2 engine of each package and the fake: the two meshes equal
        in every column, the counters and the CT, the fake on the columns
        it reports — CT continuity across batches included."""
        ej, et = (fixture_engine(s, **SHARDED) for s in SIDES)
        ef = fixture_engine("fake")
        slots = et.active.snapshot.ep_slot_of
        assert slots == ej.active.snapshot.ep_slot_of
        now = 1000
        for rep in range(3):
            b = batch_from_records(TRAFFIC, slots)
            out_j = ej.classify(copy(b), now=now + rep * 5)
            out_t = et.classify(copy(b), now=now + rep * 5)
            out_f = ef.classify(copy(b), now=now + rep * 5)
            assert_outs_equal(out_j, out_t, f"rep {rep}")
            for k in ("allow", "reason", "status", "remote_identity",
                      "redirect", "svc", "rnat"):
                np.testing.assert_array_equal(out_f[k], out_t[k], (rep, k))
        assert out_t["status"][0] == C.CTStatus.ESTABLISHED
        assert et.ct_stats(now) == ef.ct_stats(now) == ej.ct_stats(now)
        assert_ct_equal(ej.ct_arrays(), et.ct_arrays())
        assert ej.datapath.hbm_ledger()["groups"] == reference_keys(
            et.datapath.hbm_ledger()["groups"], PORT_GROUPS)
        for e in (ej, et, ef):
            e.stop()

    def test_engine_sharded_random_traffic_parity(self):
        rng = random.Random(11)
        ej, et = (fixture_engine(s, **SHARDED) for s in SIDES)
        ef = fixture_engine("fake")
        slots = et.active.snapshot.ep_slot_of
        prior = []
        now = 2000
        for bi in range(4):
            packets = [random_packet(rng, prior) for _ in range(100)]
            b = batch_from_records(packets, slots)
            out_j = ej.classify(copy(b), now=now)
            out_t = et.classify(copy(b), now=now)
            out_f = ef.classify(copy(b), now=now)
            assert_outs_equal(out_j, out_t, f"batch {bi}")
            for k in ("allow", "reason", "status", "remote_identity"):
                np.testing.assert_array_equal(out_f[k], out_t[k], (bi, k))
            prior.extend(p for i, p in enumerate(packets)
                         if out_f["allow"][i]
                         and out_f["status"][i] == C.CTStatus.NEW)
            prior = prior[-120:]
            now += 30
        assert_ct_equal(ej.ct_arrays(), et.ct_arrays())
        assert ej.datapath.pack_stats == reference_keys(
            et.datapath.pack_stats, PORT_PACK_STATS)
        for e in (ej, et, ef):
            e.stop()

    def test_ct_checkpoint_across_shard_layouts(self):
        """CT exported from a mesh restores onto one device and back onto
        a 2-shard mesh: flows stay ESTABLISHED, and every table equals the
        JAX package's through the same steps."""
        def run(side):
            eng = fixture_engine(side, **SHARDED)
            b = batch_from_records(TRAFFIC, eng.active.snapshot.ep_slot_of)
            out0 = eng.classify(copy(b), now=1000)
            live = eng.ct_stats(1000)["live"]
            assert live > 0
            tables = [eng.ct_arrays()]
            one = fixture_engine(side)
            one.load_ct_arrays(tables[0])
            assert one.ct_stats(1000)["live"] == live
            out1 = one.classify(copy(b), now=1005)
            allowed = out0["allow"]
            assert (out1["status"][allowed] == C.CTStatus.ESTABLISHED).all()
            tables.append(one.ct_arrays())
            two = fixture_engine(side, n_shards=2)
            two.load_ct_arrays(tables[1])
            out2 = two.classify(copy(b), now=1010)
            assert (out2["status"][allowed] == C.CTStatus.ESTABLISHED).all()
            tables.append(two.ct_arrays())
            for e in (eng, one, two):
                e.stop()
            return tables, (out0, out1, out2)
        (tj, oj), (tt, ot) = run("jax"), run("torch")
        for i in range(3):
            assert_ct_equal(tj[i], tt[i], f"table {i}")
            assert_outs_equal(oj[i], ot[i], f"out {i}")

    def test_rehash_preserves_entries(self):
        """The port's rehash equals the JAX package's slot for slot, and
        every live entry survives it keyed by its key."""
        rng = np.random.default_rng(5)
        arrays = make_ct_arrays(CTConfig(capacity=1024))
        n = 200
        arrays["keys"][:n] = rng.integers(0, 2**32, (n, 10), dtype=np.uint32)
        arrays["keys"][:n, 9] = (arrays["keys"][:n, 9] & ~np.uint32(0xFF)) \
            | (arrays["keys"][:n, 9] & 1)          # direction ∈ {0,1}
        arrays["expiry"][:n] = 5000
        arrays["pkts_fwd"][:n] = np.arange(n)
        for shards, cap in ((4, None), (3, 768)):
            got, dropped = tmesh.rehash_ct_arrays(arrays, shards,
                                                  capacity=cap)
            want, want_dropped = jmesh.rehash_ct_arrays(arrays, shards,
                                                        capacity=cap)
            assert dropped == want_dropped == 0
            assert_ct_equal(want, got, f"{shards} shards")
            assert int((got["expiry"] > 0).sum()) == n
            src = {tuple(arrays["keys"][i]): int(arrays["pkts_fwd"][i])
                   for i in range(n)}
            for s in np.nonzero(got["expiry"] > 0)[0]:
                assert src[tuple(got["keys"][s])] == int(got["pkts_fwd"][s])
