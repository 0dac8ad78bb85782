"""The scripted classify step against the same step run eagerly and
against the JAX package, on the CPU.

``make_classify_fn`` and the co-located mesh step run
``kernels/classify.classify_step`` as one TorchScript call a dispatch
(``classify.scripted``); the eager ``classify_step`` is the same Python
function called directly. Each case steers the same batches, made from a
seed, to ``n`` flow shards (1, 2, 4 and 8) and runs them five ways, each
on its own CT of the same size:

- ``eager``: ``classify_step`` called from Python over all rows, with the
  shard-major table and ``shards=n``, in place;
- ``scripted``: the entry point the CPU engine uses, on the batch dict:
  ``make_classify_fn`` at one shard, ``make_sharded_classify_fn`` on the
  co-located mesh above;
- ``wire``: the same on a packed wire, unpacked inside the scripted call
  (each world its own wire form: compact v4, full, L7 path-dictionary,
  address-dictionary), and ``wire_eager``: the eager step on the same
  wire unpacked from Python;
- ``jax``: the JAX package's ``make_classify_fn`` at one shard, its
  ``make_sharded_classify_fn`` on as many of the 8 virtual CPU devices of
  ``tests/conftest.py`` above.

Every out column (dtype included), the counters and the CT arrays are
held exactly equal, batch after batch; only the padding rows of a wire
differ from those of a batch dict (a compact wire's padding unpacks to
v4-mapped addresses), so the two wire ways are held equal to each other
in every row and to the others in the valid rows. The worlds: a v4-only
world
(``v4_only=True``, L7 rules), on a world with v6 rows, on a flood that
fills the table (CT_FULL and tail evictions), and on service flows and
their replies (rev-NAT). Beside them: the hoisted CT home slots against
separate hashes, the hash count of one step, and the Python-level torch
calls of one 8-shard steered dispatch of the QoS soak's engine.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mesh_dispatch as md
from cilium_tpu.compile import ct_layout as jct_layout
from cilium_tpu.kernels import classify as jcls
from cilium_tpu.kernels import hashing as jhash
from cilium_tpu.parallel import mesh as jmesh
from cilium_tpu_torch.compile.ct_layout import CTConfig, make_ct_arrays
from cilium_tpu_torch.convert import to_numpy
from cilium_tpu_torch.kernels import classify as tcls
from cilium_tpu_torch.kernels import conntrack as tctk
from cilium_tpu_torch.kernels import hashing as thash
from cilium_tpu_torch.kernels import records as trec
from cilium_tpu_torch.parallel import mesh as tmesh
from tests.test_torch_datapath import (assert_ct_equal, assert_outs_equal,
                                       bare_engine, rich_world,
                                       world_traffic)
from tests.test_torch_lb import svc_packet, svc_snapshot
from tests.test_torch_parity import P
from tests.test_torch_rss import _world_snapshot
from tests.test_torch_sharded_pipeline import P as SP

SHARDS = (1, 2, 4, 8)
WAYS = ("eager", "scripted", "jax", "wire_eager", "wire")
#: the ways whose padding rows unpack from a wire
WIRE_WAYS = ("wire_eager", "wire")

#: the Python-level torch calls one 8-shard steered CPU dispatch of the
#: QoS soak's engine makes (``mesh_dispatch.TorchCalls``): 23 (the wire's
#: upload, the outputs' moves to numpy in the finalize, the step's flow
#: fingerprints among them), and one more where the dispatch adds a
#: buffer to the wire pool
CALLS_BOUND = 24


class Ways:
    """The five ways of running one steered dispatch over ``n`` flow
    shards of ``cap`` CT slots, every batch steered to ``per`` rows a
    shard and packed by ``pack`` for the ``wire`` way."""

    def __init__(self, snaps, n, cap, per, pack, v4_only=False):
        self.snaps, self.n, self.per, self.pack = snaps, n, per, pack
        snap = snaps["torch"]
        assert snap.ep_slot_of == snaps["jax"].ep_slot_of
        self.wi = snap.world_index
        self.mesh = tmesh.make_mesh(n, 1, device="cpu")
        self.placed = tmesh.place_mesh_tensors(snap.tensors(), self.mesh)
        self.tensors = self.placed[self.mesh.device_of(0)]
        ct = {k: v.numpy().view(np.uint32) for k, v in
              make_ct_arrays(CTConfig(cap, 8), device="cpu").items()}
        ct_j = jct_layout.make_ct_arrays(jct_layout.CTConfig(cap, 8))
        assert_ct_equal({k: np.asarray(v) for k, v in ct_j.items()}, ct)
        self.v4_only = v4_only
        if n == 1:
            self.fns = {"scripted": tcls.make_classify_fn(
                            v4_only=v4_only, fused=False, device="cpu"),
                        "wire": tcls.make_classify_fn(
                            v4_only=v4_only, fused=False, packed=True,
                            device="cpu")}
            self.jfn = jcls.make_classify_fn(v4_only=v4_only,
                                             donate_ct=False)
            self.cts = {w: {k: torch.from_numpy(v.view(np.int32).copy())
                            for k, v in ct.items()} for w in WAYS}
        else:
            fn = tmesh.make_sharded_classify_fn(self.mesh, v4_only=v4_only,
                                                fused=False)
            self.fns = {"scripted": fn, "wire": fn}
            self.jfn = jmesh.make_sharded_classify_fn(
                jmesh.make_mesh(n, 1), v4_only=v4_only, donate_ct=False)
            self.cts = {w: tmesh.split_ct(ct, self.mesh) for w in WAYS}
            for w in ("eager", "wire_eager"):
                self.cts[w] = self.cts[w].table
        self.jtensors = {k: jnp.asarray(v) for k, v in
                         snaps["jax"].tensors().items()}
        self.cts["jax"] = {k: jnp.asarray(v) for k, v in ct_j.items()}

    def steer(self, raw):
        snap = self.snaps["torch"]
        lb = snap.lb if snap.lb.n_frontends else None
        steered, _scatter, _per = tmesh.steer_batch(
            raw, self.n, per_shard=self.per, lb=lb)
        return steered

    def step(self, raw, now):
        """One steered batch every way → {way: (out, counters)} in numpy,
        rows in the steered order."""
        steered = self.steer(raw)
        wire = self.pack(steered)
        got = {}
        for w, batch in (("eager", trec.batch_to_torch(steered, "cpu")),
                         ("wire_eager", trec.unpack_wire(
                             trec.wire_to_torch(wire, "cpu")))):
            out, self.cts[w], ctr = tcls.classify_step(
                self.tensors, self.cts[w], batch, now, self.wi,
                v4_only=self.v4_only, fused=False, inplace=True,
                shards=self.n)
            got[w] = (to_numpy(out), to_numpy(ctr))
        for w, batch in (("scripted", {k: v.copy()
                                       for k, v in steered.items()}),
                         ("wire", wire)):
            tensors = self.tensors if self.n == 1 else self.placed
            out, self.cts[w], ctr = self.fns[w](tensors, self.cts[w], batch,
                                                now, self.wi)
            got[w] = (to_numpy(out), to_numpy(ctr))
        out_j, self.cts["jax"], ctr_j = self.jfn(
            self.jtensors, self.cts["jax"],
            {k: jnp.asarray(v) for k, v in steered.items()},
            jnp.uint32(now), jnp.int32(self.snaps["jax"].world_index))
        got["jax"] = ({k: np.asarray(v) for k, v in out_j.items()},
                      {k: np.asarray(v) for k, v in ctr_j.items()})
        return got

    def tables(self):
        def table(ct):
            if isinstance(ct, list):
                return tmesh.join_ct(ct)
            return {k: v.numpy().view(np.uint32) for k, v in ct.items()}
        ct = {w: table(self.cts[w]) for w in WAYS if w != "jax"}
        ct["jax"] = {k: np.asarray(v) for k, v in self.cts["jax"].items()}
        return ct

    def check(self, got, valid):
        """Every way equal to the eager step, to the JAX package and, for
        a wire way, to the other wire way: out columns (dtype included;
        only the ``valid`` rows between a wire way and a dict way),
        counters and the CT arrays. → the eager step's result."""
        tables = self.tables()
        for ref in ("eager", "jax", "wire_eager"):
            out0, ctr0 = got[ref]
            for w in WAYS:
                if w == ref:
                    continue
                out, ctr = got[w]
                if (w in WIRE_WAYS) != (ref in WIRE_WAYS):
                    out0 = {k: v[valid] for k, v in got[ref][0].items()}
                    out = {k: v[valid] for k, v in out.items()}
                else:
                    out0 = got[ref][0]
                assert_outs_equal(out0, out, f"{w} vs {ref}")
                assert_outs_equal(ctr0, ctr, f"{w} vs {ref} counters")
                assert_ct_equal(tables[ref], tables[w], f"{w} vs {ref}")
        return got["eager"]

    def run(self, raw, now):
        """``step`` and ``check`` one batch → the eager step's result."""
        return self.check(self.step(raw, now), self.steer(raw)["valid"])


def engine_snaps(kind, cap):
    def snap(side):
        eng = rich_world(bare_engine(side, ct_capacity=cap), kind)
        try:
            return eng.active.snapshot
        finally:
            eng.stop()
    return {s: snap(s) for s in ("jax", "torch")}


@pytest.mark.parametrize("n", SHARDS)
def test_v4_only_world_with_l7_rules(n):
    """The L7 world with ``v4_only`` (the v6 walk elided), through the L7
    path-dictionary wire: allowed, denied and L7-dropped rows, new flows
    and their later packets."""
    snaps = engine_snaps("l7", 256 * n)
    ways = Ways(snaps, n, 256 * n, per=64, pack=trec.pack_batch_l7dict, v4_only=True)
    slots = snaps["torch"].ep_slot_of
    reasons = set()
    for i in range(4):
        raw = world_traffic("l7", slots, np.random.default_rng(10 + i), 32)
        assert not raw["is_v6"].any() and raw["http_path"].any()
        out, _ = ways.run(raw, 1000 + 5 * i)
        reasons |= set(out["reason"][out["reason"] != 0].tolist())
    assert reasons, "no row was dropped"


@pytest.mark.parametrize("n", SHARDS)
def test_world_with_v6_rows(n):
    """v6 endpoints and a v6 CIDR rule beside the v4 world, through the
    full wire: both families' LPM walks and CT keys."""
    snaps = engine_snaps("v6", 256 * n)
    ways = Ways(snaps, n, 256 * n, per=64, pack=trec.pack_batch)
    slots = snaps["torch"].ep_slot_of
    for i in range(4):
        raw = world_traffic("v6", slots, np.random.default_rng(20 + i), 32)
        assert raw["is_v6"].any() and not raw["is_v6"].all()
        ways.run(raw, 1000 + 5 * i)


@pytest.mark.parametrize("n", SHARDS)
def test_ct_full_flood_and_tail_eviction(n):
    """New allowed flows that overfill a small table, through the compact
    v4 wire: the same rows fail closed with CT_FULL and the same victims
    are tail-evicted every way."""
    m = SP("torch")
    snaps = {s: _world_snapshot(SP(s), ct_capacity=16 * n)
             for s in ("jax", "torch")}
    ways = Ways(snaps, n, 16 * n, per=64, pack=trec.pack_batch_v4)
    slots = snaps["torch"].ep_slot_of
    full = evicted = 0
    for i in range(6):
        rng = np.random.default_rng(100 + i)
        packets = [m.pkt("192.168.1.10",
                         f"10.{rng.integers(0, 200)}."
                         f"{rng.integers(0, 250)}.{rng.integers(1, 250)}",
                         int(1024 + rng.integers(0, 60000)), 443)
                   for _ in range(24 * n)]
        raw = P("torch").records.batch_from_records(packets, slots)
        out, ctr = ways.run(raw, 1000 + 7 * i)
        full += int(out["ct_full"].sum())
        evicted += int(ctr["ct_evicted"])
    assert full > 0 and evicted > 0, (full, evicted)


@pytest.mark.parametrize("n", SHARDS)
def test_service_replies_rev_nat(n):
    """SYNs to a service VIP, then the backends' replies, through the
    address-dictionary wire: DNAT, the replies' REPLY status and their
    rewrite back to the VIP."""
    m = P("torch")
    C = m.C
    snaps = {s: svc_snapshot(P(s)) for s in ("jax", "torch")}
    ways = Ways(snaps, n, 4096, per=32, pack=trec.pack_batch_addrdict)
    slots = snaps["torch"].ep_slot_of
    rng = random.Random(8 + n)
    syns = [svc_packet(m, rng, "172.20.0.10", 80, sport=42000 + i)
            for i in range(12 * n)]
    out, _ = ways.run(m.records.batch_from_records(syns, slots), 1000)
    rows = ways.steer(m.records.batch_from_records(syns, slots))
    assert out["svc"].any()
    replies = []
    for i in np.nonzero(rows["valid"])[0]:
        dst = b"".join(int(w).to_bytes(4, "big") for w in out["nat_dst"][i])
        src = b"".join(int(w).to_bytes(4, "big") for w in rows["src"][i])
        replies.append(m.oracle.PacketRecord(
            dst, src, int(out["nat_dport"][i]), int(rows["sport"][i]),
            C.PROTO_TCP, C.TCP_SYN | C.TCP_ACK, False, 1, C.DIR_INGRESS))
    out2, _ = ways.run(m.records.batch_from_records(replies, slots),
                       1010)
    valid = ways.steer(m.records.batch_from_records(replies,
                                                    slots))["valid"]
    assert (out2["status"][valid] == int(C.CTStatus.REPLY)).all()
    assert out2["rnat"][valid].all()


@pytest.mark.parametrize("cap,shards", [(4096, 1), (4096, 8), (64, 4)])
def test_hoisted_home_slots_equal_three_hashes(cap, shards):
    """``conntrack.ct_home_pair`` (one hash over both orientations) gives
    the home slots that the forward probe, the reverse probe and the
    insert each hashed for themselves before, and the JAX package's
    hash."""
    rng = np.random.default_rng(cap + shards)
    fwd = torch.from_numpy(rng.integers(-2**31, 2**31, (300, 10),
                                        dtype=np.int64).astype(np.int32))
    rev = tctk.reverse_key_words(fwd)
    fwd_home, rev_home = tctk.ct_home_pair(fwd, rev, cap, shards)
    mask = cap // shards - 1
    probe_fwd = thash.hash_words_u64(fwd) & mask
    probe_rev = thash.hash_words_u64(rev) & mask
    insert_fwd = thash.hash_words_u64(fwd) & mask
    assert torch.equal(fwd_home, probe_fwd)
    assert torch.equal(rev_home, probe_rev)
    assert torch.equal(fwd_home, insert_fwd)
    want = np.asarray(jhash.hash_words_jnp(
        jnp.asarray(fwd.numpy().view(np.uint32)))) & np.uint32(mask)
    np.testing.assert_array_equal(fwd_home.numpy(), want.astype(np.int64))
    assert fwd_home.dtype == rev_home.dtype == torch.int64


@pytest.mark.parametrize("fused", [False, True])
def test_ct_keys_hash_once_a_step(monkeypatch, fused):
    """The CT stages of one eager step over 4 co-located shards hash the
    keys once on the plain path: one hash over both orientations of every
    row, reused by both probes and the insert. On the kernel path K2
    hashes its keys itself (here its CPU stand-in, once over each shard's
    rows), and the insert hashes the forward keys once."""
    calls = []
    real = tctk.hash_words_u64

    def counting(words):
        calls.append(words.shape[0])
        return real(words)

    monkeypatch.setattr(tctk, "hash_words_u64", counting)
    snaps = {s: _world_snapshot(SP(s), ct_capacity=256)
             for s in ("jax", "torch")}
    m = SP("torch")
    raw = P("torch").records.batch_from_records(
        [m.pkt("192.168.1.10", f"10.0.0.{i}", 1024 + i, 443)
         for i in range(1, 33)], snaps["torch"].ep_slot_of)
    ways = Ways(snaps, 4, 256, per=32, pack=trec.pack_batch_v4)
    steered = ways.steer(raw)
    tcls.classify_step(ways.tensors, ways.cts["eager"],
                       trec.batch_to_torch(steered, "cpu"), 1000, ways.wi,
                       fused=fused, inplace=True, shards=4)
    rows = 4 * 32
    assert calls == ([2 * 32] * 4 + [rows] if fused else [2 * rows])


def test_steered_dispatch_python_torch_calls():
    """One 8-shard steered dispatch of the QoS soak's engine (batch 512,
    2,048 steered rows, CT 2^12) makes at most ``CALLS_BOUND`` torch
    calls from Python, counted by a ``TorchFunctionMode`` on the calling
    thread, and one call of the scripted step."""
    eng = md.engine()
    timer = md.Timed(eng.datapath)
    try:
        for i in range(3):
            eng.submit(md.submission(eng, i, md.TENANTS[i % 3]),
                       now=1000 + i)
        assert eng.drain(timeout=120)
        del timer.steps[:], timer.dispatches[:]
        counts = md.calls_per_dispatch(eng, timer, n=6, start=3)
    finally:
        timer.restore()
        eng.stop()
    assert counts and len(timer.steps) == len(timer.dispatches)
    assert {rows for _d, _t, rows, _e in timer.dispatches} == {2048}
    totals = [sum(c.values()) for c in counts]
    assert max(totals) <= CALLS_BOUND, (totals, counts)
