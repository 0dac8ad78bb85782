"""The steered step of a co-located mesh (every flow shard on one device,
rule axis 1: ``parallel/mesh.make_sharded_classify_fn``) against the JAX
mesh of the same geometry and against a per-shard loop, on the CPU.

On such a mesh the step is one ``kernels/classify.classify_step`` over
all rows: the stateless stages (service LB, the LPM walk, the policy
interior, rev-NAT, the counter tally) run once, the probe pair and the CT
update see the flow shards through their shard-major table. Each case
feeds the same steered batches, made from a seed, to:

- ``shard_major``: the restructured step in place on ``split_ct``'s
  shard-major table, with ``fused`` (the probe pair once per shard, as K2
  runs on the card; here each call takes the plain version);
- ``copy``: the same without ``donate_ct`` or ``fused`` (the plain probe
  once over the shard-major table, as the CPU engine runs it);
- ``loop``: ``classify_step`` once per flow shard on its own segment of
  the rows and its own CT table, the step this one replaced;
- ``jax``: the JAX package's ``make_sharded_classify_fn`` on as many of
  the 8 virtual CPU devices ``tests/conftest.py`` provisions, steered by
  the JAX package from its own snapshot;

at 2, 4 and 8 flow shards, and holds every out column (dtype included),
the counters and the CT arrays exactly equal across the four: a flood
that fills the table (CT_FULL and tail evictions), and service flows with
their replies (rev-NAT). The per-shard K2 composition is held against one
plain pass over the shard-major table, and ``classify_pre_ct`` calls are
counted a dispatch: once on a co-located mesh, once per flow shard on a
2 × 2 mesh and with device RSS.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cilium_tpu.compile import ct_layout as jct_layout
from cilium_tpu.parallel import mesh as jmesh
from cilium_tpu_torch.compile.ct_layout import CTConfig, make_ct_arrays
from cilium_tpu_torch.convert import to_numpy
from cilium_tpu_torch.kernels import classify as tcls
from cilium_tpu_torch.parallel import exchange as tex
from cilium_tpu_torch.parallel import mesh as tmesh
from tests.test_torch_datapath import assert_ct_equal, assert_outs_equal
from tests.test_torch_lb import svc_packet, svc_snapshot
from tests.test_torch_parity import P
from tests.test_torch_rss import _world_snapshot
from tests.test_torch_sharded_pipeline import P as SP

WAYS = ("shard_major", "copy", "loop", "jax")


class Steps:
    """The four ways of running one steered dispatch on an ``n`` × 1
    co-located mesh, each on its own CT of ``cap`` slots, every batch
    steered to ``per`` rows a shard. ``snaps`` holds each package's
    snapshot of the same world."""

    def __init__(self, snaps, n, cap, per):
        self.snaps, self.n, self.per = snaps, n, per
        snap = snaps["torch"]
        assert snap.ep_slot_of == snaps["jax"].ep_slot_of
        self.mesh = tmesh.make_mesh(n, 1, device="cpu")
        assert self.mesh.colocated
        self.placed = tmesh.place_mesh_tensors(snap.tensors(), self.mesh)
        ct = {k: v.numpy().view(np.uint32) for k, v in
              make_ct_arrays(CTConfig(cap, 8), device="cpu").items()}
        ct_j = jct_layout.make_ct_arrays(jct_layout.CTConfig(cap, 8))
        assert_ct_equal({k: np.asarray(v) for k, v in ct_j.items()}, ct)
        self.fns = {
            "shard_major": tmesh.make_sharded_classify_fn(self.mesh),
            "copy": tmesh.make_sharded_classify_fn(
                self.mesh, donate_ct=False, fused=False),
        }
        self.cts = {w: tmesh.split_ct(ct, self.mesh) for w in self.fns}
        assert isinstance(self.cts["shard_major"], tmesh.CTShards)
        self.cts["loop"] = [{k: v.clone() for k, v in t.items()}
                            for t in tmesh.split_ct(ct, self.mesh)]
        self.jfn = jmesh.make_sharded_classify_fn(jmesh.make_mesh(n, 1),
                                                  donate_ct=False)
        self.jtensors = {k: jnp.asarray(v) for k, v in
                         snaps["jax"].tensors().items()}
        self.cts["jax"] = {k: jnp.asarray(v) for k, v in ct_j.items()}

    def steer(self, side, mesh, packets):
        snap = self.snaps[side]
        raw = P(side).records.batch_from_records(packets, snap.ep_slot_of)
        lb = snap.lb if snap.lb.n_frontends else None
        return raw, mesh.steer_batch(raw, self.n, per_shard=self.per, lb=lb)

    def loop(self, steered, now):
        """``classify_step`` once per flow shard → (out, counters)."""
        views, _axes = tmesh.shard_views(self.placed, self.mesh)
        batches = tmesh.split_batch(steered, self.mesh)
        res = [tcls.classify_step(views[f], self.cts["loop"][f],
                                  batches[f], now,
                                  self.snaps["torch"].world_index)
               for f in range(self.n)]
        self.cts["loop"] = [r[1] for r in res]
        out = {k: torch.cat([r[0][k] for r in res]) for k in res[0][0]}
        return out, tmesh.sum_counters([r[2] for r in res], "cpu")

    def step(self, packets, now):
        """→ {way: (out, counters)} in numpy, rows in packet order."""
        raw, (steered, scatter, _per) = self.steer("torch", tmesh, packets)
        raw_j, (steered_j, scatter_j, _) = self.steer("jax", jmesh, packets)
        assert_outs_equal(raw_j, raw, "raw batch")
        assert_outs_equal(steered_j, steered, "steered batch")
        np.testing.assert_array_equal(scatter_j, scatter)
        wi = self.snaps["torch"].world_index
        got = {}
        for w, fn in self.fns.items():
            out, self.cts[w], ctr = fn(
                self.placed, self.cts[w],
                {k: v.copy() for k, v in steered.items()}, now, wi)
            got[w] = (to_numpy(out), to_numpy(ctr))
        got["loop"] = tuple(to_numpy(d) for d in self.loop(
            {k: v.copy() for k, v in steered.items()}, now))
        out_j, self.cts["jax"], ctr_j = self.jfn(
            self.jtensors, self.cts["jax"],
            {k: jnp.asarray(v) for k, v in steered_j.items()},
            jnp.uint32(now), jnp.int32(self.snaps["jax"].world_index))
        got["jax"] = ({k: np.asarray(v) for k, v in out_j.items()},
                      {k: np.asarray(v) for k, v in ctr_j.items()})
        return {w: (tmesh.unsteer_outputs(out, scatter), ctr)
                for w, (out, ctr) in got.items()}

    def tables(self):
        ct = {w: tmesh.join_ct(self.cts[w]) for w in WAYS[:-1]}
        ct["jax"] = {k: np.asarray(v) for k, v in self.cts["jax"].items()}
        return ct

    def check(self, got):
        """Every way equal to the JAX mesh and to the per-shard loop: out
        columns (dtype included), counters and the CT arrays. → the JAX
        mesh's result."""
        tables = self.tables()
        for ref in ("jax", "loop"):
            out0, ctr0 = got[ref]
            for w in WAYS:
                if w == ref:
                    continue
                out, ctr = got[w]
                assert_outs_equal(out0, out, f"{w} vs {ref}")
                assert_outs_equal(ctr0, ctr, f"{w} vs {ref} counters")
                assert_ct_equal(tables[ref], tables[w], f"{w} vs {ref}")
        return got["jax"]


def world_snaps(cap):
    return {s: _world_snapshot(SP(s), ct_capacity=cap) for s in ("jax",
                                                                 "torch")}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ct_full_flood_equals_the_per_shard_loop(n):
    """New allowed flows into a table they overfill: every way fails the
    same rows closed with CT_FULL and tail-evicts the same victims."""
    m = SP("torch")
    steps = Steps(world_snaps(16 * n), n, 16 * n, per=64)
    full = evicted = 0
    for i in range(6):
        rng = np.random.default_rng(100 + i)
        packets = [m.pkt("192.168.1.10",
                         f"10.{rng.integers(0, 200)}."
                         f"{rng.integers(0, 250)}.{rng.integers(1, 250)}",
                         int(1024 + rng.integers(0, 60000)), 443)
                   for _ in range(24 * n)]
        out, ctr = steps.check(steps.step(packets, 1000 + 7 * i))
        full += int(out["ct_full"].sum())
        evicted += int(ctr["ct_evicted"])
        assert int(ctr["insert_fail"]) == int(out["ct_full"].sum())
    assert full > 0 and evicted > 0, (full, evicted)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_service_replies_rev_nat_equal_the_per_shard_loop(n):
    """SYNs to a service VIP, then the backends' replies: the replies hit
    CT as REPLY and are rewritten back to the VIP (rev-NAT) the same way
    on every way."""
    m = P("torch")
    steps = Steps({s: svc_snapshot(P(s)) for s in ("jax", "torch")}, n,
                  4096, per=32)
    C = m.C
    rng = random.Random(8 + n)
    syns = [svc_packet(m, rng, "172.20.0.10", 80, sport=42000 + i)
            for i in range(12 * n)]
    out, _ = steps.check(steps.step(syns, 1000))
    assert out["svc"].any()
    # the replies come from the backend each SYN was sent to
    backends = [tuple(int(w) for w in out["nat_dst"][i])
                for i in range(len(syns))]
    replies = []
    for i, p in enumerate(syns):
        addr = b"".join(int(w).to_bytes(4, "big") for w in backends[i])
        replies.append(m.oracle.PacketRecord(
            addr, p.src_addr, int(out["nat_dport"][i]), p.src_port,
            C.PROTO_TCP, C.TCP_SYN | C.TCP_ACK, False, 1, C.DIR_INGRESS))
    out2, _ = steps.check(steps.step(replies, 1010))
    assert (out2["status"] == int(C.CTStatus.REPLY)).all()
    assert out2["rnat"].all()


@pytest.mark.parametrize("geometry,per_dispatch", [
    (dict(n_shards=4), 1),
    (dict(n_shards=2, rule_shards=2), 2),
    (dict(n_shards=4, rss_mode="device"), 4),
], ids=["4x1", "2x2", "device4"])
def test_pre_ct_runs_once_per_dispatch_on_a_colocated_mesh(
        monkeypatch, geometry, per_dispatch):
    """``classify_pre_ct`` (service LB, the LPM walk: K1 on the card) runs
    once a dispatch on a co-located flow-only mesh, and once per flow
    shard on a rule-sharded mesh and with device RSS."""
    calls = []
    real = tcls.classify_pre_ct

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tcls, "classify_pre_ct", counting)
    monkeypatch.setattr(tex, "classify_pre_ct", counting)
    # the scripted step calls no Python stage function: count its stages
    # in the same step run eagerly
    monkeypatch.setattr(tcls, "run_scripted",
                        lambda fn, *a, **k: fn(*a, **k))
    m = SP("torch")
    eng = m.jit_pipeline_engine(**geometry)
    slot_of = eng.active.snapshot.ep_slot_of
    try:
        for i, ch in enumerate(m._mk_phase(slot_of, 3, (5, 17, 9), seed=7)):
            del calls[:]
            out = eng.classify(dict(ch), now=1000 + i)
            assert out["allow"].shape[0] == ch["valid"].shape[0]
            assert len(calls) == per_dispatch, (geometry, len(calls))
    finally:
        eng.stop()


@pytest.mark.parametrize("n", [2, 4])
def test_probe_pair_per_shard_equals_one_pass(n):
    """The probe pair over a shard-major table: with ``fused``, once per
    shard on its slot range (K2's composition on the card; each call takes
    the plain version on these CPU tensors), equal to the plain probe run
    once over every row, hits as global slots."""
    from cilium_tpu_torch.kernels import conntrack as tctk
    from cilium_tpu_torch.kernels import fused as tfk
    m = SP("torch")
    steps = Steps(world_snaps(64 * n), n, 64 * n, per=32)
    rng = np.random.default_rng(n)
    packets = [m.pkt("192.168.1.10", f"10.1.{rng.integers(0, 250)}."
                     f"{rng.integers(1, 250)}",
                     int(1024 + rng.integers(0, 60000)), 443)
               for _ in range(16 * n)]
    steps.check(steps.step(packets, 1000))      # fill some of the table
    _raw, (steered, _scatter, _per) = steps.steer("torch", tmesh,
                                                  packets + packets[:8])
    batch = tmesh.whole_batch(steered, steps.mesh)
    fwd, rev = tctk.ct_key_words_pair(batch)
    table = steps.cts["shard_major"].table
    one = tfk.ct_probe_pair_sharded(table, fwd, rev, 1001, 8, n,
                                    fused=False)
    each = tfk.ct_probe_pair_sharded(table, fwd, rev, 1001, 8, n,
                                     fused=True)
    assert (one[0] >= 0).any()
    for a, b in zip(one, each):
        assert a.dtype == b.dtype == torch.int32
        assert torch.equal(a, b)
