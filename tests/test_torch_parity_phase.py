"""Phase parity of ``chip_smoke.py`` rehearsed on the CPU.

Each part of the phase (``chip_smoke.PARITY_PARTS``: cfg5's and mixed's
churn at the smoke preset, ``test_lb.py``'s service world,
``test_parity.py``'s world with enforcement never and always and batch by
batch against the sequential oracle, cfg5 at CT_FULL on a seeded
4,096-slot table with a whole-table sweep before its last batch, and
part (a)'s traffic through the port's served path, ``Engine.submit`` on
cfg5 built through the engine, with the auditor replaying every row)
runs through the phase's own loop, ``chip_smoke.parity_part``, twice:

- on the port (``DEVICE = "cpu"``: the kernel wrappers run their plain
  versions), every batch and the live CT after it against the port's
  oracle, exactly as on the card;
- on the JAX package's ``classify_step`` over the same batches (the
  port's run replayed), against ``oracle/``, on the JAX compile of the
  same world: cfg5 from ``bench.build_config5("smoke")`` (part (f)'s
  through the JAX package's engine API, as the port's), mixed from
  ``tests/test_torch_compile.py``, the rest from ``chip_smoke``'s
  declarations with the JAX package's modules.

Each side must find no mismatch with its oracle (counters included), and
the two sides must agree on every out column and counter of every batch,
the CT arrays at the end, and the counts the phase prints (rows, live
entries compared, expiries, reused slots, CT_FULL rows, tail evictions,
occupancy, the sweep's counts). The phase's copies of the reference
worlds' data are held equal to the reference's, and part (e)'s seeded
table is the one each package's oracle reaches by classifying the seeded
flows' packets.
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp

import bench
import chip_smoke as cs
from cilium_tpu.compile.ct_layout import CTConfig, make_ct_arrays
from cilium_tpu.kernels.classify import classify_step
from cilium_tpu.kernels.conntrack import ct_sweep_chunk
from cilium_tpu_torch.compile import ct_layout as port_ct
from cilium_tpu_torch.convert import ct_to_numpy
from cilium_tpu_torch.kernels.records import empty_batch
from cilium_tpu_torch.world import make_world
from tests import test_lb, test_parity
from tests.test_torch_compile import compiled
from tests.test_torch_parity import P

#: the JAX package's modules, by the names ``chip_smoke``'s parity helpers
#: use
JAX = P("jax")


@pytest.fixture(autouse=True)
def _smoke(monkeypatch):
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "PRESET", "smoke")


def test_copied_worlds_are_the_references():
    assert cs.PARITY_RULES == test_parity.RULES
    assert cs.PARITY_DSTS == test_parity.DST_POOL
    assert cs.PARITY_PORTS == test_parity.PORT_POOL
    assert cs.PARITY_PATHS == test_parity.PATHS
    assert cs.LB_RULES == test_lb.SVC_RULES


@functools.lru_cache(maxsize=None)
def jax_snapshot(part):
    """The JAX package's compile of part ``part``'s world (part (f)'s
    through the JAX package's engine, as ``chip_smoke.serve_engine``
    builds the port's)."""
    if part in ("cfg5", "ctfull"):
        return bench.build_config5("smoke")[0]
    if part == "engine":
        from cilium_tpu.runtime.config import DaemonConfig
        from cilium_tpu.runtime.datapath import FakeDatapath
        from cilium_tpu.runtime.engine import Engine
        z = cs.PARITY["smoke"]
        cfg = DaemonConfig(ct_capacity=z["cfg5_cap"],
                           batch_size=z["cfg5_rows"], v4_only=True,
                           auto_regen=False)
        eng = cs.cfg5_engine_world(
            Engine(cfg, datapath=FakeDatapath(cfg)), JAX, smoke=True)
        eng.stop()
        return eng.active.snapshot
    if part == "mixed":
        return compiled(JAX.pkg, "mixed")[0]
    if part == "services":
        return cs.parity_snapshot(JAX, cs.lb_world(JAX), 4096, lb=True)
    world = cs.parity_world(JAX)
    if part in ("never", "always"):
        from cilium_tpu.utils import constants as C
        world[0].enforcement_mode = {"never": C.ENFORCEMENT_NEVER,
                                     "always": C.ENFORCEMENT_ALWAYS}[part]
        return cs.parity_snapshot(JAX, world, 2048)
    return cs.parity_snapshot(JAX, world, 1024)


class JaxSide:
    """``classify_step`` of the JAX package over one snapshot and a fresh
    CT (or part (e)'s seeded ``image``), as ``parity_part``'s ``step``,
    ``live`` and ``sweep``."""

    def __init__(self, snap, cap, v4_only, image=None):
        self.snap, self.v4_only = snap, v4_only
        self.tensors = {k: jnp.asarray(v) for k, v in snap.tensors().items()}
        ct = make_ct_arrays(CTConfig(capacity=cap)) if image is None \
            else image.ct
        self.ct = {k: jnp.asarray(v) for k, v in ct.items()}

    def step(self, b, now):
        out, self.ct, cnt = classify_step(
            self.tensors, self.ct, {k: jnp.asarray(v) for k, v in b.items()},
            jnp.uint32(now), world_index=self.snap.world_index,
            v4_only=self.v4_only)
        return ({k: np.asarray(v) for k, v in out.items()}, 0.0, None,
                {k: np.asarray(v) for k, v in cnt.items()})

    def sweep(self, now):
        """The whole table through the JAX package's ``ct_sweep_chunk``
        in ``chip_smoke.port_sweep``'s chunks."""
        cap = self.ct["expiry"].shape[0]
        chunk = min(cap, cs.SERVE_GC_CHUNK)
        reclaimed = 0
        for start in range(0, cap, chunk):
            self.ct, n, live = ct_sweep_chunk(
                self.ct, jnp.uint32(now), jnp.uint32(start), chunk,
                count_now=jnp.uint32(now))
            reclaimed += int(n)
        return reclaimed, int(live)

    def ct_np(self):
        return {k: np.asarray(v) for k, v in self.ct.items()}

    def live(self, now):
        ct = self.ct_np()
        slots = np.nonzero(ct["expiry"] > now)[0]
        return (slots.astype(np.int64), ct["keys"][slots],
                {c: ct[c][slots].astype(np.int64) for c in cs.PARITY_CT})


def recording(outs):
    def wrap(step):
        def recorded(b, now):
            got = step(b, now)
            outs.append(got)
            return got
        return recorded
    return wrap


@pytest.mark.parametrize("part", cs.PARITY_PARTS)
def test_part_equals_the_reference(part):
    worlds = {}
    if part in ("cfg5", "mixed", "ctfull"):
        name = "mixed" if part == "mixed" else "cfg5"
        worlds[name] = make_world(name, seed=0, device="cpu", preset="smoke")
    spec = cs.parity_spec(part, worlds.get("cfg5"), worlds.get("mixed"))
    port_outs = []
    res_t, ct_t, _launches = cs.run_parity_part(spec, recording(port_outs))
    assert res_t.rows > 0 and res_t.ct_entries > 0
    if part == "cfg5":
        assert res_t.expired > 0 and res_t.reused > 0
        assert len(res_t.batches) == cs.PARITY["smoke"]["cfg5"]

    if part == "ctfull":
        cs.ctfull_checks(res_t, spec)
    if part == "engine":
        assert len(res_t.batches) == cs.PARITY["smoke"]["engine"]
        assert "0 mismatched" in cs.engine_audit_line(spec, res_t, "cpu")
        spec.engine.stop()
    snap_j = jax_snapshot(part)
    assert snap_j.world_index == spec.snap.world_index
    side = JaxSide(snap_j, spec.cap, spec.v4_only, spec.image)
    jax_outs = []
    replay = [(dict(b), now) for b, now in res_t.batches]
    res_j = cs.parity_part(
        spec.label, snap_j, JAX, recording(jax_outs)(side.step), side.live,
        lambda k, last: replay[k] if k < len(replay) else None, spec.cap,
        lb=spec.lb, sequential=spec.sequential, image=spec.image,
        sweep=None if spec.sweep_before is None
        else (spec.sweep_before, side.sweep))

    for attr in ("rows", "ct_entries", "expired", "reused", "ct_full",
                 "evicted", "occupancy", "swept"):
        assert getattr(res_j, attr) == getattr(res_t, attr), attr
    assert len(jax_outs) == len(port_outs) == len(res_t.batches)
    for i, (want, got) in enumerate(zip(jax_outs, port_outs)):
        for j in (0, 3):                      # out columns, counters
            for k in want[j]:
                np.testing.assert_array_equal(
                    got[j][k], want[j][k], err_msg=f"{part} batch {i}: {k}")
    want_ct = side.ct_np()
    got_ct = ct_to_numpy(ct_t)
    for k in want_ct:
        np.testing.assert_array_equal(got_ct[k], want_ct[k],
                                      err_msg=f"{part} CT {k}")


def test_ctfull_seed_equals_classified():
    """Part (e)'s seeding, at 4,096 slots: ``ctfull_install`` puts the
    image into a bounded table of the port's oracle equal to the one the
    oracle reaches by classifying the image's candidate flows one packet at
    a time (each flow's SYN, then its ACK, at ``CTFULL_T0``): the same
    entries at the same slots (key, flags, expiry, created, counters,
    rev-NAT). The candidates the image passed over are the ones the
    classified oracle dropped CT_FULL, and nothing was evicted. The port's
    CT loaded with the image holds the same live entries. (The reference's
    oracle is seeded the same way in ``test_part_equals_the_reference
    [ctfull]``; classifying cfg5's flows one at a time through it, whose
    LPM and ladder are unindexed, takes some 40 s on a CPU.)"""
    m = P("torch")
    cap, now = 4096, cs.CTFULL_T0
    image = cs.ctfull_image(cap, cs.CTFULL_SEED, smoke=True)
    assert image.slots.size / cap >= cs.CTFULL_FILL
    snap = make_world("cfg5", seed=0, device="cpu", preset="smoke").snapshot

    def table():
        return m.oracle.Oracle.for_snapshot(
            snap, m.oracle.ConntrackTable(capacity=cap, probe_depth=8))

    seeded, classified = table(), table()
    cs.ctfull_install(m, seeded.ct, image)
    n = len(image.flows)
    packets = []
    for flags in (m.C.TCP_SYN, m.C.TCP_ACK):
        b = empty_batch(n)
        cs.ctfull_rows(b, np.arange(n), image.flows, flags)
        packets.append(cs.batch_records(b, snap.ep_ids, m.oracle.PacketRecord))
    dropped = []
    for i, (syn, ack) in enumerate(zip(*packets)):
        v = classified.classify(syn, now)
        if v.drop_reason == m.C.DropReason.CT_FULL:
            dropped.append(i)
            continue
        assert v.allow, (i, v)
        assert classified.classify(ack, now).allow, i
    skipped = np.setdiff1d(np.arange(n), image.placed)
    assert dropped == skipped.tolist()
    assert classified.ct.evicted == 0
    assert classified.ct.insert_fail == skipped.size

    def entries(o):
        return {k: (e.slot, e.flags, e.expiry, e.created, e.pkts_fwd,
                    e.pkts_rev, e.rev_nat) for k, e in o.ct.entries.items()}

    assert entries(seeded) == entries(classified)
    assert len(seeded.ct.entries) == image.slots.size
    want = cs.oracle_live(classified, now)
    assert cs.ct_mismatches(cs.oracle_live(seeded, now), want) == []
    ct = port_ct.make_ct_arrays(port_ct.CTConfig(capacity=cap), "cpu")
    cs.ct_image_to(ct, image)
    assert cs.ct_mismatches(cs.device_live(ct, now), want) == []
