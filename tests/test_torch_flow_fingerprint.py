"""The classify step's flow fingerprints (``est_fp``) and the CT-salvage
note that stamps them, on the CPU.

- ``fused.flow_fingerprint_plain``, the fingerprint kernel's plain version
  (what the CPU step runs), equals ``shim.feeder.flow_hashes`` bit for bit:
  v4 and v6 rows, both directions, invalid rows holding any values, row
  counts that are not a multiple of the kernel's block;
- the step's ``est_fp`` is of the tuple as it arrived: a service row's
  fingerprint is its pre-DNAT tuple's, on the kernel path and the plain
  path alike;
- ``EstablishedFingerprints.note`` and ``hits`` given the step's
  fingerprints leave the reference's table bytes and give its hits, on a
  batch whose rows collide in slots;
- the engine's pipeline finalize takes ``est_fp`` out of the step's
  outputs: the tickets, ``Engine.classify`` and the folds see the
  reference's columns, the salvage table equals the JAX engine's byte for
  byte, and ``ct_salvage_fp_rows_total`` counts the stamped rows under
  ``source="step"`` (``"host"`` where no classify step built the outputs).
"""

import time

import numpy as np
import pytest

from cilium_tpu.shim import feeder as ref_feeder
from cilium_tpu_torch.compile.ct_layout import CTConfig, make_ct_arrays
from cilium_tpu_torch.kernels import fused as fk
from cilium_tpu_torch.kernels.classify import make_classify_fn
from cilium_tpu_torch.kernels.edge_cases import fingerprint_rows
from cilium_tpu_torch.kernels.records import batch_to_torch
from cilium_tpu_torch.shim import feeder
from cilium_tpu_torch.utils import constants as C
from tests.test_torch_datapath import (SIDES, bare_engine, copy, rich_world,
                                       world_traffic)

FP_COLS = ("src", "dst", "sport", "dport", "proto", "direction")
STEP = 'ct_salvage_fp_rows_total{source="step"}'
HOST = 'ct_salvage_fp_rows_total{source="host"}'


def step_fp(b):
    """The plain fingerprint of a host batch's rows → uint32."""
    t = batch_to_torch({k: b[k] for k in FP_COLS}, "cpu")
    return fk.flow_fingerprint_plain(*(t[k] for k in FP_COLS)) \
        .numpy().view(np.uint32)


@pytest.mark.parametrize("n", [1, 255, 256, 1003])
def test_plain_equals_flow_hashes(n):
    b = fingerprint_rows(n, seed=n)
    got = step_fp(b)
    assert got.dtype == np.uint32 and got.shape == (n,)
    np.testing.assert_array_equal(got, feeder.flow_hashes(b))
    np.testing.assert_array_equal(got, ref_feeder.flow_hashes(b))


def test_both_directions_of_a_flow_share_a_fingerprint():
    b = fingerprint_rows(64, seed=5)
    rev = dict(b, src=b["dst"], dst=b["src"], sport=b["dport"],
               dport=b["sport"], direction=1 - b["direction"])
    v = b["valid"]
    np.testing.assert_array_equal(step_fp(b)[v], step_fp(rev)[v])


@pytest.mark.parametrize("fused", [True, False])
def test_step_fingerprints_the_untranslated_tuple(fused):
    """A service world's batch through the CPU step (the kernel wrapper's
    plain route, then the plain route itself): ``est_fp`` is
    ``flow_hashes`` of the rows as submitted, and the DNAT-ed rows' differ
    from their translated tuple's."""
    eng = rich_world(bare_engine("torch"), "lb")
    b = world_traffic("lb", eng.active.snapshot.ep_slot_of,
                      np.random.default_rng(3), n=200)
    b["valid"][-7:] = False                  # a few invalid rows too
    fn = make_classify_fn(packed=False, fused=fused, device="cpu")
    ct = make_ct_arrays(CTConfig(capacity=2048), "cpu")
    out, _ct, _cnt = fn(dict(eng.active.tensors), ct, copy(b), 1000,
                        eng.active.snapshot.world_index)
    got = out["est_fp"].numpy().view(np.uint32)
    np.testing.assert_array_equal(got, feeder.flow_hashes(b))
    svc = out["svc"].numpy()
    assert svc.sum() >= 20
    nat = dict(b, dst=out["nat_dst"].numpy().view(np.uint32),
               dport=out["nat_dport"].numpy())
    assert (got[svc] != feeder.flow_hashes(nat)[svc]).all()
    eng.stop()


def stamped_out(n, seed):
    """Verdicts for ``n`` rows: allowed ESTABLISHED, REPLY and NEW rows and
    denied ones."""
    rng = np.random.default_rng(seed)
    return {"allow": rng.random(n) < 0.7,
            "status": rng.choice([int(C.CTStatus.NEW),
                                  int(C.CTStatus.ESTABLISHED),
                                  int(C.CTStatus.REPLY)], n).astype(np.int32)}


def test_note_with_step_fingerprints_keeps_the_reference_table():
    """A 16-slot table and 400 rows: rows of one batch collide in every
    slot. Stamped with the step's fingerprints, the table's bytes equal
    the reference's, which hashes on the host (the later row of a slot
    wins on both); ``hits`` agree on the batch, its reverse and fresh
    rows."""
    b = fingerprint_rows(400, seed=11)
    out = stamped_out(400, seed=12)
    fp = step_fp(b)
    ref = ref_feeder.EstablishedFingerprints(slots=16)
    port = feeder.EstablishedFingerprints(slots=16)
    host = feeder.EstablishedFingerprints(slots=16)
    ref.note(b, out)
    n = port.note(b, out, fp)
    assert host.note(b, out) == n
    m = out["allow"] & (out["status"] != int(C.CTStatus.NEW)) & b["valid"]
    assert n == int(m.sum())
    slots = fp[m] & 15
    assert len(set(zip(slots.tolist(), fp[m].tolist()))) > 16   # collisions
    assert port._tab.tobytes() == ref._tab.tobytes() == host._tab.tobytes()
    rev = dict(b, src=b["dst"], dst=b["src"], sport=b["dport"],
               dport=b["sport"], direction=1 - b["direction"])
    for probe in (b, rev, fingerprint_rows(400, seed=13)):
        want = ref.hits(probe)
        np.testing.assert_array_equal(port.hits(probe, step_fp(probe)), want)
        np.testing.assert_array_equal(port.hits(probe), want)


def test_note_without_stampable_rows_counts_none():
    fp = feeder.EstablishedFingerprints(slots=16)
    b = fingerprint_rows(8, seed=1)
    out = {"allow": np.zeros(8, bool),
           "status": np.full(8, int(C.CTStatus.ESTABLISHED), np.int32)}
    assert fp.note(b, out, step_fp(b)) == 0
    assert fp.note({}, {}) == 0                  # swallowed, as before
    assert not fp._tab.any()


def lb_batches(seed, n_batches, rows):
    """Seeded batches of ``rich_world("lb")``'s traffic."""
    eng = rich_world(bare_engine("torch"), "lb")
    slots = eng.active.snapshot.ep_slot_of
    eng.stop()
    rng = np.random.default_rng(seed)
    return [world_traffic("lb", slots, rng, n=rows) for _ in range(n_batches)]


def _served(side, batches, fold_outs=None):
    """``rich_world("lb")`` on ``side`` with the auditor at sampling 1.0:
    ``batches`` through ``Engine.submit``. → (engine, results);
    ``fold_outs`` collects the out columns the folds were handed."""
    eng = rich_world(bare_engine(side, audit_enabled=True), "lb")
    eng.auditor.configure(sample_rate=1.0)
    if fold_outs is not None:
        for obj, attr in ((eng.auditor, "maybe_capture"),
                          (eng.flowmetrics, "add_batch"),
                          (eng.blackbox, "record_verdicts")):
            real = getattr(obj, attr)

            def seen(*a, _real=real, **kw):
                fold_outs.append(sorted(next(
                    x for x in a if isinstance(x, dict) and "allow" in x)))
                return _real(*a, **kw)
            setattr(obj, attr, seen)
    # one at a time: batches in flight together share a dispatch, whose
    # rows all probe the table as of its start
    return eng, [eng.submit(copy(b), now=1000 + 2 * i).result(timeout=60)
                 for i, b in enumerate(batches)]


def test_pipeline_finalize_stamps_the_step_fingerprints():
    """Both packages serve the same service-world batches (new flows,
    their repeats, replies, DNAT-ed rows): the port's tickets and folds
    see the reference's columns, its salvage table equals the JAX
    engine's byte for byte, and every stamped row counts under
    ``source="step"``."""
    batches = lb_batches(7, 5, 96)
    folds = []
    (ej, rj), (et, rt) = (_served(s, batches, folds if s == "torch"
                                  else None) for s in SIDES)
    for want, got in zip(rj, rt):
        assert sorted(got) == sorted(want) and "est_fp" not in got
        for k in want:
            np.testing.assert_array_equal(np.asarray(want[k]),
                                          np.asarray(got[k]), k)
    assert folds and all("est_fp" not in cols for cols in folds)
    assert all(cols == sorted(rt[0]) for cols in folds)
    stamped = sum(int((r["allow"] & (r["status"] != int(C.CTStatus.NEW))
                       & b["valid"]).sum()) for r, b in zip(rt, batches))
    assert stamped > 50
    assert et.metrics.counters.get(STEP) == stamped
    assert HOST not in et.metrics.counters
    assert et._salvage_fp._tab.tobytes() == ej._salvage_fp._tab.tobytes()
    got = et.classify(copy(batches[0]), now=1100)
    want = ej.classify(copy(batches[0]), now=1100)
    assert sorted(got) == sorted(want)
    for e in (ej, et):
        e.stop()


def test_host_hash_where_the_step_gives_no_fingerprints():
    """The port's ``FakeDatapath`` builds outputs without a classify step:
    the note hashes on the host, counts under ``source="host"``, and its
    table equals the reference fake engine's."""
    from tests.test_torch_pipeline import fake_engine, host
    batches = lb_batches(9, 3, 48)
    engines = []
    for side in SIDES:
        eng = rich_world(fake_engine(host(side), ct_capacity=2048), "lb")
        results = [eng.submit(copy(b), now=1000 + i).result(timeout=60)
                   for i, b in enumerate(batches)]
        engines.append(eng)
    ej, et = engines
    stamped = sum(int((r["allow"] & (r["status"] != int(C.CTStatus.NEW))
                       & b["valid"]).sum()) for r, b in zip(results, batches))
    assert stamped > 0
    assert et.metrics.counters.get(HOST) == stamped
    assert STEP not in et.metrics.counters
    assert et._salvage_fp._tab.tobytes() == ej._salvage_fp._tab.tobytes()
    for e in engines:
        e.stop()


def test_grace_window_reads_the_step_fingerprints():
    """Inside the post-remesh grace window a denied row whose flow was
    stamped established flips to allow, by the step's fingerprints as by
    the host's hash."""
    eng = rich_world(bare_engine("torch"), "lb")
    b = fingerprint_rows(64, seed=21)
    b["valid"][:] = True
    fp = step_fp(b)
    est = {"allow": np.ones(64, bool),
           "status": np.full(64, int(C.CTStatus.ESTABLISHED), np.int32),
           "reason": np.zeros(64, np.int32)}
    denied = {"allow": np.arange(64) % 2 == 0,
              "status": np.full(64, int(C.CTStatus.NEW), np.int32),
              "reason": np.where(np.arange(64) % 2 == 0, 0,
                                 int(C.DropReason.POLICY)).astype(np.int32)}
    fresh = fingerprint_rows(64, seed=22)
    fresh["valid"][:] = True
    flipped = []
    for given in (fp, None):
        eng._salvage_fp = feeder.EstablishedFingerprints()
        eng._salvage_until = 0.0
        eng._ct_salvage_apply(b, est, given)
        eng._salvage_until = time.monotonic() + 60
        got = eng._ct_salvage_apply(b, denied, given)
        assert got["allow"].all() and not got["reason"].any()
        other = eng._ct_salvage_apply(
            fresh, denied, None if given is None else step_fp(fresh))
        np.testing.assert_array_equal(other["allow"], denied["allow"])
        flipped.append(eng.metrics.counters["ct_salvage_grace_hits_total"])
    assert flipped == [32, 64]
    assert eng.metrics.counters[STEP] == eng.metrics.counters[HOST] == 64
    eng.stop()
