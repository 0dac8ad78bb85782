"""End-to-end parity of the port's classify step with the semantics
oracle, case for case with ``test_parity.py``, on both packages.

The contract (``test_parity.py``'s docstring): for randomised rules and
packet streams the classify step gives verdicts bit-identical to the
oracle's snapshot batch mode, and the device CT holds exactly the oracle's
live entries (flags, expiry, counters, rev-NAT).

Each case runs the reference's scenario on each package: the JAX side as
its own tests run it (``classify_step`` on ``jax.numpy`` arrays, against
``oracle/``), the port on CPU tensors (``cilium_tpu_torch.kernels.
classify.classify_step``, whose kernel wrappers run their plain versions
there) against its own ``cilium_tpu_torch.oracle``. Each side asserts the
reference's expectations against its own oracle, and the two sides'
results (every compared column, every live CT entry, the out columns and
CT arrays of the wire cases) are held equal, exactly. ``run_parity`` runs
on the port with ``fused=True`` and ``fused=False``, as ``test_fused.py``
reruns it on the JAX side; the JAX trajectory is computed once per case.
"""

import functools
import importlib
import random
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke as cs
from tests import test_parity
from tests.test_torch_datapath import PORT_OUT

SIDES = ("jax", "torch")
PKG = {"jax": "cilium_tpu", "torch": "cilium_tpu_torch"}
ORACLE = {"jax": "oracle", "torch": "cilium_tpu_torch.oracle"}
#: the columns ``run_parity`` holds against the oracle
PARITY_COLS = ("allow", "reason", "status", "remote_identity",
               "matched_rule", "lpm_prefix", "ct_state_pre")


@functools.lru_cache(maxsize=None)
def P(side):
    """One package's modules, in the reference's terms."""
    pkg = PKG[side]
    names = {"ct_layout": "compile.ct_layout", "snapshot": "compile.snapshot",
             "lbc": "compile.lb", "classify": "kernels.classify",
             "lbk": "kernels.lb", "records": "kernels.records",
             "endpoint": "model.endpoint", "identity": "model.identity",
             "ipcache": "model.ipcache", "labels": "model.labels",
             "rules": "model.rules", "services": "model.services",
             "selectors": "model.selectors", "policy": "policy",
             "selectorcache": "policy.selectorcache",
             "repository": "policy.repository", "mapstate": "policy.mapstate",
             "C": "utils.constants", "ip": "utils.ip"}
    ns = {k: importlib.import_module(f"{pkg}.{v}") for k, v in names.items()}
    ns["oracle"] = importlib.import_module(ORACLE[side])
    return SimpleNamespace(side=side, pkg=pkg, **ns)


def both(case):
    """Run ``case(m)`` on each package; the two results must be equal."""
    obs = {s: case(P(s)) for s in SIDES}
    assert obs["jax"] == obs["torch"]
    return obs["torch"]


# --------------------------------------------------------------------------- #
# the reference's world and traffic: ``chip_smoke``'s copies, over one
# package's modules
# --------------------------------------------------------------------------- #
def test_world_is_the_references():
    """``chip_smoke``'s copy of the world compiles to
    ``test_parity.build_world``'s snapshot on both packages, and its copy
    of the traffic draws the reference's packets."""
    from cilium_tpu.compile.ct_layout import CTConfig
    from cilium_tpu.compile.snapshot import build_snapshot
    from tests.test_torch_compile import assert_tensors_equal
    ctx, repo, eps = test_parity.build_world()
    want = build_snapshot(repo, ctx, eps, CTConfig(capacity=4096)).tensors()
    for side in SIDES:
        m = P(side)
        assert_tensors_equal(cs.parity_snapshot(m, cs.parity_world(m),
                                                4096).tensors(), want, side)
    rng_a, rng_b = random.Random(5), random.Random(5)
    prior_a, prior_b = [], []
    for _ in range(200):
        a = test_parity.random_packet(rng_a, prior_a)
        b = cs.parity_packet(P("jax"), rng_b, prior_b)
        assert a == b
        prior_a.append(a)
        prior_b.append(b)


class Device:
    """One package's classify step over a placed snapshot and its CT:
    ``jax.numpy`` arrays on the JAX side, CPU tensors on the port. Batches
    go in and results come out as numpy, in the reference's dtypes."""

    def __init__(self, m, snap, cap, **step_kw):
        self.m, self.snap, self.kw = m, snap, step_kw
        ct = m.ct_layout.CTConfig(capacity=cap)
        if m.side == "jax":
            import jax.numpy as jnp
            self.tensors = {k: jnp.asarray(v)
                            for k, v in snap.tensors().items()}
            self.ct = {k: jnp.asarray(v)
                       for k, v in m.ct_layout.make_ct_arrays(ct).items()}
        else:
            from cilium_tpu_torch import convert
            self.tensors = convert.snapshot_tensors_to_torch(snap.tensors(),
                                                             "cpu")
            self.ct = m.ct_layout.make_ct_arrays(ct, "cpu")

    def step(self, batch, now):
        """Classify a numpy batch dict at ``now``. → (out, counters)."""
        if self.m.side == "jax":
            import jax.numpy as jnp
            out, self.ct, cnt = self.m.classify.classify_step(
                self.tensors, self.ct,
                {k: jnp.asarray(v) for k, v in batch.items()},
                jnp.uint32(now), jnp.int32(self.snap.world_index),
                **self.kw)
            return ({k: np.asarray(v) for k, v in out.items()},
                    {k: np.asarray(v) for k, v in cnt.items()})
        from cilium_tpu_torch import convert
        out, self.ct, cnt = self.m.classify.classify_step(
            self.tensors, self.ct,
            self.m.records.batch_to_torch(batch, "cpu"), now,
            self.snap.world_index, **self.kw)
        return convert.to_numpy(out), convert.to_numpy(cnt)

    def records(self, packets, now):
        return self.step(self.m.records.batch_from_records(
            packets, self.snap.ep_slot_of), now)

    def ct_np(self):
        """The CT arrays as uint32 numpy."""
        if self.m.side == "jax":
            return {k: np.asarray(v) for k, v in self.ct.items()}
        from cilium_tpu_torch import convert
        return convert.ct_to_numpy(self.ct)


def extract_device_ct(m, ct, now):
    """``test_parity.extract_device_ct`` over uint32 numpy CT arrays."""
    keys, expiry = ct["keys"], ct["expiry"]
    out = {}
    for slot in np.nonzero(expiry > now)[0]:
        w = keys[slot]
        key = (m.ip.words_to_addr(w[0:4]), m.ip.words_to_addr(w[4:8]),
               int(w[8]) >> 16, int(w[8]) & 0xFFFF, int(w[9]) >> 8,
               int(w[9]) & 0xFF)
        out[key] = (int(ct["flags"][slot]), int(expiry[slot]),
                    int(ct["pkts_fwd"][slot]), int(ct["pkts_rev"][slot]),
                    int(ct["rev_nat"][slot]))
    return out


def oracle_live_ct(oracle, now):
    """``test_parity.oracle_live_ct``."""
    return {key: (e.flags, e.expiry, e.pkts_fwd, e.pkts_rev, e.rev_nat)
            for key, e in oracle.ct.entries.items() if e.expiry > now}


def assert_ct_matches(m, dev, oracle, now, what):
    """The device's live CT = the oracle's; → it, sorted (comparable)."""
    dev_ct = extract_device_ct(m, dev.ct_np(), now)
    ora_ct = oracle_live_ct(oracle, now)
    only_dev = {k: v for k, v in dev_ct.items() if ora_ct.get(k) != v}
    only_ora = {k: v for k, v in ora_ct.items() if dev_ct.get(k) != v}
    assert dev_ct == ora_ct, (f"{m.side} {what}: CT divergence\n"
                              f"only-device: {only_dev}\n"
                              f"only-oracle: {only_ora}")
    return sorted(dev_ct.items())


def simple_oracle(m, snap, ctx):
    """The reference's ``Oracle(policies, ipcache)`` (no provenance)."""
    return m.oracle.Oracle(dict(zip(snap.ep_ids, snap.policies)),
                           ctx.ipcache.snapshot())


# --------------------------------------------------------------------------- #
# run_parity
# --------------------------------------------------------------------------- #
def run_parity(m, seed, n_batches=6, batch=96, cap=4096, time_step=40,
               **step_kw):
    """``test_parity.run_parity`` on ``m``'s package: every row's columns
    against the oracle's snapshot batch mode, the live CT after every
    batch. → per batch, the compared columns and the live CT."""
    C = m.C
    rng = random.Random(seed)
    ctx, repo, eps = cs.parity_world(m)
    snap = cs.parity_snapshot(m, (ctx, repo, eps), cap)
    dev = Device(m, snap, cap, **step_kw)
    oracle = m.oracle.Oracle.for_snapshot(snap)
    prior, seen = [], []
    now = 1000
    for bi in range(n_batches):
        packets = [cs.parity_packet(m, rng, prior) for _ in range(batch)]
        want = oracle.classify_batch_snapshot(packets, now)
        out, _cnt = dev.records(packets, now)
        for i, (p, v) in enumerate(zip(packets, want)):
            got = (bool(out["allow"][i]), int(out["reason"][i]),
                   int(out["status"][i]), int(out["remote_identity"][i]),
                   int(out["matched_rule"][i]), int(out["lpm_prefix"][i]),
                   int(out["ct_state_pre"][i]))
            exp = (v.allow, int(v.drop_reason), int(v.ct_status),
                   v.remote_identity, v.matched_rule, v.lpm_prefix,
                   int(v.ct_status))
            assert got == exp, (f"{m.side} seed={seed} batch={bi} pkt={i}: "
                                f"{got} != {exp} ({p})")
        seen.append(({k: out[k].tolist() for k in PARITY_COLS},
                     assert_ct_matches(m, dev, oracle, now,
                                       f"seed={seed} batch={bi}")))
        prior.extend(p for p, v in zip(packets, want)
                     if v.allow and v.ct_status == C.CTStatus.NEW)
        prior = prior[-200:]
        now += time_step
    return seen


@functools.lru_cache(maxsize=None)
def jax_parity(seed, **kw):
    return run_parity(P("jax"), seed, **kw)


def parity_both(seed, fused, **kw):
    want = jax_parity(seed, **kw)
    got = run_parity(P("torch"), seed, fused=fused, **kw)
    assert got == want


FUSED = pytest.mark.parametrize("fused", [True, False],
                                ids=["fused", "plain"])


class TestKernelOracleParity:
    @FUSED
    @pytest.mark.parametrize("seed", range(4))
    def test_randomized_multibatch(self, seed, fused):
        parity_both(seed, fused)

    @pytest.mark.parametrize("mode", ["never", "always"])
    def test_enforcement_modes(self, mode):
        """Unenforced directions bypass DENY/REDIRECT cells on the device
        path exactly as the oracle skips the ladder."""
        def case(m):
            C = m.C
            rng = random.Random(11)
            ctx, repo, eps = cs.parity_world(m)
            ctx.enforcement_mode = {"never": C.ENFORCEMENT_NEVER,
                                    "always": C.ENFORCEMENT_ALWAYS}[mode]
            snap = cs.parity_snapshot(m, (ctx, repo, eps), 2048)
            dev = Device(m, snap, 2048)
            oracle = simple_oracle(m, snap, ctx)
            prior, seen = [], []
            now = 100
            for bi in range(3):
                packets = [cs.parity_packet(m, rng, prior)
                           for _ in range(64)]
                want = oracle.classify_batch_snapshot(packets, now)
                out, _ = dev.records(packets, now)
                for i, v in enumerate(want):
                    assert bool(out["allow"][i]) == v.allow, (mode, bi, i)
                    assert int(out["reason"][i]) == int(v.drop_reason), \
                        (mode, bi, i)
                seen.append((out["allow"].tolist(), out["reason"].tolist(),
                             assert_ct_matches(m, dev, oracle, now, mode)))
                prior.extend(p for p, v in zip(packets, want)
                             if v.allow and v.ct_status == C.CTStatus.NEW)
                now += 40
            return seen
        both(case)

    def test_per_endpoint_enforcement_override(self):
        def case(m):
            C = m.C
            ctx, repo, eps = cs.parity_world(m)
            eps[2].enforcement = C.ENFORCEMENT_ALWAYS  # fe: default-deny
            snap = cs.parity_snapshot(m, (ctx, repo, eps), 1024)
            dev = Device(m, snap, 1024)
            oracle = simple_oracle(m, snap, ctx)
            s16, _ = m.ip.parse_addr("192.168.1.30")
            d16, _ = m.ip.parse_addr("8.8.8.8")
            p = m.oracle.PacketRecord(s16, d16, 40000, 443, C.PROTO_TCP,
                                      C.TCP_SYN, False, 3, C.DIR_EGRESS)
            v = oracle.classify(p, 100)
            out, _ = dev.records([p], 100)
            assert not v.allow  # always-mode, no rules for fe → deny
            assert bool(out["allow"][0]) == v.allow
            assert int(out["reason"][0]) == int(v.drop_reason)
            return bool(out["allow"][0]), int(out["reason"][0])
        both(case)

    @FUSED
    def test_long_horizon_with_expiry(self, fused):
        # large time steps force SYN-timeout expiries and slot reuse
        parity_both(99, fused, n_batches=8, batch=64, time_step=90)

    def test_batch_of_one_matches_sequential(self):
        def case(m):
            C = m.C
            rng = random.Random(7)
            ctx, repo, eps = cs.parity_world(m)
            snap = cs.parity_snapshot(m, (ctx, repo, eps), 1024)
            dev = Device(m, snap, 1024)
            oracle = simple_oracle(m, snap, ctx)
            prior, seen = [], []
            now = 500
            for i in range(40):
                p = cs.parity_packet(m, rng, prior)
                v = oracle.classify(p, now)          # SEQUENTIAL mode
                out, _ = dev.records([p], now)
                got = (bool(out["allow"][0]), int(out["reason"][0]),
                       int(out["status"][0]))
                assert got == (v.allow, int(v.drop_reason),
                               int(v.ct_status)), (i, p)
                seen.append(got)
                if v.allow and v.ct_status == C.CTStatus.NEW:
                    prior.append(p)
                now += 13
            return seen, assert_ct_matches(m, dev, oracle, now, "seq")
        both(case)


# --------------------------------------------------------------------------- #
# the packed wires
# --------------------------------------------------------------------------- #
class Fns:
    """One package's dict-path and packed-path classify functions (CT not
    donated), its wire packers, and the device unpack of a wire."""

    def __init__(self, m):
        self.m = m
        mk = m.classify.make_classify_fn
        kw = {"device": "cpu"} if m.side == "torch" else {}
        self.fn_dict = mk(donate_ct=False, **kw)
        self.fn_packed = mk(donate_ct=False, packed=True, **kw)

    def place(self, snap, cap):
        dev = Device(self.m, snap, cap)
        return dev.tensors, dev.ct, Device(self.m, snap, cap).ct

    def unpack(self, parts):
        r = self.m.records
        if self.m.side == "jax":
            import jax.numpy as jnp
            parts = [jnp.asarray(p) for p in parts]
            fn = (r.unpack_batch_jnp if len(parts) == 1
                  else r.unpack_batch_addrdict_jnp)
        else:
            parts = [r.wire_to_torch(p, "cpu") for p in parts]
            fn = r.unpack_batch if len(parts) == 1 \
                else r.unpack_batch_addrdict
        return {k: np.asarray(v) for k, v in fn(*parts).items()}

    def run(self, fn, tensors, ct, batch, now, world_index):
        if self.m.side == "jax":
            import jax.numpy as jnp
            if isinstance(batch, dict):
                batch = {k: jnp.asarray(v) for k, v in batch.items()}
            elif isinstance(batch, tuple):
                batch = tuple(jnp.asarray(p) for p in batch)
            else:
                batch = jnp.asarray(batch)
            out, ct, _ = fn(tensors, ct, batch, jnp.uint32(now),
                            jnp.int32(world_index))
            return {k: np.asarray(v) for k, v in out.items()}, ct, \
                {k: np.asarray(v) for k, v in ct.items()}
        from cilium_tpu_torch import convert
        out, ct, _ = fn(tensors, ct, batch, now, world_index)
        return convert.to_numpy(out), ct, convert.ct_to_numpy(ct)


def wire_case(m, seed, now, pack, pack_l7):
    """``test_packed_path_bit_identical`` / ``test_addrdict_wire_bit_
    identical`` on ``m``'s package: the wire round trip reproduces every
    column, and the packed path equals the dict path in every out column
    and CT array. → the dict path's outs and CTs."""
    rng = random.Random(seed)
    f = Fns(m)
    ctx, repo, eps = cs.parity_world(m)
    snap = cs.parity_snapshot(m, (ctx, repo, eps), 4096)
    tensors, ct_a, ct_b = f.place(snap, 4096)
    prior, seen = [], []
    for bi in range(3):
        packets = [cs.parity_packet(m, rng, prior) for _ in range(64)]
        raw = m.records.batch_from_records(packets, snap.ep_slot_of)
        parts = pack_l7(raw)
        unpacked = f.unpack(parts if isinstance(parts, tuple) else (parts,))
        for k in raw:
            np.testing.assert_array_equal(
                unpacked[k].astype(raw[k].dtype), raw[k], k)
        out_a, ct_a, np_a = f.run(f.fn_dict, tensors, ct_a, raw, now,
                                  snap.world_index)
        out_b, ct_b, np_b = f.run(f.fn_packed, tensors, ct_b, pack(raw),
                                  now, snap.world_index)
        for k in out_a:
            np.testing.assert_array_equal(out_a[k], out_b[k], k)
        for k in np_a:
            np.testing.assert_array_equal(np_a[k], np_b[k], k)
        # the port's own columns were held between its two paths above
        seen.append(({k: v.tolist() for k, v in out_a.items()
                      if k not in PORT_OUT},
                     {k: v.tolist() for k, v in np_a.items()}))
        prior.extend(packets)
        prior = prior[-100:]
        now += 40
    return seen


def test_packed_path_bit_identical():
    """The packed wire (one uint32 array) gives exactly the dict path's
    outputs and CT state."""
    both(lambda m: wire_case(
        m, 11, 500, m.records.pack_batch,
        lambda raw: m.records.pack_batch(raw, l7=True)))


def test_addrdict_wire_bit_identical():
    """The address-dictionary wire matches the dict path exactly, for
    mixed v4/v6 and for L7-token traffic (the 4-word variant); the port's
    ``pack_batch_addrdict`` / ``unpack_batch_addrdict``."""
    both(lambda m: wire_case(
        m, 12, 700, m.records.pack_batch_addrdict,
        lambda raw: m.records.pack_batch_addrdict(raw, l7=True)))
