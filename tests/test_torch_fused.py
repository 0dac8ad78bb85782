"""The port's kernel path against the JAX package's, case for case with
``tests/test_fused.py``: the LPM walk's property fuzz, the CT key pair,
the CT probe pair, the policy + L7 + verdict stage, the classify step
against the oracle and against the plain path, the kernel selector, and
serving (engine, pipeline, mesh, auditor).

On the CPU the port's kernel wrappers (``cilium_tpu_torch/kernels/
fused.py``) run their plain versions, which is what the port's
``fused_kernels="auto"`` runs there (``"on"`` raises: the CUDA kernels
have no CPU build). So each case that the reference runs with its Pallas
interior on holds the port's wrapper path, plain on the CPU, against the
port's own references (host walks, the plain stages, the oracle) and
against the JAX package's results. ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold the kernels themselves against the plain versions
on the card.

The JAX side's executor: the kernel-level cases run the Pallas kernels in
interpret mode as ``test_fused.py`` does (``FUSED_KW``); the step-level
and serving cases run the JAX package through its jnp reference
(``fused=False``, ``fused_kernels="off"``), which ``test_fused.py`` itself
holds equal to interpret mode case by case, because interpret mode there
would make this file the suite's long pole (each case's docstring says
which). Not mirrored, JAX-only: ``test_fuse_plan_budget_gates_per_stage``
(``fuse_plan`` is not ported).
``test_v6_walk_at_100k_prefixes`` and ``TestFusedSoak`` keep ``slow``.
"""

import random
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
from cilium_tpu.compile import lpm as j_lpm
from cilium_tpu.kernels import conntrack as j_ctk
from cilium_tpu.kernels import fused as j_fk
from cilium_tpu.kernels.classify import classify_interior_core as j_interior
from cilium_tpu.kernels.lpm import lpm_lookup_batch, lpm_lookup_prov_batch
from cilium_tpu.runtime.api import status_doc as j_status_doc
from cilium_tpu.runtime.config import DaemonConfig as JConfig
from cilium_tpu.runtime.datapath import FakeDatapath as JFake
from cilium_tpu.runtime.datapath import resolve_fused as j_resolve_fused
from cilium_tpu.runtime.engine import Engine as JEngine
from cilium_tpu_torch import convert
from cilium_tpu_torch.compile import lpm as t_lpm
from cilium_tpu_torch.kernels import conntrack as t_ctk
from cilium_tpu_torch.kernels import fused as t_fk
from cilium_tpu_torch.kernels import records as t_records
from cilium_tpu_torch.kernels.classify import \
    classify_interior_core as t_interior
from cilium_tpu_torch.kernels.lpm import lpm_walk_prov_core
from cilium_tpu_torch.runtime.api import status_doc as t_status_doc
from cilium_tpu_torch.runtime.config import DaemonConfig as TConfig
from cilium_tpu_torch.runtime.datapath import FakeDatapath as TFake
from cilium_tpu_torch.runtime.datapath import TorchDatapath
from cilium_tpu_torch.runtime.datapath import resolve_fused as t_resolve_fused
from cilium_tpu_torch.runtime.engine import Engine as TEngine
from tests.test_datapath import FIXTURE_RULES
from tests.test_fused import (FUSED_KW, _chunks, _fuzz_addresses,
                              _random_batch, _random_prefix_set, jit_engine)
from tests.test_sharded_pipeline import ORACLE_KEYS, fake_serial_engine
from tests.test_torch_parity import P, Device, run_parity

SIDES = ("jax", "torch")
OUT_KEYS = ("allow", "reason", "status", "remote_identity", "redirect",
            "svc", "nat_dst", "nat_dport", "rnat", "rnat_src", "rnat_sport")


def ints(a):
    """An array (or tensor) as a list of ints."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.int64).tolist()


def u32(a):
    """u32 words (uint32, or the port's int32 bit patterns) as a list of
    the reference's uint32 values."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32).astype(np.int64).tolist()


# --------------------------------------------------------------------------- #
# LPM: property-fuzz parity over random prefix sets
# --------------------------------------------------------------------------- #
def _lpm_side(side, entries, probes, default_index):
    """``test_fused._lpm_parity`` on one package: its host walk (the trie's
    reference) against its device walks. JAX: the jnp walk and the Pallas
    kernel in interpret mode. The port: K1's wrapper (its plain version on
    the CPU, what ``fused=True`` runs here) and the plain walk itself.
    → the host walk's identity indices and provenance."""
    lpm = j_lpm if side == "jax" else t_lpm
    idents = sorted(set(entries.values()))
    identity_index = {i: n for n, i in enumerate(idents)}
    tables = lpm.build_lpm(entries, identity_index, default_index)
    want = np.asarray([lpm.lpm_lookup_host(tables, a, v6)
                       for a, v6 in probes], dtype=np.int32)
    want_meta = np.asarray([lpm.lpm_lookup_host_prov(tables, a, v6)[1]
                            for a, v6 in probes], dtype=np.int32)
    addr = np.stack([np.frombuffer(a, dtype=">u4").astype(np.uint32)
                     for a, _ in probes])
    is_v6 = np.asarray([v6 for _, v6 in probes])
    if side == "jax":
        v4n, v6n = jnp.asarray(tables.v4_nodes), jnp.asarray(tables.v6_nodes)
        args = (v4n, v6n, jnp.asarray(addr), jnp.asarray(is_v6),
                default_index)
        walks = {"jnp": lpm_lookup_prov_batch(*args),
                 "fused": j_fk.lpm_lookup_fused(*args, interpret=True)}
        if not is_v6.any():
            walks["fused v4_only"] = j_fk.lpm_lookup_fused(
                *args, v4_only=True, interpret=True)
    else:
        args = (torch.as_tensor(tables.v4_nodes),
                torch.as_tensor(tables.v6_nodes),
                torch.as_tensor(addr.view(np.int32)), torch.as_tensor(is_v6),
                default_index)
        walks = {"plain": lpm_walk_prov_core(*args),
                 "fused": t_fk.lpm_lookup_fused(*args)}
        if not is_v6.any():
            walks["fused v4_only"] = t_fk.lpm_lookup_fused(*args,
                                                          v4_only=True)
    for name, (got, meta) in walks.items():
        np.testing.assert_array_equal(ints(got), want, f"{side} {name}")
        np.testing.assert_array_equal(ints(meta), want_meta,
                                      f"{side} {name} provenance")
    return want.tolist(), want_meta.tolist(), tables.v4_nodes.tobytes(), \
        tables.v6_nodes.tobytes()


def lpm_parity(entries, probes, default_index=0):
    """Each package's walks = its host walk, and the two packages' host
    walks and tries equal."""
    obs = [_lpm_side(s, entries, probes, default_index) for s in SIDES]
    assert obs[0] == obs[1]


class TestLPMFuzzParity:
    """JAX side: the jnp walk and the Pallas kernel in interpret mode."""

    @pytest.mark.parametrize("seed", range(4))
    def test_random_mixed_family_sets(self, seed):
        rng = np.random.default_rng(seed)
        entries = _random_prefix_set(rng, n_v4=120, n_v6=80)
        probes = _fuzz_addresses(rng, entries, 256)
        lpm_parity(entries, probes, default_index=int(rng.integers(0, 5)))

    def test_v4_only_sets(self):
        rng = np.random.default_rng(9)
        entries = _random_prefix_set(rng, n_v4=200, n_v6=0)
        probes = [p for p in _fuzz_addresses(rng, entries, 128) if not p[1]]
        lpm_parity(entries, probes)

    def test_empty_table_resolves_default(self):
        lpm_parity({}, _fuzz_addresses(np.random.default_rng(1), {}, 32),
                   default_index=7)

    def test_grid_block_path(self):
        """2048 probes: the reference's ROW_BLOCK grid (2 blocks)."""
        rng = np.random.default_rng(5)
        entries = _random_prefix_set(rng, n_v4=60, n_v6=40)
        lpm_parity(entries, _fuzz_addresses(rng, entries, 2048))

    @pytest.mark.slow
    def test_v6_walk_at_100k_prefixes(self):
        """The 16-level walk over 100k v6 /56 prefixes under one /32."""
        rng = np.random.default_rng(42)
        entries = {}
        while len(entries) < 100_000:
            b4, b5, b6 = (int(rng.integers(0, 256)),
                          int(rng.integers(0, 256)),
                          int(rng.integers(0, 256)))
            entries[f"2001:db8:{b4:02x}{b5:02x}:{b6:02x}00::/56"] = \
                int(rng.integers(1, 64))
        probes = [p for p in _fuzz_addresses(rng, entries, 1024) if p[1]]
        lpm_parity(entries, probes)


# --------------------------------------------------------------------------- #
# CT probe pair + key-pair derivation
# --------------------------------------------------------------------------- #
class TestCtKeyPair:
    def test_pair_matches_two_sided_normalization(self):
        rng = random.Random(3)
        for _trial in range(3):
            raw = _random_batch(rng, 64)
            bj = {k: jnp.asarray(v) for k, v in raw.items()}
            bt = t_records.batch_to_torch(raw, "cpu")
            seen = []
            for fwd, rev, one in (
                    (*j_ctk.ct_key_words_pair(bj),
                     lambda r: j_ctk.ct_key_words_jnp(bj, reverse=r)),
                    (*t_ctk.ct_key_words_pair(bt),
                     lambda r: t_records.ct_key_words(bt, reverse=r))):
                assert u32(fwd) == u32(one(False))
                assert u32(rev) == u32(one(True))
                seen.append((u32(fwd), u32(rev)))
            assert seen[0] == seen[1]


def _populated_ct(side, rng_state, cap=1024, n_flows=300):
    """``TestCtProbePairFused._populated_ct`` on one package, from the
    same ``random.Random`` state. → (ct, the seeding batch as numpy)."""
    rng = random.Random()
    rng.setstate(rng_state)
    raw = _random_batch(rng, n_flows)
    if side == "jax":
        from cilium_tpu.compile.ct_layout import CTConfig, make_ct_arrays
        ct = {k: jnp.asarray(v)
              for k, v in make_ct_arrays(CTConfig(capacity=cap)).items()}
        b = {k: jnp.asarray(v) for k, v in raw.items()}
        keys = j_ctk.ct_key_words_jnp(b)
        nk, ncr, zm, slot, _f, _e = j_ctk.ct_insert_new(
            ct, keys, jnp.ones((n_flows,), bool), jnp.uint32(100))
        ct = j_ctk.ct_apply(ct, b, slot, jnp.zeros((n_flows,), bool),
                            slot >= 0, jnp.uint32(100), new_keys=nk,
                            new_created=ncr, zero_mask=zm)
    else:
        from cilium_tpu_torch.compile.ct_layout import (CTConfig,
                                                         make_ct_arrays)
        ct = make_ct_arrays(CTConfig(capacity=cap), "cpu")
        b = t_records.batch_to_torch(raw, "cpu")
        keys = t_ctk.ct_key_words_pair(b)[0]
        nk, ncr, zm, slot, _f, _e = t_ctk.ct_insert_new(
            ct, keys, torch.ones((n_flows,), dtype=torch.bool), 100)
        ct = t_ctk.ct_apply(ct, b, slot, torch.zeros((n_flows,),
                                                     dtype=torch.bool),
                            slot >= 0, 100, new_keys=nk, new_created=ncr,
                            zero_mask=zm)
    return ct, raw, rng.getstate()


def ct_bytes(ct):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            .tobytes() for k, v in ct.items()}


class TestCtProbePairFused:
    def test_fused_pair_matches_two_probes(self):
        """K2's pair against two single probes, on a populated table, live
        and all-expired. JAX side: the Pallas kernel in interpret mode."""
        state = random.Random(7).getstate()
        obs = []
        for side in SIDES:
            ct, seeded, st = _populated_ct(side, state)
            rng = random.Random()
            rng.setstate(st)
            seen = [ct_bytes(ct)]
            for trial, now in ((0, 110), (1, 10_000)):
                probe = _random_batch(rng, 128)
                mix = {k: np.concatenate([v[:64], seeded[k][:64]])
                       for k, v in probe.items()}
                if side == "jax":
                    b = {k: jnp.asarray(v) for k, v in mix.items()}
                    fwd, rev = j_ctk.ct_key_words_pair(b)
                    want = (j_ctk.ct_probe(ct, fwd, jnp.uint32(now)),
                            j_ctk.ct_probe(ct, rev, jnp.uint32(now)))
                    got = j_fk.ct_probe_pair_fused(
                        ct, fwd, rev, jnp.uint32(now), probe_depth=8,
                        interpret=True)
                else:
                    b = t_records.batch_to_torch(mix, "cpu")
                    fwd, rev = t_ctk.ct_key_words_pair(b)
                    want = (t_ctk.ct_probe(ct, fwd, now),
                            t_ctk.ct_probe(ct, rev, now))
                    got = t_fk.ct_probe_pair_fused(ct, fwd, rev, now,
                                                   probe_depth=8)
                for name, w, g in zip(("fwd", "rev"), want, got):
                    assert ints(g) == ints(w), (side, trial, name)
                seen.append((ints(got[0]), ints(got[1])))
            obs.append(seen)
        assert obs[0] == obs[1]


# --------------------------------------------------------------------------- #
# policy + L7 + verdict stage
# --------------------------------------------------------------------------- #
class TestPolicyVerdictFused:
    def test_kernel_matches_interior_core(self):
        """K3 against the interior core on ``test_parity.py``'s world.
        JAX side: the Pallas kernel in interpret mode."""
        obs = []
        for side in SIDES:
            m = P(side)
            C = m.C
            rng = random.Random(11)
            snap = cs.parity_snapshot(m, cs.parity_world(m), 1024)
            host = snap.tensors()
            prior, seen = [], []
            for trial in range(3):
                packets = [cs.parity_packet(m, rng, prior) for _ in range(96)]
                raw = m.records.batch_from_records(packets, snap.ep_slot_of)
                nrng = np.random.default_rng(trial)
                est = nrng.random(96) < 0.3
                reply = ~est & (nrng.random(96) < 0.2)
                addr = np.where((raw["direction"] == C.DIR_EGRESS)[:, None],
                                raw["dst"], raw["src"])
                if side == "jax":
                    tensors = {k: jnp.asarray(v) for k, v in host.items()}
                    b = {k: jnp.asarray(v) for k, v in raw.items()}
                    id_idx = lpm_lookup_batch(
                        tensors["lpm_v4"], tensors["lpm_v6"],
                        jnp.asarray(addr), b["is_v6"],
                        default_index=snap.world_index)
                    args = (tensors, b["ep_slot"], b["direction"], id_idx,
                            b["proto"], b["dport"], b["http_method"],
                            b["http_path"], jnp.asarray(est),
                            jnp.asarray(reply), b["valid"])
                    want = j_interior(*args)
                    got = j_fk.policy_verdict_fused(*args, interpret=True)
                else:
                    tensors = convert.snapshot_tensors_to_torch(host, "cpu")
                    b = t_records.batch_to_torch(raw, "cpu")
                    id_idx = t_fk.lpm_lookup_fused(
                        tensors["lpm_v4"], tensors["lpm_v6"],
                        torch.as_tensor(addr.view(np.int32)), b["is_v6"],
                        snap.world_index)[0]
                    args = (tensors, b["ep_slot"], b["direction"], id_idx,
                            b["proto"], b["dport"], b["http_method"],
                            b["http_path"], torch.as_tensor(est),
                            torch.as_tensor(reply), b["valid"])
                    want = t_interior(*args)
                    got = t_fk.policy_verdict_fused(*args)
                cols = []
                for name, w, g in zip(("allow", "reason", "status",
                                       "redirect", "matched_rule"),
                                      want, got):
                    assert ints(g) == ints(w), (side, trial, name)
                    cols.append(ints(g))
                seen.append(cols)
                prior.extend(packets)
                prior = prior[-80:]
            obs.append(seen)
        assert obs[0] == obs[1]


# --------------------------------------------------------------------------- #
# full classify step: kernel path vs plain path vs oracle
# --------------------------------------------------------------------------- #
class TestFusedClassifyParity:
    @pytest.mark.parametrize("seed", range(2))
    def test_fused_oracle_parity(self, seed):
        """``run_parity`` with the port's kernel path (``fused=True``)
        against the port's oracle, and the JAX package's run (its jnp
        reference) against ``oracle/``: every compared column and live CT
        entry of every batch equal."""
        want = run_parity(P("jax"), seed, n_batches=4, batch=80)
        got = run_parity(P("torch"), seed, n_batches=4, batch=80, fused=True)
        assert got == want

    def test_fused_vs_jnp_bit_identity(self):
        """Outputs, CT arrays and counters of a stateful 4-batch stream
        (v6, L7, CT revisits): the port's kernel path = its plain path,
        and both = the JAX package's jnp reference."""
        obs = {}
        for side in SIDES:
            m = P(side)
            rng = random.Random(5)
            snap = cs.parity_snapshot(m, cs.parity_world(m), 4096)
            devs = [Device(m, snap, 4096)] if side == "jax" else \
                [Device(m, snap, 4096, fused=True),
                 Device(m, snap, 4096, fused=False)]
            prior, now, seen = [], 500, []
            for bi in range(4):
                packets = [cs.parity_packet(m, rng, prior)
                           for _ in range(96)]
                res = [d.records(packets, now) for d in devs]
                got = [({k: ints(v) for k, v in out.items()},
                        {k: ints(v) for k, v in cnt.items()},
                        {k: ints(v) for k, v in d.ct_np().items()})
                       for (out, cnt), d in zip(res, devs)]
                assert all(g == got[0] for g in got), (side, bi)
                seen.append(got[0])
                prior.extend(packets)
                prior = prior[-100:]
                now += 40
            obs[side] = seen
        for bi, (a, b) in enumerate(zip(obs["jax"], obs["torch"])):
            for part, x, y in zip(("out", "counters", "ct"), a, b):
                common = sorted(set(x) & set(y))
                assert common == sorted(x), (bi, part)
                assert {k: x[k] for k in common} == \
                    {k: y[k] for k in common}, (bi, part)


#: each package's other executor of the classify step: the JAX package's
#: Pallas interior in interpret mode; the port's plain path (its default
#: is the kernel wrappers)
OTHER_EXECUTOR = {"jax": dict(fused=True, fused_interpret=True),
                  "torch": dict(fused=False)}


class TestMakeClassifyFnMemo:
    def test_same_static_config_shares_one_callable(self):
        def case(side):
            mk = P(side).classify.make_classify_fn
            a = mk(8, False, donate_ct=False)
            return (a is mk(8, False, donate_ct=False),
                    a is not mk(8, True, donate_ct=False),
                    a is not mk(8, False, donate_ct=False, packed=True),
                    a is not mk(8, False, donate_ct=False,
                                **OTHER_EXECUTOR[side]),
                    a is not mk(8, False, donate_ct=False, lb_probe_depth=4))
        assert case("jax") == case("torch") == (True,) * 5
        # the port's key holds the device as well
        mk = P("torch").classify.make_classify_fn
        assert mk(8, False, donate_ct=False, device="cpu") \
            is not mk(8, False, donate_ct=False)


# --------------------------------------------------------------------------- #
# serving integration: selector, engine, pipeline, mesh, audit
# --------------------------------------------------------------------------- #
def _world(eng):
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
    eng.add_endpoint(["k8s:role=fe"], ips=("192.168.1.30",), ep_id=3)
    eng.apply_policy(FIXTURE_RULES)
    eng.regenerate()


def torch_engine(fused="auto", **kw):
    """``test_fused.jit_engine`` on the port: ``TorchDatapath`` on the
    CPU."""
    kw.setdefault("ct_capacity", 2048)
    kw.setdefault("auto_regen", False)
    kw.setdefault("flowlog_mode", "none")
    kw.setdefault("batch_size", 128)
    kw.setdefault("pipeline_flush_ms", 1.0)
    cfg = TConfig(fused_kernels=fused, device="cpu", **kw)
    eng = TEngine(cfg, datapath=TorchDatapath(cfg))
    _world(eng)
    return eng


def torch_fake_serial_engine():
    """``test_sharded_pipeline.fake_serial_engine`` on the port."""
    cfg = TConfig(ct_capacity=2048, auto_regen=False, flowlog_mode="none",
                  device="cpu")
    eng = TEngine(cfg, datapath=TFake(cfg))
    _world(eng)
    return eng


def outs_obs(out, keys=OUT_KEYS):
    return {k: ints(out[k]) for k in keys}


#: ``fused_kernels`` → what each package resolves it to. The reference's
#: ``resolve_fused(cfg)`` → (fused, interpret), on this CPU; the port's
#: ``resolve_fused(cfg, device)`` → fused, for a CPU and a CUDA device
#: (None: it raises ValueError, the kernels have no CPU build).
SELECTOR = {
    # mode:  (reference on the CPU, port on "cpu", port on "cuda")
    "off": ((False, False), False, False),
    "auto": ((False, False), False, True),
    "on": ((True, True), None, True),
}


class TestFusedSelector:
    def test_resolve_modes_on_cpu(self):
        """Every row of ``SELECTOR``."""
        for mode, (ref, cpu, cuda) in SELECTOR.items():
            assert j_resolve_fused(JConfig(fused_kernels=mode)) == ref
            cfg = TConfig(fused_kernels=mode, device="cpu")
            if cpu is None:
                with pytest.raises(ValueError):
                    t_resolve_fused(cfg, torch.device("cpu"))
            else:
                assert t_resolve_fused(cfg, torch.device("cpu")) is cpu
            assert t_resolve_fused(cfg, torch.device("cuda")) is cuda

    def test_bad_mode_rejected(self):
        errors = []
        for config in (JConfig, TConfig):
            with pytest.raises(ValueError) as e:
                config(fused_kernels="yes")
            errors.append(str(e.value))
        assert errors[0] == errors[1]

    def test_backend_surfaces_state_and_status(self):
        """``fused_state`` and status's ``fused_kernels``: the reference's
        ``on`` engine and the port's ``auto`` one (what runs the kernel
        wrappers on the CPU) report the ``SELECTOR`` row of their mode on
        the keys they share (the port adds ``launches``); the ``off``
        engines report the same on those keys; a fake datapath reports
        none on both."""
        shared = ("mode", "active", "interpret")
        for j_mode, t_mode in (("on", "auto"), ("off", "off")):
            ej, et = jit_engine(j_mode), torch_engine(t_mode)
            try:
                sj, st = ej.datapath.fused_state, et.datapath.fused_state
                assert set(shared) <= set(sj) and set(shared) <= set(st)
                assert sorted(set(st) - set(sj)) == ["launches"]
                ref = SELECTOR[j_mode][0]
                assert (sj["active"], sj["interpret"]) == ref
                assert (st["active"], st["interpret"]) == \
                    (SELECTOR[t_mode][1], False)
                if j_mode == t_mode:
                    assert {k: sj[k] for k in shared} == \
                        {k: st[k] for k in shared}
                dj = j_status_doc(ej)["fused_kernels"]
                dt = t_status_doc(et)["fused_kernels"]
                assert dj["active"] is sj["active"]
                assert dt["active"] is st["active"]
            finally:
                ej.stop()
                et.stop()
        fakes = []
        for config, fake, engine, doc in ((JConfig(), JFake, JEngine,
                                           j_status_doc),
                                          (TConfig(device="cpu"), TFake,
                                           TEngine, t_status_doc)):
            eng = engine(config, datapath=fake(config))
            try:
                fakes.append(doc(eng)["fused_kernels"])
            finally:
                eng.stop()
        assert fakes == [None, None]

    def test_compute_span_carries_executor_tag(self):
        """The ``datapath.compute`` span's ``fused`` tag is the engine's
        resolved executor: 1 on the reference's ``on`` engine (interpret
        mode), 0 on the port's ``auto`` engine on the CPU (the plain
        versions); the two spans carry the same attribute keys. Each
        package's process-global tracer, which the engines switch on, is
        set back as it was (a later test on the worker reads it)."""
        attrs = []
        for eng, want in ((jit_engine("on", trace_sample_rate=1.0), 1),
                          (torch_engine("auto", trace_sample_rate=1.0), 0)):
            try:
                ch = _chunks(eng, 1)[0]
                eng.classify(dict(ch), now=100)
                spans = [s for s in eng.tracer.spans(name="datapath.compute")
                         if s.get("attrs")]
                assert spans and spans[-1]["attrs"]["fused"] == want
                attrs.append(sorted(spans[-1]["attrs"]))
            finally:
                eng.stop()
        assert attrs[0] == attrs[1]

    @pytest.fixture(autouse=True)
    def _tracers_restored(self):
        from cilium_tpu.observe.trace import TRACER as j_tracer
        from cilium_tpu_torch.observe.trace import TRACER as t_tracer
        before = [(t, t.sample_rate) for t in (j_tracer, t_tracer)]
        yield
        for tracer, rate in before:
            tracer.configure(sample_rate=rate)
            if rate == 0:
                tracer.reset()


class TestFusedServing:
    """The JAX side serves through its jnp reference
    (``fused_kernels="off"``); the port through its kernel wrappers
    (``auto``) and its plain path (``off``)."""

    def test_engine_classify_matches_reference(self):
        ref, auto, off = jit_engine("off"), torch_engine("auto"), \
            torch_engine("off")
        try:
            for i, ch in enumerate(_chunks(ref, 5)):
                want = outs_obs(ref.classify(dict(ch), now=100 + i))
                assert outs_obs(auto.classify(dict(ch), now=100 + i)) == want
                assert outs_obs(off.classify(dict(ch), now=100 + i)) == want
        finally:
            for e in (ref, auto, off):
                e.stop()

    def test_pipelined_fused_matches_pipelined_reference(self):
        """FIFO pipeline verdicts, every out column: the port's kernel
        path = its plain path = the JAX package's pipeline."""
        engs = (jit_engine("off"), torch_engine("auto"), torch_engine("off"))
        try:
            chunks = _chunks(engs[0], 6, size=30, seed=8)
            tickets = [[e.submit(dict(ch), now=200 + i)
                        for i, ch in enumerate(chunks)] for e in engs]
            assert all(e.drain(timeout=60) for e in engs)
            got = [[t.result(timeout=10) for t in ts] for ts in tickets]
            for i in range(len(chunks)):
                want = got[0][i]
                for g in got[1:]:
                    assert sorted(g[i]) == sorted(want), i
                    for k in want:
                        assert ints(g[i][k]) == ints(want[k]), (i, k)
        finally:
            for e in engs:
                e.stop()

    def test_sharded_mesh_fused_parity(self):
        """A 1-shard and a 4-shard pipeline equal each other on every out
        column and each package's oracle-backed serial engine on the
        comparable keys; the port's (its single-process mesh on the CPU,
        kernel path) equal the JAX package's (its jnp reference)."""
        obs = []
        for serial, one, four in (
                (fake_serial_engine(), jit_engine("off", n_shards=1),
                 jit_engine("off", n_shards=4)),
                (torch_fake_serial_engine(), torch_engine("auto",
                                                          n_shards=1),
                 torch_engine("auto", n_shards=4))):
            try:
                chunks = _chunks(one, 5, size=28, seed=13)
                want = [serial.classify(dict(ch), now=300 + i)
                        for i, ch in enumerate(chunks)]
                got = []
                for eng in (one, four):
                    ts = [eng.submit(dict(ch), now=300 + i)
                          for i, ch in enumerate(chunks)]
                    assert eng.drain(timeout=60)
                    got.append([t.result(timeout=10) for t in ts])
                    for i, g in enumerate(got[-1]):
                        for k in ORACLE_KEYS:
                            assert ints(g[k]) == ints(want[i][k]), (i, k)
                for i, (a, b) in enumerate(zip(*got)):
                    assert outs_obs(a) == outs_obs(b), i
                obs.append([outs_obs(g) for g in got[0]])
            finally:
                serial.stop()
                one.stop()
                four.stop()
        assert obs[0] == obs[1]

    def test_audit_clean_with_fused_interior(self):
        """The shadow-oracle auditor at sampling 1.0 over the port's
        kernel path (and the JAX package's jnp reference): every captured
        batch replays equal to the oracle, health stays OK; the two
        packages' audit counts equal."""
        obs = []
        for eng in (jit_engine("off", audit_enabled=True,
                               audit_sample_rate=1.0),
                    torch_engine("auto", audit_enabled=True,
                                 audit_sample_rate=1.0)):
            try:
                for i, ch in enumerate(_chunks(eng, 4, size=24, seed=21)):
                    eng.classify(dict(ch), now=400 + i)
                eng.audit_step()
                st = eng.auditor.stats()
                assert st["checked_batches"] >= 4
                assert st["checked_rows"] > 0
                assert st["mismatched_rows"] == 0
                assert eng.auditor.healthy
                assert eng.health()["state"] == "OK"
                obs.append((st["checked_batches"], st["checked_rows"],
                            st["mismatched_rows"], eng.health()["state"]))
            finally:
                eng.stop()
        assert obs[0] == obs[1]


@pytest.mark.slow
class TestFusedSoak:
    def test_long_horizon_fused_oracle_parity(self):
        """Expiry, slot reuse and large time steps through the port's
        kernel path against the JAX package's interpret-mode run."""
        want = run_parity(P("jax"), 99, n_batches=8, batch=64, time_step=90,
                          **FUSED_KW)
        got = run_parity(P("torch"), 99, n_batches=8, batch=64,
                         time_step=90, fused=True)
        assert got == want

    def test_pipelined_fused_soak(self):
        """A few hundred pipelined submissions through each package's
        engine (the reference's ``on``, the port's ``auto``) with the
        auditor at 1.0: no mismatches, no restarts; the verdicts equal."""
        results = []
        for eng in (jit_engine("on", audit_enabled=True,
                               audit_sample_rate=1.0, audit_pool_batches=64),
                    torch_engine("auto", audit_enabled=True,
                                 audit_sample_rate=1.0,
                                 audit_pool_batches=64)):
            try:
                chunks = _chunks(eng, 40, size=30, seed=31)
                tickets = [eng.submit(dict(ch), now=500 + i)
                           for i, ch in enumerate(chunks)]
                assert eng.drain(timeout=120)
                results.append([outs_obs(t.result(timeout=10))
                                for t in tickets])
                deadline = time.time() + 30
                while time.time() < deadline:
                    eng.audit_step()
                    if eng.auditor.stats()["checked_batches"] >= 10:
                        break
                st = eng.auditor.stats()
                assert st["checked_batches"] >= 10
                assert st["mismatched_rows"] == 0
                pipe = eng.health().get("pipeline")
                assert not pipe or pipe["restarts"] == 0
            finally:
                eng.stop()
        assert results[0] == results[1]
