"""Live-state fast paths of the port against the JAX package's, case for
case with ``test_update_storm.py``: sparse delta patches of the placed
verdict image behind the ``StalePlacement`` fence, overlay emission, the
random rule and endpoint storm against the oracle-backed fake, the chunked
CT GC, CT survival across a restart through the checkpoint, and the storm
under the parity auditor, and the memo of classify steps
(``make_classify_fn``'s LRU, which each engine exports).

Each case runs the reference's scenario on each package: the JAX side on
``JITDatapath`` (or its ``FakeDatapath``) as its own tests run it, the port
on ``TorchDatapath`` with ``device="cpu"`` (or its own ``FakeDatapath``).
Each asserts the reference's expectations, and the two sides' results are
held equal, exactly: verdict columns, patch statistics, verdict images,
sparse payloads, CT arrays, GC counts, restored verdicts, audit counts,
the memo's sizes and evictions.
"""

import functools
import importlib
import os
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_torch_parity import PKG, SIDES, P

N_PEERS = 6
OUT_KEYS = ("allow", "reason", "status", "remote_identity", "redirect")


@functools.lru_cache(maxsize=None)
def U(side):
    """``P(side)`` plus the runtime and compiler modules these cases
    use."""
    names = {"config": "runtime.config", "datapath": "runtime.datapath",
             "engine": "runtime.engine", "faults": "runtime.faults",
             "ckpt": "runtime.checkpoint",
             "incremental": "compile.incremental",
             "policy_image": "compile.policy_image",
             "ctk": "kernels.conntrack"}
    return SimpleNamespace(**vars(P(side)), **{
        k: importlib.import_module(f"{PKG[side]}.{v}")
        for k, v in names.items()})


def both(case):
    obs = {s: case(U(s)) for s in SIDES}
    assert obs["jax"] == obs["torch"]
    return obs["torch"]


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    for s in SIDES:
        U(s).faults.FAULTS.reset()


# --------------------------------------------------------------------------- #
# world helpers (test_update_storm.py's, over one package)
# --------------------------------------------------------------------------- #
def peer_rule_docs(i, port=80, deny=False, label=None):
    key = "ingressDeny" if deny else "ingress"
    block = {"fromEndpoints": [{"matchLabels": {"peer": f"p{i}"}}]}
    if not deny:
        block["toPorts"] = [{"ports": [{"port": str(port),
                                        "protocol": "TCP"}]}]
    return [{"endpointSelector": {"matchLabels": {"app": "web"}},
             "labels": [label or f"k8s:storm=r{i}-{port}-{int(deny)}"],
             key: [block]}]


def config(m, **kw):
    kw = dict(ct_capacity=2048, auto_regen=False, **kw)
    if m.side == "torch":
        kw["device"] = "cpu"
    return m.config.DaemonConfig(**kw)


def make_engine(m, datapath, n_peers=N_PEERS, **cfg_kw):
    eng = m.engine.Engine(config(m, **cfg_kw), datapath=datapath)
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
    for i in range(n_peers):
        eng.add_endpoint([f"k8s:peer=p{i}", f"k8s:group=g{i % 2}"],
                         ips=(f"172.16.{i}.5",), ep_id=10 + i)
    eng.apply_policy([{
        "endpointSelector": {"matchLabels": {"app": "web"}},
        "ingress": [{"fromEndpoints": [{"matchLabels": {"group": "g0"}}],
                     "toPorts": [{"ports": [
                         {"port": "80", "protocol": "TCP"}]}]}]}])
    eng.regenerate()
    return eng


def device_dp(m, **kw):
    """The package's device datapath: ``JITDatapath`` or the port's
    ``TorchDatapath`` on the CPU."""
    cls = (m.datapath.TorchDatapath if m.side == "torch"
           else m.datapath.JITDatapath)
    return cls(config(m, **kw))


def jit_engine(m, **kw):
    return make_engine(m, device_dp(m, **kw), **kw)


def fake_engine(m, **kw):
    return make_engine(m, m.datapath.FakeDatapath(config(m, **kw)), **kw)


def traffic(m, slots, n_peers=N_PEERS, flags=None, sport0=30000):
    C = m.C
    flags = C.TCP_SYN if flags is None else flags
    pkts = []
    for i in range(n_peers):
        for dp in (80, 443, 8080):
            s16, _ = m.ip.parse_addr(f"172.16.{i}.5")
            d16, _ = m.ip.parse_addr("192.168.1.10")
            pkts.append(m.oracle.PacketRecord(s16, d16, sport0 + i, dp,
                                              C.PROTO_TCP, flags, False, 1,
                                              C.DIR_INGRESS))
    return m.records.batch_from_records(pkts, slots)


def warm_geometry(*engines, ports=(443, 8080)):
    for i in range(N_PEERS):
        for p in ports:
            for e in engines:
                e.replace_policy([f"k8s:warm=w{i}-{p}"],
                                 peer_rule_docs(i, p,
                                                label=f"k8s:warm=w{i}-{p}"))
                e.regenerate()


def cols(out):
    return {k: np.asarray(out[k]).tolist() for k in OUT_KEYS}


def assert_same_verdicts(a, b, msg=""):
    for k in OUT_KEYS:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      f"{msg}:{k}")
    return cols(a)


def host(t):
    """A placed tensor (JAX array or CPU tensor) as numpy in the
    reference's dtype."""
    if isinstance(t, torch.Tensor):
        a = t.detach().cpu().numpy()
        return a.view(np.uint16) if a.dtype == np.int16 else a
    return np.asarray(t)


# --------------------------------------------------------------------------- #
# the delta-patch fast path
# --------------------------------------------------------------------------- #
class TestDeltaPatch:
    def test_warm_churn_rides_the_delta_path_bit_identical(self):
        def case(m):
            eng, ref = jit_engine(m), fake_engine(m)
            warm_geometry(eng, ref)
            base = dict(eng.datapath.patch_stats)
            now, seen = 1000, []
            for step in range(10):
                i, p = step % N_PEERS, (443, 8080)[step % 2]
                label = f"k8s:warm=w{i}-{p}"
                body = None if step % 3 == 2 else peer_rule_docs(
                    i, p, label=label)
                for e in (eng, ref):
                    e.replace_policy([label], body)
                    e.regenerate()
                b = traffic(m, eng.active.snapshot.ep_slot_of)
                seen.append(assert_same_verdicts(
                    eng.classify(dict(b), now=now),
                    ref.classify(dict(b), now=now), f"step{step}"))
                now += 10
            ps = eng.datapath.patch_stats
            assert ps["patch_delta"] - base["patch_delta"] >= 5, ps
            assert ps["patch_rows"] > base["patch_rows"]
            return seen, dict(ps)
        both(case)

    def test_delta_patched_image_equals_full_place(self):
        def case(m):
            eng = jit_engine(m)
            warm_geometry(eng)
            for step in range(6):
                label = f"k8s:warm=w{step % N_PEERS}-443"
                eng.replace_policy(
                    [label],
                    None if step % 2 else peer_rule_docs(step % N_PEERS, 443,
                                                         label=label))
                eng.regenerate()
            assert eng.datapath.patch_stats["patch_delta"] >= 3
            fresh = eng.datapath.place(eng.active.snapshot)
            got = host(eng.active.tensors["verdict"])
            np.testing.assert_array_equal(got, host(fresh["verdict"]))
            return got.tobytes(), eng.datapath.patch_stats["patch_delta"]
        both(case)

    def test_stale_placement_fence_and_engine_retry(self):
        """A handle captured before a delta patch raises StalePlacement;
        the engine's retry classifies against the patched snapshot."""
        def case(m):
            eng = jit_engine(m)
            warm_geometry(eng)
            eng.replace_policy(["k8s:warm=w0-443"],
                               peer_rule_docs(0, 443,
                                              label="k8s:warm=w0-443"))
            eng.regenerate()
            old = eng.active
            before = eng.datapath.patch_stats["patch_delta"]
            eng.replace_policy(["k8s:warm=w0-443"], None)
            eng.regenerate()
            assert eng.datapath.patch_stats["patch_delta"] == before + 1
            b = traffic(m, old.snapshot.ep_slot_of)
            with pytest.raises(m.datapath.StalePlacement):
                eng.datapath.classify(old.tensors, old.snapshot, dict(b), 500)
            fences = eng.datapath.patch_stats["patch_stale_fences"]
            assert fences >= 1
            out = eng.classify(traffic(m, eng.active.snapshot.ep_slot_of),
                               now=600)
            assert out["allow"].shape[0] > 0
            return fences, cols(out)
        both(case)

    def test_delta_budget_gate_falls_back_to_full_upload(self):
        def case(m):
            eng = jit_engine(m, patch_delta_rows=1)
            warm_geometry(eng)
            inc = eng._inc
            assert inc is not None and inc.delta_budget_rows == 1
            eng.apply_policy([{
                "endpointSelector": {"matchLabels": {"app": "web"}},
                "labels": ["k8s:storm=wide"],
                "ingressDeny": [{"fromEndpoints": [
                    {"matchLabels": {"group": "g1"}}]}]}])
            before = dict(eng.datapath.patch_stats)
            eng.regenerate()
            ps = eng.datapath.patch_stats
            assert ps["patch_delta"] == before["patch_delta"]
            assert ps["patch_full"] == before["patch_full"] + 1
            return dict(ps)
        both(case)

    def test_scatter_failure_self_heals_with_full_upload(self):
        """A scatter that fails after the donation recovers with a full
        verdict upload of the new snapshot."""
        def case(m):
            eng = jit_engine(m)
            warm_geometry(eng)
            eng.replace_policy(["k8s:warm=w2-443"],
                               peer_rule_docs(2, 443,
                                              label="k8s:warm=w2-443"))
            eng.regenerate()
            dp = eng.datapath
            calls = {"n": 0}
            real = dp._scatter_rows

            def flaky(verdict, rows, vals):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise RuntimeError("injected scatter failure")
                return real(verdict, rows, vals)

            dp._scatter_rows = flaky
            try:
                before = dp.patch_stats["patch_scatter_errors"]
                eng.replace_policy(["k8s:warm=w2-443"], None)
                eng.regenerate()              # must not raise
                assert dp.patch_stats["patch_scatter_errors"] == before + 1
                got = host(eng.active.tensors["verdict"])
                np.testing.assert_array_equal(
                    got, host(dp.place(eng.active.snapshot)["verdict"]))
                out = eng.classify(traffic(m, eng.active.snapshot.ep_slot_of),
                                   now=900)
                assert out["allow"].shape[0] > 0
            finally:
                dp._scatter_rows = real
            return got.tobytes(), cols(out), dict(dp.patch_stats)
        both(case)

    def test_compiler_emits_sparse_payload(self):
        def case(m):
            eng = fake_engine(m)
            warm_geometry(eng)
            inc = eng._inc
            eng.replace_policy(["k8s:warm=w1-443"], None)
            eps = sorted(eng.endpoints.values(), key=lambda e: e.ep_id)
            res = inc.try_update(m.ct_layout.CTConfig(capacity=2048),
                                 endpoints=eps)
            assert res is not None
            snap, patch, stats = res
            assert patch.is_delta \
                and stats.delta_rows == patch.delta_rows.shape[0]
            dense = snap.image.verdict
            r = patch.delta_rows
            np.testing.assert_array_equal(dense[r[:, 0], r[:, 1], r[:, 2]],
                                          patch.delta_vals)
            return r.tolist(), patch.delta_vals.tolist()
        both(case)

    def test_sharded_delta_patch_parity(self):
        """Scatter-apply onto a 2 × 2 mesh's verdict: delta churn matches
        the fake (the port's mesh: four ``cpu`` devices)."""
        def case(m):
            kw = dict(n_shards=2, rule_shards=2)
            eng = make_engine(m, device_dp(m, **kw), **kw)
            ref = fake_engine(m)
            warm_geometry(eng, ref)
            base = eng.datapath.patch_stats["patch_delta"]
            now, seen = 700, []
            for step in range(6):
                label = f"k8s:warm=w{step % N_PEERS}-8080"
                body = None if step % 2 else peer_rule_docs(
                    step % N_PEERS, 8080, label=label)
                for e in (eng, ref):
                    e.replace_policy([label], body)
                    e.regenerate()
                b = traffic(m, eng.active.snapshot.ep_slot_of)
                seen.append(assert_same_verdicts(
                    eng.classify(dict(b), now=now),
                    ref.classify(dict(b), now=now), f"sharded-step{step}"))
                now += 10
            assert eng.datapath.patch_stats["patch_delta"] > base
            return seen, eng.datapath.patch_stats["patch_delta"] - base
        both(case)


# --------------------------------------------------------------------------- #
# overlay emission invariants
# --------------------------------------------------------------------------- #
def overlay_world(m):
    alloc = m.identity.IdentityAllocator()
    ctx = m.policy.PolicyContext(
        allocator=alloc, selector_cache=m.selectorcache.SelectorCache(alloc),
        ipcache=m.ipcache.IPCache())
    repo = m.policy.Repository(ctx)
    lbls = m.labels.Labels.parse(["k8s:app=web0"])
    ident = alloc.allocate(lbls)
    ctx.ipcache.upsert("192.168.0.10/32", ident.id)
    eps = [m.endpoint.Endpoint(ep_id=1, labels=lbls, identity_id=ident.id)]
    for i in range(4):
        pid = alloc.allocate(m.labels.Labels.parse([f"k8s:peer=q{i}"]))
        ctx.ipcache.upsert(f"172.17.{i}.0/24", pid.id)
    return ctx, repo, eps


def overlay_rule(m, i, port, tag):
    return m.rules.parse_rule({
        "endpointSelector": {"matchLabels": {"app": "web0"}},
        "labels": [f"k8s:t={tag}"],
        "ingress": [{"fromEndpoints": [{"matchLabels": {"peer": f"q{i}"}}],
                     "toPorts": [{"ports": [{"port": str(port),
                                             "protocol": "TCP"}]}]}]})


class TestOverlayEmission:
    def test_tiny_rebase_budget_keeps_equivalence_and_frozen_snapshots(self):
        """With ``rebase_rows=1`` every emission rebases; with a large
        budget the overlay accumulates: both stay identical to a fresh
        build, and emitted snapshots stay frozen."""
        def case(m):
            C, CT = m.C, m.ct_layout.CTConfig
            seen = []
            for rebase in (1, 10_000):
                ctx, repo, eps = overlay_world(m)
                repo.add([overlay_rule(m, 0, 80, "seed")])
                snap = m.snapshot.build_snapshot(repo, ctx, eps,
                                                 CT(capacity=1024))
                inc = m.incremental.IncrementalCompiler(
                    repo, ctx, eps, snap, rebase_rows=rebase)
                emitted = []
                for step in range(8):
                    i = step % 4
                    if step % 3 == 2:
                        repo.delete_by_labels(m.labels.Labels.parse(
                            [f"k8s:t=s{step - 2}"]))
                    else:
                        repo.add([overlay_rule(m, i, 80, f"s{step}")])
                    res = inc.try_update(CT(capacity=1024))
                    assert res is not None, inc.last_fallback
                    s, _patch, _ = res
                    emitted.append((s, s.image.verdict.copy()))
                    fresh = m.snapshot.build_snapshot(repo, ctx, eps,
                                                      CT(capacity=1024))
                    for ident in [x.id for x in ctx.allocator.all()]:
                        idx_s = s.id_classes.index_of.get(ident)
                        idx_f = fresh.id_classes.index_of.get(ident)
                        if idx_s is None or idx_f is None:
                            continue
                        cs_ = s.id_classes.class_of[idx_s]
                        cf = fresh.id_classes.class_of[idx_f]
                        for port in (79, 80, 81, 443):
                            ps = s.port_classes.table[0, port]
                            pf = fresh.port_classes.table[0, port]
                            d = int(s.image.verdict[0, 1, cs_, ps]) \
                                & C.VERDICT_DECISION_MASK
                            assert d == (int(fresh.image.verdict[0, 1, cf, pf])
                                         & C.VERDICT_DECISION_MASK), \
                                (rebase, step, ident, port)
                            seen.append(d)
                for s, frozen in emitted:
                    np.testing.assert_array_equal(s.image.verdict, frozen)
                seen.append([f.tobytes() for _s, f in emitted])
            return seen
        both(case)

    def test_overlay_image_nbytes_without_materialization(self):
        def case(m):
            CT = m.ct_layout.CTConfig
            ctx, repo, eps = overlay_world(m)
            repo.add([overlay_rule(m, 0, 80, "seed")])
            snap = m.snapshot.build_snapshot(repo, ctx, eps,
                                             CT(capacity=1024))
            inc = m.incremental.IncrementalCompiler(repo, ctx, eps, snap)
            repo.add([overlay_rule(m, 0, 80, "x")])
            res = inc.try_update(CT(capacity=1024))
            assert res is not None
            s, _patch, _ = res
            overlay = isinstance(s.image, m.policy_image.OverlayImage)
            if overlay:
                assert s.image._dense is None
                assert s.nbytes > 0
                assert s.image._dense is None
                _ = s.image.verdict
                assert s.image._dense is not None
            return overlay, s.nbytes
        both(case)


# --------------------------------------------------------------------------- #
# randomised storm: rule add/remove + endpoint churn, engine-level
# --------------------------------------------------------------------------- #
class TestRandomStorm:
    @pytest.mark.parametrize("seed", [3, 11])
    def test_engine_storm_matches_oracle(self, seed):
        """Random rule toggles (delta path) among endpoint adds/removes
        (full builds): the device engine equals the oracle-backed fake at
        every revision."""
        def case(m):
            rng = random.Random(seed)
            eng, ref = jit_engine(m), fake_engine(m)
            warm_geometry(eng, ref)
            next_ep = [100]
            added_eps = []
            now, seen = 2000, []
            for step in range(14):
                op = rng.random()
                if op < 0.7:
                    i, p = rng.randrange(N_PEERS), rng.choice((443, 8080))
                    label = f"k8s:warm=w{i}-{p}"
                    body = None if rng.random() < 0.4 else peer_rule_docs(
                        i, p, deny=rng.random() < 0.3, label=label)
                    for e in (eng, ref):
                        e.replace_policy([label], body)
                elif op < 0.85 or not added_eps:
                    ep_id = next_ep[0]
                    next_ep[0] += 1
                    added_eps.append(ep_id)
                    for e in (eng, ref):
                        e.add_endpoint([f"k8s:peer=px{ep_id}"],
                                       ips=(f"172.18.{ep_id % 250}.9",),
                                       ep_id=ep_id)
                else:
                    ep_id = added_eps.pop(rng.randrange(len(added_eps)))
                    for e in (eng, ref):
                        e.remove_endpoint(ep_id)
                for e in (eng, ref):
                    e.regenerate()
                assert eng.active.revision == ref.active.revision
                b = traffic(m, eng.active.snapshot.ep_slot_of)
                seen.append(assert_same_verdicts(
                    eng.classify(dict(b), now=now),
                    ref.classify(dict(b), now=now), f"storm{seed}-{step}"))
                now += 7
            assert eng.datapath.patch_stats["patch_delta"] >= 1
            return seen, dict(eng.datapath.patch_stats)
        both(case)


# --------------------------------------------------------------------------- #
# overlapped device-side CT GC
# --------------------------------------------------------------------------- #
class Table:
    """One package's CT kernel calls on a table filled from numpy: the
    ``jax.numpy`` side and the port's CPU tensors."""

    def __init__(self, m):
        self.m = m

    def filled(self, cap=1024):
        """``_ct_with_expiries``: half the slots live with expiries
        1..199, distinct keys."""
        m = self.m
        cfg = m.ct_layout.CTConfig(capacity=cap, probe_depth=4)
        if m.side == "jax":
            ct = m.ct_layout.make_ct_arrays(cfg)
        else:
            from cilium_tpu_torch.convert import ct_to_numpy
            ct = ct_to_numpy(m.ct_layout.make_ct_arrays(cfg, "cpu"))
        rng = np.random.default_rng(5)
        n = cap // 2
        slots = rng.choice(cap, size=n, replace=False)
        ct["expiry"][slots] = rng.integers(1, 200, n).astype(np.uint32)
        ct["keys"][slots, 0] = np.arange(n, dtype=np.uint32) + 1
        return self.device(ct)

    def device(self, ct):
        if self.m.side == "jax":
            import jax.numpy as jnp
            return {k: jnp.asarray(v) for k, v in ct.items()}
        from cilium_tpu_torch.convert import ct_to_torch
        return ct_to_torch(ct, "cpu")

    def np(self, ct):
        if self.m.side == "jax":
            return {k: np.asarray(v) for k, v in ct.items()}
        from cilium_tpu_torch.convert import ct_to_numpy
        return ct_to_numpy(ct)

    def u32(self, v):
        if self.m.side == "jax":
            import jax.numpy as jnp
            return jnp.uint32(v)
        return v

    def copy(self, ct):
        return {k: (v + 0 if self.m.side == "jax" else v.clone())
                for k, v in ct.items()}


class TestOverlappedCTGC:
    def test_chunked_epoch_equals_whole_table_sweep(self):
        """One epoch of chunk sweeps = one whole-table sweep: the same
        table, the same count reclaimed."""
        def case(m):
            t = Table(m)
            cap, chunk = 1024, 128
            ct_a = t.filled(cap)
            ct_b = t.copy(ct_a)
            now = t.u32(100)
            swept, n_full = m.ctk.ct_sweep(ct_a, now)
            total = 0
            for start in range(0, cap, chunk):
                ct_b, n, _live = m.ctk.ct_sweep_chunk(ct_b, now,
                                                      t.u32(start), chunk)
                total += int(n)
            assert total == int(n_full)
            a, b = t.np(swept), t.np(ct_b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], k)
            return total, {k: v.tobytes() for k, v in a.items()}
        both(case)

    def test_chunk_window_wraps(self):
        def case(m):
            t = Table(m)
            cap, chunk = 256, 128
            ct = t.filled(cap)
            exp_old = t.np(ct)["expiry"]
            new_ct, n, _ = m.ctk.ct_sweep_chunk(ct, t.u32(100), t.u32(192),
                                                chunk)
            exp_new = t.np(new_ct)["expiry"]
            in_win = np.r_[np.arange(192, 256), np.arange(0, 64)]
            out_win = np.arange(64, 192)
            dead = (exp_old[in_win] > 0) & (exp_old[in_win] <= 100)
            assert (exp_new[in_win][dead] == 0).all()
            np.testing.assert_array_equal(exp_new[out_win], exp_old[out_win])
            assert int(n) == int(dead.sum())
            return int(n), exp_new.tobytes()
        both(case)

    def test_sweep_step_overlap_and_metrics(self):
        """``Engine.sweep_step`` drives the double-buffered sweep: counts
        harvest one tick late, the counter and gauge families export, live
        flows survive, expired ones are reclaimed."""
        def case(m):
            eng = jit_engine(m, ct_gc_chunk_rows=256)
            slots = eng.active.snapshot.ep_slot_of
            eng.classify(traffic(m, slots), now=1000)
            live0 = eng.datapath.ct_stats(1001)["live"]
            assert live0 > 0
            ticks = (2048 // 256) + 2
            total, steps = 0, []
            for _ in range(ticks + 1):
                st = eng.sweep_step(now=1_000_000)
                total += st["reclaimed"]
                steps.append(st)
            assert total >= live0, (total, live0)
            assert st["epoch"] >= 1
            rendered = eng.render_metrics()
            assert "ct_gc_reclaimed_total" in rendered
            assert "ct_occupancy" in rendered
            return live0, total, steps
        both(case)

    def test_gc_is_semantics_free_under_traffic(self):
        """Chunk sweeps among classify calls change no verdict."""
        def case(m):
            eng_gc, eng_ref = jit_engine(m), jit_engine(m)
            slots = eng_gc.active.snapshot.ep_slot_of
            for e in (eng_gc, eng_ref):
                e.classify(traffic(m, slots), now=1000)
            seen = []
            for step in range(6):
                now = 1005 + step
                eng_gc.sweep_step(now=now)
                a = eng_gc.classify(traffic(m, slots, flags=0x10), now=now)
                b = eng_ref.classify(traffic(m, slots, flags=0x10), now=now)
                seen.append(assert_same_verdicts(a, b, f"gc-step{step}"))
            est = np.asarray(a["status"])
            assert (est == int(m.C.CTStatus.ESTABLISHED)).any()
            return seen
        both(case)

    def test_ct_gc_fault_point(self):
        def case(m):
            eng = jit_engine(m)
            m.faults.FAULTS.arm("ct.gc", mode="fail", times=1)
            try:
                with pytest.raises(m.faults.FaultInjected):
                    eng.sweep_step()
            finally:
                m.faults.FAULTS.disarm("ct.gc")
            st = eng.sweep_step()
            assert st["chunk_rows"] == eng.config.ct_gc_chunk_rows
            return st["chunk_rows"]
        both(case)

    def test_controller_selection(self):
        """The device backend and the fake both start and register
        ``ct-gc``."""
        def case(m):
            seen = []
            for eng in (jit_engine(m), fake_engine(m)):
                try:
                    eng.start_background()
                    names = getattr(eng.controllers, "_controllers",
                                    {"ct-gc": None})
                    assert "ct-gc" in names
                    seen.append(sorted(names))
                finally:
                    eng.stop()
            return seen
        both(case)

    def test_host_sweep_exports_counters_too(self):
        def case(m):
            eng = fake_engine(m)
            slots = eng.active.snapshot.ep_slot_of
            eng.classify(traffic(m, slots), now=1000)
            reclaimed = eng.sweep(now=10_000_000)
            rendered = eng.render_metrics()
            assert "ct_occupancy" in rendered
            if reclaimed:
                assert "ct_gc_reclaimed_total" in rendered
            return reclaimed
        both(case)


# --------------------------------------------------------------------------- #
# conntrack survival across restart
# --------------------------------------------------------------------------- #
def flow_pkt(m, flags):
    s16, _ = m.ip.parse_addr("172.16.0.5")
    d16, _ = m.ip.parse_addr("192.168.1.10")
    return m.oracle.PacketRecord(s16, d16, 33333, 80, m.C.PROTO_TCP, flags,
                                 False, 1, m.C.DIR_INGRESS)


class TestClassifyFnCacheLRU:
    """The memo of ``make_classify_fn`` (the JAX package's jitted steps,
    the port's closures over its scripted step), ``FN_CACHE_CAP`` patched
    on each package in turn."""

    def test_lru_cap_and_eviction_counter(self, monkeypatch):
        def case(m):
            ck = m.classify
            monkeypatch.setattr(ck, "FN_CACHE_CAP", 4)
            ck._FN_CACHE.clear()
            ev0 = ck._FN_EVICTIONS[0]
            fns = [ck.make_classify_fn(lb_probe_depth=8 + i)
                   for i in range(6)]
            st = ck.fn_cache_stats()
            assert st["size"] <= 4
            assert ck._FN_EVICTIONS[0] == ev0 + 2
            # the most-recent entries survive; hits touch LRU order
            assert ck.make_classify_fn(lb_probe_depth=13) is fns[5]
            # an evicted key rebuilds without growing past the cap
            ck.make_classify_fn(lb_probe_depth=8)
            end = ck.fn_cache_stats()
            assert end["size"] <= 4
            return (st["size"], st["cap"], ck._FN_EVICTIONS[0] - ev0,
                    end["size"])
        assert both(case) == (4, 4, 3, 4)

    def test_memo_hit_returns_same_fn(self):
        def case(m):
            a = m.classify.make_classify_fn(probe_depth=8, packed=True)
            b = m.classify.make_classify_fn(probe_depth=8, packed=True)
            assert a is b
            return a is b
        both(case)

    def test_engine_exports_the_memo(self, monkeypatch):
        """The ``classify_fn_cache`` resource row (capacity = the cap,
        occupancy = the size), the ``classify_fn_cache_size`` gauge and
        the ``classify_fn_cache_evictions_total`` counter, folded from the
        memo's own count."""
        def case(m):
            ck = m.classify
            eng = jit_engine(m)
            try:
                eng.render_metrics()        # folds earlier evictions
                ev0 = eng.metrics.counters.get(
                    "classify_fn_cache_evictions_total", 0)
                monkeypatch.setattr(ck, "FN_CACHE_CAP", 2)
                ck._FN_CACHE.clear()
                for i in range(5):
                    ck.make_classify_fn(lb_probe_depth=20 + i)
                text = eng.render_metrics()
                row = eng.resource_step(now=1.0)["resources"][
                    "classify_fn_cache"]
                return (eng.metrics.counters[
                            "classify_fn_cache_evictions_total"] - ev0,
                        eng.metrics.gauges["classify_fn_cache_size"],
                        row["capacity"], row["occupancy"],
                        "classify_fn_cache_size" in text,
                        "classify_fn_cache_evictions_total" in text)
            finally:
                eng.stop()
        assert both(case) == (3, 2, 2, 2, True, True)


class TestCTRestart:
    @pytest.mark.parametrize("backend", ["fake", "jit"])
    def test_established_flows_survive_restart(self, tmp_path, backend):
        def case(m):
            C = m.C

            def dp():
                return (device_dp(m) if backend == "jit"
                        else m.datapath.FakeDatapath(config(m)))
            eng = make_engine(m, dp())
            slots = eng.active.snapshot.ep_slot_of
            out = eng.classify(m.records.batch_from_records(
                [flow_pkt(m, C.TCP_SYN)], slots), now=1000)
            assert bool(out["allow"][0])
            path = str(tmp_path / f"ckpt-{m.side}")
            m.ckpt.save(eng, path)
            eng.stop()

            eng2 = m.engine.Engine(config(m), datapath=dp())
            assert m.ckpt.restore(eng2, path) is True
            out2 = eng2.classify(m.records.batch_from_records(
                [flow_pkt(m, 0x10)], eng2.active.snapshot.ep_slot_of),
                now=1005)
            assert bool(out2["allow"][0])
            assert int(out2["status"][0]) == int(C.CTStatus.ESTABLISHED)
            eng2.stop()

            eng3 = make_engine(m, dp())
            out3 = eng3.classify(m.records.batch_from_records(
                [flow_pkt(m, 0x10)], eng3.active.snapshot.ep_slot_of),
                now=1005)
            assert int(out3["status"][0]) == int(C.CTStatus.NEW)
            return cols(out), cols(out2), cols(out3)
        both(case)

    def test_ct_archive_is_versioned(self, tmp_path):
        def case(m):
            version = m.datapath.CT_FORMAT_VERSION
            eng = fake_engine(m)
            eng.classify(m.records.batch_from_records(
                [flow_pkt(m, m.C.TCP_SYN)], eng.active.snapshot.ep_slot_of),
                now=1000)
            path = str(tmp_path / f"ckpt-{m.side}")
            m.ckpt.save(eng, path)
            with np.load(os.path.join(path, "ct.npz")) as npz:
                assert "__ct_format__" in npz.files
                assert int(npz["__ct_format__"]) == version
            state = m.ckpt._read_state(path)
            assert state["ct_format"] == version
            arrays = m.ckpt._read_ct(path)
            np.savez(os.path.join(path, "ct.npz"),
                     __ct_format__=np.int32(version + 1), **arrays)
            assert m.ckpt._read_ct(path) is None
            return version, {k: v.tobytes() for k, v in arrays.items()}
        both(case)

    @pytest.mark.slow
    def test_restart_mid_soak_keeps_verdicts(self, tmp_path):
        """Pipelined traffic, a restart mid-soak (save → stop → fresh
        engine → restore): established flows keep their verdicts."""
        def case(m):
            C = m.C
            eng = jit_engine(m)
            slots = eng.active.snapshot.ep_slot_of
            n_flows = 48
            syn = [m.oracle.PacketRecord(
                m.ip.parse_addr("172.16.0.5")[0],
                m.ip.parse_addr("192.168.1.10")[0], 40000 + i, 80,
                C.PROTO_TCP, C.TCP_SYN, False, 1, C.DIR_INGRESS)
                for i in range(n_flows)]
            ack = [m.oracle.PacketRecord(p.src_addr, p.dst_addr, p.src_port,
                                         p.dst_port, p.proto, 0x10, False,
                                         p.ep_id, p.direction) for p in syn]
            bfr = m.records.batch_from_records
            for chunk in range(0, n_flows, 16):
                eng.submit(bfr(syn[chunk:chunk + 16], slots),
                           now=3000 + chunk).result(timeout=30)
            for chunk in range(0, n_flows, 16):
                eng.submit(bfr(ack[chunk:chunk + 16], slots),
                           now=3050).result(timeout=30)
            assert eng.drain(timeout=30)
            path = str(tmp_path / f"soak-ckpt-{m.side}")
            m.ckpt.save(eng, path)
            eng.stop()

            eng2 = m.engine.Engine(config(m), datapath=device_dp(m))
            assert m.ckpt.restore(eng2, path) is True
            slots2 = eng2.active.snapshot.ep_slot_of
            est = 0
            for chunk in range(0, n_flows, 16):
                out = eng2.submit(bfr(ack[chunk:chunk + 16], slots2),
                                  now=3100 + chunk).result(timeout=30)
                est += int((np.asarray(out["status"])
                            == int(C.CTStatus.ESTABLISHED)).sum())
            eng2.stop()
            assert est == n_flows, f"only {est}/{n_flows} flows survived"
            return est
        both(case)


# --------------------------------------------------------------------------- #
# the storm soak with the parity auditor at sampling 1.0
# --------------------------------------------------------------------------- #
class TestStormAudit:
    @pytest.mark.slow
    def test_policy_storm_audited_at_full_sampling(self):
        """Pipelined traffic under rule churn with the shadow auditor at
        sampling 1.0: zero mismatches, and the churn took the delta path."""
        def case(m):
            eng = jit_engine(m, audit_enabled=True, audit_sample_rate=1.0,
                             audit_pool_batches=64, audit_max_rows=512)
            eng.auditor.configure(sample_rate=1.0)
            warm_geometry(eng)
            slots = eng.active.snapshot.ep_slot_of
            now = 5000
            tickets = []
            for step in range(60):
                if step % 3 == 0:
                    i, p = step % N_PEERS, (443, 8080)[step % 2]
                    label = f"k8s:warm=w{i}-{p}"
                    body = None if step % 6 else peer_rule_docs(i, p,
                                                                label=label)
                    eng.replace_policy([label], body)
                    eng.regenerate()
                tickets.append(eng.submit(traffic(m, slots), now=now))
                now += 1
            assert eng.drain(timeout=120)
            for t in tickets:
                t.result(timeout=10)
            for _ in range(200):
                step = eng.audit_step(budget=64)
                if not step or (not step.get("replayed")
                                and not step.get("pending")):
                    break
            st = eng.auditor.stats()
            assert st["checked_rows"] > 0, st
            assert st["mismatched_rows"] == 0, st
            assert eng.datapath.patch_stats["patch_delta"] >= 1
            eng.stop()
            # which revision each pipelined batch meets depends on the
            # threads' timing, so only the audit's verdict is compared
            return st["mismatched_rows"]
        both(case)


@pytest.mark.parametrize("path", ["submit", "classify"])
def test_dispatch_retry_outlasts_back_to_back_patches(path):
    """The port's dispatches retry a ``StalePlacement`` under the engine
    lock, so a patch cannot land between a retry's capture of the active
    snapshot and its enqueue again: the pipeline's (``submit``) and the
    synchronous ``Engine.classify``. Found by the storm-audit mirror
    above: on the port's CPU path a pipeline dispatch met a fresh patch on
    each of its four attempts and the batch failed (``PipelineError``);
    the JAX package's dispatches have the same window. Here a rule toggle
    lands from another thread just before each of a dispatch's first six
    enqueues: the batch resolves, and the fence fired."""
    import threading
    m = U("torch")
    eng = jit_engine(m)
    warm_geometry(eng)
    label = "k8s:warm=w0-443"
    state = {"calls": 0, "on": True}

    def toggle():
        state["on"] = not state["on"]
        eng.replace_policy([label], peer_rule_docs(
            0, 443, label=label) if state["on"] else None)
        eng.regenerate()

    name = "classify_async" if path == "submit" else "classify"
    real = getattr(eng.datapath, name)

    def patched_first(*args, **kw):
        state["calls"] += 1
        if state["calls"] <= 6:
            t = threading.Thread(target=toggle)
            t.start()
            t.join(timeout=0.5)    # blocks while the dispatch holds the lock
        return real(*args, **kw)

    setattr(eng.datapath, name, patched_first)
    batch = traffic(m, eng.active.snapshot.ep_slot_of)
    try:
        out = (eng.submit(batch, now=700).result(timeout=60)
               if path == "submit" else eng.classify(batch, now=700))
    finally:
        setattr(eng.datapath, name, real)
    assert out["allow"].shape[0] == 3 * N_PEERS
    assert eng.datapath.patch_stats["patch_stale_fences"] >= 1
    assert eng.drain(timeout=30)
    eng.stop()
