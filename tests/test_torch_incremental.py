"""The port's incremental compiler against the JAX package's, step by step.

The sequences of ``tests/test_incremental.py`` (randomized add / remove /
refresh, the geometry paths and the gates) and the cfg5 one-rule update of
``bench.update_latency_bench`` run over both packages side by side: the
same world, the same rule documents and the same operations go to
``cilium_tpu`` and to ``cilium_tpu_torch``. At every step the two
``IncrementalCompiler.try_update`` results must be equal: fallback or not
(and ``last_fallback``), the ``SnapshotPatch`` (``verdict_rows``,
``full_tensors``, ``delta_rows``, ``delta_vals``), the ``UpdateStats``
(``fallback`` included), and the patched snapshot's ``tensors()`` byte for
byte.
"""

import dataclasses
import random
from types import SimpleNamespace

import numpy as np
import pytest

from tests.test_torch_compile import (PKGS, assert_tensors_equal, cfg5_plane,
                                      ctx_repo, modules, web_ep)

CT_CAP = 1024
N_PEERS = 12


def incremental_world(m, n_eps=2, n_peers=N_PEERS):
    """``tests/test_incremental.make_world`` over package modules ``m``."""
    ctx, repo = ctx_repo(m)
    eps = []
    for e in range(n_eps):
        lbls = m.labels.Labels.parse([f"k8s:app=web{e}"])
        ident = ctx.allocator.allocate(lbls)
        ctx.ipcache.upsert(f"192.168.{e}.10/32", ident.id)
        eps.append(m.endpoint.Endpoint(ep_id=e + 1, labels=lbls,
                                       identity_id=ident.id))
    for i in range(n_peers):
        ident = ctx.allocator.allocate(m.labels.Labels.parse(
            [f"k8s:peer=p{i}", f"k8s:group=g{i % 3}"]))
        ctx.ipcache.upsert(f"172.16.{i}.0/24", ident.id)
    return ctx, repo, eps


def l4_doc(ep_sel, group, port, proto="TCP", deny=False, l7=None,
           direction="ingress"):
    """``tests/test_incremental.l4_rule``'s document."""
    block = {"fromEndpoints" if direction.startswith("in") else "toEndpoints":
             [{"matchLabels": {"group": f"g{group}"}}]}
    if port is not None:
        pr = {"ports": [{"port": str(port), "protocol": proto}]}
        if l7:
            pr["rules"] = {"http": l7}
        block["toPorts"] = [pr]
    key = direction if not deny else direction + "Deny"
    return {"endpointSelector": {"matchLabels": {"app": ep_sel}},
            key: [block]}


class Pair:
    """One world per package, driven by the same operations."""

    def __init__(self, build):
        self.sides = []
        for pkg in PKGS:
            m = modules(pkg)
            ctx, repo, eps = build(m)
            self.sides.append(SimpleNamespace(m=m, ctx=ctx, repo=repo,
                                              eps=eps, inc=None))

    def add(self, doc, label=None):
        for s in self.sides:
            rule = s.m.rules.parse_rule(doc)
            if label is not None:
                object.__setattr__(rule, "labels",
                                   s.m.labels.Labels.parse([label]))
            s.repo.add([rule])

    def delete(self, label):
        for s in self.sides:
            s.repo.delete_by_labels(s.m.labels.Labels.parse([label]))

    def do(self, fn):
        for s in self.sides:
            fn(s)

    def seed(self, cap=CT_CAP):
        """Full build in both, then an incremental compiler over it."""
        snaps = []
        for s in self.sides:
            snap = s.m.snapshot.build_snapshot(
                s.repo, s.ctx, s.eps, s.m.ct_layout.CTConfig(capacity=cap))
            s.inc = s.m.incremental.IncrementalCompiler(s.repo, s.ctx, s.eps,
                                                        snap)
            snaps.append(snap)
        assert_tensors_equal(snaps[1].tensors(), snaps[0].tensors(), "seed")
        return snaps[1]

    def update(self, cap=CT_CAP, endpoints=None):
        """``try_update`` in both; everything it returns must be equal.
        → the port's (snapshot, patch, stats), or None on a fallback."""
        results = []
        for s in self.sides:
            kw = {} if endpoints is None else {"endpoints": endpoints(s)}
            results.append(s.inc.try_update(
                s.m.ct_layout.CTConfig(capacity=cap), **kw))
        ref, port = results
        assert (ref is None) == (port is None)
        assert self.sides[0].inc.last_fallback \
            == self.sides[1].inc.last_fallback
        if ref is None:
            return None
        assert_patch_equal(port[1], ref[1])
        assert dataclasses.asdict(port[2]) == dataclasses.asdict(ref[2])
        assert port[0].revision == ref[0].revision
        assert port[0].static_config() == ref[0].static_config()
        assert type(port[0].image).__name__ == type(ref[0].image).__name__
        assert_tensors_equal(port[0].tensors(), ref[0].tensors(), "patched")
        return port


def assert_patch_equal(got, want):
    assert got.base_revision == want.base_revision
    assert got.verdict_rows == want.verdict_rows
    assert got.full_tensors == want.full_tensors
    assert got.is_delta == want.is_delta and got.is_noop == want.is_noop
    for name in ("delta_rows", "delta_vals"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            assert (g.shape, g.dtype) == (w.shape, w.dtype), name
            assert g.tobytes() == w.tobytes(), name


# --------------------------------------------------------------------------- #
# TestRandomizedParity
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_randomized_add_remove_sequences(seed):
    rng = random.Random(seed)
    pair = Pair(incremental_world)
    pair.add(l4_doc("web0", 0, 80))
    pair.add(l4_doc("web0", 1, 443, deny=True))
    pair.add(l4_doc("web1", 2, None))
    pair.seed()
    label_pool = [f"batch={b}" for b in range(6)]
    kinds = set()
    for step in range(14):
        op = rng.random()
        tag = rng.choice(label_pool)
        if op < 0.55 or len(pair.sides[0].repo) < 2:
            kind = rng.random()
            port = rng.choice([80, 81, 443, 1000, 8080, None])
            group = rng.randrange(3)
            ep_sel = rng.choice(["web0", "web1"])
            if kind < 0.25:
                doc = l4_doc(ep_sel, group, port, deny=True)
            elif kind < 0.45 and port is not None:
                doc = l4_doc(ep_sel, group, port,
                             l7=[{"method": "GET", "path": f"/v{step}"}])
            elif kind < 0.6:
                doc = l4_doc(ep_sel, group, port, proto="UDP")
            else:
                doc = l4_doc(ep_sel, group, port)
            pair.add(doc, f"k8s:{tag}")
        else:
            pair.delete(f"k8s:{tag}")
        res = pair.update()
        assert res is not None, f"fallback at step {step}"
        kinds.add(res[1].is_delta)
    assert True in kinds                 # the delta path ran


def test_emitted_snapshots_stay_frozen():
    pair = Pair(incremental_world)
    pair.add(l4_doc("web0", 0, 80))
    snap0 = pair.seed()
    v0 = snap0.image.verdict.copy()
    pair.add(l4_doc("web0", 1, 443, deny=True))
    snap1, _patch, _stats = pair.update()
    v1 = snap1.image.verdict.copy()
    pair.add(l4_doc("web0", 2, 8080))
    pair.update()
    np.testing.assert_array_equal(snap0.image.verdict, v0)
    np.testing.assert_array_equal(snap1.image.verdict, v1)


# --------------------------------------------------------------------------- #
# TestGeometryPaths
# --------------------------------------------------------------------------- #
def test_port_class_split():
    pair = Pair(incremental_world)
    pair.add(l4_doc("web0", 0, 80))
    snap = pair.seed()
    pair.add(l4_doc("web0", 1, 5000))
    inc_snap, patch, stats = pair.update()
    assert stats.port_class_splits >= 1
    assert inc_snap.image.verdict.shape[3] > snap.image.verdict.shape[3]
    assert "port_class" in patch.full_tensors


def test_identity_class_split():
    pair = Pair(incremental_world)
    pair.add(l4_doc("web0", 0, 80))
    pair.seed()
    pair.add({"endpointSelector": {"matchLabels": {"app": "web0"}},
              "ingressDeny": [{"fromEndpoints": [
                  {"matchLabels": {"peer": "p0"}}]}]})
    _snap, _patch, stats = pair.update()
    assert stats.id_class_splits >= 1


def test_enforced_flip():
    pair = Pair(incremental_world)
    pair.add(l4_doc("web0", 0, 80))
    pair.seed()
    pair.add(l4_doc("web0", 1, 443, direction="egress"), "k8s:eg=1")
    _snap, patch, _stats = pair.update()
    assert "enforced" in patch.full_tensors
    pair.delete("k8s:eg=1")
    _snap, patch, _stats = pair.update()
    assert "enforced" in patch.full_tensors


def test_identity_growth_and_retirement():
    pair = Pair(incremental_world)
    pair.add(l4_doc("web0", 0, 80))
    pair.seed()
    pair.add({"endpointSelector": {"matchLabels": {"app": "web0"}},
              "egress": [{"toCIDR": ["10.5.0.0/16"]}]})
    _snap, patch, stats = pair.update()
    assert stats.new_identities == 1 and stats.lpm_rebuilt
    assert {"verdict", "id_class_of", "identity_ids", "lpm_v4",
            "lpm_v6"} <= patch.full_tensors
    pair.do(lambda s: s.repo.clear())
    _snap, _patch, stats = pair.update()
    assert stats.retired_identities == 1


# --------------------------------------------------------------------------- #
# TestMoreGates
# --------------------------------------------------------------------------- #
def test_enforcement_mode_change_gates():
    pair = Pair(incremental_world)
    pair.add(l4_doc("web0", 0, 80))
    pair.seed()

    def never(s):
        s.ctx.enforcement_mode = s.m.C.ENFORCEMENT_NEVER
    pair.do(never)
    assert pair.update() is None
    assert pair.sides[1].inc.last_fallback == "enforcement-mode-changed"


def test_endpoint_gate_via_param():
    pair = Pair(incremental_world)
    pair.add(l4_doc("web0", 0, 80))
    pair.seed()

    def grown(s):
        return list(s.eps) + [s.m.endpoint.Endpoint(
            ep_id=99, labels=s.eps[0].labels,
            identity_id=s.eps[0].identity_id)]
    assert pair.update(endpoints=grown) is None
    assert pair.sides[1].inc.last_fallback == "endpoint-set-changed"
    pair.add(l4_doc("web0", 1, 443))
    assert pair.update(endpoints=lambda s: s.eps) is not None


# --------------------------------------------------------------------------- #
# the cfg5 one-rule update (bench.update_latency_bench) and the lazy image
# --------------------------------------------------------------------------- #
P7_RULE = {"endpointSelector": {"matchLabels": {"app": "web"}},
           "ingress": [{"fromEndpoints": [{"matchLabels": {"pod": "p7"}}],
                        "toPorts": [{"ports": [{"port": "4242",
                                                "protocol": "TCP"}]}]}]}


def cfg5_world(m):
    ctx, repo = ctx_repo(m)
    ep = web_ep(m, ctx)
    cfg5_plane(m, ctx, repo)
    return ctx, repo, [ep]


@pytest.fixture(scope="module")
def cfg5_pair():
    pair = Pair(cfg5_world)
    pair.seed(cap=1 << 16)
    return pair


def test_cfg5_one_rule_add_and_remove(cfg5_pair):
    pair = cfg5_pair
    pair.add(P7_RULE, "k8s:bench=u1")
    snap, patch, stats = pair.update(cap=1 << 16)
    assert patch.is_delta and stats.fallback is None
    assert stats.delta_rows == len(patch.verdict_rows) >= 1
    pair.delete("k8s:bench=u1")
    snap, patch, stats = pair.update(cap=1 << 16)
    assert patch.is_delta


def test_delta_snapshot_keeps_its_verdict_lazy(cfg5_pair):
    """``tensors(only={"enforced"})`` of a delta-emitted snapshot reads the
    enforced flags without materialising the dense verdict image."""
    pair = cfg5_pair
    pair.add(P7_RULE, "k8s:bench=u2")
    (ref, _rp, _rs), (snap, patch, _stats) = (
        s.inc.try_update(s.m.ct_layout.CTConfig(capacity=1 << 16))
        for s in pair.sides)
    assert patch.is_delta
    assert isinstance(snap.image, modules("cilium_tpu_torch")
                      .policy_image.OverlayImage)
    only = snap.tensors(only=frozenset({"enforced"}))
    assert list(only) == ["enforced"]
    assert snap.image._dense is None
    assert snap.nbytes == ref.nbytes
    assert snap.image._dense is None
    assert_tensors_equal(snap.tensors(), ref.tensors())
    assert snap.image._dense is not None          # now it materialised
    pair.delete("k8s:bench=u2")
    assert pair.update(cap=1 << 16) is not None


# --------------------------------------------------------------------------- #
# TestEngineIncremental, TestEndpointGate: the production loop takes the
# patch path, held equal to a full build, on each package
# --------------------------------------------------------------------------- #
ENG_MODS = {"config": "runtime.config", "datapath": "runtime.datapath",
            "engine": "runtime.engine", "records": "kernels.records",
            "C": "utils.constants", "ip": "utils.ip"}
ENG_ORACLE = {"cilium_tpu": "oracle", "cilium_tpu_torch":
              "cilium_tpu_torch.oracle"}
#: the out columns ``test_incremental.TestEngineIncremental`` compares
ENG_OUT = ("allow", "reason", "status", "remote_identity", "redirect")


def eng_modules(pkg):
    """The engine's modules of package ``pkg``; the port's ``TorchDatapath``
    stands for the reference's ``JITDatapath`` (``backend="jit"``)."""
    import importlib
    ns = {k: importlib.import_module(f"{pkg}.{v}")
          for k, v in ENG_MODS.items()}
    ns["oracle"] = importlib.import_module(ENG_ORACLE[pkg])
    m = SimpleNamespace(pkg=pkg, **ns)
    m.Device = (m.datapath.TorchDatapath if pkg == "cilium_tpu_torch"
                else m.datapath.JITDatapath)
    return m


def eng_config(m, **kw):
    if m.pkg == "cilium_tpu_torch":
        kw["device"] = "cpu"
    return m.config.DaemonConfig(**kw)


def eng_both(case):
    """Run ``case(m)`` on each package. → the port's observation, held
    equal to the reference's."""
    obs = [case(eng_modules(pkg)) for pkg in PKGS]
    assert obs[0] == obs[1]
    return obs[1]


def out_obs(out, keys=ENG_OUT):
    return {k: np.asarray(out[k]).astype(np.int64).tolist() for k in keys}


class TestEngineIncremental:
    """``tests/test_incremental.py::TestEngineIncremental`` on both
    packages: the incremental engine's verdicts equal a full-build engine's
    on each side, and the two sides' verdicts are equal."""

    @staticmethod
    def _world_engine(m, datapath, incremental=True):
        eng = m.engine.Engine(eng_config(m, ct_capacity=2048,
                                         auto_regen=False,
                                         incremental=incremental),
                              datapath=datapath)
        eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",), ep_id=1)
        for i in range(6):
            eng.add_endpoint([f"k8s:peer=p{i}", f"k8s:group=g{i % 2}"],
                             ips=(f"172.16.{i}.5",), ep_id=10 + i)
        eng.apply_policy([{
            "endpointSelector": {"matchLabels": {"app": "web"}},
            "ingress": [{"fromEndpoints": [{"matchLabels": {"group": "g0"}}],
                         "toPorts": [{"ports": [
                             {"port": "80", "protocol": "TCP"}]}]}]}])
        eng.regenerate()
        return eng

    @staticmethod
    def _traffic(m, slots):
        C = m.C
        pkts = []
        for i in range(6):
            for dp in (80, 443, 8080):
                s16, _ = m.ip.parse_addr(f"172.16.{i}.5")
                d16, _ = m.ip.parse_addr("192.168.1.10")
                pkts.append(m.oracle.PacketRecord(
                    s16, d16, 30000 + i, dp, C.PROTO_TCP, C.TCP_SYN, False,
                    1, C.DIR_INGRESS))
        return m.records.batch_from_records(pkts, slots)

    @pytest.mark.parametrize("backend", ["jit", "fake"])
    def test_incremental_engine_matches_full_engine(self, backend):
        updates = [
            [{"endpointSelector": {"matchLabels": {"app": "web"}},
              "ingress": [{"fromEndpoints": [
                  {"matchLabels": {"group": "g1"}}],
                  "toPorts": [{"ports": [
                      {"port": "443", "protocol": "TCP"}]}]}]}],
            [{"endpointSelector": {"matchLabels": {"app": "web"}},
              "ingressDeny": [{"fromEndpoints": [
                  {"matchLabels": {"peer": "p0"}}]}]}],
            [{"endpointSelector": {"matchLabels": {"app": "web"}},
              "ingress": [{"toPorts": [{
                  "ports": [{"port": "8080", "protocol": "TCP"}],
                  "rules": {"http": [{"method": "GET",
                                      "path": "/api"}]}}]}]}],
        ]

        def case(m):
            def dp():
                if backend == "jit":
                    return m.Device(eng_config(m, ct_capacity=2048,
                                               auto_regen=False))
                return m.datapath.FakeDatapath(eng_config(m,
                                                          ct_capacity=2048))
            eng_inc = self._world_engine(m, dp(), incremental=True)
            eng_full = self._world_engine(m, dp(), incremental=False)
            seen = []
            try:
                now = 1000
                for docs in updates:
                    eng_inc.apply_policy(docs)
                    eng_full.apply_policy(docs)
                    eng_inc.regenerate()
                    eng_full.regenerate()
                    slots = eng_inc.active.snapshot.ep_slot_of
                    assert slots == eng_full.active.snapshot.ep_slot_of
                    batch = self._traffic(m, slots)
                    out_i = out_obs(eng_inc.classify(dict(batch), now=now))
                    out_f = out_obs(eng_full.classify(dict(batch), now=now))
                    assert out_i == out_f
                    seen.append((dict(slots), out_i))
                    now += 50
                rendered = eng_inc.metrics.render_prometheus()
                assert "regen_incremental_total" in rendered
                return seen, [ln for ln in rendered.splitlines()
                              if ln.startswith("regen_incremental_total")]
            finally:
                eng_inc.stop()
                eng_full.stop()
        eng_both(case)

    def test_incremental_sharded_backend(self):
        """``place_patch`` through the meshed backend (the reference's
        2 × 2 JAX mesh; the port's single-process mesh on ``cpu``): row
        updates on a sharded verdict tensor."""
        deny = [{"endpointSelector": {"matchLabels": {"app": "web"}},
                 "ingressDeny": [{"fromEndpoints": [
                     {"matchLabels": {"peer": "p2"}}]}]}]

        def case(m):
            eng_inc = self._world_engine(
                m, m.Device(eng_config(m, ct_capacity=2048, auto_regen=False,
                                       n_shards=2, rule_shards=2)),
                incremental=True)
            eng_full = self._world_engine(
                m, m.datapath.FakeDatapath(eng_config(m, ct_capacity=2048)),
                incremental=False)
            try:
                eng_inc.apply_policy(deny)
                eng_full.apply_policy(deny)
                eng_inc.regenerate()
                eng_full.regenerate()
                slots = eng_inc.active.snapshot.ep_slot_of
                batch = self._traffic(m, slots)
                keys = ENG_OUT[:4]
                out_i = out_obs(eng_inc.classify(dict(batch), now=500), keys)
                out_f = out_obs(eng_full.classify(dict(batch), now=500),
                                keys)
                assert out_i == out_f
                return dict(slots), out_i
            finally:
                eng_inc.stop()
                eng_full.stop()
        eng_both(case)


class TestEndpointGate:
    def test_add_endpoint_falls_back_to_full_build(self):
        """A new endpoint reusing an existing identity (no ipcache change)
        still invalidates the incremental path: the snapshot's endpoint
        slots changed."""
        def case(m):
            eng = m.engine.Engine(
                eng_config(m, ct_capacity=1024, auto_regen=False,
                           incremental=True),
                datapath=m.datapath.FakeDatapath(eng_config(
                    m, ct_capacity=1024)))
            try:
                eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10",),
                                 ep_id=1)
                eng.apply_policy([{
                    "endpointSelector": {"matchLabels": {"app": "web"}},
                    "ingress": [{"toPorts": [{"ports": [
                        {"port": "80", "protocol": "TCP"}]}]}]}])
                eng.regenerate()
                eng.add_endpoint(["k8s:app=web"], ep_id=2)
                snap = eng.regenerate().snapshot
                assert 2 in snap.ep_slot_of, \
                    "new endpoint missing from snapshot"
                grown = dict(snap.ep_slot_of)
                eng.remove_endpoint(2)
                snap = eng.regenerate().snapshot
                assert 2 not in snap.ep_slot_of
                return grown, dict(snap.ep_slot_of), [
                    ln for ln in eng.metrics.render_prometheus().splitlines()
                    if ln.startswith("regen_")]
            finally:
                eng.stop()
        eng_both(case)
