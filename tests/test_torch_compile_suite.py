"""The port's tensor compiler against the JAX package's, case for case with
``tests/test_compile.py``: the LPM trie against the reference LPM, port
classes, identity classes, the L7 tensors against the oracle, the central
property (dense verdict cell = sparse MapState ladder) and the end-to-end
snapshot build.

Each case runs the reference's body once on each package's modules,
asserts the reference's expectations on both, and holds a side-neutral
observation equal: every array the case builds (LPM nodes, the port class
table, identity classes, L7 tensors, the dense plane, the snapshot's
tensors) as shape, dtype and bytes, and every answer the case checks (the
LPM's identities, class ids, L7 matches, dense and ladder decisions,
verdict cells). ``test_match_parity_with_oracle`` holds each package's L7
tensors against its own oracle's ``l7_match``, and the two packages'
answers against each other.
"""

import importlib
import ipaddress
import random
from types import SimpleNamespace

import numpy as np
import pytest

SIDES = ("jax", "torch")
PKG = {"jax": "cilium_tpu", "torch": "cilium_tpu_torch"}
ORACLE = {"jax": "oracle.datapath",
          "torch": "cilium_tpu_torch.oracle.datapath"}
MODS = {"idclass": "compile.idclass", "l7": "compile.l7", "lpm": "compile.lpm",
        "policy_image": "compile.policy_image",
        "portclass": "compile.portclass", "snapshot": "compile.snapshot",
        "endpoint": "model.endpoint", "identity": "model.identity",
        "ipcache": "model.ipcache", "labels": "model.labels",
        "rules": "model.rules", "policy": "policy",
        "mapstate": "policy.mapstate", "selectorcache": "policy.selectorcache",
        "C": "utils.constants", "ip": "utils.ip"}


def P(side):
    """``side``'s modules by short name, its oracle as ``oracle``."""
    ns = {k: importlib.import_module(f"{PKG[side]}.{v}")
          for k, v in MODS.items()}
    ns["oracle"] = importlib.import_module(ORACLE[side])
    return SimpleNamespace(side=side, **ns)


def both(case):
    """Run ``case(m)`` on each package. → the port's observation, held
    equal to the reference's."""
    obs = {s: case(P(s)) for s in SIDES}
    assert obs["jax"] == obs["torch"]
    return obs["torch"]


def arr(a):
    """An array as (shape, dtype, bytes)."""
    a = np.ascontiguousarray(a)
    return a.shape, a.dtype.str, a.tobytes()


class TestLPM:
    @staticmethod
    def _roundtrip(m, entries, probes):
        """The reference's round trip on ``m``. → the identities the trie
        gave, and its node tables."""
        C = m.C
        ident_ids = sorted(set(entries.values()) | {C.IDENTITY_WORLD})
        index = {i: n for n, i in enumerate(ident_ids)}
        tables = m.lpm.build_lpm(entries, index,
                                 default_index=index[C.IDENTITY_WORLD])
        got = []
        for addr in probes:
            want = m.ipcache.lpm_lookup(entries, addr)
            addr16, is_v6 = m.ip.parse_addr(addr)
            got_idx = m.lpm.lpm_lookup_host(tables, addr16, is_v6)
            assert ident_ids[got_idx] == want, \
                f"{m.side} {addr}: {ident_ids[got_idx]} != {want}"
            got.append(ident_ids[got_idx])
        return got, arr(tables.v4_nodes), arr(tables.v6_nodes)

    def test_basic_v4(self):
        entries = {"10.0.0.0/8": 100, "10.1.0.0/16": 200,
                   "10.1.2.3/32": 300, "0.0.0.0/0": 400}
        both(lambda m: self._roundtrip(m, entries, [
            "10.1.2.3", "10.1.9.9", "10.2.0.1", "8.8.8.8", "10.1.2.4"]))

    def test_miss_is_world(self):
        def case(m):
            C = m.C
            tables = m.lpm.build_lpm({"10.0.0.0/8": 100},
                                     {100: 1, C.IDENTITY_WORLD: 0},
                                     default_index=0)
            addr16, v6 = m.ip.parse_addr("8.8.8.8")
            got = m.lpm.lpm_lookup_host(tables, addr16, v6)
            assert got == 0
            return got, arr(tables.v4_nodes), arr(tables.v6_nodes)
        both(case)

    def test_non_octet_prefixes(self):
        entries = {"10.0.0.0/12": 1, "10.16.0.0/12": 2, "10.0.0.0/9": 3,
                   "192.168.0.0/22": 4}
        both(lambda m: self._roundtrip(m, entries, [
            "10.0.0.1", "10.15.255.255", "10.16.0.1", "10.31.9.9",
            "10.127.0.1", "10.128.0.1", "192.168.3.255", "192.168.4.0"]))

    def test_v6(self):
        entries = {"2001:db8::/32": 1, "2001:db8:1::/48": 2, "::/0": 3,
                   "2001:db8:1:2::5/128": 4}
        both(lambda m: self._roundtrip(m, entries, [
            "2001:db8::1", "2001:db8:1::9", "2001:db8:1:2::5", "fe80::1"]))

    def test_family_separation(self):
        entries = {"::/0": 1, "0.0.0.0/0": 2}
        both(lambda m: self._roundtrip(m, entries, ["1.2.3.4",
                                                    "2001:db8::1"]))

    def test_random_property(self):
        rng = random.Random(42)
        entries = {}
        for _ in range(300):
            plen = rng.choice([8, 12, 16, 20, 24, 28, 32])
            addr = (f"{rng.randrange(1, 224)}.{rng.randrange(256)}."
                    f"{rng.randrange(256)}.{rng.randrange(256)}")
            net = str(ipaddress.ip_network(f"{addr}/{plen}", strict=False))
            entries[net] = rng.randrange(1000, 5000)
        probes = [f"{rng.randrange(1, 224)}.{rng.randrange(256)}."
                  f"{rng.randrange(256)}.{rng.randrange(256)}"
                  for _ in range(200)]
        both(lambda m: self._roundtrip(m, entries, probes))


def ports_obs(t):
    return arr(t.table), t.n_classes, t.family_class_ranges


class TestPortClasses:
    def test_partition(self):
        def case(m):
            C = m.C
            t = m.portclass.build_port_classes(
                {C.PROTO_FAMILY_TCP: [(80, 80), (8080, 8090)]})
            tcp = t.table[C.PROTO_FAMILY_TCP]
            assert tcp[80] != tcp[79] and tcp[80] != tcp[81]
            assert tcp[8080] == tcp[8085] == tcp[8090]
            assert tcp[8079] != tcp[8080] and tcp[8091] != tcp[8090]
            assert tcp[0] == tcp[79] and tcp[81] == tcp[8079] \
                and tcp[8091] == tcp[65535]
            assert tcp[79] != tcp[81]
            return ports_obs(t)
        both(case)

    def test_families_disjoint(self):
        def case(m):
            C = m.C
            t = m.portclass.build_port_classes(
                {C.PROTO_FAMILY_TCP: [(80, 80)],
                 C.PROTO_FAMILY_UDP: [(53, 53)]})
            assert set(np.unique(t.table[C.PROTO_FAMILY_TCP])).isdisjoint(
                set(np.unique(t.table[C.PROTO_FAMILY_UDP])))
            return ports_obs(t)
        both(case)

    def test_classes_for_range(self):
        def case(m):
            C = m.C
            t = m.portclass.build_port_classes(
                {C.PROTO_FAMILY_TCP: [(10, 20), (15, 30)]})
            one = t.classes_for_range(C.PROTO_FAMILY_TCP, 15, 20)
            three = t.classes_for_range(C.PROTO_FAMILY_TCP, 10, 30)
            assert len(one) == 1
            assert len(three) == 3
            return one.tolist(), three.tolist(), ports_obs(t)
        both(case)


def id_classes_obs(ic):
    return (arr(ic.identity_ids), sorted(ic.index_of.items()),
            arr(ic.class_of), ic.n_classes, arr(ic.representative))


class TestIdentityClasses:
    def test_same_entries_same_class(self):
        def case(m):
            C, ms_mod = m.C, m.mapstate
            ms = ms_mod.MapState()
            for ident in (100, 200):
                ms.add(ms_mod.MapStateKey(ident, C.PROTO_TCP, 80, 80),
                       ms_mod.MapStateEntry())
            ms.add(ms_mod.MapStateKey(300, C.PROTO_TCP, 443, 443),
                   ms_mod.MapStateEntry())
            ic = m.idclass.build_identity_classes(
                [2, 100, 200, 300, 400], [(0, C.DIR_INGRESS, ms)])
            cls = {i: int(ic.class_of[ic.index_of[i]])
                   for i in (2, 100, 200, 300, 400)}
            assert cls[100] == cls[200]
            assert cls[300] != cls[100]
            assert cls[2] == cls[400] == 0
            return cls, id_classes_obs(ic)
        both(case)

    def test_deny_distinguishes(self):
        def case(m):
            C, ms_mod = m.C, m.mapstate
            ms = ms_mod.MapState()
            ms.add(ms_mod.MapStateKey(100, C.PROTO_TCP, 80, 80),
                   ms_mod.MapStateEntry())
            ms.add(ms_mod.MapStateKey(200, C.PROTO_TCP, 80, 80),
                   ms_mod.MapStateEntry(deny=True))
            ic = m.idclass.build_identity_classes([100, 200], [(0, 0, ms)])
            assert ic.class_of[ic.index_of[100]] \
                != ic.class_of[ic.index_of[200]]
            return id_classes_obs(ic)
        both(case)


class TestL7Tensors:
    def test_match_parity_with_oracle(self):
        def case(m):
            C = m.C
            interner = m.l7.L7SetInterner()
            rules = frozenset({m.rules.HTTPRule(method="GET", path="/api"),
                               m.rules.HTTPRule(method="", path="/public")})
            sid = interner.intern(rules)
            t = m.l7.build_l7_tensors(interner)
            cases = [(C.HTTP_METHOD_IDS["GET"], b"/api/users"),
                     (C.HTTP_METHOD_IDS["POST"], b"/api"),
                     (C.HTTP_METHOD_IDS["POST"], b"/public/x"),
                     (C.HTTP_METHOD_IDS["GET"], b"/admin"),
                     (C.HTTP_METHOD_IDS["GET"], b"/ap"),
                     (C.HTTP_METHOD_IDS["GET"], b"")]
            got = []
            for method, path in cases:
                g = m.l7.l7_match_host(t, sid, method, path)
                assert g == m.oracle.l7_match(rules, method, path), \
                    (m.side, method, path)
                got.append(bool(g))
            return (sid, got, t.n_sets, arr(t.methods), arr(t.path),
                    arr(t.path_len), arr(t.valid))
        both(case)


def _random_mapstate(m, rng, identities):
    """``test_compile._random_mapstate`` over ``m``'s modules."""
    C, ms_mod = m.C, m.mapstate
    ms = ms_mod.MapState()
    for _ in range(rng.randrange(1, 40)):
        ident = rng.choice([C.IDENTITY_ANY] + identities)
        kind = rng.random()
        if kind < 0.2:
            key = ms_mod.MapStateKey(ident, C.PROTO_ANY, 0, 65535)
        else:
            proto = rng.choice([C.PROTO_TCP, C.PROTO_UDP, C.PROTO_ICMP])
            if proto == C.PROTO_ICMP:
                t = rng.randrange(0, 40)
                key = ms_mod.MapStateKey(ident, proto, t, t)
            elif kind < 0.5:
                key = ms_mod.MapStateKey(ident, proto, 0, 65535)
            else:
                lo = rng.randrange(1, 65000)
                hi = min(65535, lo + rng.choice([0, 0, 0, 10, 1000]))
                key = ms_mod.MapStateKey(ident, proto, lo, hi)
        deny = rng.random() < 0.25
        l7 = None
        if not deny and rng.random() < 0.15:
            l7 = frozenset({m.rules.HTTPRule(
                method="GET", path=f"/p{rng.randrange(5)}")})
        ms.add(key, ms_mod.MapStateEntry(deny=deny, l7_rules=l7))
    return ms


class TestDenseLadderEquivalence:
    """The compiler's property on both packages: dense verdict cell =
    sparse ladder, for every (identity, proto, port) probe; the planes and
    the decisions held equal between the packages."""

    @pytest.mark.parametrize("seed", range(6))
    def test_random_equivalence(self, seed):
        def case(m):
            C = m.C
            rng = random.Random(seed)
            identities = [100, 200, 300, 0x1000000, 0x1000001]
            ms = _random_mapstate(m, rng, identities)
            all_ids = identities + [C.IDENTITY_WORLD]
            ic = m.idclass.build_identity_classes(
                all_ids, [(0, C.DIR_EGRESS, ms)])
            ranges = {}
            for key, _ in ms.items():
                if key.proto == C.PROTO_ANY:
                    continue
                ranges.setdefault(C.proto_family(key.proto), []).append(
                    (key.port_lo, key.port_hi))
            pc = m.portclass.build_port_classes(ranges)
            l7 = m.l7.L7SetInterner()
            plane = m.policy_image._build_plane(ms, ic, pc, l7, ic.n_classes,
                                                pc.n_classes)
            probe_ports = set()
            for key, _ in ms.items():
                for p in (key.port_lo - 1, key.port_lo, key.port_hi,
                          key.port_hi + 1):
                    if 0 <= p <= 65535:
                        probe_ports.add(p)
            probe_ports |= {0, 1, 80, 443, 65535}
            decisions = []
            for ident in all_ids:
                row = ic.class_of[ic.index_of[ident]]
                for proto in (C.PROTO_TCP, C.PROTO_UDP, C.PROTO_ICMP,
                              C.PROTO_SCTP, 47):
                    fam = C.proto_family(proto)
                    for port in sorted(probe_ports):
                        col = pc.table[fam, port]
                        got = int(plane[row, col]) & C.VERDICT_DECISION_MASK
                        want = ms.lookup(ident, proto, port).decision
                        assert got == want, (
                            f"{m.side} seed={seed} id={ident} "
                            f"proto={proto} port={port}: dense={got} "
                            f"ladder={want}")
                        decisions.append(got)
            return decisions, arr(plane), id_classes_obs(ic), ports_obs(pc)
        both(case)


class TestSnapshot:
    def test_end_to_end_build(self):
        def case(m):
            C = m.C
            alloc = m.identity.IdentityAllocator()
            ipc = m.ipcache.IPCache()
            ctx = m.policy.PolicyContext(
                allocator=alloc,
                selector_cache=m.selectorcache.SelectorCache(alloc),
                ipcache=ipc)
            repo = m.policy.Repository(ctx)
            lbls = m.labels.Labels.parse(["k8s:app=web"])
            ident = alloc.allocate(lbls)
            ep = m.endpoint.Endpoint(ep_id=7, labels=lbls,
                                     identity_id=ident.id)
            ipc.upsert("192.168.1.10/32", ident.id)
            repo.add([m.rules.parse_rule({
                "endpointSelector": {"matchLabels": {"app": "web"}},
                "egress": [{"toCIDR": ["10.0.0.0/8"],
                            "toPorts": [{"ports": [{"port": "443",
                                                    "protocol": "TCP"}]}]}],
                "ingress": [{"toPorts": [{
                    "ports": [{"port": "80", "protocol": "TCP"}],
                    "rules": {"http": [{"method": "GET",
                                        "path": "/api"}]}}]}],
            })])
            snap = m.snapshot.build_snapshot(repo, ctx, [ep])
            assert snap.ep_slot_of[7] == 0
            assert snap.l7.n_sets == 1
            t = snap.tensors()
            assert t["verdict"].shape[0] == 1 and t["verdict"].shape[1] == 2
            cidr_id = ipc.lookup("10.5.5.5")
            row = snap.id_classes.class_of[
                snap.id_classes.index_of[cidr_id]]
            col = snap.port_classes.table[C.PROTO_FAMILY_TCP, 443]
            cell = int(t["verdict"][0, C.DIR_EGRESS, row, col])
            assert cell & C.VERDICT_DECISION_MASK == C.VERDICT_ALLOW
            row_w = snap.id_classes.class_of[
                snap.id_classes.index_of[C.IDENTITY_WORLD]]
            col80 = snap.port_classes.table[C.PROTO_FAMILY_TCP, 80]
            cell80 = int(t["verdict"][0, C.DIR_INGRESS, row_w, col80])
            assert cell80 & C.VERDICT_DECISION_MASK == C.VERDICT_REDIRECT
            assert cell80 >> C.VERDICT_L7_SHIFT == 1
            return (dict(snap.ep_slot_of), cidr_id, cell, cell80,
                    [(k, arr(v)) for k, v in t.items()],
                    snap.static_config(), snap.world_index)
        both(case)
