"""The port's policy repository against the JAX package's, case for case
with ``tests/test_policy.py``: resolve basics, deny precedence, CIDR
identities and the ipcache, entities, enforcement modes, the L7 merge,
ToServices and the selector cache.

Each case runs the reference's body once on each package's modules (the
reference's ``ctx`` fixture built per side: an ``IdentityAllocator``, its
``SelectorCache`` and an ``IPCache``), asserts the reference's
expectations on both, and holds a side-neutral observation equal:

- every resolved policy's enforced flags, its ``MapState`` entries as
  sorted tuples (key; deny, L7 rules, provenance), and the lookup of
  every allocated identity (plus world, host and the reference's literal
  identities) over TCP and UDP on every port the reference probes;
- the allocator's exported state (every identity, its labels and
  references, the next numbers), the ipcache's entries and the selector
  cache's size.
"""

import dataclasses
import importlib
from types import SimpleNamespace

import pytest

SIDES = ("jax", "torch")
PKG = {"jax": "cilium_tpu", "torch": "cilium_tpu_torch"}
MODS = {"endpoint": "model.endpoint", "identity": "model.identity",
        "ipcache": "model.ipcache", "labels": "model.labels",
        "rules": "model.rules", "services": "model.services",
        "selectors": "model.selectors", "policy": "policy",
        "mapstate": "policy.mapstate", "selectorcache": "policy.selectorcache",
        "C": "utils.constants"}

#: the literal remote identities and the ports ``test_policy.py`` probes
PROBE_IDS = (0xdead, 0xbeef, 0xabc, 12345)
PROBE_PORTS = (1, 22, 53, 80, 81, 443, 5432, 8079, 8080, 8085, 8090, 8091)


def P(side):
    """``side``'s modules by short name."""
    return SimpleNamespace(side=side, **{
        k: importlib.import_module(f"{PKG[side]}.{v}")
        for k, v in MODS.items()})


def make_ctx(m):
    """The reference's ``ctx`` fixture over ``m``'s modules."""
    alloc = m.identity.IdentityAllocator()
    return m.policy.PolicyContext(
        allocator=alloc,
        selector_cache=m.selectorcache.SelectorCache(alloc),
        ipcache=m.ipcache.IPCache())


def both(case):
    """Run ``case(m, ctx)`` on each package with a fresh context. → the
    port's observation, held equal to the reference's."""
    obs = {}
    for s in SIDES:
        m = P(s)
        obs[s] = case(m, make_ctx(m))
    assert obs["jax"] == obs["torch"]
    return obs["torch"]


def make_ep(m, ctx, labels, ep_id=1):
    lbls = m.labels.Labels.parse(labels)
    ident = ctx.allocator.allocate(lbls)
    return m.endpoint.Endpoint(ep_id=ep_id, labels=lbls,
                               identity_id=ident.id)


def rule(m, doc):
    return m.rules.parse_rule(doc)


def web(**sections):
    """A rule document selecting ``app=web`` with ``sections``."""
    return {"endpointSelector": {"matchLabels": {"app": "web"}}, **sections}


# --------------------------------------------------------------------------- #
# side-neutral observations
# --------------------------------------------------------------------------- #
def key_obs(k):
    return (k.identity, k.proto, k.port_lo, k.port_hi)


def entry_obs(e):
    l7 = None if e.l7_rules is None else sorted(
        dataclasses.astuple(h) for h in e.l7_rules)
    return (e.deny, l7, tuple(e.derived_from))


def lookup_obs(res):
    return (res.decision, None if res.key is None else key_obs(res.key),
            None if res.entry is None else entry_obs(res.entry))


def mapstate_obs(ms):
    return sorted((key_obs(k), entry_obs(e)) for k, e in ms.items())


def ctx_obs(ctx):
    """The allocator's state, the ipcache's entries, the selector count."""
    return (ctx.allocator.export_state(), sorted(ctx.ipcache.snapshot()
                                                 .items()),
            len(ctx.selector_cache))


def observe(m, ctx, *pols):
    """Each policy's enforced flags, entries and lookup grid, and the
    context's state."""
    C = m.C
    ids = sorted({i.id for i in ctx.allocator.all()}
                 | {C.IDENTITY_WORLD, C.IDENTITY_HOST, *PROBE_IDS})
    seen = []
    for pol in pols:
        dirs = []
        for d in (pol.egress, pol.ingress):
            dirs.append((d.enforced, mapstate_obs(d.mapstate), [
                lookup_obs(d.lookup(i, proto, port)) for i in ids
                for proto in (C.PROTO_TCP, C.PROTO_UDP)
                for port in PROBE_PORTS]))
        seen.append((pol.ep_id, pol.identity_id, pol.revision, dirs))
    return seen, ctx_obs(ctx)


class TestResolveBasics:
    def test_no_rules_not_enforced(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            pol = repo.resolve(ep)
            assert not pol.ingress.enforced and not pol.egress.enforced
            assert pol.ingress.lookup(12345, C.PROTO_TCP, 80).decision \
                == C.VERDICT_MISS
            return observe(m, ctx, pol)
        both(case)

    def test_l3_allow_entry(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            peer = ctx.allocator.allocate(m.labels.Labels.parse(
                ["k8s:role=fe"]))
            repo.add([rule(m, web(ingress=[{"fromEndpoints": [
                {"matchLabels": {"role": "fe"}}]}]))])
            pol = repo.resolve(ep)
            assert pol.ingress.enforced and not pol.egress.enforced
            assert m.mapstate.MapStateKey(
                peer.id, C.PROTO_ANY, *m.mapstate.PORT_WILDCARD) \
                in pol.ingress.mapstate
            assert pol.ingress.lookup(peer.id, C.PROTO_UDP, 53).decision \
                == C.VERDICT_ALLOW
            assert pol.ingress.lookup(C.IDENTITY_WORLD, C.PROTO_TCP,
                                      80).decision == C.VERDICT_MISS
            return observe(m, ctx, pol)
        both(case)

    def test_l4_port_scoping(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            peer = ctx.allocator.allocate(m.labels.Labels.parse(
                ["k8s:role=fe"]))
            repo.add([rule(m, web(ingress=[{
                "fromEndpoints": [{"matchLabels": {"role": "fe"}}],
                "toPorts": [{"ports": [{"port": "80",
                                        "protocol": "TCP"}]}]}]))])
            pol = repo.resolve(ep)
            lk = pol.ingress.lookup
            assert lk(peer.id, C.PROTO_TCP, 80).decision == C.VERDICT_ALLOW
            assert lk(peer.id, C.PROTO_TCP, 81).decision == C.VERDICT_MISS
            assert lk(peer.id, C.PROTO_UDP, 80).decision == C.VERDICT_MISS
            return observe(m, ctx, pol)
        both(case)

    def test_wildcard_peer_ports_only(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            repo.add([rule(m, web(ingress=[{"toPorts": [{"ports": [
                {"port": "443", "protocol": "TCP"}]}]}]))])
            pol = repo.resolve(ep)
            lk = pol.ingress.lookup
            assert lk(C.IDENTITY_WORLD, C.PROTO_TCP, 443).decision \
                == C.VERDICT_ALLOW
            assert lk(C.IDENTITY_WORLD, C.PROTO_TCP, 80).decision \
                == C.VERDICT_MISS
            return observe(m, ctx, pol)
        both(case)

    def test_port_range(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            repo.add([rule(m, web(ingress=[{"toPorts": [{"ports": [
                {"port": "8080", "endPort": 8090, "protocol": "TCP"}]}]}]))])
            pol = repo.resolve(ep)
            for port, want in [(8079, C.VERDICT_MISS),
                               (8080, C.VERDICT_ALLOW),
                               (8085, C.VERDICT_ALLOW),
                               (8090, C.VERDICT_ALLOW),
                               (8091, C.VERDICT_MISS)]:
                assert pol.ingress.lookup(0xdead, C.PROTO_TCP,
                                          port).decision == want
            return observe(m, ctx, pol)
        both(case)


class TestDenyPrecedence:
    def test_deny_beats_more_specific_allow(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            peer = ctx.allocator.allocate(m.labels.Labels.parse(
                ["k8s:role=fe"]))
            repo.add([rule(m, web(
                ingress=[{
                    "fromEndpoints": [{"matchLabels": {"role": "fe"}}],
                    "toPorts": [{"ports": [{"port": "80",
                                            "protocol": "TCP"}]}]}],
                ingressDeny=[{"fromEndpoints": [
                    {"matchLabels": {"role": "fe"}}]}]))])
            pol = repo.resolve(ep)
            res = pol.ingress.lookup(peer.id, C.PROTO_TCP, 80)
            assert res.decision == C.VERDICT_DENY
            return lookup_obs(res), observe(m, ctx, pol)
        both(case)

    def test_deny_scoped_to_port(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            peer = ctx.allocator.allocate(m.labels.Labels.parse(
                ["k8s:role=fe"]))
            repo.add([rule(m, web(
                ingress=[{"fromEndpoints": [
                    {"matchLabels": {"role": "fe"}}]}],
                ingressDeny=[{
                    "fromEndpoints": [{"matchLabels": {"role": "fe"}}],
                    "toPorts": [{"ports": [{"port": "22",
                                            "protocol": "TCP"}]}]}]))])
            pol = repo.resolve(ep)
            lk = pol.ingress.lookup
            assert lk(peer.id, C.PROTO_TCP, 22).decision == C.VERDICT_DENY
            assert lk(peer.id, C.PROTO_TCP, 80).decision == C.VERDICT_ALLOW
            return observe(m, ctx, pol)
        both(case)


class TestCIDR:
    def test_cidr_allocates_identity_and_ipcache(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            repo.add([rule(m, web(egress=[{"toCIDR": ["10.0.0.0/8"]}]))])
            pol = repo.resolve(ep)
            cidr_id = ctx.ipcache.lookup("10.1.2.3")
            assert cidr_id & C.LOCAL_IDENTITY_SCOPE
            assert pol.egress.lookup(cidr_id, C.PROTO_TCP, 443).decision \
                == C.VERDICT_ALLOW
            assert pol.egress.lookup(C.IDENTITY_WORLD, C.PROTO_TCP,
                                     443).decision == C.VERDICT_MISS
            return cidr_id, observe(m, ctx, pol)
        both(case)

    def test_cidrset_except_excluded(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            repo.add([rule(m, web(egress=[{"toCIDRSet": [
                {"cidr": "10.0.0.0/8", "except": ["10.96.0.0/12"]}]}]))])
            pol = repo.resolve(ep)
            in_id = ctx.ipcache.lookup("10.1.2.3")
            ex_id = ctx.ipcache.lookup("10.96.0.1")
            assert in_id != ex_id
            assert pol.egress.lookup(in_id, C.PROTO_TCP, 1).decision \
                == C.VERDICT_ALLOW
            assert pol.egress.lookup(ex_id, C.PROTO_TCP, 1).decision \
                == C.VERDICT_MISS
            return in_id, ex_id, observe(m, ctx, pol)
        both(case)

    @pytest.mark.parametrize("wide_first", [True, False])
    def test_narrower_cidr_identity_matches_wider_rule(self, wide_first):
        """The /16 identity one rule allocates is allowed by the other
        rule's /8 selector, in both rule orders, on the first resolve."""
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            wide = rule(m, web(egress=[{"toCIDR": ["10.0.0.0/8"]}]))
            narrow = rule(m, web(egress=[{"toCIDR": ["10.1.0.0/16"]}]))
            repo.add([wide, narrow] if wide_first else [narrow, wide])
            pol = repo.resolve(ep)
            narrow_id = ctx.ipcache.lookup("10.1.2.3")
            assert narrow_id == ctx.allocator.allocate_cidr(
                "10.1.0.0/16").id
            assert pol.egress.lookup(narrow_id, C.PROTO_TCP, 80).decision \
                == C.VERDICT_ALLOW
            return narrow_id, observe(m, ctx, pol)
        both(case)

    def test_rule_delete_releases_identity_and_ipcache(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            r = rule(m, web(egress=[{"toCIDR": ["10.0.0.0/8"]}],
                            labels=["k8s:policy=p"]))
            repo.add([r])
            cidr_id = ctx.ipcache.lookup("10.1.2.3")
            assert cidr_id & C.LOCAL_IDENTITY_SCOPE
            n_sel = len(ctx.selector_cache)
            before = ctx_obs(ctx)
            repo.delete_by_labels(m.labels.Labels.parse(["k8s:policy=p"]))
            assert ctx.ipcache.lookup("10.1.2.3") == C.IDENTITY_WORLD
            assert ctx.allocator.get(cidr_id) is None
            assert len(ctx.selector_cache) < n_sel
            return cidr_id, n_sel, before, ctx_obs(ctx), repo.revision
        both(case)

    def test_shared_cidr_survives_one_rule_delete(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            repo.add([rule(m, web(egress=[{"toCIDR": ["10.0.0.0/8"]}],
                                  labels=[f"k8s:policy={tag}"]))
                      for tag in ("a", "b")])
            repo.delete_by_labels(m.labels.Labels.parse(["k8s:policy=a"]))
            assert ctx.ipcache.lookup("10.1.2.3") & C.LOCAL_IDENTITY_SCOPE
            return ctx_obs(ctx), repo.revision, len(repo)
        both(case)


class TestEntities:
    def test_world_entity(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            repo.add([rule(m, web(egress=[{"toEntities": ["world"]}]))])
            pol = repo.resolve(ep)
            assert pol.egress.lookup(C.IDENTITY_WORLD, C.PROTO_TCP,
                                     443).decision == C.VERDICT_ALLOW
            peer = ctx.allocator.allocate(m.labels.Labels.parse(["k8s:x=y"]))
            assert pol.egress.lookup(peer.id, C.PROTO_TCP, 443).decision \
                == C.VERDICT_MISS
            return observe(m, ctx, pol)
        both(case)

    def test_cluster_entity_matches_pods_not_world(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            pod = ctx.allocator.allocate(m.labels.Labels.parse(
                ["k8s:app=db"]))
            repo.add([rule(m, web(egress=[{"toEntities": ["cluster"]}]))])
            pol = repo.resolve(ep)
            lk = pol.egress.lookup
            assert lk(pod.id, C.PROTO_TCP, 5432).decision == C.VERDICT_ALLOW
            assert lk(C.IDENTITY_HOST, C.PROTO_TCP, 22).decision \
                == C.VERDICT_ALLOW
            assert lk(C.IDENTITY_WORLD, C.PROTO_TCP, 443).decision \
                == C.VERDICT_MISS
            return observe(m, ctx, pol)
        both(case)

    def test_all_entity_is_wildcard(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            repo.add([rule(m, web(ingress=[{"fromEntities": ["all"]}]))])
            pol = repo.resolve(ep)
            assert pol.ingress.lookup(0xbeef, C.PROTO_TCP, 1).decision \
                == C.VERDICT_ALLOW
            return observe(m, ctx, pol)
        both(case)


class TestEnforcementModes:
    def test_always_mode(self):
        def case(m, ctx):
            ctx.enforcement_mode = m.C.ENFORCEMENT_ALWAYS
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            pol = repo.resolve(ep)
            assert pol.ingress.enforced and pol.egress.enforced
            return observe(m, ctx, pol)
        both(case)

    def test_never_mode(self):
        def case(m, ctx):
            ctx.enforcement_mode = m.C.ENFORCEMENT_NEVER
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            repo.add([rule(m, web(ingress=[]))])
            pol = repo.resolve(ep)
            assert not pol.ingress.enforced
            return observe(m, ctx, pol)
        both(case)

    def test_per_endpoint_override(self):
        def case(m, ctx):
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            ep.enforcement = m.C.ENFORCEMENT_ALWAYS
            pol = repo.resolve(ep)
            assert pol.ingress.enforced
            return observe(m, ctx, pol)
        both(case)

    def test_allow_localhost_entry(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            repo.add([rule(m, web(ingress=[]))])
            pol = repo.resolve(ep)
            assert pol.ingress.lookup(C.IDENTITY_HOST, C.PROTO_TCP,
                                      22).decision == C.VERDICT_ALLOW
            return observe(m, ctx, pol)
        both(case)


def http_port(port, http):
    return [{"toPorts": [{"ports": [{"port": port, "protocol": "TCP"}],
                          "rules": {"http": http}}]}]


class TestL7AndMerge:
    def test_l7_redirect(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            repo.add([rule(m, web(ingress=http_port(
                "80", [{"method": "GET", "path": "/api"}])))])
            pol = repo.resolve(ep)
            res = pol.ingress.lookup(C.IDENTITY_WORLD, C.PROTO_TCP, 80)
            assert res.decision == C.VERDICT_REDIRECT
            assert len(res.entry.l7_rules) == 1
            return lookup_obs(res), observe(m, ctx, pol)
        both(case)

    def test_plain_allow_shadows_l7_same_key(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            repo.add([
                rule(m, web(ingress=http_port("80", [{"path": "/x"}]))),
                rule(m, web(ingress=[{"toPorts": [{"ports": [
                    {"port": "80", "protocol": "TCP"}]}]}])),
            ])
            pol = repo.resolve(ep)
            assert pol.ingress.lookup(C.IDENTITY_WORLD, C.PROTO_TCP,
                                      80).decision == C.VERDICT_ALLOW
            return observe(m, ctx, pol)
        both(case)

    def test_l7_union_same_key(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            repo.add([
                rule(m, web(ingress=http_port("80", [{"path": "/a"}]))),
                rule(m, web(ingress=http_port("80", [{"path": "/b"}]))),
            ])
            pol = repo.resolve(ep)
            res = pol.ingress.lookup(C.IDENTITY_WORLD, C.PROTO_TCP, 80)
            assert res.decision == C.VERDICT_REDIRECT
            assert {h.path for h in res.entry.l7_rules} == {"/a", "/b"}
            return lookup_obs(res), observe(m, ctx, pol)
        both(case)


def to_service(name):
    return [{"toServices": [{"k8sService": {"serviceName": name,
                                            "namespace": "prod"}}]}]


class TestToServices:
    def test_v6_backend_normalized(self):
        """A non-canonical backend IP (uppercase v6) still gives a
        selector matching the normalized CIDR identity label."""
        def case(m, ctx):
            C = m.C
            ctx.services.upsert(m.services.Service(
                name="db6", namespace="prod", backends=("2001:DB8::1",)))
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            repo.add([rule(m, web(egress=to_service("db6")))])
            pol = repo.resolve(ep)
            backend_id = ctx.ipcache.lookup("2001:db8::1")
            assert backend_id & C.LOCAL_IDENTITY_SCOPE
            assert pol.egress.lookup(backend_id, C.PROTO_TCP, 5432) \
                .decision == C.VERDICT_ALLOW
            return backend_id, observe(m, ctx, pol)
        both(case)

    def test_service_change_rematerializes(self):
        """A backend set change re-materializes and bumps the revision."""
        def case(m, ctx):
            C = m.C
            ctx.services.upsert(m.services.Service(
                name="db", namespace="prod", backends=("10.10.0.5",)))
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            repo.add([rule(m, web(egress=to_service("db")))])
            rev0 = repo.revision
            ctx.services.upsert(m.services.Service(
                name="db", namespace="prod", backends=("10.10.0.7",)))
            assert repo.revision > rev0
            pol = repo.resolve(ep)
            new_id = ctx.ipcache.lookup("10.10.0.7")
            assert pol.egress.lookup(new_id, C.PROTO_TCP, 5432).decision \
                == C.VERDICT_ALLOW
            assert ctx.ipcache.lookup("10.10.0.5") == C.IDENTITY_WORLD
            return rev0, new_id, observe(m, ctx, pol)
        both(case)

    def test_backends_resolved(self):
        def case(m, ctx):
            C = m.C
            ctx.services.upsert(m.services.Service(
                name="db", namespace="prod",
                backends=("10.10.0.5", "10.10.0.6")))
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            repo.add([rule(m, web(egress=to_service("db")))])
            pol = repo.resolve(ep)
            backend_id = ctx.ipcache.lookup("10.10.0.5")
            assert pol.egress.lookup(backend_id, C.PROTO_TCP, 5432) \
                .decision == C.VERDICT_ALLOW
            assert pol.egress.lookup(C.IDENTITY_WORLD, C.PROTO_TCP, 5432) \
                .decision == C.VERDICT_MISS
            return backend_id, observe(m, ctx, pol)
        both(case)


class TestIncremental:
    def test_new_identity_visible_after_reresolve(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])
            repo.add([rule(m, web(ingress=[{"fromEndpoints": [
                {"matchLabels": {"role": "fe"}}]}]))])
            pol = repo.resolve(ep)
            late = ctx.allocator.allocate(m.labels.Labels.parse(
                ["k8s:role=fe", "k8s:v=2"]))
            assert pol.ingress.lookup(late.id, C.PROTO_TCP, 80).decision \
                == C.VERDICT_MISS
            pol2 = repo.resolve(ep)
            assert pol2.ingress.lookup(late.id, C.PROTO_TCP, 80).decision \
                == C.VERDICT_ALLOW
            return late.id, observe(m, ctx, pol, pol2)
        both(case)

    def test_selector_cache_incremental_notify(self):
        def case(m, ctx):
            sel = ctx.selector_cache.add_selector(
                m.selectors.EndpointSelector.from_labels({"role": "fe"}))
            events = []
            sel.subscribe(lambda a, r: events.append((set(a), set(r))))
            fe = ctx.allocator.allocate(m.labels.Labels.parse(
                ["k8s:role=fe"]))
            assert fe.id in sel.identities
            assert events and events[0][0] == {fe.id}
            return ([(sorted(a), sorted(r)) for a, r in events],
                    sorted(sel.identities), ctx_obs(ctx))
        both(case)

    def test_replace_by_labels(self):
        def case(m, ctx):
            C = m.C
            repo = m.policy.Repository(ctx)
            ep = make_ep(m, ctx, ["k8s:app=web"])

            def on(port):
                return rule(m, web(
                    ingress=[{"toPorts": [{"ports": [
                        {"port": port, "protocol": "TCP"}]}]}],
                    labels=["k8s:policy=p1"]))
            repo.add([on("80")])
            rev0 = repo.revision
            repo.replace_by_labels(
                m.labels.Labels.parse(["k8s:policy=p1"]), [on("443")])
            assert repo.revision > rev0
            pol = repo.resolve(ep)
            assert pol.ingress.lookup(0xabc, C.PROTO_TCP, 80).decision \
                == C.VERDICT_MISS
            assert pol.ingress.lookup(0xabc, C.PROTO_TCP, 443).decision \
                == C.VERDICT_ALLOW
            return rev0, observe(m, ctx, pol)
        both(case)
