"""The reference against the port's plain CPU path, at test sizes: every
compared column, counter and CT slot equal on every checked dispatch; and
the control (the reference with the conntrack guarantee broken) put in
the program's place fails the same comparison. The test-only v6 + L7
world's checked rows hold v6 rows, L7 allows and POLICY_L7 drops. Then the
reference's v6 and L7 semantics on hand-made declarations."""

import ipaddress
import types

import numpy as np
import pytest

from benchmark.harness import check, runner
from benchmark.reference import constants as C
from benchmark.reference.policy import Policy
from benchmark.tests import v6_l7
from benchmark.tests.helpers import CELLS, cpu_run

COUNTS = ("rows_mismatched", "ct_slots_mismatched", "counters_mismatched")


@pytest.mark.parametrize("name", CELLS + (v6_l7.NAME,))
def test_reference_equals_the_plain_path_and_the_control_fails(
        name, monkeypatch):
    seen = []

    def compare(policy, batch, now, before, after, counters, out):
        seen.append((batch, out))
        return check.compare(policy, batch, now, before, after, counters,
                             out)
    monkeypatch.setattr(runner, "check", types.SimpleNamespace(
        compare=compare, control_counts=check.control_counts))
    res, notes = cpu_run(name, control=True)
    checks = res["checks"]
    assert notes["errors"] == []
    assert checks["dispatches_checked"]["value"] >= 3
    for k in COUNTS:
        assert checks[k]["value"] == 0, (k, checks[k])
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    assert checks["control_rows"]["value"] > 0
    assert checks["control_ct_slots"]["value"] > 0
    if name == v6_l7.NAME:
        window = seen[1:]
        v6 = sum(int(b["is_v6"].sum()) for b, _o in window)
        l7_allowed = sum(int((o["redirect"] & o["allow"]).sum())
                         for _b, o in window)
        l7_dropped = sum(int((o["reason"] == C.POLICY_L7).sum())
                         for _b, o in window)
        assert min(v6, l7_allowed, l7_dropped) > 0, (v6, l7_allowed,
                                                      l7_dropped)


def _decl(rules, identities=(), ips=("192.168.0.10",)):
    steps = [{"endpoint": {"ep_id": 1, "labels": ["k8s:app=web"],
                           "ips": list(ips)}}]
    steps += [{"identity": {"labels": labels, "prefix": prefix}}
              for labels, prefix in identities]
    steps.append({"rules": [{"endpointSelector": {"matchLabels":
                                                  {"app": "web"}},
                             "ingress": [block]} for block in rules]})
    return {"steps": steps}


def _words(ip):
    a = int(ipaddress.ip_address(ip))
    return [(a >> s) & 0xFFFFFFFF for s in (96, 64, 32, 0)]


def test_v6_rows_match_the_longest_v6_prefix():
    pol = Policy(_decl([], identities=[
        (["k8s:pod=a"], "2001:db8::/32"), (["k8s:pod=b"], "2001:db8:1::/48"),
        (["k8s:pod=b"], "10.0.0.0/8"), (["k8s:pod=c"], "2001:db8:1::5/128")]))
    rows = np.asarray([_words("2001:db8:1::5"), _words("2001:db8:1::6"),
                       _words("2001:db8:2::1"), _words("2002::1"),
                       [0, 0, 0xFFFF, 0x0A000001]], np.uint32)
    ident, which, plen = pol.lookup_rows(rows, [True] * 4 + [False])
    a, b, c = (pol.ids[frozenset([f"k8s:pod={x}"])] for x in "abc")
    assert ident.tolist() == [c, b, a, C.IDENTITY_WORLD, b]
    assert plen.tolist() == [128, 48, 32, -1, 104]
    assert which[0] != which[1] != which[2] and which[3] == -1
    # a pod's /32 and /128 under the same labels share one identity
    assert len(pol.ids) == 4


def test_an_l7_set_matches_method_and_path_prefix():
    http = [{"method": "GET", "path": "/api"}, {"path": "/pub"}]
    pol = Policy(_decl([{"toPorts": [{
        "ports": [{"port": "80", "protocol": "TCP"}],
        "rules": {"http": http}}]}]))
    allowed, sets = pol.verdict(1, C.DIR_INGRESS,
                                np.asarray([256, 999, 256]),
                                np.asarray([6, 6, 17]),
                                np.asarray([80, 80, 80]))
    # every identity, TCP 80 only
    assert allowed.tolist() == [True, True, False]
    assert sets[0] == sets[1] > 0 and sets[2] == 0
    get, post = C.HTTP_METHODS.index("GET"), C.HTTP_METHODS.index("POST")
    reqs = [(get, b"/api/x"), (post, b"/api/x"), (post, b"/pub"),
            (get, b"/ap"), (post, b"/public/1")]
    path = np.zeros((len(reqs), C.PATH_BYTES), np.uint8)
    for i, (_m, p) in enumerate(reqs):
        path[i, :len(p)] = np.frombuffer(p, np.uint8)
    got = pol.l7_match(np.full(len(reqs), sets[0]),
                       np.asarray([m for m, _p in reqs]), path)
    assert got.tolist() == [True, False, True, False, True]


def test_blocks_on_one_port_union_their_rules_and_overlaps_are_refused():
    def l7(path, peers=None):
        block = {"toPorts": [{"ports": [{"port": "80"}],
                              "rules": {"http": [{"path": path}]}}]}
        if peers:
            block["fromEndpoints"] = [{"matchLabels": {"pod": peers}}]
        return block
    ids = [(["k8s:pod=a"], "10.0.0.1/32")]
    pol = Policy(_decl([l7("/a"), l7("/b")], identities=ids))
    assert pol.l7_sets == [frozenset({(None, b"/a"), (None, b"/b")})]
    plain = {"fromEndpoints": [{"matchLabels": {"pod": "a"}}],
             "toPorts": [{"ports": [{"port": "80"}]}]}
    for rules in ([l7("/a"), plain], [l7("/a"), l7("/b", "a")],
                  [l7("/a", "a"), {"fromEndpoints": [{"matchLabels":
                                                      {"pod": "a"}}]}]):
        with pytest.raises(NotImplementedError, match="L7 port"):
            Policy(_decl(rules, identities=ids))
