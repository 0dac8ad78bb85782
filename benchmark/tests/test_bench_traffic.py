"""The traffic: every mix's generator is deterministic in the seed, a mix
key that nothing reads is refused, the churn's stream closes only open
tuples and opens only closed ones and comes back to its start after one
period, and every mix keeps the number of live flows constant: on the
port's CPU path, the live CT entries after each batch stay at most the
warm-up's plus what the mix allows (the closing flows of the last
``CT_LIFETIME_CLOSE`` seconds and the tuples two flows share), and once
the first closing entries have expired they move by less than one batch's
closing rows. The mixes of ``BENCHMARK.json`` and the test-only v6 + L7
world's, whose ``v6`` and ``l7`` shares are as the mix asks."""

from collections import Counter

import numpy as np
import pytest

from benchmark.generators import flow_churn
from benchmark.harness import cell as cells
from benchmark.harness import serve
from benchmark.reference.constants import CT_LIFETIME_CLOSE
from benchmark.reference.policy import Policy
from benchmark.tests import v6_l7
from benchmark.tests.helpers import CELLS, SEED, load

MIXES = CELLS + (v6_l7.NAME,)

NOW0 = 1_000_000


def _traffic(name, seed):
    c = load(name)
    sizes = c.config["test_sizes"]
    decl = c.declare.declare(sizes)
    decl["node_ipcache"] = c.config["node_ipcache"]
    traffic = c.generator.make(c.traffic, decl, Policy(decl),
                               sizes["batch"], seed, c.traffic["test_flows"])
    return c, decl, sizes, traffic


def _same(a, b):
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name", MIXES)
def test_generator_is_deterministic_in_the_seed(name):
    _c, _d, _s, t1 = _traffic(name, SEED)
    _c, _d, _s, t2 = _traffic(name, SEED)
    _c, _d, _s, t3 = _traffic(name, SEED + 1)
    assert all(_same(a, b) for a, b in zip(t1.warm_batches(),
                                           t2.warm_batches()))
    got = [(t1.batch_at(i), t2.batch_at(i), t3.batch_at(i))
           for i in range(4)]
    assert all(_same(a, b) for a, b, _c in got)
    assert not all(_same(a, c) for a, _b, c in got)


@pytest.mark.parametrize("name", CELLS)
def test_a_mix_key_that_nothing_reads_is_refused(name):
    c = cells.load(name)
    cells.check_mix(c.traffic_name, c.traffic, c.generator)
    with pytest.raises(ValueError, match="loop"):
        cells.check_mix(c.traffic_name, {**c.traffic, "loop": "open"},
                        c.generator)


def _tuples(b, flags):
    m = b["tcp_flags"] == flags
    return Counter(zip(map(tuple, b["src"][m].tolist()),
                       map(tuple, b["dst"][m].tolist()),
                       b["sport"][m].tolist(), b["dport"][m].tolist()))


@pytest.mark.parametrize("name", MIXES)
def test_the_churn_closes_open_tuples_and_repeats(name):
    """Each flow's tuple counted once: a FIN row takes an open one, a SYN
    row opens one, an ACK row rides an open one, and after a period every
    flow is back on its first tuple."""
    _c, _d, _s, t = _traffic(name, SEED)
    assert t.period == 2 * (t.n_flows // t.n_new)
    every = np.arange(t.n_flows)
    open_ = _tuples(t.rows(every, flow_churn.TCP_ACK, t.sports[every, 0]),
                    flow_churn.TCP_ACK)
    start = Counter(open_)
    for i in range(t.period):
        b = t.batch_at(i)
        assert all(not v.flags.writeable for v in b.values())
        fin = _tuples(b, flow_churn.TCP_FIN | flow_churn.TCP_ACK)
        syn = _tuples(b, flow_churn.TCP_SYN)
        assert sum(fin.values()) == sum(syn.values()) == t.n_new
        assert not fin - open_
        assert not set(_tuples(b, flow_churn.TCP_ACK)) - set(open_)
        open_ = open_ - fin + syn
    assert open_ == start
    assert t.batch_at(t.period) is t.batch_at(0)


@pytest.mark.parametrize("name", MIXES)
def test_live_flows_stay_constant(name):
    c, decl, sizes, traffic = _traffic(name, SEED)
    eng, _regen = serve.build_engine(decl, c.config["daemon"], sizes, "cpu")
    try:
        now = NOW0
        for b in traffic.warm_batches():
            eng.submit(b, now=now).result(timeout=120)
            now += 1
        base = eng.datapath.ct_stats(now)["live"]
        live = []
        for i in range(3 * CT_LIFETIME_CLOSE):
            if i % 2 == 0:
                eng.sweep_step(now)
            traffic.submit(eng, i, now).result(timeout=120)
            live.append(eng.datapath.ct_stats(now)["live"])
            now += 1
    finally:
        eng.stop()
    steady = live[CT_LIFETIME_CLOSE + 1:]
    assert max(live) <= base + traffic.live_allowance(CT_LIFETIME_CLOSE)
    # the closing flows of one batch are those of its replaced flows that
    # the policy allowed: the count moves by less than one batch's
    assert max(steady) - min(steady) <= traffic.n_fin, steady


def test_the_v6_and_l7_shares_are_the_mixs():
    """A fixed count of v6 flows, each addressing its peer's /128 and the
    endpoint's v6 address; requests only on the ACK rows of L7 flows, about
    the mix's share of them matching their set; the SYN, FIN and warm-up
    rows carry none."""
    c, _d, _s, t = _traffic(v6_l7.NAME, SEED)
    assert t.is_v6.sum() == round(t.n_flows * c.traffic["v6"])
    assert (t.l7_set > 0).any() and (t.l7_set == 0).any()
    policy = Policy(_d)
    match = carried = 0
    for i in range(8):
        b = t.batch_at(i)
        v6 = b["is_v6"]
        assert (b["dst"][v6] == t.local6).all()
        assert (b["src"][v6, 0] == 0x20010DB8).all()
        assert (b["dst"][~v6, 2] == 0xFFFF).all()
        req = (b["http_method"] != flow_churn.HTTP_METHOD_NONE) \
            | b["http_path"].any(1)
        ack = b["tcp_flags"] == flow_churn.TCP_ACK
        assert not (req & ~ack).any()
        ident = policy.lookup_rows(b["src"], v6)[0]
        _ok, sets = policy.verdict(1, 1, ident, b["proto"], b["dport"])
        assert (req == (ack & (sets > 0))).all()
        match += policy.l7_match(sets[req], b["http_method"][req],
                                 b["http_path"][req]).sum()
        carried += req.sum()
    assert abs(match / carried - c.traffic["l7"]) < 0.05, match / carried
    for b in t.warm_batches():
        assert (b["http_method"] == flow_churn.HTTP_METHOD_NONE).all()
        assert not b["http_path"].any()
