"""``mixed.serve`` (cfg2 + cfg4: dual-stack, L7-lite HTTP rules) at its test
sizes on the CPU: the run is ``correct`` with no mismatch, the control put
in the program's place fails it, and its checked rows hold v6 rows, L7
allows and POLICY_L7 drops; its mix is deterministic in the seed and reads
every key it holds; ``configs/mixed.py`` declares at ``test_sizes`` what
the test-only ``v6_l7`` world declares; and the cell's three new readers
on hand-made readings, with and without what they read."""

import types

import pytest

from benchmark.harness import cell as cells
from benchmark.harness import check, runner
from benchmark.harness.kernel_bytes import HBM_BYTES_PER_S
from benchmark.reference import constants as C
from benchmark.reference.policy import Policy
from benchmark.tests import v6_l7
from benchmark.tests.helpers import SEED, cpu_run
from benchmark.tests.test_bench_traffic import _same

NAME = "mixed.serve"
COUNTS = ("rows_mismatched", "ct_slots_mismatched", "counters_mismatched")


def test_mixed_is_correct_and_the_control_fails(monkeypatch):
    seen = []

    def compare(policy, batch, now, before, after, counters, out):
        seen.append((batch, out))
        return check.compare(policy, batch, now, before, after, counters,
                             out)
    monkeypatch.setattr(runner, "check", types.SimpleNamespace(
        compare=compare, control_counts=check.control_counts))
    res, notes = cpu_run(NAME, control=True)
    checks = res["checks"]
    assert notes["errors"] == []
    assert checks["dispatches_checked"]["value"] >= 3
    for k in COUNTS:
        assert checks[k]["value"] == 0, (k, checks[k])
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    assert checks["control_rows"]["value"] > 0
    assert checks["control_ct_slots"]["value"] > 0
    window = seen[1:]
    v6 = sum(int(b["is_v6"].sum()) for b, _o in window)
    l7_allowed = sum(int((o["redirect"] & o["allow"]).sum())
                     for _b, o in window)
    l7_dropped = sum(int((o["reason"] == C.POLICY_L7).sum())
                     for _b, o in window)
    assert min(v6, l7_allowed, l7_dropped) > 0, (v6, l7_allowed, l7_dropped)


def test_the_declaration_is_v6_l7s():
    c = cells.load(NAME)
    sizes = c.config["test_sizes"]
    assert sizes == v6_l7.SIZES
    assert c.declare.declare(sizes) == v6_l7.declare(sizes)
    for k in ("node_ipcache", "daemon"):
        assert c.config[k] == v6_l7.CONFIG[k], k
    assert {k: v for k, v in c.traffic.items()
            if k not in ("flows", "checked_from")} \
        == {k: v for k, v in v6_l7.MIX.items()
            if k not in ("flows", "checked_from")}


def _traffic(seed):
    c = cells.load(NAME)
    sizes = c.config["test_sizes"]
    decl = c.declare.declare(sizes)
    decl["node_ipcache"] = c.config["node_ipcache"]
    return c.generator.make(c.traffic, decl, Policy(decl), sizes["batch"],
                            seed, c.traffic["test_flows"])


def test_the_mix_is_deterministic_and_reads_every_key():
    c = cells.load(NAME)
    cells.check_mix(c.traffic_name, c.traffic, c.generator)
    t1, t2, t3 = _traffic(SEED), _traffic(SEED), _traffic(SEED + 1)
    got = [(t1.batch_at(i), t2.batch_at(i), t3.batch_at(i))
           for i in range(4)]
    assert all(_same(a, b) for a, b, _c in got)
    assert not all(_same(a, c) for a, _b, c in got)


def _reader(name):
    return cells._module("metrics", name)


def _trace():
    """A traced part in which K3 ran twice for 2 ms and K1 four times for
    1 ms each, under their launch names."""
    return {"kernel_s": {"policy_verdict_kernel(int*)": 0.004,
                         "void lpm_lookup_kernel<4>(int*)": 0.004,
                         "ct_probe_pair_kernel": 0.001},
            "launches": {"policy_verdict_kernel(int*)": 2,
                         "void lpm_lookup_kernel<4>(int*)": 4,
                         "ct_probe_pair_kernel": 1}}


KBYTES = [{"lpm_lookup_kernel": 3e6, "ct_probe_pair_kernel": 1e6,
           "policy_verdict_kernel": 2e6},
          {"lpm_lookup_kernel": 5e6, "ct_probe_pair_kernel": 1e6,
           "policy_verdict_kernel": 4e6}]


@pytest.mark.parametrize("name,launches,mean_bytes", [
    ("verdict_roofline", 2, 3e6), ("lpm_roofline", 4, 4e6)])
def test_a_kernel_roofline_reads_its_kernel_alone(name, launches,
                                                  mean_bytes):
    read = _reader(name).read
    rec = {"trace": _trace(), "kernel_bytes": KBYTES}
    want = 100.0 * launches * mean_bytes / HBM_BYTES_PER_S / 0.004
    assert read(rec) == pytest.approx(want)
    assert read({"trace": None, "kernel_bytes": KBYTES}) is None
    assert read({"trace": _trace(), "kernel_bytes": []}) is None
    untraced = _trace()
    untraced["kernel_s"] = {"ct_probe_pair_kernel": 0.001}
    assert read({"trace": untraced, "kernel_bytes": KBYTES}) is None


def test_l7_dict_bytes_reads_its_group_or_nothing():
    read = _reader("l7_dict_bytes").read
    assert read({"placed_bytes": {"ct": 10, "l7_dict": 4096}}) == 4096
    assert read({"placed_bytes": {"ct": 10, "verdict": 5}}) is None
