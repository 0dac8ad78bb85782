"""The port's own account of the L7 wire and of v6 rows: the path
dictionary's pack as the span ``datapath.pack.l7_dict`` under
``datapath.pack``, with the batch's ``rows``, the unique ``paths`` and the
padded ``dict_rows``; the pack counters ``l7_rows``, ``v6_rows`` and
``l7_dict_paths``, exported by ``render_metrics`` as
``datapath_<key>_total``; and the device path dictionary's ledger group
``l7_dict``. A batch without requests packs no dictionary: no span, no
group.

Port only: the reference has none of these, so the cases hold the port to
what it states (no ``both``). Every case leaves the process-wide
``TRACER`` disarmed and empty, as ``tests/test_torch_trace_export.py``
does."""

import numpy as np
import pytest

from cilium_tpu_torch.kernels.records import batch_from_records
from cilium_tpu_torch.observe.trace import TRACER
from cilium_tpu_torch.oracle.datapath import PacketRecord
from cilium_tpu_torch.runtime.config import DaemonConfig
from cilium_tpu_torch.runtime.datapath import TorchDatapath
from cilium_tpu_torch.runtime.engine import Engine
from cilium_tpu_torch.utils import constants as C
from cilium_tpu_torch.utils.ip import parse_addr

SPAN = "datapath.pack.l7_dict"
COUNTERS = ("l7_rows", "v6_rows", "l7_dict_paths")
ROWS = 64

#: web takes HTTP on TCP 8080 from fe (GET /api, POST /upload), and TCP
#: 443 from anyone
POLICY = [{
    "endpointSelector": {"matchLabels": {"app": "web"}},
    "ingress": [
        {"fromEndpoints": [{"matchLabels": {"role": "fe"}}],
         "toPorts": [{"ports": [{"port": "8080", "protocol": "TCP"}],
                      "rules": {"http": [
                          {"method": "GET", "path": "/api"},
                          {"method": "POST", "path": "/upload"}]}}]},
        {"toPorts": [{"ports": [{"port": "443", "protocol": "TCP"}]}]}],
}]

#: requests of the L7 rows, in turn: two match the set, one does not
REQUESTS = ((C.HTTP_METHOD_IDS["GET"], b"/api/x"),
            (C.HTTP_METHOD_IDS["POST"], b"/upload/1"),
            (C.HTTP_METHOD_IDS["GET"], b"/admin"))

#: which rows of a kind's batch are v6, and which carry a request
KINDS = {"v6_l7": (3, 2), "l7": (0, 2), "v6": (3, 0), "v4": (0, 0)}


@pytest.fixture(autouse=True)
def _quiet_tracer():
    yield
    TRACER.configure(sample_rate=0.0)
    TRACER.reset()


def web_engine(**kw):
    """A CPU engine on the port's ``TorchDatapath``: web and fe, each with
    a v4 and a v6 address, under ``POLICY``."""
    cfg = DaemonConfig(device="cpu", ct_capacity=4096, auto_regen=False,
                       batch_size=ROWS, **kw)
    eng = Engine(cfg, datapath=TorchDatapath(cfg))
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.1.10", "fd00::10"),
                     ep_id=1)
    eng.add_endpoint(["k8s:role=fe"], ips=("192.168.1.30", "fd00::30"),
                     ep_id=3)
    eng.apply_policy(POLICY)
    eng.regenerate()
    return eng


def kind_batch(eng, kind, i):
    """``ROWS`` ingress rows from fe to web: every ``v6``-th row (0: none)
    on v6, every ``l7``-th (0: none) on 8080 with a request of
    ``REQUESTS`` in turn, the others on 443 without one."""
    v6_every, l7_every = KINDS[kind]
    recs = []
    for r in range(ROWS):
        v6 = bool(v6_every) and r % v6_every == 0
        l7 = bool(l7_every) and r % l7_every == 0
        src, _ = parse_addr("fd00::30" if v6 else "192.168.1.30")
        dst, _ = parse_addr("fd00::10" if v6 else "192.168.1.10")
        method, path = REQUESTS[r % len(REQUESTS)] if l7 \
            else (C.HTTP_METHOD_ANY, b"")
        recs.append(PacketRecord(src, dst, 20000 + 128 * i + r,
                                 8080 if l7 else 443, C.PROTO_TCP,
                                 C.TCP_ACK if l7 else C.TCP_SYN, v6, 1,
                                 C.DIR_INGRESS, method, path))
    return batch_from_records(recs, eng.active.snapshot.ep_slot_of)


def batch_counts(b):
    """The batch's own counts: v6 rows, rows with a request, and its
    unique paths (the empty one included)."""
    req = (b["http_method"] != C.HTTP_METHOD_ANY) | b["http_path"].any(1)
    paths = np.unique(b["http_path"], axis=0).shape[0]
    return int(b["is_v6"].sum()), int(req.sum()), paths


def dict_bytes(dp):
    """The bytes of one device copy of the path dictionary, after checking
    that every device holds the same one."""
    sizes = {t.numel() * t.element_size()
             for t in dp._path_dict_dev.values()}
    assert len(sizes) == 1
    return sizes.pop()


def metric(text, name):
    """The value of the unlabelled ``ciliumtpu_<name>``, None if absent."""
    for ln in text.splitlines():
        if ln.startswith(f"ciliumtpu_{name} "):
            return float(ln.split()[1])
    return None


@pytest.mark.parametrize("mesh", [{}, {"n_shards": 2}],
                         ids=["one", "mesh"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_the_dictionary_pack_is_a_span_under_pack(kind, mesh):
    eng = web_engine(trace_sample_rate=1.0, **mesh)
    try:
        batches = [kind_batch(eng, kind, i) for i in range(2)]
        for i, b in enumerate(batches):
            eng.classify(b, now=100 + i)
        spans = TRACER.export()
        ids = {s["span_id"]: s for s in spans}
        got = [s for s in spans if s["name"] == SPAN]
        if not KINDS[kind][1]:
            assert got == []
            return
        assert len(got) == len(batches)
        dev = eng.datapath._path_dict_dev
        for s, b in zip(got, batches):
            parent = ids[s["parent_id"]]
            assert parent["name"] == "datapath.pack"
            assert parent["start_ns"] <= s["start_ns"] \
                <= s["end_ns"] <= parent["end_ns"]
            _v6, _req, paths = batch_counts(b)
            rows = s["attrs"]["rows"]
            # a mesh packs the batch steered: each shard's rows padded
            assert rows == ROWS if not mesh \
                else rows >= ROWS and rows % mesh["n_shards"] == 0
            assert s["attrs"]["paths"] == paths
        # both batches ship the same dictionary, the one on the device
        assert {s["attrs"]["dict_rows"] for s in got} \
            == {t.shape[0] for t in dev.values()}
        assert got[0]["attrs"]["dict_rows"] >= got[0]["attrs"]["paths"]
    finally:
        eng.stop()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_the_counters_advance_by_the_batch_counts(kind):
    eng = web_engine()
    try:
        dp = eng.datapath
        want = dict.fromkeys(COUNTERS, 0)
        for i in range(3):
            b = kind_batch(eng, kind, i)
            v6, req, paths = batch_counts(b)
            eng.classify(b, now=100 + i)
            want["v6_rows"] += v6
            want["l7_rows"] += req
            want["l7_dict_paths"] += paths if req else 0
            assert {k: dp.pack_stats[k] for k in COUNTERS} == want, i
            text = eng.render_metrics()
            for k in COUNTERS:
                # a counter is exported once it has counted
                assert metric(text, f"datapath_{k}_total") \
                    == (want[k] or None), (i, k)
        v6_every, l7_every = KINDS[kind]
        assert (want["v6_rows"] > 0) == bool(v6_every)
        assert (want["l7_rows"] > 0) == bool(l7_every)
    finally:
        eng.stop()


@pytest.mark.parametrize("mesh", [{}, {"n_shards": 2}],
                         ids=["one", "mesh"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_the_l7_dict_group_is_the_device_dictionary(kind, mesh):
    """The group is one copy of the dictionary: a mesh counts the
    replicated dictionary once, as it counts every logical tensor."""
    eng = web_engine(**mesh)
    try:
        dp = eng.datapath
        groups = dp.hbm_ledger()["groups"]
        assert "l7_dict" not in groups
        before = sum(v for k, v in groups.items() if k != "wire_pool")
        eng.classify(kind_batch(eng, kind, 0), now=100)
        ledger = dp.hbm_ledger()
        groups = ledger["groups"]
        if not KINDS[kind][1]:
            assert "l7_dict" not in groups
            assert ledger["device_bytes"] == before
            return
        assert groups["l7_dict"] == dict_bytes(dp) > 0
        assert ledger["device_bytes"] == before + groups["l7_dict"]
    finally:
        eng.stop()


def test_the_group_leaves_with_the_l7_wire():
    """A snapshot with no L7 rule set narrows the wire: the dictionary
    goes, and its group with it."""
    eng = web_engine()
    try:
        eng.classify(kind_batch(eng, "l7", 0), now=100)
        assert eng.datapath.hbm_ledger()["groups"]["l7_dict"] > 0
        eng.repo.clear()
        eng.apply_policy([{
            "endpointSelector": {"matchLabels": {"app": "web"}},
            "ingress": [{"toPorts": [{"ports": [{"port": "443",
                                                 "protocol": "TCP"}]}]}]}])
        eng.regenerate(force=True)
        assert eng.active.snapshot.l7.n_sets == 0
        assert "l7_dict" not in eng.datapath.hbm_ledger()["groups"]
    finally:
        eng.stop()
