"""A test-only world of v6 rows and L7-lite HTTP rules, built as a
``Cell`` here (``configs/`` and ``BENCHMARK.json`` hold nothing of it):
cfg2's control plane and cfg4's L7 rule sets at test size. 400 pods in 20
label groups, a v4 /32 for each and a v6 /128 for every fourth (one
identity: the same labels twice); 100 ingress port rules (rule ``j`` lets
group ``j % 20`` reach ``1000 + j % 4000``, over UDP for every third, else
TCP); 10 sets of three HTTP rules on TCP ``80 + s`` from every peer: cfg2's
and cfg4's rules as ``cilium_tpu_torch/world.py`` declares them, whose
sizes ``declare`` takes. The web endpoint has a v4 and a v6 address. Its mix is ``churn_close``'s, with a
quarter of the flows on v6 and 70% of the requests on L7 ports matching
their set."""

import sys

from benchmark.harness import cell as cells

NAME = "v6l7.serve"

SIZES = {"pods": 400, "groups": 20, "rules": 100, "l7_sets": 10,
         "ct_capacity": 65536, "batch": 1024}

CONFIG = {
    "sizes": SIZES, "test_sizes": SIZES,
    "node_ipcache": {"169.254.254.254/32": "health"},
    "daemon": {"v4_only": False, "auto_regen": False,
               "pipeline_inflight": 2, "pipeline_flush_ms": 1.0,
               "ct_gc_chunk_rows": 65536, "audit_max_rows": 512,
               "flowlog_mode": "none"},
}

MIX = {
    "generator": "flow_churn", "outstanding": 4, "flows": 8192,
    "test_flows": 8192, "direction": "ingress", "local_ip": "192.168.0.10",
    "peers": {"pool": "identities", "zipf": 0.0}, "proto": "TCP",
    "sport": [20000, 60000], "dport": "allowed",
    "mix": {"ack": 0.8, "syn": 0.1, "fin": 0.1}, "clock_step_s": 1,
    "gc_every_s": 2, "checked_dispatches": 2, "checked_from": [0, 8],
    "test_checked_from": [0, 8], "v6": 0.25, "l7": 0.7,
}


def pod_ip(i: int) -> str:
    return f"172.{16 + (i >> 16)}.{(i >> 8) & 0xFF}.{i & 0xFF}"


def pod_ip6(i: int) -> str:
    return f"2001:db8:{i >> 8:x}:{i & 0xFF:x}::1"


def _web(block):
    return {"endpointSelector": {"matchLabels": {"app": "web"}},
            "ingress": [block]}


def declare(sizes):
    groups = sizes["groups"]
    steps = [{"endpoint": {"ep_id": 1, "labels": ["k8s:app=web"],
                           "ips": ["192.168.0.10", "fd00::10"]}}]
    for i in range(sizes["pods"]):
        labels = [f"k8s:group=g{i % groups}", f"k8s:pod=p{i}"]
        steps.append({"identity": {"labels": labels,
                                   "prefix": f"{pod_ip(i)}/32"}})
        if i % 4 == 0:
            steps.append({"identity": {"labels": labels,
                                       "prefix": f"{pod_ip6(i)}/128"}})
    rules = [_web({"fromEndpoints": [{"matchLabels": {"group":
                                                      f"g{j % groups}"}}],
                   "toPorts": [{"ports": [{
                       "port": str(1000 + j % 4000),
                       "protocol": "TCP" if j % 3 else "UDP"}]}]})
             for j in range(sizes["rules"])]
    rules += [_web({"toPorts": [{
        "ports": [{"port": str(80 + s), "protocol": "TCP"}],
        "rules": {"http": [{"method": "GET", "path": f"/api/v{s}"},
                           {"method": "POST", "path": f"/submit/{s}"},
                           {"path": f"/public/{s}"}]}}]})
        for s in range(sizes["l7_sets"])]
    steps.append({"rules": rules})
    return {"steps": steps}


def cell() -> cells.Cell:
    return cells.Cell(
        name=NAME, chips=1, config_name="v6l7", config=CONFIG,
        declare=sys.modules[__name__], traffic_name="v6l7_churn",
        traffic=MIX, generator=cells._module("generators", "flow_churn"))
