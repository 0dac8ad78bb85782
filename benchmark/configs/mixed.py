"""The mixed deployment as plain data: cfg2's control plane and cfg4's L7
rule sets on one node. ``pods`` pods in ``groups`` label groups, a v4 /32
for each and a v6 /128 for every fourth (one identity: the same labels
twice); ``rules`` ingress port rules on the web endpoint (rule ``j`` lets
group ``j % groups`` reach ``1000 + j % 4000``, over UDP for every third,
else TCP); ``l7_sets`` sets of three HTTP rules on TCP ``80 + s`` from
every peer (GET on ``/api/v{s}``, POST on ``/submit/{s}``, any method on
``/public/{s}``). The web endpoint has a v4 and a v6 address.
"""


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
