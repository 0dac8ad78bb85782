"""cfg5's deployment as plain data: the web endpoint, one identity and one
/32 for each pod, and the ingress L4 rules (rule ``j`` lets pod
``p{j % identities}`` reach TCP ``1024 + j % 25000`` on the web endpoint).
"""


def pod_ip(i: int) -> str:
    return f"172.{16 + (i >> 16)}.{(i >> 8) & 0xFF}.{i & 0xFF}"


def declare(sizes):
    n_ids, n_rules = sizes["identities"], sizes["rules"]
    steps = [{"endpoint": {"ep_id": 1, "labels": ["k8s:app=web"],
                           "ips": ["192.168.0.10"]}}]
    steps += [{"identity": {"labels": [f"k8s:pod=p{i}"],
                            "prefix": f"{pod_ip(i)}/32"}}
              for i in range(n_ids)]
    steps.append({"rules": [
        {"endpointSelector": {"matchLabels": {"app": "web"}},
         "ingress": [{"fromEndpoints": [{"matchLabels":
                                         {"pod": f"p{j % n_ids}"}}],
                      "toPorts": [{"ports": [{"port": str(1024 + j % 25000),
                                              "protocol": "TCP"}]}]}]}
        for j in range(n_rules)]})
    return {"steps": steps}
