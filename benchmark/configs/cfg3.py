"""cfg3's deployment as plain data: the web endpoint, an egress allow of
``0.0.0.0/1``, the service ``prod/api`` and a ToServices rule to it, and
``prefixes`` v4 prefixes of a BGP table's mix (/16 20%, /20 30%, /24 50%)
drawn from a generator seeded 0, each owned by the CIDR identity of its /8.
The destination pool ``dst_pool`` (65,536 addresses in 1.0.0.0 to
219.255.255.255) is drawn after the prefixes from the same generator."""

import numpy as np


def _prefixes(rng, n):
    out = []
    for _ in range(n):
        plen = int(rng.choice([16, 20, 24], p=[0.2, 0.3, 0.5]))
        addr = int(rng.integers(0x01000000, 0xDF000000)) \
            & (0xFFFFFFFF << (32 - plen))
        out.append((addr, plen))
    return out


def _dotted(addr):
    return ".".join(str((addr >> s) & 0xFF) for s in (24, 16, 8, 0))


def declare(sizes):
    rng = np.random.default_rng(0)
    web = {"matchLabels": {"app": "web"}}
    steps = [
        {"endpoint": {"ep_id": 1, "labels": ["k8s:app=web"],
                      "ips": ["192.168.0.10"]}},
        {"rules": [{"endpointSelector": web,
                    "egress": [{"toCIDR": ["0.0.0.0/1"]}]}]},
        {"service": {"name": "api", "namespace": "prod",
                     "backends": ["10.200.0.1", "10.200.0.2"]}},
        {"rules": [{"endpointSelector": web, "egress": [{"toServices": [
            {"k8sService": {"serviceName": "api",
                            "namespace": "prod"}}]}]}]},
    ]
    steps += [{"cidr_identity": {"cidr": f"{addr >> 24}.0.0.0/8",
                                 "prefix": f"{_dotted(addr)}/{plen}"}}
              for addr, plen in _prefixes(rng, sizes["prefixes"])]
    n = sizes["pool"]
    pool = ((rng.integers(1, 220, n) << 24)
            + rng.integers(0, 1 << 24, n)).astype(np.uint32)
    return {"steps": steps, "pools": {"dst_pool": pool}}
