"""A configuration's control plane worked out again from its declaration.

The declaration (``configs/<name>.py``'s ``declare``) is plain data: a list
of steps in the order the deployment makes them, and the node's own
ipcache entries. Each step is one of

- ``{"endpoint": {"ep_id", "labels", "ips"}}``: a local endpoint; its label
  set gets an identity and each of its addresses a /32;
- ``{"identity": {"labels", "prefix"}}``: a label set's identity, and the
  prefix it owns in the ipcache;
- ``{"cidr_identity": {"cidr", "prefix"}}``: the identity of the CIDR
  ``cidr``, and the prefix it owns;
- ``{"service": {"name", "namespace", "backends"}}``: a service's backends;
- ``{"rules": [document, ...]}``: policy documents.

Identities are numbered as Cilium's allocator numbers them: a new label set
takes the next number, cluster-scoped label sets from 256 and CIDR label
sets from 2^24, in the order they are first met. A CIDR identity carries
``reserved:world`` and a ``cidr:`` label for its prefix and for every
shorter prefix that holds it; a rule's ``toCIDR`` gives its CIDRs such
identities and ipcache entries when the rule is added, and ``toServices``
does so for each backend's /32. A direction of an endpoint is enforced when
some rule that selects the endpoint has a section for it; there, a packet
is allowed when some block selects its remote identity and, where the block
lists ports, its protocol and destination port.
"""

from __future__ import annotations

import functools
import ipaddress
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from . import constants as C

_PROTOS = {"TCP": C.PROTO_TCP, "UDP": C.PROTO_UDP, "SCTP": C.PROTO_SCTP,
           "ICMP": C.PROTO_ICMP}
#: the rule-document keys this reference knows; any other is refused
_BLOCK_KEYS = {"fromEndpoints", "toEndpoints", "toCIDR", "toServices",
               "toPorts"}


def _label_kv(label: str) -> Tuple[str, str, str]:
    """"k8s:pod=p0" → ("k8s", "pod", "p0")."""
    source, _, rest = label.partition(":") if ":" in label else ("", "",
                                                                  label)
    key, _, value = rest.partition("=")
    return source, key, value


@functools.lru_cache(maxsize=None)
def _cidr_labels(cidr: str) -> FrozenSet[str]:
    net = ipaddress.ip_network(cidr, strict=False)
    labels = {"reserved:world"}
    for plen in range(net.prefixlen, -1, -1):
        labels.add(f"cidr:{net.supernet(new_prefix=plen)}")
    return frozenset(labels)


def _norm(prefix: str) -> str:
    return str(ipaddress.ip_network(prefix, strict=False))


class Policy:
    """The identities, ipcache and allowed sets a declaration makes."""

    def __init__(self, decl: Dict):
        self.ids: Dict[FrozenSet[str], int] = {}
        self.labels_of: Dict[int, FrozenSet[str]] = {}
        self._next = {"cluster": C.CLUSTER_IDENTITY_BASE,
                      "cidr": C.LOCAL_IDENTITY_SCOPE}
        self.ipcache: Dict[str, int] = {}
        for prefix, name in decl.get("node_ipcache", {}).items():
            self.ipcache[_norm(prefix)] = C.RESERVED[name]
        self.endpoints: List[Dict] = []
        self.services: Dict[Tuple[str, str], List[str]] = {}
        self.rules: List[Dict] = []
        for step in decl["steps"]:
            (kind, body), = step.items()
            getattr(self, f"_step_{kind}")(body)
        self._compile()

    # -- declaration -------------------------------------------------------
    def _allocate(self, labels: FrozenSet[str], scope: str) -> int:
        got = self.ids.get(labels)
        if got is None:
            got = self.ids[labels] = self._next[scope]
            self._next[scope] += 1
            self.labels_of[got] = labels
        return got

    def _cidr_identity(self, cidr: str, prefix: str) -> int:
        ident = self._allocate(_cidr_labels(cidr), "cidr")
        self.ipcache[_norm(prefix)] = ident
        return ident

    def _step_endpoint(self, ep):
        ident = self._allocate(frozenset(ep["labels"]), "cluster")
        for ip in ep.get("ips", ()):
            self.ipcache[_norm(f"{ip}/32")] = ident
        self.endpoints.append(dict(ep, identity=ident))

    def _step_identity(self, body):
        ident = self._allocate(frozenset(body["labels"]), "cluster")
        self.ipcache[_norm(body["prefix"])] = ident

    def _step_cidr_identity(self, body):
        self._cidr_identity(body["cidr"], body["prefix"])

    def _step_service(self, body):
        self.services[(body["namespace"], body["name"])] = \
            list(body["backends"])

    def _step_rules(self, docs):
        for doc in docs:
            for section in ("ingress", "egress"):
                for block in doc.get(section, ()):
                    unknown = set(block) - _BLOCK_KEYS
                    if unknown:
                        raise NotImplementedError(
                            f"rule keys {sorted(unknown)}")
                    for cidr in block.get("toCIDR", ()):
                        self._cidr_identity(cidr, cidr)
                    for svc in block.get("toServices", ()):
                        ref = svc["k8sService"]
                        for ip in self.services.get(
                                (ref["namespace"], ref["serviceName"]), ()):
                            self._cidr_identity(f"{ip}/32", f"{ip}/32")
            self.rules.append(doc)

    # -- compiled answers --------------------------------------------------
    def _peers(self, block) -> List[int]:
        peers: List[int] = []
        for sel in [*block.get("fromEndpoints", ()),
                    *block.get("toEndpoints", ())]:
            peers += self._by_kv(sel.get("matchLabels", {}))
        for cidr in block.get("toCIDR", ()):
            peers += self._by_label.get(f"cidr:{_norm(cidr)}", [])
        for svc in block.get("toServices", ()):
            ref = svc["k8sService"]
            for ip in self.services.get((ref["namespace"],
                                         ref["serviceName"]), ()):
                peers += self._by_label.get(f"cidr:{_norm(ip + '/32')}", [])
        return peers

    def _by_kv(self, match_labels: Dict[str, str]) -> List[int]:
        sets = [set(self._by_pair.get(kv, ())) for kv in match_labels.items()]
        return sorted(set.intersection(*sets)) if sets else []

    def _compile(self):
        self._by_label: Dict[str, List[int]] = {}
        self._by_pair: Dict[Tuple[str, str], List[int]] = {}
        for ident, labels in self.labels_of.items():
            for lab in labels:
                self._by_label.setdefault(lab, []).append(ident)
                _s, k, v = _label_kv(lab)
                self._by_pair.setdefault((k, v), []).append(ident)
        # per (endpoint id, direction): enforced, allowed (id, proto, port)
        # keys, and identities allowed on every port
        self.enforced: Dict[Tuple[int, int], bool] = {}
        self.allow_keys: Dict[Tuple[int, int], np.ndarray] = {}
        self.allow_any: Dict[Tuple[int, int], np.ndarray] = {}
        for ep in self.endpoints:
            ep_kv = {(k, v) for _s, k, v in map(_label_kv, ep["labels"])}
            for d, section in ((C.DIR_INGRESS, "ingress"),
                               (C.DIR_EGRESS, "egress")):
                keys, any_ids, enforced = [], [], False
                for doc in self.rules:
                    sel = doc.get("endpointSelector", {}).get(
                        "matchLabels", {})
                    if not set(sel.items()) <= ep_kv or section not in doc:
                        continue
                    enforced = True
                    for block in doc[section]:
                        peers = np.asarray(self._peers(block), np.int64)
                        ports = [(_PROTOS[p.get("protocol", "TCP").upper()],
                                  int(p["port"]))
                                 for tp in block.get("toPorts", ())
                                 for p in tp.get("ports", ())]
                        if not block.get("toPorts"):
                            any_ids.append(peers)
                            continue
                        for proto, port in ports:
                            keys.append(_flow_key(peers, proto, port))
                k = (ep["ep_id"], d)
                self.enforced[k] = enforced
                self.allow_keys[k] = np.unique(np.concatenate(
                    keys or [np.zeros(0, np.int64)]))
                self.allow_any[k] = np.unique(np.concatenate(
                    any_ids or [np.zeros(0, np.int64)]))
        self._lpm = _LPM(self.ipcache)

    def lookup(self, addr: np.ndarray):
        """v4 addresses [N] uint32 → (identity [N] uint32, winning prefix
        index [N] int64, -1 on a miss; its length in the 128-bit space of
        v4-mapped addresses, -1 on a miss)."""
        return self._lpm.lookup(addr)

    def allowed(self, ep_id: int, direction: int, ident: np.ndarray,
                proto: np.ndarray, dport: np.ndarray) -> np.ndarray:
        k = (ep_id, direction)
        keys = _flow_key(ident.astype(np.int64), proto, dport)
        return np.isin(keys, self.allow_keys[k]) | np.isin(
            ident.astype(np.int64), self.allow_any[k])

    def allowed_ports(self, ep_id: int, direction: int, ident: int
                      ) -> List[Tuple[int, int]]:
        """The (protocol, port) pairs on which ``ident`` is allowed."""
        keys = self.allow_keys[(ep_id, direction)]
        lo = int(ident) << 24
        sel = keys[(keys >= lo) & (keys < lo + (1 << 24))]
        return [(int((x >> 16) & 0xFF), int(x & 0xFFFF)) for x in sel]


def _flow_key(ident, proto, port):
    return (np.asarray(ident, np.int64) << 24) \
        | (np.asarray(proto, np.int64) << 16) | np.asarray(port, np.int64)


class _LPM:
    """Longest-prefix match over v4 entries: per length, the sorted
    networks and their identities."""

    def __init__(self, entries: Dict[str, int]):
        self.prefixes: List[str] = []
        by_len: Dict[int, List[Tuple[int, int, int]]] = {}
        for i, (prefix, ident) in enumerate(entries.items()):
            net = ipaddress.ip_network(prefix)
            if net.version != 4:
                raise NotImplementedError("v6 ipcache entries")
            self.prefixes.append(prefix)
            key = int(net.network_address) >> (32 - net.prefixlen)
            by_len.setdefault(net.prefixlen, []).append((key, ident, i))
        self.levels = []
        for plen in sorted(by_len, reverse=True):
            rows = np.asarray(sorted(by_len[plen]), np.int64)
            self.levels.append((plen, rows[:, 0], rows[:, 1], rows[:, 2]))

    def lookup(self, addr: np.ndarray):
        a = np.asarray(addr, np.int64)
        n = a.shape[0]
        ident = np.full(n, C.IDENTITY_WORLD, np.int64)
        which = np.full(n, -1, np.int64)
        plen_out = np.full(n, -1, np.int64)
        todo = np.ones(n, bool)
        for plen, nets, ids, idx in self.levels:
            if not todo.any():
                break
            key = a >> (32 - plen)
            pos = np.clip(np.searchsorted(nets, key), 0, len(nets) - 1)
            hit = todo & (nets[pos] == key)
            ident[hit] = ids[pos[hit]]
            which[hit] = idx[pos[hit]]
            plen_out[hit] = 96 + plen
            todo &= ~hit
        return ident.astype(np.uint32), which, plen_out



def endpoint_of_slot(policy: Policy, slot: int) -> Optional[Dict]:
    """The endpoint at ``slot``: endpoints take slots in ``ep_id`` order."""
    eps = sorted(policy.endpoints, key=lambda e: e["ep_id"])
    return eps[slot] if 0 <= slot < len(eps) else None
