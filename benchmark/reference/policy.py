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
does so for each backend's /32 (/128 for a v6 address). A direction of an
endpoint is enforced when some rule that selects the endpoint has a section
for it; there, a packet is allowed when some block selects its remote
identity and, where the block lists ports, its protocol and destination
port. A block that names no peer (no ``fromEndpoints``, ``toEndpoints``,
``toCIDR`` or ``toServices``) but lists ports selects every identity.

L7-lite: a port entry of ``toPorts`` with ``rules.http`` (a list of
``{method?, path?}``) makes its ports an L7 rule set for the identities its
block selects: there a request is allowed when some rule's method is absent
or equal to the request's and its path is a byte prefix of the request's
path (up to 64 bytes), Cilium's ``rules.http`` with the path read as a
prefix. Blocks on one (identity, protocol, port) union their rules. Where
an L7 port of an identity is also allowed to it by another block without
rules, or by L7 blocks of both that identity and every identity, the
answer depends on a precedence this reference does not model: it refuses
such a declaration.
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
_PEER_KEYS = _BLOCK_KEYS - {"toPorts"}
#: the identity of a key that every identity matches
ANY = 0


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


def _host(ip: str) -> str:
    """An address's own prefix: /32, or /128 for v6."""
    return _norm(f"{ip}/{ipaddress.ip_address(ip).max_prefixlen}")


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
            self.ipcache[_host(ip)] = ident
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
                            self._cidr_identity(_host(ip), _host(ip))
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
                peers += self._by_label.get(f"cidr:{_host(ip)}", [])
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
        # per (endpoint id, direction): enforced; the (identity, proto, port)
        # keys allowed without L7 rules (identity ``ANY``: every identity);
        # the identities allowed on every port; the keys under L7 rules and
        # the number of each one's rule set in ``l7_sets`` (from 1)
        self.enforced: Dict[Tuple[int, int], bool] = {}
        self.allow_keys: Dict[Tuple[int, int], np.ndarray] = {}
        self.allow_any: Dict[Tuple[int, int], np.ndarray] = {}
        self.l7_keys: Dict[Tuple[int, int], np.ndarray] = {}
        self.l7_set: Dict[Tuple[int, int], np.ndarray] = {}
        #: the L7 rule sets: each a frozenset of (method or None, path)
        self.l7_sets: List[FrozenSet[Tuple[Optional[str], bytes]]] = []
        self._port_keys: Dict[Tuple[int, int], Tuple[np.ndarray,
                                                      np.ndarray]] = {}
        for ep in self.endpoints:
            ep_kv = {(k, v) for _s, k, v in map(_label_kv, ep["labels"])}
            for d, section in ((C.DIR_INGRESS, "ingress"),
                               (C.DIR_EGRESS, "egress")):
                keys, any_ids, enforced = [], [], False
                l7: Dict[int, FrozenSet] = {}
                for doc in self.rules:
                    sel = doc.get("endpointSelector", {}).get(
                        "matchLabels", {})
                    if not set(sel.items()) <= ep_kv or section not in doc:
                        continue
                    enforced = True
                    for block in doc[section]:
                        every = block.get("toPorts") \
                            and not set(block) & _PEER_KEYS
                        peers = np.asarray([ANY] if every
                                           else self._peers(block), np.int64)
                        if not block.get("toPorts"):
                            any_ids.append(peers)
                            continue
                        for tp in block["toPorts"]:
                            http = _http_rules(tp)
                            for p in tp.get("ports", ()):
                                fk = _flow_key(peers, _PROTOS[p.get(
                                    "protocol", "TCP").upper()],
                                    int(p["port"]))
                                if http is None:
                                    keys.append(fk)
                                    continue
                                for x in fk.tolist():
                                    l7[x] = l7.get(x, frozenset()) | http
                k = (ep["ep_id"], d)
                self.enforced[k] = enforced
                self.allow_keys[k] = np.unique(np.concatenate(
                    keys or [np.zeros(0, np.int64)]))
                self.allow_any[k] = np.unique(np.concatenate(
                    any_ids or [np.zeros(0, np.int64)]))
                self.l7_keys[k] = np.asarray(sorted(l7), np.int64)
                self.l7_set[k] = np.asarray(
                    [self._intern(l7[x]) for x in sorted(l7)], np.int64)
                self._refuse_overlaps(k)
        self._lpm = _LPM(self.ipcache)

    def _intern(self, rules: FrozenSet) -> int:
        if rules not in self.l7_sets:
            self.l7_sets.append(rules)
        return self.l7_sets.index(rules) + 1

    def _refuse_overlaps(self, k) -> None:
        """Refuse an L7 key that another allow also covers (the precedence
        this reference does not model, see the module's docstring)."""
        l7 = self.l7_keys[k]
        if not l7.size:
            return
        plain = self.allow_keys[k]
        ident, port = l7 >> 24, l7 & 0xFFFFFF
        every = ident == ANY
        clash = np.isin(l7, plain) | np.isin(
            port, plain[(plain >> 24) == ANY] & 0xFFFFFF)
        clash |= ~every & (np.isin(port, port[every])
                           | np.isin(ident, self.allow_any[k]))
        clash |= every & (np.isin(port, plain & 0xFFFFFF)
                          | (self.allow_any[k].size > 0))
        if clash.any():
            raise NotImplementedError(
                "an L7 port that another allow also covers")

    def lookup(self, addr: np.ndarray):
        """v4 addresses [N] uint32 → (identity [N] uint32, winning prefix
        index [N] int64, -1 on a miss; its length in the 128-bit space of
        v4-mapped addresses, -1 on a miss)."""
        return self._lpm.lookup(addr)

    def lookup_rows(self, words: np.ndarray, is_v6: np.ndarray):
        """Rows' addresses [N, 4] uint32 (a v4 row's in its last word) and
        their family [N] → as ``lookup``; a v6 row is matched on all 128
        bits against the v6 entries, its length as the entry's own."""
        ident, which, plen = self._lpm.lookup(words[:, 3])
        v6 = np.asarray(is_v6, bool)
        if v6.any():
            ident[v6], which[v6], plen[v6] = self._lpm.lookup6(words[v6])
        return ident, which, plen

    def verdict(self, ep_id: int, direction: int, ident: np.ndarray,
                proto: np.ndarray, dport: np.ndarray):
        """→ (allowed [N] bool: some block allows the row's identity,
        protocol and port; its L7 rule set [N] int64, 0 where none: the
        set a request there has to match)."""
        k = (ep_id, direction)
        ident = ident.astype(np.int64)
        keys = _flow_key(ident, proto, dport)
        every = _flow_key(ANY, proto, dport)
        plain = self.allow_keys[k]
        allowed = np.isin(keys, plain) | np.isin(every, plain) \
            | np.isin(ident, self.allow_any[k])
        sets = np.zeros(keys.shape[0], np.int64)
        l7 = self.l7_keys[k]
        if l7.size:
            for probe in (every, keys):
                pos = np.clip(np.searchsorted(l7, probe), 0, l7.size - 1)
                hit = l7[pos] == probe
                sets[hit] = self.l7_set[k][pos[hit]]
        return allowed | (sets > 0), sets

    def l7_match(self, sets: np.ndarray, method: np.ndarray,
                 path: np.ndarray) -> np.ndarray:
        """Requests ([N] method index, [N, 64] path bytes) against the L7
        sets ``sets`` [N] (0: none, which every request matches)."""
        ok = sets == 0
        for s in np.unique(sets[sets > 0]):
            rows = np.flatnonzero(sets == s)
            for want, prefix in self.l7_sets[int(s) - 1]:
                m = np.ones(rows.shape[0], bool) if want is None \
                    else method[rows] == C.HTTP_METHODS.index(want)
                if prefix:
                    m &= (path[rows, :len(prefix)] == np.frombuffer(
                        prefix, np.uint8)).all(1)
                ok[rows] |= m
        return ok

    def allowed_ports(self, ep_id: int, direction: int, ident: int
                      ) -> List[Tuple[int, int]]:
        """The (protocol, port) pairs on which ``ident`` is allowed, by its
        own keys and those of every identity, under L7 rules or not."""
        k = (ep_id, direction)
        if k not in self._port_keys:
            keys = np.unique(np.concatenate([self.allow_keys[k],
                                             self.l7_keys[k]]))
            self._port_keys[k] = keys, keys[(keys >> 24) == ANY]
        keys, every = self._port_keys[k]
        lo, hi = np.searchsorted(keys, [int(ident) << 24,
                                        (int(ident) + 1) << 24])
        sel = np.union1d(keys[lo:hi] & 0xFFFFFF, every)
        return [(int((x >> 16) & 0xFF), int(x & 0xFFFF)) for x in sel]


def _http_rules(port_entry: Dict
                ) -> Optional[FrozenSet[Tuple[Optional[str], bytes]]]:
    """A ``toPorts`` entry's ``rules.http`` as (method or None, path)
    pairs; None where it has none."""
    rules = port_entry.get("rules") or {}
    unknown = set(rules) - {"http"}
    if unknown:
        raise NotImplementedError(f"L7 rule kinds {sorted(unknown)}")
    out = set()
    for h in rules.get("http") or ():
        method, path = h.get("method") or None, h.get("path", "").encode()
        if method is not None and method not in C.HTTP_METHODS \
                or len(path) > C.PATH_BYTES:
            raise NotImplementedError(f"HTTP rule {h}")
        out.add((method, path))
    if out and not port_entry.get("ports"):
        raise NotImplementedError("L7 rules without ports")
    return frozenset(out) or None


def _flow_key(ident, proto, port):
    return (np.asarray(ident, np.int64) << 24) \
        | (np.asarray(proto, np.int64) << 16) | np.asarray(port, np.int64)


class _LPM:
    """Longest-prefix match: per length, v4 entries as sorted networks and
    v6 entries as a table of networks, each with its identity and index."""

    def __init__(self, entries: Dict[str, int]):
        self.prefixes: List[str] = []
        by_len: Dict[int, List[Tuple[int, int, int]]] = {}
        by_len6: Dict[int, Dict[int, Tuple[int, int]]] = {}
        for i, (prefix, ident) in enumerate(entries.items()):
            net = ipaddress.ip_network(prefix)
            self.prefixes.append(prefix)
            key = int(net.network_address) >> (net.max_prefixlen
                                               - net.prefixlen)
            if net.version == 6:
                by_len6.setdefault(net.prefixlen, {})[key] = (ident, i)
            else:
                by_len.setdefault(net.prefixlen, []).append((key, ident, i))
        self.levels = []
        for plen in sorted(by_len, reverse=True):
            rows = np.asarray(sorted(by_len[plen]), np.int64)
            self.levels.append((plen, rows[:, 0], rows[:, 1], rows[:, 2]))
        self.levels6 = sorted(by_len6.items(), reverse=True)

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

    def lookup6(self, words: np.ndarray):
        """v6 addresses [N, 4] uint32 words, most significant first."""
        addr = [(w0 << 96) | (w1 << 64) | (w2 << 32) | w3
                for w0, w1, w2, w3 in np.asarray(words, np.int64).tolist()]
        n = len(addr)
        ident = np.full(n, C.IDENTITY_WORLD, np.int64)
        which = np.full(n, -1, np.int64)
        plen_out = np.full(n, -1, np.int64)
        todo = range(n)
        for plen, table in self.levels6:
            rest = []
            for i in todo:
                got = table.get(addr[i] >> (128 - plen))
                if got is None:
                    rest.append(i)
                else:
                    ident[i], which[i] = got
                    plen_out[i] = plen
            todo = rest
        return ident.astype(np.uint32), which, plen_out


def endpoint_of_slot(policy: Policy, slot: int) -> Optional[Dict]:
    """The endpoint at ``slot``: endpoints take slots in ``ep_id`` order."""
    eps = sorted(policy.endpoints, key=lambda e: e["ep_id"])
    return eps[slot] if 0 <= slot < len(eps) else None
