"""The flow-churn generator: a mix file's parameters → batches.

A mix (``traffic/<name>.json`` with ``"generator": "flow_churn"``) fixes a
table of ``flows`` concurrent flows between the local endpoint
(``local_ip``, ``direction`` as the endpoint sees it) and peers drawn from
a pool (``peers.pool``: ``"identities"``, the /32 of every identity the
configuration declares, or a pool the declaration names under ``pools``),
with a Zipf exponent over the pool's order (``peers.zipf``, 0 = uniform).
Each flow has a destination port from ``dport`` (a range, or
``"allowed"``: one of the ports the policy allows that peer) and two
source ports from ``sport``, A and B; it starts on A. Every draw comes
from ``--seed``; every seed gives the same sizes.

Each batch of the window carries the ``mix`` shares of rows: ``syn`` new
flows, ``fin`` closing rows of the flows those replace, and ``ack`` rows
of live flows, led by the previous batch's new flows, so that every new
flow is established a batch after its SYN. A replaced flow closes its
current tuple and opens the same flow on its other source port. The
flows are replaced in an order drawn from the seed, ``syn`` × batch at a
time, so every flow of the table (less the remainder of that division,
which stays open all through) is replaced once in ``cycle`` batches and
is back on its first port after two: the stream repeats every ``period``
= 2 × ``cycle`` batches, and those are all made before the window, so the
window makes no batch. The number of live flows stays that of the table,
plus the closing ones until they expire. The warm-up carries every flow
once (ACK rows), in batches of the same shape.

Two keys are optional; a mix without them gets the batches it got before
they existed:
- ``v6``: the share of flows (a fixed count, the flows drawn from the
  seed) that address their peer by its v6 /128 (``identity_pool_v6``, with
  ``peers.zipf`` over that pool's order) and the local endpoint by its
  first v6 address in the declaration; ``peers.pool`` must be
  ``"identities"``, and a ``dport`` of ``"allowed"`` is drawn again for
  these flows from their v6 peers' identities.
- ``l7``: on the ACK rows of the window whose flow the policy puts under
  an L7 rule set, the share of requests (drawn a row at a time) whose
  method and path match a rule of that set: one of its rules, the method
  its own (GET where it names none) and the path its prefix followed by
  ``/x``; the other requests are drawn from ``NO_MATCH``, those that match
  no rule of the set. SYN and FIN rows and the warm-up's rows carry no
  request (a handshake, a close).
"""

from __future__ import annotations

import ipaddress
from typing import Dict, Iterator, List

import numpy as np

from benchmark.reference.constants import HTTP_METHODS

#: the mix keys this generator reads
KEYS = ("direction", "local_ip", "peers", "proto", "sport", "dport", "mix",
        "v6", "l7")

PROTOS = {"TCP": 6, "UDP": 17}
TCP_FIN, TCP_SYN, TCP_ACK = 0x01, 0x02, 0x10
DIRECTIONS = {"egress": 0, "ingress": 1}
HTTP_METHOD_NONE = 255
PATH_BYTES = 64
#: requests that miss an L7 rule set, of which each set's rows draw those
#: that match none of its rules
NO_MATCH = (("DELETE", b"/forbidden/zone"), ("GET", b"/admin/console"),
            ("PUT", b"/"), ("PATCH", b"/internal/debug"))


def ip_word(ip: str) -> int:
    return int(ipaddress.ip_address(ip))


def identity_pool(policy) -> np.ndarray:
    """The /32 addresses of the declared cluster identities that are not
    local endpoints, in declaration order."""
    local = {ip for ep in policy.endpoints for ip in ep.get("ips", ())}
    out = []
    for prefix, ident in policy.ipcache.items():
        net = ipaddress.ip_network(prefix)
        if net.prefixlen == 32 and str(net.network_address) not in local \
                and ident < (1 << 24) and ident >= 256:
            out.append(int(net.network_address))
    return np.asarray(out, np.uint32)


def _words(ip) -> np.ndarray:
    """An address's four 32-bit words, most significant first."""
    a = int(ip)
    return np.asarray([(a >> s) & 0xFFFFFFFF for s in (96, 64, 32, 0)],
                      np.uint32)


def identity_pool_v6(policy) -> np.ndarray:
    """[M, 4] uint32: the /128 addresses of the declared cluster identities
    that are not local endpoints, in declaration order."""
    local = {ip for ep in policy.endpoints for ip in ep.get("ips", ())}
    out = []
    for prefix, ident in policy.ipcache.items():
        net = ipaddress.ip_network(prefix)
        if net.version == 6 and net.prefixlen == 128 \
                and str(net.network_address) not in local \
                and 256 <= ident < (1 << 24):
            out.append(_words(net.network_address))
    return np.asarray(out, np.uint32).reshape(-1, 4)


def local_v6(policy, local_ip: str) -> np.ndarray:
    """The first v6 address of the endpoint that holds ``local_ip``."""
    for ep in policy.endpoints:
        if local_ip in ep.get("ips", ()):
            for ip in ep["ips"]:
                if ipaddress.ip_address(ip).version == 6:
                    return _words(ipaddress.ip_address(ip))
    raise ValueError(f"the endpoint of {local_ip} declares no v6 address")


def _constant(n: int, value, dtype) -> np.ndarray:
    a = np.full(n, value, dtype)
    a.flags.writeable = False
    return a


def make(mix: Dict, decl: Dict, policy, batch: int, seed: int,
         flows: int) -> "FlowChurn":
    name = mix["peers"]["pool"]
    pool = identity_pool(policy) if name == "identities" \
        else np.asarray(decl["pools"][name], np.uint32)
    return FlowChurn(mix, pool, policy, batch, seed, flows)


class FlowChurn:
    """The flow table and the window's batches of one run."""

    def __init__(self, mix: Dict, pool: np.ndarray, policy, batch: int,
                 seed: int, flows: int):
        self.mix, self.batch, self.seed = mix, batch, seed
        self.n_flows = flows
        self.direction = DIRECTIONS[mix["direction"]]
        self.local = np.uint32(ip_word(mix["local_ip"]))
        self.proto = PROTOS[mix["proto"]]
        rng = np.random.default_rng([seed, 0])
        zipf = float(mix["peers"].get("zipf", 0.0))
        if zipf > 0:
            w = 1.0 / np.arange(1, len(pool) + 1) ** zipf
            peer_idx = rng.choice(len(pool), flows, p=w / w.sum())
        else:
            peer_idx = rng.integers(0, len(pool), flows)
        self.peer = pool[peer_idx]
        lo, hi = mix["sport"]
        #: each flow's two source ports, [flows, 2]
        self.sports = rng.integers(lo, hi, (flows, 2)).astype(np.int32)
        if mix["dport"] == "allowed":
            self.dport = self._allowed_ports(policy, policy.lookup(pool)[0],
                                             peer_idx, rng)
        else:
            lo, hi = mix["dport"]
            self.dport = rng.integers(lo, hi, flows).astype(np.int32)
        self.order = rng.permutation(flows)
        #: the v6 flows, their peers' and the local endpoint's addresses
        self.is_v6 = self.peer6 = self.local6 = None
        #: each flow's L7 rule set (0 none) and the requests of each set
        self.l7_set = self.requests = None
        if "v6" in mix:
            self._address_v6(mix, policy, zipf)
        if "l7" in mix:
            self._l7_requests(policy)
        shares = mix["mix"]
        self.n_new = int(round(batch * shares["syn"]))
        self.n_fin = int(round(batch * shares["fin"]))
        if self.n_fin != self.n_new:
            raise ValueError("fin rows close the flows the syn rows replace")
        self.n_ack = batch - self.n_new - self.n_fin
        if self.n_ack < self.n_new:
            raise ValueError("the ack rows must cover the last new flows")
        self.cycle = flows // self.n_new
        if self.cycle < 2:
            raise ValueError("the table must hold two batches' new flows")
        self.period = 2 * self.cycle
        #: tuples that two flows (on either port) share: their entries
        #: part once one of the flows is replaced
        if self.is_v6 is None:
            self.duplicates = self._duplicates(slice(None), self.peer)
        else:
            # a v6 tuple never equals a v4 one; a v6 peer counts by its
            # place in the pool
            v6 = self.is_v6
            self.duplicates = self._duplicates(~v6, self.peer[~v6]) \
                + self._duplicates(v6, self.peer6_idx)
        n = batch
        # the columns every row shares: one read-only array each
        self._const = {
            "proto": _constant(n, self.proto, np.int32),
            "is_v6": _constant(n, False, bool),
            "ep_slot": _constant(n, 0, np.int32),
            "direction": _constant(n, self.direction, np.int32),
            "http_method": _constant(n, HTTP_METHOD_NONE, np.int32),
            "http_path": np.zeros((n, PATH_BYTES), np.uint8),
            "valid": _constant(n, True, bool),
        }
        self._const["http_path"].flags.writeable = False
        self.window = self._window()

    def _duplicates(self, flows, peer) -> int:
        """Of ``flows``' tuples (on either port), those another shares."""
        sports = self.sports[flows].reshape(-1).astype(np.int64)
        tuples = (np.repeat(np.asarray(peer).astype(np.int64), 2) << 32) \
            | (sports << 16) \
            | np.repeat(self.dport[flows], 2).astype(np.int64)
        return sports.shape[0] - np.unique(tuples).shape[0]

    def _address_v6(self, mix, policy, zipf):
        if mix["peers"]["pool"] != "identities":
            raise ValueError("v6 peers come from the identities' /128s")
        pool6 = identity_pool_v6(policy)
        n_v6 = int(round(self.n_flows * mix["v6"]))
        if n_v6 and not len(pool6):
            raise ValueError("no identity has a v6 /128")
        rng = np.random.default_rng([self.seed, 3])
        self.is_v6 = np.zeros(self.n_flows, bool)
        self.is_v6[rng.permutation(self.n_flows)[:n_v6]] = True
        if zipf > 0:
            w = 1.0 / np.arange(1, len(pool6) + 1) ** zipf
            idx = rng.choice(len(pool6), n_v6, p=w / w.sum())
        else:
            idx = rng.integers(0, len(pool6), n_v6)
        self.peer6 = np.zeros((self.n_flows, 4), np.uint32)
        self.peer6[self.is_v6] = pool6[idx]
        self.peer6_idx = idx
        self.local6 = local_v6(policy, self.mix["local_ip"])
        if mix["dport"] == "allowed" and n_v6:
            idents = policy.lookup_rows(pool6, np.ones(len(pool6), bool))[0]
            self.dport[self.is_v6] = self._allowed_ports(policy, idents,
                                                         idx, rng)

    def _l7_requests(self, policy):
        """Each flow's L7 rule set, and per set its matching requests and
        those of ``NO_MATCH`` that match none of its rules."""
        self.l7_share = float(self.mix["l7"])
        ep_id = policy.endpoints[0]["ep_id"]
        words = np.zeros((self.n_flows, 4), np.uint32)
        words[:, 3] = self.peer
        v6 = np.zeros(self.n_flows, bool) if self.is_v6 is None \
            else self.is_v6
        words[v6] = self.peer6[v6]
        idents = policy.lookup_rows(words, v6)[0]
        self.l7_set = policy.verdict(
            ep_id, self.direction, idents,
            np.full(self.n_flows, self.proto, np.int64),
            self.dport.astype(np.int64))[1]
        n_sets = len(policy.l7_sets)
        bad_m = np.asarray([HTTP_METHODS.index(m) for m, _p in NO_MATCH])
        bad_p = np.zeros((len(NO_MATCH), PATH_BYTES), np.uint8)
        for i, (_m, p) in enumerate(NO_MATCH):
            bad_p[i, :len(p)] = np.frombuffer(p, np.uint8)
        good, bad = [[]], [[]]
        for s, rules in enumerate(policy.l7_sets, start=1):
            good.append([(HTTP_METHODS.index(m) if m else 0,
                          (p + b"/x")[:PATH_BYTES])
                         for m, p in sorted(rules, key=lambda r: (
                             r[0] or "", r[1]))])
            miss = ~policy.l7_match(np.full(len(NO_MATCH), s), bad_m, bad_p)
            if not miss.any():
                raise ValueError(f"every request of NO_MATCH matches L7 "
                                 f"set {s}")
            bad.append([(int(m), p) for m, p in zip(bad_m[miss],
                                                    bad_p[miss])])
        self.requests = [_request_table(t, n_sets) for t in (good, bad)]

    def _request_rows(self, flows: np.ndarray, flags: np.ndarray, t: int):
        """The request columns of a window batch's rows (``flows``, TCP
        ``flags``), drawn for its index ``t``."""
        n = flows.shape[0]
        sets = self.l7_set[flows]
        rng = np.random.default_rng([self.seed, 4, t])
        match = rng.random(n) < self.l7_share
        pick = rng.random(n)
        method = np.full(n, HTTP_METHOD_NONE, np.int32)
        path = np.zeros((n, PATH_BYTES), np.uint8)
        carry = (sets > 0) & (flags == TCP_ACK)
        for (methods, paths, count), want in zip(self.requests,
                                                 (match, ~match)):
            rows = carry & want
            s = sets[rows]
            r = (pick[rows] * count[s]).astype(np.int64)
            method[rows] = methods[s, r]
            path[rows] = paths[s, r]
        return method, path

    def _allowed_ports(self, policy, idents, peer_idx, rng):
        ep_id = policy.endpoints[0]["ep_id"]
        ports = []
        for ident in idents:
            got = [p for proto, p in policy.allowed_ports(
                ep_id, self.direction, int(ident)) if proto == self.proto]
            if not got:
                raise ValueError(f"peer identity {ident} has no allowed "
                                 f"port")
            ports.append(got)
        width = max(len(p) for p in ports)
        table = np.zeros((len(idents), width), np.int32)
        count = np.zeros(len(idents), np.int64)
        for i, p in enumerate(ports):
            table[i, :len(p)] = p
            count[i] = len(p)
        pick = (rng.random(len(peer_idx)) * count[peer_idx]).astype(np.int64)
        return table[peer_idx, pick]

    def rows(self, flows: np.ndarray, flags, sport: np.ndarray,
             requests=None) -> Dict[str, np.ndarray]:
        """A batch of the rows of ``flows`` (indices into the table) with
        TCP ``flags`` (one, or one a row), source ports ``sport`` and, where
        given, ``requests`` (their method and path columns); each batch has
        arrays of its own but for the shared columns, and none is
        writeable."""
        n = flows.shape[0]
        peer = self.peer[flows]
        src, dst = (peer, self.local) if self.direction == 1 \
            else (self.local, peer)
        b = {"src": np.zeros((n, 4), np.uint32),
             "dst": np.zeros((n, 4), np.uint32)}
        b["src"][:, 2] = b["dst"][:, 2] = 0xFFFF
        b["src"][:, 3], b["dst"][:, 3] = src, dst
        if self.is_v6 is not None:
            b["is_v6"] = self.is_v6[flows]
            remote, local = (b["src"], b["dst"]) if self.direction == 1 \
                else (b["dst"], b["src"])
            remote[b["is_v6"]] = self.peer6[flows[b["is_v6"]]]
            local[b["is_v6"]] = self.local6
        if requests is not None:
            b["http_method"], b["http_path"] = requests
        b["sport"] = sport.astype(np.int32)
        b["dport"] = self.dport[flows]
        b["tcp_flags"] = np.broadcast_to(np.asarray(flags, np.int32),
                                         (n,)).copy()
        for k, v in b.items():
            v.flags.writeable = False
        const = {k: v for k, v in self._const.items() if k not in b}
        if n == self.batch:
            b.update(const)
        else:
            b.update({k: np.array(v[:1]).repeat(n, 0)
                      for k, v in const.items()})
        return b

    def warm_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        for start in range(0, self.n_flows, self.batch):
            idx = np.arange(start, min(start + self.batch, self.n_flows))
            if idx.shape[0] < self.batch:
                idx = np.resize(idx, self.batch)
            yield self.rows(idx, TCP_ACK, self.sports[idx, 0])

    def _replaced(self, t: int) -> np.ndarray:
        k = t % self.cycle
        return self.order[k * self.n_new:(k + 1) * self.n_new]

    def _window(self) -> List[Dict[str, np.ndarray]]:
        """The ``period`` batches of the window, in order."""
        side = np.zeros(self.n_flows, np.int64)   # each flow's port now
        out = []
        for t in range(self.period):
            rng = np.random.default_rng([self.seed, 1, t])
            replaced = self._replaced(t)
            ack = np.concatenate([self._replaced(t - 1), rng.integers(
                0, self.n_flows, self.n_ack - self.n_new)])
            ack_sport = self.sports[ack, side[ack]]
            old_sport = self.sports[replaced, side[replaced]]
            side[replaced] ^= 1
            new_sport = self.sports[replaced, side[replaced]]
            flows = np.concatenate([ack, replaced, replaced])
            flags = np.concatenate([
                np.full(ack.shape[0], TCP_ACK),
                np.full(self.n_new, TCP_FIN | TCP_ACK),
                np.full(self.n_new, TCP_SYN)])
            sport = np.concatenate([ack_sport, old_sport, new_sport])
            perm = rng.permutation(self.batch)
            flows, flags = flows[perm], flags[perm]
            requests = None if self.requests is None \
                else self._request_rows(flows, flags, t)
            out.append(self.rows(flows, flags, sport[perm], requests))
        return out

    def batch_at(self, i: int) -> Dict[str, np.ndarray]:
        """The window's ``i``-th batch."""
        return self.window[i % self.period]

    def submit(self, eng, i: int, now: int):
        """Submit the window's ``i``-th batch at ``now``: → its ticket."""
        return eng.submit(self.batch_at(i), now=now)

    def live_allowance(self, close_batches: int) -> int:
        """The most live table entries the window may leave above the
        warm-up's: the closing flows of the last ``close_batches`` batches,
        and the tuples that two flows share."""
        return close_batches * self.n_fin + self.duplicates

    def close(self) -> None:
        """Let the window's batches go."""
        self.window = []


def _request_table(per_set, n_sets: int):
    """Per set (0: none) its requests as (method [S, R], path [S, R, 64],
    count [S])."""
    width = max(1, max(len(r) for r in per_set))
    methods = np.zeros((n_sets + 1, width), np.int32)
    paths = np.zeros((n_sets + 1, width, PATH_BYTES), np.uint8)
    count = np.zeros(n_sets + 1, np.int64)
    for s, reqs in enumerate(per_set):
        count[s] = len(reqs)
        for r, (m, p) in enumerate(reqs):
            methods[s, r] = m
            p = np.frombuffer(bytes(p), np.uint8)
            paths[s, r, :len(p)] = p
    return methods, paths, count
