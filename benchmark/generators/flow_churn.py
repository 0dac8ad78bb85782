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
"""

from __future__ import annotations

import ipaddress
from typing import Dict, Iterator, List

import numpy as np

#: the mix keys this generator reads
KEYS = ("direction", "local_ip", "peers", "proto", "sport", "dport", "mix")

PROTOS = {"TCP": 6, "UDP": 17}
TCP_FIN, TCP_SYN, TCP_ACK = 0x01, 0x02, 0x10
DIRECTIONS = {"egress": 0, "ingress": 1}
HTTP_METHOD_NONE = 255
PATH_BYTES = 64


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
            self.dport = self._allowed_ports(policy, pool, peer_idx, rng)
        else:
            lo, hi = mix["dport"]
            self.dport = rng.integers(lo, hi, flows).astype(np.int32)
        self.order = rng.permutation(flows)
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
        tuples = (np.repeat(self.peer.astype(np.int64), 2) << 32) \
            | (self.sports.reshape(-1).astype(np.int64) << 16) \
            | np.repeat(self.dport, 2).astype(np.int64)
        self.duplicates = 2 * flows - np.unique(tuples).shape[0]
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

    def _allowed_ports(self, policy, pool, peer_idx, rng):
        ep_id = policy.endpoints[0]["ep_id"]
        idents, _which, _plen = policy.lookup(pool)
        ports = []
        for ident in idents:
            got = [p for proto, p in policy.allowed_ports(
                ep_id, self.direction, int(ident)) if proto == self.proto]
            if not got:
                raise ValueError(f"peer identity {ident} has no allowed "
                                 f"port")
            ports.append(got)
        width = max(len(p) for p in ports)
        table = np.zeros((len(pool), width), np.int32)
        count = np.zeros(len(pool), np.int64)
        for i, p in enumerate(ports):
            table[i, :len(p)] = p
            count[i] = len(p)
        pick = (rng.random(len(peer_idx)) * count[peer_idx]).astype(np.int64)
        return table[peer_idx, pick]

    def rows(self, flows: np.ndarray, flags, sport: np.ndarray
             ) -> Dict[str, np.ndarray]:
        """A batch of the rows of ``flows`` (indices into the table) with
        TCP ``flags`` (one, or one a row) and source ports ``sport``; each
        batch has arrays of its own but for the shared columns, and none is
        writeable."""
        n = flows.shape[0]
        peer = self.peer[flows]
        src, dst = (peer, self.local) if self.direction == 1 \
            else (self.local, peer)
        b = {"src": np.zeros((n, 4), np.uint32),
             "dst": np.zeros((n, 4), np.uint32)}
        b["src"][:, 2] = b["dst"][:, 2] = 0xFFFF
        b["src"][:, 3], b["dst"][:, 3] = src, dst
        b["sport"] = sport.astype(np.int32)
        b["dport"] = self.dport[flows]
        b["tcp_flags"] = np.broadcast_to(np.asarray(flags, np.int32),
                                         (n,)).copy()
        for k, v in b.items():
            v.flags.writeable = False
        if n == self.batch:
            b.update(self._const)
        else:
            b.update({k: np.array(v[:1]).repeat(n, 0)
                      for k, v in self._const.items()})
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
            out.append(self.rows(flows[perm], flags[perm], sport[perm]))
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
