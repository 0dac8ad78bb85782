"""One batch classified as the datapath's batch step must classify it, in
numpy, from a conntrack table as of the batch's start.

Per row: the remote address (the destination on egress, the source on
ingress) is looked up in the ipcache by longest prefix (a v4 row's address
in its last word, a v6 row's in all four); the row's forward and reverse
conntrack keys (the full addresses) are probed in the table (a slot matches
while its expiry lies after ``now``); a row whose forward key is live is
ESTABLISHED, else one whose reverse key is live is a REPLY, else it is NEW.
A tracked row is allowed without the L3/L4 policy; a NEW row is allowed
where its direction is not enforced, or where the policy allows its remote
identity on its protocol and port, else dropped with reason POLICY. Where
the policy puts the row's identity, protocol and port under an L7 rule set,
the row is redirected (``redirect``), and a row that carries a request (a
method or a path byte) that no rule of the set matches is dropped with
reason POLICY_L7, tracked or not; a row that carries none (a handshake) is
not matched. Conntrack keeps no L7 state: every row of a flow is matched
against the set as the policy stands.

The table's changes, applied as one aggregate after every row has seen the
batch-start table:
- every allowed NEW row's forward key claims a slot in its probe window of
  ``PROBE_DEPTH`` slots from its hash: round r offers each pending key its
  r-th slot where that slot is free (its expiry is not after ``now``) and
  unclaimed, the lowest row index winning a contested slot; a pending key
  whose own key a lower row already placed in a slot it probed adopts that
  slot. A key that finds no free slot evicts the live entry with the
  smallest expiry in its window that is not established TCP and that no
  row of the batch hit (ties to the earlier probe), the lowest row winning;
  a key still without a slot fails closed: its row is dropped CT_FULL;
- a claimed slot starts afresh (its flags, packet counts and rev-NAT id
  zero, its ``created`` ``now``); every allowed row ORs its flag bits into
  its entry (TCP only: FIN or RST closes its side, RST both; any packet
  without SYN marks the entry as having seen one), counts itself forward
  or reverse, and the entry's expiry becomes ``now`` plus the lifetime its
  flags give (closing 10 s, established TCP 21,600 s, else 60 s).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from . import constants as C
from .hashing import murmur3_words
from .policy import Policy, endpoint_of_slot


def key_words(batch: Dict[str, np.ndarray], reverse: bool = False
              ) -> np.ndarray:
    """[N, 10] uint32: src[4], dst[4], sport << 16 | dport,
    proto << 8 | direction (reversed: the reply's tuple)."""
    src, dst = batch["src"], batch["dst"]
    sport, dport = batch["sport"], batch["dport"]
    d = batch["direction"]
    if reverse:
        src, dst, sport, dport, d = dst, src, dport, sport, 1 - d
    u = np.uint32
    return np.concatenate([
        src.astype(u), dst.astype(u),
        ((sport.astype(u) << u(16)) | dport.astype(u))[:, None],
        ((batch["proto"].astype(u) << u(8)) | d.astype(u))[:, None]], 1)


def probe(ct: Dict[str, np.ndarray], keys: np.ndarray, now: int
          ) -> np.ndarray:
    """Each key's first live matching slot in its window, -1 if none."""
    cap = ct["expiry"].shape[0]
    home = murmur3_words(keys).astype(np.int64) & (cap - 1)
    found = np.full(keys.shape[0], -1, np.int64)
    for r in range(C.PROBE_DEPTH):
        s = (home + r) & (cap - 1)
        hit = (found < 0) & (ct["expiry"][s] > np.uint32(now)) \
            & (ct["keys"][s] == keys).all(1)
        found[hit] = s[hit]
    return found


def flag_delta(proto, tcp_flags, is_reply):
    tcp = proto == C.PROTO_TCP
    closing = (tcp_flags & (C.TCP_FIN | C.TCP_RST)) != 0
    rst = (tcp_flags & C.TCP_RST) != 0
    side = np.where(is_reply, C.CT_FLAG_RX_CLOSING, C.CT_FLAG_TX_CLOSING)
    delta = np.where(closing, side, 0)
    delta |= np.where(rst, C.CT_FLAG_RX_CLOSING | C.CT_FLAG_TX_CLOSING, 0)
    delta |= np.where((tcp_flags & C.TCP_SYN) == 0, C.CT_FLAG_SEEN_NON_SYN,
                      0)
    return np.where(tcp, delta, 0).astype(np.uint32)


def lifetime(proto, flags):
    closing = (flags & (C.CT_FLAG_TX_CLOSING | C.CT_FLAG_RX_CLOSING)) != 0
    seen = (flags & C.CT_FLAG_SEEN_NON_SYN) != 0
    tcp = np.where(closing, C.CT_LIFETIME_CLOSE,
                   np.where(seen, C.CT_LIFETIME_TCP, C.CT_LIFETIME_SYN))
    return np.where(proto == C.PROTO_TCP, tcp,
                    C.CT_LIFETIME_NONTCP).astype(np.uint32)


def _evictable(proto, flags):
    """Everything but established TCP (seen a non-SYN, not closing)."""
    est = (proto == C.PROTO_TCP) & ((flags & C.CT_FLAG_SEEN_NON_SYN) != 0) \
        & ((flags & (C.CT_FLAG_TX_CLOSING | C.CT_FLAG_RX_CLOSING)) == 0)
    return ~est


def _lowest(target: np.ndarray, rows: np.ndarray, size: int, n: int):
    """The lowest row index aiming at each slot ([size + 1], ``n`` where
    none aims)."""
    claim = np.full(size + 1, n, np.int64)
    np.minimum.at(claim, target, rows)
    return claim


def insert(ct, keys, want, protected, now):
    """The claims of the allowed NEW rows → (slot [N] (-1 none), claimed
    [cap] bool, failed [N] bool, evicted count); writes the winners' keys
    and ``created`` into ``ct``."""
    cap = ct["expiry"].shape[0]
    n = keys.shape[0]
    idx = np.arange(n, dtype=np.int64)
    home = murmur3_words(keys).astype(np.int64) & (cap - 1)
    claimed = np.zeros(cap + 1, bool)
    slot_of = np.full(n, -1, np.int64)
    pending = want.copy()
    sink = np.full(n, cap, np.int64)

    def window(r):
        return (home + r) & (cap - 1)

    def adopt(s):
        nonlocal pending
        got = pending & claimed[s] & (ct["keys"][s] == keys).all(1)
        slot_of[got] = s[got]
        pending = pending & ~got

    def win(target, attempt):
        nonlocal pending
        claim = _lowest(np.where(attempt, target, sink), idx, cap, n)
        winner = attempt & (claim[target] == idx)
        ws = target[winner]
        ct["keys"][ws] = keys[winner]
        ct["created"][ws] = np.uint32(now)
        claimed[ws] = True
        slot_of[winner] = ws
        pending = pending & ~winner
        return winner

    for r in range(C.PROBE_DEPTH):
        if r:
            adopt(window(r - 1))
        s = window(r)
        win(s, pending & (ct["expiry"][s] <= np.uint32(now)) & ~claimed[s])
    for r in range(C.PROBE_DEPTH):
        adopt(window(r))
    best_s = np.full(n, -1, np.int64)
    best_e = np.full(n, 1 << 32, np.int64)
    for r in range(C.PROBE_DEPTH):
        s = window(r)
        e = ct["expiry"][s].astype(np.int64)
        cand = pending & (e > now) & ~claimed[s] & ~protected[s] \
            & _evictable(ct["keys"][s, 9] >> np.uint32(8), ct["flags"][s])
        better = cand & ((best_s < 0) | (e < best_e))
        best_s = np.where(better, s, best_s)
        best_e = np.where(better, e, best_e)
    evicted = win(np.where(best_s >= 0, best_s, 0), pending & (best_s >= 0))
    for r in range(C.PROBE_DEPTH):
        adopt(window(r))
    return slot_of, claimed[:cap], pending, int(evicted.sum())


def classify(policy: Policy, batch: Dict[str, np.ndarray], now: int,
             ct: Dict[str, np.ndarray], stateless: bool = False):
    """→ (out columns, the table after the batch, counters). ``ct`` is the
    batch-start table (uint32 arrays), left as it is. ``stateless`` is the
    control: every row is taken as NEW and the table is left unread (the
    conntrack guarantee broken)."""
    now = int(now) & 0xFFFFFFFF
    n = batch["valid"].shape[0]
    valid = batch["valid"].astype(bool)
    d = batch["direction"].astype(np.int64)
    proto = batch["proto"].astype(np.int64)
    ident, which, plen = remote_identity(policy, batch)

    fwd = key_words(batch)
    if stateless:
        fwd_slot = rev_slot = np.full(n, -1, np.int64)
    else:
        fwd_slot, rev_slot = probe(ct, fwd, now), \
            probe(ct, key_words(batch, reverse=True), now)
    est = valid & (fwd_slot >= 0)
    reply = valid & ~est & (rev_slot >= 0)
    new = valid & ~est & ~reply
    status = np.where(est, C.ESTABLISHED, np.where(reply, C.REPLY, C.NEW))

    enforced, permitted, l7_set = policy_of_rows(policy, batch, ident)
    tokens = (batch["http_method"] != C.HTTP_METHOD_NONE) \
        | batch["http_path"].any(1)
    l7_fail = (l7_set > 0) & tokens & ~policy.l7_match(
        l7_set, batch["http_method"], batch["http_path"])
    allow = valid & (est | reply | ~enforced | permitted) & ~l7_fail
    reason = np.where(l7_fail, C.POLICY_L7,
                      np.where(allow | ~valid, C.OK, C.POLICY))

    new_ct = {k: v.copy() for k, v in ct.items()}
    hit = est | reply
    hit_slot = np.where(est, fwd_slot, np.where(reply, rev_slot, 0))
    cap = ct["expiry"].shape[0]
    protected = np.zeros(cap + 1, bool)
    protected[hit_slot[hit]] = True
    slot_new, fresh, failed, evicted = insert(
        new_ct, fwd, new & allow, protected, now)
    allow &= ~failed
    reason = np.where(failed, C.CT_FULL, reason)

    for k in ("flags", "pkts_fwd", "pkts_rev", "rev_nat"):
        new_ct[k][fresh] = 0
    slot = np.where(hit, hit_slot, slot_new)
    contrib = allow & (hit | (slot_new >= 0))
    s = slot[contrib]
    delta = flag_delta(proto[contrib], batch["tcp_flags"][contrib],
                       reply[contrib])
    np.bitwise_or.at(new_ct["flags"], s, delta)
    np.add.at(new_ct["pkts_fwd"], slot[contrib & ~reply], np.uint32(1))
    np.add.at(new_ct["pkts_rev"], slot[contrib & reply], np.uint32(1))
    touched = np.unique(s)
    with np.errstate(over="ignore"):
        new_ct["expiry"][touched] = np.uint32(now) + lifetime(
            new_ct["keys"][touched, 9] >> np.uint32(8),
            new_ct["flags"][touched])

    counted = valid
    by_reason = np.zeros(C.REASON_BINS * 2, np.int64)
    np.add.at(by_reason, reason[counted] * 2 + d[counted], 1)
    counters = {"by_reason_dir": by_reason,
                "insert_fail": int(failed.sum()), "ct_evicted": evicted}
    out = {"allow": allow, "reason": reason, "status": np.where(
        valid, status, 0), "ct_full": failed,
        "remote_identity": np.where(valid, ident, 0),
        "enforced": valid & enforced, "policy_allowed": permitted,
        "redirect": l7_set > 0, "l7_set": l7_set,
        "lpm_which": which, "lpm_plen": plen}
    return out, new_ct, counters


def remote_identity(policy: Policy, batch: Dict[str, np.ndarray]):
    """Each row's remote address looked up: → (identity, prefix index,
    prefix length), as ``Policy.lookup_rows``."""
    egress = (batch["direction"] == C.DIR_EGRESS)[:, None]
    return policy.lookup_rows(np.where(egress, batch["dst"], batch["src"]),
                              batch["is_v6"])


def policy_of_rows(policy: Policy, batch: Dict[str, np.ndarray],
                   ident: np.ndarray):
    """→ (enforced [N], allowed by the L3/L4 policy [N], L7 rule set [N],
    0 where none), for the valid rows of enforced directions (False and 0
    elsewhere)."""
    n = batch["valid"].shape[0]
    valid = batch["valid"].astype(bool)
    d = batch["direction"].astype(np.int64)
    enforced = np.zeros(n, bool)
    permitted = np.zeros(n, bool)
    l7_set = np.zeros(n, np.int64)
    for slot in np.unique(batch["ep_slot"][valid]):
        ep = endpoint_of_slot(policy, int(slot))
        for direction in (C.DIR_EGRESS, C.DIR_INGRESS):
            rows = valid & (batch["ep_slot"] == slot) & (d == direction)
            if ep is None or not rows.any():
                continue
            if policy.enforced[(ep["ep_id"], direction)]:
                enforced[rows] = True
                permitted[rows], l7_set[rows] = policy.verdict(
                    ep["ep_id"], direction, ident[rows],
                    batch["proto"][rows].astype(np.int64),
                    batch["dport"][rows].astype(np.int64))
    return enforced, permitted, l7_set
