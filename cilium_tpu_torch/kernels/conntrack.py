"""Device conntrack: batched probe, deterministic parallel insert, aggregate
update, epoch sweep (port of ``cilium_tpu/kernels/conntrack.py``; the
module docstring there states the snapshot semantics and the
insert-when-full contract this file reproduces bit for bit).

Torch has no drop mode for out-of-range scatters, so every scatter that the
reference aims at the sentinel slot ``cap`` goes into a ``cap + 1`` buffer
whose last element is the sink and is sliced off. The claim is a
``scatter_reduce("amin")`` of packet indices in int64 (lowest index wins),
the flag OR a per-bit ``amax``, the packet counters an ``index_add_``.
Nothing here waits on the device: no value is read back to the host, and
flags are set with ``index_fill_`` (an indexed assignment of a Python
scalar copies the scalar to the device and waits for it). The step only
enqueues work, so a caller can stage the next batch while the device runs
this one.
Writes into the [cap, 10] key table and the created column go through
every row's target slot with the value its slot's claim decides (the
winner's key, or the slot's own), so rows that share a slot write the same
bytes and no index leaves the table (``_write_winners``).

``inplace=True`` writes the new keys and created stamps straight into the
table it was given. The eviction round still sees the batch-start state it
needs: it reads ``expiry`` and ``flags`` (never written by the insert) and
the key's proto word only at slots not claimed in this batch (the
candidate mask excludes every claimed slot, and only claimed slots were
written).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from cilium_tpu_torch.compile.ct_layout import PROBE_DEPTH
from cilium_tpu_torch.kernels.hashing import hash_words_u64, i32, u32
from cilium_tpu_torch.kernels.records import ct_key_words
from cilium_tpu_torch.utils import constants as C

_M32 = 0xFFFFFFFF


def _now(now) -> int:
    """The batch clock as a u32 Python int (accepts an int or a 0-d
    tensor)."""
    return int(now) & _M32


def _bits(v: int) -> int:
    """u32 value → the int32 holding its bit pattern."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def reverse_key_words(fwd_keys: torch.Tensor) -> torch.Tensor:
    """[N,10] forward CT key words → reverse orientation by word ops: the
    address blocks swap, the port word rotates by 16 and the direction byte
    flips (0 ↔ 1)."""
    w8 = u32(fwd_keys[:, 8])
    w9 = u32(fwd_keys[:, 9])
    rot = ((w8 << 16) & 0xFFFFFFFF) | (w8 >> 16)
    dirw = (w9 & 0xFFFFFF00) | ((1 - (w9 & 0xFF)) & 0xFFFFFFFF)
    return torch.cat([fwd_keys[:, 4:8], fwd_keys[:, 0:4],
                      i32(rot)[:, None], i32(dirw)[:, None]], dim=-1)


def ct_key_words_pair(batch: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (fwd_keys, rev_keys), both [N,10] int32 bit patterns."""
    fwd = ct_key_words(batch, reverse=False)
    return fwd, reverse_key_words(fwd)


def key_home(keys: torch.Tensor, cap: int, shards: int = 1) -> torch.Tensor:
    """Each key's home slot [N] int64 in its own table of a ``cap``-slot
    table split into ``shards`` equal power-of-two tables (slot-range
    order; see ``probe_window``), as an offset into that table."""
    return hash_words_u64(keys) & (cap // shards - 1)


def ct_home_pair(fwd_keys: torch.Tensor, rev_keys: torch.Tensor, cap: int,
                 shards: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both orientations' home slots (``key_home``) from ONE hash over the
    two key blocks: the step hashes its CT keys once, and the forward
    probe, the reverse probe and the insert read these."""
    home = key_home(torch.cat([fwd_keys, rev_keys]), cap, shards)
    n = fwd_keys.shape[0]
    return home[:n], home[n:]


def window_first(n: int, cap: int, shards: int,
                 device: torch.device) -> Optional[torch.Tensor]:
    """The first slot [n] int64 of each row's table when ``n`` shard-major
    rows (row i belongs to table ``i // (n // shards)``) probe a
    ``cap``-slot table of ``shards`` equal tables; None for one table,
    which starts at slot 0."""
    if shards == 1:
        return None
    per = max(n // shards, 1)
    return torch.arange(n, dtype=torch.int64, device=device) // per \
        * (cap // shards)


def probe_window(home: torch.Tensor, r: int, mask: int,
                 first: Optional[torch.Tensor]) -> torch.Tensor:
    """The [N] int64 slot of every key's r-th probe: ``home`` (``key_home``)
    plus r, wrapped by ``mask`` (its table's slots - 1), in the table
    that starts at ``first`` (``window_first``). With several tables each
    key walks its own table's window, exactly as it would in that table
    alone."""
    s = (home + r) & mask
    if first is None:
        return s
    return first + s


def ct_probe_core(tab_keys: torch.Tensor, expiry: torch.Tensor,
                  keys: torch.Tensor, now: int,
                  probe_depth: int = PROBE_DEPTH, shards: int = 1,
                  home: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tab_keys [cap,10], expiry [cap] (int32 bit patterns) → each key's
    first live matching slot [N] int32 (-1 = miss). Run once per
    orientation, this is the plain version of kernel K2
    (``fused.ct_probe_pair_fused``). ``shards``: see ``probe_window``;
    ``home``: the keys' ``key_home``, hashed here when not given."""
    now = now & 0xFFFFFFFF
    cap = expiry.shape[0]
    if home is None:
        home = key_home(keys, cap, shards)
    mask = cap // shards - 1
    first = window_first(keys.shape[0], cap, shards, keys.device)
    found = torch.full((keys.shape[0],), -1, dtype=torch.int64,
                       device=keys.device)
    for i in range(probe_depth):
        s = probe_window(home, i, mask, first)
        live = u32(expiry[s]) > now
        eq = (tab_keys[s] == keys).all(dim=-1) & live
        found = torch.where((found < 0) & eq, s, found)
    return found.to(torch.int32)


def ct_probe(ct: Dict[str, torch.Tensor], keys: torch.Tensor, now: int,
             probe_depth: int = PROBE_DEPTH) -> torch.Tensor:
    """Find each key's live slot. → slot [N] int32 (-1 = miss)."""
    return ct_probe_core(ct["keys"], ct["expiry"], keys, now, probe_depth)


def _flag_delta(proto: torch.Tensor, tcp_flags: torch.Tensor,
                is_reply: torch.Tensor) -> torch.Tensor:
    """Per-packet flag bits this packet ORs into its entry (int64)."""
    is_tcp = proto == C.PROTO_TCP
    fin_rst = (tcp_flags & (C.TCP_FIN | C.TCP_RST)) != 0
    rst = (tcp_flags & C.TCP_RST) != 0
    non_syn = (tcp_flags & C.TCP_SYN) == 0
    close_self = torch.where(is_reply, C.CT_FLAG_RX_CLOSING,
                             C.CT_FLAG_TX_CLOSING)
    delta = torch.where(fin_rst, close_self, 0)
    delta = torch.where(rst, delta | C.CT_FLAG_TX_CLOSING
                        | C.CT_FLAG_RX_CLOSING, delta)
    delta = torch.where(non_syn, delta | C.CT_FLAG_SEEN_NON_SYN, delta)
    return torch.where(is_tcp, delta, 0).to(torch.int64)


def _lifetime(proto: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Entry lifetime in seconds from its proto and flags (int64)."""
    is_tcp = proto == C.PROTO_TCP
    closing = (flags & (C.CT_FLAG_TX_CLOSING | C.CT_FLAG_RX_CLOSING)) != 0
    non_syn = (flags & C.CT_FLAG_SEEN_NON_SYN) != 0
    tcp_life = torch.where(closing, C.CT_LIFETIME_CLOSE,
                           torch.where(non_syn, C.CT_LIFETIME_TCP,
                                       C.CT_LIFETIME_SYN))
    return torch.where(is_tcp, tcp_life, C.CT_LIFETIME_NONTCP).to(torch.int64)


def ct_evictable(slot_proto: torch.Tensor, flags: torch.Tensor
                 ) -> torch.Tensor:
    """Which live entries an exhausted insert may tail-evict: everything
    except established TCP (SEEN_NON_SYN and not closing)."""
    is_tcp = slot_proto == C.PROTO_TCP
    non_syn = (flags & C.CT_FLAG_SEEN_NON_SYN) != 0
    closing = (flags & (C.CT_FLAG_TX_CLOSING | C.CT_FLAG_RX_CLOSING)) != 0
    return ~(is_tcp & non_syn & ~closing)


def _claim(target: torch.Tensor, idx: torch.Tensor, cap: int,
           n: int) -> torch.Tensor:
    """Lowest packet index per slot: [cap + 1] int64, ``n`` where no
    packet aimed (slot ``cap`` is the sink of non-attempts)."""
    claim = torch.full((cap + 1,), n, dtype=torch.int64, device=idx.device)
    return claim.scatter_reduce_(0, target, idx, "amin")


def _write_winners(keys_arr: torch.Tensor, created_arr: torch.Tensor,
                   slots: torch.Tensor, keys: torch.Tensor,
                   claim: torch.Tensor, now_bits: int) -> None:
    """Write each claimed slot's winning key and created stamp without a
    host read. Every row writes its target ``slots`` [N] (all in
    ``[0, cap)``): the claim's winner (``claim[slot] < N``, the lowest
    index that attempted the slot) gets its key and ``now``; an unclaimed
    slot gets its own current bytes back. So every row aimed at one slot
    writes the same value, and the scatter is deterministic."""
    n = keys.shape[0]
    if n == 0:
        return
    c = claim[slots]
    won = c < n
    w = torch.where(won, c, 0)
    keys_arr[slots] = torch.where(won[:, None], keys[w], keys_arr[slots])
    created_arr[slots] = torch.where(won, now_bits, created_arr[slots])


def _adopt(pending: torch.Tensor, claimed: torch.Tensor,
           keys_arr: torch.Tensor, keys: torch.Tensor, s: torch.Tensor,
           slot_of: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    adopted = pending & claimed[s] & (keys_arr[s] == keys).all(dim=-1)
    return torch.where(adopted, s, slot_of), pending & ~adopted


def ct_insert_new(ct: Dict[str, torch.Tensor], keys: torch.Tensor,
                  want_insert: torch.Tensor, now: int,
                  probe_depth: int = PROBE_DEPTH, evict: bool = False,
                  protected: Optional[torch.Tensor] = None,
                  inplace: bool = False, shards: int = 1,
                  home: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deterministic parallel insert of new flows.

    → (new_keys, new_created, zero_mask [cap] bool, slot_of [N] int32,
    fail [N] bool, n_evicted int32 0-d tensor), exactly the reference's
    tuple. ``evict`` arms the tail-eviction round; ``protected`` [cap]
    bool marks slots the batch probe-hit. ``inplace`` writes the new keys
    and created stamps into ``ct`` itself (see the module docstring).
    ``shards`` > 1 inserts into a shard-major table (``probe_window``):
    the windows of two tables never share a slot, so every claim, victim
    and adoption is the one each table's own insert makes, the lowest
    index in a table being its lowest row, and ``n_evicted`` is their
    sum. ``home``: the keys' ``key_home`` (the step's forward half of
    ``ct_home_pair``), hashed here when not given."""
    now = now & 0xFFFFFFFF
    now_bits = _bits(now)
    dev = keys.device
    cap = ct["expiry"].shape[0]
    n = keys.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    if home is None:
        home = key_home(keys, cap, shards)
    mask = cap // shards - 1
    first = window_first(n, cap, shards, dev)

    keys_arr = ct["keys"] if inplace else ct["keys"].clone()
    created_arr = ct["created"] if inplace else ct["created"].clone()
    claimed = torch.zeros((cap + 1,), dtype=torch.bool, device=dev)
    slot_of = torch.full((n,), -1, dtype=torch.int64, device=dev)
    pending = want_insert.to(torch.bool)
    sink = torch.full_like(idx, cap)

    for r in range(probe_depth):
        if r > 0:
            # adoption: my previous round's target may now hold my key,
            # inserted by a lower-indexed duplicate of my flow
            sprev = probe_window(home, r - 1, mask, first)
            slot_of, pending = _adopt(pending, claimed, keys_arr, keys,
                                      sprev, slot_of)
        s = probe_window(home, r, mask, first)
        free = (u32(ct["expiry"][s]) <= now) & ~claimed[s]
        attempt = pending & free
        claim = _claim(torch.where(attempt, s, sink), idx, cap, n)
        winner = attempt & (claim[s] == idx)
        _write_winners(keys_arr, created_arr, s, keys, claim, now_bits)
        claimed.index_fill_(0, torch.where(winner, s, sink), True)
        slot_of = torch.where(winner, s, slot_of)
        pending = pending & ~winner

    # final adoption sweep: stragglers whose duplicate won at a slot they
    # already passed
    for r in range(probe_depth):
        s = probe_window(home, r, mask, first)
        slot_of, pending = _adopt(pending, claimed, keys_arr, keys, s,
                                  slot_of)

    n_evicted = torch.zeros((), dtype=torch.int32, device=dev)
    if evict:
        # tail-eviction round (batch-start state): victim = the window slot
        # with the smallest expiry among live, evictable, unclaimed,
        # unprotected entries; ties to the earliest probe offset (strict
        # <), contested victims to the lowest packet index
        best_s = torch.full((n,), -1, dtype=torch.int64, device=dev)
        best_e = torch.full((n,), 0xFFFFFFFF, dtype=torch.int64, device=dev)
        for r in range(probe_depth):
            s = probe_window(home, r, mask, first)
            e = u32(ct["expiry"][s])
            slot_proto = u32(ct["keys"][s, 9]) >> 8
            cand = (pending & (e > now)
                    & ct_evictable(slot_proto, ct["flags"][s])
                    & ~claimed[s])
            if protected is not None:
                cand = cand & ~protected[s]
            better = cand & ((best_s < 0) | (e < best_e))
            best_s = torch.where(better, s, best_s)
            best_e = torch.where(better, e, best_e)
        attempt = pending & (best_s >= 0)
        claim = _claim(torch.where(attempt, best_s, sink), idx, cap, n)
        bs = torch.where(best_s >= 0, best_s, 0)
        winner = attempt & (claim[bs] == idx)
        _write_winners(keys_arr, created_arr, bs, keys, claim, now_bits)
        claimed.index_fill_(0, torch.where(winner, best_s, sink), True)
        slot_of = torch.where(winner, best_s, slot_of)
        pending = pending & ~winner
        n_evicted = winner.sum().to(torch.int32)
        # adoption: duplicates of an evict-winner's key ride its new slot
        for r in range(probe_depth):
            s = probe_window(home, r, mask, first)
            slot_of, pending = _adopt(pending, claimed, keys_arr, keys, s,
                                      slot_of)

    # every claimed slot is freshly created: its value arrays reset
    zero_mask = claimed[:cap]
    return (keys_arr, created_arr, zero_mask, slot_of.to(torch.int32),
            pending, n_evicted)


def _count(rows: torch.Tensor, slot: torch.Tensor, sink: torch.Tensor,
           cap: int) -> torch.Tensor:
    """How many of ``rows`` aim at each slot: [cap] int64."""
    add = torch.zeros((cap + 1,), dtype=torch.int64, device=slot.device)
    add.index_add_(0, torch.where(rows, slot, sink), torch.ones_like(slot))
    return add[:cap]


def ct_apply(ct: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
             slot: torch.Tensor, is_reply: torch.Tensor,
             contrib: torch.Tensor, now: int,
             new_keys: Optional[torch.Tensor] = None,
             new_created: Optional[torch.Tensor] = None,
             zero_mask: Optional[torch.Tensor] = None,
             rev_nat_vals: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
    """Aggregate all allowed packets' effects into the table (snapshot
    semantics). ``slot`` [N] (-1 = none), ``contrib`` [N] bool,
    ``rev_nat_vals`` [N] int32 recorded for freshly created entries only.
    → the new CT dict (``keys``/``created`` are ``new_keys``/``new_created``
    when given; every other array is a new tensor)."""
    now = now & 0xFFFFFFFF
    cap = ct["expiry"].shape[0]
    dev = slot.device
    keys_arr = new_keys if new_keys is not None else ct["keys"]
    created_arr = new_created if new_created is not None else ct["created"]
    flags, fwd, rev, rnat = (ct["flags"], ct["pkts_fwd"], ct["pkts_rev"],
                             ct["rev_nat"])
    slot = slot.to(torch.int64)
    sink = torch.full_like(slot, cap)
    if zero_mask is not None:
        flags = torch.where(zero_mask, 0, flags)
        fwd = torch.where(zero_mask, 0, fwd)
        rev = torch.where(zero_mask, 0, rev)
        rnat = torch.where(zero_mask, 0, rnat)
        if rev_nat_vals is not None:
            # create-time semantics: only freshly created entries record a
            # rev-NAT id (duplicates of one flow carry the same value)
            fresh = contrib & (slot >= 0) \
                & zero_mask[torch.where(slot >= 0, slot, 0)]
            buf = torch.zeros((cap + 1,), dtype=torch.int64, device=dev)
            buf.scatter_reduce_(0, torch.where(fresh, slot, sink),
                                u32(rev_nat_vals), "amax")
            rnat = i32(torch.maximum(u32(rnat), buf[:cap]))

    scat = torch.where(contrib, slot, sink)
    delta = _flag_delta(batch["proto"], batch["tcp_flags"], is_reply)
    # OR-accumulate flag bits: scatter-max each bit plane separately (a max
    # on the full word would clobber unrelated bits), then recombine
    acc = torch.zeros((cap,), dtype=torch.int64, device=dev)
    flags64 = u32(flags)
    for bit in (C.CT_FLAG_SEEN_NON_SYN, C.CT_FLAG_TX_CLOSING,
                C.CT_FLAG_RX_CLOSING):
        plane = torch.zeros((cap + 1,), dtype=torch.int64, device=dev)
        plane[:cap] = flags64 & bit
        plane.scatter_reduce_(0, scat, delta & bit, "amax")
        acc = acc | plane[:cap]
    flags = i32(acc)

    fwd = i32(u32(fwd) + _count(contrib & ~is_reply, slot, sink, cap))
    rev = i32(u32(rev) + _count(contrib & is_reply, slot, sink, cap))

    touched = torch.zeros((cap + 1,), dtype=torch.bool, device=dev)
    touched.index_fill_(0, scat, True)
    slot_proto = u32(keys_arr[:, 9]) >> 8
    new_expiry = i32(now + _lifetime(slot_proto, acc))
    expiry = torch.where(touched[:cap], new_expiry, ct["expiry"])

    return {
        "keys": keys_arr,
        "expiry": expiry,
        "created": created_arr,
        "flags": flags,
        "pkts_fwd": fwd,
        "pkts_rev": rev,
        "rev_nat": rnat,
    }


def _sweep_mask(ct, dead, inplace: bool = False):
    """Clear every entry under ``dead`` [cap] bool → new CT dict (``ct``
    itself, cleared in place, with ``inplace``)."""
    if inplace:
        for k, v in ct.items():
            v.masked_fill_(dead[:, None] if v.dim() == 2 else dead, 0)
        return ct
    new_ct = {k: torch.where(dead, 0, v) for k, v in ct.items()
              if k != "keys"}
    new_ct["keys"] = torch.where(dead[:, None], 0, ct["keys"])
    return {k: new_ct[k] for k in ct}


def ct_sweep(ct, now, inplace: bool = False):
    """Epoch GC: clear expired entries. → (new_ct, n_reclaimed)."""
    e = u32(ct["expiry"])
    dead = (e <= _now(now)) & (e != 0)
    return _sweep_mask(ct, dead, inplace), dead.sum().to(torch.int32)


def ct_sweep_chunk(ct, now, start, chunk_rows: int, count_now=None,
                   inplace: bool = False, base: int = 0, total=None):
    """One chunk of the epoch sweep: clear expired entries whose slot lies
    in ``[start, start + chunk_rows)`` (mod cap) and count the whole
    table's live occupancy against ``count_now`` (default ``now``).
    → (new_ct, n_reclaimed, n_live), the counts as int32 0-d tensors
    holding the reference's uint32 values; ``inplace`` clears ``ct``
    itself and returns it. On a flow-sharded mesh ``ct`` is one shard of
    a ``total``-slot table whose slot 0 is global slot ``base``: the
    window is then the global one, and the counts this shard's."""
    cap = ct["expiry"].shape[0]
    total = cap if total is None else int(total)
    idx = torch.arange(base, base + cap, dtype=torch.int64,
                       device=ct["expiry"].device)
    # the reference's u32 difference, wrapped before the modulo (which
    # matters where ``total`` is not a power of two)
    off = ((idx - (int(start) & _M32)) & _M32) % total
    in_win = off < min(chunk_rows, total)
    e = u32(ct["expiry"])
    dead = in_win & (e <= _now(now)) & (e != 0)
    live = (e > _now(now if count_now is None else count_now)).sum()
    return (_sweep_mask(ct, dead, inplace), dead.sum().to(torch.int32),
            live.to(torch.int32))
