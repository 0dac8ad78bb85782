"""Device-side RSS: the ring CT exchange (port of
``cilium_tpu/parallel/exchange.py``).

With ``rss_mode="device"`` rows reach the flow shards in plain arrival
order, each shard computes the flow → shard hash itself, and cross-shard
CT lookups and inserts resolve through a ring exchange over the flow axis.
The reference runs the step as one SPMD program per chip; the port's mesh
is one process (``parallel/mesh.py``), so the step is cut into phases,
each run on every shard before the next begins:

1. **pre-CT** on every shard: LB → LPM → the split policy interior
   (``kernels/classify.classify_pre_ct``), the would-be allow for a hit
   and for a new flow, and the request rows ``[L, REQ_WORDS]``: the
   post-DNAT forward CT key, tcp_flags, the meta bits and the rev-NAT id
   to record.
2. **gather** (``ring_all_gather``, n − 1 hops, each hop a ``.to()`` of
   every shard's buffer to the device of the next shard): every shard
   holds all n shards' requests, indexed by origin. Flattened
   origin-major, the gathered rows are the bucket's global row order,
   which is what keeps the insert conflicts and CT_FULL tail evictions
   bit-identical to the host-steered path (relative order within a shard
   is arrival order in both layouts).
3. **owner-side CT stage** on every shard (``ct_exchange_serve``): the
   gathered rows whose direction-normalized hash homes here, probed (K2)
   against the shard's own table and run through the same
   ``ct_update_stage`` the steered step runs.
4. **reduce-scatter** (``ring_reduce_scatter``, n − 1 hops): each owner's
   replies (est | reply | ct_full, and the batch-start rev-NAT id), masked
   to the rows it owns, ride home and are summed, a routing since every
   row has exactly one owner.
5. **compose** on every shard: the verdict, CT_FULL, rev-NAT and the
   counters from the replies.

K3 composes est/reply inside itself, and those exist only after the hop,
so this path runs the split policy core, as the reference does. u32 words
travel as int32 bit patterns.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from cilium_tpu_torch.compile.ct_layout import PROBE_DEPTH
from cilium_tpu_torch.kernels import conntrack as ctk
from cilium_tpu_torch.kernels import fused as fk
from cilium_tpu_torch.kernels.classify import (classify_pre_ct,
                                               compose_verdict,
                                               ct_update_stage,
                                               resolve_rev_nat,
                                               run_scripted,
                                               tally_by_reason_dir)
from cilium_tpu_torch.kernels.hashing import hash_words_u64, u32
from cilium_tpu_torch.utils import constants as C

#: request row layout ([L, REQ_WORDS] int32): words 0..9 = the post-DNAT
#: forward CT key, 10 = tcp_flags, 11 = meta bits (valid | allow_if_hit<<1
#: | allow_if_new<<2), 12 = the rev-NAT id to record on a fresh insert
REQ_WORDS = 13
#: reply row layout ([L, REP_WORDS] int32): word 0 = est | reply<<1 |
#: ct_full<<2, word 1 = the batch-start CT entry rev-NAT id at the hit slot
REP_WORDS = 2


def exchange_bytes(rows: int, n_shards: int) -> int:
    """Worst-case bytes the exchange materializes across the mesh for one
    ``rows``-row bucket: every shard holds the gathered request set
    [n, L, REQ] plus the travelling reply chunks [n, L, REP]."""
    return n_shards * rows * (REQ_WORDS + REP_WORDS) * 4


def flow_shard_of_keys(fwd_keys: torch.Tensor, rev_keys: torch.Tensor,
                       n_shards: int) -> torch.Tensor:
    """Direction-normalized shard index per key pair [N] int32, the device
    twin of ``parallel/mesh.flow_shard_of``. The XOR of the two hashes is
    taken on their u32 values (int64), so the modulo is unsigned: on the
    int32 bit patterns a hash >= 2^31 would give a negative or wrong shard
    for any ``n_shards`` that is not a power of two."""
    h = hash_words_u64(fwd_keys) ^ hash_words_u64(rev_keys)
    return (h % n_shards).to(torch.int32)


# --------------------------------------------------------------------------- #
# The ring primitives: explicit hops, shard i → shard i + 1
# --------------------------------------------------------------------------- #
def ring_all_gather(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One [L, W] buffer per shard (on the shard's device) → one
    [n, L, W] per shard, indexed by ORIGIN shard, after n − 1 hops. After
    t hops shard i holds the buffer that originated t positions behind it
    on the ring."""
    n = len(xs)
    outs = []
    for i, x in enumerate(xs):
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        out[i] = x
        outs.append(out)
    bufs = list(xs)
    for t in range(1, n):
        bufs = [bufs[(i - 1) % n].to(xs[i].device) for i in range(n)]
        for i in range(n):
            outs[i][(i - t) % n] = bufs[i]
    return outs


def ring_reduce_scatter(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One [n, L, W] per shard (chunk c = this shard's contribution to
    shard c's rows) → one [L, W] per shard: chunk c starts at shard c + 1,
    accumulates every shard's contribution over n − 1 hops and arrives
    home summed."""
    n = len(parts)
    accs = [parts[i][(i - 1) % n] for i in range(n)]
    for t in range(1, n):
        accs = [accs[(i - 1) % n].to(parts[i].device)
                + parts[i][(i - 1 - t) % n] for i in range(n)]
    return accs


# --------------------------------------------------------------------------- #
# Exchange buffer packing
# --------------------------------------------------------------------------- #
def pack_requests(fwd_keys, tcp_flags, valid, allow_if_hit, allow_if_new,
                  rev_nat_vals) -> torch.Tensor:
    """→ [L, REQ_WORDS] int32 (layout at the module constants)."""
    meta = (valid.to(torch.int32) | (allow_if_hit.to(torch.int32) << 1)
            | (allow_if_new.to(torch.int32) << 2))
    return torch.cat([fwd_keys.to(torch.int32),
                      tcp_flags.to(torch.int32)[:, None], meta[:, None],
                      rev_nat_vals.to(torch.int32)[:, None]], dim=-1)


def unpack_requests(req: torch.Tensor):
    meta = req[:, 11]
    return (req[:, :10], req[:, 10], (meta & 1) != 0, (meta & 2) != 0,
            (meta & 4) != 0, req[:, 12])


def pack_replies(est, reply, ct_full, entry_rnat, mine) -> torch.Tensor:
    """→ [G, REP_WORDS] int32, masked to the rows THIS shard owns so the
    homeward reduce-scatter has exactly one writer per row."""
    flags = (est.to(torch.int32) | (reply.to(torch.int32) << 1)
             | (ct_full.to(torch.int32) << 2))
    rnat = torch.where(mine, entry_rnat.to(torch.int32), 0)
    return torch.stack([flags, rnat], dim=-1)


def unpack_replies(rep: torch.Tensor):
    flags = rep[:, 0]
    return (flags & 1) != 0, (flags & 2) != 0, (flags & 4) != 0, rep[:, 1]


# --------------------------------------------------------------------------- #
# The owner-side CT stage
# --------------------------------------------------------------------------- #
def ct_exchange_serve(ct, req_flat, shard: int, n_shards: int, now,
                      probe_depth: int = PROBE_DEPTH, fused: bool = True,
                      inplace: bool = False):
    """Serve the gathered request set against shard ``shard``'s own CT:
    probe pair (K2 with ``fused``) → est/reply/new → insert-when-full →
    aggregate apply → batch-start rev-NAT read, over exactly the rows
    whose flow hash homes here, in global bucket row order. Foreign rows
    are valid-masked out; their keys can never match this shard's entries
    (flows only insert at their home), so hit sets, protected slots and
    eviction victims are those of the steered layout.

    → (rep [G, REP_WORDS] int32, new_ct, insert_fail int32 0-d,
    n_evicted int32 0-d)."""
    fwd_keys, tcp_flags, valid, allow_if_hit, allow_if_new, rev_nat_vals = \
        unpack_requests(req_flat)
    fwd_keys = fwd_keys.contiguous()
    rev_keys = ctk.reverse_key_words(fwd_keys)
    # the symmetric hash makes both orientations home on one shard, so
    # one mask serves both probes
    mine = flow_shard_of_keys(fwd_keys, rev_keys, n_shards) == shard
    valid = valid & mine

    probe = fk.ct_probe_pair_fused if fused else fk.ct_probe_pair_plain
    fwd_slot, rev_slot = probe(ct, fwd_keys, rev_keys, now, probe_depth)
    est = valid & (fwd_slot >= 0)
    reply = valid & ~est & (rev_slot >= 0)
    new = valid & ~est & ~reply
    hit = est | reply
    hit_slot = torch.where(est, fwd_slot, torch.where(reply, rev_slot, 0))
    # the origin's would-be allow for the branch the probe resolved
    allow = torch.where(hit, allow_if_hit, allow_if_new)

    proto = (u32(fwd_keys[:, 9]) >> 8).to(torch.int32)
    new_ct, ct_full, entry_rnat, n_evicted = run_scripted(
        ct_update_stage, ct, fwd_keys, proto, tcp_flags, hit, hit_slot,
        reply, new, allow, rev_nat_vals, int(now), probe_depth,
        inplace=inplace)
    rep = pack_replies(est, reply, ct_full, entry_rnat, mine)
    return rep, new_ct, ct_full.sum().to(torch.int32), n_evicted


# --------------------------------------------------------------------------- #
# The unsteered step, phased across the flow shards
# --------------------------------------------------------------------------- #
def classify_step_exchange(tensors, cts, batches, now, world_index=0, *,
                           rule_axes=None, probe_depth: int = PROBE_DEPTH,
                           v4_only: bool = False, lb_probe_depth: int = 8,
                           fused: bool = True, inplace: bool = False):
    """The device-RSS twin of ``kernels/classify.classify_step`` over every
    flow shard at once: ``tensors[i]``, ``cts[i]`` and ``batches[i]`` are
    shard i's snapshot tensors, CT shard and arrival-order rows (all on
    the shard's device), ``rule_axes[i]`` its rule axis (or None).
    → (outs, new_cts, counters), one of each per shard; the counters are
    per shard (the caller sums them over the flow axis)."""
    n = len(batches)
    rule_axes = rule_axes or [None] * n
    # 1. pre-CT on every shard
    pres, reqs = [], []
    for i in range(n):
        b, pre = classify_pre_ct(tensors[i], batches[i], world_index,
                                 v4_only=v4_only, rule_axis=rule_axes[i],
                                 lb_probe_depth=lb_probe_depth, fused=fused,
                                 split_interior=True)
        valid = pre["valid"]
        ones = torch.ones_like(valid)
        zeros = torch.zeros_like(valid)
        # the would-be allow for each probe outcome, through the one
        # compose_verdict, so the owner's insert decision cannot drift
        # from the verdict the origin composes later
        allow_if_hit = compose_verdict(
            pre["decision"], pre["enforced"], pre["cell_redirect"],
            pre["l7_fail"], ones, zeros, valid)[0]
        allow_if_new = compose_verdict(
            pre["decision"], pre["enforced"], pre["cell_redirect"],
            pre["l7_fail"], zeros, zeros, valid)[0]
        pres.append((pre, b))
        reqs.append(pack_requests(pre["fwd_keys"], b["tcp_flags"],
                                  valid, allow_if_hit, allow_if_new,
                                  pre["rev_nat"]))
    local_rows = reqs[0].shape[0]
    # 2. gather
    gathered = ring_all_gather(reqs)
    # 3. the owner-side CT stage on every shard
    reps, new_cts, served = [], [], []
    for i in range(n):
        rep, new_ct, insert_fail, n_evicted = ct_exchange_serve(
            cts[i], gathered[i].reshape(n * local_rows, REQ_WORDS), i, n,
            now, probe_depth, fused=fused, inplace=inplace)
        reps.append(rep.reshape(n, local_rows, REP_WORDS))
        new_cts.append(new_ct)
        served.append((insert_fail, n_evicted))
    # 4. reduce-scatter
    homes = ring_reduce_scatter(reps)
    # 5. compose on every shard
    outs, counters = [], []
    for i in range(n):
        pre, b = pres[i]
        valid, no_backend = pre["valid"], pre["no_backend"]
        est, reply, ct_full, entry_rnat = unpack_replies(homes[i])
        allow, reason, status, redirect = compose_verdict(
            pre["decision"], pre["enforced"], pre["cell_redirect"],
            pre["l7_fail"], est, reply, valid)
        matched_rule = torch.where(valid & pre["enforced"], pre["mrule"],
                                   -1).to(torch.int32)
        reason = torch.where(no_backend, int(C.DropReason.NO_SERVICE),
                             reason)
        allow = allow & ~ct_full
        reason = torch.where(ct_full, int(C.DropReason.CT_FULL),
                             reason).to(torch.int32)
        rnat, rnat_src, rnat_sport = resolve_rev_nat(
            tensors[i], entry_rnat, reply, b["src"], b["sport"])
        counters.append({
            "by_reason_dir": tally_by_reason_dir(reason, b["direction"],
                                                 valid | no_backend),
            # owner-side totals: each shard counts the gathered rows it
            # served; summed over the flow axis they are the steered
            # layout's totals
            "insert_fail": served[i][0],
            "ct_evicted": served[i][1],
        })
        outs.append({
            "allow": allow,
            "reason": reason,
            "status": status,
            "ct_full": ct_full,
            "remote_identity": pre["remote_identity"],
            "redirect": redirect,
            "matched_rule": matched_rule,
            "lpm_prefix": pre["lpm_prefix"],
            "ct_state_pre": status,
            "svc": pre["svc"] & valid,
            "nat_dst": b["dst"],
            "nat_dport": b["dport"].to(torch.int32),
            "rnat": rnat,
            "rnat_src": rnat_src,
            "rnat_sport": rnat_sport,
        })
    return outs, new_cts, counters
