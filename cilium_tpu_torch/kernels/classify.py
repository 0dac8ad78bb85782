"""The classify step — one call per batch (port of
``cilium_tpu/kernels/classify.py``).

Branch-free like the reference: every packet takes every path and masks
select. Stages, in order: service LB + DNAT → ipcache LPM walk with prefix
provenance → CT key pair → forward and reverse CT probe → policy ladder,
L7 token match and verdict composition → CT insert-when-full, aggregate
apply and the batch-start rev-NAT read → rev-NAT resolution → per-reason ×
direction counters.

``fused=True`` (the default) runs the LPM walk, the probe pair and the
policy/L7/verdict interior through the wrappers of ``kernels/fused.py``:
on CUDA tensors each launches its hand-written kernel, on CPU tensors each
runs its plain torch version. ``fused=False`` runs the plain versions
directly, which is how the tests and ``chip_smoke.py`` hold the kernel
path against the plain path on the card.

``inplace=True`` (``make_classify_fn(donate_ct=True)``, the default there)
updates the CT tensors it was given instead of allocating a new table; the
batch-start reads the reference makes (the rev-NAT read, the eviction
round's view of the table) happen before any write they could see.
"""

from __future__ import annotations

import numpy as np
import torch

from cilium_tpu_torch.compile.ct_layout import PROBE_DEPTH
from cilium_tpu_torch.kernels import conntrack as ctk
from cilium_tpu_torch.kernels import fused as fk
from cilium_tpu_torch.kernels.hashing import i32
from cilium_tpu_torch.kernels.l7 import l7_match_core
from cilium_tpu_torch.kernels.lb import lb_step
from cilium_tpu_torch.kernels.lpm import lpm_walk_prov_core
from cilium_tpu_torch.kernels.policy import policy_lookup_batch
from cilium_tpu_torch.kernels.records import (batch_to_torch, unpack_wire,
                                              wire_to_torch)
from cilium_tpu_torch.utils import constants as C

N_REASON_BINS = C.DROP_REASON_BINS


def compose_verdict(decision, enforced, cell_redirect, l7_fail,
                    est, reply, valid):
    """(decision, l7_fail) → allow/reason/status/redirect."""
    hit = est | reply
    new_allow = torch.where(
        decision == C.VERDICT_DENY, False,
        torch.where(decision == C.VERDICT_MISS, ~enforced, ~l7_fail))
    allow = torch.where(hit, ~l7_fail, new_allow) & valid
    l7_reason = torch.where(l7_fail, int(C.DropReason.POLICY_L7),
                            int(C.DropReason.OK))
    reason = torch.where(
        hit, l7_reason,
        torch.where(
            decision == C.VERDICT_DENY, int(C.DropReason.POLICY_DENY),
            torch.where(decision == C.VERDICT_MISS,
                        torch.where(enforced, int(C.DropReason.POLICY),
                                    int(C.DropReason.OK)),
                        l7_reason))).to(torch.int32)
    status = torch.where(est, int(C.CTStatus.ESTABLISHED),
                         torch.where(reply, int(C.CTStatus.REPLY),
                                     int(C.CTStatus.NEW))).to(torch.int32)
    redirect = valid & cell_redirect
    return allow, reason, status, redirect


def interior_pre_core(tensors, ep_slot, direction, id_idx, proto,
                      dport, http_method, http_path, rule_axis=None):
    """Policy ladder + L7 token match → (decision, enforced,
    cell_redirect, l7_fail, mrule); nothing here depends on the CT.
    ``rule_axis`` (``kernels/policy.RuleAxis``) reads a rule-sharded
    verdict image."""
    decision, l7_cell, enforced, mrule = policy_lookup_batch(
        tensors, ep_slot, direction, id_idx, proto, dport,
        rule_axis=rule_axis)
    has_tokens = (http_method != C.HTTP_METHOD_ANY) \
        | (http_path != 0).any(dim=-1)
    cell_redirect = decision == C.VERDICT_REDIRECT
    set_to_check = torch.where(cell_redirect, l7_cell, 0)
    l7_ok = l7_match_core(tensors, set_to_check, http_method, http_path)
    l7_fail = has_tokens & (set_to_check > 0) & ~l7_ok
    return decision, enforced, cell_redirect, l7_fail, mrule


def classify_interior_core(tensors, ep_slot, direction, id_idx, proto,
                           dport, http_method, http_path, est, reply, valid,
                           rule_axis=None):
    """Policy ladder → L7 match → verdict composition: the plain version of
    kernel K3. → (allow [N] bool, reason [N] int32, status [N] int32,
    redirect [N] bool, matched_rule [N] int32, -1 where no ladder ran)."""
    decision, enforced, cell_redirect, l7_fail, mrule = interior_pre_core(
        tensors, ep_slot, direction, id_idx, proto, dport, http_method,
        http_path, rule_axis=rule_axis)
    allow, reason, status, redirect = compose_verdict(
        decision, enforced, cell_redirect, l7_fail, est, reply, valid)
    matched_rule = torch.where(valid & enforced, mrule, -1).to(torch.int32)
    return allow, reason, status, redirect, matched_rule


def classify_pre_ct(tensors, batch, world_index, *, v4_only: bool = False,
                    rule_axis=None, lb_probe_depth: int = 8,
                    fused: bool = True, split_interior: bool = False):
    """Service LB → ipcache LPM, plus the CT key derivation. → dict with
    ``batch`` (post-DNAT columns), ``valid``, ``svc``, ``rev_nat``,
    ``no_backend``, ``id_idx``, ``remote_identity``, ``lpm_prefix``,
    ``fwd_keys``, ``rev_keys``; with ``split_interior`` also ``decision``,
    ``enforced``, ``cell_redirect``, ``l7_fail``, ``mrule``."""
    valid0 = batch["valid"]
    direction = batch["direction"]
    dev = valid0.device
    if "lb_tab_keys" in tensors:
        new_dst, new_dport, rev_nat, no_backend = lb_step(
            tensors, batch, probe_depth=lb_probe_depth)
        svc = rev_nat > 0
        batch = dict(batch)
        batch["dst"] = new_dst
        batch["dport"] = new_dport
        valid = valid0 & ~no_backend
    else:
        n = valid0.shape[0]
        rev_nat = torch.zeros((n,), dtype=torch.int32, device=dev)
        svc = torch.zeros((n,), dtype=torch.bool, device=dev)
        no_backend = torch.zeros((n,), dtype=torch.bool, device=dev)
        valid = valid0

    remote_words = torch.where((direction == C.DIR_EGRESS)[:, None],
                               batch["dst"], batch["src"])
    lookup = fk.lpm_lookup_fused if fused else lpm_walk_prov_core
    id_idx, pfx_meta = lookup(tensors["lpm_v4"], tensors["lpm_v6"],
                              remote_words, batch["is_v6"], world_index,
                              v4_only=v4_only)
    ids = tensors["identity_ids"]
    remote_identity = ids[id_idx.to(torch.int64).clamp(0, ids.shape[0] - 1)]
    lpm_prefix = torch.where(valid0, pfx_meta, -1).to(torch.int32)
    fwd_keys, rev_keys = ctk.ct_key_words_pair(batch)

    pre = {
        "batch": batch, "valid": valid, "svc": svc, "rev_nat": rev_nat,
        "no_backend": no_backend, "id_idx": id_idx,
        "remote_identity": remote_identity, "lpm_prefix": lpm_prefix,
        "fwd_keys": fwd_keys, "rev_keys": rev_keys,
    }
    if split_interior:
        decision, enforced, cell_redirect, l7_fail, mrule = \
            interior_pre_core(tensors, batch["ep_slot"], direction, id_idx,
                              batch["proto"], batch["dport"],
                              batch["http_method"], batch["http_path"],
                              rule_axis=rule_axis)
        pre.update(decision=decision, enforced=enforced,
                   cell_redirect=cell_redirect, l7_fail=l7_fail, mrule=mrule)
    return pre


def ct_update_stage(ct, fwd_keys, proto, tcp_flags, hit, hit_slot, reply,
                    new, allow, rev_nat_vals, now,
                    probe_depth: int = PROBE_DEPTH, inplace: bool = False,
                    shards: int = 1):
    """CT insert-when-full + aggregate apply + the batch-start rev-NAT
    read. → (new_ct, ct_full [N] bool, entry_rnat [N] int32, n_evicted).
    ``shards`` > 1: ``ct`` is a shard-major table and the rows are
    shard-major (``conntrack.probe_window``); ``hit_slot`` holds global
    slots."""
    want_insert = new & allow
    cap = ct["expiry"].shape[0]
    hit_slot = hit_slot.to(torch.int64)
    protected = torch.zeros((cap + 1,), dtype=torch.bool,
                            device=hit.device)
    protected.index_fill_(0, torch.where(hit, hit_slot, cap), True)
    # 6b read half (lb4_rev_nat analog): the CT entry's stable rev-NAT id
    # as of the batch start, read before the table is written
    entry_rnat = ct["rev_nat"][torch.where(hit_slot >= 0, hit_slot, 0)]
    new_keys, new_created, zero_mask, slot_new, fail, n_evicted = \
        ctk.ct_insert_new(ct, fwd_keys, want_insert, now, probe_depth,
                          evict=True, protected=protected[:cap],
                          inplace=inplace, shards=shards)
    ct_full = fail
    allow = allow & ~ct_full
    slot = torch.where(hit, hit_slot, slot_new.to(torch.int64))
    contrib = allow & torch.where(hit, True, slot_new >= 0)
    new_ct = ctk.ct_apply(ct, {"proto": proto, "tcp_flags": tcp_flags},
                          slot, reply, contrib, now,
                          new_keys=new_keys, new_created=new_created,
                          zero_mask=zero_mask, rev_nat_vals=rev_nat_vals)
    if inplace:
        for k, v in new_ct.items():
            if v is not ct[k]:
                ct[k].copy_(v)
        new_ct = ct
    return new_ct, ct_full, entry_rnat, n_evicted


def resolve_rev_nat(tensors, entry_rnat, reply, src, sport):
    """A reply on a service flow carries the CT entry's stable rev-NAT id
    → rewrite src back to the VIP; unknown ids rewrite nothing."""
    if "lb_rnat_valid" not in tensors:
        rnat = torch.zeros(reply.shape, dtype=torch.bool, device=reply.device)
        return rnat, src, sport.to(torch.int32)
    n_rnat = tensors["lb_rnat_valid"].shape[0]
    rid = entry_rnat.to(torch.int64) - 1
    known = (rid >= 0) & (rid < n_rnat)
    rid_safe = torch.where(known, rid, 0)
    rnat = reply & known & tensors["lb_rnat_valid"][rid_safe]
    rnat_src = torch.where(rnat[:, None], tensors["lb_rnat_addr"][rid_safe],
                           src)
    rnat_sport = torch.where(rnat, tensors["lb_rnat_port"][rid_safe],
                             sport).to(torch.int32)
    return rnat, rnat_src, rnat_sport


def tally_by_reason_dir(reason, direction, counted):
    """Per-reason × direction counters [2 * N_REASON_BINS] (int32 bit
    patterns of the reference's uint32), one scatter-add."""
    cells = N_REASON_BINS * 2
    bin_idx = reason.to(torch.int64) * 2 + direction
    keep = counted & (bin_idx >= 0) & (bin_idx < cells)
    counts = torch.zeros((cells + 1,), dtype=torch.int64,
                         device=reason.device)
    counts.index_add_(0, torch.where(keep, bin_idx, cells),
                      torch.ones_like(bin_idx))
    return i32(counts[:cells])


def classify_step(tensors, ct, batch, now, world_index=0, *,
                  probe_depth: int = PROBE_DEPTH, v4_only: bool = False,
                  rule_axis=None, lb_probe_depth: int = 8,
                  fused: bool = True, inplace: bool = False,
                  shards: int = 1):
    """→ (out, new_ct, counters), with the reference's out columns and
    counters (u32 ones as int32 bit patterns: ``remote_identity``,
    ``nat_dst``, ``rnat_src`` and every counter). With ``rule_axis`` (a
    rule-sharded mesh) the policy stage runs the split plain core, as the
    reference does where its rules-axis psum must stay outside the
    kernel; K1 and K2 still run with ``fused``.

    ``shards`` > 1 is the steered step of that many flow shards on one
    device (``parallel/mesh.make_sharded_classify_fn``): ``ct`` is their
    shard-major table and the rows are their equal shard-major segments.
    Only the probe pair (``fused.ct_probe_pair_sharded``) and the CT
    update see the shards; every other stage runs once over all rows, and
    the counters are the sums of the shards' own."""
    fused_policy = fused and rule_axis is None
    pre = classify_pre_ct(tensors, batch, world_index, v4_only=v4_only,
                          rule_axis=rule_axis,
                          lb_probe_depth=lb_probe_depth, fused=fused,
                          split_interior=not fused_policy)
    batch = pre["batch"]
    valid = pre["valid"]
    direction = batch["direction"]
    no_backend = pre["no_backend"]
    fwd_keys, rev_keys = pre["fwd_keys"], pre["rev_keys"]

    # conntrack probe (batch-start snapshot)
    if shards > 1:
        fwd_slot, rev_slot = fk.ct_probe_pair_sharded(
            ct, fwd_keys, rev_keys, now, probe_depth, shards, fused=fused)
    else:
        probe = fk.ct_probe_pair_fused if fused else fk.ct_probe_pair_plain
        fwd_slot, rev_slot = probe(ct, fwd_keys, rev_keys, now, probe_depth)
    est = valid & (fwd_slot >= 0)
    reply = valid & ~est & (rev_slot >= 0)
    new = valid & ~est & ~reply
    hit = est | reply
    hit_slot = torch.where(est, fwd_slot, torch.where(reply, rev_slot, 0))

    # policy ladder + L7 token match + verdict composition
    if fused_policy:
        allow, reason, status, redirect, matched_rule = \
            fk.policy_verdict_fused(
                tensors, batch["ep_slot"], direction, pre["id_idx"],
                batch["proto"], batch["dport"], batch["http_method"],
                batch["http_path"], est, reply, valid)
    else:
        allow, reason, status, redirect = compose_verdict(
            pre["decision"], pre["enforced"], pre["cell_redirect"],
            pre["l7_fail"], est, reply, valid)
        matched_rule = torch.where(valid & pre["enforced"], pre["mrule"],
                                   -1).to(torch.int32)
    reason = torch.where(no_backend, int(C.DropReason.NO_SERVICE), reason)

    new_ct, ct_full, entry_rnat, n_evicted = ct_update_stage(
        ct, fwd_keys, batch["proto"], batch["tcp_flags"], hit, hit_slot,
        reply, new, allow, pre["rev_nat"], now, probe_depth, inplace=inplace,
        shards=shards)
    allow = allow & ~ct_full
    reason = torch.where(ct_full, int(C.DropReason.CT_FULL),
                         reason).to(torch.int32)

    rnat, rnat_src, rnat_sport = resolve_rev_nat(
        tensors, entry_rnat, reply, batch["src"], batch["sport"])

    counted = valid | no_backend
    counters = {
        "by_reason_dir": tally_by_reason_dir(reason, direction, counted),
        "insert_fail": ct_full.sum().to(torch.int32),
        "ct_evicted": n_evicted,
    }
    out = {
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
        "nat_dst": batch["dst"],
        "nat_dport": batch["dport"].to(torch.int32),
        "rnat": rnat,
        "rnat_src": rnat_src,
        "rnat_sport": rnat_sport,
    }
    return out, new_ct, counters


def make_classify_fn(probe_depth: int = PROBE_DEPTH, v4_only: bool = False,
                     donate_ct: bool = True, packed: bool = False,
                     lb_probe_depth: int = 8, fused: bool = True,
                     device="cuda"):
    """The classify step as ``fn(tensors, ct, batch, now, world_index)
    → (out, new_ct, counters)``.

    ``packed=True``: ``batch`` is a packed wire (``records.pack_batch*``;
    a uint32 array, a tuple of them for the dictionary wires, or the same
    as int32 tensors), moved to ``device`` and unpacked there. Otherwise a
    batch dict, of numpy arrays or of tensors. ``donate_ct=True`` updates
    ``ct`` in place and returns it as ``new_ct``."""
    def fn(tensors, ct, batch, now, world_index):
        if packed:
            batch = unpack_wire(wire_to_torch(batch, device))
        elif any(isinstance(v, np.ndarray) for v in batch.values()):
            batch = batch_to_torch(batch, device)
        return classify_step(tensors, ct, batch, now, world_index,
                             probe_depth=probe_depth, v4_only=v4_only,
                             lb_probe_depth=lb_probe_depth, fused=fused,
                             inplace=donate_ct)
    return fn
