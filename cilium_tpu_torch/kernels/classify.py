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

import collections
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cilium_tpu_torch.compile.ct_layout import PROBE_DEPTH
from cilium_tpu_torch.kernels import conntrack as ctk
from cilium_tpu_torch.kernels import fused as fk
from cilium_tpu_torch.kernels.hashing import i32
from cilium_tpu_torch.kernels.l7 import l7_match_core
from cilium_tpu_torch.kernels.lb import lb_step
from cilium_tpu_torch.kernels.lpm import lpm_walk_prov_core
from cilium_tpu_torch.kernels.policy import RuleAxis, policy_lookup_batch
from cilium_tpu_torch.kernels.records import (batch_to_torch,
                                              unpack_wire_parts, wire_parts,
                                              wire_to_torch)
from cilium_tpu_torch.utils import constants as C

N_REASON_BINS = C.DROP_REASON_BINS

Tensors = Dict[str, torch.Tensor]


def compose_verdict(decision: torch.Tensor, enforced: torch.Tensor,
                    cell_redirect: torch.Tensor, l7_fail: torch.Tensor,
                    est: torch.Tensor, reply: torch.Tensor,
                    valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """(decision, l7_fail) → allow/reason/status/redirect."""
    hit = est | reply
    new_allow = (decision != C.VERDICT_DENY) & torch.where(
        decision == C.VERDICT_MISS, ~enforced, ~l7_fail)
    allow = torch.where(hit, ~l7_fail, new_allow) & valid
    l7_reason = torch.where(l7_fail, C.DropReason.POLICY_L7.value,
                            C.DropReason.OK.value)
    reason = torch.where(
        hit, l7_reason,
        torch.where(
            decision == C.VERDICT_DENY, C.DropReason.POLICY_DENY.value,
            torch.where(decision == C.VERDICT_MISS,
                        torch.where(enforced, C.DropReason.POLICY.value,
                                    C.DropReason.OK.value),
                        l7_reason))).to(torch.int32)
    status = torch.where(est, C.CTStatus.ESTABLISHED.value,
                         torch.where(reply, C.CTStatus.REPLY.value,
                                     C.CTStatus.NEW.value)).to(torch.int32)
    redirect = valid & cell_redirect
    return allow, reason, status, redirect


def interior_pre_core(tensors: Tensors, ep_slot: torch.Tensor,
                      direction: torch.Tensor, id_idx: torch.Tensor,
                      proto: torch.Tensor, dport: torch.Tensor,
                      http_method: torch.Tensor, http_path: torch.Tensor,
                      rule_axis: Optional[RuleAxis] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor, torch.Tensor]:
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


def classify_interior_core(tensors: Tensors, ep_slot: torch.Tensor,
                           direction: torch.Tensor, id_idx: torch.Tensor,
                           proto: torch.Tensor, dport: torch.Tensor,
                           http_method: torch.Tensor,
                           http_path: torch.Tensor, est: torch.Tensor,
                           reply: torch.Tensor, valid: torch.Tensor,
                           rule_axis: Optional[RuleAxis] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
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


def classify_pre_ct(tensors: Tensors, batch: Tensors, world_index: int,
                    v4_only: bool = False,
                    rule_axis: Optional[RuleAxis] = None,
                    lb_probe_depth: int = 8, fused: bool = True,
                    split_interior: bool = False) -> Tuple[Tensors, Tensors]:
    """Service LB → ipcache LPM, plus the CT key derivation. → (the batch
    with its post-DNAT columns, a dict with ``valid``, ``svc``,
    ``rev_nat``, ``no_backend``, ``id_idx``, ``remote_identity``,
    ``lpm_prefix``, ``fwd_keys``, ``rev_keys``; with ``split_interior``
    also ``decision``, ``enforced``, ``cell_redirect``, ``l7_fail``,
    ``mrule``)."""
    valid0 = batch["valid"]
    direction = batch["direction"]
    dev = valid0.device
    if "lb_tab_keys" in tensors:
        new_dst, new_dport, rev_nat, no_backend = lb_step(
            tensors, batch, probe_depth=lb_probe_depth)
        svc = rev_nat > 0
        batch = batch.copy()
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
    if fused:
        id_idx, pfx_meta = fk.lpm_lookup_fused(
            tensors["lpm_v4"], tensors["lpm_v6"], remote_words,
            batch["is_v6"], world_index, v4_only)
    else:
        id_idx, pfx_meta = lpm_walk_prov_core(
            tensors["lpm_v4"], tensors["lpm_v6"], remote_words,
            batch["is_v6"], world_index, v4_only)
    ids = tensors["identity_ids"]
    remote_identity = ids[id_idx.to(torch.int64).clamp(0, ids.shape[0] - 1)]
    lpm_prefix = torch.where(valid0, pfx_meta, -1).to(torch.int32)
    fwd_keys, rev_keys = ctk.ct_key_words_pair(batch)

    pre = {
        "valid": valid, "svc": svc, "rev_nat": rev_nat,
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
        pre["decision"] = decision
        pre["enforced"] = enforced
        pre["cell_redirect"] = cell_redirect
        pre["l7_fail"] = l7_fail
        pre["mrule"] = mrule
    return batch, pre


def ct_update_stage(ct: Tensors, fwd_keys: torch.Tensor,
                    proto: torch.Tensor, tcp_flags: torch.Tensor,
                    hit: torch.Tensor, hit_slot: torch.Tensor,
                    reply: torch.Tensor, new: torch.Tensor,
                    allow: torch.Tensor, rev_nat_vals: torch.Tensor,
                    now: int, probe_depth: int = PROBE_DEPTH,
                    inplace: bool = False, shards: int = 1,
                    fwd_home: Optional[torch.Tensor] = None
                    ) -> Tuple[Tensors, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """CT insert-when-full + aggregate apply + the batch-start rev-NAT
    read. → (new_ct, ct_full [N] bool, entry_rnat [N] int32, n_evicted).
    ``shards`` > 1: ``ct`` is a shard-major table and the rows are
    shard-major (``conntrack.probe_window``); ``hit_slot`` holds global
    slots. ``fwd_home``: the forward keys' home slots
    (``conntrack.ct_home_pair``), hashed by the insert when not given."""
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
                          inplace=inplace, shards=shards, home=fwd_home)
    ct_full = fail
    allow = allow & ~ct_full
    slot = torch.where(hit, hit_slot, slot_new.to(torch.int64))
    contrib = allow & (hit | (slot_new >= 0))
    new_ct = ctk.ct_apply(ct, {"proto": proto, "tcp_flags": tcp_flags},
                          slot, reply, contrib, now,
                          new_keys=new_keys, new_created=new_created,
                          zero_mask=zero_mask, rev_nat_vals=rev_nat_vals)
    if inplace:
        # the insert wrote the keys and created stamps into ``ct`` itself;
        # every other column of ``new_ct`` is a new tensor
        for k in ["expiry", "flags", "pkts_fwd", "pkts_rev", "rev_nat"]:
            ct[k].copy_(new_ct[k])
        new_ct = ct
    return new_ct, ct_full, entry_rnat, n_evicted


def resolve_rev_nat(tensors: Tensors, entry_rnat: torch.Tensor,
                    reply: torch.Tensor, src: torch.Tensor,
                    sport: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
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


def tally_by_reason_dir(reason: torch.Tensor, direction: torch.Tensor,
                        counted: torch.Tensor) -> torch.Tensor:
    """Per-reason × direction counters [2 * N_REASON_BINS] (int32 bit
    patterns of the reference's uint32), one scatter-add."""
    cells = C.DROP_REASON_BINS * 2
    bin_idx = reason.to(torch.int64) * 2 + direction
    keep = counted & (bin_idx >= 0) & (bin_idx < cells)
    counts = torch.zeros((cells + 1,), dtype=torch.int64,
                         device=reason.device)
    counts.index_add_(0, torch.where(keep, bin_idx, cells),
                      torch.ones_like(bin_idx))
    return i32(counts[:cells])


def classify_step(tensors: Tensors, ct: Tensors, batch: Tensors, now: int,
                  world_index: int = 0, probe_depth: int = PROBE_DEPTH,
                  v4_only: bool = False,
                  rule_axis: Optional[RuleAxis] = None,
                  lb_probe_depth: int = 8, fused: bool = True,
                  inplace: bool = False, shards: int = 1
                  ) -> Tuple[Tensors, Tensors, Tensors]:
    """→ (out, new_ct, counters), with the reference's out columns and
    counters (u32 ones as int32 bit patterns: ``remote_identity``,
    ``nat_dst``, ``rnat_src`` and every counter), and one column of the
    port's own: ``est_fp``, each row's flow fingerprint
    (``shim.feeder.flow_hashes`` of its untranslated tuple, as int32 bit
    patterns), which the engine's finalize takes out of ``out`` for its
    CT-salvage note. With ``rule_axis`` (a
    rule-sharded mesh) the policy stage runs the split plain core, as the
    reference does where its rules-axis psum must stay outside the
    kernel; K1 and K2 still run with ``fused``.

    ``shards`` > 1 is the steered step of that many flow shards on one
    device (``parallel/mesh.make_sharded_classify_fn``): ``ct`` is their
    shard-major table and the rows are their equal shard-major segments.
    Only the probe pair (``fused.ct_probe_pair_sharded``) and the CT
    update see the shards; every other stage runs once over all rows, and
    the counters are the sums of the shards' own.

    The body compiles under ``torch.jit.script`` (``scripted``), which is
    how ``make_classify_fn`` and the co-located mesh run it: one call a
    dispatch. The plain path (``fused=False``) hashes the CT keys once
    (``conntrack.ct_home_pair``) for both probes and the insert; K2 hashes
    its keys itself, and the insert then hashes the forward keys."""
    fused_policy = fused and rule_axis is None
    # the CT-salvage note's flow fingerprints, of the tuple as it arrived
    # (before the LB's DNAT), which the engine's finalize stamps
    fp_cols = (batch["src"], batch["dst"], batch["sport"], batch["dport"],
               batch["proto"], batch["direction"])
    if fused:
        est_fp = fk.flow_fingerprint_fused(*fp_cols)
    else:
        est_fp = fk.flow_fingerprint_plain(*fp_cols)
    batch, pre = classify_pre_ct(tensors, batch, world_index, v4_only,
                                 rule_axis, lb_probe_depth, fused,
                                 not fused_policy)
    valid = pre["valid"]
    direction = batch["direction"]
    no_backend = pre["no_backend"]
    fwd_keys, rev_keys = pre["fwd_keys"], pre["rev_keys"]

    # conntrack probe (batch-start snapshot)
    fwd_home: Optional[torch.Tensor] = None
    if not fused:
        fwd_home, rev_home = ctk.ct_home_pair(
            fwd_keys, rev_keys, ct["expiry"].shape[0], shards)
        fwd_slot, rev_slot = fk.ct_probe_pair_plain(
            ct, fwd_keys, rev_keys, now, probe_depth, shards, fwd_home,
            rev_home)
    elif shards > 1:
        fwd_slot, rev_slot = fk.ct_probe_pair_sharded(
            ct, fwd_keys, rev_keys, now, probe_depth, shards, True)
    else:
        fwd_slot, rev_slot = fk.ct_probe_pair_fused(
            ct, fwd_keys, rev_keys, now, probe_depth)
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
    reason = torch.where(no_backend, C.DropReason.NO_SERVICE.value, reason)

    new_ct, ct_full, entry_rnat, n_evicted = ct_update_stage(
        ct, fwd_keys, batch["proto"], batch["tcp_flags"], hit, hit_slot,
        reply, new, allow, pre["rev_nat"], now, probe_depth, inplace,
        shards, fwd_home)
    allow = allow & ~ct_full
    reason = torch.where(ct_full, C.DropReason.CT_FULL.value,
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
        "est_fp": est_fp,
    }
    return out, new_ct, counters


def classify_wire_step(tensors: Tensors, ct: Tensors,
                       wire: List[torch.Tensor], now: int,
                       world_index: int = 0, probe_depth: int = PROBE_DEPTH,
                       v4_only: bool = False, lb_probe_depth: int = 8,
                       fused: bool = True, inplace: bool = False,
                       shards: int = 1) -> Tuple[Tensors, Tensors, Tensors]:
    """``classify_step`` of a packed wire on the device (the list of
    ``records.wire_parts``), unpacked inside the same call."""
    return classify_step(tensors, ct, unpack_wire_parts(wire), now,
                         world_index, probe_depth, v4_only, None,
                         lb_probe_depth, fused, inplace, shards)


# --------------------------------------------------------------------------- #
# The scripted step
# --------------------------------------------------------------------------- #
_SCRIPTED: Dict[object, torch.jit.ScriptFunction] = {}
_SCRIPT_LOCK = threading.Lock()


def scripted(fn):
    """``torch.jit.script(fn)``, compiled at its first use in the process
    and kept. A function that does not compile raises here: there is no
    eager stand-in."""
    with _SCRIPT_LOCK:
        got = _SCRIPTED.get(fn)
        if got is None:
            got = _SCRIPTED[fn] = torch.jit.script(fn)
        return got


def run_scripted(fn, *args, **kwargs):
    """Call the scripted ``fn`` with the executor's optimisations off
    (set for this thread, for this call): the graph runs the ops it was
    written with, as the eager function does, with no profiling runs, no
    shape specialisation and no fusion; the GIL is given up once for
    the whole call."""
    step = scripted(fn)
    with torch.jit.optimized_execution(False):
        return step(*args, **kwargs)


#: make_classify_fn memo: one step per static configuration, LRU-bounded
#: as the reference's is (its cap from ``CILIUM_TPU_CLASSIFY_FN_CACHE``,
#: default 64); evictions are counted and exported by
#: ``Engine.render_metrics`` (``classify_fn_cache_evictions_total``).
FN_CACHE_CAP = max(1, int(os.environ.get("CILIUM_TPU_CLASSIFY_FN_CACHE",
                                         "64")))
_FN_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_FN_LOCK = threading.Lock()
_FN_EVICTIONS = [0]


def fn_cache_stats() -> dict:
    """The memo's current size, cap and eviction count."""
    with _FN_LOCK:
        return {"size": len(_FN_CACHE), "cap": FN_CACHE_CAP,
                "evictions": _FN_EVICTIONS[0]}


def make_classify_fn(probe_depth: int = PROBE_DEPTH, v4_only: bool = False,
                     donate_ct: bool = True, packed: bool = False,
                     lb_probe_depth: int = 8, fused: bool = True,
                     device="cuda"):
    """The classify step as ``fn(tensors, ct, batch, now, world_index)
    → (out, new_ct, counters)``: one call of the scripted
    ``classify_step`` (``classify_wire_step`` with ``packed``), whose
    kernel wrappers (``fused`` on the card) run between its torch ops.

    ``packed=True``: ``batch`` is a packed wire (``records.pack_batch*``;
    a uint32 array, a tuple of them for the dictionary wires, or the same
    as int32 tensors), moved to ``device`` and unpacked there. Otherwise a
    batch dict, of numpy arrays or of tensors. ``donate_ct=True`` updates
    ``ct`` in place and returns it as ``new_ct``.

    Memoised on the whole static configuration, ``device`` included: a
    caller that rebuilds its datapath gets the same callable, and the
    scripted step is compiled once in the process, on first use."""
    key = (probe_depth, v4_only, donate_ct, packed, lb_probe_depth, fused,
           str(torch.device(device)))
    with _FN_LOCK:
        fn = _FN_CACHE.get(key)
        if fn is not None:
            _FN_CACHE.move_to_end(key)     # LRU touch
            return fn
    step = classify_wire_step if packed else classify_step
    scripted(step)

    def fn(tensors, ct, batch, now, world_index):
        if packed:
            batch = wire_parts(wire_to_torch(batch, device))
        elif any(isinstance(v, np.ndarray) for v in batch.values()):
            batch = batch_to_torch(batch, device)
        out, new_ct, counters = run_scripted(
            step, tensors, ct, batch, int(now), int(world_index),
            probe_depth=probe_depth, v4_only=v4_only,
            lb_probe_depth=lb_probe_depth, fused=fused, inplace=donate_ct)
        # donated: the step wrote the caller's tensors; hand back its dict
        return out, (ct if donate_ct else new_ct), counters
    with _FN_LOCK:
        cached = _FN_CACHE.get(key)
        if cached is not None:             # lost the build race: reuse
            _FN_CACHE.move_to_end(key)
            return cached
        _FN_CACHE[key] = fn
        while len(_FN_CACHE) > FN_CACHE_CAP:
            _FN_CACHE.popitem(last=False)  # evict least-recently-used
            _FN_EVICTIONS[0] += 1
        return fn
