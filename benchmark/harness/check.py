"""The comparison that decides ``correct``: what the timed path produced
for a dispatch against the plain reference (``benchmark/reference``) run
from the same batch, ``now`` and batch-start table.

Per dispatch it counts
- ``rows``: rows where a column differs: ``allow``, ``reason``, ``status``
  and ``ct_state_pre``, ``ct_full``, ``remote_identity``, ``redirect``
  (where the policy puts the row under an L7 rule set); ``svc`` and
  ``rnat`` (false: no service frontend); ``nat_dst``/``nat_dport`` and
  ``rnat_src``/``rnat_sport`` (the row's own addresses and ports); the
  length of ``lpm_prefix`` (-1 on a miss) and whether ``matched_rule`` is
  set (exactly where the row's direction is enforced); and rows whose
  ``matched_rule`` or ``lpm_prefix`` slot breaks the labelling they stand
  for: rows of one (identity, protocol, port) share one ``matched_rule``,
  rows of one ``matched_rule`` share one policy answer (allowed or not, and
  the L7 rule set, so one rule stands for one set), and the ``lpm_prefix``
  slots stand one to one for the winning prefixes (the numbers themselves
  are the compiler's enumeration, which the reference does not work out).
  The program's rows and conntrack carry no L7 set number of their own;
- ``ct_slots``: table slots where any array differs after the dispatch;
- ``counters``: per-reason × direction cells, insert failures and
  evictions that differ.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from benchmark.reference.datapath import classify

_SAME = ("allow", "reason", "status", "ct_full", "remote_identity",
         "redirect")


def _u32(d: Dict) -> Dict[str, np.ndarray]:
    return {k: np.ascontiguousarray(v).view(np.uint32) for k, v in d.items()}


def _conflicts(key: np.ndarray, val: np.ndarray) -> np.ndarray:
    """Rows whose ``key`` group holds more than one ``val``."""
    if key.size == 0:
        return np.zeros(0, bool)
    pairs = np.unique(np.stack([key, val], 1), axis=0)
    keys, counts = np.unique(pairs[:, 0], return_counts=True)
    return np.isin(key, keys[counts > 1])


def _key(*cols) -> np.ndarray:
    _u, inv = np.unique(np.stack(cols, 1), axis=0, return_inverse=True)
    return inv.reshape(-1)


def compare(policy, batch, now, ct_before, ct_after, counters,
            out) -> Dict[str, int]:
    """→ the three counts of mismatches for one dispatch. ``ct_before`` and
    ``ct_after`` are the program's tables (uint32 or int32 arrays);
    ``counters`` and ``out`` its outputs."""
    ct_before, ct_after = _u32(ct_before), _u32(ct_after)
    ref, ref_ct, ref_cnt = classify(policy, batch, now, ct_before)
    valid = batch["valid"]
    bad = np.zeros(valid.shape[0], bool)
    for k in _SAME:
        bad |= np.asarray(out[k]).astype(np.int64) \
            != ref[k].astype(np.int64)
    bad |= out["ct_state_pre"] != ref["status"]
    for k in ("svc", "rnat"):
        bad |= out[k].astype(bool)
    bad |= (out["nat_dst"] != batch["dst"]).any(1)
    bad |= out["nat_dport"] != batch["dport"]
    bad |= (out["rnat_src"] != batch["src"]).any(1)
    bad |= out["rnat_sport"] != batch["sport"]
    pfx = out["lpm_prefix"].astype(np.int64)
    plen = np.where(pfx >= 0, pfx & 0xFF, -1)
    bad |= plen != ref["lpm_plen"]
    rule = out["matched_rule"].astype(np.int64)
    bad |= (rule >= 0) != ref["enforced"]
    ruled = valid & (rule >= 0)
    triple = _key(ref["remote_identity"][ruled].astype(np.int64),
                  batch["proto"][ruled], batch["dport"][ruled])
    bad[ruled] |= _conflicts(triple, rule[ruled])
    bad[ruled] |= _conflicts(rule[ruled], _key(
        ref["policy_allowed"][ruled].astype(np.int64),
        ref["l7_set"][ruled]))
    hit = valid & (pfx >= 0)
    slot = pfx[hit] >> 8
    bad[hit] |= _conflicts(ref["lpm_which"][hit], slot)
    bad[hit] |= _conflicts(slot, ref["lpm_which"][hit])
    bad &= valid

    diff = np.zeros(ref_ct["expiry"].shape[0], bool)
    for k, v in ref_ct.items():
        d = ct_after[k] != v
        diff |= d.any(1) if d.ndim == 2 else d
    cnt = _u32({k: np.asarray(v).reshape(-1) for k, v in counters.items()})
    n_cnt = int((cnt["by_reason_dir"].astype(np.int64)
                 != ref_cnt["by_reason_dir"]).sum())
    n_cnt += int(cnt["insert_fail"][0]) != ref_cnt["insert_fail"]
    n_cnt += int(cnt["ct_evicted"][0]) != ref_cnt["ct_evicted"]
    return {"rows": int(bad.sum()), "ct_slots": int(diff.sum()),
            "counters": n_cnt}


def control_counts(policy, batch, now, ct_before) -> Dict[str, int]:
    """The control put in the program's place: the reference with the
    conntrack guarantee broken (``classify(..., stateless=True)``: every
    row taken as NEW, the table unread), its outputs in the program's
    form, judged by ``compare`` as the program's are."""
    before = _u32(ct_before)
    out, ct_after, cnt = classify(policy, batch, now, before,
                                  stateless=True)
    n = batch["valid"].shape[0]
    triple = _key(out["remote_identity"].astype(np.int64),
                  batch["proto"], batch["dport"])
    prog = dict(out)
    prog["ct_state_pre"] = out["status"]
    prog["svc"] = prog["rnat"] = np.zeros(n, bool)
    prog["nat_dst"], prog["nat_dport"] = batch["dst"], batch["dport"]
    prog["rnat_src"], prog["rnat_sport"] = batch["src"], batch["sport"]
    prog["lpm_prefix"] = np.where(out["lpm_which"] >= 0,
                                  (out["lpm_which"] << 8) | out["lpm_plen"],
                                  -1)
    prog["matched_rule"] = np.where(out["enforced"], triple, -1)
    counters = {"by_reason_dir": cnt["by_reason_dir"].astype(np.uint32),
                "insert_fail": np.uint32([cnt["insert_fail"]]),
                "ct_evicted": np.uint32([cnt["ct_evicted"]])}
    return compare(policy, batch, now, ct_before, ct_after, counters, prog)
