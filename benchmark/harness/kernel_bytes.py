"""The bytes each of the three kernels' work needs for one dispatch: each
input byte read once, each output byte written once, and of each table
only the entries these inputs touch. The count follows from the batch, the
placed tables' shapes and the table entries the rows reach, not from how a
kernel reads them, so a kernel that is fused or replaced is held to the
same count. Peak: the H100 SXM's 3.35 TB/s of HBM (NVIDIA's data sheet).

- K1, the LPM walk: the remote address (16 bytes a row), the trie nodes
  the walk visits (12 bytes each, once: a v4 row walks the v4 trie on its
  last 4 bytes, a v6 row the v6 trie on all 16), the identity index and
  prefix it returns (8 bytes a row).
- K2, the conntrack probe pair: both keys (40 bytes each a row), the
  expiry of each slot a probe reads before its key is found (4 bytes,
  once), the key of each live slot it compares (40 bytes, once), and both
  slots it returns (4 bytes each a row).
- K3, the policy ladder and verdict: the row's columns (5 words and 3
  bytes), one entry of each lookup table the rows reach (identity class,
  protocol family and port class 4 bytes each, a verdict cell 2 bytes, an
  endpoint-direction 1 byte), and 14 bytes a row out; on a row whose
  verdict is an L7 rule set, its request (the method byte and 64 path
  bytes), and once each set the rows reach (each of its rule slots' method,
  64 path bytes, path length and valid flag: 70 bytes).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from benchmark.reference.constants import PATH_BYTES, PROBE_DEPTH
from benchmark.reference.datapath import key_words
from benchmark.reference.hashing import murmur3_words

HBM_BYTES_PER_S = 3.35e12


def _unique(*cols) -> int:
    return int(np.unique(np.stack(cols, 1), axis=0).shape[0]) \
        if cols[0].size else 0


def _cells(trie: np.ndarray, words: np.ndarray) -> int:
    """The distinct cells of ``trie`` [nodes, 256, 3] (child, value,
    provenance) that the walks of ``words`` [N, W] uint32 visit, a byte a
    level, most significant first."""
    n = words.shape[0]
    child = trie[:, :, 0].reshape(-1)
    dead = trie.shape[0] - 1
    node = np.zeros(n, np.int64)
    seen = []
    for level in range(4 * words.shape[1]):
        b = (words[:, level // 4].astype(np.int64)
             >> (8 * (3 - level % 4))) & 0xFF
        at = node * 256 + b
        seen.append(at)
        c = child[at]
        node = np.where(c >= 0, c, dead)
    return np.unique(np.concatenate(seen)).shape[0] if n else 0


def lpm_bytes(lpm_v4: np.ndarray, lpm_v6: np.ndarray, remote: np.ndarray,
              is_v6: np.ndarray) -> int:
    """``lpm_v4``, ``lpm_v6``: the placed tries; ``remote`` [N, 4] uint32,
    a v4 row's address in its last word."""
    n = remote.shape[0]
    v6 = np.asarray(is_v6, bool)
    cells = _cells(lpm_v4, remote[~v6, 3:]) + _cells(lpm_v6, remote[v6])
    return n * 16 + cells * 12 + n * 8


def ct_probe_bytes(ct: Dict[str, np.ndarray], batch, now: int) -> int:
    cap = ct["expiry"].shape[0]
    exp_slots, key_slots = [], []
    for reverse in (False, True):
        keys = key_words(batch, reverse)
        home = murmur3_words(keys).astype(np.int64) & (cap - 1)
        done = np.zeros(keys.shape[0], bool)
        for r in range(PROBE_DEPTH):
            s = (home + r) & (cap - 1)
            live = ct["expiry"][s] > np.uint32(now)
            exp_slots.append(s[~done])
            key_slots.append(s[~done & live])
            done |= live & (ct["keys"][s] == keys).all(1)
    n = batch["valid"].shape[0]
    return (2 * n * 40 + np.unique(np.concatenate(exp_slots)).shape[0] * 4
            + np.unique(np.concatenate(key_slots)).shape[0] * 40
            + 2 * n * 4)


def policy_bytes(batch, out, l7_sets=None, l7_rules: int = 0) -> int:
    """``l7_sets`` [N]: each row's L7 rule set (0 none), as the reference
    works it out; ``l7_rules``: the rule slots of a placed set."""
    n = batch["valid"].shape[0]
    rule = out["matched_rule"]
    ruled = rule >= 0
    epd = batch["ep_slot"].astype(np.int64) * 2 + batch["direction"]
    table = (_unique(out["remote_identity"].astype(np.int64)) * 4
             + _unique(batch["proto"].astype(np.int64)) * 4
             + _unique(batch["proto"].astype(np.int64),
                       batch["dport"].astype(np.int64)) * 4
             + _unique(epd[ruled], rule[ruled].astype(np.int64)) * 2
             + _unique(epd))
    l7 = 0
    if l7_sets is not None:
        sets = l7_sets[l7_sets > 0]
        l7 = sets.shape[0] * (1 + PATH_BYTES) \
            + np.unique(sets).shape[0] * l7_rules * (1 + PATH_BYTES + 4 + 1)
    return n * (5 * 4 + 3) + table + n * 14 + l7


def dispatch_bytes(lpm_v4, lpm_v6, ct_before, batch, out, now,
                   l7_sets=None, l7_rules: int = 0) -> Dict[str, int]:
    """The three kernels' bytes for one dispatch, by kernel symbol."""
    remote = np.where((batch["direction"] == 0)[:, None], batch["dst"],
                      batch["src"])
    return {"lpm_lookup_kernel": lpm_bytes(lpm_v4, lpm_v6, remote,
                                           batch["is_v6"]),
            "ct_probe_pair_kernel": ct_probe_bytes(ct_before, batch, now),
            "policy_verdict_kernel": policy_bytes(batch, out, l7_sets,
                                                  l7_rules)}
