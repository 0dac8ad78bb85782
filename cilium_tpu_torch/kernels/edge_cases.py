"""Seeded inputs on which a kernel of K1 (LPM walk), K2 (CT probe pair) or
K3 (policy + L7 + verdict) could part from its plain version.

K1: v4 prefixes /0 to /32 and v6 /0 to /128 nested on one address (the
non-byte-aligned ones fill several cells), overlapping prefixes in one
byte cell, a cell with both a value and a child, misses that die at
levels 0, 1, 3 and 15, runs of single-child nodes (ending in a value,
with a branch or a value in the middle, past the last level), tries whose
dead node is not inert (the full-depth walk), every warp mixing families,
``v4_only`` with v6 rows set, and N = 0, 1 and 300.

K2: probe runs that wrap from slot ``cap - 1`` to slot 0, expiries at the
clock's edges above 2^31, two live copies of a key in one run, a dead copy
before a live one, a run full of live near misses, ``probe_depth`` 1 and 8,
and key words at or above 2^31. The flow-fingerprint kernel
(``fingerprint_rows``): v4-mapped and v6 words, both directions, invalid
rows holding any int32 in their port, protocol and direction columns,
any row count. K3: an L7 prefix length on each side of
every 16-byte boundary (and below 0 and past 64), method ANY against an
exact method, set ids past the last set, REDIRECT rows with and without
tokens, an invalid first rule before a valid second one, and row inputs
outside every table.

Everything is numpy in the reference's dtypes (uint32 CT arrays and key
words, the uint16 verdict image, bool flags), made by one generator seeded
with ``seed``: the CPU tests hand the same arrays to the JAX package and to
the port, and ``chip_smoke.py`` holds the CUDA kernels against their plain
versions on them. ``lpm_args``, ``probe_args`` and ``policy_args`` place
a case on a device as the wrappers' arguments.
"""

from __future__ import annotations

import ipaddress
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from cilium_tpu_torch import convert
from cilium_tpu_torch.compile.ct_layout import CT_FIELDS, KEY_WORDS, \
    PROBE_DEPTH
from cilium_tpu_torch.compile.lpm import build_lpm, pack_pfx
from cilium_tpu_torch.kernels.hashing import hash_words_u64
from cilium_tpu_torch.utils import constants as C

_M32 = 0xFFFFFFFF


class LpmCase(NamedTuple):
    v4_nodes: np.ndarray          # [n4, 256, 3] int32
    v6_nodes: np.ndarray          # [n6, 256, 3] int32
    addr: np.ndarray              # [N, 4] uint32, v4-mapped
    is_v6: np.ndarray             # [N] bool
    default_index: int
    v4_only: bool


class ProbeCase(NamedTuple):
    ct: Dict[str, np.ndarray]     # the seven uint32 CT arrays
    fwd: np.ndarray               # [N, 10] uint32
    rev: np.ndarray               # [N, 10] uint32
    now: int                      # u32
    depth: int


class PolicyCase(NamedTuple):
    tensors: Dict[str, np.ndarray]
    #: ep_slot, direction, id_idx, proto, dport, http_method (int32),
    #: http_path [N, 64] uint8, est, reply, valid (bool)
    rows: Tuple[np.ndarray, ...]


# --------------------------------------------------------------------------- #
# K1
# --------------------------------------------------------------------------- #
_V4_BASE, _V6_BASE = "203.0.113.77", "2001:db8:aaaa:bbbb:cccc:dddd:eeee:ff01"


def _addr(ip) -> int:
    """An address as the 128-bit integer of its v4-mapped form."""
    a = ipaddress.ip_address(ip)
    return int(a) | (0xFFFF << 32) if a.version == 4 else int(a)


def _trie(prefixes, v4_bits=0):
    """Both tries of an ipcache holding ``prefixes``, prefix i naming
    identity index i + 1."""
    entries = {p: 100 + i for i, p in enumerate(prefixes)}
    t = build_lpm(entries, {100 + i: i + 1 for i in range(len(prefixes))},
                  0)
    return t.v4_nodes, t.v6_nodes


def _lpm_case(tries, addrs, v6, default_index=7, v4_only=False):
    addr = np.array([[(a >> s) & 0xFFFFFFFF for s in (96, 64, 32, 0)]
                     for a in addrs], dtype=np.uint32).reshape(-1, 4)
    return LpmCase(tries[0], tries[1], addr, np.asarray(v6, dtype=bool)
                   .reshape(-1), default_index, v4_only)


def _around(rng, base, lengths, bits, n_random):
    """``base``, and for each length the address with the bit just past it
    and the bit just inside it flipped, and ``n_random`` addresses that
    keep a random number of its leading bits. ``bits`` is 32 (v4) or
    128."""
    low = (1 << bits) - 1
    top = _addr(base) & ~low
    b = _addr(base) & low
    out = [b]
    for p in lengths:
        if p < bits:
            out.append(b ^ (1 << (bits - 1 - p)))
        if p > 0:
            out.append(b ^ (1 << (bits - p)))
    for keep in rng.integers(0, bits + 1, n_random):
        r = int.from_bytes(rng.bytes(bits // 8), "big")
        mask = low ^ ((1 << (bits - int(keep))) - 1)
        out.append((b & mask) | (r & ~mask & low))
    return [top | a for a in out]


def _lengths(rng, v6):
    bits, base, lengths = ((128, _V6_BASE, (0, 48, 60, 64, 127, 128)) if v6
                           else (32, _V4_BASE, (0, 1, 7, 8, 9, 12, 24, 31,
                                                32)))
    tries = _trie([f"{ipaddress.ip_network(f'{base}/{p}', strict=False)}"
                   for p in lengths])
    addrs = _around(rng, base, lengths, bits, 40)
    return _lpm_case(tries, addrs, [v6] * len(addrs), default_index=3)


def _listed(prefixes, probes, default_index=7):
    addrs = [_addr(a) for a in probes]
    return _lpm_case(_trie(prefixes), addrs,
                     [":" in a for a in probes], default_index)


def _same_cell():
    """/24, /25, /26 and /27 share the cells of one node; each of its 256
    bytes is probed, and one address past the /24."""
    return _listed(["10.0.0.0/24", "10.0.0.0/25", "10.0.0.64/26",
                    "10.0.0.96/27"],
                   [f"10.0.0.{i}" for i in range(256)] + ["10.0.1.5"])


_MISS_PREFIXES = ["10.1.2.0/24", "10.1.3.4/32", "2001:db8::1/128",
                  "2001:db8:0:1::/64"]
#: dies at v4 levels 0, 1, 3; v6 levels 0, 3, 15 and inside the /128's run
_MISS_PROBES = ["11.1.2.3", "10.2.2.3", "10.1.3.5", "10.1.2.9", "10.1.3.4",
                "3000::1", "2001:db9::1", "2001:db8::2", "2001:db8::1",
                "2001:db8::1:0:1", "2001:db8:0:1::77", "2001:db8:0:2::1"]


def _dead_not_inert(loop_to_root):
    """The misses' tries with values in every cell of the dead node (or,
    with ``loop_to_root``, half its cells leading back to the root): the
    walk runs to full depth, and a row that dies early picks up the dead
    node's value at the next level, as the reference does."""
    case = _listed(_MISS_PREFIXES, _MISS_PROBES)
    tries = []
    for nodes in (case.v4_nodes.copy(), case.v6_nodes.copy()):
        dead = nodes[-1]
        if loop_to_root:
            dead[::2, 0] = 0
        else:
            dead[:, 1] = 9
            dead[:, 2] = pack_pfx(40, 7)
        tries.append(nodes)
    return case._replace(v4_nodes=tries[0], v6_nodes=tries[1])


def _run_past_end():
    """A /128's last node keeps its one cell but trades the value for a
    child: the run of single-child nodes then runs past the last level."""
    case = _listed(["2001:db8::5:0:0:1/128", "10.0.0.0/8"],
                   ["2001:db8::5:0:0:1", "2001:db8::5:0:0:2", "10.9.9.9",
                    "2001:db8::5:0:1:1"])
    nodes = case.v6_nodes.copy()
    leaf = nodes.shape[0] - 2                 # the last node built
    nodes[leaf, 1] = [0, -1, -1]
    return case._replace(v6_nodes=nodes)


def _random_tries(rng, n_v4, n_v6):
    pfx = set()
    for _ in range(n_v4):
        p = int(rng.integers(1, 33))
        a = ipaddress.ip_address(int(rng.integers(0, 1 << 32)))
        pfx.add(str(ipaddress.ip_network(f"{a}/{p}", strict=False)))
    for _ in range(n_v6):
        p = int(rng.choice([16, 32, 48, 56, 60, 64, 96, 112, 127, 128]))
        a = ipaddress.ip_address(int.from_bytes(rng.bytes(16), "big"))
        pfx.add(str(ipaddress.ip_network(f"{a}/{p}", strict=False)))
    return sorted(pfx)


def _mixed_rows(rng, prefixes, n):
    """``n`` rows alternating v4 and v6 (every warp mixes families), each
    near one of ``prefixes`` or random."""
    nets = [ipaddress.ip_network(p) for p in prefixes]
    v4 = [x for x in nets if x.version == 4]
    v6 = [x for x in nets if x.version == 6]
    addrs, fam = [], []
    for j in range(n):
        six = j % 2 == 1
        pool, bits = (v6, 128) if six else (v4, 32)
        r = int.from_bytes(rng.bytes(bits // 8), "big")
        if pool and j % 5:
            net = pool[int(rng.integers(0, len(pool)))]
            keep = int(rng.integers(net.prefixlen, bits + 1)) if j % 3 \
                else net.prefixlen
            mask = ((1 << bits) - 1) ^ ((1 << (bits - keep)) - 1)
            r = (int(net.network_address) & mask) | (r & ~mask)
        addrs.append(r if six else r | (0xFFFF << 32))
        fam.append(six)
    return addrs, fam


def _lpm_cases(rng):
    cases = {"v4_lengths": _lengths(rng, False),
             "v6_lengths": _lengths(rng, True),
             "same_cell_overlap": _same_cell(),
             "value_and_child": _listed(
                 ["10.1.0.0/16", "10.1.2.0/24", "10.1.2.3/32"],
                 ["10.1.2.3", "10.1.2.4", "10.1.3.3", "10.1.200.1",
                  "10.2.0.0"]),
             "misses_at_levels": _listed(_MISS_PREFIXES, _MISS_PROBES),
             "run_value_end": _listed(
                 ["2001:db8:0:1::1/128", "2001:db8:0:2::1/128"],
                 ["2001:db8:0:1::1", "2001:db8:0:2::1", "2001:db8:0:1::2",
                  "2001:db8:0:1:0:0:1:1", "2001:db8:0:1:8000::1",
                  "2001:db8:0:3::1"]),
             "run_branch_middle": _listed(
                 ["2001:db8::1/128", "2001:db8::1:0:0:1/128"],
                 ["2001:db8::1", "2001:db8::1:0:0:1", "2001:db8::2:0:0:1",
                  "2001:db8::1:0:0:2", "2001:db8::1:0:1:1",
                  "2001:db8:1::1", "2001:db8::1:0:0:0"]),
             "run_value_middle": _listed(
                 ["2001:db8::/64", "2001:db8::1/128", "2001:db8::/32"],
                 ["2001:db8::1", "2001:db8::2", "2001:db8::1:0:0:1",
                  "2001:db8:0:1::1", "2001:db9::1"]),
             "run_past_last_level": _run_past_end(),
             "dead_node_values": _dead_not_inert(False),
             "dead_node_loops_to_root": _dead_not_inert(True)}
    prefixes = _random_tries(rng, 150, 100)
    tries = _trie(prefixes)
    addrs, fam = _mixed_rows(rng, prefixes, 300)
    mixed = _lpm_case(tries, addrs, fam, default_index=5)
    cases["warps_mix_families_n300"] = mixed
    cases["v4_only_with_v6_rows"] = mixed._replace(v4_only=True)
    cases["n_0"] = mixed._replace(addr=mixed.addr[:0],
                                  is_v6=mixed.is_v6[:0])
    cases["n_1"] = mixed._replace(addr=mixed.addr[1:2],
                                  is_v6=mixed.is_v6[1:2])
    cases["default_index_0"] = mixed._replace(default_index=0)
    return cases


# --------------------------------------------------------------------------- #
# K2
# --------------------------------------------------------------------------- #
def _table(cap):
    ct = {"keys": np.zeros((cap, KEY_WORDS), dtype=np.uint32)}
    ct.update({f: np.zeros((cap,), dtype=np.uint32) for f in CT_FIELDS[1:]})
    return ct


def _keys(rng, n, high=False):
    k = rng.integers(0, 1 << 32, (n, KEY_WORDS), dtype=np.uint64) \
        .astype(np.uint32)
    return k | np.uint32(0x80000000) if high else k


def _bases(keys, cap):
    h = hash_words_u64(torch.from_numpy(keys.view(np.int32).copy()))
    return (h & (cap - 1)).numpy()


def _place(ct, slot, key, expiry):
    """Write ``key`` live until ``expiry`` at ``slot`` unless it is taken."""
    if ct["expiry"][slot] or ct["keys"][slot].any():
        return False
    ct["keys"][slot] = key
    ct["expiry"][slot] = expiry & _M32
    return True


def _probe_case(ct, keys, rng, now, depth=PROBE_DEPTH):
    """The case probing ``keys`` plus a few absent keys forward, and the
    same rows in the other order in reverse."""
    fwd = np.concatenate([keys, _keys(rng, 4)])
    return ProbeCase(ct, fwd, fwd[::-1].copy(), now & _M32, depth)


def _wrap(rng, now):
    cap = 64
    ct = _table(cap)
    cand = _keys(rng, 4096)
    keys = cand[_bases(cand, cap) >= cap - 3][:8]
    for s in range(cap - 3, cap):           # the run's tail is taken, so
        _place(ct, s, _keys(rng, 1)[0], now + 100)   # every hit wraps
    for k, b in zip(keys, _bases(keys, cap)):
        for i in range(cap - b, PROBE_DEPTH):
            if _place(ct, (b + i) % cap, k, now + 100):
                break
    return _probe_case(ct, keys, rng, now)


def _expiry_edges(rng, _now):
    now = 0x80000000 + 1000
    cap = 256
    ct = _table(cap)
    expiries = (now - 1, now, now + 1, _M32, 0x7FFFFFFF, 0x80000000, 0,
                now + 0x10000)
    keys = _keys(rng, 24)
    for j, (k, b) in enumerate(zip(keys, _bases(keys, cap))):
        for i in range(PROBE_DEPTH):
            if _place(ct, (b + i) % cap, k, expiries[j % len(expiries)]):
                break
    return _probe_case(ct, keys, rng, now)


def _copies(rng, now, first_live):
    """Each key twice in its run, at offsets a < b; the copy at ``a`` is
    live or dead (expiry ``now``), the one at ``b`` live."""
    cap = 256
    ct = _table(cap)
    keys = _keys(rng, 16)
    for k, b in zip(keys, _bases(keys, cap)):
        lo, hi = sorted(rng.choice(PROBE_DEPTH, 2, replace=False))
        for i in range(lo):                  # other live keys in front
            _place(ct, (b + i) % cap, _keys(rng, 1)[0], now + 50)
        _place(ct, (b + lo) % cap, k, now + 7 if first_live else now)
        _place(ct, (b + hi) % cap, k, now + 9)
    return _probe_case(ct, keys, rng, now)


def _full_run(rng, now):
    """Every slot of each key's run live, holding the key with one word
    changed (each of the 10 words in turn)."""
    cap = 256
    ct = _table(cap)
    keys = _keys(rng, 6)
    for k, b in zip(keys, _bases(keys, cap)):
        for i in range(PROBE_DEPTH):
            near = k.copy()
            near[(i + int(b)) % KEY_WORDS] ^= np.uint32(1 << (i * 3))
            _place(ct, (b + i) % cap, near, now + 30)
    fwd = keys.copy()
    return ProbeCase(ct, fwd, fwd[::-1].copy(), now, PROBE_DEPTH)


def _depth(rng, now, depth):
    """Keys at the last offset the depth reaches (hits) and at the first
    one past it (misses)."""
    cap = 256
    ct = _table(cap)
    keys = _keys(rng, 16)
    for j, (k, b) in enumerate(zip(keys, _bases(keys, cap))):
        _place(ct, (b + depth - 1 + j % 2) % cap, k, now + 20)
    return _probe_case(ct, keys, rng, now, depth)


def _high_words(rng, now):
    cap = 256
    ct = _table(cap)
    keys = _keys(rng, 16, high=True)
    for k, b in zip(keys[:12], _bases(keys[:12], cap)):
        _place(ct, (b + rng.integers(0, PROBE_DEPTH)) % cap, k, now + 40)
    return _probe_case(ct, keys, rng, now)


def _probe_cases(rng):
    now = 5000
    return {
        "wrap": _wrap(rng, now),
        "expiry_edges": _expiry_edges(rng, now),
        "two_live_copies": _copies(rng, now, first_live=True),
        "dead_before_live": _copies(rng, now, first_live=False),
        "full_run_no_match": _full_run(rng, now),
        "depth_1": _depth(rng, now, 1),
        "depth_8": _depth(rng, now, 8),
        "high_words": _high_words(rng, now),
    }


# --------------------------------------------------------------------------- #
# K3
# --------------------------------------------------------------------------- #
N_IDS, N_ROWS, N_COLS, N_EPS, N_FAM, N_PORTS = 12, 6, 5, 2, 3, 65536
N_SETS, N_L7_RULES, WIDTH = 4, 3, C.L7_PATH_MAXLEN
GET, POST = C.HTTP_METHOD_IDS["GET"], C.HTTP_METHOD_IDS["POST"]
ANY = C.HTTP_METHOD_ANY
#: prefix lengths on each side of every 16-byte boundary, below 0, past 64
PATH_LENS = (-1, 0, 1, 15, 16, 17, 63, 64, 80)


def _policy_tables(rng):
    cells = rng.integers(0, 4, (N_EPS, 2, N_ROWS, N_COLS))
    l7 = rng.integers(0, N_SETS, cells.shape)
    verdict = np.where(cells == C.VERDICT_REDIRECT,
                       C.VERDICT_REDIRECT | (l7 << C.VERDICT_L7_SHIFT),
                       cells).astype(np.uint16)
    return {
        "id_class_of": rng.integers(0, N_ROWS, N_IDS).astype(np.int32),
        "proto_family": (np.arange(256) % N_FAM).astype(np.int32),
        "port_class": rng.integers(0, N_COLS, (N_FAM, N_PORTS))
        .astype(np.int32),
        "verdict": verdict,
        "enforced": np.array([[True, False], [True, True]]),
        "l7_methods": np.full((N_SETS, N_L7_RULES), ANY, dtype=np.uint8),
        "l7_valid": np.zeros((N_SETS, N_L7_RULES), dtype=bool),
        "l7_path_len": np.zeros((N_SETS, N_L7_RULES), dtype=np.int32),
        "l7_path": np.zeros((N_SETS, N_L7_RULES, WIDTH), dtype=np.uint8),
    }


def _rule(t, sid, r, method, prefix, plen=None, valid=True):
    t["l7_methods"][sid, r] = method
    t["l7_valid"][sid, r] = valid
    t["l7_path"][sid, r, :len(prefix)] = np.frombuffer(prefix, np.uint8)
    t["l7_path_len"][sid, r] = len(prefix) if plen is None else plen


def _redirect_all(t, l7_ids):
    """Every cell of endpoint 0 becomes REDIRECT to one of ``l7_ids``."""
    plane = t["verdict"][0]
    ids = np.resize(np.asarray(l7_ids), plane.size).reshape(plane.shape)
    t["verdict"][0] = (C.VERDICT_REDIRECT
                       | (ids << C.VERDICT_L7_SHIFT)).astype(np.uint16)


def _path(s):
    p = np.zeros((WIDTH,), dtype=np.uint8)
    p[:len(s)] = np.frombuffer(s, np.uint8)
    return p


def _rows(rng, n, methods, paths):
    """Random row inputs, 3 in 4 on endpoint 0, with the given requests."""
    est = rng.random(n) < 0.2
    return (np.where(rng.random(n) < 0.75, 0, 1).astype(np.int32),
            rng.integers(0, 2, n).astype(np.int32),
            rng.integers(0, N_IDS, n).astype(np.int32),
            rng.integers(0, 256, n).astype(np.int32),
            rng.integers(0, N_PORTS, n).astype(np.int32),
            np.asarray(methods, dtype=np.int32),
            np.asarray(paths, dtype=np.uint8),
            est, ~est & (rng.random(n) < 0.2), rng.random(n) < 0.9)


def _path_len(rng, plen):
    """Set 1's only valid rule has prefix length ``plen``; each request is
    the prefix with one byte changed around a boundary (or none)."""
    t = _policy_tables(rng)
    prefix = rng.integers(1, 256, WIDTH).astype(np.uint8)
    _rule(t, 1, 0, ANY, prefix.tobytes(), plen)
    _redirect_all(t, [1])
    spots = [None, 0, plen - 1, plen, plen + 1, 15, 16, 17, 31, 32, 47, 48,
             63]
    spots = [p for p in spots if p is None or 0 <= p < WIDTH]
    n = 64
    paths = np.tile(prefix, (n, 1))
    for j in range(n):
        p = spots[j % len(spots)]
        if p is not None:
            paths[j, p] ^= np.uint8(rng.integers(1, 256))
    return PolicyCase(t, _rows(rng, n, [GET] * n, paths))


def _method(rng):
    t = _policy_tables(rng)
    _rule(t, 2, 0, GET, b"/api")
    _rule(t, 2, 1, ANY, b"/pub")
    _redirect_all(t, [2])
    reqs = [(m, p) for m in (GET, POST, ANY, 8) for p in
            (b"/api/x", b"/pub/y", b"/nope")]
    n = 48
    return PolicyCase(t, _rows(rng, n, [reqs[j % len(reqs)][0]
                                        for j in range(n)],
                               [_path(reqs[j % len(reqs)][1])
                                for j in range(n)]))


def _set_clamp(rng):
    t = _policy_tables(rng)
    _rule(t, N_SETS - 1, 0, ANY, b"/clamp")
    _rule(t, 1, 0, ANY, b"/one")
    _redirect_all(t, [N_SETS - 1, N_SETS, N_SETS + 5, (1 << 14) - 1, 1])
    n = 48
    paths = [_path((b"/clamp/a", b"/one/b", b"/none")[j % 3])
             for j in range(n)]
    return PolicyCase(t, _rows(rng, n, [GET] * n, paths))


def _tokens(rng):
    t = _policy_tables(rng)
    _rule(t, 1, 0, ANY, b"/allowed")
    _redirect_all(t, [1])
    last = np.zeros((WIDTH,), dtype=np.uint8)
    last[WIDTH - 1] = 7
    reqs = [(ANY, np.zeros((WIDTH,), dtype=np.uint8)),     # no tokens
            (ANY, _path(b"/denied")), (GET, _path(b"")),
            (GET, _path(b"/allowed/x")), (ANY, last), (POST, _path(b"/"))]
    n = 48
    return PolicyCase(t, _rows(rng, n, [reqs[j % len(reqs)][0]
                                        for j in range(n)],
                               [reqs[j % len(reqs)][1] for j in range(n)]))


def _valid_second(rng):
    t = _policy_tables(rng)
    _rule(t, 1, 0, ANY, b"/first", valid=False)
    _rule(t, 1, 1, ANY, b"/second")
    _redirect_all(t, [1])
    n = 48
    paths = [_path((b"/first/a", b"/second/b", b"/third")[j % 3])
             for j in range(n)]
    return PolicyCase(t, _rows(rng, n, [GET] * n, paths))


def _out_of_range(rng):
    t = _policy_tables(rng)
    _rule(t, 1, 0, ANY, b"/x")
    lo, hi = -(1 << 31), (1 << 31) - 1
    n = 60
    ep, d, ids, proto, dport, meth, path, est, reply, valid = _rows(
        rng, n, [GET] * n, [_path(b"/x/y" if j % 2 else b"/z")
                            for j in range(n)])
    for col, bad in ((ep, (-1, 2, 5, hi, lo)), (d, (-1, 2, 7, hi, lo)),
                     (ids, (-3, N_IDS, N_IDS + 100, hi, lo)),
                     (proto, (-1, 256, 1000, hi, lo)),
                     (dport, (-1, N_PORTS, 70000, hi, lo))):
        at = rng.choice(n, n // 2, replace=False)
        col[at] = np.resize(np.asarray(bad, dtype=np.int64), at.shape[0])
    return PolicyCase(t, (ep, d, ids, proto, dport, meth, path, est, reply,
                          valid))


def _policy_cases(rng):
    cases = {f"path_len_{p}": _path_len(rng, p) for p in PATH_LENS}
    cases.update({"method_any_vs_exact": _method(rng),
                  "set_id_clamp": _set_clamp(rng),
                  "redirect_tokens": _tokens(rng),
                  "valid_second_rule": _valid_second(rng),
                  "out_of_range_rows": _out_of_range(rng)})
    return cases


# --------------------------------------------------------------------------- #
def edge_cases(seed: int = 0):
    """→ ({name: ProbeCase}, {name: PolicyCase}, {name: LpmCase}), all
    from one generator."""
    rng = np.random.default_rng(seed)
    probe, policy = _probe_cases(rng), _policy_cases(rng)
    return probe, policy, _lpm_cases(rng)


def lpm_args(case: LpmCase, device):
    """→ ``lpm_lookup_*``'s arguments (lpm_v4, lpm_v6, addr_words, is_v6,
    default_index, v4_only)."""
    return (torch.tensor(case.v4_nodes, device=device),
            torch.tensor(case.v6_nodes, device=device),
            torch.tensor(case.addr.view(np.int32), device=device),
            torch.tensor(case.is_v6, device=device), case.default_index,
            case.v4_only)


def probe_args(case: ProbeCase, device):
    """→ ``ct_probe_pair_*``'s arguments (ct, fwd, rev, now, depth)."""
    return (convert.ct_to_torch(case.ct, device),
            torch.tensor(case.fwd.view(np.int32), device=device),
            torch.tensor(case.rev.view(np.int32), device=device),
            case.now, case.depth)


def policy_args(case: PolicyCase, device):
    """→ ``policy_verdict_*``'s arguments (tensors, then the ten rows)."""
    return (convert.snapshot_tensors_to_torch(case.tensors, device),
            *(torch.tensor(r, device=device) for r in case.rows))


def fingerprint_rows(n: int, seed: int) -> Dict[str, np.ndarray]:
    """``n`` host rows for the flow-fingerprint kernel: a third v4-mapped,
    the rest random v6 words; both directions; one row in four invalid and
    holding any int32 in its port, protocol and direction columns."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (2, n, 4), dtype=np.uint64) \
        .astype(np.uint32)
    words[:, np.arange(n) % 3 == 0, :3] = [0, 0, 0xFFFF]
    b = {"src": words[0], "dst": words[1],
         "sport": rng.integers(0, 1 << 16, n).astype(np.int32),
         "dport": rng.integers(0, 1 << 16, n).astype(np.int32),
         "proto": rng.choice([1, 6, 17, 58], n).astype(np.int32),
         "direction": (np.arange(n) % 2).astype(np.int32),
         "valid": np.arange(n) % 4 != 3}
    junk = ~b["valid"]
    for k in ("sport", "dport", "proto", "direction"):
        b[k][junk] = rng.integers(-(1 << 31), 1 << 31, int(junk.sum()))
    return b
