#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``cilium_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with one CUDA device visible::

    python3 chip_smoke.py [--seed N] [--profile]

Phases, each reporting one line (any failure exits non-zero and prints no
result line):

1. device  — requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` does;
2. build   — builds the three kernels from ``cilium_tpu_torch/csrc/``;
3. kernels — runs K1 (LPM walk), K2 (CT probe pair) and K3 (policy + L7 +
   verdict) at the main path's shapes against their plain torch versions
   on seeded inputs covering v4 and v6, hits, misses and expired slots,
   REDIRECT cells with passing and failing L7, and unenforced directions,
   then K1, K2 and K3 on every case of ``kernels/edge_cases.py``; exact
   equality. K1's line adds the dependent loads a row waits on
   (``chain_mean``, ``chain_max``: 4 a row for a v4-only launch, which
   walks the trie's own planes; else counted by the plain version of the
   kernel's walk over the derived tables) and the build time and bytes of
   the derived tables (``derive_ms``, ``derived_bytes``; 0 for a v4-only
   launch, which derives nothing). Each kernel is timed at both worlds'
   widths:
   ``ms``      device time per launch with L2 cold (evict-last lines
               demoted and a 256 MB write before each of 20 launches),
               from ``torch.profiler``;
   ``hot_ms``  the same over 50 back-to-back launches, no flush;
   ``host_ms`` host time per wrapper call (200 calls, no synchronise);
   beside its plain version's time and its bound (the bytes the work
   needs over the HBM rate);
4. cfg5    — the main path: the cfg5 world (2^21-slot CT, 1M flows, 100 MB
   verdict image) through ``make_classify_fn(packed=True)``: warm the CT
   with every flow, then churn batches of 65,536; two batches are also run
   by the plain path from a copy of the same CT and must match in every
   out column, counter and CT array; every kernel must have launched;
5. mixed   — the v4/v6 + L7 world at batch 4,096 on the L7-dict wire,
   every batch held against the plain path the same way.

``--profile`` adds each main-path phase's device time by op and each
kernel's device time per launch on the path (``path_ms``).

Then it prints the kernels' JSON line, the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

#: H100 SXM device-memory rate (NVIDIA data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12
#: bytes written before each cold launch: five times the H100's 50 MB L2
L2_FLUSH_BYTES = 256 << 20
#: where the worlds live and at what size (a rehearsal on the CPU sets
#: "cpu" and "smoke"; a chip run keeps these)
DEVICE = "cuda"
PRESET = "full"

#: wrapper → (source, the TPU kernel it replaces, the CUDA kernel's name)
KERNELS = {
    "lpm_lookup_fused": ("cilium_tpu_torch/csrc/lpm_lookup.cu",
                         "cilium_tpu/kernels/fused.py:134",
                         "lpm_lookup_kernel"),
    "ct_probe_pair_fused": ("cilium_tpu_torch/csrc/ct_probe_pair.cu",
                            "cilium_tpu/kernels/fused.py:183",
                            "ct_probe_pair_kernel"),
    "policy_verdict_fused": ("cilium_tpu_torch/csrc/policy_verdict.cu",
                             "cilium_tpu/kernels/fused.py:219",
                             "policy_verdict_kernel"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0 and r.stdout.strip(),
          f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds per call of ``fn`` on the current stream (host
    and device together: for the plain versions, many small ops)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(events, symbol):
    """(launches, device ms per launch) of the CUDA kernel named
    ``symbol`` in a profiler's ``key_averages()``; (0, None) if absent."""
    hits = [e for e in events
            if symbol in e.key and e.self_device_time_total > 0]
    count = sum(e.count for e in hits)
    if not count:
        return 0, None
    return count, sum(e.self_device_time_total for e in hits) / count / 1e3


def flush_l2(buf):
    """Leave L2 cold: demote every line a kernel loaded with an evict_last
    policy to normal priority (``cuCtxResetPersistingL2Cache`` of
    libcuda; a normal write would pass such lines over), then write
    ``buf``, which is larger than L2. Waits for the device first, so that
    no launch still queued marks lines after the reset."""
    import ctypes

    import torch
    torch.cuda.synchronize()
    rc = ctypes.CDLL("libcuda.so.1").cuCtxResetPersistingL2Cache()
    check(rc == 0, f"cuCtxResetPersistingL2Cache failed (CUresult {rc})")
    buf.fill_(1)


def device_ms(fn, symbol, launches, flush=None, tries=3):
    """Device time per launch (ms) of the kernel ``symbol`` over
    ``launches`` calls of ``fn``, from ``torch.profiler``. With ``flush``
    (a device buffer larger than L2), each call follows ``flush_l2``, so
    the kernel finds L2 cold. The profiler now and then drops some
    launches' records; each record it keeps is one launch's own device
    time, so the mean is taken over those. A window in which it kept
    fewer than half is run again, and after ``tries`` such windows the
    run fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                if flush is not None:
                    flush_l2(flush)
                fn()
            torch.cuda.synchronize()
        count, ms = kernel_device_ms(prof.key_averages(), symbol)
        if launches <= 2 * count <= 2 * launches:
            return ms
    raise SmokeFailure(f"the profiler kept {count} records of {symbol} "
                       f"for {launches} launches, in {tries} windows")


def host_ms(fn, calls=200):
    """Host milliseconds per call of ``fn`` with no synchronise between
    calls: what a wrapper costs the host-bound step."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e3


def max_abs_err(got, want):
    import torch
    err = 0
    for g, w in zip(got, want, strict=True):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"shape/dtype {tuple(g.shape)} {g.dtype} vs "
              f"{tuple(w.shape)} {w.dtype}")
        if g.numel():
            d = (g.to(torch.int64) - w.to(torch.int64)).abs().max()
            err = max(err, int(d))
    return err


def same(a, b, what):
    import torch
    for k in a:
        check(torch.equal(a[k], b[k]), f"{what}: {k} differs")


# --------------------------------------------------------------------------- #
# bytes each kernel's work needs (inputs once, outputs once, and of each
# table only the entries these inputs touch)
# --------------------------------------------------------------------------- #
def unique_count(idx):
    import torch
    return int(torch.unique(idx.reshape(-1)).numel())


def lpm_bytes(t, addr, is_v6, v4_only):
    import torch
    from cilium_tpu_torch.kernels.hashing import u32
    n = addr.shape[0]
    words = u32(addr)
    touched = 0
    fams = [("lpm_v4", 12, 4, torch.ones(n, dtype=torch.bool,
                                          device=addr.device))]
    if not v4_only:
        fams = [("lpm_v4", 12, 4, ~is_v6), ("lpm_v6", 0, 16, is_v6)]
    for name, first, levels, rows in fams:
        nodes = t[name].reshape(-1, 3)
        dead = t[name].shape[0] - 1
        node = torch.zeros(n, dtype=torch.int64, device=addr.device)
        seen = []
        for level in range(levels):
            pos = first + level
            b = (words[:, pos // 4] >> (8 * (3 - pos % 4))) & 0xFF
            at = node * 256 + b
            seen.append(at[rows])
            child = nodes[at, 0]
            node = torch.where(child >= 0, child, dead).to(torch.int64)
        touched += unique_count(torch.cat(seen)) * 12
    return n * 16 + (0 if v4_only else n) + touched + n * 8


def ct_probe_bytes(ct, fwd, rev, now, depth):
    import torch
    from cilium_tpu_torch.kernels.hashing import hash_words_u64, u32
    cap = ct["expiry"].shape[0]
    exp_slots, key_slots = [], []
    for keys in (fwd, rev):
        base = hash_words_u64(keys) & (cap - 1)
        done = torch.zeros(keys.shape[0], dtype=torch.bool,
                           device=keys.device)
        for i in range(depth):
            s = (base + i) & (cap - 1)
            live = u32(ct["expiry"][s]) > (now & 0xFFFFFFFF)
            exp_slots.append(s[~done])
            key_slots.append(s[~done & live])
            done = done | (live & (ct["keys"][s] == keys).all(-1))
    n = fwd.shape[0]
    return (2 * n * 40 + unique_count(torch.cat(exp_slots)) * 4
            + unique_count(torch.cat(key_slots)) * 40 + 2 * n * 4)


def policy_bytes(t, rows):
    import torch
    from cilium_tpu_torch.kernels.classify import interior_pre_core
    ep, d, id_idx, proto, dport, meth, path = rows[:7]
    n = ep.shape[0]
    n_ids = t["id_class_of"].shape[0]
    idc = id_idx.to(torch.int64).clamp(0, n_ids - 1)
    pf = proto.to(torch.int64).clamp(0, 255)
    fam = t["proto_family"][pf].to(torch.int64)
    n_ports = t["port_class"].shape[1]
    pc_at = fam * n_ports + dport.to(torch.int64).clamp(0, n_ports - 1)
    _e, _two, n_rows, n_cols = t["verdict"].shape
    cls = t["id_class_of"][idc].to(torch.int64).clamp(0, n_rows - 1)
    pcls = t["port_class"].reshape(-1)[pc_at].to(torch.int64) \
        .clamp(0, n_cols - 1)
    epd = ep.to(torch.int64) * 2 + d.to(torch.int64)
    cell = (epd * n_rows + cls) * n_cols + pcls
    decision, _enf, redirect, _fail, _m = interior_pre_core(
        t, ep, d, id_idx, proto, dport, meth, path)
    l7_id = (t["verdict"].reshape(-1)[cell].to(torch.int64) & 0xFFFF) >> 2
    # only rows with a REDIRECT cell and an L7 set read their request
    l7_rows = redirect & (l7_id > 0)
    sets = l7_id[l7_rows]
    n_rules = t["l7_methods"].shape[1]
    l7 = unique_count(sets) * n_rules * (1 + 1 + 4 + 64) if sets.numel() \
        else 0
    table = (unique_count(idc) * 4 + unique_count(pf) * 4
             + unique_count(pc_at) * 4 + unique_count(cell) * 2
             + unique_count(epd) + l7)
    return (n * (5 * 4 + 3) + int(l7_rows.sum()) * (4 + 64) + table
            + n * 14)


def bound_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #
def remote_words(b):
    import torch
    return torch.where((b["direction"] == 0)[:, None], b["dst"], b["src"])


def kernel_inputs(world, seed):
    """A main-path batch of ``world`` unpacked on the card, with one row in
    eight aimed at a random (mostly unmatched) address."""
    import numpy as np
    from cilium_tpu_torch.kernels.records import unpack_wire, wire_to_torch
    raw = world.next_batch()
    rng = np.random.default_rng(seed)
    miss = np.arange(raw["valid"].shape[0]) % 8 == 7
    for col in ("src", "dst"):
        v6 = raw["is_v6"][miss]
        rnd = rng.integers(0, 1 << 32, (int(miss.sum()), 4),
                           dtype=np.uint64).astype(np.uint32)
        rnd[~v6, :3] = [0, 0, 0xFFFF]
        raw[col][miss] = rnd
    return unpack_wire(wire_to_torch(world.pack(raw), DEVICE))


def hold(kernel, world, args, kernel_fn, plain_fn, nbytes, report, card,
         flush):
    """Hold one kernel against its plain version on ``args`` (exact), time
    both, and fill its report entry: at cfg5 width (the main path's) the
    top-level fields, at mixed width its ``mixed`` entry.
    → (plain outputs, the phase line)."""
    got = kernel_fn(*args)
    want = plain_fn(*args)
    err = max_abs_err(got, want)
    check(err == 0, f"{kernel} {world.name}: kernel != plain (max err {err})")
    symbol = KERNELS[kernel][2]
    ms = device_ms(lambda: kernel_fn(*args), symbol, 20, flush)
    hot = device_ms(lambda: kernel_fn(*args), symbol, 50)
    host = host_ms(lambda: kernel_fn(*args))
    plain_ms = cuda_ms(lambda: plain_fn(*args), 10)
    entry = dict(max_abs_err=err, ms=ms, hot_ms=hot, host_ms=host,
                 plain_ms=plain_ms, bound_ms=bound_ms(nbytes))
    if world.name == "cfg5":
        report[kernel].update(entry)
    else:
        report[kernel][world.name] = entry
    return want, (f"{kernel} {world.name}: n={want[0].shape[0]} exact, "
                  f"ms={ms:.6f} hot_ms={hot:.6f} host_ms={host:.6f} "
                  f"plain_ms={plain_ms:.6f} bytes={nbytes} "
                  f"bound_ms={bound_ms(nbytes):.6f} [{card}]")


def policy_rows(b, idx, gen):
    """K3's ten row inputs for batch ``b`` with identity indices ``idx``,
    est and reply drawn from ``gen``."""
    import torch
    m = b["valid"].shape[0]
    est = torch.rand(m, generator=gen, device=DEVICE) < 0.3
    reply = ~est & (torch.rand(m, generator=gen, device=DEVICE) < 0.2)
    return (b["ep_slot"], b["direction"], idx, b["proto"], b["dport"],
            b["http_method"], b["http_path"], est, reply, b["valid"])


def probe_case(world, seed):
    """K2 inputs at ``world``'s width: a table of the world's cap filled by
    the plain path at now=1000 from alternating SYN (60 s) and ACK
    batches, probed at 1100 by live forward keys, expired keys, reversed
    live keys (reply hits) and fresh rows."""
    import torch
    from cilium_tpu_torch.compile.ct_layout import CTConfig, make_ct_arrays
    from cilium_tpu_torch.kernels.classify import make_classify_fn
    from cilium_tpu_torch.kernels.conntrack import (ct_key_words_pair,
                                                    reverse_key_words)
    from cilium_tpu_torch.kernels.records import unpack_wire, wire_to_torch
    from cilium_tpu_torch.utils import constants as C
    ct = make_ct_arrays(CTConfig(capacity=world.ct["expiry"].shape[0]),
                        DEVICE)
    fill = make_classify_fn(v4_only=world.v4_only, packed=True, fused=False,
                            device=DEVICE)
    batches = list(world.warm_batches()) or [world.next_batch()
                                             for _ in range(4)]
    for i, raw in enumerate(batches):
        raw["tcp_flags"][:] = C.TCP_SYN if i % 2 else C.TCP_ACK
        fill(world.tensors, ct, world.pack(raw), 1000, world.world_index)
    live, dead = (ct_key_words_pair(unpack_wire(wire_to_torch(
        world.pack(batches[i]), DEVICE))) for i in (0, 1))
    fresh = ct_key_words_pair(kernel_inputs(world, seed))[0]
    n = world.batch
    q = n // 5
    fwd = torch.cat([live[0][:2 * q], dead[0][:q], live[1][2 * q:3 * q],
                     fresh[:n - 4 * q]])
    return ct, fwd, reverse_key_words(fwd), 1100


def phase_kernels(cfg5, mixed, seed, report, card):
    """K1, K2 and K3 held against their plain versions at both worlds'
    widths (cfg5 is the main path's); → phase lines."""
    import torch
    from cilium_tpu_torch.kernels import fused as fk
    from cilium_tpu_torch.utils import constants as C

    lines = []
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device=DEVICE)
    for w in (cfg5, mixed):
        # K1: v4_only at cfg5, both families at mixed; 1 row in 8 misses
        b = kernel_inputs(w, seed)
        largs = (w.tensors["lpm_v4"], w.tensors["lpm_v6"], remote_words(b),
                 b["is_v6"], w.world_index, w.v4_only)
        (idx, meta), line = hold(
            "lpm_lookup_fused", w, largs, fk.lpm_lookup_fused,
            fk.lpm_lookup_plain,
            lpm_bytes(w.tensors, largs[2], largs[3], w.v4_only), report, card,
            flush)
        hits = int((meta >= 0).sum())
        check(0 < hits < meta.numel(), f"K1 {w.name}: no hit/miss mix")
        extra = lpm_derived_stats(w, largs, (idx, meta))
        (report["lpm_lookup_fused"] if w is cfg5
         else report["lpm_lookup_fused"][w.name]).update(extra)
        line += " " + " ".join(f"{k}={v}" for k, v in extra.items())
        check(w.v4_only or (bool(b["is_v6"].any())
                            and bool((~b["is_v6"]).any())),
              f"K1 {w.name}: batch lacks a family")
        lines.append(f"{line} hits={hits}")

        # K2: live, expired, reply and fresh keys at the world's CT size
        ct, fwd, rev, now = probe_case(w, seed + 1)
        pargs = (ct, fwd, rev, now, 8)
        (fs, rs), line = hold(
            "ct_probe_pair_fused", w, pargs, fk.ct_probe_pair_fused,
            fk.ct_probe_pair_plain, ct_probe_bytes(ct, fwd, rev, now, 8),
            report, card, flush)
        fh, rh = int((fs >= 0).sum()), int((rs >= 0).sum())
        check(fh > 0 and rh > 0 and fh + rh < 2 * fs.numel(),
              f"K2 {w.name}: no hit/miss mix")
        lines.append(f"{line} fwd_hits={fh} rev_hits={rh}")
        del ct

        # K3: random est/reply; mixed carries REDIRECT cells, passing and
        # failing L7 and the unenforced egress direction
        rows = policy_rows(b, idx, gen)
        (allow, reason, _s, redirect, _m), line = hold(
            "policy_verdict_fused", w, (w.tensors, *rows),
            fk.policy_verdict_fused, fk.policy_verdict_plain,
            policy_bytes(w.tensors, rows), report, card, flush)
        reasons = sorted(int(r) for r in torch.unique(reason))
        if w is mixed:
            check(bool(redirect.any()), "K3 mixed: no REDIRECT row")
            check(int(C.DropReason.POLICY_L7) in reasons,
                  "K3 mixed: no failing L7 row")
            check(bool((redirect & allow & (b["http_method"] != 255)).any()),
                  "K3 mixed: no passing L7 row")
            check(bool(((b["direction"] == 0) & allow).any()),
                  "K3 mixed: no unenforced-direction row")
        lines.append(f"{line} reasons={reasons} "
                     f"redirect={int(redirect.sum())}")
    return lines + [edge_line(seed)]


def lpm_derived_stats(world, largs, want):
    """K1's derived tables built anew on the card (host clock around the
    build, synchronised), their bytes, and the dependent loads per row of
    the plain version of the kernel's walk over them, whose results must
    equal ``want``. A v4-only launch walks the trie's planes, 4 levels a
    row, and derives nothing. → the fields K1's report and line add."""
    import torch
    from cilium_tpu_torch.kernels.lpm import lpm_derive, lpm_walk_derived
    v4, v6, addr, is_v6, default, v4_only = largs
    if v4_only:
        return {"chain_mean": 4.0, "chain_max": 4, "derive_ms": 0.0,
                "derived_bytes": 0}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d4, d6 = lpm_derive(v4), lpm_derive(v6)
    torch.cuda.synchronize()
    derive_ms = (time.perf_counter() - t0) * 1e3
    idx, meta, steps = lpm_walk_derived(d4, d6, addr, is_v6, default)
    check(torch.equal(idx, want[0]) and torch.equal(meta, want[1]),
          f"K1 {world.name}: the derived walk differs from the plain one")
    return {"chain_mean": float(steps.float().mean()),
            "chain_max": int(steps.max()), "derive_ms": derive_ms,
            "derived_bytes": sum(t.numel() * 4 for d in (d4, d6)
                                 for t in d)}


def edge_line(seed):
    """K1, K2 and K3 on every case of ``kernels/edge_cases.py``, exact
    against their plain versions; → the phase line."""
    from cilium_tpu_torch.kernels import fused as fk
    from cilium_tpu_torch.kernels.edge_cases import (edge_cases, lpm_args,
                                                     policy_args, probe_args)
    probe, policy, lpm = edge_cases(seed)
    for name, case in lpm.items():
        args = lpm_args(case, DEVICE)
        err = max_abs_err(fk.lpm_lookup_fused(*args),
                          fk.lpm_lookup_plain(*args))
        check(err == 0, f"K1 edge case {name}: max err {err}")
    for name, case in probe.items():
        args = probe_args(case, DEVICE)
        err = max_abs_err(fk.ct_probe_pair_fused(*args),
                          fk.ct_probe_pair_plain(*args))
        check(err == 0, f"K2 edge case {name}: max err {err}")
    for name, case in policy.items():
        args = policy_args(case, DEVICE)
        err = max_abs_err(fk.policy_verdict_fused(*args),
                          fk.policy_verdict_plain(*args))
        check(err == 0, f"K3 edge case {name}: max err {err}")
    return (f"edge cases: K1 {len(lpm)}, K2 {len(probe)} and K3 "
            f"{len(policy)} cases exact (max_abs_err 0)")


def drive(world, fn, fn_plain, wires, now0, compare_at):
    """Run ``wires`` through ``fn`` (CT in place); at the indices in
    ``compare_at`` also run ``fn_plain`` from a copy of the same CT and
    require identical results. → (batch seconds, last out, counters)."""
    import torch
    seconds, out, counters = [], None, None
    for i, wire in enumerate(wires):
        now = now0 + i
        if i in compare_at:
            ct_copy = {k: v.clone() for k, v in world.ct.items()}
            out_p, ct_p, cnt_p = fn_plain(world.tensors, ct_copy, wire, now,
                                          world.world_index)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ct, counters = fn(world.tensors, world.ct, wire, now,
                                world.world_index)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if i in compare_at:
            same(out_p, out, f"{world.name} batch {i} out")
            same(cnt_p, counters, f"{world.name} batch {i} counters")
            same(ct_p, world.ct, f"{world.name} batch {i} ct")
    return seconds, out, counters


def percentile_ms(seconds, q):
    import numpy as np
    return float(np.percentile(np.asarray(seconds) * 1e3, q))


def profile_lines(world, fn, wires, now0, label):
    """Device time by op over a few batches, the device's busy share of
    the wall time, and each kernel's device time per launch
    (``torch.profiler``, profiler on). → (lines, {"wall_ms", "busy_ms",
    "path_ms": {kernel: ms or None}})."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, wire in enumerate(wires):
            fn(world.tensors, world.ct, wire, now0 + i, world.world_index)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in ops)
    lines = [f"{label} profile: {len(wires)} batches, wall "
             f"{wall * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
             f"(share {busy_us / 1e6 / wall:.4f})"]
    for e in ops[:14]:
        lines.append(f"{label} profile: {e.key[:70]} x{e.count} "
                     f"device {e.self_device_time_total / 1e3:.3f} ms, "
                     f"host {e.self_cpu_time_total / 1e3:.3f} ms")
    path_ms = {}
    for kernel, (_src, _rep, symbol) in KERNELS.items():
        count, ms = kernel_device_ms(ops, symbol)
        path_ms[kernel] = ms
        lines.append(f"{label} profile: kernel {kernel} x{count} " + (
            f"device {ms:.6f} ms per launch" if count else
            "no device time seen"))
    return lines, {"wall_ms": wall * 1e3, "busy_ms": busy_us / 1e3,
                   "path_ms": path_ms}


def phase_cfg5(world, card, report, profile=False):
    import torch
    from cilium_tpu_torch.kernels import fused as fk
    from cilium_tpu_torch.kernels.classify import make_classify_fn
    fn = make_classify_fn(v4_only=True, packed=True, donate_ct=True,
                          device=DEVICE)
    fn_plain = make_classify_fn(v4_only=True, packed=True, donate_ct=True,
                                fused=False, device=DEVICE)
    warm = [world.pack(b) for b in world.warm_batches()]
    churn = [world.pack(world.next_batch()) for _ in range(24)]
    fk.reset_launches()
    t0 = time.perf_counter()
    drive(world, fn, fn_plain, warm, 1000, ())
    warm_s = time.perf_counter() - t0
    occupancy = int((world.ct["expiry"] != 0).sum())
    seconds, out, counters = drive(world, fn, fn_plain, churn, 1001, (4, 17))
    launches = dict(fk.LAUNCHES)
    for k, v in launches.items():
        check(v > 0, f"cfg5: kernel {k} never launched on the main path")
        report[k]["launches"] = v
    valid_rows = world.batch
    allow = float(out["allow"].float().mean())
    est = float((out["status"] == 1).float().mean())
    check(allow > 0.9, f"cfg5: allow rate {allow} (flows are allowed)")
    check(est > 0.5, f"cfg5: established share {est}")
    check(occupancy >= 0.9 * world.n_flows,
          f"cfg5: CT holds {occupancy} of {world.n_flows} flows after warm")
    check(bool(torch.isin(out["reason"], torch.tensor(
        [0, 137], device=DEVICE)).all()), "cfg5: unexpected drop reason")
    steady = seconds[2:]
    fps = valid_rows * len(steady) / sum(steady)
    prof = []
    if profile:
        prof, stats = profile_lines(world, fn, churn[:4], 2000, "cfg5")
        for k, ms in stats["path_ms"].items():
            report[k]["path_ms"] = ms
    return prof + [
            f"cfg5 warm: {len(warm)} batches, {warm_s:.3f} s, CT occupancy "
            f"{occupancy}",
            f"cfg5: {fps:.0f} flows/s, p50 {percentile_ms(steady, 50):.3f} "
            f"ms, p99 {percentile_ms(steady, 99):.3f} ms per batch of "
            f"{valid_rows} (allow {allow:.4f}, established {est:.4f}, "
            f"insert_fail {int(counters['insert_fail'])}) [{card}]",
            f"cfg5 launches: {json.dumps(launches)}"]


def phase_mixed(world, card, report, profile=False):
    import torch
    from cilium_tpu_torch.kernels import fused as fk
    from cilium_tpu_torch.kernels.classify import make_classify_fn
    fn = make_classify_fn(packed=True, donate_ct=True, device=DEVICE)
    fn_plain = make_classify_fn(packed=True, donate_ct=True, fused=False,
                                device=DEVICE)
    wires = [world.pack(world.next_batch()) for _ in range(12)]
    fk.reset_launches()
    seconds, out, _c = drive(world, fn, fn_plain, wires, 1000,
                             set(range(len(wires))))
    launches = dict(fk.LAUNCHES)
    for k, v in launches.items():
        check(v > 0, f"mixed: kernel {k} never launched")
    check(bool(out["redirect"].any()), "mixed: no redirect rows")
    check(bool((out["reason"] == 180).any()), "mixed: no L7 drops")
    check(bool((out["status"] == 1).any()), "mixed: no established rows")
    steady = seconds[2:]
    prof = []
    if profile:
        prof, stats = profile_lines(world, fn, wires[:4], 2000, "mixed")
        for k, ms in stats["path_ms"].items():
            report[k]["mixed"]["path_ms"] = ms
    return prof + [
            f"mixed: {world.batch * len(steady) / sum(steady):.0f} flows/s, "
            f"p50 {percentile_ms(steady, 50):.3f} ms, p99 "
            f"{percentile_ms(steady, 99):.3f} ms per batch of {world.batch}, "
            f"all {len(wires)} batches equal to the plain path "
            f"(allow {float(out['allow'].float().mean()):.4f}) [{card}]",
            f"mixed launches: {json.dumps(launches)}"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print each phase's device time by op")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from cilium_tpu_torch.kernels import _build
        from cilium_tpu_torch.world import make_world
    except ImportError as e:
        print(f"chip_smoke: the cilium_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 3
    phase = "device"
    try:
        card = card_line()
        name = torch.cuda.get_device_name(0)
        print(f"phase device: {name} x{torch.cuda.device_count()} "
              f"(torch {torch.__version__}, CUDA {torch.version.cuda}) "
              f"[{card}]", flush=True)

        phase = "build"
        t0 = time.perf_counter()
        per = _build.build_all(verbose=True)
        print(f"phase build: {time.perf_counter() - t0:.2f} s "
              f"{json.dumps({k: round(v, 2) for k, v in per.items()})}",
              flush=True)

        phase = "kernels"
        report = {k: {"name": k, "route": "cuda", "source": src,
                      "replaces": rep, "launches": 0, "max_abs_err": None,
                      "ms": None, "plain_ms": None, "bound_ms": None,
                      "bound_by": "bytes", "library_ms": None,
                      "hot_ms": None, "host_ms": None, "path_ms": None}
                  for k, (src, rep, _symbol) in KERNELS.items()}
        t0 = time.perf_counter()
        cfg5 = make_world("cfg5", seed=args.seed, device=DEVICE,
                          preset=PRESET)
        mixed = make_world("mixed", seed=args.seed, device=DEVICE,
                           preset=PRESET)
        print(f"phase worlds: {time.perf_counter() - t0:.2f} s", flush=True)
        for line in phase_kernels(cfg5, mixed, args.seed, report, card):
            print(f"phase kernels: {line}", flush=True)

        phase = "cfg5"
        for line in phase_cfg5(cfg5, card, report, args.profile):
            print(f"phase {line}", flush=True)
        del cfg5

        phase = "mixed"
        for line in phase_mixed(mixed, card, report, args.profile):
            print(f"phase {line}", flush=True)
        torch.cuda.synchronize()
    except Exception as e:        # every phase failure ends the run
        print(f"chip_smoke: phase {phase} failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1

    print(json.dumps({"kernels": list(report.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
