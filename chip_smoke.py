#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``cilium_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with one CUDA device visible::

    python3 chip_smoke.py [--seed N] [--profile]

Phases, each reporting one line (any failure exits non-zero and prints no
result line). A ``torch.profiler`` session with CUDA activity leaves every
later launch of its process slower on the host, so every phase whose
readings are host-bound (``HOST_BOUND``) runs before any profiler session
of the process, and refuses to start after one (``host_bound``); every
profiled measurement waits for the last phase, profile:

1. device  — requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` does;
2. build   — builds the three kernels from ``cilium_tpu_torch/csrc/``;
3. ddos    — cfg6's drop storm (``bench.py``'s ``ddos_bench``), run first,
   before any other phase has left state in the process, through the
   port's ``Engine`` → pipeline → ``TorchDatapath`` (kernels on), the CT
   at Cilium's default ``bpf-ct-global-tcp-max`` (2^19 slots; its bytes
   from ``ct_layout``), batches of 65,536: 65,536 established legit flows
   (172.16/16 → web:443, ``_prio`` 0) beside a flood of 4 batches an
   iteration (40% junk to unknown identities, 60% SYNs from 10/8 to the
   open port 80, ``_prio`` 1); GC chunks of 2^16, 8 in emergency with a
   56 s TTL slash; the ladder at 0.8/0.5, up 1 tick, down 4; logical
   time; the auditor at sampling 1.0. The flood saturates the CT (tail
   evictions, CT_FULL fails closed), then arrives faster than the worker
   is let through (``DrainGate``: 3 dispatches an iteration), the ladder
   climbs to SHED-NEW and the flood is shed at harvest
   (``shed_new_rows``), held 20 iterations, then recovery. Fails unless
   ``bench.py``'s gate holds (survival ≥ 0.99, audit checked > 0 with 0
   mismatched, SHED-NEW reached, peak occupancy ≥ 0.8, < 0.995 at storm
   end, ≤ 0.5 at the end, evictions, post-storm flows/s ≥ 0.8 of
   pre-storm, the ledger's forecast before SHED-NEW, its CT row = the
   gauge, polling < 2% of serving), every dispatch and GC tick equals a
   plain ``TorchDatapath`` replay (CT included; the dispatches before
   the post-storm window are replayed and dropped before it starts, so
   that window runs without their copies), K1/K2/K3 launched once a
   dispatch, and the saturated table's insert is the same on the card
   and the CPU. Prints survival, legit p50/p99, the occupancy
   trajectory, the ladder's dwell, evictions and CT_FULL, flows/s before,
   during and after, the pipeline worker's time by window (pre-storm and
   post-storm: the host ms medians of ``classify_async`` and its parts —
   pack, upload, the step under ``_ct_lock``, the output fetch — of the
   engine's dispatch and finalize and of each of the finalize's folds;
   each thread's CPU seconds, the device and pinned host allocators'
   counters, and host probes at the windows' edges), and K2
   at the saturated table (host and bound here; cold and hot in phase
   profile; its device time on the path under ``--profile``).
4. worlds  — compiles the cfg5, mixed and cfg3 worlds from their rules with
   the port's policy compiler (``cilium_tpu_torch/world.py``) and places
   them; prints each one's compile seconds (host CPU), snapshot bytes and
   placed bytes;
5. kernels — runs K1 (LPM walk), K2 (CT probe pair) and K3 (policy + L7 +
   verdict) at the main path's shapes against their plain torch versions
   on seeded inputs covering v4 and v6, hits, misses and expired slots,
   REDIRECT cells with passing and failing L7, and unenforced directions,
   then K1, K2 and K3 on every case of ``kernels/edge_cases.py``; exact
   equality. K1's line adds the dependent loads a row waits on
   (``chain_mean``, ``chain_max``: 4 a row for a v4-only launch, which
   walks the trie's own planes; else counted by the plain version of the
   kernel's walk over the derived tables) and the build time and bytes of
   the derived tables (``derive_ms``, ``derived_bytes``; 0 for a v4-only
   launch, which derives nothing). Each kernel is timed at the cfg5 and
   mixed widths, and K1 also at cfg3's (a 43,095-node v4 trie):
   ``host_ms`` host time per wrapper call (200 calls, no synchronise);
   ``ms``      device time per launch with L2 cold (evict-last lines
               demoted and a 256 MB write before each of 20 launches),
               from ``torch.profiler``, in phase profile;
   ``hot_ms``  the same over 50 back-to-back launches, no flush;
   beside its plain version's time and its bound (the bytes the work
   needs over the HBM rate);
6. cfg5    — the main path: the cfg5 world (2^21-slot CT, 1M flows, 100 MB
   verdict image) through ``make_classify_fn(packed=True)``: warm the CT
   with every flow, then churn batches of 65,536; two batches are also run
   by the plain path from a copy of the same CT and must match in every
   out column, counter and CT array; every kernel must have launched;
7. update  — on the cfg5 world: one rule (pod p7 → TCP 4242) added through
   the port's ``IncrementalCompiler.try_update``, the patched snapshot's
   named tensors placed again, p7 → web:4242 rows classified (held against
   the plain path) and seen to flip from a policy drop to allow; then the
   rule removed and the rows seen to drop again;
8. mixed   — the v4/v6 + L7 world at batch 4,096 on the L7-dict wire,
   every batch held against the plain path the same way;
9. parity  — the main path against the port's oracle
   (``cilium_tpu_torch.oracle``, snapshot batch mode on a bounded CT of
   the device's size and probe depth): (a) cfg5 at full width (the CT at
   2^21, batches of 65,536: cfg5's churn with half the rows SYN, FINs and
   RSTs, rows to a port no rule opens and from sources outside the
   ipcache, replies of the previous batch's flows; 6 batches, the last
   after the clock jumps past the SYN lifetime, so entries expire and
   slots are reused), (b) mixed (v6, L7 tokens; batch 4,096, CT 2^18),
   (c) ``tests/test_lb.py``'s service world (DNAT, rev-NAT, NO_SERVICE),
   (d) ``tests/test_parity.py``'s world with enforcement never and always,
   and 40 batches of one against the sequential oracle; each part on a
   fresh CT; (e) cfg5 at CT_FULL: cfg6's table (Cilium's default
   ``bpf-ct-global-tcp-max``, 2^19 slots) seeded on both sides from one
   image of established flows at 96% occupancy, then 6 batches of 65,536
   (a SYN flood, data and replies of the seeded flows, new legit flows),
   the last two after a jump past the SYN lifetime and the last after a
   whole-table ``ct_sweep_chunk`` pass; it fails unless every check
   before the sweep finds ≥ 95% live, ≥ 10,000 rows drop CT_FULL and
   ≥ 10,000 live entries are tail-evicted; (f) part (a)'s traffic through
   the served path: cfg5 built through the port's engine on a fresh CT of
   2^21 slots, 4 batches of 65,536 each ``Engine.submit``-ted whole and
   awaited (pipeline → ``TorchDatapath.classify_async`` → finalize, one
   dispatch a batch, its counters compared), the last after the clock
   jump, the shadow auditor at sampling 1.0 over every row (all 262,144
   checked, 0 mismatched; its replay's seconds). Every row's allow, reason,
   status, remote identity, matched rule, LPM prefix and CT state (and
   (c)'s LB columns), each batch's per-reason × direction,
   ``insert_fail`` and ``ct_evicted`` counters and, after every batch,
   every live CT entry slot for slot (key, flags, expiry, counters,
   rev-NAT) must equal the oracle's; any mismatch fails the run. Prints a
   line a part: rows, batches and live entries compared, the oracle's
   host seconds, the step's host and CUDA-event ms, each kernel's
   launches;
10. cfg3    — 100,000 v4 prefixes, CT 2^18: churn batches of 65,536 Zipf
   destinations, two held against the plain path;
11. serve   — cfg5 at full width built through the port's engine API
   (``Engine`` on ``TorchDatapath``: the web endpoint, 2,000 pod
   identities with /32 entries, 50,000 rules through ``repo.add``,
   ``regenerate``), then cfg5's churn through ``Engine.submit`` (2 batches
   in flight): 2 warm batches, 16 with nothing else running, then at
   least 16 more beside a storm of 24 toggles of one-pod, one-port rules
   (each pod's rows must flip drop → allow → drop; every toggle a delta
   patch; ``StalePlacement`` retried) with overlapped GC ticks of 2^16
   rows; the shadow auditor at
   sampling 1.0 over 2 batches (0 mismatches). Every dispatch and GC tick
   is then replayed in order on a second ``TorchDatapath`` with
   ``fused_kernels="off"``: every out column, counter and GC result, and
   the CT arrays at the end, must be equal; every kernel must have
   launched once per dispatched batch. Prints flows/s, submit → result
   p50/p99, the host ms inside ``classify_async``, inside ``finalize`` and
   in the engine's finalize folds, ``rule_add_ms``/``rule_remove_ms`` and
   each patch's ``place_patch`` ms, the patch counters, the GC counts and
   the audit, and the Python-level torch calls of 4 more dispatches
   (``classify_async`` and its finalize).
12. soak   — ``tests/test_torch_qos.py``'s 8-shard QoS soak through
   ``mesh_dispatch.run_soak`` on ``TorchDatapath(device="cuda")``: 8 flow
   shards sharing the card (the co-located steered step), batch 512, CT
   2^12, the auditor at sampling 1.0, QoS ``gold=4:lane,silver=2,bulk=1``;
   two ``render_metrics`` scrape threads from the start; 20 warm
   submissions of 64 SYNs; stall timeout 1.0 s, then one 4 s
   ``datapath.transfer`` hang; 10 submissions after the restart. Fails on
   a rejected ticket after the restart, an audit mismatch, no restart or
   more than ``pipeline_max_restarts``, or a kernel never launched.
   Prints restarts and rejected tickets, the dispatch p50 and max beside
   the loops (and the scripted step's), the audit, and the Python-level
   torch calls a dispatch after the restart;

13. agent  — cfg5 built as phase serve builds it, plus one ClusterIP
   service (web → 10.96.0.10:443, three backends), its CT warmed at the
   wall clock and saved with ``checkpoint.save`` (seconds, ct.npz bytes);
   ``python3 -m cilium_tpu_torch.cli.main agent run`` restores it in a
   process of its own on the card (its restore and ``regenerate``
   seconds, time to ``/v1/healthz``; ``/v1/status`` must show the 50,000
   rules, the endpoint, the service, the revision and
   ``fused_kernels.active``); 24 ``POST /v1/classify`` requests of flows
   the seed established, new flows and flows to the service frontend,
   each answered equal to an in-process ``fused_kernels="off"`` engine
   restored from the same state dir (round trip p50/p99); one rule
   added over ``POST /v1/policy`` whose probe rows flip drop → allow on
   both; SIGTERM (exit 0, socket removed, the checkpoint's CT equal to
   the plain engine's); an ``--oneshot`` restart whose checkpoint's CT
   equals the plain engine's re-placed as a restore re-places it, with
   the service flows keyed on a backend (the LB stage ran); each kernel
   launched in the agent (its ``fused_kernels.launches``, read before
   and after the requests);
14. feeder — one full cfg5 batch of 65,536 frames (``build_frame``; every
   8th a new flow to a port no rule opens) through a ``FlowShim`` of the
   port's own build on mocked rings into ``Engine.start_feeder`` on the
   seed engine: the dispatched records equal the frames' rows in order,
   every dispatch of the seed engine (its warm batches first) equals a
   plain ``TorchDatapath`` replaying them, the shim forwards exactly the
   rows the dispatches allowed; frames/s,
   the feeder's e2e p50/p99 and stats; each kernel launched;
15. verify — ``verify_configs(quick=True)`` on the card: every combination
   accepted; each one's argument, temp and output bytes, ``budget_doc``;
   each kernel launched once per combination at least.

16. mesh  — cfg5 through the port's engine and pipeline on meshes whose
   shards share the card: (a) 4 flow shards with host RSS, (b) 4 with
   device RSS (the ring CT exchange), (c) 2 flow × 2 rule shards; each
   serves 6 churn batches one at a time (the same batches and clocks
   everywhere) and 8 pipelined; (d) on (a):
   ``device.fail`` naming shard 2, the engine re-meshes 4 → 3 (CT
   3 · 2^19, salvaged + lost + dropped = the gathered table's live
   entries), serves degraded batches, and heals 3 → 4. Every dispatch and
   re-mesh is replayed on a plain datapath of the same geometry (every
   out column, counter, re-mesh count and the CT arrays equal); (a) = (b)
   on the batches served one at a time, CT included; the verdict columns
   of (a), (b), (c) = a one-shard ``TorchDatapath`` on every row where
   neither reports CT_FULL; K1 and K2 launch once per flow shard a
   dispatch, K3 too on (a) and nowhere else. Prints flows/s and batch
   p50/p99, host ms in ``classify_async`` (and (a)'s Python-level torch
   calls a dispatch over 4 more batches), launches by kernel name,
   ``exchange_bytes`` and the re-mesh ``took_s``.

17. tenants — cfg5 built through the engine with cfg8's QoS (``gold=4:lane,
   silver=2,bulk=1:cap=10``, lane bucket 64, one batch in flight), each
   submission stamped ``_tenant``: 16 gold lane probes of 32 rows alone,
   12 rounds of two bulk floods of 65,536 rows, a silver batch and a lane
   probe, then a 4 s window in which all three tenants keep saturating
   backlogs of full batches, whose admitted rows must split 4:2:1 (bulk
   within [0.5, 1.5] × 1/7); the auditor at sampling 1.0 over 4 lane
   probes (0 mismatches); every dispatch replayed on a plain datapath;
   no uploaded wire wider than the widest wire format (``_tenant`` never
   reaches the card). Prints flows/s, lane p50/p99 alone and under the
   flood, the admitted shares and ``qos_status()``;
18. fqdn — cfg5 plus cfg9's egress rules on web (the UDP/53 redirect to
   8.8.8.8 with an allow-all L7 set, ``toFQDNs *.svc.example.com`` → TCP
   443), the DNS plane on: 16 ticks of a DNS batch (6 stable names, 8
   new churn names of TTL 15 s) through the pipeline, the proxy learning
   from its redirect rows as the feeder's verdict-apply path does, the
   fqdn-gc expiry and a refresh, then a 65,536-row cfg5 churn batch whose
   first rows go to each stable name and to the churn names of the last
   3 ticks and the next one on 443: churn names' rows go drop → allow →
   drop, stable names' never drop; 0 full rebuilds; every dispatch and
   the CT replayed on a plain datapath (each patched snapshot placed
   whole). Prints each trie patch's ``place_patch`` ms, refresh p50/p99,
   identities created and retired, and ``fqdn_status()``;
19. cluster — cfg7's shape: ``ClusterSupervisor`` with two node processes
   on the card (each an engine on ``TorchDatapath`` at cfg5's CT
   geometry, a ``cluster=mesh`` pod, ingress from the mesh on 8080):
   converge (the post-seed ingest a delta patch), serve 6 batches of
   4,096 cross-node rows a node, partition node-0 from the store
   (last-good serving, MESH_STALE, heal), kill node-1 (its prefix
   withdrawn after the lease), restart and re-converge it, a
   ``FlowRelay`` over both nodes' flowlog JSONL sees both; the node
   auditors find 0 mismatches; each node's kernel launches rise. Prints
   per-node flows/s, replication-lag p99 and convergence rounds;
20. chaos — ``python3 -m cilium_tpu_torch.cli.main faults chaos
   --datapath torch`` in a process of its own on the card: exit 0, every
   phase PASS, each kernel launched;
21. goldengen — cfg5's web endpoint (its MapState and the ipcache) as a
   scenario for the port's C++ golden-vector generator: 256 of cfg5's
   packets (new flows, a port no rule opens, sources outside the
   ipcache, repeats and replies) through the generator, the port's oracle
   and the classify step on the card one packet a step; all three agree
   on allow, reason, CT status and remote identity.
22. profile — every profiled measurement, after every host-bound phase:
   each kernel's ``ms`` and ``hot_ms`` on phase kernels' inputs and K2's
   at phase ddos's saturated table; cfg5 built through the engine again,
   2 warm batches and 4 pipelined under ``torch.profiler`` (each kernel
   seen on the device by name; the device's busy share), every dispatch
   and the CT held against a plain replay; then its snapshot placed on a
   ``TorchDatapath`` of each mesh geometry of phase mesh, 2 batches each
   under the profiler (each kernel's launches and device ms per launch).

``--profile`` adds each main-path phase's device time by op and each
kernel's device time per launch on the path (``path_ms``), in phase
profile, and one plateau iteration of phase ddos under the profiler: the
phases after it then run after a profiler session, and say so.

Then it prints the kernels' JSON line, the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time
from collections import Counter

#: H100 SXM device-memory rate (NVIDIA data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12
#: bytes written before each cold launch: five times the H100's 50 MB L2
L2_FLUSH_BYTES = 256 << 20
#: where the worlds live and at what size (a rehearsal on the CPU sets
#: "cpu" and "smoke"; a chip run keeps these)
DEVICE = "cuda"
PRESET = "full"
#: cfg3 churn batches on the main path
CFG3_BATCHES = 8

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
    # no TPU kernel: the reference hashes these fingerprints on the host
    "flow_fingerprint_fused": ("cilium_tpu_torch/csrc/flow_fingerprint.cu",
                               None, "flow_fingerprint_kernel"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


#: the phases whose readings are host-bound (flows/s, latencies, restore
#: and re-mesh seconds, host ms a call): each calls ``host_bound`` first
HOST_BOUND = ("ddos", "kernels", "cfg5", "update", "mixed", "cfg3", "serve",
              "soak", "agent", "feeder", "observe", "verify", "mesh",
              "tenants", "fqdn", "cluster")
#: the ``torch.profiler`` sessions this process has started, in order
#: (``profiler_session``). One with CUDA activity leaves the later
#: launches of the process slower on the host (``profiler_drift.py``).
PROFILER_SESSIONS = []
#: set by ``--profile``: phase ddos profiles its plateau, and the
#: host-bound phases after it run all the same, each saying so
PROFILED_RUN = False
#: profiled measurements put off until phase profile: (label, job), where
#: ``job(flush)`` → phase lines
DEFERRED = []


def profiler_session(what):
    """``torch.profiler.profile`` over the CPU (and the card's activity on
    a card), recorded in ``PROFILER_SESSIONS`` as ``what``."""
    from torch.profiler import ProfilerActivity, profile
    PROFILER_SESSIONS.append(what)
    acts = [ProfilerActivity.CPU]
    if DEVICE == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def host_bound(what):
    """Called where a host-bound reading starts: fails once a profiler
    session has run in this process (under ``--profile``, prints that it
    has)."""
    if not PROFILER_SESSIONS:
        return
    msg = (f"{what}: a host-bound reading after the profiler session "
           f"{PROFILER_SESSIONS[0]!r} of this process")
    check(PROFILED_RUN, msg)
    print(f"chip_smoke: {msg} (--profile)", flush=True)


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
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profiler_session(symbol) as prof:
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


def defer_device_times(label, entry, fn, symbol, nbytes, card):
    """Put off the cold and hot device times of ``fn``'s kernel ``symbol``
    (``device_ms``) until phase profile, which writes them into ``entry``
    and prints them under ``label``."""
    def job(flush):
        ms = device_ms(fn, symbol, 20, flush)
        hot = device_ms(fn, symbol, 50)
        entry.update(ms=ms, hot_ms=hot)
        return [f"{label}: ms={ms:.6f} hot_ms={hot:.6f} bound_ms="
                f"{bound_ms(nbytes):.6f} (share {bound_ms(nbytes) / ms:.3f})"
                f" [{card}]"]
    DEFERRED.append((label, job))


def hold(kernel, world, args, kernel_fn, plain_fn, nbytes, report, card):
    """Hold one kernel against its plain version on ``args`` (exact), time
    both on the host, and fill its report entry: at cfg5 width (the main
    path's) the top-level fields, at mixed width its ``mixed`` entry; its
    device times follow in phase profile. → (plain outputs, the phase
    line)."""
    got = kernel_fn(*args)
    want = plain_fn(*args)
    err = max_abs_err(got, want)
    check(err == 0, f"{kernel} {world.name}: kernel != plain (max err {err})")
    host = host_ms(lambda: kernel_fn(*args))
    plain_ms = cuda_ms(lambda: plain_fn(*args), 10)
    entry = dict(max_abs_err=err, ms=None, hot_ms=None, host_ms=host,
                 plain_ms=plain_ms, bound_ms=bound_ms(nbytes))
    if world.name == "cfg5":
        report[kernel].update(entry)
        entry = report[kernel]
    else:
        report[kernel][world.name] = entry
    # a shallow copy of each dict argument: a later phase may rebind a
    # world's tensors
    kept = tuple(dict(a) if isinstance(a, dict) else a for a in args)
    defer_device_times(f"{kernel} {world.name}", entry,
                       lambda: kernel_fn(*kept), KERNELS[kernel][2], nbytes,
                       card)
    return want, (f"{kernel} {world.name}: n={want[0].shape[0]} exact, "
                  f"host_ms={host:.6f} plain_ms={plain_ms:.6f} "
                  f"bytes={nbytes} bound_ms={bound_ms(nbytes):.6f} [{card}]")


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


def hold_lpm(w, seed, report, card):
    """K1 held against its plain version at ``w``'s width (v4-only at cfg5
    and cfg3, both families at mixed; 1 row in 8 misses).
    → (the batch, K1's identity indices, the phase line)."""
    from cilium_tpu_torch.kernels import fused as fk
    b = kernel_inputs(w, seed)
    largs = (w.tensors["lpm_v4"], w.tensors["lpm_v6"], remote_words(b),
             b["is_v6"], w.world_index, w.v4_only)
    (idx, meta), line = hold(
        "lpm_lookup_fused", w, largs, fk.lpm_lookup_fused,
        fk.lpm_lookup_plain,
        lpm_bytes(w.tensors, largs[2], largs[3], w.v4_only), report, card)
    hits = int((meta >= 0).sum())
    check(0 < hits < meta.numel(), f"K1 {w.name}: no hit/miss mix")
    extra = lpm_derived_stats(w, largs, (idx, meta))
    (report["lpm_lookup_fused"] if w.name == "cfg5"
     else report["lpm_lookup_fused"][w.name]).update(extra)
    line += " " + " ".join(f"{k}={v}" for k, v in extra.items())
    check(w.v4_only or (bool(b["is_v6"].any())
                        and bool((~b["is_v6"]).any())),
          f"K1 {w.name}: batch lacks a family")
    return b, idx, (f"{line} hits={hits} "
                    f"trie_nodes={w.tensors['lpm_v4'].shape[0]}")


def fingerprint_bytes(n):
    """The fingerprint kernel's bytes for ``n`` rows: src and dst (16 each),
    sport, dport, proto and direction (4 each) read once, the fingerprint
    (4) written once."""
    return n * (2 * 16 + 4 * 4 + 4)


def hold_fingerprint(w, seed, report, card):
    """The flow-fingerprint kernel held against its plain version at
    ``w``'s width (1 row in 8 at a random address), and both against
    ``shim.feeder.flow_hashes`` of the same rows on the host. → the
    phase line."""
    import numpy as np
    from cilium_tpu_torch.kernels import fused as fk
    from cilium_tpu_torch.shim.feeder import flow_hashes
    b = kernel_inputs(w, seed)
    cols = ("src", "dst", "sport", "dport", "proto", "direction")
    args = tuple(b[k] for k in cols)
    (fp,), line = hold(
        "flow_fingerprint_fused", w, args,
        lambda *a: (fk.flow_fingerprint_fused(*a),),
        lambda *a: (fk.flow_fingerprint_plain(*a),),
        fingerprint_bytes(args[0].shape[0]), report, card)
    want = flow_hashes({k: b[k].cpu().numpy() for k in cols})
    check(np.array_equal(fp.cpu().numpy().view(np.uint32), want),
          f"fingerprint {w.name}: != flow_hashes of the host rows")
    return f"{line} = flow_hashes"


def phase_kernels(cfg5, mixed, cfg3, seed, report, card):
    """K1, K2 and K3 held against their plain versions at the cfg5 (the
    main path's) and mixed widths, K1 at cfg3's, and the flow-fingerprint
    kernel at cfg5's and cfg3's; their device times put off until phase
    profile (which keeps their inputs). → phase lines."""
    import torch
    from cilium_tpu_torch.kernels import fused as fk
    from cilium_tpu_torch.utils import constants as C

    host_bound("phase kernels")
    lines = []
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    for w in (cfg5, mixed):
        b, idx, line = hold_lpm(w, seed, report, card)
        lines.append(line)

        # K2: live, expired, reply and fresh keys at the world's CT size
        ct, fwd, rev, now = probe_case(w, seed + 1)
        pargs = (ct, fwd, rev, now, 8)
        (fs, rs), line = hold(
            "ct_probe_pair_fused", w, pargs, fk.ct_probe_pair_fused,
            fk.ct_probe_pair_plain, ct_probe_bytes(ct, fwd, rev, now, 8),
            report, card)
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
            policy_bytes(w.tensors, rows), report, card)
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
    lines.append(hold_lpm(cfg3, seed, report, card)[2])
    lines += [hold_fingerprint(w, seed, report, card) for w in (cfg5, cfg3)]
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
    torch.cuda.synchronize()
    with profiler_session(f"{label} op table") as prof:
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


def defer_op_table(world, fn, wires, label, entry):
    """``--profile``'s op table of ``label``'s main path (``profile_lines``
    on ``wires``), put off until phase profile, which writes each
    kernel's ``path_ms`` into ``entry(kernel)``."""
    def job(_flush):
        lines, stats = profile_lines(world, fn, wires, 2000, label)
        for k, ms in stats["path_ms"].items():
            entry(k)["path_ms"] = ms
        return lines
    DEFERRED.append((f"{label} op table", job))


def phase_cfg5(world, card, report, profile=False):
    host_bound("phase cfg5")
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
    if profile:
        defer_op_table(world, fn, churn[:4], "cfg5",
                       lambda k: report[k])
    return [
            f"cfg5 warm: {len(warm)} batches, {warm_s:.3f} s, CT occupancy "
            f"{occupancy}",
            f"cfg5: {fps:.0f} flows/s, p50 {percentile_ms(steady, 50):.3f} "
            f"ms, p99 {percentile_ms(steady, 99):.3f} ms per batch of "
            f"{valid_rows} (allow {allow:.4f}, established {est:.4f}, "
            f"insert_fail {int(counters['insert_fail'])}) [{card}]",
            f"cfg5 launches: {json.dumps(launches)}"]


def phase_mixed(world, card, report, profile=False):
    host_bound("phase mixed")
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
    if profile:
        defer_op_table(world, fn, wires[:4], "mixed",
                       lambda k: report[k]["mixed"])
    return [
            f"mixed: {world.batch * len(steady) / sum(steady):.0f} flows/s, "
            f"p50 {percentile_ms(steady, 50):.3f} ms, p99 "
            f"{percentile_ms(steady, 99):.3f} ms per batch of {world.batch}, "
            f"all {len(wires)} batches equal to the plain path "
            f"(allow {float(out['allow'].float().mean()):.4f}) [{card}]",
            f"mixed launches: {json.dumps(launches)}"]


def phase_worlds(seed):
    """The three worlds compiled from their rules and placed; → (worlds by
    name, phase lines). Compile seconds are host time on this machine's
    CPU (the compiler is numpy), not the card's."""
    from cilium_tpu_torch.world import make_world
    worlds, lines = {}, []
    for name in ("cfg5", "mixed", "cfg3"):
        t0 = time.perf_counter()
        w = make_world(name, seed=seed, device=DEVICE, preset=PRESET)
        total = time.perf_counter() - t0
        placed = sum(t.numel() * t.element_size() for t in w.tensors.values())
        ct_bytes = sum(t.numel() * t.element_size() for t in w.ct.values())
        lines.append(
            f"{name}: host CPU seconds: rules and traffic tables "
            f"{w.declare_s:.3f}, build_snapshot {w.compile_s:.3f}, in all "
            f"with placing {total:.3f}; snapshot "
            f"{w.snapshot.nbytes} bytes, placed {placed} bytes + CT "
            f"{ct_bytes} bytes, verdict "
            f"{list(w.host_tensors['verdict'].shape)}, lpm_v4 "
            f"{list(w.host_tensors['lpm_v4'].shape)}, lpm_v6 "
            f"{list(w.host_tensors['lpm_v6'].shape)}")
        worlds[name] = w
    return worlds, lines


#: the one rule of ``bench.update_latency_bench``: pod p7 → TCP 4242
P7_RULE = {"endpointSelector": {"matchLabels": {"app": "web"}},
           "ingress": [{"fromEndpoints": [{"matchLabels": {"pod": "p7"}}],
                        "toPorts": [{"ports": [{"port": "4242",
                                                "protocol": "TCP"}]}]}]}
P7_WORD = 0xAC100007                  # 172.16.0.7, pod p7's address


def phase_update(world, card):
    """One rule added to and removed from the placed cfg5 world through
    the port's incremental compiler; p7 → web:4242 rows flip from a
    policy drop to allow and back. → phase lines."""
    host_bound("phase update")
    import numpy as np
    import torch
    from cilium_tpu_torch.compile.ct_layout import CTConfig
    from cilium_tpu_torch.compile.incremental import IncrementalCompiler
    from cilium_tpu_torch.kernels import fused as fk
    from cilium_tpu_torch.kernels.classify import make_classify_fn
    from cilium_tpu_torch.model.labels import Labels
    from cilium_tpu_torch.model.rules import parse_rule
    from cilium_tpu_torch.utils import constants as C
    fn = make_classify_fn(v4_only=True, packed=True, donate_ct=True,
                          device=DEVICE)
    fn_plain = make_classify_fn(v4_only=True, packed=True, donate_ct=True,
                                fused=False, device=DEVICE)
    ct_cfg = CTConfig(capacity=world.ct["expiry"].shape[0])
    label = Labels.parse(["k8s:bench=u1"])
    n_p7 = 1024
    lines = []

    def p7_rows(now):
        """A churn batch whose first ``n_p7`` rows are new p7 → web:4242
        flows; held against the plain path. → (allowed, drop reasons) of
        those rows."""
        b = world.next_batch()
        b["src"][:n_p7, 3] = P7_WORD
        b["dport"][:n_p7] = 4242
        # other source ports at each ``now``: every row is a new flow
        b["sport"][:n_p7] = 20000 + (now % 20) * n_p7 + np.arange(n_p7)
        b["tcp_flags"][:n_p7] = C.TCP_SYN
        _s, out, _c = drive(world, fn, fn_plain, [world.pack(b)], now, {0})
        return (int(out["allow"][:n_p7].sum()),
                sorted(int(r) for r in torch.unique(out["reason"][:n_p7])))

    def update(what):
        t0 = time.perf_counter()
        res = inc.try_update(ct_cfg)
        update_s = time.perf_counter() - t0
        check(res is not None, f"update: {what} fell back "
                               f"({inc.last_fallback})")
        snap, patch, stats = res
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        names = world.place(snap, patch)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        nbytes = sum(world.tensors[k].numel() * world.tensors[k]
                     .element_size() for k in names)
        lines.append(
            f"update {what}: try_update {update_s * 1e3:.3f} ms (host), "
            f"delta={patch.is_delta} rows={len(patch.verdict_rows)} "
            f"stats={json.dumps(vars(stats))}; placed {names} ({nbytes} "
            f"bytes) in {place_s * 1e3:.3f} ms (host clock, synchronised)")

    fk.reset_launches()
    t0 = time.perf_counter()
    inc = IncrementalCompiler(world.repo, world.ctx, world.endpoints,
                              world.snapshot)
    lines.append(f"update seed: IncrementalCompiler over the placed "
                 f"snapshot in {time.perf_counter() - t0:.3f} s (host)")
    before = p7_rows(3000)
    check(before == (0, [int(C.DropReason.POLICY)]),
          f"update: p7 rows before the rule: {before}")
    rule = parse_rule(P7_RULE)
    object.__setattr__(rule, "labels", label)
    world.repo.add([rule])
    update("add")
    added = p7_rows(3001)
    # allowed now; a new flow may still find its CT probe window full
    check(added[0] >= 0.9 * n_p7 and set(added[1]) <= {
        0, int(C.DropReason.CT_FULL)}, f"update: p7 rows with the rule: "
                                        f"{added}")
    world.repo.delete_by_labels(label)
    update("remove")
    removed = p7_rows(3002)
    check(removed == (0, [int(C.DropReason.POLICY)]),
          f"update: p7 rows after removal: {removed}")
    launches = dict(fk.LAUNCHES)
    for k, v in launches.items():
        check(v > 0, f"update: kernel {k} never launched")
    return lines + [
        f"update: {n_p7} p7 → web:4242 rows allowed before / with / after "
        f"the rule: {before[0]} / {added[0]} / {removed[0]}, each batch "
        f"equal to the plain path [{card}]",
        f"update launches: {json.dumps(launches)}"]


def phase_cfg3(world, card, report, profile=False):
    """cfg3's Zipf churn through the main path; two batches held against
    the plain path. → phase lines."""
    host_bound("phase cfg3")
    import torch
    from cilium_tpu_torch.kernels import fused as fk
    from cilium_tpu_torch.kernels.classify import make_classify_fn
    from cilium_tpu_torch.utils import constants as C
    fn = make_classify_fn(v4_only=True, packed=True, donate_ct=True,
                          device=DEVICE)
    fn_plain = make_classify_fn(v4_only=True, packed=True, donate_ct=True,
                                fused=False, device=DEVICE)
    wires = [world.pack(world.next_batch()) for _ in range(CFG3_BATCHES)]
    fk.reset_launches()
    seconds, out, counters = drive(world, fn, fn_plain, wires, 1000, (2, 5))
    launches = dict(fk.LAUNCHES)
    for k, v in launches.items():
        check(v > 0, f"cfg3: kernel {k} never launched")
    allow = float(out["allow"].float().mean())
    check(0.2 < allow < 0.8, f"cfg3: allow share {allow} (0.0.0.0/1 "
                             f"covers about half the destinations)")
    reasons = sorted(int(r) for r in torch.unique(out["reason"]))
    check(set(reasons) <= {0, int(C.DropReason.POLICY),
                           int(C.DropReason.CT_FULL)},
          f"cfg3: unexpected drop reasons {reasons}")
    occupancy = int((world.ct["expiry"] != 0).sum())
    steady = seconds[2:]
    if profile:
        defer_op_table(world, fn, wires[:4], "cfg3",
                       lambda k: report[k].setdefault("cfg3", {}))
    return [
        f"cfg3: {world.batch * len(steady) / sum(steady):.0f} flows/s, "
        f"p50 {percentile_ms(steady, 50):.3f} ms, p99 "
        f"{percentile_ms(steady, 99):.3f} ms per batch of {world.batch} "
        f"over {len(wires)} batches, batches 2 and 5 equal to the plain "
        f"path (allow {allow:.4f}, reasons {reasons}, CT occupancy "
        f"{occupancy}, insert_fail {int(counters['insert_fail'])}) [{card}]",
        f"cfg3 launches: {json.dumps(launches)}"]


# --------------------------------------------------------------------------- #
# parity: the main path held against the oracle
# --------------------------------------------------------------------------- #
#: batches of parts (a) cfg5 and (b) mixed at each preset (the last batch
#: of each after a clock jump past the SYN lifetime), and at smoke the rows
#: of a batch each keeps and part (a)'s CT slots (a rehearsal's reference
#: oracle scans every rule and prefix for each row)
PARITY = {"full": dict(cfg5=6, mixed=6, cfg5_rows=None, mixed_rows=None,
                      cfg5_cap=None, engine=4,
                      ctfull=dict(cap=1 << 19, rows=1 << 16, batches=6,
                                  min_full=10_000, min_evicted=10_000)),
          "smoke": dict(cfg5=4, mixed=4, cfg5_rows=512, mixed_rows=128,
                        cfg5_cap=1 << 12, engine=4,
                        ctfull=dict(cap=1 << 12, rows=512, batches=6,
                                    min_full=1000, min_evicted=64))}
#: part (e): the share of the table the seeded established flows fill, the
#: least live share at every check before the sweep, the seed of its flows
#: and the clock of its first batch
CTFULL_FILL = 0.96
CTFULL_MIN_OCC = 0.95
CTFULL_SEED = 0
CTFULL_T0 = 1000
#: the columns ``tests/test_parity.run_parity`` holds against the oracle
PARITY_COLS = ("allow", "reason", "status", "remote_identity",
               "matched_rule", "lpm_prefix", "ct_state_pre")
#: seconds between batches, and the jump before the last: past
#: ``CT_LIFETIME_SYN`` (60 s), so SYN-only entries expire and slots are reused
PARITY_TICK = 10
PARITY_JUMP = 70
#: the CT columns compared for every live entry (its slot and key too)
PARITY_CT = ("flags", "expiry", "pkts_fwd", "pkts_rev", "rev_nat")

#: ``tests/test_parity.py``'s world: web egress to 10/8 except 10.96/12 on
#: 443 and 8080-8090, to the world on 53, to 2001:db8::/32 on 443, ICMP echo
#: to 10.200/16, a deny of 10.66/16, an HTTP cell on ingress 80 and ingress
#: from fe pods; db ingress from web pods on 5432
PARITY_RULES = [
    {"endpointSelector": {"matchLabels": {"app": "web"}},
     "egress": [
         {"toCIDRSet": [{"cidr": "10.0.0.0/8", "except": ["10.96.0.0/12"]}],
          "toPorts": [{"ports": [{"port": "443", "protocol": "TCP"},
                                 {"port": "8080", "endPort": 8090,
                                  "protocol": "TCP"}]}]},
         {"toEntities": ["world"],
          "toPorts": [{"ports": [{"port": "53", "protocol": "ANY"}]}]},
         {"toCIDR": ["2001:db8::/32"],
          "toPorts": [{"ports": [{"port": "443", "protocol": "TCP"}]}]},
         {"toCIDR": ["10.200.0.0/16"],
          "icmps": [{"fields": [{"type": 8, "family": "IPv4"}]}]},
     ],
     "egressDeny": [{"toCIDR": ["10.66.0.0/16"]}],
     "ingress": [
         {"toPorts": [{"ports": [{"port": "80", "protocol": "TCP"}],
                       "rules": {"http": [{"method": "GET", "path": "/api"},
                                          {"path": "/public"}]}}]},
         {"fromEndpoints": [{"matchLabels": {"role": "fe"}}]},
     ]},
    {"endpointSelector": {"matchLabels": {"app": "db"}},
     "ingress": [{"fromEndpoints": [{"matchLabels": {"app": "web"}}],
                  "toPorts": [{"ports": [{"port": "5432",
                                          "protocol": "TCP"}]}]}]},
]
PARITY_DSTS = ["10.1.2.3", "10.5.5.5", "10.96.0.1", "10.100.3.9", "10.66.1.1",
               "10.200.1.1", "8.8.8.8", "1.1.1.1", "192.168.1.20",
               "192.168.1.30", "2001:db8::77", "2001:db9::1"]
PARITY_PORTS = [443, 8080, 8085, 8090, 8091, 80, 53, 5432, 22, 0]
PARITY_PATHS = [b"/api/users", b"/public/x", b"/admin", b"/ap", b""]
PARITY_EPS = ((1, "k8s:app=web", "192.168.1.10"),
              (2, "k8s:app=db", "192.168.1.20"),
              (3, "k8s:role=fe", "192.168.1.30"))

#: ``tests/test_lb.py``'s service world: a client may reach backend pods
#: on 8080; ``api`` (ClusterIP 172.20.0.10:80 and NodePort
#: 192.168.2.100:30080 → three backends on 8080), ``blocked``
#: (172.20.0.11:80 → 10.60.0.1:9090, a port policy does not open) and
#: ``empty`` (172.20.0.12:80, no backends)
LB_RULES = [{"endpointSelector": {"matchLabels": {"app": "client"}},
             "egress": [{"toEndpoints": [{"matchLabels": {"app": "be"}}],
                         "toPorts": [{"ports": [{"port": "8080",
                                                 "protocol": "TCP"}]}]}]}]
LB_CLIENT = "192.168.2.1"


@functools.lru_cache(maxsize=None)
def port_modules():
    """The port's modules that the parity worlds below are declared and
    checked with, by the names those helpers use (a CPU rehearsal passes
    another package's modules under the same names)."""
    from types import SimpleNamespace

    from cilium_tpu_torch import oracle, policy
    from cilium_tpu_torch.compile import ct_layout, snapshot
    from cilium_tpu_torch.compile import lb as lbc
    from cilium_tpu_torch.kernels import records
    from cilium_tpu_torch.model import (endpoint, identity, ipcache, labels,
                                        rules, services)
    from cilium_tpu_torch.policy import selectorcache
    from cilium_tpu_torch.utils import constants as C
    from cilium_tpu_torch.utils import ip
    return SimpleNamespace(
        ct_layout=ct_layout, snapshot=snapshot, lbc=lbc, records=records,
        endpoint=endpoint, identity=identity, ipcache=ipcache, labels=labels,
        rules=rules, services=services, policy=policy,
        selectorcache=selectorcache, C=C, ip=ip, oracle=oracle)


def _plane(m):
    alloc = m.identity.IdentityAllocator()
    ctx = m.policy.PolicyContext(
        allocator=alloc, selector_cache=m.selectorcache.SelectorCache(alloc),
        ipcache=m.ipcache.IPCache())
    return ctx, m.policy.Repository(ctx)


def parity_world(m):
    """``test_parity.build_world`` over the modules ``m``. → (ctx, repo,
    endpoints)."""
    ctx, repo = _plane(m)
    eps = []
    for ep_id, label, ip in PARITY_EPS:
        lbls = m.labels.Labels.parse((label,))
        ident = ctx.allocator.allocate(lbls)
        eps.append(m.endpoint.Endpoint(ep_id=ep_id, labels=lbls,
                                       identity_id=ident.id, ips=(ip,)))
        ctx.ipcache.upsert(f"{ip}/32", ident.id)
    repo.add(m.rules.parse_rules(PARITY_RULES))
    return ctx, repo, eps


def parity_packet(m, rng, prior):
    """``test_parity.random_packet``: a repeat of a prior flow (with an ACK,
    PSH, FIN or RST), its reply, or a new random flow of one of the three
    endpoints (L7 tokens on some to port 80)."""
    C, record = m.C, m.oracle.PacketRecord
    r = rng.random()
    if prior and r < 0.30:
        p = rng.choice(prior)
        flags = rng.choice([C.TCP_ACK, C.TCP_ACK | C.TCP_PSH, C.TCP_FIN,
                            C.TCP_RST]) if p.proto == C.PROTO_TCP else 0
        return record(p.src_addr, p.dst_addr, p.src_port, p.dst_port,
                      p.proto, flags, p.is_ipv6, p.ep_id, p.direction,
                      p.http_method, p.http_path)
    if prior and r < 0.45:
        p = rng.choice(prior)
        flags = (C.TCP_SYN | C.TCP_ACK) if p.proto == C.PROTO_TCP else 0
        return record(p.dst_addr, p.src_addr, p.dst_port, p.src_port,
                      p.proto, flags, p.is_ipv6, p.ep_id, 1 - p.direction,
                      C.HTTP_METHOD_ANY, b"")
    ep_id = rng.choice([1, 1, 1, 2, 3])
    direction = rng.choice([C.DIR_EGRESS, C.DIR_EGRESS, C.DIR_INGRESS])
    dst = rng.choice(PARITY_DSTS)
    src_ip = PARITY_EPS[ep_id - 1][2]
    src, dstip = (dst, src_ip) if direction == C.DIR_INGRESS \
        else (src_ip, dst)
    s16, sv6 = m.ip.parse_addr(src)
    d16, dv6 = m.ip.parse_addr(dstip)
    proto = rng.choice([C.PROTO_TCP] * 5 + [C.PROTO_UDP, C.PROTO_ICMP])
    if proto == C.PROTO_ICMP:
        sport, dport, flags = 0, rng.choice([0, 8]), 0
    else:
        sport = rng.randrange(30000, 60000)
        dport = rng.choice(PARITY_PORTS)
        flags = C.TCP_SYN if proto == C.PROTO_TCP else 0
    method, path = C.HTTP_METHOD_ANY, b""
    if proto == C.PROTO_TCP and dport == 80 and rng.random() < 0.5:
        method = rng.choice([C.HTTP_METHOD_IDS["GET"],
                             C.HTTP_METHOD_IDS["POST"]])
        path = rng.choice(PARITY_PATHS)
        flags = C.TCP_ACK
    return record(s16, d16, sport, dport, proto, flags, sv6 or dv6, ep_id,
                  direction, method, path)


def lb_world(m):
    """``test_lb.build_svc_world`` over the modules ``m``. → (ctx, repo,
    endpoints)."""
    S = m.services
    ctx, repo = _plane(m)
    cl = m.labels.Labels.parse(["k8s:app=client"])
    ident = ctx.allocator.allocate(cl)
    eps = [m.endpoint.Endpoint(ep_id=1, labels=cl, identity_id=ident.id,
                               ips=(LB_CLIENT,))]
    ctx.ipcache.upsert(f"{LB_CLIENT}/32", ident.id)
    be = ctx.allocator.allocate(m.labels.Labels.parse(["k8s:app=be"]))
    for i in range(1, 4):
        ctx.ipcache.upsert(f"10.50.0.{i}/32", be.id)
    ctx.ipcache.upsert("10.60.0.1/32", be.id)
    tcp = m.C.PROTO_TCP
    ctx.services.upsert(S.Service(
        name="api", namespace="prod",
        frontends=(S.Frontend("172.20.0.10", 80, tcp),
                   S.Frontend("192.168.2.100", 30080, tcp,
                              kind="NodePort")),
        lb_backends=tuple(S.Backend(f"10.50.0.{i}", 8080)
                          for i in range(1, 4))))
    ctx.services.upsert(S.Service(
        name="blocked", namespace="prod",
        frontends=(S.Frontend("172.20.0.11", 80, tcp),),
        lb_backends=(S.Backend("10.60.0.1", 9090),)))
    ctx.services.upsert(S.Service(
        name="empty", namespace="prod",
        frontends=(S.Frontend("172.20.0.12", 80, tcp),), lb_backends=()))
    repo.add(m.rules.parse_rules(LB_RULES))
    return ctx, repo, eps


def lb_packet(m, dst, dport, sport, flags=None):
    """``test_lb.svc_packet``: a TCP packet of the client, egress."""
    C = m.C
    s16, _ = m.ip.parse_addr(LB_CLIENT)
    d16, _ = m.ip.parse_addr(dst)
    return m.oracle.PacketRecord(
        s16, d16, sport, dport, C.PROTO_TCP,
        C.TCP_SYN if flags is None else flags, False, 1, C.DIR_EGRESS)


def parity_snapshot(m, world, cap, lb=False):
    """Compile ``world`` (ctx, repo, endpoints) with ``m``'s compiler;
    the service world's Maglev tables at ``test_lb.py``'s M = 31."""
    ctx, repo, eps = world
    extra = (m.lbc.LBConfig(maglev_m=31),) if lb else ()
    return m.snapshot.build_snapshot(repo, ctx, eps,
                                     m.ct_layout.CTConfig(capacity=cap),
                                     *extra)


def batch_records(b, ep_ids, record):
    """A host batch (every row valid) → one ``record`` (a package's
    ``PacketRecord``) per row: the packets the device classifies."""
    import numpy as np
    check(bool(b["valid"].all()), "parity: a batch row is not valid")
    n = b["valid"].shape[0]
    src = b["src"].astype(">u4").tobytes()
    dst = b["dst"].astype(">u4").tobytes()
    cols = [b[k].tolist() for k in ("sport", "dport", "proto", "tcp_flags",
                                    "is_v6", "ep_slot", "direction",
                                    "http_method")]
    has_path = b["http_path"].any(axis=1)
    recs = []
    for i, (sp, dp, pr, fl, v6, slot, d, meth) in enumerate(zip(*cols)):
        path = bytes(b["http_path"][i]).rstrip(b"\0") if has_path[i] \
            else b""
        recs.append(record(src[16 * i:16 * i + 16], dst[16 * i:16 * i + 16],
                           sp, dp, pr, fl, v6, ep_ids[slot], d, meth, path))
    return recs


def verdict_columns(verdicts):
    """The oracle's verdicts → its ``PARITY_COLS`` as int64 arrays."""
    import numpy as np
    n = len(verdicts)
    fields = {"allow": "allow", "reason": "drop_reason",
              "status": "ct_status", "remote_identity": "remote_identity",
              "matched_rule": "matched_rule", "lpm_prefix": "lpm_prefix",
              "ct_state_pre": "ct_status"}
    return {k: np.fromiter((int(getattr(v, f)) for v in verdicts),
                           np.int64, n) for k, f in fields.items()}


def lb_mismatches(out, verdicts):
    """Rows whose LB columns differ from the oracle's: ``svc`` and
    ``rnat`` everywhere, the DNAT'd destination where the oracle
    translated, the rev-NAT source where it reverse-translated (what
    ``test_lb._check_against_oracle`` holds). → [description]."""
    import numpy as np
    bad = []
    for flag, addr, port in (("svc", "nat_dst", "nat_dport"),
                             ("rnat", "rnat_src", "rnat_sport")):
        want = np.fromiter((getattr(v, flag) for v in verdicts), bool,
                           len(verdicts))
        got = np.asarray(out[flag]).astype(bool)
        bad += [f"row {i} {flag}: {got[i]} != {want[i]}"
                for i in np.nonzero(got != want)[0]]
        rows = np.nonzero(want)[0]
        if rows.size:
            w_addr = np.frombuffer(b"".join(
                getattr(verdicts[i], addr) for i in rows), ">u4") \
                .reshape(-1, 4).astype(np.uint32)
            g_addr = np.asarray(out[addr]).astype(np.uint32)[rows]
            w_port = np.array([getattr(verdicts[i], port) for i in rows])
            g_port = np.asarray(out[port]).astype(np.int64)[rows]
            for j in np.nonzero((g_addr != w_addr).any(axis=1)
                                | (g_port != w_port))[0]:
                bad.append(f"row {rows[j]} {addr}/{port}: "
                           f"{g_addr[j].tolist()}:{g_port[j]} != "
                           f"{w_addr[j].tolist()}:{w_port[j]}")
    return bad


def oracle_live(oracle, now):
    """The oracle's live CT entries (expiry > now) as arrays in slot
    order: (slots, key words [n, 10] uint32, {column: values})."""
    import itertools
    import operator

    import numpy as np
    live = [(k, e) for k, e in oracle.ct.entries.items() if e.expiry > now]
    n = len(live)
    keys = np.zeros((n, 10), dtype=np.uint32)
    vals = np.zeros((n, len(PARITY_CT) + 1), dtype=np.int64)
    if n:
        ks, es = zip(*live)
        keys[:, 0:4] = np.frombuffer(b"".join(map(operator.itemgetter(0), ks)),
                                     ">u4").reshape(n, 4)
        keys[:, 4:8] = np.frombuffer(b"".join(map(operator.itemgetter(1), ks)),
                                     ">u4").reshape(n, 4)
        ports = np.fromiter(itertools.chain.from_iterable(
            map(operator.itemgetter(2, 3, 4, 5), ks)), np.int64,
            4 * n).reshape(n, 4)
        keys[:, 8] = ((ports[:, 0] << 16) | ports[:, 1]) & 0xFFFFFFFF
        keys[:, 9] = (ports[:, 2] << 8) | ports[:, 3]
        vals[:] = np.fromiter(itertools.chain.from_iterable(
            map(operator.attrgetter("slot", *PARITY_CT), es)), np.int64,
            vals.size).reshape(vals.shape)
    order = np.argsort(vals[:, 0], kind="stable")
    keys, vals = keys[order], vals[order]
    return (vals[:, 0], keys,
            {c: vals[:, 1 + j] for j, c in enumerate(PARITY_CT)})


def device_live(ct, now):
    """The port's CT (tensors on the card) → its live entries as
    ``oracle_live`` gives them: only the live slots leave the device."""
    import numpy as np
    import torch
    expiry = ct["expiry"].cpu().numpy().view(np.uint32)
    slots = np.nonzero(expiry > now)[0]
    idx = torch.as_tensor(slots, device=ct["expiry"].device)
    rows = {k: ct[k].index_select(0, idx).cpu().numpy().view(np.uint32)
            for k in ("keys",) + PARITY_CT}
    return (slots.astype(np.int64), rows["keys"],
            {c: rows[c].astype(np.int64) for c in PARITY_CT})


def ct_mismatches(dev, ora):
    """Two live tables (``device_live`` / ``oracle_live``) → descriptions
    of where they differ: the live slots, each slot's key and its
    flags, expiry, counters and rev-NAT."""
    import numpy as np
    d_slots, d_keys, d_cols = dev
    o_slots, o_keys, o_cols = ora
    if d_slots.shape != o_slots.shape or (d_slots != o_slots).any():
        only_d = np.setdiff1d(d_slots, o_slots)[:3].tolist()
        only_o = np.setdiff1d(o_slots, d_slots)[:3].tolist()
        return [f"live slots: device {d_slots.size}, oracle {o_slots.size}; "
                f"only the device's {only_d}, only the oracle's {only_o}"]
    bad = (d_keys != o_keys).any(axis=1)
    for c in PARITY_CT:
        bad |= d_cols[c] != o_cols[c]
    return [f"slot {d_slots[j]}: device {d_keys[j].tolist()} "
            f"{[int(d_cols[c][j]) for c in PARITY_CT]}, oracle "
            f"{o_keys[j].tolist()} {[int(o_cols[c][j]) for c in PARITY_CT]}"
            for j in np.nonzero(bad)[0]]


def parity_part(label, snap, m, step, live, make_batch, cap,
                lb=False, sequential=False, image=None, sweep=None):
    """Classify the batches ``make_batch(k, last)`` gives (None ends the
    run; ``last`` holds the previous batch, its records and the oracle's
    verdicts) with ``step(batch, now) → (out, host_ms, cuda_ms,
    counters)``, and each one with ``m``'s oracle over the same snapshot
    (snapshot batch mode, or one packet at a time with ``sequential``), on
    a bounded CT of ``cap`` slots and the device's probe depth: every
    row's ``PARITY_COLS`` (and with ``lb`` its LB columns), the step's
    counters and, after every batch, every live CT entry (``live(now)``)
    must be equal. ``image`` (``ctfull_image``, already in the device's
    CT) seeds the oracle's table; with ``sweep`` = (k, ``fn``) a
    whole-table GC pass ``fn(now) → (reclaimed, live)`` runs on the device
    before batch ``k``, and the oracle's ``sweep`` beside it. Any
    difference raises. → the run's counts and the batches it ran."""
    import itertools
    from types import SimpleNamespace

    import numpy as np
    oracle = m.oracle.Oracle.for_snapshot(
        snap, m.oracle.ConntrackTable(capacity=cap, probe_depth=8))
    if image is not None:
        ctfull_install(m, oracle.ct, image)
    res = SimpleNamespace(label=label, batches=[], rows=0, ct_entries=0,
                          oracle_s=0.0, host_ms=[], cuda_ms=[], reused=0,
                          expired=0, ct_full=0, evicted=0, occupancy=[],
                          swept=None)
    last, prev_live = None, None
    for k in itertools.count():
        nxt = make_batch(k, last)
        if nxt is None:
            break
        b, now = nxt
        if sweep is not None and k == sweep[0]:
            reclaimed, n_live = sweep[1](now)
            want_live = sum(e.expiry > now
                            for e in oracle.ct.entries.values())
            oracle.ct.sweep(now)
            check(n_live == want_live,
                  f"parity {label}: the sweep at {now} counts {n_live} "
                  f"live entries, the oracle {want_live}")
            res.swept = (reclaimed, n_live)
        recs = batch_records(b, snap.ep_ids, m.oracle.PacketRecord)
        fails0, evicted0 = oracle.ct.insert_fail, oracle.ct.evicted
        t0 = time.perf_counter()
        want = ([oracle.classify(p, now) for p in recs] if sequential
                else oracle.classify_batch_snapshot(recs, now))
        res.oracle_s += time.perf_counter() - t0
        out, host, cuda, cnt = step(b, now)
        res.host_ms.append(host)
        res.cuda_ms.append(cuda)
        wcols = verdict_columns(want)
        bad = []
        for c in PARITY_COLS:
            got = np.asarray(out[c]).astype(np.int64)
            bad += [f"row {i} {c}: {got[i]} != {wcols[c][i]} ({recs[i]})"
                    for i in np.nonzero(got != wcols[c])[0]]
        if lb:
            bad += lb_mismatches(out, want)
        bad += counter_mismatches(cnt, wcols, b["direction"],
                                  oracle.ct.insert_fail - fails0,
                                  oracle.ct.evicted - evicted0, m.C)
        dev = live(now)
        bad += ct_mismatches(dev, oracle_live(oracle, now))
        check(not bad, f"parity {label} batch {k} (now {now}): "
                       f"{len(bad)} mismatches with the oracle: {bad[:5]}")
        if prev_live is not None:
            # slots live before this batch that now hold another flow, and
            # entries that expired between the two batches' clocks
            _s, i_was, i_now = np.intersect1d(prev_live[0], dev[0],
                                              assume_unique=True,
                                              return_indices=True)
            res.reused += int((prev_live[1][i_was] != dev[1][i_now])
                              .any(axis=1).sum())
            res.expired += int((prev_live[2]["expiry"] <= now).sum())
        prev_live = dev
        res.batches.append((b, now))
        res.rows += len(recs)
        res.ct_entries += int(dev[0].size)
        res.ct_full += int((wcols["reason"] == m.C.DropReason.CT_FULL).sum())
        res.occupancy.append(dev[0].size / cap)
        last = SimpleNamespace(batch=b, records=recs, verdicts=want)
    res.evicted = oracle.ct.evicted
    return res


def reply_rows(b, rows, last, C):
    """Rows ``rows`` of ``b`` become replies of flows the oracle allowed as
    NEW in ``last`` (the first such flows, in row order): addresses and
    ports swapped, the other direction, an ACK (no flags off TCP), no L7
    tokens."""
    import numpy as np
    prev = last.batch
    src_rows = np.nonzero(np.fromiter(
        (v.allow and v.ct_status == C.CTStatus.NEW for v in last.verdicts),
        bool, len(last.verdicts)))[0][:rows.size]
    rows = rows[:src_rows.size]
    for k in ("proto", "is_v6", "ep_slot", "valid"):
        b[k][rows] = prev[k][src_rows]
    b["src"][rows], b["dst"][rows] = prev["dst"][src_rows], \
        prev["src"][src_rows]
    b["sport"][rows], b["dport"][rows] = prev["dport"][src_rows], \
        prev["sport"][src_rows]
    b["direction"][rows] = 1 - prev["direction"][src_rows]
    b["tcp_flags"][rows] = np.where(prev["proto"][src_rows] == C.PROTO_TCP,
                                    C.TCP_ACK, 0)
    b["http_method"][rows] = C.HTTP_METHOD_ANY
    b["http_path"][rows] = 0


def parity_clock(k, n):
    """Batch ``k`` of ``n``'s clock: ``PARITY_TICK`` apart, the last after
    a jump of ``PARITY_JUMP``."""
    return 1000 + PARITY_TICK * k + (PARITY_JUMP - PARITY_TICK) * (k == n - 1)


def cfg5_parity_batches(next_batch, n, rows=None):
    """``make_batch`` for part (a): cfg5's churn rewritten as
    ``golden_packets`` rewrites it: even rows SYN, every 16th from row 7 a
    FIN and from row 15 an RST, every 8th from row 3 to a port no rule
    opens, from row 5 from a source outside the ipcache (203/8), and from
    the second batch on every 8th from row 1 a reply of a flow the
    previous batch opened. ``rows``: only a batch's first rows."""
    import numpy as np
    from cilium_tpu_torch.utils import constants as C

    def make(k, last):
        if k == n:
            return None
        b = next_batch()
        if rows is not None:
            b = head_rows(b, rows)
        i = np.arange(b["valid"].shape[0])
        b["tcp_flags"][i % 2 == 0] = C.TCP_SYN
        b["tcp_flags"][i % 16 == 7] = C.TCP_FIN | C.TCP_ACK
        b["tcp_flags"][i % 16 == 15] = C.TCP_RST
        closed = i % 8 == 3
        b["dport"][closed] = 30000 + i[closed] % 30000
        outside = i % 8 == 5
        b["src"][outside, 3] = 0xCB000000 | i[outside]
        if last is not None:
            reply_rows(b, i[i % 8 == 1], last, C)
        return b, parity_clock(k, n)
    return make


def mixed_parity_batches(next_batch, n, rows=None):
    """``make_batch`` for part (b): the mixed world's traffic (~25% v6, L7
    tokens on the L7 ports, UDP, egress on the unenforced direction), with
    every 16th TCP row from row 7 a FIN and from row 15 an RST, and from
    the second batch on every 8th from row 1 a reply of a flow the
    previous batch opened. ``rows``: only a batch's first rows."""
    import numpy as np
    from cilium_tpu_torch.utils import constants as C

    def make(k, last):
        if k == n:
            return None
        b = next_batch()
        if rows is not None:
            b = head_rows(b, rows)
        i = np.arange(b["valid"].shape[0])
        tcp = b["proto"] == C.PROTO_TCP
        b["tcp_flags"][tcp & (i % 16 == 7)] = C.TCP_FIN | C.TCP_ACK
        b["tcp_flags"][tcp & (i % 16 == 15)] = C.TCP_RST
        if last is not None:
            reply_rows(b, i[i % 8 == 1], last, C)
        return b, parity_clock(k, n)
    return make


def records_batches(m, ep_slot_of, batches):
    """``make_batch`` over ``batches``: (records, or a callable ``last →
    records``; now) pairs, packed with ``m``'s ``batch_from_records``."""

    def make(k, last):
        if k == len(batches):
            return None
        recs, now = batches[k]
        if callable(recs):
            recs = recs(last)
        return m.records.batch_from_records(recs, ep_slot_of), now
    return make


def lb_parity_batches(m, ep_slot_of):
    """Part (c)'s batches, ``test_lb.py``'s flows: SYNs to the ClusterIP
    and the NodePort of ``api`` (DNAT to a Maglev-picked backend), to
    ``blocked`` (DNAT to a port policy does not open), to ``empty`` (no
    backend: NO_SERVICE) and to a backend directly (no service); then the
    replies from the backends the oracle picked (rev-NAT to the
    frontend); then the forward flows again (ESTABLISHED, the same
    backend)."""
    import dataclasses
    C = m.C
    first = ([lb_packet(m, "172.20.0.10", 80, 40000 + i) for i in range(16)]
             + [lb_packet(m, "192.168.2.100", 30080, 41000 + i)
                for i in range(8)]
             + [lb_packet(m, "172.20.0.11", 80, 42000 + i) for i in range(4)]
             + [lb_packet(m, "172.20.0.12", 80, 43000 + i) for i in range(3)]
             + [lb_packet(m, "10.50.0.1", 8080, 44000 + i)
                for i in range(3)])

    def replies(last):
        return [m.oracle.PacketRecord(
            v.nat_dst, p.src_addr, v.nat_dport, p.src_port, C.PROTO_TCP,
            C.TCP_SYN | C.TCP_ACK, False, 1, C.DIR_INGRESS)
            for p, v in zip(last.records, last.verdicts) if v.allow and v.svc]

    again = [dataclasses.replace(p, tcp_flags=C.TCP_ACK) for p in first]
    return records_batches(m, ep_slot_of, [(first, 1000), (replies, 1010),
                                             (again, 1020)])


def small_parity_batches(m, ep_slot_of, seed, n, rows, now0, step):
    """``make_batch`` of ``test_parity.py``'s random traffic: ``n``
    batches of ``rows`` packets from ``random.Random(seed)``, the prior
    flows those the oracle allowed as NEW."""
    import random
    rng = random.Random(seed)
    prior = []

    def make(k, last):
        if k == n:
            return None
        if last is not None:
            prior.extend(p for p, v in zip(last.records, last.verdicts)
                         if v.allow and v.ct_status == m.C.CTStatus.NEW)
        recs = [parity_packet(m, rng, prior) for _ in range(rows)]
        return m.records.batch_from_records(recs, ep_slot_of), now0 + step * k
    return make


def cfg5_open_port(pod, rng, smoke):
    """A TCP port of pod ``p{pod}``'s own cfg5 rules, drawn from ``rng``."""
    from cilium_tpu_torch.world import cfg5_sizes
    n_ids, n_rules = cfg5_sizes(smoke)[:2]
    k = rng.integers(0, max(1, n_rules // n_ids), len(pod))
    return 1024 + (pod + n_ids * k) % 25000


def ctfull_image(cap, seed, smoke, fill=CTFULL_FILL, probe_depth=8):
    """Part (e)'s seeded table: established TCP flows of cfg5 (pod → web on
    a port of the pod's own rules, direction ingress), each as its SYN and
    then an ACK at ``CTFULL_T0`` leave it (SEEN_NON_SYN, so not evictable;
    two forward packets), placed one flow at a time in the first free slot
    of its probe window, as the sequential oracle places them, until
    ``fill`` of the ``cap`` slots hold one. A repeated flow is passed over,
    and so is one whose window is full. → namespace: ``ct`` (the CT arrays
    as uint32 numpy), ``flows`` (the distinct candidates in order: pod,
    sport, dport; int64 [n, 3]), ``placed`` (the indices of those that
    took a slot), ``slots`` (the slot each took)."""
    from types import SimpleNamespace

    import numpy as np
    from cilium_tpu_torch.compile.ct_layout import CT_FIELDS
    from cilium_tpu_torch.kernels.hashing import hash_words_np
    from cilium_tpu_torch.utils import constants as C
    from cilium_tpu_torch.world import cfg5_sizes
    n_ids = cfg5_sizes(smoke)[0]
    rng = np.random.default_rng(seed)
    target = int(np.ceil(fill * cap))
    occ = bytearray(cap)
    seen, flows, placed, slots = set(), [], [], []
    while len(slots) < target:
        pod = rng.integers(0, n_ids, target)
        sport = rng.integers(20000, 60000, target)
        dport = cfg5_open_port(pod, rng, smoke)
        base = hash_words_np(ctfull_keys(np.stack([pod, sport, dport], 1))) \
            & np.uint32(cap - 1)
        for f in zip(pod.tolist(), sport.tolist(), dport.tolist(),
                     base.tolist()):
            if f[:3] in seen:
                continue
            seen.add(f[:3])
            flows.append(f[:3])
            for r in range(probe_depth):
                slot = (f[3] + r) & (cap - 1)
                if not occ[slot]:
                    occ[slot] = 1
                    placed.append(len(flows) - 1)
                    slots.append(slot)
                    break
            if len(slots) == target:
                break
    flows = np.asarray(flows, dtype=np.int64)
    placed = np.asarray(placed, dtype=np.int64)
    slots = np.asarray(slots, dtype=np.int64)
    ct = {k: np.zeros((cap, 10) if k == "keys" else (cap,), np.uint32)
          for k in CT_FIELDS}
    ct["keys"][slots] = ctfull_keys(flows[placed])
    ct["expiry"][slots] = CTFULL_T0 + C.CT_LIFETIME_TCP
    ct["created"][slots] = CTFULL_T0
    ct["flags"][slots] = C.CT_FLAG_SEEN_NON_SYN
    ct["pkts_fwd"][slots] = 2
    return SimpleNamespace(ct=ct, flows=flows, placed=placed, slots=slots)


def ctfull_install(m, table, image):
    """Put ``image``'s entries into ``m``'s bounded oracle CT ``table`` at
    their slots (``ConntrackTable.install``)."""
    ct = image.ct
    slots = image.slots
    kb = ct["keys"][slots].astype(">u4").tobytes()
    cols = [ct[c][slots].tolist() for c in ("expiry", "created", "flags",
                                             "pkts_fwd", "pkts_rev",
                                             "rev_nat")]
    w8 = ct["keys"][slots, 8].tolist()
    w9 = ct["keys"][slots, 9].tolist()
    for j, (slot, exp, cre, fl, pf, pr, rn, a, b) in enumerate(
            zip(slots.tolist(), *cols, w8, w9)):
        key = (kb[40 * j:40 * j + 16], kb[40 * j + 16:40 * j + 32],
               a >> 16, a & 0xFFFF, b >> 8, b & 0xFF)
        table.install(key, m.oracle.CTEntry(
            expiry=exp, created=cre, flags=fl, pkts_fwd=pf, pkts_rev=pr,
            rev_nat=rn), slot)


def ctfull_rows(b, rows, flows, flags, reply=False):
    """Rows ``rows`` of batch ``b`` carry ``flows`` (pod, sport, dport)
    with ``flags``: forward (pod → web, ingress) or their replies (web →
    pod, egress)."""
    from cilium_tpu_torch.utils import constants as C
    from cilium_tpu_torch.world import WEB_IP_WORD
    pod_w = 0xAC100000 + flows[:, 0]
    b["src"][rows, 2] = b["dst"][rows, 2] = 0xFFFF
    b["src"][rows, 3] = WEB_IP_WORD if reply else pod_w
    b["dst"][rows, 3] = pod_w if reply else WEB_IP_WORD
    b["sport"][rows] = flows[:, 2] if reply else flows[:, 1]
    b["dport"][rows] = flows[:, 1] if reply else flows[:, 2]
    b["proto"][rows] = C.PROTO_TCP
    b["tcp_flags"][rows] = flags
    b["direction"][rows] = C.DIR_EGRESS if reply else C.DIR_INGRESS
    b["valid"][rows] = True


def ctfull_keys(flows):
    """The forward CT key words [n, 10] (uint32) of cfg5 flows (pod, sport,
    dport), as the device's ``ct_key_words`` and the oracle build them."""
    import numpy as np
    from cilium_tpu_torch.kernels.records import ct_key_words_np, empty_batch
    b = empty_batch(len(flows))
    ctfull_rows(b, np.arange(len(flows)), flows, 0)
    return ct_key_words_np(b)


def ctfull_clock(k, n):
    """Part (e)'s batch ``k`` of ``n``: ``PARITY_TICK`` apart, and from the
    last but one on after a jump past the SYN lifetime."""
    from cilium_tpu_torch.utils import constants as C
    return CTFULL_T0 + PARITY_TICK * k + C.CT_LIFETIME_SYN * (k >= n - 2)


def ctfull_parity_batches(image, n, rows, seed, smoke):
    """``make_batch`` for part (e), on cfg5's world over ``image``'s table:
    six rows of every 8 a SYN flood of new flows (fresh every batch,
    allowed, so each wants a slot; evictable, they churn among
    themselves), row 3 data of seeded flows (ESTABLISHED), row 7 of every
    16 their replies (REPLY) and row 15 new legit flows (a SYN each; from
    the second batch on, half of them the ACKs of the previous batch's).
    Clocks from ``ctfull_clock``."""
    import numpy as np
    from cilium_tpu_torch.kernels.records import empty_batch
    from cilium_tpu_torch.utils import constants as C
    from cilium_tpu_torch.world import cfg5_sizes
    n_ids = cfg5_sizes(smoke)[0]
    rng = np.random.default_rng(seed + 1)
    seeded = image.flows[image.placed]
    legit = [None]

    def fresh(count, lo, hi):
        pod = rng.integers(0, n_ids, count)
        return np.stack([pod, rng.integers(lo, hi, count),
                         cfg5_open_port(pod, rng, smoke)], axis=1)

    def make(k, _last):
        if k == n:
            return None
        b = empty_batch(rows)
        i = np.arange(rows)
        flood = i[(i % 8 != 3) & (i % 8 != 7)]
        ctfull_rows(b, flood, fresh(flood.size, 1024, 20000), C.TCP_SYN)
        for sel, reply in ((i % 8 == 3, False), (i % 16 == 7, True)):
            r = i[sel]
            ctfull_rows(b, r, seeded[rng.integers(0, len(seeded), r.size)],
                        C.TCP_ACK, reply)
        new = i[i % 16 == 15]
        if legit[0] is not None:
            acks, new = new[:new.size // 2], new[new.size // 2:]
            ctfull_rows(b, acks, legit[0][:acks.size], C.TCP_ACK)
        legit[0] = fresh(new.size, 60000, 65536)
        ctfull_rows(b, new, legit[0], C.TCP_SYN)
        return b, ctfull_clock(k, n)
    return make


def counter_mismatches(cnt, wcols, direction, fails, evicted, C):
    """The step's counters against the oracle's verdicts on the same rows
    (every row valid): each reason × direction cell, ``insert_fail`` and
    ``ct_evicted`` (the oracle's CT_FULL rows and tail evictions of the
    batch). → [description]."""
    import numpy as np
    cells = C.DROP_REASON_BINS * 2
    want = np.bincount(wcols["reason"] * 2 + np.asarray(direction, np.int64),
                       minlength=cells)[:cells]
    got = np.asarray(cnt["by_reason_dir"]).astype(np.int64).reshape(-1)
    bad = [f"by_reason_dir[{c}]: {got[c]} != {want[c]}"
           for c in np.nonzero(got != want)[0]]
    for name, w in (("insert_fail", fails), ("ct_evicted", evicted)):
        g = int(np.asarray(cnt[name]).astype(np.int64))
        if g != w:
            bad.append(f"{name}: {g} != {w}")
    return bad


def ct_image_to(ct, image):
    """Write ``image``'s CT arrays (uint32 numpy) into the port's ``ct``."""
    import torch
    from cilium_tpu_torch.convert import port_dtype
    for k, v in image.ct.items():
        ct[k].copy_(torch.from_numpy(port_dtype(v)))


def port_sweep(ct):
    """A whole-table GC pass over the port's ``ct`` in place, in chunks of
    ``SERVE_GC_CHUNK`` rows as ``TorchDatapath.sweep_step`` drives
    ``ct_sweep_chunk``. → ``sweep(now) → (reclaimed, live)``."""
    from cilium_tpu_torch.kernels.conntrack import ct_sweep_chunk

    def sweep(now):
        cap = ct["expiry"].shape[0]
        chunk = min(cap, SERVE_GC_CHUNK)
        reclaimed = live = 0
        for start in range(0, cap, chunk):
            _ct, n, live = ct_sweep_chunk(ct, now, start, chunk,
                                          count_now=now, inplace=True)
            reclaimed += int(n)
        return reclaimed, int(live)
    return sweep


def port_step(fn, tensors, ct, world_index, pack=None):
    """``step`` of ``parity_part`` for the port: ``fn`` (a
    ``make_classify_fn`` of the port, CT donated) on ``DEVICE`` over the
    placed ``tensors`` and ``ct``; ``pack`` the wire the batch ships as
    (else the batch dict). → (out as numpy, host ms of the call, device
    ms between CUDA events around it, or None off the card, the counters
    as numpy)."""
    import torch
    from cilium_tpu_torch.convert import to_numpy

    def step(b, now):
        wire = pack(b) if pack is not None else b
        cuda = DEVICE == "cuda"
        if cuda:
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        out, _ct, cnt = fn(tensors, ct, wire, now, world_index)
        host = (time.perf_counter() - t0) * 1e3
        if cuda:
            ev[1].record()
            torch.cuda.synchronize()
        return (to_numpy(out), host,
                ev[0].elapsed_time(ev[1]) if cuda else None, to_numpy(cnt))
    return step


def parity_line(res, launches, card, what, seconds):
    import numpy as np
    cuda = [x for x in res.cuda_ms if x is not None]
    dev = (f"cuda p50 {np.median(cuda):.3f} ms" if cuda else
           "cuda not measured" + (" (off the card)" if DEVICE != "cuda"
                                  else " (the served path)"))
    return (f"parity {res.label}: {len(res.batches)} batches, {res.rows} "
            f"rows, each row's {', '.join(PARITY_COLS)}{what} and each "
            f"batch's counters equal to the oracle's; the live CT after every batch equal slot for slot "
            f"(key, flags, expiry, counters, rev-NAT): {res.ct_entries} "
            f"entries compared, {res.expired} expired and {res.reused} "
            f"slots reused across the clock; oracle {res.oracle_s:.3f} s "
            f"(host); step host p50 {np.median(res.host_ms):.3f} ms, {dev} "
            f"per batch; launches {json.dumps(launches)}; mismatches 0; "
            f"the part {seconds:.3f} s (host clock) [{card}]")


#: phase parity's parts, in order
PARITY_PARTS = ("cfg5", "mixed", "services", "never", "always", "sequential",
                "ctfull", "engine")


def parity_spec(part, cfg5=None, mixed=None):
    """What part ``part`` of phase parity runs: (a) ``"cfg5"`` and (b)
    ``"mixed"`` on those worlds (their placed tensors and traffic, a fresh
    CT of the world's size, the world's wire); (c) ``"services"`` on
    ``test_lb.py``'s world and (d) ``"never"``, ``"always"`` and
    ``"sequential"`` on ``test_parity.py``'s, compiled by the port and
    placed on ``DEVICE``, batch dicts; (e) ``"ctfull"`` on cfg5's world
    over a table seeded from ``ctfull_image`` (its size cfg6's), with a
    whole-table sweep before the last batch; (f) ``"engine"``, part (a)'s
    traffic through the served path: cfg5 built through the port's engine
    (``serve_engine``) on a fresh CT of cfg5's size (the smoke preset's
    part (a) size), its batches ``Engine.submit``-ted whole, the auditor at
    sampling 1.0 over every row. → a namespace: ``label``, ``snap``,
    ``tensors``, ``cap``, ``make`` (``parity_part``'s ``make_batch``),
    ``pack``, ``v4_only``, ``lb``, ``sequential``, ``what``, ``image``,
    ``sweep_before`` (the batch the sweep precedes), ``engine`` (part
    (f)'s, else None) and ``build_s`` (its host seconds)."""
    from types import SimpleNamespace

    from cilium_tpu_torch.convert import snapshot_tensors_to_torch
    from cilium_tpu_torch.utils import constants as C
    m = port_modules()
    sizes = PARITY[PRESET]
    spec = dict(pack=None, v4_only=False, lb=False, sequential=False,
                what="", image=None, sweep_before=None, engine=None,
                build_s=None)
    if part == "engine":
        from cilium_tpu_torch.world import cfg5_sizes, cfg5_traffic
        smoke = PRESET == "smoke"
        _ids, _rules, cap, _flows, rows = cfg5_sizes(smoke)
        cap, rows = sizes["cfg5_cap"] or cap, sizes["cfg5_rows"] or rows
        eng, cfg, build_s = serve_engine(
            ct_capacity=cap, batch_size=rows, audit_enabled=True,
            audit_sample_rate=1.0, audit_max_rows=rows,
            audit_pool_batches=sizes["engine"])
        next_batch, _warm = cfg5_traffic(0, smoke)
        return SimpleNamespace(**dict(
            spec, label=f"(f) cfg5 through Engine.submit (CT "
                        f"{cfg.ct_capacity}, batch {cfg.batch_size})",
            snap=eng.active.snapshot, tensors=None, cap=cfg.ct_capacity,
            make=cfg5_parity_batches(next_batch, sizes["engine"],
                                     sizes["cfg5_rows"]),
            v4_only=True, engine=eng, build_s=build_s))
    if part == "ctfull":
        z = sizes["ctfull"]
        smoke = PRESET == "smoke"
        image = ctfull_image(z["cap"], CTFULL_SEED, smoke)
        return SimpleNamespace(**dict(
            spec, label=f"(e) cfg5 at CT_FULL (CT {z['cap']}, batch "
                        f"{z['rows']})",
            snap=cfg5.snapshot, tensors=cfg5.tensors, cap=z["cap"],
            make=ctfull_parity_batches(image, z["batches"], z["rows"],
                                       CTFULL_SEED, smoke),
            pack=cfg5.pack, v4_only=True, image=image,
            sweep_before=z["batches"] - 1))
    if part in ("cfg5", "mixed"):
        w = cfg5 if part == "cfg5" else mixed
        cap = sizes.get(f"{part}_cap") or w.ct["expiry"].shape[0]
        rows = sizes[f"{part}_rows"]
        make = (cfg5_parity_batches if part == "cfg5"
                else mixed_parity_batches)(w.next_batch, sizes[part], rows)
        return SimpleNamespace(**dict(
            spec, label=f"({'a' if part == 'cfg5' else 'b'}) {part} (CT "
                        f"{cap}, batch {rows or w.batch})",
            snap=w.snapshot, tensors=w.tensors, cap=cap, make=make,
            pack=w.pack, v4_only=part == "cfg5"))
    if part == "services":
        snap = parity_snapshot(m, lb_world(m), 4096, lb=True)
        spec.update(label="(c) services", cap=4096,
                    make=lb_parity_batches(m, snap.ep_slot_of), lb=True,
                    what=", svc, nat_dst/nat_dport and rnat/rnat_src/"
                         "rnat_sport")
    elif part in ("never", "always"):
        world = parity_world(m)
        world[0].enforcement_mode = {"never": C.ENFORCEMENT_NEVER,
                                     "always": C.ENFORCEMENT_ALWAYS}[part]
        snap = parity_snapshot(m, world, 2048)
        spec.update(label=f"(d) test_parity's world, enforcement {part}",
                    cap=2048, make=small_parity_batches(
                        m, snap.ep_slot_of, 11, 3, 64, 100, 40))
    else:
        snap = parity_snapshot(m, parity_world(m), 1024)
        spec.update(label="(d) test_parity's world, 40 batches of one "
                          "against the sequential oracle",
                    cap=1024, make=small_parity_batches(
                        m, snap.ep_slot_of, 7, 40, 1, 500, 13),
                    sequential=True)
    tensors = snapshot_tensors_to_torch(snap.tensors(), DEVICE)
    return SimpleNamespace(**spec, snap=snap, tensors=tensors)


def ctfull_checks(res, spec):
    """Part (e)'s own checks: every check before the sweep finds
    ``CTFULL_MIN_OCC`` of the table live, and the part drops at least the
    preset's ``min_full`` rows CT_FULL and tail-evicts ``min_evicted``
    live entries. → None; a check not met raises."""
    z = PARITY[PRESET]["ctfull"]
    pre = res.occupancy[:spec.sweep_before]
    check(min(pre) >= CTFULL_MIN_OCC,
          f"parity (e): occupancy {min(pre):.6f} at a check before the "
          f"sweep, under {CTFULL_MIN_OCC}")
    check(res.ct_full >= z["min_full"],
          f"parity (e): {res.ct_full} rows CT_FULL, under {z['min_full']}")
    check(res.evicted >= z["min_evicted"],
          f"parity (e): {res.evicted} tail evictions, under "
          f"{z['min_evicted']}")
    check(res.swept is not None and res.swept[0] > 0,
          f"parity (e): the sweep reclaimed {res.swept}")


def ctfull_line(res, spec, card):
    ctfull_checks(res, spec)
    occ = ", ".join(f"{x:.6f}" for x in res.occupancy)
    return (f"parity (e) CT_FULL: {spec.image.slots.size} established "
            f"entries seeded on both sides; occupancy after each batch "
            f"[{occ}] (the sweep before batch {spec.sweep_before}); "
            f"{res.ct_full} rows CT_FULL, {res.evicted} live entries "
            f"tail-evicted; the sweep reclaimed {res.swept[0]} slots, "
            f"{res.swept[1]} live after it [{card}]")


def engine_step(eng, log):
    """``step`` of ``parity_part`` through the served path: the batch
    ``Engine.submit``-ted whole (the pipeline's direct path →
    ``TorchDatapath.classify_async`` → finalize, its folds and the
    auditor's capture) and its ticket awaited; ``log``, a ``DispatchLog``
    on the engine's datapath, must see exactly one dispatch. → (the
    ticket's out as numpy, host ms submit → result, None, that dispatch's
    counters)."""
    import numpy as np

    def step(b, now):
        n0 = log.steps()
        t0 = time.perf_counter()
        out = eng.submit(log.own(b), now=now).result(timeout=300)
        host = (time.perf_counter() - t0) * 1e3
        check(log.steps() == n0 + 1, f"parity (f): {log.steps() - n0} "
                                     f"dispatches for one batch")
        entry = [e for kind, e in log.entries if kind == "step"][-1]
        return ({k: np.asarray(v) for k, v in out.items()}, host, None,
                entry["result"][1])
    return step


def run_parity_part(spec, step_wrap=None):
    """Part ``spec`` through the port's step on ``DEVICE`` (a fresh CT), or
    through ``spec.engine``'s served path (``engine_step``), held against
    the port's oracle by ``parity_part``. ``step_wrap`` wraps the step (a
    rehearsal records its outputs). → (result, the CT, the launches)."""
    from cilium_tpu_torch.compile.ct_layout import CTConfig, make_ct_arrays
    from cilium_tpu_torch.kernels import fused as fk
    from cilium_tpu_torch.kernels.classify import make_classify_fn
    if spec.engine is not None:
        dp = spec.engine.datapath
        step = engine_step(spec.engine, DispatchLog(dp))

        def cts():
            return dp._cts[0]
    else:
        ct = make_ct_arrays(CTConfig(capacity=spec.cap), DEVICE)
        if spec.image is not None:
            ct_image_to(ct, spec.image)
        fn = make_classify_fn(v4_only=spec.v4_only,
                              packed=spec.pack is not None, donate_ct=True,
                              device=DEVICE)
        step = port_step(fn, spec.tensors, ct, spec.snap.world_index,
                         spec.pack)

        def cts():
            return ct
    fk.reset_launches()
    res = parity_part(spec.label, spec.snap, port_modules(),
                      step_wrap(step) if step_wrap else step,
                      lambda now: device_live(cts(), now), spec.make,
                      spec.cap, lb=spec.lb, sequential=spec.sequential,
                      image=spec.image,
                      sweep=None if spec.sweep_before is None
                      else (spec.sweep_before, port_sweep(cts())))
    launches = dict(fk.LAUNCHES)
    for k, v in launches.items():
        check(v >= len(res.batches) or DEVICE != "cuda",
              f"parity {spec.label}: {k} launched {v} times for "
              f"{len(res.batches)} batches")
    return res, cts(), launches


def engine_audit_line(spec, res, card):
    """Part (f)'s auditor: its captures of every row of the part's batches
    replayed against the oracle (``audit_step`` until none is pending);
    every row must be checked, none mismatched. → the line, with the
    replay's host seconds and µs a row."""
    eng = spec.engine
    t0 = time.perf_counter()
    while (eng.audit_step(budget=None) or {}).get("replayed"):
        pass
    replay_s = time.perf_counter() - t0
    st = eng.auditor.stats()
    check(st["checked_rows"] == res.rows and st["mismatched_rows"] == 0
          and not st["pending"],
          f"parity (f): the auditor checked {st['checked_rows']} of "
          f"{res.rows} rows, {st['mismatched_rows']} mismatched, "
          f"{st['pending']} pending")
    return (f"parity (f) auditor at sampling 1.0 (max rows "
            f"{eng.config.audit_max_rows}): {st['checked_batches']} "
            f"batches, {st['checked_rows']} rows replayed against the oracle "
            f"in {replay_s:.3f} s (host), "
            f"{replay_s * 1e6 / max(1, st['checked_rows']):.3f} µs a row, "
            f"{st['mismatched_rows']} mismatched; the engine built in "
            f"{spec.build_s:.3f} s (host) [{card}]")


def phase_parity(cfg5, mixed, card, report=None):
    """The main path held against the oracle on the card, part by part
    (``PARITY_PARTS``, ``parity_spec``): each batch's columns and the live
    CT after it against the port's oracle on the same snapshot. →
    phase lines."""
    total = {k: 0 for k in KERNELS}
    lines = []
    t0 = time.perf_counter()
    for part in PARITY_PARTS:
        t_part = time.perf_counter()
        spec = parity_spec(part, cfg5, mixed)
        res, _ct, launches = run_parity_part(spec)
        if part == "cfg5":
            check(res.expired > 0 and res.reused > 0,
                  f"parity (a): {res.expired} entries expired and "
                  f"{res.reused} slots reused across the clock jump")
        for k, v in launches.items():
            total[k] += v
        lines.append(parity_line(res, launches, card, spec.what,
                                 time.perf_counter() - t_part))
        if part == "ctfull":
            lines.append(ctfull_line(res, spec, card))
        if part == "engine":
            lines.append(engine_audit_line(spec, res, card))
            spec.engine.stop()
    if report is not None:
        for k, v in total.items():
            report[k]["launches"] += v
    note_launches(report, "parity", total)
    return lines + [f"parity launches: {json.dumps(total)}; the phase "
                    f"{time.perf_counter() - t0:.3f} s (host clock)"]


# --------------------------------------------------------------------------- #
# serve: cfg5 through the port's engine, pipeline and TorchDatapath
# --------------------------------------------------------------------------- #
#: the storm's pods and ports: pod p{k} → TCP 4235 + k (pod p7 → 4242, the
#: rule of phase update), each a port none of the pod's own rules opens
STORM_PODS = 8
STORM_PORT0 = 4235
#: churn batches submitted through the pipeline after the 2 warm ones
#: with nothing else running; beside the storm at least as many, at most
#: four times
SERVE_BATCHES = 16
#: GC ticks interleaved with the storm, and rows per tick
SERVE_GC_TICKS = 4
SERVE_GC_CHUNK = 1 << 16
#: rows of each storm probe that go pod p{k} → web:(4235 + k)
STORM_PROBE_ROWS = 1024


def storm_docs(pod, port, label):
    """``bench.py``'s one-pod, one-port storm rule, labelled for toggling."""
    return [{"endpointSelector": {"matchLabels": {"app": "web"}},
             "labels": [label],
             "ingress": [{"fromEndpoints": [{"matchLabels":
                                             {"pod": f"p{pod}"}}],
                          "toPorts": [{"ports": [{"port": str(port),
                                                  "protocol": "TCP"}]}]}]}]


def cfg5_engine_world(eng, m, smoke):
    """cfg5 built through ``eng``'s engine API as ``bench.py`` builds it
    for the reference's update storm (the web endpoint, one identity and a
    /32 per pod, the rules through ``repo.add``, ``regenerate``), with
    ``m``'s ``labels`` and ``rules`` modules (the engine's package), at the
    ``smoke`` preset's sizes or full width. → ``eng``."""
    from cilium_tpu_torch.world import cfg5_sizes
    n_ids, n_rules = cfg5_sizes(smoke)[:2]
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.0.10",), ep_id=1)
    for i in range(n_ids):
        ident = eng.ctx.allocator.allocate(
            m.labels.Labels.parse([f"k8s:pod=p{i}"]))
        eng.ctx.ipcache.upsert(
            f"172.{16 + (i >> 16)}.{(i >> 8) & 0xFF}.{i & 0xFF}/32",
            ident.id)
    eng.repo.add([m.rules.parse_rule({
        "endpointSelector": {"matchLabels": {"app": "web"}},
        "ingress": [{
            "fromEndpoints": [{"matchLabels": {"pod": f"p{j % n_ids}"}}],
            "toPorts": [{"ports": [{"port": str(1024 + (j % 25000)),
                                    "protocol": "TCP"}]}]}]})
        for j in range(n_rules)])
    eng.regenerate()
    return eng


def serve_engine(**overrides):
    """cfg5 built through the port's engine API (``cfg5_engine_world``) at
    ``PRESET``'s width; ``overrides`` are further ``DaemonConfig`` fields.
    → (engine, its config, host seconds)."""
    from cilium_tpu_torch.runtime import DaemonConfig, Engine
    from cilium_tpu_torch.runtime.datapath import TorchDatapath
    from cilium_tpu_torch.world import cfg5_sizes
    smoke = PRESET == "smoke"
    _ids, _rules, cap, _flows, batch = cfg5_sizes(smoke)
    kw = dict(device=DEVICE, ct_capacity=cap, batch_size=batch,
              v4_only=True, auto_regen=False, pipeline_inflight=2,
              pipeline_flush_ms=1.0, ct_gc_chunk_rows=SERVE_GC_CHUNK,
              audit_max_rows=512, flowlog_mode="none")
    kw.update(overrides)
    cfg = DaemonConfig(**kw)
    t0 = time.perf_counter()
    eng = cfg5_engine_world(Engine(cfg, datapath=TorchDatapath(cfg)),
                            port_modules(), smoke)
    return eng, cfg, time.perf_counter() - t0


class DispatchLog:
    """Wraps the engine datapath's ``classify_async``, ``sweep_step`` and
    ``place_patch``: keeps every dispatch (its snapshot, its batch, ``now``
    and, once finalized, a copy of its outputs) and every GC tick in the
    order they reached the stream, and the host time of each call. One
    lock around each whole call makes that order the stream's. A batch the
    smoke submitted whole (``own``) reaches the datapath as it was
    submitted, on the pipeline's direct path, and is kept by reference;
    any other (a staged, coalesced batch) is copied.

    It also times each part of a single-device ``classify_async``, by
    wrapping the datapath's own steps on the instance: ``pack``
    (``_columnar`` + ``_pack_wire``), ``upload`` (``_upload_wire``),
    ``step`` (``_classify``, under ``_ct_lock``) and ``fetch``
    (``_fetch``); ``time(obj, attr, name)`` times any other call so.
    ``window(label, edge)`` marks where a window starts or ends (``edge``
    "start" or "end", the pipeline drained) with ``window_counters()`` and
    ``host_probe()`` there; ``summary()`` → each window's medians of every
    timer, the counters' change over it and the probes at its edges. On
    the card each step also records a CUDA event at its start and end:
    ``step_device`` is the device's span between them, ``step_lag`` how
    long after the host's return from the step the device reached its
    end (timed from an event recorded at the window's start, the device
    idle there): near 0 while the host's launches hold the device back,
    the queued work's time when the device holds the host back."""

    PARTS = ("pack", "upload", "step", "fetch")

    def __init__(self, dp):
        import threading
        self.dp = dp
        self.entries = []
        self.lock = threading.Lock()
        self.owned = {}
        self.n_steps = 0
        self.async_ms, self.finalize_ms, self.place_ms = [], [], []
        # with ``counting``, each dispatch's Python-level torch calls
        # (``classify_async`` and its finalize; ``dispatch_calls``)
        self.counting, self.torch_calls = False, []
        # every timer's host ms, call by call, and the windows' marks
        self.ms = {"classify_async": self.async_ms,
                   "finalize": self.finalize_ms}
        self.marks = {}
        self._columnar_ms = 0.0
        # (host ms, tensors placed whole, delta rows) of each patch; the
        # dispatches that reached the datapath with a host-only ``_``
        # column in them, and the widest wire uploaded (words a row): the
        # pack reads only the wire's own columns
        self.patches, self.host_cols, self.wire_words = [], 0, 0
        for attr, name in (("_columnar", "columnar"), ("_pack_wire", "pack"),
                           ("_classify", "step"), ("_fetch", "fetch")):
            if hasattr(dp, attr):
                self.time(dp, attr, name)
        # (host s, event) at each step's start and end, on the card
        self.step_events = []
        if DEVICE == "cuda" and hasattr(dp, "_classify"):
            dp._classify = self._evented(dp._classify)
        self._async, self._sweep = dp.classify_async, dp.sweep_step
        self._patch, self._remesh = dp.place_patch, dp.remesh
        self._upload = self.timed(dp._upload_wire, "upload")
        dp._upload_wire = self.upload_wire
        dp.classify_async = self.classify_async
        dp.sweep_step = self.sweep_step
        dp.place_patch = self.place_patch
        dp.remesh = self.remesh

    def timed(self, real, name):
        """``real``, adding the host ms of each call to the timer ``name``
        (``columnar``'s ms are carried into the next ``pack``)."""
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return real(*args, **kw)
            finally:
                ms = (time.perf_counter() - t0) * 1e3
                if name == "columnar":
                    self._columnar_ms = ms
                else:
                    if name == "pack":
                        ms, self._columnar_ms = ms + self._columnar_ms, 0.0
                    self.ms.setdefault(name, []).append(ms)
        return call

    def time(self, obj, attr, name):
        """Time every call of ``obj.attr`` (wrapped on the instance)."""
        self.ms.setdefault(name, [])
        setattr(obj, attr, self.timed(getattr(obj, attr), name))

    def _evented(self, step):
        import torch

        def call(*args, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            h0 = time.perf_counter()
            try:
                return step(*args, **kw)
            finally:
                h1 = time.perf_counter()
                ev[1].record()
                self.step_events.append((h0, ev[0], h1, ev[1]))
        return call

    def window(self, label, edge):
        ref = None
        if DEVICE == "cuda":
            import torch
            ref = torch.cuda.Event(enable_timing=True)
            ref.record()
            ref = (time.perf_counter(), ref)
        self.marks[(label, edge)] = (
            {k: len(v) for k, v in self.ms.items()}, window_counters(),
            host_probe(), (len(self.step_events), ref))

    def summary(self):
        import numpy as np
        res = {}
        labels = sorted({lb for lb, _e in self.marks},
                        key=lambda lb: self.marks[(lb, "start")][0]["step"])
        for lb in labels:
            (i0, c0, p0, (e0, ref)), (i1, c1, p1, (e1, _r)) = \
                self.marks[(lb, "start")], self.marks[(lb, "end")]
            med = {k: float(np.median(v[i0[k]:i1[k]]))
                   for k, v in self.ms.items() if i1.get(k, 0) > i0.get(k, 0)}
            med["dispatches"] = i1["step"] - i0["step"]
            steps = self.step_events[e0:e1]
            if ref is not None and steps:
                h_ref, ev_ref = ref
                med["step_device"] = float(np.median(
                    [a.elapsed_time(b) for _h0, a, _h1, b in steps]))
                med["step_lag"] = float(np.median(
                    [ev_ref.elapsed_time(b) - (h1 - h_ref) * 1e3
                     for _h0, _a, h1, b in steps]))
            res[lb] = {"median_ms": med, "counters": {
                k: c1[k] - c0.get(k, 0) for k in c1
                if c1[k] != c0.get(k, 0)}, "probe": {"start": p0, "end": p1}}
        return res

    def own(self, batch):
        """Mark ``batch`` as the smoke's, never written after submit."""
        with self.lock:
            self.owned[id(batch["valid"])] = batch
        return batch

    def _counted(self, fn, *args):
        """``fn(*args)`` and the torch calls it made from Python on this
        thread (None unless ``counting``)."""
        if not self.counting:
            return fn(*args), None
        from mesh_dispatch import TorchCalls
        with TorchCalls() as mode:
            return fn(*args), mode.calls

    def classify_async(self, placed, snap, batch, now, pre_steered=False):
        import numpy as np
        with self.lock:
            t0 = time.perf_counter()
            fin, calls = self._counted(self._async, placed, snap, batch, now,
                                       pre_steered)
            self.async_ms.append((time.perf_counter() - t0) * 1e3)
            self.host_cols += any(k.startswith("_") for k in batch)
            mine = self.owned.pop(id(batch["valid"]), None)
            if mine is None or any(batch[k] is not mine.get(k)
                                   for k in batch):
                mine = {k: np.array(v) for k, v in batch.items()}
            entry = {"snap": snap, "now": now, "result": None,
                     "batch": mine, "pre_steered": pre_steered}
            self.entries.append(("step", entry))
            self.n_steps += 1

        def finalize():
            t0 = time.perf_counter()
            (out, counters), more = self._counted(fin)
            self.finalize_ms.append((time.perf_counter() - t0) * 1e3)
            if calls is not None:
                self.torch_calls.append(calls + (more or Counter()))
            entry["result"] = ({k: np.array(v) for k, v in out.items()},
                               {k: np.array(v) for k, v in counters.items()})
            return out, counters
        return finalize

    def upload_wire(self, wire, wire_buf, device=None, rows=None):
        self.wire_words = max(self.wire_words, int(wire.shape[-1]))
        return self._upload(wire, wire_buf, device=device, rows=rows)

    def sweep_step(self, now, chunk_rows, ttl_slash_s=0):
        with self.lock:
            st = self._sweep(now, chunk_rows, ttl_slash_s)
            self.entries.append(("gc", (now, chunk_rows, ttl_slash_s,
                                        dict(st))))
        return st

    def place_patch(self, placed, snap, patch):
        t0 = time.perf_counter()
        res = self._patch(placed, snap, patch)
        ms = (time.perf_counter() - t0) * 1e3
        self.place_ms.append(ms)
        rows = patch.delta_rows
        self.patches.append((ms, sorted(patch.full_tensors),
                             0 if rows is None else int(rows.shape[0])))
        return res

    def remesh(self, live_ordinals, fence_handle=None, salvage_floor=None):
        with self.lock:
            res = self._remesh(live_ordinals, fence_handle=fence_handle,
                               salvage_floor=salvage_floor)
            self.entries.append(("remesh", (list(live_ordinals),
                                            salvage_floor, dict(res))))
        return res

    def steps(self):
        return self.n_steps


#: ``torch.cuda.memory_stats`` counters read at a window's edges
DEVICE_ALLOC_KEYS = ("num_alloc_retries", "num_device_alloc",
                     "num_device_free", "num_sync_all_streams",
                     "segment.all.allocated", "segment.all.freed")


def thread_cpu_s():
    """CPU seconds (user + system) of each thread of this process, from
    ``/proc/self/task``, keyed ``cpu_s.<name>``: a Python thread's name,
    else the kernel's name of the thread and its id. Empty where there is
    no ``/proc``."""
    import threading
    names = {t.native_id: t.name for t in threading.enumerate()}
    tick = os.sysconf("SC_CLK_TCK")
    res = {}
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return res
    for tid in tids:
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                stat = f.read()
        except OSError:               # the thread ended meanwhile
            continue
        comm = stat[stat.index("(") + 1:stat.rindex(")")]
        fields = stat[stat.rindex(")") + 2:].split()
        name = names.get(int(tid)) or f"{comm}.{tid}"
        res[f"cpu_s.{name}"] = (int(fields[11]) + int(fields[12])) / tick
    return res


#: Python's GC pauses, host ms summed by generation since
#: ``gc_pause_timer`` installed its callback
GC_PAUSE_MS = [0.0, 0.0, 0.0]


def gc_pause_timer():
    """Install (once) a ``gc.callbacks`` hook that sums each collection's
    pause, start to stop, into ``GC_PAUSE_MS[generation]``. A collection
    runs whole under the interpreter lock, so its start and stop pair
    without interleaving."""
    import gc
    if any(getattr(cb, "gc_pause", False) for cb in gc.callbacks):
        return
    t0 = []

    def pause(phase, info):
        if phase == "start":
            t0[:] = [time.perf_counter()]
        elif t0:
            GC_PAUSE_MS[info["generation"]] += \
                (time.perf_counter() - t0.pop()) * 1e3
    pause.gc_pause = True
    gc.callbacks.append(pause)


def window_counters():
    """What a window's edges read: each thread's CPU seconds
    (``thread_cpu_s``), Python's GC collections and pause host ms by
    generation (``gc.collections.gen<g>``, ``gc.pause_ms.gen<g>``; the
    pauses from ``gc_pause_timer``, installed at the first read), the
    device caching allocator's counters (``DEVICE_ALLOC_KEYS``) and every
    counter of the pinned host allocator that the installed torch exposes
    (``torch.cuda.host_memory_stats``), prefixed ``host.``; the
    allocators' only on the card."""
    import gc

    import torch
    gc_pause_timer()
    res = thread_cpu_s()
    stats = gc.get_stats()
    res["gc.collections"] = sum(g["collections"] for g in stats)
    for g, st in enumerate(stats):
        res[f"gc.collections.gen{g}"] = st["collections"]
        res[f"gc.pause_ms.gen{g}"] = GC_PAUSE_MS[g]
    if DEVICE != "cuda":
        return res
    dev = torch.cuda.memory_stats(DEVICE)
    res.update({k: int(dev.get(k, 0)) for k in DEVICE_ALLOC_KEYS})
    host = getattr(torch.cuda, "host_memory_stats", None)
    for k, v in (host() if host is not None else {}).items():
        if isinstance(v, (int, float)):
            res[f"host.{k}"] = v
    return res


#: the device caching allocator's state read at a window's edges: the
#: blocks it has handed out, its segments and the bytes it holds
DEVICE_ALLOC_STATE = ("active.all.current", "segment.all.current",
                      "reserved_bytes.all.current")


def host_probe():
    """What the host can do at this moment, read where the pipeline is
    idle: ``spin_ms``, a pure-Python loop (the interpreter's speed: the
    host's clock rate and this thread's share of a core); the objects
    Python's GC tracks (``gc.objects``, and in its oldest generation
    ``gc.objects.gen2``: what a gen-2 pass walks); the process's resident
    memory (``VmRSS_kB``, where ``/proc/self/status`` has it); and on the
    card the device allocator's ``DEVICE_ALLOC_STATE``."""
    import gc

    import torch
    t0 = time.perf_counter()
    sum(i * i for i in range(200_000))
    res = {"spin_ms": (time.perf_counter() - t0) * 1e3,
           "gc.objects": len(gc.get_objects()),
           "gc.objects.gen2": len(gc.get_objects(generation=2))}
    if DEVICE == "cuda":
        dev = torch.cuda.memory_stats(DEVICE)
        res.update({k: int(dev.get(k, 0)) for k in DEVICE_ALLOC_STATE})
    try:
        with open("/proc/self/status") as f:
            for line in f:
                key, _, val = line.partition(":")
                if key == "VmRSS":
                    res["VmRSS_kB"] = int(val.split()[0])
    except OSError:
        pass
    return res


class Feed:
    """Churn batches through ``Engine.submit`` from a feeder thread, at
    most ``outstanding`` unresolved, while a collector resolves the tickets
    in order and stamps submit → result. Runs until ``stop`` is set and
    ``least`` batches are in, and at most ``most``."""

    def __init__(self, eng, log, next_batch, tick, least, most,
                 outstanding=4):
        import queue
        import threading
        self.eng, self.log, self.next_batch, self.tick = (
            eng, log, next_batch, tick)
        self.least, self.most = least, most
        self.stop = threading.Event()
        self.tickets = queue.Queue()
        self.slots = threading.Semaphore(outstanding)
        self.lat_ms, self.rows, self.fed, self.errors = [], 0, 0, []
        self.threads = [threading.Thread(target=self._feed,
                                         name="serve-feeder"),
                        threading.Thread(target=self._collect,
                                         name="serve-collector")]
        self.t0 = time.perf_counter()
        self.wall_s = None
        for th in self.threads:
            th.start()

    def _feed(self):
        while self.fed < self.most and not (self.stop.is_set()
                                            and self.fed >= self.least):
            self.slots.acquire()
            b = self.log.own(self.next_batch())
            t = time.perf_counter()
            self.tickets.put((t, self.eng.submit(b, now=self.tick()),
                              int(b["valid"].sum())))
            self.fed += 1
        self.tickets.put(None)

    def _collect(self):
        while True:
            item = self.tickets.get()
            if item is None:
                return
            t, ticket, n = item
            try:
                ticket.result(timeout=300)
                self.lat_ms.append((time.perf_counter() - t) * 1e3)
                self.rows += n
            except Exception as e:            # counted, and fails the phase
                self.errors.append(f"{type(e).__name__}: {e}")
            finally:
                self.slots.release()

    def join(self):
        self.stop.set()
        for th in self.threads:
            th.join(timeout=600)
            check(not th.is_alive(), f"serve: {th.name} did not finish")
        self.wall_s = time.perf_counter() - self.t0
        check(not self.errors, f"serve: tickets lost: {self.errors[:3]}")
        return self


def fold_timers(eng, log):
    """Time on ``log`` (a ``DispatchLog``) each of the engine's per-batch
    finalize folds: the counters, flow metrics, the flight recorder, the
    auditor's capture, the per-rule hit counters and the CT-salvage grace
    window, the host work a finalized batch costs the pipeline's worker
    beside the datapath's own. → {fold: [ms, ...]}, ``log.ms``'s lists."""
    folds = {"metrics": (eng.metrics, "add_batch"),
             "flowmetrics": (eng.flowmetrics, "add_batch"),
             "blackbox": (eng.blackbox, "record_verdicts"),
             "audit_capture": (eng.auditor, "maybe_capture"),
             "rule_hits": (eng, "_fold_rule_hits"),
             "salvage": (eng, "_ct_salvage_apply")}
    for name, (obj, attr) in folds.items():
        log.time(obj, attr, name)
    return {name: log.ms[name] for name in folds}


def worker_timers(eng, log):
    """Time on ``log`` what the pipeline's worker does with each batch:
    the engine's dispatch (``engine_dispatch``, the datapath's
    ``classify_async`` inside it) and finalize (``engine_finalize``, the
    datapath's finalize and the folds inside it), and each fold
    (``fold_timers``). Starts the engine's pipeline."""
    fold_timers(eng, log)
    pipe = eng.start_pipeline()
    dispatch = pipe._dispatch_fn

    def engine_dispatch(*args, **kw):
        return log.timed(dispatch(*args, **kw), "engine_finalize")
    pipe._dispatch_fn = log.timed(engine_dispatch, "engine_dispatch")


class PlainReplay:
    """A second ``TorchDatapath`` of ``cfg``'s geometry on the same device
    with ``fused_kernels="off"``, fed a ``DispatchLog``'s dispatches, GC
    ticks and re-meshes in order (a full ``place`` of each snapshot a
    dispatch used, and again after a re-mesh): every out column, counter,
    GC result and re-mesh count must equal the engine's. ``feed(log)``
    takes all the log holds, every dispatch of it finalized, and empties
    it (its batches and copies freed as it goes), so that one replay can
    follow a log in parts; the caller compares the CT arrays at the
    end."""

    def __init__(self, cfg):
        import dataclasses

        from cilium_tpu_torch.runtime.datapath import TorchDatapath
        self.plain = TorchDatapath(dataclasses.replace(cfg,
                                                       fused_kernels="off"))
        self.placed = self.snap = None
        self.n_steps = self.n_gc = 0
        # a list: (batch, plain outputs, now) of each dispatch fed
        self.keep = None

    def feed(self, log):
        import numpy as np
        plain = self.plain
        with log.lock:
            entries, log.entries = log.entries, []
            log.owned.clear()
        for i, (kind, e) in enumerate(entries):
            entries[i] = None
            if kind == "gc":
                now, chunk, slash, want = e
                got = plain.sweep_step(now, chunk, slash)
                check(got == want, f"serve: GC tick {self.n_gc}: {got} != "
                                   f"{want}")
                self.n_gc += 1
                continue
            if kind == "remesh":
                live, floor, want = e
                got = plain.remesh(live, salvage_floor=floor)
                for k in ("to", "ct_capacity", "ct_salvaged", "ct_lost",
                          "ct_dropped", "salvage_source"):
                    check(got[k] == want[k], f"remesh to {live}: {k} "
                          f"{want[k]} on the kernel path, {got[k]} plain")
                self.snap = None         # the new mesh needs a placement
                continue
            check(e["result"] is not None, "serve: a dispatch never finalized")
            if e["snap"] is not self.snap:
                self.snap = e["snap"]
                self.placed = plain.place(self.snap)
            out, counters = plain.classify_async(
                self.placed, self.snap, e["batch"], e["now"],
                e["pre_steered"])()
            n = self.n_steps
            for got, want in zip((out, counters), e["result"]):
                check(set(got) == set(want), "serve: output keys differ")
                for k in want:
                    if got[k].dtype == want[k].dtype \
                            and np.array_equal(got[k], want[k]):
                        continue
                    if got[k].ndim == 0:
                        raise SmokeFailure(
                            f"serve: dispatch {n} (now {e['now']}) {k}: "
                            f"kernel path {want[k]}, plain {got[k]}")
                    bad = np.nonzero((got[k] != want[k]).reshape(
                        got[k].shape[0], -1).any(-1))[0]
                    raise SmokeFailure(
                        f"serve: dispatch {n} (now {e['now']}) {k} differs "
                        f"from the plain path in {len(bad)} rows, first "
                        f"{list(bad[:5])}: kernel path {want[k][bad[:3]]}, "
                        f"plain {got[k][bad[:3]]}")
            if self.keep is not None:
                self.keep.append((e["batch"], out, e["now"]))
            self.n_steps += 1
        return self


def dispatch_calls(eng, log, batches, nows):
    """Each of ``batches`` submitted at its ``nows`` and awaited, with the
    Python-level torch calls of every dispatch counted (``DispatchLog``'s
    ``counting``: a ``mesh_dispatch.TorchCalls`` mode around
    ``classify_async`` and around its finalize) → the calls of each
    dispatch by name (a ``Counter``). The mode slows the calls it
    counts: nothing is timed here."""
    n0 = len(log.torch_calls)
    log.counting = True
    try:
        for b, now in zip(batches, nows):
            eng.submit(log.own(b), now=now).result(timeout=300)
        check(eng.drain(timeout=300), "the pipeline did not drain")
    finally:
        log.counting = False
    return log.torch_calls[n0:]


def calls_text(calls):
    """min / p50 / max of the torch calls of ``dispatch_calls``'s
    dispatches, and the most frequent names (mean a dispatch)."""
    import numpy as np
    check(calls, "no dispatch was counted")
    totals = [sum(c.values()) for c in calls]
    top = sum(calls, Counter()).most_common(8)
    return (f"min {min(totals)} p50 {int(np.percentile(totals, 50))} max "
            f"{max(totals)} over {len(calls)} dispatches; by name " +
            ", ".join(f"{name} {n / len(calls):g}" for name, n in top))


def replay_plain(log, cfg):
    """``PlainReplay`` of all of ``log``. → (plain datapath, dispatches
    compared, ticks)."""
    r = PlainReplay(cfg).feed(log)
    return r.plain, r.n_steps, r.n_gc


def phase_serve(seed, card, profile=False):
    """cfg5 through the port's engine on the card: pipelined churn
    (``Engine.submit``, 2 in flight) alone, then beside a storm of rule
    toggles with overlapped GC ticks, then the shadow auditor; every
    dispatch held against the plain path. → phase lines."""
    host_bound("phase serve")
    import threading

    import numpy as np
    from cilium_tpu_torch.kernels import fused as fk
    from cilium_tpu_torch.utils import constants as C
    from cilium_tpu_torch.world import cfg5_traffic

    lines = []
    eng, cfg, build_s = serve_engine()
    lines.append(f"serve: cfg5 built through the engine in {build_s:.3f} s "
                 f"(host CPU): {len(eng.active.snapshot.ep_ids)} endpoint, "
                 f"verdict {list(eng.active.tensors['verdict'].shape)}, "
                 f"CT {cfg.ct_capacity} slots, batch {cfg.batch_size}")
    next_batch, _warm = cfg5_traffic(seed, PRESET == "smoke")
    ports = [STORM_PORT0 + k for k in range(STORM_PODS)]
    labels = [f"k8s:storm=w{k}" for k in range(STORM_PODS)]

    # warm: each storm pod's rule once (splits its identity class), so the
    # storm's toggles ride the delta path
    t0 = time.perf_counter()
    for k in range(STORM_PODS):
        eng.replace_policy([labels[k]], storm_docs(k, ports[k], labels[k]))
        eng.regenerate()
    warm_s = time.perf_counter() - t0
    dp = eng.datapath
    patch0 = dict(dp.patch_stats)
    log = DispatchLog(dp)
    folds = fold_timers(eng, log)

    clock = [50_000]
    clock_lock = threading.Lock()

    def tick():
        with clock_lock:
            clock[0] += 1
            return clock[0]

    def probe(k, u, n=STORM_PROBE_ROWS):
        """A churn batch whose first ``n`` rows are new flows pod p{k} →
        web:(4235 + k), with source ports of their own for each toggle
        ``u`` (a flow seen before is established, and passes whatever the
        rule)."""
        b = next_batch()
        b["src"][:n, 3] = 0xAC100000 + k
        b["dport"][:n] = ports[k]
        b["sport"][:n] = 10000 + u * n + np.arange(n)
        b["tcp_flags"][:n] = C.TCP_SYN
        return log.own(b)

    def p(vals, q):
        return float(np.percentile(np.asarray(vals), q)) if vals else -1.0

    for _ in range(2):                   # the 2 warm batches
        eng.submit(log.own(next_batch()), now=tick()).result(timeout=300)
    fk.reset_launches()
    steps0, ms0 = log.steps(), len(log.async_ms)

    # the pipeline alone: SERVE_BATCHES churn batches
    clean = Feed(eng, log, next_batch, tick, SERVE_BATCHES,
                 SERVE_BATCHES).join()
    check(eng.drain(timeout=300), "serve: the pipeline did not drain")
    split = log.async_ms[ms0:], log.finalize_ms[ms0:]
    lines += [
        f"serve: pipeline alone: {clean.rows / clean.wall_s:.0f} flows/s, "
        f"submit → result p50 {p(clean.lat_ms, 50):.3f} ms p99 "
        f"{p(clean.lat_ms, 99):.3f} ms over {clean.fed} churn batches of "
        f"{cfg.batch_size} (2 warm before) [{card}]",
        f"serve: host ms per batch inside classify_async p50 "
        f"{p(split[0], 50):.3f} mean {np.mean(split[0]):.3f}, inside "
        f"finalize p50 {p(split[1], 50):.3f} mean "
        f"{np.mean(split[1]):.3f}; the engine's finalize folds p50 " +
        ", ".join(f"{k} {p(v, 50):.3f}" for k, v in folds.items()) +
        f" [{card}]"]

    # the storm: pod p{k}'s rule removed, added, removed (3 x 8 toggles),
    # each followed by a probe of its rows, GC ticks between, beside churn
    ms0 = len(log.async_ms)
    live = Feed(eng, log, next_batch, tick, SERVE_BATCHES, 4 * SERVE_BATCHES)
    add_ms, remove_ms, flips, gc, probes = [], [], {}, [], []
    for u in range(3 * STORM_PODS):
        k = u % STORM_PODS
        adding = (u // STORM_PODS) == 1
        t0 = time.perf_counter()
        eng.replace_policy([labels[k]], storm_docs(k, ports[k], labels[k])
                           if adding else None)
        eng.regenerate()
        (add_ms if adding else remove_ms).append(
            (time.perf_counter() - t0) * 1e3)
        out = eng.submit(probe(k, u), now=tick()).result(timeout=300)
        rows = {c: out[c][:STORM_PROBE_ROWS] for c in ("allow", "reason",
                                                       "status")}
        probes.append((k, adding, rows))
        flips.setdefault(k, []).append(int(rows["allow"].sum()))
        if u % 6 == 5:
            gc.append(eng.sweep_step(now=tick()))
    live.join()
    check(eng.drain(timeout=300), "serve: the pipeline did not drain")
    check(eng.metrics.counters.get("regen_failures_total", 0) == 0,
          f"serve: a regeneration failed: {eng._last_regen_error}")
    gc.append(eng.sweep_step(now=tick()))     # harvests the last tick
    check(len(gc) > SERVE_GC_TICKS, f"serve: {len(gc)} GC ticks")
    dispatched = log.steps() - steps0
    launches = dict(fk.LAUNCHES)
    for name, n in launches.items():
        check(n >= dispatched, f"serve: {name} launched {n} times for "
                               f"{dispatched} dispatched batches")
    patch = {k: v - patch0[k] for k, v in dp.patch_stats.items()}
    check(patch["patch_delta"] > 0, f"serve: no delta patch ran: {patch}")
    pstats = eng.pipeline_stats()
    check(pstats["dispatch_errors"] == 0, f"serve: dispatch errors "
                                          f"{pstats['dispatch_errors']}")
    storm_split = log.async_ms[ms0:], log.finalize_ms[ms0:]
    lines += [
        f"serve: beside the storm: {live.rows / live.wall_s:.0f} flows/s, "
        f"submit → result p50 {p(live.lat_ms, 50):.3f} ms p99 "
        f"{p(live.lat_ms, 99):.3f} ms over {live.fed} churn batches; "
        f"classify_async p50 {p(storm_split[0], 50):.3f} ms, finalize p50 "
        f"{p(storm_split[1], 50):.3f} ms [{card}]",
        f"serve: storm warm {warm_s:.3f} s ({STORM_PODS} rules, class "
        f"splits); {3 * STORM_PODS} toggles: rule_add_ms p50 "
        f"{p(add_ms, 50):.3f}, rule_remove_ms p50 {p(remove_ms, 50):.3f}; "
        f"place_patch host ms each "
        f"{[round(x, 3) for x in log.place_ms]}; "
        f"{json.dumps(patch)}; every ticket resolved [{card}]",
        f"serve: storm pods' rows allowed (removed / added / removed): "
        f"{json.dumps(flips)} of {STORM_PROBE_ROWS} each",
        f"serve: GC ticks of {SERVE_GC_CHUNK} rows: " + ", ".join(
            f"reclaimed {g['reclaimed']} live {g['live']}" for g in gc)]

    # the auditor at sampling 1.0 over 2 batches
    eng.auditor.configure(sample_rate=1.0)
    for _ in range(2):
        eng.submit(log.own(next_batch()), now=tick()).result(timeout=300)
    eng.auditor.configure(sample_rate=0.0)
    t0 = time.perf_counter()
    for _ in range(100):
        st = eng.audit_step(budget=64)
        if not st or not (st.get("replayed") or st.get("pending")):
            break
    audit_s = time.perf_counter() - t0
    audit = eng.auditor.stats()
    check(audit["checked_rows"] > 0 and audit["mismatched_rows"] == 0,
          f"serve: audit {audit}")
    calls = dispatch_calls(eng, log, [next_batch() for _ in range(4)],
                           [tick() for _ in range(4)])

    # every dispatch against the plain path, then the CT
    t0 = time.perf_counter()
    plain, n_steps, n_gc = replay_plain(log, cfg)
    want, got = eng.ct_arrays(), plain.ct_arrays()
    for k in want:
        check(np.array_equal(want[k], got[k]), f"serve: CT {k} differs "
                                               f"from the plain path")
    replay_s = time.perf_counter() - t0
    eng.stop()
    # each pod's rows flip: denied without its rule, allowed with it (a
    # new flow may still find its probe window full); checked after the
    # replay, so a divergence from the plain path is named first
    for k, adding, rows in probes:
        allowed = int(rows["allow"].sum())
        reasons = sorted(int(r) for r in np.unique(rows["reason"]))
        status = np.bincount(rows["status"], minlength=3).tolist()
        if adding:
            check(allowed >= STORM_PROBE_ROWS // 2 and set(reasons) <= {
                0, int(C.DropReason.CT_FULL)},
                f"serve: p{k} rows with the rule: allowed {allowed}, "
                f"reasons {reasons}, status counts {status}")
        else:
            check(allowed == 0 and reasons == [int(C.DropReason.POLICY)],
                  f"serve: p{k} rows without the rule: allowed {allowed}, "
                  f"reasons {reasons}, status counts {status}")
    return lines + [
        f"serve: audit at sampling 1.0 over 2 batches: checked "
        f"{audit['checked_rows']} rows, mismatched "
        f"{audit['mismatched_rows']}, {audit_s:.3f} s of replay",
        f"serve: python-level torch calls a dispatch (classify_async and "
        f"its finalize, 4 more batches): {calls_text(calls)}",
        f"serve: {n_steps} dispatches and {n_gc} GC ticks replayed on a "
        f"plain TorchDatapath (fused_kernels=off) in {replay_s:.3f} s: every "
        f"out column, counter, GC result and the CT arrays equal",
        f"serve launches: {json.dumps(launches)} for {dispatched} "
        f"dispatched batches"]


def phase_soak(card):
    """``tests/test_torch_qos.py``'s 8-shard QoS soak on the card, through
    ``mesh_dispatch.run_soak``: 8 flow shards sharing the card (the
    co-located steered step, one scripted call a dispatch: K1 and K3 once,
    K2 once a shard), batch 512, CT 2^12, the auditor at sampling 1.0,
    QoS ``gold=4:lane,silver=2,bulk=1``; two ``render_metrics`` scrape
    threads from the start; 20 warm submissions of 64 SYNs; stall timeout
    1.0 s, then one ``datapath.transfer=hang:delay_s=4:times=1``; 10
    submissions after the restart. Fails on a rejected ticket after the
    restart, an audit mismatch, no restart or more than
    ``pipeline_max_restarts``, or a kernel that never launched. → phase
    lines."""
    host_bound("phase soak")
    import mesh_dispatch as md
    from cilium_tpu_torch.kernels import fused as fk
    fk.reset_launches()
    t0 = time.perf_counter()
    r = md.run_soak(device=DEVICE)
    wall = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    check(r["rejected"] == 0, f"soak: {r['rejected']} of {r['tickets']} "
                              f"tickets rejected after the restart")
    check(r["checked_rows"] > 0 and r["mismatched_rows"] == 0,
          f"soak: audit checked {r['checked_rows']} rows, mismatched "
          f"{r['mismatched_rows']}")
    check(1 <= r["restarts"] <= r["max_restarts"],
          f"soak: {r['restarts']} restarts (at most {r['max_restarts']})")
    if DEVICE == "cuda":
        check(all(n > 0 for n in launches.values()),
              f"soak: kernel launches {launches}")

    def ms(xs):
        import numpy as np
        return (f"p50 {float(np.percentile(xs, 50)) * 1e3:.3f} ms max "
                f"{max(xs) * 1e3:.3f} ms over {len(xs)}")
    return [
        f"soak: {wall:.3f} s; restarts {r['restarts']} (at most "
        f"{r['max_restarts']}), tickets rejected after the restart "
        f"{r['rejected']} of {r['tickets']}; audit checked "
        f"{r['checked_rows']} rows, mismatched {r['mismatched_rows']}",
        f"soak: dispatch (classify_async) beside 2 render_metrics loops: "
        f"warm {ms(r['warm'])}; after the restart {ms(r['after'])}, the "
        f"scripted step in it {ms(r['steps'])} [{card}]",
        f"soak: python-level torch calls a dispatch after the restart "
        f"(classify_async and its finalize): {calls_text(r['calls'])}; "
        f"launches {json.dumps(launches)}"]


def profile_serve(eng, log, next_batch, tick, card):
    """Four pipelined churn batches under ``torch.profiler``: each kernel
    must appear on the device by name (the profiler drops a record now and
    then, so at least half the launches), and the device's busy share of
    the wall. → phase lines."""
    import torch
    n = 4
    batches = [log.own(next_batch()) for _ in range(n)]
    torch.cuda.synchronize()
    with profiler_session("serve") as prof:
        t0 = time.perf_counter()
        tickets = [eng.submit(b, now=tick()) for b in batches]
        for t in tickets:
            t.result(timeout=300)
        wall = time.perf_counter() - t0
    ops = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in ops)
    seen = {}
    for kernel, (_src, _rep, symbol) in KERNELS.items():
        count, _ms = kernel_device_ms(ops, symbol)
        seen[kernel] = count
        check(2 * count >= n, f"serve: {kernel} seen {count} times on the "
                              f"device for {n} batches")
    return [f"serve profile: {n} pipelined batches, wall {wall * 1e3:.3f} "
            f"ms, device busy {busy_us / 1e3:.3f} ms (share "
            f"{busy_us / 1e6 / wall:.4f}); kernels on the device "
            f"{json.dumps(seen)} [{card}]"]


# --------------------------------------------------------------------------- #
# agent: cfg5 restored by a separate agent process and served on its socket
# --------------------------------------------------------------------------- #
#: the ClusterIP service of phase agent: web → VIP:443 DNATs to a backend
SVC_VIP, SVC_PORT = "10.96.0.10", 443
SVC_BACKENDS = ("10.244.0.11", "10.244.0.12", "10.244.0.13")
#: /v1/classify requests, and rows of each kind in each
AGENT_REQUESTS = 24
AGENT_ROWS = 512
#: the rule phase agent toggles over the API (pod p7 → web:4242)
AGENT_PROBE_POD, AGENT_PROBE_PORT = 7, 4242
AGENT_DEADLINE_S = 300


def agent_engine(seed):
    """Phase serve's cfg5 engine plus one ClusterIP service, its CT warmed
    with every flow once and two churn batches, all at the wall clock (the
    agent's GC sweeps at the wall clock), every dispatch of its datapath
    kept by a ``DispatchLog`` from the first. → (engine, config,
    next_batch, the last churn batch, seconds to build, the log)."""
    from cilium_tpu_torch.model.services import Backend, Frontend, Service
    from cilium_tpu_torch.utils import constants as C
    from cilium_tpu_torch.world import cfg5_traffic
    eng, cfg, build_s = serve_engine(ingest_poll_budget=8192,
                                     pipeline_request_timeout_s=60.0)
    log = DispatchLog(eng.datapath)
    eng.upsert_service(Service(
        name="api", namespace="prod",
        frontends=(Frontend(SVC_VIP, SVC_PORT, C.PROTO_TCP),),
        lb_backends=tuple(Backend(b, 8443) for b in SVC_BACKENDS)))
    eng.regenerate()
    next_batch, warm_batches = cfg5_traffic(seed, PRESET == "smoke")
    now = int(time.time())
    for b in warm_batches():
        eng.classify(b, now=now)
    last = None
    for _ in range(2):
        last = next_batch()
        eng.classify({k: v.copy() for k, v in last.items()}, now=now)
    return eng, cfg, next_batch, last, build_s, log


def agent_records(last, i, per):
    """Request ``i``'s records, all TCP ACK (an established-lifetime CT
    entry, which no wall-clock GC of this run reclaims): flows the seed
    established (rows of its last churn batch), new flows (the same pods
    and ports, source ports no flow of cfg5 uses) and web → the service
    frontend (egress, DNAT to a backend); ``per`` of each."""
    from cilium_tpu_torch.utils import constants as C
    from cilium_tpu_torch.utils.ip import addr_to_str, words_to_addr
    recs = []
    rows = range(i * per, (i + 1) * per)
    for j in rows:
        src = addr_to_str(words_to_addr(last["src"][j]))
        base = {"src": src, "dst": "192.168.0.10", "ep": 1,
                "dport": int(last["dport"][j]), "direction": "ingress",
                "flags": C.TCP_ACK}
        recs.append({**base, "sport": int(last["sport"][j])})
        recs.append({**base, "sport": 1024 + j})
        recs.append({"src": "192.168.0.10", "dst": SVC_VIP,
                     "sport": 1024 + j, "dport": SVC_PORT, "ep": 1,
                     "direction": "egress", "flags": C.TCP_ACK})
    return recs


def agent_probe(u):
    """New flows pod p7 → web:4242 (toggle ``u``'s own source ports)."""
    from cilium_tpu_torch.utils import constants as C
    return [{"src": f"172.16.0.{AGENT_PROBE_POD}", "dst": "192.168.0.10",
             "sport": 14000 + u * 256 + j, "dport": AGENT_PROBE_PORT,
             "ep": 1, "direction": "ingress", "flags": C.TCP_ACK}
            for j in range(256)]


def spawn_agent(cfg_path, log_path, root, *extra):
    with open(log_path, "ab") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "cilium_tpu_torch.cli.main", "agent",
             "run", "--config", cfg_path, *extra], cwd=root, stdout=log,
            stderr=subprocess.STDOUT)


def log_tail(path, n=20):
    with open(path, errors="replace") as f:
        return "".join(f.readlines()[-n:])


def wait_healthz(proc, client, log_path):
    t0 = time.perf_counter()
    while True:
        check(proc.poll() is None, f"agent: exited {proc.returncode} "
                                   f"before healthz:\n{log_tail(log_path)}")
        check(time.perf_counter() - t0 < AGENT_DEADLINE_S,
              f"agent: no healthz in {AGENT_DEADLINE_S} s")
        try:
            if client.get("/v1/healthz")[0] == 200:
                return time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.1)


def phase_agent(seed, card):
    """cfg5 (plus a ClusterIP service) seeded in process and checkpointed;
    ``cilium_tpu_torch.cli.main agent run`` restores it in a process of
    its own on the card and serves ``/v1/classify``, each answer held
    against an in-process ``fused_kernels="off"`` engine restored from the
    same state dir; one rule toggled over ``POST /v1/policy``; SIGTERM;
    ``--oneshot`` restart, whose checkpoint's CT must equal the plain
    engine's. Prints its lines as it goes. → (the seed engine, its
    config, next_batch, its dispatch log)."""
    host_bound("phase agent")
    import shutil
    import signal
    import tempfile

    import numpy as np
    from cilium_tpu_torch.runtime import DaemonConfig, Engine
    from cilium_tpu_torch.runtime import checkpoint as ckpt
    from cilium_tpu_torch.runtime.api import UnixAPIClient, classify_doc
    from cilium_tpu_torch.parallel.mesh import rehash_ct_arrays
    from cilium_tpu_torch.runtime.datapath import TorchDatapath
    from cilium_tpu_torch.utils.ip import parse_addr
    root = os.path.dirname(os.path.abspath(__file__))

    def say(*lines):
        for line in lines:
            print(f"phase {line}", flush=True)

    def same_ct(got, want, what):
        check(got is not None, f"agent: the {what} has no CT")
        for k in want:
            if not np.array_equal(got[k], want[k]):
                bad = np.nonzero((got[k] != want[k]).reshape(
                    got[k].shape[0], -1).any(-1))[0]
                raise SmokeFailure(
                    f"agent: the {what}'s CT {k} differs from the plain "
                    f"engine's in {len(bad)} slots, first {list(bad[:5])}")
    eng, cfg, next_batch, last, build_s, log = agent_engine(seed)
    work = tempfile.mkdtemp(prefix="cts-agent-")
    state, sock = os.path.join(work, "state"), os.path.join(work, "a.sock")
    cfg_path, log_path = (os.path.join(work, n)
                          for n in ("config.json", "agent.log"))
    proc = None
    try:
        t0 = time.perf_counter()
        ckpt.save(eng, state)
        save_s = time.perf_counter() - t0
        ct_bytes = os.path.getsize(os.path.join(state, ckpt.CT_FILE))
        n_rules, revision = len(eng.repo), eng.repo.revision
        # the agent's config: the seed's, served on a socket from the state
        keys = ("device", "ct_capacity", "batch_size", "v4_only",
                "auto_regen", "pipeline_inflight", "pipeline_flush_ms",
                "ct_gc_chunk_rows", "audit_max_rows", "flowlog_mode",
                "pipeline_request_timeout_s")
        doc = {k: getattr(cfg, k) for k in keys}
        with open(cfg_path, "w") as f:
            json.dump({**doc, "api_socket": sock, "state_dir": state}, f)
        # the plain engine, restored from the same state dir
        pcfg = DaemonConfig(**{**doc, "fused_kernels": "off"})
        plain = Engine(pcfg, datapath=TorchDatapath(pcfg))
        t0 = time.perf_counter()
        check(ckpt.restore(plain, state, strict=True),
              "agent: the plain engine did not restore")
        restore_s = time.perf_counter() - t0
        say(
            f"agent: seed cfg5 + service built in {build_s:.3f} s, CT warmed "
            f"({eng.ct_stats(int(time.time()))['live']} live of "
            f"{cfg.ct_capacity}); checkpoint.save {save_s:.3f} s, ct.npz "
            f"{ct_bytes} bytes; checkpoint.restore (plain engine, in "
            f"process) {restore_s:.3f} s [{card}]")

        proc = spawn_agent(cfg_path, log_path, root,
                           "--checkpoint-interval-s", "0")
        client = UnixAPIClient(sock, timeout=120)
        healthz_s = wait_healthz(proc, client, log_path)
        with open(log_path) as f:
            cold = [ln.split("cold start: ")[1].strip() for ln in f
                    if "cold start: " in ln]
        check(cold, "agent: no cold-start line in its log")
        st = client.get("/v1/status")[1]
        fk_state = st.get("fused_kernels") or {}
        check(st["rules"] == n_rules and st["endpoints"] == 1
              and st["services"] == 1 and st["revision"] == revision,
              f"agent: restored {st['rules']} rules, {st['endpoints']} "
              f"endpoints, {st['services']} services, revision "
              f"{st['revision']}; want {n_rules}, 1, 1, {revision}")
        check(DEVICE != "cuda" or fk_state.get("active") is True,
              f"agent: CUDA kernels not active, never launched: {fk_state}")
        say(
            f"agent: cold start: {cold[0]} (in the agent), time to healthz "
            f"{healthz_s:.3f} s from spawn; /v1/status: {st['rules']} "
            f"rules, {st['endpoints']} endpoint, {st['services']} service, "
            f"revision {st['revision']}, CT {st['conntrack']}, "
            f"fused_kernels {json.dumps(fk_state)} [{card}]")

        launches0 = fk_state.get("launches", {})
        per = min(AGENT_ROWS, last["valid"].shape[0] // AGENT_REQUESTS)
        rtt, kinds = [], {"established": {}, "new": {}, "service": {}}
        for i in range(AGENT_REQUESTS):
            body = {"records": agent_records(last, i, per),
                    "now": int(time.time())}
            t0 = time.perf_counter()
            got = client.post("/v1/classify", body)
            rtt.append((time.perf_counter() - t0) * 1e3)
            want = classify_doc(plain, body)
            check(got == tuple(want), f"agent: request {i}: the agent "
                                      f"answered {str(got)[:300]}, the "
                                      f"plain engine {str(want)[:300]}")
            for r, v in enumerate(got[1]["verdicts"]):
                kind = ("established", "new", "service")[r % 3]
                key = f"{v['ct_state']}/{v['reason']}"
                kinds[kind][key] = kinds[kind].get(key, 0) + 1
        # a flow whose probe window was full is not in the CT (CT_FULL,
        # on both paths alike); a seeded flow the restore dropped (its
        # probe window full when re-placed) comes back NEW
        for kind, ok, also in (
                ("established", "ESTABLISHED/OK", {"NEW/OK"}),
                ("new", "NEW/OK", set()), ("service", "NEW/OK", set())):
            seen = kinds[kind]
            check(set(seen) <= {ok, "NEW/CT_FULL"} | also
                  and seen.get(ok, 0) >= 0.9 * sum(seen.values()),
                  f"agent: {kind} rows after the restart: {kinds}")
        launches1 = client.get("/v1/status")[1]["fused_kernels"]["launches"]
        served = {k: launches1[k] - launches0.get(k, 0) for k in launches1}
        for k, v in served.items():
            check(v >= 1, f"agent: kernel {k} launched {v} times for "
                          f"{AGENT_REQUESTS} requests")

        # one rule over the API: p7 → web:4242 flips drop → allow
        flips = []
        for u in range(2):
            if u:
                docs = storm_docs(AGENT_PROBE_POD, AGENT_PROBE_PORT,
                                  "k8s:storm=agent")
                code, doc = client.post("/v1/policy", docs)
                check(code == 200, f"agent: POST /v1/policy {code} {doc}")
                plain.apply_policy(docs)
                plain.regenerate()
            body = {"records": agent_probe(u), "now": int(time.time())}
            got = client.post("/v1/classify", body)
            check(got == tuple(classify_doc(plain, body)),
                  f"agent: probe {u} differs from the plain engine")
            flips.append(sum(v["allow"] for v in got[1]["verdicts"]))
        # denied without the rule; allowed with it (a new flow may still
        # find its probe window full)
        check(flips[0] == 0 and flips[1] >= 230,
              f"agent: p7 → 4242 rows allowed {flips} of 256")

        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=AGENT_DEADLINE_S)
        stop_s = time.perf_counter() - t0
        check(rc == 0, f"agent: SIGTERM exit {rc}:\n{log_tail(log_path)}")
        check(not os.path.exists(sock), "agent: socket left behind")
        want_ct = plain.ct_arrays()
        same_ct(ckpt.load_host(state).ct, want_ct, "SIGTERM checkpoint")
        t0 = time.perf_counter()
        one = subprocess.run(
            [sys.executable, "-m", "cilium_tpu_torch.cli.main", "agent",
             "run", "--config", cfg_path, "--oneshot"], cwd=root,
            capture_output=True, text=True, timeout=AGENT_DEADLINE_S)
        oneshot_s = time.perf_counter() - t0
        check(one.returncode == 0, f"agent: --oneshot exit "
                                   f"{one.returncode}: {one.stderr[-2000:]}")
        # a restore re-places every entry at its probe position
        # (rehash_ct_arrays), so the oneshot's table is the plain one
        # re-placed the same way
        host = ckpt.load_host(state)
        # (an entry whose probe window is full is dropped, on both alike)
        replaced, dropped = rehash_ct_arrays(want_ct, 1, cfg.probe_depth)
        same_ct(host.ct, replaced, "--oneshot checkpoint")
        # the service rows went through the LB stage: their CT entries
        # are keyed on a backend
        backends = {int.from_bytes(parse_addr(b)[0][12:], "big")
                    for b in SVC_BACKENDS}
        live = host.ct["expiry"] > 0
        dnat = int(np.isin(host.ct["keys"][live][:, 7],
                           list(backends)).sum())
        check(dnat >= 0.9 * AGENT_REQUESTS * per,
              f"agent: {dnat} CT entries keyed on a service backend")
        plain.stop()
        say(
            f"agent: /v1/classify {AGENT_REQUESTS} requests of "
            f"{3 * per} records: round trip p50 "
            f"{float(np.percentile(rtt, 50)):.3f} ms p99 "
            f"{float(np.percentile(rtt, 99)):.3f} ms; every verdict equal "
            f"to the plain engine's; {json.dumps(kinds)} [{card}]",
            f"agent: POST /v1/policy p7 → web:4242: probe rows allowed "
            f"{flips} of 256",
            f"agent: SIGTERM → exit 0 in {stop_s:.3f} s, socket removed, "
            f"its checkpoint's CT equal to the plain engine's; --oneshot "
            f"restart {oneshot_s:.3f} s, its checkpoint's CT equal to the "
            f"plain engine's re-placed ({int(live.sum())} live, {dropped} "
            f"dropped re-placing, {dnat} keyed on a service backend)",
            f"agent launches: {json.dumps(served)} for "
            f"{AGENT_REQUESTS + 2} requests")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        shutil.rmtree(work, ignore_errors=True)
    return eng, cfg, next_batch, log


# --------------------------------------------------------------------------- #
# feeder: cfg5 frames through the port's shim into the engine's pipeline
# --------------------------------------------------------------------------- #
FEEDER_ROWS = 1 << 16
FEEDER_SHIM_BATCH = 8192
FEEDER_RING = 1 << 14


def feeder_frames(b, n):
    """``build_frame`` of ``b``'s first ``n`` rows: pod → web
    (192.168.0.10), TCP ACK, each row's ports. → [frame bytes]."""
    from cilium_tpu_torch.shim.bindings import build_frame
    from cilium_tpu_torch.utils import constants as C
    from cilium_tpu_torch.utils.ip import addr_to_str, words_to_addr
    names, frames = {}, []
    for j in range(n):
        w = int(b["src"][j, 3])
        if w not in names:
            names[w] = addr_to_str(words_to_addr(b["src"][j]))
        frames.append(build_frame(names[w], "192.168.0.10",
                                  int(b["sport"][j]), int(b["dport"][j]),
                                  tcp_flags=C.TCP_ACK))
    return frames


def deny_every_8th(b, n, sport0=10000):
    """Every 8th of ``b``'s first ``n`` rows becomes a new flow to port
    4242, which no rule opens (in place). → that row mask."""
    import numpy as np
    deny = np.arange(n) % 8 == 7
    b["dport"][:n][deny] = 4242
    b["sport"][:n][deny] = sport0 + np.arange(n)[deny] % 10000
    return deny


def shim_stats_done(st):
    return st["verdict_passes"] + st["verdict_drops"] + st["tx_full_drops"]


def inject_frames(wire, frames, what):
    """Inject ``frames`` into ``wire.shim``'s mocked rx ring, draining its
    tx ring (into ``wire.tx``) while the ring is full, then wait for a
    verdict on each. → seconds from the first injection to the last
    verdict."""
    shim = wire.shim
    done0 = shim_stats_done(shim.stats())
    t0 = time.perf_counter()
    deadline = t0 + AGENT_DEADLINE_S
    for f in frames:
        while shim.mock_rx_inject(f) != 0:     # the ring is full: let the
            wire.tx += len(shim.mock_tx_drain(4096))   # feeder's threads run
            check(time.perf_counter() < deadline, f"{what}: rx ring stuck")
            time.sleep(0.0005)
    while True:
        wire.tx += len(shim.mock_tx_drain(4096))
        st = shim.stats()
        if shim_stats_done(st) - done0 >= len(frames):
            break
        check(time.perf_counter() < deadline,
              f"{what}: verdicts never reached {len(frames)}: {st}")
        time.sleep(0.001)
    return time.perf_counter() - t0


def drain_tx(wire, what):
    """Drain the tx ring until every frame the shim passed has left it
    (the pipeline drained first)."""
    check(wire.eng.drain(timeout=300), f"{what}: the pipeline did not drain")
    deadline = time.perf_counter() + 60
    while wire.tx < wire.shim.stats()["verdict_passes"]:
        wire.tx += len(wire.shim.mock_tx_drain(4096))
        check(time.perf_counter() < deadline,
              f"{what}: forwarded {wire.tx} of "
              f"{wire.shim.stats()['verdict_passes']} passes")
        time.sleep(0.001)


def feeder_wire(eng, cfg, next_batch, log):
    """A ``FlowShim`` of the port's own build on mocked rings (web at
    192.168.0.10 as endpoint 1) attached to ``eng`` by
    ``Engine.start_feeder``. → the wire: engine, config, shim, feeder,
    ``log`` (a ``DispatchLog`` of ``eng``'s datapath), a ``PlainReplay``
    to feed it to, ``next_batch`` and the frames drained from tx."""
    from types import SimpleNamespace

    from cilium_tpu_torch.shim.bindings import FlowShim
    shim = FlowShim(batch_size=min(FEEDER_SHIM_BATCH, cfg.batch_size),
                    timeout_us=500)
    shim.register_endpoint("192.168.0.10", 1)
    shim.mock_rings_init(ring_size=FEEDER_RING, frame_size=2048,
                         n_frames=FEEDER_RING)
    feeder = eng.start_feeder(shim)
    return SimpleNamespace(eng=eng, cfg=cfg, shim=shim, feeder=feeder,
                           log=log, replay=PlainReplay(cfg),
                           next_batch=next_batch, tx=0)


def phase_feeder(eng, cfg, next_batch, log, card, report=None):
    """One full cfg5 batch of frames (``build_frame``; every 8th a new
    flow to a port no rule opens) injected into a ``FlowShim`` of the
    port's own build on mocked rings, harvested by ``Engine.start_feeder``
    into the pipeline on the card: the records the feeder dispatched equal
    the frames' rows in order, every dispatch equals a plain
    ``TorchDatapath`` replaying the seed engine's every dispatch from the
    first (``log``), and the shim forwarded exactly the rows the
    dispatches allowed. The engine, its feeder and shim stay up for phase
    observe. → (the wire: engine, config, shim, feeder, log, the replay
    and next_batch; phase lines)."""
    host_bound("phase feeder")
    import numpy as np
    from cilium_tpu_torch.kernels import fused as fk
    b = next_batch()
    n = min(FEEDER_ROWS, b["valid"].shape[0])
    deny_every_8th(b, n)
    t0 = time.perf_counter()
    frames = feeder_frames(b, n)
    frames_s = time.perf_counter() - t0
    first = len(log.entries)
    fk.reset_launches()
    wire = feeder_wire(eng, cfg, next_batch, log)
    feeder, shim = wire.feeder, wire.shim
    wall = inject_frames(wire, frames, "feeder")
    drain_tx(wire, "feeder")
    launches = dict(fk.LAUNCHES)
    stats = feeder.stats()
    st = shim.stats()
    for k, v in launches.items():
        check(v >= 1, f"feeder: kernel {k} launched {v} times")
    # the dispatched records are the frames' rows, in order
    steps = [e for kind, e in log.entries[first:] if kind == "step"]
    got = {k: np.concatenate([e["batch"][k][e["batch"]["valid"]]
                              for e in steps])
           for k in ("src", "dst", "sport", "dport", "tcp_flags")}
    for k in got:
        check(np.array_equal(got[k], b[k][:n]),
              f"feeder: dispatched {k} differ from the injected rows")
    allowed = int(sum(e["result"][0]["allow"][e["batch"]["valid"]].sum()
                      for e in steps))
    wire.replay.feed(log)
    n_steps = wire.replay.n_steps
    check(st["verdict_passes"] == allowed == wire.tx
          and st["verdict_drops"] == n - allowed,
          f"feeder: shim passed {st['verdict_passes']}, dropped "
          f"{st['verdict_drops']}, forwarded {wire.tx}; the dispatches "
          f"allowed {allowed} of {n}")
    check(0 < allowed < n, f"feeder: allowed {allowed} of {n}")
    note_launches(report, "feeder", launches)
    return wire, [
        f"feeder: {n} cfg5 frames ({frames_s:.3f} s to build) through the "
        f"port's shim on mocked rings into Engine.start_feeder: "
        f"{n / wall:.0f} frames/s, e2e p50 {stats['e2e_p50_ms']} ms p99 "
        f"{stats['e2e_p99_ms']} ms [{card}]",
        f"feeder: {len(steps)} dispatches (and the seed's "
        f"{n_steps - len(steps)} before them) equal to a plain "
        f"TorchDatapath replaying them; shim forwarded {wire.tx}, dropped "
        f"{st['verdict_drops']} = the dispatches' allow; feeder stats "
        f"{json.dumps(stats)}",
        f"feeder launches: {json.dumps(launches)} for {len(steps)} "
        f"dispatches"]


# --------------------------------------------------------------------------- #
# observe: the flow observer and the fault points on the feeder's wire path
# --------------------------------------------------------------------------- #
#: part (a)'s frames, and each window's of part (b) and each segment's of
#: part (c)
OBSERVE_ROWS = 1 << 16
OBSERVE_WINDOW = 8192
OBSERVE_WINDOWS = 4
#: part (a)'s frames before the follower attaches
OBSERVE_PRIME = 64
#: the follower's cadence; the calibration's polls and backlog
OBSERVE_POLL_S = 0.005
OBSERVE_CAL_POLLS = 200
OBSERVE_CAL_BACKLOG = 64
#: the reference bench's gate (``bench.py --ingest --observer``)
OBSERVE_BUDGET = 0.02
OBSERVE_FPS_RATIO = 0.5


def observe_filter(b, deny):
    """Part (a)'s compound filter: dropped, to port 4242, from the /24 of
    the first denied row's pod. → (its ``FlowFilter`` fields, the /24's
    network word)."""
    net = int(b["src"][int(deny.argmax()), 3]) & 0xFFFFFF00
    cidr = ".".join(str((net >> sh) & 255) for sh in (24, 16, 8)) + ".0/24"
    return dict(verdict="DROPPED", dports=(4242,), src_cidrs=(cidr,)), net


def follow(cursor, poll_s, stop, lap=None):
    """Poll ``cursor`` every ``poll_s`` until ``stop`` is set, then once
    more. With ``lap`` (the ring's capacity) the first poll is held until
    more than ``lap`` records have landed past the cursor, so that the
    ring laps it and the gap path runs. → (the thread, to start; its
    records, gap markers, poll seconds and errors)."""
    import threading
    rec, gaps, polls, errors = [], [], [], []
    fl = cursor.observer.flowlog

    def run():
        try:
            while lap is not None and not stop.is_set() \
                    and fl.newest_seq - cursor.cursor <= lap:
                time.sleep(0.001)
            while True:
                last = stop.is_set()
                t0 = time.perf_counter()
                for r in cursor.poll(limit=8192):
                    (gaps if r.get("gap") else rec).append(r)
                polls.append(time.perf_counter() - t0)
                if last:
                    return
                time.sleep(poll_s)
        except Exception as e:      # noqa: BLE001 — raised by the caller
            errors.append(e)
    th = threading.Thread(target=run, daemon=True)
    return th, rec, gaps, polls, errors


def observe_expected(apps, kept, net, C):
    """The rows part (a)'s appends took, from the plain replay of the same
    dispatches: ``apps`` (seq before, seq after, the valid rows' sports,
    now) of each ``FlowLog.append_batch``, ``kept`` the replay's
    (batch, plain outputs, now) of each dispatch, in order. → ({column:
    array} by seq from the first append's, the filter's match by seq,
    rows shed at extraction)."""
    import numpy as np
    kept = [k for k in kept if k[0]["valid"].any()]
    check(len(kept) == len(apps),
          f"observe: {len(apps)} flow-log appends for {len(kept)} "
          f"dispatches with valid rows")
    cols, shed = {k: [] for k in ("src", "dst", "sport", "dport", "allow",
                                  "reason", "remote_identity", "now",
                                  "matched_rule", "lpm_prefix")}, 0
    for i, ((s0, s1, sports, now), (b, out, now_b)) in enumerate(
            zip(apps, kept)):
        vi = np.nonzero(b["valid"])[0]
        check(now == now_b and np.array_equal(sports, b["sport"][vi]),
              f"observe: flow-log append {i} is not dispatch {i}")
        rows = vi[len(vi) - (s1 - s0):]        # the append keeps the newest
        shed += len(vi) - len(rows)
        for k in ("src", "dst", "sport", "dport"):
            cols[k].append(np.asarray(b[k])[rows])
        for k in ("allow", "reason", "remote_identity", "matched_rule",
                  "lpm_prefix"):
            cols[k].append(np.asarray(out[k])[rows] if k in out
                           else np.full(len(rows), -1))
        cols["now"].append(np.full(len(rows), now))
    cols = {k: np.concatenate(v) for k, v in cols.items()}
    src = cols["src"].astype(np.int64) & 0xFFFFFFFF
    match = (~cols["allow"].astype(bool) & (cols["dport"] == 4242)
             & (src[:, 0] == 0) & (src[:, 1] == 0) & (src[:, 2] == 0xFFFF)
             & ((src[:, 3] & 0xFFFFFF00) == net))
    return cols, match, shed


def observe_mismatches(rec, cols, seq0, parse_addr):
    """Delivered records whose fields differ from the replay's row at their
    seq. → [(seq, field, delivered, replayed)] (at most 5), count."""
    import numpy as np
    bad, n = [], 0
    for r in rec:
        j = r["seq"] - seq0 - 1
        want = {"verdict": "FORWARDED" if cols["allow"][j] else "DROPPED",
                "drop_reason": int(cols["reason"][j]),
                "src_port": int(cols["sport"][j]),
                "dst_port": int(cols["dport"][j]),
                "remote_identity": int(cols["remote_identity"][j]),
                "matched_rule": int(cols["matched_rule"][j]),
                "lpm_prefix": int(cols["lpm_prefix"][j]),
                "time": int(cols["now"][j])}
        diff = [(k, r[k], v) for k, v in want.items() if r[k] != v]
        for k, col in (("src_ip", "src"), ("dst_ip", "dst")):
            words = np.frombuffer(parse_addr(r[k])[0], ">u4")
            if not np.array_equal(words.astype(np.int64),
                                  cols[col][j].astype(np.int64)
                                  & 0xFFFFFFFF):
                diff.append((k, r[k], cols[col][j].tolist()))
        if diff:
            n += 1
            bad.extend((r["seq"],) + d for d in diff[:1])
    return bad[:5], n


def observe_part_a(wire, card):
    """Part (a): ``flowlog_mode="all"`` armed on the served engine,
    ``OBSERVE_PRIME`` frames, then one ``FollowCursor`` with the compound
    filter from the newest record on over ``OBSERVE_ROWS`` frames (its
    first poll held until the ring has lapped it once, so that the gap
    path runs), every delivered record held against the plain replay's
    row at its seq, and every record appended past the cursor delivered,
    declared in a gap or filtered out. → (frames, phase lines)."""
    import threading

    import numpy as np
    from cilium_tpu_torch.observe.observer import (FlowFilter, FlowObserver,
                                                   FollowCursor)
    from cilium_tpu_torch.utils import constants as C
    from cilium_tpu_torch.utils.ip import parse_addr
    eng, fl = wire.eng, wire.eng.flowlog
    b = wire.next_batch()
    n = min(OBSERVE_ROWS, b["valid"].shape[0])
    deny = deny_every_8th(b, n, sport0=20000)
    frames = feeder_frames(b, n)
    fields, net = observe_filter(b, deny)
    fl.mode = "all"
    # a few frames first, so that the follower's cursor is a real one: a
    # cursor at 0 is a fresh attach, whose pre-history the gap contract
    # does not count as loss
    inject_frames(wire, feeder_frames(wire.next_batch(), OBSERVE_PRIME),
                  "observe (a)")
    drain_tx(wire, "observe (a)")
    wire.replay.feed(wire.log)
    check(fl.newest_seq > 0, "observe (a): the priming frames appended "
                             "no record")
    apps = []

    def append(batch, out, now, ep_ids):
        s0 = fl.newest_seq
        real(batch, out, now, ep_ids)
        valid = np.asarray(batch["valid"])
        apps.append((s0, fl.newest_seq, np.asarray(batch["sport"])[valid],
                     int(now)))
    real = fl.append_batch
    fl.append_batch = append
    seq0, shed0 = fl.newest_seq, fl.extract_shed
    gap_rec0 = fl.follow_gap_records
    cursor = FollowCursor(FlowObserver(fl), allow=[FlowFilter(**fields)],
                          cursor=seq0)
    stop = threading.Event()
    th, rec, gaps, polls, errors = follow(cursor, OBSERVE_POLL_S, stop,
                                          lap=fl.capacity)
    th.start()
    try:
        wall = inject_frames(wire, frames, "observe (a)")
        drain_tx(wire, "observe (a)")
    finally:
        stop.set()
        th.join(60)
        del fl.append_batch
    check(not th.is_alive(), "observe (a): the follower did not stop")
    check(not errors, f"observe (a): the follower raised {errors[:1]}")
    appended = fl.newest_seq - seq0
    wire.replay.keep = []
    wire.replay.feed(wire.log)
    kept, wire.replay.keep = wire.replay.keep, None
    cols, match, shed = observe_expected(apps, kept, net, C)
    check(len(match) == appended, f"observe (a): {appended} records "
                                  f"appended, {len(match)} replayed")
    check(fl.extract_shed - shed0 == shed,
          f"observe (a): {fl.extract_shed - shed0} rows shed at extraction,"
          f" the dispatches' valid rows less the appends' {shed}")
    gapped = np.zeros(appended, dtype=bool)
    for g in gaps:
        lo = g["resume_seq"] - g["dropped"] - seq0 - 1
        check(0 <= lo and g["resume_seq"] - seq0 - 1 <= appended,
              f"observe (a): gap {g} outside the part's seqs")
        gapped[lo:lo + g["dropped"]] = True
    dropped = sum(g["dropped"] for g in gaps)
    seqs = np.array([r["seq"] for r in rec], dtype=np.int64)
    check(bool(np.all(np.diff(seqs) > 0)),
          "observe (a): delivered seqs not strictly increasing")
    want = np.nonzero(match & ~gapped)[0] + seq0 + 1
    check(np.array_equal(seqs, want),
          f"observe (a): delivered {len(seqs)} records, the replay's "
          f"matches outside the gaps are {len(want)}")
    bad, n_bad = observe_mismatches(rec, cols, seq0, parse_addr)
    check(n_bad == 0, f"observe (a): {n_bad} delivered records differ "
                      f"from the replay, first {bad}")
    filtered = int((~match & ~gapped).sum())
    check(len(rec) + dropped + filtered == appended,
          f"observe (a): delivered {len(rec)} + gap-dropped {dropped} + "
          f"filtered out {filtered} != appended {appended}")
    check(dropped == int(gapped.sum()) == cursor.dropped
          == fl.follow_gap_records - gap_rec0,
          f"observe (a): gap records {dropped}, cursor {cursor.dropped}, "
          f"flow log {fl.follow_gap_records - gap_rec0}")
    if appended > fl.capacity:
        check(len(gaps) >= 1, "observe (a): the ring lapped the held "
                              "follower and no gap was declared")
    check(0 < len(rec) < 0.1 * appended,
          f"observe (a): {len(rec)} of {appended} records matched the "
          f"filter")
    per_batch = (appended + shed) / max(1, len(apps))
    return frames, [
        f"observe (a): {n} cfg5 frames through the shim with flowlog_mode "
        f"all on a {fl.capacity}-record ring in {wall:.3f} s; "
        f"{len(apps)} appends of {appended + shed} valid rows kept "
        f"{appended} records ({shed} shed at extraction, "
        f"{per_batch:.0f} valid rows a dispatch); a FollowCursor "
        f"{json.dumps(fields)} from seq {seq0} ({OBSERVE_PRIME} frames "
        f"before it), held until the ring lapped it, then every "
        f"{OBSERVE_POLL_S * 1e3:.0f} ms: {len(polls)} polls, delivered "
        f"{len(rec)}, {len(gaps)} gaps of {dropped} records, filtered out "
        f"{filtered}: {len(rec)} + {dropped} + {filtered} = {appended} "
        f"appended; every delivered record equal to the plain replay's "
        f"row at its seq, 0 mismatches [{card}]"]


def observe_part_b(wire, frames, card):
    """Part (b), the reference bench's attestation (``bench.py --ingest
    --observer``): a warmup window, then ``OBSERVE_WINDOWS`` disarmed and
    armed windows alternating, ``OBSERVE_WINDOW`` frames each, the armed
    follower polling every ``OBSERVE_POLL_S`` with a compound filter; the
    per-poll cost calibrated on the live ring with a
    ``OBSERVE_CAL_BACKLOG``-record backlog over ``OBSERVE_CAL_POLLS``
    polls. Gate: calibrated cost × polls / armed seconds <
    ``OBSERVE_BUDGET``, best armed / best disarmed frames/s >
    ``OBSERVE_FPS_RATIO``. → (the document, phase lines)."""
    import threading

    import numpy as np
    from cilium_tpu_torch.observe.observer import (FlowFilter, FlowObserver,
                                                   FollowCursor)
    fl = wire.eng.flowlog
    flt = [FlowFilter(verdict="DROPPED", dports=(9999,),
                      dst_cidrs=("192.168.0.0/16",))]
    pool = frames[:OBSERVE_WINDOW]

    def window(armed):
        stop = threading.Event()
        th = polls = None
        if armed:
            th, _rec, _gaps, polls, errors = follow(
                FollowCursor(FlowObserver(fl), allow=flt), OBSERVE_POLL_S,
                stop)
            th.start()
        try:
            secs = inject_frames(wire, pool, "observe (b)")
        finally:
            stop.set()
            if th is not None:
                th.join(30)
        doc = {"armed": armed, "fps": len(pool) / secs,
               "elapsed_s": secs}
        if armed:
            check(not errors, f"observe (b): the follower raised "
                              f"{errors[:1]}")
            doc.update(polls=len(polls),
                       poll_p50_us=float(np.median(polls)) * 1e6)
        return doc

    window(False)                          # warmup (not recorded)
    cal = FollowCursor(FlowObserver(fl), allow=flt)
    newest = fl.newest_seq
    durs = []
    for _ in range(OBSERVE_CAL_POLLS):
        cal.cursor = max(0, newest - OBSERVE_CAL_BACKLOG)
        t0 = time.perf_counter()
        cal.poll(limit=8192)
        durs.append(time.perf_counter() - t0)
    per_poll = float(np.median(durs))
    runs = [window(armed) for armed in (False, True) * OBSERVE_WINDOWS]
    fps_dis = max(r["fps"] for r in runs if not r["armed"])
    fps_arm = max(r["fps"] for r in runs if r["armed"])
    polls = sum(r.get("polls", 0) for r in runs)
    span = sum(r["elapsed_s"] for r in runs if r["armed"])
    ovh = per_poll * polls / span
    ratio = fps_arm / fps_dis
    doc = {"windows": runs, "frames_per_window": len(pool),
           "fps_armed": fps_arm, "fps_disarmed": fps_dis,
           "fps_ratio": ratio, "calibrated_poll_us": per_poll * 1e6,
           "polls": polls, "armed_elapsed_s": span,
           "overhead_pct": ovh * 100, "budget_pct": OBSERVE_BUDGET * 100}
    check(ovh < OBSERVE_BUDGET and ratio > OBSERVE_FPS_RATIO,
          f"observe (b): overhead {ovh * 100:.4f}% (budget "
          f"{OBSERVE_BUDGET * 100}%) or fps ratio {ratio:.4f} (floor "
          f"{OBSERVE_FPS_RATIO}) out of bounds: {json.dumps(doc)}")
    return doc, [
        f"observe (b): {OBSERVE_WINDOWS} disarmed and {OBSERVE_WINDOWS} "
        f"armed windows of {len(pool)} frames, alternating: frames/s "
        f"{[round(r['fps']) for r in runs]}; best disarmed {fps_dis:.0f}, "
        f"best armed {fps_arm:.0f}, ratio {ratio:.4f} (> "
        f"{OBSERVE_FPS_RATIO}); {polls} polls in {span:.3f} armed s, "
        f"calibrated_poll_us {per_poll * 1e6:.3f} ({OBSERVE_CAL_POLLS} "
        f"polls, {OBSERVE_CAL_BACKLOG}-record backlog), overhead_pct "
        f"{ovh * 100:.4f} (< {OBSERVE_BUDGET * 100}) [{card}]",
        f"observe (b): {json.dumps(doc)}"]


def observe_part_c(wire, frames, card):
    """Part (c), the fault points on the wire path: ``shim.rx_ring=fail:1``
    armed halfway through a segment (exactly one failed poll, every frame
    of it dispatched); ``pipeline.dispatch=fail`` armed for a segment
    (none of its rows dispatched, all applied fail-closed and counted, the
    breaker opens); disarmed, the breaker's cooldown waited, a segment
    whose first submission is the half-open probe (the breaker closes;
    batches harvested while the probe is out are refused, fail-closed).
    Every frame accounted for: forwarded + dropped by a dispatch +
    fail-closed = injected. → phase lines."""
    from cilium_tpu_torch.runtime.faults import FAULTS
    eng, shim, feeder, log = wire.eng, wire.shim, wire.feeder, wire.log
    seg = min(OBSERVE_WINDOW, len(frames) // 3)
    drain_tx(wire, "observe (c)")        # part (b)'s last frames leave
    st0, fd0, tx0 = shim.stats(), feeder.stats(), wire.tx
    cnt = eng.metrics.counters
    marks = []

    def dispatched(since):
        """(valid rows, allowed rows) of the dispatches logged since
        entry ``since``."""
        steps = [e for kind, e in log.entries[since:] if kind == "step"]
        return (sum(int(e["batch"]["valid"].sum()) for e in steps),
                int(sum(e["result"][0]["allow"][e["batch"]["valid"]].sum()
                        for e in steps)))
    # (1) one failed poll
    marks.append(len(log.entries))
    inject_frames(wire, frames[:seg // 2], "observe (c) rx_ring")
    FAULTS.arm("shim.rx_ring", mode="fail", times=1)
    try:
        inject_frames(wire, frames[seg // 2:seg], "observe (c) rx_ring")
        tripped = FAULTS.stats()["shim.rx_ring"]["trips"]
    finally:
        FAULTS.disarm("shim.rx_ring")
    faults = feeder.stats()["harvest_faults"] - fd0["harvest_faults"]
    check(faults == 1 and tripped == 1,
          f"observe (c): shim.rx_ring=fail:1 tripped {tripped} times, "
          f"failed {faults} polls")
    drain_tx(wire, "observe (c) rx_ring")
    # (2) the dispatch point failing for a whole segment
    opened0 = cnt.get('pipeline_breaker_transitions_total{to="open"}', 0)
    closed0 = cnt.get('pipeline_breaker_transitions_total{to="closed"}', 0)
    st1, fd1 = shim.stats(), feeder.stats()
    marks.append(len(log.entries))
    FAULTS.arm("pipeline.dispatch", mode="fail")
    try:
        inject_frames(wire, frames[seg:2 * seg], "observe (c) dispatch")
        check(eng.drain(timeout=300), "observe (c): no drain under fault")
        br_fault = eng.pipeline_stats()["breaker"]
        fd2 = feeder.stats()
    finally:
        FAULTS.disarm("pipeline.dispatch")
    st2 = shim.stats()
    refused = st2["verdict_drops"] - st1["verdict_drops"]
    check(refused == seg and st2["verdict_passes"] == st1["verdict_passes"],
          f"observe (c): under pipeline.dispatch=fail {refused} of {seg} "
          f"frames dropped, {st2['verdict_passes'] - st1['verdict_passes']}"
          f" passed")
    opened = cnt.get('pipeline_breaker_transitions_total{to="open"}',
                     0) - opened0
    check(opened >= 1 and br_fault["state"] != "closed"
          and fd2["rejected_batches"] > fd1["rejected_batches"],
          f"observe (c): breaker {br_fault}, opened {opened} times, "
          f"rejected batches {fd2['rejected_batches']}")
    # (3) disarmed: past the cooldown, the probe closes the breaker
    time.sleep(eng.config.pipeline_breaker_cooldown_s + 0.2)
    marks.append(len(log.entries))
    inject_frames(wire, frames[2 * seg:3 * seg], "observe (c) probe")
    drain_tx(wire, "observe (c) probe")
    br = eng.pipeline_stats()["breaker"]
    closed = cnt.get('pipeline_breaker_transitions_total{to="closed"}',
                     0) - closed0
    check(br["state"] == "closed" and closed >= 1,
          f"observe (c): after the cooldown the breaker is {br}, closed "
          f"{closed} times")
    # each segment's dispatched rows, then every frame accounted for
    marks.append(len(log.entries))
    per = [dispatched(marks[i])[0] - dispatched(marks[i + 1])[0]
           for i in range(3)]
    check(per[0] == seg and per[1] == 0 and 0 < per[2] <= seg,
          f"observe (c): rows dispatched by segment {per} of {seg} each")
    rows, allowed = dispatched(marks[0])
    st = shim.stats()
    injected = 3 * seg
    fail_closed = injected - rows
    passes = st["verdict_passes"] - st0["verdict_passes"]
    drops = st["verdict_drops"] - st0["verdict_drops"]
    tx = wire.tx - tx0
    check(st["tx_full_drops"] == st0["tx_full_drops"],
          "observe (c): frames dropped at a full tx ring")
    check(passes == allowed == tx and drops == rows - allowed + fail_closed
          and fail_closed == 2 * seg - per[2],
          f"observe (c): injected {injected}: forwarded {tx} (shim passes "
          f"{passes}), dispatches allowed {allowed} and dropped "
          f"{rows - allowed} of {rows}, fail-closed {fail_closed}; shim "
          f"drops {drops}")
    return [
        f"observe (c): shim.rx_ring=fail:1 armed mid-segment: 1 failed "
        f"poll, {seg} of {seg} frames dispatched; pipeline.dispatch=fail "
        f"for a segment: {refused} of {seg} rows applied fail-closed, "
        f"{fd2['rejected_batches'] - fd1['rejected_batches']} batches "
        f"refused, breaker opened ({json.dumps(br_fault)}); disarmed, "
        f"{eng.config.pipeline_breaker_cooldown_s} s cooldown, the probe "
        f"closed it ({json.dumps(br)}), {seg - per[2]} of the segment's "
        f"rows refused while the probe was out [{card}]",
        f"observe (c): {injected} frames injected = {tx} forwarded + "
        f"{rows - allowed} dropped by the dispatches + {fail_closed} "
        f"fail-closed; {rows} rows dispatched [{card}]"]


def phase_observe(wire, card, report=None):
    """The flow observer and the fault points on the served wire path of
    phase feeder's cfg5 engine and shim (parts (a), (b), (c)); then every
    dispatch since phase feeder's replay and the CT held against the
    plain replay, K1/K2/K3 launched once a dispatch, and the engine
    stopped. → phase lines."""
    host_bound("phase observe")
    import numpy as np
    from cilium_tpu_torch.kernels import fused as fk
    t0 = time.perf_counter()
    first = wire.replay.n_steps
    fk.reset_launches()
    n0 = wire.log.steps()
    try:
        frames, lines = observe_part_a(wire, card)
        _doc, more = observe_part_b(wire, frames, card)
        lines += more
        lines += observe_part_c(wire, frames, card)
        drain_tx(wire, "observe")
        launches = dict(fk.LAUNCHES)
        dispatched = wire.log.steps() - n0
        wire.replay.feed(wire.log)
        want, got = wire.eng.ct_arrays(), wire.replay.plain.ct_arrays()
        for k in want:
            check(np.array_equal(want[k], got[k]),
                  f"observe: CT {k} differs from the plain replay")
    finally:
        wire.eng.stop()
        wire.shim.close()
    for k, v in launches.items():
        check(v == dispatched, f"observe: kernel {k} launched {v} times for "
                               f"{dispatched} dispatches")
    note_launches(report, "observe", launches)
    return lines + [
        f"observe: {wire.replay.n_steps - first} dispatches replayed on a "
        f"plain TorchDatapath (every out column and counter, then the CT "
        f"arrays, equal); the part took {time.perf_counter() - t0:.3f} s "
        f"[{card}]",
        f"observe launches: {json.dumps(launches)} for {dispatched} "
        f"dispatches"]


# --------------------------------------------------------------------------- #
# verify: the verifier's dry run of every datapath combination on the card
# --------------------------------------------------------------------------- #
def phase_verify(card):
    """``verify_configs(quick=True)`` on the card: every combination
    accepted; each one's argument, temp and output bytes, and the
    ``budget_doc``. → phase lines."""
    host_bound("phase verify")
    from cilium_tpu_torch.compile.verifier import budget_doc, verify_configs
    from cilium_tpu_torch.kernels import fused as fk
    fk.reset_launches()
    t0 = time.perf_counter()
    reports = verify_configs(quick=True, device=DEVICE)
    sweep_s = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    bad = [(r.name, r.error[:200]) for r in reports if not r.ok]
    check(not bad, f"verify: rejected {bad}")
    for k, v in launches.items():
        check(v >= len(reports), f"verify: kernel {k} launched {v} times "
                                 f"for {len(reports)} combinations")
    return [f"verify: {len(reports)} combinations accepted in {sweep_s:.3f} "
            f"s [{card}]"] + [
        f"verify: {r.name} argument_bytes {r.argument_bytes} temp_bytes "
        f"{r.temp_bytes} output_bytes {r.output_bytes}" for r in reports] + [
        f"verify: budget_doc {json.dumps(budget_doc(reports))}",
        f"verify launches: {json.dumps(launches)}"]


# --------------------------------------------------------------------------- #
# mesh: cfg5 through the engine on meshes whose shards share the card
# --------------------------------------------------------------------------- #
#: the meshes of phase mesh: (key, label, DaemonConfig fields)
MESH_CONFIGS = (
    ("a", "4 flow shards, host RSS", dict(n_shards=4)),
    ("b", "4 flow shards, device RSS", dict(n_shards=4, rss_mode="device")),
    ("c", "2 flow x 2 rule shards", dict(n_shards=2, rule_shards=2)),
)
#: churn batches each mesh serves one at a time (the same batches and
#: clocks on every mesh and on the one-shard datapath), then pipelined
MESH_SERIAL = 6
MESH_PIPELINED = 8
#: (d), on mesh (a): batches served by the degraded 3-shard mesh, then by
#: the healed 4-shard mesh
MESH_DEGRADED = 6
MESH_HEALED = 4
#: the shard the drill loses
MESH_LOST = 2
#: the verdict columns held against the one-shard datapath
VERDICT_COLS = ("allow", "reason", "redirect", "remote_identity",
                "matched_rule", "lpm_prefix")


def mesh_launch_check(launches, dispatched, flow_shards, colocated,
                      device_rss, what):
    """K2 launches once per flow shard a dispatch. The host-steered step
    of a flow-only mesh whose shards share the card (``colocated``) runs
    the stateless stages once over all rows: K1, K3 and the fingerprint
    kernel once a dispatch. Elsewhere K1 launches once per flow shard and
    K3 never (the policy stage runs the split plain core); the fingerprint
    kernel runs in each flow shard's classify step, which the device-RSS
    exchange step (``device_rss``) does not call."""
    want = {"lpm_lookup_fused":
            dispatched if colocated else flow_shards * dispatched,
            "ct_probe_pair_fused": flow_shards * dispatched,
            "policy_verdict_fused": dispatched if colocated else 0,
            "flow_fingerprint_fused":
            dispatched if colocated
            else 0 if device_rss else flow_shards * dispatched}
    check(dispatched > 0 and launches == want,
          f"mesh {what}: launches {launches}, want {want} for "
          f"{dispatched} dispatches")


def mesh_serve(eng, log, batches, now0, card, what, after_serial=None):
    """``batches`` = (serial, piped): the first through ``Engine.submit``
    one at a time, then ``after_serial()``, then the others pipelined (2
    in flight) through ``Feed``. → (serial outputs, lines)."""
    import numpy as np
    serial, piped = batches
    outs, lat = [], []
    for i, b in enumerate(serial):
        t0 = time.perf_counter()
        outs.append(eng.submit({k: v.copy() for k, v in b.items()},
                               now=now0 + i).result(timeout=300))
        lat.append(time.perf_counter() - t0)
    if after_serial is not None:
        after_serial()
    rows = sum(int(b["valid"].sum()) for b in serial)
    clock = [now0 + len(serial)]

    def tick():
        clock[0] += 1
        return clock[0]
    it = iter(piped)
    feed = Feed(eng, log, lambda: {k: v.copy() for k, v in next(it).items()},
                tick, len(piped), len(piped), outstanding=2).join()
    check(eng.drain(timeout=300), f"mesh {what}: the pipeline did not drain")
    steady = lat[1:] or lat
    return outs, [
        f"mesh {what}: one batch at a time {rows / sum(lat):.0f} flows/s, "
        f"batch p50 {percentile_ms(steady, 50):.3f} ms p99 "
        f"{percentile_ms(steady, 99):.3f} ms over {len(steady)} batches of "
        f"{serial[0]['valid'].shape[0]}; pipelined (2 in flight) "
        f"{feed.rows / feed.wall_s:.0f} flows/s, submit → result p50 "
        f"{float(np.percentile(feed.lat_ms, 50)):.3f} ms over {feed.fed} "
        f"batches; shards share one card, so this is the mesh path's "
        f"overhead, not scaling [{card}]"]


def mesh_profile(dp, placed, snap, batches, now0, card, what):
    """``batches`` through the mesh datapath ``dp``'s synchronous entry
    (``classify``: it steers a host-RSS batch itself) under
    ``torch.profiler``: each kernel's launches and device time per launch,
    by name. → (the line, {kernel: ms})."""
    import torch
    torch.cuda.synchronize()
    with profiler_session(f"mesh {what}") as prof:
        for i, b in enumerate(batches):
            dp.classify(placed, snap, {k: v.copy() for k, v in b.items()},
                        now0 + i)
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    seen, ms = {}, {}
    for kernel, (_src, _rep, symbol) in KERNELS.items():
        seen[kernel], ms[kernel] = kernel_device_ms(ops, symbol)
    return (f"mesh {what}: {len(batches)} batches, kernel launches "
            f"seen {json.dumps(seen)}, device ms per launch " + json.dumps(
                {k: None if v is None else round(v, 6)
                 for k, v in ms.items()}) + f" [{card}]"), ms


def mesh_drill(eng, log, degraded, healed, now0, card):
    """(d): ``device.fail`` armed naming shard ``MESH_LOST``: the next
    dispatch fails, the pipeline parks, the engine re-meshes 4 → 3
    (salvaged + lost + dropped = the gathered table's live entries, the
    CT now 3 · 2^19 slots), degraded batches are served with the fault
    still armed; disarmed, the engine heals 3 → 4. → lines."""
    import numpy as np
    from cilium_tpu_torch.runtime.faults import FAULTS
    lines = []
    dp = eng.datapath
    check(eng.drain(timeout=300), "mesh d: the pipeline did not drain")
    FAULTS.arm("device.fail", mode="fail", message=f"dev={MESH_LOST}")
    try:
        trip = eng.submit({k: v.copy() for k, v in degraded[0].items()},
                          now=now0)
        deadline = time.monotonic() + 60
        while (eng.pipeline_stats() or {}).get("state") != "device-lost" \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        check(eng.pipeline_stats()["state"] == "device-lost",
              f"mesh d: pipeline state {eng.pipeline_stats()['state']}")
        gathered = int((dp.ct_arrays()["expiry"] > 0).sum())
        doc = eng.remesh_step()["remesh"]
        try:
            trip.result(timeout=60)
            check(False, "mesh d: the tripping batch was served")
        except SmokeFailure:
            raise
        except Exception:                  # rejected with the window
            pass
        check(doc["to"] == 3 and doc["salvage_source"] == "device",
              f"mesh d: remesh {doc}")
        total = doc["ct_salvaged"] + doc["ct_lost"] + doc["ct_dropped"]
        check(total == gathered and doc["ct_lost"] > 0,
              f"mesh d: salvaged {doc['ct_salvaged']} + lost "
              f"{doc['ct_lost']} + dropped {doc['ct_dropped']} != "
              f"{gathered} live in the gathered table")
        check(dp.ct_stats(0)["capacity"] == 3 * (dp.config.ct_capacity // 4),
              f"mesh d: CT capacity {dp.ct_stats(0)['capacity']}")
        lines.append(
            f"mesh d: device.fail dev={MESH_LOST}: re-mesh 4 → 3 in "
            f"{doc['took_s']} s (took_s; plus the snapshot re-placed): "
            f"gathered {gathered} live = salvaged {doc['ct_salvaged']} + "
            f"lost {doc['ct_lost']} + dropped {doc['ct_dropped']}; CT "
            f"{doc['ct_capacity']} slots on shards "
            f"{doc['live_ordinals']} [{card}]")
        outs, serve = mesh_serve(eng, log, (degraded[1:3], degraded[3:]),
                                 now0 + 10, card, "d degraded (3 shards)")
        lines += serve
        check(all(o["allow"].mean() > 0.5 for o in outs),
              "mesh d: degraded batches mostly dropped")
    finally:
        FAULTS.disarm("device.fail")
    live = int((dp.ct_arrays()["expiry"] > 0).sum())
    doc = eng.remesh_step()["remesh"]
    check(doc and doc["to"] == 4, f"mesh d: heal {doc}")
    total = doc["ct_salvaged"] + doc["ct_lost"] + doc["ct_dropped"]
    check(total == live and doc["ct_lost"] == 0,
          f"mesh d: heal salvaged/lost/dropped {doc} of {live} live")
    lines.append(f"mesh d: healed 3 → 4 in {doc['took_s']} s: {live} live "
                 f"= salvaged {doc['ct_salvaged']} + dropped "
                 f"{doc['ct_dropped']}; CT {doc['ct_capacity']} slots "
                 f"[{card}]")
    _outs, serve = mesh_serve(eng, log, (healed[:2], healed[2:]),
                              now0 + 100, card, "d healed (4 shards)")
    return lines + serve


def phase_mesh(seed, card, report):
    """cfg5 through the port's engine on meshes whose shards share the
    card: (a) 4 flow shards with host RSS, (b) 4 with device RSS, (c)
    2 flow × 2 rule shards, (d) the device-loss drill on (a). Every
    dispatch is held against a plain datapath of the same geometry
    replaying it; (a) and (b) against each other; the verdicts of (a),
    (b) and (c) against a one-shard datapath. → phase lines."""
    host_bound("phase mesh")
    import dataclasses

    import numpy as np
    import torch
    from cilium_tpu_torch.kernels import fused as fk
    from cilium_tpu_torch.runtime.datapath import TorchDatapath
    from cilium_tpu_torch.world import cfg5_traffic
    next_batch, _warm = cfg5_traffic(seed + 7, PRESET == "smoke")
    serial = [next_batch() for _ in range(MESH_SERIAL)]
    piped = [next_batch() for _ in range(MESH_PIPELINED)]
    for _ in range(2):      # keeps (d)'s batches the stream's 17th on
        next_batch()
    degraded = [next_batch() for _ in range(MESH_DEGRADED)]
    healed = [next_batch() for _ in range(MESH_HEALED)]
    now0 = 80_000
    lines, outs, ct_serial, launches = [], {}, {}, {}
    one_outs = None
    for key, label, fields in MESH_CONFIGS:
        what = f"{key} ({label})"
        eng, cfg, build_s = serve_engine(remesh_heal_hysteresis_s=0.0,
                                         **fields)
        dp = eng.datapath
        lines.append(f"mesh {what}: cfg5 built through the engine in "
                     f"{build_s:.3f} s (host CPU); CT {cfg.ct_capacity} "
                     f"slots in {dp.n_flow_shards} shards on "
                     f"{dp.mesh_health()['ordinal_devices']}")
        if one_outs is None:
            # the one-shard reference: the same snapshot, batches, clocks
            one = TorchDatapath(dataclasses.replace(
                cfg, n_shards=1, rule_shards=1, rss_mode="host"))
            snap = eng.active.snapshot
            placed = one.place(snap)
            one_outs = [one.classify(placed, snap,
                                     {k: v.copy() for k, v in b.items()},
                                     now0 + i)[0]
                        for i, b in enumerate(serial)]
            del one, placed
        log = DispatchLog(dp)
        fk.reset_launches()
        outs[key], serve = mesh_serve(
            eng, log, (serial, piped), now0, card, what,
            after_serial=lambda: ct_serial.__setitem__(key, dp.ct_arrays()))
        launches[key] = dict(fk.LAUNCHES)
        dispatched = log.steps()
        mesh_launch_check(launches[key], dispatched, dp.n_flow_shards,
                          key == "a", cfg.rss_mode == "device", what)
        lines += serve
        lines.append(f"mesh {what}: host ms per dispatch inside "
                     f"classify_async p50 "
                     f"{float(np.percentile(log.async_ms, 50)):.3f}, "
                     f"finalize p50 "
                     f"{float(np.percentile(log.finalize_ms, 50)):.3f}; "
                     f"launches {json.dumps(launches[key])} for "
                     f"{dispatched} dispatches [{card}]")
        if key == "a":
            calls = dispatch_calls(
                eng, log, [{k: v.copy() for k, v in b.items()}
                           for b in piped[:4]],
                [now0 + 150 + i for i in range(4)])
            lines.append(f"mesh {what}: python-level torch calls a "
                         f"dispatch (classify_async and its finalize, 4 "
                         f"more batches): {calls_text(calls)}")
        if key == "b":
            ex = dp.rss_exchange_stats()
            lines.append(f"mesh {what}: exchange_bytes {json.dumps(ex)} "
                         f"(gathered requests + replies a bucket, all "
                         f"shards)")
        if key == "a":
            fk.reset_launches()
            first = len(log.entries)
            lines += mesh_drill(eng, log, degraded, healed, now0 + 200, card)
            launches["d"] = dict(fk.LAUNCHES)
            # every dispatch launches K2 once per flow shard of the mesh
            # that served it, K1 and K3 once (the shards share the card)
            width, k2, steps = 4, 0, 0
            for kind, e in log.entries[first:]:
                if kind == "remesh":
                    width = len(e[0])
                elif kind == "step":
                    k2, steps = k2 + width, steps + 1
            want = {"lpm_lookup_fused": steps, "ct_probe_pair_fused": k2,
                    "policy_verdict_fused": steps,
                    "flow_fingerprint_fused": steps}
            check(launches["d"] == want,
                  f"mesh d: launches {launches['d']}, want {want} for "
                  f"{steps} dispatches")
            lines.append(f"mesh d launches: {json.dumps(launches['d'])} "
                         f"for {steps} dispatches at 4, 3 and 4 shards")
        t0 = time.perf_counter()
        plain, n_steps, _n_gc = replay_plain(log, cfg)
        want, got = eng.ct_arrays(), plain.ct_arrays()
        for k in want:
            check(np.array_equal(want[k], got[k]),
                  f"mesh {what}: CT {k} differs from the plain path")
        lines.append(f"mesh {what}: {n_steps} dispatches replayed on a "
                     f"plain mesh of the same geometry (fused_kernels=off) "
                     f"in {time.perf_counter() - t0:.3f} s: every out "
                     f"column, counter, re-mesh count and the CT arrays "
                     f"equal")
        eng.stop()
        del eng, dp, log, plain, want, got
        torch.cuda.empty_cache()
    # (a) and (b) on the same batches: every column, and the CT after
    for i in range(MESH_SERIAL):
        for k in outs["a"][i]:
            check(np.array_equal(outs["a"][i][k], outs["b"][i][k]),
                  f"mesh: batch {i} {k}: host RSS != device RSS")
    for k in ct_serial["a"]:
        check(np.array_equal(ct_serial["a"][k], ct_serial["b"][k]),
              f"mesh: CT {k} after the same batches: host RSS != device "
              f"RSS")
    full = 0
    for key in ("a", "b", "c"):
        for i, (got, want) in enumerate(zip(outs[key], one_outs)):
            ok = ~(got["ct_full"] | want["ct_full"])
            full += int((~ok).sum())
            for k in VERDICT_COLS:
                check(np.array_equal(got[k][ok], want[k][ok]),
                      f"mesh {key}: batch {i} {k} != one shard")
    lines.append(f"mesh: (a) = (b) in every column of {MESH_SERIAL} "
                 f"batches and in the CT arrays after them; (a), (b), (c) = one shard in "
                 f"{list(VERDICT_COLS)} on every row where neither "
                 f"reports CT_FULL ({full} CT_FULL rows over the three)")
    for k in report:
        report[k]["mesh_launches"] = {m: launches[m][k] for m in launches}
    return lines


# --------------------------------------------------------------------------- #
# tenants: cfg5 with multi-tenant QoS (cfg8's tenants and lane)
# --------------------------------------------------------------------------- #
#: cfg8's tenant spec and lane bucket (``bench.py`` ``tenants_bench``)
QOS_TENANTS = "gold=4:lane,silver=2,bulk=1:cap=10"
QOS_LANE_BUCKET = 64
#: rows of a gold lane probe (under the lane bucket)
LANE_ROWS = 32
#: lane probes with nothing else running, and isolation rounds (each: two
#: bulk floods, a silver batch and a lane probe)
TENANT_LANE_PROBES = 16
TENANT_ISO_ROUNDS = 12
#: wall seconds of the saturating share window, and the batches each
#: tenant's pool holds for it
TENANT_SHARE_S = 4.0
TENANT_POOL = 4


def note_launches(report, phase, launches):
    """Add a phase's launches of each kernel to the kernels' JSON rows
    (``phase_launches``); ``report`` None leaves them out."""
    if report is None:
        return
    for k, n in launches.items():
        report[k].setdefault("phase_launches", {})[phase] = n


def widest_wire():
    """Words a row of the widest wire format ships (the L7 dictionary's):
    a host-only column on the wire would make a wire wider."""
    from cilium_tpu_torch.kernels.records import wire_words_for
    return max(wire_words_for(a, b) for a in (0, 1) for b in (0, 1))


def head_rows(b, n):
    """The first ``n`` rows of batch ``b`` (copies)."""
    return {k: v[:n].copy() for k, v in b.items()}


def resolve_all(tickets):
    """Wait for every ticket. → how many were shed after admission (a
    flood batch displaced or past its deadline); any other error fails
    the phase."""
    from cilium_tpu_torch.pipeline.guard import (PipelineDeadlineExceeded,
                                                 PipelineDrop)
    shed = 0
    for t in tickets:
        try:
            t.result(timeout=300)
        except (PipelineDrop, PipelineDeadlineExceeded):
            shed += 1
    return shed


def phase_tenants(seed, card, report=None):
    """cfg5 built through the engine with cfg8's QoS (gold lane, silver,
    capped bulk): lane probes alone and under bulk floods of full cfg5
    churn batches, then a saturating backlog of all three tenants whose
    admitted rows must split 4:2:1; the auditor at sampling 1.0 on the
    lane; every dispatch held against the plain path. → (phase lines,
    the engine's snapshot, its ipcache entries), the last two for phase
    goldengen."""
    host_bound("phase tenants")
    import numpy as np
    from cilium_tpu_torch.kernels import fused as fk
    from cilium_tpu_torch.pipeline.guard import PipelineError
    from cilium_tpu_torch.world import cfg5_traffic

    lines = []
    eng, cfg, build_s = serve_engine(
        qos_enabled=True, qos_tenants=QOS_TENANTS,
        qos_lane_bucket=QOS_LANE_BUCKET, pipeline_inflight=1,
        pipeline_flush_ms=5.0, pipeline_queue_batches=16,
        pipeline_block_timeout_s=0.05, audit_max_rows=LANE_ROWS)
    tid = {name: t for t, name in eng.qos.tenants().items()}
    lines.append(f"tenants: cfg5 built through the engine with qos_tenants="
                 f"{QOS_TENANTS!r}, lane bucket {QOS_LANE_BUCKET} in "
                 f"{build_s:.3f} s (host CPU); tenants {json.dumps(tid)}")
    next_batch, _warm = cfg5_traffic(seed + 11, PRESET == "smoke")
    log = DispatchLog(eng.datapath)
    clock = [60_000]

    def stamped(b, tenant):
        b["_tenant"] = np.full(b["valid"].shape, tid[tenant], np.int32)
        return b

    def lane_probe(record=None):
        t0 = time.perf_counter()
        out = eng.submit(stamped(head_rows(next_batch(), LANE_ROWS), "gold"),
                         now=clock[0]).result(timeout=300)
        if record is not None:
            record.append((time.perf_counter() - t0) * 1e3)
        return out

    def p(vals, q):
        return float(np.percentile(np.asarray(vals), q))

    for _ in range(2):                     # warm the lane and full shapes
        lane_probe()
        eng.submit(stamped(next_batch(), "silver"),
                   now=clock[0]).result(timeout=300)
        clock[0] += 1
    fk.reset_launches()
    steps0 = log.steps()

    unloaded = []
    for _ in range(TENANT_LANE_PROBES):
        lane_probe(unloaded)
        clock[0] += 1

    # isolation: bulk floods full cfg5 batches while gold and silver serve
    loaded, pending, flood_sent, flood_shed = [], [], 0, 0
    t0 = time.perf_counter()
    rows = 0
    for _ in range(TENANT_ISO_ROUNDS):
        clock[0] += 1
        for _f in range(2):
            try:
                tk = eng.submit(stamped(next_batch(), "bulk"), now=clock[0],
                                deadline_ms=0)
            except PipelineError:         # refused at admission: shed
                flood_shed += 1
                continue
            if tk.dropped:
                flood_shed += 1
            else:
                flood_sent += 1
                pending.append(tk)
                rows += cfg.batch_size
        pending.append(eng.submit(stamped(next_batch(), "silver"),
                                  now=clock[0]))
        rows += cfg.batch_size + LANE_ROWS
        lane_probe(loaded)
    late = resolve_all(pending)           # floods shed after admission
    flood_sent, flood_shed = flood_sent - late, flood_shed + late
    rows -= late * cfg.batch_size
    iso_s = time.perf_counter() - t0
    check(eng.drain(timeout=300), "tenants: the pipeline did not drain")

    # the share window: every tenant pushes a saturating backlog
    pl = eng.start_pipeline()
    pools = {n: [stamped(next_batch(), n) for _ in range(TENANT_POOL)]
             for n in ("gold", "silver", "bulk")}
    before = {n: d["admitted_rows"] for n, d in pl.stats()["tenants"].items()}
    pending, k = [], 0
    t_end = time.monotonic() + TENANT_SHARE_S
    while time.monotonic() < t_end:
        clock[0] += 1
        k += 1
        for name, pool in pools.items():
            for r in range(2):
                try:
                    tk = eng.submit(pool[(k + r) % TENANT_POOL],
                                    now=clock[0], deadline_ms=0)
                except PipelineError:     # refused at admission
                    continue
                if not tk.dropped:
                    pending.append(tk)
        time.sleep(0.002)
    after = {n: d["admitted_rows"] for n, d in pl.stats()["tenants"].items()}
    share_shed = resolve_all(pending)
    check(eng.drain(timeout=300), "tenants: the pipeline did not drain")
    admitted = {n: after.get(n, 0) - before.get(n, 0) for n in after}
    total = max(1, sum(admitted.get(n, 0) for n in pools))
    share = {n: admitted.get(n, 0) / total for n in pools}
    check(0.5 / 7 <= share["bulk"] <= 1.5 / 7,
          f"tenants: bulk's admitted share {share['bulk']:.4f} outside "
          f"[{0.5 / 7:.4f}, {1.5 / 7:.4f}] ({admitted})")

    # the auditor at sampling 1.0 over lane probes
    eng.auditor.configure(sample_rate=1.0)
    for _ in range(4):
        lane_probe()
        clock[0] += 1
    eng.auditor.configure(sample_rate=0.0)
    for _ in range(100):
        st = eng.audit_step(budget=64)
        if not st or not (st.get("replayed") or st.get("pending")):
            break
    audit = eng.auditor.stats()
    check(audit["checked_rows"] > 0 and audit["mismatched_rows"] == 0,
          f"tenants: audit {audit}")
    dispatched = log.steps() - steps0
    launches = dict(fk.LAUNCHES)
    for name, n in launches.items():
        check(n >= dispatched, f"tenants: {name} launched {n} times for "
                               f"{dispatched} dispatched batches")
    check(0 < log.wire_words <= widest_wire(),
          f"tenants: a wire of {log.wire_words} words a row uploaded")
    qos = eng.qos_status()
    hbm = eng.datapath.hbm_ledger()
    pstats = eng.pipeline_stats()
    check(pstats["dispatch_errors"] == 0,
          f"tenants: dispatch errors {pstats['dispatch_errors']}")
    t0 = time.perf_counter()
    plain, n_steps, _n_gc = replay_plain(log, cfg)
    want, got = eng.ct_arrays(), plain.ct_arrays()
    for k2 in want:
        check(np.array_equal(want[k2], got[k2]),
              f"tenants: CT {k2} differs from the plain path")
    replay_s = time.perf_counter() - t0
    eng.stop()
    snap, ipcache = eng.active.snapshot, eng.ctx.ipcache.snapshot()
    note_launches(report, "tenants", launches)
    return lines + [
        f"tenants: isolation: {rows / iso_s:.0f} flows/s over "
        f"{TENANT_ISO_ROUNDS} rounds ({flood_sent} bulk floods of "
        f"{cfg.batch_size} served, {flood_shed} shed); "
        f"lane ({LANE_ROWS} rows) submit → result p50 "
        f"{p(unloaded, 50):.3f} ms p99 {p(unloaded, 99):.3f} ms unloaded, "
        f"p50 {p(loaded, 50):.3f} ms p99 {p(loaded, 99):.3f} ms under the "
        f"flood [{card}]",
        f"tenants: share window {TENANT_SHARE_S} s of saturating backlogs "
        f"(batches of {cfg.batch_size}, {share_shed} shed after "
        f"admission): admitted rows {json.dumps(admitted)}, shares "
        f"{json.dumps({n: round(v, 4) for n, v in share.items()})} "
        f"(weights 4:2:1 → 0.5714/0.2857/0.1429)",
        f"tenants: qos_status {json.dumps(qos, default=str)}; bytes on "
        f"the card {json.dumps(hbm['groups'])} (device "
        f"{hbm['device_bytes']})",
        f"tenants: audit at sampling 1.0 over 4 lane probes: checked "
        f"{audit['checked_rows']} rows, mismatched "
        f"{audit['mismatched_rows']}; {log.host_cols} dispatches carried "
        f"_tenant to the datapath, the widest wire uploaded "
        f"{log.wire_words} words a row (no host column on the card)",
        f"tenants: {n_steps} dispatches replayed on a plain TorchDatapath "
        f"(fused_kernels=off) in {replay_s:.3f} s: every out column, "
        f"counter and the CT arrays equal",
        f"tenants launches: {json.dumps(launches)} for {dispatched} "
        f"dispatched batches"], snap, ipcache


# --------------------------------------------------------------------------- #
# fqdn: cfg5 with the in-band DNS plane (cfg9's rules and churn)
# --------------------------------------------------------------------------- #
#: cfg9's churn (``bench.py`` ``fqdn_bench``): stable names re-resolved
#: every tick with a long TTL, churn names new every tick with a short one
FQDN_TICKS = 16
FQDN_STABLE = 6
FQDN_CHURN = 8
FQDN_STABLE_TTL, FQDN_CHURN_TTL, FQDN_TICK_S = 10_000, 15, 7
DNS_PAYLOAD = 512
#: rows of each tick's churn batch that go web → a learned (or retired,
#: or not yet learned) name's IP on 443, per name
FQDN_PROBE_ROWS = 64


def fqdn_rules():
    """cfg9's two egress rules on web: the UDP/53 redirect to the
    resolver (allow-all L7 set) and ``toFQDNs`` → TCP 443."""
    return [{"endpointSelector": {"matchLabels": {"app": "web"}},
             "egress": [
                 {"toCIDR": ["8.8.8.8/32"],
                  "toPorts": [{"ports": [{"port": "53", "protocol": "UDP"}],
                               "rules": {"http": [{}]}}]},
                 {"toFQDNs": [{"matchPattern": "*.svc.example.com"}],
                  "toPorts": [{"ports": [{"port": "443",
                                          "protocol": "TCP"}]}]}]}]


def dns_batch(answers):
    """DNS exchange rows web → 8.8.8.8:53/UDP whose harvested responses
    ride the ``_dns_payload``/``_dns_len`` columns, as the feeder's poll
    buffers carry them."""
    import numpy as np
    from cilium_tpu_torch.fqdn.dnsparse import encode_response
    from cilium_tpu_torch.kernels.records import empty_batch
    from cilium_tpu_torch.utils import constants as C
    from cilium_tpu_torch.world import WEB_IP_WORD
    n = len(answers)
    b = empty_batch(n)
    for col in ("src", "dst"):
        b[col][:, 2] = 0xFFFF
    b["src"][:, 3] = WEB_IP_WORD
    b["dst"][:, 3] = 0x08080808
    b["sport"][:] = 30000 + np.arange(n)
    b["dport"][:] = 53
    b["proto"][:] = C.PROTO_UDP
    b["direction"][:] = C.DIR_EGRESS
    b["valid"][:] = True
    b["_dns_payload"] = np.zeros((n, DNS_PAYLOAD), np.uint8)
    b["_dns_len"] = np.zeros((n,), np.int32)
    for i, (name, ip, ttl) in enumerate(answers):
        wire = encode_response(name, [ip], ttl=ttl)[:DNS_PAYLOAD]
        b["_dns_payload"][i, :len(wire)] = np.frombuffer(wire, np.uint8)
        b["_dns_len"][i] = len(wire)
    return b


def ip_word(ip):
    a, b_, c, d = (int(x) for x in ip.split("."))
    return (a << 24) | (b_ << 16) | (c << 8) | d


def phase_fqdn(seed, card, report=None):
    """cfg5 plus cfg9's DNS rules through the engine with the DNS plane:
    per tick, a DNS batch through the pipeline whose redirect rows the
    proxy learns from, the fqdn-gc expiry, a refresh (identity growth
    and retirement as trie and verdict patches), then a full cfg5 churn
    batch with rows to learned, retired and unlearned names on 443; every
    dispatch held against the plain path. → phase lines."""
    host_bound("phase fqdn")
    import numpy as np
    from cilium_tpu_torch.fqdn.proxy import DNSProxy
    from cilium_tpu_torch.kernels import fused as fk
    from cilium_tpu_torch.utils import constants as C
    from cilium_tpu_torch.world import WEB_IP_WORD, cfg5_traffic

    lines = []
    eng, cfg, build_s = serve_engine(fqdn_proxy_enabled=True,
                                     fqdn_min_ttl=0)
    L = [50_000]
    eng.ctx.fqdn_cache.clock = lambda: L[0]
    log = DispatchLog(eng.datapath)
    t0 = time.perf_counter()
    eng.apply_policy(fqdn_rules())
    eng.regenerate()
    lines.append(f"fqdn: cfg5 built through the engine in {build_s:.3f} s, "
                 f"cfg9's two egress rules added in "
                 f"{time.perf_counter() - t0:.3f} s (host CPU); lpm_v4 "
                 f"{list(eng.active.tensors['lpm_v4'].shape)}, v4_only "
                 f"{cfg.v4_only} (K1 walks the trie's own planes: no "
                 f"lpm_derive on a patch)")
    # the proxy the feeder's verdict-apply path taps, observed by the
    # engine's status as the feeder's would be
    proxy = DNSProxy(eng.ctx.fqdn_cache, metrics=eng.metrics,
                     min_ttl=cfg.fqdn_min_ttl, port=cfg.fqdn_proxy_port,
                     payload_width=DNS_PAYLOAD)
    eng._dns_proxy = proxy               # noqa: SLF001 — the feeder's slot
    next_batch, _warm = cfg5_traffic(seed + 13, PRESET == "smoke")
    stable = {f"s{i}.svc.example.com": f"20.0.{i}.1"
              for i in range(FQDN_STABLE)}

    def churn(t):
        return {f"c{t}-{j}.svc.example.com": f"20.1.{t % 200}.{j + 1}"
                for j in range(FQDN_CHURN)}

    def learn(answers):
        b = dns_batch(answers)
        out = eng.submit(b, now=L[0]).result(timeout=300)
        proxy.observe_batch(b, out)
        return int(np.asarray(out["redirect"]).sum())

    for name, ip in stable.items():          # seed the stable names
        learn([(name, ip, FQDN_STABLE_TTL)])
    eng.regenerate()
    dp = eng.datapath
    patch0 = dict(dp.patch_stats)
    fulls0 = eng.metrics.counters.get("regen_full_total", 0)
    incr0 = eng.metrics.counters.get("regen_incremental_total", 0)
    retired0 = eng.metrics.counters.get("fqdn_identities_retired_total", 0)
    created0 = eng.repo.fqdn_identities_created
    fk.reset_launches()
    steps0 = log.steps()

    # the probe targets of each tick: every stable name, and the churn
    # names of ticks t-3 .. t+1 (retired, live, not yet learned)
    history = {}                             # name → [allowed per tick]
    refresh_ms, redirect_rows, sport = [], 0, [20000]
    for t in range(FQDN_TICKS):
        L[0] += FQDN_TICK_S
        answers = [(n, ip, FQDN_STABLE_TTL) for n, ip in stable.items()]
        answers += [(n, ip, FQDN_CHURN_TTL) for n, ip in churn(t).items()]
        redirect_rows += learn(answers)
        eng.ctx.fqdn_cache.expire(L[0])
        t0 = time.perf_counter()
        eng.regenerate()
        refresh_ms.append((time.perf_counter() - t0) * 1e3)
        targets = dict(stable)
        for u in range(max(0, t - 3), t + 2):
            targets.update(churn(u))
        b = next_batch()
        names = list(targets)
        n = FQDN_PROBE_ROWS * len(names)
        b["src"][:n, 3] = WEB_IP_WORD
        b["dst"][:n, 3] = np.repeat(
            np.array([ip_word(targets[m]) for m in names], np.uint32),
            FQDN_PROBE_ROWS)
        b["direction"][:n] = C.DIR_EGRESS
        b["dport"][:n] = 443
        b["sport"][:n] = sport[0] + np.arange(n)    # new flows each tick
        sport[0] = 20000 + (sport[0] - 20000 + n) % 40000
        b["tcp_flags"][:n] = C.TCP_SYN
        out = eng.submit(log.own(b), now=L[0]).result(timeout=300)
        allow = np.asarray(out["allow"][:n]).reshape(len(names),
                                                     FQDN_PROBE_ROWS)
        for i, m in enumerate(names):
            history.setdefault(m, {})[t] = int(allow[i].sum())
    check(eng.drain(timeout=300), "fqdn: the pipeline did not drain")
    check(eng.metrics.counters.get("regen_failures_total", 0) == 0,
          f"fqdn: a regeneration failed: {eng._last_regen_error}")
    fulls = eng.metrics.counters.get("regen_full_total", 0) - fulls0
    incr = eng.metrics.counters.get("regen_incremental_total", 0) - incr0
    check(fulls == 0 and incr >= FQDN_TICKS,
          f"fqdn: {fulls} full rebuilds, {incr} delta refreshes in "
          f"{FQDN_TICKS} ticks")
    retired = eng.metrics.counters.get("fqdn_identities_retired_total",
                                       0) - retired0
    created = eng.repo.fqdn_identities_created - created0
    check(created > 0 and retired > 0 and redirect_rows > 0,
          f"fqdn: created {created}, retired {retired}, redirect rows "
          f"{redirect_rows}")
    # stable names never flap; a churn name's rows go drop → allow → drop
    flips = {}
    for m, per in history.items():
        seq = [per[t] > 0 for t in sorted(per)]
        if m in stable:
            check(all(seq) and min(per.values()) >= FQDN_PROBE_ROWS // 2,
                  f"fqdn: stable name {m} flapped: {per}")
            continue
        t_learn = int(m[1:m.index("-")])
        pattern = "".join("A" if a else "d" for a in seq)
        flips[pattern] = flips.get(pattern, 0) + 1
        want_live = [t_learn <= t < t_learn + 3 for t in sorted(per)]
        check(seq == want_live, f"fqdn: churn name {m} (learned at tick "
                                f"{t_learn}) allowed {per}")
    dispatched = log.steps() - steps0
    launches = dict(fk.LAUNCHES)
    for name, k in launches.items():
        check(k >= dispatched, f"fqdn: {name} launched {k} times for "
                               f"{dispatched} dispatched batches")
    check(0 < log.wire_words <= widest_wire(),
          f"fqdn: a wire of {log.wire_words} words a row uploaded")
    patch = {k: v - patch0[k] for k, v in dp.patch_stats.items()}
    trie = [(round(ms, 3), rows) for ms, names_, rows in log.patches
            if "lpm_v4" in names_]
    other = [round(ms, 3) for ms, names_, _r in log.patches
             if "lpm_v4" not in names_]
    check(trie, "fqdn: no patch placed a new trie")
    status = eng.fqdn_status()
    hbm = dp.hbm_ledger()
    verdict = list(eng.active.snapshot.tensors(
        only=frozenset(("verdict",)))["verdict"].shape)
    t0 = time.perf_counter()
    plain, n_steps, _n_gc = replay_plain(log, cfg)
    want, got = eng.ct_arrays(), plain.ct_arrays()
    for k in want:
        check(np.array_equal(want[k], got[k]),
              f"fqdn: CT {k} differs from the plain path")
    replay_s = time.perf_counter() - t0
    eng.stop()
    note_launches(report, "fqdn", launches)
    return lines + [
        f"fqdn: {FQDN_TICKS} ticks of {FQDN_STABLE} stable + {FQDN_CHURN} "
        f"churn names (TTL {FQDN_CHURN_TTL} s, a tick {FQDN_TICK_S} s): "
        f"refresh p50 {float(np.percentile(refresh_ms, 50)):.3f} ms p99 "
        f"{float(np.percentile(refresh_ms, 99)):.3f} ms (host, regenerate "
        f"with the patch placed), {fulls} full rebuilds, {incr} delta "
        f"refreshes; identities created {created}, retired {retired}; "
        f"{redirect_rows} DNS rows carried the redirect [{card}]",
        f"fqdn: after the churn verdict {verdict}, bytes on the card "
        f"{json.dumps(hbm['groups'])} (device {hbm['device_bytes']})",
        f"fqdn: trie patches (place_patch host ms, delta rows) {trie}; "
        f"other patches host ms {other}; patch counters "
        f"{json.dumps(patch)} [{card}]",
        f"fqdn: churn names' rows ({FQDN_PROBE_ROWS} each a tick, d = "
        f"dropped, A = allowed): {json.dumps(flips)}; the {FQDN_STABLE} "
        f"stable names allowed every tick",
        f"fqdn: fqdn_status {json.dumps(status, default=str)}; "
        f"{log.host_cols} dispatches carried the _dns columns to the "
        f"datapath, the widest wire uploaded {log.wire_words} words a row "
        f"(the {DNS_PAYLOAD}-byte payload never reached the card)",
        f"fqdn: {n_steps} dispatches replayed on a plain TorchDatapath "
        f"(fused_kernels=off, each snapshot placed whole) in "
        f"{replay_s:.3f} s: every out column, counter and the CT arrays "
        f"equal",
        f"fqdn launches: {json.dumps(launches)} for {dispatched} "
        f"dispatched batches"]


# --------------------------------------------------------------------------- #
# cluster: cfg7 on the card — node processes over one clustermesh store
# --------------------------------------------------------------------------- #
CLUSTER_NODES = 2
#: rows a serve batch carries. The node worker builds its records one by
#: one in Python (``PacketRecord`` → ``batch_from_records``), so a batch
#: costs host time in proportion; 4,096 rows keeps that under a second
#: while the kernels run at a real batch width
CLUSTER_ROWS = 4096
CLUSTER_SERVE_BATCHES = 6
CLUSTER_STALE_S, CLUSTER_BUDGET_S = 2.0, 1.0


def cluster_ip(i):
    return f"10.{i + 1}.0.10"


def cluster_flows(i, n, sport0):
    """``n`` flows node ``i`` serves: peers' pods → its pod on 8080
    (allowed across the mesh), every 8th from an unknown world source and
    every 8th on port 23 (dropped). → (flows, the allow each should get)."""
    peers = [j for j in range(CLUSTER_NODES) if j != i]
    flows, want = [], []
    for r in range(n):
        src = cluster_ip(peers[r % len(peers)])
        dport, ok = 8080, True
        if r % 8 == 7:
            src, ok = f"203.0.113.{r % 250 + 1}", False
        elif r % 8 == 6:
            dport, ok = 23, False
        flows.append({"src": src, "dst": cluster_ip(i), "ep_id": 1,
                      "sport": sport0 + r, "dport": dport})
        want.append(ok)
    return flows, want


def phase_cluster(seed, card, report=None):
    """cfg7's shape on the card: ``ClusterSupervisor`` with two node
    processes, each an engine on ``TorchDatapath`` at cfg5's CT geometry:
    converge, serve cross-node flows, partition one node from the store,
    kill a peer and restart it, and fan the nodes' flowlogs into one
    ``FlowRelay``. → phase lines."""
    host_bound("phase cluster")
    import shutil
    import tempfile

    from cilium_tpu_torch.observe.relay import FlowRelay, JsonlTailObserver
    from cilium_tpu_torch.runtime.cluster import ClusterSupervisor
    from cilium_tpu_torch.world import cfg5_sizes

    cap = cfg5_sizes(PRESET == "smoke")[2]
    names = [f"node-{i}" for i in range(CLUSTER_NODES)]
    work = tempfile.mkdtemp(prefix="chip-smoke-cluster-")
    store, flows_dir = os.path.join(work, "store"), os.path.join(work, "fl")
    os.makedirs(flows_dir)
    overrides = {n: {"device": DEVICE, "ct_capacity": cap,
                     "batch_size": CLUSTER_ROWS, "audit_max_rows": 256,
                     "cluster_stale_after_s": CLUSTER_STALE_S,
                     "cluster_staleness_budget_s": CLUSTER_BUDGET_S,
                     "flowlog_path": os.path.join(flows_dir, f"{n}.jsonl")}
                 for n in names}
    lines = []

    def setup(sup, i):
        sup.add_endpoint(names[i], ["k8s:cluster=mesh", f"k8s:app=svc{i}"],
                         [cluster_ip(i)], ep_id=1)
        sup.nodes[names[i]].call("policy", docs=[{
            "endpointSelector": {"matchLabels": {"app": f"svc{i}"}},
            "ingress": [{"fromEndpoints": [
                {"matchLabels": {"cluster": "mesh"}}],
                "toPorts": [{"ports": [{"port": "8080",
                                        "protocol": "TCP"}]}]}]}])
        sup.nodes[names[i]].call("regen")    # seeds the delta path

    def spot(sup, i, sport0, now):
        flows, want = cluster_flows(i, 64, sport0)
        out = sup.nodes[names[i]].call("classify", flows=flows, now=now)
        return out["allow"] == want

    def launches(sup):
        return {n: st["fused_kernels"]["launches"]
                for n, st in sup.broadcast("status").items()}

    t0 = time.perf_counter()
    sup = ClusterSupervisor(store, names, overrides=overrides,
                            datapath="torch")
    try:
        for i in range(CLUSTER_NODES):
            setup(sup, i)
        boot_s = time.perf_counter() - t0
        rounds = sup.converge(max_rounds=3 + CLUSTER_NODES)
        st = sup.broadcast("status")
        incr = {n: s["counters"].get("regen_incremental_total", 0)
                for n, s in st.items()}
        check(all(v >= 1 for v in incr.values()),
              f"cluster: the post-seed ingest was not a delta patch: {incr}")
        l0 = launches(sup)
        fps, allowed = {}, {}
        for i, n in enumerate(names):
            flows, want = cluster_flows(i, CLUSTER_ROWS, 20000)
            res = sup.nodes[n].call("serve", flows=flows,
                                    batches=CLUSTER_SERVE_BATCHES,
                                    now=5000, timeout=600.0)
            fps[n] = res["fps"]
            allowed[n] = (res["allowed"], sum(want) * CLUSTER_SERVE_BATCHES)
            check(spot(sup, i, 45000, 6000),
                  f"cluster: {n}: cross-node verdicts wrong")
        sup.broadcast("flush")
        # store partition on node-0: last-good serving, MESH_STALE, heal
        victim = names[0]
        sup.nodes[victim].call("arm", point="clustermesh.store_list",
                               spec={"mode": "fail"})
        during = []
        for _ in range(3):
            sup.broadcast("step")
            during.append(spot(sup, 0, 46000, 7000))
            time.sleep(0.45)
        st = sup.nodes[victim].call("status")
        check(all(during), "cluster: the partitioned node failed closed")
        check(st["mesh"]["state"] == "MESH_STALE"
              and st["health"]["state"] == "DEGRADED",
              f"cluster: partition: mesh {st['mesh']['state']}, health "
              f"{st['health']['state']}")
        sup.nodes[victim].call("disarm", point="clustermesh.store_list")
        sup.broadcast("step")
        st = sup.nodes[victim].call("status")
        check(st["mesh"]["state"] == "OK",
              f"cluster: MESH_STALE stuck after heal: {st['mesh']['state']}")
        rounds_heal = sup.converge(max_rounds=4)
        # kill a peer: its lease expires, its entries withdraw; restart
        dead_i = CLUSTER_NODES - 1
        dead = names[dead_i]
        sup.nodes[dead].kill()
        survivors = names[:dead_i]
        prefix = f"{cluster_ip(dead_i)}/32"
        t_kill = time.perf_counter()
        withdrawn = False
        while not withdrawn and \
                time.perf_counter() < t_kill + 2 * CLUSTER_STALE_S + 2.0:
            time.sleep(CLUSTER_STALE_S * 0.6)
            sup.broadcast("step", only=survivors)
            views = sup.views(only=survivors)
            withdrawn = all(prefix not in views[n] for n in survivors)
        withdraw_s = time.perf_counter() - t_kill
        check(withdrawn, f"cluster: {prefix} not withdrawn after the lease")
        probe = [{"src": cluster_ip(dead_i), "dst": cluster_ip(0),
                  "sport": 47001, "dport": 8080, "ep_id": 1}]
        out = sup.nodes[names[0]].call("classify", flows=probe, now=8000)
        check(not out["allow"][0], "cluster: a withdrawn pod still allowed")
        t1 = time.perf_counter()
        sup.restart(dead)
        setup(sup, dead_i)
        rounds_back = sup.converge(max_rounds=4 + CLUSTER_NODES)
        restart_s = time.perf_counter() - t1
        probe[0]["sport"] = 47002
        out = sup.nodes[names[0]].call("classify", flows=probe, now=8100)
        check(out["allow"][0], "cluster: the restarted pod not re-admitted")
        flows, _want = cluster_flows(dead_i, CLUSTER_ROWS, 30000)
        sup.nodes[dead].call("serve", flows=flows, batches=2, now=8200,
                             timeout=600.0)
        check(spot(sup, dead_i, 48000, 8300),
              f"cluster: {dead}: cross-node verdicts wrong after restart")
        sup.broadcast("flush")
        relay = FlowRelay({n: JsonlTailObserver(
            os.path.join(flows_dir, f"{n}.jsonl")) for n in names})
        merged = relay.poll(limit=1_000_000)
        seen = sorted({r.get("node") for r in merged["flows"]
                       if not r.get("gap")})
        check(seen == names, f"cluster: the relay saw {seen} of {names}")
        audits = sup.broadcast("audit", timeout=600.0)
        check(all(a["mismatched_rows"] == 0 and a["checked_rows"] > 0
                  for a in audits.values()), f"cluster: audits {audits}")
        st = sup.broadcast("status")
        lag = {n: s["mesh"]["replication_lag_p99_s"] for n, s in st.items()}
        l1 = {n: s["fused_kernels"]["launches"] for n, s in st.items()}
        for n in names:
            base = l0[n] if n != dead else {}
            for k in KERNELS:
                check(l1[n][k] > base.get(k, 0),
                      f"cluster: {n}: {k} launches {base.get(k, 0)} → "
                      f"{l1[n][k]}")
    finally:
        try:
            sup.stop_all()
        finally:
            shutil.rmtree(work, ignore_errors=True)
    note_launches(report, "cluster", {
        k: sum(l1[n][k] - (l0[n][k] if n != dead else 0) for n in names)
        for k in KERNELS})
    return lines + [
        f"cluster: {CLUSTER_NODES} node processes on {DEVICE} (CT {cap} "
        f"slots each) booted and seeded in {boot_s:.3f} s; converged in "
        f"{rounds} rounds, the post-seed ingest a delta patch on each "
        f"({json.dumps(incr)})",
        f"cluster: serve {CLUSTER_SERVE_BATCHES} batches of {CLUSTER_ROWS} "
        f"cross-node rows a node (records built in the node's Python): "
        f"flows/s {json.dumps({n: round(v, 1) for n, v in fps.items()})}, "
        f"allowed (got, want) {json.dumps(allowed)} [{card}]",
        f"cluster: partition of {victim}: served last-good in 3 of 3 "
        f"rounds, MESH_STALE past {CLUSTER_BUDGET_S} s, healed and "
        f"re-converged in {rounds_heal} rounds; {dead} killed: "
        f"{prefix} withdrawn {withdraw_s:.3f} s after the kill (lease "
        f"{CLUSTER_STALE_S} s), restarted and re-converged in "
        f"{rounds_back} rounds, {restart_s:.3f} s",
        f"cluster: relay over both flowlogs: {len(merged['flows'])} flows "
        f"from {seen}, gaps {len(merged['gaps'])}, lag "
        f"{json.dumps(merged['lag'])}",
        f"cluster: replication-lag p99 s {json.dumps(lag)}; audits "
        f"(checked, mismatched) "
        f"{json.dumps({n: (a['checked_rows'], a['mismatched_rows']) for n, a in audits.items()})}",
        f"cluster launches: {json.dumps(l1)} ({dead} counted from its "
        f"restart)"]


# --------------------------------------------------------------------------- #
# chaos: the in-process drill on the card, in a process of its own
# --------------------------------------------------------------------------- #
CHAOS_PHASES = ("regen-storm", "regen-recovery", "peer-flap",
                "pipeline-storm", "stall-storm", "breaker", "ct-restart",
                "checkpoint-corruption", "qos-enqueue-failsafe",
                "dns-poison")


def phase_chaos(card, report=None):
    """``cilium-tpu-torch faults chaos --datapath torch`` in a process of
    its own on the card: exit 0, every phase PASS, each kernel launched.
    → phase lines."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "cilium_tpu_torch.cli.main",
                        "faults", "chaos", "--datapath", "torch",
                        "--device", DEVICE, "-o", "json"],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=600)
    took = time.perf_counter() - t0
    check(r.returncode == 0, f"chaos: exit {r.returncode}: "
                             f"{r.stdout[-2000:]} {r.stderr[-2000:]}")
    doc = json.loads(r.stdout)
    phases = [p["phase"] for p in doc["phases"]]
    check(doc["ok"] and all(p["ok"] for p in doc["phases"])
          and tuple(phases) == CHAOS_PHASES,
          f"chaos: phases {doc['phases']}")
    launched = doc["launches"]
    if DEVICE == "cuda":
        for k in KERNELS:
            check(launched.get(k, 0) > 0, f"chaos: {k} never launched")
    note_launches(report, "chaos", launched)
    return [f"chaos: faults chaos --datapath torch in its own process: "
            f"rc 0 in {took:.3f} s, every phase PASS: {', '.join(phases)} "
            f"[{card}]",
            f"chaos launches: {json.dumps(launched)}"]


# --------------------------------------------------------------------------- #
# goldengen: cfg5's web endpoint through three independent classifiers
# --------------------------------------------------------------------------- #
GOLDEN_PACKETS = 256


def golden_packets(seed):
    """``GOLDEN_PACKETS`` of cfg5's packets for endpoint 1 with their
    clocks: churn rows (half as SYN; every 8th to a port no rule opens,
    every 8th from a source outside the ipcache), then some of the same
    flows again and their replies (egress from web). → [(record, now)]."""
    import dataclasses

    from cilium_tpu_torch.oracle import PacketRecord
    from cilium_tpu_torch.utils import constants as C
    from cilium_tpu_torch.world import cfg5_traffic
    next_batch, _warm = cfg5_traffic(seed + 17, PRESET == "smoke")
    b = next_batch()
    n_new = GOLDEN_PACKETS // 2 + GOLDEN_PACKETS // 4

    def addr(words):
        return b"".join(int(w).to_bytes(4, "big") for w in words)

    recs = []
    for i in range(n_new):
        flags = C.TCP_SYN if i % 2 == 0 else int(b["tcp_flags"][i])
        src, dport = addr(b["src"][i]), int(b["dport"][i])
        if i % 8 == 3:                  # a port no rule opens
            dport = 30000 + i
        elif i % 8 == 5:                # a source outside the ipcache
            src = addr((0, 0, 0xFFFF, 0xCB007100 + i))
        recs.append(PacketRecord(
            src, addr(b["dst"][i]), int(b["sport"][i]), dport,
            int(b["proto"][i]), flags, False, 1, int(b["direction"][i])))
    rest = GOLDEN_PACKETS - n_new
    for i in range(rest):
        p = recs[i]
        if i % 2 == 0:                  # the same flow again
            recs.append(dataclasses.replace(p, tcp_flags=C.TCP_ACK))
        else:                           # its reply, egress from web
            recs.append(PacketRecord(
                p.dst_addr, p.src_addr, p.dst_port, p.src_port, p.proto,
                C.TCP_ACK, False, 1, C.DIR_EGRESS))
    return [(p, 3000 + 7 * i) for i, p in enumerate(recs)]


def phase_goldengen(snap, ipcache, seed, card, report=None):
    """cfg5's web endpoint (the MapState of ``snap``, the ipcache entries
    ``ipcache``) as a goldengen scenario: ``GOLDEN_PACKETS`` of cfg5's
    packets through the port's C++ golden-vector generator, the port's
    oracle, and the classify step on the card one packet a step; all
    three must agree on allow, reason, status and remote identity.
    → phase lines."""
    import tempfile

    import numpy as np
    from cilium_tpu_torch import convert
    from cilium_tpu_torch.compile.ct_layout import CTConfig, make_ct_arrays
    from cilium_tpu_torch.kernels import fused as fk
    from cilium_tpu_torch.kernels.classify import classify_step
    from cilium_tpu_torch.kernels.records import (batch_from_records,
                                                  batch_to_torch)
    from cilium_tpu_torch.oracle import Oracle
    from cilium_tpu_torch.shim.bindings import run_goldengen, write_scenario
    from cilium_tpu_torch.utils import constants as C

    web = snap.policies[snap.ep_slot_of[1]]
    l7_sets, l7_index, entries = [], {}, []
    for d, dirpol in ((C.DIR_EGRESS, web.egress),
                      (C.DIR_INGRESS, web.ingress)):
        for key, entry in dirpol.mapstate.items():
            l7 = 0
            if entry.l7_rules is not None:
                fs = frozenset(entry.l7_rules)
                if fs not in l7_index:
                    l7_sets.append(sorted(
                        (C.HTTP_METHOD_IDS.get(h.method, 255)
                         if h.method else 255, h.path.encode())
                        for h in fs))
                    l7_index[fs] = len(l7_sets)
                l7 = l7_index[fs]
            entries.append((d, entry.deny, key.proto, key.identity,
                            key.port_lo, key.port_hi, l7))
    packets = golden_packets(seed)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-golden-") as d:
        scen, outp = os.path.join(d, "scen.bin"), os.path.join(d, "out.bin")
        t0 = time.perf_counter()
        write_scenario(scen, ipcache,
                       (web.egress.enforced, web.ingress.enforced),
                       entries, l7_sets, packets)
        golden = run_goldengen(scen, outp)
        golden_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracle = Oracle({1: web}, ipcache)
    want = [oracle.classify(p, t) for p, t in packets]
    oracle_s = time.perf_counter() - t0
    tensors = convert.snapshot_tensors_to_torch(snap.tensors(), DEVICE)
    ct = make_ct_arrays(CTConfig(capacity=1 << 16), DEVICE)
    fk.reset_launches()
    got = []
    t0 = time.perf_counter()
    for p, t in packets:
        b = batch_to_torch(batch_from_records([p], snap.ep_slot_of), DEVICE)
        out, ct, _cnt = classify_step(tensors, ct, b, t, snap.world_index,
                                      v4_only=True)
        got.append({k: int(out[k][0]) for k in
                    ("allow", "reason", "status", "remote_identity")})
    step_s = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    statuses = {}
    for i, ((p, _t), v) in enumerate(zip(packets, want)):
        g, c = golden[i], got[i]
        trio = ((bool(g.allow), int(g.reason), int(g.status),
                 int(g.remote)),
                (bool(v.allow), int(v.drop_reason), int(v.ct_status),
                 int(v.remote_identity)),
                (bool(c["allow"]), c["reason"], c["status"],
                 c["remote_identity"] & 0xFFFFFFFF))
        check(trio[0] == trio[1] == trio[2],
              f"goldengen: packet {i} {p}: goldengen {trio[0]}, oracle "
              f"{trio[1]}, card {trio[2]}")
        key = f"{'allow' if trio[0][0] else 'drop'}/{trio[0][2]}"
        statuses[key] = statuses.get(key, 0) + 1
    for k in KERNELS:
        check(launches[k] >= len(packets) or DEVICE != "cuda",
              f"goldengen: {k} launched {launches[k]} times for "
              f"{len(packets)} steps")
    note_launches(report, "goldengen", launches)
    return [f"goldengen: cfg5's web endpoint ({len(entries)} MapState "
            f"entries, {len(ipcache)} ipcache prefixes) and "
            f"{len(packets)} of cfg5's packets: goldengen (C++) "
            f"{golden_s:.3f} s with the scenario written, oracle "
            f"{oracle_s:.3f} s, the classify step one packet a step on "
            f"{DEVICE} {step_s:.3f} s (host clock); all three agree on "
            f"allow, reason, status and remote identity in every packet "
            f"(allow-or-drop/CT status counts {json.dumps(statuses)}) "
            f"[{card}]",
            f"goldengen launches: {json.dumps(launches)} for "
            f"{len(packets)} steps"]


# --------------------------------------------------------------------------- #
# phase ddos: cfg6's drop storm
# --------------------------------------------------------------------------- #
#: cfg6 at each preset (``bench.py:865`` ``ddos_bench``): CT slots, batch
#: rows, flood batches an iteration (cap/2 rows), iterations held at
#: SHED-NEW, the iteration cap, and the legit batches of the pre/post
#: throughput windows and of each of the attestation's four windows. The
#: full preset sizes the CT to Cilium's default ``bpf-ct-global-tcp-max``
#: (524,288) and the batch to cfg5's; smoke is the reference's own.
DDOS = {"full": dict(cap=1 << 19, batch=1 << 16, flood=4, hold=20,
                     max_iters=120, fps=24, attest=24),
        "smoke": dict(cap=1 << 13, batch=256, flood=11, hold=8,
                      max_iters=48, fps=12, attest=12)}
#: the web endpoint's address (192.168.0.10) as its low word
DDOS_WEB = 0xC0A8000A
#: post-storm flows/s must keep this share of pre-storm (``bench.py``'s
#: own gate asks 1/1.2 of its CPU and TPU runs), each the median of
#: DDOS_FPS_WINDOWS windows: one window's flows/s on the card spreads by
#: ±20% with the host's load
DDOS_POST_RATIO = 0.8
DDOS_FPS_WINDOWS = 3


def ddos_params(smoke):
    return DDOS["smoke" if smoke else "full"]


def ddos_config(smoke):
    """``bench.py:905-920``'s ``DaemonConfig`` fields for cfg6, the GC
    chunk at cap/8 as there (both packages take them)."""
    p = ddos_params(smoke)
    return dict(ct_capacity=p["cap"], auto_regen=False,
                batch_size=p["batch"], pipeline_flush_ms=0.5,
                pipeline_queue_batches=16, pipeline_block_timeout_s=0.05,
                audit_enabled=True, audit_sample_rate=1.0,
                audit_pool_batches=64, audit_max_rows=512,
                flowlog_mode="none", ct_gc_chunk_rows=p["cap"] // 8,
                ct_gc_emergency_chunks=8, ct_gc_emergency_ttl_slash_s=56,
                ct_pressure_high=0.8, ct_pressure_low=0.5,
                overload_up_ticks=1, overload_down_ticks=4,
                overload_shed_rate_high=15.0, overload_shed_rate_low=2.0,
                overload_interval_s=0.1)


def ddos_world(eng):
    """cfg6's policy world: legit clients (172.16/16) on 443, port 80 open
    to 10/8 (the flood's CT filler), ingress enforced."""
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.0.10",), ep_id=1)
    eng.apply_policy([
        {"endpointSelector": {"matchLabels": {"app": "web"}},
         "ingress": [{"fromCIDR": ["172.16.0.0/16"],
                      "toPorts": [{"ports": [
                          {"port": "443", "protocol": "TCP"}]}]}]},
        {"endpointSelector": {"matchLabels": {"app": "web"}},
         "ingress": [{"fromCIDR": ["10.0.0.0/8"],
                      "toPorts": [{"ports": [
                          {"port": "80", "protocol": "TCP"}]}]}]}])
    eng.regenerate()
    return eng


def ddos_base(empty_batch, n):
    b = empty_batch(n)
    b["src"][:, 2] = 0xFFFF
    b["dst"][:, 2] = 0xFFFF
    b["dst"][:, 3] = DDOS_WEB
    b["proto"][:] = 6
    b["direction"][:] = 1
    b["valid"][:] = True
    return b


def ddos_legit(empty_batch, n):
    """``n`` legit flows 172.16/16 → web:443 with ACK (established, the
    protected class), ``_prio`` 0: the reference's addresses and ports at
    its 256 rows; past 64,000 rows a source repeats on another port."""
    import numpy as np
    b = ddos_base(empty_batch, n)
    i = np.arange(n)
    b["src"][:, 3] = (0xAC100000 + i % 250 + 1
                      + (((i // 250) % 256) << 8)).astype(np.uint32)
    b["sport"][:] = 40000 + i % 25536
    b["dport"][:] = 443
    b["tcp_flags"][:] = 0x10
    b["_prio"] = np.zeros((n,), np.int8)
    return b


def ddos_flood(empty_batch, rng, n):
    """One flood batch, drawn as ``bench.py``'s: 40% junk from 203/8
    (unknown identities → POLICY drops) to random ports, 60% SYNs from
    random 10/8 sources to port 80 (allowed: the CT filler); ``_prio``
    1."""
    import numpy as np
    b = ddos_base(empty_batch, n)
    junk = rng.random(n) < 0.4
    b["src"][:, 3] = np.where(
        junk, 0xCB000000 + rng.integers(0, 1 << 20, n),
        0x0A000000 + rng.integers(1, 1 << 24, n)).astype(np.uint32)
    b["sport"][:] = rng.integers(1024, 65535, n)
    b["dport"][:] = np.where(junk, rng.integers(1, 65535, n), 80)
    b["tcp_flags"][:] = 0x02
    b["_prio"] = np.ones((n,), np.int8)
    return b


class Harvester:
    """The shim feeder's role at harvest, as ``bench.py``'s cfg6 plays it:
    carries the harvest-shed counters the overload controller folds into
    its shed signal, and receives the ladder's level."""

    def __init__(self):
        self.prio_shed_rows = self.prio_shed_batches = self.level = 0

    def set_overload_state(self, level):
        self.level = int(level)

    def stats(self):
        return {"alive": True, "pending": 0, "pool_free": 0,
                "prio_shed_rows": self.prio_shed_rows,
                "prio_shed_batches": self.prio_shed_batches,
                "overload_level": self.level}

    def stop(self, timeout=0.0):
        pass


class DrainGate:
    """Paces the pipeline worker's dispatches by wrapping the datapath's
    ``classify_async``: open, every dispatch passes; shut, each waits for
    a permit. ``settle`` then waits until the worker waits at the gate
    with no permit left, or has nothing left to dispatch. So the flood of
    an ingest-bound storm (one that arrives faster than the device drains
    it, ``bench.py``'s phase 1b) backs the admission queue up by the same
    count on every run, whatever the wall clock, and the queue an
    ``overload_step`` reads is the same too."""

    def __init__(self, dp):
        import threading
        self.cond = threading.Condition()
        self.shut = False
        self.permits = self.arrived = self.passed = self.waiting = 0
        self._real = dp.classify_async
        dp.classify_async = self.classify_async

    def classify_async(self, *args, **kw):
        with self.cond:
            self.arrived += 1
            self.waiting += 1
            self.cond.notify_all()
            while self.shut and self.permits == 0:
                self.cond.wait()
            self.waiting -= 1
            if self.shut:
                self.permits -= 1
        try:
            return self._real(*args, **kw)
        finally:
            with self.cond:
                self.passed += 1
                self.cond.notify_all()

    def set(self, shut, permits=0):
        with self.cond:
            self.shut, self.permits = shut, permits
            self.cond.notify_all()

    def settle(self, admitted, timeout=300.0):
        """Wait until the worker is parked at the shut gate with no permit
        left, or all ``admitted`` dispatches have passed; unused permits
        are taken back."""
        deadline = time.monotonic() + timeout
        with self.cond:
            while True:
                parked = self.shut and self.permits == 0 and self.waiting
                if parked or self.passed == self.arrived == admitted:
                    self.permits = 0
                    return
                left = deadline - time.monotonic()
                check(left > 0, f"ddos: the pipeline worker did not settle "
                                f"({self.arrived} arrived, {self.passed} "
                                f"passed, {admitted} admitted)")
                self.cond.wait(min(left, 0.05))


def ddos_storm(eng, pkg, smoke, seed, profile_plateau=None, at_plateau=None,
               own=None, window=None):
    """``bench.py``'s cfg6 drop storm (``ddos_bench``) on ``eng``, an
    engine of ``ddos_config`` and ``ddos_world``, in logical time (manual
    ``overload_step``/``sweep_step``/``resource_step`` ticks). ``pkg``
    carries the engine's package's ``empty_batch``, ``shed_new_rows`` and
    ``OVERLOAD_SHED_NEW``.

    Phases: establish the legit population and measure pre-storm flows/s;
    the ledger-overhead attestation (disarmed/armed windows); 1a, the
    flood fully served each iteration until the CT has held past
    ``ct_pressure_high`` for 4 iterations; 1b, the ingest storm: the
    pipeline worker is let through ``flood // 2 + 1`` dispatches an
    iteration (``DrainGate``), so the queue backs up, the ladder climbs to
    SHED-NEW and the flood is then shed at harvest (``shed_new_rows``),
    held ``hold`` iterations; recovery until level 0 and occupancy <=
    ``ct_pressure_low``; post-storm flows/s (each throughput the median of
    ``DDOS_FPS_WINDOWS`` windows). Floods carry no deadline
    (``bench.py`` gives 1b's 200 ms, a shed that depends on the wall
    clock), and the overload controller reads its shed rate per logical
    second (one an iteration). ``profile_plateau(run)`` runs one
    saturated iteration of 1a (``run``) under a profiler;
    ``at_plateau(eng, now)`` is called once at the end of 1a with the
    pipeline drained; ``own(batch)`` sees every batch before it is
    submitted; ``window(label, edge)`` is called where the pre-storm
    ("pre") and post-storm ("post") flows/s windows start and end (``edge``
    "start" or "end"), the pipeline drained at each.

    → a result dict. ``trace`` holds one record an iteration of the
    wall-clock-free fields (the ladder's level, queue fraction and ct /
    queue / resource latches, CT occupancy, emergency mode, forecast,
    flood counts, dispatches; CT and legit counters where the pipeline is
    drained); latencies, flows/s, the attestation, the ladder's dwell
    seconds and the audit's counts depend on the wall clock."""
    import numpy as np
    p = ddos_params(smoke)
    cfg = eng.config
    own = own or (lambda b: b)
    window = window or (lambda label, edge: None)
    n, flood = p["batch"], p["flood"]
    drain_per_iter = flood // 2 + 1
    harvester = Harvester()
    eng._feeder = harvester
    gate = DrainGate(eng.datapath)
    rng = np.random.default_rng(5 + seed)
    shed_new = pkg.OVERLOAD_SHED_NEW
    L = [50_000]
    admitted = [0]
    survival = {"rows": 0, "allowed": 0}
    legit_ms, pending = [], []
    trace = []
    counts = {"sent": 0, "dropped": 0, "harvest_shed": 0}

    def overload_tick():
        # the controller reads sheds per second since its last tick: the
        # stamp set one second back makes that sheds per logical second
        eng._overload_shed_t = time.monotonic() - 1.0
        return eng.overload_step()

    def submit(b, deadline_ms=None):
        t = eng.submit(own(b), now=L[0], deadline_ms=deadline_ms)
        if t.dropped:
            return None
        admitted[0] += 1
        return t

    def admitted_dispatches():
        shed = eng.pipeline_stats()["shed_reasons"]
        return admitted[0] - sum(shed.values())

    def submit_legit():
        t0 = time.perf_counter()
        t = submit(ddos_legit(pkg.empty_batch, n))
        if t is None:
            survival["rows"] += n     # a refused batch: 0 allowed
        else:
            pending.append((t, t0))

    def pump_legit(block):
        rest = []
        for t, t0 in pending:
            if not block and not t.done():
                rest.append((t, t0))
                continue
            try:
                out = t.result(timeout=300)
                survival["allowed"] += int(np.asarray(out["allow"]).sum())
            except Exception:
                pass
            survival["rows"] += n
            legit_ms.append((time.perf_counter() - t0) * 1e3)
        pending[:] = rest

    def run_legit(count):
        for _ in range(count):
            submit_legit()
        pump_legit(True)

    def fps_of(count, label):
        """Legit flows/s: the median of ``DDOS_FPS_WINDOWS`` windows of
        ``count`` batches each. → (median, every window's)."""
        rates = []
        window(label, "start")
        for _ in range(DDOS_FPS_WINDOWS):
            t0 = time.perf_counter()
            run_legit(count)
            rates.append(count * n / max(time.perf_counter() - t0, 1e-9))
        window(label, "end")
        return float(np.median(rates)), rates

    ledger = {"mismatches": 0, "forecast_iter": None}

    def poll_ledger(it):
        row = eng.resource_step(now=float(L[0]))["resources"].get("ct_table")
        gauge = float(eng.metrics.gauges.get("ct_occupancy", 0.0))
        if row is None or row["pressure"] != gauge:
            ledger["mismatches"] += 1
        if ledger["forecast_iter"] is None and row is not None \
                and row["forecast"]:
            ledger["forecast_iter"] = it
        return bool(row and row["forecast"])

    def record(phase, it, st, drained):
        occ = float(eng.metrics.gauges.get("ct_occupancy", 0.0))
        rec = {"phase": phase, "it": it, "now": L[0], "level": st["level"],
               "queue_frac": st["inputs"]["queue_frac"],
               "lit": st["lit"],
               "ct_occupancy": occ, "emergency": bool(eng._ct_emergency),
               "forecast": poll_ledger(it), "dispatches": gate.passed,
               **counts}
        if drained:
            rec.update(evicted=eng.metrics.ct_evicted,
                       ct_full=eng.metrics.insert_fail,
                       legit_rows=survival["rows"],
                       legit_allowed=survival["allowed"])
        trace.append(rec)
        return occ

    # phase 0: establish the legit flows, pre-storm flows/s
    run_legit(2)
    L[0] += 1
    run_legit(2)
    legit_ms.clear()
    pre_fps, pre_windows = fps_of(p["fps"], "pre")
    overload_tick()

    # the ledger-overhead attestation (bench.py's D/A/D/A windows)
    att = {"off": [], "on": []}
    poll_s = armed_s = 0.0
    for mode in ("off", "on", "off", "on"):
        t0 = time.perf_counter()
        for i in range(p["attest"]):
            run_legit(1)
            if mode == "on" and i % 12 == 11:
                p0 = time.perf_counter()
                eng.resource_step(now=float(L[0]))
                poll_s += time.perf_counter() - p0
        dt = max(time.perf_counter() - t0, 1e-9)
        att[mode].append(p["attest"] * n / dt)
        if mode == "on":
            armed_s += dt
    overhead_pct = 100.0 * poll_s / max(armed_s, 1e-9)
    attestation = {"fps_disarmed": float(np.mean(att["off"])),
                   "fps_armed": float(np.mean(att["on"])),
                   "poll_s": poll_s, "armed_serving_s": armed_s,
                   "overhead_pct": overhead_pct, "budget_pct": 2.0,
                   "ok": overhead_pct < 2.0}
    legit_ms.clear()

    # 1a: the flood fully served each iteration until the table saturates
    max_level = it = sat_hold = 0
    storm_t0 = time.perf_counter()
    storm_rows = 0
    profiled = None

    def one_1a():
        for _ in range(flood):
            if submit(ddos_flood(pkg.empty_batch, rng, n), 0) is None:
                counts["dropped"] += 1
            else:
                counts["sent"] += 1
        run_legit(1)

    while it < p["max_iters"] // 2 and sat_hold < 4:
        it += 1
        L[0] += 1
        if profile_plateau is not None and profiled is None and sat_hold:
            profiled = profile_plateau(one_1a)
        else:
            one_1a()
        storm_rows += (flood + 1) * n
        st = overload_tick()
        max_level = max(max_level, st["level"])
        eng.sweep_step(now=L[0])
        eng.audit_step(budget=16)
        if record("1a", it, st, True) >= cfg.ct_pressure_high:
            sat_hold += 1
    check(eng.drain(timeout=300), "ddos: the pipeline did not drain")
    if at_plateau is not None:
        at_plateau(eng, L[0])

    # 1b: the ingest storm, the worker let through drain_per_iter
    # dispatches an iteration
    shed_new_iters = 0
    shed_new_iter = None
    gate.set(shut=True)
    while it < p["max_iters"] and shed_new_iters < p["hold"]:
        it += 1
        L[0] += 1
        level = harvester.level
        max_level = max(max_level, level)
        for _ in range(flood):
            fb = ddos_flood(pkg.empty_batch, rng, n)
            storm_rows += n
            if level >= shed_new:
                shed = pkg.shed_new_rows(fb)
                harvester.prio_shed_rows += shed
                harvester.prio_shed_batches += 1
                counts["harvest_shed"] += shed
                continue
            if submit(fb) is None:
                counts["dropped"] += 1
            else:
                counts["sent"] += 1
        submit_legit()
        storm_rows += n
        gate.settle(admitted_dispatches())
        st = overload_tick()
        if st["level"] >= shed_new:
            shed_new_iters += 1
            if shed_new_iter is None:
                shed_new_iter = it
        gate.set(shut=True, permits=drain_per_iter)
        gate.settle(admitted_dispatches())
        pump_legit(False)
        eng.sweep_step(now=L[0])
        eng.audit_step(budget=16)
        record("1b", it, st, False)
    gate.set(shut=False)
    check(eng.drain(timeout=300), "ddos: the pipeline did not drain")
    pump_legit(True)
    storm_s = max(time.perf_counter() - storm_t0, 1e-9)
    occ_all = [r["ct_occupancy"] for r in trace]
    occ_peak, occ_late = max(occ_all), occ_all[-1]
    trace.append({"phase": "1b-end", "it": it, "now": L[0],
                  "evicted": eng.metrics.ct_evicted,
                  "ct_full": eng.metrics.insert_fail,
                  "legit_rows": survival["rows"],
                  "legit_allowed": survival["allowed"],
                  "dispatches": gate.passed, **counts})

    # recovery
    for _ in range(80):
        L[0] += 2
        run_legit(1)
        st = overload_tick()
        eng.sweep_step(now=L[0])
        it += 1
        occ = record("recover", it, st, True)
        if st["level"] == 0 and occ <= cfg.ct_pressure_low:
            break
    occ_final = float(eng.metrics.gauges.get("ct_occupancy", 0.0))
    post_fps, post_windows = fps_of(p["fps"], "post")
    ladder = eng.overload_status() or {}
    check(eng.drain(timeout=300), "ddos: the pipeline did not drain")
    for _ in range(200):
        step = eng.audit_step(budget=128)
        if not step or not (step.get("replayed") or step.get("pending")):
            break
    eng._feeder = None
    levels = [r["level"] for r in trace if "level" in r]
    return {
        "trace": trace, "iterations": it, "shed_new_iter": shed_new_iter,
        "forecast_iter": ledger["forecast_iter"],
        "ct_track_mismatches": ledger["mismatches"],
        "survival": survival["allowed"] / max(1, survival["rows"]),
        "legit_rows": survival["rows"], "legit_ms": legit_ms,
        "max_level": max_level, "occ_peak": occ_peak, "occ_late": occ_late,
        "occ_final": occ_final, "occ_trajectory": occ_all,
        "evicted": eng.metrics.ct_evicted,
        "ct_full": eng.metrics.insert_fail, "audit": eng.auditor.stats(),
        "pre_fps": pre_fps, "storm_fps": storm_rows / storm_s,
        "post_fps": post_fps, "fps_windows": (pre_windows, post_windows),
        "attestation": attestation,
        "dwell_iters": {lv: levels.count(lv) for lv in sorted(set(levels))},
        "dwell_s": ladder.get("dwell_s"), "dispatches": gate.passed,
        "drain_per_iter": drain_per_iter, "profiled": profiled, **counts}


def ddos_gate(res, cfg, shed_new):
    """``bench.py:1241-1283``'s cfg6 gate, the post-storm share at
    ``DDOS_POST_RATIO``. → the reasons it fails."""
    why = []
    if res["survival"] < 0.99:
        why.append(f"established-flow survival {res['survival']:.4f} < 0.99")
    if res["audit"]["mismatched_rows"] or not res["audit"]["checked_rows"]:
        why.append(f"audit {res['audit']}")
    if res["max_level"] < shed_new:
        why.append(f"ladder never reached SHED-NEW (max {res['max_level']})")
    if res["occ_peak"] < cfg.ct_pressure_high:
        why.append(f"peak occupancy {res['occ_peak']} < "
                   f"{cfg.ct_pressure_high}")
    if res["occ_late"] >= 0.995:
        why.append(f"occupancy at storm end {res['occ_late']} >= 0.995")
    if res["occ_final"] > cfg.ct_pressure_low:
        why.append(f"final occupancy {res['occ_final']} > "
                   f"{cfg.ct_pressure_low}")
    if not res["evicted"]:
        why.append("no CT tail-evictions")
    ratio = res["post_fps"] / max(res["pre_fps"], 1e-9)
    if ratio < DDOS_POST_RATIO:
        why.append(f"post-storm flows/s {res['post_fps']:.0f} vs pre-storm "
                   f"{res['pre_fps']:.0f} (ratio {ratio:.3f} < "
                   f"{DDOS_POST_RATIO})")
    if res["ct_track_mismatches"]:
        why.append(f"ct_table row != ct_occupancy on "
                   f"{res['ct_track_mismatches']} polls")
    fi, si = res["forecast_iter"], res["shed_new_iter"]
    if fi is None or (si is not None and fi >= si):
        why.append(f"forecast at iteration {fi}, SHED-NEW at {si}")
    if not res["attestation"]["ok"]:
        why.append(f"ledger polling {res['attestation']['overhead_pct']:.2f}"
                   f"% > 2% of armed serving time")
    return why


def gc_windows(summary):
    """From ``DispatchLog.summary()``: each window's step host ms median,
    its dispatches, the GC pause host ms and collections by generation
    over it, and the tracked objects (all, and gen 2) at its start and
    end. → {window: {...}}."""
    res = {}
    for lb, w in summary.items():
        med, cnt = w["median_ms"], w["counters"]
        res[lb] = {
            "step_ms": med.get("step"), "dispatches": med.get("dispatches"),
            "pause_ms": [round(cnt.get(f"gc.pause_ms.gen{g}", 0.0), 3)
                         for g in range(3)],
            "collections": [cnt.get(f"gc.collections.gen{g}", 0)
                            for g in range(3)],
            "objects": [w["probe"][e].get("gc.objects")
                        for e in ("start", "end")],
            "objects_gen2": [w["probe"][e].get("gc.objects.gen2")
                             for e in ("start", "end")]}
    return res


def object_census():
    """The objects Python's GC tracks, counted by type name (outside any
    window: it walks every one of them)."""
    import gc
    from collections import Counter
    return Counter(type(o).__name__ for o in gc.get_objects())


def census_rise(before, after, top=12):
    """The ``top`` type names whose tracked objects rose most from
    ``before`` to ``after``. → {name: rise}."""
    rise = after.copy()
    rise.subtract(before)
    return dict(rise.most_common(top))


def phase_ddos(seed, card, report=None, profile=False):
    """cfg6's drop storm through the port's ``Engine`` → pipeline →
    ``TorchDatapath`` on the card (``ddos_storm``), the CT at Cilium's
    default size: the reference's gate, every dispatch and GC tick
    replayed on a plain datapath, K1/K2/K3 launched once a dispatch, and
    K2 timed on the host at the saturated table (its device times in
    phase profile, which keeps the table); with ``profile`` one plateau
    iteration under ``torch.profiler`` (K2's ``path_ms``, the device's
    busy share), which leaves every later launch of the process slower
    on the host, the post-storm window's included, so the gate's share
    then reads the profiler too. At the post-storm window's start the
    dispatch log is replayed and dropped, and a full GC collection frees
    what the storm left in cycles (the profiler's events among them).
    → phase lines."""
    host_bound("phase ddos")
    import gc
    from types import SimpleNamespace

    import numpy as np
    import torch
    from cilium_tpu_torch.compile.ct_layout import CT_FIELDS, KEY_WORDS
    from cilium_tpu_torch.kernels import fused as fk
    from cilium_tpu_torch.kernels.conntrack import (ct_insert_new,
                                                    ct_key_words_pair,
                                                    reverse_key_words)
    from cilium_tpu_torch.kernels.records import batch_to_torch, empty_batch
    from cilium_tpu_torch.pipeline.guard import OVERLOAD_SHED_NEW
    from cilium_tpu_torch.runtime import DaemonConfig, Engine
    from cilium_tpu_torch.runtime.datapath import TorchDatapath
    from cilium_tpu_torch.shim.feeder import shed_new_rows

    smoke = PRESET == "smoke"
    p = ddos_params(smoke)
    cfg = DaemonConfig(device=DEVICE, **ddos_config(smoke))
    eng = ddos_world(Engine(cfg, datapath=TorchDatapath(cfg)))
    ct_bytes = cfg.ct_capacity * (KEY_WORDS + len(CT_FIELDS) - 1) * 4
    lines = [f"ddos: cfg6 at CT {cfg.ct_capacity} slots ({ct_bytes} bytes: "
             f"{KEY_WORDS} key words and {len(CT_FIELDS) - 1} words a slot, "
             f"ct_layout), batch {cfg.batch_size}, {p['flood']} flood "
             f"batches an iteration, GC chunk {cfg.ct_gc_chunk_rows} x "
             f"{cfg.ct_gc_emergency_chunks} in emergency, TTL slash "
             f"{cfg.ct_gc_emergency_ttl_slash_s} s"]
    dp = eng.datapath
    log = DispatchLog(dp)
    worker_timers(eng, log)
    replay = PlainReplay(cfg)
    first_replay = {}

    census = {}

    def window(label, edge):
        if (label, edge) == ("post", "start"):
            # the dispatches so far replayed and dropped: the post-storm
            # window runs without the log's copies of the storm's batches
            t1 = time.perf_counter()
            replay.feed(log)
            first_replay.update(s=time.perf_counter() - t1,
                                steps=replay.n_steps)
            census["freed"] = gc.collect()
            census["post"] = object_census()
        log.window(label, edge)
        if (label, edge) == ("pre", "end"):
            census["pre"] = object_census()
    pkg = SimpleNamespace(empty_batch=empty_batch,
                          shed_new_rows=shed_new_rows,
                          OVERLOAD_SHED_NEW=OVERLOAD_SHED_NEW)
    sym = KERNELS["ct_probe_pair_fused"][2]
    plateau = {}

    def profile_plateau(run):
        torch.cuda.synchronize()
        with profiler_session("ddos plateau") as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ops = [e for e in prof.key_averages()
               if e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in ops) / 1e6
        return kernel_device_ms(ops, sym) + (busy / wall,)

    def at_plateau(e, now):
        plateau["ct"] = {k: v.clone() for k, v in e.datapath._cts[0].items()}
        plateau["occ"] = float(e.metrics.gauges.get("ct_occupancy", 0.0))
        plateau["now"] = now

    fk.reset_launches()
    t0 = time.perf_counter()
    res = ddos_storm(eng, pkg, smoke, seed,
                     profile_plateau if profile else None, at_plateau,
                     own=log.own, window=window)
    enqueue = log.summary()
    storm_s = time.perf_counter() - t0 - first_replay["s"]
    launches = dict(fk.LAUNCHES)
    dispatched = log.steps()
    check(dispatched == res["dispatches"],
          f"ddos: {dispatched} dispatches logged, {res['dispatches']} "
          f"through the gate")
    for name, k in launches.items():
        check(k == dispatched, f"ddos: {name} launched {k} times for "
                               f"{dispatched} dispatches")
    why = ddos_gate(res, cfg, OVERLOAD_SHED_NEW)
    check(not why, f"ddos: the cfg6 gate failed: {why}; the worker by "
                   f"window {json.dumps(enqueue)}")

    # K2 at the saturated table: flood keys, a table at the plateau
    rng = np.random.default_rng(seed + 7)
    fb = ddos_flood(empty_batch, rng, p["batch"])
    fwd = ct_key_words_pair(batch_to_torch(fb, DEVICE))[0]
    rev = reverse_key_words(fwd)
    ct, now = plateau["ct"], plateau["now"]
    pargs = (ct, fwd, rev, now, 8)
    got = fk.ct_probe_pair_fused(*pargs)
    want = fk.ct_probe_pair_plain(*pargs)
    err = max_abs_err(got, want)
    check(err == 0, f"ddos: K2 at the saturated table != plain (err {err})")
    host_bound("phase ddos: K2 host_ms at the saturated table")
    host = host_ms(lambda: fk.ct_probe_pair_fused(*pargs))
    plain_ms = cuda_ms(lambda: fk.ct_probe_pair_plain(*pargs), 10)
    nbytes = ct_probe_bytes(ct, fwd, rev, now, 8)
    path_n, path_ms, busy = res.get("profiled") or (0, None, None)
    entry = dict(max_abs_err=err, ms=None, hot_ms=None, host_ms=host,
                 path_ms=path_ms, plain_ms=plain_ms,
                 bound_ms=bound_ms(nbytes), occupancy=plateau["occ"])
    defer_device_times("ct_probe_pair_fused cfg6_saturated", entry,
                       lambda: fk.ct_probe_pair_fused(*pargs), sym, nbytes,
                       card)
    if report is not None:
        report["ct_probe_pair_fused"]["cfg6_saturated"] = entry
        note_launches(report, "ddos", launches)
    hits = int((got[0] >= 0).sum())

    # the eviction round under the heaviest contention: the flood batch's
    # insert into the saturated table, on the card and on the CPU
    ins = [ct_insert_new({k: v.to(dev) for k, v in ct.items()}, fwd.to(dev),
                         torch.ones(fwd.shape[0], dtype=torch.bool,
                                    device=dev), now, 8, evict=True)
           for dev in (DEVICE, "cpu")]
    for name, a, b in zip(("new_keys", "new_created", "zero_mask", "slot",
                           "fail", "n_evicted"), *ins):
        check(torch.equal(a.cpu(), b), f"ddos: the saturated insert's {name}"
                                       f" differs between {DEVICE} and cpu")
    evicted_now, failed_now = int(ins[1][5]), int(ins[1][4].sum())
    del ins

    # every dispatch and GC tick since the post-storm window's start
    # against the plain path, then the CT
    t1 = time.perf_counter()
    replay.feed(log)
    plain, n_steps, n_gc = replay.plain, replay.n_steps, replay.n_gc
    want_ct, got_ct = eng.ct_arrays(), plain.ct_arrays()
    for k in want_ct:
        check(np.array_equal(want_ct[k], got_ct[k]),
              f"ddos: CT {k} differs from the plain path")
    replay_s = time.perf_counter() - t1
    eng.stop()

    r = res
    lat = np.asarray(r["legit_ms"]) if r["legit_ms"] else np.zeros(1)
    traj = r["occ_trajectory"]
    names = ("ok", "pressure", "overload", "shed-new")
    return lines + [
        f"ddos: {r['iterations']} iterations in {storm_s:.3f} s; survival "
        f"{r['survival']:.6f} of {r['legit_rows']} legit rows; legit p50 "
        f"{np.percentile(lat, 50):.3f} ms p99 {np.percentile(lat, 99):.3f} "
        f"ms [{card}]",
        f"ddos: occupancy peak {r['occ_peak']:.6f}, at storm end "
        f"{r['occ_late']:.6f}, final {r['occ_final']:.6f}; trajectory "
        f"(every 4th) {[round(x, 4) for x in traj[::4]]} [{card}]",
        f"ddos: ladder max level {r['max_level']}, SHED-NEW at iteration "
        f"{r['shed_new_iter']}, forecast at {r['forecast_iter']}; dwell "
        f"iterations " + json.dumps({names[k]: v for k, v in
                                     r['dwell_iters'].items()}) +
        f", dwell s {json.dumps(r['dwell_s'])} [{card}]",
        f"ddos: evicted {r['evicted']}, CT_FULL {r['ct_full']}; flood "
        f"sent {r['sent']}, refused {r['dropped']}, shed at harvest "
        f"{r['harvest_shed']} rows; the worker let through "
        f"{r['drain_per_iter']} dispatches an ingest-storm iteration "
        f"[{card}]",
        f"ddos: flows/s pre-storm {r['pre_fps']:.0f} (windows "
        f"{[round(x) for x in r['fps_windows'][0]]}), storm "
        f"{r['storm_fps']:.0f}, post-storm {r['post_fps']:.0f} (windows "
        f"{[round(x) for x in r['fps_windows'][1]]}; ratio "
        f"{r['post_fps'] / max(r['pre_fps'], 1e-9):.4f}); attestation "
        f"{json.dumps(r['attestation'])} [{card}]",
        f"ddos: audit {json.dumps(r['audit'])}",
        f"ddos: the worker by window (host ms medians of classify_async, "
        f"its parts and its finalize, of the engine's dispatch and finalize"
        f" and of the finalize's folds; the change over the window of each "
        f"thread's CPU seconds and the allocators' counters):"
        f" {json.dumps(enqueue)} [{card}]",
        f"ddos: GC by window (the step's host ms median; GC pause host ms"
        f" and collections by generation over the window; tracked objects "
        f"at its edges): {json.dumps(gc_windows(enqueue))} [{card}]",
        f"ddos: a full GC collection at the post-storm window's start "
        f"freed {census['freed']} objects; tracked objects by type then, "
        f"against the pre-storm window's end (the 12 largest rises; the "
        f"plateau profiled: {profile}): "
        f"{json.dumps(census_rise(census['pre'], census['post']))}",
        f"ddos: K2 at the saturated table (occupancy {plateau['occ']:.4f},"
        f" {hits} of {fwd.shape[0]} flood keys hit) exact, "
        f"host_ms={host:.6f} path_ms="
        f"{path_ms if path_ms is None else round(path_ms, 6)} "
        f"({path_n} launches profiled, device busy "
        f"{busy if busy is None else round(busy, 4)}) plain_ms="
        f"{plain_ms:.6f} bytes={nbytes} bound_ms={bound_ms(nbytes):.6f} "
        f"[{card}]",
        f"ddos: the same flood batch's insert into that table (evicting): "
        f"{evicted_now} evictions, {failed_now} CT_FULL; slots, fails, keys "
        f"and stamps equal on {DEVICE} and on the CPU",
        f"ddos: {n_steps} dispatches and {n_gc} GC ticks replayed on a "
        f"plain TorchDatapath, the {first_replay['steps']} before the "
        f"post-storm window at its start ({first_replay['s']:.3f} s, not in "
        f"the storm's seconds), the rest at the end ({replay_s:.3f} s): "
        f"every out column, counter, GC result and the CT arrays equal",
        f"ddos launches: {json.dumps(launches)} for {dispatched} "
        f"dispatches"]


# --------------------------------------------------------------------------- #
# profile: every profiled measurement, after every host-bound phase
# --------------------------------------------------------------------------- #
def phase_profile(seed, card, report):
    """The device times put off by the phases before (``DEFERRED``: the
    kernels' cold and hot times, ``--profile``'s op tables), then
    ``serve_profile``. → phase lines."""
    import torch
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device=DEVICE)
    lines = []
    while DEFERRED:
        _label, job = DEFERRED.pop(0)
        lines += job(flush)
    del flush
    return lines + serve_profile(seed, card, report)


def serve_profile(seed, card, report):
    """cfg5 built through the engine as phase serve builds it: 2 warm
    batches, then 4 pipelined under the profiler (``profile_serve``: each
    kernel seen on the device by name, the device's busy share), every
    dispatch and the CT held against a plain replay; then its snapshot
    placed on a ``TorchDatapath`` of each geometry of ``MESH_CONFIGS``,
    one warm batch and 2 under the profiler (``mesh_profile``: each
    kernel's device ms per launch into the report's ``mesh_ms``).
    → phase lines."""
    import dataclasses

    import numpy as np
    import torch
    from cilium_tpu_torch.runtime.datapath import TorchDatapath
    from cilium_tpu_torch.world import cfg5_traffic
    eng, cfg, build_s = serve_engine()
    next_batch, _warm = cfg5_traffic(seed, PRESET == "smoke")
    log = DispatchLog(eng.datapath)
    clock = [90_000]

    def tick():
        clock[0] += 1
        return clock[0]
    for _ in range(2):
        eng.submit(log.own(next_batch()), now=tick()).result(timeout=300)
    lines = [f"profile: cfg5 built through the engine again in "
             f"{build_s:.3f} s (host CPU)"]
    lines += profile_serve(eng, log, next_batch, tick, card)
    plain, n_steps, _n_gc = replay_plain(log, cfg)
    want, got = eng.ct_arrays(), plain.ct_arrays()
    for k in want:
        check(np.array_equal(want[k], got[k]),
              f"profile: serve's CT {k} differs from the plain path")
    lines.append(f"profile: serve's {n_steps} dispatches replayed on a plain"
                 f" TorchDatapath: every out column, counter and the CT "
                 f"arrays equal")
    snap = eng.active.snapshot
    eng.stop()
    del eng, log, plain, want, got
    mesh_next, _warm = cfg5_traffic(seed + 7, PRESET == "smoke")
    batches = [mesh_next() for _ in range(3)]
    for key, label, fields in MESH_CONFIGS:
        dp = TorchDatapath(dataclasses.replace(cfg, **fields))
        placed = dp.place(snap)
        dp.classify(placed, snap, {k: v.copy() for k, v in
                                   batches[0].items()}, 80_000)
        line, ms = mesh_profile(dp, placed, snap, batches[1:], 80_001, card,
                                f"{key} ({label})")
        lines.append(line)
        for k in report:
            report[k].setdefault("mesh_ms", {})[key] = ms[k]
        del dp, placed
        torch.cuda.empty_cache()
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print each phase's device time by op (in "
                         "phase ddos a plateau iteration, whose profiler "
                         "slows every later launch of the process on the "
                         "host: the host-bound phases then run after it, "
                         "and say so)")
    args = ap.parse_args(argv)
    global PROFILED_RUN
    PROFILED_RUN = args.profile
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from cilium_tpu_torch.kernels import _build
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

        report = {k: {"name": k, "route": "cuda", "source": src,
                      "replaces": rep, "launches": 0, "max_abs_err": None,
                      "ms": None, "plain_ms": None, "bound_ms": None,
                      "bound_by": "bytes", "library_ms": None,
                      "hot_ms": None, "host_ms": None, "path_ms": None}
                  for k, (src, rep, _symbol) in KERNELS.items()}
        # first, in a process nothing else has run in yet: its gate holds
        # the post-storm flows/s against the pre-storm's, a host
        # measurement. No profiler session runs before phase profile
        # (``host_bound``), but for ``--profile``'s plateau.
        phase = "ddos"
        for line in phase_ddos(args.seed, card, report, args.profile):
            print(f"phase {line}", flush=True)

        phase = "worlds"
        worlds, lines = phase_worlds(args.seed)
        for line in lines:
            print(f"phase worlds: {line}", flush=True)
        # popped, so that ``del`` frees each world after its phases
        cfg5, mixed, cfg3 = (worlds.pop(k) for k in ("cfg5", "mixed", "cfg3"))

        phase = "kernels"
        for line in phase_kernels(cfg5, mixed, cfg3, args.seed, report,
                                  card):
            print(f"phase kernels: {line}", flush=True)

        phase = "cfg5"
        for line in phase_cfg5(cfg5, card, report, args.profile):
            print(f"phase {line}", flush=True)

        phase = "update"
        for line in phase_update(cfg5, card):
            print(f"phase {line}", flush=True)

        phase = "mixed"
        for line in phase_mixed(mixed, card, report, args.profile):
            print(f"phase {line}", flush=True)

        phase = "parity"
        for line in phase_parity(cfg5, mixed, card, report):
            print(f"phase {line}", flush=True)
        del cfg5, mixed

        phase = "cfg3"
        for line in phase_cfg3(cfg3, card, report, args.profile):
            print(f"phase {line}", flush=True)
        del cfg3

        phase = "serve"
        for line in phase_serve(args.seed, card, args.profile):
            print(f"phase {line}", flush=True)

        phase = "soak"
        for line in phase_soak(card):
            print(f"phase {line}", flush=True)

        phase = "agent"
        eng, cfg, next_batch, log = phase_agent(args.seed, card)

        phase = "feeder"
        wire, lines = phase_feeder(eng, cfg, next_batch, log, card, report)
        for line in lines:
            print(f"phase {line}", flush=True)
        del eng, log

        phase = "observe"
        for line in phase_observe(wire, card, report):
            print(f"phase {line}", flush=True)
        del wire

        phase = "verify"
        for line in phase_verify(card):
            print(f"phase {line}", flush=True)

        phase = "mesh"
        for line in phase_mesh(args.seed, card, report):
            print(f"phase {line}", flush=True)

        phase = "tenants"
        lines, snap, ipcache = phase_tenants(args.seed, card, report)
        for line in lines:
            print(f"phase {line}", flush=True)

        phase = "fqdn"
        for line in phase_fqdn(args.seed, card, report):
            print(f"phase {line}", flush=True)

        phase = "cluster"
        for line in phase_cluster(args.seed, card, report):
            print(f"phase {line}", flush=True)

        phase = "chaos"
        for line in phase_chaos(card, report):
            print(f"phase {line}", flush=True)

        phase = "goldengen"
        for line in phase_goldengen(snap, ipcache, args.seed, card,
                                    report):
            print(f"phase {line}", flush=True)
        del snap, ipcache

        phase = "profile"
        for line in phase_profile(args.seed, card, report):
            print(f"phase profile: {line}", flush=True)
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
