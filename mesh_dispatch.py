#!/usr/bin/env python3
"""The port's host-steered mesh dispatch at the QoS soak's geometry, on
the CPU: torch ops a dispatch by stage, and dispatch seconds alone and
beside threads that loop ``Engine.render_metrics``.

The engine is ``tests/test_torch_qos.py``'s 8-shard soak's: 8 flow
shards on ``TorchDatapath(device="cpu")``, batch 512 (2,048 steered rows
with the default segment headroom), CT 2^12, the auditor at sampling
1.0, QoS on, one web endpoint allowed to 10.0.0.0/8:443, submissions of
64 SYNs, two scrape threads. Imports only the port.

- ``--mode steady``: 20 warm submissions; 20 timed alone (the seconds
  inside ``TorchDatapath.classify_async``); the last dispatch replayed 5
  times under a CPU-only ``torch.profiler`` session, its top-level aten
  ops counted by stage; 20 timed beside the scrape threads.
- ``--mode soak``: the soak's own sequence (scrapers from the start, 20
  warm submissions, stall timeout 1.0 s, one 4 s ``datapath.transfer``
  hang, 10 submissions after the restart): every dispatch's seconds and
  thread, each stage's seconds after the restart, the restarts and the
  rejected tickets.

``--spin``: the scrape threads do pure-Python work instead of
``Engine.render_metrics`` (the GIL alone, no metrics). Run from the repo
root: ``python3 mesh_dispatch.py --mode steady``.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from collections import Counter, defaultdict

import numpy as np
import torch

from cilium_tpu_torch.kernels import classify as cls
from cilium_tpu_torch.kernels import conntrack as ctk
from cilium_tpu_torch.kernels import fused as fk
from cilium_tpu_torch.kernels.records import batch_from_records
from cilium_tpu_torch.oracle.datapath import PacketRecord
from cilium_tpu_torch.parallel import mesh as mm
from cilium_tpu_torch.runtime.config import DaemonConfig
from cilium_tpu_torch.runtime.datapath import TorchDatapath
from cilium_tpu_torch.runtime.engine import Engine
from cilium_tpu_torch.runtime.faults import FAULTS
from cilium_tpu_torch.utils import constants as C
from cilium_tpu_torch.utils.ip import parse_addr

#: the soak's geometry: flow shards, scrape threads, timed submissions
SHARDS, SCRAPERS, N = 8, 2, 20

#: (module, function, stage) the readings attribute time and ops to
STAGES = (
    (mm, "split_batch", "unpack"), (mm, "whole_batch", "unpack"),
    (cls, "classify_pre_ct", "pre_ct"),
    (cls, "interior_pre_core", "interior"),
    (cls, "compose_verdict", "interior"),
    (fk, "policy_verdict_fused", "interior"),
    (fk, "ct_probe_pair_fused", "k2_probe"),
    (fk, "ct_probe_pair_plain", "k2_probe"),
    (fk, "ct_probe_pair_sharded", "k2_probe"),
    (cls, "ct_update_stage", "ct_update"),
    (ctk, "ct_insert_new", "ct_insert"),
    (ctk, "hash_words_u64", "ct_hash"),
    (cls, "resolve_rev_nat", "rnat_tally"),
    (cls, "tally_by_reason_dir", "rnat_tally"),
    (mm, "sum_counters", "rnat_tally"),
)


def engine() -> Engine:
    cfg = DaemonConfig(
        n_shards=SHARDS, auto_regen=False, batch_size=512,
        ct_capacity=1 << 12, pipeline_flush_ms=0.5, audit_enabled=True,
        audit_sample_rate=1.0, pipeline_max_restarts=3,
        pipeline_restart_backoff_s=0.05, qos_enabled=True,
        qos_tenants="gold=4:lane,silver=2,bulk=1", qos_assign="1=gold",
        device="cpu")
    eng = Engine(cfg, datapath=TorchDatapath(cfg))
    eng.auditor.configure(sample_rate=1.0)
    eng.add_endpoint(["k8s:app=web"], ips=("192.168.0.10",), ep_id=1)
    eng.apply_policy([{
        "endpointSelector": {"matchLabels": {"app": "web"}},
        "egress": [{"toCIDR": ["10.0.0.0/8"],
                    "toPorts": [{"ports": [{"port": "443",
                                            "protocol": "TCP"}]}]}]}])
    eng.regenerate()
    return eng


def submission(eng, i, tenant):
    s16, _ = parse_addr("192.168.0.10")
    recs = [PacketRecord(s16, parse_addr(f"10.0.{(i + j) % 250}.1")[0],
                         40000 + j, 443, C.PROTO_TCP, C.TCP_SYN, False, 1,
                         C.DIR_EGRESS) for j in range(64)]
    b = batch_from_records(recs, eng.active.snapshot.ep_slot_of)
    tids = {v: k for k, v in eng.qos.tenants().items()}
    b["_tenant"] = np.full(b["valid"].shape, tids[tenant], dtype=np.int32)
    return b


TENANTS = ("gold", "silver", "bulk")


class Timed:
    """Wraps ``datapath.classify_async`` (seconds, thread, rows, end) and
    the stage functions (seconds, end)."""

    def __init__(self, dp):
        self.dispatches, self.stages, self.last = [], defaultdict(list), None
        self._restore = []
        orig = dp.classify_async

        def timed(*a, **k):
            self.last = (a, k)
            t0 = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                t1 = time.perf_counter()
                self.dispatches.append((t1 - t0,
                                        threading.current_thread().name,
                                        int(a[2]["valid"].shape[0]), t1))
        dp.classify_async = timed
        self.orig = orig

    def wrap_stages(self, around):
        """Wrap every stage function: ``around(stage, f, a, k)`` calls
        it."""
        for mod, name, stage in STAGES:
            f = getattr(mod, name, None)
            if f is None:
                continue

            def g(*a, _f=f, _stage=stage, **k):
                return around(_stage, _f, a, k)
            setattr(mod, name, g)
            self._restore.append((mod, name, f))

    def time_stages(self):
        def around(stage, f, a, k):
            t0 = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                t1 = time.perf_counter()
                self.stages[stage].append((t1 - t0, t1))
        self.wrap_stages(around)

    def label_stages(self):
        def around(stage, f, a, k):
            with torch.profiler.record_function("STAGE:" + stage):
                return f(*a, **k)
        self.wrap_stages(around)

    def restore(self):
        for mod, name, f in reversed(self._restore):
            setattr(mod, name, f)
        self._restore = []


def scrapers(eng, n, spin=False):
    """``n`` threads looping ``render_metrics`` (``spin``: pure-Python
    work that never waits) → a join that stops them and returns the
    loops run."""
    stop, renders = threading.Event(), [0]

    def loop():
        while not stop.is_set():
            if spin:
                sum(range(2000))
            else:
                eng.render_metrics()
            renders[0] += 1
    threads = [threading.Thread(target=loop) for _ in range(n)]
    for t in threads:
        t.start()

    def join():
        stop.set()
        for t in threads:
            t.join()
        return renders[0]
    return join


def quantiles(xs):
    if not xs:
        return "no dispatch"
    xs = sorted(xs)
    return (f"min {xs[0]:.4f} p50 {xs[len(xs) // 2]:.4f} max {xs[-1]:.4f} "
            f"n {len(xs)}")


def ops_by_stage(timer):
    """The last dispatch replayed 5 times on this thread under a CPU
    profiler: top-level aten ops a dispatch by stage, each op counted in
    its innermost stage (``ct_hash``: the CT key hashes inside the probe
    and the insert)."""
    a, k = timer.last
    for _ in range(2):
        timer.orig(*a, **k)()
    timer.label_stages()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(5):
                timer.orig(*a, **k)()
    finally:
        timer.restore()
    by = Counter()
    for ev in prof.events():
        parent = ev.cpu_parent
        if not ev.name.startswith("aten::") or (
                parent is not None and parent.name.startswith("aten::")):
            continue
        stage = "other"
        while parent is not None:
            if parent.name.startswith("STAGE:"):
                stage = parent.name[6:]
                break
            parent = parent.cpu_parent
        by[stage] += 1
    return {s: n // 5 for s, n in sorted(by.items())}


def steady(spin):
    eng = engine()
    timer = Timed(eng.datapath)
    k = [0]

    def run(n):
        del timer.dispatches[:]
        for i in range(n):
            eng.submit(submission(eng, k[0] + i, TENANTS[i % 3]),
                       now=1000 + k[0] + i)
        assert eng.drain(timeout=300), "not drained in 300 s"
        k[0] += n
        return [d[0] for d in timer.dispatches]

    run(20)
    alone = run(N)
    ops = ops_by_stage(timer)
    join = scrapers(eng, SCRAPERS, spin)
    try:
        busy = run(N)
    finally:
        renders = join()
        eng.stop()
    print(f"torch ops a dispatch by stage: {ops} total {sum(ops.values())}")
    print(f"dispatch s alone: {quantiles(alone)}")
    loops = "pure-Python" if spin else "render_metrics"
    print(f"dispatch s beside {SCRAPERS} {loops} loops: "
          f"{quantiles(busy)}; {renders} renders")


def soak(spin):
    eng = engine()
    timer = Timed(eng.datapath)
    join = scrapers(eng, SCRAPERS, spin)
    rejected = 0
    try:
        FAULTS.reset()
        for i in range(20):
            eng.submit(submission(eng, i, TENANTS[i % 3]), now=1000 + i)
        assert eng.drain(timeout=120)
        eng.resource_step(now=1.0)
        eng.start_pipeline().set_stall_timeout_s(1.0)
        warm = [d[0] for d in timer.dispatches]
        del timer.dispatches[:]
        timer.time_stages()
        t0 = time.perf_counter()
        FAULTS.load_spec("datapath.transfer=hang:delay_s=4:times=1")
        try:
            eng.submit(submission(eng, 99, "bulk"), now=2000)
        except Exception:   # noqa: BLE001 — the wedged window
            pass
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            ps = eng.pipeline_stats()
            if ps and ps["restarts"] >= 1 and ps["state"] == "ok":
                break
            time.sleep(0.1)
        FAULTS.reset()
        restarted = time.perf_counter()
        tickets = [eng.submit(submission(eng, 200 + i, TENANTS[i % 3]),
                              now=3000 + i) for i in range(10)]
        eng.drain(timeout=120)
        for t in tickets:
            try:
                t.result(timeout=5)
            except Exception:   # noqa: BLE001 — counted
                rejected += 1
        restarts = eng.pipeline_stats()["restarts"]
    finally:
        timer.restore()
        join()
        FAULTS.reset()
        eng.stop()
    print(f"warm dispatch s (scrapers running): {quantiles(warm)}")
    for d, name, rows, end in timer.dispatches:
        print(f"dispatch at {end - t0:7.3f} s: {d:.3f} s on {name}, "
              f"{rows} rows")
    for stage, xs in sorted(timer.stages.items()):
        post = [d for d, end in xs if end > restarted]
        if post:
            print(f"after the restart, {stage}: {len(post)} calls, mean "
                  f"{sum(post) / len(post):.4f} s, max {max(post):.4f} s")
    print(f"restarts {restarts}, tickets rejected after the restart "
          f"{rejected} of 10")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("steady", "soak"), default="steady")
    ap.add_argument("--spin", action="store_true",
                    help="the scrape threads do pure-Python work")
    args = ap.parse_args(argv)
    (steady if args.mode == "steady" else soak)(args.spin)
    return 0


if __name__ == "__main__":
    sys.exit(main())
