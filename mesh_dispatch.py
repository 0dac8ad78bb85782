#!/usr/bin/env python3
"""The port's host-steered mesh dispatch at the QoS soak's geometry, on
the CPU: the Python-level torch calls of a dispatch, and dispatch
seconds alone and beside threads that loop ``Engine.render_metrics``.

The engine is ``tests/test_torch_qos.py``'s 8-shard soak's: 8 flow
shards on ``TorchDatapath(device="cpu")``, batch 512 (2,048 steered rows
with the default segment headroom), CT 2^12, the auditor at sampling
1.0, QoS on, one web endpoint allowed to 10.0.0.0/8:443, submissions of
64 SYNs, two scrape threads. Imports only the port.

A dispatch is one ``TorchDatapath.classify_async`` and its finalize.
Its Python-level torch calls are counted by :class:`TorchCalls`, a
``torch.overrides.TorchFunctionMode`` entered on the thread that makes
the call: it sees every torch function and tensor method called from
Python, and nothing inside the scripted step (``kernels/classify.py``),
which is one call. The scripted step's seconds are read as one stage.

- ``--mode steady``: the scripted step compiled (its first use in the
  process) and 20 warm submissions, the first dispatch timed apart; 20
  timed alone (the seconds inside ``classify_async``, and of the
  scripted step in it); the calls of the next 20 dispatches, by name;
  20 timed beside the scrape threads.
- ``--mode soak``: the soak's own sequence (scrapers from the start, 20
  warm submissions, stall timeout 1.0 s, one 4 s ``datapath.transfer``
  hang, 10 submissions after the restart, the auditor drained): every
  dispatch's seconds and thread, the dispatches' and the scripted step's
  seconds and the torch calls after the restart, the restarts, the
  rejected tickets and the audit (``run_soak``, which
  ``chip_smoke.py``'s phase soak runs on the card).

``--spin``: the scrape threads do pure-Python work instead of
``Engine.render_metrics`` (the GIL alone, no metrics). Run from the repo
root: ``python3 mesh_dispatch.py --mode steady``.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from collections import Counter

import numpy as np
from torch.overrides import TorchFunctionMode

from cilium_tpu_torch.kernels import classify as cls
from cilium_tpu_torch.kernels.records import batch_from_records
from cilium_tpu_torch.oracle.datapath import PacketRecord
from cilium_tpu_torch.runtime.config import DaemonConfig
from cilium_tpu_torch.runtime.datapath import TorchDatapath
from cilium_tpu_torch.runtime.engine import Engine
from cilium_tpu_torch.runtime.faults import FAULTS
from cilium_tpu_torch.utils import constants as C
from cilium_tpu_torch.utils.ip import parse_addr

#: the soak's geometry: flow shards, scrape threads, timed submissions
SHARDS, SCRAPERS, N = 8, 2, 20


class TorchCalls(TorchFunctionMode):
    """Counts the torch calls made from Python on the thread that enters
    it, by name (``calls``)."""

    def __init__(self):
        super().__init__()
        self.calls = Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls[getattr(func, "__name__", str(func))] += 1
        return func(*args, **(kwargs or {}))


def engine(device: str = "cpu") -> Engine:
    """The soak's engine on ``device`` (``"cuda"``: the kernels on the
    card, as ``chip_smoke.py``'s phase soak runs it)."""
    cfg = DaemonConfig(
        n_shards=SHARDS, auto_regen=False, batch_size=512,
        ct_capacity=1 << 12, pipeline_flush_ms=0.5, audit_enabled=True,
        audit_sample_rate=1.0, pipeline_max_restarts=3,
        pipeline_restart_backoff_s=0.05, qos_enabled=True,
        qos_tenants="gold=4:lane,silver=2,bulk=1", qos_assign="1=gold",
        device=device)
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
    """Wraps ``datapath.classify_async`` and its finalize (seconds,
    thread, rows, end; with ``count``, the Python-level torch calls of
    each dispatch in ``calls``) and the scripted step (``steps``:
    seconds, end)."""

    def __init__(self, dp):
        self.dispatches, self.steps, self.calls = [], [], []
        self.count = False
        orig = dp.classify_async
        orig_scripted = cls.scripted

        def counted(f, *a, **k):
            if not self.count:
                return f(*a, **k), None
            with TorchCalls() as mode:
                return f(*a, **k), mode.calls

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                fin, calls = counted(orig, *a, **k)
            finally:
                t1 = time.perf_counter()
                self.dispatches.append((t1 - t0,
                                        threading.current_thread().name,
                                        int(a[2]["valid"].shape[0]), t1))

            def finalize():
                res, more = counted(fin)
                if calls is not None:
                    self.calls.append(calls + more)
                return res
            return finalize

        def step_timed(fn):
            step = orig_scripted(fn)

            def call(*a, **k):
                t0 = time.perf_counter()
                try:
                    return step(*a, **k)
                finally:
                    t1 = time.perf_counter()
                    self.steps.append((t1 - t0, t1))
            return call
        dp.classify_async = timed
        cls.scripted = step_timed
        self._restore = (dp, orig, orig_scripted)

    def restore(self):
        dp, orig, orig_scripted = self._restore
        dp.classify_async = orig
        cls.scripted = orig_scripted


def calls_per_dispatch(eng, timer, n=N, start=0):
    """``n`` submissions with every dispatch's torch calls counted → the
    calls of each dispatch (a ``Counter`` by name each)."""
    timer.count = True
    del timer.calls[:]
    try:
        for i in range(n):
            eng.submit(submission(eng, start + i, TENANTS[i % 3]),
                       now=1000 + start + i)
        assert eng.drain(timeout=300), "not drained in 300 s"
    finally:
        timer.count = False
    return list(timer.calls)


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


def steady(spin):
    # first use in this process: the step's compile, then its first call
    t0 = time.perf_counter()
    cls.scripted(cls.classify_wire_step)
    compile_s = time.perf_counter() - t0
    eng = engine()
    timer = Timed(eng.datapath)
    k = [0]

    def run(n):
        del timer.dispatches[:], timer.steps[:]
        for i in range(n):
            eng.submit(submission(eng, k[0] + i, TENANTS[i % 3]),
                       now=1000 + k[0] + i)
        assert eng.drain(timeout=300), "not drained in 300 s"
        k[0] += n
        return [d[0] for d in timer.dispatches], [s[0] for s in timer.steps]

    try:
        warm, _steps = run(20)
        alone, alone_steps = run(N)
        counts = calls_per_dispatch(eng, timer, start=k[0])
        k[0] += N
        join = scrapers(eng, SCRAPERS, spin)
        try:
            busy, busy_steps = run(N)
        finally:
            renders = join()
    finally:
        timer.restore()
        eng.stop()
    total = [sum(c.values()) for c in counts]
    every = sum(counts, Counter())
    top = ", ".join(f"{name} {v / len(counts):g}"
                    for name, v in every.most_common(12))
    print(f"python-level torch calls a dispatch: {quantiles(total)}; "
          f"by name (mean): {top}")
    print(f"first use: compiling the scripted step {compile_s:.3f} s, "
          f"the first dispatch {warm[0]:.4f} s, the next "
          f"{quantiles(warm[1:])}")
    print(f"dispatch s alone: {quantiles(alone)}")
    print(f"scripted step s alone: {quantiles(alone_steps)}")
    loops = "pure-Python" if spin else "render_metrics"
    print(f"dispatch s beside {SCRAPERS} {loops} loops: "
          f"{quantiles(busy)}; {renders} renders")
    print(f"scripted step s beside the loops: {quantiles(busy_steps)}")


def run_soak(device="cpu", spin=False):
    """The soak's own sequence on ``device`` → its readings: the warm
    dispatches' seconds beside the scrape threads; every dispatch of the
    drill (seconds, thread, rows, end, from its start); the seconds of the
    dispatches and of the scripted step that started after the restart,
    and their Python-level torch calls by name (a ``Counter`` a
    dispatch); restarts, the cap on them,
    rejected tickets after the restart and the auditor's rows."""
    eng = engine(device)
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
        del timer.dispatches[:], timer.steps[:]
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
        timer.count = True
        tickets = [eng.submit(submission(eng, 200 + i, TENANTS[i % 3]),
                              now=3000 + i) for i in range(10)]
        eng.drain(timeout=120)
        timer.count = False
        for t in tickets:
            try:
                t.result(timeout=5)
            except Exception:   # noqa: BLE001 — counted
                rejected += 1
        for _ in range(50):
            st = eng.audit_step(budget=128)
            if not st or (not st.get("replayed") and not st.get("pending")):
                break
        audit = eng.auditor.stats()
        restarts = eng.pipeline_stats()["restarts"]
    finally:
        timer.restore()
        join()
        FAULTS.reset()
        eng.stop()
    return {
        "warm": warm,
        "dispatches": [(d, name, rows, end - t0)
                       for d, name, rows, end in timer.dispatches],
        "after": [d for d, _n, _r, end in timer.dispatches
                  if end - d > restarted],
        "calls": list(timer.calls),
        "steps": [d for d, end in timer.steps if end - d > restarted],
        "restarts": restarts,
        "max_restarts": eng.config.pipeline_max_restarts,
        "rejected": rejected, "tickets": len(tickets),
        "checked_rows": audit["checked_rows"],
        "mismatched_rows": audit["mismatched_rows"],
    }


def soak(spin):
    r = run_soak(spin=spin)
    print(f"warm dispatch s (scrapers running): {quantiles(r['warm'])}")
    for d, name, rows, at in r["dispatches"]:
        print(f"dispatch at {at:7.3f} s: {d:.3f} s on {name}, {rows} rows")
    print(f"after the restart, dispatch s: {quantiles(r['after'])}; "
          f"scripted step s: {quantiles(r['steps'])}; python-level torch "
          f"calls a dispatch: "
          f"{quantiles([sum(c.values()) for c in r['calls']])}")
    print(f"restarts {r['restarts']}, tickets rejected after the restart "
          f"{r['rejected']} of {r['tickets']}, audit checked "
          f"{r['checked_rows']} rows, mismatched {r['mismatched_rows']}")


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
