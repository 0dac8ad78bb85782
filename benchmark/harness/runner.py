"""One run of one cell: build, warm up, drive the window, check, report.

The order of a run:
1. the configuration's world is declared through the engine's public API
   and compiled (``Engine.regenerate``, timed: ``regen_s``);
2. the mix's generator draws its flow table from the seed and makes the
   window's batches (the reference's policy picks the allowed ports; it is
   dropped, with the declaration, before the window, and worked out again
   for the check); the host buffers of the check's copies of the table are
   made; the warm-up puts every flow into the table once, in batches of
   the window's shape, with one GC tick; the first warm-up dispatch is
   captured: it starts from an empty table, which the reference makes
   itself (the start check);
3. the window: the closed loop runs for ``seconds`` (set-up ends at its
   first submit); in a traced run its first half is timed by the host only,
   then four dispatches have their torch calls counted, then the profiler
   is started (which takes seconds, the loop running on) and records the
   next ``seconds / 2``;
4. once the window has closed and the peak memory is read, the captures
   are copied to the host and the engine is stopped and freed; the
   reference then checks the first warm-up dispatch and the window's
   dispatches drawn from the seed (``checked_dispatches`` of the indices
   ``checked_from``).
"""

from __future__ import annotations

import gc
import json
import resource
import sys
import time
from typing import Dict

import numpy as np

from benchmark.harness import check, hostload, serve
from benchmark.harness.kernel_bytes import dispatch_bytes
from benchmark.reference.constants import CT_LIFETIME_CLOSE
from benchmark.reference.datapath import policy_of_rows, remote_identity
from benchmark.reference.policy import Policy

#: the clock at the warm-up's first batch (logical seconds)
NOW0 = 1_000_000
#: dispatches whose torch calls a traced run counts
COUNTED = 4
#: modules no run may have loaded, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "cilium_tpu", "oracle")


def forbidden_modules():
    return sorted({n for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


def _host(d: Dict) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in d.items()}


def cpu_s() -> float:
    """The CPU seconds of this process so far, all its threads."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def host_probe_ms() -> float:
    """The host's speed on one core: the least of three timings of a fixed
    piece of pure Python (about 30 ms each)."""
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        d = {}
        for i in range(200_000):
            d[i & 0xFFF] = d.get(i & 0xFFF, 0) + i
        best = min(best, time.perf_counter() - t)
    return best * 1e3


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, test_sizes: bool = False,
             control: bool = False) -> Dict:
    """→ the result line's object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown`` when traced,
    ``checks``). ``t_start``: the process's start on ``perf_counter``.
    ``test_sizes`` runs the configuration's and mix's test sizes;
    ``control`` also puts the control (``check.control_counts``) in the
    program's place on every checked dispatch and adds its counts to the
    checks, under ``control_``."""
    import torch
    cfg, mix = cell.config, cell.traffic
    sizes = cfg["test_sizes"] if test_sizes else cfg["sizes"]
    n_flows = mix["test_flows"] if test_sizes else mix["flows"]
    decl = cell.declare.declare(sizes)
    decl["node_ipcache"] = cfg.get("node_ipcache", {})

    eng, regen_s = serve.build_engine(decl, cfg["daemon"], sizes, device)
    rec = serve.Recorder(eng)
    t_traffic = time.perf_counter()
    policy = Policy(decl)
    traffic = cell.generator.make(mix, decl, policy, sizes["batch"], seed,
                                  n_flows)
    traffic_s = time.perf_counter() - t_traffic
    # the benchmark's own objects leave the heap the program's collector
    # walks: the check works the policy out again after the window
    decl.pop("pools", None)
    decl_text = json.dumps(decl)
    del decl, policy

    rng = np.random.default_rng([seed, 2])
    lo, hi = mix["test_checked_from" if test_sizes else "checked_from"]
    picks = sorted(int(x) for x in rng.choice(
        np.arange(lo, hi), mix["checked_dispatches"], replace=False))
    checked = {i: {} for i in picks}
    rec.reserve(1 + 2 * len(picks))

    # warm-up: every flow once, one GC tick, the first dispatch captured
    now = NOW0
    start = {}
    tickets = []
    eng.sweep_step(now)
    for i, b in enumerate(traffic.warm_batches()):
        if i == 0:
            rec.capture(b, start, before=False)
        tickets.append(eng.submit(b, now=now))
        now += mix["clock_step_s"]
    start["out"] = {k: np.array(v)
                    for k, v in tickets[0].result(timeout=600).items()}
    for t in tickets:
        t.result(timeout=600)
    live_warm = eng.datapath.ct_stats(now)["live"]

    step = mix["clock_step_s"]
    gc_every = max(1, int(round(mix["gc_every_s"] / step)))
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    loop = serve.Loop(eng, rec, traffic, now, step, gc_every,
                      mix["outstanding"], checked)
    dtrace = traced_from = None
    part1 = [None, None]            # the host-timed part, epoch ns

    sampler = hostload.HostSampler()

    def until():
        nonlocal dtrace, traced_from
        if loop.t_first is None:
            return True
        sampler.sample(sum(n for _s, _r, n in loop.batches))
        t = time.perf_counter()
        if not trace:
            return t - loop.t_first < seconds
        if part1[1] is None:
            if t - loop.t_first < seconds / 2:
                return True
            part1[1] = time.time_ns()
            rec.count_calls(COUNTED)
            return True
        if traced_from is None:
            if len(rec.calls) < COUNTED \
                    and t - loop.t_first < seconds / 2 + 60:
                return True
            if device == "cuda":
                from benchmark.harness.trace import DeviceTrace
                # takes seconds to start, the pipeline draining meanwhile:
                # the traced part starts once it is up
                dtrace = DeviceTrace()
            traced_from = time.perf_counter()
        return time.perf_counter() - traced_from < seconds / 2

    cpu0 = cpu_s()
    threads0 = hostload.threads()
    t_end = loop.run(until)
    sampler.sample(sum(n for _s, _r, n in loop.batches), force=True)
    threads1 = hostload.threads()
    # the host's share in the window's speed: the process's CPU seconds a
    # second of wall (and each thread's), how fast one core runs fixed work
    # just after, and the rate and CPU use second by second
    host = {"cpu_per_s": (cpu_s() - cpu0) / (t_end - loop.t_first),
            "probe_ms": host_probe_ms(),
            "threads_cpu_s": {k: round(v - threads0.get(k, 0.0), 2)
                              for k, v in threads1.items()
                              if v - threads0.get(k, 0.0) >= 0.05},
            "series": {k: [round(x, 4) for x in v]
                       for k, v in sampler.series().items()}}
    traffic.close()
    if dtrace is not None:
        dtrace.stop()
    t_first = loop.t_first
    setup_s = t_first - t_start
    part1[0] = loop.t_first_ns
    if part1[1] is None:
        part1[1] = time.time_ns()
    wall = t_end - t_first
    done_rows = sum(n for _s, _r, n in loop.batches)
    t0_ns = part1[0]
    gaps = np.diff([r_ns for _s, r_ns, _n in loop.batches]) / 1e6
    quarter = [0, 0, 0, 0]
    for _s, r_ns, n in loop.batches:
        q = int((r_ns - t0_ns) / 1e9 / wall * 4)
        quarter[min(max(q, 0), 3)] += n
    end_now = loop.now

    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    live_end = eng.datapath.ct_stats(end_now)["live"]
    # the datapath's device-resident groups (its wire pool is host memory)
    ledger = {k: v for k, v in eng.datapath.hbm_ledger()["groups"].items()
              if k != "wire_pool"}
    placed = eng.active.tensors
    tries = [placed[k].cpu().numpy() for k in ("lpm_v4", "lpm_v6")]
    l7_rules = placed["l7_methods"].shape[1]
    records = [start] + [checked[i] for i in picks]
    if device == "cuda":
        torch.cuda.synchronize()
    for r in records:
        for k in ("ct_before", "ct_after", "counters"):
            if k in r:
                r[k] = _host(r[k])
    errors = list(loop.errors)
    batches, spans, calls = loop.batches, rec.spans, rec.calls
    attempted, failed = loop.submitted_rows, loop.failed_rows
    eng.stop()
    del eng, rec, loop
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # the check, on the host
    t_check = time.perf_counter()
    policy = Policy(json.loads(decl_text))
    counts = {"rows": 0, "ct_slots": 0, "counters": 0}
    ctl: Dict[str, int] = {}
    n_checked = 0
    kbytes = []
    for i, r in enumerate(records):
        if not all(k in r for k in ("out", "ct_after", "counters")):
            continue
        if i == 0:
            before = {k: np.zeros_like(v).view(np.uint32)
                      for k, v in r["ct_after"].items()}
        else:
            before = r["ct_before"]
            l7_sets = None
            if policy.l7_sets:
                ident = remote_identity(policy, r["batch"])[0]
                l7_sets = policy_of_rows(policy, r["batch"], ident)[2]
            kbytes.append(dispatch_bytes(
                *tries, {k: np.ascontiguousarray(v).view(np.uint32)
                         for k, v in before.items()},
                r["batch"], r["out"], r["now"], l7_sets, l7_rules))
        got = check.compare(policy, r["batch"], r["now"], before,
                            r["ct_after"], r["counters"], r["out"])
        for k in counts:
            counts[k] += got[k]
        if control:
            got = check.control_counts(policy, r["batch"], r["now"], before)
            for k in got:
                ctl[k] = ctl.get(k, 0) + got[k]
        n_checked += 1

    closing = traffic.live_allowance(int(np.ceil(CT_LIFETIME_CLOSE / step)))
    checks = {
        "rows_mismatched": {"value": counts["rows"], "most": 0},
        "ct_slots_mismatched": {"value": counts["ct_slots"], "most": 0},
        "counters_mismatched": {"value": counts["counters"], "most": 0},
        "dispatches_checked": {"value": n_checked,
                               "least": 1 + len(picks)},
        "live_flows_over": {"value": live_end - live_warm - closing,
                            "most": 0},
        "errors": {"value": len(errors), "most": 0},
    }
    for k, v in ctl.items():
        checks[f"control_{k}"] = {"value": v}
    correct = all(c["value"] <= c["most"] if "most" in c
                  else c["value"] >= c["least"] for c in checks.values()
                  if "most" in c or "least" in c)

    metrics = {}
    if not trace:
        values = {"flows_per_s": done_rows / wall, "setup_s": setup_s,
                  "device_memory_bytes": peak}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    summary = None
    if dtrace is not None:
        summary = dtrace.summary(spans)
    reading = {"part1": tuple(part1), "spans": spans, "calls": calls,
               "batches": batches, "trace": summary, "kernel_bytes": kbytes,
               "regen_s": regen_s, "memory_peak_bytes": peak,
               "placed_bytes": ledger}
    if trace:
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": {
                  "platform": "gpu" if device == "cuda" else device,
                  "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}}
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    notes = {"window_s": wall, "rows_done": done_rows,
             "quarter_flows_per_s": [q / (wall / 4) for q in quarter],
             "result_gap_ms": [float(np.percentile(gaps, q))
                               for q in (50, 90, 99, 100)] if gaps.size
             else None,
             "live_warm": live_warm, "live_end": live_end,
             "setup_s": setup_s, "regen_s": regen_s,
             "traffic_s": traffic_s, "host": host,
             "check_s": time.perf_counter() - t_check,
             "errors": errors[:5]}
    if summary is not None:
        notes["trace"] = {k: summary[k] for k in ("events", "start_s",
                                                  "stop_s")}
    return result, notes
