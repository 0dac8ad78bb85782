"""cfg6's drop storm on the CPU: ``chip_smoke.ddos_storm``, the loop that
``chip_smoke.py``'s phase ddos runs, at the reference's own smoke size
(``bench.py:865`` ``ddos_bench``: CT 2^13, batch 256, 11 flood batches an
iteration, the ``DaemonConfig`` of ``bench.py:905-920``), through the
port's ``Engine`` on ``TorchDatapath`` and the JAX package's ``Engine`` on
``JITDatapath``, on the same seed and the same logical ticks.

Held equal, exactly, iteration for iteration: the ladder's level, its
queue fraction and its four latches (``ddos_storm`` reads the shed rate
per logical second), the CT occupancy gauge, emergency GC, the
ledger's forecast, the flood's sent, refused and harvest-shed counts and
the dispatches; where the pipeline is drained (the saturation and recovery
iterations, and the end of the ingest storm) also the evicted and CT_FULL
counts and legit survival. Then every dispatch's verdicts (every out
column, in dispatch order) and the CT arrays.

Left out, because they depend on the wall clock: legit latencies, the
pre-storm, storm and post-storm flows/s, the ledger-overhead attestation,
the ladder's dwell seconds, the shed rate's value (its second carries
the microseconds between the loop's stamp and the controller's read),
and the auditor's row counts (its pool fills
as the worker finalizes); each side's audit must still check rows and
find no mismatch.
"""

import importlib
from types import SimpleNamespace

import numpy as np

import chip_smoke
from tests.test_torch_datapath import (SIDES, PKG, assert_ct_equal,
                                       assert_outs_equal, make_config,
                                       make_datapath, mods)

SEED = 0
#: the run's results compared exactly (the module docstring's list)
SAME = ("iterations", "shed_new_iter", "forecast_iter", "ct_track_mismatches",
        "survival", "legit_rows", "max_level", "occ_peak", "occ_late",
        "occ_final", "occ_trajectory", "evicted", "ct_full", "dwell_iters",
        "dispatches", "drain_per_iter", "sent", "dropped", "harvest_shed")


def storm(side):
    """The storm on ``side``'s engine. → (result, every dispatch's
    outputs in dispatch order, the CT arrays)."""
    pkg = PKG[side]
    m = mods(side)
    cfg = make_config(side, **chip_smoke.ddos_config(True))
    eng = chip_smoke.ddos_world(m.engine.Engine(
        cfg, datapath=make_datapath(side, cfg)))
    outs = []
    real = eng.datapath.classify_async

    def recorded(*args, **kw):
        fin = real(*args, **kw)
        at = len(outs)
        outs.append(None)

        def finalize():
            res = fin()
            outs[at] = {k: np.array(v) for k, v in res[0].items()}
            return res
        return finalize
    eng.datapath.classify_async = recorded
    ns = SimpleNamespace(
        empty_batch=importlib.import_module(
            f"{pkg}.kernels.records").empty_batch,
        shed_new_rows=importlib.import_module(
            f"{pkg}.shim.feeder").shed_new_rows,
        OVERLOAD_SHED_NEW=importlib.import_module(
            f"{pkg}.pipeline.guard").OVERLOAD_SHED_NEW)
    try:
        res = chip_smoke.ddos_storm(eng, ns, True, SEED)
        return res, outs, eng.ct_arrays(), cfg
    finally:
        eng.stop()


def test_cfg6_storm_equals_jax_iteration_for_iteration():
    (rj, oj, cj, cfg), (rt, ot, ct, _c) = (storm(s) for s in SIDES)
    assert len(rj["trace"]) == len(rt["trace"])
    for want, got in zip(rj["trace"], rt["trace"]):
        assert want == got, (want, got)
    for k in SAME:
        assert rj[k] == rt[k], k
    assert len(oj) == len(ot) == rt["dispatches"]
    for i, (want, got) in enumerate(zip(oj, ot)):
        assert_outs_equal(want, got, f"dispatch {i}")
    assert_ct_equal(cj, ct)
    # the reference's gate on what does not depend on the wall clock
    for r in (rj, rt):
        assert r["audit"]["checked_rows"] > 0
        assert r["audit"]["mismatched_rows"] == 0
        assert r["survival"] >= 0.99
        assert r["max_level"] == 3 and r["shed_new_iter"] is not None
        assert r["occ_peak"] >= cfg.ct_pressure_high
        assert r["occ_late"] < 0.995
        assert r["occ_final"] <= cfg.ct_pressure_low
        assert r["evicted"] > 0 and r["ct_full"] > 0
        assert r["ct_track_mismatches"] == 0
        assert r["forecast_iter"] < r["shed_new_iter"]
    phases = {rec["phase"] for rec in rt["trace"]}
    assert phases == {"1a", "1b", "1b-end", "recover"}


def test_worker_split_covers_both_windows(monkeypatch):
    """Phase ddos's worker split (``chip_smoke.DispatchLog``'s timers and
    windows, ``worker_timers``) and its replay in two parts
    (``PlainReplay``) on the port's storm at the smoke size: each of the
    pre-storm and post-storm windows holds every legit dispatch of its
    ``DDOS_FPS_WINDOWS`` windows and a median of every timer; the parts
    of a dispatch (pack, upload, the step, the fetch) add up to no more
    than its whole ``classify_async``, which is inside the engine's
    dispatch, and the datapath's finalize and every fold are inside the
    engine's finalize; the windows' edges carry their probes and the
    pipeline worker's CPU seconds. The log is empty when the post-storm
    window starts, and the replay, fed before it and at the end, holds
    every dispatch and the CT equal."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    cfg = make_config("torch", **chip_smoke.ddos_config(True))
    m = mods("torch")
    eng = chip_smoke.ddos_world(m.engine.Engine(
        cfg, datapath=make_datapath("torch", cfg)))
    log = chip_smoke.DispatchLog(eng.datapath)
    chip_smoke.worker_timers(eng, log)
    replay = chip_smoke.PlainReplay(cfg)
    before_post = {}

    def window(label, edge):
        if (label, edge) == ("post", "start"):
            replay.feed(log)
            before_post.update(steps=replay.n_steps, entries=len(log.entries),
                               owned=len(log.owned))
        log.window(label, edge)
    ns = SimpleNamespace(
        empty_batch=importlib.import_module(
            "cilium_tpu_torch.kernels.records").empty_batch,
        shed_new_rows=importlib.import_module(
            "cilium_tpu_torch.shim.feeder").shed_new_rows,
        OVERLOAD_SHED_NEW=importlib.import_module(
            "cilium_tpu_torch.pipeline.guard").OVERLOAD_SHED_NEW)
    try:
        res = chip_smoke.ddos_storm(eng, ns, True, SEED, own=log.own,
                                    window=window)
        replay.feed(log)
        assert_ct_equal(eng.ct_arrays(), replay.plain.ct_arrays())
    finally:
        eng.stop()
    n = res["dispatches"]
    assert before_post["entries"] == before_post["owned"] == 0
    assert 0 < before_post["steps"] < replay.n_steps == log.steps() == n
    per_window = chip_smoke.DDOS_FPS_WINDOWS * chip_smoke.ddos_params(
        True)["fps"]
    summary = log.summary()
    assert set(summary) == {"pre", "post"}
    timers = (chip_smoke.DispatchLog.PARTS
              + ("classify_async", "finalize", "engine_dispatch",
                 "engine_finalize", "metrics", "flowmetrics", "blackbox",
                 "audit_capture", "rule_hits", "salvage"))
    for w in summary.values():
        assert w["median_ms"]["dispatches"] == per_window
        assert all(w["median_ms"][k] > 0 for k in timers), w["median_ms"]
        assert set(w["probe"]) == {"start", "end"}
        assert w["probe"]["start"]["spin_ms"] > 0
        assert w["counters"].get("cpu_s.pipeline-worker", 0) >= 0
    ms = log.ms
    for k in ("classify_async", "finalize", "engine_dispatch",
              "engine_finalize", "metrics", "flowmetrics") + log.PARTS:
        assert len(ms[k]) == n, k
    for i in range(n):
        parts = sum(ms[p][i] for p in log.PARTS)
        assert parts <= ms["classify_async"][i] <= ms["engine_dispatch"][i]
        folds = sum(ms[f][i] for f in ("metrics", "flowmetrics"))
        assert ms["finalize"][i] + folds <= ms["engine_finalize"][i], i
