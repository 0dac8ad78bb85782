"""The Engine: the daemon's core object (port of
``cilium_tpu/runtime/engine.py``; analog of upstream cilium-agent's daemon
wiring + endpoint regeneration pipeline).

Owns the control-plane state (allocator, ipcache, repository, endpoints),
compiles PolicySnapshots, places them on device, and serves classification.

Concurrency/atomicity model (the analog of per-endpoint policymap atomicity +
regeneration revisions): the active compiled snapshot is swapped by a single
reference assignment under a lock — a batch classifies against exactly one
snapshot revision, never a torn update. Regeneration is driven by a debounced
Trigger on repository/ipcache changes; CT sweeping by a periodic controller.
Device arrays are a cache of host truth: on device loss the engine can
re-materialize everything from host state (upstream philosophy: "BPF maps are
re-populatable from agent state").
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from cilium_tpu_torch.compile.ct_layout import CTConfig
from cilium_tpu_torch.compile.lb import LBConfig
from cilium_tpu_torch.compile.snapshot import PolicySnapshot, build_snapshot
from cilium_tpu_torch.model.endpoint import Endpoint
from cilium_tpu_torch.model.identity import IdentityAllocator
from cilium_tpu_torch.model.ipcache import IPCache
from cilium_tpu_torch.model.labels import Labels
from cilium_tpu_torch.model.rules import parse_rules
from cilium_tpu_torch.model.services import ServiceRegistry
from cilium_tpu_torch.observe.audit import ShadowAuditor
from cilium_tpu_torch.observe.blackbox import FlightRecorder
from cilium_tpu_torch.observe.flowmetrics import FlowMetrics
from cilium_tpu_torch.observe.pressure import LADDER_EXCLUDE, ResourceLedger
from cilium_tpu_torch.observe.trace import TRACER
from cilium_tpu_torch.observe.trace import active as active_trace
from cilium_tpu_torch.policy.repository import PolicyContext, Repository
from cilium_tpu_torch.policy.selectorcache import SelectorCache
from cilium_tpu_torch.runtime.config import DaemonConfig
from cilium_tpu_torch.runtime.controller import ControllerManager, Trigger
from cilium_tpu_torch.runtime.datapath import DatapathBackend, StalePlacement
from cilium_tpu_torch.runtime.faults import FAULTS
from cilium_tpu_torch.runtime.flowlog import FlowLog
from cilium_tpu_torch.runtime.metrics import Metrics
from cilium_tpu_torch.utils import constants as C


@dataclass
class CompiledSnapshot:
    """A snapshot placed on the datapath: what a batch classifies against."""
    snapshot: PolicySnapshot
    tensors: Dict            # the backend's placed handle (device arrays)
    world_index: int
    revision: int


class Engine:
    """Depends only on the DatapathBackend boundary for everything device-
    or semantics-executing (SURVEY.md §1 layer 3: the Datapath/Loader plugin
    boundary). Constructed with a FakeDatapath it touches no device."""

    def __init__(self, config: Optional[DaemonConfig] = None,
                 datapath: Optional[DatapathBackend] = None):
        self.config = config or DaemonConfig()
        if datapath is None:
            from cilium_tpu_torch.runtime.datapath import TorchDatapath
            datapath = TorchDatapath(self.config)
        self.datapath = datapath

        alloc = IdentityAllocator()
        from cilium_tpu_torch.model.fqdn import FQDNCache
        self.ctx = PolicyContext(
            allocator=alloc,
            selector_cache=SelectorCache(alloc),
            ipcache=IPCache(),
            services=ServiceRegistry(),
            enforcement_mode=self.config.enforcement_mode,
            allow_localhost=self.config.allow_localhost,
            fqdn_cache=FQDNCache(
                min_ttl=self.config.fqdn_min_ttl,
                max_names=self.config.fqdn_max_names,
                max_ips_per_name=self.config.fqdn_max_ips_per_name),
        )
        self.repo = Repository(self.ctx)
        self.endpoints: Dict[int, Endpoint] = {}
        self._next_ep_id = 1

        self.metrics = Metrics()
        self.flowlog = FlowLog(self.config.flowlog_capacity,
                               self.config.flowlog_mode,
                               sink_path=self.config.flowlog_path or None,
                               metrics=self.metrics)
        # the vectorized flow-observe engine over the columnar ring
        # (observe/observer.py — the Hubble Observe()/FlowFilter analog);
        # /v1/flows/observe and `cilium-tpu observe` serve through it
        from cilium_tpu_torch.observe.observer import FlowObserver
        self.observer = FlowObserver(self.flowlog, metrics=self.metrics)
        # per-rule hit/drop counters (the unused-rule / policy-drift
        # signal): matched_rule provenance → capped-cardinality labeled
        # counters, resolved to rule tags lazily per snapshot
        self._rule_fold_lock = threading.Lock()
        self._rule_label_memo: Dict[int, str] = {}   # coord → label
        self._rule_label_snap: Optional[PolicySnapshot] = None
        self._rule_labels_seen: set = set()          # global cardinality cap
        # observe/: span tracer + Hubble-metrics-analog windowed flow
        # aggregation. The tracer is process-wide; an engine only
        # configures it when ITS config turns tracing on — constructing a
        # second engine with the rate-0 default must not silently disable
        # (or wipe the span ring of) tracing another engine enabled
        if self.config.trace_sample_rate > 0:
            TRACER.configure(sample_rate=self.config.trace_sample_rate,
                             capacity=self.config.trace_capacity)
        self.tracer = TRACER
        self.flowmetrics = FlowMetrics(
            window_s=self.config.flowmetrics_window_s,
            n_windows=self.config.flowmetrics_windows,
            top_k=self.config.flowmetrics_top_k)
        # verdict provenance (observe/audit.py + observe/blackbox.py): the
        # flight recorder is always on (bounded rings, freeze on anomaly);
        # the shadow auditor is constructed unconditionally but samples
        # nothing until audit_enabled arms it (tests/chaos re-arm via
        # auditor.configure) — its capture path costs one attribute read
        # per finalized batch when disarmed
        self.blackbox = FlightRecorder(
            capacity=self.config.blackbox_events,
            verdict_batches=self.config.blackbox_verdicts,
            shed_spike=self.config.blackbox_shed_spike,
            shed_window_s=self.config.blackbox_shed_window_s,
            shed_spike_relaxed=self.config.blackbox_shed_spike_relaxed,
            metrics=self.metrics, tracer=TRACER)
        self.auditor = ShadowAuditor(
            sample_rate=self.config.audit_sample_rate
            if self.config.audit_enabled else 0.0,
            pool_batches=self.config.audit_pool_batches,
            max_rows=self.config.audit_max_rows,
            n_shards=getattr(self.datapath, "pipeline_shards", 1),
            metrics=self.metrics,
            on_mismatch=self._on_parity_mismatch)
        # resource pressure ledger (observe/pressure.py): every
        # bounded structure registers (capacity, occupancy, high_water)
        # here; the resource-ledger controller polls, the labeled
        # resource_* families + /v1/resources + `cilium-tpu top` export,
        # health() folds pressure in as RESOURCE_PRESSURE, and the
        # overload ladder takes the worst non-CT pressure as its fourth
        # latch. Forecast events narrate to the flight recorder.
        self.ledger = ResourceLedger(
            metrics=self.metrics,
            window=self.config.resource_eta_window,
            warn=self.config.resource_pressure_warn,
            crit=self.config.resource_pressure_crit,
            eta_warn_s=self.config.resource_eta_warn_s,
            event_sink=self.blackbox.record_event)
        self._last_update_stats = None   # incremental UpdateStats (budgets)
        self._hbm_budget = None          # attached verifier budget_doc
        # multi-tenant QoS (cilium_tpu/qos): the tenant table is built
        # once from config and threaded into the pipeline (weighted-fair
        # admission + latency lane) and the feeder (harvest-time tenant
        # stamping). None when qos_enabled is off — every consumer then
        # takes its pre-QoS FIFO path, byte-identical to today.
        if self.config.qos_enabled:
            from cilium_tpu_torch.qos import TenantTable
            self.qos = TenantTable.from_spec(
                self.config.qos_tenants,
                assign=self.config.qos_assign,
                default_weight=self.config.qos_default_weight,
                default_cap=self.config.qos_tenant_cap_batches)
        else:
            self.qos = None
        self._register_resources()
        self.controllers = ControllerManager()

        self._lock = threading.RLock()
        self._active: Optional[CompiledSnapshot] = None
        # regeneration-needed flag. An Event, not a bare bool: observers
        # (repo/ipcache/services) mark it from their mutators' threads
        # WITHOUT the engine lock — Event.set() is atomic, so a mark can
        # never be lost to a torn read/write interleaving
        self._dirty_event = threading.Event()
        self._dirty_event.set()
        self._autotuner = None     # observe/autotune controller state
        # supervised degradation: regen failures never tear down serving —
        # classify continues on the last-good snapshot while these track
        # the failure streak for health_probe()/metrics
        self._regen_failures = 0
        self._last_regen_error = ""
        self._inc = None           # IncrementalCompiler, seeded on full build
        self._api = None           # APIServer when config.api_socket set
        self._mesh = None          # ClusterMesh when cluster_store set
        self._pipeline = None      # ingestion Pipeline, started on demand
        self._pipeline_stopped = False   # stop() bars lazy restart
        self._pipeline_sharded = False   # pipeline delivers steered batches
        self._feeder = None        # shim/feeder.py harvest thread
        self._dns_proxy = None     # fqdn/proxy.py learning tap (feeder)
        self._pack_stats_seen: Dict[str, int] = {}  # scrape-delta baseline
        self._pack_fold_lock = threading.Lock()     # concurrent scrapes
        self._remap_snap = None    # dispatch-time slot-LUT cache key
        self._remap_lut: Optional[np.ndarray] = None
        # overload ladder (pipeline/guard.OverloadLadder; the `overload`
        # controller feeds it) + shed-rate bookkeeping for its shed signal
        self._overload = None
        self._overload_shed_prev = 0
        self._overload_shed_t: Optional[float] = None
        # CT emergency-GC latch (hysteresis: enters at ct_pressure_high,
        # exits at ct_pressure_low; armed by sweep()/sweep_step())
        self._ct_emergency = False
        # mesh self-healing: device loss → fenced re-mesh onto
        # survivors → CT salvage → hysteretic re-admission. The grace-
        # window fingerprint filter shares the feeder's exact established-
        # flow update/lookup discipline (shim/feeder.py) but is engine-
        # owned: the window must work for direct submit() producers too.
        from cilium_tpu_torch.shim.feeder import EstablishedFingerprints
        self._remesh_lock = threading.Lock()
        self._remesh_last: Optional[Dict] = None
        self._heal_ok_since: Optional[float] = None   # probe-pass streak
        self._salvage_until = 0.0    # monotonic end of the grace window
        self._salvage_fp = EstablishedFingerprints()

        self._regen_trigger = Trigger(self._mark_dirty_and_regen,
                                      min_interval=self.config.regen_debounce_s,
                                      sync=not self.config.auto_regen)
        # health prober source address → reserved health identity
        # (cilium-health analog; upstream allocates health endpoint IPs)
        self.ctx.ipcache.upsert(f"{C.HEALTH_PROBE_IP}/32", C.IDENTITY_HEALTH)

        self.repo.add_observer(lambda rev: self._regen_trigger())
        self.ctx.ipcache.add_observer(self._mark_dirty)
        # LB-only service changes (no toServices rule referencing them) still
        # need a recompile: the frontend/Maglev tensors live in the snapshot
        self.ctx.services.add_observer(self._mark_dirty)

    # -- endpoint lifecycle (thin pkg/endpoint analog) ------------------------
    def add_endpoint(self, labels: Sequence[str], ips: Sequence[str] = (),
                     ep_id: Optional[int] = None,
                     enforcement: Optional[str] = None) -> Endpoint:
        with self._lock:
            if ep_id is None:
                ep_id = self._next_ep_id
            if ep_id in self.endpoints:
                raise ValueError(f"endpoint {ep_id} already exists")
            self._next_ep_id = max(self._next_ep_id, ep_id + 1)
            lbls = Labels.parse(labels)
            ident = self.ctx.allocator.allocate(lbls)
            ep = Endpoint(ep_id=ep_id, labels=lbls, ips=tuple(ips),
                          identity_id=ident.id, enforcement=enforcement)
            self.endpoints[ep_id] = ep
            for ip in ips:
                prefix = f"{ip}/128" if ":" in ip else f"{ip}/32"
                self.ctx.ipcache.upsert(prefix, ident.id)
            self._mark_dirty()
            return ep

    def remove_endpoint(self, ep_id: int) -> bool:
        with self._lock:
            ep = self.endpoints.pop(ep_id, None)
            if ep is None:
                return False
            for ip in ep.ips:
                prefix = f"{ip}/128" if ":" in ip else f"{ip}/32"
                self.ctx.ipcache.delete(prefix)
            ident = self.ctx.allocator.get(ep.identity_id)
            if ident is not None:
                self.ctx.allocator.release(ident)
            self._mark_dirty()
            return True

    # -- FQDN policy (pkg/fqdn analog) -----------------------------------------
    def observe_dns(self, name: str, ips: Sequence[str], ttl: int = 3600,
                    now: Optional[int] = None) -> bool:
        """Feed one DNS answer into the FQDN cache (the programmatic stand-in
        for upstream's DNS-proxy observation path). Newly learned IPs
        re-materialize toFQDNs rules → regeneration."""
        if now is None:
            # the cache's clock, not wall time: materialization filters
            # expiries through fqdn_cache.clock, and the two must agree
            now = int(self.ctx.fqdn_cache.clock())
        return self.ctx.fqdn_cache.observe(name, ips, ttl, now)

    # -- services (pkg/service analog) -----------------------------------------
    def upsert_service(self, svc) -> None:
        """Add/replace a Service (frontends+backends program the LB tensors
        at the next regeneration; upstream: service upsert → lbmap writes)."""
        self.ctx.services.upsert(svc)

    def delete_service(self, namespace: str, name: str) -> bool:
        return self.ctx.services.delete(namespace, name)

    # -- policy ----------------------------------------------------------------
    def apply_policy(self, docs) -> int:
        """Ingest CNP-style rule documents (list/dict/JSON string)."""
        return self.repo.add(parse_rules(docs))

    def replace_policy(self, match_labels: Sequence[str], docs) -> int:
        return self.repo.replace_by_labels(Labels.parse(match_labels),
                                           parse_rules(docs) if docs else [])

    # -- regeneration (the loader path) ----------------------------------------
    @property
    def _dirty(self) -> bool:
        """Read-only view; all writes go through ``_dirty_event`` directly
        (the clear-before-compile ordering in ``_regenerate_locked`` is
        load-bearing — no second write path)."""
        return self._dirty_event.is_set()

    def _mark_dirty(self, *_args) -> None:
        self._dirty_event.set()

    def _mark_dirty_and_regen(self) -> None:
        self._dirty_event.set()
        if self.config.auto_regen:
            try:
                self.regenerate()
            except Exception:
                # regenerate() only raises through its supervised
                # degradation when there is no last-good snapshot (cold
                # start); it has already counted/logged the failure — keep
                # the trigger alive and surface that NOTHING is serving
                logging.getLogger("cilium_tpu_torch.engine").exception(
                    "regeneration failed with no last-good snapshot; "
                    "nothing is being served")

    def regenerate(self, force: bool = False) -> CompiledSnapshot:
        """Compile current control-plane state and swap it in atomically.

        With ``config.incremental`` the regeneration first tries to patch
        the active snapshot through the repository changelog
        (compile/incremental.IncrementalCompiler — the upstream analog of
        incremental policymap diffs, SURVEY.md §3.2); geometry gates fall
        back to the full compiler and re-seed the patcher."""
        with self._lock:
            if not (self._dirty_event.is_set() or force) \
                    and self._active is not None:
                return self._active
            was_dirty = self._dirty_event.is_set()
            try:
                return self._regenerate_locked(force)
            except Exception as e:  # noqa: BLE001 — supervised degradation
                # the failed compile consumed nothing: restore the dirty
                # mark it cleared so the next classify/trigger retries. A
                # *forced* regen from a clean engine stays clean — its
                # failure owes no retry (and marks set by observers
                # mid-compile are already on the event, never cleared here)
                if was_dirty:
                    self._dirty_event.set()
                self._regen_failures += 1
                self._last_regen_error = f"{type(e).__name__}: {e}"
                self.metrics.inc_counter("regen_failures_total")
                self.metrics.set_gauge("engine_degraded", 1)
                self.metrics.set_gauge("regen_consecutive_failures",
                                       self._regen_failures)
                if self._active is not None:
                    # serving survives: the last-good snapshot keeps
                    # answering (verdicts stay bit-identical to the last
                    # successfully compiled state); _dirty stays set so the
                    # next classify/trigger retries the compile
                    logging.getLogger("cilium_tpu_torch.engine").warning(
                        "regeneration failed (%d consecutive), serving "
                        "last-good snapshot rev %d: %s",
                        self._regen_failures, self._active.revision,
                        self._last_regen_error)
                    return self._active
                raise   # cold start: nothing compiled yet, nothing to serve

    def _regenerate_locked(self, force: bool) -> CompiledSnapshot:
        """The compile+place body of :meth:`regenerate` (lock held)."""
        # flush the coalesced FQDN refresh FIRST — before the dirty-event
        # clear and before the incremental compiler computes its identity
        # delta — so N debounced cache observes materialize as ONE rule
        # refresh whose identity growth/retirement this very cycle sees
        self.repo.flush_fqdn_refresh()
        # clear BEFORE compiling: a concurrent observer marking dirty
        # mid-compile must survive into the next regeneration (clearing
        # after the swap would lose that mark)
        self._dirty_event.clear()
        # regenerations are rare and always worth a trace when tracing is
        # on; the context makes the datapath's nested spans (the
        # datapath.patch.apply scatter) attach to this regeneration
        trace_id = TRACER.force_sample()
        with TRACER.context(trace_id):
            return self._regen_traced(trace_id, force)

    def _regen_traced(self, trace_id, force: bool) -> CompiledSnapshot:
        FAULTS.fire("regen.compile")
        eps = sorted(self.endpoints.values(), key=lambda e: e.ep_id)
        ct_cfg = CTConfig(self.config.ct_capacity,
                          self.config.probe_depth)
        lb_cfg = LBConfig(maglev_m=self.config.maglev_m)

        snap = patch = None
        if (self._inc is not None and self._active is not None
                and not force):
            # NB: lb_cfg is deliberately not passed — LB geometry is
            # fixed at daemon start; LB content changes gate via
            # services_revision
            with TRACER.span(trace_id, "engine.regen.patch"), \
                    self.metrics.span("snapshot_patch").timer():
                result = self._inc.try_update(ct_cfg, endpoints=eps)
            if result is not None:
                snap, patch, stats = result
                self.metrics.inc_counter("regen_incremental_total")
                self.metrics.set_gauge("regen_last_rows_patched",
                                       stats.rows_recomputed)
                # the patch-budget headroom the resource ledger samples
                # (patch_budget / ident_growth rows)
                self._last_update_stats = stats
                if stats.retired_identities:
                    self.metrics.inc_counter(
                        "fqdn_identities_retired_total",
                        stats.retired_identities)
            else:
                logging.getLogger("cilium_tpu_torch.engine").debug(
                    "incremental fallback: %s", self._inc.last_fallback)

        full_build = snap is None
        if full_build:
            with TRACER.span(trace_id, "engine.regen.compile"), \
                    self.metrics.span("snapshot_compile").timer():
                snap = build_snapshot(self.repo, self.ctx, eps,
                                      ct_cfg, lb_cfg)
            self.metrics.inc_counter("regen_full_total")

        try:
            with TRACER.span(trace_id, "engine.regen.place",
                             incremental=patch is not None), \
                    self.metrics.span("device_place").timer():
                if patch is not None and self._active is not None:
                    if patch.is_noop:
                        tensors = self._active.tensors
                    else:
                        tensors = self.datapath.place_patch(
                            self._active.tensors, snap, patch)
                else:
                    tensors = self.datapath.place(snap)
        except Exception:
            # the incremental compiler already advanced past this
            # revision; keeping it would let a retry pair the new
            # snapshot with never-patched device tensors (silent stale
            # policy). Discard — the retry takes the full-build path.
            self._inc = None
            raise
        if full_build and self.config.incremental:
            # seed only after placement succeeded (same staleness trap)
            from cilium_tpu_torch.compile.incremental import \
                IncrementalCompiler
            self._inc = IncrementalCompiler(
                self.repo, self.ctx, eps, snap,
                delta_budget_rows=self.config.patch_delta_rows,
                rebase_rows=self.config.patch_rebase_rows)
        self.repo.prune_changes(snap.revision)
        compiled = CompiledSnapshot(
            snapshot=snap, tensors=tensors,
            world_index=snap.world_index, revision=snap.revision)
        self._active = compiled            # atomic swap (revision fence);
        # _dirty_event was cleared up top — NOT re-cleared here, so a
        # concurrent mark during this compile still forces the next regen
        if self._regen_failures:
            logging.getLogger("cilium_tpu_torch.engine").info(
                "regeneration recovered after %d failures (rev %d)",
                self._regen_failures, snap.revision)
        self._regen_failures = 0
        self._last_regen_error = ""
        for ep in self.endpoints.values():
            ep.policy_revision = snap.revision
        self.metrics.set_gauge("policy_revision", snap.revision)
        self.metrics.set_gauge("policy_image_bytes", snap.nbytes)
        self.metrics.set_gauge("engine_degraded", 0)
        self.metrics.set_gauge("regen_consecutive_failures", 0)
        # flight recorder: the revision trail is what makes a frozen bundle
        # attributable ("which policy world were these verdicts from")
        self.blackbox.record_event("regen", revision=snap.revision,
                                   incremental=patch is not None
                                   and not full_build)
        return compiled

    @property
    def active(self) -> CompiledSnapshot:
        if self._active is None or self._dirty:
            return self.regenerate()
        return self._active

    # -- datapath ---------------------------------------------------------------
    #: StalePlacement retries before giving up: each retry holds the engine
    #: lock from capturing the active snapshot to enqueueing on it, so no
    #: patch can land in between — more than a few in a row means
    #: something is wedged, not racing
    _STALE_RETRIES = 4

    def classify(self, batch: Dict[str, np.ndarray],
                 now: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Classify one batch (dict-of-arrays, kernels/records layout).
        Returns the out pytree as numpy; CT and counters update internally."""
        if now is None:
            now = int(time.time())
        trace_id = TRACER.maybe_sample()
        # the folds are children of engine.classify; the classify timer
        # keeps to the datapath's call
        with TRACER.context(trace_id), \
                TRACER.span(trace_id, "engine.classify"):
            with self.metrics.span("classify").timer():
                for attempt in range(self._STALE_RETRIES):
                    # a retry runs under the engine lock: no regeneration
                    # can patch the handle it captures before it is
                    # enqueued
                    with self._lock if attempt \
                            else contextlib.nullcontext():
                        active = self.active
                        try:
                            out, counters = self.datapath.classify(
                                active.tensors, active.snapshot, batch, now)
                            break
                        except StalePlacement:
                            # a live patch landed between capturing the
                            # handle and enqueueing: retry, holding the
                            # lock, against the post-patch snapshot (same
                            # as having dispatched a moment later)
                            if attempt == self._STALE_RETRIES - 1:
                                raise
            # the step's fingerprints serve only the pipeline's salvage
            # note: the caller gets the reference's columns
            out.pop("est_fp", None)
            self._fold_batch(batch, out, counters, active.snapshot, now)
        return out

    def _fold_batch(self, batch, out, counters, snap, now: int,
                    steered: bool = False) -> None:
        """The finalize folds of one batch whose verdicts are on the host:
        the counters, the flow log, the flow metrics, then the provenance
        hooks. Each fold is an ``engine.fold.*`` span of the thread's
        trace (a no-op unsampled)."""
        tracer, tid = active_trace()
        n_valid = int(np.asarray(batch["valid"]).sum())
        with tracer.span(tid, "engine.fold.metrics"):
            self.metrics.add_batch(counters, n_valid)
        with tracer.span(tid, "engine.fold.flowlog"):
            self.flowlog.append_batch(batch, out, now, snap.ep_ids)
        with tracer.span(tid, "engine.fold.flowmetrics"):
            self.flowmetrics.add_batch(batch, out, now)
        self._observe_batch(batch, out, snap, now, n_valid, steered=steered)

    # -- verdict provenance (observe/audit.py + observe/blackbox.py) ------------
    def _observe_batch(self, batch, out, snap, now: int, n_valid: int,
                       steered: bool = False) -> None:
        """Per-finalized-batch provenance hooks: flight-recorder verdict
        summary (always on) + shadow-audit counter-sampled capture. Both
        are internally never-raise; the serving path cannot be taken down
        by its own observers."""
        tracer, tid = active_trace()
        with tracer.span(tid, "engine.fold.blackbox"):
            self.blackbox.record_verdicts(out, n_valid, now)
        with tracer.span(tid, "engine.fold.audit_capture"):
            self.auditor.maybe_capture(batch, out, snap, now,
                                       steered=steered)
        with tracer.span(tid, "engine.fold.rule_hits"):
            self._fold_rule_hits(out, snap)

    # -- per-rule hit/drop counters ----------------------------------
    def _fold_rule_hits(self, out, snap) -> None:
        """matched_rule provenance → ``policy_rule_hits_total{rule=...}`` /
        ``policy_rule_drops_total{rule=...}``: the unused-rule /
        policy-drift signal. Vectorized (one bincount pass per verdict
        class, Python only over the batch's DISTINCT coordinates — a batch
        matches a handful of rules, not a handful of thousands) and
        capped-cardinality (``rule_metrics_max`` distinct label values
        process-wide, overflow under ``rule="other"``). Never-raise: the
        serving path cannot be taken down by its own observers."""
        cap = self.config.rule_metrics_max
        if cap <= 0 or not isinstance(out, dict) \
                or "matched_rule" not in out:
            return
        try:
            mr = np.asarray(out["matched_rule"])
            allow = np.asarray(out["allow"])
            ran = mr >= 0
            if not bool(ran.any()):
                return
            coords = mr[ran].astype(np.int64)
            allowed = allow[ran]
            # bincount over unique-compacted indices: O(batch), never
            # O(max coordinate) — a 50k-rule world's cell space would
            # otherwise allocate megabyte count arrays per finalized batch
            uniq, inv = np.unique(coords, return_inverse=True)
            hits = np.bincount(inv[allowed], minlength=uniq.size)
            drops = np.bincount(inv[~allowed], minlength=uniq.size)
            with self._rule_fold_lock:
                if snap is not self._rule_label_snap:
                    # labels are coordinate-space-relative; a new snapshot
                    # re-resolves (already-seen label STRINGS keep their
                    # series — the cap is on strings, not snapshots)
                    self._rule_label_memo.clear()
                    self._rule_label_snap = snap
                for u in range(uniq.size):
                    c = int(uniq[u])
                    label = self._rule_label_memo.get(c)
                    if label is None:
                        label = self._resolve_rule_label(c, snap, cap)
                        self._rule_label_memo[c] = label
                    if hits[u]:
                        self.metrics.inc_counter(
                            f'policy_rule_hits_total{{rule="{label}"}}',
                            int(hits[u]))
                    if drops[u]:
                        self.metrics.inc_counter(
                            f'policy_rule_drops_total{{rule="{label}"}}',
                            int(drops[u]))
        except Exception:   # noqa: BLE001
            log.exception("per-rule hit fold failed")
            self.metrics.inc_counter("rule_metrics_errors_total")

    def _resolve_rule_label(self, coord: int, snap, cap: int) -> str:
        """One matched_rule coordinate → its stable label:
        ``ic<id_class>/pc<port_class>[/id<representative identity>]``.
        Holds ``_rule_fold_lock``."""
        npc = max(1, snap.port_classes.n_classes)
        ic, pc = divmod(coord, npc)
        label = f"ic{ic}/pc{pc}"
        if 0 <= ic < snap.id_classes.n_classes:
            rep = int(snap.id_classes.representative[ic])
            if rep >= 0:
                label += f"/id{rep}"
        if label not in self._rule_labels_seen:
            if len(self._rule_labels_seen) >= cap:
                return "other"
            self._rule_labels_seen.add(label)
        return label

    def explain_provenance(self, flows: Sequence[Dict]) -> Dict:
        """Legend for the provenance coordinates in ``flows`` (observe API
        / CLI): matched_rule → id-class/port-class/representative-identity,
        lpm_prefix → the canonical ipcache prefix — resolved against the
        ACTIVE snapshot. Records predating the current revision may name
        coordinates the legend cannot resolve; they return ``resolved:
        False`` rather than a wrong answer."""
        active = self.active
        snap = active.snapshot if active is not None else None
        rules: Dict[str, Dict] = {}
        prefixes: Dict[str, Dict] = {}
        for r in flows:
            mr = int(r.get("matched_rule", -1))
            if mr >= 0 and str(mr) not in rules:
                if snap is not None:
                    npc = max(1, snap.port_classes.n_classes)
                    ic, pc = divmod(mr, npc)
                    ok = 0 <= ic < snap.id_classes.n_classes
                    rep = int(snap.id_classes.representative[ic]) \
                        if ok else -1
                    rules[str(mr)] = {
                        "resolved": ok, "id_class": ic, "port_class": pc,
                        "rep_identity": rep,
                        "label": self._rule_label_memo.get(
                            mr, f"ic{ic}/pc{pc}")}
                else:
                    rules[str(mr)] = {"resolved": False}
            lp = int(r.get("lpm_prefix", -1))
            if lp >= 0 and str(lp) not in prefixes:
                if snap is not None:
                    d = snap.lpm.describe(lp)
                    d["resolved"] = d["prefix"] is not None
                    prefixes[str(lp)] = d
                else:
                    prefixes[str(lp)] = {"resolved": False}
        return {"rules": rules, "prefixes": prefixes,
                "revision": active.revision if active is not None else -1}

    def _on_parity_mismatch(self, detail: Dict) -> None:
        """Auditor mismatch sink: narrate to the flight recorder (which
        freezes a debug bundle on this kind — the offending rows + revision
        ride in the detail) and pin the degraded flag health() folds in."""
        self.metrics.set_gauge("parity_audit_degraded", 1)
        self.blackbox.record_event("parity-mismatch", **detail)

    def _pipeline_event(self, kind: str, **attrs) -> None:
        """Pipeline guard-event sink → flight recorder (breaker
        transitions, watchdog restarts, sheds)."""
        self.blackbox.record_event(kind, **attrs)

    def audit_step(self, budget: Optional[int] = None) -> Optional[Dict]:
        """One parity-audit replay sweep (the ``parity-audit`` controller
        body; also directly callable from tests/drills)."""
        return self.auditor.step(budget=budget)

    def debug_bundle(self, clear: bool = False) -> Dict:
        """The flight-recorder export: the frozen anomaly bundle when one
        exists (parity mismatch, breaker open, watchdog restart, shed
        spike), else a live snapshot — enriched with the engine state an
        operator needs to replay it (health, pipeline/feeder stats, audit
        counters + mismatch details, active revision). ``clear=True`` is
        the operator re-arm: the recorder unfreezes AND the auditor's
        mismatch state resets, so health() returns to OK and the next
        divergence degrades/freezes afresh."""
        active = self._active
        extra = {
            "health": self.health(),
            "active_revision": active.revision if active else None,
            "pipeline": self.pipeline_stats(),
            "feeder": self.feeder_stats(),
            "audit": self.auditor.stats(),
            "audit_mismatches": list(self.auditor.mismatches),
            "blackbox": self.blackbox.stats(),
        }
        doc = self.blackbox.bundle(extra=extra, clear=clear)
        if clear:
            self.auditor.rearm()
            self.metrics.set_gauge("parity_audit_degraded", 0)
        return doc

    # -- pipelined ingestion (pipeline/scheduler.py) ----------------------------
    def start_pipeline(self):
        """The async ingestion path beside :meth:`classify`: a bounded-queue
        scheduler that coalesces sub-full submissions into bucketed shapes
        and overlaps host staging/transfer with the previous batch's device
        compute (``DatapathBackend.classify_async``). Created lazily; knobs
        come from ``DaemonConfig.pipeline_*``."""
        with self._lock:
            if self._pipeline is None:
                from cilium_tpu_torch.pipeline import Pipeline, PipelineClosed
                if self._pipeline_stopped:
                    raise PipelineClosed(
                        "engine stopped; no new pipeline submissions")
                cfg = self.config
                # flow-sharded backends (the multi-chip mesh) want batches
                # pre-steered: the pipeline's staging ring grows per-shard
                # segments and steers at stage-write time, so one submit()
                # saturates every chip behind the one admission queue.
                # With device-side RSS (rss_mode="device") pipeline_shards
                # is 1 — rows stage contiguously in arrival order, direct
                # bucket-shaped dispatch comes back, and the shard_map
                # body's ppermute exchange owns flow→shard resolution; the
                # mesh size rides along for the per-mesh guard surface.
                shards = getattr(self.datapath, "pipeline_shards", 1)
                rss = getattr(self.datapath, "rss_state", None) or {}
                rss_mode = rss.get("mode", "host")
                mesh_shards = rss.get("shards", shards)
                self._pipeline_sharded = shards > 1
                min_bucket = min(cfg.pipeline_min_bucket, cfg.batch_size)
                if rss_mode == "device":
                    # every bucket must divide the mesh's flow axis (each
                    # chip takes an equal pow2 arrival-order slice)
                    min_bucket = max(min_bucket, mesh_shards)
                self._pipeline = Pipeline(
                    self._pipeline_dispatch, metrics=self.metrics,
                    max_bucket=cfg.batch_size,
                    min_bucket=min_bucket,
                    queue_batches=cfg.pipeline_queue_batches,
                    admission=cfg.pipeline_admission,
                    block_timeout_s=cfg.pipeline_block_timeout_s,
                    flush_ms=cfg.pipeline_flush_ms,
                    inflight=cfg.pipeline_inflight,
                    deadline_ms=cfg.pipeline_deadline_ms,
                    breaker_threshold=cfg.pipeline_breaker_threshold,
                    breaker_cooldown_s=cfg.pipeline_breaker_cooldown_s,
                    stall_timeout_s=cfg.pipeline_stall_timeout_s,
                    max_restarts=cfg.pipeline_max_restarts,
                    restart_backoff_s=cfg.pipeline_restart_backoff_s,
                    n_shards=shards,
                    shard_fn=self._pipeline_shard_of if shards > 1
                    else None,
                    shard_headroom=cfg.pipeline_shard_headroom,
                    # pre-binned shards are only trusted while the binning
                    # revision is still active (LB changes move the
                    # post-DNAT steer hash)
                    shard_rev_fn=(lambda: self._active.revision
                                  if self._active is not None else -1)
                    if shards > 1 else None,
                    mesh_shards=mesh_shards,
                    rss_mode=rss_mode,
                    event_sink=self._pipeline_event,
                    # device-loss park protocol: a DeviceLost
                    # dispatch failure parks the worker and signals here
                    # instead of spending restart budget on a chip that
                    # will not come back; the mesh-heal controller answers
                    # with the fenced re-mesh. Unsharded (or healing
                    # disabled): no callback — DeviceLost degrades to the
                    # breaker path like any other dispatch failure.
                    on_device_loss=self._on_device_loss
                    if self._pipeline_sharded and cfg.remesh_enabled
                    else None,
                    qos=self.qos,
                    # the lane shape must stay a valid bucket: within
                    # [1, min_bucket] and, on a device-RSS mesh, still
                    # divisible across the flow axis (>= mesh_shards)
                    lane_bucket=min(max(cfg.qos_lane_bucket,
                                        mesh_shards
                                        if rss_mode == "device" else 1),
                                    min_bucket)
                    if self.qos is not None else 0)
            return self._pipeline

    def submit(self, batch: Dict[str, np.ndarray],
               now: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               ingest_mono: Optional[float] = None):
        """Admit one batch into the ingestion pipeline; returns a Ticket
        whose ``result()`` is bit-identical to what :meth:`classify` would
        return for the same batch in the same order. ``deadline_ms``
        bounds staleness (default ``config.pipeline_deadline_ms``); a
        submission the worker cannot serve in time is shed with
        ``PipelineDeadlineExceeded``. ``ingest_mono`` (monotonic seconds)
        is the producer's harvest stamp — it rides the ticket so
        verdict-apply can compute true ingest→verdict latency. Raises
        ``PipelineUnavailable`` while the dispatch circuit breaker is open
        or after the pipeline hard-failed (watchdog restart budget
        exhausted)."""
        return self.start_pipeline().submit(batch, now=now,
                                            deadline_ms=deadline_ms,
                                            ingest_mono=ingest_mono)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until every pipeline submission so far has resolved."""
        pl = self._pipeline           # local ref: stop() may null the field
        if pl is None:
            return True
        return pl.drain(timeout=timeout)

    def pipeline_stats(self) -> Optional[Dict]:
        pl = self._pipeline
        return pl.stats() if pl is not None else None

    def _pipeline_shard_of(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """Per-row flow-shard ids for the sharded staging ring: the
        direction-normalized flow hash over the ACTIVE snapshot's LB tables
        (service flows steer by their post-DNAT tuple — the same
        translation the datapath and the shim run), mod the mesh's flow
        axis. Called from the pipeline worker at stage-write time for rows
        the producer didn't pre-bin."""
        from cilium_tpu_torch.parallel.mesh import flow_shard_of
        snap = self.active.snapshot
        lb = snap.lb if snap.lb.n_frontends else None
        return flow_shard_of(batch, self.datapath.pipeline_shards, lb=lb)

    def _pipeline_dispatch(self, batch: Dict[str, np.ndarray], now: int,
                           steer_rev: Optional[int] = None):
        """One microbatch through the datapath (called from the pipeline
        worker). Captures the active snapshot per dispatch — same revision
        fencing as classify — and defers metrics/flow-log to finalize, when
        the verdicts are actually on the host. ``steer_rev`` (sharded
        pipelines) is the revision the bucket was steered under; when a
        regen slipped in between stage-write and now, the batch is handed
        to the datapath un-pre-steered so it re-steers against THIS
        snapshot's LB tables (counted ``pack_fallback_steered`` — rare and
        attributable) instead of stranding service flows' CT entries on
        the wrong shard."""
        for attempt in range(self._STALE_RETRIES):
            # a retry runs under the engine lock: no regeneration can
            # patch the handle it captures before it is enqueued
            with self._lock if attempt else contextlib.nullcontext():
                active = self.active
                raw = batch.get("_ep_raw")
                if raw is not None and raw.any():
                    # shim-fed rows carry their raw endpoint ids (raw !=
                    # 0): re-map them onto THIS dispatch's snapshot — slots
                    # are re-enumerated on regen, so a harvest-time mapping
                    # can go stale in the queue and classify rows under
                    # another endpoint's policy. Unknown ids fail closed;
                    # rows without a raw id (non-shim producers coalesced
                    # into the same bucket) keep their submitted ep_slot
                    # untouched. Vectorized via the same per-snapshot LUT
                    # the feeder uses (cached; one worker thread calls
                    # this, no lock needed). Re-runs on a StalePlacement
                    # retry: the mapping must follow the snapshot actually
                    # classifying.
                    from cilium_tpu_torch.shim.feeder import \
                        build_slot_lut, map_raw_slots
                    snap = active.snapshot
                    if snap is not self._remap_snap:
                        self._remap_lut = build_slot_lut(snap.ep_slot_of)
                        self._remap_snap = snap
                    slots = map_raw_slots(raw, snap.ep_slot_of,
                                          self._remap_lut)
                    has = raw != 0
                    good = has & (slots >= 0)
                    batch["ep_slot"][good] = slots[good]
                    batch["valid"] &= ~(has & (slots < 0))
                try:
                    with self.metrics.span("pipeline_dispatch").timer():
                        # a sharded pipeline's staging ring delivers rows
                        # already grouped into per-shard segments: the
                        # datapath packs them in place and ships each chip
                        # its own segment — verdicts come back in the
                        # steered geometry, un-steered per-ticket by the
                        # pipeline's finalize gather. The kwarg rides only
                        # on sharded engines so duck-typed 4-arg backends
                        # stay compatible.
                        if self._pipeline_sharded:
                            fin = self.datapath.classify_async(
                                active.tensors, active.snapshot, batch, now,
                                pre_steered=steer_rev is not None
                                and steer_rev == active.revision)
                        else:
                            fin = self.datapath.classify_async(
                                active.tensors, active.snapshot, batch, now)
                    break
                except StalePlacement:
                    # a live delta patch donated the captured handle's
                    # buffers between capture and enqueue: dispatch again,
                    # holding the lock, against the patched snapshot
                    if attempt == self._STALE_RETRIES - 1:
                        raise

        def finalize():
            out, counters = fin()
            # the step's flow fingerprints (absent where no classify step
            # built ``out``) feed the salvage note alone: the folds, the
            # observers and the ticket see the reference's columns
            fp = out.pop("est_fp", None)
            if batch.get("_canary") is not None:
                # scheduler recovery canary: synthetic
                # all-invalid rows proving the datapath round-trips after
                # a restart/re-mesh — invisible to every accounting
                # surface (no metrics, flow log, observers, or grace-
                # window learning)
                return out
            # the finalize capture hook: batch/out are still the live
            # (un-recycled) staging views here — the audit copy happens
            # before the scheduler recycles the buffer
            self._fold_batch(batch, out, counters, active.snapshot, now,
                             steered=self._pipeline_sharded)
            # CT-salvage grace window: strictly AFTER the
            # audit capture — the auditor judges the datapath's raw
            # verdict (oracle parity must stay exact), while the APPLIED
            # verdict rides the bounded established-fingerprint grace
            tracer, tid = active_trace()
            with tracer.span(tid, "engine.fold.salvage",
                             fp="host" if fp is None else "step"):
                return self._ct_salvage_apply(batch, out, fp)
        return finalize

    # -- async shim ingestion (shim/feeder.py) ----------------------------------
    def start_feeder(self, shim):
        """Attach an async shim→pipeline feeder: a harvest thread polls
        ``shim`` on a budget, submits harvested batches into the ingestion
        pipeline (reusable poll buffers, no per-poll allocation), and
        applies verdicts FIFO as tickets resolve — replacing the
        synchronous poll→classify→apply loop. Knobs: ``ingest_*`` in
        DaemonConfig. Stopped (drained) by :meth:`stop`."""
        with self._lock:
            if self._feeder is not None:
                return self._feeder
            from cilium_tpu_torch.shim.feeder import ShimFeeder
            cfg = self.config
            if shim.batch_size > cfg.batch_size:
                # fail fast: a harvest batch that can't fit the pipeline's
                # largest bucket would reject EVERY submission — the feeder
                # would run "healthy" while fail-closing 100% of traffic
                raise ValueError(
                    f"shim batch_size {shim.batch_size} exceeds the "
                    f"pipeline's max bucket (batch_size={cfg.batch_size})")
            self.start_pipeline()
            if cfg.fqdn_proxy_enabled and self._dns_proxy is None:
                # in-band DNS plane: the learning tap rides the feeder's
                # verdict-apply path (fqdn/proxy.py — fail-open, counted)
                from cilium_tpu_torch.fqdn.proxy import DNSProxy
                self._dns_proxy = DNSProxy(
                    self.ctx.fqdn_cache, metrics=self.metrics,
                    min_ttl=cfg.fqdn_min_ttl, port=cfg.fqdn_proxy_port)
            self._feeder = ShimFeeder(
                shim, self,
                pool_batches=cfg.ingest_pool_batches,
                poll_budget=cfg.ingest_poll_budget,
                idle_sleep_s=cfg.ingest_idle_sleep_s,
                slo_ms=cfg.slo_e2e_ms,
                # steered mesh: harvest computes the flow-shard hash during
                # ep-slot mapping (vectorized, shares flow_shard_of) so the
                # staging ring's flush-time scatter is a copy, not a
                # re-hash — the feeder IS the software RSS. With
                # rss_mode="device" pipeline_shards is 1: pre-binning
                # disappears from the harvest path entirely (the in-kernel
                # ppermute exchange owns flow→shard resolution).
                n_shards=getattr(self.datapath, "pipeline_shards", 1),
                metrics=self.metrics, tracer=self.tracer,
                # SHED-NEW harvest drops narrate to the flight recorder
                # (the relaxed shed-spike class) like pipeline sheds do
                event_sink=self._pipeline_event,
                # QoS armed: harvest stamps the per-row tenant id the
                # admission queue's weighted-fair scheduling keys on
                qos=self.qos,
                # DNS plane armed: poll buffers grow the payload columns
                # and the verdict-apply path taps the learning proxy
                fqdn=self._dns_proxy).start()
            return self._feeder

    def feeder_stats(self) -> Optional[Dict]:
        fd = self._feeder
        return fd.stats() if fd is not None else None

    def _ct_pressure_update(self, occ_frac: float) -> None:
        """Hysteresis latch for the CT emergency-GC mode: enter above
        ``ct_pressure_high``, exit below ``ct_pressure_low``. Transitions
        are gauged, counted and narrated to the flight recorder (recorded,
        never frozen — commanded degradation is the system working)."""
        cfg = self.config
        if not self._ct_emergency and occ_frac >= cfg.ct_pressure_high:
            self._ct_emergency = True
            self.metrics.set_gauge("ct_emergency_gc", 1)
            self.metrics.inc_counter("ct_emergency_entries_total")
            self.blackbox.record_event("ct-emergency", action="enter",
                                       occupancy=round(occ_frac, 4))
        elif self._ct_emergency and occ_frac <= cfg.ct_pressure_low:
            self._ct_emergency = False
            self.metrics.set_gauge("ct_emergency_gc", 0)
            self.blackbox.record_event("ct-emergency", action="exit",
                                       occupancy=round(occ_frac, 4))

    # -- mesh self-healing: device-loss detection → fenced
    # re-mesh onto survivors → CT salvage → hysteretic re-admission ----------
    def _on_device_loss(self, device: int, reason: str) -> None:
        """Pipeline → engine device-loss signal. Runs on the pipeline
        worker mid-failure handling, so it must not call back into the
        pipeline — the freezing ``device-loss`` flight-recorder event
        already rode the event sink; here only the attribution counter
        and the heal-hysteresis reset (a chip that just died restarts
        its probe-pass streak from zero)."""
        self.metrics.inc_counter(
            f'device_loss_total{{device="{device}"}}')
        self._heal_ok_since = None

    def remesh_step(self) -> Optional[Dict]:
        """One tick of the ``mesh-heal`` controller (directly callable
        from the cfg10 bench/tests for deterministic driving).

        DOWN: any latched-dead ordinal still in the serving set triggers
        a fenced re-mesh onto the survivors — the wedged in-flight window
        is rejected, queued submissions survive, CT salvages, and the
        bounded established-fingerprint grace window arms.

        UP: configured-but-departed ordinals are canary-probed
        (``probe_device``: the chaos drill first, then a real host→device
        round trip); only after every probe has passed continuously for
        ``remesh_heal_hysteresis_s`` does the reverse re-mesh re-admit
        them — a flapping chip re-zeroes the streak via
        :meth:`_on_device_loss` and never thrashes the mesh."""
        cfg = self.config
        dp = self.datapath
        mh = getattr(dp, "mesh_health", None)
        if not cfg.remesh_enabled or mh is None:
            return None
        h = mh()
        if h["configured"] <= 1:
            return None
        live = list(h["live_ordinals"])
        dead = set(h["dead_ordinals"])
        doc: Dict = {"configured": h["configured"], "live": len(live),
                     "remesh": None}
        dead_live = [o for o in live if o in dead]
        if dead_live:
            target = [o for o in live if o not in dead]
            if not target:
                # every shard latched dead: nothing to re-mesh onto —
                # the parked pipeline's guard surface tells that story
                doc["remesh"] = "no-survivors"
                return doc
            doc["remesh"] = self._remesh_to(target, reason="device-loss")
            return doc
        departed = [o for o in range(h["configured"]) if o not in live]
        if not departed:
            self._heal_ok_since = None
            return doc
        healthy = [o for o in departed if dp.probe_device(o)]
        if not healthy:
            self._heal_ok_since = None
            return doc
        now = time.monotonic()
        if self._heal_ok_since is None:
            self._heal_ok_since = now
        doc["heal_ok_s"] = round(now - self._heal_ok_since, 3)
        if now - self._heal_ok_since >= cfg.remesh_heal_hysteresis_s:
            for o in healthy:
                dp.note_device_healed(o)
            self._heal_ok_since = None
            doc["remesh"] = self._remesh_to(sorted(live + healthy),
                                            reason="heal")
        return doc

    def _remesh_to(self, target, reason: str) -> Optional[Dict]:
        """Fenced re-mesh to exactly the ``target`` ordinals: fence the
        pipeline generation (wedged in-flight window rejected with an
        attributable PipelineError, queued submissions survive), swap the
        datapath mesh with CT salvage, then recompile and re-place the
        snapshot onto the survivor mesh under a BUMPED revision — the
        bump is the steering fence: every pre-binned ``_shard`` stamp
        hashed mod the old flow-axis width becomes visibly stale and is
        re-steered at stage-write. The scheduler adopts the returned
        geometry (n_shards / mesh_shards / re-clamped min_bucket) and
        restarts dispatch canary-first."""
        dp = self.datapath
        with self._remesh_lock:
            old = int(dp.n_flow_shards)
            result: Dict = {}

            def rebuild():
                with self._lock:
                    active = self._active
                    res = dp.remesh(
                        target,
                        fence_handle=active.tensors
                        if active is not None else None,
                        salvage_floor=self._ct_salvage_arrays())
                    result.update(res)
                    if not res.get("noop"):
                        # the incremental compiler's patch path targets
                        # the now-fenced placement: discard it and force
                        # a full compile+place on the NEW mesh. A compile
                        # failure here raises through — the scheduler
                        # restarts the generation and the breaker narrates
                        # the doubly-degraded state; serving the fenced
                        # handle would only StalePlacement forever.
                        self._inc = None
                        self.repo.bump_revision()
                        self._dirty_event.set()
                        self._regenerate_locked(force=True)
                new_mesh = int(dp.n_flow_shards)
                min_bucket = min(self.config.pipeline_min_bucket,
                                 self.config.batch_size)
                rss = getattr(dp, "rss_state", None) or {}
                if rss.get("mode") == "device":
                    # every bucket must still divide the (new) flow axis
                    min_bucket = max(min_bucket, new_mesh)
                return {"n_shards": getattr(dp, "pipeline_shards", 1),
                        "mesh_shards": new_mesh,
                        "min_bucket": min_bucket}

            pl = self._pipeline
            if pl is not None:
                geom = pl.remesh(rebuild, reason=reason)
            else:
                # no pipeline (classify-only engines, unit drills): the
                # datapath swap alone is the whole fence
                geom = rebuild()
                self._pipeline_event(
                    "remesh", ok=True, reason=reason,
                    n_shards=geom["n_shards"],
                    mesh_shards=geom["mesh_shards"])
            if result.get("noop"):
                return result
            new = int(result.get("to", dp.n_flow_shards))
            self.metrics.inc_counter(
                f'datapath_remesh_total{{from="{old}",to="{new}"}}')
            if new < old:
                # the grace window arms only on the DEGRADE direction:
                # healing back carries the whole salvaged table with it
                self._salvage_until = time.monotonic() \
                    + self.config.remesh_grace_s
            self._remesh_last = {**result, "reason": reason,
                                 "geometry": geom, "t": time.time()}
            return self._remesh_last

    def _ct_salvage_apply(self, batch: Dict[str, np.ndarray],
                          out: Dict[str, np.ndarray],
                          fp: Optional[np.ndarray] = None
                          ) -> Dict[str, np.ndarray]:
        """Post-audit verdict overlay for the bounded post-remesh grace
        window. Every finalized batch feeds the established-fingerprint
        filter (the window must be warm BEFORE a loss); while the window
        is open, denied rows whose fingerprint was stamped established
        pre-loss flip to allow — established flows ride over the lost
        shard's CT while forward packets cold-learn entries on the
        survivor mesh. Counted ``ct_salvage_grace_hits_total``; never
        raises; copies on flip (the auditor holds the raw arrays).

        ``fp``: the rows' fingerprints as the classify step computed them
        (its ``est_fp``); without them the filter hashes on the host. The
        rows stamped count under ``ct_salvage_fp_rows_total{source=...}``,
        ``step`` or ``host``."""
        try:
            stamped = self._salvage_fp.note(batch, out, fp)
            if stamped:
                source = "host" if fp is None else "step"
                self.metrics.inc_counter(
                    f'ct_salvage_fp_rows_total{{source="{source}"}}',
                    stamped)
            if time.monotonic() >= self._salvage_until:
                return out
            allow = np.asarray(out["allow"])
            m = (np.asarray(batch["valid"]) & ~allow
                 & self._salvage_fp.hits(batch, fp))
            n = int(m.sum())
            if not n:
                return out
            out = dict(out)
            allow = allow.copy()
            allow[m] = True
            reason = np.asarray(out["reason"]).copy()
            reason[m] = 0
            out["allow"] = allow
            out["reason"] = reason
            self.metrics.inc_counter("ct_salvage_grace_hits_total", n)
        except Exception:   # noqa: BLE001 — overlay, never load-bearing
            log.exception("ct-salvage grace overlay failed")
        return out

    def _ct_salvage_arrays(self) -> Optional[Dict[str, np.ndarray]]:
        """The archive salvage floor for a re-mesh whose device gather
        fails (the chip died holding the collective): the newest
        ct-snapshot archive, or None when the controller is off / has not
        written one — the re-mesh then falls through to a cold table."""
        d = self.config.ct_snapshot_dir
        if not d:
            return None
        from cilium_tpu_torch.runtime import checkpoint
        newest = checkpoint.newest_ct_archive(d)
        if newest is None:
            return None
        return checkpoint.load_ct_archive(newest)

    def ct_snapshot_step(self, now: Optional[float] = None
                         ) -> Optional[Dict]:
        """One tick of the ``ct-snapshot`` controller: gather the CT
        table to host and write one timestamped archive (atomic,
        self-describing format, pruned to ``ct_snapshot_keep``) — the
        bounded-staleness salvage floor. The ``device.collective`` chaos
        point fails the gather here exactly like it fails a re-mesh
        gather; controller supervision backs off, the archive ages, and
        ``checkpoint_age_seconds`` / CHECKPOINT_STALE make the lost
        redundancy visible (the ``finally`` keeps the age gauge honest
        even on a failing tick; -1 = no archive yet)."""
        cfg = self.config
        if not cfg.ct_snapshot_dir:
            return None
        from cilium_tpu_torch.runtime import checkpoint as ckpt
        if now is None:
            now = time.time()
        doc = None
        try:
            FAULTS.fire("device.collective")
            arrays = self.datapath.ct_arrays()
            path = ckpt.save_ct_archive(cfg.ct_snapshot_dir, arrays,
                                        keep=cfg.ct_snapshot_keep)
            doc = {"path": path,
                   "entries": int((arrays["expiry"] > 0).sum())}
        finally:
            age = ckpt.ct_archive_age_s(cfg.ct_snapshot_dir, now=now)
            self.metrics.set_gauge(
                "checkpoint_age_seconds",
                round(age, 3) if age is not None else -1.0)
        return doc

    def remesh_status(self) -> Dict:
        """Operator surface for the self-healing plane (``/v1/status`` /
        CLI): mesh width + per-device health from the datapath, the last
        re-mesh record, cumulative salvage stats, and the live grace
        window."""
        dp = self.datapath
        mh = getattr(dp, "mesh_health", None)
        doc: Dict = {"enabled": bool(self.config.remesh_enabled),
                     "mesh": mh() if mh is not None else None,
                     "last_remesh": self._remesh_last,
                     "stats": dict(getattr(dp, "remesh_stats", {}) or {})}
        grace = self._salvage_until - time.monotonic()
        doc["salvage_grace_remaining_s"] = round(grace, 3) \
            if grace > 0 else 0.0
        return doc

    def sweep(self, now: Optional[int] = None) -> int:
        """CT garbage collection, host-driven whole-table mode (upstream
        ctmap GC): blocks on the device sweep. The ct-gc controller only
        runs this for backends without the overlapped device sweep (or
        with ``ct_gc_overlap`` off); it remains directly callable for
        tests/CLI. In emergency mode (occupancy latched above
        ``ct_pressure_high``) the sweep runs with the effective TTL
        slashed — entries within ``ct_gc_emergency_ttl_slash_s`` of expiry
        are reclaimed early."""
        if now is None:
            now = int(time.time())
        eff_now = now + (self.config.ct_gc_emergency_ttl_slash_s
                         if self._ct_emergency else 0)
        reclaimed = self.datapath.sweep(eff_now)
        self.metrics.set_gauge("ct_last_sweep_reclaimed", reclaimed)
        if reclaimed:
            self.metrics.inc_counter("ct_gc_reclaimed_total", reclaimed)
        # occupancy export: ct_stats waits for the device under the
        # classify lock — acceptable at this path's sweep_interval_s
        # cadence, and the reason the overlapped sweep_step reads its
        # occupancy one tick late instead of ever calling this
        st = self.datapath.ct_stats(now)
        occ = st["live"] / max(1, st["capacity"])
        self.metrics.set_gauge("ct_occupancy", round(occ, 6))
        self._ct_pressure_update(occ)
        return reclaimed

    def sweep_step(self, now: Optional[int] = None) -> Optional[Dict]:
        """One tick of the overlapped device-side CT GC (the ``ct-gc``
        controller body on capable backends): enqueue a donated chunk sweep
        that interleaves with live classify steps, harvest the previous
        tick's reclaimed/occupancy scalars, and export them
        (``ct_gc_reclaimed_total`` counter, ``ct_occupancy`` gauge — a
        live/capacity FRACTION). The ``ct.gc`` fault point drills the
        controller's supervised backoff.

        EMERGENCY mode (hysteresis latch on occupancy, see
        ``_ct_pressure_update``): the tick runs ``ct_gc_emergency_chunks``
        chunk sweeps instead of one, each with the effective TTL slashed
        by ``ct_gc_emergency_ttl_slash_s`` — full-rate reclamation that
        eats a flood's short-lived entries while leaving established
        flows' 21600s lifetimes untouched. Occupancy always measures on
        the REAL clock (only the sweep threshold is slashed): a slashed
        count would exclude live entries the sweep has not reached yet,
        read artificially low, and flap the enter/exit latch under a
        sustained flood."""
        FAULTS.fire("ct.gc")
        if now is None:
            now = int(time.time())
        cfg = self.config
        emergency = self._ct_emergency
        chunks = cfg.ct_gc_emergency_chunks if emergency else 1
        slash = cfg.ct_gc_emergency_ttl_slash_s if emergency else 0
        # GC ticks are rare: always trace one (the datapath.ct.gc span
        # needs a context to attach to)
        reclaimed = 0
        with TRACER.context(TRACER.force_sample()):
            for _ in range(chunks):
                # the slash rides only the SWEEP clock; occupancy keeps
                # measuring at the real `now` (a slashed count would read
                # low and flap the pressure latch)
                st = self.datapath.sweep_step(now, cfg.ct_gc_chunk_rows,
                                              ttl_slash_s=slash)
                reclaimed += st["reclaimed"]
        if emergency:
            self.metrics.inc_counter("ct_emergency_sweeps_total", chunks)
        if reclaimed:
            self.metrics.inc_counter("ct_gc_reclaimed_total", reclaimed)
        if st["live"] >= 0:
            occ = st["live"] / max(1, cfg.ct_capacity)
            self.metrics.set_gauge("ct_occupancy", round(occ, 6))
            self._ct_pressure_update(occ)
        self.metrics.set_gauge("ct_gc_epoch", st["epoch"])
        self.metrics.set_gauge("ct_gc_cursor", st["cursor"])
        st = dict(st)
        st["reclaimed"] = reclaimed
        st["emergency"] = emergency
        return st

    def overload_step(self) -> Optional[Dict]:
        """One tick of the overload-ladder controller (the ``overload``
        controller body; directly callable from the cfg6 bench/tests for
        deterministic logical-time driving). Folds queue occupancy,
        shed+admission-drop rate, and CT occupancy into the
        pipeline/guard.OverloadLadder state machine and propagates the
        state to the shedding sites: the admission queue (priority
        shedding at PRESSURE, fail-fast at OVERLOAD) and the shim feeder
        (harvest-time SHED-NEW). Transitions are gauged, counted, and
        recorded as flight-recorder events (never frozen — the ladder IS
        the system surviving). The ``overload.decide`` fault point drills
        the controller's supervised backoff: a failing decider leaves the
        last propagated state standing."""
        FAULTS.fire("overload.decide")
        cfg = self.config
        if self._overload is None:
            from cilium_tpu_torch.pipeline.guard import OverloadLadder
            self._overload = OverloadLadder(
                queue_high=cfg.overload_queue_high,
                queue_low=cfg.overload_queue_low,
                shed_high=cfg.overload_shed_rate_high,
                shed_low=cfg.overload_shed_rate_low,
                ct_high=cfg.ct_pressure_high,
                ct_low=cfg.ct_pressure_low,
                resource_high=cfg.overload_resource_high,
                resource_low=cfg.overload_resource_low,
                up_ticks=cfg.overload_up_ticks,
                down_ticks=cfg.overload_down_ticks)
        pl = self._pipeline
        ps = pl.stats() if pl is not None else None
        fd = self._feeder
        # the feeder's harvest-time prio sheds ride the shed signal too:
        # under SHED-NEW the queue pressure vanishes BY DESIGN (that is the
        # relief), and without this term the ladder would descend mid-storm
        # and oscillate — sustained harvest shedding keeps the rung held
        # until the flood actually stops
        fd_shed = fd.prio_shed_rows if fd is not None else 0
        if ps is not None:
            queue_frac = ps["queue_depth"] / max(1, ps["queue_max"])
            shed_now = ps["shed_total"] + ps["admission_drops"] + fd_shed
        else:
            queue_frac = 0.0
            shed_now = self._overload_shed_prev
        t = time.monotonic()
        dt = (t - self._overload_shed_t) if self._overload_shed_t \
            else cfg.overload_interval_s
        rate = max(0, shed_now - self._overload_shed_prev) / max(dt, 1e-3)
        self._overload_shed_prev = shed_now
        self._overload_shed_t = t
        ct_occ = float(self.metrics.gauges.get("ct_occupancy", 0.0))
        # the ledger's fourth latch: worst NON-CT failure-class pressure
        # (CT and the admission queue are already the ladder's own
        # signals; graceful-degradation pools report pressure 0 anyway)
        exclude = LADDER_EXCLUDE
        if self.qos is not None:
            # per-tenant queue rows must not light the GLOBAL ladder: one
            # tenant hitting its own cap is isolation working as designed
            # (the aggregate admission_queue signal already covers real
            # queue pressure) — tenant-scoped relief happens at the
            # admission sites (over_share fail-fast, pressure-ordered
            # victim selection), not on the cluster-wide rung
            exclude = tuple(LADDER_EXCLUDE) + tuple(
                f"qos_tenant_queue_{n}"
                for n in self.qos.tenants().values())
        res_p = self.ledger.max_pressure(exclude=exclude)
        state, changed = self._overload.observe(queue_frac, rate, ct_occ,
                                                resource_pressure=res_p)
        if pl is not None:
            pl.set_overload_state(state)
        fd = self._feeder
        if fd is not None:
            fd.set_overload_state(state)
        self.metrics.set_gauge("overload_state", state)
        if changed:
            from cilium_tpu_torch.pipeline.guard import OVERLOAD_STATE_NAMES
            name = OVERLOAD_STATE_NAMES[state]
            self.metrics.inc_counter(
                f'overload_transitions_total{{to="{name}"}}')
            self.blackbox.record_event(
                "overload", state=name,
                queue_frac=round(queue_frac, 4),
                shed_rate=round(rate, 2),
                ct_occupancy=round(ct_occ, 4),
                resource_pressure=round(res_p, 4))
        return self._overload.status()

    def overload_status(self) -> Optional[Dict]:
        ov = self._overload
        return ov.status() if ov is not None else None

    def qos_status(self) -> Optional[Dict]:
        """The multi-tenant QoS document (``/v1/status`` row): tenant
        table (weights/lanes/caps/assignments) plus the live per-tenant
        admission picture when the pipeline is up. None when QoS is off —
        the status document stays byte-identical to the pre-QoS shape."""
        if self.qos is None:
            return None
        doc: Dict = dict(self.qos.stats())
        pl = self._pipeline
        if pl is not None:
            ps = pl.stats()
            doc["tenants"] = ps.get("tenants", {})
            doc["lane_bucket"] = ps.get("lane_bucket", 0)
            doc["lane_fill_rows"] = ps.get("lane_fill_rows", 0)
            doc["lane_bucket_rows"] = ps.get("lane_bucket_rows", 0)
        return doc

    def fqdn_status(self) -> Dict:
        """The in-band DNS plane document (``status.fqdn``): cache
        occupancy/bounds/high-water, proxy learning counters (frames
        seen, answers observed, parse errors — the fail-open loss
        signal), and the repository's refresh-coalescing / identity
        lifecycle counters."""
        doc: Dict = {
            "proxy_enabled": bool(self.config.fqdn_proxy_enabled),
            "cache": self.ctx.fqdn_cache.stats(),
            "refresh_coalesced": self.repo.fqdn_refresh_coalesced,
            "identities_created": self.repo.fqdn_identities_created,
        }
        px = self._dns_proxy
        if px is not None:
            doc["proxy"] = px.stats()
        return doc

    # -- resource pressure ledger (observe/pressure.py) --------------
    # Provider contract: each returns {resource: (capacity, occupancy)} or
    # (capacity, occupancy, pressure) — the 3-tuple hands through a
    # canonical pressure fraction. Structures that degrade GRACEFULLY at
    # full occupancy (drop-oldest rings, LRU caches, backpressure pools)
    # report explicit pressure 0.0: occupancy/high-water stay visible but
    # "full" is their steady state, not a capacity failure — only
    # structures whose exhaustion sheds/fails (CT, queue, shard segments,
    # budgets) carry failure-signal pressure.
    def _register_resources(self) -> None:
        self.ledger.register("ct", self._res_ct)
        self.ledger.register("pipeline", self._res_pipeline)
        self.ledger.register("feeder", self._res_feeder)
        if self.qos is not None:
            self.ledger.register("qos", self._res_qos)
        self.ledger.register("compile", self._res_compile)
        self.ledger.register("observe", self._res_observe)
        self.ledger.register("datapath", self._res_datapath)
        self.ledger.register("fqdn", self._res_fqdn)

    def _res_ct(self) -> Dict:
        # the ct_occupancy gauge IS the canonical fraction: hand it
        # through verbatim so the resource row and the gauge can never
        # disagree (the cfg6 bench gates on exact equality)
        occ = float(self.metrics.gauges.get("ct_occupancy", 0.0))
        cap = self.config.ct_capacity
        return {"ct_table": (cap, occ * cap, occ)}

    def _res_pipeline(self) -> Dict:
        pl = self._pipeline
        if pl is None:
            return {}
        ps = pl.occupancy_stats()
        out = {
            "admission_queue": (ps["queue_max"], ps["queue_depth"]),
            # staging slots backpressure by design (acquire blocks):
            # informational
            "staging_slots": (ps["staging_slots"],
                              ps["staging_slots"] - ps["staging_free"],
                              0.0),
            # capacity is the ring's REAL aggregate (n_shards * seg_cap
            # when sharded — headroom makes that exceed max_bucket, and
            # staged rows legitimately pass max_bucket before a segment
            # fills; max_bucket as capacity would read >100%)
            "staging_ring": (ps["stage_rows"], ps["staged_rows"], 0.0),
        }
        if ps.get("n_shards", 1) > 1:
            # the binding sharded constraint: ONE overfull segment sheds
            # the whole submission (steer_overflow) — a real capacity
            # failure, unlike the flush-on-full aggregate ring
            out["staging_segment_peak"] = (
                ps["shard_capacity"], max(ps["shard_fill"], default=0))
        return out

    def _res_feeder(self) -> Dict:
        fd = self._feeder
        if fd is None:
            return {}
        st = fd.stats()
        # pool exhaustion = FIFO backpressure on the oldest ticket (by
        # design) — informational occupancy, not failure pressure
        return {"feeder_pool": (self.config.ingest_pool_batches,
                                st.get("pending", 0), 0.0)}

    def _res_qos(self) -> Dict:
        # per-tenant admission-queue rows (active tenants only): a tenant
        # that drains/departs stops reporting and the ledger's staleness
        # sweep drops its whole gauge family — the departed-subject
        # discipline (a frozen depth for a gone tenant reads as load).
        # Capped tenants carry real pressure (cap exhaustion sheds, the
        # tenant_cap class); uncapped tenants report informational 0.0 —
        # their bound is the global queue, already a ladder signal.
        pl = self._pipeline
        if pl is None or self.qos is None:
            return {}
        out: Dict = {}
        for name, (cap, depth) in \
                pl.occupancy_stats().get("tenants", {}).items():
            if cap > 0:
                out[f"qos_tenant_queue_{name}"] = (cap, depth)
            else:
                out[f"qos_tenant_queue_{name}"] = (
                    self.config.pipeline_queue_batches, depth, 0.0)
        return out

    def _res_compile(self) -> Dict:
        from cilium_tpu_torch.policy.mapstate import overlay_stats
        cfg = self.config
        st = self._last_update_stats
        # patch budgets: all informational (explicit pressure 0.0).
        # At-budget means delta cycles fall back to full uploads/rebuilds
        # — a perf cliff, commanded and graceful, never traffic loss. And
        # delta_rows/new_identities are the LAST cycle's consumption, not
        # a standing occupancy: letting them carry failure pressure would
        # pin health/the ladder's resource latch on an idle engine until
        # the next (unrelated) update happened to be smaller.
        out = {
            "patch_budget": (cfg.patch_delta_rows,
                             st.delta_rows if st is not None else 0, 0.0),
            "ident_growth": (512 if self._inc is None
                             else self._inc.IDENT_GROWTH_MAX,
                             st.new_identities if st is not None else 0,
                             0.0),
            # delta-path retirement: same last-cycle-consumption
            # semantics as ident_growth — at budget, the cycle fell back to
            # a full rebuild, a commanded perf cliff
            "ident_retire": (512 if self._inc is None
                             else self._inc.IDENT_RETIRE_MAX,
                             getattr(st, "retired_identities", 0)
                             if st is not None else 0,
                             0.0),
        }
        inc = self._inc
        if inc is not None:
            out["patch_overlay"] = (cfg.patch_rebase_rows,
                                    len(inc._overlay), 0.0)  # noqa: SLF001
        # mapstate overlay folds at budget BY DESIGN (one amortized
        # O(entries) flatten) — occupancy/high-water visibility only; a
        # pre-fold dirty count past the budget must not read as an
        # exhaustion (it would strict-freeze the recorder on commanded
        # behavior)
        ovs = overlay_stats()
        out["mapstate_overlay"] = (ovs["fold_budget"], ovs["last_dirty"],
                                   0.0)
        return out

    def _res_fqdn(self) -> Dict:
        # the FQDN cache bound sheds GRACEFULLY (oldest-expiry eviction,
        # never a crash or a dropped reply) — informational 0.0, but
        # occupancy/high-water/ETA stay visible so a spoofed-response
        # storm pinning the bound is attributable before identities churn
        cache = self.ctx.fqdn_cache
        if cache.max_names <= 0:
            return {}  # unbounded: no capacity to report against
        st = cache.stats()
        return {"fqdn_cache": (cache.max_names, st["names"], 0.0)}

    def _res_observe(self) -> Dict:
        ts = self.tracer.stats()
        bs = self.blackbox.stats()
        aud = self.auditor.stats()
        return {
            # drop-oldest rings wrap by design: informational (their loss
            # accounting lives in spans_dropped_total / follow gaps)
            "trace_ring": (ts["capacity"], ts["spans_in_ring"], 0.0),
            "flowlog_ring": (self.flowlog.capacity, len(self.flowlog),
                             0.0),
            "blackbox_events": (bs["events_capacity"],
                                bs["events_in_ring"], 0.0),
            # the audit capture pool saturating means the replay loop is
            # lagging live capture — real pressure (skips are counted,
            # but sustained skipping blinds the parity contract)
            "audit_pool": (aud["pool_batches"], aud["pending"]),
        }

    def _res_datapath(self) -> Dict:
        out: Dict = {}
        dp = self.datapath
        ws = getattr(dp, "wire_pool_stats", None)
        if ws is not None:
            s = ws()
            # occupancy = buffers checked out with in-flight batches;
            # pool misses allocate (shed to GC) — informational
            out["wire_pool"] = (s["capacity"], s["in_flight"], 0.0)
        hl = getattr(dp, "hbm_ledger", None)
        if hl is not None and self.config.max_hbm_bytes > 0:
            out["hbm"] = (self.config.max_hbm_bytes,
                          hl()["device_bytes"])
        rs = getattr(dp, "rss_exchange_stats", None)
        if rs is not None:
            s = rs()
            if s is not None:
                # device-RSS ppermute exchange buffers: transient per
                # dispatch and sized by the bucket shape — informational
                # occupancy against the worst case at batch_size (a full
                # bucket is the steady serving state, not a failure)
                out["rss_exchange"] = (s["capacity"], s["in_use"], 0.0)
        mh = getattr(dp, "mesh_health", None)
        if mh is not None:
            h = mh()
            if h["configured"] > 1:
                # mesh_width: occupancy = devices actually
                # serving, capacity = configured width. A missing chip IS
                # failure pressure, so hand the missing fraction through
                # explicitly — the default occupancy/capacity convention
                # would read the full healthy mesh as the pressured state
                out["mesh_width"] = (
                    h["configured"], h["live"],
                    (h["configured"] - h["live"]) / h["configured"])
        import sys as _sys
        cls_mod = _sys.modules.get("cilium_tpu_torch.kernels.classify")
        if cls_mod is not None:
            cs = cls_mod.fn_cache_stats()
            # LRU: full-with-evictions is a rebuild cost, not a failure
            out["classify_fn_cache"] = (cs["cap"], cs["size"], 0.0)
        return out

    def resource_step(self, now: Optional[float] = None) -> Dict:
        """One ledger sweep (the ``resource-ledger`` controller body;
        directly callable from benches/tests with a logical clock for
        deterministic ETA math). Exports the labeled resource_* gauge
        families and fires forecast events; returns the full report."""
        FAULTS.fire("resource.poll")
        return self.ledger.poll(now)

    def resources(self) -> Dict:
        """The ``GET /v1/resources`` document: the ledger's READ side (the
        last controller sweep) plus the device-memory ledger. Deliberately
        side-effect-free — a scrape or a tight ``top --interval`` loop
        must not fire the resource.poll fault point, skew the ETA windows'
        sampling cadence, or be the thing that fires a freeze event; the
        ``resource-ledger`` controller owns sampling."""
        report = self.ledger.report()
        report["hbm"] = self.hbm_status()
        return report

    def hbm_status(self) -> Dict:
        """Live device-memory ledger (None on the fake datapath) plus the
        attached offline verifier budget report — the two surfaces that
        must cite the same numbers."""
        hl = getattr(self.datapath, "hbm_ledger", None)
        return {
            "ledger": hl() if hl is not None else None,
            "max_hbm_bytes": self.config.max_hbm_bytes or None,
            "verifier": self._hbm_budget,
        }

    def note_verifier_budget(self, doc: Dict) -> None:
        """Attach an offline ``compile/verifier.budget_doc`` summary so
        status/bench surfaces cite the same device-memory numbers the
        offline verifier judged."""
        self._hbm_budget = doc

    # -- multi-host sync (runtime/clustermesh.py) -------------------------------
    def attach_mesh(self, store_dir: Optional[str] = None,
                    node_name: Optional[str] = None):
        """Create (or return) this engine's ClusterMesh WITHOUT starting the
        sync controller — deterministic callers (``chip_smoke.py``'s
        phase cluster, tests, chaos drills) tick ``mesh.step()`` themselves;
        ``start_background`` wires the controller on top. Arguments default
        to the config's ``cluster_store``/``node_name``."""
        with self._lock:
            if self._mesh is None:
                from cilium_tpu_torch.runtime.clustermesh import ClusterMesh
                self._mesh = ClusterMesh(
                    self, store_dir or self.config.cluster_store,
                    node_name or self.config.node_name,
                    stale_after_s=self.config.cluster_stale_after_s,
                    staleness_budget_s=self.config.cluster_staleness_budget_s)
            return self._mesh

    def mesh_status(self) -> Optional[Dict]:
        m = self._mesh
        return m.status() if m is not None else None

    def start_background(self) -> None:
        """Start the periodic controllers and (when configured) the REST API
        server on its unix socket (SURVEY.md §3.1 "api server up")."""
        if self.config.api_socket and self._api is None:
            from cilium_tpu_torch.runtime.api import APIServer
            self._api = APIServer(self, self.config.api_socket)
            self._api.start()
        if self.config.cluster_store and self.config.node_name:
            self.attach_mesh()
            self.controllers.update(
                "clustermesh-sync", self._mesh.step,
                interval=self.config.cluster_sync_interval_s)
        if self.config.ct_gc_overlap \
                and hasattr(self.datapath, "sweep_step"):
            # overlapped device-side epoch GC: small donated chunk sweeps
            # interleaved with classify at a tight cadence, reclaim counts
            # harvested one tick late (the double buffer) — classify is
            # never stalled behind a whole-table sweep
            self.controllers.update("ct-gc", self.sweep_step,
                                    interval=self.config.ct_gc_interval_s)
        else:
            self.controllers.update("ct-gc", lambda: self.sweep(),
                                    interval=self.config.sweep_interval_s)
        # expired DNS names must revoke their identities (upstream: fqdn
        # cache GC controller); expire() notifies → re-materialize → regen
        self.controllers.update(
            "fqdn-gc",
            lambda: self.ctx.fqdn_cache.expire(
                int(self.ctx.fqdn_cache.clock())),
            interval=self.config.sweep_interval_s)
        if self.config.flowlog_path or self.config.metrics_path:
            self.controllers.update(
                "obs-flush", self.flush_observability,
                interval=self.config.obs_flush_interval_s)
        if self.config.overload_enabled:
            # the degradation ladder (pipeline/guard.OverloadLadder):
            # queue/shed/CT pressure → OK/PRESSURE/OVERLOAD/SHED-NEW,
            # propagated to the admission queue and the feeder — a
            # supervised controller like every other (a crashing decider
            # backs off; the last propagated state stands)
            self.controllers.update(
                "overload", self.overload_step,
                interval=self.config.overload_interval_s)
        if self.config.resource_ledger_enabled:
            # the resource pressure ledger (observe/pressure.py): one
            # sweep of every registered bounded structure per interval —
            # labeled gauge export, high-water, time-to-exhaustion
            # forecasts into the flight recorder. Supervised like every
            # controller: a crashing poll backs off and the last exported
            # pressure stands.
            self.controllers.update(
                "resource-ledger", self.resource_step,
                interval=self.config.resource_interval_s)
        if self.config.autotune_enabled:
            # the closed loop (observe/autotune.py): queue-wait + fill
            # histograms → bounded flush_ms / bucket-floor adjustments
            self.controllers.update(
                "pipeline-autotune", self._autotune_step,
                interval=self.config.autotune_interval_s)
        if self.config.audit_enabled:
            # the shadow-oracle replay loop (observe/audit.py): supervised
            # like every controller — a crashing/wedged replay backs off
            # and the bounded capture pool degrades to `skipped`, never to
            # a stalled serving path
            self.controllers.update(
                "parity-audit", lambda: self.audit_step(budget=64),
                interval=self.config.audit_interval_s)
        if self.config.remesh_enabled \
                and getattr(self.datapath, "mesh_health", None) is not None:
            # mesh self-healing: down-remesh on latched device
            # loss, canary-probe departed chips, hysteretic re-admission
            self.controllers.update(
                "mesh-heal", self.remesh_step,
                interval=self.config.remesh_interval_s)
        if self.config.ct_snapshot_dir:
            # bounded-staleness CT archive — the salvage floor a device-
            # loss re-mesh falls back to when the gather collective fails
            self.controllers.update(
                "ct-snapshot", self.ct_snapshot_step,
                interval=self.config.ct_snapshot_interval_s)

    def _autotune_step(self):
        """One autotune control interval (controller body). No-ops until
        the ingestion pipeline exists; rebinds if the pipeline was
        recreated."""
        pl = self._pipeline
        if pl is None:
            return None
        if self._autotuner is None or self._autotuner.pipeline is not pl:
            from cilium_tpu_torch.observe.autotune import Autotuner
            cfg = self.config
            self._autotuner = Autotuner(
                pl, self.metrics,
                flush_ms_min=cfg.autotune_flush_ms_min,
                flush_ms_max=cfg.autotune_flush_ms_max,
                min_bucket_floor=min(cfg.pipeline_min_bucket,
                                     cfg.batch_size),
                target_fill=cfg.autotune_target_fill,
                queue_wait_p99_budget_ms=cfg.autotune_queue_wait_p99_ms,
                hysteresis=cfg.autotune_hysteresis,
                step_factor=cfg.autotune_step_factor)
        return self._autotuner.step()

    def autotune_status(self) -> Optional[Dict]:
        at = self._autotuner
        return at.status() if at is not None else None

    def health(self) -> Dict:
        """Engine health summary (the supervised-degradation surface).

        States:
          OK        — the active snapshot is the current compiled state
          DEGRADED  — regeneration is failing; serving the last-good
                      snapshot, which is still semantically current — OR
                      the serving pipeline is degraded (breaker open,
                      watchdog restart in progress, or hard-failed) while
                      the synchronous classify path still answers
          STALE     — regeneration is failing AND committed policy changes
                      (repo revision > active revision) cannot be compiled:
                      verdicts are correct for an older policy world

        When the ingestion pipeline exists its guard state
        (ok/breaker-open/restarting/failed — pipeline/guard.py) is folded
        in under the ``pipeline`` key and into the overall ``state``, plus
        the ``pipeline_state`` gauge."""
        with self._lock:
            active = self._active
            state = C.HEALTH_OK
            if self._regen_failures:
                state = C.HEALTH_DEGRADED
                if active is not None and self.repo.revision > active.revision:
                    state = C.HEALTH_STALE
            doc = {
                "state": state,
                "consecutive_regen_failures": self._regen_failures,
                "last_regen_error": self._last_regen_error,
                "active_revision": active.revision if active else None,
                "repo_revision": self.repo.revision,
            }
            pl = self._pipeline
        aud = self.auditor
        if not aud.healthy:
            # a parity mismatch means verdicts diverged from the semantic
            # oracle under a live revision: serving still answers (the
            # sampled mismatch does not prove every verdict wrong), but
            # the daemon is provably not bit-identical — DEGRADED until an
            # operator pulls the debug bundle and re-arms
            doc["audit"] = {
                "mismatched_rows": aud.mismatched_rows,
                "checked_rows": aud.checked_rows,
                "last_mismatch_revision": aud.last_mismatch_revision,
            }
            if doc["state"] == C.HEALTH_OK:
                doc["state"] = C.HEALTH_DEGRADED
        mesh = self._mesh
        if mesh is not None:
            ms = mesh.status()
            # MESH_STALE is a DETAIL, not a serving failure: classify keeps
            # answering from last-good remote state (partition never fails
            # closed on established remote flows) — but the operator must
            # see that the remote view may be behind the mesh
            doc["mesh"] = {
                "state": ms["state"],
                "store_ok": ms["store_ok"],
                "peers": len(ms["peers"]),
                "remote_entries": ms["remote_entries"],
                "last_good_pass_age_s": ms["last_good_pass_age_s"],
                "replication_lag_p99_s": ms["replication_lag_p99_s"],
            }
            if ms["state"] == C.MESH_STALE \
                    and doc["state"] == C.HEALTH_OK:
                doc["state"] = C.HEALTH_DEGRADED
        ov = self._overload
        if ov is not None:
            ost = ov.status()
            # the ladder is COMMANDED degradation: PRESSURE still reports
            # OK (the system is coping by reordering sheds), but OVERLOAD
            # and SHED-NEW mean traffic is being refused wholesale — an
            # operator-attention state
            doc["overload"] = {
                "state": ost["state"],
                "level": ost["level"],
                "since_s": ost["since_s"],
                "inputs": ost["inputs"],
            }
            from cilium_tpu_torch.pipeline.guard import OVERLOAD_OVERLOAD
            if ost["level"] >= OVERLOAD_OVERLOAD \
                    and doc["state"] == C.HEALTH_OK:
                doc["state"] = C.HEALTH_DEGRADED
        mhf = getattr(self.datapath, "mesh_health", None)
        if mhf is not None:
            mw = mhf()
            if mw["configured"] > 1 and (mw["dead_ordinals"]
                                         or mw["live"] < mw["configured"]):
                # device loss: serving continues on the
                # survivor mesh — degraded, one fault from losing
                # redundancy — with the live grace window attached so an
                # operator can tell salvage-covered from cold-learning
                grace = self._salvage_until - time.monotonic()
                doc["devices"] = {
                    "detail": C.DEVICE_LOST,
                    "configured": mw["configured"],
                    "live": mw["live"],
                    "dead": mw["dead_ordinals"],
                    "salvage_grace_remaining_s":
                        round(grace, 3) if grace > 0 else 0.0,
                }
                if doc["state"] == C.HEALTH_OK:
                    doc["state"] = C.HEALTH_DEGRADED
        cfg = self.config
        if cfg.ct_snapshot_dir and cfg.checkpoint_max_age_s > 0:
            from cilium_tpu_torch.runtime.checkpoint import ct_archive_age_s
            age = ct_archive_age_s(cfg.ct_snapshot_dir)
            if age is None or age > cfg.checkpoint_max_age_s:
                # CHECKPOINT_STALE: the salvage floor a
                # device-loss re-mesh would fall back to no longer
                # reflects recent flows (or was never written)
                doc["checkpoint"] = {
                    "detail": C.CHECKPOINT_STALE,
                    "age_s": round(age, 1) if age is not None else None,
                    "max_age_s": cfg.checkpoint_max_age_s,
                }
                if doc["state"] == C.HEALTH_OK:
                    doc["state"] = C.HEALTH_DEGRADED
        rs = self.ledger.status()
        if rs["pressured"]:
            # RESOURCE_PRESSURE detail: some bounded structure
            # is past its warn fraction — the which-runs-out-first answer,
            # with the soonest exhaustion forecast attached. Warn-level
            # pressure is an attention state, not a failure; CRITICAL
            # pressure (past resource_pressure_crit) degrades health like
            # a mesh/pipeline fault would
            doc["resources"] = {
                "detail": C.RESOURCE_PRESSURE,
                "pressured": rs["pressured"],
                "max_pressure": rs["max_pressure"],
                "min_eta": rs["min_eta"],
                "critical": rs["critical"],
            }
            if rs["critical"] and doc["state"] == C.HEALTH_OK:
                doc["state"] = C.HEALTH_DEGRADED
        if pl is not None:
            # outside the engine lock: pipeline stats take the pipeline
            # lock and must stay a leaf in the lock order; one snapshot
            # carries state, restarts and breaker together
            ps = pl.stats()
            pstate = ps["state"]
            doc["pipeline"] = {
                "state": pstate,
                "restarts": ps["restarts"],
                "breaker": ps["breaker"],
                # per-mesh guard surface: a non-ok state fences this many
                # chips at once (no half-mesh verdicts) — the MESH size,
                # which device-RSS pipelines keep even though their
                # staging ring is unsharded
                "shards": ps.get("mesh_shards") or ps.get("n_shards", 1),
                "rss_mode": ps.get("rss_mode", "host"),
            }
            from cilium_tpu_torch.pipeline.guard import PIPELINE_STATES
            self.metrics.set_gauge("pipeline_state",
                                   PIPELINE_STATES.get(pstate, -1))
            if pstate in ("breaker-open", "restarting", "failed",
                          "device-lost") \
                    and doc["state"] == C.HEALTH_OK:
                doc["state"] = C.HEALTH_DEGRADED
        return doc

    def health_probe(self, now: Optional[int] = None) -> Dict:
        """Datapath health check (cilium-health analog): classify one ICMP
        echo probe from the reserved health identity to every endpoint with
        an IP, through the real device path. Returns
        {ep_id: {reachable, reason, ct_state}, "engine": health()}; a
        probe's verdict follows
        policy exactly like real traffic (an endpoint whose ingress denies
        the health identity reports unreachable — same as upstream when
        health checks are not whitelisted)."""
        from cilium_tpu_torch.oracle import PacketRecord
        from cilium_tpu_torch.kernels.records import batch_from_records
        from cilium_tpu_torch.utils.ip import parse_addr

        if now is None:
            now = int(time.time())
        src16, _ = parse_addr(C.HEALTH_PROBE_IP)
        eps = [ep for ep in sorted(self.endpoints.values(),
                                   key=lambda e: e.ep_id) if ep.ips]
        if not eps:
            return {"engine": self.health()}
        recs = []
        for ep in eps:
            dst16, v6 = parse_addr(ep.ips[0])
            recs.append(PacketRecord(
                src16, dst16, 0, C.ICMP_ECHO_REQUEST,
                C.PROTO_ICMP6 if v6 else C.PROTO_ICMP, 0, v6,
                ep.ep_id, C.DIR_INGRESS))
        out = self.classify(
            batch_from_records(recs, self.active.snapshot.ep_slot_of),
            now=now)
        report = {}
        for i, ep in enumerate(eps):
            report[ep.ep_id] = {
                "reachable": bool(out["allow"][i]),
                "reason": C.DropReason(int(out["reason"][i])).name,
                "ct_state": C.CTStatus(int(out["status"][i])).name,
            }
        self.metrics.set_gauge(
            "health_reachable_endpoints",
            sum(1 for r in report.values() if r["reachable"]))
        report["engine"] = self.health()
        return report

    def profile_classify(self, batch: Dict[str, np.ndarray], trace_dir: str,
                         now: Optional[int] = None,
                         repeats: int = 3) -> Dict[str, np.ndarray]:
        """Run ``repeats`` classify steps under ``torch.profiler`` and
        export a Chrome trace (``classify_trace.json``) into ``trace_dir``
        (the device half of tracing; host stage timers live in
        metrics.span). With a CUDA datapath the trace holds the card's
        kernels beside the host ops; with a fake datapath there is no
        device program to profile."""
        import os

        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            for i in range(repeats):
                out = self.classify(dict(batch),
                                    now=None if now is None else now + i)
        prof.export_chrome_trace(os.path.join(trace_dir,
                                              "classify_trace.json"))
        return out

    def render_metrics(self) -> str:
        """The full Prometheus exposition: device/host metrics plus the
        flow-metrics totals (one text body for /v1/metrics and the
        textfile exporter)."""
        # zero-copy ingestion attribution: fold the datapath's monotone
        # pack/upload ints in as real counters (delta since last scrape —
        # a *_total gauge would trip PromQL counter semantics). The
        # fallback split exports as ONE labeled counter family so residual
        # allocating packs are attributable: disabled (zero-copy off),
        # steered (sharded batch arrived un-steered), shape (unpoolable
        # row count).
        pack = getattr(self.datapath, "pack_stats", None)
        if pack:
            with self._pack_fold_lock:   # API scrape vs textfile flush
                for k, v in pack.items():
                    d = v - self._pack_stats_seen.get(k, 0)
                    if d:
                        if k.startswith("pack_fallback_"):
                            reason = k[len("pack_fallback_"):]
                            name = ("datapath_pack_fallback_total"
                                    f'{{reason="{reason}"}}')
                        else:
                            name = f"datapath_{k}_total"
                        self.metrics.inc_counter(name, d)
                        self._pack_stats_seen[k] = v
        # live-patch attribution (delta scatter-applies vs full re-places,
        # rows moved, stale-placement fence trips) — same delta-fold
        patch = getattr(self.datapath, "patch_stats", None)
        if patch:
            with self._pack_fold_lock:
                for k, v in patch.items():
                    d = v - self._pack_stats_seen.get(f"patch:{k}", 0)
                    if d:
                        self.metrics.inc_counter(f"datapath_{k}_total", d)
                        self._pack_stats_seen[f"patch:{k}"] = v
        # make_classify_fn memo (kernels/classify): size gauge + eviction
        # counter, folded only when the step's module is loaded — a
        # fake-datapath engine never imports it
        import sys as _sys
        cls_mod = _sys.modules.get("cilium_tpu_torch.kernels.classify")
        if cls_mod is not None:
            cs = cls_mod.fn_cache_stats()
            self.metrics.set_gauge("classify_fn_cache_size", cs["size"])
            with self._pack_fold_lock:
                d = cs["evictions"] - self._pack_stats_seen.get(
                    "fn_cache:evictions", 0)
                if d:
                    self.metrics.inc_counter(
                        "classify_fn_cache_evictions_total", d)
                    self._pack_stats_seen["fn_cache:evictions"] = \
                        cs["evictions"]
        # trace-ring drop accounting: the tracer's drop-oldest
        # overwrites + full wraps as real counters (same delta-fold as the
        # pack stats — the tracer's own totals are process-lifetime ints)
        ts = self.tracer.stats()
        with self._pack_fold_lock:
            for key, name in (("spans_dropped_total",
                               "trace_spans_dropped_total"),
                              ("ring_wraps", "trace_ring_wraps_total")):
                d = ts[key] - self._pack_stats_seen.get(f"trace:{key}", 0)
                if d > 0:
                    self.metrics.inc_counter(name, d)
                    self._pack_stats_seen[f"trace:{key}"] = ts[key]
                elif d < 0:
                    # the process-wide tracer was reset (tests/operator
                    # re-arm): re-baseline so future losses keep counting
                    # instead of waiting out the old watermark
                    self._pack_stats_seen[f"trace:{key}"] = ts[key]
        # in-band DNS plane: the repository's process-lifetime ints
        # (coalesced refreshes, toFQDNs identities materialized) folded as
        # real counters — same delta-fold discipline as the pack stats.
        # fqdn_observed_total / fqdn_parse_errors_total are incremented
        # live by the proxy; fqdn_identities_retired_total by the regen
        # path — only the repo's counters need folding here.
        with self._pack_fold_lock:
            for val, name in (
                    (self.repo.fqdn_refresh_coalesced,
                     "fqdn_refresh_coalesced_total"),
                    (self.repo.fqdn_identities_created,
                     "fqdn_identities_created_total")):
                d = val - self._pack_stats_seen.get(f"fqdn:{name}", 0)
                if d > 0:
                    self.metrics.inc_counter(name, d)
                    self._pack_stats_seen[f"fqdn:{name}"] = val
        # feeder liveness/occupancy as first-class gauge families (the
        # monotone feeder_*_total counters are already incremented live by
        # the feeder itself; these are the fields that existed only in
        # feeder_stats() — a scrape must see them without the status API)
        fd = self.feeder_stats()
        if fd is not None:
            self.metrics.set_gauge("feeder_alive", 1 if fd["alive"] else 0)
            self.metrics.set_gauge("feeder_pool_free", fd["pool_free"])
            self.metrics.set_gauge("feeder_pending", fd["pending"])
        return (self.metrics.render_prometheus()
                + self.flowmetrics.render_prometheus())

    def flush_observability(self) -> None:
        """Flush the flow-log sink and write the Prometheus text file (the
        hubble-export + node-exporter-textfile analog). Also callable
        directly for synchronous export. Each flush also notes a stats
        snapshot into the flight recorder, so a later frozen bundle
        carries the state trajectory leading up to its anomaly."""
        self.blackbox.note_stats({
            "pipeline": self.pipeline_stats(),
            "feeder": self.feeder_stats(),
            "audit": self.auditor.stats(),
        })
        if self.config.flowlog_path:
            self.flowlog.flush_sink()
        if self.config.metrics_path:
            import os
            import tempfile
            d = os.path.dirname(self.config.metrics_path) or "."
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, prefix=".metrics-")
            with os.fdopen(fd, "w") as f:
                f.write(self.render_metrics())
            os.replace(tmp, self.config.metrics_path)

    def stop(self) -> None:
        with self._lock:
            fd, self._feeder = self._feeder, None
        if fd is not None:
            # feeder first: it drains the shim and applies remaining
            # verdicts THROUGH the still-open pipeline
            fd.stop()
        with self._lock:
            pl, self._pipeline = self._pipeline, None
            self._pipeline_stopped = True    # submit() must not resurrect it
        if pl is not None:
            # clean shutdown: queued submissions are classified, not dropped
            pl.close(timeout=30.0)
        self.controllers.stop_all()
        # deregister every ledger resource (drops the whole exported
        # resource_* label family per resource): a stopped engine must not
        # leave frozen pressure series behind for the next engine sharing
        # this process's textfile/scrape surface
        self.ledger.deregister_all()
        self._regen_trigger.cancel()
        if self._api is not None:
            self._api.stop()
            self._api = None
        if self._mesh is not None:
            self._mesh.withdraw()
            self._mesh = None

    # -- introspection ----------------------------------------------------------
    def ct_stats(self, now: Optional[int] = None) -> Dict[str, int]:
        if now is None:
            now = int(time.time())
        return self.datapath.ct_stats(now)

    def ct_arrays(self) -> Dict[str, np.ndarray]:
        """Host copy of the CT table (checkpoint/inspection)."""
        return self.datapath.ct_arrays()

    def load_ct_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        self.datapath.load_ct_arrays(arrays)
