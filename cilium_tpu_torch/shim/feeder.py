"""Async shim→pipeline feeder: the harvest half of zero-copy ingestion.

Before this module the shim path was synchronous per poll: poll a batch,
classify it with a blocking wait, apply verdicts, repeat — the device idles
during every harvest and the host idles during every classify. The feeder
replaces that loop with a harvest thread that

- polls the :class:`~cilium_tpu_torch.shim.bindings.FlowShim` on a budget
  (AF_XDP rings and the heap-mocked rings drain through ``afxdp_poll``;
  the plain mock batcher through ``poll_batch`` alone),
- writes harvested columns straight into a small pool of reusable poll
  buffers (``FlowShim.make_poll_buffer`` — no per-poll column dict),
- maps shim endpoint ids onto the active snapshot's slots (vectorized,
  lookup table cached per snapshot; unknown endpoints fail closed),
- submits each buffer to the engine's ingestion pipeline and
- applies verdicts **FIFO** as tickets resolve — the C++ shim holds one
  FrameRef per emitted record, so verdict order must equal harvest order;
  a rejected/shed/timed-out ticket is applied as all-drop (fail closed)
  rather than skipped, which would desync frames from verdicts.

Buffer lifecycle: a poll buffer stays owned by the pipeline from submit
until its ticket resolves (the scheduler stages from it asynchronously),
so the pool bounds feeder in-flight batches; when every buffer is busy the
feeder blocks on the oldest ticket — natural backpressure from the device
straight back to the rx ring (frames simply wait in the ring).

Fault tolerance: the ``shim.rx_ring`` injection point fires inside both
poll entry points; a trip is one failed poll — frames stay queued and
drain on the next poll. ``stop()`` drains: remaining rx frames are
force-harvested, submitted, and every pending verdict applied in order.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, Optional

import numpy as np

from cilium_tpu_torch.observe.trace import TRACER, Tracer
from cilium_tpu_torch.runtime.faults import FaultInjected
from cilium_tpu_torch.runtime.metrics import Metrics
from cilium_tpu_torch.shim.bindings import MAX_UNVERDICTED_BATCHES, FlowShim
from cilium_tpu_torch.utils import constants as C

log = logging.getLogger("cilium_tpu_torch.feeder")

#: dense-LUT cap: one sparse/huge ep_id must not turn the per-snapshot
#: LUT rebuild into a multi-GB allocation — fall back to dict lookups
DENSE_LUT_MAX = 1 << 20

#: established-flow filter geometry (pow2 slots): a direct-mapped
#: fingerprint table of recently-established flow hashes — the harvest-time
#: priority heuristic, NOT semantics (a collision merely promotes a flood
#: flow's priority class; verdicts are untouched)
EST_FILTER_SLOTS = 1 << 16


def flow_hashes(b: Dict[str, np.ndarray]) -> np.ndarray:
    """Direction-normalized flow hash per row (fwd XOR rev key hash — both
    directions of a flow agree). The UNtranslated tuple, deliberately:
    priority classing is a heuristic and must only be self-consistent
    between its update (verdict apply) and lookup (harvest) sides; the
    steering path keeps its own LB-translated hash."""
    from cilium_tpu_torch.kernels.hashing import hash_words_np
    from cilium_tpu_torch.kernels.records import ct_key_words_np
    return (hash_words_np(ct_key_words_np(b))
            ^ hash_words_np(ct_key_words_np(b, reverse=True)))


class EstablishedFingerprints:
    """Direct-mapped fingerprint table of flows observed allowed-
    ESTABLISHED/REPLY (pow2 slots; slot ``h & mask`` holds ``h | 1`` so an
    empty slot can never read as a hit for hash 0). Two consumers share
    the exact same update/lookup discipline:

    - the feeder's harvest-time priority classing (a hit ranks the row
      PRIO_ESTABLISHED — heuristic only, a collision merely promotes a
      colliding flow's class);
    - the engine's post-remesh CT-salvage grace window: a
      denied row whose fingerprint was established before the device loss
      rides through while the survivor mesh's CT cold-learns — there a
      collision admits one flow for a bounded window, which is exactly
      the documented grace contract, never a policy bypass outside it.

    Both take the rows' fingerprints as ``fp`` where the caller has them
    (the classify step's ``est_fp`` column, ``flow_hashes`` computed on
    the device); without it they hash ``buf`` on the host. Either way the
    table is stamped here, in row order: where two rows of a batch share
    a slot, the later one wins.

    ``note`` never raises (both call sites are verdict hot paths)."""

    def __init__(self, slots: int = EST_FILTER_SLOTS):
        if slots < 1 or slots & (slots - 1):
            raise ValueError("fingerprint slots must be a power of two")
        self._tab = np.zeros((slots,), dtype=np.uint32)
        self._mask = np.uint32(slots - 1)

    def note(self, buf: Dict[str, np.ndarray],
             out: Dict[str, np.ndarray],
             fp: Optional[np.ndarray] = None) -> int:
        """Stamp fingerprints for rows applied allowed-ESTABLISHED/REPLY
        (``fp``: every row's fingerprint, uint32). → the rows stamped (0
        when the update failed)."""
        try:
            st = np.asarray(out["status"])
            m = (np.asarray(out["allow"])
                 & ((st == int(C.CTStatus.ESTABLISHED))
                    | (st == int(C.CTStatus.REPLY)))
                 & np.asarray(buf["valid"]))
            if not m.any():
                return 0
            if fp is None:
                h = flow_hashes({k: np.asarray(buf[k])[m]
                                 for k in ("src", "dst", "sport", "dport",
                                           "proto", "direction")})
            else:
                h = np.asarray(fp, dtype=np.uint32)[m]
            self._tab[h & self._mask] = h | np.uint32(1)
            return int(h.shape[0])
        except Exception:   # noqa: BLE001 — heuristic, never load-bearing
            log.exception("established-fingerprint update failed")
            return 0

    def hits(self, buf: Dict[str, np.ndarray],
             fp: Optional[np.ndarray] = None) -> np.ndarray:
        """[N] bool: rows whose direction-normalized fingerprint is
        stamped (``fp``: every row's fingerprint, uint32). Row-aligned
        with ``buf``; validity is the caller's mask."""
        h = flow_hashes(buf) if fp is None else np.asarray(fp,
                                                           dtype=np.uint32)
        return self._tab[h & self._mask] == (h | np.uint32(1))


def shed_new_rows(b: Dict[str, np.ndarray]) -> int:
    """The SHED-NEW harvest-time shed, shared by the feeder and the cfg6
    bench's synthetic harvest: invalidate every valid row whose ``_prio``
    class is worse than established — those frames get their drop verdict
    at apply time without EVER being submitted (rx-ring backpressure
    relief), while established-class rows ride on. Returns rows shed."""
    from cilium_tpu_torch.pipeline.guard import PRIO_ESTABLISHED
    v = b["valid"]
    m = v & (np.asarray(b["_prio"]) > PRIO_ESTABLISHED)
    n = int(m.sum())
    if n:
        v[m] = False                    # in place: poll buffers are pooled
    return n


def build_slot_lut(slot_of: Dict[int, int],
                   dense_max: int = DENSE_LUT_MAX
                   ) -> Optional[np.ndarray]:
    """ep_id → slot lookup array for one snapshot (None when the id space
    is too sparse to densify — callers fall back to dict lookups)."""
    size = max(slot_of, default=0) + 1
    if size > dense_max:
        return None
    lut = np.full((size,), -1, dtype=np.int32)
    for ep_id, slot in slot_of.items():
        if 0 <= ep_id < size:
            lut[ep_id] = slot
    return lut


def map_raw_slots(raw: np.ndarray, slot_of: Dict[int, int],
                  lut: Optional[np.ndarray]) -> np.ndarray:
    """[N] raw shim ep ids → [N] snapshot slots; -1 for unknown ids AND
    for raw == 0 ("no id"). Vectorized through the dense LUT when one
    exists, per-row dict lookups otherwise. Shared by the feeder's
    harvest-time mapping and the engine's dispatch-time re-mapping so the
    fail-closed semantics cannot diverge."""
    if lut is not None:
        slots = lut[np.clip(raw, 0, lut.size - 1)]
        # out-of-range ids INCLUDING negatives fail closed (a negative
        # would otherwise wrap-index the LUT and steal another
        # endpoint's slot); 0 means "no id"
        return np.where((raw >= lut.size) | (raw <= 0),
                        np.int32(-1), slots)
    return np.fromiter(
        (slot_of.get(int(e), -1) if e else -1 for e in raw),
        dtype=np.int32, count=raw.shape[0])


class ShimFeeder:
    """Harvest thread feeding one ``FlowShim`` into one engine's pipeline.

    ``engine`` needs ``submit(batch, now=...) -> Ticket`` and
    ``active.snapshot`` (slot mapping) — the real Engine, or any
    duck-typed stand-in in tests."""

    def __init__(self, shim: FlowShim, engine, *,
                 pool_batches: int = 4,
                 poll_budget: int = 256,
                 idle_sleep_s: float = 0.0005,
                 n_shards: int = 1,
                 slo_ms: float = 0.0,
                 metrics: Optional[Metrics] = None,
                 tracer: Optional[Tracer] = None,
                 event_sink=None,
                 qos=None,
                 fqdn=None,
                 name: str = "feeder"):
        if not 1 <= pool_batches <= MAX_UNVERDICTED_BATCHES:
            raise ValueError(
                f"pool_batches must be in [1, {MAX_UNVERDICTED_BATCHES}] "
                "(the shim ages out unverdicted batches past that)")
        if poll_budget < 1:
            raise ValueError("poll_budget must be >= 1")
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.shim = shim
        self.engine = engine
        self.metrics = metrics if metrics is not None else Metrics()
        self.tracer = tracer if tracer is not None else TRACER
        self._poll_budget = poll_budget
        self._idle_sleep_s = idle_sleep_s
        self._n_shards = n_shards
        self._name = name
        # guard-event sink (the flight recorder): SHED-NEW harvest drops
        # are narrated as kind="shed" reason="shed-new" events — the
        # relaxed spike class (observe/blackbox.RELAXED_SHED_REASONS).
        # Fired outside any lock, exceptions swallowed.
        self._event_sink = event_sink
        # end-to-end latency SLO: harvest stamp → verdict apply, the TRUE
        # ingest→verdict number (queue wait + staging + dispatch + device +
        # FIFO head-of-line wait). slo_ms > 0 arms the burn counters.
        self._slo_s = slo_ms / 1e3 if slo_ms > 0 else 0.0

        self._free: deque = deque(shim.make_poll_buffer()
                                  for _ in range(pool_batches))
        # overload-ladder level (set by the engine's overload controller);
        # >= SHED_NEW arms the harvest-time priority shed
        self._overload_level = 0
        # priority classing: every poll buffer carries a ``_prio`` column
        # (pipeline/guard.PRIO_*) the admission queue ranks batches by;
        # the established-flow filter below feeds class 0
        from cilium_tpu_torch.pipeline.guard import PRIO_NEW
        for buf in self._free:
            buf["_prio"] = np.full((shim.batch_size,), PRIO_NEW,
                                   dtype=np.int8)
        self._est = EstablishedFingerprints()
        # multi-tenant QoS (cilium_tpu/qos): with a TenantTable armed,
        # every poll buffer carries a ``_tenant`` column stamped at
        # harvest time from the endpoint→tenant LUT (same compiled-LUT
        # discipline as the ep-slot map below) — the admission queue's
        # weighted-fair scheduling and the per-tenant e2e/SLO families
        # key on it. QoS off: no column, zero extra work per poll.
        self._qos = qos
        if qos is not None:
            for buf in self._free:
                buf["_tenant"] = np.zeros((shim.batch_size,),
                                          dtype=np.int32)
        # in-band DNS plane (cilium_tpu/fqdn): with a DNSProxy armed,
        # every poll buffer carries the harvested DNS response payload
        # (``_dns_payload`` [batch, W] uint8, ``_dns_len`` [batch] int32)
        # the verdict-apply tap parses into the FQDN cache. The native
        # C++ shim has no payload channel and never writes either column
        # (the tap sees len==0 everywhere and no-ops); DNS-capable shim
        # stand-ins fill both during poll_batch. Proxy off: no columns,
        # zero extra work per poll.
        self._fqdn = fqdn
        if fqdn is not None:
            w = int(getattr(fqdn, "payload_width", 512))
            for buf in self._free:
                buf["_dns_payload"] = np.zeros((shim.batch_size, w),
                                               dtype=np.uint8)
                buf["_dns_len"] = np.zeros((shim.batch_size,),
                                           dtype=np.int32)
        if n_shards > 1:
            # software RSS (SURVEY §2), HOST steering mode only: harvest
            # pre-bins each record by the direction-normalized flow hash
            # so the pipeline's flush-time scatter is a plain copy, never
            # a re-hash. With ``rss_mode="device"`` the engine passes
            # n_shards=1 (the datapath's ``pipeline_shards``) and this
            # whole block — the harvest-side half of the host RSS tax —
            # disappears: the in-kernel ppermute exchange owns flow→shard
            # resolution. The column carries the SHARD_BIN encoding —
            # shard+1 in the low bits (0 = "not binned", the staging
            # ring's convention for optional ``_*`` columns) and the
            # binning policy revision above, so a bin hashed under a
            # superseded LB table is re-hashed at stage-write instead of
            # stranding a service flow's CT entry on the wrong shard —
            # and rides the same reusable poll buffers.
            for buf in self._free:
                buf["_shard"] = np.zeros((shim.batch_size,), dtype=np.int64)
        self._pending: deque = deque()     # (ticket, buf) in harvest order
        self._zeros = np.zeros((shim.batch_size,), dtype=bool)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._rings: Optional[bool] = None  # afxdp/mock rings attached?
        self._snap = None                   # slot-lookup cache key
        self._slot_lut = np.full((1,), -1, dtype=np.int32)

        # stats (single-writer: the feeder thread; read via stats())
        self.harvested_batches = 0
        self.harvested_records = 0
        self.applied_batches = 0
        self.rejected_batches = 0          # applied fail-closed
        self.harvest_faults = 0
        self.errors = 0                    # unexpected step failures
        self.slo_burns = 0                 # applied batches past the SLO
        self.prio_shed_rows = 0            # SHED-NEW harvest-time drops
        self.prio_shed_batches = 0         # batches never submitted at all
        self._submit_rejects = 0           # log-throttle counter

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ShimFeeder":
        if self._thread is not None:
            return self
        self._stop.clear()      # restart after a clean stop() must harvest
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"{self._name}-harvest")
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop harvesting and drain: force-poll what the batcher still
        holds, then apply every pending verdict FIFO (fail closed on
        tickets that cannot resolve within ``timeout``)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                # keep the thread ref: nulling it would let a later
                # start() spawn a SECOND harvester interleaving
                # poll/apply on the same shim — frame/verdict desync
                log.warning("feeder thread did not stop within %.1fs; "
                            "keeping it registered", timeout)
                return
            self._thread = None

    def set_overload_state(self, level: int) -> None:
        """Propagate the overload-ladder level (engine's overload
        controller); >= SHED-NEW arms the harvest-time priority shed."""
        self._overload_level = int(level)

    def stats(self) -> Dict:
        t = self._thread
        e2e = self.metrics.histograms.get("ingest_e2e_latency_seconds")
        return {
            "harvested_batches": self.harvested_batches,
            "harvested_records": self.harvested_records,
            "applied_batches": self.applied_batches,
            "rejected_batches": self.rejected_batches,
            "harvest_faults": self.harvest_faults,
            "errors": self.errors,
            "overload_level": self._overload_level,
            "prio_shed_rows": self.prio_shed_rows,
            "prio_shed_batches": self.prio_shed_batches,
            "alive": bool(t is not None and t.is_alive()),
            "pending": len(self._pending),
            "pool_free": len(self._free),
            "slo_ms": round(self._slo_s * 1e3, 3),
            "slo_burns": self.slo_burns,
            "e2e_p50_ms": round(e2e.quantile(0.5) * 1e3, 3) if e2e else 0.0,
            "e2e_p99_ms": round(e2e.quantile(0.99) * 1e3, 3) if e2e else 0.0,
        }

    # -- harvest loop ---------------------------------------------------------
    def _run(self) -> None:
        # supervised degradation: a failing step (e.g. engine.active
        # raising through a regen failure storm) must not kill ingestion
        # for the daemon's lifetime — count, log (throttled), retry
        while not self._stop.is_set():
            try:
                progressed = self._step(force=False)
            except Exception:   # noqa: BLE001 — keep harvesting
                progressed = False
                self._count_error("harvest step failed")
            if not progressed and not self._stop.is_set():
                if self._idle_sleep_s:
                    self._stop.wait(self._idle_sleep_s)
        try:
            self._drain()
        except Exception:   # noqa: BLE001
            log.exception("feeder drain failed")

    def _count_error(self, what: str) -> None:
        self.errors += 1
        self.metrics.inc_counter("feeder_errors_total")
        if self.errors <= 3 or self.errors % 100 == 0:
            log.exception("feeder %s (error %d); retrying", what,
                          self.errors)

    def _step(self, force: bool) -> bool:
        """One harvest iteration. Returns True when any work happened."""
        progressed = self._apply_ready(block=False)
        buf = self._acquire_buffer()
        if buf is None:
            return progressed            # pool exhausted and head not done
        now_us = int(time.monotonic() * 1e6)
        if self._fqdn is not None:
            # reset_batch_rows zeroes only the TAIL of optional columns and
            # the native shim never writes them: a reused buffer would
            # otherwise replay the PREVIOUS poll's DNS payload for head
            # rows. len==0 makes stale payload bytes unreachable.
            buf["_dns_len"][:] = 0
        tid = self.tracer.maybe_sample()
        try:
            with self.tracer.span(tid, "shim.harvest", force=force):
                if self._rings_attached():
                    rc = self.shim.afxdp_poll(self._poll_budget,
                                              now_us=now_us)
                    if rc < 0:
                        log.debug("afxdp_poll -> %d", rc)
                b = self.shim.poll_batch(now_us=now_us, force=force,
                                         out=buf)
        except FaultInjected:
            # one failed poll: frames stay queued in the ring and drain on
            # the next poll — the supervised-degradation contract
            self.harvest_faults += 1
            self.metrics.inc_counter("feeder_harvest_faults_total")
            self._free.append(buf)
            return progressed
        except Exception:   # noqa: BLE001 — buffer must return to the pool
            self._free.append(buf)
            self._count_error("poll failed")
            return progressed
        if b is None:
            self._free.append(buf)
            return progressed
        self.harvested_batches += 1
        self.metrics.inc_counter("feeder_harvest_batches_total")
        ticket = None
        try:
            n_valid = self._map_slots(b)
            self.harvested_records += n_valid
            self.metrics.inc_counter("feeder_harvest_records_total",
                                     n_valid)
            from cilium_tpu_torch.pipeline.guard import OVERLOAD_SHED_NEW
            submit = True
            if self._overload_level >= OVERLOAD_SHED_NEW:
                # the ladder's terminal rung: only established-class rows
                # are submitted; everything else gets its drop verdict at
                # apply time without touching the pipeline — the rx ring's
                # real backpressure relief. A batch shed whole rides the
                # pending queue as the all-drop sentinel (FIFO-safe).
                if self._shed_new(b) and not bool(b["valid"].any()):
                    submit = False
                    self.prio_shed_batches += 1
                    self.metrics.inc_counter(
                        "feeder_prio_shed_batches_total")
            # the harvest stamp rides the ticket (true ingest→verdict
            # latency; monotonic — same clock as now_us above)
            if submit:
                ticket = self.engine.submit(b, ingest_mono=now_us / 1e6)
        except Exception as e:   # noqa: BLE001 — unavailable/closed/
            # regen-storm engine.active/... : the shim already holds this
            # batch's FrameRefs, so a verdict MUST be consumed for it —
            # but strictly AFTER the batches harvested before it
            # (apply_verdicts always consumes the OLDEST batch). The
            # rejection rides the pending queue as a ``None`` sentinel and
            # is applied all-drop in FIFO position, never out of order.
            self._submit_rejects += 1
            if self._submit_rejects <= 3 or self._submit_rejects % 100 == 0:
                # throttled: a breaker-open storm rejects at harvest rate
                log.warning("feeder submit rejected (%d), queueing "
                            "fail-closed drop verdicts: %s",
                            self._submit_rejects, e)
        self._pending.append((ticket, buf, now_us / 1e6))
        self.metrics.set_gauge("feeder_pending", len(self._pending))
        return True

    def _acquire_buffer(self):
        if self._free:
            return self._free.popleft()
        # pool exhausted: backpressure — block on the OLDEST ticket (FIFO),
        # bounded so stop() stays responsive
        if self._apply_ready(block=True, block_timeout=0.05):
            if self._free:
                return self._free.popleft()
        return None

    def _rings_attached(self) -> bool:
        """Whether rx/fill rings exist (AF_XDP bind or mocked); without
        them the plain feed_frame→batcher path needs no ring drain.
        Prefer the shim's own ``rings_ready`` flag: probing the fill
        LEVEL can read zero with every umem descriptor parked in the rx
        ring — exactly the state where the drain is most needed — and
        since only the drain recycles addresses, mistaking that for "no
        rings" wedges ingestion permanently (the producer sees a full rx
        ring, the harvester never looks at it). The level probe remains
        as a fallback for shim stand-ins without the flag; only a
        positive probe is cached, so rings initialized after start still
        attach."""
        if self._rings:
            return True
        ready = getattr(self.shim, "rings_ready", None)
        self._rings = bool(ready) if ready is not None \
            else self.shim.ring_fill_level() > 0
        return bool(self._rings)

    #: class-level alias (tests monkeypatch it to force the sparse path)
    DENSE_LUT_MAX = DENSE_LUT_MAX

    # -- slot mapping ---------------------------------------------------------
    def _map_slots(self, b: Dict[str, np.ndarray]) -> int:
        """Shim-ep-id → snapshot-slot mapping, in place (build_slot_lut /
        map_raw_slots — shared with the engine's dispatch-time re-map).
        Records for endpoints the snapshot doesn't know go invalid (fail
        closed). Returns the surviving valid count."""
        snap = self.engine.active.snapshot
        if snap is not self._snap:
            self._slot_lut = build_slot_lut(snap.ep_slot_of,
                                            self.DENSE_LUT_MAX)
            self._snap = snap
        slots = map_raw_slots(b["_ep_raw"], snap.ep_slot_of,
                              self._slot_lut)
        unknown = slots < 0
        b["ep_slot"][:] = np.where(unknown, 0, slots)
        b["valid"] &= ~unknown
        if "_prio" in b:
            # priority classing while the columns are hot: flows in the
            # established filter outrank new flows outrank
            # unknown-endpoint traffic (pipeline/guard.PRIO_*) — what the
            # admission queue ranks batches by under PRESSURE and the
            # SHED-NEW harvest shed keys on
            from cilium_tpu_torch.pipeline.guard import (PRIO_ESTABLISHED,
                                                   PRIO_NEW, PRIO_UNKNOWN)
            hit = self._est.hits(b)
            pr = np.where(hit, PRIO_ESTABLISHED, PRIO_NEW).astype(np.int8)
            pr[unknown] = PRIO_UNKNOWN
            b["_prio"][:] = pr
        if self._qos is not None and "_tenant" in b:
            # tenant identity while the ep ids are hot: endpoint → tenant
            # via the TenantTable's compiled LUT (cached on its revision
            # counter inside map_tenants — same rebuild-on-change
            # discipline as the ep-slot LUT above). Unknown endpoints
            # land on the default tenant: they must still be served,
            # they just ride the shared budget.
            b["_tenant"][:] = self._qos.map_tenants(b["_ep_raw"])
        if self._n_shards > 1:
            # pre-bin while the columns are already hot in cache: the same
            # direction-normalized hash (post-DNAT tuple) the datapath and
            # the staging ring use, revision-stamped so a regen between
            # harvest and stage-write invalidates the bin rather than
            # mis-steering it
            from cilium_tpu_torch.parallel.mesh import flow_shard_of
            from cilium_tpu_torch.pipeline.scheduler import shard_bin_encode
            lb = snap.lb if snap.lb.n_frontends else None
            b["_shard"][:] = shard_bin_encode(
                flow_shard_of(b, self._n_shards, lb=lb), snap.revision)
        return int(b["valid"].sum())

    def _shed_new(self, b: Dict[str, np.ndarray]) -> int:
        """SHED-NEW shed of one harvested batch (see shed_new_rows), with
        per-class attribution counters — the ``{class=...}`` label family
        operators alert on."""
        from cilium_tpu_torch.pipeline.guard import PRIO_NEW, PRIO_UNKNOWN
        pr = np.asarray(b["_prio"])
        v = np.asarray(b["valid"])
        n_new = int((v & (pr == PRIO_NEW)).sum())
        n_unk = int((v & (pr >= PRIO_UNKNOWN)).sum())
        shed = shed_new_rows(b)
        if shed:
            self.prio_shed_rows += shed
            if n_new:
                self.metrics.inc_counter(
                    'feeder_prio_shed_rows_total{class="new"}', n_new)
            if n_unk:
                self.metrics.inc_counter(
                    'feeder_prio_shed_rows_total{class="unknown"}', n_unk)
            if self._event_sink is not None:
                try:
                    self._event_sink("shed", reason="shed-new", rows=shed)
                except Exception:   # noqa: BLE001 — observability only
                    log.exception("feeder event sink failed")
        return shed

    def _note_established(self, buf, out) -> None:
        """Feed the established-flow filter from applied verdicts: flows
        observed allowed-ESTABLISHED/REPLY stamp their fingerprint, so the
        NEXT harvest ranks them class 0 (EstablishedFingerprints — shared
        with the engine's CT-salvage grace window, which needs the exact
        same update/lookup discipline). Never raises."""
        self._est.note(buf, out)

    # -- verdict application (FIFO) -------------------------------------------
    def _apply_ready(self, block: bool,
                     block_timeout: float = 0.0) -> bool:
        """Apply verdicts for resolved head tickets, strictly FIFO. With
        ``block`` the head ticket is awaited up to ``block_timeout``."""
        did = False
        while self._pending:
            ticket, buf, ingest_mono = self._pending[0]
            if ticket is not None and not ticket.done():
                if not block:
                    break
                try:
                    ticket.result(timeout=block_timeout)
                except TimeoutError:
                    break
                except Exception:   # noqa: BLE001 — applied below
                    pass
                block = False        # at most one blocking wait per call
            self._pending.popleft()
            self._apply_one(ticket, buf, ingest_mono=ingest_mono)
            did = True
        self.metrics.set_gauge("feeder_pending", len(self._pending))
        return did

    def _apply_one(self, ticket, buf, recycle: bool = True,
                   ingest_mono: Optional[float] = None) -> None:
        """Apply one batch's verdicts (``ticket is None``: the rejected-
        at-submit sentinel — all-drop, fail closed). ``recycle=False``
        sheds the buffer instead of pooling it — for tickets that did NOT
        resolve: the pipeline may still stage from the buffer later."""
        rejected = True
        allow = self._zeros
        if ticket is not None:
            try:
                out = ticket.result(timeout=0)
                allow = out["allow"]
                rejected = False
                self._note_established(buf, out)
                if self._fqdn is not None:
                    # in-band DNS learning tap: rows whose verdict carried
                    # the DNS L7 redirect get their response payload parsed
                    # into the FQDN cache. Strictly after the verdict is
                    # computed and strictly before apply_verdicts — the
                    # proxy never raises and never touches ``allow``, so a
                    # broken parser can only lose learning, never the reply
                    # (the fail-open contract; fault point ``fqdn.parse``).
                    self._fqdn.observe_batch(buf, out)
            except Exception:   # noqa: BLE001 — drop/shed/unavailable
                pass
        try:
            self.shim.apply_verdicts(allow)
        except Exception:   # noqa: BLE001
            log.exception("apply_verdicts failed; frame/verdict FIFO may "
                          "be desynced")
        if not rejected and ingest_mono is not None:
            # verdict-apply is the END of the serving path for this batch:
            # harvest stamp → here is the true ingest→verdict latency
            self._observe_e2e(time.monotonic() - ingest_mono, buf)
        if rejected:
            self.rejected_batches += 1
            self.metrics.inc_counter("feeder_rejected_batches_total")
        self.applied_batches += 1
        self.metrics.inc_counter("feeder_applied_batches_total")
        if recycle:
            self._free.append(buf)

    def _observe_e2e(self, lat_s: float, buf: Dict[str, np.ndarray]) -> None:
        """One applied batch's ingest→verdict latency into the e2e SLO
        surface: the ``ingest_e2e_latency_seconds`` histogram (plus a
        per-shard labeled family when the batch pre-binned onto a mesh) and
        the SLO burn counters when a threshold is armed.

        Attribution is BATCH-granular: every row in the batch experienced
        the same harvest→apply latency, so the batch's latency is observed
        once into each shard family that had valid rows (the latency shard
        N's rows truly saw). Under uniformly mixed harvest batches the
        per-shard series therefore move together; they become differential
        exactly when the mesh degrades asymmetrically — only the batches
        carrying the slow shard's rows stall, and that shard's family (and
        burn counter) pulls away from the rest. The unlabeled family/burn
        counts each batch once and stays the aggregate truth. Never raises
        — this rides the verdict-apply hot path."""
        try:
            self.metrics.histogram("ingest_e2e_latency_seconds").observe(
                lat_s)
            shards = ()
            if self._n_shards > 1 and "_shard" in buf:
                from cilium_tpu_torch.pipeline.scheduler import SHARD_BIN_MASK
                # valid-masked: the buffer's padding tail carries the
                # zeroed-row flow hash, which would attribute every batch
                # to one deterministic shard that carried no traffic
                bins = (np.asarray(buf["_shard"]) & SHARD_BIN_MASK) - 1
                bins = bins[np.asarray(buf["valid"])]
                shards = np.unique(bins[(bins >= 0)
                                        & (bins < self._n_shards)])
                for s in shards:
                    self.metrics.histogram(
                        f'ingest_e2e_latency_seconds{{shard="{int(s)}"}}'
                    ).observe(lat_s)
            tnames = ()
            if self._qos is not None and "_tenant" in buf:
                # per-tenant SLO accounting, batch-granular like the
                # shard families: the batch's latency is observed once
                # into each tenant family that had valid rows — the
                # per-tenant p99 the isolation contract is gated on
                tids = np.unique(
                    np.asarray(buf["_tenant"])[np.asarray(buf["valid"])])
                tnames = [self._qos.name_of(int(t)) for t in tids]
                for tn in tnames:
                    self.metrics.histogram(
                        f'ingest_e2e_latency_seconds{{tenant="{tn}"}}'
                    ).observe(lat_s)
            if self._slo_s and lat_s > self._slo_s:
                self.metrics.inc_counter("ingest_e2e_slo_burn_total")
                for s in shards:
                    self.metrics.inc_counter(
                        f'ingest_e2e_slo_burn_total{{shard="{int(s)}"}}')
                for tn in tnames:
                    self.metrics.inc_counter(
                        f'ingest_e2e_slo_burn_total{{tenant="{tn}"}}')
                self.slo_burns += 1
        except Exception:   # noqa: BLE001
            log.exception("e2e latency observation failed")

    def _drain(self) -> None:
        """Stop-path drain: alternate force-harvesting what the batcher
        still holds with resolving + applying pending verdicts FIFO, until
        neither makes progress — a busy device can exhaust the pool
        mid-drain, so harvesting must resume after the pending sweep frees
        buffers (bounded: the producer has stopped injecting)."""
        for _round in range(2 * MAX_UNVERDICTED_BATCHES):
            harvested = False
            for _ in range(MAX_UNVERDICTED_BATCHES):
                if not self._step(force=True):
                    break
                harvested = True
            if not self._pending and not harvested:
                break
            while self._pending:
                ticket, buf, ingest_mono = self._pending.popleft()
                resolved = True
                if ticket is not None:
                    try:
                        ticket.result(timeout=10.0)
                    except TimeoutError:
                        # still owned by the (possibly wedged) pipeline:
                        # apply fail-closed for FIFO, but NEVER pool the
                        # buffer — a later stage could read it rewritten
                        resolved = False
                    except Exception:   # noqa: BLE001 — fail-closed below
                        pass
                self._apply_one(ticket, buf, recycle=resolved,
                                ingest_mono=ingest_mono)
        self.metrics.set_gauge("feeder_pending", len(self._pending))
