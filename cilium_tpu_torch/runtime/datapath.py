"""The Datapath plugin boundary (port of ``cilium_tpu/runtime/datapath.py``;
upstream: ``pkg/datapath/types``'s ``Datapath``/``Loader`` interfaces, the
fake mirrors ``pkg/datapath/fake``).

The Engine owns the control plane (rules, identities, ipcache, endpoints)
and compiles ``PolicySnapshot``s; everything device- or
semantics-executing sits behind ``DatapathBackend``:

- ``TorchDatapath`` — the production backend: snapshots placed as torch
  tensors on one device, batches classified by the port's classify step
  (on a CUDA device its three interior stages run as the hand-written
  kernels of ``kernels/fused.py``), conntrack updated in place on the
  device.
- ``FakeDatapath`` — device-free. Records every placed snapshot (what
  upstream tests assert map/table contents against) and classifies via the
  semantics oracle, so control-plane tests exercise the full rules →
  verdict contract with no device at all.
"""

from __future__ import annotations

import abc
import contextlib
import logging
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from cilium_tpu_torch.compile.ct_layout import (CT_FIELDS, KEY_WORDS,
                                                CTConfig, make_ct_arrays)
from cilium_tpu_torch.compile.snapshot import PolicySnapshot
from cilium_tpu_torch.observe.trace import (CT_GC_SPAN, PATCH_APPLY_SPAN,
                                            active as active_trace)
from cilium_tpu_torch.parallel.mesh import CTShards
from cilium_tpu_torch.runtime.config import DaemonConfig
from cilium_tpu_torch.runtime.faults import FAULTS
from cilium_tpu_torch.utils import constants as C

OutArrays = Dict[str, np.ndarray]

#: clean (non-v6, compact-slot) batches required before place() may narrow
#: a widened wire format: narrowing under sustained wide traffic would flap
#: the wire format (and the unpacker it selects) on every regen
WIRE_RESET_CLEAN_BATCHES = 64

CT_SCHEMA_KEYS = frozenset(
    ("keys", "expiry", "created", "flags", "pkts_fwd", "pkts_rev", "rev_nat"))

#: ct.npz schema version written by checkpoints; normalize_ct_arrays
#: upgrades anything older it still understands (v1 lacked rev_nat)
CT_FORMAT_VERSION = 2


class StalePlacement(RuntimeError):
    """The placed handle's verdict tensor was patched in place by a later
    ``place_patch`` (the sub-ms delta path updates the device-resident
    policy image in place). Raised from the classify enqueue path when a
    caller captured the old handle before the patch landed but enqueued
    after — the revision fence that guarantees no batch ever classifies
    against a torn or deleted image. Callers retry with the engine's
    current active snapshot; semantically identical to having dispatched a
    moment later."""


#: substrings that mark a dispatch exception as a DEAD-ACCELERATOR failure
#: rather than the transient dispatch errors the breaker/backoff machinery
#: owns. The first entry is the chaos drill (runtime/faults.py
#: ``device.fail``); then the reference's runtime status strings for a chip
#: that dropped off the bus; then the CUDA runtime's strings for a lost
#: card, as ``cudaGetErrorString`` gives them and torch raises them
#: (``CUDA error: <string>``): ``cudaErrorECCUncorrectable``,
#: ``cudaErrorDevicesUnavailable``, ``cudaErrorLaunchFailure`` and
#: ``cudaErrorNvlinkUncorrectable``. Matching is case-sensitive on
#: purpose: these are literal runtime status tokens, and loosening the
#: match risks classifying a user exception that merely *mentions* devices.
_DEAD_DEVICE_MARKERS = (
    "device.fail",
    "DEVICE_UNAVAILABLE",
    "device unavailable",
    "Device or resource busy",
    "hardware failure",
    "data transfer failed between devices",
    "chip has been disabled",
    "uncorrectable ECC error encountered",
    "CUDA-capable device(s) is/are busy or unavailable",
    "unspecified launch failure",
    "uncorrectable NVLink error detected during the execution",
)

#: the CUDA runtime error codes whose strings ``_DEAD_DEVICE_MARKERS``
#: carries (``cudaError_t`` values)
CUDA_DEAD_DEVICE_ERRORS = {
    "cudaErrorDevicesUnavailable": 46,
    "cudaErrorECCUncorrectable": 214,
    "cudaErrorNvlinkUncorrectable": 220,
    "cudaErrorLaunchFailure": 719,
}

#: ``dev=K`` riding in the exception text attributes the loss to a flow-
#: shard ordinal (the fault drill arms it via message=dev=K; a real
#: runtime's status may or may not name the chip)
_DEAD_DEVICE_ORDINAL = re.compile(r"\bdev=(\d+)\b")


def dead_device_of(exc: BaseException) -> Optional[int]:
    """Classify a dispatch exception: ``None`` means transient (breaker /
    retry territory — NOT a device loss), an int means a dead-accelerator
    signature. The int is the flow-shard ordinal the failure names, or -1
    when the signature carries no attribution (the caller then treats the
    whole mesh generation as suspect and probes)."""
    text = f"{type(exc).__name__}: {exc}"
    if not any(m in text for m in _DEAD_DEVICE_MARKERS):
        return None
    m = _DEAD_DEVICE_ORDINAL.search(text)
    return int(m.group(1)) if m else -1


class PlacedTensors(dict):
    """A placed snapshot handle: the device-tensor dict plus the patch
    fence. ``dead`` flips (under the datapath's classify lock) the moment a
    delta patch writes this handle's verdict tensor in place for its
    successor — enqueueing against a dead handle raises
    :class:`StalePlacement` instead of reading a patched image."""
    __slots__ = ("dead",)

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.dead = False


def resolve_fused(config: DaemonConfig, device: torch.device) -> bool:
    """``DaemonConfig.fused_kernels`` → whether the classify step runs its
    three interior stages through the CUDA kernel wrappers
    (``kernels/fused.py``). ``auto``: the kernels on a CUDA device, the
    plain torch versions on the CPU; ``on``: the kernels, and a CPU device
    raises (there is no CPU build of the kernels); ``off``: the plain
    versions everywhere."""
    mode = config.fused_kernels
    if mode == "off":
        return False
    if device.type == "cuda":
        return True
    if mode == "on":
        raise ValueError("fused_kernels='on' needs a CUDA device: the "
                         "kernels have no CPU build (use 'auto' or 'off')")
    return False


#: numpy dtype → torch dtype, for host staging buffers
_TORCH_DTYPE = {np.dtype(k): v for k, v in (
    (np.bool_, torch.bool), (np.uint8, torch.uint8), (np.int8, torch.int8),
    (np.int16, torch.int16), (np.int32, torch.int32),
    (np.int64, torch.int64), (np.float32, torch.float32))}


def _u32_bits(a: np.ndarray) -> np.ndarray:
    """A CT array of the checkpoint schema (uint32) → the int32 bit
    pattern the device table holds, by a view (never a value cast)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.int32:
        return a
    if a.dtype != np.uint32:
        raise TypeError(f"CT array dtype {a.dtype}: the schema is uint32")
    return a.view(np.int32)


def normalize_ct_arrays(arrays: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
    """Validate/upgrade a ct_layout checkpoint to the current schema —
    backend-independent (the schema belongs to the checkpoint format, not to
    any one backend). Strips the embedded format-version stamp, backfills
    the rev_nat column for checkpoints written before service rev-NAT
    existed (format 1), and raises on any other mismatch — including a
    format stamp NEWER than this build understands (restoring a
    future-format CT would silently mis-read columns; dropping it loudly
    is the checkpoint path's fail-closed)."""
    if "__ct_format__" in arrays:
        arrays = dict(arrays)
        fmt = int(np.asarray(arrays.pop("__ct_format__")).reshape(-1)[0])
        if fmt > CT_FORMAT_VERSION:
            raise ValueError(
                f"CT checkpoint format {fmt} is newer than this build's "
                f"{CT_FORMAT_VERSION}")
    if "rev_nat" not in arrays and "expiry" in arrays:
        arrays = dict(arrays)
        arrays["rev_nat"] = np.zeros_like(arrays["expiry"])
    if set(arrays.keys()) != CT_SCHEMA_KEYS:
        raise ValueError(f"CT arrays mismatch: {sorted(arrays)} != "
                         f"{sorted(CT_SCHEMA_KEYS)}")
    return arrays


def _records_from_batch(b: Dict[str, np.ndarray], ep_ids) -> list:
    """Batch dict → oracle PacketRecords (inverse of batch_from_records);
    invalid rows become None so callers keep indices aligned. Lives here —
    not in kernels/ — because only the oracle-backed fake and the auditor
    need it."""
    from cilium_tpu_torch.oracle import PacketRecord
    n = b["valid"].shape[0]
    out: list = []
    for i in range(n):
        if not b["valid"][i]:
            out.append(None)
            continue
        slot = int(b["ep_slot"][i])
        path = bytes(b["http_path"][i])
        path = path[:path.index(0)] if 0 in path else path
        out.append(PacketRecord(
            b["src"][i].astype(">u4").tobytes(),
            b["dst"][i].astype(">u4").tobytes(),
            int(b["sport"][i]), int(b["dport"][i]), int(b["proto"][i]),
            int(b["tcp_flags"][i]), bool(b["is_v6"][i]),
            ep_ids[slot] if slot < len(ep_ids) else -1,
            int(b["direction"][i]), int(b["http_method"][i]), path))
    return out


class DatapathBackend(abc.ABC):
    """What the Engine needs from a datapath. The backend owns conntrack
    state (the device-side analog of pinned BPF maps): it survives snapshot
    swaps and is exportable/restorable for checkpointing."""

    @abc.abstractmethod
    def place(self, snap: PolicySnapshot) -> Any:
        """Materialize a compiled snapshot for classification; returns an
        opaque placed handle the Engine passes back to classify()."""

    def place_patch(self, placed: Any, snap: PolicySnapshot,
                    patch) -> Any:
        """Materialize an incrementally-updated snapshot given the previous
        placed handle and a compile.incremental.SnapshotPatch. Default: full
        re-place (semantically always correct); the torch backend overrides
        with device-side index updates."""
        return self.place(snap)

    @abc.abstractmethod
    def classify(self, placed: Any, snap: PolicySnapshot,
                 batch: Dict[str, np.ndarray], now: int
                 ) -> Tuple[OutArrays, OutArrays]:
        """Classify one batch against a placed snapshot. Returns
        (out, counters) as numpy: out has at least allow/reason/status/
        remote_identity; counters has by_reason_dir [C.COUNTER_CELLS]
        (reasons x directions) + insert_fail."""

    @property
    def pipeline_shards(self) -> int:
        """Flow-shard count the ingestion pipeline should steer for: > 1
        means the backend serves a flow-sharded mesh and wants pipeline
        batches delivered pre-steered (rows grouped into equal per-shard
        segments along dim 0). 1 = no steering (the default; FakeDatapath
        and the single-device TorchDatapath)."""
        return 1

    def classify_async(self, placed: Any, snap: PolicySnapshot,
                       batch: Dict[str, np.ndarray], now: int,
                       pre_steered: bool = False):
        """Enqueue one batch and return a zero-argument *finalize* callable
        that blocks until the verdicts are ready and returns the same
        (out, counters) tuple ``classify`` would.

        The contract the pipeline scheduler builds on: everything ordering-
        sensitive (CT mutation order) happens before this returns, so the
        caller may stage/pack/transfer the NEXT batch while the device is
        still computing this one. The default runs the backend's synchronous
        ``classify`` eagerly (FakeDatapath: a plain queue — no device, no
        overlap to win); the torch backend overrides it with real async
        dispatch.

        ``pre_steered``: the caller already grouped rows into
        ``pipeline_shards`` equal segments by flow-shard (the sharded
        staging ring); outputs come back in the same steered row geometry —
        the caller owns un-steering. Meaningless (and ignored) on backends
        with ``pipeline_shards == 1``, where row order carries no placement
        semantics."""
        res = self.classify(placed, snap, batch, now)
        return lambda: res

    @abc.abstractmethod
    def sweep(self, now: int) -> int:
        """Conntrack GC; returns reclaimed entry count."""

    @abc.abstractmethod
    def ct_stats(self, now: int) -> Dict[str, int]: ...

    @abc.abstractmethod
    def ct_arrays(self) -> Dict[str, np.ndarray]:
        """Host copy of the CT table in the ct_layout schema."""

    @abc.abstractmethod
    def load_ct_arrays(self, arrays: Dict[str, np.ndarray]) -> None: ...


def _empty_ct_np(cap: int) -> Dict[str, np.ndarray]:
    """An empty CT table in the checkpoint schema (uint32 numpy arrays, the
    ct_layout field order)."""
    out = {"keys": np.zeros((cap, KEY_WORDS), dtype=np.uint32)}
    for name in CT_FIELDS[1:]:
        out[name] = np.zeros((cap,), dtype=np.uint32)
    return out


class TorchDatapath(DatapathBackend):
    """Production backend: the port's classify step over torch tensors on
    one device or on a mesh of devices.

    ``DaemonConfig.device`` picks the device kind: ``"cuda"`` (the default;
    no CUDA device raises, the datapath never carries on on the CPU) or
    ``"cpu"`` (tests). ``fused_kernels`` picks the interior's executor
    (:func:`resolve_fused`).

    **The mesh.** With ``n_shards``/``rule_shards`` > 1 the datapath serves
    through a ``[n_flow, n_rule]`` grid of devices in this one process
    (``parallel/mesh.make_mesh``: cards round-robin, or ``cpu`` repeated):
    the CT splits into one power-of-two table per flow shard, on the
    device of that shard's rule shard 0; the verdict image's id-class rows
    split over the rule shards; every other tensor is placed once per
    distinct device. Rows reach the shards host-steered
    (``rss_mode="host"``: the pipeline delivers them pre-steered, or
    ``steer_batch`` regroups them here and ``finalize`` un-steers) or in
    FIFO order with the ring CT exchange (``rss_mode="device"``).
    ``ct_arrays``/``load_ct_arrays`` speak the reference's global layout
    (shard-major slot ranges), rehashed into the active geometry on
    import, so a one-device checkpoint restores onto a mesh and back.
    ``remesh`` shrinks the flow axis onto surviving shards after a device
    loss, salvaging the CT, and grows it back on heal.

    **One stream per device owns all device state.** On CUDA every method
    that touches placed tensors or the CT enqueues its work on the streams
    the datapath owns, one per distinct device, set as each device's
    current stream together: ``place``, ``place_patch``,
    ``classify_async``, ``sweep``, ``sweep_step``, ``ct_stats``,
    ``ct_arrays``, ``load_ct_arrays``, ``remesh``. On one card (a single
    device, or every shard of a mesh sharing it) that single order
    sequences the in-place CT updates of successive steps, an in-place
    verdict patch against the steps enqueued before it, and the chunked GC
    against both — whichever host thread enqueues. Across cards PyTorch's
    peer copies wait on the source device's current stream, which is the
    datapath's. Every tensor a device reads is made on its stream, so none
    needs ``record_stream``."""

    #: the column set a dict dispatch ships
    _BATCH_KEYS = ("src", "dst", "sport", "dport", "proto", "tcp_flags",
                   "is_v6", "ep_slot", "direction", "http_method",
                   "http_path", "valid")

    def __init__(self, config: Optional[DaemonConfig] = None):
        from cilium_tpu_torch.kernels.classify import make_classify_fn
        self.config = config or DaemonConfig()
        cfg = self.config
        self.n_flow_shards = max(1, cfg.n_shards)
        self.n_rule_shards = max(1, cfg.rule_shards)
        self._sharded = self.n_flow_shards * self.n_rule_shards > 1
        # device-side RSS: rows reach the shards in FIFO order and the ring
        # exchange resolves CT ownership; only meaningful with flow shards
        self._rss_device = (cfg.rss_mode == "device"
                            and self.n_flow_shards > 1)
        self._device = torch.device(cfg.device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchDatapath: device='cuda' but no CUDA device is "
                "available (pass DaemonConfig(device='cpu') to run on "
                "the CPU)")
        self._fused = resolve_fused(cfg, self._device)
        self._ct_capacity = int(cfg.ct_capacity)
        if self._sharded:
            from cilium_tpu_torch.parallel.mesh import (local_ct_capacity,
                                                        make_mesh)
            if self.n_flow_shards & (self.n_flow_shards - 1):
                raise ValueError("n_shards must be a power of two (each CT "
                                 "shard is a power-of-two hash table)")
            local_ct_capacity(self._ct_capacity, self.n_flow_shards)
            self._mesh = make_mesh(self.n_flow_shards, self.n_rule_shards,
                                   device=cfg.device)
            # flow shard i serves on row i of this CONFIGURED grid for the
            # life of the process: remesh derives survivor meshes from it
            # and device-health ordinals index into it; only
            # _live_ordinals (the serving subset) shrinks
            self._configured_devices = [list(row)
                                        for row in self._mesh.devices]
            self._live_ordinals: List[int] = list(range(self.n_flow_shards))
            self._classify = self._mesh_classify_fn(self._mesh)
            # per-survivor-set geometry cache: healing back onto a device
            # set served before reuses its mesh and step
            self._mesh_cache: Dict[Tuple[int, ...], tuple] = {
                tuple(self._live_ordinals): (self._mesh, self._classify)}
            devices = self._mesh.distinct_devices
        else:
            self._mesh = None
            self._configured_devices = None
            self._live_ordinals = [0]
            self._mesh_cache = {}
            self._classify = make_classify_fn(
                probe_depth=cfg.probe_depth, v4_only=cfg.v4_only,
                donate_ct=cfg.donate_ct, packed=True, fused=self._fused,
                device=self._device)
            devices = [self._device]
        self._streams: Dict[Any, Any] = {}
        if self._device.type == "cuda":
            self._streams = {d: torch.cuda.Stream(d) for d in devices}
        self._configured_flow_shards = self.n_flow_shards
        # per-ordinal health records latched by the dead-device classifier
        # and cleared on heal
        self.device_health: Dict[int, Dict[str, Any]] = {}
        self.remesh_stats: Dict[str, int] = {
            "remesh_total": 0,
            "remesh_ct_salvaged": 0,     # live entries carried across
            "remesh_ct_lost": 0,         # live entries on lost shards
            "remesh_ct_dropped": 0,      # rehash probe-window casualties
            "remesh_gather_failures": 0,  # device.collective / gather died
        }
        # the CT: one table per flow shard (one on a single device; on a
        # co-located mesh, views of one shard-major table)
        with self._on_stream():
            if self._colocated:
                self._cts = CTShards(make_ct_arrays(
                    CTConfig(self._ct_capacity, cfg.probe_depth),
                    device=self._home()), self.n_flow_shards)
            else:
                self._cts = [make_ct_arrays(
                    CTConfig(self._ct_capacity // self.n_flow_shards,
                             cfg.probe_depth),
                    device=self._home(f)) for f in range(self.n_flow_shards)]
        # the in-place CT step and the in-place verdict patch: the enqueue
        # of each is serialized (host-side controllers may call in)
        self._ct_lock = threading.Lock()
        # wire-format stickiness: per-batch content must not flap the wire
        # format (and the unpacker it selects) — once L7/v6 traffic is seen
        # the wider format stays, and L7 dict geometry only grows. place()
        # resets the flags when a NEW snapshot provably has no L7/v6
        # surface, so a transient burst doesn't tax every future batch.
        self._wire_l7 = False
        self._wire_wide = False        # v6 or >14-bit ep_slot seen
        self._l7_path_words = 1
        self._l7_dict_rows = 1
        # zero-copy staging: a checkout/return pool of wire buffers the
        # pack kernels fill in place, keyed by (rows, words) — pinned host
        # memory on a CUDA device, so the upload is an asynchronous copy.
        # A buffer returns to the pool only in ITS OWN batch's finalize,
        # after the event that follows its step (a pinned buffer reused
        # before its copy completes would corrupt a later batch silently);
        # a dispatch that never finalizes sheds its buffer to the GC. Only
        # power-of-two row counts (the serving shapes) are pooled.
        self._pack_lock = threading.Lock()
        self._wire_pool_cap = max(4, cfg.pipeline_inflight + 2)
        self._wire_pool: Dict[Tuple[int, int], list] = {}
        self._wire_out = 0
        self._batches_since_wide = 0
        # L7 path-dict upload cache: real traffic repeats the same path set
        # batch after batch — an unchanged dict is never re-transferred
        # (one device copy per distinct device)
        self._path_dict_host: Optional[np.ndarray] = None
        self._path_dict_dev: Dict[Any, torch.Tensor] = {}
        self.pack_stats: Dict[str, int] = {
            "pack_inplace": 0,            # packed into a pooled wire buffer
            "pack_fallback_disabled": 0,  # zero-copy ingest turned off
            "pack_fallback_steered": 0,   # un-steered sharded batch
            "pack_fallback_shape": 0,     # unpoolable (non-pow2) row count
            "upload_cache_hits": 0,       # path dict served from device cache
            "upload_cache_misses": 0,
            "wire_flag_resets": 0,        # place() narrowed the wire format
            "l7_rows": 0,                 # rows that carry an HTTP request
            "v6_rows": 0,                 # is_v6 rows
            "l7_dict_paths": 0,           # unique paths, summed over dicts
        }
        # live-patch attribution: how each place_patch applied (delta = the
        # in-place device scatter; full = whole-tensor re-upload) and how
        # often the StalePlacement fence fired
        self.patch_stats: Dict[str, int] = {
            "patch_delta": 0,
            "patch_full": 0,
            "patch_rows": 0,              # rows scatter-applied, cumulative
            "patch_stale_fences": 0,
            "patch_scatter_errors": 0,    # failed scatters self-healed by
                                          # a full verdict re-upload
        }
        # device-memory ledger: bytes per placed tensor group, re-accounted
        # on every place/place_patch, CT at construction/restore, the wire
        # pool on demand; the device-RSS exchange's peak bucket bytes
        self._hbm_lock = threading.Lock()
        self._hbm_groups: Dict[str, int] = {}
        self._hbm_places = 0
        self._hbm_patches = 0
        self._exchange_last_bytes = 0
        self._exchange_peak_bytes = 0
        self._account_ct_hbm()
        # overlapped CT GC (kernels/conntrack.ct_sweep_chunk): cursor into
        # the slot space + the previous tick's (event, pinned scalars) —
        # the double buffer, harvested one tick later so the enqueue path
        # never waits on the device
        self._gc_cursor = 0
        self._gc_epoch = 0
        self._gc_pending = None
        self._gc_reclaimed_total = 0
        self._gc_last_live = -1

    def _mesh_classify_fn(self, mesh):
        from cilium_tpu_torch.parallel.mesh import (make_sharded_classify_fn,
                                                    make_unsteered_classify_fn)
        make_fn = (make_unsteered_classify_fn if self._rss_device
                   else make_sharded_classify_fn)
        return make_fn(mesh, probe_depth=self.config.probe_depth,
                       v4_only=self.config.v4_only,
                       donate_ct=self.config.donate_ct, fused=self._fused)

    @property
    def _colocated(self) -> bool:
        """A mesh whose flow shards share one device, rule axis 1."""
        return self._mesh is not None and self._mesh.colocated

    def _home(self, flow: int = 0):
        """The device of flow shard ``flow``'s step and CT."""
        if self._mesh is None:
            return self._device
        return self._mesh.device_of(flow)

    @property
    def _stream(self):
        """The home device's stream (None on the CPU): the fetches and GC
        scalars of a step are copied on it, after every shard's work."""
        return self._streams.get(self._home())

    @property
    def pipeline_shards(self) -> int:
        """The ingestion pipeline steers for the flow axis only — rule
        shards replicate the batch, so a rules-only mesh needs no row
        grouping. With device-side RSS the answer is 1: row order carries
        no placement, and the ring exchange owns flow → shard
        resolution."""
        if self._rss_device:
            return 1
        return self.n_flow_shards if self._sharded else 1

    @property
    def rss_state(self) -> Dict[str, Any]:
        """Where flow → shard resolution runs ("host" steering or the
        "device" ring exchange), the mesh's flow-axis size, and whether
        device mode is active (it needs a flow-sharded mesh)."""
        return {
            "mode": "device" if self._rss_device else "host",
            "shards": self.n_flow_shards if self._sharded else 1,
            "active": self._rss_device,
        }

    def rss_exchange_stats(self) -> Optional[Dict[str, int]]:
        """Exchange-buffer occupancy for the resource ledger (device RSS
        only): bytes the last dispatched bucket's gathered request/reply
        buffers took across the mesh, against the worst case at
        ``batch_size``."""
        if not self._rss_device:
            return None
        from cilium_tpu_torch.parallel.exchange import exchange_bytes
        cap = exchange_bytes(self.config.batch_size, self.n_flow_shards)
        with self._hbm_lock:
            return {"capacity": max(cap, self._exchange_peak_bytes),
                    "in_use": self._exchange_last_bytes,
                    "peak": self._exchange_peak_bytes}

    @property
    def fused_state(self) -> Dict[str, Any]:
        """Operator-facing view of the kernel selector: the configured
        mode, whether the CUDA kernels run (``interpret`` is always False:
        there is no interpreted build of the kernels), and how many times
        this process has launched each one (``kernels/fused.LAUNCHES``)."""
        from cilium_tpu_torch.kernels.fused import LAUNCHES
        return {
            "mode": self.config.fused_kernels,
            "active": self._fused,
            "interpret": False,
            "launches": dict(LAUNCHES),
        }

    def _on_stream(self):
        """Every device's stream as its current one (a no-op on the
        CPU)."""
        stack = contextlib.ExitStack()
        for s in self._streams.values():
            stack.enter_context(torch.cuda.stream(s))
        return stack

    def _maybe_reset_wire_flags(self, snap: PolicySnapshot) -> None:
        """Un-stick the widened wire formats when the NEW snapshot provably
        has no surface that needs them: with zero L7 rule sets, http tokens
        cannot affect any verdict, and with no v6 prefixes + all ep slots
        under the compact cap, the 4-word v4 wire is sufficient. The wide
        reset additionally requires WIRE_RESET_CLEAN_BATCHES batches
        without v6 traffic, so sustained v6 flows never reset-flap the
        format across regens."""
        from cilium_tpu_torch.kernels.records import PACK4_EP_SLOT_MAX
        # under the pack lock: a concurrent classify_async reads/widens the
        # same flags there — a reset landing between its widen and its
        # format choice would mispack the in-flight batch
        with self._pack_lock:
            reset = False
            if self._wire_l7 and snap.l7.n_sets == 0:
                self._wire_l7 = False
                self._l7_path_words = 1
                self._l7_dict_rows = 1
                self._path_dict_host = None
                self._path_dict_dev = {}
                with self._hbm_lock:
                    self._hbm_groups.pop("l7_dict", None)
                reset = True
            # slots run 0..len-1, so the compact wire fits through
            # len == PACK4_EP_SLOT_MAX + 1 inclusive
            if self._wire_wide \
                    and len(snap.ep_ids) - 1 <= PACK4_EP_SLOT_MAX \
                    and self._batches_since_wide >= WIRE_RESET_CLEAN_BATCHES \
                    and not any(":" in p for p in snap.ipcache):
                self._wire_wide = False
                reset = True
            if reset:
                self.pack_stats["wire_flag_resets"] += 1

    # -- device-memory ledger ---------------------------------------------------
    @staticmethod
    def _hbm_group(name: str) -> str:
        """Placed-tensor name → ledger group: the verdict image (what
        place_patch scatters; on a rule-sharded mesh its row slices), the
        LPM tries, the remaining policy planes."""
        if name.split(".")[0] == "verdict":
            return "verdict"
        if name.startswith("lpm"):
            return "tries"
        return "policy"

    @staticmethod
    def _nbytes(t: torch.Tensor) -> int:
        return int(t.numel() * t.element_size())

    def _logical_tensors(self, placed):
        """(name, tensor) of a placement, each logical tensor once: a mesh
        counts its replicated tensors once and each verdict row slice
        once, as the reference counts a sharded array's global bytes."""
        if self._mesh is None:
            return list(placed.items())
        from cilium_tpu_torch.parallel.mesh import verdict_slice_name
        own = placed[self._home()]
        items = [(k, v) for k, v in own.items()
                 if not k.startswith("verdict.")]
        if self.n_rule_shards > 1:
            items += [(verdict_slice_name(r),
                       placed[self._mesh.device_of(0, r)][
                           verdict_slice_name(r)])
                      for r in range(self.n_rule_shards)]
        return items

    def _account_placed(self, placed: Dict, patched: bool) -> None:
        groups = {"verdict": 0, "tries": 0, "policy": 0}
        for k, v in self._logical_tensors(placed):
            groups[self._hbm_group(k)] += self._nbytes(v)
        with self._hbm_lock:
            self._hbm_groups.update(groups)
            if patched:
                self._hbm_patches += 1
            else:
                self._hbm_places += 1

    def _account_ct_hbm(self) -> None:
        n = sum(self._nbytes(v) for ct in self._cts for v in ct.values())
        with self._hbm_lock:
            self._hbm_groups["ct"] = n

    def hbm_ledger(self) -> Dict[str, Any]:
        """Bytes per placed tensor group, live: verdict image / LPM tries /
        policy planes / CT table / the L7 wire's path dictionary
        (``l7_dict``, present once a dictionary has been placed) / the
        device-RSS exchange's peak bucket (device-resident; a mesh counts
        each logical tensor once), plus the pooled wire staging buffers
        (host memory; flagged so the two kinds are never summed into one
        misleading number). On a CUDA
        device ``memory_allocated`` is the caching allocator's own count
        beside them (it also holds the step's transient tensors)."""
        with self._pack_lock:
            wire = sum(self._nbytes(b) for pool in self._wire_pool.values()
                       for b in pool)
            wire_keys = len(self._wire_pool)
        with self._hbm_lock:
            groups = dict(self._hbm_groups)
            places, patches = self._hbm_places, self._hbm_patches
        device_total = sum(groups.values())
        groups["wire_pool"] = wire
        doc = {
            "groups": groups,
            "device_bytes": device_total,
            "host_pool_bytes": wire,
            "wire_pool_keys": wire_keys,
            "places_total": places,
            "patches_total": patches,
        }
        if self._device.type == "cuda":
            doc["memory_allocated"] = int(sum(
                torch.cuda.memory_allocated(d) for d in self._streams))
        return doc

    def wire_pool_stats(self) -> Dict[str, int]:
        """Pool occupancy for the resource ledger: buffers checked out with
        in-flight batches against the pool's slots across active (rows,
        words) keys."""
        with self._pack_lock:
            keys = max(1, len(self._wire_pool))
            free = sum(len(p) for p in self._wire_pool.values())
            out = self._wire_out
        cap = self._wire_pool_cap * keys
        return {"capacity": max(cap, out), "free": free,
                "in_flight": out, "keys": keys}

    # -- placement --------------------------------------------------------------
    def _put_tensor(self, v: np.ndarray, device=None) -> torch.Tensor:
        """A host array (the reference's dtypes) → a fresh tensor on
        ``device`` (default: the home device), in the port's dtype (call
        on the streams). On a CUDA device the array is staged in pinned
        memory and copied asynchronously, so the host does not wait for
        the steps already queued."""
        from cilium_tpu_torch.convert import port_dtype
        a = port_dtype(np.asarray(v))
        if not self._streams:
            return torch.tensor(a)
        host = torch.empty(a.shape, dtype=_TORCH_DTYPE[a.dtype],
                           pin_memory=True)
        host.numpy()[...] = a
        return host.to(device or self._home(), non_blocking=True)

    def _place_into(self, handle: Dict, tensors: Dict[str, np.ndarray]
                    ) -> None:
        """Place host ``tensors`` into ``handle`` (call on the streams):
        by name on one device; on a mesh every distinct device's copies
        (``parallel/mesh.mesh_placement``)."""
        if self._mesh is None:
            for k, v in tensors.items():
                handle[k] = self._put_tensor(v)
            return
        from cilium_tpu_torch.parallel.mesh import mesh_placement
        for d, arrs in mesh_placement(tensors, self._mesh).items():
            handle[d].update({k: self._put_tensor(a, d)
                              for k, a in arrs.items()})

    def _copy_handle(self, placed) -> "PlacedTensors":
        """A new handle sharing ``placed``'s tensors."""
        if self._mesh is None:
            return PlacedTensors(placed)
        return PlacedTensors({d: dict(t) for d, t in placed.items()})

    def place(self, snap: PolicySnapshot) -> Dict:
        self._maybe_reset_wire_flags(snap)
        placed = PlacedTensors() if self._mesh is None else PlacedTensors(
            {d: {} for d in self._mesh.distinct_devices})
        with self._on_stream():
            self._place_into(placed, snap.tensors())
        self._account_placed(placed, patched=False)
        return placed

    def _verdict_copies(self, placed):
        """Every verdict tensor of a placement: (the dict that holds it,
        its key, the first global id-class row it holds, its row count or
        None for all)."""
        if self._mesh is None:
            return [(placed, "verdict", 0, None)]
        if self.n_rule_shards == 1:
            return [(t, "verdict", 0, None) for t in placed.values()]
        from cilium_tpu_torch.parallel.mesh import verdict_slice_name
        out = []
        for t in placed.values():
            for r in range(self.n_rule_shards):
                key = verdict_slice_name(r)
                if key in t:
                    rows = t[key].shape[2]
                    out.append((t, key, r * rows, rows))
        return out

    @staticmethod
    def _rows_in(rows_np: np.ndarray, lo: int, n) -> np.ndarray:
        """Mask of delta rows [K, 3] whose id-class row lies in
        ``[lo, lo + n)`` (all when ``n`` is None)."""
        if n is None:
            return np.ones(rows_np.shape[0], dtype=bool)
        return (rows_np[:, 2] >= lo) & (rows_np[:, 2] < lo + n)

    def _scatter_rows(self, verdict: torch.Tensor, rows: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
        """In-place scatter-apply of a sparse verdict delta on the stream:
        ``rows`` [K, 3] (endpoint slot, direction, id-class row), ``vals``
        [K, n_cols]. Exactly the K rows, every index in range."""
        rows = rows.long()
        verdict.index_put_((rows[:, 0], rows[:, 1], rows[:, 2]), vals)
        return verdict

    def place_patch(self, placed, snap: PolicySnapshot, patch) -> Dict:
        """Incremental device update: re-upload only tensors the patch
        names; when the compiler shipped a sparse (rows, values) delta,
        scatter it into the device-resident verdict image IN PLACE — on a
        mesh into every copy, and into each rule shard's rows — with no
        host round trip of any plane.

        The in-place write is fenced: under the classify lock the old
        handle is marked dead before the scatter is enqueued, so a
        concurrent classify that captured the old handle either enqueued
        before the patch (the stream runs its reads first) or observes
        ``dead`` and raises :class:`StalePlacement` for the caller to retry
        against the new active snapshot — no batch ever classifies against
        a torn image. A patch of a whole tensor (``full_tensors``) places a
        fresh tensor and leaves the old handle's untouched."""
        self._maybe_reset_wire_flags(snap)
        tracer, trace_id = active_trace()

        new_placed = self._copy_handle(placed)
        if patch.full_tensors:
            # selective host materialization: only the named tensors are
            # read (a delta-emitted snapshot's dense image stays lazy)
            tensors = snap.tensors(only=frozenset(patch.full_tensors))
            with self._on_stream():
                self._place_into(new_placed, {
                    name: tensors[name] for name in patch.full_tensors
                    if name in tensors})

        if patch.verdict_rows and "verdict" not in patch.full_tensors:
            use_delta = (self.config.delta_patch
                         and patch.delta_rows is not None)
            if use_delta:
                rows_np, vals_np = patch.delta_rows, patch.delta_vals
                k = rows_np.shape[0]
                with tracer.span(trace_id, PATCH_APPLY_SPAN, rows=k):
                    scatter_failed = False
                    with self._on_stream():
                        pieces = []
                        for t, key, lo, n in self._verdict_copies(
                                new_placed):
                            sel = self._rows_in(rows_np, lo, n)
                            if not sel.any():
                                continue
                            r = rows_np[sel].copy()
                            r[:, 2] -= lo
                            dev = t[key].device
                            pieces.append((t, key, self._put_tensor(r, dev),
                                           self._put_tensor(vals_np[sel],
                                                            dev)))
                        with self._ct_lock:
                            # the fence: dead flips atomically with the
                            # in-place write — any enqueue that comes
                            # later sees it and retries against the new
                            # active snapshot
                            if isinstance(placed, PlacedTensors):
                                placed.dead = True
                            try:
                                for t, key, r, v in pieces:
                                    t[key] = self._scatter_rows(t[key], r, v)
                            except Exception:   # noqa: BLE001 — healed below
                                # the handle is marked dead: a raise here
                                # would leave regenerate()'s serve-last-good
                                # degradation pinned on a handle every
                                # classify refuses. Self-heal with a full
                                # verdict upload of the NEW snapshot.
                                scatter_failed = True
                    if scatter_failed:
                        # the healed patch COUNTS AS FULL: patch_delta only
                        # ever means "the in-place scatter actually ran"
                        self.patch_stats["patch_scatter_errors"] += 1
                        self.patch_stats["patch_full"] += 1
                        v = snap.tensors(only=frozenset(("verdict",)))
                        with self._on_stream():
                            self._place_into(new_placed, v)
                    else:
                        self.patch_stats["patch_delta"] += 1
                        self.patch_stats["patch_rows"] += k
            else:
                # legacy path (delta_patch off, or a patch without the
                # payload): a functional row update of a copy from
                # host-gathered values — the old handle stays live
                rows = np.asarray(patch.verdict_rows, dtype=np.int32)
                vals = snap.tensors(only=frozenset(("verdict",)))[
                    "verdict"][rows[:, 0], rows[:, 1], rows[:, 2]]
                with self._on_stream():
                    for t, key, lo, n in self._verdict_copies(new_placed):
                        sel = self._rows_in(rows, lo, n)
                        verdict = t[key].clone()
                        if sel.any():
                            dev = verdict.device
                            r = self._put_tensor(rows[sel], dev).long()
                            verdict.index_put_(
                                (r[:, 0], r[:, 1], r[:, 2] - lo),
                                self._put_tensor(vals[sel], dev))
                        t[key] = verdict
                self.patch_stats["patch_full"] += 1
        else:
            self.patch_stats["patch_full"] += 1
        self._account_placed(new_placed, patched=True)
        return new_placed

    # -- classification ---------------------------------------------------------
    def classify(self, placed, snap, batch, now):
        return self.classify_async(placed, snap, batch, now)()

    def _pack_wire(self, b, snap, pooled: bool = True,
                   fallback_reason: str = "shape"):
        """The zero-copy pack: widen-then-choose the sticky wire format
        under the pack lock, check out a pooled wire buffer, pack in
        place. Returns (wire, path_dict_or_None, wire_key, wire_buf) —
        wire_key is None when the pack allocated (the buffer then just
        sheds to the GC instead of returning to the pool).

        The lock covers only widen-then-choose + the pool checkout (a
        concurrent place() reset lands before or after this batch's whole
        format decision, never between); the column writes run outside it,
        into the private buffer. L7 widening is POLICY-gated: with zero L7
        rule sets, tokens cannot affect any verdict, so tokenized traffic
        under an L7-free policy stays on the compact wire.

        ``pooled=False`` skips the pool and counts the batch under
        ``pack_fallback_{fallback_reason}`` (the allocating steer of an
        un-steered batch on a host-steered mesh).

        On the L7 wire the path dictionary's pack (``np.unique`` over the
        batch's paths) is the span ``datapath.pack.l7_dict``, a child of
        the caller's ``datapath.pack``, with the batch's ``rows``, the
        unique ``paths`` and the padded ``dict_rows`` shipped. Every batch
        adds to ``pack_stats`` ``l7_rows`` (rows that carry a request),
        ``v6_rows`` and, on the L7 wire, ``l7_dict_paths`` (its unique
        paths); ``render_metrics`` exports them as
        ``datapath_<key>_total``. The device copy of the dictionary is the
        ledger group ``l7_dict`` (``_upload_path_dict``), counted once on a
        mesh."""
        from cilium_tpu_torch.kernels.records import (
            PACK4_EP_SLOT_MAX, _pack_path_dict, _path_words_of, pack_batch,
            pack_batch_v4, pack_l7dict_wire, wire_words_for)
        has_method = b["http_method"] != C.HTTP_METHOD_ANY
        batch_l7 = bool(has_method.any() or b["http_path"].any())
        # the rows are counted only where the batch carries a request: an
        # L7-free batch pays no pass beyond the two reductions above
        l7_rows = int(np.count_nonzero(
            has_method | b["http_path"].any(axis=1))) if batch_l7 else 0
        v6_rows = int(np.count_nonzero(b["is_v6"]))
        batch_wide = bool(
            v6_rows or int(b["ep_slot"].max(initial=0)) > PACK4_EP_SLOT_MAX)
        path_dict = None
        n_rows = int(b["valid"].shape[0])
        zero_copy = self.config.zero_copy_ingest and pooled
        with self._pack_lock:
            self.pack_stats["l7_rows"] += l7_rows
            self.pack_stats["v6_rows"] += v6_rows
            if snap.l7.n_sets > 0:
                self._wire_l7 |= batch_l7
            self._wire_wide |= batch_wide
            self._batches_since_wide = 0 if batch_wide \
                else self._batches_since_wide + 1
            use_l7, use_wide = self._wire_l7, self._wire_wide
            if use_l7:
                self._l7_path_words = max(self._l7_path_words,
                                          _path_words_of(b["http_path"]))
                l7_path_words = self._l7_path_words
                l7_min_rows = self._l7_dict_rows
            words = wire_words_for(use_l7, use_wide)
            wire_buf = self._wire_buf(n_rows, words) if zero_copy else None
            wire_key = (n_rows, words) if wire_buf is not None else None
            if wire_buf is not None:
                self.pack_stats["pack_inplace"] += 1
            elif not self.config.zero_copy_ingest:
                self.pack_stats["pack_fallback_disabled"] += 1
            else:
                self.pack_stats[f"pack_fallback_{fallback_reason}"] += 1
        out = None if wire_buf is None else wire_buf.numpy().view(np.uint32)
        try:
            if use_l7:
                tracer, trace_id = active_trace()
                with tracer.span(trace_id, "datapath.pack.l7_dict",
                                 rows=n_rows) as span:
                    path_dict, path_idx = _pack_path_dict(
                        b["http_path"], l7_path_words, l7_min_rows)
                    paths = int(path_idx.max(initial=-1)) + 1
                    span.annotate(paths=paths,
                                  dict_rows=int(path_dict.shape[0]))
                wire = pack_l7dict_wire(b, path_idx, force_full=use_wide,
                                        out=out)
                with self._pack_lock:       # dict geometry stays grow-only
                    self._l7_dict_rows = max(self._l7_dict_rows,
                                             path_dict.shape[0])
                    self.pack_stats["l7_dict_paths"] += paths
            elif not use_wide:
                wire = pack_batch_v4(b, out=out)
            else:
                wire = pack_batch(b, l7=False, out=out)
        except BaseException:
            # the checkout already counted this buffer in flight; a pack
            # that dies here never reaches a finalize to release it
            self._wire_buf_shed(wire_key)
            raise
        return wire, path_dict, wire_key, wire_buf

    @staticmethod
    def _columnar(batch):
        """Already-columnar staged batches (the pipeline's staging ring)
        skip the per-batch dict copy."""
        if all(type(v) is np.ndarray for v in batch.values()):
            return batch
        return {k: np.asarray(v) for k, v in batch.items()}

    def _upload_wire(self, wire: np.ndarray,
                     wire_buf: Optional[torch.Tensor], device=None,
                     rows: Optional[slice] = None) -> torch.Tensor:
        """The packed wire's ``rows`` (default all) on ``device`` (default
        the home device; call on the streams). A pooled buffer is the
        whole wire: on a CUDA device it is pinned and the copy is
        asynchronous; an unpooled pack (a rare control-plane shape) copies
        from pageable memory."""
        if wire_buf is not None and wire.shape == tuple(wire_buf.shape):
            src = wire_buf
        else:
            src = torch.from_numpy(np.ascontiguousarray(wire).view(np.int32))
        if rows is not None:
            src = src[rows]
        if not self._streams:
            return src
        dev = torch.empty(src.shape, dtype=torch.int32,
                          device=device or self._home())
        dev.copy_(src, non_blocking=src.is_pinned())
        return dev

    def _fetch(self, out: Dict[str, torch.Tensor],
               counters: Dict[str, torch.Tensor]):
        """Enqueue the step's outputs back to the host (call on the
        streams, after the step): one copy per tensor into pinned host
        memory, then an event on the home stream. → a callable that waits
        on that event and returns (out, counters) as numpy in the
        reference's dtypes."""
        from cilium_tpu_torch.convert import U32_OUT

        def host(d):
            return {k: (v.numpy().view(np.uint32) if k in U32_OUT
                        else v.numpy()) for k, v in d.items()}
        if not self._streams:
            return lambda: (host(out), host(counters))

        def pinned(d):
            res = {}
            for k, v in d.items():
                h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                h.copy_(v, non_blocking=True)
                res[k] = h
            return res
        out_h, cnt_h = pinned(out), pinned(counters)
        done = torch.cuda.Event()
        done.record(self._stream)

        def wait():
            done.synchronize()
            return host(out_h), host(cnt_h)
        return wait

    def classify_async(self, placed, snap, batch, now, pre_steered=False):
        """Asynchronous dispatch (the pipeline's overlap stage): host
        packing, the upload, the step and the copies of its outputs are
        enqueued here, in CT order, and nothing waits on the device; the
        returned finalize waits on the event recorded after the output
        copies, which is where the host blocks. On the CPU the step runs
        to its end here.

        ``pre_steered`` (a host-steered mesh): the rows are already grouped
        into ``pipeline_shards`` equal per-shard segments (the pipeline's
        steered staging ring), and the outputs come back in that layout
        (the caller un-steers). Meaningless elsewhere."""
        if self._sharded:
            if self._rss_device:
                return self._classify_async_device(placed, snap, batch, now)
            return self._classify_async_sharded(placed, snap, batch, now,
                                                pre_steered=pre_steered)
        tracer, trace_id = active_trace()
        with tracer.span(trace_id, "datapath.pack"):
            b = self._columnar(batch)
            wire, path_dict, wire_key, wire_buf = self._pack_wire(b, snap)
        try:
            with tracer.span(trace_id, "datapath.transfer",
                             bytes=int(wire.nbytes)):
                # chaos points: a wedged/failed host→device link, and the
                # CT insert phase of this dispatch (a trip rejects the
                # batch — tickets fail closed, FIFO intact)
                FAULTS.fire("datapath.transfer")
                FAULTS.fire("ct.insert")
                with self._on_stream():
                    dev_wire = self._upload_wire(wire, wire_buf)
                    if path_dict is not None:
                        dev_batch = (dev_wire, self._upload_path_dict(
                            path_dict, [self._device])[self._device])
                    else:
                        dev_batch = dev_wire
                    with self._ct_lock:
                        self._check_placed(placed)
                        out, new_ct, counters = self._classify(
                            dict(placed), self._cts[0], dev_batch,
                            int(now) & 0xFFFFFFFF, int(snap.world_index))
                        self._cts = [new_ct]
                    fetched = self._fetch(out, counters)
        except BaseException:
            self._wire_buf_shed(wire_key)    # finalize will never run
            raise
        return self._finalizer(tracer, trace_id, fetched, wire_key, wire_buf)

    def _finalizer(self, tracer, trace_id, fetched, wire_key, wire_buf,
                   post=None, device_loss: bool = False):
        """The ``finalize`` of one dispatch: wait for its outputs, return
        its pooled wire buffer, and apply ``post`` (the un-steer or the
        padding's truncation) to the outputs."""
        def finalize():
            # datapath.compute: the host blocked on this dispatch's output
            # event. On a card that is the wait on the device (the step
            # was enqueued in classify_async), not its compute time; on
            # the CPU the step already ran there. The ``fused`` tag names
            # the executor (the CUDA kernels vs the plain versions)
            try:
                with tracer.span(trace_id, "datapath.compute",
                                 fused=int(self._fused)):
                    out_np, counters_np = fetched()
            except BaseException as e:
                # a failed wait (device error) never releases: shed the
                # checkout count, the buffer goes to the GC
                self._wire_buf_shed(wire_key)
                if device_loss:
                    self._maybe_device_lost(e)
                raise
            if wire_key is not None:
                # the event followed this batch's step: the device is done
                # with the wire buffer, which may be reused now — and ONLY
                # now
                self._wire_buf_release(wire_key, wire_buf)
            if post is not None:
                out_np = post(out_np)
            return out_np, counters_np
        return finalize

    def _dispatch_mesh(self, placed, snap, b, now, pooled: bool,
                       fallback_reason: str, tracer, trace_id, span_kw):
        """Pack ``b`` (rows a multiple of the flow axis), upload each flow
        shard's rows to its device (the whole wire at once where the
        steered step is one step over co-located shards), enqueue the
        meshed step and the fetch. → (fetched, wire_key, wire_buf)."""
        from cilium_tpu_torch.parallel.mesh import ShardedBatch
        n = self.n_flow_shards
        with tracer.span(trace_id, "datapath.pack", **span_kw):
            if not self.config.zero_copy_ingest:
                # the column-dict dispatch (each shard's rows copied from
                # the host columns)
                with self._pack_lock:
                    self.pack_stats["pack_fallback_disabled"] += 1
                wire = path_dict = wire_key = wire_buf = None
                dict_batch = {k: b[k] for k in self._BATCH_KEYS}
                nbytes = sum(v.nbytes for v in dict_batch.values())
            else:
                dict_batch = None
                wire, path_dict, wire_key, wire_buf = self._pack_wire(
                    b, snap, pooled=pooled, fallback_reason=fallback_reason)
                nbytes = int(wire.nbytes)
        try:
            with tracer.span(trace_id, "datapath.transfer", bytes=nbytes,
                             shards=n):
                FAULTS.fire("datapath.transfer")
                FAULTS.fire("ct.insert")
                self._fire_device_fault()
                with self._on_stream():
                    if dict_batch is not None:
                        dev_batch = dict_batch
                    elif self._colocated and not self._rss_device:
                        home = self._home()
                        dev_batch = self._upload_wire(wire, wire_buf)
                        if path_dict is not None:
                            dev_batch = (dev_batch, self._upload_path_dict(
                                path_dict, [home])[home])
                    else:
                        per = wire.shape[0] // n
                        devs = [self._home(f) for f in range(n)]
                        dicts = None if path_dict is None else \
                            self._upload_path_dict(path_dict, devs)
                        segs = []
                        for f, dev in enumerate(devs):
                            w = self._upload_wire(
                                wire, wire_buf, dev,
                                slice(f * per, (f + 1) * per))
                            segs.append(w if dicts is None
                                        else (w, dicts[dev]))
                        dev_batch = ShardedBatch(segs)
                    with self._ct_lock:
                        self._check_placed(placed)
                        out, self._cts, counters = self._classify(
                            dict(placed), self._cts, dev_batch,
                            int(now) & 0xFFFFFFFF, int(snap.world_index))
                    fetched = self._fetch(out, counters)
        except BaseException as e:
            self._wire_buf_shed(wire_key)    # finalize will never run
            self._maybe_device_lost(e)       # dead-device signature?
            raise
        return fetched, wire_key, wire_buf

    def _classify_async_sharded(self, placed, snap, batch, now,
                                pre_steered=False):
        """The host-steered mesh. Pre-steered batches (the pipeline's
        steered staging ring: rows in equal per-shard segments) pack in
        place into one pooled wire buffer whose segments are the per-shard
        uploads, and finalize returns the outputs in that layout (the
        caller un-steers). Un-steered batches (the synchronous
        control-plane entry) steer here with the allocating regroup —
        counted ``pack_fallback_steered`` — and finalize un-steers them. A
        rules-only mesh needs no row grouping: every batch counts as
        pre-steered."""
        from cilium_tpu_torch.parallel.mesh import (steer_batch,
                                                    unsteer_outputs)
        tracer, trace_id = active_trace()
        n = self.n_flow_shards
        pre = pre_steered or n == 1
        scatter = None
        b = self._columnar(batch)
        if not pre:
            # steering hashes the post-DNAT tuple (service flows' CT
            # entries live under the translated tuple), as the shim does
            lb = snap.lb if snap.lb.n_frontends else None
            with tracer.span(trace_id, "datapath.steer"):
                b, scatter, _per = steer_batch(b, n, lb=lb,
                                               round_to_pow2=True)
        n_rows = int(b["valid"].shape[0])
        if n_rows % n:
            raise ValueError(f"pre-steered batch rows ({n_rows}) must "
                             f"divide into {n} flow shards")
        fetched, wire_key, wire_buf = self._dispatch_mesh(
            placed, snap, b, now, pooled=pre,
            fallback_reason="shape" if pre else "steered", tracer=tracer,
            trace_id=trace_id, span_kw={"shards": n})
        post = None if scatter is None else (
            lambda out: unsteer_outputs(out, scatter))
        return self._finalizer(tracer, trace_id, fetched, wire_key,
                               wire_buf, post, device_loss=True)

    def _classify_async_device(self, placed, snap, batch, now):
        """The device-RSS mesh: the batch ships in ARRIVAL order, each
        flow shard taking an equal slice, and flow → shard resolution
        happens in the step's ring exchange. No steering and no un-steer:
        outputs come back in FIFO order. Batches whose rows are not a
        power-of-two multiple of the width (control-plane classifies) pad
        with invalid rows, and finalize truncates the padding."""
        from cilium_tpu_torch.parallel.exchange import exchange_bytes
        tracer, trace_id = active_trace()
        n = self.n_flow_shards
        b = self._columnar(batch)
        orig_rows = rows = int(b["valid"].shape[0])
        if rows % n or rows & (rows - 1):
            from cilium_tpu_torch.kernels.records import empty_batch
            per = 1 << max(0, (-(-rows // n) - 1).bit_length())
            rows = per * n
            pb = empty_batch(rows)
            for k, col in pb.items():
                col[:orig_rows] = b[k]
            b = pb
        ex_bytes = exchange_bytes(rows, n)
        with self._hbm_lock:
            self._exchange_last_bytes = ex_bytes
            if ex_bytes > self._exchange_peak_bytes:
                self._exchange_peak_bytes = ex_bytes
                self._hbm_groups["exchange"] = ex_bytes
        fetched, wire_key, wire_buf = self._dispatch_mesh(
            placed, snap, b, now, pooled=True, fallback_reason="shape",
            tracer=tracer, trace_id=trace_id,
            span_kw={"shards": n, "rss": "device"})
        post = None if orig_rows == rows else (
            lambda out: {k: v[:orig_rows] for k, v in out.items()})
        return self._finalizer(tracer, trace_id, fetched, wire_key,
                               wire_buf, post, device_loss=True)

    def _wire_buf(self, rows: int, words: int) -> Optional[torch.Tensor]:
        """Check out a pooled wire buffer (pack lock held): an int32 host
        tensor, pinned on a CUDA device. It returns to the pool in its
        batch's finalize; pool misses allocate. Non-power-of-two row
        counts return None (pooling every size ever seen would grow
        without bound)."""
        if rows & (rows - 1):
            return None
        self._wire_out += 1
        pool = self._wire_pool.get((rows, words))
        if pool:
            return pool.pop()
        return torch.empty((rows, words), dtype=torch.int32,
                           pin_memory=bool(self._streams))

    def _wire_buf_release(self, key: Tuple[int, int],
                          buf: torch.Tensor) -> None:
        with self._pack_lock:
            self._wire_out = max(0, self._wire_out - 1)
            pool = self._wire_pool.setdefault(key, [])
            if len(pool) < self._wire_pool_cap:
                pool.append(buf)

    def _wire_buf_shed(self, wire_key) -> None:
        """A dispatch died between checkout and finalize: the buffer sheds
        to the GC (an aborted copy may still read it — never re-pool it),
        but the in-flight count comes back down."""
        if wire_key is None:
            return
        with self._pack_lock:
            self._wire_out = max(0, self._wire_out - 1)

    def _upload_path_dict(self, path_dict: np.ndarray, devices
                          ) -> Dict[Any, torch.Tensor]:
        """Device copies of the L7 path dict, one per device of
        ``devices``, cached by content (call on the streams): serving
        traffic repeats a small stable path set, so in steady state the
        dict is uploaded once and every later batch reuses the device
        tensors. One hit or miss is counted per batch."""
        with self._pack_lock:
            cached_host = self._path_dict_host
            cached = dict(self._path_dict_dev)
        if (cached_host is not None
                and cached_host.shape == path_dict.shape
                and np.array_equal(cached_host, path_dict)
                and all(d in cached for d in devices)):
            with self._pack_lock:
                self.pack_stats["upload_cache_hits"] += 1
            return cached
        devs = {d: self._put_tensor(path_dict, d) for d in devices}
        with self._pack_lock:
            self.pack_stats["upload_cache_misses"] += 1
            # the dict is a fresh np.unique product (never pool-aliased):
            # safe to retain as the comparison baseline without a copy
            self._path_dict_host = path_dict
            self._path_dict_dev = devs
            # its own ledger group, set only once a dictionary is placed:
            # on the v4 wire the group is absent, so the groups (and the
            # device bytes beyond them) read as they did before it existed.
            # Every device holds the same dictionary: one logical tensor,
            # counted once, as _logical_tensors counts a replicated trie
            with self._hbm_lock:
                self._hbm_groups["l7_dict"] = self._nbytes(
                    next(iter(devs.values())))
        return devs

    def _check_placed(self, placed) -> None:
        """Classify-lock-held patch fence: refuse to enqueue against a
        handle whose verdict a delta patch wrote in place (or whose mesh a
        remesh replaced)."""
        if isinstance(placed, PlacedTensors) and placed.dead:
            self.patch_stats["patch_stale_fences"] += 1
            raise StalePlacement(
                "placed snapshot was delta-patched in place; re-capture "
                "the active snapshot and retry")

    # -- conntrack ---------------------------------------------------------------
    def _local_cap(self) -> int:
        return self._ct_capacity // len(self._cts)

    def sweep(self, now: int) -> int:
        """Whole-table epoch GC, synchronous: → reclaimed entries."""
        from cilium_tpu_torch.kernels import conntrack as ctk
        with self._on_stream():
            with self._ct_lock:
                counts = [ctk.ct_sweep(ct, now, inplace=True)[1]
                          for ct in self._cts]
            return sum(int(c) for c in counts)

    def sweep_step(self, now: int, chunk_rows: int,
                   ttl_slash_s: int = 0) -> Dict[str, int]:
        """One tick of the overlapped device-side epoch GC.

        Each tick enqueues an in-place chunk sweep over
        ``[cursor, cursor + chunk_rows)`` of the global slot space (on a
        mesh, each flow shard's part of it) on the streams — interleaving
        with classify steps under the same lock discipline as the classify
        dispatch — copies its reclaimed/occupancy scalars to pinned host
        memory behind an event, and *harvests the previous tick's*, which
        resolved while traffic ran. That one-tick-late read is the double
        buffer: the enqueue never waits on the device. The cursor wraps at
        the LIVE capacity (a remesh may have shrunk the table).

        ``ttl_slash_s`` (emergency GC) pushes the SWEEP clock that far into
        the future, while the occupancy count stays on the real clock.

        Returns {"reclaimed", "reclaimed_total", "live", "cursor", "epoch",
        "chunk_rows"}; ``live`` is -1 until the first harvest lands."""
        from cilium_tpu_torch.kernels.conntrack import ct_sweep_chunk
        from cilium_tpu_torch.kernels.hashing import i32, u32
        if self._gc_pending is not None:
            done, scalars = self._gc_pending
            if done is not None:
                done.synchronize()
            n, live = (int(x) & 0xFFFFFFFF for x in scalars.tolist())
            self._gc_reclaimed_total += n
            self._gc_last_live = live
            reclaimed = n
            self._gc_pending = None
        else:
            reclaimed = 0
        cap = int(self._ct_capacity)
        local = self._local_cap()
        home = self._home()
        tracer, trace_id = active_trace()
        with tracer.span(trace_id, CT_GC_SPAN,
                         cursor=self._gc_cursor, chunk=chunk_rows):
            with self._on_stream():
                with self._ct_lock:
                    parts = [ct_sweep_chunk(
                        ct, now + ttl_slash_s, self._gc_cursor, chunk_rows,
                        count_now=now, inplace=True, base=f * local,
                        total=cap)[1:] for f, ct in enumerate(self._cts)]
                pair = torch.stack([
                    i32(sum(u32(p[i].to(home)) for p in parts))
                    for i in (0, 1)])
                if self._stream is None:
                    self._gc_pending = (None, pair)
                else:
                    scalars = torch.empty((2,), dtype=torch.int32,
                                          pin_memory=True)
                    scalars.copy_(pair, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(self._stream)
                    self._gc_pending = (done, scalars)
        cursor = self._gc_cursor
        self._gc_cursor = (self._gc_cursor + chunk_rows) % cap
        if self._gc_cursor <= cursor:
            self._gc_epoch += 1            # wrapped: one full epoch swept
        return {
            "reclaimed": reclaimed,
            "reclaimed_total": self._gc_reclaimed_total,
            "live": self._gc_last_live,
            "cursor": cursor,
            "epoch": self._gc_epoch,
            "chunk_rows": chunk_rows,
        }

    def ct_stats(self, now: int) -> Dict[str, int]:
        from cilium_tpu_torch.kernels.hashing import u32
        now = int(now)
        home = self._home()
        with self._on_stream():
            with self._ct_lock:
                counts = []
                for ct in self._cts:
                    e = u32(ct["expiry"])
                    counts.append(torch.stack(
                        [(e > now).sum(), ((e > 0) & (e <= now)).sum()]
                    ).to(home))
            live, stale = sum(counts).tolist()
        return {"capacity": int(self._ct_capacity), "live": int(live),
                "stale": int(stale)}

    def _gather_ct(self) -> Dict[str, np.ndarray]:
        """The global table as uint32 numpy copies (call on the streams,
        under the CT lock)."""
        from cilium_tpu_torch.parallel.mesh import join_ct
        return join_ct(self._cts)

    def ct_arrays(self) -> Dict[str, np.ndarray]:
        """Host copy of the CT table in the checkpoint schema: uint32
        arrays (views of copies of the devices' int32 bit patterns), in
        the reference's global layout (a mesh's shards in slot-range
        order). The copy is taken on the streams under the CT lock, so it
        holds every step enqueued before it and none after — on the CPU
        too, where ``.cpu()`` alone would hand out the live table."""
        with self._on_stream():
            with self._ct_lock:
                return self._gather_ct()

    def _place_ct(self, arrays: Dict[str, np.ndarray]) -> List[Dict]:
        """A global table in the checkpoint schema → one table per flow
        shard of the active geometry, on the shards' devices (call on the
        streams)."""
        n = self.n_flow_shards
        if self._colocated:
            return CTShards({k: self._put_tensor(_u32_bits(arrays[k]))
                             for k in CT_FIELDS}, n)
        local = arrays["expiry"].shape[0] // n
        return [{k: self._put_tensor(
            _u32_bits(arrays[k][f * local:(f + 1) * local]), self._home(f))
            for k in CT_FIELDS} for f in range(n)]

    def load_ct_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        """Import a CT table in the checkpoint schema (any backend's
        export, any format this build understands): normalized, re-placed
        at this table's probe geometry (its flow shards and capacity), and
        uploaded as int32 views."""
        from cilium_tpu_torch.parallel.mesh import rehash_ct_arrays
        arrays = normalize_ct_arrays(arrays)
        arrays, dropped = rehash_ct_arrays(
            arrays, self.n_flow_shards, self.config.probe_depth,
            capacity=self._ct_capacity)
        if dropped:
            logging.getLogger("cilium_tpu_torch.datapath").warning(
                "load_ct_arrays: %d entries dropped (probe window exhausted "
                "during rehash into %d shard(s))", dropped,
                self.n_flow_shards)
        with self._on_stream():
            cts = self._place_ct(arrays)
            with self._ct_lock:
                self._cts = cts
        self._account_ct_hbm()

    # -- device loss: detection, fenced re-mesh, CT salvage, heal ---------------
    def _fire_device_fault(self) -> None:
        """The ``device.fail`` drill, fired on every sharded dispatch. A
        trip naming an ordinal that already LEFT the serving mesh is
        swallowed: the dead device cannot hurt a mesh it is no longer part
        of, which is what lets degraded serving run with the fault still
        armed (disarming the point is the drill's heal signal). Trips
        naming a live ordinal, or none, propagate into the dispatch
        failure path where :meth:`_maybe_device_lost` reclassifies
        them."""
        try:
            FAULTS.fire("device.fail")
        except BaseException as e:
            dev = dead_device_of(e)
            if dev is not None and dev >= 0 \
                    and dev not in self._live_ordinals:
                return
            raise

    def _maybe_device_lost(self, exc: BaseException) -> None:
        """Dispatch-failure triage: transient errors return untouched (the
        caller's breaker/backoff machinery owns those), while a
        dead-device signature latches the per-device health record and
        re-raises as :class:`~cilium_tpu_torch.pipeline.guard.DeviceLost`,
        the signal the pipeline parks its worker on and the engine
        re-meshes from."""
        from cilium_tpu_torch.pipeline.guard import DeviceLost
        if isinstance(exc, DeviceLost):
            raise exc
        dev = dead_device_of(exc)
        if dev is None:
            return
        self.note_device_loss(dev, reason=str(exc))
        raise DeviceLost(
            f"dead-device signature in sharded dispatch: {exc}",
            device=dev) from exc

    def note_device_loss(self, ordinal: int, reason: str = "") -> None:
        """Latch a per-device health record. The FIRST loss's evidence is
        kept (a storm of failures off one dead device must not churn the
        record); an unattributed loss (-1) records nothing — the engine's
        probe pass owns attribution then."""
        if ordinal < 0 or ordinal >= self._configured_flow_shards:
            return
        rec = self.device_health.get(ordinal)
        if rec is not None and rec.get("state") == "dead":
            return
        self.device_health[ordinal] = {
            "state": "dead", "since": time.time(),
            "reason": str(reason)[:200]}

    def note_device_healed(self, ordinal: int) -> None:
        rec = self.device_health.get(ordinal)
        if rec is not None:
            rec.update(state="live", since=time.time(), reason="")

    def _ordinal_device(self, ordinal: int):
        if self._configured_devices is None:
            return self._device
        return self._configured_devices[ordinal][0]

    def probe_device(self, ordinal: int) -> bool:
        """Heal canary for one CONFIGURED ordinal: the chaos drill first
        (an armed ``device.fail`` naming this ordinal — or none — means
        still dead), then a real host → device → host round trip of 8
        bytes to the ordinal's device. Never raises: a failed probe IS the
        answer."""
        try:
            FAULTS.fire("device.fail")
        except BaseException as e:   # noqa: BLE001 — trip text is the verdict
            dev = dead_device_of(e)
            if dev is None or dev < 0 or dev == ordinal:
                return False
        try:
            ones = torch.ones(8, dtype=torch.uint8)
            back = ones.to(self._ordinal_device(ordinal)).to("cpu")
            return bool(torch.equal(back, ones))
        except Exception:   # noqa: BLE001 — a failed probe IS the answer
            return False

    def mesh_health(self) -> Dict[str, Any]:
        """Operator-facing mesh-width surface: configured vs currently
        SERVING flow shards, which ordinals serve, the per-device health
        records, and each configured ordinal's device."""
        dead = sorted(o for o, r in self.device_health.items()
                      if r.get("state") == "dead")
        return {
            "configured": self._configured_flow_shards,
            "live": self.n_flow_shards if self._sharded else 1,
            "live_ordinals": list(self._live_ordinals),
            "dead_ordinals": dead,
            "devices": {int(k): dict(v)
                        for k, v in self.device_health.items()},
            "ordinal_devices": {
                o: str(self._ordinal_device(o))
                for o in range(self._configured_flow_shards)},
        }

    def remesh(self, live_ordinals, fence_handle=None,
               salvage_floor: Optional[Dict[str, np.ndarray]] = None
               ) -> Dict[str, Any]:
        """Shrink (or re-grow) the serving mesh to exactly the given
        CONFIGURED flow-shard ordinals, salvaging the conntrack table
        across the transition. Runs under the classify lock — the caller
        (``Engine._remesh_to``) has fenced the pipeline generation, so
        nothing dispatches concurrently; a control-plane classify holding
        the pre-remesh handle hits the ``fence_handle.dead`` flip and
        retries through ``StalePlacement``.

        CT salvage, each fallback counted in ``remesh_stats``: a gather of
        the live table (``device.collective`` is the chaos point) → the
        caller's ``salvage_floor`` archive → a cold table. After a gather
        the LOST shards' slot ranges are zeroed (``drop_ct_shard``): that
        state died with the device, even where (one card shared by the
        shards, the CPU) it could still be read. The new table's capacity
        is ``degraded_ct_capacity`` — the largest per-shard power of two
        the survivor count divides into (2^21 at 3 shards: 3 · 2^19) — and
        surviving entries rehash into it (probe-window casualties counted
        ``remesh_ct_dropped``). The caller re-places the active snapshot
        onto the new mesh afterwards."""
        if not self._sharded or self._configured_devices is None:
            raise ValueError("remesh requires a flow-sharded mesh")
        live = sorted({int(o) for o in live_ordinals})
        if not live:
            raise ValueError("remesh needs at least one surviving shard")
        bad = [o for o in live
               if not 0 <= o < self._configured_flow_shards]
        if bad:
            raise ValueError(f"remesh ordinals out of range: {bad}")
        from cilium_tpu_torch.parallel.mesh import (
            degraded_ct_capacity, drop_ct_shard, make_mesh, rehash_ct_arrays)
        n_new = len(live)
        started = time.monotonic()
        with self._on_stream(), self._ct_lock:
            old_live = list(self._live_ordinals)
            old_n = len(old_live)
            if live == old_live:
                return {"from": old_n, "to": n_new, "noop": True,
                        "live_ordinals": live}
            source = "device"
            arrays: Optional[Dict[str, np.ndarray]] = None
            try:
                FAULTS.fire("device.collective")
                arrays = self._gather_ct()
            except Exception:   # noqa: BLE001 — counted, archive/cold floor
                self.remesh_stats["remesh_gather_failures"] += 1
            lost = 0
            if arrays is not None:
                for pos, o in enumerate(old_live):
                    if o not in live:
                        lost += drop_ct_shard(arrays, pos, old_n)
            elif salvage_floor is not None:
                source = "archive"
                arrays = {k: np.array(v) for k, v in salvage_floor.items()}
            else:
                source = "cold"
                arrays = _empty_ct_np(self.config.ct_capacity)
            new_cap = degraded_ct_capacity(self.config.ct_capacity, n_new)
            arrays, dropped = rehash_ct_arrays(
                arrays, n_new, self.config.probe_depth, capacity=new_cap)
            salvaged = int((arrays["expiry"] > 0).sum())
            # survivor geometry, cached per exact ordinal set: healing back
            # onto a set that served before reuses its mesh and step
            key = tuple(live)
            cached = self._mesh_cache.get(key)
            if cached is None:
                devices = [d for o in live
                           for d in self._configured_devices[o]]
                mesh = make_mesh(n_new, self.n_rule_shards, devices=devices)
                cached = (mesh, self._mesh_classify_fn(mesh))
                self._mesh_cache[key] = cached
            self._mesh, self._classify = cached
            self.n_flow_shards = n_new
            self._live_ordinals = live
            self._ct_capacity = new_cap
            self._cts = self._place_ct(arrays)
            # restart the GC cursor in the new slot space
            self._gc_cursor = 0
            self._gc_pending = None
            self.remesh_stats["remesh_total"] += 1
            self.remesh_stats["remesh_ct_salvaged"] += salvaged
            self.remesh_stats["remesh_ct_lost"] += lost
            self.remesh_stats["remesh_ct_dropped"] += dropped
            # fence: flips atomically with the geometry swap, so a
            # control-plane classify holding the old handle can never
            # enqueue against the old mesh
            if isinstance(fence_handle, PlacedTensors):
                fence_handle.dead = True
        self._account_ct_hbm()
        return {"from": old_n, "to": n_new, "live_ordinals": live,
                "ct_capacity": new_cap, "ct_salvaged": salvaged,
                "ct_lost": lost, "ct_dropped": dropped,
                "salvage_source": source,
                "took_s": round(time.monotonic() - started, 3)}


class FakeDatapath(DatapathBackend):
    """Device-free backend for control-plane tests (pkg/datapath/fake
    analog).

    ``place`` records the snapshot + its would-be device images (numpy) in
    ``self.placed`` so tests can assert "map contents" exactly like upstream
    control-plane tests assert policymap/lbmap state. ``classify`` runs the
    semantics oracle over the same snapshot, so verdicts follow the real
    contract — a second, independent implementation behind the same
    boundary. Conntrack is the oracle's exact table; the array view is
    reconstructed on demand in the ct_layout schema."""

    PLACED_KEEP = 64                     # placement history cap (memory bound)

    def __init__(self, config: Optional[DaemonConfig] = None):
        from cilium_tpu_torch.oracle import ConntrackTable
        self.config = config or DaemonConfig()
        # [(snapshot, tensors_np)], in order; a long-lived engine with
        # auto-regen would otherwise grow this without bound — keep the most
        # recent PLACED_KEEP (tests only assert against recent placements)
        self.placed = []
        self.placed_total = 0            # placements ever (incl. evicted)
        # BOUNDED oracle table (device hash, same probe window) so the
        # fake exhibits the device's exact CT-exhaustion semantics — at the
        # configured capacity a saturating test sees the same tail
        # evictions and CT_FULL denies the jnp kernel computes, slot for
        # slot (single-device layout; the sharded mesh's per-shard tables
        # hash differently and are out of the fake's scope)
        self._ct_table = ConntrackTable(capacity=self.config.ct_capacity,
                                        probe_depth=self.config.probe_depth)
        self._oracle = None
        self._oracle_snap = None         # snapshot the cached oracle is for
        self.ct_export_truncated = 0     # entries dropped by ct_arrays()
        self._lock = threading.Lock()

    # -- helpers -------------------------------------------------------------
    def _oracle_for(self, snap: PolicySnapshot):
        """Oracle for EXACTLY ``snap`` — cached by snapshot identity, so a
        batch is always evaluated against the snapshot revision the Engine
        captured (revision fencing: a concurrent place() of a newer snapshot
        must not retarget an in-flight batch)."""
        from cilium_tpu_torch.oracle import Oracle
        if self._oracle is None or self._oracle_snap is not snap:
            # CT persists across snapshot swaps: the table, not the oracle,
            # owns connection state
            oracle = Oracle.for_snapshot(snap, ct=self._ct_table)
            self._oracle, self._oracle_snap = oracle, snap
        return self._oracle

    # -- DatapathBackend -----------------------------------------------------
    def place(self, snap: PolicySnapshot) -> Dict:
        tensors = snap.tensors()         # numpy, no device
        with self._lock:
            self.placed.append((snap, tensors))
            self.placed_total += 1
            if len(self.placed) > self.PLACED_KEEP:
                del self.placed[:-self.PLACED_KEEP]
        return tensors

    def classify(self, placed, snap, batch, now):
        FAULTS.fire("ct.insert")      # same drill point as the torch path
        with self._lock:
            oracle = self._oracle_for(snap)
            records = _records_from_batch(batch, snap.ep_ids)
            live = [p for p in records if p is not None]
            # counter baselines BEFORE the classify mutates the table
            evicted0 = self._ct_table.evicted
            fail0 = self._ct_table.insert_fail
            verdicts = iter(oracle.classify_batch_snapshot(live, now))
            n = len(records)
            out = {
                "allow": np.zeros(n, bool),
                "reason": np.zeros(n, np.int32),
                "status": np.zeros(n, np.int32),
                "ct_full": np.zeros(n, bool),
                "remote_identity": np.zeros(n, np.int32),
                "redirect": np.zeros(n, bool),
                # provenance columns (invalid rows: -1 like the device's
                # valid mask; ct_state_pre 0 == CTStatus.NEW, matching the
                # kernel's valid-masked est/reply)
                "matched_rule": np.full(n, -1, np.int32),
                "lpm_prefix": np.full(n, -1, np.int32),
                "ct_state_pre": np.zeros(n, np.int32),
                "svc": np.zeros(n, bool),
                "nat_dst": np.zeros((n, 4), np.uint32),
                "nat_dport": np.zeros(n, np.int32),
                "rnat": np.zeros(n, bool),
                "rnat_src": np.zeros((n, 4), np.uint32),
                "rnat_sport": np.zeros(n, np.int32),
            }
            counters = {"by_reason_dir": np.zeros(C.COUNTER_CELLS, np.uint32),
                        "insert_fail": np.uint32(0)}
            for i, p in enumerate(records):
                if p is None:
                    continue
                v = next(verdicts)
                out["allow"][i] = v.allow
                out["reason"][i] = v.drop_reason
                out["status"][i] = v.ct_status
                out["ct_full"][i] = v.ct_full
                out["remote_identity"][i] = v.remote_identity
                out["redirect"][i] = v.redirect
                out["matched_rule"][i] = v.matched_rule
                out["lpm_prefix"][i] = v.lpm_prefix
                out["ct_state_pre"][i] = v.ct_status
                out["svc"][i] = v.svc
                if v.nat_dst:
                    out["nat_dst"][i] = np.frombuffer(v.nat_dst, dtype=">u4")
                out["nat_dport"][i] = v.nat_dport
                out["rnat"][i] = v.rnat
                if v.rnat_src:
                    out["rnat_src"][i] = np.frombuffer(v.rnat_src, dtype=">u4")
                out["rnat_sport"][i] = v.rnat_sport
                counters["by_reason_dir"][int(v.drop_reason) * 2
                                          + p.direction] += 1
            counters["insert_fail"] = np.uint32(
                self._ct_table.insert_fail - fail0)
            counters["ct_evicted"] = np.uint32(
                self._ct_table.evicted - evicted0)
            return out, counters

    def sweep(self, now: int) -> int:
        with self._lock:
            return self._ct_table.sweep(now)

    def ct_stats(self, now: int) -> Dict[str, int]:
        with self._lock:
            live = sum(1 for e in self._ct_table.entries.values()
                       if e.expiry > now)
            return {
                "capacity": self.config.ct_capacity,
                "live": live,
                "stale": len(self._ct_table.entries) - live,
            }

    def ct_arrays(self) -> Dict[str, np.ndarray]:
        """Oracle CT → ct_layout arrays. Bounded tables (the default)
        export each entry at its REAL hash slot — the same placement the
        single-device table computes; entries without one (legacy restores)
        fall back to the old dense-from-0 layout."""
        import logging
        from cilium_tpu_torch.kernels.records import ct_key_words_np
        cap = self.config.ct_capacity
        arrays = _empty_ct_np(cap)
        with self._lock:
            items = list(self._ct_table.entries.items())
            overflow = len(items) - cap
            if overflow > 0:
                # a bounded table can never overflow; an unbounded legacy
                # dict can — never lose flows silently, and when forced
                # to, drop the soonest-to-expire (deterministic)
                self.ct_export_truncated += overflow
                logging.getLogger("cilium_tpu_torch.datapath").warning(
                    "FakeDatapath.ct_arrays: %d CT entries exceed "
                    "ct_capacity=%d; dropping the soonest-expiring from "
                    "the export", overflow, cap)
                items.sort(key=lambda kv: kv[1].expiry, reverse=True)
                items = items[:cap]
        hash_slots = all(0 <= e.slot < cap for _k, e in items)
        for dense, (key, e) in enumerate(items):
            slot = e.slot if hash_slots else dense
            src, dst, sport, dport, proto, d = key
            one = {
                "src": np.frombuffer(src, dtype=">u4").reshape(1, 4),
                "dst": np.frombuffer(dst, dtype=">u4").reshape(1, 4),
                "sport": np.array([sport]), "dport": np.array([dport]),
                "proto": np.array([proto]), "direction": np.array([d]),
            }
            arrays["keys"][slot] = ct_key_words_np(one)[0]
            arrays["expiry"][slot] = e.expiry
            arrays["created"][slot] = e.created
            arrays["flags"][slot] = e.flags
            arrays["pkts_fwd"][slot] = e.pkts_fwd
            arrays["pkts_rev"][slot] = e.pkts_rev
            arrays["rev_nat"][slot] = e.rev_nat
        return arrays

    def load_ct_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        """ct_layout arrays → oracle CT entries (inverse of ct_arrays).
        Entries re-place into this table's hash layout (the imported
        arrays may come from a different shard count or a dense legacy
        export); entries whose probe window is already full drop with a
        warning — the same contract as the torch backend's rehash."""
        import logging
        from cilium_tpu_torch.oracle import ConntrackTable, CTEntry
        from cilium_tpu_torch.utils.ip import words_to_addr
        arrays = normalize_ct_arrays(arrays)   # validate BEFORE clearing
        cap = self.config.ct_capacity
        pd = self.config.probe_depth
        with self._lock:
            table = ConntrackTable(capacity=cap, probe_depth=pd)
            expiry = arrays["expiry"]
            loaded = []
            for slot in np.nonzero(expiry > 0)[0]:
                w = arrays["keys"][slot]
                key = (words_to_addr(w[0:4]), words_to_addr(w[4:8]),
                       int(w[8]) >> 16, int(w[8]) & 0xFFFF,
                       int(w[9]) >> 8, int(w[9]) & 0xFF)
                loaded.append((key, CTEntry(
                    expiry=int(expiry[slot]),
                    created=int(arrays["created"][slot]),
                    flags=int(arrays["flags"][slot]),
                    pkts_fwd=int(arrays["pkts_fwd"][slot]),
                    pkts_rev=int(arrays["pkts_rev"][slot]),
                    rev_nat=int(arrays["rev_nat"][slot]))))
            dropped = 0
            if loaded:
                bases = table.base_slots([k for k, _e in loaded])
                for (key, entry), base in zip(loaded, bases):
                    placed = False
                    for r in range(pd):
                        s = (int(base) + r) % cap
                        if table._slots[s] is None:     # noqa: SLF001
                            table.install(key, entry, s)
                            placed = True
                            break
                    if not placed:
                        dropped += 1
            self._ct_table = table
            # the cached oracle closed over the old table object
            self._oracle = None
            self._oracle_snap = None
            if dropped:
                logging.getLogger("cilium_tpu_torch.datapath").warning(
                    "FakeDatapath.load_ct_arrays: %d entries dropped "
                    "(probe window exhausted during re-place)", dropped)
