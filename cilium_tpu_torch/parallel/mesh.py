"""The flow- and rule-sharded mesh (port of
``cilium_tpu/parallel/mesh.py``).

- **The mesh** is a ``[n_flow, n_rule]`` grid of ``torch.device``s in ONE
  process (``make_mesh``), as the reference's is one controller driving a
  ``shard_map`` over a device grid. Where every flow shard shares one
  device and there is no rule axis (``TorchMesh.colocated``), the
  host-steered step is one step over all shards; elsewhere each flow
  shard runs its own step from a host loop. Collectives are explicit
  tensor moves and sums. The
  grid may hold one device more than once (``cpu`` in the tests, one
  card shared by several shards): the port's counterpart of XLA's
  virtual host devices. On a node with several cards shard i lands on
  ``cuda:(i mod count)`` and each hop is a peer copy.
- **Flow axis** (the RSS analog): batches and the CT split across flow
  shards, each shard owning an independent power-of-two CT table. With
  ``rss_mode="host"`` the host steers rows by the direction-normalized
  flow hash (``steer_batch``) so both directions of a flow reach the
  owning shard; with ``rss_mode="device"`` rows arrive in FIFO order and
  the ring exchange of ``parallel/exchange.py`` routes CT work to its
  owner (``make_unsteered_classify_fn``).
- **Rule axis**: the verdict image's id-class rows split across rule
  shards (``pad_snapshot_tensors``), and the cells of a lookup are summed
  (``kernels/policy.RuleAxis``). The counters are summed over the flow
  axis only.

Every flow shard's step runs on the device of its rule shard 0, which
holds its CT shard; the other devices of its row hold only their verdict
rows. The numpy helpers (steering, CT geometry, ``rehash_ct_arrays``)
serve the engine, the pipeline and the checkpoint boundary.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from cilium_tpu_torch.compile.ct_layout import PROBE_DEPTH
from cilium_tpu_torch.kernels.hashing import hash_words_np
from cilium_tpu_torch.kernels.records import BatchArrays, ct_key_words_np

# --------------------------------------------------------------------------- #
# Host-side steering (the RSS analog; the C++ shim implements the same hash)
# --------------------------------------------------------------------------- #
def flow_shard_of(batch: BatchArrays, n_shards: int,
                  lb=None) -> np.ndarray:
    """Direction-normalized shard index per packet: XOR of forward and
    reverse key hashes is symmetric, so both directions of a flow agree.

    ``lb`` (a compiled compile/lb.LBTables) translates service VIPs first —
    CT entries live under the DNAT'ed tuple, so steering must hash the
    translated tuple or a service flow's forward and reply packets would
    land on different CT shards. The C++ shim runs the same translation."""
    if lb is not None and lb.n_frontends:
        from cilium_tpu_torch.compile.lb import lb_translate_np
        new_dst, new_dport, _rnat, _nb, _fe = lb_translate_np(lb, batch)
        batch = dict(batch)
        batch["dst"] = new_dst
        batch["dport"] = new_dport
    h = hash_words_np(ct_key_words_np(batch, reverse=False)) \
        ^ hash_words_np(ct_key_words_np(batch, reverse=True))
    return (h % np.uint32(n_shards)).astype(np.int32)


def steer_rows(shard: np.ndarray, n_shards: int, seg_cap: int,
               fills: Optional[np.ndarray] = None,
               counts: Optional[np.ndarray] = None) -> np.ndarray:
    """Destination row per packet for a segmented steered layout: packet i
    (shard ``shard[i]``) lands at ``shard[i]*seg_cap + fill + rank`` where
    ``rank`` preserves arrival order within the shard (stable sort) and
    ``fills`` are the segments' current occupancies (all-zero when absent).
    This is the scatter half of ``steer_batch``, shared with the pipeline's
    staging ring so flush-time steering is the same placement the classic
    steer produces. The caller checks capacity (``fills + counts`` must stay
    within ``seg_cap``); ``counts`` passes an already-computed
    ``bincount(shard, minlength=n_shards)`` so hot callers don't pay the
    histogram twice."""
    m = shard.shape[0]
    order = np.argsort(shard, kind="stable")
    sorted_s = shard[order]
    if counts is None:
        counts = np.bincount(shard, minlength=n_shards)
    counts = counts.astype(np.int64)
    starts = np.zeros(n_shards + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    rank = np.arange(m, dtype=np.int64) - starts[sorted_s]
    base = sorted_s * seg_cap + rank
    if fills is not None:
        base += np.asarray(fills, dtype=np.int64)[sorted_s]
    rows = np.empty(m, dtype=np.int64)
    rows[order] = base
    return rows


def steer_batch(batch: BatchArrays, n_shards: int,
                per_shard: Optional[int] = None, lb=None,
                round_to_pow2: bool = False,
                out: Optional[BatchArrays] = None
                ) -> Tuple[BatchArrays, np.ndarray, int]:
    """Regroup a batch so packets of shard s occupy rows
    [s*per_shard, (s+1)*per_shard) (invalid-padded).

    Returns (steered_batch, scatter_index, per_shard) where
    ``scatter_index[i]`` is the steered row of original packet i — use it to
    gather per-packet outputs back into original order.

    ``out=`` scatters into a caller-owned column dict (a reusable steered
    buffer) instead of allocating; its rows must cover
    ``n_shards * per_shard`` and every batch key must be present. Rows not
    written are restored to the empty-batch defaults, so a reused buffer
    cannot leak a previous batch's records into the valid mask or the
    wire-format probes. (The pipeline's staging ring does NOT come through
    here — it scatters incrementally at ingest via ``steer_rows``; this
    variant serves whole-batch callers that want to reuse one steered
    buffer across calls.)

    Fully vectorized (argsort regroup) — this is the host half of the
    production multi-chip path, so it must keep up with the device, not just
    the dryrun (a per-packet Python loop caps steering far below the
    device's rate)."""
    from cilium_tpu_torch.kernels.records import reset_batch_rows
    n = batch["valid"].shape[0]
    shard = flow_shard_of(batch, n_shards, lb=lb)
    validm = np.asarray(batch["valid"], dtype=bool)
    vidx = np.nonzero(validm)[0]
    s = shard[vidx]
    counts = np.bincount(s, minlength=n_shards).astype(np.int64)
    if per_shard is None:
        per_shard = int(max(1, counts.max()))
        if round_to_pow2:
            # stabilize the steered shape across batches (each distinct
            # n_shards*per_shard is a new dispatch shape): round up to a
            # power of 2
            per_shard = 1 << (per_shard - 1).bit_length()
    elif counts.max() > per_shard:
        raise ValueError("per_shard too small for steering")
    rows = steer_rows(s, n_shards, per_shard, counts=counts)
    src = vidx
    total = n_shards * per_shard
    if out is None:
        out = {k: np.zeros((total,) + v.shape[1:], dtype=v.dtype)
               for k, v in batch.items()}
        out["http_method"][:] = 255
    else:
        if out["valid"].shape[0] < total:
            raise ValueError(
                f"steer out= buffer has {out['valid'].shape[0]} rows, "
                f"need {total}")
        reset_batch_rows(out, 0, total)
    scatter = np.full((n,), -1, dtype=np.int64)
    scatter[src] = rows
    for k, v in batch.items():
        out[k][rows] = np.asarray(v)[src]
    return out, scatter, per_shard


def unsteer_outputs(out: Dict[str, np.ndarray],
                    scatter: np.ndarray) -> Dict[str, np.ndarray]:
    """Map steered per-packet outputs back to original packet order.
    Packets that were invalid get zeros."""
    n = scatter.shape[0]
    result = {}
    safe = np.where(scatter >= 0, scatter, 0)
    for k, v in out.items():
        gathered = np.asarray(v)[safe]
        gathered[scatter < 0] = 0
        result[k] = gathered
    return result


# --------------------------------------------------------------------------- #
# Array preparation for the mesh
# --------------------------------------------------------------------------- #
def pad_snapshot_tensors(tensors: Dict[str, np.ndarray],
                         n_rule_shards: int) -> Dict[str, np.ndarray]:
    """Pad verdict id-class rows to a multiple of the rules axis. Padded rows
    are all-MISS (never gathered: id_class_of never points at them)."""
    if n_rule_shards <= 1:
        return tensors
    v = tensors["verdict"]
    rows = v.shape[2]
    padded = -(-rows // n_rule_shards) * n_rule_shards
    if padded != rows:
        pad = np.zeros((v.shape[0], v.shape[1], padded - rows, v.shape[3]),
                       dtype=v.dtype)
        tensors = dict(tensors)
        tensors["verdict"] = np.concatenate([v, pad], axis=2)
    return tensors


def local_ct_capacity(capacity: int, n_flow_shards: int) -> int:
    """The slots of each flow shard's table; raises unless ``capacity``
    splits into ``n_flow_shards`` power-of-two tables."""
    local = capacity // n_flow_shards
    if local * n_flow_shards != capacity or (local & (local - 1)):
        raise ValueError(
            f"CT capacity {capacity} must split into {n_flow_shards} "
            f"power-of-two shards")
    return local


def shard_ct_arrays(ct: Dict[str, np.ndarray],
                    n_flow_shards: int) -> Dict[str, np.ndarray]:
    """Validate the CT capacity divides into power-of-two local tables."""
    local_ct_capacity(ct["expiry"].shape[0], n_flow_shards)
    return ct


def degraded_ct_capacity(capacity: int, n_flow_shards: int) -> int:
    """The largest CT capacity <= ``capacity`` that still splits into
    ``n_flow_shards`` power-of-two local tables — the table geometry a
    remesh onto a NON-power-of-two survivor count rehashes into (e.g.
    4096 slots at 3 shards → 1024·3 = 3072). Healing back to a
    power-of-two width recovers the full configured capacity."""
    local = capacity // n_flow_shards
    if local < 1:
        raise ValueError(
            f"CT capacity {capacity} cannot split across "
            f"{n_flow_shards} shards")
    local = 1 << (local.bit_length() - 1)
    return local * n_flow_shards


def drop_ct_shard(arrays: Dict[str, np.ndarray], shard: int,
                  n_shards: int) -> int:
    """Zero one flow shard's slot range ``[shard*local, (shard+1)*local)``
    of a host-gathered CT table, in place. The honest-loss step of remesh
    salvage: on the CPU smoke rig a "killed" virtual device's shard is
    still physically gatherable, so salvage deliberately drops it — the
    lost shard's flows must cold-learn under the established-fingerprint
    grace window exactly as they would on real hardware. Returns the
    number of live entries dropped."""
    cap = arrays["expiry"].shape[0]
    local = cap // n_shards
    lo, hi = shard * local, (shard + 1) * local
    n_live = int((arrays["expiry"][lo:hi] > 0).sum())
    for k, v in arrays.items():
        v[lo:hi] = 0
    return n_live


def _reverse_key_words(keys: np.ndarray) -> np.ndarray:
    """[M,10] forward CT key words → reverse orientation (addr/port swap,
    direction flip) — the host inverse of records.ct_key_words_np(reverse)."""
    rev = keys.copy()
    rev[:, 0:4] = keys[:, 4:8]
    rev[:, 4:8] = keys[:, 0:4]
    rev[:, 8] = ((keys[:, 8] << np.uint32(16))
                 | (keys[:, 8] >> np.uint32(16)))
    rev[:, 9] = ((keys[:, 9] & np.uint32(0xFFFFFF00))
                 | (np.uint32(1) - (keys[:, 9] & np.uint32(0xFF))))
    return rev


def rehash_ct_arrays(arrays: Dict[str, np.ndarray], n_flow_shards: int,
                     probe_depth: int = PROBE_DEPTH,
                     capacity: Optional[int] = None
                     ) -> Tuple[Dict[str, np.ndarray], int]:
    """Re-place every live CT entry at the open-addressed position the device
    probe expects for the given shard layout (shard = direction-normalized
    hash, local slot = key hash mod the per-shard table, linear probe).

    Checkpoint portability: an exported table's slot placement is only valid
    for the geometry that wrote it (the bounded oracle-backed fake and a
    single-chip table hash over the FULL capacity; a sharded table hashes
    per shard — and legacy fake exports were dense-from-0). Rehashing on
    import makes restore correct across backends and shard counts. Returns
    (new_arrays, n_dropped) — entries whose probe window is exhausted are
    dropped (counted; a restore-time drop means the flow re-learns as NEW
    on its next packet — unlike a live insert exhaustion, which since the
    insert-when-full contract fails CLOSED with DROP ``CT_FULL``).
    ``capacity`` resizes the table while rehashing (checkpoint restored into
    a backend configured with a different ct_capacity).
    """
    cap = int(capacity or arrays["expiry"].shape[0])
    local = cap // n_flow_shards
    if local * n_flow_shards != cap or (local & (local - 1)):
        raise ValueError(
            f"CT capacity {cap} must split into {n_flow_shards} "
            f"power-of-two shards")
    live = np.nonzero(arrays["expiry"] > 0)[0]
    m = live.shape[0]
    keys = arrays["keys"][live].astype(np.uint32)
    fwd_h = hash_words_np(keys)
    shard = ((fwd_h ^ hash_words_np(_reverse_key_words(keys)))
             % np.uint32(n_flow_shards)).astype(np.int64)
    home = (fwd_h & np.uint32(local - 1)).astype(np.int64)
    base = shard * local

    new = {k: np.zeros((cap,) + v.shape[1:], dtype=v.dtype)
           for k, v in arrays.items()}
    occupied = np.zeros(cap, dtype=bool)
    placed_slot = np.full(m, -1, dtype=np.int64)
    pending = np.ones(m, dtype=bool)
    idx = np.arange(m, dtype=np.int64)
    for r in range(probe_depth):
        t = base + ((home + r) & (local - 1))
        attempt = pending & ~occupied[t]
        claim = np.full(cap + 1, m, dtype=np.int64)
        np.minimum.at(claim, np.where(attempt, t, cap), idx)
        winner = attempt & (claim[t] == idx)
        occupied[t[winner]] = True
        placed_slot[winner] = t[winner]
        pending = pending & ~winner
    ok = placed_slot >= 0
    src, dst = live[ok], placed_slot[ok]
    for k in arrays:
        new[k][dst] = arrays[k][src]
    return new, int(pending.sum())


# --------------------------------------------------------------------------- #
# The mesh: a grid of devices in one process
# --------------------------------------------------------------------------- #
class TorchMesh:
    """A ``[n_flow, n_rule]`` grid of ``torch.device``s. ``shape`` carries
    the reference's axis sizes (``shape["flows"]``, ``shape["rules"]``);
    a device may appear more than once."""

    def __init__(self, devices):
        import torch
        self.devices = [[torch.device(d) for d in row] for row in devices]
        self.shape = {"flows": len(self.devices),
                      "rules": len(self.devices[0])}

    def device_of(self, flow: int, rule: int = 0):
        return self.devices[flow][rule]

    @property
    def colocated(self) -> bool:
        """Every flow shard on one device and no rule axis: the geometry
        whose steered step runs as one step over all shards (the CPU
        mesh, one card)."""
        return self.shape["rules"] == 1 and all(
            row[0] == self.devices[0][0] for row in self.devices)

    @property
    def distinct_devices(self) -> List[Any]:
        """Each device of the grid once, in grid order."""
        seen: List[Any] = []
        for row in self.devices:
            for d in row:
                if d not in seen:
                    seen.append(d)
        return seen


def make_mesh(n_flow_shards: int, n_rule_shards: int = 1, devices=None,
              device: str = "cuda") -> TorchMesh:
    """The ``[n_flow_shards, n_rule_shards]`` grid over ``devices`` (row
    major). Without ``devices``: shard i on ``cuda:(i mod count)`` of the
    visible cards for ``device="cuda"`` (no card raises), or ``cpu``
    repeated for ``device="cpu"``."""
    import torch
    need = n_flow_shards * n_rule_shards
    if devices is None:
        kind = torch.device(device).type
        if kind == "cuda":
            count = torch.cuda.device_count()
            if count < 1:
                raise RuntimeError("make_mesh: no CUDA device is available")
            devices = [torch.device("cuda", i % count) for i in range(need)]
        else:
            devices = [torch.device(kind)] * need
    devices = list(devices)
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return TorchMesh([devices[f * n_rule_shards:(f + 1) * n_rule_shards]
                      for f in range(n_flow_shards)])


# --------------------------------------------------------------------------- #
# Placing a snapshot, the CT and a batch on the mesh
# --------------------------------------------------------------------------- #
def verdict_slice_name(rule: int) -> str:
    """Key of rule shard ``rule``'s verdict rows on a rule-sharded mesh."""
    return f"verdict.{rule}"


def mesh_placement(tensors: Dict[str, np.ndarray], mesh: TorchMesh
                   ) -> Dict[Any, Dict[str, np.ndarray]]:
    """The host arrays each DISTINCT device of ``mesh`` holds: every
    tensor once per device; on a rule-sharded mesh the padded verdict's
    id-class rows split into ``shape["rules"]`` slices
    (``verdict_slice_name``), each on the devices that serve that rule
    shard."""
    n_rule = mesh.shape["rules"]
    out: Dict[Any, Dict[str, np.ndarray]] = {}
    if n_rule == 1:
        for d in mesh.distinct_devices:
            out[d] = dict(tensors)
        return out
    rest = {k: a for k, a in tensors.items() if k != "verdict"}
    for d in mesh.distinct_devices:
        out[d] = dict(rest)
    if "verdict" not in tensors:
        return out
    v = pad_snapshot_tensors(tensors, n_rule)["verdict"]
    rows = v.shape[2] // n_rule
    for row in mesh.devices:
        for r, d in enumerate(row):
            out[d][verdict_slice_name(r)] = v[:, :, r * rows:(r + 1) * rows]
    return out


def place_mesh_tensors(tensors: Dict[str, np.ndarray], mesh: TorchMesh,
                       put: Optional[Callable] = None) -> Dict[Any, Dict]:
    """Place a snapshot's tensors on ``mesh`` (``mesh_placement``); ``put``
    (``(array, device) → tensor``, default a copy in the port's dtype)
    moves each array."""
    import torch
    from cilium_tpu_torch.convert import port_dtype
    if put is None:
        def put(a, dev):
            return torch.tensor(port_dtype(np.asarray(a)), device=dev)
    return {d: {k: put(a, d) for k, a in arrs.items()}
            for d, arrs in mesh_placement(tensors, mesh).items()}


def shard_views(placed: Dict[Any, Dict], mesh: TorchMesh):
    """Per flow shard, the tensors its step reads on the device of its
    rule shard 0, and its ``RuleAxis`` (None on a flow-only mesh).
    → (views, rule_axes), one of each per flow shard."""
    from cilium_tpu_torch.kernels.policy import RuleAxis
    n_rule = mesh.shape["rules"]
    views, axes = [], []
    for f in range(mesh.shape["flows"]):
        own = placed[mesh.device_of(f)]
        if n_rule == 1:
            views.append(own)
            axes.append(None)
            continue
        views.append({k: v for k, v in own.items()
                      if not k.startswith("verdict.")})
        axes.append(RuleAxis([
            placed[mesh.device_of(f, r)][verdict_slice_name(r)]
            for r in range(n_rule)]))
    return views, axes


class CTShards(list):
    """The CT of a co-located mesh: one table per flow shard, each a view
    of its slot range of ``table``, the shard-major table the step
    reads and writes whole."""

    def __init__(self, table: Dict[str, Any], n: int):
        local = table["expiry"].shape[0] // n
        super().__init__({k: v[f * local:(f + 1) * local]
                          for k, v in table.items()} for f in range(n))
        self.table = table


def split_ct(ct: Dict[str, np.ndarray], mesh: TorchMesh
             ) -> List[Dict[str, Any]]:
    """A global CT table (uint32 numpy, shard-major slot ranges) → one
    int32 table per flow shard, on the shard's device (on a co-located
    mesh, views of one table: :class:`CTShards`). The capacity must split
    into power-of-two shards."""
    import torch
    from cilium_tpu_torch.convert import port_dtype
    n = mesh.shape["flows"]
    local = local_ct_capacity(ct["expiry"].shape[0], n)
    if mesh.colocated:
        return CTShards({k: torch.tensor(port_dtype(v),
                                         device=mesh.device_of(0))
                         for k, v in ct.items()}, n)
    return [{k: torch.tensor(port_dtype(v[f * local:(f + 1) * local]),
                             device=mesh.device_of(f))
             for k, v in ct.items()} for f in range(n)]


def join_ct(cts: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Per-shard CT tables → the global table as uint32 numpy (shard-major
    slot ranges, the reference's layout), copied."""
    return {k: np.concatenate([c[k].to("cpu", copy=True).numpy()
                               for c in cts]).view(np.uint32)
            for k in cts[0]}


class ShardedBatch(tuple):
    """A batch already split into one packed wire (or wire tuple) per flow
    shard, each on its shard's device."""


def split_batch(batch, mesh: TorchMesh) -> List[Dict[str, Any]]:
    """Any batch form → one unpacked batch dict per flow shard, on the
    shard's device: a column dict (numpy), a packed wire, a
    ``(wire, dict...)`` tuple (the wire's rows split, the dictionaries
    replicated), or a :class:`ShardedBatch`. The rows must divide the
    flow axis."""
    from cilium_tpu_torch.kernels.records import (batch_to_torch,
                                                  unpack_wire,
                                                  wire_to_torch)
    n = mesh.shape["flows"]
    devs = [mesh.device_of(f) for f in range(n)]
    if isinstance(batch, ShardedBatch):
        return [unpack_wire(w) for w in batch]
    if isinstance(batch, dict):
        rows = batch["valid"].shape[0]
        per = _per_shard(rows, n)
        return [batch_to_torch({k: v[f * per:(f + 1) * per]
                                for k, v in batch.items()}, dev)
                for f, dev in enumerate(devs)]
    parts = tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)
    per = _per_shard(parts[0].shape[0], n)
    out = []
    for f, dev in enumerate(devs):
        wire = wire_to_torch(parts[0][f * per:(f + 1) * per], dev)
        rest = tuple(wire_to_torch(d, dev) for d in parts[1:])
        out.append(unpack_wire((wire,) + rest if rest else wire))
    return out


def whole_batch(batch, mesh: TorchMesh) -> Dict[str, Any]:
    """A column dict (numpy), a packed wire or a ``(wire, dict...)``
    tuple → one unpacked batch dict of all its rows on a co-located
    mesh's device. The rows must divide the flow axis."""
    from cilium_tpu_torch.kernels.records import unpack_wire_parts
    whole = _whole_parts(batch, mesh)
    return unpack_wire_parts(whole) if isinstance(whole, list) else whole


def _whole_parts(batch, mesh: TorchMesh):
    """``whole_batch`` before the unpack: a column dict as a batch dict of
    tensors, a wire as the list of its tensors (``records.wire_parts``),
    on the mesh's first device."""
    from cilium_tpu_torch.kernels.records import batch_to_torch, wire_to_torch
    n = mesh.shape["flows"]
    dev = mesh.device_of(0)
    if isinstance(batch, dict):
        _per_shard(batch["valid"].shape[0], n)
        return batch_to_torch(batch, dev)
    parts = tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)
    _per_shard(parts[0].shape[0], n)
    return [wire_to_torch(p, dev) for p in parts]


def _per_shard(rows: int, n: int) -> int:
    if rows % n:
        raise ValueError(f"batch rows ({rows}) must divide into {n} flow "
                         f"shards")
    return rows // n


def sum_counters(counters: List[Dict[str, Any]], device) -> Dict[str, Any]:
    """Per-shard counters (u32 values as int32 bit patterns) → their sums
    over the flow axis on ``device``, wrapping as u32 sums do."""
    from cilium_tpu_torch.kernels.hashing import i32, u32
    return {k: i32(sum(u32(c[k].to(device)) for c in counters))
            for k in counters[0]}


# --------------------------------------------------------------------------- #
# The meshed classify step
# --------------------------------------------------------------------------- #
def make_sharded_classify_fn(mesh: TorchMesh, probe_depth: int = PROBE_DEPTH,
                             v4_only: bool = False, donate_ct: bool = True,
                             fused: bool = True):
    """The host-steered classify step over ``mesh``. Call with ``(placed,
    cts, batch, now, world_index)``: ``placed`` from
    ``place_mesh_tensors``, ``cts`` from ``split_ct`` (updated in place
    with ``donate_ct``), ``batch`` steered (``steer_batch``) in any form
    ``split_batch`` takes. → (out on the mesh's first device with the rows
    in batch order, cts, counters summed over the flow axis).

    On a co-located mesh (``TorchMesh.colocated``) it is ONE call of the
    scripted ``kernels/classify.classify_step`` over all rows with
    ``shards`` = the flow axis: the stateless stages run once (with
    ``fused``, K1 and K3 launch once a dispatch), the probe pair once per
    shard (K2, or the plain probe once over the shard-major table), the CT
    update once over the shard-major table. Elsewhere each flow shard runs
    its own scripted step on its own segment of the rows and its own CT
    shard (with ``fused``, K1, K2 and, on a flow-only mesh, K3 launch once
    per shard). Both are the reference's steered step bit for bit."""
    from cilium_tpu_torch.kernels.classify import classify_step, run_scripted
    if mesh.colocated:
        return _make_colocated_classify(mesh, probe_depth, v4_only,
                                        donate_ct, fused)

    def step(views, axes, cts, batches, now, world_index):
        res = [run_scripted(classify_step, views[f], cts[f], batches[f],
                            int(now), int(world_index),
                            probe_depth=probe_depth, v4_only=v4_only,
                            rule_axis=axes[f], fused=fused,
                            inplace=donate_ct)
               for f in range(len(batches))]
        return tuple(list(col) for col in zip(*res))

    return _make_meshed_classify(mesh, step)


def make_unsteered_classify_fn(mesh: TorchMesh,
                               probe_depth: int = PROBE_DEPTH,
                               v4_only: bool = False, donate_ct: bool = True,
                               fused: bool = True):
    """The device-RSS classify step over ``mesh``: rows split over the
    flow shards in plain arrival order, and CT lookups and inserts resolve
    through the ring exchange (``parallel/exchange.classify_step_exchange``;
    K1 and K2 launch once per shard, the policy stage runs the split plain
    core). Outputs come back in arrival order, bit-identical to what the
    steered path computes for the same rows. Same call as
    :func:`make_sharded_classify_fn`; the rows must divide the flow
    axis."""
    from cilium_tpu_torch.parallel.exchange import classify_step_exchange

    def step(views, axes, cts, batches, now, world_index):
        return classify_step_exchange(
            views, cts, batches, now, world_index, rule_axes=axes,
            probe_depth=probe_depth, v4_only=v4_only, fused=fused,
            inplace=donate_ct)

    return _make_meshed_classify(mesh, step)


def _make_colocated_classify(mesh: TorchMesh, probe_depth: int,
                             v4_only: bool, donate_ct: bool, fused: bool):
    """The steered step of a co-located mesh (see
    :func:`make_sharded_classify_fn`); ``cts`` is a :class:`CTShards`.
    A wire is unpacked inside the scripted call."""
    from cilium_tpu_torch.kernels.classify import (classify_step,
                                                   classify_wire_step,
                                                   run_scripted)
    dev = mesh.device_of(0)
    n = mesh.shape["flows"]

    def call(placed, cts, batch, now, world_index):
        whole = _whole_parts(batch, mesh)
        step = classify_wire_step if isinstance(whole, list) \
            else classify_step
        out, table, counters = run_scripted(
            step, placed[dev], cts.table, whole, int(now), int(world_index),
            probe_depth=probe_depth, v4_only=v4_only, fused=fused,
            inplace=donate_ct, shards=n)
        return out, (cts if donate_ct else CTShards(table, n)), counters

    return call


def _make_meshed_classify(mesh: TorchMesh, step):
    """The shared plumbing of both meshed steps: the per-shard views of
    the placement, the batch split, and the gather of outputs and counter
    sums on the mesh's first device."""
    import torch
    dev0 = mesh.device_of(0)

    def call(placed, cts, batch, now, world_index):
        views, axes = shard_views(placed, mesh)
        outs, new_cts, counters = step(views, axes, cts,
                                       split_batch(batch, mesh), now,
                                       world_index)
        out = {k: torch.cat([o[k].to(dev0) for o in outs])
               for k in outs[0]}
        return out, new_cts, sum_counters(counters, dev0)

    return call
