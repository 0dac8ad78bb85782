"""The three fused classify-interior kernels as CUDA C++ for Hopper (port of
``cilium_tpu/kernels/fused.py``; sources in ``cilium_tpu_torch/csrc/``).

- ``lpm_lookup_fused`` (K1, ``csrc/lpm_lookup.cu``): both families' stride
  walks in one loop, over the tables ``lpm_derived`` derives from each
  trie on the card and caches; a v4-only launch walks the v4 trie's own
  planes.
- ``ct_probe_pair_fused`` (K2, ``csrc/ct_probe_pair.cu``): the forward and
  reverse CT probes in one launch (``ct_probe_pair_sharded``: one launch
  per table of a co-located mesh's shard-major CT).
- ``policy_verdict_fused`` (K3, ``csrc/policy_verdict.cu``): policy ladder,
  L7 token match and verdict composition in one launch.
- ``flow_fingerprint_fused`` (``csrc/flow_fingerprint.cu``): each row's
  direction-normalized flow fingerprint, which the engine's CT-salvage
  note stamps; no TPU kernel (the reference hashes on the host).

Each wrapper takes the reference's arguments (without ``interpret``). On
CUDA tensors it checks device, dtype, shape and contiguity, launches its
kernel on the current stream, raises if the launch is refused, and adds
one to its entry of ``LAUNCHES``; on CPU tensors it runs the kernel's plain
torch version (``*_plain`` below), which is also what the tests and
``chip_smoke.py`` hold the kernel against. The kernels read every table
from global memory, so unlike the TPU kernels (whose tables had to fit a
VMEM budget) they run at every geometry: there is no residency gate.

The scripted classify step (``kernels/classify.py``) calls each wrapper as
a Python function (``torch.jit.ignore``): the launch happens between the
scripted step's torch ops, and the wrappers' annotations are its
signature for them (hence no postponed annotations in this module).
"""

import weakref
from typing import Dict, Optional, Tuple

import torch

from cilium_tpu_torch.kernels import _build
from cilium_tpu_torch.kernels.conntrack import (_now, ct_home_pair,
                                                ct_probe_core)
from cilium_tpu_torch.kernels.hashing import hash_words_u64, i32
from cilium_tpu_torch.kernels.lpm import (LpmDerived, lpm_derive,
                                          lpm_walk_prov_core)
from cilium_tpu_torch.kernels.records import ct_key_words

#: launches of each CUDA kernel since the last ``reset_launches``
LAUNCHES = {"lpm_lookup_fused": 0, "ct_probe_pair_fused": 0,
            "policy_verdict_fused": 0, "flow_fingerprint_fused": 0}

#: the snapshot tensors the verdict kernel reads
POLICY_TENSOR_KEYS = ("id_class_of", "proto_family", "port_class",
                      "verdict", "enforced", "l7_methods", "l7_valid",
                      "l7_path_len", "l7_path")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _ptr(t, dtypes, shape=None, name="tensor", device=None, align=4):
    """Validate one kernel argument and return its device pointer."""
    if t is None:
        return None
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a tensor on {device or 'cuda'}, "
                         f"got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name}: must be contiguous and {align}-byte "
                         f"aligned")
    return t.data_ptr()


_I32 = (torch.int32,)
_BOOL8 = (torch.bool, torch.uint8)


def _launch(lib: str, kernel: str, device, *args) -> None:
    """Call ``lib``'s C entry point on ``device``'s current stream; raise
    if the launch was refused."""
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _build.launcher(lib)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed (cudaError {rc})")
    LAUNCHES[kernel] += 1


# --------------------------------------------------------------------------- #
# K1: LPM stride walk
# --------------------------------------------------------------------------- #
def lpm_lookup_plain(lpm_v4: torch.Tensor, lpm_v6: Optional[torch.Tensor],
                     addr_words: torch.Tensor, is_v6: Optional[torch.Tensor],
                     default_index: int, v4_only: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K1 (kernels/lpm.lpm_walk_prov_core)."""
    return lpm_walk_prov_core(lpm_v4, lpm_v6, addr_words, is_v6,
                              default_index, v4_only=v4_only)


#: (data_ptr, shape) of a trie → (weak reference to it, its ``_version``
#: when derived, the derived tables, their (cells, runs) pointers). No
#: device in the key: a device's pointers are unique in the process, and
#: a hit must be this very tensor.
_DERIVED: Dict[tuple, Tuple[weakref.ref, int, LpmDerived, tuple]] = {}


def _cached(nodes: torch.Tensor):
    """``nodes``'s cache entry if it is current, else None."""
    hit = _DERIVED.get((nodes.data_ptr(), nodes.shape))
    if hit is not None and hit[0]() is nodes and hit[1] == nodes._version:
        return hit
    return None


def _derive(nodes: torch.Tensor):
    """Build and cache the derived tables of ``nodes``; → its entry."""
    key = (nodes.data_ptr(), nodes.shape)

    def drop(ref, key=key):
        if _DERIVED.get(key, (None,))[0] is ref:
            del _DERIVED[key]
    d = lpm_derive(nodes)
    entry = (weakref.ref(nodes, drop), nodes._version, d,
             (d.cells.data_ptr(), d.runs.data_ptr()))
    _DERIVED[key] = entry
    return entry


def lpm_derived(nodes: torch.Tensor) -> LpmDerived:
    """The derived walk tables of trie ``nodes`` (``kernels/lpm.lpm_derive``,
    torch ops on its device), built once and cached on the tensor's
    ``(data_ptr, shape, _version)``: an in-place edit bumps the version and
    rebuilds them. The entry holds the tensor weakly and is dropped with
    it, so a new trie at a freed address is never served stale tables. A
    cache hit costs the host a dict lookup and reads nothing back.

    An edit of a trie must therefore go through a torch in-place op on the
    tensor itself. Writes that bypass its version counter (through
    ``.data``, or a kernel writing through ``data_ptr``) are not seen: the
    walk would go on reading the tables of the trie as it was."""
    return (_cached(nodes) or _derive(nodes))[2]


def _lpm_tables(nodes, name, dev):
    """(cells, runs) pointers of trie ``nodes``'s derived tables, which the
    kernel reads in place of the trie (``lpm_derive`` checks the trie's
    dtype and shape; its tables are contiguous on its device)."""
    if nodes.device != dev:
        raise ValueError(f"{name}: expected a tensor on {dev}, got "
                         f"{nodes.device}")
    return (_cached(nodes) or _derive(nodes))[3]


@torch.jit.ignore
def lpm_lookup_fused(lpm_v4: torch.Tensor, lpm_v6: torch.Tensor,
                     addr_words: torch.Tensor, is_v6: torch.Tensor,
                     default_index: int, v4_only: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 → (identity index [N] int32, packed lpm_prefix provenance [N]
    int32, -1 on miss). ``default_index`` (the world index) is a runtime
    scalar. On the card the kernel walks ``lpm_derived``'s tables of both
    tries, built on the first call for each trie; a v4-only launch walks
    ``lpm_v4``'s own planes and derives nothing."""
    if _on_cpu(addr_words):
        return lpm_lookup_plain(lpm_v4, lpm_v6, addr_words, is_v6,
                                default_index, v4_only)
    dev = addr_words.device
    n = addr_words.shape[0]
    addr_words = addr_words.contiguous()
    if addr_words.data_ptr() % 16:
        addr_words = addr_words.clone()
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    meta = torch.empty((n,), dtype=torch.int32, device=dev)
    if v4_only:
        planes4 = _ptr(lpm_v4, _I32, (lpm_v4.shape[0], 256, 3), "lpm_v4",
                       dev)
        isv6_ptr, tables = None, (None,) * 4
    else:
        # the derived tables: freshly allocated, so 16-byte aligned
        planes4 = None
        isv6_ptr = _ptr(is_v6.contiguous(), _BOOL8, (n,), "is_v6", dev, 1)
        tables = (*_lpm_tables(lpm_v4, "lpm_v4", dev),
                  *_lpm_tables(lpm_v6, "lpm_v6", dev))
    _launch("lpm", "lpm_lookup_fused", dev,
            _ptr(addr_words, _I32, (n, 4), "addr_words", dev, 16), isv6_ptr,
            planes4, lpm_v4.shape[0], *tables, int(default_index),
            int(v4_only), n, idx.data_ptr(), meta.data_ptr())
    return idx, meta


# --------------------------------------------------------------------------- #
# K2: forward + reverse CT probe
# --------------------------------------------------------------------------- #
def ct_probe_pair_plain(ct: Dict[str, torch.Tensor], fwd_keys: torch.Tensor,
                        rev_keys: torch.Tensor, now: int, probe_depth: int,
                        shards: int = 1,
                        fwd_home: Optional[torch.Tensor] = None,
                        rev_home: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K2: ``ct_probe_core`` once per orientation,
    over a table of ``shards`` equal tables (``conntrack.probe_window``).
    ``fwd_home``/``rev_home``: the keys' home slots, hoisted by the step
    (``conntrack.ct_home_pair``); hashed here, once for both, when not
    given."""
    if fwd_home is None or rev_home is None:
        fwd_home, rev_home = ct_home_pair(fwd_keys, rev_keys,
                                          ct["expiry"].shape[0], shards)
    return (ct_probe_core(ct["keys"], ct["expiry"], fwd_keys, now,
                          probe_depth, shards, fwd_home),
            ct_probe_core(ct["keys"], ct["expiry"], rev_keys, now,
                          probe_depth, shards, rev_home))


@torch.jit.ignore
def ct_probe_pair_fused(ct: Dict[str, torch.Tensor], fwd_keys: torch.Tensor,
                        rev_keys: torch.Tensor, now: int, probe_depth: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 → (fwd_slot, rev_slot), each [N] int32 (-1 = miss). The kernel
    reads key words as 8-byte pairs: ``ct["keys"]``, ``fwd_keys`` and
    ``rev_keys`` must be 8-byte aligned."""
    if _on_cpu(fwd_keys):
        return ct_probe_pair_plain(ct, fwd_keys, rev_keys, now, probe_depth)
    dev = fwd_keys.device
    n = fwd_keys.shape[0]
    cap = ct["expiry"].shape[0]
    fwd_slot = torch.empty((n,), dtype=torch.int32, device=dev)
    rev_slot = torch.empty((n,), dtype=torch.int32, device=dev)
    _launch("ct_probe", "ct_probe_pair_fused", dev,
            _ptr(ct["keys"], _I32, (cap, 10), "ct.keys", dev, 8),
            _ptr(ct["expiry"], _I32, (cap,), "ct.expiry", dev), cap,
            _ptr(fwd_keys.contiguous(), _I32, (n, 10), "fwd_keys", dev, 8),
            _ptr(rev_keys.contiguous(), _I32, (n, 10), "rev_keys", dev, 8), n,
            _now(now), int(probe_depth), fwd_slot.data_ptr(),
            rev_slot.data_ptr())
    return fwd_slot, rev_slot


@torch.jit.ignore
def ct_probe_pair_sharded(ct: Dict[str, torch.Tensor],
                          fwd_keys: torch.Tensor, rev_keys: torch.Tensor,
                          now: int, probe_depth: int, shards: int,
                          fused: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The probe pair over a shard-major table of ``shards`` equal tables
    (rows shard-major, ``conntrack.probe_window``) → global slots. With
    ``fused``, K2 runs once per table, on its slot range and its rows,
    and each hit is offset by the range's first slot; otherwise the plain
    version runs once over every row."""
    if not fused:
        return ct_probe_pair_plain(ct, fwd_keys, rev_keys, now, probe_depth,
                                   shards)
    local = ct["expiry"].shape[0] // shards
    per = fwd_keys.shape[0] // shards
    fwd, rev = [], []
    for f in range(shards):
        rows = slice(f * per, (f + 1) * per)
        lo = f * local
        part = {k: v[lo:lo + local] for k, v in ct.items()}
        fs, rs = ct_probe_pair_fused(part, fwd_keys[rows], rev_keys[rows],
                                     now, probe_depth)
        fwd.append(torch.where(fs >= 0, fs + lo, fs))
        rev.append(torch.where(rs >= 0, rs + lo, rs))
    return torch.cat(fwd), torch.cat(rev)


# --------------------------------------------------------------------------- #
# K3: policy ladder + L7 matcher + verdict composition
# --------------------------------------------------------------------------- #
def policy_verdict_plain(tensors, ep_slot, direction, id_idx, proto, dport,
                         http_method, http_path, est, reply, valid):
    """Plain torch version of K3 (kernels/classify.classify_interior_core)."""
    from cilium_tpu_torch.kernels.classify import classify_interior_core
    return classify_interior_core(tensors, ep_slot, direction, id_idx, proto,
                                  dport, http_method, http_path, est, reply,
                                  valid)


@torch.jit.ignore
def policy_verdict_fused(tensors: Dict[str, torch.Tensor],
                         ep_slot: torch.Tensor, direction: torch.Tensor,
                         id_idx: torch.Tensor, proto: torch.Tensor,
                         dport: torch.Tensor, http_method: torch.Tensor,
                         http_path: torch.Tensor, est: torch.Tensor,
                         reply: torch.Tensor, valid: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor, torch.Tensor]:
    """K3 → (allow [N] bool, reason [N] int32, status [N] int32,
    redirect [N] bool, matched_rule [N] int32). ``enforced`` and
    ``l7_valid`` may be bool or uint8. The kernel reads ``http_path`` and
    ``l7_path`` 16 bytes at a time: both must be 16-byte aligned."""
    if _on_cpu(valid):
        return policy_verdict_plain(tensors, ep_slot, direction, id_idx,
                                    proto, dport, http_method, http_path,
                                    est, reply, valid)
    dev = valid.device
    n = valid.shape[0]
    t = {k: tensors[k] for k in POLICY_TENSOR_KEYS}
    v = t["verdict"]
    n_eps, _, n_rows, n_cols = v.shape
    n_sets, n_l7 = t["l7_methods"].shape
    width = t["l7_path"].shape[2]
    if http_path.shape != (n, width) or width != 64:
        raise ValueError(f"http_path: shape {tuple(http_path.shape)} does "
                         f"not match the L7 prefix width {width} (64)")
    rows = [_ptr(c.contiguous(), _I32, (n,), name, dev) for name, c in (
        ("ep_slot", ep_slot), ("direction", direction), ("id_idx", id_idx),
        ("proto", proto), ("dport", dport), ("http_method", http_method))]
    rows.append(_ptr(http_path.contiguous(), (torch.uint8,), (n, 64),
                     "http_path", dev, 16))
    rows += [_ptr(c.contiguous(), _BOOL8, (n,), name, dev, 1)
             for name, c in (("est", est), ("reply", reply),
                             ("valid", valid))]
    allow = torch.empty((n,), dtype=torch.bool, device=dev)
    reason = torch.empty((n,), dtype=torch.int32, device=dev)
    status = torch.empty((n,), dtype=torch.int32, device=dev)
    redirect = torch.empty((n,), dtype=torch.bool, device=dev)
    mrule = torch.empty((n,), dtype=torch.int32, device=dev)
    _launch("policy", "policy_verdict_fused", dev, *rows, n,
            _ptr(t["id_class_of"], _I32, None, "id_class_of", dev),
            t["id_class_of"].shape[0],
            _ptr(t["proto_family"], _I32, None, "proto_family", dev),
            t["proto_family"].shape[0],
            _ptr(t["port_class"], _I32, None, "port_class", dev),
            t["port_class"].shape[0], t["port_class"].shape[1],
            _ptr(v, (torch.int16,), None, "verdict", dev, 2),
            n_eps, n_rows, n_cols,
            _ptr(t["enforced"], _BOOL8, (n_eps, 2), "enforced", dev, 1),
            _ptr(t["l7_methods"], (torch.uint8,), None, "l7_methods", dev, 1),
            _ptr(t["l7_valid"], _BOOL8, (n_sets, n_l7), "l7_valid", dev, 1),
            _ptr(t["l7_path_len"], _I32, (n_sets, n_l7), "l7_path_len", dev),
            _ptr(t["l7_path"], (torch.uint8,), (n_sets, n_l7, 64),
                 "l7_path", dev, 16),
            n_sets, n_l7,
            allow.data_ptr(), reason.data_ptr(), status.data_ptr(),
            redirect.data_ptr(), mrule.data_ptr())
    return allow, reason, status, redirect, mrule


# --------------------------------------------------------------------------- #
# Flow fingerprints (the CT-salvage note's; no TPU kernel)
# --------------------------------------------------------------------------- #
def flow_fingerprint_plain(src: torch.Tensor, dst: torch.Tensor,
                           sport: torch.Tensor, dport: torch.Tensor,
                           proto: torch.Tensor, direction: torch.Tensor
                           ) -> torch.Tensor:
    """Plain torch version of the fingerprint kernel: the row's CT key in
    both orientations (``records.ct_key_words``), hashed in one pass
    (``hashing.hash_words_u64``), XORed → [N] int32, the bit patterns of
    ``shim.feeder.flow_hashes`` of the same rows."""
    b = {"src": src, "dst": dst, "sport": sport, "dport": dport,
         "proto": proto, "direction": direction}
    n = src.shape[0]
    h = hash_words_u64(torch.cat([ct_key_words(b, False),
                                  ct_key_words(b, True)]))
    return i32(h[:n] ^ h[n:])


@torch.jit.ignore
def flow_fingerprint_fused(src: torch.Tensor, dst: torch.Tensor,
                           sport: torch.Tensor, dport: torch.Tensor,
                           proto: torch.Tensor, direction: torch.Tensor
                           ) -> torch.Tensor:
    """Each row's flow fingerprint → [N] int32 (``flow_fingerprint_plain``).
    Every column int32; the kernel reads ``src`` and ``dst`` ([N, 4]) 16
    bytes a row, so they must be 16-byte aligned."""
    if _on_cpu(src):
        return flow_fingerprint_plain(src, dst, sport, dport, proto,
                                      direction)
    dev = src.device
    n = src.shape[0]
    fp = torch.empty((n,), dtype=torch.int32, device=dev)
    _launch("flow_fp", "flow_fingerprint_fused", dev,
            *[_ptr(a.contiguous(), _I32, (n, 4), name, dev, 16)
              for name, a in (("src", src), ("dst", dst))],
            *[_ptr(c.contiguous(), _I32, (n,), name, dev) for name, c in (
                ("sport", sport), ("dport", dport), ("proto", proto),
                ("direction", direction))],
            n, fp.data_ptr())
    return fp
