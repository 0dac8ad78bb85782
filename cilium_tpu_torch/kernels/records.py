"""Packet batch layout and the packed wire formats (port of
``cilium_tpu/kernels/records.py``).

A batch is a dict of arrays with a fixed size N (padded; ``valid`` masks
real packets). The host packers below are numpy copies of the reference's:
they build the one contiguous uint32 wire array the serving path ships.
The device half unpacks any wire form into the port's batch dict of torch
tensors, where the u32 columns (``src``, ``dst``) are int32 bit patterns
and the rest keep the reference's dtypes (int32 columns, bool ``is_v6`` and
``valid``, uint8 ``http_path``).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cilium_tpu_torch.kernels.hashing import i32, u32
from cilium_tpu_torch.utils import constants as C

BatchArrays = Dict[str, np.ndarray]


def empty_batch(n: int) -> BatchArrays:
    return {
        "src": np.zeros((n, 4), dtype=np.uint32),
        "dst": np.zeros((n, 4), dtype=np.uint32),
        "sport": np.zeros((n,), dtype=np.int32),
        "dport": np.zeros((n,), dtype=np.int32),
        "proto": np.zeros((n,), dtype=np.int32),
        "tcp_flags": np.zeros((n,), dtype=np.int32),
        "is_v6": np.zeros((n,), dtype=bool),
        "ep_slot": np.zeros((n,), dtype=np.int32),
        "direction": np.zeros((n,), dtype=np.int32),
        "http_method": np.full((n,), C.HTTP_METHOD_ANY, dtype=np.int32),
        "http_path": np.zeros((n, C.L7_PATH_MAXLEN), dtype=np.uint8),
        "valid": np.zeros((n,), dtype=bool),
    }



def reset_batch_rows(b: BatchArrays, start: int, stop: int) -> None:
    """Restore rows [start:stop] of a reused batch dict to the
    ``empty_batch`` defaults (optional shim-side ``_*`` columns included).
    Every buffer-reuse site (staging-ring flush tails, reusable poll
    buffers) goes through here so a future column with a non-zero default
    cannot silently diverge between them."""
    for k, col in b.items():
        if k == "valid":
            col[start:stop] = False
        elif k == "http_method":
            col[start:stop] = C.HTTP_METHOD_ANY
        else:
            col[start:stop] = 0


def _addr_words(addr16: bytes) -> np.ndarray:
    return np.frombuffer(addr16, dtype=">u4").astype(np.uint32)


def batch_from_records(records: Sequence, ep_slot_of: Dict[int, int],
                       pad_to: int = 0) -> BatchArrays:
    """Build a batch from oracle PacketRecords (tests / pcap replay).

    Records for endpoints unknown to the snapshot fail closed: they are left
    ``valid=False`` (never forwarded, no CT effects) — the batch-level analog
    of the oracle's INVALID_IDENTITY drop for unknown endpoints.
    """
    n = max(len(records), pad_to)
    b = empty_batch(n)
    for i, p in enumerate(records):
        b["src"][i] = _addr_words(p.src_addr)
        b["dst"][i] = _addr_words(p.dst_addr)
        b["sport"][i] = p.src_port
        b["dport"][i] = p.dst_port
        b["proto"][i] = p.proto
        b["tcp_flags"][i] = p.tcp_flags
        b["is_v6"][i] = p.is_ipv6
        slot = ep_slot_of.get(p.ep_id)
        if slot is None:
            continue  # fail closed: stays invalid
        b["ep_slot"][i] = slot
        b["direction"][i] = p.direction
        b["http_method"][i] = p.http_method
        pb = p.http_path[:C.L7_PATH_MAXLEN]
        if pb:
            b["http_path"][i, :len(pb)] = np.frombuffer(pb, dtype=np.uint8)
        b["valid"][i] = True
    return b


def ct_key_words_np(batch: BatchArrays, reverse: bool = False) -> np.ndarray:
    """[N, 10] uint32 conntrack key on the host (numpy; the checkpoint,
    steering and oracle-export side), forward or reverse orientation: the
    same words ``ct_key_words`` builds on the device."""
    src, dst = ((batch["dst"], batch["src"]) if reverse
                else (batch["src"], batch["dst"]))
    sport, dport = ((batch["dport"], batch["sport"]) if reverse
                    else (batch["sport"], batch["dport"]))
    direction = (1 - batch["direction"]) if reverse else batch["direction"]
    words = [
        src[:, 0], src[:, 1], src[:, 2], src[:, 3],
        dst[:, 0], dst[:, 1], dst[:, 2], dst[:, 3],
        (sport.astype(np.uint32) << np.uint32(16)) | dport.astype(np.uint32),
        (batch["proto"].astype(np.uint32) << np.uint32(8))
        | direction.astype(np.uint32),
    ]
    return np.stack(words, axis=-1)

def ct_key_words(batch: Dict[str, torch.Tensor],
                 reverse: bool = False) -> torch.Tensor:
    """[N, 10] conntrack key (int32 bit patterns of the reference's uint32
    words; see compile/ct_layout.py), forward or reverse orientation."""
    src, dst = batch["src"], batch["dst"]
    sport, dport = batch["sport"], batch["dport"]
    direction = batch["direction"]
    if reverse:
        src, dst, sport, dport = dst, src, dport, sport
        direction = 1 - direction
    port_w = i32((u32(sport) << 16) | u32(dport))
    proto_w = i32((u32(batch["proto"]) << 8) | u32(direction))
    return torch.cat([src.to(torch.int32), dst.to(torch.int32),
                      port_w[:, None], proto_w[:, None]], dim=-1)


# --------------------------------------------------------------------------- #
# Packed wire format: ONE contiguous uint32 array per batch.
#
# One contiguous buffer crosses the host link in one transfer instead of
# twelve; the host packs (vectorized numpy) and the device unpacks with a
# few bit ops (``unpack_wire`` below).
#
# Word layout per record:
#   0-3   src words          4-7  dst words
#   8     sport<<16 | dport
#   9     proto<<24 | tcp_flags<<16 | http_method<<8 | is_v6<<2|dir<<1|valid
#   10    ep_slot
#   11+   (L7 variant only) http_path as 16 big-endian uint32 words
# --------------------------------------------------------------------------- #
PACK_WORDS = 11
PACK_WORDS_L7 = PACK_WORDS + C.L7_PATH_MAXLEN // 4


def _out_view(out: Optional[np.ndarray], n: int, words: int) -> np.ndarray:
    """Resolve the ``out=`` contract shared by every pack kernel: a
    caller-owned uint32 buffer with >= n rows of exactly ``words`` columns
    (the staging ring preallocates at max_bucket rows and packs into the
    [:n] prefix). Returns the [:n] view to fill, or a fresh allocation when
    the caller passed none."""
    if out is None:
        return np.empty((n, words), dtype=np.uint32)
    if (out.dtype != np.uint32 or out.ndim != 2 or out.shape[0] < n
            or out.shape[1] != words):
        raise ValueError(
            f"pack out= buffer mismatch: need uint32 [>={n}, {words}], "
            f"got {out.dtype} {out.shape}")
    return out[:n]


def _path_words_of(paths: np.ndarray) -> int:
    """Smallest power-of-two word count covering the longest path in
    ``paths`` [N, 64]. L7 throughput is transfer-bound and most HTTP paths
    are short: shipping only the occupied prefix (rounded to a power of two
    so trace shapes stay few) cuts the wire size ~2-4x vs the fixed 64-byte
    block."""
    nz = np.nonzero(paths.any(axis=0))[0]
    maxlen = int(nz[-1]) + 1 if nz.size else 1
    words = -(-maxlen // 4)
    return min(1 << (words - 1).bit_length(), C.L7_PATH_MAXLEN // 4)


def _path_words_for(b: BatchArrays) -> int:
    return _path_words_of(b["http_path"])


def pack_batch(b: BatchArrays, l7: Optional[bool] = None,
               path_words: Optional[int] = None,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """Pack a batch dict → [N, 11] (or [N, 11+path_words] when l7) uint32.
    ``l7=None`` auto-detects: include the path block iff any record carries
    L7 tokens. ``path_words`` (power of two ≤ 16) sizes the path block;
    default = smallest power of two covering the batch's longest path.
    ``out=`` writes into a caller-owned buffer (see ``_out_view``) instead
    of allocating — the staging ring's steady-state zero-alloc path; the
    wire is bit-identical either way."""
    if l7 is None:
        l7 = bool((b["http_method"] != C.HTTP_METHOD_ANY).any()
                  or b["http_path"].any())
    if l7:
        if path_words is None:
            path_words = _path_words_for(b)
        path_words = min(path_words, C.L7_PATH_MAXLEN // 4)
        if b["http_path"][:, 4 * path_words:].any():
            raise ValueError(f"path_words={path_words} truncates a path")
    else:
        path_words = 0
    n = b["valid"].shape[0]
    out = _out_view(out, n, PACK_WORDS + path_words)
    out[:, 0:4] = b["src"]
    out[:, 4:8] = b["dst"]
    out[:, 8] = (b["sport"].astype(np.uint32) << 16) \
        | b["dport"].astype(np.uint32)
    out[:, 9] = (b["proto"].astype(np.uint32) << 24) \
        | (b["tcp_flags"].astype(np.uint32) << 16) \
        | (b["http_method"].astype(np.uint32) << 8) \
        | (b["is_v6"].astype(np.uint32) << 2) \
        | (b["direction"].astype(np.uint32) << 1) \
        | b["valid"].astype(np.uint32)
    out[:, 10] = b["ep_slot"].astype(np.uint32)
    if l7:
        p = b["http_path"][:, :4 * path_words].reshape(
            n, path_words, 4).astype(np.uint32)
        out[:, PACK_WORDS:] = ((p[:, :, 0] << 24) | (p[:, :, 1] << 16)
                               | (p[:, :, 2] << 8) | p[:, :, 3])
    return out


# Compact v4 variant: 4 words (16B) per record — for the v4-only, L7-free
# hot path (configs 1/2/3/5 traffic). The classify pipeline is transfer-
# bound, so bytes/record is the throughput knob: 16B vs 44B is ~2.7x more
# records per second through the same link.
#   0  src v4   1  dst v4   2  sport<<16|dport
#   3  proto<<24 | tcp_flags<<16 | ep_slot<<2 | dir<<1 | valid
# ep_slot therefore caps at 14 bits (16383 endpoints/node) in this format;
# the full format carries 32-bit slots.
PACK4_WORDS = 4
PACK4_EP_SLOT_MAX = (1 << 14) - 1


def pack_batch_v4(b: BatchArrays,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
    """Pack a v4-only, L7-free batch dict → [N, 4] uint32. ``out=`` fills
    a caller-owned buffer in place (bit-identical wire, no allocation)."""
    if b["is_v6"].any():
        raise ValueError("pack_batch_v4: batch contains v6 records")
    if (b["ep_slot"] > PACK4_EP_SLOT_MAX).any():
        raise ValueError("pack_batch_v4: ep_slot exceeds 14-bit compact cap")
    n = b["valid"].shape[0]
    out = _out_view(out, n, PACK4_WORDS)
    out[:, 0] = b["src"][:, 3]
    out[:, 1] = b["dst"][:, 3]
    out[:, 2] = (b["sport"].astype(np.uint32) << 16) \
        | b["dport"].astype(np.uint32)
    out[:, 3] = (b["proto"].astype(np.uint32) << 24) \
        | (b["tcp_flags"].astype(np.uint32) << 16) \
        | (b["ep_slot"].astype(np.uint32) << 2) \
        | (b["direction"].astype(np.uint32) << 1) \
        | b["valid"].astype(np.uint32)
    return out


# --------------------------------------------------------------------------- #
# L7 dictionary wire format: (wire, path_dict) — real HTTP traffic repeats a
# small set of paths, so shipping the 64B path block per record wastes ~80%
# of the link. Instead: unique paths once per batch ([U, P] packed words,
# U padded to a power of two for trace stability) + a 16-bit dictionary
# index per record; the device gathers the path bytes back during unpack.
# 20B/record vs 76-108B.
#
# v4-compact variant ([N, 5]): PACK4 words 0-3 + word 4 = method<<24|path_idx.
# full variant ([N, 12]): PACK words 0-10 + word 11 = path_idx (method is
# already in word 9).
# --------------------------------------------------------------------------- #
PACK4_L7_WORDS = PACK4_WORDS + 1
PACK_L7DICT_WORDS = PACK_WORDS + 1


def _pad_dict_rows(count: int, min_rows: int) -> int:
    """Dictionary row padding: next power of two ≥ max(count, min_rows) —
    shared by the path and address dictionaries so trace-shape policy can't
    silently diverge between them."""
    return 1 << max(0, (max(count, min_rows) - 1)).bit_length()


def _pack_path_dict(paths: np.ndarray, path_words: Optional[int],
                    min_rows: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """[N, 64] uint8 → (dict_words [U_pow2, P] uint32, index [N] int64).
    ``min_rows`` floors the padded row count (callers pin it grow-only so
    serving doesn't retrace when per-batch path diversity fluctuates)."""
    uniq, idx = np.unique(paths, axis=0, return_inverse=True)
    if uniq.shape[0] > 65536:
        raise ValueError("path dictionary overflow (>64k unique paths)")
    if path_words is None:
        path_words = _path_words_of(uniq)
    path_words = min(path_words, C.L7_PATH_MAXLEN // 4)
    if uniq[:, 4 * path_words:].any():
        raise ValueError(f"path_words={path_words} truncates a path")
    u_pad = _pad_dict_rows(uniq.shape[0], min_rows)
    p = np.zeros((u_pad, 4 * path_words), dtype=np.uint32)
    p[:uniq.shape[0]] = uniq[:, :4 * path_words]
    p = p.reshape(u_pad, path_words, 4)
    words = ((p[:, :, 0] << 24) | (p[:, :, 1] << 16)
             | (p[:, :, 2] << 8) | p[:, :, 3])
    return words, idx


def pack_batch_l7dict(b: BatchArrays, path_words: Optional[int] = None,
                      min_rows: int = 1, force_full: bool = False,
                      out: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack an L7 batch as (wire, path_dict). Picks the 5-word v4-compact
    wire when the batch qualifies, else the 12-word full wire
    (``force_full`` pins the full wire so serving paths don't flap formats
    batch-to-batch). ``out=`` fills a caller-owned wire buffer in place
    (its width must match the variant this batch selects; the path dict is
    always fresh — ``np.unique`` allocates regardless, and the upload layer
    dedups re-transfers by content instead)."""
    dict_words, idx = _pack_path_dict(b["http_path"], path_words, min_rows)
    return pack_l7dict_wire(b, idx, force_full=force_full, out=out), \
        dict_words


def pack_l7dict_wire(b: BatchArrays, idx: np.ndarray,
                     force_full: bool = False,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
    """The wire half of ``pack_batch_l7dict``: ``idx`` [N] is each row's
    index into the path dict that ``_pack_path_dict`` made."""
    n = b["valid"].shape[0]
    if not force_full and not b["is_v6"].any() \
            and not (b["ep_slot"] > PACK4_EP_SLOT_MAX).any():
        wire = _out_view(out, n, PACK4_L7_WORDS)
        wire[:, 0] = b["src"][:, 3]
        wire[:, 1] = b["dst"][:, 3]
        wire[:, 2] = (b["sport"].astype(np.uint32) << 16) \
            | b["dport"].astype(np.uint32)
        wire[:, 3] = (b["proto"].astype(np.uint32) << 24) \
            | (b["tcp_flags"].astype(np.uint32) << 16) \
            | (b["ep_slot"].astype(np.uint32) << 2) \
            | (b["direction"].astype(np.uint32) << 1) \
            | b["valid"].astype(np.uint32)
        wire[:, 4] = (b["http_method"].astype(np.uint32) << 24) \
            | idx.astype(np.uint32)
        return wire
    wire = _out_view(out, n, PACK_L7DICT_WORDS)
    pack_batch(b, l7=False, out=wire[:, :PACK_WORDS])
    wire[:, PACK_WORDS] = idx.astype(np.uint32)
    return wire


# --------------------------------------------------------------------------- #
# Address-dictionary wire: (wire [N,3 or 4], addr_dict [U,4] [, path_dict]) —
# pod traffic repeats addresses heavily (a 65k-record cfg5 batch carries
# ~2000 distinct addresses), so shipping each unique 16B normalized address
# once and 16-bit indexes per record beats even the compact v4 wire
# (12B/record vs 16B) and beats the full wire ~3x for mixed v4/v6. Handles
# both families uniformly (the dict rows are v4-mapped/16B).
#
#   w0 = src_idx<<16 | dst_idx          (indexes into addr_dict)
#   w1 = sport<<16 | dport
#   w2 = proto<<24 | tcp_flags<<16 | ep_slot<<3 | is_v6<<2 | dir<<1 | valid
#   w3 = http_method<<16 | path_idx     (L7 variant only)
# --------------------------------------------------------------------------- #
PACKA_WORDS = 3
PACKA_L7_WORDS = 4
PACKA_EP_SLOT_MAX = (1 << 13) - 1


def addr_dict_ratio(b: BatchArrays) -> float:
    """Unique-address fraction of a batch (selection heuristic: the addr
    dict wins when addresses repeat; random-scan traffic where every
    record brings fresh addresses packs better with the flat formats)."""
    n = b["valid"].shape[0]
    if n == 0:
        return 1.0
    uniq = np.unique(np.concatenate([b["src"], b["dst"]]), axis=0)
    return uniq.shape[0] / (2 * n)


def pack_batch_addrdict(b: BatchArrays, l7: Optional[bool] = None,
                        min_addr_rows: int = 1,
                        path_words: Optional[int] = None,
                        min_path_rows: int = 1):
    """Pack a batch in the address-dictionary wire. Returns
    (wire [N,3], addr_dict) or, with L7 tokens, (wire [N,4], addr_dict,
    path_dict). ``min_*_rows`` floor the padded dictionary sizes (grow-only
    pinning for serving paths)."""
    n = b["valid"].shape[0]
    if (b["ep_slot"] > PACKA_EP_SLOT_MAX).any():
        raise ValueError("pack_batch_addrdict: ep_slot exceeds 13-bit cap")
    uniq, inv = np.unique(np.concatenate([b["src"], b["dst"]]), axis=0,
                          return_inverse=True)
    if uniq.shape[0] > 65536:
        raise ValueError("address dictionary overflow (>64k unique)")
    u_pad = _pad_dict_rows(uniq.shape[0], min_addr_rows)
    addr_dict = np.zeros((u_pad, 4), dtype=np.uint32)
    addr_dict[:uniq.shape[0]] = uniq
    src_idx = inv[:n].astype(np.uint32)
    dst_idx = inv[n:].astype(np.uint32)
    if l7 is None:
        l7 = bool((b["http_method"] != C.HTTP_METHOD_ANY).any()
                  or b["http_path"].any())
    wire = np.empty((n, PACKA_L7_WORDS if l7 else PACKA_WORDS),
                    dtype=np.uint32)
    wire[:, 0] = (src_idx << 16) | dst_idx
    wire[:, 1] = (b["sport"].astype(np.uint32) << 16) \
        | b["dport"].astype(np.uint32)
    wire[:, 2] = (b["proto"].astype(np.uint32) << 24) \
        | (b["tcp_flags"].astype(np.uint32) << 16) \
        | (b["ep_slot"].astype(np.uint32) << 3) \
        | (b["is_v6"].astype(np.uint32) << 2) \
        | (b["direction"].astype(np.uint32) << 1) \
        | b["valid"].astype(np.uint32)
    if not l7:
        return wire, addr_dict
    path_dict, path_idx = _pack_path_dict(b["http_path"], path_words,
                                          min_path_rows)
    wire[:, 3] = (b["http_method"].astype(np.uint32) << 16) \
        | path_idx.astype(np.uint32)
    return wire, addr_dict, path_dict


def wire_words_for(use_l7: bool, use_wide: bool) -> int:
    """Wire width (uint32 words/record) the serving path ships for a given
    sticky-format decision — one ladder shared by the single-chip and the
    sharded pack paths so the format choice cannot diverge between them."""
    if use_l7:
        return PACK_L7DICT_WORDS if use_wide else PACK4_L7_WORDS
    return PACK_WORDS if use_wide else PACK4_WORDS


# --------------------------------------------------------------------------- #
# Device half: wire (torch int32 bit patterns) → batch dict of tensors
# --------------------------------------------------------------------------- #
def wire_to_torch(wire, device="cuda"):
    """Host wire (a uint32 array, or the tuple of a dictionary wire) → the
    int32 tensors ``unpack_wire`` takes, on ``device``."""
    if isinstance(wire, (tuple, list)):
        return tuple(wire_to_torch(w, device) for w in wire)
    if isinstance(wire, torch.Tensor):
        return wire.to(device)
    arr = np.ascontiguousarray(wire, dtype=np.uint32).view(np.int32)
    return torch.tensor(arr, device=device)


#: this module, as the scripted unpackers read its wire widths:
#: TorchScript reads a number only as an attribute of a module
_LAYOUT = sys.modules[__name__]


def _field(w: torch.Tensor, shift: int, mask: int) -> torch.Tensor:
    """Logical (u32) ``(w >> shift) & mask`` of an int32 bit pattern."""
    return ((u32(w) >> shift) & mask).to(torch.int32)


def _words_to_path(words: torch.Tensor) -> torch.Tensor:
    """[N, P] big-endian path words → [N, 64] uint8 (zero-padded)."""
    n = words.shape[0]
    w = u32(words)
    path = torch.stack([(w >> 24) & 0xFF, (w >> 16) & 0xFF,
                        (w >> 8) & 0xFF, w & 0xFF],
                       dim=-1).reshape(n, -1).to(torch.uint8)
    pad = C.L7_PATH_MAXLEN - path.shape[1]
    if pad > 0:
        path = torch.nn.functional.pad(path, [0, pad])
    return path


def _dict_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with the reference's gather semantics: an index past
    the table clamps to its last row instead of faulting."""
    return table[idx.clamp(0, table.shape[0] - 1).to(torch.int64)]


def _no_l7(b: Dict[str, torch.Tensor], n: int,
           device: torch.device) -> Dict[str, torch.Tensor]:
    """``b`` with the columns of a batch without L7 tokens."""
    b["http_method"] = torch.full((n,), C.HTTP_METHOD_ANY,
                                  dtype=torch.int32, device=device)
    b["http_path"] = torch.zeros((n, C.L7_PATH_MAXLEN), dtype=torch.uint8,
                                 device=device)
    return b


def unpack_batch(packed: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Full layout ([N, 11] or [N, 11 + path_words]) → batch dict."""
    n = packed.shape[0]
    w9 = packed[:, 9]
    b = {
        "src": packed[:, 0:4].contiguous(),
        "dst": packed[:, 4:8].contiguous(),
        "sport": _field(packed[:, 8], 16, 0xFFFF),
        "dport": _field(packed[:, 8], 0, 0xFFFF),
        "proto": _field(w9, 24, 0xFF),
        "tcp_flags": _field(w9, 16, 0xFF),
        "http_method": _field(w9, 8, 0xFF),
        "is_v6": _field(w9, 2, 1).to(torch.bool),
        "direction": _field(w9, 1, 1),
        "valid": _field(w9, 0, 1).to(torch.bool),
        "ep_slot": packed[:, 10].contiguous(),
    }
    if packed.shape[1] > _LAYOUT.PACK_WORDS:
        b["http_path"] = _words_to_path(packed[:, _LAYOUT.PACK_WORDS:])
    else:
        b["http_path"] = torch.zeros((n, C.L7_PATH_MAXLEN),
                                     dtype=torch.uint8, device=packed.device)
    return b


def unpack_batch_v4(packed: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Compact v4 layout [N, 4] → batch dict (v4-mapped addresses: words
    [0, 0, 0xFFFF, addr])."""
    n = packed.shape[0]
    w3 = packed[:, 3]
    zeros = torch.zeros((n,), dtype=torch.int32, device=packed.device)
    ffff = torch.full((n,), 0xFFFF, dtype=torch.int32, device=packed.device)
    b = {
        "src": torch.stack([zeros, zeros, ffff, packed[:, 0]], dim=-1),
        "dst": torch.stack([zeros, zeros, ffff, packed[:, 1]], dim=-1),
        "sport": _field(packed[:, 2], 16, 0xFFFF),
        "dport": _field(packed[:, 2], 0, 0xFFFF),
        "proto": _field(w3, 24, 0xFF),
        "tcp_flags": _field(w3, 16, 0xFF),
        "is_v6": torch.zeros((n,), dtype=torch.bool, device=packed.device),
        "direction": _field(w3, 1, 1),
        "valid": _field(w3, 0, 1).to(torch.bool),
        "ep_slot": _field(w3, 2, _LAYOUT.PACK4_EP_SLOT_MAX),
    }
    return _no_l7(b, n, packed.device)


def unpack_batch_l7dict(wire: torch.Tensor,
                        dict_words: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Either L7 path-dictionary wire ([N, 5] or [N, 12]) → batch dict."""
    if wire.shape[1] == _LAYOUT.PACK4_L7_WORDS:
        b = unpack_batch_v4(wire[:, :_LAYOUT.PACK4_WORDS])
        w4 = wire[:, 4]
        b["http_method"] = _field(w4, 24, 0xFF)
        b["http_path"] = _words_to_path(
            _dict_rows(dict_words, _field(w4, 0, 0xFFFF)))
        return b
    b = unpack_batch(wire[:, :_LAYOUT.PACK_WORDS])
    b["http_path"] = _words_to_path(
        _dict_rows(dict_words,
                   _field(wire[:, _LAYOUT.PACK_WORDS], 0, 0xFFFF)))
    return b


def unpack_batch_addrdict(wire: torch.Tensor, addr_dict: torch.Tensor,
                          path_dict: Optional[torch.Tensor] = None
                          ) -> Dict[str, torch.Tensor]:
    """Address-dictionary wire ([N, 3] or [N, 4]) → batch dict."""
    n = wire.shape[0]
    w2 = wire[:, 2]
    b = {
        "src": _dict_rows(addr_dict, _field(wire[:, 0], 16, 0xFFFF)),
        "dst": _dict_rows(addr_dict, _field(wire[:, 0], 0, 0xFFFF)),
        "sport": _field(wire[:, 1], 16, 0xFFFF),
        "dport": _field(wire[:, 1], 0, 0xFFFF),
        "proto": _field(w2, 24, 0xFF),
        "tcp_flags": _field(w2, 16, 0xFF),
        "ep_slot": _field(w2, 3, _LAYOUT.PACKA_EP_SLOT_MAX),
        "is_v6": _field(w2, 2, 1).to(torch.bool),
        "direction": _field(w2, 1, 1),
        "valid": _field(w2, 0, 1).to(torch.bool),
    }
    if wire.shape[1] == _LAYOUT.PACKA_L7_WORDS and path_dict is not None:
        w3 = wire[:, 3]
        b["http_method"] = _field(w3, 16, 0xFF)
        b["http_path"] = _words_to_path(
            _dict_rows(path_dict, _field(w3, 0, 0xFFFF)))
        return b
    return _no_l7(b, n, wire.device)


def unpack_wire_parts(parts: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A packed wire as the list of its tensors (the wire, then its
    dictionaries) → the standard batch dict, dispatching on the count and
    the wire's width: more than one part is a dictionary wire (address or
    L7 path), [N, 4] alone is compact v4, anything else the full
    layout."""
    wire = parts[0]
    if len(parts) > 1:
        if wire.shape[1] == _LAYOUT.PACKA_WORDS \
                or wire.shape[1] == _LAYOUT.PACKA_L7_WORDS:
            return unpack_batch_addrdict(
                wire, parts[1], parts[2] if len(parts) > 2 else None)
        return unpack_batch_l7dict(wire, parts[1])
    if wire.shape[1] == _LAYOUT.PACK4_WORDS:
        return unpack_batch_v4(wire)
    return unpack_batch(wire)


def wire_parts(batch) -> List[torch.Tensor]:
    """A wire on the device (a tensor, or the tuple of a dictionary wire)
    → the list ``unpack_wire_parts`` takes."""
    return list(batch) if isinstance(batch, (tuple, list)) else [batch]


def unpack_wire(batch) -> Dict[str, torch.Tensor]:
    """Any packed wire form on the device → the standard batch dict
    (``unpack_wire_parts``)."""
    return unpack_wire_parts(wire_parts(batch))


def batch_to_torch(b: BatchArrays, device="cuda") -> Dict[str, torch.Tensor]:
    """Host batch dict (the reference's dtypes) → the port's batch dict on
    ``device`` (uint32 columns as int32 bit patterns)."""
    out = {}
    for k, v in b.items():
        v = np.ascontiguousarray(v)
        if v.dtype == np.uint32:
            v = v.view(np.int32)
        out[k] = torch.tensor(v, device=device)
    return out
