"""Carries the JAX package's arrays across to the port and back.

The reference keeps u32 lanes as uint32 and the verdict image as uint16;
the port keeps the same bytes as int32 and int16 tensors (torch has no
arithmetic on the unsigned types). int64 arrays (``identity_ids``) become
int32, as ``jnp.asarray`` makes them with 64-bit types off. Everything
else keeps its dtype. The inverse direction views the bit patterns back,
so a table round-trips byte for byte.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

#: out columns and counters that are uint32 in the reference (and the
#: port's own ``est_fp``, which is the reference's flow hashes)
U32_OUT = frozenset({"remote_identity", "nat_dst", "rnat_src",
                     "by_reason_dir", "insert_fail", "ct_evicted",
                     "est_fp"})


def port_dtype(a: np.ndarray) -> np.ndarray:
    """A reference array in the dtype the port keeps it in: the bit
    pattern of a uint32 (uint16) array viewed as int32 (int16), int64 cast
    to int32; anything else as it is. Contiguous."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    if a.dtype == np.uint16:
        return a.view(np.int16)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    return a


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    return torch.tensor(port_dtype(a), device=device)     # always a copy


def snapshot_tensors_to_torch(tensors: Dict[str, np.ndarray],
                              device="cuda") -> Dict[str, torch.Tensor]:
    """``PolicySnapshot.tensors()`` (numpy) → the tensor dict the port's
    ``classify_step`` reads, on ``device``."""
    return {k: _to_torch(np.asarray(v), device) for k, v in tensors.items()}


def ct_to_torch(ct: Dict[str, np.ndarray],
                device="cuda") -> Dict[str, torch.Tensor]:
    """The 7-array CT dict (uint32 numpy) → int32 tensors on ``device``."""
    return {k: _to_torch(np.asarray(v, dtype=np.uint32), device)
            for k, v in ct.items()}


def ct_to_numpy(ct: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's CT dict → uint32 numpy arrays (the reference's bytes)."""
    return {k: v.detach().cpu().numpy().view(np.uint32)
            for k, v in ct.items()}


def to_numpy(d: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """An out or counters dict → numpy in the reference's dtypes (the u32
    columns of ``U32_OUT`` viewed back as uint32)."""
    out = {}
    for k, v in d.items():
        a = v.detach().cpu().numpy()
        out[k] = a.view(np.uint32) if k in U32_OUT else a
    return out
