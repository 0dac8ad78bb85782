"""32-bit mixing hash over conntrack key words (port of
``cilium_tpu/kernels/hashing.py``): a murmur3-style accumulate plus the
fmix32 finalizer. Two executors of one definition: ``hash_words_u64`` runs
on the device (the CT probe, the LB frontend probe); ``hash_words_np`` is
the host mirror the LB compiler hashes its frontend and Maglev tables with.
They must agree bit for bit, or every service lookup misses.

Also home of the two u32 lane helpers every module of the port uses:
``u32`` widens an int32 bit pattern to its unsigned value in int64, and
``i32`` narrows an int64 back to the int32 that holds its low 32 bits.
Torch has no unsigned 32-bit shift, add, compare or modulo on the CPU, and
int32 ``>>`` is arithmetic, so all u32 arithmetic runs in int64.

The torch functions compile under ``torch.jit.script`` (the CPU step is
one scripted call, ``kernels/classify.py``), which reads no module-level
number: they spell their constants as literals, the numpy mirror reads
the named ones, and the tests hold the two equal.
"""

from __future__ import annotations

import numpy as np
import torch

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_SEED = 0x9747B28C


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (or any integer) bit pattern → its u32 value as int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def i32(x: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 holding its low 32 bits (two's complement)."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``x * c`` for x, c < 2^32, without int64 overflow:
    split c into 16-bit halves so every partial product stays < 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & 0xFFFFFFFF) | (x >> (32 - r))


def hash_words_u64(words: torch.Tensor) -> torch.Tensor:
    """words [..., K] (int32 bit patterns or u32 values in int64) → the
    hash [...] as a u32 value in int64 (seed ``_SEED``, multipliers
    ``_C1``, ``_C2``)."""
    w = u32(words)
    h = torch.full(w.shape[:-1], 0x9747B28C, dtype=torch.int64,
                   device=w.device)
    for i in range(w.shape[-1]):
        k = _mul32(w[..., i], 0xCC9E2D51)
        k = _rotl32(k, 15)
        k = _mul32(k, 0x1B873593)
        h = h ^ k
        h = _rotl32(h, 13)
        h = (_mul32(h, 5) + 0xE6546B64) & 0xFFFFFFFF
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def hash_words_np(words: np.ndarray) -> np.ndarray:
    """words [..., K] → the hash [...] as uint32 (host numpy)."""
    words = np.asarray(words).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = np.full(words.shape[:-1], _SEED, dtype=np.uint32)
        for i in range(words.shape[-1]):
            k = _rotl32_np(words[..., i] * np.uint32(_C1), 15)
            h = h ^ (k * np.uint32(_C2))
            h = _rotl32_np(h, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))


def _rotl32_np(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))
