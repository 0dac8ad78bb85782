"""The conntrack key's hash (32-bit MurmurHash3 over the key's words), which
places a key in the table: the slot layout is part of the table's state."""

import numpy as np

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)
_SEED = np.uint32(0x9747B28C)


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def murmur3_words(words: np.ndarray) -> np.ndarray:
    """words [..., K] uint32 → hash [...] uint32."""
    words = np.asarray(words, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h = np.full(words.shape[:-1], _SEED, dtype=np.uint32)
        for i in range(words.shape[-1]):
            k = _rotl(words[..., i] * _C1, 15)
            h = h ^ (k * _C2)
            h = _rotl(h, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))
