// The conntrack key hash on the card: a murmur3-style accumulation of the
// key's ten u32 words, then the fmix32 finalizer. It is the arithmetic of
// kernels/hashing.py (hash_words_u64 on the device, hash_words_np on the
// host), which must agree with it bit for bit. K2 (ct_probe_pair.cu)
// hashes CT keys with it for their home slots, and flow_fingerprint.cu
// hashes both orientations of a row's key into its flow fingerprint.
//
// A key is passed as five 8-byte pairs: word 2p in the low half of pair p,
// word 2p + 1 in the high half, as a little-endian 8-byte load of the key
// gives them.

#pragma once

#include <cstdint>

namespace cthash {

constexpr int kKeyPairs = 5;     // a key is 10 words, 5 8-byte pairs

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t hash_words10(
    const uint64_t (&k)[kKeyPairs]) {
  uint32_t h = 0x9747B28Cu;
#pragma unroll
  for (int i = 0; i < 2 * kKeyPairs; ++i) {
    uint32_t w = static_cast<uint32_t>(k[i / 2] >> (32 * (i % 2)));
    w *= 0xCC9E2D51u;
    w = rotl32(w, 15);
    w *= 0x1B873593u;
    h ^= w;
    h = rotl32(h, 13);
    h = h * 5u + 0xE6546B64u;
  }
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

}  // namespace cthash
