// K2: forward and reverse conntrack probe, a group of kGroup lanes per
// (row, direction).
//
// Replaces the Pallas kernel cilium_tpu/kernels/fused.py::ct_probe_pair_fused
// (pallas_call at fused.py:202); the plain torch version is
// cilium_tpu_torch/kernels/conntrack.py::ct_probe_core, run once per
// orientation.
//
// A key's slot is the s = (base + i) & (cap - 1) with the smallest
// i < probe_depth whose expiry is later than now (unsigned compare) and
// whose 10 key words all match, else -1; base is the key's murmur3 +
// fmix32 hash (ct_hash.cuh: the arithmetic of kernels/hashing.py).
//
// What bounds it on Hopper, and what the design does about it:
// - Scattered loads from a table far larger than L2 (a 2^21-slot table is
//   92 MB): for each probed slot a 4-byte expiry and, if the slot is live,
//   its 40-byte key. A miss (the reverse probe of most established flows)
//   visits all probe_depth slots, so walking them one after another is a
//   chain of up to 8 dependent memory round trips per key.
// - Cooperative probing: the kGroup lanes of a group (a power of two that
//   divides 32) probe one key together. Lane j takes offsets j, j + kGroup,
//   ...; in each round the group's expiries, consecutive u32s in one
//   32-byte sector, are loaded together, the live lanes load their slot's
//   key as five 8-byte loads (slot * 40 bytes is 8-byte aligned), and a
//   ballot over the group with __ffs picks the lowest matching offset,
//   which is the sequential loop's first match. The group stops at the
//   first round with a match, so a miss costs ceil(probe_depth / kGroup)
//   rounds.
// - The row's key is read once per group, its five 8-byte pairs spread
//   over the lanes and coalesced, then shuffled to every lane. Every lane
//   hashes the key itself: the group's lanes run in lockstep, so one lane
//   hashing costs the warp the same instruction slots, and no broadcast is
//   needed.
// - Forward and reverse groups share one grid, so both orientations'
//   loads are in flight together.
// - L2 eviction priority per load (l2_hint.cuh): key lines are read once
//   per batch (evict_first); expiry (8 MB at 2^21 slots) is kept
//   (evict_last).
// - wgmma and TMA do not apply: no matrix product and no tile to copy,
//   only gathers whose addresses depend on the data.

#include <cstdint>
#include <cuda_runtime.h>

#include "ct_hash.cuh"
#include "l2_hint.cuh"

namespace {

// Lanes per key, chosen on the card by a sweep over 1, 2, 4 and 8
// (kernel_sweep.py, PERF.md).
constexpr int kGroup = 4;
static_assert(32 % kGroup == 0, "a group is a power of two dividing 32");

constexpr int kPairs = cthash::kKeyPairs;   // a key is 5 8-byte pairs
constexpr int kMine = (kPairs + kGroup - 1) / kGroup;   // pairs per lane

__global__ void ct_probe_pair_kernel(const uint32_t* __restrict__ tab_keys,
                                     const uint32_t* __restrict__ expiry,
                                     long long cap,
                                     const uint32_t* __restrict__ fwd_keys,
                                     const uint32_t* __restrict__ rev_keys,
                                     long long n, uint32_t now,
                                     int probe_depth,
                                     int32_t* __restrict__ fwd_out,
                                     int32_t* __restrict__ rev_out) {
  const long long group =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) / kGroup;
  if (group >= 2 * n) return;      // a group's lanes leave together
  const int lane = threadIdx.x % kGroup;
  const int first = (threadIdx.x % 32) - lane;   // the group's warp lane 0
  const unsigned gmask =
      kGroup == 32 ? 0xFFFFFFFFu : ((1u << kGroup) - 1u) << first;
  const bool is_rev = group >= n;
  const long long row = is_rev ? group - n : group;
  const uint64_t* src = reinterpret_cast<const uint64_t*>(
      (is_rev ? rev_keys : fwd_keys) + row * 10);

  // the row's key: pair p read by lane p % kGroup, then shuffled to all
  // lanes
  uint64_t mine[kMine];
#pragma unroll
  for (int m = 0; m < kMine; ++m) {
    const int p = lane + m * kGroup;
    mine[m] = p < kPairs ? src[p] : 0;
  }
  uint64_t key[kPairs];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    key[p] = __shfl_sync(gmask, mine[p / kGroup], p % kGroup, kGroup);
  }
  const uint64_t mask = (uint64_t)cap - 1;
  const uint64_t base = cthash::hash_words10(key) & mask;
  const uint64_t keep = l2hint::evict_last();
  const uint64_t once = l2hint::evict_first();

  int32_t found = -1;
  for (int r0 = 0; r0 < probe_depth; r0 += kGroup) {
    const int i = r0 + lane;
    const uint64_t s = (base + i) & mask;
    bool hit = false;
    if (i < probe_depth && l2hint::ld_u32(expiry + s, keep) > now) {
      const uint64_t* tk = reinterpret_cast<const uint64_t*>(tab_keys + s * 10);
      uint64_t slot_key[kPairs];
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        slot_key[p] = l2hint::ld_u64(tk + p, once);
      }
      hit = true;
#pragma unroll
      for (int p = 0; p < kPairs; ++p) hit = hit && slot_key[p] == key[p];
    }
    const unsigned bits = (__ballot_sync(gmask, hit) & gmask) >> first;
    if (bits) {
      found = (int32_t)((base + r0 + __ffs(bits) - 1) & mask);
      break;
    }
  }
  if (lane == 0) (is_rev ? rev_out : fwd_out)[row] = found;
}

}  // namespace

extern "C" int ct_probe_pair_launch(const void* tab_keys, const void* expiry,
                                    long long cap, const void* fwd_keys,
                                    const void* rev_keys, long long n,
                                    unsigned int now, int probe_depth,
                                    void* fwd_out, void* rev_out,
                                    void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (2 * n * kGroup + threads - 1) / threads;
  ct_probe_pair_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(tab_keys),
      static_cast<const uint32_t*>(expiry), cap,
      static_cast<const uint32_t*>(fwd_keys),
      static_cast<const uint32_t*>(rev_keys), n, now, probe_depth,
      static_cast<int32_t*>(fwd_out), static_cast<int32_t*>(rev_out));
  return (int)cudaGetLastError();
}
