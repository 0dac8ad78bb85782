// K1: ipcache LPM stride walk with prefix provenance, one thread per row.
//
// Replaces the Pallas kernel cilium_tpu/kernels/fused.py::lpm_lookup_fused
// (pallas_call at fused.py:168); the plain torch version is
// cilium_tpu_torch/kernels/lpm.py::lpm_walk_prov_core.
//
// What bounds it on Hopper: latency, not bytes. Each level is a load whose
// address depends on the one before, so a row costs its chain of dependent
// loads (4 levels for v4, 16 for v6 in the trie as compiled), each an L1/L2
// hit at best and a trip to device memory when the trie is larger than L2.
// The design shortens the chain a row pays:
//
// - One loop for both families: each lane starts at its own byte (12 for
//   v4, 0 for v6), so a warp that mixes families runs the longer chain, not
//   the sum of both.
// - The walk reads derived tables (kernels/lpm.py::lpm_derive, built on
//   the card once per trie and cached by the wrapper): 16-byte cells
//   (child, value, meta, run), one vector load a level.
// - It stops where the walk ends: a cell without a child holds -1 when the
//   trie keeps its dead node inert, and no later level can change the
//   result. A trie that breaks the invariant gets the dead node's index
//   there instead, and is walked to full depth as the reference walks it.
//   A warp leaves the loop when its last lane is done.
// - A run of single-child nodes (each with one cell that holds a child and
//   no value, as the zero bytes of a v6 /128) is crossed in one step: the
//   cell before it names the node past the run and the run's length, and
//   the run's bytes (16 bytes a node) load beside the cell past it. A
//   mismatch means the reference walk reaches an inert cell, then the dead
//   node: the row is done. This pays where a level is a trip to L2 or
//   device memory (a v6 trie larger than L2). Where the trie sits in L1,
//   as a v4 trie does, the run's compare costs about the load it saves,
//   and the loop's control more than the early exit saves: a v4-only
//   launch runs a kernel of its own, the 4 levels unrolled over the
//   trie's own planes, and derives nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRunBits = 5;

struct Family {
  const int4* cells;    // [n, 256] (child, value, meta, run)
  const uint4* runs;    // [n] the bytes of the run starting at each node
};

// byte ``pos`` of the address held big-endian in ``w``
__device__ __forceinline__ uint32_t byte_at(uint4 w, int pos) {
  const uint32_t word = pos < 8 ? (pos < 4 ? w.x : w.y)
                                : (pos < 12 ? w.z : w.w);
  return __byte_perm(word, 0u, 0x4440u | (3 - (pos & 3)));
}

// do the address bytes [pos, pos + k) equal the run's bytes? 1 <= pos,
// 1 <= k, pos + k < 16
__device__ __forceinline__ bool run_matches(uint64_t hi, uint64_t lo,
                                            int pos, int k, uint4 r) {
  uint64_t h, l;
  if (pos >= 8) {
    h = lo << (8 * (pos - 8));
    l = 0;
  } else {
    h = (hi << (8 * pos)) | (lo >> (64 - 8 * pos));
    l = lo << (8 * pos);
  }
  const uint64_t eh = (uint64_t(r.x) << 32) | r.y;
  const uint64_t el = (uint64_t(r.z) << 32) | r.w;
  const uint64_t mh = k >= 8 ? ~0ull : ~0ull << (8 * (8 - k));
  const uint64_t ml = k <= 8 ? 0ull : ~0ull << (8 * (16 - k));
  return ((h ^ eh) & mh) == 0 && ((l ^ el) & ml) == 0;
}

// v4 rows alone: the 4 levels unrolled over the trie's own planes
// [n, 256, 3] (child, value, meta); a missing child goes to ``dead``
__global__ void __launch_bounds__(kThreads) lpm_lookup_kernel_v4(
    const uint4* __restrict__ addr_words, const int32_t* __restrict__ planes,
    long long dead, int default_index, long long n,
    int32_t* __restrict__ idx_out, int32_t* __restrict__ meta_out) {
  const long long row = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (row >= n) return;
  const uint4 w = __ldg(addr_words + row);
  long long node = 0;
  int32_t best = default_index, meta = -1;
#pragma unroll
  for (int level = 0; level < 4; ++level) {
    const int32_t* t = planes + (node * 256 + byte_at(w, 12 + level)) * 3;
    // three loads at once: a meta load behind the value test would wait
    // for the value
    const int32_t child = __ldg(t), value = __ldg(t + 1), m = __ldg(t + 2);
    if (value >= 0) {
      best = value;
      meta = m;
    }
    node = child >= 0 ? child : dead;
  }
  idx_out[row] = best;
  meta_out[row] = meta;
}

// both families over the derived tables, one loop per lane
__global__ void __launch_bounds__(kThreads) lpm_lookup_kernel(
    const uint4* __restrict__ addr_words, const uint8_t* __restrict__ is_v6,
    Family f4, Family f6, int default_index, long long n,
    int32_t* __restrict__ idx_out, int32_t* __restrict__ meta_out) {
  const long long row = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (row >= n) return;
  const uint4 w = __ldg(addr_words + row);
  const uint64_t hi = (uint64_t(w.x) << 32) | w.y;
  const uint64_t lo = (uint64_t(w.z) << 32) | w.w;
  const bool v6 = is_v6[row];
  const Family f = v6 ? f6 : f4;
  int pos = v6 ? 0 : 12;
  int4 c = __ldg(f.cells + byte_at(w, pos));       // the root is node 0
  int32_t best = default_index, meta = -1;
  // each step loads one cell and consumes at least one level; the loop
  // stays rolled (16 unrolled steps ran slower)
#pragma unroll 1
  for (int step = 0; step < 16; ++step) {
    if (c.y >= 0) {
      best = c.y;
      meta = c.z;
    }
    if (++pos == 16) break;
    int node = c.x;
    if (node < 0) break;              // the walk ends here
    if (c.w >= 0) {
      const int k = c.w & ((1 << kRunBits) - 1);
      if (pos + k >= 16) break;       // the run covers every level left
      const uint4 r = __ldg(f.runs + node);
      node = c.w >> kRunBits;
      c = __ldg(f.cells + size_t(node) * 256 + byte_at(w, pos + k));
      if (!run_matches(hi, lo, pos, k, r)) break;
      pos += k;
    } else {
      c = __ldg(f.cells + size_t(node) * 256 + byte_at(w, pos));
    }
  }
  idx_out[row] = best;
  meta_out[row] = meta;
}

}  // namespace

// A v4-only launch reads the v4 trie's planes and node count; any other
// reads the derived cells and runs of both tries.
extern "C" int lpm_lookup_launch(const void* addr_words, const void* is_v6,
                                 const void* planes4, long long n4,
                                 const void* cells4, const void* runs4,
                                 const void* cells6, const void* runs6,
                                 int default_index, int v4_only, long long n,
                                 void* idx_out, void* meta_out,
                                 void* stream) {
  if (n <= 0) return 0;
  const auto addr = static_cast<const uint4*>(addr_words);
  const auto idx = static_cast<int32_t*>(idx_out);
  const auto meta = static_cast<int32_t*>(meta_out);
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const auto s = (cudaStream_t)stream;
  if (v4_only) {
    lpm_lookup_kernel_v4<<<blocks, kThreads, 0, s>>>(
        addr, static_cast<const int32_t*>(planes4), n4 - 1, default_index,
        n, idx, meta);
  } else {
    const Family f4{static_cast<const int4*>(cells4),
                    static_cast<const uint4*>(runs4)};
    const Family f6{static_cast<const int4*>(cells6),
                    static_cast<const uint4*>(runs6)};
    lpm_lookup_kernel<<<blocks, kThreads, 0, s>>>(
        addr, static_cast<const uint8_t*>(is_v6), f4, f6, default_index, n,
        idx, meta);
  }
  return (int)cudaGetLastError();
}
