// Flow fingerprints: for every row, hash(forward CT key) ^ hash(reverse CT
// key) of the row's tuple as it arrived (before the service LB's DNAT), as
// the u32 bit pattern in an int32. Both directions of a flow get the same
// fingerprint. It equals shim/feeder.py::flow_hashes bit for bit; the plain
// torch version is cilium_tpu_torch/kernels/fused.py::flow_fingerprint_plain.
//
// It replaces no TPU kernel: the reference computes these fingerprints on
// the host, in numpy, when the engine's finalize stamps its established-
// flow table (EstablishedFingerprints.note, the CT-salvage note). There
// they cost about a hundred whole-array passes over each batch on the one
// thread that finalizes every batch. The classify step already holds the
// rows on the card, so it computes them here, once a dispatch, and the
// finalize only stamps the table with them.
//
// What bounds it on Hopper, and what the design does about it:
// - Bytes: a row reads 48 bytes (src and dst, 16 each; sport, dport,
//   proto and direction, 4 each) and writes 4, so 3.4 MB at 65,536 rows,
//   about 1 us at 3.35 TB/s. The ~200 integer operations of the two
//   hashes cost less than the loads. At these sizes the launch bounds it.
// - One thread a row: neighbouring threads read neighbouring rows, so the
//   address words come in as coalesced 16-byte loads and the 4-byte
//   columns as coalesced 4-byte loads, each read once (read-only path).
// - The hash is ct_hash.cuh's, the one K2 hashes CT keys with.
// - No shared memory, no table, nothing reused between rows.

#include <cstdint>
#include <cuda_runtime.h>

#include "ct_hash.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint64_t pair(uint32_t lo, uint32_t hi) {
  return static_cast<uint64_t>(lo) | (static_cast<uint64_t>(hi) << 32);
}

__global__ void flow_fingerprint_kernel(const uint4* __restrict__ src,
                                        const uint4* __restrict__ dst,
                                        const uint32_t* __restrict__ sport,
                                        const uint32_t* __restrict__ dport,
                                        const uint32_t* __restrict__ proto,
                                        const uint32_t* __restrict__ dir,
                                        long long n,
                                        int32_t* __restrict__ fp_out) {
  const long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint4 s = __ldg(src + row);
  const uint4 d = __ldg(dst + row);
  const uint32_t sp = __ldg(sport + row);
  const uint32_t dp = __ldg(dport + row);
  const uint32_t pr = __ldg(proto + row) << 8;
  const uint32_t di = __ldg(dir + row);
  // records.ct_key_words: src words, dst words, sport << 16 | dport,
  // proto << 8 | direction; the reverse swaps the ends and takes
  // 1 - direction (all u32 arithmetic, as numpy's)
  const uint64_t fwd[cthash::kKeyPairs] = {
      pair(s.x, s.y), pair(s.z, s.w), pair(d.x, d.y), pair(d.z, d.w),
      pair((sp << 16) | dp, pr | di)};
  const uint64_t rev[cthash::kKeyPairs] = {
      pair(d.x, d.y), pair(d.z, d.w), pair(s.x, s.y), pair(s.z, s.w),
      pair((dp << 16) | sp, pr | (1u - di))};
  fp_out[row] = static_cast<int32_t>(cthash::hash_words10(fwd) ^
                                     cthash::hash_words10(rev));
}

}  // namespace

extern "C" int flow_fingerprint_launch(const void* src, const void* dst,
                                       const void* sport, const void* dport,
                                       const void* proto,
                                       const void* direction, long long n,
                                       void* fp_out, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  flow_fingerprint_kernel<<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(
      static_cast<const uint4*>(src), static_cast<const uint4*>(dst),
      static_cast<const uint32_t*>(sport),
      static_cast<const uint32_t*>(dport),
      static_cast<const uint32_t*>(proto),
      static_cast<const uint32_t*>(direction), n,
      static_cast<int32_t*>(fp_out));
  return (int)cudaGetLastError();
}
