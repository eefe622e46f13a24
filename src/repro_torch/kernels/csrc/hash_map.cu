// The cache tier's batch hash probe for Hopper (sm_90a):
//
//   slots[i] = s   if the map holds (uids[i], s) and slot_uid[s] == uids[i]
//            = -1  otherwise
//
// Replaces the Pallas TPU kernel src/repro/kernels/hash_map.py
// (hash_lookup_pallas, pallas_call at :197).  The map is open addressing
// with linear probing over H (a power of two) buckets: key_tab[b] holds an
// id or EMPTY (-1), slot_tab[b] the cache slot it was admitted to.  The
// home bucket is the 32-bit murmur3 finalizer of the id, masked to H - 1.
// A probe walks from the home bucket until it finds the id (at most one
// bucket holds it) or an EMPTY bucket; a found entry is live only if
// slot_uid of its slot still names the id (eviction kills entries by
// overwriting slot_uid, not the map).
//
// The TPU kernel runs one grid step per id, one after the other, over the
// whole map in VMEM.  Here each thread probes one id, and the GPU's 132
// SMs run tens of thousands of probes at once; the map (2^20 buckets x 8 B
// at the slice's cache) lies in device memory and L2.
//
// What bounds it: bytes, and the latency of dependent loads.  Per id it
// reads the id, one (key, slot) pair per probe (the chains are short: the
// map is at most 3/4 full and usually near 1/4), one slot_uid entry on a
// hit, and writes one int32.  There is no arithmetic to speak of.
//
// Design: one thread per id, 256 threads per block; the murmur mix in
// uint32_t wraps exactly as the reference's uint32 arithmetic.  slot_uid
// is read only when key_tab[b] holds the id, and a slot outside [0, C)
// counts as not live, so a broken map cannot read out of bounds; the loop
// is bounded at H probes, so a map with no EMPTY bucket cannot hang the
// card.  The output is an integer, bit-equal to the plain version
// (ref.hash_lookup_ref).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kEmpty = -1;

__device__ __forceinline__ uint32_t murmur_mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void hash_lookup_kernel(const int32_t* __restrict__ key_tab,
                                   const int32_t* __restrict__ slot_tab,
                                   int64_t n_buckets,
                                   const int32_t* __restrict__ slot_uid,
                                   int64_t n_slots,
                                   const int32_t* __restrict__ uids,
                                   int64_t n, int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t u = uids[i];
  const uint32_t mask = static_cast<uint32_t>(n_buckets - 1);
  uint32_t b = murmur_mix(static_cast<uint32_t>(u)) & mask;
  int32_t slot = -1;
  for (int64_t probe = 0; probe < n_buckets; ++probe) {
    const int32_t k = key_tab[b];
    if (k == u) {
      const int32_t s = slot_tab[b];
      if (s >= 0 && s < n_slots && slot_uid[s] == u) slot = s;
      break;
    }
    if (k == kEmpty) break;
    b = (b + 1) & mask;
  }
  out[i] = slot;
}

}  // namespace

// The binding checks every shape before it calls this; n >= 1, n_buckets a
// power of two <= 2^31.
void launch_hash_lookup(const int32_t* key_tab, const int32_t* slot_tab,
                        int64_t n_buckets, const int32_t* slot_uid,
                        int64_t n_slots, const int32_t* uids, int64_t n,
                        int32_t* out, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  hash_lookup_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      key_tab, slot_tab, n_buckets, slot_uid, n_slots, uids, n, out);
}
