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
// whole map in VMEM.  Here the GPU's 132 SMs run all the probes of a batch
// at once; the map (2^20 buckets x 8 B at the slice's cache) lies in
// device memory and L2.
//
// What bounds it: the card's rate of random reads from a cold L2, and the
// latency of each id's chain of dependent loads, not bytes.  Per id it
// reads the id, the buckets of its chain (short: the map is at most 3/4
// full and usually near 1/4), on a hit one slot_tab and one slot_uid word,
// and writes one int32: 65,536 ids move ~1.3 MB, 0.4 us at the HBM's rate,
// but each random 4-byte read costs the memory a whole sector, and each id
// is a chain of trips to HBM (id -> keys -> slot -> slot_uid -> store).
//
// Design (each choice the faster of the two measured, PERF.md):
//   - one id a thread (two or four ids a thread, their loads interleaved,
//     were slower: fewer threads hide the trips worse);
//   - a step reads a whole aligned group of kGroup buckets of key_tab (an
//     int4 where H >= 4 and key_tab is 16-byte aligned; else a bucket a
//     step), so most chains end in one load; the chain goes on to the next
//     group (wrapping from H - 1 to 0) until the id or an EMPTY bucket is
//     seen, and stops after H buckets, so a map with no EMPTY bucket cannot
//     hang the card (the id is a miss, as in the plain version);
//   - slot_tab is read only for the bucket that holds the id (reading each
//     group's slots with its keys saves a hit one trip but costs every id a
//     second random sector, and was slower);
//   - slot_uid is read only for a found entry whose slot lies in [0, C), so
//     a broken map cannot read out of bounds; the entry is live if
//     slot_uid[s] still names the id;
//   - the murmur mix in uint32_t wraps exactly as the reference's uint32
//     arithmetic.  The output is an integer, bit-equal to the plain version
//     (ref.hash_lookup_ref).
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

// The aligned group of kGroup keys at p.
template <int kGroup>
__device__ __forceinline__ void load_group(const int32_t* p,
                                           int32_t (&v)[kGroup]) {
  if constexpr (kGroup == 4) {
    const int4 x = *reinterpret_cast<const int4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    v[0] = *p;
  }
}

template <int kGroup>
__global__ void __launch_bounds__(kThreads) hash_lookup_kernel(
    const int32_t* __restrict__ key_tab, const int32_t* __restrict__ slot_tab,
    int64_t n_buckets, const int32_t* __restrict__ slot_uid, int64_t n_slots,
    const int32_t* __restrict__ uids, int64_t n, int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t u = uids[i];
  const uint32_t mask = static_cast<uint32_t>(n_buckets - 1);
  uint32_t b = murmur_mix(static_cast<uint32_t>(u)) & mask;
  int64_t left = n_buckets;   // buckets the chain may still examine
  int64_t at = -1;            // the bucket that holds u
  for (bool more = true; more;) {
    int32_t keys[kGroup];
    const uint32_t a = b & ~static_cast<uint32_t>(kGroup - 1);
    load_group<kGroup>(key_tab + a, keys);
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      if (!more || q < static_cast<int>(b - a)) continue;
      if (left == 0) {
        more = false;         // H buckets seen: a miss
      } else if (keys[q] == u) {
        at = a + q;
        more = false;
      } else if (keys[q] == kEmpty) {
        more = false;         // the end of the chain: a miss
      } else {
        --left;
      }
    }
    b = (a + kGroup) & mask;
  }
  int32_t slot = -1;
  if (at >= 0) {
    const int32_t s = slot_tab[at];
    if (s >= 0 && s < n_slots && slot_uid[s] == u) slot = s;
  }
  out[i] = slot;
}

}  // namespace

// The binding checks every shape before it calls this; n >= 1, n_buckets a
// power of two <= 2^31.  Whole groups of 4 keys are read where the map has
// them and key_tab is 16-byte aligned, else one key a step.
cudaError_t launch_hash_lookup(const int32_t* key_tab,
                               const int32_t* slot_tab, int64_t n_buckets,
                               const int32_t* slot_uid, int64_t n_slots,
                               const int32_t* uids, int64_t n, int32_t* out,
                               cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const bool vec = n_buckets >= 4 &&
                   reinterpret_cast<uintptr_t>(key_tab) % 16 == 0;
  auto* kernel = vec ? &hash_lookup_kernel<4> : &hash_lookup_kernel<1>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      key_tab, slot_tab, n_buckets, slot_uid, n_slots, uids, n, out);
  return cudaGetLastError();
}
