// Embedding bag over the pulled working set, and its backward, for Hopper
// (sm_90a).
//
// Forward:   out[b] = sum_{j: seg[j] == b} w[j] * working[inv[j]]
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding_bag.py
// (embedding_bag_pallas; exact form at :102, one-hot MXU form at :129).
// The TPU version multiplies a one-hot (bags x nnz) block by the gathered
// rows on the matrix unit.  On the GPU that product would read every nnz
// entry once per bag block; instead the entries are grouped by bag once
// (the index streams, built on the card without a sort: build_streams
// below, shared with the backward) and a walk adds each bag's own entries.
//
// Backward (the gradient of the forward's sum; no TPU kernel is replaced:
// the reference's backward is the XLA vjp of its plain version,
// src/repro/kernels/ops.py:113-122):
//
//   g_work[r] = sum_{j: inv[j] == r} w[j] * g[seg[j]]
//   g_w[j]    = sum_d g[seg[j], d] * working[inv[j], d]
//
// g_work is the forward with the roles of inv and seg swapped: a second
// kernel walks the entries grouped by working row (a stable sort of inv)
// and gathers rows of g by seg.  It is written by hand rather than left to
// PyTorch's index ops because their scatter into the working rows adds with
// float atomics, whose order, and so whose bits, change from run to run;
// here every working row adds its entries in ascending original position,
// which makes training on the card reproducible and bit-equal to the
// sequential CPU index_add_ of the plain vjp.  g_w is a second small kernel
// (one warp per entry, a fixed shuffle-tree reduction) that runs only when
// the weights need a gradient.
//
// What bounds all three: bytes.  Per call they move the gathered rows, the
// index and weight streams, and the output rows; the arithmetic is one
// multiply and one add per gathered element.
//
// Design of the forward.  What holds it back is the latency of dependent
// loads more than the bytes: a baidu-ctr bag holds ~2.5 entries (100 ids
// over 40 fields), so each bag is a short chain (offsets -> its (row,
// weight) pairs -> the rows -> the store) and 40,960 such chains make a
// batch.  One extension call does it all, with no sort and no host sync:
//   - the index streams by bag: build_streams keyed by seg (the backward
//     keys it by inv): counts, the scanned offsets, the long bags (more
//     than kLongRow entries) placed by the ordered compaction, the others
//     by an atomic slot and a rank pass.  inv and the weights land in bag
//     order as int32 and float32, so the walk reads a bag's pairs
//     contiguously.  Entries whose seg lies outside [0, num_bags) form the
//     sentinel group, after the last bag, and fall in no bag;
//   - the walk (embedding_bag_walk_kernel): a group of kLanes lanes a bag,
//     several bags a warp (at dim 64, a half-warp a bag, a float4 a lane:
//     one 256-byte row in one load); the group loads up to kLanes of its
//     bag's (row, weight) pairs at once, then the rows of up to kPre
//     entries before it adds any of them, so their loads overlap; the
//     groups are persistent (as many blocks as the card holds) and load
//     the next bag's pairs and the bounds of the bag after it while this
//     bag's rows load, so each bag waits on one trip to memory, not three;
//     the warp's loops run to the longest bag of the warp, so every shuffle
//     finds its whole warp;
//   - the builder's kernels after the first, and the walk, are
//     programmatic dependent launches: each starts while the one before
//     finishes and waits for it on the card (griddepcontrol), which takes
//     a launch's latency off each of the four steps;
//   - each bag adds its entries in ascending original position (the
//     streams' stable order), with __fmul_rn/__fadd_rn so that no
//     multiply-add is contracted: the sum is bit-equal to the sequential
//     CPU segment sum, and two runs give equal bits (no atomics);
//   - every bag row is written, an empty bag as zeros;
//   - a row wider than kTileCols = 256 columns (GIN's input widths, 602 and
//     1433) is added in column tiles of at most 256, one walk launch a tile
//     on the one set of streams, each tile reading its columns of the rows
//     at the row stride; each tile picks its own instantiation, so the
//     float4 path needs the stride and the tile's first column aligned, not
//     just its width.  The tiles of a bag add its entries in the same
//     order, so every column has the bits one wide launch would give.
//
// Design of g_work.  Every working row adds its entries in ascending
// original position, acc = __fadd_rn(acc, __fmul_rn(g[seg[j], c], w[j]))
// (unweighted: acc = __fadd_rn(acc, g[seg[j], c])), so only the adds are a
// chain; the loads of g rows and the multiplies are not, and the design
// takes them off it.  What bounds it: the bytes (6.6 us at the training
// path's pod shapes, PERF.md), and the order: the hottest id holds ~8 % of
// a batch's ids, so one working row adds ~4 k entries, a chain of ~4 k
// dependent adds per column (~8 us at 4 cycles an add), which no bit-exact
// design goes below.
//   - Index streams (build_streams: a memset and four small launches, no
//     sort, no host sync, no copy, in one scratch allocation with
//     everything else).  inv's entries outside [0, working_rows) form a
//     sentinel group after the rows.  Count each group (warp-aggregated
//     atomics); scan the counts into the CSR offsets (a tile a block,
//     decoupled look-back) and put every row with entries on a row list:
//     very long (> kVeryLong = 1024 entries), long (> kLongRow = 128) or
//     short; place each long group (and a long sentinel group) with one
//     block that walks inv in order and compacts its matches (ballots and
//     one prefix sum a round), so its order is the original one, while
//     each entry of a short group takes a slot of its group by an atomic;
//     then each short entry moves to its rank among its group's at most
//     kLongRow slots.  seg and the weights land in that order, so the
//     kernels read them contiguously.  This is the stable order, the same
//     as a stable sort's (a radix sort took ~55 us and a dozen API calls,
//     PERF.md).  What bounds the placement: each long group reads all of
//     inv once, so it costs O(n_long x nnz) reads, one block a group and
//     one group a block at a time over an SM's worth of blocks (132 on the
//     H100); the rows of more than kLongRow entries grow with the batch
//     under Zipf traffic, so this part grows faster than the batch
//     (PERF.md times it at phase 1's batch and at four times it).
//   - Then g_work is zeroed (a memset: rows without entries stay zero) and
//     two kernels run side by side on the caller's stream, so each has its
//     own launch bounds: the short rows' kernel is a programmatic
//     dependent launch that starts while the long rows' runs, and its
//     blocks wait for that one only before they exit (fork and join events
//     between two streams cost more on the device than both kernels' work
//     overlapped).  embedding_bag_backward_long_kernel: one block an SM
//     takes the long-row list's (row, 8 columns) items one at a time from
//     a counter, the very long rows' first, so the hottest row's bytes
//     spread over eight blocks at dim 64 and the blocks done early take the
//     rest (a fixed share of the items a block is 5x slower at four times
//     the training batch, whose long rows outnumber the blocks; PERF.md).
//     Warp 0 adds; warps 1..7 each own one 5 KB slot of a
//     shared-memory ring and fill it with the next 128 entries' g values
//     (cp.async, 4 B a lane, four entries a warp instruction, the segments
//     of the stage after loaded while the copies fly), column by column (a
//     12-float pad keeps both sides free of bank conflicts), multiply them
//     by their weights once they land, and hand the slot over by named
//     barriers (bar.arrive / bar.sync, one full and one empty barrier a
//     slot).  Warp 0 reads four entries of its column as one float4, eight
//     entries ahead of their adds, so its chain waits only on itself with
//     up to seven stages in flight; the launch bounds (two blocks an SM)
//     leave it the registers for that.
//   - embedding_bag_backward_kernel: the short rows' warps walk the
//     short-row list, a row a warp at a time, lanes across dim as in the
//     forward: a row's 32 (segment, weight) pairs load coalesced and the
//     next 32 while these add; the g rows of up to 16 floats a lane load
//     ahead of their adds (64 registers, four blocks an SM, no spills at
//     dim <= 128).
//   - an entry whose segment lies outside [0, num_bags) adds a zero
//     (multiplied by its weight), as the plain vjp does;
//   - every working row is written exactly once, by its adds, or by the
//     memset when it has no entries (pads, the drop row);
//   - past 256 columns the long and the short rows' kernels run once a
//     column tile, as the walk does, on the one set of streams and row
//     lists, each tile with its own next-item counter.
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>


#include "device.h"

namespace {

size_t aligned(size_t bytes) { return (bytes + 255) / 256 * 256; }

// Launches kernel, with `dependent` as a programmatic dependent launch: its
// blocks may start before the kernel before it on the stream has finished,
// and wait for it (griddepcontrol.wait, which every such kernel runs before
// it reads what the one before wrote, and before it exits) instead of the
// launch waiting.
template <typename... Params, typename... Args>
void launch_dependent(bool dependent, void (*kernel)(Params...),
                      unsigned blocks, unsigned threads, cudaStream_t stream,
                      Args&&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = dependent ? 1 : 0;
  cudaLaunchKernelEx(&config, kernel, std::forward<Args>(args)...);
}

// Lets the next kernel on the stream, if it is a programmatic dependent
// launch, start its blocks now (they wait for this grid to finish).
__device__ __forceinline__ void start_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Waits for the grid before this one (a no-op unless this kernel is a
// programmatic dependent launch).
__device__ __forceinline__ void wait_for_prior() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;

// The widest column tile a walk or a backward launch adds; a wider row is
// added tile by tile on the same index streams, each tile's own launch.
// kMaxBagDim in bindings.h caps dim at kTileCols times the tiles' counters
// that the scratch holds.
constexpr int kTileCols = 256;

// The forward's walk: a group of kLanes lanes (a power of two) adds one
// bag, lane l of the group the columns (v * kLanes + l) * kW + [0, kW) for
// v < kVecs, kW floats a load (4: float4, where dim, ld and the pointers
// allow it; else 1).  dim is the width of one column tile, ld the row
// stride of working and out (both start at the tile's first column).  Bag b's entries are inv_sorted / w_sorted [offsets[b],
// offsets[b + 1]).  The groups are persistent: group g walks the bags g,
// g + stride, ..., and while one bag's rows load, the next bag's first
// kLanes (row, weight) pairs and the bounds of the bag after it load too,
// so only the rows' trip is on each bag's path.  A warp's loops run to the
// longest of its groups' bags, so every shuffle finds the whole warp.
template <int kLanes, int kVecs, int kW>
__global__ void __launch_bounds__(kRowsPerBlock * kWarp)
embedding_bag_walk_kernel(const float* __restrict__ working, int dim,
                          int64_t ld,
                          const int32_t* __restrict__ inv_sorted,
                          const float* __restrict__ w_sorted,
                          const int64_t* __restrict__ offsets, int num_bags,
                          float* __restrict__ out) {
  constexpr int kBags = kWarp / kLanes;           // bags a warp walks at once
  // entries whose rows load before any of them adds: 4 loads a lane (a
  // bag holds ~2.5 entries; 8 measured no faster and took more registers)
  constexpr int kPre = kVecs >= 4 ? 1 : 4 / kVecs;
  const int lane = threadIdx.x % kWarp;
  const int sub = lane % kLanes;
  const int64_t warp_first =
      (static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp)
      * kBags;
  const int64_t stride =
      static_cast<int64_t>(gridDim.x) * kRowsPerBlock * kBags;
  // the streams are the kernel before this one's output
  wait_for_prior();

  // a bag's bounds (an empty range past the last bag), and its entry i's
  // (row, weight) pair (row 0 and 1 past its end)
  auto bounds = [&](int64_t bag, int64_t& begin, int64_t& end) {
    begin = end = 0;
    if (bag < num_bags) {
      begin = offsets[bag];
      end = offsets[bag + 1];
    }
  };
  auto pair = [&](int64_t begin, int64_t end, int64_t i, int32_t& row,
                  float& w) {
    row = 0;
    w = 1.0f;
    if (begin + i < end) {
      row = inv_sorted[begin + i];
      if (w_sorted != nullptr) w = w_sorted[begin + i];
    }
  };

  int64_t bag = warp_first + lane / kLanes;
  int64_t begin, end, next_begin, next_end;
  int32_t row0;
  float w0;
  bounds(bag, begin, end);
  pair(begin, end, sub, row0, w0);
  bounds(bag + stride, next_begin, next_end);
  for (int64_t b0 = warp_first; b0 < num_bags; b0 += stride) {  // warp-wide
    // in flight while this bag adds: the next bag's first pairs and the
    // bounds of the bag after it
    int32_t next_row0;
    float next_w0;
    int64_t after_begin, after_end;
    pair(next_begin, next_end, sub, next_row0, next_w0);
    bounds(bag + 2 * stride, after_begin, after_end);

    const int n = static_cast<int>(end - begin);
    const int n_warp = __reduce_max_sync(0xffffffffu, n);
    float acc[kVecs][kW];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
#pragma unroll
      for (int e = 0; e < kW; ++e) acc[v][e] = 0.0f;
    }
    for (int base = 0; base < n_warp; base += kLanes) {
      // the group's kLanes (row, weight) pairs from entry base on, one a
      // lane (the first kLanes came with the bag)
      int32_t my_row = row0;
      float my_w = w0;
      if (base > 0) pair(begin, end, base + sub, my_row, my_w);
      const int m = n_warp - base < kLanes ? n_warp - base : kLanes;
      for (int t0 = 0; t0 < m; t0 += kPre) {  // warp-uniform
        // all the loads first, so they overlap; the adds below keep the
        // entries' order.  A lane past its bag's end loads nothing.
        float x[kPre][kVecs][kW];
        unsigned ok_mask = 0;
#pragma unroll
        for (int t = 0; t < kPre; ++t) {
          const int64_t row =
              __shfl_sync(0xffffffffu, my_row, (t0 + t) % kLanes, kLanes);
          const bool ok = t0 + t < m && base + t0 + t < n;
          ok_mask |= static_cast<unsigned>(ok) << t;
          const float* src = working + row * ld;
#pragma unroll
          for (int v = 0; v < kVecs; ++v) {
            const int c = (v * kLanes + sub) * kW;
            if constexpr (kW == 4) {
              float4 y = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              if (ok && c < dim) y = *reinterpret_cast<const float4*>(src + c);
              x[t][v][0] = y.x;
              x[t][v][1] = y.y;
              x[t][v][2] = y.z;
              x[t][v][3] = y.w;
            } else {
              x[t][v][0] = ok && c < dim ? src[c] : 0.0f;
            }
          }
        }
#pragma unroll
        for (int t = 0; t < kPre; ++t) {
          const float w =
              __shfl_sync(0xffffffffu, my_w, (t0 + t) % kLanes, kLanes);
          if ((ok_mask >> t) & 1u) {
#pragma unroll
            for (int v = 0; v < kVecs; ++v) {
#pragma unroll
              for (int e = 0; e < kW; ++e) {
                float y = x[t][v][e];
                if (w_sorted != nullptr) y = __fmul_rn(y, w);
                acc[v][e] = __fadd_rn(acc[v][e], y);
              }
            }
          }
        }
      }
    }
    if (bag < num_bags) {
      float* dst = out + bag * ld;
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        const int c = (v * kLanes + sub) * kW;
        if (c >= dim) continue;
        if constexpr (kW == 4) {
          *reinterpret_cast<float4*>(dst + c) =
              make_float4(acc[v][0], acc[v][1], acc[v][2], acc[v][3]);
        } else {
          dst[c] = acc[v][0];
        }
      }
    }
    bag += stride;
    begin = next_begin;
    end = next_end;
    row0 = next_row0;
    w0 = next_w0;
    next_begin = after_begin;
    next_end = after_end;
  }
}

// ---- the index streams: a stable order of the entries by a key, without a
// sort (build_streams).  The backward keys them by inv (a group a working
// row) and carries seg; the forward keys them by seg (a group a bag) and
// carries inv.  Both carry the weights.

// Groups of more than kLongRow entries are long: the placement compacts
// their entries in order, and the backward's long rows' kernel adds them.
// Those of more than kVeryLong are very long and handed out first.
constexpr int kLongRow = 128;
constexpr int kVeryLong = 1024;

// The row lists that build_streams writes and the kernels read: [the count
// of groups of more than kVeryLong entries, the count of the other groups
// of more than kLongRow entries, kLongRow, the count of the groups of 1 to
// kLongRow entries; then room for max_long long groups, the very long ones
// from the front and the others from the back; then room for nnz short
// groups (listed only where the caller asks: the forward walks every bag
// and needs no short list)].  Each part is in no fixed order: the lists
// decide only which block or warp adds a group, never how.
constexpr int kListHead = 4;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;        // counts a scan thread takes per round
constexpr int kPlaceThreads = 1024;
constexpr int kPlaceBallots = 16;    // a compacting warp's ballots a round

// The group of entry j: its key, or groups (the sentinel group, last) when
// keys[j] lies outside [0, groups).
__device__ __forceinline__ int group_of(const int32_t* keys, int64_t j,
                                        int groups) {
  const int32_t r = keys[j];
  return r >= 0 && r < groups ? r : groups;
}

// counts[k] = the entries of group k, k in [0, groups] (zeroed before).
// Thread 0 also clears the row lists' counts.
__global__ void stream_count_kernel(const int32_t* __restrict__ keys,
                                    int64_t nnz, int groups,
                                    int32_t* __restrict__ counts,
                                    int32_t* __restrict__ long_rows) {
  start_dependents();
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j == 0) long_rows[0] = long_rows[1] = long_rows[3] = 0;
  const bool ok = j < nnz;
  const unsigned active = __ballot_sync(0xffffffffu, ok);
  if (!ok) return;
  const int k = group_of(keys, j, groups);
  const unsigned peers = __match_any_sync(active, k);  // one atomic a group
  if (static_cast<int>(threadIdx.x % kWarp) == __ffs(peers) - 1) {
    atomicAdd(counts + k, __popc(peers));
  }
}

// Exclusive prefix sum of v over a block of blockDim.x threads (a multiple
// of 32, at most 1024); *total gets the block's sum.  sh: 32 ints.
__device__ __forceinline__ int block_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  int x = v;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == kWarp - 1) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    sh[lane] = s;
  }
  __syncthreads();
  const int pre = (warp > 0 ? sh[warp - 1] : 0) + x - v;
  *total = sh[warps - 1];
  __syncthreads();  // sh is free again
  return pre;
}

// A tile of kScanThreads * items ints in shared memory, padded by one int
// every 32 so that a thread's run of consecutive items reads free of bank
// conflicts; loads and stores go through it coalesced.
__device__ __forceinline__ int pad32(int i) { return i + i / kWarp; }

// offsets[k] = the entries of groups before k, for k in [0, groups], a
// tile of counts a block (taken in launch order from *next_tile), its
// prefix found by a decoupled look-back over the tiles before it (status:
// 0 not out yet, 1 << 32 | the tile's sum, 2 << 32 | the sum up to and
// with it); each long group, and with list_short each short one with
// entries, goes on its row list by an atomic append.
__global__ void __launch_bounds__(kScanThreads) stream_scan_kernel(
    const int32_t* __restrict__ counts, int groups, int max_long,
    bool list_short, int* __restrict__ next_tile,
    unsigned long long* __restrict__ status, int64_t* __restrict__ offsets,
    int32_t* __restrict__ long_rows) {
  constexpr int kTile = kScanThreads * kScanItems;
  __shared__ int tile[kTile + kTile / kWarp];
  __shared__ int sh[kWarp];
  __shared__ int tile_id, tile_prefix;
  wait_for_prior();       // the counts
  start_dependents();
  if (threadIdx.x == 0) tile_id = atomicAdd(next_tile, 1);
  __syncthreads();
  const int t = tile_id;
  const int64_t n = static_cast<int64_t>(groups) + 1;
  const int64_t base = static_cast<int64_t>(t) * kTile;
#pragma unroll
  for (int u = 0; u < kScanItems; ++u) {
    const int i = u * kScanThreads + threadIdx.x;
    tile[pad32(i)] = base + i < n ? counts[base + i] : 0;
  }
  __syncthreads();
  const int i0 = threadIdx.x * kScanItems;
  int c[kScanItems];
  int sum = 0;
#pragma unroll
  for (int u = 0; u < kScanItems; ++u) {
    c[u] = tile[pad32(i0 + u)];
    sum += c[u];
    const int64_t k = base + i0 + u;
    if (k < groups && c[u] > kVeryLong) {
      long_rows[kListHead + atomicAdd(long_rows, 1)] = static_cast<int>(k);
    } else if (k < groups && c[u] > kLongRow) {
      long_rows[kListHead + max_long - 1 - atomicAdd(long_rows + 1, 1)] =
          static_cast<int>(k);
    } else if (list_short && k < groups && c[u] > 0) {
      long_rows[kListHead + max_long + atomicAdd(long_rows + 3, 1)] =
          static_cast<int>(k);
    }
  }
  int total;
  int at = block_scan(sum, sh, &total);
  if (threadIdx.x < kWarp) {
    // warp 0 looks back 32 tiles at a time: it sums the aggregates up to
    // the nearest tile whose full prefix is out, once all of them are
    const int lane = threadIdx.x;
    if (lane == 0 && t > 0) {
      atomicExch(status + t, (1ull << 32) | static_cast<unsigned>(total));
    }
    int prefix = 0;
    for (int top = t - 1; top >= 0;) {
      const int i = top - lane;
      const unsigned long long v =
          i >= 0 ? *reinterpret_cast<volatile unsigned long long*>(status + i)
                 : 2ull << 32;
      const int flag = static_cast<int>(v >> 32);
      const unsigned full = __ballot_sync(0xffffffffu, flag == 2);
      const unsigned ready = __ballot_sync(0xffffffffu, flag != 0);
      const int stop = full != 0 ? __ffs(full) - 1 : kWarp - 1;
      const unsigned need =
          stop == kWarp - 1 ? 0xffffffffu : (2u << stop) - 1u;
      if ((ready & need) != need) continue;  // not all out yet: look again
      int part = lane <= stop && i >= 0
                     ? static_cast<int>(v & 0xffffffffull) : 0;
#pragma unroll
      for (int o = kWarp / 2; o > 0; o /= 2) {
        part += __shfl_down_sync(0xffffffffu, part, o);
      }
      prefix += __shfl_sync(0xffffffffu, part, 0);
      if (full != 0) break;
      top -= kWarp;
    }
    if (lane == 0) {
      atomicExch(status + t,
                 (2ull << 32) | static_cast<unsigned>(prefix + total));
      tile_prefix = prefix;
      if (t == 0) long_rows[2] = kLongRow;
    }
  }
  __syncthreads();
  at += tile_prefix;
#pragma unroll
  for (int u = 0; u < kScanItems; ++u) {
    tile[pad32(i0 + u)] = at;
    at += c[u];
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kScanItems; ++u) {
    const int i = u * kScanThreads + threadIdx.x;
    if (base + i < n) offsets[base + i] = tile[pad32(i)];
  }
}

// Group k's entries (k long, or the sentinel group) written in ascending
// original position from sorted position `at` on.  The whole block walks
// the keys in rounds of kPlaceThreads * kPlaceBallots entries: warp w's lanes
// read entries u * kPlaceThreads + w * 32 + lane (coalesced) for u <
// kPlaceBallots and ballot their matches; one prefix sum over the (u, w) counts, in that
// order, is the order of the entries, and each match goes to its prefix
// plus its rank in its ballot.
__device__ void compact_group(const int32_t* __restrict__ keys,
                              const int32_t* __restrict__ vals,
                              const float* __restrict__ w, int64_t nnz,
                              int groups, int k, int at, int* counts_uw,
                              int* sh, int32_t* __restrict__ keys_sorted,
                              int32_t* __restrict__ vals_sorted,
                              float* __restrict__ w_sorted) {
  constexpr int kRound = kPlaceThreads * kPlaceBallots;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const unsigned below = (1u << lane) - 1u;
  for (int64_t base = 0; base < nnz; base += kRound) {
    unsigned hits[kPlaceBallots];
#pragma unroll
    for (int u = 0; u < kPlaceBallots; ++u) {
      const int64_t j = base + u * kPlaceThreads + warp * kWarp + lane;
      hits[u] = __ballot_sync(0xffffffffu,
                              j < nnz && group_of(keys, j, groups) == k);
    }
    if (lane < kPlaceBallots) {
      // lane u of warp w holds the count of (u, w): in (u, w) order the
      // block's first threads then hold consecutive counts
      int c = 0;
#pragma unroll
      for (int u = 0; u < kPlaceBallots; ++u) {
        c = lane == u ? __popc(hits[u]) : c;
      }
      counts_uw[lane * (kPlaceThreads / kWarp) + warp] = c;
    }
    __syncthreads();
    int total;
    const int n_uw = kPlaceBallots * (kPlaceThreads / kWarp);
    const int pre = block_scan(
        static_cast<int>(threadIdx.x) < n_uw ? counts_uw[threadIdx.x] : 0, sh,
        &total);
    if (static_cast<int>(threadIdx.x) < n_uw) counts_uw[threadIdx.x] = pre;
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPlaceBallots; ++u) {
      if ((hits[u] >> lane) & 1u) {
        const int64_t j = base + u * kPlaceThreads + warp * kWarp + lane;
        const int pos = at + counts_uw[u * (kPlaceThreads / kWarp) + warp] +
                        __popc(hits[u] & below);
        keys_sorted[pos] = k;
        vals_sorted[pos] = vals[j];
        if (w != nullptr) w_sorted[pos] = w[j];
      }
    }
    at += total;
    __syncthreads();  // counts_uw is free again
  }
}

// The first place_blocks blocks compact the long groups (the list's rows,
// then the sentinel group if it is long), a block a group at a time; the
// others give each entry of a short group a slot of its group (in no
// order yet: tmp holds its position j) and its key.
__global__ void __launch_bounds__(kPlaceThreads) stream_place_kernel(
    const int32_t* __restrict__ keys, const int32_t* __restrict__ vals,
    const float* __restrict__ w, int64_t nnz, int groups,
    const int32_t* __restrict__ counts, const int64_t* __restrict__ offsets,
    const int32_t* __restrict__ long_rows, int max_long, int place_blocks,
    int32_t* __restrict__ fill, int32_t* __restrict__ tmp,
    int32_t* __restrict__ keys_sorted, int32_t* __restrict__ vals_sorted,
    float* __restrict__ w_sorted) {
  __shared__ int counts_uw[kPlaceThreads];
  __shared__ int sh[kWarp];
  wait_for_prior();       // the offsets and the row lists
  start_dependents();
  if (static_cast<int>(blockIdx.x) < place_blocks) {
    const int n_very = long_rows[0];
    const int n_long = n_very + long_rows[1];
    const int n_groups = n_long + (counts[groups] > kLongRow ? 1 : 0);
    for (int q = blockIdx.x; q < n_groups; q += place_blocks) {
      const int k = q < n_very ? long_rows[kListHead + q]
                    : q < n_long
                        ? long_rows[kListHead + max_long - 1 - (q - n_very)]
                        : groups;
      compact_group(keys, vals, w, nnz, groups, k,
                    static_cast<int>(offsets[k]), counts_uw, sh,
                    keys_sorted, vals_sorted, w_sorted);
    }
    return;
  }
  const int64_t j =
      static_cast<int64_t>(blockIdx.x - place_blocks) * kPlaceThreads +
      threadIdx.x;
  if (j >= nnz) return;
  const int k = group_of(keys, j, groups);
  if (counts[k] > kLongRow) return;
  const int pos = static_cast<int>(offsets[k]) + atomicAdd(fill + k, 1);
  tmp[pos] = static_cast<int32_t>(j);
  keys_sorted[pos] = k;
}

// Each entry of a short group moves to its rank in ascending original
// position among its group's (at most kLongRow) entries.
__global__ void stream_rank_kernel(const int32_t* __restrict__ vals,
                                   const float* __restrict__ w, int64_t nnz,
                                   const int32_t* __restrict__ counts,
                                   const int64_t* __restrict__ offsets,
                                   const int32_t* __restrict__ tmp,
                                   const int32_t* __restrict__ keys_sorted,
                                   int32_t* __restrict__ vals_sorted,
                                   float* __restrict__ w_sorted) {
  wait_for_prior();       // the placed entries
  start_dependents();
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (q >= nnz) return;
  const int k = keys_sorted[q];
  const int c = counts[k];
  if (c > kLongRow) return;
  const int start = static_cast<int>(offsets[k]);
  const int j = tmp[q];
  int p = start;
  for (int i = start; i < start + c; ++i) p += tmp[i] < j;
  vals_sorted[p] = vals[j];
  if (w != nullptr) w_sorted[p] = w[j];
}

// ---- the working-row gradient

// The long rows' path: a block of 256 threads adds kSlice columns of one
// working row.  Warp 0 adds; warps 1..kProducers each own one slot of a
// shared-memory ring and fill it, a stage of kStage entries at a time.
constexpr int kSlice = 8;                        // columns a long block adds
constexpr int kSub = kWarp / kSlice;             // entries a warp copies at once
constexpr int kStage = kWarp * kSub;             // entries a slot holds
constexpr int kProducers = kRowsPerBlock - 1;
// A slot holds column c of its kStage entries at c * kColStride (so warp
// 0's lane c reads four entries as one float4; the stride's 12-float pad
// keeps those reads and the producers' 4 B copies free of bank conflicts),
// then the kStage weights, each part padded for warp 0's read-ahead.
constexpr int kColStride = kStage + 12;
constexpr int kSlotW = kSlice * kColStride;                 // weights' offset
constexpr int kSlotFloats = kSlotW + kStage + 8;
constexpr int kRingBytes = kProducers * kSlotFloats * 4;
constexpr int kLongBlocksPerSm = 1;   // blocks an SM that walk each list
constexpr int kShortBlocksPerSm = 3;

// The hand-over of slot k between its producer warp and warp 0, for the
// ring's stage s, by named barriers: full at 1 + k, empty at
// 1 + kProducers + k (ids 1..14; 0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(2 * kWarp) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(2 * kWarp) : "memory");
}

// warp 0 waits until stage s is in slot k
__device__ __forceinline__ void wait_full(int k) { bar_sync(1 + k); }

// warp 0 is done with stage s in slot k (the producer waits for that only
// if it fills the slot again)
__device__ __forceinline__ void release(int k, int s, int stages) {
  if (s + kProducers < stages) bar_arrive(1 + kProducers + k);
}

// producer k waits until slot k's last stage (s - kProducers) is added
__device__ __forceinline__ void wait_empty(int k, int s) {
  if (s >= kProducers) bar_sync(1 + kProducers + k);
}

// producer k has staged stage s in slot k (its copies have landed)
__device__ __forceinline__ void publish(int k) { bar_arrive(1 + k); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float add4(float acc, float4 x) {
  acc = __fadd_rn(acc, x.x);
  acc = __fadd_rn(acc, x.y);
  acc = __fadd_rn(acc, x.z);
  return __fadd_rn(acc, x.w);
}

// Warp 0's adds of one stage of m entries, lane c's column xs (the
// producers have multiplied the weights in).  A full stage reads eight
// entries (two float4) one step ahead of their adds, so only the adds
// wait on each other.
__device__ __forceinline__ float add_stage(float acc, const float* xs,
                                           int m) {
  if (m == kStage) {
    float4 x0 = lds4(xs), x1 = lds4(xs + 4);
#pragma unroll 8
    for (int t = 0; t < kStage; t += 8) {
      // the pad holds what the last step reads ahead
      const float4 y0 = lds4(xs + t + 8), y1 = lds4(xs + t + 12);
      acc = add4(add4(acc, x0), x1);
      x0 = y0;
      x1 = y1;
    }
  } else {
    for (int t = 0; t < m; ++t) acc = __fadd_rn(acc, xs[t]);
  }
  return acc;
}

// Columns [col0, col0 + kSlice) of g_work[r] (of a tile dim columns wide;
// g's rows are ld apart): the entries [begin, end) of
// the streams sorted by working row, added in order by warp 0 from the
// ring while the producer warps stage the next ones (g rows gathered by
// seg, 4 B cp.async copies, kSub entries a warp instruction; an entry
// outside g stages a zero, which is then multiplied by its weight).
__device__ __forceinline__ void long_row_slice(
    const float* __restrict__ g, int64_t num_bags, int dim, int64_t ld,
    const int32_t* __restrict__ seg_sorted,
    const float* __restrict__ w_sorted, int64_t begin, int64_t end,
    int col0, float* __restrict__ dst, float* ring) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int sub = lane / kSlice;
  const int col = col0 + lane % kSlice;
  const bool weighted = w_sorted != nullptr;
  const int64_t n = end - begin;
  const int stages = static_cast<int>((n + kStage - 1) / kStage);

  if (warp == 0) {
    float acc = 0.0f;
    for (int s = 0; s < stages; ++s) {
      const int k = s % kProducers;
      const float* xs = ring + k * kSlotFloats + (lane % kSlice) * kColStride;
      const int64_t left = n - static_cast<int64_t>(s) * kStage;
      const int m = static_cast<int>(left < kStage ? left : kStage);
      wait_full(k);
      acc = add_stage(acc, xs, m);
      release(k, s, stages);
    }
    if (sub == 0 && col < dim) dst[col] = acc;
    return;
  }

  const int k = warp - 1;
  float* slot = ring + k * kSlotFloats;
  float* sw = slot + kSlotW;
  // this warp's stages are k, k + kProducers, ...; lane l holds the
  // (segment, weight) of entries l, l + 32, ... of its next stage, loaded
  // while the copies of the current one are in flight
  int32_t b[kSub];
  float w[kSub];
  auto fetch = [&](int s) {
    const int64_t base = begin + static_cast<int64_t>(s) * kStage;
#pragma unroll
    for (int q = 0; q < kSub; ++q) {
      const int64_t i = base + q * kWarp + lane;
      b[q] = -1;
      w[q] = 1.0f;
      if (s < stages && i < end) {
        b[q] = seg_sorted[i];
        if (weighted) w[q] = w_sorted[i];
      }
    }
  };
  fetch(k);
  for (int s = k; s < stages; s += kProducers) {
    wait_empty(k, s);
    const int64_t left = n - static_cast<int64_t>(s) * kStage;
    const int m = static_cast<int>(left < kStage ? left : kStage);
#pragma unroll
    for (int q = 0; q < kSub; ++q) {
      if (q * kWarp + lane < m) sw[q * kWarp + lane] = w[q];
    }
#pragma unroll
    for (int t = 0; t < kStage; t += kSub) {
      const int e = t + sub;                        // this lane's entry
      const int64_t bt = __shfl_sync(0xffffffffu, b[t / kWarp], e % kWarp);
      if (e < m && col < dim) {
        float* d = slot + (lane % kSlice) * kColStride + e;
        if (bt >= 0 && bt < num_bags) {
          cp_async4(d, g + bt * ld + col);
        } else {
          *d = 0.0f;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    fetch(s + kProducers);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    if (weighted) {
      // the multiplies are off warp 0's chain too: each lane scales the
      // values it copied by their weights (staged above) before handing over
      __syncwarp();
#pragma unroll
      for (int t = 0; t < kStage; t += kSub) {
        const int e = t + sub;
        if (e < m && col < dim) {
          float* d = slot + (lane % kSlice) * kColStride + e;
          *d = __fmul_rn(*d, sw[e]);
        }
      }
    }
    publish(k);
  }
}

// The rows of the long-row list (g_work is zeroed before): the list's
// (row, kSlice columns) items of one column tile (dim columns; g and
// g_work start at its first column, their rows ld apart), the very long
// rows' first, each block taking the next item from *next_item (zeroed
// before) when it is done with its last.  Its own launch bounds leave
// warp 0 the registers to read ahead of its chain of adds.
__global__ void __launch_bounds__(kRowsPerBlock * kWarp, 2)
embedding_bag_backward_long_kernel(
    const float* __restrict__ g, int64_t num_bags, int dim, int64_t ld,
    const int32_t* __restrict__ seg_sorted,
    const float* __restrict__ w_sorted, const int64_t* __restrict__ offsets,
    const int32_t* __restrict__ long_rows, int max_long,
    int* __restrict__ next_item, float* __restrict__ g_work) {
  extern __shared__ __align__(16) float ring[];
  __shared__ int item;
  // the short rows' kernel, launched after this one, may start now
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int slices = (dim + kSlice - 1) / kSlice;
  const int very = long_rows[0];
  const int items = (very + long_rows[1]) * slices;
  for (;;) {
    if (threadIdx.x == 0) item = atomicAdd(next_item, 1);
    __syncthreads();
    const int it = item;
    if (it >= items) break;  // the whole block together
    const int q = it / slices;
    const int r = long_rows[kListHead + (q < very ? q
                                         : max_long - 1 - (q - very))];
    long_row_slice(g, num_bags, dim, ld, seg_sorted, w_sorted, offsets[r],
                   offsets[r + 1], (it - q * slices) * kSlice,
                   g_work + static_cast<int64_t>(r) * ld, ring);
    __syncthreads();  // the ring and `item` are free for the next item
  }
}

// The rows of the short-row list: warp i of the grid walks the list's rows
// i, i + (its warps), ..., lanes across the dim columns of one column tile
// as in the forward (g and g_work start at its first column, their rows ld
// apart).
template <int kColsPerLane>
__global__ void __launch_bounds__(kRowsPerBlock * kWarp, 4)
embedding_bag_backward_kernel(
    const float* __restrict__ g, int64_t num_bags, int dim, int64_t ld,
    const int32_t* __restrict__ seg_sorted,
    const float* __restrict__ w_sorted, const int64_t* __restrict__ offsets,
    const int32_t* __restrict__ long_rows, int max_long,
    float* __restrict__ g_work) {
  // entries whose g rows load ahead of their adds: 16 floats a lane
  constexpr int kPre = kColsPerLane >= 16 ? 1 : 16 / kColsPerLane;
  const int lane = threadIdx.x % kWarp;
  const int n_short = long_rows[3];
  const int* short_rows = long_rows + kListHead + max_long;
  const int stride = gridDim.x * kRowsPerBlock;
  for (int q = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
       q < n_short; q += stride) {  // whole warps together
  const int64_t r = short_rows[q];
  const int64_t begin = offsets[r];
  const int64_t end = offsets[r + 1];

  float acc[kColsPerLane];
#pragma unroll
  for (int v = 0; v < kColsPerLane; ++v) acc[v] = 0.0f;
  int32_t next_b = -1;
  float next_w = 1.0f;
  if (begin + lane < end) {
    next_b = seg_sorted[begin + lane];
    if (w_sorted != nullptr) next_w = w_sorted[begin + lane];
  }
  for (int64_t base = begin; base < end; base += kWarp) {
    const int n = static_cast<int>(end - base < kWarp ? end - base : kWarp);
    const int32_t my_b = next_b;
    const float my_w = next_w;
    // the next batch's (row, weight) pairs load while this batch adds
    next_b = -1;
    next_w = 1.0f;
    if (base + kWarp + lane < end) {
      next_b = seg_sorted[base + kWarp + lane];
      if (w_sorted != nullptr) next_w = w_sorted[base + kWarp + lane];
    }
#pragma unroll
    for (int t0 = 0; t0 < kWarp; t0 += kPre) {
      if (t0 >= n) break;  // warp-uniform
      // all the loads first, so they overlap; the adds below keep the
      // entries' order.  The loads are unconditional, from an address
      // that is always valid (row 0, the last column), and an entry that
      // lies outside g or the batch is zeroed at its add: a load under a
      // condition would have to land before the next one issues.  The
      // inner loops do not break early, so they unroll fully and x stays
      // in registers.
      float x[kPre][kColsPerLane];
      unsigned ok_mask = 0;
#pragma unroll
      for (int t = 0; t < kPre; ++t) {
        const int64_t b = __shfl_sync(0xffffffffu, my_b, t0 + t);
        const bool ok = t0 + t < n && b >= 0 && b < num_bags;
        ok_mask |= static_cast<unsigned>(ok) << t;
        const float* row = g + (ok ? b : 0) * ld;
#pragma unroll
        for (int v = 0; v < kColsPerLane; ++v) {
          const int c = lane + v * kWarp;
          x[t][v] = row[c < dim ? c : dim - 1];
        }
      }
#pragma unroll
      for (int t = 0; t < kPre; ++t) {
        const float w = __shfl_sync(0xffffffffu, my_w, t0 + t);
        if (t0 + t < n) {  // warp-uniform
          const bool ok = (ok_mask >> t) & 1u;
#pragma unroll
          for (int v = 0; v < kColsPerLane; ++v) {
            float xv = ok ? x[t][v] : 0.0f;
            if (w_sorted != nullptr) xv = __fmul_rn(xv, w);
            acc[v] = __fadd_rn(acc[v], xv);
          }
        }
      }
    }
  }

  float* dst = g_work + r * ld;
#pragma unroll
  for (int v = 0; v < kColsPerLane; ++v) {
    const int c = lane + v * kWarp;
    if (c < dim) dst[c] = acc[v];
  }
  }
  // a block leaves only once the long rows' kernel (launched before this
  // one, which may have started early) has finished: whatever follows on
  // the stream then sees every row of g_work
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The walk: as many blocks as the card holds at once (persistent groups),
// or fewer where the bags are fewer; a programmatic dependent launch.
template <int kLanes, int kVecs, int kW>
void launch_walk(const float* working, int dim, int64_t ld,
                 const int32_t* inv_sorted, const float* w_sorted,
                 const int64_t* offsets, int num_bags, float* out,
                 cudaStream_t stream) {
  constexpr int kBagsPerBlock = kRowsPerBlock * (kWarp / kLanes);
  auto* kernel = embedding_bag_walk_kernel<kLanes, kVecs, kW>;
  static int per_sm = 0;   // an instantiation's blocks an SM holds
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  kRowsPerBlock * kWarp, 0);
    if (per_sm <= 0) per_sm = 1;
  }
  const int needed = (num_bags + kBagsPerBlock - 1) / kBagsPerBlock;
  const int blocks = needed < per_sm * sm_count() ? needed
                                                  : per_sm * sm_count();
  launch_dependent(true, kernel, blocks, kRowsPerBlock * kWarp, stream,
                   working, dim, ld, inv_sorted, w_sorted, offsets,
                   num_bags, out);
}

// The walk over column tiles of at most kTileCols columns, one launch a
// tile on the same streams, each tile's instantiation by its width: float4
// loads where the tile's width and the row stride are multiples of 4 and
// both tiles' first columns are 16-byte aligned (kLanes lanes cover the
// tile, at most 32, then two float4 a lane), else a float a load, a warp a
// bag.  A bag adds its entries in the same order in every tile, so each
// column's sum is the one a single tile would give.  At dim <= kTileCols
// this is one launch with the row stride dim.
void walk(const float* working, int dim, const int32_t* inv_sorted,
          const float* w_sorted, const int64_t* offsets, int num_bags,
          float* out, cudaStream_t stream) {
  for (int col0 = 0; col0 < dim; col0 += kTileCols) {
    const int tw = dim - col0 < kTileCols ? dim - col0 : kTileCols;
    const float* src = working + col0;
    float* dst = out + col0;
    const bool vec = tw % 4 == 0 && dim % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dst) % 16 == 0;
    auto* run = vec ? (tw <= 16    ? &launch_walk<4, 1, 4>
                       : tw <= 32  ? &launch_walk<8, 1, 4>
                       : tw <= 64  ? &launch_walk<16, 1, 4>
                       : tw <= 128 ? &launch_walk<32, 1, 4>
                                   : &launch_walk<32, 2, 4>)
                    : (tw <= 32    ? &launch_walk<32, 1, 1>
                       : tw <= 64  ? &launch_walk<32, 2, 1>
                       : tw <= 128 ? &launch_walk<32, 4, 1>
                                   : &launch_walk<32, 8, 1>);
    run(src, tw, dim, inv_sorted, w_sorted, offsets, num_bags, dst, stream);
  }
}

// One column tile (dim columns; g and g_work start at its first column,
// their rows ld apart) of g_work, which is zeroed before: the long rows'
// kernel, then the short rows' beside it.  next_item is the tile's own
// counter.
template <int kColsPerLane>
void launch_backward(const float* g, int64_t num_bags, int dim, int64_t ld,
                     const int32_t* seg_sorted, const float* w_sorted,
                     const int64_t* offsets, const int32_t* long_rows,
                     int max_long, int* next_item, float* g_work,
                     cudaStream_t stream) {
  const int sms = sm_count();
  if (max_long > 0) {
    embedding_bag_backward_long_kernel<<<kLongBlocksPerSm * sms,
                                         kRowsPerBlock * kWarp, kRingBytes,
                                         stream>>>(
        g, num_bags, dim, ld, seg_sorted, w_sorted, offsets, long_rows,
        max_long, next_item, g_work);
  }
  // a programmatic dependent launch: the short rows' kernel starts while
  // the long rows' runs (its blocks wait for it only before they exit)
  launch_dependent(max_long > 0, embedding_bag_backward_kernel<kColsPerLane>,
                   kShortBlocksPerSm * sms, kRowsPerBlock * kWarp, stream, g,
                   num_bags, dim, ld, seg_sorted, w_sorted, offsets,
                   long_rows, max_long, g_work);
}

// g_w[j] = <g[seg[j]], working[inv[j]]>: one warp per entry.  Lane l adds
// columns l, l + 32, ... in ascending order, then a fixed shuffle tree
// (offsets 16, 8, 4, 2, 1) adds the 32 partial sums; the order never
// depends on the run.
constexpr int kEntriesPerBlock = 8;

__global__ void bag_weight_grad_kernel(
    const float* __restrict__ g, int64_t num_bags, int dim,
    const int32_t* __restrict__ seg, const float* __restrict__ working,
    int64_t working_rows, const int32_t* __restrict__ inv, int64_t nnz,
    float* __restrict__ g_w) {
  const int lane = threadIdx.x % kWarp;
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * kEntriesPerBlock + threadIdx.x / kWarp;
  if (j >= nnz) return;  // whole warps leave together
  const int64_t b = seg[j];
  const int64_t r = inv[j];
  float acc = 0.0f;
  if (b >= 0 && b < num_bags && r >= 0 && r < working_rows) {
    const float* gb = g + b * dim;
    const float* wr = working + r * dim;
    for (int c = lane; c < dim; c += kWarp) {
      acc = __fadd_rn(acc, __fmul_rn(gb[c], wr[c]));
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  if (lane == 0) g_w[j] = acc;
}

// Tiles of counts the scan takes.
size_t scan_tiles(int groups) {
  const size_t n = static_cast<size_t>(groups) + 1;
  constexpr size_t kTile = static_cast<size_t>(kScanThreads) * kScanItems;
  return (n + kTile - 1) / kTile;
}

// The most groups of more than kLongRow entries that nnz entries can make.
int64_t max_long_rows(int64_t nnz) { return nnz / (kLongRow + 1); }

// The byte offsets of the streams' scratch parts, each 256-byte aligned,
// in this order: vals_sorted, keys_sorted, w_sorted (weighted only),
// offsets, the row lists (what build_streams hands the kernels and the
// bindings hand back), then the groups' counts and fills, the counters
// (the scan's next tile, the long rows' next item of each column tile:
// 64 ints, so at most 63 tiles) and the scan's
// look-back words (these four cleared by one memset), the short groups'
// unordered positions, and the end.
enum Part { kVals, kKeys, kW, kOffsets, kLists, kCounts, kFill, kCounters,
            kStatus, kTmp, kEnd, kParts };

void scratch_layout(int64_t nnz, int groups, bool weighted,
                    size_t at[kParts]) {
  const size_t n4 = aligned(static_cast<size_t>(nnz) * 4);
  const size_t groups1 = static_cast<size_t>(groups) + 1;
  const size_t groups4 = aligned(groups1 * 4);
  const size_t sizes[kParts - 1] = {
      n4, n4, weighted ? n4 : 0, aligned(groups1 * 8),
      aligned(static_cast<size_t>(kListHead + max_long_rows(nnz) + nnz) * 4),
      groups4, groups4, 256, aligned(scan_tiles(groups) * 8), n4};
  at[0] = 0;
  for (int i = 0; i + 1 < kParts; ++i) at[i + 1] = at[i] + sizes[i];
}

// The streams sorted by key, in a memset and four launches, with no host
// sync: count the groups, scan the counts (the offsets and the row lists;
// the short groups listed only with list_short), place the long groups by
// an ordered compaction and scatter the short groups' entries, then order
// each short group by rank.  vals and w land in that order.  The last
// three are programmatic dependent launches.
void build_streams(const int32_t* keys, const int32_t* vals, const float* w,
                   int64_t nnz, int groups, bool list_short, char* scratch,
                   const size_t at[kParts], cudaStream_t stream) {
  auto part = [&](Part k) { return scratch + at[k]; };
  auto* keys_sorted = reinterpret_cast<int32_t*>(part(kKeys));
  auto* vals_sorted = reinterpret_cast<int32_t*>(part(kVals));
  auto* w_sorted = w != nullptr ? reinterpret_cast<float*>(part(kW))
                                : nullptr;
  auto* offsets = reinterpret_cast<int64_t*>(part(kOffsets));
  auto* lists = reinterpret_cast<int32_t*>(part(kLists));
  auto* counts = reinterpret_cast<int32_t*>(part(kCounts));
  auto* fill = reinterpret_cast<int32_t*>(part(kFill));
  auto* next_tile = reinterpret_cast<int*>(part(kCounters));
  auto* status = reinterpret_cast<unsigned long long*>(part(kStatus));
  auto* tmp = reinterpret_cast<int32_t*>(part(kTmp));
  const int max_long = static_cast<int>(max_long_rows(nnz));
  cudaMemsetAsync(counts, 0, at[kTmp] - at[kCounts], stream);
  constexpr int kThreads = 256;
  const unsigned entry_blocks =
      static_cast<unsigned>((nnz + kThreads - 1) / kThreads);
  stream_count_kernel<<<entry_blocks > 0 ? entry_blocks : 1, kThreads, 0,
                        stream>>>(keys, nnz, groups, counts, lists);
  launch_dependent(true, stream_scan_kernel,
                   static_cast<unsigned>(scan_tiles(groups)), kScanThreads,
                   stream, counts, groups, max_long, list_short, next_tile,
                   status, offsets, lists);
  if (nnz > 0) {
    const int place_blocks = sm_count();
    const unsigned scatter_blocks = static_cast<unsigned>(
        (nnz + kPlaceThreads - 1) / kPlaceThreads);
    launch_dependent(true, stream_place_kernel, place_blocks + scatter_blocks,
                     kPlaceThreads, stream, keys, vals, w, nnz, groups,
                     counts, offsets, lists, max_long, place_blocks, fill,
                     tmp, keys_sorted, vals_sorted, w_sorted);
    launch_dependent(true, stream_rank_kernel, entry_blocks, kThreads, stream,
                     vals, w, nnz, counts, offsets, tmp, keys_sorted,
                     vals_sorted, w_sorted);
  }
}

}  // namespace

// The bindings check every shape before they call these: dim lies in
// [1, kMaxBagDim] (bindings.h: 8192, 32 column tiles), the row counts are
// positive and below 2^31.  `weights` may be null (unweighted bag).

// The scratch bytes of the index streams of nnz entries over `groups`
// keys; at[0..4] get the byte offsets of the streams left there:
// vals_sorted, keys_sorted, w_sorted (weighted only), offsets, the row
// lists.
size_t streams_scratch_bytes(int64_t nnz, int groups, bool weighted,
                             size_t streams_at[5]) {
  size_t at[kParts];
  scratch_layout(nnz, groups, weighted, at);
  for (int i = 0; i < 5; ++i) streams_at[i] = at[i];
  return at[kEnd];
}

// out[b] = sum over j with seg[j] == b of w[j] * working[inv[j]], every
// bag written: the streams by bag in `scratch` (streams_scratch_bytes with
// num_bags groups: inv and w gathered into bag order, offsets[b] for b in
// [0, num_bags], the entries outside [0, num_bags) last), then the walk.
// With out null only the streams are built.
cudaError_t launch_embedding_bag(const float* working, int dim,
                                 const int32_t* inv, const int32_t* seg,
                                 const float* w, int64_t nnz, int num_bags,
                                 void* scratch, float* out,
                                 cudaStream_t stream) {
  size_t at[kParts];
  scratch_layout(nnz, num_bags, w != nullptr, at);
  char* base = static_cast<char*>(scratch);
  build_streams(seg, inv, w, nnz, num_bags, false, base, at, stream);
  if (out != nullptr) {
    walk(working, dim, reinterpret_cast<const int32_t*>(base + at[kVals]),
         w != nullptr ? reinterpret_cast<const float*>(base + at[kW])
                      : nullptr,
         reinterpret_cast<const int64_t*>(base + at[kOffsets]), num_bags,
         out, stream);
  }
  return cudaGetLastError();
}

// The walk alone on given streams (inv_sorted, w_sorted or null, offsets
// of num_bags + 1 entries).
cudaError_t launch_embedding_bag_walk(const float* working, int dim,
                                      const int32_t* inv_sorted,
                                      const float* w_sorted,
                                      const int64_t* offsets, int num_bags,
                                      float* out, cudaStream_t stream) {
  walk(working, dim, inv_sorted, w_sorted, offsets, num_bags, out, stream);
  return cudaGetLastError();
}

// The row lists' length in ints, for nnz entries.
int64_t backward_list_ints(int64_t nnz) {
  return kListHead + max_long_rows(nnz) + nnz;
}

// g_work[r] = sum over j with inv[j] == r of w[j] * g[seg[j]], every row
// written: the streams by working row in `scratch`
// (streams_scratch_bytes with working_rows groups; keys_sorted: inv, the
// entries outside [0, working_rows) as working_rows, last; seg and w
// gathered into that order; offsets[r] for r in [0, working_rows]; the row
// lists), then g_work zeroed by a memset and the long rows' kernel with
// the short rows' beside it.  With g_work null only the streams are built.
cudaError_t launch_embedding_bag_backward(
    const float* g, int64_t num_bags, int dim, const int32_t* inv,
    const int32_t* seg, const float* w, int64_t nnz, int working_rows,
    void* scratch, float* g_work, cudaStream_t stream) {
  size_t at[kParts];
  scratch_layout(nnz, working_rows, w != nullptr, at);
  char* base = static_cast<char*>(scratch);
  build_streams(inv, seg, w, nnz, working_rows, true, base, at, stream);
  if (g_work != nullptr) {
    const auto* seg_sorted =
        reinterpret_cast<const int32_t*>(base + at[kVals]);
    const auto* w_sorted =
        w != nullptr ? reinterpret_cast<const float*>(base + at[kW]) : nullptr;
    const auto* offsets = reinterpret_cast<const int64_t*>(base + at[kOffsets]);
    const auto* lists = reinterpret_cast<const int32_t*>(base + at[kLists]);
    const int max_long = static_cast<int>(max_long_rows(nnz));
    // the counters' first int is the scan's; each tile's next item follows
    auto* next_item = reinterpret_cast<int*>(base + at[kCounters]) + 1;
    cudaMemsetAsync(g_work, 0,
                    static_cast<size_t>(working_rows) * dim * sizeof(float),
                    stream);
    for (int col0 = 0; col0 < dim; col0 += kTileCols) {
      const int tw = dim - col0 < kTileCols ? dim - col0 : kTileCols;
      auto* run = tw <= 32    ? &launch_backward<1>
                  : tw <= 64  ? &launch_backward<2>
                  : tw <= 128 ? &launch_backward<4>
                              : &launch_backward<8>;
      run(g + col0, num_bags, tw, dim, seg_sorted, w_sorted, offsets, lists,
          max_long, next_item + col0 / kTileCols, g_work + col0, stream);
    }
  }
  return cudaGetLastError();
}

void launch_embedding_bag_weight_grad(const float* g, int64_t num_bags,
                                      int dim, const int32_t* seg,
                                      const float* working,
                                      int64_t working_rows,
                                      const int32_t* inv, int64_t nnz,
                                      float* g_w, cudaStream_t stream) {
  const int64_t blocks = (nnz + kEntriesPerBlock - 1) / kEntriesPerBlock;
  bag_weight_grad_kernel<<<static_cast<unsigned>(blocks),
                           kEntriesPerBlock * kWarp, 0, stream>>>(
      g, num_bags, dim, seg, working, working_rows, inv, nnz, g_w);
}
