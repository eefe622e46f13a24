// Embedding bag over the pulled working set, and its backward, for Hopper
// (sm_90a).
//
// Forward:   out[b] = sum_{j: seg[j] == b} w[j] * working[inv[j]]
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding_bag.py
// (embedding_bag_pallas; exact form at :102, one-hot MXU form at :129).
// The TPU version multiplies a one-hot (bags x nnz) block by the gathered
// rows on the matrix unit.  On the GPU that product would read every nnz
// entry once per bag block; instead the wrapper sorts the entries by bag
// once (a stable sort of seg gives `order` and the CSR `offsets`), and this
// kernel walks each bag's own entries.
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
// Design of the forward:
//   - one warp per bag, eight bags per 256-thread block;
//   - lanes span dim: lane l owns columns l, l + 32, ... (two f32 per lane
//     at dim 64), so every gathered row is read as coalesced 128-byte
//     segments;
//   - the lanes first load up to 32 of the bag's (row, weight) pairs in
//     parallel and then broadcast them with __shfl_sync, so the dependent
//     order -> inv -> row chain is paid once per 32 entries;
//   - each bag adds its entries in ascending original position (the stable
//     sort keeps it), with __fmul_rn/__fadd_rn so that no multiply-add is
//     contracted: the sum is bit-equal to the sequential CPU segment sum,
//     and two runs give equal bits (no atomics);
//   - every bag row is written, an empty bag as zeros.
//
// Design of g_work: the same walk, one warp per working row, with two
// changes for the Zipf-hot rows.  The hottest id holds ~8 % of a batch's
// ids, so one working row gathers thousands of entries, and its sum is a
// chain of dependent adds in a fixed order that one warp must walk alone:
//   - the wrapper gathers seg and the weights into the row-sorted order, so
//     the lanes read 32 (row, weight) pairs coalesced, and the next 32 load
//     while these are added;
//   - a batch of more than 8 entries loads all its g rows into registers
//     first (up to 32 at dim <= 64) and only then adds them in order, so
//     the memory latencies overlap instead of adding up.  The hottest row
//     still sets the kernel's time: its one warp walks ~4 k entries in
//     order (PERF.md);
//   - an entry whose segment lies outside [0, num_bags) adds a zero, as
//     the plain vjp does;
//   - every working row is written, untouched ones (pads, the drop row) as
//     zeros.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;

template <int kColsPerLane>
__global__ void embedding_bag_kernel(
    const float* __restrict__ working, int dim,
    const int32_t* __restrict__ inv, const float* __restrict__ weights,
    const int64_t* __restrict__ order, const int64_t* __restrict__ offsets,
    int num_bags, float* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  const int bag = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (bag >= num_bags) return;  // whole warps leave together
  const int64_t begin = offsets[bag];
  const int64_t end = offsets[bag + 1];

  float acc[kColsPerLane];
#pragma unroll
  for (int v = 0; v < kColsPerLane; ++v) acc[v] = 0.0f;

  for (int64_t base = begin; base < end; base += kWarp) {
    const int n = static_cast<int>(end - base < kWarp ? end - base : kWarp);
    int64_t my_row = 0;
    float my_w = 1.0f;
    if (lane < n) {
      const int64_t j = order[base + lane];
      my_row = inv[j];
      if (weights != nullptr) my_w = weights[j];
    }
    for (int t = 0; t < n; ++t) {
      const int64_t row = __shfl_sync(0xffffffffu, my_row, t);
      const float w = __shfl_sync(0xffffffffu, my_w, t);
      const float* src = working + row * dim;
#pragma unroll
      for (int v = 0; v < kColsPerLane; ++v) {
        const int c = lane + v * kWarp;
        if (c < dim) {
          float x = src[c];
          if (weights != nullptr) x = __fmul_rn(x, w);
          acc[v] = __fadd_rn(acc[v], x);
        }
      }
    }
  }

  float* dst = out + static_cast<int64_t>(bag) * dim;
#pragma unroll
  for (int v = 0; v < kColsPerLane; ++v) {
    const int c = lane + v * kWarp;
    if (c < dim) dst[c] = acc[v];
  }
}

// Entries of a batch that g_work adds one at a time; longer batches load
// their rows ahead.
constexpr int kFew = 8;

template <int kColsPerLane>
__global__ void embedding_bag_backward_kernel(
    const float* __restrict__ g, int64_t num_bags, int dim,
    const int32_t* __restrict__ seg_sorted,
    const float* __restrict__ w_sorted, const int64_t* __restrict__ offsets,
    int working_rows, float* __restrict__ g_work) {
  // rows loaded ahead of their adds: up to 32 at dim <= 64, fewer at wider
  // dims, so the buffer stays at 64 floats a lane
  constexpr int kPre = kColsPerLane <= 2 ? kWarp : 64 / kColsPerLane;
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (r >= working_rows) return;  // whole warps leave together
  const int64_t begin = offsets[r];
  const int64_t end = offsets[r + 1];

  float acc[kColsPerLane];
#pragma unroll
  for (int v = 0; v < kColsPerLane; ++v) acc[v] = 0.0f;

  int64_t next_b = -1;
  float next_w = 1.0f;
  if (begin + lane < end) {
    next_b = seg_sorted[begin + lane];
    if (w_sorted != nullptr) next_w = w_sorted[begin + lane];
  }
  for (int64_t base = begin; base < end; base += kWarp) {
    const int n = static_cast<int>(end - base < kWarp ? end - base : kWarp);
    const int64_t my_b = next_b;
    const float my_w = next_w;
    // the next batch's (row, weight) pairs load while this batch adds
    next_b = -1;
    next_w = 1.0f;
    if (base + kWarp + lane < end) {
      next_b = seg_sorted[base + kWarp + lane];
      if (w_sorted != nullptr) next_w = w_sorted[base + kWarp + lane];
    }
    if (n <= kFew) {  // warp-uniform
      for (int t = 0; t < n; ++t) {
        const int64_t b = __shfl_sync(0xffffffffu, my_b, t);
        const float w = __shfl_sync(0xffffffffu, my_w, t);
        const bool ok = b >= 0 && b < num_bags;
#pragma unroll
        for (int v = 0; v < kColsPerLane; ++v) {
          const int c = lane + v * kWarp;
          if (c < dim) {
            float x = ok ? g[b * dim + c] : 0.0f;
            if (w_sorted != nullptr) x = __fmul_rn(x, w);
            acc[v] = __fadd_rn(acc[v], x);
          }
        }
      }
      continue;
    }
#pragma unroll
    for (int t0 = 0; t0 < kWarp; t0 += kPre) {
      if (t0 >= n) break;  // warp-uniform
      // all the loads first, so they overlap; the adds below keep the
      // entries' order.  The loads are unconditional, from an address
      // that is always valid (row 0, the last column), and an entry that
      // lies outside g is zeroed at its add: a load under a condition
      // would have to land before the next one issues.
      float x[kPre][kColsPerLane];
      unsigned ok_mask = 0;
#pragma unroll
      for (int t = 0; t < kPre; ++t) {
        const int64_t b = __shfl_sync(0xffffffffu, my_b, t0 + t);
        const bool ok = t0 + t < n && b >= 0 && b < num_bags;
        ok_mask |= static_cast<unsigned>(ok) << t;
        const float* row = g + (ok ? b : 0) * dim;
#pragma unroll
        for (int v = 0; v < kColsPerLane; ++v) {
          const int c = lane + v * kWarp;
          x[t][v] = row[c < dim ? c : dim - 1];
        }
      }
#pragma unroll
      for (int t = 0; t < kPre; ++t) {
        if (t0 + t >= n) break;  // warp-uniform
        const float w = __shfl_sync(0xffffffffu, my_w, t0 + t);
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

  float* dst = g_work + static_cast<int64_t>(r) * dim;
#pragma unroll
  for (int v = 0; v < kColsPerLane; ++v) {
    const int c = lane + v * kWarp;
    if (c < dim) dst[c] = acc[v];
  }
}

template <int kColsPerLane>
void launch_forward(const float* working, int dim, const int32_t* inv,
                    const float* weights, const int64_t* order,
                    const int64_t* offsets, int num_bags, float* out,
                    cudaStream_t stream) {
  const int blocks = (num_bags + kRowsPerBlock - 1) / kRowsPerBlock;
  embedding_bag_kernel<kColsPerLane>
      <<<blocks, kRowsPerBlock * kWarp, 0, stream>>>(
          working, dim, inv, weights, order, offsets, num_bags, out);
}

template <int kColsPerLane>
void launch_backward(const float* g, int64_t num_bags, int dim,
                     const int32_t* seg_sorted, const float* w_sorted,
                     const int64_t* offsets, int working_rows, float* g_work,
                     cudaStream_t stream) {
  const int blocks = (working_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  embedding_bag_backward_kernel<kColsPerLane>
      <<<blocks, kRowsPerBlock * kWarp, 0, stream>>>(
          g, num_bags, dim, seg_sorted, w_sorted, offsets, working_rows,
          g_work);
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

}  // namespace

// The bindings check every shape before they call these: dim lies in
// [1, 256], the row counts are positive and below 2^31.  `weights` may be
// null (unweighted bag).

// out[b] = sum over order[offsets[b]:offsets[b+1]] of w[j] * working[inv[j]].
void launch_embedding_bag(const float* working, int dim, const int32_t* inv,
                          const float* weights, const int64_t* order,
                          const int64_t* offsets, int num_bags, float* out,
                          cudaStream_t stream) {
  if (dim <= 32) {
    launch_forward<1>(working, dim, inv, weights, order, offsets, num_bags,
                      out, stream);
  } else if (dim <= 64) {
    launch_forward<2>(working, dim, inv, weights, order, offsets, num_bags,
                      out, stream);
  } else if (dim <= 128) {
    launch_forward<4>(working, dim, inv, weights, order, offsets, num_bags,
                      out, stream);
  } else {
    launch_forward<8>(working, dim, inv, weights, order, offsets, num_bags,
                      out, stream);
  }
}

// g_work[r] = sum over i in [offsets[r], offsets[r+1]) of w[i] * g[seg[i]],
// with seg and w gathered into the order of a stable sort by working row.
void launch_embedding_bag_backward(const float* g, int64_t num_bags, int dim,
                                   const int32_t* seg_sorted,
                                   const float* w_sorted,
                                   const int64_t* offsets, int working_rows,
                                   float* g_work, cudaStream_t stream) {
  if (dim <= 32) {
    launch_backward<1>(g, num_bags, dim, seg_sorted, w_sorted, offsets,
                       working_rows, g_work, stream);
  } else if (dim <= 64) {
    launch_backward<2>(g, num_bags, dim, seg_sorted, w_sorted, offsets,
                       working_rows, g_work, stream);
  } else if (dim <= 128) {
    launch_backward<4>(g, num_bags, dim, seg_sorted, w_sorted, offsets,
                       working_rows, g_work, stream);
  } else {
    launch_backward<8>(g, num_bags, dim, seg_sorted, w_sorted, offsets,
                       working_rows, g_work, stream);
  }
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
