// The in-place AdaGrad push for Hopper (sm_90a):
//
//   table[uids[i]] += delta[i];  accum[uids[i]] += g2[i]   (every real i)
//
// Replaces the Pallas TPU kernel src/repro/kernels/sparse_adagrad.py
// (sparse_adagrad_apply_pallas, pallas_call at :127).  As there, the
// AdaGrad arithmetic is done once, outside, by adagrad_row_updates (shared
// with the plain version), and this kernel only adds two loads: the result
// is bit-equal to the plain index_add_ scatter.
//
// Contract on `uids`: laid out as pull_working_set lays them out, i.e. the
// real ids strictly ascending, then (when the batch has fewer distinct ids
// than the capacity) pads that repeat uids[0] up to the end; an overflowed
// batch has no pads.  The pads carry delta = -0.0 and g2 = +0.0 (no id slot
// maps to a pad position, so its gradient is zero).
//
// Duplicate rows race on the GPU.  The TPU kernel walks its grid in
// reverse, one step at a time, so the pads run first and the real row
// last.  Here the rows run in parallel, and a pad and the real uids[0]
// would read-add-write the same row at the same time, so one update could
// be lost.  The kernel therefore skips every position i > 0 with
// uids[i] <= uids[i-1]: exactly the pads.  Skipping is bit-exact, because
// x + (-0.0) == x for every x and the accumulator is never -0.0.  A uid
// outside [0, rows) is skipped too (the reference's scatter drops it).
//
// What bounds it: bytes.  Per real row it reads the table row, the
// accumulator row, delta and g2, and writes the two rows back (6 x 4 x dim
// bytes), plus the uid stream; there is one add per element.
//
// Design: one warp per uid position, eight per 256-thread block; lanes span
// dim (coalesced 128-byte rows at dim 32k).  Every table offset is int64_t:
// at 50 M rows x 64, uid * dim reaches 3.2e9.  The tensors are updated in
// place; nothing of table size is allocated.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kUidsPerBlock = 8;

__global__ void sparse_adagrad_apply_kernel(
    float* __restrict__ table, float* __restrict__ accum, int64_t rows,
    int dim, const int32_t* __restrict__ uids, int64_t cap,
    const float* __restrict__ delta, const float* __restrict__ g2) {
  const int lane = threadIdx.x % kWarp;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kUidsPerBlock + threadIdx.x / kWarp;
  if (i >= cap) return;  // whole warps leave together
  const int64_t u = uids[i];
  if (i > 0 && u <= static_cast<int64_t>(uids[i - 1])) return;  // a pad
  if (u < 0 || u >= rows) return;
  float* t = table + u * dim;
  float* a = accum + u * dim;
  const float* d = delta + i * dim;
  const float* s = g2 + i * dim;
  for (int c = lane; c < dim; c += kWarp) {
    t[c] = __fadd_rn(t[c], d[c]);
    a[c] = __fadd_rn(a[c], s[c]);
  }
}

}  // namespace

// The binding checks every shape before it calls this; cap >= 1.
void launch_sparse_adagrad_apply(float* table, float* accum, int64_t rows,
                                 int dim, const int32_t* uids, int64_t cap,
                                 const float* delta, const float* g2,
                                 cudaStream_t stream) {
  const int64_t blocks = (cap + kUidsPerBlock - 1) / kUidsPerBlock;
  sparse_adagrad_apply_kernel<<<static_cast<unsigned>(blocks),
                                kUidsPerBlock * kWarp, 0, stream>>>(
      table, accum, rows, dim, uids, cap, delta, g2);
}
