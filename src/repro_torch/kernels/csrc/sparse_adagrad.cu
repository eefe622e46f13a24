// The in-place AdaGrad pushes and the cached row gather for Hopper
// (sm_90a):
//
//   push:         table[uids[i]] += delta[i];  accum[uids[i]] += g2[i]
//   cached push:  cache[slots[i]] += delta[i]; cache_accum[slots[i]] += g2[i]
//                 (every real i)
//   cached gather: out[i] = cache_rows[slots[i]]
//   staged push:  rows += delta(accum, g); accum += g*g   (elementwise over
//                 the pulled (C, D) rows; the row math in the kernel)
//
// Replace the Pallas TPU kernels of src/repro/kernels/sparse_adagrad.py:
// sparse_adagrad_apply_pallas (pallas_call at :127),
// sparse_adagrad_cached_apply_pallas (:166) and gather_rows_cached_pallas
// (:194).  The two pushes share one kernel body under two index streams:
// the row of position i is uids[i] (the table) or slots[i] (the device
// cache, the hash probe's output); the pad test below reads the uids in
// both, because a slot order is not ascending.  As there, the
// AdaGrad arithmetic is done once, outside, by adagrad_row_updates (shared
// with the plain version), and the pushes only add two loads: the result
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
// In the cached push the pads' slots repeat slots[0] (the first id's
// slot), so the same uid test finds them; a slot outside [0, C) is
// skipped.
//
// What bounds the pushes: bytes.  Per real row they read the table row, the
// accumulator row, delta and g2, and write the two rows back (6 x 4 x dim
// bytes), plus the uid (and slot) stream; there is one add per element.
// The cached push's rows are the cache's, so it behaves like the table
// push on a (C, dim) table.
//
// Design: one warp per uid position, eight per 256-thread block; lanes span
// dim (coalesced 128-byte rows at dim 32k).  Every table offset is int64_t:
// at 50 M rows x 64, uid * dim reaches 3.2e9.  The tensors are updated in
// place; nothing of table size is allocated.
//
// The cached gather is pure data movement (bytes: one cache row read and
// one row written per position, plus the slot stream): one warp per output
// row, 64-bit row offsets, and 16-byte loads and stores (float4) when dim
// is a multiple of 4 and both tensors are 16-byte aligned, else one float
// per lane.  The wrapper demands 0 <= slots < C (the reference's lookup
// passes "safe" slots); a slot outside that range writes a zero row.  The
// copy is exact, so the result is bit-equal to the plain index_select.
//
// The staged push replaces the Pallas TPU kernel sparse_adagrad_pallas
// (pallas_call at :88 of the same file): dense-block AdaGrad over the
// working set's rows as the SSD tier stages them, aligned with the uids
// (row i is table row uids[i]; pads repeat uids[0] and carry zero
// gradients).  Unlike the pushes above it computes the row math itself,
// with the exact roundings of adagrad_row_updates, so the staged rows end
// bit-equal to the host push's table rows:
//   g2 = g*g;  a_new = f32(f64(a) + f64(g)^2);  root = f32(sqrt(f64(a_new)))
//   delta = (f32(-lr) * g) / (root + f32(eps));  rows += delta;  accum += g2
// (every op IEEE-rounded: __fmul_rn, __dadd_rn, __dsqrt_rn, ...; g*g is
// exact in double).  A pad row is left as it was: x + (-0.0) == x.
// What bounds it: bytes.  Per element it reads the row, the accumulator
// and the gradient and writes the row and the accumulator (5 x 4 B); the
// float64 root is a few dozen instructions per element, far under the
// card's float64 rate at these sizes.  Design: a flat grid-stride loop,
// 16-byte loads and stores (float4) when the element count is a multiple
// of 4 and the three tensors are 16-byte aligned, else one float per
// thread.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kUidsPerBlock = 8;
constexpr int kRowsPerBlock = 8;

// slots == nullptr: the row of position i is uids[i] (the table push);
// otherwise slots[i] (the cached push).
__global__ void sparse_adagrad_apply_kernel(
    float* __restrict__ table, float* __restrict__ accum, int64_t rows,
    int dim, const int32_t* __restrict__ uids,
    const int32_t* __restrict__ slots, int64_t cap,
    const float* __restrict__ delta, const float* __restrict__ g2) {
  const int lane = threadIdx.x % kWarp;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kUidsPerBlock + threadIdx.x / kWarp;
  if (i >= cap) return;  // whole warps leave together
  const int64_t u = uids[i];
  if (i > 0 && u <= static_cast<int64_t>(uids[i - 1])) return;  // a pad
  const int64_t r = slots == nullptr ? u : static_cast<int64_t>(slots[i]);
  if (r < 0 || r >= rows) return;
  float* t = table + r * dim;
  float* a = accum + r * dim;
  const float* d = delta + i * dim;
  const float* s = g2 + i * dim;
  for (int c = lane; c < dim; c += kWarp) {
    t[c] = __fadd_rn(t[c], d[c]);
    a[c] = __fadd_rn(a[c], s[c]);
  }
}

template <bool kVec4>
__global__ void gather_rows_cached_kernel(
    const float* __restrict__ cache_rows, int64_t n_slots, int dim,
    const int32_t* __restrict__ slots, int64_t cap, float* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (i >= cap) return;
  const int64_t s = slots[i];
  const bool ok = s >= 0 && s < n_slots;
  if (kVec4) {
    const int n4 = dim / 4;
    const float4* src =
        reinterpret_cast<const float4*>(cache_rows + (ok ? s : 0) * dim);
    float4* dst = reinterpret_cast<float4*>(out + i * dim);
    for (int c = lane; c < n4; c += kWarp) {
      dst[c] = ok ? src[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    const float* src = cache_rows + (ok ? s : 0) * dim;
    float* dst = out + i * dim;
    for (int c = lane; c < dim; c += kWarp) dst[c] = ok ? src[c] : 0.f;
  }
}

__device__ __forceinline__ void adagrad_element(float& w, float& a, float g,
                                                float neg_lr, float eps) {
  const float g2 = __fmul_rn(g, g);
  const double gd = static_cast<double>(g);
  const float a_new = __double2float_rn(
      __dadd_rn(static_cast<double>(a), __dmul_rn(gd, gd)));
  const float root = __double2float_rn(__dsqrt_rn(static_cast<double>(a_new)));
  const float delta = __fdiv_rn(__fmul_rn(neg_lr, g), __fadd_rn(root, eps));
  w = __fadd_rn(w, delta);
  a = __fadd_rn(a, g2);
}

__global__ void sparse_adagrad_staged_kernel(float* __restrict__ rows,
                                             float* __restrict__ accum,
                                             const float* __restrict__ grads,
                                             int64_t n, float neg_lr,
                                             float eps) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    float w = rows[i];
    float a = accum[i];
    adagrad_element(w, a, grads[i], neg_lr, eps);
    rows[i] = w;
    accum[i] = a;
  }
}

__global__ void sparse_adagrad_staged_vec4_kernel(
    float4* __restrict__ rows, float4* __restrict__ accum,
    const float4* __restrict__ grads, int64_t n4, float neg_lr, float eps) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n4; i += stride) {
    float4 w = rows[i];
    float4 a = accum[i];
    const float4 g = grads[i];
    adagrad_element(w.x, a.x, g.x, neg_lr, eps);
    adagrad_element(w.y, a.y, g.y, neg_lr, eps);
    adagrad_element(w.z, a.z, g.z, neg_lr, eps);
    adagrad_element(w.w, a.w, g.w, neg_lr, eps);
    rows[i] = w;
    accum[i] = a;
  }
}

}  // namespace

// The binding checks every shape before these are called; cap >= 1.
void launch_sparse_adagrad_apply(float* table, float* accum, int64_t rows,
                                 int dim, const int32_t* uids,
                                 const int32_t* slots, int64_t cap,
                                 const float* delta, const float* g2,
                                 cudaStream_t stream) {
  const int64_t blocks = (cap + kUidsPerBlock - 1) / kUidsPerBlock;
  sparse_adagrad_apply_kernel<<<static_cast<unsigned>(blocks),
                                kUidsPerBlock * kWarp, 0, stream>>>(
      table, accum, rows, dim, uids, slots, cap, delta, g2);
}

void launch_gather_rows_cached(const float* cache_rows, int64_t n_slots,
                               int dim, const int32_t* slots, int64_t cap,
                               float* out, cudaStream_t stream) {
  const int64_t blocks = (cap + kRowsPerBlock - 1) / kRowsPerBlock;
  const bool vec4 = dim % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(cache_rows) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) {
    gather_rows_cached_kernel<true><<<static_cast<unsigned>(blocks),
                                      kRowsPerBlock * kWarp, 0, stream>>>(
        cache_rows, n_slots, dim, slots, cap, out);
  } else {
    gather_rows_cached_kernel<false><<<static_cast<unsigned>(blocks),
                                       kRowsPerBlock * kWarp, 0, stream>>>(
        cache_rows, n_slots, dim, slots, cap, out);
  }
}

// rows/accum/grads: n floats each (n >= 1); neg_lr = (float)(-lr).
void launch_sparse_adagrad_staged(float* rows, float* accum,
                                  const float* grads, int64_t n, float neg_lr,
                                  float eps, cudaStream_t stream) {
  constexpr int kThreads = 256;
  constexpr int64_t kMaxBlocks = 132 * 16;
  const bool vec4 = n % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(accum) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(grads) % 16 == 0;
  const int64_t work = vec4 ? n / 4 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (vec4) {
    sparse_adagrad_staged_vec4_kernel<<<static_cast<unsigned>(blocks),
                                        kThreads, 0, stream>>>(
        reinterpret_cast<float4*>(rows), reinterpret_cast<float4*>(accum),
        reinterpret_cast<const float4*>(grads), work, neg_lr, eps);
  } else {
    sparse_adagrad_staged_kernel<<<static_cast<unsigned>(blocks), kThreads,
                                   0, stream>>>(rows, accum, grads, n, neg_lr,
                                                eps);
  }
}
