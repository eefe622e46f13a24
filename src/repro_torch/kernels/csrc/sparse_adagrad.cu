// The in-place AdaGrad pushes and the cached row gather for Hopper
// (sm_90a):
//
//   push:          table[uids[i]], accum[uids[i]] <- AdaGrad(grads[i])
//   cached push:   cache[slots[i]], cache_accum[slots[i]] <- AdaGrad(grads[i])
//                  (every real i)
//   cached gather: out[i] = cache_rows[slots[i]]  (and, with the drop row,
//                  out[cap] = 0)
//   staged push:   rows += delta(accum, g); accum += g*g   (elementwise over
//                  the pulled (C, D) rows)
//
// Replace the Pallas TPU kernels of src/repro/kernels/sparse_adagrad.py:
// sparse_adagrad_apply_pallas (pallas_call at :127),
// sparse_adagrad_cached_apply_pallas (:166), gather_rows_cached_pallas
// (:194) and sparse_adagrad_pallas (:88).  The two pushes share one kernel
// under two index streams: the row of position i is uids[i] (the table) or
// slots[i] (the device cache, the hash probe's output); the pad test reads
// the uids in both, because a slot order is not ascending.
//
// The row math.  On the TPU, XLA fuses adagrad_row_updates (the reference
// computes it outside its Pallas push) into one pass ahead of the scatter.
// Here every kernel applies it per element itself (adagrad_element below),
// with the exact roundings of the port's adagrad_row_updates:
//   g2 = g*g;  a_new = f32(f64(a) + f64(g)^2);  root = f32(sqrt(f64(a_new)))
//   delta = (f32(-lr) * g) / (root + f32(eps));  w += delta;  a += g2
// (every op IEEE-rounded: __fmul_rn, __dadd_rn, __dsqrt_rn, ...; g*g is
// exact in double).  So a push ends bit-equal to adagrad_row_updates
// followed by index_add_: each real row is distinct and is read before its
// own write.
//
// Contract on `uids`: laid out as pull_working_set lays them out, i.e. the
// real ids strictly ascending, then (when the batch has fewer distinct ids
// than the capacity) pads that repeat uids[0] up to the end; an overflowed
// batch has no pads.  The pads carry zero gradients (no id slot maps to a
// pad position), whose update (-0.0, +0.0) changes no bits.
//
// Duplicate rows would race on the GPU.  The TPU kernel walks its grid in
// reverse, one step at a time, so the pads run first and the real row
// last.  Here the rows run in parallel, and a pad and the real uids[0]
// would read-modify-write the same row at the same time.  The kernel
// therefore skips every position i > 0 with uids[i] <= uids[i-1]: exactly
// the pads, whose gradient rows it never reads.  A uid outside [0, rows) is
// skipped too (the reference's scatter drops it).  In the cached push the
// pads' slots repeat slots[0] (the first id's slot), so the same uid test
// finds them; a slot outside [0, C) is skipped.
//
// What bounds the pushes: bytes.  Per real row they read the table row, the
// accumulator row and the gradient row and write the two rows back (5 x 4
// x dim bytes), plus the uid (and slot) stream.  The float64 root is a few
// dozen instructions an element, far under the card's float64 rate.
//
// Design of the pushes.  At dim 64 a half-warp takes a position, a float4
// a lane (16-byte loads and stores when dim is a multiple of 4 and the
// three tensors are 16-byte aligned; else one float a lane, the lanes a
// position the power of two that covers the row, at most 32).  Each group
// of lanes takes kPushChunk consecutive positions at a time, their three
// rows each loaded before any is stored, so two positions' loads are in
// flight a lane; the index words of the group's next chunk are loaded
// before this chunk's rows, so their trip overlaps the rows'.  A grid sized
// to the card (the blocks that fit at once) strides over the chunks.
// Every row offset is int64_t: at 50 M rows x 64, uid * dim reaches 3.2e9.
// The tensors are updated in place; nothing of table size is allocated.
//
// The cached gather is pure data movement (bytes: one cache row read and
// one row written a position, plus the slot stream).  The same walk: a
// half-warp a row at dim 64, a float4 a lane, kGatherChunk consecutive
// positions a group, their slots loaded together (16-byte loads where
// aligned) and their rows loaded before any is stored, 64-bit offsets, a
// grid sized to the card.  A slot outside [0, C) gives a zero row; so do
// the positions past the slots, which is how the drop row (the working
// set's last, zero row) is written by the same launch.  The copy is exact,
// so the result is bit-equal to index_select (and the drop row's cat).
//
// The staged push: dense-block AdaGrad over the working set's rows as the
// SSD tier stages them, aligned with the uids (row i is table row uids[i];
// pads repeat uids[0] and carry zero gradients), so the staged rows end
// bit-equal to the host push's table rows.  A pad row is left as it was:
// x + (-0.0) == x.  What bounds it: bytes (5 x 4 B an element).  Design: a
// flat grid-stride loop, 16-byte loads and stores (float4) when the element
// count is a multiple of 4 and the three tensors are 16-byte aligned, else
// one float a thread.
#include <cuda_runtime.h>
#include <cstdint>

#include "device.h"

namespace {

constexpr int kThreads = 256;
constexpr int kPushChunk = 2;    // positions a group of lanes takes at once
constexpr int kGatherChunk = 8;  // a multiple of 4 (int4 slot loads)

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

__device__ __forceinline__ void adagrad_vec(float& w, float& a, float g,
                                            float neg_lr, float eps) {
  adagrad_element(w, a, g, neg_lr, eps);
}

__device__ __forceinline__ void adagrad_vec(float4& w, float4& a, float4 g,
                                            float neg_lr, float eps) {
  adagrad_element(w.x, a.x, g.x, neg_lr, eps);
  adagrad_element(w.y, a.y, g.y, neg_lr, eps);
  adagrad_element(w.z, a.z, g.z, neg_lr, eps);
  adagrad_element(w.w, a.w, g.w, neg_lr, eps);
}

template <typename V>
__device__ __forceinline__ V zero_vec();
template <>
__device__ __forceinline__ float zero_vec<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero_vec<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// The index words of one push chunk: uids[i0 - 1 .. i0 + kPushChunk - 1]
// (and the slots of its positions), loaded as raw words so that their use
// can wait until the chunk before has been stored.
struct PushIdx {
  int32_t prev;
  int32_t u[kPushChunk];
  int32_t s[kPushChunk];
};

__device__ __forceinline__ PushIdx load_push_idx(
    const int32_t* __restrict__ uids, const int32_t* __restrict__ slots,
    int64_t i0, int64_t cap) {
  PushIdx x;
  x.prev = i0 > 0 ? uids[i0 - 1] : 0;
#pragma unroll
  for (int j = 0; j < kPushChunk; ++j) {
    const bool in = i0 + j < cap;
    x.u[j] = in ? uids[i0 + j] : 0;
    x.s[j] = in && slots != nullptr ? slots[i0 + j] : 0;
  }
  return x;
}

// slots == nullptr: the row of position i is uids[i] (the table push);
// otherwise slots[i] (the cached push).  n_vec: V-sized words a row.
template <typename V, int L>
__global__ void __launch_bounds__(kThreads) sparse_adagrad_push_kernel(
    float* __restrict__ table, float* __restrict__ accum, int64_t rows,
    int n_vec, const int32_t* __restrict__ uids,
    const int32_t* __restrict__ slots, int64_t cap,
    const float* __restrict__ grads, float neg_lr, float eps) {
  V* t = reinterpret_cast<V*>(table);
  V* a = reinterpret_cast<V*>(accum);
  const V* g = reinterpret_cast<const V*>(grads);
  const int sub = threadIdx.x % L;
  const int64_t groups = static_cast<int64_t>(gridDim.x) * (kThreads / L);
  const int64_t chunks = (cap + kPushChunk - 1) / kPushChunk;
  int64_t c = static_cast<int64_t>(blockIdx.x) * (kThreads / L) +
              threadIdx.x / L;
  PushIdx cur{};
  if (c < chunks) cur = load_push_idx(uids, slots, c * kPushChunk, cap);
  for (; c < chunks; c += groups) {
    const int64_t i0 = c * kPushChunk;
    PushIdx nxt{};
    if (c + groups < chunks) {
      nxt = load_push_idx(uids, slots, (c + groups) * kPushChunk, cap);
    }
    int64_t r[kPushChunk];  // the row of each position, or -1: skip it
#pragma unroll
    for (int j = 0; j < kPushChunk; ++j) {
      const int32_t before = j == 0 ? cur.prev : cur.u[j - 1];
      const bool pad = i0 + j >= cap || (i0 + j > 0 && cur.u[j] <= before);
      const int64_t row = slots == nullptr ? cur.u[j] : cur.s[j];
      r[j] = !pad && row >= 0 && row < rows ? row : -1;
    }
    for (int v = sub; v < n_vec; v += L) {
      V tw[kPushChunk], aw[kPushChunk], gw[kPushChunk];
#pragma unroll
      for (int j = 0; j < kPushChunk; ++j) {
        if (r[j] >= 0) {
          tw[j] = t[r[j] * n_vec + v];
          aw[j] = a[r[j] * n_vec + v];
          gw[j] = g[(i0 + j) * n_vec + v];
        }
      }
#pragma unroll
      for (int j = 0; j < kPushChunk; ++j) {
        if (r[j] >= 0) {
          adagrad_vec(tw[j], aw[j], gw[j], neg_lr, eps);
          t[r[j] * n_vec + v] = tw[j];
          a[r[j] * n_vec + v] = aw[j];
        }
      }
    }
    cur = nxt;
  }
}

// Positions [cap, n_out) and slots outside [0, n_slots) give zero rows.
template <typename V, int L>
__global__ void __launch_bounds__(kThreads) gather_rows_cached_kernel(
    const float* __restrict__ cache_rows, int64_t n_slots, int n_vec,
    const int32_t* __restrict__ slots, int64_t cap, int64_t n_out,
    bool slots_vec4, float* __restrict__ out) {
  const V* src = reinterpret_cast<const V*>(cache_rows);
  V* dst = reinterpret_cast<V*>(out);
  const int sub = threadIdx.x % L;
  const int64_t groups = static_cast<int64_t>(gridDim.x) * (kThreads / L);
  const int64_t chunks = (n_out + kGatherChunk - 1) / kGatherChunk;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * (kThreads / L) +
                   threadIdx.x / L;
       c < chunks; c += groups) {
    const int64_t i0 = c * kGatherChunk;
    int32_t s[kGatherChunk];
    if (slots_vec4 && i0 + kGatherChunk <= cap) {
#pragma unroll
      for (int j = 0; j < kGatherChunk; j += 4) {
        const int4 q = *reinterpret_cast<const int4*>(slots + i0 + j);
        s[j] = q.x, s[j + 1] = q.y, s[j + 2] = q.z, s[j + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kGatherChunk; ++j) {
        s[j] = i0 + j < cap ? slots[i0 + j] : -1;
      }
    }
    for (int v = sub; v < n_vec; v += L) {
      V x[kGatherChunk];
#pragma unroll
      for (int j = 0; j < kGatherChunk; ++j) {
        x[j] = s[j] >= 0 && s[j] < n_slots
                   ? src[static_cast<int64_t>(s[j]) * n_vec + v]
                   : zero_vec<V>();
      }
#pragma unroll
      for (int j = 0; j < kGatherChunk; ++j) {
        if (i0 + j < n_out) dst[(i0 + j) * n_vec + v] = x[j];
      }
    }
  }
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
    adagrad_vec(w, a, grads[i], neg_lr, eps);
    rows[i] = w;
    accum[i] = a;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Lanes a row: the power of two that covers n_vec words, at most 32.
int lanes_for(int n_vec) {
  int lanes = 1;
  while (lanes < n_vec && lanes < 32) lanes *= 2;
  return lanes;
}

// The blocks of `kernel` an SM holds at once.
int blocks_per_sm(const void* kernel) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return per_sm > 0 ? per_sm : 1;
}

template <typename V, int L>
void launch_push(float* table, float* accum, int64_t rows, int n_vec,
                 const int32_t* uids, const int32_t* slots, int64_t cap,
                 const float* grads, float neg_lr, float eps,
                 cudaStream_t stream) {
  static const int per_sm = blocks_per_sm(
      reinterpret_cast<const void*>(&sparse_adagrad_push_kernel<V, L>));
  const int64_t max_blocks = static_cast<int64_t>(per_sm) * sm_count();
  const int64_t chunks = (cap + kPushChunk - 1) / kPushChunk;
  int64_t blocks = (chunks + kThreads / L - 1) / (kThreads / L);
  if (blocks > max_blocks) blocks = max_blocks;
  sparse_adagrad_push_kernel<V, L>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          table, accum, rows, n_vec, uids, slots, cap, grads, neg_lr, eps);
}

template <typename V, int L>
void launch_gather(const float* cache_rows, int64_t n_slots, int n_vec,
                   const int32_t* slots, int64_t cap, int64_t n_out,
                   float* out, cudaStream_t stream) {
  static const int per_sm = blocks_per_sm(
      reinterpret_cast<const void*>(&gather_rows_cached_kernel<V, L>));
  const int64_t max_blocks = static_cast<int64_t>(per_sm) * sm_count();
  const int64_t chunks = (n_out + kGatherChunk - 1) / kGatherChunk;
  int64_t blocks = (chunks + kThreads / L - 1) / (kThreads / L);
  if (blocks > max_blocks) blocks = max_blocks;
  gather_rows_cached_kernel<V, L>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          cache_rows, n_slots, n_vec, slots, cap, n_out, aligned16(slots),
          out);
}

// FN<V, L>(args...) with L the lanes for n_vec words a row.
#define DISPATCH_LANES(V, n_vec, FN, ...)         \
  switch (lanes_for(n_vec)) {                     \
    case 1: FN<V, 1>(__VA_ARGS__); break;         \
    case 2: FN<V, 2>(__VA_ARGS__); break;         \
    case 4: FN<V, 4>(__VA_ARGS__); break;         \
    case 8: FN<V, 8>(__VA_ARGS__); break;         \
    case 16: FN<V, 16>(__VA_ARGS__); break;       \
    default: FN<V, 32>(__VA_ARGS__); break;       \
  }

}  // namespace

// The binding checks every shape before these are called; cap >= 1.
// slots == nullptr: the table push; else the cached push into `rows`
// cache rows.  neg_lr = (float)(-lr).
void launch_sparse_adagrad_apply(float* table, float* accum, int64_t rows,
                                 int dim, const int32_t* uids,
                                 const int32_t* slots, int64_t cap,
                                 const float* grads, float neg_lr, float eps,
                                 cudaStream_t stream) {
  if (dim % 4 == 0 && aligned16(table) && aligned16(accum) &&
      aligned16(grads)) {
    DISPATCH_LANES(float4, dim / 4, launch_push, table, accum, rows, dim / 4,
                   uids, slots, cap, grads, neg_lr, eps, stream)
  } else {
    DISPATCH_LANES(float, dim, launch_push, table, accum, rows, dim, uids,
                   slots, cap, grads, neg_lr, eps, stream)
  }
}

// out: n_out >= cap rows of dim; the rows past cap are written zero.
void launch_gather_rows_cached(const float* cache_rows, int64_t n_slots,
                               int dim, const int32_t* slots, int64_t cap,
                               int64_t n_out, float* out,
                               cudaStream_t stream) {
  if (dim % 4 == 0 && aligned16(cache_rows) && aligned16(out)) {
    DISPATCH_LANES(float4, dim / 4, launch_gather, cache_rows, n_slots,
                   dim / 4, slots, cap, n_out, out, stream)
  } else {
    DISPATCH_LANES(float, dim, launch_gather, cache_rows, n_slots, dim,
                   slots, cap, n_out, out, stream)
  }
}

// rows/accum/grads: n floats each (n >= 1); neg_lr = (float)(-lr).
void launch_sparse_adagrad_staged(float* rows, float* accum,
                                  const float* grads, int64_t n, float neg_lr,
                                  float eps, cudaStream_t stream) {
  constexpr int64_t kMaxBlocks = 132 * 16;
  const bool vec4 = n % 4 == 0 && aligned16(rows) && aligned16(accum) &&
                    aligned16(grads);
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
