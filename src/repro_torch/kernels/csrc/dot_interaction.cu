// DLRM's dot interaction for Hopper (sm_90a), forward:
//
//   out[b, p] = sum_d feats[b, i, d] * feats[b, j, d],
//   (i, j) = the p-th pair of np.tril_indices(F, k=-1): (1,0), (2,0), (2,1),
//            (3,0), ...; p = i (i - 1) / 2 + j
//
// feats (B, F, D) float32 or bfloat16 -> out (B, F (F - 1) / 2) in the
// same dtype; the sums are float32 (bfloat16 loads widen exactly).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dot_interaction.py
// (dot_interaction_pallas, pallas_call at :44), which forms the batched
// self-Gram feats . feats^T of a block of instances on the MXU and keeps
// its strict lower triangle, so the full (B, F, F) Gram never reaches
// device memory.  This kernel keeps that property and computes only the
// triangle's tiles.
//
// What bounds it: bytes.  At DLRM's serving shapes (F = 27, D = 128) an
// instance reads 13.8 KB and writes 1.4 KB for 351 x 128 FMAs: about 6
// FLOP per byte, far below the card's float32 rate per byte of HBM.  The
// first version of this kernel (one dot product per thread, two scalar
// shared-memory loads per FMA) was bound by shared-memory wavefronts
// instead, about 0.2 ms of its 0.31 ms at (16384, 27, 128).
//
// Design (float32 FMAs on the CUDA cores; TF32 tensor cores would miss the
// float32 tolerance):
// - A group is ipb consecutive instances; the block stages its F x D rows
//   in shared memory as float32: by cp.async, 16 B a copy, when the input
//   is float32, D % 4 == 0 and aligned; else by plain loads that widen
//   bfloat16.  ipb is as many instances as fill one warp with tiles (one
//   at F >= 21), as far as the rows fit 64 KB and the groups cover the
//   SMs twice; a block holds at most 128 threads of tiles (the dynamic
//   shared memory above 48 KB is opted into).
// - Staging and computing overlap across the many one-warp blocks an SM
//   holds (at the bulk shape one warp a block beat four, and persistent
//   blocks with a second buffer, half as many an SM, were slower).
// - The rows are cut into blocks of four (rows past F are padding whose
//   sums are never stored).  A thread owns one 4 x 4 tile (I, J), I >= J,
//   of the strict lower triangle's row blocks: per four d it reads four
//   float4 of rows 4I.. and four of rows 4J.. and issues 64 FMAs, in
//   ascending d into 16 float32 sums.  A diagonal tile stores only j < i.
//   Each tile is found from its index in closed form (no index table, so
//   a call makes no host-to-device copy).
// - Shared-memory layout: row r of an instance at r S + 4 (r / 4) floats,
//   S = the staged width rounded up to four, plus four.  Row block I then
//   starts at I (S + 1) 16-byte units, S + 1 odd, so the float4 loads of up
//   to eight row blocks at one d fall in eight different bank groups: no
//   conflicts among a quarter warp.
// - Rows too wide for shared memory are staged in chunks of dc columns
//   (one instance a block), each thread carrying its 16 sums from chunk to
//   chunk.  F is limited to 6144 (a chunk of four columns of F rows must
//   fit the shared memory); any B and D go.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "device.h"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 128;             // tiles a block computes at once
constexpr int kSmemBudget = 64 * 1024;       // per block, F x D fits
constexpr int kSmemMax = 227 * 1024;         // the opt-in limit on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __uint_as_float(
      static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&x)) << 16);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Floats of one staged instance: rows_p rows of stride S plus a four-float
// pad after every block of four rows.
__host__ __device__ __forceinline__ int inst_floats(int rows_p, int S) {
  return rows_p * S + rows_p;
}

// The t-th tile (I, J), J <= I, of the lower triangle of row blocks in
// row order: (0,0), (1,0), (1,1), (2,0), ...
__device__ __forceinline__ void tile_of(int t, int& I, int& J) {
  int r = static_cast<int>(
      0.5f * (sqrtf(8.0f * static_cast<float>(t) + 1.0f) - 1.0f));
  while (static_cast<int64_t>(r) * (r + 1) / 2 > t) --r;
  while (static_cast<int64_t>(r + 1) * (r + 2) / 2 <= t) ++r;
  I = r;
  J = t - static_cast<int>(static_cast<int64_t>(r) * (r + 1) / 2);
}

// acc[a][b] += sum over the staged columns [0, dn) of rows 4I + a and
// 4J + b of one staged instance, in ascending column.
__device__ __forceinline__ void tile_dot(const float* inst, int S, int I,
                                         int J, int dn, float (&acc)[4][4]) {
  const float* a_rows = inst + 4 * I * S + 4 * I;
  const float* b_rows = inst + 4 * J * S + 4 * J;
#pragma unroll 2
  for (int c = 0; c < dn; c += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      x[a] = *reinterpret_cast<const float4*>(a_rows + a * S + c);
      y[a] = *reinterpret_cast<const float4*>(b_rows + a * S + c);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        acc[a][b] = fmaf(x[a].x, y[b].x, acc[a][b]);
        acc[a][b] = fmaf(x[a].y, y[b].y, acc[a][b]);
        acc[a][b] = fmaf(x[a].z, y[b].z, acc[a][b]);
        acc[a][b] = fmaf(x[a].w, y[b].w, acc[a][b]);
      }
    }
  }
}

// The strict lower triangle's part of tile (I, J) into out (one instance).
template <typename T>
__device__ __forceinline__ void store_tile(T* o, int F, int I, int J,
                                           const float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = 4 * I + a;
    if (i >= F) continue;
    const int base = i * (i - 1) / 2;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = 4 * J + b;
      if (j < i) store(o + base + j, acc[a][b]);
    }
  }
}

// Block b takes the group of ipb instances from b * ipb: it stages their
// rows (or a chunk of dc columns at a time when they are wider than
// shared memory) and computes its tiles.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
dot_interaction_kernel(const T* __restrict__ feats, T* __restrict__ out,
                       int64_t B, int F, int D, int P, int ipb, int dc,
                       bool async) {
  extern __shared__ __align__(16) float s[];
  const int rows_p = (F + 3) & ~3;
  const int nb = rows_p / 4;
  const int nt = nb * (nb + 1) / 2;          // tiles per instance
  const int S = ((dc + 3) & ~3) + 4;
  const int inst_sz = inst_floats(rows_p, S);
  const int64_t inst0 = static_cast<int64_t>(blockIdx.x) * ipb;
  const int n_inst = static_cast<int>(
      B - inst0 < ipb ? B - inst0 : static_cast<int64_t>(ipb));
  const int items = n_inst * nt;
  const T* src = feats + inst0 * F * D;
  T* dst = out + inst0 * P;
  const int tid = threadIdx.x;
  const bool single = dc >= D;

  // columns [d0, d0 + dn) of the block's rows into shared memory, zeros up
  // to the next multiple of four
  auto stage = [&](int d0, int dn) {
    const int q = (dn + 3) / 4;
    const int rows = n_inst * F;
    for (int e = tid; e < rows * q; e += blockDim.x) {
      const int r = e / q;
      const int c = (e - r * q) * 4;
      const int n = r / F;
      const int rr = r - n * F;
      float* o = s + n * inst_sz + rr * S + (rr & ~3) + c;
      const T* g = src + static_cast<int64_t>(r) * D + d0 + c;
      if (async) {
        cp_async16(o, reinterpret_cast<const float*>(g));
      } else {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = c + k < dn ? to_f32(g[k]) : 0.f;
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    if (async) {
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
  };

  if (single) {
    stage(0, D);
    __syncthreads();
  }
  for (int g0 = 0; g0 < items; g0 += blockDim.x) {
    const int it = g0 + tid;
    const bool live = it < items;
    int n = 0, I = 0, J = 0;
    if (live) {
      n = it / nt;
      tile_of(it - n * nt, I, J);
    }
    float acc[4][4] = {};
    for (int d0 = 0; d0 < D; d0 += dc) {
      const int dn = D - d0 < dc ? D - d0 : dc;
      if (!single) {
        __syncthreads();                     // the last chunk's reads are done
        stage(d0, dn);
        __syncthreads();
      }
      if (live) tile_dot(s + n * inst_sz, S, I, J, dn, acc);
    }
    if (live) store_tile(dst + static_cast<int64_t>(n) * P, F, I, J, acc);
  }
}

}  // namespace

// The largest F the kernel takes: a chunk of four staged columns of F
// rows (each row padded to eight floats, plus a block pad) must fit the
// opt-in shared memory.
int dot_interaction_max_features() { return 6144; }

// feats (B, F, D) -> out (B, F (F - 1) / 2), both contiguous, of one dtype
// (bf16: bfloat16, else float32); B * P > 0, 2 <= F <=
// dot_interaction_max_features().  Launches on ``stream``.
void launch_dot_interaction(const void* feats, void* out, int64_t B,
                                   int F, int D, bool bf16,
                                   cudaStream_t stream) {
  const int P = F * (F - 1) / 2;
  const int rows_p = (F + 3) & ~3;
  const int nt = (rows_p / 4) * (rows_p / 4 + 1) / 2;
  auto bytes = [&](int ipb, int dc) {
    return static_cast<int64_t>(ipb) *
           inst_floats(rows_p, ((dc + 3) & ~3) + 4) * 4;
  };
  int ipb = 1, dc = D;
  if (bytes(1, D) <= kSmemBudget) {
    // instances whose tiles fill a warp (one at F >= 21), as far as the
    // rows fit and the grid still covers the SMs twice
    const int64_t cover = B / (2 * static_cast<int64_t>(sm_count()));
    const int by_threads = nt >= kWarp ? 1 : kWarp / nt;
    const int by_smem = static_cast<int>(kSmemBudget / bytes(1, D));
    ipb = by_threads < by_smem ? by_threads : by_smem;
    if (cover < ipb) ipb = cover < 1 ? 1 : static_cast<int>(cover);
  } else {
    // one instance a block, the widest multiple of four that fits
    dc = 4;
    while (dc + 4 < D && bytes(1, dc + 4) <= kSmemMax) dc += 4;
    if (D <= dc + 4 && bytes(1, D) <= kSmemMax) dc = D;
  }
  const bool async = !bf16 && D % 4 == 0 && dc % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  const int64_t blocks = (B + ipb - 1) / ipb;
  const int64_t tiles = static_cast<int64_t>(ipb) * nt;
  const int threads = static_cast<int>(
      tiles >= kMaxThreads ? kMaxThreads : (tiles + kWarp - 1) / kWarp * kWarp);
  const size_t smem = static_cast<size_t>(bytes(ipb, dc));
  if (bf16) {
    auto* k = dot_interaction_kernel<__nv_bfloat16>;
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    k<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(feats),
        static_cast<__nv_bfloat16*>(out), B, F, D, P, ipb, dc, false);
  } else {
    auto* k = dot_interaction_kernel<float>;
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    k<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
        static_cast<const float*>(feats), static_cast<float*>(out), B, F, D,
        P, ipb, dc, async);
  }
}

// ---------------------------------------------------------------- backward
//
// Kernel 8b, the interaction's backward (its vjp), for Hopper (sm_90a):
//
//   g_feats[b, i, :] = sum_{j != i} g[b, p(max(i, j), min(i, j))]
//                                   * feats[b, j, :],
//   p(i, j) = i (i - 1) / 2 + j     (the forward's pair index),
//
// that is g_feats = (G + G^T) feats with G = g scattered into the strict
// lower triangle.  g (B, F (F - 1) / 2) and feats (B, F, D), float32 or
// bfloat16, give (B, F, D) in that dtype; each output element adds its
// products in float32, in ascending j (the diagonal's with weight zero, as
// in (G + G^T) feats), so two runs give the same bits.
//
// Replaces no TPU kernel: the reference's gradient is XLA's vjp of its jnp
// dot_interaction (src/repro/kernels/ops.py:128-132 has no custom_vjp).
// It exists because the port's forward is the hand-written kernel above,
// whose autograd function needs a backward on the card.
//
// What bounds it: bytes.  At the training shape of one pod, (32768, 27,
// 128) float32, it reads feats (453.0 MB) and g (46.0 MB) and writes 453.0
// MB: 0.284 ms at 3.35 TB/s, against 0.09 ms for its 5.9 GFLOP at the
// float32 rate.  So a thread reuses each staged value: it owns four output
// rows and a float4 of columns, and per j reads one float4 of feats' row j
// and one float4 of M = G + G^T's row j (M is symmetric, so its row j
// holds the four rows' weights), two shared-memory loads per 16 FMAs.
//
// Design (float32 FMAs on the CUDA cores; TF32 tensor cores would miss the
// float32 tolerance, as for the forward):
// - A block takes ipb instances and a chunk of dc columns; it stages the
//   F rows' chunk in shared memory as float32 (by cp.async, 16 B a copy,
//   when the input is float32, D % 4 == 0 and aligned; else by plain
//   loads that widen bfloat16) and, while those copies fly, once for all
//   its chunks, M as F rows of F rounded up to four floats: each g read
//   once, coalesced, and written to M[i][j] and M[j][i]; the diagonal and
//   the pad columns zero.  Staging and computing overlap across the
//   blocks an SM holds, as in the forward.
// - Threads walk (instance, row block, column quad), the quad fastest, so
//   a warp reads 32 consecutive float4 of one feats row (no bank
//   conflicts) and one broadcast float4 of M, and writes its rows
//   coalesced.
// - DLRM's case (float32, D % 4 == 0, aligned, F <= 88, the rows in 64
//   KB) runs persistent blocks with two buffers instead: the next
//   instance's rows and g are copied by cp.async while this one is
//   computed, and M is built from the staged g, so the loop never waits
//   on device memory (one instance a block left each block's copies
//   exposed: its time barely moved from a cold L2 to a warm one).
// - When M does not fit (F > 88: F x F floats over 32 KB) the weights are
//   read from g in global memory instead (each a broadcast load in a
//   warp, from L1 after the first).  Rows too wide for shared memory are
//   staged in chunks, as in the forward; F is limited as there.
namespace {

constexpr int kBwdMaxThreads = 256;
constexpr int kBwdGBudget = 32 * 1024;       // M staged up to this size

// (i, j), i > j, of pair p = i (i - 1) / 2 + j.
__device__ __forceinline__ void pair_of(int p, int& i, int& j) {
  int r = static_cast<int>(
      0.5f * (1.0f + sqrtf(8.0f * static_cast<float>(p) + 1.0f)));
  while (static_cast<int64_t>(r) * (r - 1) / 2 > p) --r;
  while (static_cast<int64_t>(r + 1) * r / 2 <= p) ++r;
  i = r;
  j = p - static_cast<int>(static_cast<int64_t>(r) * (r - 1) / 2);
}

template <typename T, bool kStagedM>
__global__ void __launch_bounds__(kBwdMaxThreads)
dot_interaction_backward_kernel(const T* __restrict__ g,
                                const T* __restrict__ feats,
                                T* __restrict__ out, int64_t B, int F, int D,
                                int P, int ipb, int dc, int n_chunks,
                                bool async, bool vec_store) {
  extern __shared__ __align__(16) float s[];
  const int Fp = (F + 3) & ~3;
  const int nb = Fp / 4;                     // row blocks of four
  const int S = (dc + 3) & ~3;               // staged row stride
  const int m_sz = kStagedM ? F * Fp : 0;
  const int inst_sz = F * S + m_sz;          // floats per staged instance
  const int64_t inst0 = static_cast<int64_t>(blockIdx.x) * ipb;
  const int n_inst = static_cast<int>(
      B - inst0 < ipb ? B - inst0 : static_cast<int64_t>(ipb));
  const T* src = feats + inst0 * F * D;
  const T* gsrc = g + inst0 * P;
  T* dst = out + inst0 * F * D;
  const int tid = threadIdx.x;

  for (int chunk = blockIdx.y; chunk < n_chunks; chunk += gridDim.y) {
    const int d0 = chunk * dc;
    const int dn = D - d0 < dc ? D - d0 : dc;
    const int Q = (dn + 3) / 4;
    if (chunk != static_cast<int>(blockIdx.y)) __syncthreads();
    // columns [d0, d0 + dn) of the block's rows, zeros up to a multiple of 4
    for (int e = tid; e < n_inst * F * Q; e += blockDim.x) {
      const int r = e / Q;
      const int c = (e - r * Q) * 4;
      const int n = r / F;
      float* o = s + n * inst_sz + (r - n * F) * S + c;
      const T* gp = src + static_cast<int64_t>(r) * D + d0 + c;
      if (async) {
        cp_async16(o, reinterpret_cast<const float*>(gp));
      } else {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = c + k < dn ? to_f32(gp[k]) : 0.f;
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    if (kStagedM && chunk == static_cast<int>(blockIdx.y)) {
      // M = G + G^T of each instance, once for all chunks, while the
      // copies fly: the diagonal and the pad columns zero, then every g
      // twice
      for (int e = tid; e < n_inst * F * Fp; e += blockDim.x) {
        const int n = e / (F * Fp);
        const int r = e - n * F * Fp;
        const int row = r / Fp;
        const int col = r - row * Fp;
        if (col == row || col >= F) s[n * inst_sz + F * S + r] = 0.f;
      }
      for (int e = tid; e < n_inst * P; e += blockDim.x) {
        const int n = e / P;
        const int p = e - n * P;
        int i, j;
        pair_of(p, i, j);
        const float v = to_f32(gsrc[static_cast<int64_t>(n) * P + p]);
        float* m = s + n * inst_sz + F * S;
        m[i * Fp + j] = v;
        m[j * Fp + i] = v;
      }
    }
    if (async) {
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();

    const int per_inst = nb * Q;
    for (int it = tid; it < n_inst * per_inst; it += blockDim.x) {
      const int n = it / per_inst;
      const int rem = it - n * per_inst;
      const int I = rem / Q;
      const int q = rem - I * Q;
      const float* rows = s + n * inst_sz;
      const float* m = rows + F * S;
      const T* gi = gsrc + static_cast<int64_t>(n) * P;
      float acc[4][4] = {};
      for (int j = 0; j < F; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(rows + j * S + 4 * q);
        float w[4];
        if (kStagedM) {
          const float4 mm =
              *reinterpret_cast<const float4*>(m + j * Fp + 4 * I);
          w[0] = mm.x; w[1] = mm.y; w[2] = mm.z; w[3] = mm.w;
        } else {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int i = 4 * I + a;
            w[a] = 0.f;
            if (i < F && i != j) {
              const int hi = i > j ? i : j, lo = i > j ? j : i;
              w[a] = to_f32(gi[hi * (hi - 1) / 2 + lo]);
            }
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {        // w[a] = 0 at i == j
          acc[a][0] = fmaf(w[a], x.x, acc[a][0]);
          acc[a][1] = fmaf(w[a], x.y, acc[a][1]);
          acc[a][2] = fmaf(w[a], x.z, acc[a][2]);
          acc[a][3] = fmaf(w[a], x.w, acc[a][3]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 4 * I + a;
        if (i >= F) continue;
        T* o = dst + (static_cast<int64_t>(n) * F + i) * D + d0 + 4 * q;
        if (std::is_same<T, float>::value && vec_store && 4 * q + 4 <= dn) {
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (4 * q + k < dn) store(o + k, acc[a][k]);
        }
      }
    }
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// The DLRM path's kernel (float32, D % 4 == 0, aligned, M staged, one
// chunk): persistent blocks over instances b, b + gridDim.x, ..., each
// with two buffers of an instance's rows, its g and its M.  The next
// instance's rows (16-byte copies) and g (4-byte copies) fly while this
// one is computed; M is then built from the staged g in shared memory,
// so no load waits on device memory in the loop.  The arithmetic is the
// kernel above's.
__global__ void __launch_bounds__(kBwdMaxThreads)
dot_interaction_backward_pipe_kernel(const float* __restrict__ g,
                                     const float* __restrict__ feats,
                                     float* __restrict__ out, int64_t B,
                                     int F, int D, int P) {
  extern __shared__ __align__(16) float s[];
  const int Fp = (F + 3) & ~3;
  const int nb = Fp / 4;
  const int Q = D / 4;
  // a buffer: rows (F x D), M (F x Fp), g (P rounded up to four)
  const int buf_sz = F * D + F * Fp + ((P + 3) & ~3);
  const int tid = threadIdx.x;
  auto issue = [&](int64_t b, float* buf) {
    const float* src = feats + b * F * D;
    for (int e = tid; e < F * Q; e += blockDim.x) {
      const int r = e / Q;
      const int c = (e - r * Q) * 4;
      cp_async16(buf + r * D + c, src + static_cast<int64_t>(r) * D + c);
    }
    const float* gs = g + b * P;
    float* gl = buf + F * D + F * Fp;
    for (int e = tid; e < P; e += blockDim.x) cp_async4(gl + e, gs + e);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  int64_t b = blockIdx.x;
  if (b < B) issue(b, s);
  for (int k = 0; b < B; ++k, b += gridDim.x) {
    float* cur = s + (k & 1) * buf_sz;
    if (b + gridDim.x < B) {
      issue(b + gridDim.x, s + ((k & 1) ^ 1) * buf_sz);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    float* m = cur + F * D;
    const float* gl = m + F * Fp;
    for (int e = tid; e < F * Fp; e += blockDim.x) {
      const int row = e / Fp;
      const int col = e - row * Fp;
      float v = 0.f;
      if (col < F && col != row) {
        const int hi = row > col ? row : col, lo = row > col ? col : row;
        v = gl[hi * (hi - 1) / 2 + lo];
      }
      m[e] = v;
    }
    __syncthreads();
    float* dst = out + b * F * D;
    for (int it = tid; it < nb * Q; it += blockDim.x) {
      const int I = it / Q;
      const int q = it - I * Q;
      float acc[4][4] = {};
      for (int j = 0; j < F; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(cur + j * D + 4 * q);
        const float4 w = *reinterpret_cast<const float4*>(m + j * Fp + 4 * I);
        const float wa[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a][0] = fmaf(wa[a], x.x, acc[a][0]);
          acc[a][1] = fmaf(wa[a], x.y, acc[a][1]);
          acc[a][2] = fmaf(wa[a], x.z, acc[a][2]);
          acc[a][3] = fmaf(wa[a], x.w, acc[a][3]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (4 * I + a < F) {
          *reinterpret_cast<float4*>(dst + (4 * I + a) * D + 4 * q) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
        }
      }
    }
    __syncthreads();                         // cur is refilled next-but-one
  }
}

template <typename T, bool kStagedM>
void launch_backward(const T* g, const T* feats, T* out, int64_t B, int F,
                     int D, int P, int ipb, int dc, int n_chunks, bool async,
                     bool vec_store, int threads, size_t smem,
                     cudaStream_t stream) {
  auto* k = dot_interaction_backward_kernel<T, kStagedM>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const dim3 grid(static_cast<unsigned>((B + ipb - 1) / ipb),
                  static_cast<unsigned>(n_chunks < 65535 ? n_chunks : 65535));
  k<<<grid, threads, smem, stream>>>(g, feats, out, B, F, D, P, ipb, dc,
                                     n_chunks, async, vec_store);
}

}  // namespace

// g (B, F (F - 1) / 2) and feats (B, F, D) -> out (B, F, D), all
// contiguous, of one dtype (bf16: bfloat16, else float32); B * D > 0,
// 1 <= F <= dot_interaction_max_features().  Launches on ``stream``.
void launch_dot_interaction_backward(const void* g, const void* feats,
                                     void* out, int64_t B, int F, int D,
                                     bool bf16, cudaStream_t stream) {
  const int P = F * (F - 1) / 2;
  const int Fp = (F + 3) & ~3;
  const int nb = Fp / 4;
  const bool staged_m = static_cast<int64_t>(F) * Fp * 4 <= kBwdGBudget;
  auto bytes = [&](int ipb, int dc) {
    return static_cast<int64_t>(ipb) *
           (static_cast<int64_t>(F) * ((dc + 3) & ~3) +
            (staged_m ? static_cast<int64_t>(F) * Fp : 0)) * 4;
  };
  int ipb = 1, dc = D;
  if (bytes(1, D) <= kSmemBudget) {
    // instances whose threads fill a block, as far as they fit and the
    // grid still covers the SMs twice
    const int64_t per_inst = static_cast<int64_t>(nb) * ((D + 3) / 4);
    const int64_t cover = B / (2 * static_cast<int64_t>(sm_count()));
    const int by_threads = static_cast<int>(
        per_inst >= kBwdMaxThreads ? 1 : kBwdMaxThreads / per_inst);
    const int by_smem = static_cast<int>(kSmemBudget / bytes(1, D));
    ipb = by_threads < by_smem ? by_threads : by_smem;
    if (cover < ipb) ipb = cover < 1 ? 1 : static_cast<int>(cover);
  } else {
    // one instance a block, the widest multiple of four that fits
    dc = 4;
    while (dc + 4 < D && bytes(1, dc + 4) <= kSmemMax) dc += 4;
    if (D <= dc + 4 && bytes(1, D) <= kSmemMax) dc = D;
  }
  const int n_chunks = (D + dc - 1) / dc;
  const bool aligned_io = D % 4 == 0 && dc % 4 == 0;
  const bool async = !bf16 && aligned_io &&
                     reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  const bool vec_store = !bf16 && aligned_io &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t tiles =
      static_cast<int64_t>(ipb) * nb * (((dc < D ? dc : D) + 3) / 4);
  const int threads = static_cast<int>(
      tiles >= kBwdMaxThreads ? kBwdMaxThreads
                              : (tiles + kWarp - 1) / kWarp * kWarp);
  const size_t smem = static_cast<size_t>(bytes(ipb, dc));
  if (!bf16 && staged_m && dc == D && async && vec_store) {
    // DLRM's path: persistent blocks, as many as the SMs hold
    auto* k = dot_interaction_backward_pipe_kernel;
    const int64_t per_inst = static_cast<int64_t>(nb) * (D / 4);
    const int pthreads = static_cast<int>(
        per_inst >= kBwdMaxThreads ? kBwdMaxThreads
                                   : (per_inst + kWarp - 1) / kWarp * kWarp);
    const size_t psmem = 2 * static_cast<size_t>(
        static_cast<int64_t>(F) * D + static_cast<int64_t>(F) * Fp +
        ((P + 3) & ~3)) * 4;
    if (psmem > 48 * 1024) {
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(psmem));
    }
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, pthreads,
                                                  psmem);
    const int64_t grid = static_cast<int64_t>(per_sm < 1 ? 1 : per_sm) *
                         sm_count();
    k<<<static_cast<unsigned>(B < grid ? B : grid), pthreads, psmem,
        stream>>>(static_cast<const float*>(g),
                  static_cast<const float*>(feats), static_cast<float*>(out),
                  B, F, D, P);
    return;
  }
  if (bf16) {
    using T = __nv_bfloat16;
    auto* gg = static_cast<const T*>(g);
    auto* ff = static_cast<const T*>(feats);
    auto* oo = static_cast<T*>(out);
    if (staged_m)
      launch_backward<T, true>(gg, ff, oo, B, F, D, P, ipb, dc, n_chunks,
                               false, false, threads, smem, stream);
    else
      launch_backward<T, false>(gg, ff, oo, B, F, D, P, ipb, dc, n_chunks,
                                false, false, threads, smem, stream);
  } else {
    auto* gg = static_cast<const float*>(g);
    auto* ff = static_cast<const float*>(feats);
    auto* oo = static_cast<float*>(out);
    if (staged_m)
      launch_backward<float, true>(gg, ff, oo, B, F, D, P, ipb, dc, n_chunks,
                                   async, vec_store, threads, smem, stream);
    else
      launch_backward<float, false>(gg, ff, oo, B, F, D, P, ipb, dc,
                                    n_chunks, async, vec_store, threads, smem,
                                    stream);
  }
}
