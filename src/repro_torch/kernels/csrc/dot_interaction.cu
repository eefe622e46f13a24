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
