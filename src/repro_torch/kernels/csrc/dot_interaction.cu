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
// triangle's F (F - 1) / 2 dots.
//
// What bounds it: bytes.  At DLRM's serving shapes (F = 27, D = 128) an
// instance reads 13.8 KB and writes 1.4 KB for 351 x 128 FMAs: about 6
// FLOP per byte, far below the card's float32 rate per byte of HBM.
//
// Design (a first, simple kernel; tensor cores are later work):
// - One block of 256 threads takes ipb consecutive instances (chosen by
//   the host so their rows fit 48 KB of shared memory and one pass of the
//   block covers their pairs).  The block stages the instances' F x D rows
//   in shared memory as float32, with coalesced loads (16 B a thread when
//   D % 4 == 0 and the input is aligned, else element by element), each
//   row padded by one float so that the rows a warp reads at one d fall in
//   different banks.
// - Each thread owns up to kItems (instance, pair) items at a time; it
//   finds (i, j) from p in closed form (no index table, so a call makes
//   no host-to-device copy), sums over d in ascending order with float32
//   FMAs, and writes its items; neighbouring threads write neighbouring
//   outputs.
// - Rows too wide for shared memory are staged in chunks of dc columns,
//   each thread carrying its sums from chunk to chunk; F is limited to
//   6144 (two floats a row must fit 48 KB), any B and D go.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                // items a thread holds per pass
constexpr int kSmemBytes = 48 * 1024;    // no opt-in attribute needed

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __uint_as_float(
      static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&x)) << 16);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four consecutive elements from an address aligned to four elements.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// The p-th pair (i, j), j < i, of the strict lower triangle in row order.
__device__ __forceinline__ void pair_of(int p, int& i, int& j) {
  int r = static_cast<int>(
      0.5f * (1.0f + sqrtf(8.0f * static_cast<float>(p) + 1.0f)));
  while (static_cast<int64_t>(r) * (r - 1) / 2 > p) --r;
  while (static_cast<int64_t>(r) * (r + 1) / 2 <= p) ++r;
  i = r;
  j = p - static_cast<int>(static_cast<int64_t>(r) * (r - 1) / 2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_interaction_kernel(const T* __restrict__ feats, T* __restrict__ out,
                       int64_t B, int F, int D, int P, int ipb, int dc,
                       bool vec) {
  extern __shared__ float s[];             // [ipb * F][dc + 1]
  const int stride = dc + 1;
  const int64_t inst0 = static_cast<int64_t>(blockIdx.x) * ipb;
  const int n_inst = static_cast<int>(
      B - inst0 < ipb ? B - inst0 : static_cast<int64_t>(ipb));
  const int rows = n_inst * F;
  const int items = n_inst * P;
  const T* src = feats + inst0 * F * D;
  T* dst = out + inst0 * P;
  const int tid = threadIdx.x;
  const bool single = dc >= D;

  // columns [d0, d0 + dn) of the block's rows into shared memory
  auto stage = [&](int d0, int dn) {
    if (vec) {
      const int q = dn / 4;
      for (int e = tid; e < rows * q; e += kThreads) {
        const int r = e / q;
        const int c = (e - r * q) * 4;
        const float4 v = load4(src + static_cast<int64_t>(r) * D + d0 + c);
        float* o = s + r * stride + c;
        o[0] = v.x;
        o[1] = v.y;
        o[2] = v.z;
        o[3] = v.w;
      }
    } else {
      for (int e = tid; e < rows * dn; e += kThreads) {
        const int r = e / dn;
        const int c = e - r * dn;
        s[r * stride + c] = to_f32(src[static_cast<int64_t>(r) * D + d0 + c]);
      }
    }
  };

  if (single) {
    stage(0, D);
    __syncthreads();
  }
  for (int g0 = 0; g0 < items; g0 += kThreads * kItems) {
    int a[kItems], b[kItems];
    float acc[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int it = g0 + k * kThreads + tid;
      a[k] = b[k] = 0;                     // a spare item reads row 0
      acc[k] = 0.f;
      if (it < items) {
        const int inst = it / P;
        int i, j;
        pair_of(it - inst * P, i, j);
        a[k] = (inst * F + i) * stride;
        b[k] = (inst * F + j) * stride;
      }
    }
    for (int d0 = 0; d0 < D; d0 += dc) {
      const int dn = D - d0 < dc ? D - d0 : dc;
      if (!single) {
        __syncthreads();                   // the last chunk's reads are done
        stage(d0, dn);
        __syncthreads();
      }
#pragma unroll 4
      for (int d = 0; d < dn; ++d) {
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          acc[k] = fmaf(s[a[k] + d], s[b[k] + d], acc[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int it = g0 + k * kThreads + tid;
      if (it < items) store(dst + it, acc[k]);
    }
  }
}

}  // namespace

// The largest F the kernel takes: one staged column of F rows, each padded
// by one float, must fit kSmemBytes.
int dot_interaction_max_features() { return kSmemBytes / (2 * 4); }

// feats (B, F, D) -> out (B, F (F - 1) / 2), both contiguous, of one dtype
// (bf16: bfloat16, else float32); B * P > 0, 1 <= F <=
// dot_interaction_max_features().  Launches on ``stream``.
void launch_dot_interaction(const void* feats, void* out, int64_t B, int F,
                            int D, bool bf16, cudaStream_t stream) {
  const int P = F * (F - 1) / 2;
  const int64_t row_bytes = (static_cast<int64_t>(D) + 1) * 4;
  int ipb, dc;
  if (F * row_bytes <= kSmemBytes) {
    dc = D;
    const int fit = static_cast<int>(kSmemBytes / (F * row_bytes));
    const int pass = P >= kThreads * kItems ? 1 : kThreads * kItems / P;
    ipb = fit < pass ? fit : pass;
  } else {
    ipb = 1;
    dc = kSmemBytes / (4 * F) - 1;
    if (D % 4 == 0 && dc >= 4) dc -= dc % 4;
  }
  const int elem = bf16 ? 2 : 4;
  const bool vec = D % 4 == 0 && dc % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(feats) % (4 * elem) == 0;
  const int64_t blocks = (B + ipb - 1) / ipb;
  const size_t smem = static_cast<size_t>(ipb) * F * (dc + 1) * 4;
  if (bf16) {
    dot_interaction_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
            static_cast<const __nv_bfloat16*>(feats),
            static_cast<__nv_bfloat16*>(out), B, F, D, P, ipb, dc, vec);
  } else {
    dot_interaction_kernel<float>
        <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
            static_cast<const float*>(feats), static_cast<float*>(out), B, F,
            D, P, ipb, dc, vec);
  }
}
