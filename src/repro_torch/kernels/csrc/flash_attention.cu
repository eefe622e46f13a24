// Causal (or full) softmax attention for Hopper (sm_90a), forward, with
// the online-softmax recurrence:
//
//   O[b, t, h] = sum_j softmax_j(q[b, t, h] . k[b, j, h / G] / sqrt(hd)
//                                + mask(t, j)) v[b, j, h / G],   G = H / Kv
//
// q (B, S, H, hd) and k, v (B, S, Kv, hd), contiguous, float32 or
// bfloat16 -> out (B, S, H, hd) in q's dtype.  Everything inside is
// float32: q is widened and scaled by 1/sqrt(hd) in float32, the scores,
// the running max m, the running sum l and the accumulator are float32,
// masked scores are -1e30, and the result is acc / max(l, 1e-30), cast
// back once.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas, pallas_call at :79; the body _flash_kernel at
// :24-56: the mask at :41, the accumulate at :50, the divide at :56).  That
// kernel takes GQA pre-flattened to (B*H, S, hd), with K and V repeated per
// group by its caller, walks the kv blocks as the TPU's sequential grid
// axis with m, l and acc in VMEM scratch, and asserts S % block == 0.
//
// What bounds it: operations.  At the prefill's shape (B 4, S 4096, H 40,
// Kv 8, hd 128, bf16, causal) the two products are 4 B H hd S (S + 1) / 2
// = 6.87e11 FLOP: 0.695 ms at the card's 989 TFLOP/s on bf16 tensor
// cores, while reading Q, K, V and writing O once is 403 MB, 0.120 ms at
// 3.35 TB/s.  This kernel does its FLOP as float32 FMAs on the CUDA cores,
// whose peak is 67 TFLOP/s, so it cannot take less than ~10 ms there.
//
// Design (a first, simple kernel; mma/wgmma, TMA and warp specialisation
// are later work):
// - Layout and GQA in the kernel: one block per (q tile of 64 rows, head h,
//   batch b) reads q in place, (B, S, H, hd), and KV head h / G of k and v
//   in place, (B, S, Kv, hd); nothing is transposed or repeated.
// - The TPU's sequential kv axis becomes a loop inside the block over kv
//   tiles of 64 rows, from position 0 upward, with tile edges at fixed
//   absolute positions, so row t's sums do not depend on S.  Under
//   causal the loop stops at the tile that holds the block's last row: the
//   tiles above the diagonal would add exp(-1e30 - m) = 0 and leave m, l
//   and acc as they are, so skipping them changes no bit.
// - Shared memory holds the block's q rows (scaled, float32), one kv tile
//   (K for the scores, then V for the product, in the same buffer) and the
//   tile's probabilities P; rows are padded by 4 floats, so the 16-byte
//   reads of 16 rows at one column fall in distinct banks.  85 KB at
//   hd <= 128: two blocks per SM.
// - 256 threads as 16 x 16: thread (ty, tx) owns q rows ty + 16 i (i < 4),
//   score columns tx + 16 j (j < 4) and output columns tx * 4 + 64 c + e.
//   A row's max and sum are reduced across its 16 threads by shuffles.
// - Any S: rows and kv positions at or past S are staged as zeros and
//   masked; hd any multiple of 8 up to 256, padded with zeros to 64, 128 or
//   256 (the template width); f32 and bf16 in, 16-byte-aligned tensors.
// - The heaviest q tiles (the last, under causal) are scheduled first.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 64;          // q rows of a block
constexpr int kBK = 64;          // kv rows of a tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kRows = kBQ / 16;  // q rows a thread owns
constexpr int kCols = kBK / 16;  // score columns a thread owns
constexpr int kPStride = kBK + 4;
constexpr float kMasked = -1e30f;

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

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  uint2 u;
  u.x = bf16_bits(x.x) | (bf16_bits(x.y) << 16);
  u.y = bf16_bits(x.z) | (bf16_bits(x.w) << 16);
  *reinterpret_cast<uint2*>(p) = u;
}

template <int HDP>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(kBQ + kBK) * (HDP + 4) +
          static_cast<size_t>(kBQ) * kPStride) * sizeof(float);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, HDP <= 128 ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int Kv, int hd, float scale, bool causal) {
  constexpr int kStride = HDP + 4;   // floats a staged row takes
  constexpr int kVecs = HDP / 4;     // float4s a staged row holds
  constexpr int kOut = HDP / 16;     // output columns a thread owns
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);   // [kBQ][kStride]
  float* skv = sq + kBQ * kStride;               // [kBK][kStride]
  float* sp = skv + kBK * kStride;               // [kBQ][kPStride]

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t q_row = static_cast<int64_t>(H) * hd;   // between positions
  const int64_t kv_row = static_cast<int64_t>(Kv) * hd;
  const T* qb = q + b * S * q_row + static_cast<int64_t>(h) * hd;
  const T* kb = k + b * S * kv_row + static_cast<int64_t>(kvh) * hd;
  const T* vb = v + b * S * kv_row + static_cast<int64_t>(kvh) * hd;
  T* ob = o + b * S * q_row + static_cast<int64_t>(h) * hd;

  // rows [r0, r0 + 64) of a (S, hd) slice with row stride `row` into dst as
  // float32, times `mul` when `scaled`; zeros past S and past hd
  auto stage = [&](float* dst, const T* src, int64_t row, int r0,
                   bool scaled) {
    for (int e = tid; e < 64 * kVecs; e += kThreads) {
      const int r = e / kVecs;
      const int c = (e - r * kVecs) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < S && c < hd) {
        x = load4(src + static_cast<int64_t>(r0 + r) * row + c);
        if (scaled) {
          x.x *= scale;
          x.y *= scale;
          x.z *= scale;
          x.w *= scale;
        }
      }
      store4(dst + r * kStride + c, x);
    }
  };

  stage(sq, qb, q_row, q0, true);
  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < kOut; ++n) acc[i][n] = 0.f;
  }

  const int last_row = min(q0 + kBQ, S) - 1;
  const int n_kt = causal ? last_row / kBK + 1 : (S + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                 // the last tile's reads are done
    stage(skv, kb, kv_row, k0, false);
    __syncthreads();

    // ---- scores of the tile: s[i][j] = q[row i] . k[column j]
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; d += 4) {
      float4 a[kRows], c4[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        a[i] = *reinterpret_cast<const float4*>(sq + (ty + 16 * i) * kStride
                                                + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        c4[j] = *reinterpret_cast<const float4*>(skv + (tx + 16 * j) * kStride
                                                 + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, c4[j].x, t);
          t = fmaf(a[i].y, c4[j].y, t);
          t = fmaf(a[i].z, c4[j].z, t);
          t = fmaf(a[i].w, c4[j].w, t);
          s[i][j] = t;
        }
    }

    // ---- mask, then the online-softmax update of m, l and acc
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = k0 + tx + 16 * j;
        if (c >= S || (causal && c > r)) s[i][j] = kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sp[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < kOut; ++n) acc[i][n] *= corr;
    }

    __syncthreads();                 // K's reads and P's writes are done
    stage(skv, vb, kv_row, k0, false);
    __syncthreads();

    // ---- acc[i][n] += sum_j P[row i][j] V[j][column n]
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 p4[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        p4[i] = *reinterpret_cast<const float4*>(sp + (ty + 16 * i) * kPStride
                                                 + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[kOut];
#pragma unroll
        for (int c = 0; c < kOut / 4; ++c) {
          const float4 x = *reinterpret_cast<const float4*>(
              skv + (j + jj) * kStride + tx * 4 + 64 * c);
          vv[4 * c] = x.x;
          vv[4 * c + 1] = x.y;
          vv[4 * c + 2] = x.z;
          vv[4 * c + 3] = x.w;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = jj == 0 ? p4[i].x
                        : jj == 1 ? p4[i].y
                        : jj == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int n = 0; n < kOut; ++n) acc[i][n] = fmaf(p, vv[n], acc[i][n]);
        }
      }
    }
  }

  // ---- out = acc / max(l, 1e-30), cast once
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOut / 4; ++c) {
      const int col = tx * 4 + 64 * c;
      if (col >= hd) continue;
      store4(ob + static_cast<int64_t>(r) * q_row + col,
             make_float4(acc[i][4 * c] / den, acc[i][4 * c + 1] / den,
                         acc[i][4 * c + 2] / den, acc[i][4 * c + 3] / den));
    }
  }
}

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t B, int S, int H, int Kv, int hd, bool causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HDP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, static_cast<unsigned>(B));
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  flash_attention_kernel<T, HDP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Kv, hd, scale,
      causal);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         void* o, int64_t B, int S, int H, int Kv, int hd,
                         bool causal, cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, B, S, H, Kv, hd, causal, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, B, S, H, Kv, hd, causal, stream);
  return launch<T, 256>(q, k, v, o, B, S, H, Kv, hd, causal, stream);
}

}  // namespace

// The widest head the kernel takes.
int flash_attention_max_head_dim() { return 256; }

// q (B, S, H, hd), k and v (B, S, Kv, hd) -> o (B, S, H, hd), all
// contiguous, 16-byte aligned and of one dtype (bf16: bfloat16, else
// float32); B, S >= 1, H % Kv == 0, hd % 8 == 0, hd <= 256, and B, H below
// 2^16.  Launches on ``stream``; returns the error of the shared-memory
// opt-in (the launch's own is left for cudaGetLastError).
cudaError_t launch_flash_attention(const void* q, const void* k,
                                   const void* v, void* o, int64_t B, int S,
                                   int H, int Kv, int hd, bool causal,
                                   bool bf16, cudaStream_t stream) {
  if (bf16)
    return launch_dtype<__nv_bfloat16>(q, k, v, o, B, S, H, Kv, hd, causal,
                                       stream);
  return launch_dtype<float>(q, k, v, o, B, S, H, Kv, hd, causal, stream);
}
