// Helpers of flash attention's kernels shared by the forward
// (flash_attention.cu, whose top describes both directions) and the
// backward (flash_attention_backward.cu): the tile constants, the local
// terms' bounds (first_key, last_row) and the tensor-core primitives
// (cp.async, ldmatrix, mma.sync, bf16 packing).  The two sources compile
// side by side.
#pragma once

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

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

template <int HDP>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(kBQ + kBK) * (HDP + 4) +
          static_cast<size_t>(kBQ) * kPStride) * sizeof(float);
}

// the first key row r sees under the local terms (0: none); see the top
__device__ __forceinline__ int first_key(int r, int window, int chunk) {
  int lo = 0;
  if (window > 0) lo = max(lo, r - window + 1);
  if (chunk > 0) lo = max(lo, r - r % chunk);
  return lo;
}

// the last row below S that sees key c under the local terms (0: none):
// min(S - 1, c + window - 1, the end of c's chunk), written so that no
// term overflows; non-decreasing in c
__device__ __forceinline__ int last_row(int c, int S, int window,
                                        int chunk) {
  int hi = S - 1;
  if (window > 0 && window - 1 < hi - c) hi = c + window - 1;
  if (chunk > 0) {
    const int c0 = c - c % chunk;
    if (chunk - 1 < hi - c0) hi = c0 + chunk - 1;
  }
  return hi;
}

// ------------------------------------- the bfloat16 kernel: tensor cores

constexpr int kMmaWarps = 8;                  // 16 q rows each
constexpr int kMmaBQ = 16 * kMmaWarps;        // q rows of a block
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBK = 64;                    // kv rows of a tile

// bf16s a staged row takes: 16 bytes of padding put the 8 rows that one
// ldmatrix phase reads into 8 distinct 16-byte bank groups
template <int HDP>
__host__ __device__ constexpr int mma_stride() { return HDP + 8; }

// the block's q rows, then two stages of (K tile, V tile)
template <int HDP>
constexpr size_t mma_smem_bytes() {
  return static_cast<size_t>(kMmaBQ + 4 * kMmaBK) * mma_stride<HDP>() *
         sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory past L1; zeros when src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 4 bytes from global to shared memory; zeros when src_bytes is 0
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

// rows [r0, r0 + n) of a (S, hd) bf16 slice with row stride `row` into dst
// (rows mma_stride<HDP>() apart) by cp.async, 16 bytes a thread of
// kThreads; zeros past S and past hd
template <int HDP, int kThreads>
__device__ __forceinline__ void cp_async_rows(__nv_bfloat16* dst,
                                              const __nv_bfloat16* src,
                                              int64_t row, int r0, int n,
                                              int S, int hd) {
  constexpr int kChunks = HDP / 8;     // 16-byte chunks of a staged row
  for (int e = threadIdx.x; e < n * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = (e - r * kChunks) * 8;
    const bool in = r0 + r < S && c < hd;
    cp_async16(smem_addr(dst + r * mma_stride<HDP>() + c),
               in ? src + static_cast<int64_t>(r0 + r) * row + c : src,
               in ? 16 : 0);
  }
}

// four 8 x 8 bf16 matrices, lane i giving a row address of matrix i / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, "
               "%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a b for a 16 x 16 bf16 (row major) and b 16 x 8 bf16 (column
// major): exact products, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as two bf16 (round to nearest even), x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x, y) = hi + lo to ~2^-18: hi = bf16(x, y), lo = bf16((x, y) - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

// ldmatrix row addresses of a lane, in bytes from a staged tile's first
// element: rows as the A operand (or, .trans, as B with k along the
// rows), and rows as B's columns (k along each row)
template <int HDP>
__device__ __forceinline__ uint32_t a_lane_bytes(int lane) {
  return (((lane & 7) + ((lane >> 3) & 1) * 8) * mma_stride<HDP>() +
          (lane >> 4) * 8) * 2;
}
template <int HDP>
__device__ __forceinline__ uint32_t b_lane_bytes(int lane) {
  return (((lane & 7) + (lane >> 4) * 8) * mma_stride<HDP>() +
          ((lane >> 3) & 1) * 8) * 2;
}

// rows [0, n) of a staged tile out to rows [r0, r0 + n) of a (S, hd) slice
// with row stride `row`, 16 bytes a thread (thread i of nt); nothing past S
// or past hd
template <int HDP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, int64_t row,
                                           const __nv_bfloat16* src, int r0,
                                           int n, int S, int hd, int i,
                                           int nt) {
  constexpr int kChunks = HDP / 8;
  for (int e = i; e < n * kChunks; e += nt) {
    const int r = e / kChunks;
    const int c = (e - r * kChunks) * 8;
    if (r0 + r < S && c < hd)
      *reinterpret_cast<uint4*>(dst + static_cast<int64_t>(r0 + r) * row +
                                c) =
          *reinterpret_cast<const uint4*>(src + r * mma_stride<HDP>() + c);
  }
}

}  // namespace

// The widest head either kernel takes (flash_attention.cu).
int flash_attention_max_head_dim();
