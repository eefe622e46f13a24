// Causal (or full) softmax attention for Hopper (sm_90a), forward, with
// the online-softmax recurrence:
//
//   O[b, t, h] = sum_j softmax_j(q[b, t, h] . k[b, j, h / G] / sqrt(hd)
//                                + mask(t, j)) v[b, j, h / G],   G = H / Kv
//
// q (B, S, H, hd) and k, v (B, S, Kv, hd), contiguous -> out (B, S, H, hd)
// in q's dtype.  Two kernels, picked by the dtype alone
// (launch_flash_attention):
// - bfloat16 -> the mma kernel (tensor cores, below);
// - float32  -> the fma kernel (CUDA cores, below).
// Neither stands in for the other; any other dtype, hd not a multiple of 8
// in [8, 256], or H not a multiple of Kv is refused.
//
// The local terms (the reference model's _mask, src/repro/models/
// transformer.py:168-180): a sliding window and a chunk, runtime arguments
// (0: none), on top of causal.  Row r then sees keys c in [lo(r), r],
// lo(r) = max(r - window + 1, r - r % chunk, 0): r - c < window and
// r / chunk == c / chunk.  lo is non-decreasing in r, and the diagonal is
// always seen, so no row is empty.  Both kernels (and the backward's four,
// below) take them as a template flag (kLocal), so the causal kernels are
// the instructions they were:
// - the kv loop starts at the tile that holds lo(first row of the block),
//   not at 0;
// - the mma kernel's warps skip a tile wholly before lo(first row of the
//   warp), as they skip one wholly above the diagonal;
// - the element mask adds c < lo(r): in the mma kernel in a tile that
//   reaches below lo of the warp's last row, in the fma kernel (which
//   masks every tile element by element) everywhere.
// A row whose first tiles are wholly masked for it (another row of its
// block sees them) ends them with m = -1e30; its first seen score then
// gives corr = exp(-1e30 - m_new) = 0, which zeroes l and acc exactly, so
// its bits are those of a loop that started at its own first tile.  With
// window >= S and chunk >= S, lo is 0 everywhere: the same tiles in the same
// order, the same bits as causal.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas, pallas_call at :79; the body _flash_kernel at
// :24-56: the mask at :41, the accumulate at :50, the divide at :56).  That
// kernel takes GQA pre-flattened to (B*H, S, hd), with K and V repeated per
// group by its caller, walks the kv blocks as the TPU's sequential grid
// axis with m, l and acc in VMEM scratch, and asserts S % block == 0.
//
// The numbers.  Masked scores are -1e30 (after the scale), m_new =
// max(m, rowmax), corr = expf(m - m_new), p = expf(s - m_new), l = l corr +
// sum p over the float32 p, and out = acc / max(l, 1e-30) in float32, cast
// back once.  Both kernels keep p in float32 for the product with v, as
// the TPU kernel does.  They differ in the scores:
// - fma: q is widened and scaled by 1/sqrt(hd) in float32 before the
//   product (the TPU kernel's order); products and sums in float32.
// - mma: the raw bf16 q and k go into the mma (exact products, float32
//   sums), then s = acc * scale: one float32 rounding per score away from
//   the TPU kernel's order.  p enters P V as two bf16 halves, p_hi =
//   bf16(p) and p_lo = bf16(p - p_hi), acc = acc corr + p_hi V + p_lo V:
//   p is carried to ~2^-18 relative and the products are exact.  Rounding
//   p once to bf16 (SDPA's way) would move the output tens of bf16 ulps.
//
// What bounds them: operations.  At the prefill's shape (B 4, S 4096, H
// 40, Kv 8, hd 128, bf16, causal) the two products are 4 B H hd S (S + 1)
// / 2 = 6.87e11 FLOP: 0.695 ms at the card's 989 TFLOP/s on bf16 tensor
// cores, while reading Q, K, V and writing O once is 403 MB, 0.120 ms at
// 3.35 TB/s.  The fma kernel does its FLOP on the CUDA cores (67 TFLOP/s
// peak in float32), so it cannot take less than ~10 ms there.
//
// The mma kernel (a first tensor-core kernel, FlashAttention-2's design
// with warp-level mma.sync; wgmma, TMA and warp specialisation are later
// work):
// - Blocks and warps: one block per (q tile of 128 rows, head h, batch b),
//   the heaviest causal tiles first; 8 warps of 16 q rows.  GQA in place:
//   KV head h / G of k and v, (B, S, Kv, hd), nothing repeated.  At
//   (4, 4096) the blocks read 5.5 GB of K and V (1056 tiles of 64 rows per
//   (b, h), mostly from L2); 64-row q tiles would read 10.9 GB.
// - Q: staged once by cp.async, then each warp keeps its 16 x HDP
//   fragments in registers (ldmatrix; 32 registers a thread at HDP 128).
//   At HDP 256 the output accumulator alone takes 128 registers, so Q
//   stays in shared memory and its fragments are reloaded per kv tile.
// - K and V: tiles of 64 rows in a two-stage shared-memory buffer, filled
//   by cp.async.cg (16 bytes a thread) for tile j + 1 while tile j
//   computes; one barrier per tile both publishes tile j and frees tile
//   j - 1's stage.  Rows are padded by 16 bytes, so the 8 row addresses of an
//   ldmatrix phase fall in distinct bank groups.  K feeds S = Q K^T
//   through ldmatrix (B operand, column major), V feeds P V through
//   ldmatrix.trans.
// - S = Q K^T and O += P V by mma.sync.aligned.m16n8k16.row.col.f32.bf16:
//   a warp keeps S (16 x 64, 32 floats a thread), m and l (its quad's
//   part, summed over the quad by shuffles at the end) and the output
//   accumulator (16 x HDP, 64 floats a thread at HDP 128) in registers;
//   the row max is reduced over the 4 threads of a quad by __shfl_xor_sync.
//   P goes from S's accumulator layout straight into the A operand's
//   (FlashAttention-2's trick), never through shared memory.  The two
//   halves of p make P V 1.5x the mma work of a bf16-p kernel: at
//   (4, 4096) 1.05e12 FLOP of mma issued for 6.87e11 useful.
// - Kv tiles have fixed absolute edges (0, 64, 128, ...); the loop walks up
//   from 0 and, under causal, stops at the tile that holds the block's
//   last row; a warp skips the last tile when it lies wholly above its
//   rows.  Skipped tiles would add exp(-1e30 - m) = 0 and leave m, l and
//   acc as they are, and nothing depends on S, so row t's bits do not
//   either.
// - Any S: rows and kv positions at or past S are staged as zeros (cp.async
//   with a zero source size) and masked; hd is padded with zeros to the
//   template width HDP = 64, 128 or 256 (a multiple of the mma's k of 16).
// - Registers (sm_90a; cuobjdump -res-usage of the built extension, as
//   chip_smoke.py phase 11 (a) prints it): mma<64> 158, mma<128> 235,
//   neither with a stack frame or a spill store; mma<256> 255 with an
//   8-byte stack frame and one STL.  One block of 256 threads per SM at
//   HDP 128 (235 x 256 registers).  Tried at (4, 4096) and not faster: 64-row q tiles
//   (two blocks per SM), 32-row kv tiles (PERF.md section 6).
//
// The fma kernel (cuobjdump: fma<64> 126 registers, fma<128> 128 with an
// 8-byte stack frame and two STL, fma<256> 167):
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
//   256 (the template width); 16-byte-aligned tensors.
// - The heaviest q tiles (the last, under causal) are scheduled first.
//
// The backward (kernel 9b, launch_flash_attention_backward) replaces no
// TPU kernel: the reference takes XLA's vjp of its attention.  From the
// forward's output O and row log-sum-exp, three launches: D = rowsum(dO O)
// (a warp a row), then dK and dV, then dQ; the dtype picks the kernels as
// in the forward.  No float atomics, so two runs give the same bits.
// What bounds it: operations, five products of 2 hd FLOP a (q, kv) pair:
// 4.30e11 FLOP at (1, 4096, 40, 8, 128) causal, 0.434 ms on bf16 tensor
// cores.
// - bfloat16 -> the mma kernels (FlashAttention-2's backward on the
//   forward's mma.sync, ldmatrix and cp.async helpers).  dK/dV: one block
//   per (128 kv rows, KV head, batch), 8 warps of 16 kv rows (at HDP 256
//   64 kv rows, two warps splitting a row group's dK and dV columns: two
//   16 x 256 float32 accumulators would not fit one warp's registers); the
//   block walks the G query heads of its KV head and the 64-row q tiles
//   that reach it (Q, dO, lse and D in a two-stage cp.async buffer), a
//   warp taking 32 q columns at a time: S^T = K Q^T and dP^T = V dO^T on
//   the tensor cores, P^T and dS^T in registers, then dV += P^T dO and
//   dK += dS^T Q with P^T and dS^T going from the accumulators straight
//   into the A operand.  dQ: one block per (128 q rows, head, batch), Q
//   and dO fragments in registers (reloaded per k step at HDP 256), K and
//   V tiles of 64 rows (32 at 256) in a two-stage buffer; it recomputes S
//   and dP and adds dQ += dS K: seven products where five are needed, the
//   price of no atomics.  Heaviest causal tiles first, the diagonal
//   skipped per warp, fixed absolute tile edges.
//   Roundings: P and dS enter their products rounded once to bf16 (SDPA's
//   and FlashAttention-2's way); sums are float32, dK and dQ times
//   1/sqrt(hd) after them, each gradient rounded once.  Against the plain
//   vjp (float32 inside): at most 7.75e-3 of a gradient's largest
//   magnitude on the card (chip_smoke.py phase 14 (a)), 7.4e-3 for the
//   CPU model of these roundings (tests/test_torch_flash_backward_bf16.py);
//   the tolerance is 2e-2.
//   Registers (sm_90a, cuobjdump -res-usage as phase 14 (a) prints it):
//   kv<64> 190, kv<128> 243, kv<256> 246, q<64> 153, q<128> 233, q<256>
//   244; no stack frame or spill store in any.
// - float32 -> the fma kernels (CUDA cores): the same split with 64-row
//   tiles (32 at HDP 256), P and dS through shared memory, s recomputed in
//   the forward's order (q scaled first).
// The local terms in the backward: the forward's window and chunk, behind
// the same kLocal flag, so the causal kernels stay the instructions they
// were.  Key c is seen by rows [c, last_row(c)], last_row(c) = min(S - 1,
// c + window - 1, the end of c's chunk), non-decreasing in c (first_key's
// mirror).  The dK/dV kernels' q loop stops at the tile that holds
// last_row of the block's last column; the dQ kernels' kv loop starts at
// the tile of the block's first row's first key.  An mma warp skips a
// step wholly past last_row of its last kv row (dK/dV) or wholly before
// first_key of its first q row (dQ), and masks element by element a step
// that crosses the window's far edge or a chunk boundary for any of its
// rows; the fma kernels mask every element.  A skipped step adds P = 0
// and dS = 0, as the causal skip does, so the bits are those of a loop
// over every tile; with window >= S and chunk >= S every bound is the
// causal one, the causal kernel's bits.  D is rowsum(dO O) as before, and
// no row is empty (the diagonal is always seen), so lse is finite.
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

template <typename T, int HDP, bool kLocal>
__global__ void __launch_bounds__(kThreads, HDP <= 128 ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int S, int H, int Kv, int hd,
                       float scale, bool causal, int window, int chunk) {
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
  // under the local terms: each row's first key, and the block's first tile
  int lo[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    lo[i] = kLocal ? first_key(q0 + ty + 16 * i, window, chunk) : 0;
  const int kt0 = kLocal ? first_key(q0, window, chunk) / kBK : 0;
  for (int kt = kt0; kt < n_kt; ++kt) {
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
        if (c >= S || (causal && c > r) || (kLocal && c < lo[i]))
          s[i][j] = kMasked;
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

  // ---- out = acc / max(l, 1e-30), cast once; the row's log-sum-exp
  // m + log(max(l, 1e-30)) when asked for (m and l are the row's, in each
  // of its 16 threads)
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[(b * H + h) * static_cast<int64_t>(S) + r] = m[i] + logf(den);
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

template <typename T, int HDP, bool kLocal>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int64_t B, int S, int H, int Kv, int hd,
                   bool causal, int window, int chunk, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HDP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HDP, kLocal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, static_cast<unsigned>(B));
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  flash_attention_kernel<T, HDP, kLocal><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, Kv, hd,
      scale, causal, window, chunk);
  return cudaSuccess;
}

template <typename T, bool kLocal>
cudaError_t launch_width(const void* q, const void* k, const void* v,
                         void* o, float* lse, int64_t B, int S, int H, int Kv,
                         int hd, bool causal, int window, int chunk,
                         cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64, kLocal>(q, k, v, o, lse, B, S, H, Kv, hd, causal,
                                 window, chunk, stream);
  if (hd <= 128)
    return launch<T, 128, kLocal>(q, k, v, o, lse, B, S, H, Kv, hd, causal,
                                  window, chunk, stream);
  return launch<T, 256, kLocal>(q, k, v, o, lse, B, S, H, Kv, hd, causal,
                                window, chunk, stream);
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         void* o, float* lse, int64_t B, int S, int H, int Kv,
                         int hd, bool causal, int window, int chunk,
                         cudaStream_t stream) {
  if (window > 0 || chunk > 0)
    return launch_width<T, true>(q, k, v, o, lse, B, S, H, Kv, hd, causal,
                                 window, chunk, stream);
  return launch_width<T, false>(q, k, v, o, lse, B, S, H, Kv, hd, causal, 0,
                                0, stream);
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

template <int HDP, bool kLocal>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int S, int H, int Kv,
                           int hd, float scale, bool causal, int window,
                           int chunk) {
  constexpr int kStride = mma_stride<HDP>();
  constexpr int kKs = HDP / 16;        // k steps of q . k over hd
  constexpr int kN = kMmaBK / 8;       // 8-column score tiles of a warp
  constexpr int kOutN = HDP / 8;       // 8-column output tiles of a warp
  constexpr bool kQInRegs = HDP <= 128;
  constexpr uint32_t kStageBytes = 2 * kMmaBK * kStride * 2;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* skv = sq + kMmaBQ * kStride;

  const int n_qt = (S + kMmaBQ - 1) / kMmaBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kMmaBQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;             // the fragments' row in 8
  const int t = lane & 3;              // the fragments' column pair
  const int64_t q_row = static_cast<int64_t>(H) * hd;
  const int64_t kv_row = static_cast<int64_t>(Kv) * hd;
  const __nv_bfloat16* qb = q + b * S * q_row + static_cast<int64_t>(h) * hd;
  const __nv_bfloat16* kb = k + b * S * kv_row + static_cast<int64_t>(kvh) * hd;
  const __nv_bfloat16* vb = v + b * S * kv_row + static_cast<int64_t>(kvh) * hd;
  __nv_bfloat16* ob = o + b * S * q_row + static_cast<int64_t>(h) * hd;

  auto stage = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int64_t row,
                   int r0, int n) {
    cp_async_rows<HDP, kMmaThreads>(dst, src, row, r0, n, S, hd);
  };
  auto stage_kv = [&](int kt) {
    __nv_bfloat16* dst = skv + (kt & 1) * 2 * kMmaBK * kStride;
    stage(dst, kb, kv_row, kt * kMmaBK, kMmaBK);
    stage(dst + kMmaBK * kStride, vb, kv_row, kt * kMmaBK, kMmaBK);
  };

  const int last_row = min(q0 + kMmaBQ, S) - 1;
  const int n_kt = causal ? last_row / kMmaBK + 1 : (S + kMmaBK - 1) / kMmaBK;
  // under the local terms the block starts at the tile of its first row's
  // first key
  const int kt0 = kLocal ? first_key(q0, window, chunk) / kMmaBK : 0;
  stage(sq, qb, q_row, q0, kMmaBQ);
  stage_kv(kt0);
  cp_async_commit();

  // the lanes' row addresses for ldmatrix: Q as the A operand, K as B
  // (kv rows are B's columns), V transposed as B
  const int wr0 = warp * 16;           // the warp's first row in the block
  const uint32_t q_lane = smem_addr(sq + wr0 * kStride) +
                          a_lane_bytes<HDP>(lane);
  const uint32_t k_lane = b_lane_bytes<HDP>(lane);
  const uint32_t v_lane = a_lane_bytes<HDP>(lane);
  const uint32_t skv0 = smem_addr(skv);

  uint32_t qf[kQInRegs ? kKs : 1][4];
  float acc[kOutN][4];
#pragma unroll
  for (int n = 0; n < kOutN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows row0 (fragment elements 0, 1) and row0 + 8 (elements 2, 3); l is
  // this thread's part of the row sum, added over the quad at the end
  const int row0 = q0 + wr0 + g;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  // under the local terms: the first key of rows row0 and row0 + 8, and of
  // the warp's first and last rows
  const int lo0 = kLocal ? first_key(row0, window, chunk) : 0;
  const int lo1 = kLocal ? first_key(row0 + 8, window, chunk) : 0;
  const int lo_first = kLocal ? first_key(q0 + wr0, window, chunk) : 0;
  const int lo_last = kLocal ? first_key(q0 + wr0 + 15, window, chunk) : 0;

  for (int kt = kt0; kt < n_kt; ++kt) {
    cp_async_wait<0>();                // tile kt (and, first, q) landed
    // every warp is past tile kt - 1, so its stage may be refilled
    __syncthreads();
    if (kt + 1 < n_kt) {
      stage_kv(kt + 1);
      cp_async_commit();
    }
    if constexpr (kQInRegs) {
      if (kt == kt0) {
#pragma unroll
        for (int kk = 0; kk < kKs; ++kk) ldsm_x4(qf[kk], q_lane + kk * 32);
      }
    }
    const int k0 = kt * kMmaBK;
    // under causal a tile wholly above the warp's rows would add exp(-1e30
    // - m) = 0 and leave m, l and acc as they are: skipped; so is one
    // wholly before the first key of the warp's rows
    if ((!causal || k0 <= q0 + wr0 + 15) &&
        (!kLocal || k0 + kMmaBK > lo_first)) {
      const uint32_t sk = skv0 + (kt & 1) * kStageBytes;
      const uint32_t sv = sk + kMmaBK * kStride * 2;

      // ---- s = q . k over the tile's 64 columns
      float s[kN][4];
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        uint32_t qa[4];
        if constexpr (kQInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
        } else {
          ldsm_x4(qa, q_lane + kk * 32);
        }
#pragma unroll
        for (int nn = 0; nn < kN / 2; ++nn) {
          uint32_t kf[4];
          ldsm_x4(kf, sk + k_lane + (nn * 16 * kStride + kk * 16) * 2);
          mma_bf16(s[2 * nn], qa, kf[0], kf[1]);
          mma_bf16(s[2 * nn + 1], qa, kf[2], kf[3]);
        }
      }

      // ---- scale, mask, then the online-softmax update of m, l and acc
      const bool edge = k0 + kMmaBK > S ||
                        (causal && k0 + kMmaBK - 1 > q0 + wr0) ||
                        (kLocal && k0 < lo_last);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (edge) {
            const int c = k0 + 8 * j + 2 * t + (e & 1);
            const int r = row0 + (e >> 1) * 8;
            if (c >= S || (causal && c > r) ||
                (kLocal && c < ((e >> 1) ? lo1 : lo0)))
              x = kMasked;
          }
          s[j][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      const float corr0 = expf(m0 - mn0);
      const float corr1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= corr0;
      l1 *= corr1;
      // p as the A operand of P V, in two bf16 halves: 16-column chunk
      // j / 2, elements 0 and 2 for row0, 1 and 3 for row0 + 8
      uint32_t ph[kN / 2][4], pl[kN / 2][4];
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float p0 = expf(s[j][0] - mn0);
        const float p1 = expf(s[j][1] - mn0);
        const float p2 = expf(s[j][2] - mn1);
        const float p3 = expf(s[j][3] - mn1);
        l0 += p0;
        l0 += p1;
        l1 += p2;
        l1 += p3;
        split_bf16(p0, p1, ph[j / 2][(j & 1) * 2], pl[j / 2][(j & 1) * 2]);
        split_bf16(p2, p3, ph[j / 2][(j & 1) * 2 + 1],
                   pl[j / 2][(j & 1) * 2 + 1]);
      }
#pragma unroll
      for (int n = 0; n < kOutN; ++n) {
        acc[n][0] *= corr0;
        acc[n][1] *= corr0;
        acc[n][2] *= corr1;
        acc[n][3] *= corr1;
      }

      // ---- acc += p_hi v + p_lo v
#pragma unroll
      for (int kc = 0; kc < kN / 2; ++kc)
#pragma unroll
        for (int np = 0; np < kOutN / 2; ++np) {
          uint32_t vf[4];
          ldsm_x4_trans(vf, sv + v_lane + (kc * 16 * kStride + np * 16) * 2);
          mma_bf16(acc[2 * np], ph[kc], vf[0], vf[1]);
          mma_bf16(acc[2 * np], pl[kc], vf[0], vf[1]);
          mma_bf16(acc[2 * np + 1], ph[kc], vf[2], vf[3]);
          mma_bf16(acc[2 * np + 1], pl[kc], vf[2], vf[3]);
        }
    }
  }

  // ---- out = acc / max(l, 1e-30), cast once; staged in the warp's own
  // q rows, then stored 16 bytes a lane
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f);
  const float den1 = fmaxf(l1, 1e-30f);
  // the rows' log-sum-exp when asked for (m and l are the quad's rows')
  if (lse != nullptr && t == 0) {
    float* lrow = lse + (b * H + h) * static_cast<int64_t>(S);
    if (row0 < S) lrow[row0] = m0 + logf(den0);
    if (row0 + 8 < S) lrow[row0 + 8] = m1 + logf(den1);
  }
  __nv_bfloat16* so = sq + wr0 * kStride;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < kOutN; ++n) {
    *reinterpret_cast<uint32_t*>(so + g * kStride + 8 * n + 2 * t) =
        pack_bf16(acc[n][0] / den0, acc[n][1] / den0);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * kStride + 8 * n + 2 * t) =
        pack_bf16(acc[n][2] / den1, acc[n][3] / den1);
  }
  __syncwarp();
  store_rows<HDP>(ob, q_row, so, q0 + wr0, 16, S, hd, lane, 32);
}

template <int HDP, bool kLocal>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int64_t B, int S, int H, int Kv, int hd,
                       bool causal, int window, int chunk,
                       cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<HDP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel<HDP, kLocal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kMmaBQ - 1) / kMmaBQ, H, static_cast<unsigned>(B));
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  using bf16 = __nv_bfloat16;
  flash_attention_mma_kernel<HDP, kLocal>
      <<<grid, kMmaThreads, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, S, H, Kv,
          hd, scale, causal, window, chunk);
  return cudaSuccess;
}

template <bool kLocal>
cudaError_t launch_mma_width(const void* q, const void* k, const void* v,
                             void* o, float* lse, int64_t B, int S, int H,
                             int Kv, int hd, bool causal, int window,
                             int chunk, cudaStream_t stream) {
  if (hd <= 64)
    return launch_mma<64, kLocal>(q, k, v, o, lse, B, S, H, Kv, hd, causal,
                                  window, chunk, stream);
  if (hd <= 128)
    return launch_mma<128, kLocal>(q, k, v, o, lse, B, S, H, Kv, hd, causal,
                                   window, chunk, stream);
  return launch_mma<256, kLocal>(q, k, v, o, lse, B, S, H, Kv, hd, causal,
                                 window, chunk, stream);
}


// ------------------------------------------- the backward (kernel 9b)

constexpr int kBwdThreads = 256;     // 16 x 16 (fma), 8 warps (mma)

// four consecutive elements as float32 (16 bytes of float32, 8 of bf16)
__device__ __forceinline__ float4 load4f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4f(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 c = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, c.x, c.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// D[b, h, t] = sum_d dO[b, t, h, d] O[b, t, h, d] in float32: one warp a
// row of the (B, S, H, hd) layout, the lanes' partial sums added by shuffles
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
flash_attention_bwd_delta_kernel(const T* __restrict__ o,
                                 const T* __restrict__ dout,
                                 float* __restrict__ delta, int64_t rows,
                                 int S, int H, int hd) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (kBwdThreads / 32) +
                    (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* po = o + r * hd;
  const T* pd = dout + r * hd;
  float acc = 0.f;
  for (int c = lane * 4; c < hd; c += 128) acc = dot4(load4f(po + c),
                                                      load4f(pd + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(r % H);
    const int64_t bt = r / H;                       // b * S + t
    delta[(bt / S * H + h) * S + bt % S] = acc;
  }
}

template <typename T>
void launch_delta(const void* o, const void* dout, float* delta, int64_t B,
                  int S, int H, int hd, cudaStream_t stream) {
  const int64_t rows = B * S * H;
  constexpr int64_t kWarps = kBwdThreads / 32;
  flash_attention_bwd_delta_kernel<T>
      <<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kBwdThreads, 0,
         stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout),
                   delta, rows, S, H, hd);
}

// ---- float32: the fma kernels (CUDA cores)

// the q and kv tile of the fma backward: 64 rows up to HDP 128, 32 at 256
template <int HDP>
__host__ __device__ constexpr int bwd_tile() { return HDP <= 128 ? 64 : 32; }

// K, V, Q and dO tiles (rows padded by 4 floats), then P and dS (the kv
// kernel; the q kernel uses dS only), then lse and D of the tile's q rows
template <int HDP>
constexpr size_t bwd_smem_bytes() {
  constexpr int T = bwd_tile<HDP>();
  return (static_cast<size_t>(4 * T) * (HDP + 4) +
          static_cast<size_t>(2 * T) * (T + 4) + 2 * T) * sizeof(float);
}

// What both fma kernels share: the block's geometry and staging, and one
// (q tile, kv tile) pair's P and dS.  Scores are recomputed in the
// forward's order: q staged times 1/sqrt(hd), s = q_scaled . k.
template <int HDP>
struct BwdTile {
  static constexpr int kT = bwd_tile<HDP>();
  static constexpr int kR = kT / 16;          // q rows (kv rows) a thread owns
  static constexpr int kC = kT / 16;          // score columns a thread owns
  static constexpr int kOut = HDP / 16;       // output columns a thread owns
  static constexpr int kStride = HDP + 4;     // floats a staged row takes
  static constexpr int kPStride = kT + 4;

  // rows [r0, r0 + kT) of a (S, hd) slice with row stride `row` into dst,
  // times `mul`; zeros past S and past hd
  __device__ static void stage(float* dst, const float* src, int64_t row,
                               int r0, int S, int hd, float mul) {
    for (int e = threadIdx.x; e < kT * (HDP / 4); e += kBwdThreads) {
      const int r = e / (HDP / 4);
      const int c = (e - r * (HDP / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < S && c < hd) {
        x = load4f(src + static_cast<int64_t>(r0 + r) * row + c);
        x.x *= mul;
        x.y *= mul;
        x.z *= mul;
        x.w *= mul;
      }
      store4(dst + r * kStride + c, x);
    }
  }

  // lse and D of q rows [q0, q0 + kT) (zeros past S)
  __device__ static void stage_rows(float* slse, float* sd, const float* lse,
                                    const float* delta, int q0, int S) {
    for (int e = threadIdx.x; e < kT; e += kBwdThreads) {
      const bool in = q0 + e < S;
      slse[e] = in ? lse[q0 + e] : 0.f;
      sd[e] = in ? delta[q0 + e] : 0.f;
    }
  }

  // thread (ty, tx)'s P and dS of the pair: q rows ty + 16 a, kv columns
  // tx + 16 c; P = exp(s - lse) (0 where masked or past S), dS = P (dP - D)
  // with dP = dO . V; under kLocal a column before its row's first key is
  // masked too
  template <bool kLocal>
  __device__ static void p_ds(const float* sq, const float* sdo,
                              const float* sk, const float* sv,
                              const float* slse, const float* sd, int q0,
                              int k0, int S, int hd, bool causal,
                              int window, int chunk,
                              float (&p)[kR][kC], float (&ds)[kR][kC]) {
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
    float s[kR][kC], dp[kR][kC];
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int c = 0; c < kC; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < hd; d += 4) {
      float4 qa[kR], da[kR];
#pragma unroll
      for (int a = 0; a < kR; ++a) {
        qa[a] = load4f(sq + (ty + 16 * a) * kStride + d);
        da[a] = load4f(sdo + (ty + 16 * a) * kStride + d);
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float4 kc = load4f(sk + (tx + 16 * c) * kStride + d);
        const float4 vc = load4f(sv + (tx + 16 * c) * kStride + d);
#pragma unroll
        for (int a = 0; a < kR; ++a) {
          s[a][c] = dot4(qa[a], kc, s[a][c]);
          dp[a][c] = dot4(da[a], vc, dp[a][c]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kR; ++a) {
      const int r = q0 + ty + 16 * a;
      const int lo = kLocal ? first_key(r, window, chunk) : 0;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int col = k0 + tx + 16 * c;
        const bool live = r < S && col < S && !(causal && col > r) &&
                          !(kLocal && col < lo);
        p[a][c] = live ? expf(s[a][c] - slse[ty + 16 * a]) : 0.f;
        ds[a][c] = p[a][c] * (dp[a][c] - sd[ty + 16 * a]);
      }
    }
  }

  // acc[a][n] += sum_j w[row ty + 16 a][j] x[j][column n] over the tile's
  // kT rows j of x; w in shared memory with row stride kPStride (wt: read
  // transposed, w[j][row])
  __device__ static void accumulate(float (&acc)[kR][kOut], const float* w,
                                    bool wt, const float* x) {
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      float wj[kR];
#pragma unroll
      for (int a = 0; a < kR; ++a)
        wj[a] = wt ? w[j * kPStride + ty + 16 * a]
                   : w[(ty + 16 * a) * kPStride + j];
#pragma unroll
      for (int c = 0; c < kOut / 4; ++c) {
        const float4 xv = load4f(x + j * kStride + tx * 4 + 64 * c);
#pragma unroll
        for (int a = 0; a < kR; ++a) {
          acc[a][4 * c] = fmaf(wj[a], xv.x, acc[a][4 * c]);
          acc[a][4 * c + 1] = fmaf(wj[a], xv.y, acc[a][4 * c + 1]);
          acc[a][4 * c + 2] = fmaf(wj[a], xv.z, acc[a][4 * c + 2]);
          acc[a][4 * c + 3] = fmaf(wj[a], xv.w, acc[a][4 * c + 3]);
        }
      }
    }
  }

  // rows r0 + ty + 16 a of a (S, hd) output slice: acc times mul
  __device__ static void write(float* dst, int64_t row, int r0, int S,
                               int hd, const float (&acc)[kR][kOut],
                               float mul) {
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
#pragma unroll
    for (int a = 0; a < kR; ++a) {
      const int r = r0 + ty + 16 * a;
      if (r >= S) continue;
#pragma unroll
      for (int c = 0; c < kOut / 4; ++c) {
        const int col = tx * 4 + 64 * c;
        if (col >= hd) continue;
        store4(dst + static_cast<int64_t>(r) * row + col,
               make_float4(acc[a][4 * c] * mul, acc[a][4 * c + 1] * mul,
                           acc[a][4 * c + 2] * mul,
                           acc[a][4 * c + 3] * mul));
      }
    }
  }
};

// dK and dV: one block per (kv tile, KV head, batch), looping over the G
// query heads of its KV head and, for each, over the q tiles that reach
// the kv tile (under causal from the diagonal tile on; under kLocal up to
// the tile that holds the last row that sees the kv tile's last column):
//   dV += P^T dO,   dK += dS^T Q (q staged scaled, so dK needs no scale).
// Nothing else writes the block's rows, so no atomics: the sums run in one
// fixed order.
template <int HDP, bool kLocal>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_attention_bwd_kv_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int S, int H, int Kv, int hd, float scale,
                              bool causal, int window, int chunk) {
  using Tile = BwdTile<HDP>;
  constexpr int kT = Tile::kT;
  constexpr int kStride = Tile::kStride;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + kT * kStride;
  float* sq = sv + kT * kStride;
  float* sdo = sq + kT * kStride;
  float* sp = sdo + kT * kStride;
  float* sds = sp + kT * Tile::kPStride;
  float* slse = sds + kT * Tile::kPStride;
  float* sd = slse + kT;

  const int kt = blockIdx.x;           // the heaviest (first) tiles first
  const int k0 = kt * kT;
  const int kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int G = H / Kv;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int64_t q_row = static_cast<int64_t>(H) * hd;
  const int64_t kv_row = static_cast<int64_t>(Kv) * hd;

  Tile::stage(sk, k + b * S * kv_row + static_cast<int64_t>(kvh) * hd,
              kv_row, k0, S, hd, 1.f);
  Tile::stage(sv, v + b * S * kv_row + static_cast<int64_t>(kvh) * hd,
              kv_row, k0, S, hd, 1.f);
  float acc_k[Tile::kR][Tile::kOut], acc_v[Tile::kR][Tile::kOut];
#pragma unroll
  for (int a = 0; a < Tile::kR; ++a)
#pragma unroll
    for (int n = 0; n < Tile::kOut; ++n) acc_k[a][n] = acc_v[a][n] = 0.f;

  const int n_qt =
      kLocal ? last_row(min(k0 + kT, S) - 1, S, window, chunk) / kT + 1
             : (S + kT - 1) / kT;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* qh = q + b * S * q_row + static_cast<int64_t>(h) * hd;
    const float* doh = dout + b * S * q_row + static_cast<int64_t>(h) * hd;
    const float* lh = lse + (b * H + h) * static_cast<int64_t>(S);
    const float* dh = delta + (b * H + h) * static_cast<int64_t>(S);
    for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();                 // the last pair's reads are done
      Tile::stage(sq, qh, q_row, q0, S, hd, scale);
      Tile::stage(sdo, doh, q_row, q0, S, hd, 1.f);
      Tile::stage_rows(slse, sd, lh, dh, q0, S);
      __syncthreads();
      float p[Tile::kR][Tile::kC], ds[Tile::kR][Tile::kC];
      Tile::template p_ds<kLocal>(sq, sdo, sk, sv, slse, sd, q0, k0, S, hd,
                                  causal, window, chunk, p, ds);
#pragma unroll
      for (int a = 0; a < Tile::kR; ++a)
#pragma unroll
        for (int c = 0; c < Tile::kC; ++c) {
          sp[(ty + 16 * a) * Tile::kPStride + tx + 16 * c] = p[a][c];
          sds[(ty + 16 * a) * Tile::kPStride + tx + 16 * c] = ds[a][c];
        }
      __syncthreads();
      // the block's kv rows are P's and dS's columns: read transposed
      Tile::accumulate(acc_v, sp, true, sdo);
      Tile::accumulate(acc_k, sds, true, sq);
    }
  }
  Tile::write(dk + b * S * kv_row + static_cast<int64_t>(kvh) * hd, kv_row,
              k0, S, hd, acc_k, 1.f);
  Tile::write(dv + b * S * kv_row + static_cast<int64_t>(kvh) * hd, kv_row,
              k0, S, hd, acc_v, 1.f);
}

// dQ: one block per (q tile, head, batch), the heaviest causal tiles
// first, looping over the kv tiles up to the diagonal (under kLocal from
// the tile of the block's first row's first key): dQ += dS K, times
// 1/sqrt(hd) at the end.
template <int HDP, bool kLocal>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_attention_bwd_q_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dq, int S, int H, int Kv,
                             int hd, float scale, bool causal, int window,
                             int chunk) {
  using Tile = BwdTile<HDP>;
  constexpr int kT = Tile::kT;
  constexpr int kStride = Tile::kStride;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + kT * kStride;
  float* sq = sv + kT * kStride;
  float* sdo = sq + kT * kStride;
  float* sds = sdo + kT * kStride + kT * Tile::kPStride;
  float* slse = sds + kT * Tile::kPStride;
  float* sd = slse + kT;

  const int n_qt = (S + kT - 1) / kT;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kT;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int64_t q_row = static_cast<int64_t>(H) * hd;
  const int64_t kv_row = static_cast<int64_t>(Kv) * hd;
  const float* kb = k + b * S * kv_row + static_cast<int64_t>(kvh) * hd;
  const float* vb = v + b * S * kv_row + static_cast<int64_t>(kvh) * hd;

  Tile::stage(sq, q + b * S * q_row + static_cast<int64_t>(h) * hd, q_row,
              q0, S, hd, scale);
  Tile::stage(sdo, dout + b * S * q_row + static_cast<int64_t>(h) * hd,
              q_row, q0, S, hd, 1.f);
  Tile::stage_rows(slse, sd, lse + (b * H + h) * static_cast<int64_t>(S),
                   delta + (b * H + h) * static_cast<int64_t>(S), q0, S);
  float acc[Tile::kR][Tile::kOut];
#pragma unroll
  for (int a = 0; a < Tile::kR; ++a)
#pragma unroll
    for (int n = 0; n < Tile::kOut; ++n) acc[a][n] = 0.f;

  const int last_row = min(q0 + kT, S) - 1;
  const int n_kt = causal ? last_row / kT + 1 : n_qt;
  const int kt0 = kLocal ? first_key(q0, window, chunk) / kT : 0;
  for (int kt = kt0; kt < n_kt; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();                   // the last tile's reads are done
    Tile::stage(sk, kb, kv_row, k0, S, hd, 1.f);
    Tile::stage(sv, vb, kv_row, k0, S, hd, 1.f);
    __syncthreads();
    float p[Tile::kR][Tile::kC], ds[Tile::kR][Tile::kC];
    Tile::template p_ds<kLocal>(sq, sdo, sk, sv, slse, sd, q0, k0, S, hd,
                                causal, window, chunk, p, ds);
#pragma unroll
    for (int a = 0; a < Tile::kR; ++a)
#pragma unroll
      for (int c = 0; c < Tile::kC; ++c)
        sds[(ty + 16 * a) * Tile::kPStride + tx + 16 * c] = ds[a][c];
    __syncthreads();
    Tile::accumulate(acc, sds, false, sk);
  }
  Tile::write(dq + b * S * q_row + static_cast<int64_t>(h) * hd, q_row, q0,
              S, hd, acc, scale);
}

template <int HDP, bool kLocal>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int64_t B,
                       int S, int H, int Kv, int hd, bool causal, int window,
                       int chunk, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<HDP>();
  constexpr int kT = bwd_tile<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_kv_kernel<HDP, kLocal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      flash_attention_bwd_q_kernel<HDP, kLocal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  launch_delta<float>(o, dout, delta, B, S, H, hd, stream);
  const int n_t = (S + kT - 1) / kT;
  flash_attention_bwd_kv_kernel<HDP, kLocal>
      <<<dim3(n_t, Kv, static_cast<unsigned>(B)), kBwdThreads, smem,
         stream>>>(tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk),
                   static_cast<float*>(dv), S, H, Kv, hd, scale, causal,
                   window, chunk);
  flash_attention_bwd_q_kernel<HDP, kLocal>
      <<<dim3(n_t, H, static_cast<unsigned>(B)), kBwdThreads, smem,
         stream>>>(tq, tk, tv, tdo, lse, delta, static_cast<float*>(dq), S,
                   H, Kv, hd, scale, causal, window, chunk);
  return cudaSuccess;
}

// ---- bfloat16: the mma kernels (tensor cores)

constexpr int kBwdStep = 32;     // q (dK/dV) or kv (dQ) columns a warp step
constexpr int kBwdQTile = 64;    // q rows of a dK/dV stage
constexpr int kBwdDqRows = 128;  // q rows of a dQ block, 16 a warp

// warps that share a row group, each taking HDP / split of dK's and dV's
// columns: 2 at HDP 256, whose two 16 x 256 float32 accumulators would not
// fit one warp's registers
template <int HDP>
__host__ __device__ constexpr int bwd_split() { return HDP > 128 ? 2 : 1; }
// kv rows of a dK/dV block (16 a row group) and of a dQ stage
template <int HDP>
__host__ __device__ constexpr int bwd_kv_rows() {
  return 128 / bwd_split<HDP>();
}
template <int HDP>
__host__ __device__ constexpr int bwd_dq_kv_rows() {
  return 64 / bwd_split<HDP>();
}

// K and V tiles, two stages of (Q tile, dO tile), two of (lse, D)
template <int HDP>
constexpr size_t bwd_kv_mma_smem_bytes() {
  return static_cast<size_t>(2 * bwd_kv_rows<HDP>() + 4 * kBwdQTile) *
             mma_stride<HDP>() * sizeof(__nv_bfloat16) +
         4 * kBwdQTile * sizeof(float);
}
// Q and dO tiles, two stages of (K tile, V tile)
template <int HDP>
constexpr size_t bwd_q_mma_smem_bytes() {
  return static_cast<size_t>(2 * kBwdDqRows + 4 * bwd_dq_kv_rows<HDP>()) *
         mma_stride<HDP>() * sizeof(__nv_bfloat16);
}


// a warp's 16 x 8 kN float32 accumulator tiles, times mul, as bf16 into
// rows [0, 16) of dst from column c0
template <int HDP, int kN>
__device__ __forceinline__ void put_acc(__nv_bfloat16* dst, int c0,
                                        const float (&acc)[kN][4],
                                        float mul) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  constexpr int kStride = mma_stride<HDP>();
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    __nv_bfloat16* p = dst + g * kStride + c0 + 8 * n + 2 * t;
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(acc[n][0] * mul,
                                                acc[n][1] * mul);
    *reinterpret_cast<uint32_t*>(p + 8 * kStride) =
        pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
}


// dK and dV on the tensor cores: one block per (kv tile, KV head, batch),
// the heaviest causal tiles first; warp w owns kv rows 16 (w % R) of the
// tile (R row groups) and dK's and dV's columns [c0, c0 + HDP / split).
// The block walks its G query heads and, for each, the q tiles of 64 rows
// that reach the kv tile (two-stage cp.async: tile i + 1 loads while tile
// i computes); a warp takes a tile 32 q columns at a time:
//   S^T = K Q^T, dP^T = V dO^T                          (mma, K and V
//      fragments by ldmatrix, Q and dO as B)
//   P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - D)   (registers)
//   dV += bf16(P^T) dO, dK += bf16(dS^T) Q              (mma, P^T and dS^T
//      straight from the accumulators into the A operand)
// dK times 1/sqrt(hd) once at the end.  Nothing else writes the block's
// rows: the sums run in one fixed order, no atomics.  Under kLocal the q
// tiles end at the one that holds the last row that sees the block's last
// column (last_row), a warp skips a step wholly past last_row of its last
// row, and a step that reaches past last_row of its first row is masked
// element by element.
template <int HDP, bool kLocal>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_attention_bwd_kv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const __nv_bfloat16* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta,
                                  __nv_bfloat16* __restrict__ dk,
                                  __nv_bfloat16* __restrict__ dv, int S,
                                  int H, int Kv, int hd, float scale,
                                  bool causal, int window, int chunk) {
  using bf16 = __nv_bfloat16;
  constexpr int kStride = mma_stride<HDP>();
  constexpr int kKs = HDP / 16;              // k steps over hd
  constexpr int kBK = bwd_kv_rows<HDP>();
  constexpr int kGroups = kBK / 16;          // row groups
  constexpr int kW = HDP / bwd_split<HDP>(); // dK and dV columns of a warp
  constexpr int kN = kBwdStep / 8;           // 8-column score tiles a step
  constexpr uint32_t kTileBytes = kBwdQTile * kStride * 2;
  extern __shared__ float4 smem4[];
  bf16* sk = reinterpret_cast<bf16*>(smem4);
  bf16* sv = sk + kBK * kStride;
  bf16* sqd = sv + kBK * kStride;      // stage s: Q at 2 s, dO at 2 s + 1
  float* srow = reinterpret_cast<float*>(sqd + 4 * kBwdQTile * kStride);

  const int n_kt = (S + kBK - 1) / kBK;
  const int n_hb = gridDim.x / n_kt;
  const int kt = blockIdx.x / n_hb;    // the heaviest (first) tiles first
  const int hb = blockIdx.x - kt * n_hb;
  const int kvh = hb % Kv;
  const int64_t b = hb / Kv;
  const int G = H / Kv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = kt * kBK;
  const int kr0 = k0 + 16 * (warp % kGroups);   // the warp's first kv row
  const int c0 = warp / kGroups * kW;
  const int64_t q_row = static_cast<int64_t>(H) * hd;
  const int64_t kv_row = static_cast<int64_t>(Kv) * hd;
  const bf16* qb = q + b * S * q_row;
  const bf16* dob = dout + b * S * q_row;

  // step i: head kvh G + i / nq, q tile qt0 + i % nq
  const int qt0 = causal ? k0 / kBwdQTile : 0;
  const int nq =
      (kLocal ? last_row(min(k0 + kBK, S) - 1, S, window, chunk) /
                    kBwdQTile + 1
              : (S + kBwdQTile - 1) / kBwdQTile) - qt0;
  const int n_steps = G * nq;
  auto stage_q = [&](int i) {
    const int h = kvh * G + i / nq;
    const int q0 = (qt0 + i % nq) * kBwdQTile;
    bf16* dst = sqd + (i & 1) * 2 * kBwdQTile * kStride;
    cp_async_rows<HDP, kBwdThreads>(dst, qb + static_cast<int64_t>(h) * hd,
                                    q_row, q0, kBwdQTile, S, hd);
    cp_async_rows<HDP, kBwdThreads>(dst + kBwdQTile * kStride,
                                    dob + static_cast<int64_t>(h) * hd,
                                    q_row, q0, kBwdQTile, S, hd);
    if (tid < 2 * kBwdQTile) {         // lse, then D, of the tile's rows
      const int r = tid % kBwdQTile;
      const float* src = (tid < kBwdQTile ? lse : delta) +
                         (b * H + h) * static_cast<int64_t>(S);
      const bool in = q0 + r < S;
      cp_async4(smem_addr(srow + (i & 1) * 2 * kBwdQTile + tid),
                in ? src + q0 + r : src, in ? 4 : 0);
    }
  };
  cp_async_rows<HDP, kBwdThreads>(
      sk, k + b * S * kv_row + static_cast<int64_t>(kvh) * hd, kv_row, k0,
      kBK, S, hd);
  cp_async_rows<HDP, kBwdThreads>(
      sv, v + b * S * kv_row + static_cast<int64_t>(kvh) * hd, kv_row, k0,
      kBK, S, hd);
  stage_q(0);
  cp_async_commit();

  const uint32_t a_lane = a_lane_bytes<HDP>(lane);
  const uint32_t b_lane = b_lane_bytes<HDP>(lane);
  const uint32_t sk_w = smem_addr(sk + (kr0 - k0) * kStride) + a_lane;
  const uint32_t sv_w = smem_addr(sv + (kr0 - k0) * kStride) + a_lane;
  const uint32_t sqd0 = smem_addr(sqd);
  float acc_k[kW / 8][4], acc_v[kW / 8][4];
#pragma unroll
  for (int n = 0; n < kW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  // under the local terms: the last row that sees kv row kr0 + g and
  // kr0 + g + 8, and the warp's first and last rows
  const int lr0 = kLocal ? last_row(kr0 + g, S, window, chunk) : 0;
  const int lr1 = kLocal ? last_row(kr0 + g + 8, S, window, chunk) : 0;
  const int lr_first = kLocal ? last_row(kr0, S, window, chunk) : 0;
  const int lr_last = kLocal ? last_row(kr0 + 15, S, window, chunk) : 0;

  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<0>();                // step i (first: K and V too) landed
    // every warp is past step i - 1, so its stage may be refilled
    __syncthreads();
    if (i + 1 < n_steps) {
      stage_q(i + 1);
      cp_async_commit();
    }
    if (kr0 >= S) continue;            // the warp's rows lie past S
    const int q0 = (qt0 + i % nq) * kBwdQTile;
    const uint32_t sq_s = sqd0 + (i & 1) * 2 * kTileBytes;
    const uint32_t sdo_s = sq_s + kTileBytes;
    const float* slse = srow + (i & 1) * 2 * kBwdQTile;
    const float* sd = slse + kBwdQTile;
#pragma unroll 1
    for (int j0 = 0; j0 < kBwdQTile; j0 += kBwdStep) {
      const int qs = q0 + j0;
      // under causal, columns wholly before the warp's rows add P = 0; so
      // do, under the local terms, columns wholly past their last rows
      if (qs >= S || (causal && qs + kBwdStep - 1 < kr0) ||
          (kLocal && qs > lr_last))
        continue;

      // ---- S^T = K Q^T and dP^T = V dO^T over the step's 32 q columns
      float st[kN][4], dpt[kN][4];
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, sk_w + kk * 32);
        ldsm_x4(va, sv_w + kk * 32);
#pragma unroll
        for (int nn = 0; nn < kN / 2; ++nn) {
          const uint32_t off =
              b_lane + ((j0 + 16 * nn) * kStride + kk * 16) * 2;
          uint32_t f[4];
          ldsm_x4(f, sq_s + off);
          mma_bf16(st[2 * nn], ka, f[0], f[1]);
          mma_bf16(st[2 * nn + 1], ka, f[2], f[3]);
          ldsm_x4(f, sdo_s + off);
          mma_bf16(dpt[2 * nn], va, f[0], f[1]);
          mma_bf16(dpt[2 * nn + 1], va, f[2], f[3]);
        }
      }

      // ---- P^T and dS^T, masked, rounded to bf16 as A operands: 16-column
      // chunk j / 2, elements 0 and 2 for row g, 1 and 3 for row g + 8
      const bool edge = qs + kBwdStep > S || (causal && qs < kr0 + 15) ||
                        (kLocal && qs + kBwdStep - 1 > lr_first);
      uint32_t pa[kN / 2][4], da[kN / 2][4];
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const int c = j0 + 8 * j + 2 * t;     // the column in the stage
        const float2 l2 = *reinterpret_cast<const float2*>(slse + c);
        const float2 d2 = *reinterpret_cast<const float2*>(sd + c);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = expf(st[j][e] * scale - ((e & 1) ? l2.y : l2.x));
          if (edge) {
            const int qi = q0 + c + (e & 1);
            const int kj = kr0 + g + 8 * (e >> 1);
            if (qi >= S || (causal && kj > qi) ||
                (kLocal && qi > ((e >> 1) ? lr1 : lr0)))
              x = 0.f;
          }
          p[e] = x;
          ds[e] = x * (dpt[j][e] - ((e & 1) ? d2.y : d2.x));
        }
        pa[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
        da[j / 2][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        da[j / 2][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // ---- dV += P^T dO and dK += dS^T Q over the warp's columns
#pragma unroll
      for (int kc = 0; kc < kN / 2; ++kc)
#pragma unroll
        for (int np = 0; np < kW / 16; ++np) {
          const uint32_t off =
              a_lane + ((j0 + 16 * kc) * kStride + c0 + 16 * np) * 2;
          uint32_t f[4];
          ldsm_x4_trans(f, sdo_s + off);
          mma_bf16(acc_v[2 * np], pa[kc], f[0], f[1]);
          mma_bf16(acc_v[2 * np + 1], pa[kc], f[2], f[3]);
          ldsm_x4_trans(f, sq_s + off);
          mma_bf16(acc_k[2 * np], da[kc], f[0], f[1]);
          mma_bf16(acc_k[2 * np + 1], da[kc], f[2], f[3]);
        }
    }
  }

  // ---- dK (times 1/sqrt(hd)) and dV as bf16 through the K and V tiles,
  // then out 16 bytes a thread
  __syncthreads();                     // every warp is past its K, V reads
  put_acc<HDP>(sk + (kr0 - k0) * kStride, c0, acc_k, scale);
  put_acc<HDP>(sv + (kr0 - k0) * kStride, c0, acc_v, 1.f);
  __syncthreads();
  store_rows<HDP>(dk + b * S * kv_row + static_cast<int64_t>(kvh) * hd,
                  kv_row, sk, k0, kBK, S, hd, tid, kBwdThreads);
  store_rows<HDP>(dv + b * S * kv_row + static_cast<int64_t>(kvh) * hd,
                  kv_row, sv, k0, kBK, S, hd, tid, kBwdThreads);
}

// dQ on the tensor cores: one block per (q tile of 128 rows, head, batch),
// the heaviest causal tiles first, 16 q rows a warp; Q and dO staged once
// (their fragments kept in registers up to HDP 128, reloaded per k step at
// 256), K and V tiles in a two-stage cp.async buffer, up to the diagonal,
// 32 kv columns a warp step:
//   S = Q K^T, dP = dO V^T, P = exp(S scale - lse), dS = P (dP - D),
//   dQ += bf16(dS) K;
// times 1/sqrt(hd) once at the end.  The recompute of S and dP (two of
// the backward's seven products) keeps dQ free of atomics.  Under kLocal
// the kv tiles start at the one that holds the block's first row's first
// key, a warp skips a step wholly before the first key of its first row,
// and a step that reaches below the first key of its last row is masked
// element by element.
template <int HDP, bool kLocal>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_attention_bwd_q_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const __nv_bfloat16* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 __nv_bfloat16* __restrict__ dq, int S, int H,
                                 int Kv, int hd, float scale, bool causal,
                                 int window, int chunk) {
  using bf16 = __nv_bfloat16;
  constexpr int kStride = mma_stride<HDP>();
  constexpr int kKs = HDP / 16;        // k steps over hd
  constexpr int kBK = bwd_dq_kv_rows<HDP>();
  constexpr int kN = kBwdStep / 8;     // 8-column score tiles a step
  constexpr int kOutN = HDP / 8;       // 8-column dQ tiles of a warp
  constexpr bool kInRegs = HDP <= 128;
  constexpr uint32_t kTileBytes = kBK * kStride * 2;
  extern __shared__ float4 smem4[];
  bf16* sq = reinterpret_cast<bf16*>(smem4);
  bf16* sdo = sq + kBwdDqRows * kStride;
  bf16* skv = sdo + kBwdDqRows * kStride;   // stage s: K at 2 s, V at 2 s + 1

  const int n_qt = (S + kBwdDqRows - 1) / kBwdDqRows;
  const int n_hb = gridDim.x / n_qt;
  const int rank = blockIdx.x / n_hb;
  const int hb = blockIdx.x - rank * n_hb;
  const int h = hb % H;
  const int64_t b = hb / H;
  const int q0 = (n_qt - 1 - rank) * kBwdDqRows;
  const int kvh = h / (H / Kv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qr0 = q0 + 16 * warp;      // the warp's first row
  const int r0 = qr0 + g;              // the thread's rows r0 and r0 + 8
  const int64_t q_row = static_cast<int64_t>(H) * hd;
  const int64_t kv_row = static_cast<int64_t>(Kv) * hd;
  const bf16* kb = k + b * S * kv_row + static_cast<int64_t>(kvh) * hd;
  const bf16* vb = v + b * S * kv_row + static_cast<int64_t>(kvh) * hd;
  const float* lh = lse + (b * H + h) * static_cast<int64_t>(S);
  const float* dh = delta + (b * H + h) * static_cast<int64_t>(S);
  const float lse0 = r0 < S ? lh[r0] : 0.f;
  const float lse1 = r0 + 8 < S ? lh[r0 + 8] : 0.f;
  const float d0 = r0 < S ? dh[r0] : 0.f;
  const float d1 = r0 + 8 < S ? dh[r0 + 8] : 0.f;

  auto stage_kv = [&](int kt) {
    bf16* dst = skv + (kt & 1) * 2 * kBK * kStride;
    cp_async_rows<HDP, kBwdThreads>(dst, kb, kv_row, kt * kBK, kBK, S, hd);
    cp_async_rows<HDP, kBwdThreads>(dst + kBK * kStride, vb, kv_row,
                                    kt * kBK, kBK, S, hd);
  };
  const int last_row = min(q0 + kBwdDqRows, S) - 1;
  const int n_kt = causal ? last_row / kBK + 1 : (S + kBK - 1) / kBK;
  const int kt0 = kLocal ? first_key(q0, window, chunk) / kBK : 0;
  cp_async_rows<HDP, kBwdThreads>(
      sq, q + b * S * q_row + static_cast<int64_t>(h) * hd, q_row, q0,
      kBwdDqRows, S, hd);
  cp_async_rows<HDP, kBwdThreads>(
      sdo, dout + b * S * q_row + static_cast<int64_t>(h) * hd, q_row, q0,
      kBwdDqRows, S, hd);
  stage_kv(kt0);
  cp_async_commit();

  const uint32_t a_lane = a_lane_bytes<HDP>(lane);
  const uint32_t b_lane = b_lane_bytes<HDP>(lane);
  const uint32_t sq_w = smem_addr(sq + 16 * warp * kStride) + a_lane;
  const uint32_t sdo_w = smem_addr(sdo + 16 * warp * kStride) + a_lane;
  const uint32_t skv0 = smem_addr(skv);
  uint32_t qf[kInRegs ? kKs : 1][4], df[kInRegs ? kKs : 1][4];
  float acc[kOutN][4];
#pragma unroll
  for (int n = 0; n < kOutN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // under the local terms: the first key of rows r0 and r0 + 8, and of the
  // warp's first and last rows
  const int lo0 = kLocal ? first_key(r0, window, chunk) : 0;
  const int lo1 = kLocal ? first_key(r0 + 8, window, chunk) : 0;
  const int lo_first = kLocal ? first_key(qr0, window, chunk) : 0;
  const int lo_last = kLocal ? first_key(qr0 + 15, window, chunk) : 0;

  for (int kt = kt0; kt < n_kt; ++kt) {
    cp_async_wait<0>();                // tile kt (first: Q and dO too) landed
    // every warp is past tile kt - 1, so its stage may be refilled
    __syncthreads();
    if (kt + 1 < n_kt) {
      stage_kv(kt + 1);
      cp_async_commit();
    }
    if constexpr (kInRegs) {
      if (kt == kt0) {
#pragma unroll
        for (int kk = 0; kk < kKs; ++kk) {
          ldsm_x4(qf[kk], sq_w + kk * 32);
          ldsm_x4(df[kk], sdo_w + kk * 32);
        }
      }
    }
    if (qr0 >= S) continue;            // the warp's rows lie past S
    const uint32_t sk_s = skv0 + (kt & 1) * 2 * kTileBytes;
    const uint32_t sv_s = sk_s + kTileBytes;
#pragma unroll 1
    for (int j0 = 0; j0 < kBK; j0 += kBwdStep) {
      const int ks = kt * kBK + j0;
      // under causal, columns wholly past the warp's rows add P = 0; so
      // do, under the local terms, columns wholly before their first keys
      if (ks >= S || (causal && ks > qr0 + 15) ||
          (kLocal && ks + kBwdStep - 1 < lo_first))
        continue;

      // ---- S = Q K^T and dP = dO V^T over the step's 32 kv columns
      float s[kN][4], dp[kN][4];
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        uint32_t qa[4], da[4];
        if constexpr (kInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            qa[e] = qf[kk][e];
            da[e] = df[kk][e];
          }
        } else {
          ldsm_x4(qa, sq_w + kk * 32);
          ldsm_x4(da, sdo_w + kk * 32);
        }
#pragma unroll
        for (int nn = 0; nn < kN / 2; ++nn) {
          const uint32_t off =
              b_lane + ((j0 + 16 * nn) * kStride + kk * 16) * 2;
          uint32_t f[4];
          ldsm_x4(f, sk_s + off);
          mma_bf16(s[2 * nn], qa, f[0], f[1]);
          mma_bf16(s[2 * nn + 1], qa, f[2], f[3]);
          ldsm_x4(f, sv_s + off);
          mma_bf16(dp[2 * nn], da, f[0], f[1]);
          mma_bf16(dp[2 * nn + 1], da, f[2], f[3]);
        }
      }

      // ---- dS, masked, rounded to bf16 as the A operand
      const bool edge = ks + kBwdStep > S || qr0 + 16 > S ||
                        (causal && ks + kBwdStep - 1 > qr0) ||
                        (kLocal && ks < lo_last);
      uint32_t dsa[kN / 2][4];
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = expf(s[j][e] * scale - (e < 2 ? lse0 : lse1));
          if (edge) {
            const int c = ks + 8 * j + 2 * t + (e & 1);
            const int r = r0 + 8 * (e >> 1);
            if (c >= S || r >= S || (causal && c > r) ||
                (kLocal && c < ((e >> 1) ? lo1 : lo0)))
              x = 0.f;
          }
          ds[e] = x * (dp[j][e] - (e < 2 ? d0 : d1));
        }
        dsa[j / 2][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[j / 2][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // ---- dQ += dS K
#pragma unroll
      for (int kc = 0; kc < kN / 2; ++kc)
#pragma unroll
        for (int np = 0; np < kOutN / 2; ++np) {
          uint32_t f[4];
          ldsm_x4_trans(f, sk_s + a_lane +
                               ((j0 + 16 * kc) * kStride + 16 * np) * 2);
          mma_bf16(acc[2 * np], dsa[kc], f[0], f[1]);
          mma_bf16(acc[2 * np + 1], dsa[kc], f[2], f[3]);
        }
    }
  }

  // ---- dQ times 1/sqrt(hd) as bf16 through the warp's own Q rows, then
  // out 16 bytes a lane
  bf16* so = sq + 16 * warp * kStride;
  __syncwarp();
  put_acc<HDP>(so, 0, acc, scale);
  __syncwarp();
  store_rows<HDP>(dq + b * S * q_row + static_cast<int64_t>(h) * hd, q_row,
                  so, qr0, 16, S, hd, lane, 32);
}

template <int HDP, bool kLocal>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           float* delta, void* dq, void* dk, void* dv,
                           int64_t B, int S, int H, int Kv, int hd,
                           bool causal, int window, int chunk,
                           cudaStream_t stream) {
  constexpr size_t kv_smem = bwd_kv_mma_smem_bytes<HDP>();
  constexpr size_t q_smem = bwd_q_mma_smem_bytes<HDP>();
  const int64_t kv_blocks =
      (S + bwd_kv_rows<HDP>() - 1) / bwd_kv_rows<HDP>() * Kv * B;
  const int64_t q_blocks = (S + kBwdDqRows - 1) / kBwdDqRows * H * B;
  if (q_blocks > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_kv_mma_kernel<HDP, kLocal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kv_smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      flash_attention_bwd_q_mma_kernel<HDP, kLocal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(q_smem));
  if (err != cudaSuccess) return err;
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  using bf16 = __nv_bfloat16;
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  launch_delta<bf16>(o, dout, delta, B, S, H, hd, stream);
  flash_attention_bwd_kv_mma_kernel<HDP, kLocal>
      <<<static_cast<unsigned>(kv_blocks), kBwdThreads, kv_smem, stream>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), S, H, Kv, hd, scale, causal, window,
          chunk);
  flash_attention_bwd_q_mma_kernel<HDP, kLocal>
      <<<static_cast<unsigned>(q_blocks), kBwdThreads, q_smem, stream>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), S, H, Kv, hd,
          scale, causal, window, chunk);
  return cudaSuccess;
}

// the backward at template width HDP: the mma kernels for bfloat16, the
// fma kernels for float32
template <int HDP, bool kLocal>
cudaError_t launch_bwd_dtype(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const float* lse, float* delta, void* dq,
                             void* dk, void* dv, int64_t B, int S, int H,
                             int Kv, int hd, bool causal, int window,
                             int chunk, bool bf16, cudaStream_t stream) {
  return bf16 ? launch_bwd_mma<HDP, kLocal>(q, k, v, o, dout, lse, delta, dq,
                                            dk, dv, B, S, H, Kv, hd, causal,
                                            window, chunk, stream)
              : launch_bwd<HDP, kLocal>(q, k, v, o, dout, lse, delta, dq, dk,
                                        dv, B, S, H, Kv, hd, causal, window,
                                        chunk, stream);
}

// the backward at width HDP, with the local terms or without them (the
// causal kernels, as they were before the terms)
template <int HDP>
cudaError_t launch_bwd_width(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const float* lse, float* delta, void* dq,
                             void* dk, void* dv, int64_t B, int S, int H,
                             int Kv, int hd, bool causal, int window,
                             int chunk, bool bf16, cudaStream_t stream) {
  if (window > 0 || chunk > 0)
    return launch_bwd_dtype<HDP, true>(q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, B, S, H, Kv, hd, causal, window,
                                       chunk, bf16, stream);
  return launch_bwd_dtype<HDP, false>(q, k, v, o, dout, lse, delta, dq, dk,
                                      dv, B, S, H, Kv, hd, causal, 0, 0, bf16,
                                      stream);
}

}  // namespace


// The widest head either kernel takes.
int flash_attention_max_head_dim() { return 256; }

// q (B, S, H, hd), k and v (B, S, Kv, hd) -> o (B, S, H, hd), all
// contiguous, 16-byte aligned and of one dtype (bf16: bfloat16, the mma
// kernel; else float32, the fma kernel); B, S >= 1, H % Kv == 0,
// hd % 8 == 0, hd <= 256, and B, H below 2^16; anything else returns
// cudaErrorInvalidValue.  With ``lse`` (B, H, S) float32 also each row's
// log-sum-exp of its scaled, masked scores (the backward's input); with
// nullptr the kernels write the same o as without it.  window and chunk
// are the local terms as the wrapper's local_terms validated them (0:
// none; either under causal; see the top).  Launches on ``stream``;
// returns the error of the shared-memory opt-in (the launch's own is left
// for cudaGetLastError).
cudaError_t launch_flash_attention(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int64_t B, int S, int H, int Kv, int hd,
                                   bool causal, int window, int chunk,
                                   bool bf16, cudaStream_t stream) {
  if (B < 1 || S < 1 || Kv < 1 || H % Kv || hd < 8 || hd % 8 ||
      hd > flash_attention_max_head_dim())
    return cudaErrorInvalidValue;
  const bool local = window > 0 || chunk > 0;
  if (bf16)
    return local ? launch_mma_width<true>(q, k, v, o, lse, B, S, H, Kv, hd,
                                          causal, window, chunk, stream)
                 : launch_mma_width<false>(q, k, v, o, lse, B, S, H, Kv, hd,
                                           causal, 0, 0, stream);
  return launch_dtype<float>(q, k, v, o, lse, B, S, H, Kv, hd, causal,
                             window, chunk, stream);
}

// The backward (kernel 9b): dq (B, S, H, hd), dk and dv (B, S, Kv, hd) of
// the attention whose inputs were q, k, v, output o and row log-sum-exp
// lse (B, H, S) float32 (the forward's, asked for), given dout; delta is a
// (B, H, S) float32 scratch for D = rowsum(dO o).  Every tensor
// contiguous and 16-byte aligned, q, k, v, o, dout, dq, dk, dv of one
// dtype (bf16: bfloat16, the mma kernels; else float32, the fma kernels),
// as the forward takes them, with the forward's window and chunk (0:
// none).  Three launches on ``stream``: D, then dK and dV, then dQ;
// returns the first shared-memory opt-in's error (the launches' own are
// left for cudaGetLastError).
cudaError_t launch_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int64_t B, int S, int H, int Kv, int hd, bool causal,
    int window, int chunk, bool bf16, cudaStream_t stream) {
  if (B < 1 || S < 1 || Kv < 1 || H % Kv || hd < 8 || hd % 8 ||
      hd > flash_attention_max_head_dim())
    return cudaErrorInvalidValue;
  const auto launch = hd <= 64    ? launch_bwd_width<64>
                      : hd <= 128 ? launch_bwd_width<128>
                                  : launch_bwd_width<256>;
  return launch(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, Kv, hd,
                causal, window, chunk, bf16, stream);
}
