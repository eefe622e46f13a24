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
//
// This source holds the forward; the backward's kernels are in
// flash_attention_backward.cu, and the helpers both use in
// flash_attention.cuh.
#include "flash_attention.cuh"

namespace {

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
