// Flash attention's backward (kernel 9b) for Hopper (sm_90a): D, then dK
// and dV by KV-head tiles, then dQ, in bfloat16 on the tensor cores and in
// float32 on the CUDA cores, with the forward's sliding window and chunk.
// The top of flash_attention.cu describes its design and roundings; the
// helpers it shares with the forward are in flash_attention.cuh.
#include "flash_attention.cuh"

namespace {

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
