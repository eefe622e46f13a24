// The k-step local Adam step for Hopper (sm_90a), over every leaf of the
// dense tower in one launch:
//
//   m  = b1*m + (1-b1)*g;   v = b2*v + (1-b2)*g*g          (in place)
//   p -= lr*(m*mhat) / sqrt(v_use*vhat)  [+ lr*wd*p]        (in place)
//   v_use = v (the new local EMA) while warmup and t <= k, else v_hat
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_adam.py
// (fused_adam_pallas, pallas_call at :44), which covers the plain step
// (no bias correction, no weight decay, v_hat only); this kernel also
// covers what core/kstep.py's local branch does around it: the warm-up
// selection of v_use before the first merge, the bias-correction factors
// and the weight decay.
//
// Bit-equality with the PyTorch ops of kernels/ref.py::fused_adam_ref on
// the card: every operation is one IEEE-rounded float op in the ops'
// order (__fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/__fsqrt_rn, so nvcc
// contracts nothing into an FMA).  A Python float operand is rounded to
// float32 as PyTorch rounds a scalar operand: the wrapper passes
// (float)b1, (float)(1.0 - b1) (the difference taken in double, as Python
// takes it), and for a float lr (float)(lr * weight_decay), a double
// product.  A tensor lr is read by pointer and lr * weight_decay is then
// a float32 product, as PyTorch computes a 0-dim tensor times a scalar.
// Nothing is read on the host: t (the step count after this step), a
// tensor lr and the bias-correction factors are 0-dim device tensors read
// by pointer, so a step makes no host sync and no host-to-device copy.
//
// Leaves: up to kMaxLeaves pointers per array and their sizes travel by
// value in the launch's parameters (AdamLeaves, < 4 KB); each block finds
// its leaf in a prefix table of block counts.  The wrapper launches once
// per kMaxLeaves leaves (baidu-ctr has 9, qwen3-14b 14).
//
// Dtypes, as the TPU kernel takes them (its :21-25 and :50): p and g are
// float32 or bfloat16, per leaf (AdamLeaves::bf16); m, v and v_hat are
// float32.  A bfloat16 p and g are widened to float32 (exact), the step
// runs in float32 as above, and p is written back rounded to nearest
// even (__float2bfloat16_rn), as ref.fused_adam_ref's p.copy_ of the
// float32 result rounds it.  The float32 path is the same instructions as
// before bfloat16 leaves were taken.
//
// What bounds it: bytes.  Per element it reads p, g, m, v and v_hat and
// writes p, m and v: 8 x 4 B in float32, 26 B with a bfloat16 p and g; a
// handful of float ops, well under the card's rate.  Each thread handles
// kPerThread elements a block-width apart, so a warp's loads are
// coalesced.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "fused_adam.h"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int64_t kElemsPerBlock = int64_t{kThreads} * kPerThread;

// float32 <-> the leaf's type by the intrinsics (load() builds with
// __CUDA_NO_BFLOAT16_CONVERSIONS__); round to nearest even
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float& dst, float x) { dst = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16& dst, float x) {
  dst = __float2bfloat16_rn(x);
}

// One leaf's elements [base, base + kPerThread * kThreads) of a block, P
// and G of type T (float or __nv_bfloat16).
template <typename T>
__device__ __forceinline__ void adam_elements(
    T* __restrict__ P, const T* __restrict__ G, float* __restrict__ M,
    float* __restrict__ V, const float* __restrict__ VH, int64_t n,
    int64_t base, const AdamScalars& s, float lr, float lrwd, bool pre,
    float mhat, float vhat) {
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t i = base + int64_t{j} * kThreads;
    if (i < n) {
      const float g = widen(G[i]);
      const float m = __fadd_rn(__fmul_rn(s.b1, M[i]), __fmul_rn(s.c1, g));
      const float v = __fadd_rn(__fmul_rn(s.b2, V[i]),
                                __fmul_rn(s.c2, __fmul_rn(g, g)));
      float vu = pre ? v : VH[i];
      const float mu = s.mhat != nullptr ? __fmul_rn(m, mhat) : m;
      if (s.vhat != nullptr) vu = __fmul_rn(vu, vhat);
      float d = __fdiv_rn(__fmul_rn(lr, mu), __fsqrt_rn(vu));
      const float p = widen(P[i]);
      if (s.has_wd) d = __fadd_rn(d, __fmul_rn(lrwd, p));
      narrow(P[i], __fsub_rn(p, d));
      M[i] = m;
      V[i] = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(AdamLeaves a, AdamScalars s) {
  const int64_t b = blockIdx.x;
  int leaf = 0;
  while (leaf + 1 < a.count && b >= a.block_start[leaf + 1]) ++leaf;

  const float lr = s.lr_ptr != nullptr ? *s.lr_ptr : s.lr;
  const float lrwd = s.lr_ptr != nullptr ? __fmul_rn(lr, s.wd) : s.lrwd;
  const bool pre = s.warmup && *s.t <= s.k;
  const float mhat = s.mhat != nullptr ? *s.mhat : 1.f;
  const float vhat = s.vhat != nullptr ? *s.vhat : 1.f;

  const int64_t base = (b - a.block_start[leaf]) * kElemsPerBlock +
                       threadIdx.x;
  if (a.bf16[leaf])
    adam_elements(static_cast<__nv_bfloat16*>(a.p[leaf]),
                  static_cast<const __nv_bfloat16*>(a.g[leaf]), a.m[leaf],
                  a.v[leaf], a.vh[leaf], a.n[leaf], base, s, lr, lrwd, pre,
                  mhat, vhat);
  else
    adam_elements(static_cast<float*>(a.p[leaf]),
                  static_cast<const float*>(a.g[leaf]), a.m[leaf], a.v[leaf],
                  a.vh[leaf], a.n[leaf], base, s, lr, lrwd, pre, mhat, vhat);
}

}  // namespace

int64_t fused_adam_blocks(int64_t n) {
  return (n + kElemsPerBlock - 1) / kElemsPerBlock;
}

// a.block_start holds the prefix sums of fused_adam_blocks(n) per leaf;
// a.block_start[a.count] blocks in all (>= 1).
void launch_fused_adam(const AdamLeaves& a, const AdamScalars& s,
                       cudaStream_t stream) {
  const int64_t blocks = a.block_start[a.count];
  fused_adam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      a, s);
}
