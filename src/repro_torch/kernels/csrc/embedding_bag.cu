// Embedding bag over the pulled working set, for Hopper (sm_90a).
//
//   out[b] = sum_{j: seg[j] == b} w[j] * working[inv[j]]
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding_bag.py
// (embedding_bag_pallas; exact form at :102, one-hot MXU form at :129).
// The TPU version multiplies a one-hot (bags x nnz) block by the gathered
// rows on the matrix unit.  On the GPU that product would read every nnz
// entry once per bag block; instead the wrapper sorts the entries by bag
// once (a stable sort of seg gives `order` and the CSR `offsets`), and this
// kernel walks each bag's own entries.
//
// What bounds it: bytes.  Per call it moves the rows the bags reference,
// the index and weight streams, and the (num_bags, dim) output; the
// arithmetic is one multiply and one add per gathered element.
//
// Design:
//   - one warp per bag, eight bags per 256-thread block;
//   - lanes span dim: lane l owns columns l, l + 32, ... (two f32 per lane
//     at dim 64), so every gathered row is read as coalesced 128-byte
//     segments;
//   - the lanes first load up to 32 of the bag's (row, weight) pairs in
//     parallel and then broadcast them with __shfl_sync, so the dependent
//     order -> inv -> row chain is paid once per 32 entries;
//   - each bag adds its entries in ascending original position (the stable
//     sort keeps it), with __fmul_rn/__fadd_rn so that no multiply-add is
//     contracted: the sum is bit-equal to the sequential CPU segment sum,
//     and two runs give equal bits (no atomics);
//   - every bag row is written, an empty bag as zeros.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kBagsPerBlock = 8;

template <int kColsPerLane>
__global__ void embedding_bag_kernel(
    const float* __restrict__ working, int dim,
    const int32_t* __restrict__ inv, const float* __restrict__ weights,
    const int64_t* __restrict__ order, const int64_t* __restrict__ offsets,
    int num_bags, float* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  const int bag = blockIdx.x * kBagsPerBlock + threadIdx.x / kWarp;
  if (bag >= num_bags) return;  // whole warps leave together
  const int64_t begin = offsets[bag];
  const int64_t end = offsets[bag + 1];

  float acc[kColsPerLane];
#pragma unroll
  for (int v = 0; v < kColsPerLane; ++v) acc[v] = 0.0f;

  for (int64_t base = begin; base < end; base += kWarp) {
    const int n = static_cast<int>(end - base < kWarp ? end - base : kWarp);
    int64_t my_row = 0;
    float my_w = 1.0f;
    if (lane < n) {
      const int64_t j = order[base + lane];
      my_row = inv[j];
      if (weights != nullptr) my_w = weights[j];
    }
    for (int t = 0; t < n; ++t) {
      const int64_t row = __shfl_sync(0xffffffffu, my_row, t);
      const float w = __shfl_sync(0xffffffffu, my_w, t);
      const float* src = working + row * dim;
#pragma unroll
      for (int v = 0; v < kColsPerLane; ++v) {
        const int c = lane + v * kWarp;
        if (c < dim) {
          float x = src[c];
          if (weights != nullptr) x = __fmul_rn(x, w);
          acc[v] = __fadd_rn(acc[v], x);
        }
      }
    }
  }

  float* dst = out + static_cast<int64_t>(bag) * dim;
#pragma unroll
  for (int v = 0; v < kColsPerLane; ++v) {
    const int c = lane + v * kWarp;
    if (c < dim) dst[c] = acc[v];
  }
}

template <int kColsPerLane>
void launch(const float* working, int dim, const int32_t* inv,
            const float* weights, const int64_t* order,
            const int64_t* offsets, int num_bags, float* out,
            cudaStream_t stream) {
  const int blocks = (num_bags + kBagsPerBlock - 1) / kBagsPerBlock;
  embedding_bag_kernel<kColsPerLane>
      <<<blocks, kBagsPerBlock * kWarp, 0, stream>>>(
          working, dim, inv, weights, order, offsets, num_bags, out);
}

}  // namespace

// dim must lie in [1, 256] and num_bags must be positive: the binding checks
// both before it calls this.  `weights` may be null (unweighted bag).
void launch_embedding_bag(const float* working, int dim, const int32_t* inv,
                          const float* weights, const int64_t* order,
                          const int64_t* offsets, int num_bags, float* out,
                          cudaStream_t stream) {
  if (dim <= 32) {
    launch<1>(working, dim, inv, weights, order, offsets, num_bags, out, stream);
  } else if (dim <= 64) {
    launch<2>(working, dim, inv, weights, order, offsets, num_bags, out, stream);
  } else if (dim <= 128) {
    launch<4>(working, dim, inv, weights, order, offsets, num_bags, out, stream);
  } else {
    launch<8>(working, dim, inv, weights, order, offsets, num_bags, out, stream);
  }
}
