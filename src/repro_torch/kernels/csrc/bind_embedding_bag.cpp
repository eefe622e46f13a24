// The embedding bag's wrappers (csrc/embedding_bag.cu): the forward, its
// walk alone, the working-row and the weight gradients.
#include "bindings.h"

#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

size_t streams_scratch_bytes(int64_t nnz, int groups, bool weighted,
                             size_t streams_at[5]);
cudaError_t launch_embedding_bag(const float* working, int dim,
                                 const int32_t* inv, const int32_t* seg,
                                 const float* w, int64_t nnz, int num_bags,
                                 void* scratch, float* out,
                                 cudaStream_t stream);
cudaError_t launch_embedding_bag_walk(const float* working, int dim,
                                      const int32_t* inv_sorted,
                                      const float* w_sorted,
                                      const int64_t* offsets, int num_bags,
                                      float* out, cudaStream_t stream);
int64_t backward_list_ints(int64_t nnz);
cudaError_t launch_embedding_bag_backward(
    const float* g, int64_t num_bags, int dim, const int32_t* inv,
    const int32_t* seg, const float* w, int64_t nnz, int working_rows,
    void* scratch, float* g_work, cudaStream_t stream);
void launch_embedding_bag_weight_grad(const float* g, int64_t num_bags,
                                      int dim, const int32_t* seg,
                                      const float* working,
                                      int64_t working_rows,
                                      const int32_t* inv, int64_t nnz,
                                      float* g_w, cudaStream_t stream);

namespace repro_bind {

// Views of the index streams that build_streams left in `scratch` (the
// byte offsets `at` of streams_scratch_bytes): [vals_sorted, w_sorted
// (undefined without weights), offsets (int64, groups + 1), keys_sorted
// (the entries outside [0, groups) as groups, last)].
std::vector<at::Tensor> stream_views(const at::Tensor& scratch,
                                        const size_t at[5], int64_t nnz,
                                        int64_t groups, bool weighted) {
  auto view = [&](int part, int64_t n, at::ScalarType dtype) {
    const int64_t size = n * static_cast<int64_t>(c10::elementSize(dtype));
    return scratch.narrow(0, static_cast<int64_t>(at[part]), size)
        .view(dtype);
  };
  at::Tensor w_sorted;
  if (weighted) w_sorted = view(2, nnz, at::kFloat);
  return {view(0, nnz, at::kInt), w_sorted,
          view(3, groups + 1, at::kLong), view(1, nnz, at::kInt)};
}

// out[b] = sum over j with seg[j] == b of w[j] * working[inv[j]], every
// bag written, in one call: the index streams by bag built on the card (a
// stable order, no sort, no host sync), then the walk, with every
// intermediate in one scratch allocation; returns [out] (num_bags x dim).
// With streams_only it builds only the streams and returns them, views of
// the scratch: [inv_sorted, w_sorted, offsets, keys_sorted] (stream_views;
// keys_sorted is seg, the entries outside [0, num_bags) as num_bags).
std::vector<at::Tensor> embedding_bag_forward(
    const at::Tensor& working, const at::Tensor& inv,
    const at::Tensor& seg, const std::optional<at::Tensor>& weights,
    int64_t num_bags, bool streams_only) {
  check_cuda(working, "working", at::kFloat, 2, working);
  check_cuda(inv, "inv", at::kInt, 1, working);
  check_cuda(seg, "seg", at::kInt, 1, working);
  const int64_t dim = working.size(1);
  const int64_t nnz = inv.size(0);
  check_dim(dim);
  check_rows(working.size(0), "working rows");
  check_rows(num_bags, "num_bags");
  TORCH_CHECK(seg.size(0) == nnz, "seg and inv differ in length");
  TORCH_CHECK(nnz < kMaxRows, "nnz must lie below 2^31");
  const float* w = optional_weights(weights, working, nnz);
  const c10::cuda::CUDAGuard guard(working.device());
  size_t at[5];
  const size_t bytes = streams_scratch_bytes(
      nnz, static_cast<int>(num_bags), w != nullptr, at);
  auto scratch = at::empty({static_cast<int64_t>(bytes)},
                              working.options().dtype(at::kByte));
  at::Tensor out;
  if (!streams_only) out = at::empty({num_bags, dim}, working.options());
  C10_CUDA_CHECK(launch_embedding_bag(
      working.data_ptr<float>(), static_cast<int>(dim),
      inv.data_ptr<int32_t>(), seg.data_ptr<int32_t>(), w, nnz,
      static_cast<int>(num_bags), scratch.data_ptr(),
      streams_only ? nullptr : out.data_ptr<float>(),
      c10::cuda::getCurrentCUDAStream().stream()));
  if (!streams_only) return {out};
  return stream_views(scratch, at, nnz, num_bags, w != nullptr);
}

// The forward's walk alone on given streams: out[b] = sum over
// [offsets[b], offsets[b+1]) of w_sorted[i] * working[inv_sorted[i]].
void embedding_bag_walk(const at::Tensor& working,
                        const at::Tensor& inv_sorted,
                        const std::optional<at::Tensor>& w_sorted,
                        const at::Tensor& offsets,
                        const at::Tensor& out) {
  check_cuda(working, "working", at::kFloat, 2, working);
  check_cuda(inv_sorted, "inv_sorted", at::kInt, 1, working);
  check_cuda(out, "out", at::kFloat, 2, working);
  const int64_t dim = working.size(1);
  const int64_t num_bags = out.size(0);
  check_dim(dim);
  check_rows(working.size(0), "working rows");
  check_rows(num_bags, "num_bags");
  TORCH_CHECK(out.size(1) == dim, "out must have ", dim, " columns");
  check_offsets(offsets, num_bags, working);
  const float* w = optional_weights(w_sorted, working, inv_sorted.size(0));
  const c10::cuda::CUDAGuard guard(working.device());
  C10_CUDA_CHECK(launch_embedding_bag_walk(
      working.data_ptr<float>(), static_cast<int>(dim),
      inv_sorted.data_ptr<int32_t>(), w, offsets.data_ptr<int64_t>(),
      static_cast<int>(num_bags), out.data_ptr<float>(),
      c10::cuda::getCurrentCUDAStream().stream()));
}

// g_work[r] = sum over j with inv[j] == r of w[j] * g[seg[j]], every row
// written, in one call: the index streams by working row built on the card
// (a stable order, no sort, no host sync), then the kernels, with every
// intermediate in one scratch allocation; returns [g_work] (working_rows x
// dim).  With streams_only it builds only the streams and returns them,
// views of the scratch: [seg_sorted, w_sorted (undefined without
// weights), offsets (int64, working_rows + 1), keys_sorted (inv, the
// entries outside [0, working_rows) as working_rows, last), the row lists
// (int32, the layout of csrc/embedding_bag.cu's kListHead)].
std::vector<at::Tensor> embedding_bag_backward(
    const at::Tensor& g, const at::Tensor& inv,
    const at::Tensor& seg, const std::optional<at::Tensor>& weights,
    int64_t working_rows, bool streams_only) {
  check_cuda(g, "g", at::kFloat, 2, g);
  check_cuda(inv, "inv", at::kInt, 1, g);
  check_cuda(seg, "seg", at::kInt, 1, g);
  const int64_t dim = g.size(1);
  const int64_t nnz = inv.size(0);
  check_dim(dim);
  check_rows(g.size(0), "num_bags");
  check_rows(working_rows, "working rows");
  TORCH_CHECK(seg.size(0) == nnz, "seg and inv differ in length");
  TORCH_CHECK(nnz < kMaxRows, "nnz must lie below 2^31");
  const float* w = optional_weights(weights, g, nnz);
  const c10::cuda::CUDAGuard guard(g.device());
  size_t at[5];
  const size_t bytes = streams_scratch_bytes(
      nnz, static_cast<int>(working_rows), w != nullptr, at);
  auto scratch = at::empty({static_cast<int64_t>(bytes)},
                              g.options().dtype(at::kByte));
  at::Tensor g_work;
  if (!streams_only) g_work = at::empty({working_rows, dim}, g.options());
  const cudaError_t err = launch_embedding_bag_backward(
      g.data_ptr<float>(), g.size(0), static_cast<int>(dim),
      inv.data_ptr<int32_t>(), seg.data_ptr<int32_t>(), w, nnz,
      static_cast<int>(working_rows), scratch.data_ptr(),
      streams_only ? nullptr : g_work.data_ptr<float>(),
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "embedding_bag_backward: ",
              cudaGetErrorString(err));
  if (!streams_only) return {g_work};
  auto views = stream_views(scratch, at, nnz, working_rows, w != nullptr);
  views.push_back(scratch.narrow(0, static_cast<int64_t>(at[4]),
                                 backward_list_ints(nnz) * 4)
                      .view(at::kInt));
  return views;
}

// g_w[j] = sum_d g[seg[j], d] * working[inv[j], d].
void embedding_bag_weight_grad(const at::Tensor& g,
                               const at::Tensor& seg,
                               const at::Tensor& working,
                               const at::Tensor& inv,
                               const at::Tensor& g_w) {
  check_cuda(g, "g", at::kFloat, 2, g);
  check_cuda(seg, "seg", at::kInt, 1, g);
  check_cuda(working, "working", at::kFloat, 2, g);
  check_cuda(inv, "inv", at::kInt, 1, g);
  check_cuda(g_w, "g_w", at::kFloat, 1, g);
  const int64_t dim = g.size(1);
  const int64_t nnz = seg.size(0);
  check_dim(dim);
  TORCH_CHECK(working.size(1) == dim, "working must have ", dim, " columns");
  TORCH_CHECK(inv.size(0) == nnz && g_w.size(0) == nnz,
              "seg, inv and g_w differ in length");
  if (nnz == 0) return;
  const c10::cuda::CUDAGuard guard(g.device());
  launch_embedding_bag_weight_grad(
      g.data_ptr<float>(), g.size(0), static_cast<int>(dim),
      seg.data_ptr<int32_t>(), working.data_ptr<float>(), working.size(0),
      inv.data_ptr<int32_t>(), nnz, g_w.data_ptr<float>(),
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace repro_bind
