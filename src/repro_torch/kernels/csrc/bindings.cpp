// Python binding of the hand-written CUDA kernels.  This is the only source
// that includes PyTorch's headers: the kernels themselves (*.cu) see plain
// pointers, so nvcc compiles them in seconds.
#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

void launch_embedding_bag(const float* working, int dim, const int32_t* inv,
                          const float* weights, const int64_t* order,
                          const int64_t* offsets, int num_bags, float* out,
                          cudaStream_t stream);
void launch_embedding_bag_backward(const float* g, int64_t num_bags, int dim,
                                   const int32_t* seg_sorted,
                                   const float* w_sorted,
                                   const int64_t* offsets, int working_rows,
                                   float* g_work, cudaStream_t stream);
void launch_embedding_bag_weight_grad(const float* g, int64_t num_bags,
                                      int dim, const int32_t* seg,
                                      const float* working,
                                      int64_t working_rows,
                                      const int32_t* inv, int64_t nnz,
                                      float* g_w, cudaStream_t stream);
void launch_sparse_adagrad_apply(float* table, float* accum, int64_t rows,
                                 int dim, const int32_t* uids, int64_t cap,
                                 const float* delta, const float* g2,
                                 cudaStream_t stream);

namespace {

constexpr int64_t kMaxRows = int64_t{1} << 31;

void check_cuda(const torch::Tensor& t, const char* name,
                torch::ScalarType dtype, int64_t ndim,
                const torch::Tensor& like) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.device() == like.device(), name, " is on ", t.device(),
              ", expected ", like.device());
  TORCH_CHECK(t.scalar_type() == dtype, name, " has dtype ", t.scalar_type(),
              ", expected ", dtype);
  TORCH_CHECK(t.dim() == ndim, name, " must be ", ndim, "-D");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

void check_dim(int64_t dim) {
  TORCH_CHECK(dim >= 1 && dim <= 256, "dim must lie in [1, 256], got ", dim);
}

void check_rows(int64_t rows, const char* what) {
  TORCH_CHECK(rows >= 1 && rows < kMaxRows, what, " must lie in [1, 2^31), got ",
              rows);
}

const float* optional_weights(const c10::optional<torch::Tensor>& weights,
                              const torch::Tensor& like, int64_t nnz) {
  if (!weights.has_value()) return nullptr;
  check_cuda(*weights, "weights", torch::kFloat32, 1, like);
  TORCH_CHECK(weights->size(0) == nnz, "weights must have ", nnz, " entries");
  return weights->data_ptr<float>();
}

void check_offsets(const torch::Tensor& offsets, int64_t num_out,
                   const torch::Tensor& like) {
  check_cuda(offsets, "offsets", torch::kInt64, 1, like);
  TORCH_CHECK(offsets.size(0) == num_out + 1, "offsets must have ",
              num_out + 1, " entries");
}

// out[b] = sum over order[offsets[b]:offsets[b+1]] of w[j] * working[inv[j]].
void embedding_bag_forward(const torch::Tensor& working,
                           const torch::Tensor& inv,
                           const c10::optional<torch::Tensor>& weights,
                           const torch::Tensor& order,
                           const torch::Tensor& offsets,
                           const torch::Tensor& out) {
  check_cuda(working, "working", torch::kFloat32, 2, working);
  check_cuda(inv, "inv", torch::kInt32, 1, working);
  check_cuda(out, "out", torch::kFloat32, 2, working);
  const int64_t dim = working.size(1);
  const int64_t num_bags = out.size(0);
  check_dim(dim);
  check_rows(working.size(0), "working rows");
  check_rows(num_bags, "num_bags");
  TORCH_CHECK(out.size(1) == dim, "out must have ", dim, " columns");
  check_offsets(offsets, num_bags, working);
  check_cuda(order, "order", torch::kInt64, 1, working);
  TORCH_CHECK(order.size(0) == inv.size(0), "order and inv differ in length");
  const float* w = optional_weights(weights, working, inv.size(0));
  const c10::cuda::CUDAGuard guard(working.device());
  launch_embedding_bag(working.data_ptr<float>(), static_cast<int>(dim),
                       inv.data_ptr<int32_t>(), w, order.data_ptr<int64_t>(),
                       offsets.data_ptr<int64_t>(),
                       static_cast<int>(num_bags), out.data_ptr<float>(),
                       c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// g_work[r] = sum over i in [offsets[r], offsets[r+1]) of w[i] * g[seg[i]]
// (seg and w sorted by working row).
void embedding_bag_backward(const torch::Tensor& g, const torch::Tensor& seg,
                            const c10::optional<torch::Tensor>& weights,
                            const torch::Tensor& offsets,
                            const torch::Tensor& g_work) {
  check_cuda(g, "g", torch::kFloat32, 2, g);
  check_cuda(seg, "seg", torch::kInt32, 1, g);
  check_cuda(g_work, "g_work", torch::kFloat32, 2, g);
  const int64_t dim = g.size(1);
  const int64_t working_rows = g_work.size(0);
  check_dim(dim);
  check_rows(g.size(0), "num_bags");
  check_rows(working_rows, "working rows");
  TORCH_CHECK(g_work.size(1) == dim, "g_work must have ", dim, " columns");
  check_offsets(offsets, working_rows, g);
  const float* w = optional_weights(weights, g, seg.size(0));
  const c10::cuda::CUDAGuard guard(g.device());
  launch_embedding_bag_backward(
      g.data_ptr<float>(), g.size(0), static_cast<int>(dim),
      seg.data_ptr<int32_t>(), w, offsets.data_ptr<int64_t>(),
      static_cast<int>(working_rows),
      g_work.data_ptr<float>(), c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// g_w[j] = sum_d g[seg[j], d] * working[inv[j], d].
void embedding_bag_weight_grad(const torch::Tensor& g,
                               const torch::Tensor& seg,
                               const torch::Tensor& working,
                               const torch::Tensor& inv,
                               const torch::Tensor& g_w) {
  check_cuda(g, "g", torch::kFloat32, 2, g);
  check_cuda(seg, "seg", torch::kInt32, 1, g);
  check_cuda(working, "working", torch::kFloat32, 2, g);
  check_cuda(inv, "inv", torch::kInt32, 1, g);
  check_cuda(g_w, "g_w", torch::kFloat32, 1, g);
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

// table[uids[i]] += delta[i]; accum[uids[i]] += g2[i], in place, skipping
// the pads of pull_working_set's layout (csrc/sparse_adagrad.cu).
void sparse_adagrad_apply(const torch::Tensor& table,
                          const torch::Tensor& accum,
                          const torch::Tensor& uids,
                          const torch::Tensor& delta,
                          const torch::Tensor& g2) {
  check_cuda(table, "table", torch::kFloat32, 2, table);
  check_cuda(accum, "accum", torch::kFloat32, 2, table);
  check_cuda(uids, "uids", torch::kInt32, 1, table);
  check_cuda(delta, "delta", torch::kFloat32, 2, table);
  check_cuda(g2, "g2", torch::kFloat32, 2, table);
  const int64_t dim = table.size(1);
  const int64_t cap = uids.size(0);
  TORCH_CHECK(dim >= 1 && dim < kMaxRows, "dim must be positive, got ", dim);
  TORCH_CHECK(accum.sizes() == table.sizes(), "accum must be shaped like the "
              "table");
  TORCH_CHECK(delta.size(0) == cap && delta.size(1) == dim && g2.sizes() ==
              delta.sizes(), "delta and g2 must be (", cap, ", ", dim, ")");
  if (cap == 0) return;
  const c10::cuda::CUDAGuard guard(table.device());
  launch_sparse_adagrad_apply(
      table.data_ptr<float>(), accum.data_ptr<float>(), table.size(0),
      static_cast<int>(dim), uids.data_ptr<int32_t>(), cap,
      delta.data_ptr<float>(), g2.data_ptr<float>(),
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("embedding_bag_forward", &embedding_bag_forward,
        "Embedding bag over a CSR-ordered index stream (CUDA)",
        py::arg("working"), py::arg("inv"), py::arg("weights"),
        py::arg("order"), py::arg("offsets"), py::arg("out"));
  m.def("embedding_bag_backward", &embedding_bag_backward,
        "Working-row gradient of the bag, streams sorted by working row "
        "(CUDA)", py::arg("g"), py::arg("seg"), py::arg("weights"),
        py::arg("offsets"), py::arg("g_work"));
  m.def("embedding_bag_weight_grad", &embedding_bag_weight_grad,
        "Per-entry weight gradient of the bag (CUDA)", py::arg("g"),
        py::arg("seg"), py::arg("working"), py::arg("inv"), py::arg("g_w"));
  m.def("sparse_adagrad_apply", &sparse_adagrad_apply,
        "In-place AdaGrad push of precomputed (delta, g2) rows (CUDA)",
        py::arg("table"), py::arg("accum"), py::arg("uids"), py::arg("delta"),
        py::arg("g2"));
}
