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

namespace {

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

// out[b] = sum over order[offsets[b]:offsets[b+1]] of w[j] * working[inv[j]].
void embedding_bag_forward(const torch::Tensor& working,
                           const torch::Tensor& inv,
                           const c10::optional<torch::Tensor>& weights,
                           const torch::Tensor& order,
                           const torch::Tensor& offsets,
                           const torch::Tensor& out) {
  check_cuda(working, "working", torch::kFloat32, 2, working);
  check_cuda(inv, "inv", torch::kInt32, 1, working);
  check_cuda(order, "order", torch::kInt64, 1, working);
  check_cuda(offsets, "offsets", torch::kInt64, 1, working);
  check_cuda(out, "out", torch::kFloat32, 2, working);
  const int64_t dim = working.size(1);
  const int64_t num_bags = out.size(0);
  TORCH_CHECK(dim >= 1 && dim <= 256, "dim must lie in [1, 256], got ", dim);
  TORCH_CHECK(out.size(1) == dim, "out must have ", dim, " columns");
  TORCH_CHECK(num_bags >= 1 && num_bags < (int64_t{1} << 31),
              "num_bags must lie in [1, 2^31), got ", num_bags);
  TORCH_CHECK(offsets.size(0) == num_bags + 1,
              "offsets must have num_bags + 1 entries");
  TORCH_CHECK(order.size(0) == inv.size(0), "order and inv differ in length");
  const float* w = nullptr;
  if (weights.has_value()) {
    check_cuda(*weights, "weights", torch::kFloat32, 1, working);
    TORCH_CHECK(weights->size(0) == inv.size(0),
                "weights and inv differ in length");
    w = weights->data_ptr<float>();
  }
  const c10::cuda::CUDAGuard guard(working.device());
  launch_embedding_bag(working.data_ptr<float>(), static_cast<int>(dim),
                       inv.data_ptr<int32_t>(), w,
                       order.data_ptr<int64_t>(), offsets.data_ptr<int64_t>(),
                       static_cast<int>(num_bags), out.data_ptr<float>(),
                       c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("embedding_bag_forward", &embedding_bag_forward,
        "Embedding bag over a CSR-ordered index stream (CUDA)",
        py::arg("working"), py::arg("inv"), py::arg("weights"),
        py::arg("order"), py::arg("offsets"), py::arg("out"));
}
