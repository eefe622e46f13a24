// The Python-facing wrappers of the hand-written CUDA kernels: their
// declarations, for the module (bindings.cpp), and the argument checks they
// share.  The wrappers live in three sources that include ATen's tensor
// alone (bind_embedding_bag.cpp, bind_sparse.cpp, bind_dense.cpp), so the
// build compiles them side by side; only bindings.cpp includes the Python
// binding's headers, and the kernels themselves (*.cu) see plain pointers.
#pragma once

#include <ATen/core/Tensor.h>

#include <cstdint>
#include <optional>
#include <utility>
#include <vector>

namespace repro_bind {

std::vector<at::Tensor> embedding_bag_forward(
    const at::Tensor& working, const at::Tensor& inv,
    const at::Tensor& seg, const std::optional<at::Tensor>& weights,
    int64_t num_bags, bool streams_only);

void embedding_bag_walk(const at::Tensor& working,
                        const at::Tensor& inv_sorted,
                        const std::optional<at::Tensor>& w_sorted,
                        const at::Tensor& offsets,
                        const at::Tensor& out);

std::vector<at::Tensor> embedding_bag_backward(
    const at::Tensor& g, const at::Tensor& inv,
    const at::Tensor& seg, const std::optional<at::Tensor>& weights,
    int64_t working_rows, bool streams_only);

void embedding_bag_weight_grad(const at::Tensor& g,
                               const at::Tensor& seg,
                               const at::Tensor& working,
                               const at::Tensor& inv,
                               const at::Tensor& g_w);

void sparse_adagrad_apply(const at::Tensor& table,
                          const at::Tensor& accum,
                          const at::Tensor& uids,
                          const at::Tensor& grads, double lr, double eps);

void sparse_adagrad_cached_apply(const at::Tensor& cache_rows,
                                 const at::Tensor& cache_accum,
                                 const at::Tensor& slots,
                                 const at::Tensor& uids,
                                 const at::Tensor& grads, double lr,
                                 double eps);

at::Tensor gather_rows_cached(const at::Tensor& cache_rows,
                                 const at::Tensor& slots, bool drop_row);

at::Tensor hash_lookup(const at::Tensor& key_tab,
                          const at::Tensor& slot_tab,
                          const at::Tensor& slot_uid,
                          const at::Tensor& uids);

void dot_interaction(const at::Tensor& feats, const at::Tensor& out);

void dot_interaction_backward(const at::Tensor& g,
                              const at::Tensor& feats,
                              const at::Tensor& out);

void flash_attention(const at::Tensor& q, const at::Tensor& k,
                     const at::Tensor& v, const at::Tensor& out,
                     bool causal, const std::optional<at::Tensor>& lse,
                     int window, int chunk);

void flash_attention_backward(const at::Tensor& q, const at::Tensor& k,
                              const at::Tensor& v, const at::Tensor& out,
                              const at::Tensor& dout,
                              const at::Tensor& lse,
                              const at::Tensor& delta,
                              const at::Tensor& dq,
                              const at::Tensor& dk,
                              const at::Tensor& dv, bool causal,
                              int window, int chunk);

void sparse_adagrad_staged(const at::Tensor& rows,
                           const at::Tensor& accum,
                           const at::Tensor& grads, double lr, double eps);

void fused_adam(const at::Tensor& table,
                const std::vector<at::Tensor>& grads,
                const at::Tensor& t,
                const std::optional<at::Tensor>& lr_t, double lr,
                const std::optional<at::Tensor>& mhat,
                const std::optional<at::Tensor>& vhat, double b1,
                double b2, double weight_decay, int64_t k, bool warmup);

// ---- checks shared by the wrappers (TORCH_CHECK raises RuntimeError)

inline constexpr int64_t kMaxRows = int64_t{1} << 31;

inline void check_cuda(const at::Tensor& t, const char* name,
                at::ScalarType dtype, int64_t ndim,
                const at::Tensor& like) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.device() == like.device(), name, " is on ", t.device(),
              ", expected ", like.device());
  TORCH_CHECK(t.scalar_type() == dtype, name, " has dtype ", t.scalar_type(),
              ", expected ", dtype);
  TORCH_CHECK(t.dim() == ndim, name, " must be ", ndim, "-D");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

// The bag's widest row: 32 column tiles of 256 (embedding_bag.cu's
// kTileCols; the scratch holds a counter for each tile).
inline constexpr int64_t kMaxBagDim = 8192;

inline void check_dim(int64_t dim) {
  TORCH_CHECK(dim >= 1 && dim <= kMaxBagDim, "dim must lie in [1, ",
              kMaxBagDim, "], got ", dim);
}

inline void check_rows(int64_t rows, const char* what) {
  TORCH_CHECK(rows >= 1 && rows < kMaxRows, what, " must lie in [1, 2^31), got ",
              rows);
}

inline const float* optional_weights(const std::optional<at::Tensor>& weights,
                              const at::Tensor& like, int64_t nnz) {
  if (!weights.has_value()) return nullptr;
  check_cuda(*weights, "weights", at::kFloat, 1, like);
  TORCH_CHECK(weights->size(0) == nnz, "weights must have ", nnz, " entries");
  return weights->data_ptr<float>();
}

inline void check_offsets(const at::Tensor& offsets, int64_t num_out,
                   const at::Tensor& like) {
  check_cuda(offsets, "offsets", at::kLong, 1, like);
  TORCH_CHECK(offsets.size(0) == num_out + 1, "offsets must have ",
              num_out + 1, " entries");
}

}  // namespace repro_bind
