// The sparse path's wrappers: the AdaGrad pushes, the cached gather, the
// hash probe (csrc/sparse_adagrad.cu, csrc/hash_map.cu) and the k-step
// local Adam step (csrc/fused_adam.cu).
#include "bindings.h"

#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include <algorithm>

#include "fused_adam.h"

void launch_sparse_adagrad_apply(float* table, float* accum, int64_t rows,
                                 int dim, const int32_t* uids,
                                 const int32_t* slots, int64_t cap,
                                 const float* grads, float neg_lr, float eps,
                                 cudaStream_t stream);
void launch_gather_rows_cached(const float* cache_rows, int64_t n_slots,
                               int dim, const int32_t* slots, int64_t cap,
                               int64_t n_out, float* out,
                               cudaStream_t stream);
void launch_sparse_adagrad_staged(float* rows, float* accum,
                                  const float* grads, int64_t n, float neg_lr,
                                  float eps, cudaStream_t stream);
cudaError_t launch_hash_lookup(const int32_t* key_tab,
                               const int32_t* slot_tab, int64_t n_buckets,
                               const int32_t* slot_uid, int64_t n_slots,
                               const int32_t* uids, int64_t n, int32_t* out,
                               cudaStream_t stream);


namespace repro_bind {

// Every check of the pushes and the cached gather is made here, once, and
// raises ValueError.
void check_value(const at::Tensor& t, const char* name,
                 at::ScalarType dtype, int64_t ndim,
                 const at::Tensor& like, const char* what) {
  TORCH_CHECK_VALUE(t.dim() == ndim && t.scalar_type() == dtype, name,
                    " must be ", ndim, "-D ", dtype, ", got ", t.sizes(),
                    " ", t.scalar_type());
  TORCH_CHECK_VALUE(t.device() == like.device(), name, " is on ",
                    t.device(), ", expected ", like.device());
  TORCH_CHECK_VALUE(t.is_cuda(), what, " takes CUDA tensors, got ",
                    t.device());
  TORCH_CHECK_VALUE(t.is_contiguous(), what, " takes contiguous tensors; ",
                    name, " is not");
}

// Checks shared by both pushes; returns (dim, cap).
std::pair<int64_t, int64_t> check_push(const at::Tensor& table,
                                       const at::Tensor& accum,
                                       const at::Tensor& uids,
                                       const at::Tensor& grads,
                                       const char* what) {
  check_value(table, "table", at::kFloat, 2, table, what);
  check_value(accum, "accum", at::kFloat, 2, table, what);
  check_value(uids, "uids", at::kInt, 1, table, what);
  check_value(grads, "grads", at::kFloat, 2, table, what);
  const int64_t dim = table.size(1);
  const int64_t cap = uids.size(0);
  TORCH_CHECK_VALUE(dim >= 1 && dim < kMaxRows, "dim must be positive, got ",
                    dim);
  TORCH_CHECK_VALUE(accum.sizes() == table.sizes(), "accum must be shaped "
                    "like the table ", table.sizes(), ", got ",
                    accum.sizes());
  TORCH_CHECK_VALUE(grads.size(0) == cap && grads.size(1) == dim,
                    "grads must be (", cap, ", ", dim, "), got ",
                    grads.sizes());
  return {dim, cap};
}

// table[uids[i]], accum[uids[i]] <- AdaGrad(grads[i]) in place, skipping
// the pads of pull_working_set's layout (csrc/sparse_adagrad.cu).
void sparse_adagrad_apply(const at::Tensor& table,
                          const at::Tensor& accum,
                          const at::Tensor& uids,
                          const at::Tensor& grads, double lr, double eps) {
  const auto [dim, cap] = check_push(table, accum, uids, grads,
                                     "sparse_adagrad_apply_cuda");
  if (cap == 0) return;
  const c10::cuda::CUDAGuard guard(table.device());
  launch_sparse_adagrad_apply(
      table.data_ptr<float>(), accum.data_ptr<float>(), table.size(0),
      static_cast<int>(dim), uids.data_ptr<int32_t>(), nullptr, cap,
      grads.data_ptr<float>(), static_cast<float>(-lr),
      static_cast<float>(eps), c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// cache_rows[slots[i]], cache_accum[slots[i]] <- AdaGrad(grads[i]) in
// place, skipping the pads found by uids (csrc/sparse_adagrad.cu).
void sparse_adagrad_cached_apply(const at::Tensor& cache_rows,
                                 const at::Tensor& cache_accum,
                                 const at::Tensor& slots,
                                 const at::Tensor& uids,
                                 const at::Tensor& grads, double lr,
                                 double eps) {
  const char* what = "sparse_adagrad_cached_apply_cuda";
  const auto [dim, cap] = check_push(cache_rows, cache_accum, uids, grads,
                                     what);
  check_value(slots, "slots", at::kInt, 1, cache_rows, what);
  TORCH_CHECK_VALUE(slots.size(0) == cap, "slots must be (", cap,
                    ",) like uids, got ", slots.sizes());
  TORCH_CHECK_VALUE(cache_rows.size(0) >= 1 && cache_rows.size(0) < kMaxRows,
                    "cache rows must lie in [1, 2^31), got ",
                    cache_rows.size(0));
  if (cap == 0) return;
  const c10::cuda::CUDAGuard guard(cache_rows.device());
  launch_sparse_adagrad_apply(
      cache_rows.data_ptr<float>(), cache_accum.data_ptr<float>(),
      cache_rows.size(0), static_cast<int>(dim), uids.data_ptr<int32_t>(),
      slots.data_ptr<int32_t>(), cap, grads.data_ptr<float>(),
      static_cast<float>(-lr), static_cast<float>(eps),
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// out[i] = cache_rows[slots[i]], (cap, dim); with drop_row (cap + 1, dim),
// its last row zero (csrc/sparse_adagrad.cu).
at::Tensor gather_rows_cached(const at::Tensor& cache_rows,
                                 const at::Tensor& slots, bool drop_row) {
  const char* what = "gather_rows_cached_cuda";
  check_value(cache_rows, "cache_rows", at::kFloat, 2, cache_rows,
              what);
  check_value(slots, "slots", at::kInt, 1, cache_rows, what);
  const int64_t dim = cache_rows.size(1);
  const int64_t cap = slots.size(0);
  TORCH_CHECK_VALUE(dim >= 1 && dim < kMaxRows, "dim must be positive, got ",
                    dim);
  TORCH_CHECK_VALUE(cache_rows.size(0) >= 1 && cache_rows.size(0) < kMaxRows,
                    "cache rows must lie in [1, 2^31), got ",
                    cache_rows.size(0));
  const int64_t n_out = cap + (drop_row ? 1 : 0);
  auto out = at::empty({n_out, dim}, cache_rows.options());
  if (n_out == 0) return out;
  const c10::cuda::CUDAGuard guard(cache_rows.device());
  launch_gather_rows_cached(cache_rows.data_ptr<float>(), cache_rows.size(0),
                            static_cast<int>(dim), slots.data_ptr<int32_t>(),
                            cap, n_out, out.data_ptr<float>(),
                            c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

// slots[i] = live cache slot of uids[i] or -1 (csrc/hash_map.cu); every
// check of hash_lookup_cuda is made here, once, and raises ValueError.
at::Tensor hash_lookup(const at::Tensor& key_tab,
                          const at::Tensor& slot_tab,
                          const at::Tensor& slot_uid,
                          const at::Tensor& uids) {
  const std::pair<const at::Tensor*, const char*> args[] = {
      {&key_tab, "key_tab"}, {&slot_tab, "slot_tab"},
      {&slot_uid, "slot_uid"}, {&uids, "uids"}};
  for (const auto& [t, name] : args) {
    TORCH_CHECK_VALUE(t->dim() == 1 && t->scalar_type() == at::kInt,
                      name, " must be 1-D int32, got ", t->sizes(), " ",
                      t->scalar_type());
    TORCH_CHECK_VALUE(t->device() == key_tab.device(), "key_tab, slot_tab, "
                      "slot_uid and uids must share a device");
    TORCH_CHECK_VALUE(t->is_contiguous(), "hash_lookup_cuda takes "
                      "contiguous tensors; ", name, " is not");
  }
  TORCH_CHECK_VALUE(key_tab.is_cuda(), "hash_lookup_cuda takes CUDA "
                    "tensors, got ", key_tab.device());
  const int64_t n_buckets = key_tab.size(0);
  TORCH_CHECK_VALUE(n_buckets >= 1 && n_buckets <= kMaxRows &&
                    (n_buckets & (n_buckets - 1)) == 0 &&
                    slot_tab.size(0) == n_buckets,
                    "key_tab and slot_tab must have the same power-of-2 "
                    "length <= 2^31, got ", n_buckets, " and ",
                    slot_tab.size(0));
  auto out = at::empty_like(uids);
  if (uids.size(0) == 0) return out;
  const c10::cuda::CUDAGuard guard(key_tab.device());
  C10_CUDA_CHECK(launch_hash_lookup(
      key_tab.data_ptr<int32_t>(), slot_tab.data_ptr<int32_t>(), n_buckets,
      slot_uid.data_ptr<int32_t>(), slot_uid.size(0),
      uids.data_ptr<int32_t>(), uids.size(0), out.data_ptr<int32_t>(),
      c10::cuda::getCurrentCUDAStream().stream()));
  return out;
}

// rows += delta(accum, grads); accum += grads^2, elementwise and in place
// (the staged push, csrc/sparse_adagrad.cu).
void sparse_adagrad_staged(const at::Tensor& rows,
                           const at::Tensor& accum,
                           const at::Tensor& grads, double lr, double eps) {
  check_cuda(rows, "rows", at::kFloat, 2, rows);
  check_cuda(accum, "accum", at::kFloat, 2, rows);
  check_cuda(grads, "grads", at::kFloat, 2, rows);
  TORCH_CHECK(accum.sizes() == rows.sizes() && grads.sizes() == rows.sizes(),
              "rows, accum and grads must have one shape");
  const int64_t n = rows.numel();
  if (n == 0) return;
  const c10::cuda::CUDAGuard guard(rows.device());
  launch_sparse_adagrad_staged(
      rows.data_ptr<float>(), accum.data_ptr<float>(),
      grads.data_ptr<float>(), n, static_cast<float>(-lr),
      static_cast<float>(eps), c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

const float* optional_scalar(const std::optional<at::Tensor>& t,
                             const char* name, const at::Tensor& like) {
  if (!t.has_value()) return nullptr;
  check_cuda(*t, name, at::kFloat, 0, like);
  return t->data_ptr<float>();
}

// The k-step local Adam step over every leaf, in place (csrc/fused_adam.cu).
// `table` is the (L, 6) int64 CPU table of (p, m, v_local, v_hat, numel,
// p is bfloat16) that kernels/fused_adam.py builds once per set of leaves
// (it checks them); `grads` are this step's gradients, one per row of the
// table, each in its parameter's dtype.
void fused_adam(const at::Tensor& table,
                const std::vector<at::Tensor>& grads,
                const at::Tensor& t,
                const std::optional<at::Tensor>& lr_t, double lr,
                const std::optional<at::Tensor>& mhat,
                const std::optional<at::Tensor>& vhat, double b1,
                double b2, double weight_decay, int64_t k, bool warmup) {
  TORCH_CHECK(table.device().is_cpu() && table.scalar_type() == at::kLong
              && table.dim() == 2 && table.size(1) == 6 &&
              table.is_contiguous(), "table must be a contiguous (L, 6) int64 "
              "CPU tensor");
  const int64_t leaves = table.size(0);
  TORCH_CHECK(static_cast<int64_t>(grads.size()) == leaves, "got ",
              grads.size(), " gradients for ", leaves, " leaves");
  if (leaves == 0) return;
  check_cuda(t, "t", at::kInt, 0, t);
  AdamScalars s{};
  s.t = t.data_ptr<int32_t>();
  s.k = static_cast<int32_t>(k);
  s.warmup = warmup;
  s.lr_ptr = optional_scalar(lr_t, "lr", t);
  s.lr = static_cast<float>(lr);
  s.mhat = optional_scalar(mhat, "mhat_s", t);
  s.vhat = optional_scalar(vhat, "vhat_s", t);
  s.b1 = static_cast<float>(b1);
  s.c1 = static_cast<float>(1.0 - b1);
  s.b2 = static_cast<float>(b2);
  s.c2 = static_cast<float>(1.0 - b2);
  s.has_wd = weight_decay > 0.0;
  s.lrwd = static_cast<float>(lr * weight_decay);
  s.wd = static_cast<float>(weight_decay);
  const int64_t* rows = table.data_ptr<int64_t>();
  const c10::cuda::CUDAGuard guard(t.device());
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  for (int64_t first = 0; first < leaves; first += kMaxLeaves) {
    AdamLeaves a{};
    a.count = static_cast<int>(std::min<int64_t>(kMaxLeaves, leaves - first));
    a.block_start[0] = 0;
    for (int j = 0; j < a.count; ++j) {
      const int64_t* r = rows + (first + j) * 6;
      const at::Tensor& g = grads[first + j];
      check_cuda(g, "grad", r[5] ? at::kBFloat16 : at::kFloat,
                 g.dim(), t);
      TORCH_CHECK(g.numel() == r[4], "gradient ", first + j, " has ",
                  g.numel(), " elements, its leaf ", r[4]);
      a.p[j] = reinterpret_cast<void*>(r[0]);
      a.m[j] = reinterpret_cast<float*>(r[1]);
      a.v[j] = reinterpret_cast<float*>(r[2]);
      a.vh[j] = reinterpret_cast<const float*>(r[3]);
      a.g[j] = g.data_ptr();
      a.n[j] = r[4];
      a.bf16[j] = r[5] != 0;
      a.block_start[j + 1] = a.block_start[j] + fused_adam_blocks(r[4]);
    }
    if (a.block_start[a.count] == 0) continue;
    launch_fused_adam(a, s, stream);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
  }
}

}  // namespace repro_bind
