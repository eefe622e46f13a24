// Python binding of the hand-written CUDA kernels.  This is the only source
// that includes PyTorch's headers: the kernels themselves (*.cu) see plain
// pointers, so nvcc compiles them in seconds.
#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include <algorithm>
#include <vector>

#include "fused_adam.h"

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
void launch_dot_interaction(const void* feats, void* out, int64_t B, int F,
                            int D, bool bf16, cudaStream_t stream);
int dot_interaction_max_features();
void launch_dot_interaction_backward(const void* g, const void* feats,
                                     void* out, int64_t B, int F, int D,
                                     bool bf16, cudaStream_t stream);
cudaError_t launch_flash_attention(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int64_t B, int S, int H, int Kv, int hd,
                                   bool causal, int window, int chunk,
                                   bool bf16, cudaStream_t stream);
cudaError_t launch_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int64_t B, int S, int H, int Kv, int hd, bool causal,
    int window, int chunk, bool bf16, cudaStream_t stream);
int flash_attention_max_head_dim();
cudaError_t launch_hash_lookup(const int32_t* key_tab,
                               const int32_t* slot_tab, int64_t n_buckets,
                               const int32_t* slot_uid, int64_t n_slots,
                               const int32_t* uids, int64_t n, int32_t* out,
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

// Views of the index streams that build_streams left in `scratch` (the
// byte offsets `at` of streams_scratch_bytes): [vals_sorted, w_sorted
// (undefined without weights), offsets (int64, groups + 1), keys_sorted
// (the entries outside [0, groups) as groups, last)].
std::vector<torch::Tensor> stream_views(const torch::Tensor& scratch,
                                        const size_t at[5], int64_t nnz,
                                        int64_t groups, bool weighted) {
  auto view = [&](int part, int64_t n, torch::ScalarType dtype) {
    const int64_t size = n * static_cast<int64_t>(c10::elementSize(dtype));
    return scratch.narrow(0, static_cast<int64_t>(at[part]), size)
        .view(dtype);
  };
  torch::Tensor w_sorted;
  if (weighted) w_sorted = view(2, nnz, torch::kFloat32);
  return {view(0, nnz, torch::kInt32), w_sorted,
          view(3, groups + 1, torch::kInt64), view(1, nnz, torch::kInt32)};
}

// out[b] = sum over j with seg[j] == b of w[j] * working[inv[j]], every
// bag written, in one call: the index streams by bag built on the card (a
// stable order, no sort, no host sync), then the walk, with every
// intermediate in one scratch allocation; returns [out] (num_bags x dim).
// With streams_only it builds only the streams and returns them, views of
// the scratch: [inv_sorted, w_sorted, offsets, keys_sorted] (stream_views;
// keys_sorted is seg, the entries outside [0, num_bags) as num_bags).
std::vector<torch::Tensor> embedding_bag_forward(
    const torch::Tensor& working, const torch::Tensor& inv,
    const torch::Tensor& seg, const c10::optional<torch::Tensor>& weights,
    int64_t num_bags, bool streams_only) {
  check_cuda(working, "working", torch::kFloat32, 2, working);
  check_cuda(inv, "inv", torch::kInt32, 1, working);
  check_cuda(seg, "seg", torch::kInt32, 1, working);
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
  auto scratch = torch::empty({static_cast<int64_t>(bytes)},
                              working.options().dtype(torch::kUInt8));
  torch::Tensor out;
  if (!streams_only) out = torch::empty({num_bags, dim}, working.options());
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
void embedding_bag_walk(const torch::Tensor& working,
                        const torch::Tensor& inv_sorted,
                        const c10::optional<torch::Tensor>& w_sorted,
                        const torch::Tensor& offsets,
                        const torch::Tensor& out) {
  check_cuda(working, "working", torch::kFloat32, 2, working);
  check_cuda(inv_sorted, "inv_sorted", torch::kInt32, 1, working);
  check_cuda(out, "out", torch::kFloat32, 2, working);
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
std::vector<torch::Tensor> embedding_bag_backward(
    const torch::Tensor& g, const torch::Tensor& inv,
    const torch::Tensor& seg, const c10::optional<torch::Tensor>& weights,
    int64_t working_rows, bool streams_only) {
  check_cuda(g, "g", torch::kFloat32, 2, g);
  check_cuda(inv, "inv", torch::kInt32, 1, g);
  check_cuda(seg, "seg", torch::kInt32, 1, g);
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
  auto scratch = torch::empty({static_cast<int64_t>(bytes)},
                              g.options().dtype(torch::kUInt8));
  torch::Tensor g_work;
  if (!streams_only) g_work = torch::empty({working_rows, dim}, g.options());
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
                      .view(torch::kInt32));
  return views;
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

// Every check of the pushes and the cached gather is made here, once, and
// raises ValueError.
void check_value(const torch::Tensor& t, const char* name,
                 torch::ScalarType dtype, int64_t ndim,
                 const torch::Tensor& like, const char* what) {
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
std::pair<int64_t, int64_t> check_push(const torch::Tensor& table,
                                       const torch::Tensor& accum,
                                       const torch::Tensor& uids,
                                       const torch::Tensor& grads,
                                       const char* what) {
  check_value(table, "table", torch::kFloat32, 2, table, what);
  check_value(accum, "accum", torch::kFloat32, 2, table, what);
  check_value(uids, "uids", torch::kInt32, 1, table, what);
  check_value(grads, "grads", torch::kFloat32, 2, table, what);
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
void sparse_adagrad_apply(const torch::Tensor& table,
                          const torch::Tensor& accum,
                          const torch::Tensor& uids,
                          const torch::Tensor& grads, double lr, double eps) {
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
void sparse_adagrad_cached_apply(const torch::Tensor& cache_rows,
                                 const torch::Tensor& cache_accum,
                                 const torch::Tensor& slots,
                                 const torch::Tensor& uids,
                                 const torch::Tensor& grads, double lr,
                                 double eps) {
  const char* what = "sparse_adagrad_cached_apply_cuda";
  const auto [dim, cap] = check_push(cache_rows, cache_accum, uids, grads,
                                     what);
  check_value(slots, "slots", torch::kInt32, 1, cache_rows, what);
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
torch::Tensor gather_rows_cached(const torch::Tensor& cache_rows,
                                 const torch::Tensor& slots, bool drop_row) {
  const char* what = "gather_rows_cached_cuda";
  check_value(cache_rows, "cache_rows", torch::kFloat32, 2, cache_rows,
              what);
  check_value(slots, "slots", torch::kInt32, 1, cache_rows, what);
  const int64_t dim = cache_rows.size(1);
  const int64_t cap = slots.size(0);
  TORCH_CHECK_VALUE(dim >= 1 && dim < kMaxRows, "dim must be positive, got ",
                    dim);
  TORCH_CHECK_VALUE(cache_rows.size(0) >= 1 && cache_rows.size(0) < kMaxRows,
                    "cache rows must lie in [1, 2^31), got ",
                    cache_rows.size(0));
  const int64_t n_out = cap + (drop_row ? 1 : 0);
  auto out = torch::empty({n_out, dim}, cache_rows.options());
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
torch::Tensor hash_lookup(const torch::Tensor& key_tab,
                          const torch::Tensor& slot_tab,
                          const torch::Tensor& slot_uid,
                          const torch::Tensor& uids) {
  const std::pair<const torch::Tensor*, const char*> args[] = {
      {&key_tab, "key_tab"}, {&slot_tab, "slot_tab"},
      {&slot_uid, "slot_uid"}, {&uids, "uids"}};
  for (const auto& [t, name] : args) {
    TORCH_CHECK_VALUE(t->dim() == 1 && t->scalar_type() == torch::kInt32,
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
  auto out = torch::empty_like(uids);
  if (uids.size(0) == 0) return out;
  const c10::cuda::CUDAGuard guard(key_tab.device());
  C10_CUDA_CHECK(launch_hash_lookup(
      key_tab.data_ptr<int32_t>(), slot_tab.data_ptr<int32_t>(), n_buckets,
      slot_uid.data_ptr<int32_t>(), slot_uid.size(0),
      uids.data_ptr<int32_t>(), uids.size(0), out.data_ptr<int32_t>(),
      c10::cuda::getCurrentCUDAStream().stream()));
  return out;
}

// out[b, p] = dot of rows (i, j) of feats[b], the p-th pair of the strict
// lower triangle (csrc/dot_interaction.cu).
void dot_interaction(const torch::Tensor& feats, const torch::Tensor& out) {
  const auto dtype = feats.scalar_type();
  TORCH_CHECK(dtype == torch::kFloat32 || dtype == torch::kBFloat16,
              "feats must be float32 or bfloat16, got ", dtype);
  check_cuda(feats, "feats", dtype, 3, feats);
  check_cuda(out, "out", dtype, 2, feats);
  const int64_t B = feats.size(0), F = feats.size(1), D = feats.size(2);
  TORCH_CHECK(F >= 1 && F <= dot_interaction_max_features(),
              "feats must have 1 to ", dot_interaction_max_features(),
              " features, got ", F);
  TORCH_CHECK(B < kMaxRows && D < kMaxRows, "B and D must lie below 2^31");
  const int64_t P = F * (F - 1) / 2;
  TORCH_CHECK(out.size(0) == B && out.size(1) == P, "out must be (", B, ", ",
              P, ")");
  if (B * P == 0) return;
  const c10::cuda::CUDAGuard guard(feats.device());
  launch_dot_interaction(feats.data_ptr(), out.data_ptr(), B,
                         static_cast<int>(F), static_cast<int>(D),
                         dtype == torch::kBFloat16,
                         c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// out (B, F, D) = (G + G^T) feats, G = g (B, F (F - 1) / 2) scattered into
// the strict lower triangle: the interaction's backward
// (csrc/dot_interaction.cu).
void dot_interaction_backward(const torch::Tensor& g,
                              const torch::Tensor& feats,
                              const torch::Tensor& out) {
  const auto dtype = feats.scalar_type();
  TORCH_CHECK(dtype == torch::kFloat32 || dtype == torch::kBFloat16,
              "feats must be float32 or bfloat16, got ", dtype);
  check_cuda(feats, "feats", dtype, 3, feats);
  check_cuda(g, "g", dtype, 2, feats);
  check_cuda(out, "out", dtype, 3, feats);
  const int64_t B = feats.size(0), F = feats.size(1), D = feats.size(2);
  TORCH_CHECK(F >= 1 && F <= dot_interaction_max_features(),
              "feats must have 1 to ", dot_interaction_max_features(),
              " features, got ", F);
  TORCH_CHECK(B < kMaxRows && D < kMaxRows, "B and D must lie below 2^31");
  const int64_t P = F * (F - 1) / 2;
  TORCH_CHECK(g.size(0) == B && g.size(1) == P, "g must be (", B, ", ", P,
              "), got ", g.sizes());
  TORCH_CHECK(out.sizes() == feats.sizes(), "out must have feats' shape");
  if (B * D == 0) return;
  const c10::cuda::CUDAGuard guard(feats.device());
  launch_dot_interaction_backward(
      g.data_ptr(), feats.data_ptr(), out.data_ptr(), B, static_cast<int>(F),
      static_cast<int>(D), dtype == torch::kBFloat16,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The shapes, dtype and alignment both directions of kernel 9 take: q and
// out (B, S, H, hd), k and v (B, S, Kv, hd); returns (B, S, H, Kv, hd).
std::vector<int64_t> check_attention(const torch::Tensor& q,
                                     const torch::Tensor& k,
                                     const torch::Tensor& v,
                                     const torch::Tensor& out) {
  const auto dtype = q.scalar_type();
  TORCH_CHECK(dtype == torch::kFloat32 || dtype == torch::kBFloat16,
              "q must be float32 or bfloat16, got ", dtype);
  check_cuda(q, "q", dtype, 4, q);
  check_cuda(k, "k", dtype, 4, q);
  check_cuda(v, "v", dtype, 4, q);
  check_cuda(out, "out", dtype, 4, q);
  const int64_t B = q.size(0), S = q.size(1), H = q.size(2), hd = q.size(3);
  const int64_t Kv = k.size(2);
  TORCH_CHECK(k.size(0) == B && k.size(1) == S && k.size(3) == hd &&
              v.sizes() == k.sizes(), "k and v must be (", B, ", ", S,
              ", Kv, ", hd, "), got ", k.sizes(), " and ", v.sizes());
  TORCH_CHECK(out.sizes() == q.sizes(), "out must have q's shape");
  TORCH_CHECK(Kv >= 1 && H % Kv == 0, "H (", H, ") must be a multiple of "
              "Kv (", Kv, ")");
  TORCH_CHECK(hd >= 8 && hd % 8 == 0 && hd <= flash_attention_max_head_dim(),
              "head_dim must be a multiple of 8 up to ",
              flash_attention_max_head_dim(), ", got ", hd);
  TORCH_CHECK(B < 65536 && H < 65536 && S < kMaxRows,
              "B and H must lie below 2^16 and S below 2^31");
  for (const torch::Tensor* t : {&q, &k, &v, &out})
    TORCH_CHECK(reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                "q, k, v and out must be 16-byte aligned");
  return {B, S, H, Kv, hd};
}

// the (B, H, S) float32 row statistics of kernel 9 (lse, D)
void check_rows(const torch::Tensor& t, const char* name,
                const torch::Tensor& q) {
  check_cuda(t, name, torch::kFloat32, 3, q);
  TORCH_CHECK(t.size(0) == q.size(0) && t.size(1) == q.size(2) &&
              t.size(2) == q.size(1), name, " must be (B, H, S)");
}

// out (B, S, H, hd) = softmax(q k^T / sqrt(hd) + mask) v with KV head
// h / (H / Kv) for q head h, causal or full, with a sliding window and a
// chunk under causal (0: none; csrc/flash_attention.cu); with lse
// (B, H, S) float32 also each row's log-sum-exp.
void flash_attention(const torch::Tensor& q, const torch::Tensor& k,
                     const torch::Tensor& v, const torch::Tensor& out,
                     bool causal, const c10::optional<torch::Tensor>& lse,
                     int window, int chunk) {
  const auto d = check_attention(q, k, v, out);
  if (lse.has_value()) check_rows(*lse, "lse", q);
  if (d[0] * d[1] == 0) return;
  const c10::cuda::CUDAGuard guard(q.device());
  C10_CUDA_CHECK(launch_flash_attention(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
      lse.has_value() ? lse->data_ptr<float>() : nullptr, d[0],
      static_cast<int>(d[1]), static_cast<int>(d[2]), static_cast<int>(d[3]),
      static_cast<int>(d[4]), causal, window, chunk,
      q.scalar_type() == torch::kBFloat16,
      c10::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// kernel 9b: dq, dk, dv of the attention whose forward gave out and lse,
// given dout, under the forward's window and chunk (0: none); delta a
// (B, H, S) float32 scratch (csrc/flash_attention.cu).
void flash_attention_backward(const torch::Tensor& q, const torch::Tensor& k,
                              const torch::Tensor& v, const torch::Tensor& out,
                              const torch::Tensor& dout,
                              const torch::Tensor& lse,
                              const torch::Tensor& delta,
                              const torch::Tensor& dq,
                              const torch::Tensor& dk,
                              const torch::Tensor& dv, bool causal,
                              int window, int chunk) {
  const auto d = check_attention(q, k, v, out);
  const auto dtype = q.scalar_type();
  check_cuda(dout, "dout", dtype, 4, q);
  check_cuda(dq, "dq", dtype, 4, q);
  check_cuda(dk, "dk", dtype, 4, q);
  check_cuda(dv, "dv", dtype, 4, q);
  TORCH_CHECK(dout.sizes() == q.sizes() && dq.sizes() == q.sizes() &&
              dk.sizes() == k.sizes() && dv.sizes() == k.sizes(),
              "dout and dq must have q's shape, dk and dv k's");
  for (const torch::Tensor* t : {&dout, &dq, &dk, &dv})
    TORCH_CHECK(reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                "dout, dq, dk and dv must be 16-byte aligned");
  check_rows(lse, "lse", q);
  check_rows(delta, "delta", q);
  if (d[0] * d[1] == 0) return;
  const c10::cuda::CUDAGuard guard(q.device());
  C10_CUDA_CHECK(launch_flash_attention_backward(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
      dout.data_ptr(), lse.data_ptr<float>(), delta.data_ptr<float>(),
      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), d[0],
      static_cast<int>(d[1]), static_cast<int>(d[2]), static_cast<int>(d[3]),
      static_cast<int>(d[4]), causal, window, chunk,
      dtype == torch::kBFloat16, c10::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// rows += delta(accum, grads); accum += grads^2, elementwise and in place
// (the staged push, csrc/sparse_adagrad.cu).
void sparse_adagrad_staged(const torch::Tensor& rows,
                           const torch::Tensor& accum,
                           const torch::Tensor& grads, double lr, double eps) {
  check_cuda(rows, "rows", torch::kFloat32, 2, rows);
  check_cuda(accum, "accum", torch::kFloat32, 2, rows);
  check_cuda(grads, "grads", torch::kFloat32, 2, rows);
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

const float* optional_scalar(const c10::optional<torch::Tensor>& t,
                             const char* name, const torch::Tensor& like) {
  if (!t.has_value()) return nullptr;
  check_cuda(*t, name, torch::kFloat32, 0, like);
  return t->data_ptr<float>();
}

// The k-step local Adam step over every leaf, in place (csrc/fused_adam.cu).
// `table` is the (L, 6) int64 CPU table of (p, m, v_local, v_hat, numel,
// p is bfloat16) that kernels/fused_adam.py builds once per set of leaves
// (it checks them); `grads` are this step's gradients, one per row of the
// table, each in its parameter's dtype.
void fused_adam(const torch::Tensor& table,
                const std::vector<torch::Tensor>& grads,
                const torch::Tensor& t,
                const c10::optional<torch::Tensor>& lr_t, double lr,
                const c10::optional<torch::Tensor>& mhat,
                const c10::optional<torch::Tensor>& vhat, double b1,
                double b2, double weight_decay, int64_t k, bool warmup) {
  TORCH_CHECK(table.device().is_cpu() && table.scalar_type() == torch::kInt64
              && table.dim() == 2 && table.size(1) == 6 &&
              table.is_contiguous(), "table must be a contiguous (L, 6) int64 "
              "CPU tensor");
  const int64_t leaves = table.size(0);
  TORCH_CHECK(static_cast<int64_t>(grads.size()) == leaves, "got ",
              grads.size(), " gradients for ", leaves, " leaves");
  if (leaves == 0) return;
  check_cuda(t, "t", torch::kInt32, 0, t);
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
      const torch::Tensor& g = grads[first + j];
      check_cuda(g, "grad", r[5] ? torch::kBFloat16 : torch::kFloat32,
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

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("embedding_bag_forward", &embedding_bag_forward,
        "Embedding bag from inv and seg in one call, or its index streams "
        "alone (CUDA)", py::arg("working"), py::arg("inv"), py::arg("seg"),
        py::arg("weights"), py::arg("num_bags"),
        py::arg("streams_only") = false);
  m.def("embedding_bag_walk", &embedding_bag_walk,
        "The embedding bag's walk alone, on index streams in bag order "
        "(CUDA)", py::arg("working"), py::arg("inv_sorted"),
        py::arg("w_sorted"), py::arg("offsets"), py::arg("out"));
  m.def("embedding_bag_backward", &embedding_bag_backward,
        "Working-row gradient of the bag from inv and seg in one call, or "
        "its index streams alone (CUDA)", py::arg("g"), py::arg("inv"),
        py::arg("seg"), py::arg("weights"), py::arg("working_rows"),
        py::arg("streams_only") = false);
  m.def("embedding_bag_weight_grad", &embedding_bag_weight_grad,
        "Per-entry weight gradient of the bag (CUDA)", py::arg("g"),
        py::arg("seg"), py::arg("working"), py::arg("inv"), py::arg("g_w"));
  m.def("sparse_adagrad_apply", &sparse_adagrad_apply,
        "In-place AdaGrad push, the row math in the kernel (CUDA)",
        py::arg("table"), py::arg("accum"), py::arg("uids"), py::arg("grads"),
        py::arg("lr"), py::arg("eps"));
  m.def("sparse_adagrad_cached_apply", &sparse_adagrad_cached_apply,
        "In-place AdaGrad push into the device cache by slot, the row math "
        "in the kernel (CUDA)", py::arg("cache_rows"), py::arg("cache_accum"),
        py::arg("slots"), py::arg("uids"), py::arg("grads"), py::arg("lr"),
        py::arg("eps"));
  m.def("gather_rows_cached", &gather_rows_cached,
        "Row gather from the device cache by slot, with an optional zero "
        "drop row after the rows (CUDA)", py::arg("cache_rows"),
        py::arg("slots"), py::arg("drop_row") = false);
  m.def("sparse_adagrad_staged", &sparse_adagrad_staged,
        "In-place dense-block AdaGrad over staged working-set rows (CUDA)",
        py::arg("rows"), py::arg("accum"), py::arg("grads"), py::arg("lr"),
        py::arg("eps"));
  m.def("fused_adam", &fused_adam,
        "In-place k-step local Adam step over every leaf in one launch "
        "(CUDA)", py::arg("table"), py::arg("grads"), py::arg("t"),
        py::arg("lr_t"), py::arg("lr"), py::arg("mhat"), py::arg("vhat"),
        py::arg("b1"), py::arg("b2"), py::arg("weight_decay"), py::arg("k"),
        py::arg("warmup"));
  m.def("dot_interaction", &dot_interaction,
        "DLRM dot interaction: the strict lower triangle of each instance's "
        "self-Gram (CUDA)", py::arg("feats"), py::arg("out"));
  m.def("dot_interaction_backward", &dot_interaction_backward,
        "DLRM dot interaction's backward: (G + G^T) feats, G the gradient "
        "in the strict lower triangle (CUDA)", py::arg("g"), py::arg("feats"),
        py::arg("out"));
  m.def("flash_attention", &flash_attention,
        "Causal or full GQA softmax attention with the online-softmax "
        "recurrence, forward, with an optional sliding window and chunk, "
        "optionally with the rows' log-sum-exp (CUDA)",
        py::arg("q"), py::arg("k"), py::arg("v"), py::arg("out"),
        py::arg("causal"), py::arg("lse") = py::none(),
        py::arg("window") = 0, py::arg("chunk") = 0);
  m.def("flash_attention_backward", &flash_attention_backward,
        "Causal or full GQA softmax attention's backward: dq, dk, dv from "
        "the forward's output and log-sum-exp, with an optional sliding "
        "window and chunk (CUDA)", py::arg("q"),
        py::arg("k"), py::arg("v"), py::arg("out"), py::arg("dout"),
        py::arg("lse"), py::arg("delta"), py::arg("dq"), py::arg("dk"),
        py::arg("dv"), py::arg("causal"), py::arg("window") = 0,
        py::arg("chunk") = 0);
  m.def("hash_lookup", &hash_lookup,
        "Batch linear probe of the cache's id -> slot hash map (CUDA)",
        py::arg("key_tab"), py::arg("slot_tab"), py::arg("slot_uid"),
        py::arg("uids"));
}
