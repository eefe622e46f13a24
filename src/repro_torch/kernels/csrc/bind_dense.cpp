// The dense kernels' wrappers: DLRM's dot interaction in both directions
// (csrc/dot_interaction.cu) and flash attention in both directions
// (csrc/flash_attention.cu).
#include "bindings.h"

#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

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

namespace repro_bind {

// out[b, p] = dot of rows (i, j) of feats[b], the p-th pair of the strict
// lower triangle (csrc/dot_interaction.cu).
void dot_interaction(const at::Tensor& feats, const at::Tensor& out) {
  const auto dtype = feats.scalar_type();
  TORCH_CHECK(dtype == at::kFloat || dtype == at::kBFloat16,
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
                         dtype == at::kBFloat16,
                         c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// out (B, F, D) = (G + G^T) feats, G = g (B, F (F - 1) / 2) scattered into
// the strict lower triangle: the interaction's backward
// (csrc/dot_interaction.cu).
void dot_interaction_backward(const at::Tensor& g,
                              const at::Tensor& feats,
                              const at::Tensor& out) {
  const auto dtype = feats.scalar_type();
  TORCH_CHECK(dtype == at::kFloat || dtype == at::kBFloat16,
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
      static_cast<int>(D), dtype == at::kBFloat16,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The shapes, dtype and alignment both directions of kernel 9 take: q and
// out (B, S, H, hd), k and v (B, S, Kv, hd); returns (B, S, H, Kv, hd).
std::vector<int64_t> check_attention(const at::Tensor& q,
                                     const at::Tensor& k,
                                     const at::Tensor& v,
                                     const at::Tensor& out) {
  const auto dtype = q.scalar_type();
  TORCH_CHECK(dtype == at::kFloat || dtype == at::kBFloat16,
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
  for (const at::Tensor* t : {&q, &k, &v, &out})
    TORCH_CHECK(reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                "q, k, v and out must be 16-byte aligned");
  return {B, S, H, Kv, hd};
}

// the (B, H, S) float32 row statistics of kernel 9 (lse, D)
void check_rows(const at::Tensor& t, const char* name,
                const at::Tensor& q) {
  check_cuda(t, name, at::kFloat, 3, q);
  TORCH_CHECK(t.size(0) == q.size(0) && t.size(1) == q.size(2) &&
              t.size(2) == q.size(1), name, " must be (B, H, S)");
}

// out (B, S, H, hd) = softmax(q k^T / sqrt(hd) + mask) v with KV head
// h / (H / Kv) for q head h, causal or full, with a sliding window and a
// chunk under causal (0: none; csrc/flash_attention.cu); with lse
// (B, H, S) float32 also each row's log-sum-exp.
void flash_attention(const at::Tensor& q, const at::Tensor& k,
                     const at::Tensor& v, const at::Tensor& out,
                     bool causal, const std::optional<at::Tensor>& lse,
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
      q.scalar_type() == at::kBFloat16,
      c10::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// kernel 9b: dq, dk, dv of the attention whose forward gave out and lse,
// given dout, under the forward's window and chunk (0: none); delta a
// (B, H, S) float32 scratch (csrc/flash_attention.cu).
void flash_attention_backward(const at::Tensor& q, const at::Tensor& k,
                              const at::Tensor& v, const at::Tensor& out,
                              const at::Tensor& dout,
                              const at::Tensor& lse,
                              const at::Tensor& delta,
                              const at::Tensor& dq,
                              const at::Tensor& dk,
                              const at::Tensor& dv, bool causal,
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
  for (const at::Tensor* t : {&dout, &dq, &dk, &dv})
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
      dtype == at::kBFloat16, c10::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace repro_bind
