// The launch parameters of the fused local Adam step (fused_adam.cu),
// shared by the kernel and its binding.  Both structs travel by value in
// the kernel's parameters: no device table, no host-to-device copy.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

constexpr int kMaxLeaves = 32;

struct AdamLeaves {
  void* p[kMaxLeaves];           // float32 or bfloat16, as bf16[] says
  const void* g[kMaxLeaves];     // the parameter's dtype
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];          // v_local
  const float* vh[kMaxLeaves];   // v_hat
  int64_t n[kMaxLeaves];
  int64_t block_start[kMaxLeaves + 1];
  bool bf16[kMaxLeaves];         // p and g are bfloat16 (else float32)
  int count;
};

struct AdamScalars {
  const int32_t* t;      // () step count after this step, on the device
  int32_t k;
  bool warmup;           // local_v_warmup: v_use = v while t <= k
  const float* lr_ptr;   // a 0-dim float32 lr, or nullptr: lr by value
  float lr;
  const float* mhat;     // bias-correction factors, or nullptr (none)
  const float* vhat;
  float b1, c1, b2, c2;  // (float)b1, (float)(1 - b1), ...
  bool has_wd;
  float lrwd;            // (float)(lr * weight_decay) for a float lr
  float wd;              // (float)weight_decay for a tensor lr
};

int64_t fused_adam_blocks(int64_t n);
void launch_fused_adam(const AdamLeaves& a, const AdamScalars& s,
                       cudaStream_t stream);
