// One thread follows a chain of dependent loads through device memory: the
// latency of one trip to HBM, which bounds a kernel made of short chains of
// dependent loads (the cache tier's hash probe: id -> bucket -> slot_uid).
//
//   nvcc -O3 -shared -Xcompiler -fPIC -gencode=arch=compute_90a,code=sm_90a \
//        -o build/pointer_chase.so tools/pointer_chase.cu
//
// chip_smoke.py builds it and calls it through ctypes (a plain C interface:
// no PyTorch headers, so it builds in seconds).
//   - pointer_chase: next[] holds a random cycle over cache lines; `steps`
//     loads each wait for the one before, and the last index is written to
//     *sink so that none is optimized away.  With steps = 0 the kernel
//     loads nothing: its time is the launch alone.
//   - random_reads: the same loads without the chain: thread i reads
//     table[idx[i]] (idx read coalesced), all at once, so their time is
//     what the card takes to fetch those words with nothing waiting on
//     anything; a word equal to `never` is written to *sink.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void chase_kernel(const int64_t* __restrict__ next, int64_t start,
                             int steps, int64_t* __restrict__ sink) {
  int64_t i = start;
  for (int s = 0; s < steps; ++s) {
    // volatile: each load goes to memory, in order
    i = *reinterpret_cast<const volatile int64_t*>(next + i);
  }
  *sink = i;
}

__global__ void random_reads_kernel(const int32_t* __restrict__ table,
                                    const int64_t* __restrict__ idx,
                                    int64_t n, int32_t never,
                                    int32_t* __restrict__ sink) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int32_t v = table[idx[i]];
  if (v == never) *sink = v;
}

}  // namespace

extern "C" int pointer_chase(const void* next, int64_t start, int steps,
                             void* sink, void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(next), start, steps,
      static_cast<int64_t*>(sink));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int random_reads(const void* table, const void* idx, int64_t n,
                            int32_t never, void* sink, void* stream) {
  if (n > 0) {
    random_reads_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(table), static_cast<const int64_t*>(idx),
        n, never, static_cast<int32_t*>(sink));
  }
  return static_cast<int>(cudaGetLastError());
}
