// Hopper probe (K7): y = 2 * x, float32, one thread per element.
//
// Replaces the Pallas probe kernel `kern` of stage_trivial_copy in
// scripts/pallas_probe.py:62-78 (pallas_call :73), which asks whether a
// kernel runs on the device at all. It is the first kernel chip_smoke.py
// launches. Its bound is the bytes it moves ([8,128] f32 in and out: 8 KB,
// a few nanoseconds at 3.35 TB/s); what it measures is launch overhead.

#include <cuda_runtime.h>

namespace {

__global__ void probe_double_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = 2.f * x[i];
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch on the given stream.
int vt_probe_double(const void* x, void* y, int n, void* stream) {
  const int threads = 256;
  probe_double_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
