// bf16 packing shared by the port's CUDA kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace
