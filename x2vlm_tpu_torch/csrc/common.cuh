// Shared helpers of the port's CUDA kernels (compiled for sm_90a by
// x2vlm_tpu_torch/ops/_build.py; each kernel file is its own shared library
// with a plain C interface, loaded with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace x2 {

// Element types, as the Python wrappers pass them.
enum DType : int { kF32 = 0, kBF16 = 1 };
// Kinds of an optional operand whose type is chosen at run time.
enum OperandKind : int { kAbsent = 0, kOperandF32 = 1, kOperandBF16 = 2 };

// A masked logit: large but finite, so a row whose every key is masked
// averages its values instead of producing NaN (x2vlm_tpu/ops/attention.py).
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Read element `idx` of an f32 or bf16 operand as float.
__device__ __forceinline__ float load_operand(const void* p, int kind, long long idx) {
  return kind == kOperandF32 ? static_cast<const float*>(p)[idx]
                             : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[idx]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace x2

// Every kernel library exports this, so the Python wrapper can name an error.
extern "C" const char* x2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
