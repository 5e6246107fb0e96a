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

// ---- the tiny attention kernels' two routes (ops/tiny_attention.py `tiny_route`) ----
// bf16 with a head dim that is a multiple of 16, up to 128, runs on the
// tensor cores; fp32 (any D) and bf16 at other head dims on the CUDA cores.
enum TinyRoute : int { kRouteCudaCore = 0, kRouteTensorCore = 1 };

inline int tiny_route(int dtype, int D) {
  return dtype == kBF16 && D > 0 && D % 16 == 0 && D <= 128 ? kRouteTensorCore
                                                           : kRouteCudaCore;
}

// ---- the flash backward's dQ and dK/dV routes (ops/flash_attention.py
// `flash_bwd_route`) ----
// bf16 at head dim 64 (the main path) runs on the tensor cores; fp32 (any
// D) and bf16 at the other head dims on the CUDA cores. dBias has one route.
inline int flash_bwd_route(int dtype, int D) {
  return dtype == kBF16 && D == 64 ? kRouteTensorCore : kRouteCudaCore;
}

__host__ __device__ constexpr int round_up16(int x) { return (x + 15) & ~15; }

// Row stride (elements) of a TileLayout<D> tile (below), for the host.
inline size_t tile_ld(int D) { return D % 64 == 0 ? D : D + 8; }

// ---- tensor-core building blocks (mma.sync, ldmatrix, cp.async) ----

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}

// 4 bytes from global to shared memory, asynchronously; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait_group<0>(); }

// Four 8x8 b16 matrices from shared memory: lane l gives the address of row
// l % 8 of matrix l / 8; r[i] is matrix i in the mma fragment layout (lane
// holds row lane / 4, columns 2 (lane % 4) and +1; with .trans the matrix
// is transposed first).
__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats rounded to bf16 (round to nearest even), `lo` in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Elements idx and idx + 1 of an f32 or bf16 operand as floats, 0 where
// !ok0 / !ok1; one 8- or 4-byte load when both are wanted and `vec` says
// idx is even (the operand itself 8-byte aligned).
__device__ __forceinline__ float2 load_pair(const void* p, int kind, long long idx, bool ok0,
                                            bool ok1, bool vec) {
  if (kind == kOperandF32) {
    const float* f = static_cast<const float*>(p) + idx;
    if (vec && ok1) return *reinterpret_cast<const float2*>(f);
    return make_float2(ok0 ? f[0] : 0.f, ok1 ? f[1] : 0.f);
  }
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p) + idx;
  if (vec && ok1) return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
  return make_float2(ok0 ? __bfloat162float(x[0]) : 0.f, ok1 ? __bfloat162float(x[1]) : 0.f);
}

// The same for a bf16 operand, kept packed in one register (the low half
// is element idx).
__device__ __forceinline__ unsigned load_bf16_pair(const __nv_bfloat16* p, long long idx,
                                                   bool ok0, bool ok1, bool vec) {
  if (vec && ok1) return *reinterpret_cast<const unsigned*>(p + idx);
  const unsigned lo = ok0 ? __bfloat16_as_ushort(p[idx]) : 0u;
  const unsigned hi = ok1 ? __bfloat16_as_ushort(p[idx + 1]) : 0u;
  return lo | (hi << 16);
}

__device__ __forceinline__ float2 unpack_bf16(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// Shared-memory layout of a bf16 tile with D columns that ldmatrix reads
// eight rows at a time: when D % 64 == 0, rows of D elements whose 16-byte
// chunks are XOR-swizzled by (row % 8); otherwise rows padded to D + 8
// elements ((D + 8) / 8 is odd for D % 16 == 0). Either way the eight rows
// of one ldmatrix start in eight different 16-byte bank groups.
template <int D>
struct TileLayout {
  static constexpr bool kSwizzle = D % 64 == 0;
  static constexpr int kLD = kSwizzle ? D : D + 8;  // row stride (elements)
  // element offset of (row, col), col a multiple of 8
  __device__ static __forceinline__ int off(int row, int col) {
    return row * kLD + (kSwizzle ? (((col >> 3) ^ (row & 7)) << 3) : col);
  }
};

// Stage rows [0, rows_pad) of a (rows, D) bf16 slice whose rows lie `stride`
// elements apart into a TileLayout<D> tile (16-byte cp.async; the source
// 16-byte aligned); rows past `rows` are zeros.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int rows, int rows_pad, long long stride, int tid,
                                           int nthreads) {
  constexpr int kChunks = D / 8;
  for (int i = tid; i < rows_pad * kChunks; i += nthreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r < rows;
    cp_async16(dst + TileLayout<D>::off(r, c), src + (ok ? r * stride : 0) + c, ok ? 16 : 0);
  }
}

}  // namespace x2

// Every kernel library exports this, so the Python wrapper can name an error.
extern "C" const char* x2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
