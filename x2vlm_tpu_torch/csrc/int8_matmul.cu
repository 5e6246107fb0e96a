// Dynamic W8A8 int8 matmul for Hopper (sm_90a): the projections and FFN
// matmuls of the int8 serving path (quant_int8=True).
//
// Replaces: x2vlm_tpu/ops/int8_matmul.py `_kernel` (launched by
// `int8_matmul` through `pl.pallas_call`). Same contract, in two kernels:
//
//  - `quantize_rows_kernel`: per-token symmetric int8 quantization of x
//    (M, K), f32 or bf16: sx = max(amax, 1e-6) / 127 and xq = round(x / sx),
//    an IEEE division and round-half-to-even, as `jnp.round(xf / sx)`;
//  - `int8_gemm_kernel`: acc = xq . wq^T in int32 on the tensor cores, then
//    out = (f32(acc) * sx[row]) * sw[col] (+ f32 bias[col]), an optional
//    erf GELU or tanh GELU in f32, written in f32 or bf16. wq is (N, K)
//    int8, the nn.Linear layout, with one f32 scale per output row sw (N,).
//
// The TPU kernel quantizes a row block once, on the first N tile of its
// sequential grid, and keeps the int8 rows in VMEM scratch across the N
// sweep. CUDA blocks run in no order and share no scratch, so the
// quantization is its own kernel that writes (xq, sx) once; the GEMM reads
// them. That is also the JAX package's `quantize_act` + `QDense(x, xq, sx)`
// split, which lets q/k/v share one quantization of their input.
//
// Exactness: the dequantize multiplies and the bias add use __fmul_rn /
// __fadd_rn, so nvcc does not contract them into an FMA, and the division
// is __fdiv_rn (no --use_fast_math): xq, sx, the int32 sums and, without
// an activation, the outputs equal the plain PyTorch version's bit for bit.
//
// What bounds it on the H100: at the main path's shapes (M = 5120 to 25600
// rows, (K, N) in {(768, 768), (768, 2304), (768, 3072), (3072, 768)}) the
// product is 2MNK = 6-119 GOP against 12-177 MB moved: the two bounds are
// close (0.003-0.060 ms at 1979 TOP/s, 0.004-0.053 ms at 3.35 TB/s), the
// operations ahead at the large N and K. This first version uses mma.sync
// m16n8k32 (s8 x s8 -> s32): 128 x 128 x 64 block tiles, 8 warps of
// 64 x 32, a 3-stage cp.async ring, 32-bit fragment loads from shared rows
// padded to 80 bytes (conflict-free). wgmma and TMA are later work.
// The quantization is bound by its bytes (one read of x for the abs-max,
// one again for the division, one write of xq): one warp per row.

#include "common.cuh"

namespace {

enum Act : int { kActNone = 0, kActGelu = 1, kActGeluFast = 2 };

constexpr int kQuantThreads = 256;
constexpr int kQuantRows = kQuantThreads / 32;  // one warp per row

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                     int M, int K) {
  const int row = blockIdx.x * kQuantRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warps leave together
  const T* xr = x + static_cast<long long>(row) * K;
  float amax = 0.f;
  for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(x2::to_f(xr[k])));
  amax = x2::warp_max(amax);
  // an all-zero row gets sx = 1e-6 / 127 and xq = 0, as the reference
  const float s = __fdiv_rn(fmaxf(amax, 1e-6f), 127.0f);
  int8_t* qr = xq + static_cast<long long>(row) * K;
  for (int k = lane; k < K; k += 32)
    qr[k] = static_cast<int8_t>(__float2int_rn(__fdiv_rn(x2::to_f(xr[k]), s)));
  if (lane == 0) sx[row] = s;
}

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int kStages = 3;
constexpr int kGemmThreads = 256;  // 8 warps: 2 along M x 4 along N, 64 x 32 each
constexpr int LDS = BK + 16;       // shared row stride in bytes: fragment loads hit 32 banks
constexpr int kTileBytes = (BM + BN) * LDS;
constexpr int kGemmSmem = kStages * kTileBytes;  // 61,440 bytes

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c (16x8 s32) += a (16x32 s8, row) . b (32x8 s8, col)
__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [r0, r0 + ROWS) x bytes [k0, k0 + BK) of a row-major (rows, K)
// int8 matrix into shared memory (row stride LDS); rows past `rows` and
// bytes past K (K % 16 == 0) are filled with zeros.
template <int ROWS>
__device__ __forceinline__ void load_rows(int8_t* dst, const int8_t* __restrict__ src, int r0,
                                          int rows, int k0, int K, int tid) {
  constexpr int kChunks = BK / 16;
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kGemmThreads; ++i) {
    const int c = tid + i * kGemmThreads;
    const int r = c / kChunks, kc = (c % kChunks) * 16;
    const bool ok = r0 + r < rows && k0 + kc < K;
    const int8_t* p = ok ? src + static_cast<long long>(r0 + r) * K + k0 + kc : src;
    cp_async16(dst + r * LDS + kc, p, ok ? 16 : 0);
  }
}

__device__ __forceinline__ float apply_act(int act, float v) {
  if (act == kActGelu) return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  if (act == kActGeluFast)
    return 0.5f * v * (1.0f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  return v;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename OutT>
__global__ void __launch_bounds__(kGemmThreads, 2)
int8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                 const int8_t* __restrict__ wq, const float* __restrict__ sw,
                 const float* __restrict__ bias, OutT* __restrict__ out, int M, int N, int K,
                 int act) {
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tiles = (K + BK - 1) / BK;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) {
      int8_t* st = smem + s * kTileBytes;
      load_rows<BM>(st, xq, m0, M, s * BK, K, tid);
      load_rows<BN>(st + BM * LDS, wq, n0, N, s * BK, K, tid);
    }
    cp_async_commit();
  }

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;

  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();               // ... for every thread; stage kt-1 is free again
    const int next = kt + kStages - 1;
    if (next < tiles) {
      int8_t* st = smem + (next % kStages) * kTileBytes;
      load_rows<BM>(st, xq, m0, M, next * BK, K, tid);
      load_rows<BN>(st + BM * LDS, wq, n0, N, next * BK, K, tid);
    }
    cp_async_commit();

    const int8_t* As = smem + (kt % kStages) * kTileBytes;
    const int8_t* Bs = As + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = As + (wm + mi * 16 + g) * LDS + kk + 4 * t;
        a[mi][0] = *reinterpret_cast<const unsigned*>(p);
        a[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
        a[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
        a[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = Bs + (wn + ni * 8 + g) * LDS + kk + 4 * t;
        b[ni][0] = *reinterpret_cast<const unsigned*>(p);
        b[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
  }
  cp_async_wait<0>();

  // epilogue: thread (g, t) holds rows g and g + 8, columns 2t and 2t + 1
  // of each 16 x 8 tile
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + mi * 16 + g + 8 * h;
      if (row >= M) continue;
      const float s_row = sx[row];
      OutT* orow = out + static_cast<long long>(row) * N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + 2 * t;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = min(col + j, N - 1);
          float y = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h + j]), s_row), sw[c]);
          if (bias != nullptr) y = __fadd_rn(y, bias[c]);
          v[j] = apply_act(act, y);
        }
        if (pairs && col + 1 < N) {
          store2(orow + col, v[0], v[1]);
        } else {
          if (col < N) orow[col] = x2::from_f<OutT>(v[0]);
          if (col + 1 < N) orow[col + 1] = x2::from_f<OutT>(v[1]);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_quantize(const void* x, void* xq, void* sx, int M, int K, cudaStream_t st) {
  const int blocks = (M + kQuantRows - 1) / kQuantRows;
  quantize_rows_kernel<T><<<blocks, kQuantThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx), M, K);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_gemm(const void* xq, const void* sx, const void* wq, const void* sw,
                        const void* bias, void* out, int M, int N, int K, int act,
                        cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(int8_gemm_kernel<OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<OutT><<<grid, kGemmThreads, kGemmSmem, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const int8_t*>(wq), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<OutT*>(out), M, N, K, act);
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) contiguous, dtype `dtype` (x2::DType). xq: (M, K) int8; sx: (M,)
// f32. Returns cudaGetLastError() after the launch.
extern "C" int x2_int8_quantize(const void* x, void* xq, void* sx, int M, int K, int dtype,
                                void* stream) {
  if (M <= 0 || K <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == x2::kF32) return static_cast<int>(launch_quantize<float>(x, xq, sx, M, K, st));
  if (dtype == x2::kBF16)
    return static_cast<int>(launch_quantize<__nv_bfloat16>(x, xq, sx, M, K, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// xq: (M, K) int8, sx: (M,) f32, wq: (N, K) int8, sw: (N,) f32, bias: null
// or (N,) f32, out: (M, N) of `out_dtype` (x2::DType); all contiguous, xq
// and wq 16-byte aligned, K % 16 == 0. act: 0 none, 1 erf GELU, 2 tanh
// GELU. Returns cudaGetLastError() after the launch.
extern "C" int x2_int8_matmul(const void* xq, const void* sx, const void* wq, const void* sw,
                              const void* bias, void* out, int M, int N, int K, int act,
                              int out_dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0) return cudaErrorInvalidValue;
  if (act != kActNone && act != kActGelu && act != kActGeluFast) return cudaErrorInvalidValue;
  if ((M + BM - 1) / BM > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == x2::kF32)
    return static_cast<int>(launch_gemm<float>(xq, sx, wq, sw, bias, out, M, N, K, act, st));
  if (out_dtype == x2::kBF16)
    return static_cast<int>(
        launch_gemm<__nv_bfloat16>(xq, sx, wq, sw, bias, out, M, N, K, act, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
