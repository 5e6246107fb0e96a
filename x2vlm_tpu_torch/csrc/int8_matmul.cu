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
// operations ahead at the large N and K. The design follows the card:
//
//  - the GEMM is warp-specialised. One producer thread keeps TMA loads of
//    128-byte K slices of xq (BM rows) and wq (BN rows) in flight into a
//    ring of kStages stages (128-byte swizzle, mbarrier completion; TMA's
//    out-of-bounds zero fill covers the M, N and K edges). Two consumer
//    warpgroups take the block's 128 x 128 tiles in turns (ping-pong):
//    each multiplies a whole tile with `wgmma.mma_async m64n128k32
//    s32.s8.s8` straight from shared memory (two per 32 bytes of K, 8 per
//    stage), releasing a stage when its wgmma group is done, and runs the
//    tile's epilogue while the other consumer's wgmmas run. The grid is
//    persistent: one block an SM walks the tiles, so the producer loads
//    the next tile during an epilogue. `setmaxnreg` moves registers from
//    the producer to the consumers. The epilogue dequantizes in registers
//    (the activation a template argument, so the unrolled elements carry
//    no test; the tanh GELU's tanh from exp2f), stages 128-byte row pieces
//    of the output in shared memory
//    and writes them with 16-byte stores (element stores where a row is
//    not a multiple of 16 bytes, e.g. N = 77);
//  - the quantization is bound by its bytes. One warp a row at a time:
//    each lane loads its part of the row once, as 16-byte vectors kept in
//    registers (3 a lane for bf16 K = 768, 12 for K = 3072), takes the
//    abs-max with shuffles, and writes 8 (bf16) or 4 (f32) int8 values per
//    store. All of a lane's loads are issued before any arithmetic. Rows
//    longer than the registers hold (bf16 K > 4096, f32 K > 2048) read
//    their tail twice.
//
// The tensor maps are built on the host for each call (xq's address
// changes from call to call) through cuTensorMapEncodeTiled, looked up at
// run time in libcuda (cudaGetDriverEntryPointByVersion), so no library
// beyond the CUDA runtime is linked; each is passed by value as a
// __grid_constant__.

#include "common.cuh"

#include <cuda.h>  // CUtensorMap and the types of cuTensorMapEncodeTiled

namespace {

enum Act : int { kActNone = 0, kActGelu = 1, kActGeluFast = 2 };

// ---------------------------------------------------------------- quantize

constexpr int kQuantThreads = 256;
constexpr int kQuantRows = kQuantThreads / 32;  // one warp per row
// 16-byte vectors of a row that one lane may keep in registers; a
// launch takes the fewest of these counts that hold the row
constexpr int kQuantVectors[] = {1, 2, 3, 4, 6, 8, 12, 16};

template <typename T>
constexpr int kPerVec = 16 / static_cast<int>(sizeof(T));  // elements in 16 bytes

__device__ __forceinline__ unsigned word_of(const uint4& r, int j) {
  return j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w;
}

// element e of a 16-byte vector of T, as float (e is known at compile time)
template <typename T>
__device__ __forceinline__ float elem(const uint4& r, int e);
template <>
__device__ __forceinline__ float elem<float>(const uint4& r, int e) {
  return __uint_as_float(word_of(r, e));
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& r, int e) {
  const unsigned w = word_of(r, e >> 1);
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

__device__ __forceinline__ unsigned bits_of(float x) { return __float_as_uint(x); }
__device__ __forceinline__ unsigned bits_of(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }

__device__ __forceinline__ int quant(float x, float s) {
  return __float2int_rn(__fdiv_rn(x, s));
}

// Lane `lane`'s part of a row of K elements of T: elements (32 i + lane) E
// .. + E - 1 of vector i, zeros past K. `vec`: K is a multiple of
// kPerVec<T> and x is 16-byte aligned, so every vector is read whole.
template <typename T, int V>
__device__ __forceinline__ void load_row(uint4 (&raw)[V], const T* __restrict__ xr, int K,
                                         int lane, bool vec) {
  constexpr int E = kPerVec<T>;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k0 = (32 * i + lane) * E;
    if (vec && k0 + E <= K) {
      raw[i] = __ldg(reinterpret_cast<const uint4*>(xr + k0));
    } else {
      unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (k0 + e < K)
          w[(e * sizeof(T)) >> 2] |= bits_of(xr[k0 + e]) << (((e * sizeof(T)) & 3) * 8);
      raw[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// One warp a row. `vec`: as load_row's, and xq kPerVec<T>-byte aligned,
// so every vector's int8 values are stored whole.
template <typename T, int V>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                     int M, int K, bool vec) {
  constexpr int E = kPerVec<T>;
  const int row = blockIdx.x * kQuantRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warps leave together
  const T* xr = x + static_cast<long long>(row) * K;
  int8_t* qr = xq + static_cast<long long>(row) * K;
  uint4 raw[V];  // the row, read once
  load_row<T, V>(raw, xr, K, lane, vec);

  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(elem<T>(raw[i], e)));
  for (int k = 32 * V * E + lane; k < K; k += 32) amax = fmaxf(amax, fabsf(x2::to_f(xr[k])));
  amax = x2::warp_max(amax);
  // an all-zero row gets sx = 1e-6 / 127 and xq = 0, as the reference
  const float s = __fdiv_rn(fmaxf(amax, 1e-6f), 127.0f);

#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k0 = (32 * i + lane) * E;
    if (k0 >= K) break;
    unsigned packed[E / 4];
#pragma unroll
    for (int j = 0; j < E / 4; ++j) packed[j] = 0u;
#pragma unroll
    for (int e = 0; e < E; ++e)
      packed[e >> 2] |= (static_cast<unsigned>(quant(elem<T>(raw[i], e), s)) & 0xffu)
                        << ((e & 3) * 8);
    if (vec && k0 + E <= K) {
      if constexpr (E == 8)
        *reinterpret_cast<uint2*>(qr + k0) = make_uint2(packed[0], packed[1]);
      else
        *reinterpret_cast<unsigned*>(qr + k0) = packed[0];
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (k0 + e < K) qr[k0 + e] = static_cast<int8_t>(packed[e >> 2] >> ((e & 3) * 8));
    }
  }
  for (int k = 32 * V * E + lane; k < K; k += 32)
    qr[k] = static_cast<int8_t>(quant(x2::to_f(xr[k]), s));
  if (lane == 0) sx[row] = s;
}

// ---------------------------------------------------------------- GEMM

constexpr int BM = 128;          // rows of a tile: two m64 wgmmas a consumer
constexpr int BN = 128;          // columns of a tile (the wgmma n)
constexpr int BK = 128;          // K bytes of a stage: one 128-byte swizzle row
constexpr int kStages = 5;       // ring of (BM + BN) x BK stages
constexpr int kEpiBytes = 128;   // bytes of an output row staged at a time
constexpr int kEpiLd = kEpiBytes + 16;  // their row stride in shared memory
constexpr int kGemmThreads = 384;       // producer warpgroup + two consumer warpgroups
constexpr int kStageBytes = (BM + BN) * BK;
constexpr int kHalves = BM / 64;              // m64 wgmmas per 32 bytes of K
constexpr int kParamFloats = BM + 2 * BN;     // a tile's sx, sw and bias
// 1024 bytes of slack to align the ring for the 128-byte swizzle, the
// ring, each consumer's output staging and scales, a full and an empty
// mbarrier per stage and the consumers' two turn mbarriers
// (ops/int8_matmul.py `gemm_smem_bytes` mirrors it)
constexpr int kGemmSmem = 1024 + kStages * kStageBytes + 2 * BM * kEpiLd +
                          2 * kParamFloats * 4 + (2 * kStages + 2) * 8;
static_assert(BN == 128, "the wgmma shape of wgmma_m64n128k32");
static_assert(kGemmSmem <= 232448, "shared memory of one block");

// ---- mbarrier, TMA and wgmma ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(x2::smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   x2::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(x2::smem_u32(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed. A wait
// that never ends (a TMA transaction lost) traps after ~2^26 polls, far
// longer than any kernel of this path runs, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  unsigned polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(x2::smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A box of a 2-D int8 tensor map, from coordinates (k, row), into shared
// memory; completes on `bar` with the box's bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int k,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(x2::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x2::smem_u32(bar)), "r"(k), "r"(row)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows written by TMA with
// the 128-byte swizzle: 8-row groups 1024 bytes apart (the stride field),
// the leading field unused for this layout; `p` 1024-byte aligned plus a
// multiple of 32 bytes along K.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((x2::smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// an asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128 s32, the wgmma accumulator layout) += A (64 x 32 s8, K-major,
// descriptor da) . B (128 x 32 s8, K-major, descriptor db)^T; accumulate = 0
// overwrites d.
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// tanh(u) = 1 - 2 / (exp(2u) + 1) from exp2f and a fast division: within a
// few ulp of 1 of tanhf, so the tanh GELU's outputs stay within the plain
// version's bounds (chip_smoke.py `rule_int8`), at fewer instructions than
// tanhf on the epilogue's critical path (tools/int8_variants.py `tanhf`).
__device__ __forceinline__ float tanh_exp(float u) {
  return 1.0f - __fdividef(2.0f, exp2f(2.8853900817779268f * u) + 1.0f);
}

// The activation is a template argument: an epilogue with no test in it
// lets the compiler interleave the unrolled elements' arithmetic.
template <int kAct>
__device__ __forceinline__ float apply_act(float v) {
  if constexpr (kAct == kActGelu) return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  if constexpr (kAct == kActGeluFast)
    return 0.5f * v * (1.0f + tanh_exp(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  return v;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// `vec_out`: rows of `out` are a multiple of 16 bytes and `out` is 16-byte
// aligned, so staged 16-byte pieces are stored whole.
template <typename OutT, int kAct>
__global__ void __launch_bounds__(kGemmThreads, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 const float* __restrict__ bias, OutT* __restrict__ out, int M, int N, int K,
                 bool vec_out) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzled ring must start on a 1024-byte boundary of shared memory
  uint8_t* smem = smem_raw + ((1024 - (x2::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sA = smem;                              // kStages x BM x BK
  uint8_t* sB = sA + kStages * BM * BK;            // kStages x BN x BK
  uint8_t* sOut = sB + kStages * BN * BK;          // 2 x BM x kEpiLd
  float* sParams = reinterpret_cast<float*>(sOut + 2 * BM * kEpiLd);  // 2 x kParamFloats
  uint64_t* full = reinterpret_cast<uint64_t*>(sParams + 2 * kParamFloats);
  uint64_t* empty = full + kStages;
  // turn[c]: consumer c may start its next tile's mainloop
  uint64_t* turn = empty + kStages;

  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * tiles_n;
  const int ktiles = (K + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);  // the producer's arrive, plus the stage's TMA bytes
      mbar_init(&empty[s], 4);  // one arrive per warp of the consumer that reads the stage
    }
    mbar_init(&turn[0], 4);  // one arrive per warp of the other consumer
    mbar_init(&turn[1], 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load, tile after tile ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_x))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_w))
                   : "memory");
      int stage = 0;
      unsigned phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);  // the first pass finds every stage free
          mbar_expect_tx(&full[stage], kStageBytes);
          tma_load(sA + stage * BM * BK, &map_x, &full[stage], kt * BK, m0);
          tma_load(sB + stage * BN * BK, &map_w, &full[stage], kt * BK, n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw multiplies the block's tiles j = cw,
    // cw + 2, ... The two take turns at the mainloop (ping-pong): a
    // consumer starts a tile's mainloop once the other has passed every
    // stage of the tile before, so the ring's phases it waits on are never
    // more than one ahead (a parity wait cannot tell two phases apart), and
    // its epilogue runs during the other's mainloop ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, q = lane & 3;  // accumulator coordinates, as mma.sync's C
    uint8_t* stage_out = sOut + cw * BM * kEpiLd;
    float* p_sx = sParams + cw * kParamFloats;  // BM row scales, then BN of sw, BN of bias
    float* p_sw = p_sx + BM;
    float* p_bias = p_sw + BN;
    constexpr int kCols = kEpiBytes / static_cast<int>(sizeof(OutT));  // columns staged at once
    constexpr int kChunks = kEpiBytes / 16;                            // 16-byte pieces of a row
    constexpr int kPerChunk = 16 / static_cast<int>(sizeof(OutT));
    int acc[kHalves][BN / 2];
    int n = 0;  // tiles this consumer has taken
    for (int j = cw, tile = blockIdx.x + j * gridDim.x; tile < tiles;
         j += 2, tile = blockIdx.x + j * gridDim.x) {
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
      // the tile's scales and bias, for the epilogue (the last one is done with them)
      for (int i = t; i < BM; i += 128) {
        const int row = m0 + i;
        p_sx[i] = row < M ? sx[row] : 0.f;
      }
      for (int i = t; i < BN; i += 128) {
        const int col = n0 + i;
        p_sw[i] = col < N ? sw[col] : 0.f;
        p_bias[i] = col < N && bias != nullptr ? bias[col] : 0.f;
      }
      // the ring position of the tile's first stage: the producer fills
      // ktiles stages for each of the block's tiles, in order
      const long long pos = static_cast<long long>(j) * ktiles;
      int stage = static_cast<int>(pos % kStages);
      unsigned phase = static_cast<unsigned>((pos / kStages) & 1);
      if (cw == 1 || n > 0) mbar_wait(&turn[cw], (cw == 1 ? n : n - 1) & 1);
      int prev = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&full[stage], phase);
        __syncwarp();
        wgmma_fence();
        const uint64_t db = sw128_desc(sB + stage * BN * BK);
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {  // 32 bytes of K each: +2 in 16-byte units
#pragma unroll
          for (int hh = 0; hh < kHalves; ++hh) {
            const uint64_t da = sw128_desc(sA + stage * BM * BK + 64 * hh * BK);
            wgmma_m64n128k32(acc[hh], da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (kt > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (lane == 0) mbar_arrive(&turn[cw ^ 1]);  // every stage passed
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
      for (int hh = 0; hh < kHalves; ++hh) fence_regs(acc[hh]);
      bar_sync(1 + cw, 128);  // the scales are in shared memory

      // ---- epilogue: in half hh, thread (g, q) of warp w holds rows
      // 64 hh + 16 w + g and + 8, columns 8 i + 2 q and + 1 (acc[hh][4 i ..]) ----
#pragma unroll
      for (int c = 0; c < BN / kCols; ++c) {
#pragma unroll
        for (int hh = 0; hh < kHalves; ++hh) {
#pragma unroll
          for (int i = 0; i < kCols / 8; ++i) {
            const int fi = c * (kCols / 8) + i;
            const int lc = 8 * i + 2 * q;
            const float2 w = *reinterpret_cast<const float2*>(p_sw + c * kCols + lc);
            const float2 b = *reinterpret_cast<const float2*>(p_bias + c * kCols + lc);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 64 * hh + 16 * warp + g + 8 * h;
              const float s_row = p_sx[r];
              float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[hh][4 * fi + 2 * h]), s_row), w.x);
              float y1 =
                  __fmul_rn(__fmul_rn(__int2float_rn(acc[hh][4 * fi + 2 * h + 1]), s_row), w.y);
              if (bias != nullptr) {
                y0 = __fadd_rn(y0, b.x);
                y1 = __fadd_rn(y1, b.y);
              }
              store2(reinterpret_cast<OutT*>(stage_out + r * kEpiLd) + lc, apply_act<kAct>(y0),
                     apply_act<kAct>(y1));
            }
          }
        }
        bar_sync(1 + cw, 128);  // the warpgroup's staged piece is complete
#pragma unroll
        for (int p = 0; p < BM * kChunks / 128; ++p) {
          const int idx = p * 128 + t;
          const int r = idx / kChunks, ch = idx % kChunks;
          const int grow = m0 + r;
          const int gcol = n0 + c * kCols + ch * kPerChunk;
          if (grow < M && gcol < N) {
            const uint8_t* src = stage_out + r * kEpiLd + ch * 16;
            OutT* dst = out + static_cast<long long>(grow) * N + gcol;
            if (vec_out) {
              *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
            } else {
#pragma unroll
              for (int e = 0; e < kPerChunk; ++e)
                if (gcol + e < N) dst[e] = reinterpret_cast<const OutT*>(src)[e];
            }
          }
        }
        bar_sync(1 + cw, 128);  // ... and stored: the staging may be written again
      }
      ++n;
    }
  }
}

// ---------------------------------------------------------------- host side

template <typename T, int V>
cudaError_t launch_quantize_v(const void* x, void* xq, void* sx, int M, int K, bool vec,
                              cudaStream_t st) {
  const int blocks = (M + kQuantRows - 1) / kQuantRows;
  quantize_rows_kernel<T, V><<<blocks, kQuantThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx), M, K, vec);
  return cudaGetLastError();
}

// The fewest 16-byte vectors a lane keeps that hold its part of a row of K
// elements of T (past the largest count, the row's tail is read twice).
template <typename T>
int quant_vectors(int K) {
  const int need = (K + 32 * kPerVec<T> - 1) / (32 * kPerVec<T>);
  for (int v : kQuantVectors)
    if (v >= need) return v;
  return kQuantVectors[sizeof(kQuantVectors) / sizeof(int) - 1];
}

template <typename T>
cudaError_t launch_quantize(const void* x, void* xq, void* sx, int M, int K, cudaStream_t st) {
  constexpr int E = kPerVec<T>;
  const bool vec = K % E == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xq) % E == 0;
  switch (quant_vectors<T>(K)) {
    case 1: return launch_quantize_v<T, 1>(x, xq, sx, M, K, vec, st);
    case 2: return launch_quantize_v<T, 2>(x, xq, sx, M, K, vec, st);
    case 3: return launch_quantize_v<T, 3>(x, xq, sx, M, K, vec, st);
    case 4: return launch_quantize_v<T, 4>(x, xq, sx, M, K, vec, st);
    case 6: return launch_quantize_v<T, 6>(x, xq, sx, M, K, vec, st);
    case 8: return launch_quantize_v<T, 8>(x, xq, sx, M, K, vec, st);
    case 12: return launch_quantize_v<T, 12>(x, xq, sx, M, K, vec, st);
    default: return launch_quantize_v<T, 16>(x, xq, sx, M, K, vec, st);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime has loaded (null if
// it has none).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major (rows, K) int8 matrix read in boxes of
// box_rows x BK bytes with the 128-byte swizzle; out-of-bounds bytes read
// as zeros.
cudaError_t make_map(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

template <typename OutT, int kAct>
cudaError_t launch_gemm(const void* xq, const void* sx, const void* wq, const void* sw,
                        const void* bias, void* out, int M, int N, int K, cudaStream_t st) {
  CUtensorMap map_x, map_w;
  cudaError_t err = make_map(&map_x, xq, M, K, BM);
  if (err == cudaSuccess) err = make_map(&map_w, wq, N, K, BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(int8_gemm_kernel<OutT, kAct>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  // persistent: one block an SM (or a tile, if fewer) walks the tiles
  const int sms = sm_count();
  const int grid = sms > 0 && tiles > sms ? sms : static_cast<int>(tiles);
  const bool vec_out = (static_cast<long long>(N) * sizeof(OutT)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  int8_gemm_kernel<OutT, kAct><<<grid, kGemmThreads, kGemmSmem, st>>>(
      map_x, map_w, static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<OutT*>(out), M, N, K, vec_out);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_gemm(const void* xq, const void* sx, const void* wq, const void* sw,
                        const void* bias, void* out, int M, int N, int K, int act,
                        cudaStream_t st) {
  if (act == kActGelu)
    return launch_gemm<OutT, kActGelu>(xq, sx, wq, sw, bias, out, M, N, K, st);
  if (act == kActGeluFast)
    return launch_gemm<OutT, kActGeluFast>(xq, sx, wq, sw, bias, out, M, N, K, st);
  return launch_gemm<OutT, kActNone>(xq, sx, wq, sw, bias, out, M, N, K, st);
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
// and wq 16-byte aligned (TMA), K % 16 == 0. act: 0 none, 1 erf GELU, 2
// tanh GELU. Returns cudaGetLastError() after the launch.
extern "C" int x2_int8_matmul(const void* xq, const void* sx, const void* wq, const void* sw,
                              const void* bias, void* out, int M, int N, int K, int act,
                              int out_dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(xq) % 16 != 0 || reinterpret_cast<uintptr_t>(wq) % 16 != 0)
    return cudaErrorInvalidValue;
  if (act != kActNone && act != kActGelu && act != kActGeluFast) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == x2::kF32)
    return static_cast<int>(launch_gemm<float>(xq, sx, wq, sw, bias, out, M, N, K, act, st));
  if (out_dtype == x2::kBF16)
    return static_cast<int>(
        launch_gemm<__nv_bfloat16>(xq, sx, wq, sw, bias, out, M, N, K, act, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The GEMM's dynamic shared memory a block (ops/int8_matmul.py
// `gemm_smem_bytes`).
extern "C" long long x2_int8_matmul_smem_bytes(void) { return kGemmSmem; }

// The GEMM's plan, one field at a time (ops/int8_matmul.py `GEMM_PLAN`):
// 0 tile rows, 1 tile columns, 2 K bytes a stage, 3 stages, 4 bytes of an
// output row staged at a time; -1 for another field.
extern "C" int x2_int8_matmul_plan(int field) {
  switch (field) {
    case 0: return BM;
    case 1: return BN;
    case 2: return BK;
    case 3: return kStages;
    case 4: return kEpiBytes;
    default: return -1;
  }
}
