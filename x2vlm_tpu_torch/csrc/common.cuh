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

// ---- the tiny kernels' two walks over the keys (ops/tiny_attention.py `tiny_walk`) ----
// Resident: a block holds its head's whole K and V (and, in the backward,
// the whole (Sq, Skv) probability block) in shared memory. Taken wherever
// the CUDA-core resident kernels of both directions fit, which bounds the
// tensor-core ones: up to 257 keys at Sq = 40, D = 64. Tiled: beyond that
// (the fusion cross-attention at 384 px, 40 x 584) the block walks the keys
// in tiles and its shared memory does not grow with Skv; it takes Sq <= 64
// (one 16-row query tile a warp) and D <= 128.
enum TinyWalk : int { kWalkResident = 0, kWalkTiled = 1 };
constexpr size_t kSmemLimit = 232448;  // bytes of shared memory one block may use
constexpr int kTinyTiledMaxSq = 64;
constexpr int kTinyTiledMaxD = 128;

// Shared memory of the CUDA-core resident kernels (tiny_attention_fwd.cu:
// 8 warps; tiny_attention_bwd.cu: 16 warps carrying 4 rows each).
inline size_t tiny_fwd_resident_cc_smem(int Skv, int D) {
  return sizeof(float) * (static_cast<size_t>(Skv) * (D + 1) + static_cast<size_t>(Skv) * D +
                          8 * static_cast<size_t>(Skv) + 8 * static_cast<size_t>(D));
}
inline size_t tiny_bwd_resident_cc_smem(int Sq, int Skv, int D) {
  const size_t kv = static_cast<size_t>(Skv) * 2 * (D + 1);
  const size_t gq = static_cast<size_t>(Sq) * 2 * D;
  return sizeof(float) * ((kv > gq ? kv : gq) + 2 * static_cast<size_t>(Sq) * Skv +
                          16 * 4 * static_cast<size_t>(D));
}

inline int tiny_walk(int Sq, int Skv, int D) {
  return D <= 256 && tiny_fwd_resident_cc_smem(Skv, D) <= kSmemLimit &&
                 tiny_bwd_resident_cc_smem(Sq, Skv, D) <= kSmemLimit
             ? kWalkResident
             : kWalkTiled;
}

// ---- the flash kernels' routes (ops/flash_attention.py `flash_route`) ----
// One rule for the forward, dQ, dK/dV and dBias: bf16 at head dim 64 (the
// main path) runs on the tensor cores; fp32 (any D) and bf16 at the other
// head dims on the CUDA cores.
inline int flash_route(int dtype, int D) {
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

// A (rows x 64 keys) block of a row-major operand of kElemBytes-byte
// elements, rows `stride` elements apart, each Skv keys long, whatever its
// alignment (the tiny kernels' key-tiled walks: the key mask, the dropout
// multiplier and the probabilities, at any Skv): row r (element base + r *
// stride) is copied by 16-byte cp.async from the 16-byte chunk that holds
// its key c0, into a row of kLW words, so its key c0 + j is element j +
// shift of that row (shift = (base + r * stride + c0) mod kPerChunk). Rows
// in [nrows, rows_pad) and bytes past a row's key Skv - 1 are zeros, and no
// copy reads past that key. The operand itself is 16-byte aligned.
template <int kElemBytes>
struct KeyRows {
  static constexpr int kPerChunk = 16 / kElemBytes;  // elements in 16 bytes
  static constexpr int kChunks = 64 / kPerChunk + 1;
  static constexpr int kLW = 4 * kChunks;  // row stride (words)

  __device__ static int shift(long long e0) { return static_cast<int>(e0 & (kPerChunk - 1)); }
  __device__ static void stage(unsigned* dst, const void* src, long long base, long long stride,
                               int nrows, int rows_pad, int c0, int Skv, int tid,
                               int nthreads) {
    const char* s = static_cast<const char*>(src);
    for (int i = tid; i < rows_pad * kChunks; i += nthreads) {
      const int r = i / kChunks, c = i - r * kChunks;
      const long long e0 = base + r * stride + c0;
      const int sh = shift(e0);
      const int left = Skv - (c0 - sh + kPerChunk * c);  // keys of the row from the chunk on
      const bool ok = r < nrows && left > 0;
      cp_async16(dst + r * kLW + 4 * c, ok ? s + 16 * ((e0 - sh) / kPerChunk + c) : s,
                 ok ? min(16, left * kElemBytes) : 0);
    }
  }
};

// Keys j and j + 1 (j even) of a staged KeyRows row `row` whose shift is
// `sh`, as floats: fp32 (kElemBytes 4) or bf16 (2).
__device__ __forceinline__ float2 key_pair_f32(const unsigned* row, int j, int sh) {
  const float* f = reinterpret_cast<const float*>(row) + j + sh;
  return (sh & 1) == 0 ? *reinterpret_cast<const float2*>(f) : make_float2(f[0], f[1]);
}
__device__ __forceinline__ float2 key_pair_bf16(const unsigned* row, int j, int sh) {
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(row) + j + sh;
  return (sh & 1) == 0 ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x))
                       : make_float2(__bfloat162float(x[0]), __bfloat162float(x[1]));
}

// ---- the flash kernels' tensor-core route (bf16, D = 64) ----

constexpr int kTcThreads = 128;  // 4 warps, 16 rows of a 64-row tile each
constexpr int kTcTile = 64;      // rows of a block's own tile and of a walked tile
constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one MUFU instruction; a result below 2^-126 flushes to 0. exp2f
// adds the steps that keep such results: on an H100 at the main shape with
// a bf16 bias, dQ took 0.065 ms with it against 0.053 with this, dK/dV
// 0.076 against 0.071 (tools/flash_bwd_variants.py, exp2f).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A 64 x 64 (query rows x keys) tile of the bias in shared memory, copied
// by 16-byte cp.async from a 16-byte aligned bias: a bias row need not start
// on a 16-byte boundary (the main path's bf16 rows are 197 elements), so
// each row is copied from the aligned chunk that holds its first key, and
// `shift` (0 .. 7 for bf16, 0 .. 3 for fp32) says where that key lies in
// the row. A row is 9 chunks (bf16) or 17 (fp32), 36 or 68 words: the
// kernels' reads meet at most 2-way bank conflicts.
template <int kBias>
struct BiasTile {
  static constexpr bool kBF16 = kBias == kOperandBF16;
  static constexpr int kPerChunk = kBF16 ? 8 : 4;  // elements in 16 bytes
  static constexpr int kChunks = kBias == 0 ? 0 : kTcTile / kPerChunk + 1;
  static constexpr int kLW = 4 * kChunks;  // row stride (words)
  static constexpr int kStageWords = kTcTile * kLW;

  // the shift of the row whose key c0 is element e0
  __device__ static int shift_of(long long e0) {
    return static_cast<int>(e0 & (kPerChunk - 1));
  }
  // rows [0, nrows) of the tile are bias rows row0 + r (element base +
  // (row0 + r) sq of `bias`), keys c0 .. c0 + 63 of Skv; rows past nrows and
  // chunks with no key below Skv are zeros. A chunk that runs past the
  // row's key Skv - 1 copies only up to it (zeros after), so no copy reads
  // past the bias.
  __device__ static void stage(unsigned* dst, const void* bias, long long sq, int Skv,
                               long long base, int row0, int nrows, int c0, int tid) {
    if constexpr (kBias != 0) {
      const char* src = static_cast<const char*>(bias);
      for (int i = tid; i < kTcTile * kChunks; i += kTcThreads) {
        const int r = i / kChunks, c = i - r * kChunks;
        const long long e0 = base + static_cast<long long>(row0 + r) * sq + c0;
        const int sh = shift_of(e0);
        const int left = Skv - (c0 - sh + kPerChunk * c);  // keys of the row from the chunk on
        const bool ok = r < nrows && left > 0;
        cp_async16(dst + r * kLW + 4 * c, ok ? src + 16 * ((e0 - sh) / kPerChunk + c) : src,
                   ok ? min(16, left * (16 / kPerChunk)) : 0);
      }
    }
  }
  // the bias at row r, key c0 + j of a staged tile whose row r has `shift`
  __device__ static float at(const unsigned* tile, int r, int j, int shift) {
    if constexpr (kBF16)
      return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(tile + r * kLW)[j + shift]);
    else
      return reinterpret_cast<const float*>(tile + r * kLW)[j + shift];
  }
};

// Words of one staged bias tile of `bias_kind`, for the host.
inline size_t bias_tile_words(int bias_kind) {
  return bias_kind == kOperandBF16 ? BiasTile<kOperandBF16>::kStageWords
         : bias_kind == kOperandF32 ? BiasTile<kOperandF32>::kStageWords
                                    : 0;
}

// Fragment coordinates (as in tiny_attention_fwd.cu): lane = 4 g + t holds
// rows g and g + 8 of a 16-row tile. For a 16 x 16 product tile kept as two
// 16 x 8 C tiles in c[8], c[4T + 2R + e] is row g + 8R, column 8T + 2t + e,
// and the A fragment of that tile is a[i] = (c[2i], c[2i + 1]) packed.
__device__ __forceinline__ void pack_a(unsigned (&a)[4], const float (&c)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = pack_bf16(c[2 * i], c[2 * i + 1]);
}

// c[8] (zeroed first) = A (16 rows, KS 16-column fragments) . B^T, B the 16
// rows of `Bs` from row n0 (B fragments by ldmatrix: B's rows are the n
// dimension).
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[8], const unsigned (&a)[D / 16][4],
                                        const __nv_bfloat16* Bs, int n0, int lane) {
  using L = TileLayout<D>;
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = 0.f;
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
    unsigned b[4];
    ldmatrix_x4(b, Bs + L::off(n0 + (lane & 7) + ((lane >> 4) << 3), 16 * s + (lane & 8)));
    mma_bf16(c, a[s], b);
    mma_bf16(c + 4, a[s], b + 2);
  }
}

// acc (16 x D) += A (16 x 16, one A fragment) . B, B the 16 rows of `Bs`
// from row k0 (ldmatrix.trans: B's rows are the k dimension).
template <int D>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const unsigned (&a)[4],
                                       const __nv_bfloat16* Bs, int k0, int lane) {
  using L = TileLayout<D>;
#pragma unroll
  for (int dn = 0; dn < D; dn += 16) {
    unsigned b[4];
    ldmatrix_x4_trans(b, Bs + L::off(k0 + (lane & 7) + (lane & 8), dn + ((lane >> 4) << 3)));
    mma_bf16(acc[dn / 8], a, b);
    mma_bf16(acc[dn / 8 + 1], a, b + 2);
  }
}

// A warp's 16 x D accumulator * mul, through its own 16 rows `Os` of a
// tile (no other warp reads them), to rows row0.. of `dst` (rows D apart)
// as 16-byte stores; rows at or past `nrows` are not written.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul,
                                           __nv_bfloat16* Os, __nv_bfloat16* dst, int row0,
                                           int nrows, int lane) {
  using L = TileLayout<D>;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();  // every lane is done reading the rows
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    *reinterpret_cast<unsigned*>(Os + L::off(g, 8 * nt) + 2 * t) =
        pack_bf16(acc[nt][0] * mul, acc[nt][1] * mul);
    *reinterpret_cast<unsigned*>(Os + L::off(g + 8, 8 * nt) + 2 * t) =
        pack_bf16(acc[nt][2] * mul, acc[nt][3] * mul);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * (D / 8); i += 32) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    if (row0 + r < nrows)
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(row0 + r) * D + c) =
          *reinterpret_cast<const uint4*>(Os + L::off(r, c));
  }
}

}  // namespace x2

// Every kernel library exports this, so the Python wrapper can name an error.
extern "C" const char* x2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
