// Tiny (short-query) multi-head attention forward for Hopper (sm_90a), on
// the projection layout: q (B, Sq, H*D), k/v (B, Skv, H*D), out (B, Sq, H*D).
//
// Replaces: x2vlm_tpu/ops/tiny_attention.py `_fwd_kernel` (launched by
// `_tiny_fwd_impl` through `pl.pallas_call`). Same contract: q is scaled
// (here in-kernel, rounded to q's dtype as the reference's `qw * scale`
// does), an optional key mask (B, Skv) adds -1e30 to the masked logits, a
// per-head softmax in fp32, an optional dropout multiplier (B, Sq, H*Skv)
// applied after the softmax, then P @ V. Optionally writes the pre-dropout
// fp32 probabilities (B, Sq, H*Skv), which the backward
// (tiny_attention_bwd.cu) reads; the serving path passes a null pointer and
// skips that write. A row whose every key is masked averages the values of
// its Skv real keys (P = 1/Skv).
//
// What bounds it on the H100: at the main path's shapes (B=128, H=12, D=64;
// text self-attention 40x40, fusion cross-attention 40x200) it moves
// 31-94 MB (serving) for 0.6-3 GFLOP, so it is bound by bytes: ~0.009 /
// ~0.028 ms at 3.35 TB/s, against ~0.001 / ~0.003 ms of bf16 tensor-core
// work; with the training operands (the fp32 probabilities written, a bf16
// multiplier read) 40x200 moves ~168 MB (~0.050 ms).
//
// Two routes, chosen by x2::tiny_route (ops/tiny_attention.py `tiny_route`):
//
// - Tensor cores (bf16, D % 16 == 0, D <= 128; the main path). One block of
//   4 warps per (head h, batch row b), so every K/V byte is read from device
//   memory once. The head's K and V rows (row stride H*D) come into bf16
//   shared memory by 16-byte cp.async, K and V in separate groups so the
//   first walk over K runs while V lands; tiles XOR-swizzled (D % 64 == 0)
//   or padded so ldmatrix reads distinct banks, zero-filled to a multiple of
//   16 keys. Beside them one fp32 bias per key: 0, -1e30 where masked (as
//   the reference adds), -3e38 past Skv, so pad keys never enter a row sum
//   and a fully masked row still gives 1/Skv. 54,080 B at 40x200 (the
//   CUDA-core kernel takes 111,648 B), so 4 blocks share an SM. Each warp
//   owns a 16-row query tile; q * scale, rounded to bf16, goes straight from
//   device memory into mma A fragments while K/V land. S = Qs K^T by
//   mma.sync m16n8k16 (bf16 in, fp32 sums), 16 keys at a time, never a
//   whole row of S in registers. Without probabilities (serving) one walk
//   with the online softmax (kOnePass below); with them two walks, so the
//   stored probabilities are final. P * dm is rounded to bf16 and the C
//   fragments of two adjacent 8-key tiles become the A fragment of P . V,
//   whose B fragments come from V by ldmatrix.trans. Past 64 keys the bf16
//   multiplier of a row tile (training) is loaded into registers before
//   its first walk (kRegDm below). exp is exp2f of (x - m) * log2(e).
// - CUDA cores (fp32 at any D, bf16 at other D): the first design, in fp32:
//   K/V staged as fp32, K with a row stride of D+1 floats so the 32 lanes
//   that each take one key read 32 different banks; each warp takes one
//   query row at a time: lanes over keys for the logits, warp shuffles for
//   the row max and sum, lanes over the head dim for P @ V. fp32 keeps its
//   fp32 products (no TF32).
//
// The TPU kernel's block-diagonal K/V scratch (it cut MXU dispatches), its
// H*D >= 256 gate and head chunking are Mosaic devices and are not carried
// over.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// CUDA-core route
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

static_assert(kWarps == 8, "x2::tiny_fwd_resident_cc_smem counts 8 warps");
size_t smem_bytes(int Skv, int D) { return x2::tiny_fwd_resident_cc_smem(Skv, D); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
tiny_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const uint8_t* __restrict__ key_mask, const void* __restrict__ dmask,
                int dmask_kind, T* __restrict__ out, float* __restrict__ probs, int Sq, int Skv,
                int H, int D, float scale) {
  extern __shared__ float smem[];
  const int LD = D + 1;
  float* Ks = smem;               // Skv x LD
  float* Vs = Ks + Skv * LD;      // Skv x D
  float* Pw = Vs + Skv * D;       // kWarps x Skv: each warp's probability row
  float* Qw = Pw + kWarps * Skv;  // kWarps x D: each warp's scaled query row

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int HD = H * D;

  const long long kv_base = static_cast<long long>(b) * Skv * HD + static_cast<long long>(h) * D;
  for (int i = tid; i < Skv * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    const long long g = kv_base + static_cast<long long>(j) * HD + d;
    Ks[j * LD + d] = x2::to_f(k[g]);
    Vs[j * D + d] = x2::to_f(v[g]);
  }
  __syncthreads();

  float* prow = Pw + warp * Skv;
  float* qrow = Qw + warp * D;
  const uint8_t* km = key_mask != nullptr ? key_mask + static_cast<long long>(b) * Skv : nullptr;
  const long long prow_stride = static_cast<long long>(H) * Skv;

  for (int r = warp; r < Sq; r += kWarps) {
    const long long row = static_cast<long long>(b) * Sq + r;
    const T* qp = q + row * HD + static_cast<long long>(h) * D;
    for (int d = lane; d < D; d += 32)
      qrow[d] = x2::to_f(x2::from_f<T>(x2::to_f(qp[d]) * scale));
    __syncwarp();

    float mx = -INFINITY;
    for (int j = lane; j < Skv; j += 32) {
      const float* kr = Ks + j * LD;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qrow[d], kr[d], s);
      if (km != nullptr && km[j] == 0) s += x2::kNegInf;
      prow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = x2::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < Skv; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
    sum = x2::warp_sum(sum);

    const long long pbase = row * prow_stride + static_cast<long long>(h) * Skv;
    for (int j = lane; j < Skv; j += 32) {
      float p = prow[j] / sum;
      if (probs != nullptr) probs[pbase + j] = p;
      if (dmask != nullptr) p *= x2::load_operand(dmask, dmask_kind, pbase + j);
      prow[j] = p;
    }
    __syncwarp();

    T* op = out + row * HD + static_cast<long long>(h) * D;
    for (int d = lane; d < D; d += 32) {
      float o = 0.f;
      for (int j = 0; j < Skv; ++j) o = fmaf(prow[j], Vs[j * D + d], o);
      op[d] = x2::from_f<T>(o);
    }
    __syncwarp();  // prow / qrow are rewritten for the next row
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_mask,
                   const void* dmask, int dmask_kind, void* out, void* probs, int B, int Sq,
                   int Skv, int H, int D, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(Skv, D);
  cudaError_t err = cudaFuncSetAttribute(
      tiny_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  tiny_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(key_mask), dmask, dmask_kind, static_cast<T*>(out),
      static_cast<float*>(probs), Sq, Skv, H, D, scale);
  return cudaGetLastError();
}

// Key-tiled walk (x2::tiny_walk): kTileKeys keys at a time, one a lane, so
// shared memory holds one K / V tile, the block's scaled query rows and
// their output sums (Sq <= 64: each warp owns at most kMaxRows rows). Two
// passes over the tiles: the row max and sum (each lane its keys, merged by
// shuffles), then P, its store, the multiplier and P . V into the sums.
constexpr int kTileKeys = 32;
constexpr int kMaxRows = x2::kTinyTiledMaxSq / kWarps;
constexpr float kPadLogit = -3.0e38f;  // a lane with no key yet: below any real or masked logit

size_t tiled_smem_bytes(int Sq, int D) {
  return sizeof(float) * (static_cast<size_t>(kTileKeys) * (2 * D + 1) +
                          2 * static_cast<size_t>(Sq) * D + static_cast<size_t>(kWarps) * kTileKeys);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tiny_fwd_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const uint8_t* __restrict__ key_mask, const void* __restrict__ dmask,
                      int dmask_kind, T* __restrict__ out, float* __restrict__ probs, int Sq,
                      int Skv, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int LD = D + 1;
  float* Ks = smem;                   // kTileKeys x LD
  float* Vs = Ks + kTileKeys * LD;    // kTileKeys x D
  float* Qs = Vs + kTileKeys * D;     // Sq x D: q * scale
  float* Os = Qs + Sq * D;            // Sq x D: the rows' P . V sums
  float* Pw = Os + Sq * D;            // kWarps x kTileKeys: each warp's probabilities

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int HD = H * D;
  const long long kv_base = static_cast<long long>(b) * Skv * HD + static_cast<long long>(h) * D;
  const long long q_base = static_cast<long long>(b) * Sq * HD + static_cast<long long>(h) * D;
  const long long prow_stride = static_cast<long long>(H) * Skv;
  const long long p_base = static_cast<long long>(b) * Sq * prow_stride +
                           static_cast<long long>(h) * Skv;
  const uint8_t* km = key_mask != nullptr ? key_mask + static_cast<long long>(b) * Skv : nullptr;

  for (int i = tid; i < Sq * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    Qs[i] = x2::to_f(x2::from_f<T>(x2::to_f(q[q_base + static_cast<long long>(r) * HD + d]) * scale));
    Os[i] = 0.f;
  }
  auto stage = [&](int t0, bool with_v) {
    __syncthreads();  // the previous tile is no longer read
    const int rows = min(kTileKeys, Skv - t0);
    for (int i = tid; i < kTileKeys * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      const long long gi = kv_base + static_cast<long long>(t0 + j) * HD + d;
      Ks[j * LD + d] = j < rows ? x2::to_f(k[gi]) : 0.f;
      if (with_v) Vs[j * D + d] = j < rows ? x2::to_f(v[gi]) : 0.f;
    }
    __syncthreads();
  };
  auto logit = [&](int r, int j) {  // row r, key j = t0 + lane (< Skv)
    const float* qr = Qs + r * D;
    const float* kr = Ks + lane * LD;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
    return km != nullptr && km[j] == 0 ? s + x2::kNegInf : s;
  };

  float m[kMaxRows], l[kMaxRows];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    m[i] = kPadLogit;
    l[i] = 0.f;
  }
  for (int t0 = 0; t0 < Skv; t0 += kTileKeys) {  // pass 1
    stage(t0, false);
    const int j = t0 + lane;
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      const int r = warp + kWarps * i;
      if (r < Sq && j < Skv) {
        const float s = logit(r, j);
        const float mn = fmaxf(m[i], s);
        l[i] = l[i] * expf(m[i] - mn) + expf(s - mn);
        m[i] = mn;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    const float mx = x2::warp_max(m[i]);
    l[i] = x2::warp_sum(l[i] * expf(m[i] - mx));
    m[i] = mx;
  }
  float* pw = Pw + warp * kTileKeys;
  for (int t0 = 0; t0 < Skv; t0 += kTileKeys) {  // pass 2
    stage(t0, true);
    const int j = t0 + lane;
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      const int r = warp + kWarps * i;
      if (r >= Sq) continue;
      float p = 0.f;
      if (j < Skv) {
        const long long pi = p_base + static_cast<long long>(r) * prow_stride + j;
        p = expf(logit(r, j) - m[i]) / l[i];
        if (probs != nullptr) probs[pi] = p;
        if (dmask != nullptr) p *= x2::load_operand(dmask, dmask_kind, pi);
      }
      pw[lane] = p;
      __syncwarp();
      float* orow = Os + r * D;
      for (int d = lane; d < D; d += 32) {
        float o = orow[d];
        for (int jj = 0; jj < kTileKeys; ++jj) o = fmaf(pw[jj], Vs[jj * D + d], o);
        orow[d] = o;
      }
      __syncwarp();  // pw is rewritten for the next row
    }
  }
  __syncthreads();
  for (int i = tid; i < Sq * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    out[q_base + static_cast<long long>(r) * HD + d] = x2::from_f<T>(Os[i]);
  }
}

template <typename T>
cudaError_t launch_tiled(const void* q, const void* k, const void* v, const void* key_mask,
                         const void* dmask, int dmask_kind, void* out, void* probs, int B, int Sq,
                         int Skv, int H, int D, float scale, cudaStream_t stream) {
  const size_t smem = tiled_smem_bytes(Sq, D);
  cudaError_t err = cudaFuncSetAttribute(tiny_fwd_tiled_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  tiny_fwd_tiled_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(key_mask), dmask, dmask_kind, static_cast<T*>(out),
      static_cast<float*>(probs), Sq, Skv, H, D, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core route
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 128;          // 4 warps, each owning 16-row query tiles
constexpr int kWarps = kThreads / 32;
constexpr int kRegGroups = 16;         // 16-key groups whose bf16 multipliers a lane holds
constexpr int kRegDmMinSkv = 64;       // fewer keys: the group-by-group loads are faster
constexpr float kPadLogit = -3.0e38f;  // keys past Skv: below any real or masked logit
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float expo(float x) { return exp2f(x * kLog2e); }

size_t smem_bytes(int Skv, int D) {
  const size_t skv = x2::round_up16(Skv);
  return sizeof(bf16) * 2 * skv * x2::tile_ld(D) + sizeof(float) * skv;
}

// Fragment coordinates: lane = 4 g + t holds rows g and g + 8 of a 16-row
// tile; in a 16 x 8 C tile, columns 2t and 2t + 1. For the 16 keys of group
// gi (keys n0 = 16 gi ...) the kernel keeps two C tiles in c[8]:
// c[4T + 2R + e] is row g + 8R, key n0 + 8T + 2t + e, which is also the
// order of the A fragment of those 16 keys: a[i] = (c[2i], c[2i + 1]).
//
// kOnePass (no probabilities asked for, the serving path): one walk over
// the keys with the online softmax: a running row max m and sum l, the
// output tile rescaled by exp(m_old - m_new) when m grows and divided by l
// at the end; P * dm is rounded to bf16 before P . V as a probability
// relative to the running max. Otherwise two walks, so the probabilities
// are final when they are stored: pass 1 for m and l, pass 2 for P, its
// store and P . V.
//
// kRegDm (two walks only): the multiplier is bf16 and kRegDmMinSkv < Skv <=
// 16 kRegGroups, so each lane loads its multipliers of the row tile into
// registers before pass 1, while K and V land, and pass 2 never waits on
// them; otherwise pass 2 loads them group by group. Either way they are
// read once. The registers cost occupancy (D=64: 168 against 113, 3 blocks
// an SM against 4), which pays at many keys and not at few: on an H100
// (chip_smoke.py check_tiny, B=128, H=12, training operands) 40x200 takes
// 0.105 ms with it against 0.130 ms without, 40x40 0.047 against 0.041 ms.

template <int D, bool kRegDm, bool kOnePass>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const uint8_t* __restrict__ key_mask, const void* __restrict__ dmask,
           int dmask_kind, bf16* __restrict__ out, float* __restrict__ probs, int Sq, int Skv,
           int H, float scale) {
  using L = x2::TileLayout<D>;
  constexpr int KS = D / 16;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Skv16 = x2::round_up16(Skv), ngroups = Skv16 / 16;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);                 // Skv16 rows
  bf16* Vs = Ks + Skv16 * L::kLD;                               // Skv16 rows
  float* kbias = reinterpret_cast<float*>(Vs + Skv16 * L::kLD);  // Skv16

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int HD = H * D;
  const long long kv_base = static_cast<long long>(b) * Skv * HD + static_cast<long long>(h) * D;
  // K first, V second: pass 1 runs while V lands
  x2::stage_rows<D>(Ks, k + kv_base, Skv, Skv16, HD, tid, kThreads);
  x2::cp_async_commit();
  x2::stage_rows<D>(Vs, v + kv_base, Skv, Skv16, HD, tid, kThreads);
  x2::cp_async_commit();
  // what each key adds to its logit: 0, -1e30 where masked (as the
  // reference), -3e38 past Skv (its K row is zeros)
  const uint8_t* km = key_mask != nullptr ? key_mask + static_cast<long long>(b) * Skv : nullptr;
  for (int j = tid; j < Skv16; j += kThreads)
    kbias[j] = j >= Skv ? kPadLogit : (km != nullptr && km[j] == 0 ? x2::kNegInf : 0.f);

  const long long prow_stride = static_cast<long long>(H) * Skv;
  const bool vec = (Skv & 1) == 0;
  const bf16* dm16 = static_cast<const bf16*>(dmask);

  unsigned qa[KS][4];  // q * scale of the warp's 16 rows, rounded to bf16, as A fragments
  unsigned dmr[kRegDm ? kRegGroups : 1][2][2];  // [group][T][R] packed multipliers (kRegDm)
  bool row_ok[2];
  long long prow[2];

  auto load_tile = [&](int r0) {
    row_ok[0] = r0 + g < Sq;
    row_ok[1] = r0 + g + 8 < Sq;
    const long long rb = static_cast<long long>(b) * Sq + r0 + g;
    prow[0] = rb * prow_stride + static_cast<long long>(h) * Skv;
    prow[1] = prow[0] + 8 * prow_stride;
    const bf16* qb = q + rb * HD + static_cast<long long>(h) * D;
    auto pair = [&](int R, int d) -> unsigned {
      if (!row_ok[R]) return 0u;
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(qb + 8LL * R * HD + d));
      return x2::pack_bf16(x.x * scale, x.y * scale);
    };
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      qa[s][0] = pair(0, 16 * s + 2 * t);
      qa[s][1] = pair(1, 16 * s + 2 * t);
      qa[s][2] = pair(0, 16 * s + 8 + 2 * t);
      qa[s][3] = pair(1, 16 * s + 8 + 2 * t);
    }
    if constexpr (kRegDm) {
#pragma unroll
      for (int gi = 0; gi < kRegGroups; ++gi)
#pragma unroll
        for (int T = 0; T < 2; ++T)
#pragma unroll
          for (int R = 0; R < 2; ++R) {
            const int j = 16 * gi + 8 * T + 2 * t;
            dmr[gi][T][R] = x2::load_bf16_pair(dm16, prow[R] + j, row_ok[R] && j < Skv,
                                               row_ok[R] && j + 1 < Skv, vec);
          }
    }
  };
  // biased logits of the 16 keys of group gi (layout above)
  auto logits16 = [&](int gi, float (&c)[8]) {
    const int n0 = 16 * gi;
#pragma unroll
    for (int i = 0; i < 8; ++i) c[i] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      unsigned kb[4];
      x2::ldmatrix_x4(kb, Ks + L::off(n0 + (lane & 7) + ((lane >> 4) << 3), 16 * s + (lane & 8)));
      x2::mma_bf16(c, qa[s], kb);
      x2::mma_bf16(c + 4, qa[s], kb + 2);
    }
#pragma unroll
    for (int T = 0; T < 2; ++T) {
      const float2 a = *reinterpret_cast<const float2*>(kbias + n0 + 8 * T + 2 * t);
      c[4 * T] += a.x;
      c[4 * T + 1] += a.y;
      c[4 * T + 2] += a.x;
      c[4 * T + 3] += a.y;
    }
  };
  // o += P . V for the 16 keys of group gi, P in C fragments (rounded to bf16 here)
  auto pv16 = [&](int gi, const float (&c)[8], float (&o)[NT][4]) {
    const int n0 = 16 * gi;
    const unsigned pa[4] = {x2::pack_bf16(c[0], c[1]), x2::pack_bf16(c[2], c[3]),
                            x2::pack_bf16(c[4], c[5]), x2::pack_bf16(c[6], c[7])};
#pragma unroll
    for (int dn = 0; dn < D; dn += 16) {
      unsigned vb[4];
      x2::ldmatrix_x4_trans(vb, Vs + L::off(n0 + (lane & 7) + (lane & 8), dn + ((lane >> 4) << 3)));
      x2::mma_bf16(o[dn / 8], pa, vb);
      x2::mma_bf16(o[dn / 8 + 1], pa, vb + 2);
    }
  };
  // the one walk on group gi: the running max and sum, o rescaled, o += (P * dm) . V
  auto one_pass_group = [&](int gi, const float2 (&dm)[2][2], float (&m)[2], float (&l)[2],
                            float (&o)[NT][4]) {
    float c[8];
    logits16(gi, c);
#pragma unroll
    for (int R = 0; R < 2; ++R) {
      float mx = fmaxf(fmaxf(c[2 * R], c[2 * R + 1]), fmaxf(c[4 + 2 * R], c[5 + 2 * R]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[R], mx);  // the same in the four lanes of the row
      const float alpha = expo(m[R] - mn);
      m[R] = mn;
      l[R] *= alpha;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][2 * R] *= alpha;
        o[nt][2 * R + 1] *= alpha;
      }
    }
#pragma unroll
    for (int T = 0; T < 2; ++T)
#pragma unroll
      for (int R = 0; R < 2; ++R) {
        float& p0 = c[4 * T + 2 * R];
        float& p1 = c[4 * T + 2 * R + 1];
        p0 = expo(p0 - m[R]);
        p1 = expo(p1 - m[R]);
        l[R] += p0 + p1;
        p0 *= dm[T][R].x;
        p1 *= dm[T][R].y;
      }
    pv16(gi, c, o);
  };
  // pass 2 on group gi: P, the probabilities, the multiplier, o += (P * dm) . V
  auto pass2_group = [&](int gi, const float2 (&dm)[2][2], const float (&m)[2],
                         const float (&inv_l)[2], float (&o)[NT][4]) {
    const int n0 = 16 * gi;
    float c[8];
    logits16(gi, c);
#pragma unroll
    for (int T = 0; T < 2; ++T)
#pragma unroll
      for (int R = 0; R < 2; ++R) {
        float& p0 = c[4 * T + 2 * R];
        float& p1 = c[4 * T + 2 * R + 1];
        p0 = expo(p0 - m[R]) * inv_l[R];
        p1 = expo(p1 - m[R]) * inv_l[R];
        const int j = n0 + 8 * T + 2 * t;
        if (probs != nullptr && row_ok[R] && j < Skv) {
          float* pp = probs + prow[R] + j;
          if (j + 1 < Skv && vec) {
            *reinterpret_cast<float2*>(pp) = make_float2(p0, p1);
          } else {
            pp[0] = p0;
            if (j + 1 < Skv) pp[1] = p1;
          }
        }
        p0 *= dm[T][R].x;
        p1 *= dm[T][R].y;
      }
    pv16(gi, c, o);
  };
  // the multipliers of group gi, loaded from device memory (1 without dmask)
  auto load_dm = [&](int gi, float2 (&dm)[2][2]) {
#pragma unroll
    for (int T = 0; T < 2; ++T)
#pragma unroll
      for (int R = 0; R < 2; ++R) {
        const int j = 16 * gi + 8 * T + 2 * t;
        dm[T][R] = dmask == nullptr
                       ? make_float2(1.f, 1.f)
                       : x2::load_pair(dmask, dmask_kind, prow[R] + j, row_ok[R] && j < Skv,
                                       row_ok[R] && j + 1 < Skv, vec);
      }
  };

  // every warp runs the same number of tile steps, so the two barriers of
  // the first step are reached by all
  const int steps = (Sq + kWarps * 16 - 1) / (kWarps * 16);
  for (int it = 0; it < steps; ++it) {
    const int r0 = 16 * (kWarps * it + warp);
    const bool valid = r0 < Sq;
    if (valid) load_tile(r0);  // the first tile's loads overlap the K/V copies
    if (it == 0) {
      x2::cp_async_wait_group<1>();  // K
      __syncthreads();
    }

    // pass 1: each lane's running max and sum over its keys, then the quad's
    float m[2] = {kPadLogit, kPadLogit}, l[2] = {0.f, 0.f}, inv_l[2];
    if (valid && !kOnePass) {
      for (int gi = 0; gi < ngroups; ++gi) {
        float c[8];
        logits16(gi, c);
#pragma unroll
        for (int R = 0; R < 2; ++R) {
          const float mx = fmaxf(fmaxf(c[2 * R], c[2 * R + 1]), fmaxf(c[4 + 2 * R], c[5 + 2 * R]));
          const float mn = fmaxf(m[R], mx);
          l[R] = l[R] * expo(m[R] - mn) + expo(c[2 * R] - mn) + expo(c[2 * R + 1] - mn) +
                 expo(c[4 + 2 * R] - mn) + expo(c[5 + 2 * R] - mn);
          m[R] = mn;
        }
      }
#pragma unroll
      for (int R = 0; R < 2; ++R) {
#pragma unroll
        for (int sh = 1; sh <= 2; sh <<= 1) {
          const float mo = __shfl_xor_sync(0xffffffffu, m[R], sh);
          const float lo = __shfl_xor_sync(0xffffffffu, l[R], sh);
          const float mn = fmaxf(m[R], mo);
          l[R] = l[R] * expo(m[R] - mn) + lo * expo(mo - mn);
          m[R] = mn;
        }
        inv_l[R] = 1.f / l[R];
      }
    }
    if (it == 0) {
      x2::cp_async_wait_all();  // V
      __syncthreads();
    }
    if (!valid) continue;

    float o[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    if constexpr (kOnePass) {
#pragma unroll 2
      for (int gi = 0; gi < ngroups; ++gi) {
        float2 dm[2][2];
        load_dm(gi, dm);
        one_pass_group(gi, dm, m, l, o);
      }
#pragma unroll
      for (int R = 0; R < 2; ++R) {
        l[R] += __shfl_xor_sync(0xffffffffu, l[R], 1);
        l[R] += __shfl_xor_sync(0xffffffffu, l[R], 2);
        const float inv = 1.f / l[R];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          o[nt][2 * R] *= inv;
          o[nt][2 * R + 1] *= inv;
        }
      }
    } else if constexpr (kRegDm) {  // pass 2
#pragma unroll
      for (int gi = 0; gi < kRegGroups; ++gi) {
        if (gi < ngroups) {
          const float2 dm[2][2] = {
              {x2::unpack_bf16(dmr[gi][0][0]), x2::unpack_bf16(dmr[gi][0][1])},
              {x2::unpack_bf16(dmr[gi][1][0]), x2::unpack_bf16(dmr[gi][1][1])}};
          pass2_group(gi, dm, m, inv_l, o);
        }
      }
    } else {  // pass 2
      for (int gi = 0; gi < ngroups; ++gi) {
        float2 dm[2][2];
        load_dm(gi, dm);
        pass2_group(gi, dm, m, inv_l, o);
      }
    }

    bf16* ob = out + (static_cast<long long>(b) * Sq + r0 + g) * HD + static_cast<long long>(h) * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int d = 8 * nt + 2 * t;
      if (row_ok[0]) *reinterpret_cast<unsigned*>(ob + d) = x2::pack_bf16(o[nt][0], o[nt][1]);
      if (row_ok[1])
        *reinterpret_cast<unsigned*>(ob + 8LL * HD + d) = x2::pack_bf16(o[nt][2], o[nt][3]);
    }
  }
}

template <int D, bool kRegDm, bool kOnePass>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_mask,
                   const void* dmask, int dmask_kind, void* out, void* probs, int B, int Sq,
                   int Skv, int H, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(Skv, D);
  auto kernel = fwd_kernel<D, kRegDm, kOnePass>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(key_mask), dmask, dmask_kind, static_cast<bf16*>(out),
      static_cast<float*>(probs), Sq, Skv, H, scale);
  return cudaGetLastError();
}

// Key-tiled walk (x2::tiny_walk; Sq <= 64, D <= 128). What bounds it at the
// 384 px fusion cross-attention (40 x 584, H = 12, D = 64) is bytes: K and V
// once, and with the training operands the bf16 multiplier read and the fp32
// probabilities written, ~345 MB at B = 96 (0.103 ms at 3.35 TB/s); the
// tensor-core work is ~0.002 ms. The walk's math (exp, the online softmax,
// the staged operands' reads) is latency-bound at the warps an SM holds, so
// the design keeps loads in flight and the warps' math independent:
// - a ring of kStages stages, each one 64-key tile: K and V (TileLayout
//   rows), the key mask bytes and, with dropout, the multiplier's rows
//   (KeyRows: 16-byte copies at any alignment), by cp.async groups, so
//   tiles t + 1 and t + 2 land while tile t is on the tensor cores; the
//   multiplier is read from shared memory, never from device memory in the
//   inner loop; a tile with no masked or padding key skips the logit bias;
// - one warp a 16-row query tile, taking the tile's four 16-key groups at
//   once: four independent products between the softmax's dependent steps.
//   (Two warps a row tile, each taking every second group and merging their
//   sums at the end, lost at every 40 x 584 shape on an H100: more warps,
//   fewer blocks an SM, less work between the steps of each; PERF.md);
// - serving: one walk, the online softmax rescaled once a tile (the max
//   over its four groups), not once a group;
// - with probabilities: pass 1 computes only Q K^T over the K tiles for the
//   row max and sum; pass 2 walks the tiles backwards, so it starts on the
//   K tiles pass 1 read last (still in the ring and in L2), and stores P
//   normalised, each warp's 16 x 16 block through shared memory as 16-byte
//   row pieces;
// - exp by one ex2.approx.ftz (a probability below 2^-126 flushes to 0).
// Shared memory does not grow with Skv: at Sq = 40, D = 64 a serving block
// takes 49,392 B (4 an SM), one with probabilities and a bf16 multiplier
// 75,248 B (3 an SM); tiled_smem_bytes is the most (an fp32 multiplier).
constexpr int kKeyTile = 64;
constexpr int kStages = 3;
constexpr int kScratchLW = 20;  // row stride (words) of a warp's 16 x 16 fp32 probability block
constexpr int kGroups = kKeyTile / 16;  // 16-key groups of a tile
using MaskRows = x2::KeyRows<1>;
using DmRows16 = x2::KeyRows<2>;
using DmRows32 = x2::KeyRows<4>;

__device__ __forceinline__ float ex2e(float x) { return x2::ex2(x * kLog2e); }

// words of a multiplier row in a ring stage: none, bf16 or fp32 (x2::OperandKind)
__host__ __device__ inline int dm_row_words(int dm_kind) {
  return dm_kind == x2::kOperandBF16 ? DmRows16::kLW : dm_kind == x2::kOperandF32 ? DmRows32::kLW : 0;
}

// bytes of one ring stage: K and V tiles, the key mask bytes and the
// multiplier's Sq16 rows
__host__ __device__ inline size_t tiled_stage_bytes(int Sq16, int ld, int dm_kind) {
  return sizeof(bf16) * 2 * kKeyTile * ld + sizeof(unsigned) * MaskRows::kLW +
         sizeof(unsigned) * static_cast<size_t>(Sq16) * dm_row_words(dm_kind);
}

// one block's shared memory: the ring and, with probabilities, each warp's P block
size_t tiled_instance_smem_bytes(int Sq, int D, bool one_pass, int dm_kind) {
  return kStages * tiled_stage_bytes(x2::round_up16(Sq), static_cast<int>(x2::tile_ld(D)),
                                     dm_kind) +
         (one_pass ? 0 : sizeof(float) * kWarps * 16 * kScratchLW);
}

// the most one block takes: the two walks with an fp32 multiplier
size_t tiled_smem_bytes(int Sq, int D) {
  return tiled_instance_smem_bytes(Sq, D, false, x2::kOperandF32);
}

template <int D, bool kOnePass, bool kDm>
__global__ void __launch_bounds__(kThreads, 4)
fwd_tiled_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const uint8_t* __restrict__ key_mask,
                 const void* __restrict__ dmask, int dmask_kind, bf16* __restrict__ out,
                 float* __restrict__ probs, int Sq, int Skv, int H, float scale) {
  using L = x2::TileLayout<D>;
  constexpr int KS = D / 16;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Sq16 = x2::round_up16(Sq);
  const size_t stage_bytes = tiled_stage_bytes(Sq16, L::kLD, kDm ? dmask_kind : 0);
  auto Ks = [&](int slot) { return reinterpret_cast<bf16*>(smem_raw + slot * stage_bytes); };
  auto Vs = [&](int slot) { return Ks(slot) + kKeyTile * L::kLD; };
  auto Ms = [&](int slot) { return reinterpret_cast<unsigned*>(Vs(slot) + kKeyTile * L::kLD); };
  auto Ds = [&](int slot) { return Ms(slot) + MaskRows::kLW; };

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* scratch = reinterpret_cast<float*>(smem_raw + kStages * stage_bytes) +
                   warp * 16 * kScratchLW;
  const int HD = H * D;
  const long long kv_base = static_cast<long long>(b) * Skv * HD + static_cast<long long>(h) * D;
  const long long prow_stride = static_cast<long long>(H) * Skv;
  const long long p_base = static_cast<long long>(b) * Sq * prow_stride +
                           static_cast<long long>(h) * Skv;
  const long long m_base = static_cast<long long>(b) * Skv;  // the key mask row
  const int r0 = 16 * warp;
  const bool active = r0 < Sq;
  const bool row_ok[2] = {r0 + g < Sq, r0 + g + 8 < Sq};
  const long long prow[2] = {p_base + (r0 + g) * prow_stride, p_base + (r0 + g + 8) * prow_stride};
  const bool dm16 = dmask_kind == x2::kOperandBF16;
  const int dm_lw = dm_row_words(dmask_kind);
  const int ntiles = (Skv + kKeyTile - 1) / kKeyTile;
  const int nsteps = kOnePass ? ntiles : 2 * ntiles;
  // step s: pass 1 on tile s (K only) while s < ntiles, else pass 2 on
  // tile 2 ntiles - 1 - s (backwards); serving: tile s
  auto tile_of = [&](int s) { return kOnePass || s < ntiles ? s : 2 * ntiles - 1 - s; };
  auto full = [&](int s) { return kOnePass || s >= ntiles; };

  unsigned qa[KS][4];  // q * scale of the warp's 16 rows, rounded to bf16, as A fragments
  if (active) {
    const bf16* qb = q + (static_cast<long long>(b) * Sq + r0 + g) * HD + static_cast<long long>(h) * D;
    auto pair = [&](int R, int d) -> unsigned {
      if (!row_ok[R]) return 0u;
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(qb + 8LL * R * HD + d));
      return x2::pack_bf16(x.x * scale, x.y * scale);
    };
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      qa[s][0] = pair(0, 16 * s + 2 * t);
      qa[s][1] = pair(1, 16 * s + 2 * t);
      qa[s][2] = pair(0, 16 * s + 8 + 2 * t);
      qa[s][3] = pair(1, 16 * s + 8 + 2 * t);
    }
  }

  // step s's tile into slot s % kStages (one cp.async group, empty past the end)
  auto load_step = [&](int s) {
    if (s < nsteps) {
      const int slot = s % kStages, t0 = tile_of(s) * kKeyTile;
      const int rows = min(kKeyTile, Skv - t0);
      x2::stage_rows<D>(Ks(slot), k + kv_base + static_cast<long long>(t0) * HD, rows, kKeyTile,
                        HD, tid, kThreads);
      if (key_mask != nullptr)
        MaskRows::stage(Ms(slot), key_mask, m_base, 0, 1, 1, t0, Skv, tid, kThreads);
      if (full(s)) {
        x2::stage_rows<D>(Vs(slot), v + kv_base + static_cast<long long>(t0) * HD, rows,
                          kKeyTile, HD, tid, kThreads);
        if constexpr (kDm) {
          if (dm16)
            DmRows16::stage(Ds(slot), dmask, p_base, prow_stride, Sq, Sq16, t0, Skv, tid,
                            kThreads);
          else
            DmRows32::stage(Ds(slot), dmask, p_base, prow_stride, Sq, Sq16, t0, Skv, tid,
                            kThreads);
        }
      }
    }
    x2::cp_async_commit();
  };
  // whether the tile in `slot` (keys from t0) has a masked or padding key
  auto biased = [&](int slot, int t0) {
    if (t0 + kKeyTile > Skv) return true;
    if (key_mask == nullptr) return false;
    const unsigned char* mb = reinterpret_cast<const unsigned char*>(Ms(slot)) +
                              MaskRows::shift(m_base + t0);
    return !__all_sync(0xffffffffu, mb[2 * lane] != 0 && mb[2 * lane + 1] != 0);
  };
  // logits of the 16 keys of group gi of the tile in `slot`, biased when
  // `bias`: c[4T + 2R + e] is row r0 + g + 8R, key 16 gi + 8T + 2t + e
  auto logits16 = [&](int slot, int t0, int gi, bool bias, float (&c)[8]) {
    x2::mma_abt<D>(c, qa, Ks(slot), 16 * gi, lane);
    if (!bias) return;
    const unsigned char* mb = reinterpret_cast<const unsigned char*>(Ms(slot)) +
                              MaskRows::shift(m_base + t0);
#pragma unroll
    for (int T = 0; T < 2; ++T)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 16 * gi + 8 * T + 2 * t + e;
        const float kb = t0 + j >= Skv ? kPadLogit
                         : (key_mask != nullptr && mb[j] == 0 ? x2::kNegInf : 0.f);
        c[4 * T + e] += kb;
        c[4 * T + 2 + e] += kb;
      }
  };
  // the multipliers of keys 16 gi + 8T + 2t, + 1 of rows r0 + g + 8R
  auto mult = [&](int slot, int t0, int gi, int T, int R) -> float2 {
    const int rr = r0 + g + 8 * R, j = 16 * gi + 8 * T + 2 * t;
    const unsigned* row = Ds(slot) + rr * dm_lw;
    return dm16 ? x2::key_pair_bf16(row, j, DmRows16::shift(prow[R] + t0))
                : x2::key_pair_f32(row, j, DmRows32::shift(prow[R] + t0));
  };
  auto pv16 = [&](int slot, int gi, const float (&c)[8], float (&o)[NT][4]) {
    unsigned pa[4];
    x2::pack_a(pa, c);
    x2::mma_ab<D>(o, pa, Vs(slot), 16 * gi, lane);
  };
  // the warp's 16 x 16 block of P (keys from j0) to device memory as
  // 16-byte row pieces, through its own block of shared memory
  const bool vec4 = (Skv & 3) == 0;
  auto store_p = [&](int j0, const float (&c)[8]) {
    __syncwarp();  // the previous block has been read
#pragma unroll
    for (int T = 0; T < 2; ++T)
#pragma unroll
      for (int R = 0; R < 2; ++R)
        *reinterpret_cast<float2*>(scratch + (g + 8 * R) * kScratchLW + 8 * T + 2 * t) =
            make_float2(c[4 * T + 2 * R], c[4 * T + 2 * R + 1]);
    __syncwarp();
#pragma unroll
    for (int i = lane; i < 64; i += 32) {
      const int r = i >> 2, c4 = 4 * (i & 3), j = j0 + c4;
      if (r0 + r >= Sq || j >= Skv) continue;
      const float4 p = *reinterpret_cast<const float4*>(scratch + r * kScratchLW + c4);
      float* dst = probs + p_base + (r0 + r) * prow_stride + j;
      if (vec4 && j + 3 < Skv) {
        *reinterpret_cast<float4*>(dst) = p;
      } else {
        dst[0] = p.x;
        if (j + 1 < Skv) dst[1] = p.y;
        if (j + 2 < Skv) dst[2] = p.z;
        if (j + 3 < Skv) dst[3] = p.w;
      }
    }
  };

  float m[2] = {kPadLogit, kPadLogit}, l[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_step(s);
  for (int s = 0; s < nsteps; ++s) {
    x2::cp_async_wait_group<kStages - 2>();  // step s's tile
    __syncthreads();  // ... for every thread; the slot of step s - 1 is free
    load_step(s + kStages - 1);
    if (!kOnePass && s == ntiles) {  // pass 1 done: the row max and sum
#pragma unroll
      for (int R = 0; R < 2; ++R) {
#pragma unroll
        for (int sh = 1; sh <= 2; sh <<= 1) {  // the quad's
          const float mo = __shfl_xor_sync(0xffffffffu, m[R], sh);
          const float lo = __shfl_xor_sync(0xffffffffu, l[R], sh);
          const float mn = fmaxf(m[R], mo);
          l[R] = l[R] * ex2e(m[R] - mn) + lo * ex2e(mo - mn);
          m[R] = mn;
        }
      }
#pragma unroll
      for (int R = 0; R < 2; ++R) inv_l[R] = 1.f / l[R];
    }
    if (!active) continue;
    const int slot = s % kStages, t0 = tile_of(s) * kKeyTile;
    const int ng = (min(kKeyTile, Skv - t0) + 15) / 16;
    const bool bias = biased(slot, t0);
    if (!full(s)) {  // pass 1: each lane's running max and sum over its keys
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        if (gi >= ng) continue;
        float c[8];
        logits16(slot, t0, gi, bias, c);
#pragma unroll
        for (int R = 0; R < 2; ++R) {
          const float mx = fmaxf(fmaxf(c[2 * R], c[2 * R + 1]), fmaxf(c[4 + 2 * R], c[5 + 2 * R]));
          const float mn = fmaxf(m[R], mx);
          l[R] = l[R] * ex2e(m[R] - mn) + ex2e(c[2 * R] - mn) + ex2e(c[2 * R + 1] - mn) +
                 ex2e(c[4 + 2 * R] - mn) + ex2e(c[5 + 2 * R] - mn);
          m[R] = mn;
        }
      }
    } else if constexpr (kOnePass) {  // the tile's groups; one rescale
      float c[kGroups][8];
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        if (gi < ng) {
          logits16(slot, t0, gi, bias, c[gi]);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) c[gi][i] = kPadLogit;
        }
      }
#pragma unroll
      for (int R = 0; R < 2; ++R) {
        float mx = kPadLogit;
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi)
          mx = fmaxf(mx, fmaxf(fmaxf(c[gi][2 * R], c[gi][2 * R + 1]),
                               fmaxf(c[gi][4 + 2 * R], c[gi][5 + 2 * R])));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[R], mx);  // the same in the four lanes of the row
        const float alpha = ex2e(m[R] - mn);
        m[R] = mn;
        l[R] *= alpha;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          o[nt][2 * R] *= alpha;
          o[nt][2 * R + 1] *= alpha;
        }
      }
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        if (gi >= ng) continue;
#pragma unroll
        for (int T = 0; T < 2; ++T)
#pragma unroll
          for (int R = 0; R < 2; ++R) {
            float& p0 = c[gi][4 * T + 2 * R];
            float& p1 = c[gi][4 * T + 2 * R + 1];
            p0 = ex2e(p0 - m[R]);
            p1 = ex2e(p1 - m[R]);
            l[R] += p0 + p1;
            if constexpr (kDm) {
              const float2 dm = mult(slot, t0, gi, T, R);
              p0 *= dm.x;
              p1 *= dm.y;
            }
          }
        pv16(slot, gi, c[gi], o);
      }
    } else {  // pass 2: P final, stored, times the multiplier, into o
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        if (gi >= ng) continue;
        float c[8];
        logits16(slot, t0, gi, bias, c);
#pragma unroll
        for (int T = 0; T < 2; ++T)
#pragma unroll
          for (int R = 0; R < 2; ++R) {
            c[4 * T + 2 * R] = ex2e(c[4 * T + 2 * R] - m[R]) * inv_l[R];
            c[4 * T + 2 * R + 1] = ex2e(c[4 * T + 2 * R + 1] - m[R]) * inv_l[R];
          }
        store_p(t0 + 16 * gi, c);
        if constexpr (kDm) {
#pragma unroll
          for (int T = 0; T < 2; ++T)
#pragma unroll
            for (int R = 0; R < 2; ++R) {
              const float2 dm = mult(slot, t0, gi, T, R);
              c[4 * T + 2 * R] *= dm.x;
              c[4 * T + 2 * R + 1] *= dm.y;
            }
        }
        pv16(slot, gi, c, o);
      }
    }
  }

  if (!active) return;
  float inv[2] = {1.f, 1.f};  // with probabilities o is already normalised
  if (kOnePass) {
#pragma unroll
    for (int R = 0; R < 2; ++R) {  // the quad's sum
      l[R] += __shfl_xor_sync(0xffffffffu, l[R], 1);
      l[R] += __shfl_xor_sync(0xffffffffu, l[R], 2);
      inv[R] = 1.f / l[R];
    }
  }
  bf16* ob = out + (static_cast<long long>(b) * Sq + r0 + g) * HD + static_cast<long long>(h) * D;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int d = 8 * nt + 2 * t;
    if (row_ok[0])
      *reinterpret_cast<unsigned*>(ob + d) = x2::pack_bf16(o[nt][0] * inv[0], o[nt][1] * inv[0]);
    if (row_ok[1])
      *reinterpret_cast<unsigned*>(ob + 8LL * HD + d) =
          x2::pack_bf16(o[nt][2] * inv[1], o[nt][3] * inv[1]);
  }
}

template <int D, bool kOnePass, bool kDm>
cudaError_t launch_tiled(const void* q, const void* k, const void* v, const void* key_mask,
                         const void* dmask, int dmask_kind, void* out, void* probs, int B,
                         int Sq, int Skv, int H, float scale, cudaStream_t stream) {
  const size_t smem = tiled_instance_smem_bytes(Sq, D, kOnePass, kDm ? dmask_kind : 0);
  auto kernel = fwd_tiled_kernel<D, kOnePass, kDm>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(key_mask), dmask, dmask_kind, static_cast<bf16*>(out),
      static_cast<float*>(probs), Sq, Skv, H, scale);
  return cudaGetLastError();
}

template <int D, bool kDm>
cudaError_t launch_tiled_dm(const void* q, const void* k, const void* v, const void* key_mask,
                            const void* dmask, int dmask_kind, void* out, void* probs, int B,
                            int Sq, int Skv, int H, float scale, cudaStream_t st) {
  return probs == nullptr
             ? launch_tiled<D, true, kDm>(q, k, v, key_mask, dmask, dmask_kind, out, probs, B, Sq,
                                          Skv, H, scale, st)
             : launch_tiled<D, false, kDm>(q, k, v, key_mask, dmask, dmask_kind, out, probs, B,
                                           Sq, Skv, H, scale, st);
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* key_mask,
                     const void* dmask, int dmask_kind, void* out, void* probs, int B, int Sq,
                     int Skv, int H, float scale, cudaStream_t st) {
  if (x2::tiny_walk(Sq, Skv, D) == x2::kWalkTiled)
    return dmask == nullptr ? launch_tiled_dm<D, false>(q, k, v, key_mask, dmask, dmask_kind, out,
                                                        probs, B, Sq, Skv, H, scale, st)
                            : launch_tiled_dm<D, true>(q, k, v, key_mask, dmask, dmask_kind, out,
                                                       probs, B, Sq, Skv, H, scale, st);
  if (probs == nullptr)
    return launch<D, false, true>(q, k, v, key_mask, dmask, dmask_kind, out, probs, B, Sq, Skv,
                                  H, scale, st);
  if constexpr (D <= 64) {  // registers: the multipliers beside q and the output tile
    if (dmask != nullptr && dmask_kind == x2::kOperandBF16 && Skv > kRegDmMinSkv &&
        x2::round_up16(Skv) <= 16 * kRegGroups)
      return launch<D, true, false>(q, k, v, key_mask, dmask, dmask_kind, out, probs, B, Sq, Skv,
                                    H, scale, st);
  }
  return launch<D, false, false>(q, k, v, key_mask, dmask, dmask_kind, out, probs, B, Sq, Skv, H,
                                 scale, st);
}

cudaError_t dispatch(const void* q, const void* k, const void* v, const void* key_mask,
                     const void* dmask, int dmask_kind, void* out, void* probs, int B, int Sq,
                     int Skv, int H, int D, float scale, cudaStream_t st) {
  switch (D) {
#define X2_TINY_FWD_CASE(DD)                                                                   \
  case DD:                                                                                     \
    return launch_d<DD>(q, k, v, key_mask, dmask, dmask_kind, out, probs, B, Sq, Skv, H, scale, \
                        st);
    X2_TINY_FWD_CASE(16)
    X2_TINY_FWD_CASE(32)
    X2_TINY_FWD_CASE(48)
    X2_TINY_FWD_CASE(64)
    X2_TINY_FWD_CASE(80)
    X2_TINY_FWD_CASE(96)
    X2_TINY_FWD_CASE(112)
    X2_TINY_FWD_CASE(128)
#undef X2_TINY_FWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// The route (x2::TinyRoute) the kernels take for q/k/v of `dtype` at head
// dim D; ops/tiny_attention.py `tiny_route` keeps the same rule.
extern "C" int x2_tiny_attention_route(int dtype, int D) { return x2::tiny_route(dtype, D); }

// Shared memory (bytes) one block of `route` needs; ops/tiny_attention.py
// keeps the same formulas and refuses larger shapes before launch.
extern "C" long long x2_tiny_attention_smem_bytes(int Skv, int D, int route) {
  return static_cast<long long>(route == x2::kRouteTensorCore ? tc::smem_bytes(Skv, D)
                                                              : smem_bytes(Skv, D));
}

// The walk (x2::TinyWalk) both kernels take at (Sq, Skv, D);
// ops/tiny_attention.py `tiny_walk` keeps the same rule.
extern "C" int x2_tiny_attention_walk(int Sq, int Skv, int D) { return x2::tiny_walk(Sq, Skv, D); }

// Shared memory (bytes) one block of the key-tiled walk on `route` needs;
// it does not depend on Skv (ops/tiny_attention.py `tiled_smem_bytes`).
extern "C" long long x2_tiny_attention_tiled_smem_bytes(int Sq, int D, int route) {
  return static_cast<long long>(route == x2::kRouteTensorCore ? tc::tiled_smem_bytes(Sq, D)
                                                              : tiled_smem_bytes(Sq, D));
}

// q, out: (B, Sq, H*D); k, v: (B, Skv, H*D); all contiguous, dtype `dtype`
// (x2::DType); on the tensor-core route 16-byte aligned. key_mask: null or
// (B, Skv) uint8, 0 = masked. dmask: null or (B, Sq, H*Skv), f32 or bf16 per
// dmask_kind (x2::OperandKind). probs: null or (B, Sq, H*Skv) f32. Returns
// cudaGetLastError() after the launch.
extern "C" int x2_tiny_attention_fwd(const void* q, const void* k, const void* v,
                                     const void* key_mask, const void* dmask, int dmask_kind,
                                     void* out, void* probs, int B, int Sq, int Skv, int H,
                                     int D, int dtype, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || D <= 0) return cudaErrorInvalidValue;
  if (dmask != nullptr && dmask_kind != x2::kOperandF32 && dmask_kind != x2::kOperandBF16)
    return cudaErrorInvalidValue;
  const bool tiled = x2::tiny_walk(Sq, Skv, D) == x2::kWalkTiled;
  if (tiled && (Sq > x2::kTinyTiledMaxSq || D > x2::kTinyTiledMaxD)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x2::tiny_route(dtype, D) == x2::kRouteTensorCore)
    return static_cast<int>(tc::dispatch(q, k, v, key_mask, dmask, dmask_kind, out, probs, B,
                                         Sq, Skv, H, D, scale, st));
  if (tiled && dtype == x2::kF32)
    return static_cast<int>(launch_tiled<float>(q, k, v, key_mask, dmask, dmask_kind, out, probs,
                                                B, Sq, Skv, H, D, scale, st));
  if (tiled && dtype == x2::kBF16)
    return static_cast<int>(launch_tiled<__nv_bfloat16>(q, k, v, key_mask, dmask, dmask_kind,
                                                        out, probs, B, Sq, Skv, H, D, scale, st));
  if (dtype == x2::kF32)
    return static_cast<int>(launch<float>(q, k, v, key_mask, dmask, dmask_kind, out, probs, B,
                                          Sq, Skv, H, D, scale, st));
  if (dtype == x2::kBF16)
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, key_mask, dmask, dmask_kind, out,
                                                  probs, B, Sq, Skv, H, D, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
