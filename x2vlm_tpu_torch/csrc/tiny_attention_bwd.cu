// Tiny (short-query) multi-head attention backward for Hopper (sm_90a), on
// the projection layout: q, g, dq (B, Sq, H*D); k, v, dk, dv (B, Skv, H*D).
//
// Replaces: x2vlm_tpu/ops/tiny_attention.py `_bwd_kernel` (K6, launched by
// `_tiny_vjp_bwd` through `pl.pallas_call`). Same contract: the forward's
// fp32 pre-dropout probabilities P (B, Sq, H*Skv) and the same optional
// dropout multiplier dm (B, Sq, H*Skv) come in, with the output gradient g;
// per head, with Pu = P * dm:
//   dV = Pu^T . g
//   dP = (g . V^T) * dm
//   dL = P * (dP - rowsum(dP * P))          (softmax backward)
//   dQs = dL . K,  dK = dL^T . Qs
// The key mask needs no operand: a masked key's P is 0. Scale: the port's
// forward (tiny_attention_fwd.cu) scales q in-kernel, rounding q * scale to
// q's dtype as the JAX package's `qw * scale` does, while the TPU kernel
// receives the scaled Qs. So this kernel rebuilds Qs = q * scale with the
// same rounding for dK, and returns dQ = dQs * scale, the gradient of the
// unscaled q.
//
// What bounds it on the H100: at the main path's shapes (B=64 text 40x40,
// B=128 fusion 40x40 and 40x200, H=12, D=64) it moves the fp32
// probabilities, the bf16 multiplier and seven (B, S, H*D) tensors: ~255 MB
// at 40x200 for ~6 GFLOP, so it is bound by bytes (~0.076 ms at 3.35 TB/s;
// the bf16 tensor-core work is ~0.006 ms).
//
// Two routes, chosen by x2::tiny_route (ops/tiny_attention.py `tiny_route`):
//
// - Tensor cores (bf16, D % 16 == 0, D <= 128; the main path). One block of
//   4 warps per (head h, batch row b), as the forward, so each K/V/P byte
//   is read from device memory once. g, V and P come into shared memory by
//   cp.async in one group, K in a second that lands during pass 1; Qs =
//   q * scale rounded to bf16 beside them. bf16 tiles are XOR-swizzled or
//   padded for conflict-free ldmatrix and zero-filled to 16 rows; P is one
//   fp32 word per (query row, key). Each warp owns a 16-row query tile, its
//   bf16 multipliers loaded once into registers in the mma C layout (each
//   lane two adjacent keys of two rows), and walks the keys twice, 16 at a
//   time, with mma.sync m16n8k16 (bf16 in, fp32 sums):
//   1. dP = g . V^T; rowsum(dP * dm * P), summed per lane and merged over
//      the fragment quad by shuffles;
//   2. dP again; dL = P * (dP * dm - rowsum) and Pu = P * dm, each rounded
//      to bf16 as the plain version rounds them; dQ += dL . K with dL as
//      the A fragment straight from registers and K through ldmatrix.trans;
//      the 16 words of P of the key group are rewritten in place as its dL
//      (16 bf16) and Pu (16 bf16); dQ * scale is stored.
//   After a barrier, dK = dL^T . Qs and dV = Pu^T . g: 16 keys by D per
//   task, the query rows as the k dimension, both operands through
//   ldmatrix.trans, tasks spread over the warps; each output tile goes
//   through shared memory (K/V's, dead by then) to 16-byte row stores.
//   Shared memory 106,240 B at 40x200 (the CUDA-core kernel takes 184 KB),
//   so 2 blocks share an SM.
// - CUDA cores (fp32 at any D, bf16 at other D up to 256): the first design,
//   in fp32. One block of 512 threads per (head h, batch row b); its shared
//   memory fills an SM at 40x200, so the block brings 16 warps to hide the
//   latency of its loads. Two phases:
//   1. that head's K and V (Skv x D, row stride D+1 floats) in shared
//      memory; each warp takes four query rows at a time: lanes over keys
//      for dP and the softmax backward (warp shuffles for the row sums),
//      lanes over the head dim for dQ; each row's dL and Pu = P * dm stay in
//      shared memory (Sq x Skv fp32 each);
//   2. K/V's space is reused for g and Qs (Sq x D each); each warp takes
//      four keys at a time, lanes over the head dim, and sums dV and dK over
//      the query rows from shared memory only.
//   Carrying four rows (keys) per warp reuses each K/V (g/Qs) element
//   loaded from shared memory four times: the loops are bound by
//   shared-memory load issue, not by FMAs. fp32 keeps fp32 products.
//
// The block-diagonal K/V scratch of the TPU kernel (it cut MXU dispatches)
// is not carried over. Shared memory bounds the shapes: ops/tiny_attention.py
// admits a shape only when both the forward and this kernel fit.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// CUDA-core route
// ---------------------------------------------------------------------------

constexpr int kThreads = 512;  // 16 warps: one block fills an SM's shared memory
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDPerLane = 8;  // head dims up to 256
constexpr int kRows = 4;         // query rows a warp carries at once (phase 1)
constexpr int kKeys = 4;         // keys a warp carries at once (phase 2)

static_assert(kWarps == 16 && kRows == 4, "x2::tiny_bwd_resident_cc_smem counts 16 x 4 rows");
size_t smem_bytes(int Sq, int Skv, int D) { return x2::tiny_bwd_resident_cc_smem(Sq, Skv, D); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
tiny_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ probs, const void* __restrict__ dmask,
                int dmask_kind, const T* __restrict__ g, T* __restrict__ dq,
                T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H, int D,
                float scale) {
  extern __shared__ float smem[];
  const int LD = D + 1;
  const size_t kv = static_cast<size_t>(Skv) * 2 * LD;
  const size_t gq = static_cast<size_t>(Sq) * 2 * D;
  float* Ks = smem;                          // phase 1: Skv x LD
  float* Vs = Ks + Skv * LD;                 // phase 1: Skv x LD
  float* Gs = smem;                          // phase 2: Sq x D
  float* Qs = Gs + Sq * D;                   // phase 2: Sq x D
  float* dL = smem + (kv > gq ? kv : gq);    // Sq x Skv
  float* Pu = dL + Sq * Skv;                 // Sq x Skv: P * dm
  float* Gw = Pu + Sq * Skv;                 // kWarps x kRows x D: each warp's g rows

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int HD = H * D;
  const long long kv_base = static_cast<long long>(b) * Skv * HD + static_cast<long long>(h) * D;
  const long long q_base = static_cast<long long>(b) * Sq * HD + static_cast<long long>(h) * D;
  const long long prow_stride = static_cast<long long>(H) * Skv;
  const long long p_base = static_cast<long long>(b) * Sq * prow_stride +
                           static_cast<long long>(h) * Skv;

#pragma unroll 4
  for (int i = tid; i < Skv * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    const long long gi = kv_base + static_cast<long long>(j) * HD + d;
    Ks[j * LD + d] = x2::to_f(k[gi]);
    Vs[j * LD + d] = x2::to_f(v[gi]);
  }
  __syncthreads();

  // ---- phase 1: dL and dQ, kRows query rows per warp at a time ----
  float* gw = Gw + warp * kRows * D;
  for (int r0 = warp * kRows; r0 < Sq; r0 += kWarps * kRows) {
    const int nr = min(kRows, Sq - r0);
    for (int i = 0; i < nr; ++i)
      for (int d = lane; d < D; d += 32)
        gw[i * D + d] = x2::to_f(g[q_base + static_cast<long long>(r0 + i) * HD + d]);
    __syncwarp();
    float dot[kRows];  // rowsum(dP * P) of each row
#pragma unroll
    for (int i = 0; i < kRows; ++i) dot[i] = 0.f;
    for (int j = lane; j < Skv; j += 32) {
      // this key's P and dm of the rows first, so their loads overlap the dot products
      float p[kRows], m[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const long long pi = p_base + static_cast<long long>(r0 + i) * prow_stride + j;
        p[i] = i < nr ? probs[pi] : 0.f;
        m[i] = i < nr && dmask != nullptr ? x2::load_operand(dmask, dmask_kind, pi) : 1.f;
      }
      const float* vr = Vs + j * LD;
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float vv = vr[d];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i] = fmaf(gw[i * D + d], vv, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (i < nr) {
          const float dpv = acc[i] * m[i];
          dL[(r0 + i) * Skv + j] = dpv;  // dP for now
          Pu[(r0 + i) * Skv + j] = p[i] * m[i];
          dot[i] = fmaf(dpv, p[i], dot[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) dot[i] = x2::warp_sum(dot[i]);
    for (int j = lane; j < Skv; j += 32)
      for (int i = 0; i < nr; ++i) {
        const long long pi = p_base + static_cast<long long>(r0 + i) * prow_stride + j;
        float* dl = dL + (r0 + i) * Skv + j;
        *dl = probs[pi] * (*dl - dot[i]);
      }
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
      for (int j = 0; j < Skv; ++j) {
        const float kk = Ks[j * LD + d];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if (i < nr) acc[i] = fmaf(dL[(r0 + i) * Skv + j], kk, acc[i]);
      }
      for (int i = 0; i < nr; ++i)
        dq[q_base + static_cast<long long>(r0 + i) * HD + d] = x2::from_f<T>(acc[i] * scale);
    }
    __syncwarp();  // gw is rewritten for the next rows
  }
  __syncthreads();  // K/V are no longer read; every dL row is written

  // ---- phase 2: dV and dK, kKeys keys per warp at a time ----
#pragma unroll 4
  for (int i = tid; i < Sq * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const long long gi = q_base + static_cast<long long>(r) * HD + d;
    Gs[i] = x2::to_f(g[gi]);
    Qs[i] = x2::to_f(x2::from_f<T>(x2::to_f(q[gi]) * scale));  // as the forward rounds it
  }
  __syncthreads();
  for (int j0 = warp * kKeys; j0 < Skv; j0 += kWarps * kKeys) {
    const int nk = min(kKeys, Skv - j0);
    float dk_acc[kKeys][kMaxDPerLane], dv_acc[kKeys][kMaxDPerLane];
#pragma unroll
    for (int i = 0; i < kKeys; ++i)
#pragma unroll
      for (int t = 0; t < kMaxDPerLane; ++t) {
        dk_acc[i][t] = 0.f;
        dv_acc[i][t] = 0.f;
      }
    for (int r = 0; r < Sq; ++r) {
      float pu[kKeys], dl[kKeys];
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        pu[i] = i < nk ? Pu[r * Skv + j0 + i] : 0.f;
        dl[i] = i < nk ? dL[r * Skv + j0 + i] : 0.f;
      }
#pragma unroll
      for (int t = 0; t < kMaxDPerLane; ++t) {
        const int d = lane + 32 * t;
        if (d < D) {
          const float gv = Gs[r * D + d], qv = Qs[r * D + d];
#pragma unroll
          for (int i = 0; i < kKeys; ++i) {
            dv_acc[i][t] = fmaf(pu[i], gv, dv_acc[i][t]);
            dk_acc[i][t] = fmaf(dl[i], qv, dk_acc[i][t]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      if (i >= nk) continue;
      const long long o = kv_base + static_cast<long long>(j0 + i) * HD;
#pragma unroll
      for (int t = 0; t < kMaxDPerLane; ++t) {
        const int d = lane + 32 * t;
        if (d < D) {
          dk[o + d] = x2::from_f<T>(dk_acc[i][t]);
          dv[o + d] = x2::from_f<T>(dv_acc[i][t]);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* probs,
                   const void* dmask, int dmask_kind, const void* g, void* dq, void* dk,
                   void* dv, int B, int Sq, int Skv, int H, int D, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(Sq, Skv, D);
  cudaError_t err = cudaFuncSetAttribute(
      tiny_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  tiny_bwd_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(probs), dmask, dmask_kind, static_cast<const T*>(g),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, D, scale);
  return cudaGetLastError();
}

// Key-tiled walk (x2::tiny_walk; Sq <= 64, D <= 128): 256 threads, the
// keys kTileKeys at a time, one a lane. g, Qs and the dQ sums (Sq x D
// each) stay in shared memory; per tile only its K and V rows and the
// tile's dL and Pu columns. Pass 1 over the V tiles: rowsum(dP * dm * P) of
// each row (each warp its rows, each lane its keys, then a warp sum). Pass
// 2 over K and V tiles: dL and Pu of the tile's columns, then dQ += dL . K
// (threads over (row, d)) and the tile's dK = dL^T . Qs, dV = Pu^T . g
// (threads over (key, d)), stored at once: no other block has those keys.
constexpr int kTiledThreads = 256;
constexpr int kTiledWarps = kTiledThreads / 32;
constexpr int kTileKeys = 32;
constexpr int kMaxRows = x2::kTinyTiledMaxSq / kTiledWarps;

size_t tiled_smem_bytes(int Sq, int D) {
  return sizeof(float) * (2 * static_cast<size_t>(kTileKeys) * (D + 1) +
                          3 * static_cast<size_t>(Sq) * D + 2 * static_cast<size_t>(Sq) * kTileKeys);
}

template <typename T>
__global__ void __launch_bounds__(kTiledThreads)
tiny_bwd_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ probs, const void* __restrict__ dmask,
                      int dmask_kind, const T* __restrict__ g, T* __restrict__ dq,
                      T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H, int D,
                      float scale) {
  extern __shared__ float smem[];
  const int LD = D + 1;
  float* Ks = smem;                        // kTileKeys x LD
  float* Vs = Ks + kTileKeys * LD;         // kTileKeys x LD
  float* Gs = Vs + kTileKeys * LD;         // Sq x D
  float* Qs = Gs + Sq * D;                 // Sq x D: q * scale
  float* dQ = Qs + Sq * D;                 // Sq x D: dL . K sums
  float* dL = dQ + Sq * D;                 // Sq x kTileKeys
  float* Pu = dL + Sq * kTileKeys;         // Sq x kTileKeys: P * dm

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int HD = H * D;
  const long long kv_base = static_cast<long long>(b) * Skv * HD + static_cast<long long>(h) * D;
  const long long q_base = static_cast<long long>(b) * Sq * HD + static_cast<long long>(h) * D;
  const long long prow_stride = static_cast<long long>(H) * Skv;
  const long long p_base = static_cast<long long>(b) * Sq * prow_stride +
                           static_cast<long long>(h) * Skv;

  for (int i = tid; i < Sq * D; i += kTiledThreads) {
    const int r = i / D, d = i - r * D;
    const long long gi = q_base + static_cast<long long>(r) * HD + d;
    Gs[i] = x2::to_f(g[gi]);
    Qs[i] = x2::to_f(x2::from_f<T>(x2::to_f(q[gi]) * scale));  // as the forward rounds it
    dQ[i] = 0.f;
  }
  auto stage = [&](int t0, bool with_k) {
    __syncthreads();  // the previous tile is no longer read
    const int rows = min(kTileKeys, Skv - t0);
    for (int i = tid; i < kTileKeys * D; i += kTiledThreads) {
      const int j = i / D, d = i - j * D;
      const long long gi = kv_base + static_cast<long long>(t0 + j) * HD + d;
      Vs[j * LD + d] = j < rows ? x2::to_f(v[gi]) : 0.f;
      if (with_k) Ks[j * LD + d] = j < rows ? x2::to_f(k[gi]) : 0.f;
    }
    __syncthreads();
  };
  auto dp_at = [&](int r) {  // (g . V^T) at row r and the lane's key of the tile
    const float* gr = Gs + r * D;
    const float* vr = Vs + lane * LD;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(gr[d], vr[d], s);
    return s;
  };

  float dot[kMaxRows];  // rowsum(dP * dm * P) of the warp's rows
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) dot[i] = 0.f;
  for (int t0 = 0; t0 < Skv; t0 += kTileKeys) {  // pass 1
    stage(t0, false);
    const int j = t0 + lane;
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      const int r = warp + kTiledWarps * i;
      if (r < Sq && j < Skv) {
        const long long pi = p_base + static_cast<long long>(r) * prow_stride + j;
        const float m = dmask != nullptr ? x2::load_operand(dmask, dmask_kind, pi) : 1.f;
        dot[i] = fmaf(dp_at(r) * m, probs[pi], dot[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) dot[i] = x2::warp_sum(dot[i]);

  for (int t0 = 0; t0 < Skv; t0 += kTileKeys) {  // pass 2
    stage(t0, true);
    const int j = t0 + lane;
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      const int r = warp + kTiledWarps * i;
      if (r >= Sq) continue;
      float dl = 0.f, pu = 0.f;
      if (j < Skv) {
        const long long pi = p_base + static_cast<long long>(r) * prow_stride + j;
        const float m = dmask != nullptr ? x2::load_operand(dmask, dmask_kind, pi) : 1.f;
        const float p = probs[pi];
        dl = p * (dp_at(r) * m - dot[i]);
        pu = p * m;
      }
      dL[r * kTileKeys + lane] = dl;
      Pu[r * kTileKeys + lane] = pu;
    }
    __syncthreads();
    for (int i = tid; i < Sq * D; i += kTiledThreads) {
      const int r = i / D, d = i - r * D;
      float a = dQ[i];
      for (int jj = 0; jj < kTileKeys; ++jj) a = fmaf(dL[r * kTileKeys + jj], Ks[jj * LD + d], a);
      dQ[i] = a;
    }
    const int rows = min(kTileKeys, Skv - t0);
    for (int i = tid; i < rows * D; i += kTiledThreads) {
      const int jj = i / D, d = i - jj * D;
      float ak = 0.f, av = 0.f;
      for (int r = 0; r < Sq; ++r) {
        ak = fmaf(dL[r * kTileKeys + jj], Qs[r * D + d], ak);
        av = fmaf(Pu[r * kTileKeys + jj], Gs[r * D + d], av);
      }
      const long long gi = kv_base + static_cast<long long>(t0 + jj) * HD + d;
      dk[gi] = x2::from_f<T>(ak);
      dv[gi] = x2::from_f<T>(av);
    }
  }
  __syncthreads();
  for (int i = tid; i < Sq * D; i += kTiledThreads) {
    const int r = i / D, d = i - r * D;
    dq[q_base + static_cast<long long>(r) * HD + d] = x2::from_f<T>(dQ[i] * scale);
  }
}

template <typename T>
cudaError_t launch_tiled(const void* q, const void* k, const void* v, const void* probs,
                         const void* dmask, int dmask_kind, const void* g, void* dq, void* dk,
                         void* dv, int B, int Sq, int Skv, int H, int D, float scale,
                         cudaStream_t stream) {
  const size_t smem = tiled_smem_bytes(Sq, D);
  cudaError_t err = cudaFuncSetAttribute(tiny_bwd_tiled_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  tiny_bwd_tiled_kernel<T><<<dim3(H, B), kTiledThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(probs), dmask, dmask_kind, static_cast<const T*>(g),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, D, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core route
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 128;   // 4 warps, each owning 16-row query tiles
constexpr int kWarps = kThreads / 32;
constexpr int kRegGroups = 16;  // 16-key groups whose bf16 multipliers a lane holds

size_t smem_bytes(int Sq, int Skv, int D) {
  const size_t sq = x2::round_up16(Sq), skv = x2::round_up16(Skv);
  return sizeof(bf16) * (2 * skv + 2 * sq) * x2::tile_ld(D) + sizeof(float) * sq * (skv + 4);
}

// Fragment coordinates as in tiny_attention_fwd.cu: lane = 4 g + t; for the
// 16 keys of group gi (from n0 = 16 gi), c[4T + 2R + e] is row g + 8R, key
// n0 + 8T + 2t + e, and the A fragment of those keys is a[i] = (c[2i],
// c[2i + 1]).
//
// W, one 32-bit word per (query row, key), holds P (fp32) from the start;
// pass 2 rewrites the 16 words of a row's key group as the group's dL (16
// bf16, 32 bytes) followed by its Pu (16 bf16), which phase 3 reads with
// ldmatrix.trans. Its row stride Skv16 + 4 words keeps those reads
// conflict-free.
//
// kRegDm: the multiplier is bf16 and Skv <= 16 kRegGroups, so each lane
// loads its multipliers of the row tile once, into registers, before pass 1
// (one round trip to device memory, while the copies land) and keeps them
// for pass 2; otherwise both passes load them group by group. On an H100
// (chip_smoke.py check_tiny_bwd, H=12, D=64, training operands) it takes
// 40x200 at B=128 from 0.260 to 0.142 ms and 40x40 at B=64 from 0.028 to
// 0.025 ms; 40x40 at B=128 is within 3% either way (0.054 / 0.053).

template <int D, bool kRegDm>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const float* __restrict__ probs, const void* __restrict__ dmask, int dmask_kind,
           const bf16* __restrict__ g, bf16* __restrict__ dq, bf16* __restrict__ dk,
           bf16* __restrict__ dv, int Sq, int Skv, int H, float scale) {
  using L = x2::TileLayout<D>;  // K, V, g, Qs
  constexpr int KS = D / 16;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Skv16 = x2::round_up16(Skv), Sq16 = x2::round_up16(Sq), ngroups = Skv16 / 16;
  const int LDW = Skv16 + 4;  // W row stride (words)
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);         // Skv16 rows
  bf16* Vs = Ks + Skv16 * L::kLD;                       // Skv16 rows
  bf16* Gs = Vs + Skv16 * L::kLD;                       // Sq16 rows
  bf16* Qs = Gs + Sq16 * L::kLD;                        // Sq16 rows
  float* W = reinterpret_cast<float*>(Qs + Sq16 * L::kLD);  // Sq16 x LDW

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int HD = H * D;
  const long long kv_base = static_cast<long long>(b) * Skv * HD + static_cast<long long>(h) * D;
  const long long q_base = static_cast<long long>(b) * Sq * HD + static_cast<long long>(h) * D;
  const long long prow_stride = static_cast<long long>(H) * Skv;
  const long long p_base = static_cast<long long>(b) * Sq * prow_stride +
                           static_cast<long long>(h) * Skv;

  // group 1: g, V and P (pass 1); group 2: K (pass 2)
  x2::stage_rows<D>(Gs, g + q_base, Sq, Sq16, HD, tid, kThreads);
  x2::stage_rows<D>(Vs, v + kv_base, Skv, Skv16, HD, tid, kThreads);
  if ((Skv & 3) == 0) {  // P rows start 16-byte aligned
    const int chunks = Skv16 / 4;
    for (int i = tid; i < Sq16 * chunks; i += kThreads) {
      const int r = i / chunks, c = (i - r * chunks) * 4;
      const bool ok = r < Sq && c < Skv;
      x2::cp_async16(W + r * LDW + c, probs + p_base + (ok ? r * prow_stride + c : 0),
                     ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < Sq16 * Skv16; i += kThreads) {
      const int r = i / Skv16, c = i - r * Skv16;
      const bool ok = r < Sq && c < Skv;
      x2::cp_async4(W + r * LDW + c, probs + p_base + (ok ? r * prow_stride + c : 0),
                    ok ? 4 : 0);
    }
  }
  x2::cp_async_commit();
  x2::stage_rows<D>(Ks, k + kv_base, Skv, Skv16, HD, tid, kThreads);
  x2::cp_async_commit();
  // Qs = q * scale rounded to bf16, as the forward rounds it; rows past Sq are zeros
  constexpr int kRowChunks = D / 8;
  for (int i = tid; i < Sq16 * kRowChunks; i += kThreads) {
    const int r = i / kRowChunks, c = (i % kRowChunks) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < Sq) {
      raw = *reinterpret_cast<const uint4*>(q + q_base + static_cast<long long>(r) * HD + c);
      unsigned* w = reinterpret_cast<unsigned*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = x2::unpack_bf16(w[e]);
        w[e] = x2::pack_bf16(x.x * scale, x.y * scale);
      }
    }
    *reinterpret_cast<uint4*>(Qs + L::off(r, c)) = raw;
  }

  const bool vec = (Skv & 1) == 0;
  const bf16* dm16 = static_cast<const bf16*>(dmask);
  unsigned dmr[kRegDm ? kRegGroups : 1][2][2];  // [group][T][R] packed multipliers (kRegDm)
  bool row_ok[2];
  long long prow[2];
  unsigned ga[KS][4];  // g rows r0 .. r0 + 15 as A fragments
  int r0 = 0;

  // multipliers of group gi (keys 16 gi + 8T + 2t, + 1; rows gr + 8R)
  auto mult = [&](int gi, int T, int R) -> float2 {
    if constexpr (kRegDm) {
      return x2::unpack_bf16(dmr[gi][T][R]);
    } else {
      if (dmask == nullptr) return make_float2(1.f, 1.f);
      const int j = 16 * gi + 8 * T + 2 * t;
      return x2::load_pair(dmask, dmask_kind, prow[R] + j, row_ok[R] && j < Skv,
                           row_ok[R] && j + 1 < Skv, vec);
    }
  };
  auto dp16 = [&](int gi, float (&c)[8]) {  // g . V^T for the 16 keys of group gi
    const int n0 = 16 * gi;
#pragma unroll
    for (int i = 0; i < 8; ++i) c[i] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      unsigned vb[4];
      x2::ldmatrix_x4(vb, Vs + L::off(n0 + (lane & 7) + ((lane >> 4) << 3), 16 * s + (lane & 8)));
      x2::mma_bf16(c, ga[s], vb);
      x2::mma_bf16(c + 4, ga[s], vb + 2);
    }
  };
  auto p_pair = [&](int gi, int T, int R) -> float2 {  // P at (row gr + 8R, keys ..) from W
    return *reinterpret_cast<const float2*>(W + (r0 + gr + 8 * R) * LDW + 16 * gi + 8 * T + 2 * t);
  };
  auto pass1_group = [&](int gi, float (&dot)[2]) {
    float c[8];
    dp16(gi, c);
#pragma unroll
    for (int T = 0; T < 2; ++T)
#pragma unroll
      for (int R = 0; R < 2; ++R) {
        const float2 p = p_pair(gi, T, R), m = mult(gi, T, R);
        dot[R] += c[4 * T + 2 * R] * m.x * p.x + c[4 * T + 2 * R + 1] * m.y * p.y;
      }
  };
  auto pass2_group = [&](int gi, const float (&dot)[2], float (&acc)[NT][4]) {
    const int n0 = 16 * gi;
    float c[8], pu[8];
    dp16(gi, c);
#pragma unroll
    for (int T = 0; T < 2; ++T)
#pragma unroll
      for (int R = 0; R < 2; ++R) {
        const float2 p = p_pair(gi, T, R), m = mult(gi, T, R);
        float* cc = c + 4 * T + 2 * R;
        float* uu = pu + 4 * T + 2 * R;
        cc[0] = p.x * (cc[0] * m.x - dot[R]);
        cc[1] = p.y * (cc[1] * m.y - dot[R]);
        uu[0] = p.x * m.x;
        uu[1] = p.y * m.y;
      }
    const unsigned la[4] = {x2::pack_bf16(c[0], c[1]), x2::pack_bf16(c[2], c[3]),
                            x2::pack_bf16(c[4], c[5]), x2::pack_bf16(c[6], c[7])};
    const unsigned ua[4] = {x2::pack_bf16(pu[0], pu[1]), x2::pack_bf16(pu[2], pu[3]),
                            x2::pack_bf16(pu[4], pu[5]), x2::pack_bf16(pu[6], pu[7])};
    __syncwarp();  // every lane has read this group's P before it becomes dL | Pu
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a[i]: row gr + 8 (i & 1), keys n0 + 8 (i >> 1) + 2t
      unsigned* w = reinterpret_cast<unsigned*>(W + (r0 + gr + 8 * (i & 1)) * LDW + n0);
      w[4 * (i >> 1) + t] = la[i];      // dL: bf16 key 8 (i >> 1) + 2t of the group
      w[8 + 4 * (i >> 1) + t] = ua[i];  // Pu: 32 bytes on
    }
#pragma unroll
    for (int dn = 0; dn < D; dn += 16) {
      unsigned kb[4];
      x2::ldmatrix_x4_trans(kb, Ks + L::off(n0 + (lane & 7) + (lane & 8), dn + ((lane >> 4) << 3)));
      x2::mma_bf16(acc[dn / 8], la, kb);
      x2::mma_bf16(acc[dn / 8 + 1], la, kb + 2);
    }
  };

  // ---- passes 1 and 2: dL, Pu and dQ, one 16-row tile per warp and step;
  // every warp runs the same number of steps, so the barriers of the first
  // step are reached by all ----
  const int steps = (Sq + kWarps * 16 - 1) / (kWarps * 16);
  for (int it = 0; it < steps; ++it) {
    r0 = 16 * (kWarps * it + warp);
    const bool valid = r0 < Sq;
    if (valid) {
      row_ok[0] = r0 + gr < Sq;
      row_ok[1] = r0 + gr + 8 < Sq;
      prow[0] = p_base + (r0 + gr) * prow_stride;
      prow[1] = prow[0] + 8 * prow_stride;
      if constexpr (kRegDm) {  // overlaps the copies
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
    }
    if (it == 0) {
      x2::cp_async_wait_group<1>();  // g, V, P
      __syncthreads();
    }
    float dot[2] = {0.f, 0.f};  // rowsum(dP * dm * P) of rows gr and gr + 8
    if (valid) {
#pragma unroll
      for (int s = 0; s < KS; ++s)
        x2::ldmatrix_x4(ga[s], Gs + L::off(r0 + (lane & 15), 16 * s + ((lane >> 4) << 3)));
      if constexpr (kRegDm) {
#pragma unroll
        for (int gi = 0; gi < kRegGroups; ++gi)
          if (gi < ngroups) pass1_group(gi, dot);
      } else {
        for (int gi = 0; gi < ngroups; ++gi) pass1_group(gi, dot);
      }
#pragma unroll
      for (int R = 0; R < 2; ++R) {
        dot[R] += __shfl_xor_sync(0xffffffffu, dot[R], 1);
        dot[R] += __shfl_xor_sync(0xffffffffu, dot[R], 2);
      }
    }
    if (it == 0) {
      x2::cp_async_wait_all();  // K
      __syncthreads();
    }
    if (!valid) continue;

    float acc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    if constexpr (kRegDm) {
#pragma unroll
      for (int gi = 0; gi < kRegGroups; ++gi)
        if (gi < ngroups) pass2_group(gi, dot, acc);
    } else {
      for (int gi = 0; gi < ngroups; ++gi) pass2_group(gi, dot, acc);
    }
    bf16* qrow = dq + q_base + static_cast<long long>(r0 + gr) * HD;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int d = 8 * nt + 2 * t;
      if (row_ok[0])
        *reinterpret_cast<unsigned*>(qrow + d) =
            x2::pack_bf16(acc[nt][0] * scale, acc[nt][1] * scale);
      if (row_ok[1])
        *reinterpret_cast<unsigned*>(qrow + 8LL * HD + d) =
            x2::pack_bf16(acc[nt][2] * scale, acc[nt][3] * scale);
    }
  }
  __syncthreads();  // every dL / Pu row is in W

  // ---- dK = dL^T . Qs and dV = Pu^T . g, 16 keys by D per task ----
  const int tasks = ngroups * 2;
  bf16* Os = Ks + warp * 16 * L::kLD;  // the warp's output tile; a warp with tasks fits in K/V
  for (int task = warp; task < tasks; task += kWarps) {
    const int m0 = (task >> 1) * 16;
    const bool is_dv = task & 1;
    // A^T: the group's dL (or Pu, 32 bytes on) of rows 0 .. Sq16, read transposed
    const unsigned char* A = reinterpret_cast<const unsigned char*>(W + m0) + (is_dv ? 32 : 0);
    const bf16* Bm = is_dv ? Gs : Qs;  // Sq16 rows
    float o[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    for (int k0 = 0; k0 < Sq16; k0 += 16) {
      unsigned a[4];
      x2::ldmatrix_x4_trans(a, A + (k0 + (lane & 7) + ((lane >> 4) << 3)) * LDW * 4 +
                                   (lane & 8) * 2);
#pragma unroll
      for (int dn = 0; dn < D; dn += 16) {
        unsigned bb[4];
        x2::ldmatrix_x4_trans(bb,
                              Bm + L::off(k0 + (lane & 7) + (lane & 8), dn + ((lane >> 4) << 3)));
        x2::mma_bf16(o[dn / 8], a, bb);
        x2::mma_bf16(o[dn / 8 + 1], a, bb + 2);
      }
    }
    // through the warp's 16-row tile in K/V's space (no longer read), so the
    // rows go out as 16-byte stores
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      *reinterpret_cast<unsigned*>(Os + L::off(gr, 8 * nt) + 2 * t) =
          x2::pack_bf16(o[nt][0], o[nt][1]);
      *reinterpret_cast<unsigned*>(Os + L::off(gr + 8, 8 * nt) + 2 * t) =
          x2::pack_bf16(o[nt][2], o[nt][3]);
    }
    __syncwarp();
    bf16* dst = (is_dv ? dv : dk) + kv_base;
#pragma unroll
    for (int i = lane; i < 16 * (D / 8); i += 32) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      if (m0 + r < Skv)
        *reinterpret_cast<uint4*>(dst + static_cast<long long>(m0 + r) * HD + c) =
            *reinterpret_cast<const uint4*>(Os + L::off(r, c));
    }
    __syncwarp();  // the tile is rewritten by the warp's next task
  }
}

template <int D, bool kRegDm>
cudaError_t launch(const void* q, const void* k, const void* v, const void* probs,
                   const void* dmask, int dmask_kind, const void* g, void* dq, void* dk,
                   void* dv, int B, int Sq, int Skv, int H, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(Sq, Skv, D);
  auto kernel = bwd_kernel<D, kRegDm>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // as much of the SM's 228 KB as shared memory as it takes: 2 blocks at 40x200
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(probs), dmask, dmask_kind, static_cast<const bf16*>(g),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Skv, H, scale);
  return cudaGetLastError();
}

// Key-tiled walk (x2::tiny_walk; Sq <= 64, D <= 128). What bounds it at the
// 384 px fusion cross-attention (40 x 584, H = 12, D = 64) is bytes: the fp32
// probabilities, the bf16 multiplier and q, g, out, K, V, dq, dk, dv once
// each, ~530 MB at B = 96 (0.158 ms at 3.35 TB/s). So the design reads each
// of them once and keeps loads in flight:
// - one walk: the softmax backward's row sums rowsum(dP * dm * P) are taken
//   as rowsum(g * out) (equal, since out = (P * dm) . V) in the prologue,
//   from the block's rows of g and of the forward's out, so no walk reads
//   V, P and the multiplier only for them;
// - a ring of kBwdStages 64-key tiles: K and V (TileLayout rows) and the
//   multiplier (KeyRows: 16-byte copies at any alignment), by cp.async
//   groups, so tile t + 1 lands during tile t's two phases; P, read once,
//   goes from device memory straight into registers, each warp's values of
//   tile t + 1 loaded as it is done with tile t's, so the ring stays small
//   enough for 3 blocks an SM;
// - phase A: dP = g . V^T, dL = P * (dP * dm - rowsum) and Pu = P * dm for
//   (16-row tile, 16-key group) units, warp w taking group w of every row
//   tile, dL and Pu rounded to bf16 into two planes (rows of 72 elements:
//   conflict-free ldmatrix both ways);
// - phase B, after a barrier: the tile's dK = dL^T . Qs and dV = Pu^T . g
//   (16 keys by D a task, staged through the tile's V rows, dead by then,
//   to 16-byte row stores; no other block has these keys), and dQ += dL . K
//   in (16-row, 16-column) units that each warp owns for the whole walk.
// Shared memory does not grow with Skv: kBwdStages tiles, g, Qs, the two
// planes and the row sums, 72,960 B at Sq = 40, D = 64 with a bf16
// multiplier (3 blocks an SM); tiled_smem_bytes is the most (fp32).
constexpr int kKeyTile = 64;
constexpr int kBwdStages = 2;
constexpr int kWLD = kKeyTile + 8;  // row stride (elements) of the dL and Pu planes
using DmRows16 = x2::KeyRows<2>;
using DmRows32 = x2::KeyRows<4>;

// words of a multiplier row in a ring stage: none, bf16 or fp32 (x2::OperandKind)
__host__ __device__ inline int dm_row_words(int dm_kind) {
  return dm_kind == x2::kOperandBF16 ? DmRows16::kLW : dm_kind == x2::kOperandF32 ? DmRows32::kLW : 0;
}

// bytes of one ring stage: K and V tiles and the multiplier's Sq16 rows
__host__ __device__ inline size_t tiled_stage_bytes(int Sq16, int ld, int dm_kind) {
  return sizeof(bf16) * 2 * kKeyTile * ld +
         sizeof(unsigned) * static_cast<size_t>(Sq16) * dm_row_words(dm_kind);
}

size_t tiled_instance_smem_bytes(int Sq, int D, int dm_kind) {
  const int sq = x2::round_up16(Sq), ld = static_cast<int>(x2::tile_ld(D));
  return kBwdStages * tiled_stage_bytes(sq, ld, dm_kind) + sizeof(bf16) * 2 * sq * (ld + kWLD) +
         sizeof(float) * x2::kTinyTiledMaxSq;
}

// the most one block takes: an fp32 multiplier
size_t tiled_smem_bytes(int Sq, int D) { return tiled_instance_smem_bytes(Sq, D, x2::kOperandF32); }

template <int D, bool kDm>
__global__ void __launch_bounds__(kThreads, 3)
bwd_tiled_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ probs,
                 const void* __restrict__ dmask, int dmask_kind, const bf16* __restrict__ g,
                 const bf16* __restrict__ out, bf16* __restrict__ dq, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int Sq, int Skv, int H, float scale) {
  using L = x2::TileLayout<D>;  // K, V, g, Qs
  constexpr int KS = D / 16;
  constexpr int NT = D / 8;
  constexpr int kDqUnits = D / 16;  // (16-row, 16-column) dQ units a warp owns, at most
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Sq16 = x2::round_up16(Sq), NR = Sq16 / 16;
  const size_t stage_bytes = tiled_stage_bytes(Sq16, L::kLD, kDm ? dmask_kind : 0);
  auto Ks = [&](int slot) { return reinterpret_cast<bf16*>(smem_raw + slot * stage_bytes); };
  auto Vs = [&](int slot) { return Ks(slot) + kKeyTile * L::kLD; };
  auto Ds = [&](int slot) { return reinterpret_cast<unsigned*>(Vs(slot) + kKeyTile * L::kLD); };
  bf16* Gs = reinterpret_cast<bf16*>(smem_raw + kBwdStages * stage_bytes);  // Sq16 rows
  bf16* Qs = Gs + Sq16 * L::kLD;                                            // Sq16 rows
  bf16* Wl = Qs + Sq16 * L::kLD;                                            // dL, Sq16 x kWLD
  bf16* Wu = Wl + Sq16 * kWLD;                                              // Pu
  float* delta = reinterpret_cast<float*>(Wu + Sq16 * kWLD);                // rowsum, Sq16

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int HD = H * D;
  const long long kv_base = static_cast<long long>(b) * Skv * HD + static_cast<long long>(h) * D;
  const long long q_base = static_cast<long long>(b) * Sq * HD + static_cast<long long>(h) * D;
  const long long prow_stride = static_cast<long long>(H) * Skv;
  const long long p_base = static_cast<long long>(b) * Sq * prow_stride +
                           static_cast<long long>(h) * Skv;
  const bool dm16 = dmask_kind == x2::kOperandBF16;
  const int dm_lw = dm_row_words(dmask_kind);
  const int ntiles = (Skv + kKeyTile - 1) / kKeyTile;
  const bool vec = (Skv & 1) == 0;

  // tile s into slot s % kBwdStages (one cp.async group, empty past the end)
  auto load_step = [&](int s) {
    if (s < ntiles) {
      const int slot = s % kBwdStages, t0 = s * kKeyTile, rows = min(kKeyTile, Skv - t0);
      x2::stage_rows<D>(Ks(slot), k + kv_base + static_cast<long long>(t0) * HD, rows, kKeyTile,
                        HD, tid, kThreads);
      x2::stage_rows<D>(Vs(slot), v + kv_base + static_cast<long long>(t0) * HD, rows, kKeyTile,
                        HD, tid, kThreads);
      if constexpr (kDm) {
        if (dm16)
          DmRows16::stage(Ds(slot), dmask, p_base, prow_stride, Sq, Sq16, t0, Skv, tid, kThreads);
        else
          DmRows32::stage(Ds(slot), dmask, p_base, prow_stride, Sq, Sq16, t0, Skv, tid, kThreads);
      }
    }
    x2::cp_async_commit();
  };

  x2::stage_rows<D>(Gs, g + q_base, Sq, Sq16, HD, tid, kThreads);  // lands with tile 0
#pragma unroll
  for (int s = 0; s < kBwdStages - 1; ++s) load_step(s);
  constexpr int kRowChunks = D / 8;  // Qs = q * scale rounded to bf16; rows past Sq are zeros
  for (int i = tid; i < Sq16 * kRowChunks; i += kThreads) {
    const int r = i / kRowChunks, c = (i % kRowChunks) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < Sq) {
      raw = *reinterpret_cast<const uint4*>(q + q_base + static_cast<long long>(r) * HD + c);
      unsigned* w = reinterpret_cast<unsigned*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = x2::unpack_bf16(w[e]);
        w[e] = x2::pack_bf16(x.x * scale, x.y * scale);
      }
    }
    *reinterpret_cast<uint4*>(Qs + L::off(r, c)) = raw;
  }
  for (int r = warp; r < Sq16; r += kWarps) {  // rowsum(g * out), 0 past Sq
    float sum = 0.f;
    if (r < Sq) {
      const long long base = q_base + static_cast<long long>(r) * HD;
      for (int d = 2 * lane; d < D; d += 64) {
        const float2 a = x2::unpack_bf16(*reinterpret_cast<const unsigned*>(g + base + d));
        const float2 o = x2::unpack_bf16(*reinterpret_cast<const unsigned*>(out + base + d));
        sum += a.x * o.x + a.y * o.y;
      }
    }
    sum = x2::warp_sum(sum);
    if (lane == 0) delta[r] = sum;
  }

  // P of the warp's units (row tile rt, its key group `warp`) of the tile in
  // hand: p[rt][R][T] is row 16 rt + gr + 8R, keys 16 warp + 8T + 2t, + 1
  float2 p[4][2][2];
  auto load_p = [&](int rt, int s) {
#pragma unroll
    for (int R = 0; R < 2; ++R)
#pragma unroll
      for (int T = 0; T < 2; ++T) {
        const int rr = 16 * rt + gr + 8 * R, j = s * kKeyTile + 16 * warp + 8 * T + 2 * t;
        const bool ok = rr < Sq && s < ntiles;
        p[rt][R][T] = x2::load_pair(probs, x2::kOperandF32, p_base + rr * prow_stride + j,
                                    ok && j < Skv, ok && j + 1 < Skv, vec);
      }
  };
#pragma unroll
  for (int rt = 0; rt < 4; ++rt)
    if (rt < NR) load_p(rt, 0);

  float dqa[kDqUnits][2][4];  // the warp's dQs units (unit warp + 4i: row tile, 16 columns)
#pragma unroll
  for (int i = 0; i < kDqUnits; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n) dqa[i][n][0] = dqa[i][n][1] = dqa[i][n][2] = dqa[i][n][3] = 0.f;

  for (int s = 0; s < ntiles; ++s) {
    x2::cp_async_wait_group<kBwdStages - 2>();  // tile s (and g)
    __syncthreads();  // ... for every thread; tile s - 1's slot and the planes are free
    load_step(s + kBwdStages - 1);
    const int slot = s % kBwdStages, t0 = s * kKeyTile;
    const int ng = (min(kKeyTile, Skv - t0) + 15) / 16;

    // phase A: dL and Pu of (row tile, key group) units, then P of the next tile
#pragma unroll
    for (int rt = 0; rt < 4; ++rt) {
      if (rt >= NR) continue;
      if (warp >= ng) {
        load_p(rt, s + 1);
        continue;
      }
      const int n0 = 16 * warp;
      unsigned ga[KS][4];  // g rows 16 rt .. as A fragments
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        x2::ldmatrix_x4(ga[ks], Gs + L::off(16 * rt + (lane & 15), 16 * ks + ((lane >> 4) << 3)));
      float c[8], pu[8];
      x2::mma_abt<D>(c, ga, Vs(slot), n0, lane);
#pragma unroll
      for (int R = 0; R < 2; ++R) {
        const int rr = 16 * rt + gr + 8 * R;
        const long long e0 = p_base + rr * prow_stride + t0;
        const float dl_sum = delta[rr];
#pragma unroll
        for (int T = 0; T < 2; ++T) {
          const int j = n0 + 8 * T + 2 * t;
          const float2 pp = p[rt][R][T];
          float2 m = make_float2(1.f, 1.f);
          if constexpr (kDm) {
            const unsigned* drow = Ds(slot) + rr * dm_lw;
            m = dm16 ? x2::key_pair_bf16(drow, j, DmRows16::shift(e0))
                     : x2::key_pair_f32(drow, j, DmRows32::shift(e0));
          }
          float* cc = c + 4 * T + 2 * R;
          float* uu = pu + 4 * T + 2 * R;
          cc[0] = pp.x * (cc[0] * m.x - dl_sum);
          cc[1] = pp.y * (cc[1] * m.y - dl_sum);
          uu[0] = pp.x * m.x;
          uu[1] = pp.y * m.y;
        }
      }
      load_p(rt, s + 1);
#pragma unroll
      for (int T = 0; T < 2; ++T)
#pragma unroll
        for (int R = 0; R < 2; ++R) {
          const int off = (16 * rt + gr + 8 * R) * kWLD + n0 + 8 * T + 2 * t;
          *reinterpret_cast<unsigned*>(Wl + off) = x2::pack_bf16(c[4 * T + 2 * R], c[4 * T + 2 * R + 1]);
          *reinterpret_cast<unsigned*>(Wu + off) = x2::pack_bf16(pu[4 * T + 2 * R], pu[4 * T + 2 * R + 1]);
        }
    }
    __syncthreads();  // every dL / Pu of the tile is in the planes; V is no longer read

    // phase B: dK = dL^T . Qs and dV = Pu^T . g, 16 keys by D a task
    bf16* Os = Vs(slot) + warp * 16 * L::kLD;  // the warp's 16 rows of the dead V tile
    for (int task = warp; task < 2 * ng; task += kWarps) {
      const int m0 = (task >> 1) * 16;
      const bool is_dv = task & 1;
      const bf16* A = is_dv ? Wu : Wl;
      const bf16* Bm = is_dv ? Gs : Qs;
      float o[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
      for (int k0 = 0; k0 < Sq16; k0 += 16) {
        unsigned a[4];  // (keys m0 .., rows k0 ..), read transposed
        x2::ldmatrix_x4_trans(a, A + (k0 + (lane & 7) + ((lane >> 4) << 3)) * kWLD + m0 + (lane & 8));
        x2::mma_ab<D>(o, a, Bm, k0, lane);
      }
      // through the warp's 16 rows, so the rows go out as 16-byte stores
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        *reinterpret_cast<unsigned*>(Os + L::off(gr, 8 * nt) + 2 * t) =
            x2::pack_bf16(o[nt][0], o[nt][1]);
        *reinterpret_cast<unsigned*>(Os + L::off(gr + 8, 8 * nt) + 2 * t) =
            x2::pack_bf16(o[nt][2], o[nt][3]);
      }
      __syncwarp();
      bf16* dst = (is_dv ? dv : dk) + kv_base;
#pragma unroll
      for (int i = lane; i < 16 * (D / 8); i += 32) {
        const int r = i / (D / 8), c = (i % (D / 8)) * 8;
        const int key = t0 + m0 + r;
        if (key < Skv)
          *reinterpret_cast<uint4*>(dst + static_cast<long long>(key) * HD + c) =
              *reinterpret_cast<const uint4*>(Os + L::off(r, c));
      }
      __syncwarp();  // the rows are rewritten by the warp's next task
    }
    // dQs += dL . K, the warp's units
#pragma unroll
    for (int i = 0; i < kDqUnits; ++i) {
      const int unit = warp + kWarps * i;
      if (unit >= NR * kDqUnits) continue;
      const int rt = unit / kDqUnits, dc = unit % kDqUnits;
      for (int gi = 0; gi < ng; ++gi) {
        unsigned a[4], kb[4];
        x2::ldmatrix_x4(a, Wl + (16 * rt + (lane & 15)) * kWLD + 16 * gi + ((lane >> 4) << 3));
        x2::ldmatrix_x4_trans(kb, Ks(slot) + L::off(16 * gi + (lane & 7) + (lane & 8),
                                                    16 * dc + ((lane >> 4) << 3)));
        x2::mma_bf16(dqa[i][0], a, kb);
        x2::mma_bf16(dqa[i][1], a, kb + 2);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kDqUnits; ++i) {
    const int unit = warp + kWarps * i;
    if (unit >= NR * kDqUnits) continue;
    const int rt = unit / kDqUnits, dc = unit % kDqUnits;
    bf16* qrow = dq + q_base + static_cast<long long>(16 * rt + gr) * HD + 16 * dc;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int d = 8 * n + 2 * t;
      if (16 * rt + gr < Sq)
        *reinterpret_cast<unsigned*>(qrow + d) =
            x2::pack_bf16(dqa[i][n][0] * scale, dqa[i][n][1] * scale);
      if (16 * rt + gr + 8 < Sq)
        *reinterpret_cast<unsigned*>(qrow + 8LL * HD + d) =
            x2::pack_bf16(dqa[i][n][2] * scale, dqa[i][n][3] * scale);
    }
  }
}

template <int D, bool kDm>
cudaError_t launch_tiled(const void* q, const void* k, const void* v, const void* probs,
                         const void* dmask, int dmask_kind, const void* g, const void* out,
                         void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H, float scale,
                         cudaStream_t stream) {
  const size_t smem = tiled_instance_smem_bytes(Sq, D, kDm ? dmask_kind : 0);
  auto kernel = bwd_tiled_kernel<D, kDm>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // as much of the SM's 228 KB as shared memory as it takes: 3 blocks at Sq = 40, D = 64
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(probs), dmask, dmask_kind, static_cast<const bf16*>(g),
      static_cast<const bf16*>(out), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Skv, H, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* probs,
                     const void* dmask, int dmask_kind, const void* g, const void* out, void* dq,
                     void* dk, void* dv, int B, int Sq, int Skv, int H, float scale,
                     cudaStream_t st) {
  if (x2::tiny_walk(Sq, Skv, D) == x2::kWalkTiled) {
    return dmask == nullptr ? launch_tiled<D, false>(q, k, v, probs, dmask, dmask_kind, g, out, dq,
                                                     dk, dv, B, Sq, Skv, H, scale, st)
                            : launch_tiled<D, true>(q, k, v, probs, dmask, dmask_kind, g, out, dq,
                                                    dk, dv, B, Sq, Skv, H, scale, st);
  }
  if constexpr (D <= 64) {  // registers: the multipliers beside g and dQ
    if (dmask != nullptr && dmask_kind == x2::kOperandBF16 &&
        x2::round_up16(Skv) <= 16 * kRegGroups)
      return launch<D, true>(q, k, v, probs, dmask, dmask_kind, g, dq, dk, dv, B, Sq, Skv, H,
                             scale, st);
  }
  return launch<D, false>(q, k, v, probs, dmask, dmask_kind, g, dq, dk, dv, B, Sq, Skv, H, scale,
                          st);
}

cudaError_t dispatch(const void* q, const void* k, const void* v, const void* probs,
                     const void* dmask, int dmask_kind, const void* g, const void* out, void* dq,
                     void* dk, void* dv, int B, int Sq, int Skv, int H, int D, float scale,
                     cudaStream_t st) {
  switch (D) {
#define X2_TINY_BWD_CASE(DD)                                                                   \
  case DD:                                                                                     \
    return launch_d<DD>(q, k, v, probs, dmask, dmask_kind, g, out, dq, dk, dv, B, Sq, Skv, H, \
                        scale, st);
    X2_TINY_BWD_CASE(16)
    X2_TINY_BWD_CASE(32)
    X2_TINY_BWD_CASE(48)
    X2_TINY_BWD_CASE(64)
    X2_TINY_BWD_CASE(80)
    X2_TINY_BWD_CASE(96)
    X2_TINY_BWD_CASE(112)
    X2_TINY_BWD_CASE(128)
#undef X2_TINY_BWD_CASE
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
// keeps the same formulas for its dispatch rule and refuses larger shapes
// before launch.
extern "C" long long x2_tiny_attention_bwd_smem_bytes(int Sq, int Skv, int D, int route) {
  return static_cast<long long>(route == x2::kRouteTensorCore ? tc::smem_bytes(Sq, Skv, D)
                                                              : smem_bytes(Sq, Skv, D));
}

// The walk (x2::TinyWalk) both kernels take at (Sq, Skv, D).
extern "C" int x2_tiny_attention_walk(int Sq, int Skv, int D) { return x2::tiny_walk(Sq, Skv, D); }

// Shared memory (bytes) one block of the key-tiled walk on `route` needs;
// it does not depend on Skv (ops/tiny_attention.py `tiled_bwd_smem_bytes`).
extern "C" long long x2_tiny_attention_bwd_tiled_smem_bytes(int Sq, int D, int route) {
  return static_cast<long long>(route == x2::kRouteTensorCore ? tc::tiled_smem_bytes(Sq, D)
                                                              : tiled_smem_bytes(Sq, D));
}

// q, g, dq: (B, Sq, H*D); k, v, dk, dv: (B, Skv, H*D); all contiguous, dtype
// `dtype` (x2::DType); on the tensor-core route every operand 16-byte
// aligned. probs: (B, Sq, H*Skv) f32, the forward's pre-dropout
// probabilities. dmask: null or (B, Sq, H*Skv), f32 or bf16 per dmask_kind
// (x2::OperandKind). out: the forward's output (B, Sq, H*D), from which the
// key-tiled tensor-core kernel takes its row sums (rowsum(g * out)); the
// others ignore it. `scale` is the forward's (already rounded to the
// dtype). Returns cudaGetLastError() after the launch.
extern "C" int x2_tiny_attention_bwd(const void* q, const void* k, const void* v,
                                     const void* probs, const void* dmask, int dmask_kind,
                                     const void* g, const void* out, void* dq, void* dk,
                                     void* dv, int B, int Sq, int Skv, int H, int D, int dtype,
                                     float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || D <= 0 || D > 32 * kMaxDPerLane)
    return cudaErrorInvalidValue;
  if (dmask != nullptr && dmask_kind != x2::kOperandF32 && dmask_kind != x2::kOperandBF16)
    return cudaErrorInvalidValue;
  const bool tiled = x2::tiny_walk(Sq, Skv, D) == x2::kWalkTiled;
  if (tiled && (Sq > x2::kTinyTiledMaxSq || D > x2::kTinyTiledMaxD)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x2::tiny_route(dtype, D) == x2::kRouteTensorCore)
    return static_cast<int>(tc::dispatch(q, k, v, probs, dmask, dmask_kind, g, out, dq, dk, dv,
                                         B, Sq, Skv, H, D, scale, st));
  if (tiled && dtype == x2::kF32)
    return static_cast<int>(launch_tiled<float>(q, k, v, probs, dmask, dmask_kind, g, dq, dk, dv,
                                                B, Sq, Skv, H, D, scale, st));
  if (tiled && dtype == x2::kBF16)
    return static_cast<int>(launch_tiled<__nv_bfloat16>(q, k, v, probs, dmask, dmask_kind, g, dq,
                                                        dk, dv, B, Sq, Skv, H, D, scale, st));
  if (dtype == x2::kF32)
    return static_cast<int>(launch<float>(q, k, v, probs, dmask, dmask_kind, g, dq, dk, dv, B,
                                          Sq, Skv, H, D, scale, st));
  if (dtype == x2::kBF16)
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, probs, dmask, dmask_kind, g, dq, dk,
                                                  dv, B, Sq, Skv, H, D, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
