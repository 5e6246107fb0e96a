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
// probabilities, the bf16 multiplier and five (B, S, H*D) tensors: ~255 MB
// at 40x200 for ~4 GFLOP, so it is memory-bound (~0.076 ms at 3.35 TB/s).
// This first version computes in fp32 on the CUDA cores.
//
// Design: one block of 512 threads per (head h, batch row b), as the
// forward, so each K/V/P byte is read from device memory once; its shared
// memory fills an SM at 40x200, so the block brings 16 warps to hide the
// latency of its loads. Two phases:
// 1. that head's K and V (Skv x D, row stride D+1 floats) in shared memory;
//    each warp takes four query rows at a time: lanes over keys for dP and
//    the softmax backward (warp shuffles for the row sums), lanes over the
//    head dim for dQ; each row's dL and Pu = P * dm stay in shared memory
//    (Sq x Skv fp32 each);
// 2. K/V's space is reused for g and Qs (Sq x D each); each warp takes four
//    keys at a time, lanes over the head dim, and sums dV and dK over the
//    query rows from shared memory only.
// Carrying four rows (keys) per warp reuses each K/V (g/Qs) element loaded
// from shared memory four times: the loops are bound by shared-memory load
// issue, not by FMAs.
// The block-diagonal K/V scratch of the TPU kernel (it cut MXU dispatches)
// is not carried over. Shared memory bounds the shapes: ops/tiny_attention.py
// admits a shape only when both the forward and this kernel fit.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;  // 16 warps: one block fills an SM's shared memory
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDPerLane = 8;  // head dims up to 256
constexpr int kRows = 4;         // query rows a warp carries at once (phase 1)
constexpr int kKeys = 4;         // keys a warp carries at once (phase 2)

size_t smem_bytes(int Sq, int Skv, int D) {
  const size_t kv = static_cast<size_t>(Skv) * 2 * (D + 1);
  const size_t gq = static_cast<size_t>(Sq) * 2 * D;
  return sizeof(float) * ((kv > gq ? kv : gq) + 2 * static_cast<size_t>(Sq) * Skv +
                          static_cast<size_t>(kWarps) * kRows * D);
}

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

}  // namespace

// Shared memory (bytes) one block needs; ops/tiny_attention.py keeps the
// same formula for its dispatch rule and refuses larger shapes before launch.
extern "C" long long x2_tiny_attention_bwd_smem_bytes(int Sq, int Skv, int D) {
  return static_cast<long long>(smem_bytes(Sq, Skv, D));
}

// q, g, dq: (B, Sq, H*D); k, v, dk, dv: (B, Skv, H*D); all contiguous, dtype
// `dtype` (x2::DType). probs: (B, Sq, H*Skv) f32, the forward's pre-dropout
// probabilities. dmask: null or (B, Sq, H*Skv), f32 or bf16 per dmask_kind
// (x2::OperandKind). `scale` is the forward's (already rounded to the
// dtype). Returns cudaGetLastError() after the launch.
extern "C" int x2_tiny_attention_bwd(const void* q, const void* k, const void* v,
                                     const void* probs, const void* dmask, int dmask_kind,
                                     const void* g, void* dq, void* dk, void* dv, int B,
                                     int Sq, int Skv, int H, int D, int dtype, float scale,
                                     void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || D <= 0 || D > 32 * kMaxDPerLane)
    return cudaErrorInvalidValue;
  if (dmask != nullptr && dmask_kind != x2::kOperandF32 && dmask_kind != x2::kOperandBF16)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == x2::kF32)
    return static_cast<int>(launch<float>(q, k, v, probs, dmask, dmask_kind, g, dq, dk, dv, B,
                                          Sq, Skv, H, D, scale, st));
  if (dtype == x2::kBF16)
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, probs, dmask, dmask_kind, g, dq, dk,
                                                  dv, B, Sq, Skv, H, D, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
