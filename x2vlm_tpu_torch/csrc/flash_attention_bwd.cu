// Flash attention backward for Hopper (sm_90a): dQ, dK/dV and dBias of
// softmax(scale * q.k^T + bias, masked) . v over (B, H, S, D) tensors, with
// the probabilities recomputed tile by tile from the forward's per-row
// log-sum-exp, so no (Sq, Skv) array is ever written to device memory
// (except dBias itself, which is an output).
//
// Replaces: x2vlm_tpu/ops/flash_attention.py `_dq_kernel` (K2), `_dkv_kernel`
// (K3) and `_dbias_kernel` (K4), launched by `_flash_backward` through
// `pl.pallas_call`. Same contract as the forward in flash_attention_fwd.cu:
// an optional additive bias read through strides (0 on a broadcast dim),
// an optional key mask (B, Skv), causal masking (key c visible to query r
// iff c <= r + Skv - Sq), Sq != Skv. Inputs: q, k, v, dO in the element type
// T; lse (B, H, Sq) and delta = rowsum(dO * O) (B, H, Sq) in fp32 (delta is
// computed by the caller, as the JAX package computes it outside its
// kernels). With P = exp(S - lse) and dS = P * (dO.V^T - delta):
//   dQ = scale * dS.K,   dK = scale * dS^T.q,   dV = P^T.dO,
//   dBias = dS, summed over the batch rows that share a bias row.
//
// Masked logits (deviation from the TPU kernel): a logit hidden by the key
// mask or by causality is a constant in the plain / XLA formulation, so its
// dS is 0 here, including on a row whose every key is hidden (the Pallas
// `_dq_kernel` gives such a row dS = (1/n)(dP - delta)). Such a row averages
// V in the forward (every logit is -1e30), so its P is 1/Skv for every key:
// fp32 cannot recover that from lse = -1e30 + log(Skv) = -1e30, so a row
// whose lse is below -1e29 takes P = 1/Skv explicitly.
//
// What bounds it on the H100: at the main path's shape (BEiT-2 base, B=32,
// H=12, S=197, D=64, bias (1,12,197,197) bf16) each kernel moves 40-60 MB
// (q/k/v/dO/lse/delta in, its gradients out) against 4-8 GFLOP, so at the
// tensor-core rate each would be memory-bound (~0.012-0.018 ms at
// 3.35 TB/s). This first version computes in fp32 on the CUDA cores, like
// the forward, so FMA issue and shared-memory bandwidth set its time.
//
// Design. 256 threads as 16 x 16 (ty, tx); a tile pair of BQ query rows x
// BKV keys (64 x 64 for D <= 128, 32 x 32 above, so shared memory fits).
// In every kernel a thread computes S and dP = dO.V^T for rows ty + 16 i and
// keys tx + 16 j from tiles in shared memory (row stride D+1 floats: the 16
// lanes that read 16 different rows hit 16 different banks), then P and dS
// in registers.
// - dQ (K2): one block per (b, h, query tile), a loop over key tiles; dS
//   goes through shared memory and each thread accumulates 1/16 of its rows'
//   dQ columns in registers. The loop inside the block replaces the TPU
//   grid's sequential KV dimension.
// - dK/dV (K3): one block per (b, h, key tile), a loop over query tiles; P^T
//   and dS^T go through shared memory; each thread accumulates dK and dV of
//   its keys' columns.
// - dBias (K4): the (1, H, Sq, Skv) rel-pos bias is shared by every batch
//   row, so dBias is a sum over the batch, a reduction across what would be
//   separate blocks. It is made deterministic without atomics: one block per
//   (query tile, key tile, h) loops over the batch rows and writes its tile
//   once (fp32; the caller sums heads for a head-broadcast bias and casts).
//   A per-batch bias gets one block per (tile, tile, h, b).
// Keys past Skv are not keys (P = 0); rows past Sq are computed and dropped.
// No causal tile skipping: a fully hidden row still feeds dV.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kDeadLse = -1e29f;  // lse of a row with no visible key

template <int D>
struct Tile {
  static constexpr int BQ = D <= 128 ? 64 : 32;   // query rows per tile
  static constexpr int BKV = BQ;                   // keys per tile
  static constexpr int RI = BQ / 16;               // rows per thread
  static constexpr int CJ = BKV / 16;              // keys per thread
  static constexpr int ND = D / 16;                // head-dim columns per thread
  static constexpr int LD = D + 1;                 // row stride of a tile (floats)
};

// What the three kernels share: the operands, the masking rules and the
// recomputation of P and dS for one (row, key).
template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;
  const float* delta;
  const void* bias;
  int bias_kind;
  long long bias_sb, bias_sh, bias_sq;
  const uint8_t* key_mask;
  int H, Sq, Skv, causal;
  float scale;

  // P and dS of query row qr and key kc, from s = q.k and dp = dO.v.
  __device__ __forceinline__ void p_ds(int b, int h, int qr, int kc, float s, float dp,
                                       float lse_r, float delta_r, float& p,
                                       float& ds) const {
    if (qr >= Sq || kc >= Skv) {  // past the ragged edge
      p = 0.f;
      ds = 0.f;
      return;
    }
    bool visible = true;
    if (key_mask != nullptr && key_mask[static_cast<long long>(b) * Skv + kc] == 0)
      visible = false;
    if (causal && kc > qr + Skv - Sq) visible = false;
    if (lse_r < kDeadLse) {  // no visible key: the forward averaged V
      p = 1.f / static_cast<float>(Skv);
      ds = 0.f;
      return;
    }
    if (!visible) {
      p = 0.f;
      ds = 0.f;
      return;
    }
    float x = s * scale;
    if (bias != nullptr)
      x += x2::load_operand(bias, bias_kind, b * bias_sb + h * bias_sh + qr * bias_sq + kc);
    p = expf(x - lse_r);
    ds = p * (dp - delta_r);
  }
};

// Copy rows [row0, row0 + ROWS) of a (.., nrows, D) slab into a tile with
// row stride LD, zero-filling rows past nrows.
template <int ROWS, int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int nrows) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int gr = row0 + r;
    dst[r * LD + d] = gr < nrows ? x2::to_f(src[static_cast<long long>(gr) * D + d]) : 0.f;
  }
}

// s[i][j] = Q[ty+16i] . K[tx+16j] and dp[i][j] = dO[ty+16i] . V[tx+16j].
template <int D>
__device__ __forceinline__ void s_dp(const float* Qs, const float* dOs, const float* Ks,
                                     const float* Vs, int ty, int tx,
                                     float (&s)[Tile<D>::RI][Tile<D>::CJ],
                                     float (&dp)[Tile<D>::RI][Tile<D>::CJ]) {
  using TL = Tile<D>;
  constexpr int LD = TL::LD;
#pragma unroll
  for (int i = 0; i < TL::RI; ++i)
#pragma unroll
    for (int j = 0; j < TL::CJ; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[TL::RI], ov[TL::RI], kv[TL::CJ], vv[TL::CJ];
#pragma unroll
    for (int i = 0; i < TL::RI; ++i) {
      qv[i] = Qs[(ty + 16 * i) * LD + d];
      ov[i] = dOs[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < TL::CJ; ++j) {
      kv[j] = Ks[(tx + 16 * j) * LD + d];
      vv[j] = Vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < TL::RI; ++i)
#pragma unroll
      for (int j = 0; j < TL::CJ; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

template <int D>
constexpr size_t dq_smem() {
  using TL = Tile<D>;
  return sizeof(float) * static_cast<size_t>(2 * TL::BQ * TL::LD + 2 * TL::BKV * TL::LD +
                                             TL::BQ * (TL::BKV + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args<T> a, T* __restrict__ dq) {
  using TL = Tile<D>;
  constexpr int LD = TL::LD, LS = TL::BKV + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + TL::BQ * LD;
  float* Ks = dOs + TL::BQ * LD;
  float* Vs = Ks + TL::BKV * LD;
  float* dSs = Vs + TL::BKV * LD;  // BQ x LS

  const int q0 = blockIdx.x * TL::BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long bh = static_cast<long long>(b) * a.H + h;
  load_tile<TL::BQ, D>(Qs, a.q + bh * a.Sq * D, q0, a.Sq);
  load_tile<TL::BQ, D>(dOs, a.dout + bh * a.Sq * D, q0, a.Sq);
  float lse_r[TL::RI], delta_r[TL::RI];
#pragma unroll
  for (int i = 0; i < TL::RI; ++i) {
    const int qr = q0 + ty + 16 * i;
    lse_r[i] = qr < a.Sq ? a.lse[bh * a.Sq + qr] : 0.f;
    delta_r[i] = qr < a.Sq ? a.delta[bh * a.Sq + qr] : 0.f;
  }
  float acc[TL::RI][TL::ND];
#pragma unroll
  for (int i = 0; i < TL::RI; ++i)
#pragma unroll
    for (int j = 0; j < TL::ND; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < a.Skv; c0 += TL::BKV) {
    __syncthreads();  // the previous tile's K/V/dS are no longer read
    load_tile<TL::BKV, D>(Ks, a.k + bh * a.Skv * D, c0, a.Skv);
    load_tile<TL::BKV, D>(Vs, a.v + bh * a.Skv * D, c0, a.Skv);
    __syncthreads();
    float s[TL::RI][TL::CJ], dp[TL::RI][TL::CJ];
    s_dp<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < TL::RI; ++i)
#pragma unroll
      for (int j = 0; j < TL::CJ; ++j) {
        float p, ds;
        a.p_ds(b, h, q0 + ty + 16 * i, c0 + tx + 16 * j, s[i][j], dp[i][j], lse_r[i],
               delta_r[i], p, ds);
        dSs[(ty + 16 * i) * LS + tx + 16 * j] = ds;
      }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < TL::BKV; ++c) {
      float dsv[TL::RI], kv[TL::ND];
#pragma unroll
      for (int i = 0; i < TL::RI; ++i) dsv[i] = dSs[(ty + 16 * i) * LS + c];
#pragma unroll
      for (int j = 0; j < TL::ND; ++j) kv[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TL::RI; ++i)
#pragma unroll
        for (int j = 0; j < TL::ND; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < TL::RI; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr < a.Sq) {
      T* out = dq + (bh * a.Sq + qr) * D;
#pragma unroll
      for (int j = 0; j < TL::ND; ++j) out[tx + 16 * j] = x2::from_f<T>(acc[i][j] * a.scale);
    }
  }
}

template <int D>
constexpr size_t dkv_smem() {
  using TL = Tile<D>;
  return sizeof(float) * static_cast<size_t>(2 * TL::BQ * TL::LD + 2 * TL::BKV * TL::LD +
                                             2 * TL::BKV * (TL::BQ + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(Args<T> a, T* __restrict__ dk, T* __restrict__ dv) {
  using TL = Tile<D>;
  constexpr int LD = TL::LD, LP = TL::BQ + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + TL::BQ * LD;
  float* Ks = dOs + TL::BQ * LD;
  float* Vs = Ks + TL::BKV * LD;
  float* Pt = Vs + TL::BKV * LD;   // BKV x LP: P^T of the current tile pair
  float* dSt = Pt + TL::BKV * LP;  // BKV x LP: dS^T

  const int c0 = blockIdx.x * TL::BKV;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long bh = static_cast<long long>(b) * a.H + h;
  load_tile<TL::BKV, D>(Ks, a.k + bh * a.Skv * D, c0, a.Skv);
  load_tile<TL::BKV, D>(Vs, a.v + bh * a.Skv * D, c0, a.Skv);
  // this thread's keys are c0 + ty + 16 i (KI of them) in the accumulation
  constexpr int KI = TL::BKV / 16;
  float dk_acc[KI][TL::ND], dv_acc[KI][TL::ND];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int j = 0; j < TL::ND; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  for (int q0 = 0; q0 < a.Sq; q0 += TL::BQ) {
    __syncthreads();  // the previous tile's Q/dO/P/dS are no longer read
    load_tile<TL::BQ, D>(Qs, a.q + bh * a.Sq * D, q0, a.Sq);
    load_tile<TL::BQ, D>(dOs, a.dout + bh * a.Sq * D, q0, a.Sq);
    __syncthreads();
    float s[TL::RI][TL::CJ], dp[TL::RI][TL::CJ];
    s_dp<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < TL::RI; ++i) {
      const int r = ty + 16 * i;
      const int qr = q0 + r;
      const float lse_r = qr < a.Sq ? a.lse[bh * a.Sq + qr] : 0.f;
      const float delta_r = qr < a.Sq ? a.delta[bh * a.Sq + qr] : 0.f;
#pragma unroll
      for (int j = 0; j < TL::CJ; ++j) {
        const int c = tx + 16 * j;
        float p, ds;
        a.p_ds(b, h, qr, c0 + c, s[i][j], dp[i][j], lse_r, delta_r, p, ds);
        Pt[c * LP + r] = p;
        dSt[c * LP + r] = ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < TL::BQ; ++r) {
      float pv[KI], dsv[KI], ov[TL::ND], qv[TL::ND];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        pv[i] = Pt[(ty + 16 * i) * LP + r];
        dsv[i] = dSt[(ty + 16 * i) * LP + r];
      }
#pragma unroll
      for (int j = 0; j < TL::ND; ++j) {
        ov[j] = dOs[r * LD + tx + 16 * j];
        qv[j] = Qs[r * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int j = 0; j < TL::ND; ++j) {
          dv_acc[i][j] = fmaf(pv[i], ov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int kc = c0 + ty + 16 * i;
    if (kc < a.Skv) {
      T* kout = dk + (bh * a.Skv + kc) * D;
      T* vout = dv + (bh * a.Skv + kc) * D;
#pragma unroll
      for (int j = 0; j < TL::ND; ++j) {
        kout[tx + 16 * j] = x2::from_f<T>(dk_acc[i][j] * a.scale);
        vout[tx + 16 * j] = x2::from_f<T>(dv_acc[i][j]);
      }
    }
  }
}

template <int D>
constexpr size_t dbias_smem() {
  using TL = Tile<D>;
  return sizeof(float) * static_cast<size_t>(2 * TL::BQ * TL::LD + 2 * TL::BKV * TL::LD);
}

// grid (query tiles, key tiles, H * Bb); block (qt, kt, h + H * bb) sums dS
// of its tile over batch rows [bb * nb, (bb + 1) * nb), nb = B / Bb.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dbias_kernel(Args<T> a, float* __restrict__ dbias, int nb) {
  using TL = Tile<D>;
  constexpr int LD = TL::LD;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + TL::BQ * LD;
  float* Ks = dOs + TL::BQ * LD;
  float* Vs = Ks + TL::BKV * LD;

  const int q0 = blockIdx.x * TL::BQ;
  const int c0 = blockIdx.y * TL::BKV;
  const int h = blockIdx.z % a.H;
  const int bb = blockIdx.z / a.H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[TL::RI][TL::CJ];
#pragma unroll
  for (int i = 0; i < TL::RI; ++i)
#pragma unroll
    for (int j = 0; j < TL::CJ; ++j) acc[i][j] = 0.f;

  for (int b = bb * nb; b < (bb + 1) * nb; ++b) {
    const long long bh = static_cast<long long>(b) * a.H + h;
    __syncthreads();  // the previous batch row's tiles are no longer read
    load_tile<TL::BQ, D>(Qs, a.q + bh * a.Sq * D, q0, a.Sq);
    load_tile<TL::BQ, D>(dOs, a.dout + bh * a.Sq * D, q0, a.Sq);
    load_tile<TL::BKV, D>(Ks, a.k + bh * a.Skv * D, c0, a.Skv);
    load_tile<TL::BKV, D>(Vs, a.v + bh * a.Skv * D, c0, a.Skv);
    __syncthreads();
    float s[TL::RI][TL::CJ], dp[TL::RI][TL::CJ];
    s_dp<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < TL::RI; ++i) {
      const int qr = q0 + ty + 16 * i;
      const float lse_r = qr < a.Sq ? a.lse[bh * a.Sq + qr] : 0.f;
      const float delta_r = qr < a.Sq ? a.delta[bh * a.Sq + qr] : 0.f;
#pragma unroll
      for (int j = 0; j < TL::CJ; ++j) {
        float p, ds;
        a.p_ds(b, h, qr, c0 + tx + 16 * j, s[i][j], dp[i][j], lse_r, delta_r, p, ds);
        acc[i][j] += ds;
      }
    }
  }
  const long long base = (static_cast<long long>(bb) * a.H + h) * a.Sq;
#pragma unroll
  for (int i = 0; i < TL::RI; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < TL::CJ; ++j) {
      const int kc = c0 + tx + 16 * j;
      if (kc < a.Skv) dbias[(base + qr) * a.Skv + kc] = acc[i][j];
    }
  }
}

enum Which { kDQ = 0, kDKV = 1, kDBias = 2 };

template <typename T, int D>
cudaError_t launch(int which, const Args<T>& a, int B, void* out0, void* out1, int bias_b,
                   cudaStream_t stream) {
  using TL = Tile<D>;
  const int nq = (a.Sq + TL::BQ - 1) / TL::BQ;
  const int nk = (a.Skv + TL::BKV - 1) / TL::BKV;
  cudaError_t err;
  if (which == kDQ) {
    constexpr size_t smem = dq_smem<D>();
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<T, D><<<dim3(nq, a.H, B), kThreads, smem, stream>>>(
        a, static_cast<T*>(out0));
  } else if (which == kDKV) {
    constexpr size_t smem = dkv_smem<D>();
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<T, D><<<dim3(nk, a.H, B), kThreads, smem, stream>>>(
        a, static_cast<T*>(out0), static_cast<T*>(out1));
  } else {
    if (bias_b != 1 && bias_b != B) return cudaErrorInvalidValue;
    constexpr size_t smem = dbias_smem<D>();
    err = cudaFuncSetAttribute(flash_bwd_dbias_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_bwd_dbias_kernel<T, D><<<dim3(nq, nk, a.H * bias_b), kThreads, smem, stream>>>(
        a, static_cast<float*>(out0), B / bias_b);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int which, const void* q, const void* k, const void* v,
                     const void* bias, int bias_kind, long long sb, long long sh, long long sq,
                     const void* key_mask, const void* dout, const void* lse,
                     const void* delta, void* out0, void* out1, int bias_b, int B, int H,
                     int Sq, int Skv, int D, int causal, float scale, cudaStream_t stream) {
  Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
            static_cast<const T*>(dout), static_cast<const float*>(lse),
            static_cast<const float*>(delta), bias, bias_kind, sb, sh, sq,
            static_cast<const uint8_t*>(key_mask), H, Sq, Skv, causal, scale};
  switch (D) {
    case 64: return launch<T, 64>(which, a, B, out0, out1, bias_b, stream);
    case 128: return launch<T, 128>(which, a, B, out0, out1, bias_b, stream);
    case 192: return launch<T, 192>(which, a, B, out0, out1, bias_b, stream);
    case 256: return launch<T, 256>(which, a, B, out0, out1, bias_b, stream);
    default: return cudaErrorInvalidValue;
  }
}

int entry(int which, const void* q, const void* k, const void* v, const void* bias,
          int bias_kind, long long sb, long long sh, long long sq, const void* key_mask,
          const void* dout, const void* lse, const void* delta, void* out0, void* out1,
          int bias_b, int B, int H, int Sq, int Skv, int D, int dtype, int causal, float scale,
          void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0) return cudaErrorInvalidValue;
  if (bias != nullptr && bias_kind != x2::kOperandF32 && bias_kind != x2::kOperandBF16)
    return cudaErrorInvalidValue;
  if (which == kDBias && bias == nullptr) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == x2::kF32)
    return static_cast<int>(dispatch<float>(which, q, k, v, bias, bias_kind, sb, sh, sq,
                                            key_mask, dout, lse, delta, out0, out1, bias_b, B,
                                            H, Sq, Skv, D, causal, scale, st));
  if (dtype == x2::kBF16)
    return static_cast<int>(dispatch<__nv_bfloat16>(which, q, k, v, bias, bias_kind, sb, sh,
                                                    sq, key_mask, dout, lse, delta, out0, out1,
                                                    bias_b, B, H, Sq, Skv, D, causal, scale,
                                                    st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, dout, dq: (B, H, Sq, D); k, v, dk, dv: (B, H, Skv, D); all contiguous,
// dtype `dtype` (x2::DType). lse, delta: (B, H, Sq) f32. bias: null or
// (.., Sq, Skv) with unit stride on the last dim and element strides
// sb / sh / sq (0 where the dim broadcasts), f32 or bf16 per bias_kind.
// key_mask: null or (B, Skv) uint8, 0 = masked. dbias: (bias_b, H, Sq, Skv)
// f32, bias_b = 1 (summed over the batch) or B. Each entry returns
// cudaGetLastError() after its launch.
extern "C" int x2_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                         const void* bias, int bias_kind, long long sb,
                                         long long sh, long long sq, const void* key_mask,
                                         const void* dout, const void* lse, const void* delta,
                                         void* dq, int B, int H, int Sq, int Skv, int D,
                                         int dtype, int causal, float scale, void* stream) {
  return entry(kDQ, q, k, v, bias, bias_kind, sb, sh, sq, key_mask, dout, lse, delta, dq,
               nullptr, 1, B, H, Sq, Skv, D, dtype, causal, scale, stream);
}

extern "C" int x2_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                          const void* bias, int bias_kind, long long sb,
                                          long long sh, long long sq, const void* key_mask,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dk, void* dv, int B, int H, int Sq, int Skv,
                                          int D, int dtype, int causal, float scale,
                                          void* stream) {
  return entry(kDKV, q, k, v, bias, bias_kind, sb, sh, sq, key_mask, dout, lse, delta, dk, dv,
               1, B, H, Sq, Skv, D, dtype, causal, scale, stream);
}

extern "C" int x2_flash_attention_bwd_dbias(const void* q, const void* k, const void* v,
                                            const void* bias, int bias_kind, long long sb,
                                            long long sh, long long sq, const void* key_mask,
                                            const void* dout, const void* lse,
                                            const void* delta, void* dbias, int bias_b, int B,
                                            int H, int Sq, int Skv, int D, int dtype,
                                            int causal, float scale, void* stream) {
  return entry(kDBias, q, k, v, bias, bias_kind, sb, sh, sq, key_mask, dout, lse, delta,
               dbias, nullptr, bias_b, B, H, Sq, Skv, D, dtype, causal, scale, stream);
}
