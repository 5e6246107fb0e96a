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
// Rounding: P and dS are rounded to the element type before their products
// (dV = P^T.dO, dQ / dK from dS), with fp32 sums, as the plain version
// (ops/flash_attention.py `flash_attention_bwd_reference`) casts them.
//
// What bounds it on the H100: at the main path's shape (BEiT-2 base, B=32,
// H=12, S=197, D=64, bias (1,12,197,197) bf16) dQ moves ~50 MB (q/k/v/dO,
// lse, delta and the bias in, dQ out; bound 0.0149 ms at 3.35 TB/s) and
// dK/dV ~60 MB (0.0178 ms) against 5.7 and 7.6 GFLOP of bf16 products
// (0.0058 and 0.0077 ms at 989 TFLOP/s): with the products on the tensor
// cores both are bound by bytes. What keeps the tensor-core kernels at 3.5
// and 4x their bound is mostly mma and staging latency: with P and dS cut
// to one multiply they took dQ 0.0445 and dK/dV 0.0545 ms against 0.0525
// and 0.0709 (tools/flash_bwd_variants.py, no_elementwise; H100).
//
// Two routes for dQ and dK/dV, chosen by x2::flash_bwd_route
// (ops/flash_attention.py `flash_bwd_route`); a dispatch, not a fallback:
//
// - Tensor cores (bf16, D = 64; the main path), namespace tc. Blocks of 4
//   warps, each warp owning 16 rows of a 64-row tile, so a tile past the
//   ragged edge costs at most one 16-row step per warp (S=197 pads to 208,
//   not 256). bf16 tiles come in by 16-byte cp.async into XOR-swizzled
//   x2::TileLayout rows (conflict-free ldmatrix), rows past the edge
//   zero-filled to the 16-row step. Products are mma.sync m16n8k16 (bf16
//   in, fp32 sums), B fragments from ldmatrix (.trans where the operand's
//   rows are the k dimension). P and dS never leave registers: computed in
//   the mma C layout, rounded and packed to bf16 A fragments (a 16 x 16 C
//   pair is an A fragment as it stands), with P = 2^((S scale + bias) log2e
//   - lse log2e) in one MUFU instruction. The bias comes with the walked
//   tiles as a 64 x 64 tile, by 16-byte copies from the aligned chunk that
//   holds each row's first key (the main path's bf16 rows are 394 bytes,
//   so a row starts anywhere in a chunk); the main path's (1, H, S, S) bias
//   is 0.93 MB and is read from L2 by every batch row. Read per element
//   from device memory instead, it cost dQ 0.0625 against 0.0525 ms and
//   dK/dV 0.078 against 0.071 at the main shape on an H100
//   (tools/flash_bwd_variants.py, bias_per_element). Each kernel has an
//   instance per bias kind (none, fp32, bf16) and with or without masking
//   (a key mask or causal), so the main path tests neither per element:
//   tested at run time in every instance, they cost dQ 0.0636 against
//   0.0534 ms and dK/dV 0.074 against 0.0725 (mask_runtime). 3 blocks of 4
//   warps share an SM (at most 170 registers a thread, ~67 KB of shared
//   memory a block with a bf16 bias).
//   - dQ (K2): one block per (b, h, 64-query tile). Q and dO are staged once
//     and held as A fragments; the keys come in 64-key tiles of K and V,
//     double-buffered (the next tile's copies fly while this one computes).
//     Per 16-key group: S = Q.K^T, dP = dO.V^T, dS = P (dP - delta), dQ +=
//     dS.K. dQ * scale leaves through the warp's own Q rows as 16-byte rows.
//   - dK/dV (K3): one block per (b, h, 64-key tile), K and V held as A
//     fragments; Q, dO, lse and delta come in 64-query tiles,
//     double-buffered. Per 16-query group: S^T = K.Q^T and dP^T = V.dO^T,
//     so P^T and dS^T come out in the A layout of dV += P^T.dO and dK +=
//     dS^T.Q. dK * scale and dV leave through the warp's own K / V rows.
// - CUDA cores (fp32 at any D, bf16 at D 128, 192, 256): the first design,
//   in fp32, so FMA issue and shared-memory bandwidth set its time. 256
//   threads as 16 x 16 (ty, tx); a tile pair of BQ query rows x BKV keys (64
//   x 64 for D <= 128, 32 x 32 above, so shared memory fits). A thread
//   computes S and dP = dO.V^T for rows ty + 16 i and keys tx + 16 j from
//   tiles in shared memory (row stride D+1 floats: the 16 lanes that read 16
//   different rows hit 16 different banks), then P and dS in registers.
//   - dQ (K2): one block per (b, h, query tile), a loop over key tiles; dS
//     goes through shared memory and each thread accumulates 1/16 of its
//     rows' dQ columns in registers. The loop inside the block replaces the
//     TPU grid's sequential KV dimension.
//   - dK/dV (K3): one block per (b, h, key tile), a loop over query tiles;
//     P^T and dS^T go through shared memory; each thread accumulates dK and
//     dV of its keys' columns.
// - dBias (K4, CUDA cores on every route): the (1, H, Sq, Skv) rel-pos bias
//   is shared by every batch row, so dBias is a sum over the batch, a
//   reduction across what would be separate blocks. It is made deterministic
//   without atomics: one block per (query tile, key tile, h) loops over the
//   batch rows and writes its tile once (fp32; the caller sums heads for a
//   head-broadcast bias and casts). A per-batch bias gets one block per
//   (tile, tile, h, b).
// Keys past Skv are not keys (P = 0); rows past Sq have no lse, so their P
// is forced to 0 (zero-filled tiles alone would not do it) and they add
// nothing to dK / dV. No causal tile skipping: a fully hidden row still
// feeds dV.

#include <type_traits>

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

// ---------------------------------------------------------------------------
// Tensor-core route (bf16, D = 64): dQ and dK/dV
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // 4 warps, 16 rows (dQ) or keys (dK/dV) each
// blocks an SM: at most 170 registers a thread (dK/dV spills up to 40
// bytes); on an H100 at the main shape with a bf16 bias, 2 blocks (207
// registers, no spill) took dK/dV from 0.071 to 0.077 ms and 4 (128
// registers, ~300 bytes of spills) to 0.104 (tools/flash_bwd_variants.py,
// min_blocks_2 / min_blocks_4)
constexpr int kMinBlocks = 3;
constexpr int kTile = 64;  // rows of a block's own tile and of a walked tile
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
  static constexpr bool kBF16 = kBias == x2::kOperandBF16;
  static constexpr int kPerChunk = kBF16 ? 8 : 4;  // elements in 16 bytes
  static constexpr int kChunks = kBias == 0 ? 0 : kTile / kPerChunk + 1;
  static constexpr int kLW = 4 * kChunks;  // row stride (words)
  static constexpr int kStageWords = kTile * kLW;

  // the shift of the row whose key c0 is element e0
  __device__ static int shift_of(long long e0) {
    return static_cast<int>(e0 & (kPerChunk - 1));
  }
  // rows [0, nrows) of the tile are bias rows row0 + r (element base +
  // (row0 + r) sq), keys c0 .. c0 + 63; rows past nrows and chunks with no
  // key below Skv are zeros. A chunk that runs past the row's key Skv - 1
  // copies only up to it (zeros after), so no copy reads past the bias.
  __device__ static void stage(unsigned* dst, const Args<bf16>& a, long long base, int row0,
                               int nrows, int c0, int tid) {
    if constexpr (kBias != 0) {
      const char* src = static_cast<const char*>(a.bias);
      for (int i = tid; i < kTile * kChunks; i += kThreads) {
        const int r = i / kChunks, c = i - r * kChunks;
        const long long e0 = base + static_cast<long long>(row0 + r) * a.bias_sq + c0;
        const int sh = shift_of(e0);
        const int left = a.Skv - (c0 - sh + kPerChunk * c);  // keys of the row from the chunk on
        const bool ok = r < nrows && left > 0;
        x2::cp_async16(dst + r * kLW + 4 * c,
                       ok ? src + 16 * ((e0 - sh) / kPerChunk + c) : src,
                       ok ? min(16, left * (16 / kPerChunk)) : 0);
      }
    }
  }
  // the bias at row r, key c0 + j of a staged tile whose row r has `shift`
  __device__ static float at(const unsigned* tile, int r, int j, int shift) {
    if constexpr (kBF16)
      return __bfloat162float(reinterpret_cast<const bf16*>(tile + r * kLW)[j + shift]);
    else
      return reinterpret_cast<const float*>(tile + r * kLW)[j + shift];
  }
};

// Shared memory of one block: dQ holds Q and dO (one tile each) and two
// stages of K | V | the bias tile; dK/dV holds K and V and two stages of Q
// | dO | the bias tile | lse and delta (fp32).
size_t bias_words(int bias_kind) {  // of one stage
  return bias_kind == x2::kOperandBF16 ? BiasTile<x2::kOperandBF16>::kStageWords
         : bias_kind == x2::kOperandF32 ? BiasTile<x2::kOperandF32>::kStageWords
                                        : 0;
}
size_t dq_smem(int D, int bias_kind) {
  return sizeof(bf16) * (2 + 2 * 2) * kTile * x2::tile_ld(D) + 4 * 2 * bias_words(bias_kind);
}
size_t dkv_smem(int D, int bias_kind) {
  return dq_smem(D, bias_kind) + sizeof(float) * 2 * 2 * kTile;
}

// Fragment coordinates (as in tiny_attention_fwd.cu): lane = 4 g + t holds
// rows g and g + 8 of a 16-row tile. For a 16 x 16 product tile kept as two
// 16 x 8 C tiles in c[8], c[4T + 2R + e] is row g + 8R, column 8T + 2t + e,
// and the A fragment of that tile is a[i] = (c[2i], c[2i + 1]) packed.
__device__ __forceinline__ void pack_a(unsigned (&a)[4], const float (&c)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = x2::pack_bf16(c[2 * i], c[2 * i + 1]);
}

// c[8] (zeroed first) = A (16 rows, KS 16-column fragments) . B^T, B the 16
// rows of `Bs` from row n0 (B fragments by ldmatrix: B's rows are the n
// dimension).
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[8], const unsigned (&a)[D / 16][4],
                                        const bf16* Bs, int n0, int lane) {
  using L = x2::TileLayout<D>;
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = 0.f;
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
    unsigned b[4];
    x2::ldmatrix_x4(b, Bs + L::off(n0 + (lane & 7) + ((lane >> 4) << 3), 16 * s + (lane & 8)));
    x2::mma_bf16(c, a[s], b);
    x2::mma_bf16(c + 4, a[s], b + 2);
  }
}

// acc (16 x D) += A (16 x 16, one A fragment) . B, B the 16 rows of `Bs`
// from row k0 (ldmatrix.trans: B's rows are the k dimension).
template <int D>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const unsigned (&a)[4],
                                       const bf16* Bs, int k0, int lane) {
  using L = x2::TileLayout<D>;
#pragma unroll
  for (int dn = 0; dn < D; dn += 16) {
    unsigned b[4];
    x2::ldmatrix_x4_trans(b, Bs + L::off(k0 + (lane & 7) + (lane & 8), dn + ((lane >> 4) << 3)));
    x2::mma_bf16(acc[dn / 8], a, b);
    x2::mma_bf16(acc[dn / 8 + 1], a, b + 2);
  }
}

// A warp's 16 x D accumulator * mul, through its own 16 rows `Os` of a
// tile (no other warp reads them), to rows row0.. of `dst` (rows D apart)
// as 16-byte stores; rows at or past `nrows` are not written.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul, bf16* Os,
                                           bf16* dst, int row0, int nrows, int lane) {
  using L = x2::TileLayout<D>;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();  // every lane is done reading the rows
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    *reinterpret_cast<unsigned*>(Os + L::off(g, 8 * nt) + 2 * t) =
        x2::pack_bf16(acc[nt][0] * mul, acc[nt][1] * mul);
    *reinterpret_cast<unsigned*>(Os + L::off(g + 8, 8 * nt) + 2 * t) =
        x2::pack_bf16(acc[nt][2] * mul, acc[nt][3] * mul);
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

// grid (query tiles, H, B); kMask: a key mask or causal masking
template <int D, int kBias, bool kMask>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dq_kernel(Args<bf16> a, bf16* __restrict__ dq) {
  using L = x2::TileLayout<D>;
  using BT = BiasTile<kBias>;
  constexpr int KS = D / 16, NT = D / 8, kTileElems = kTile * L::kLD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kTileElems;
  bf16* KV = dOs + kTileElems;  // stage s: K at KV + 2 s kTileElems, V after it
  unsigned* Bias = reinterpret_cast<unsigned*>(KV + 4 * kTileElems);  // stage s at s kStageWords

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const int Sq = a.Sq, Skv = a.Skv;
  const int nq = min(kTile, Sq - q0);
  const long long bbase = b * a.bias_sb + h * a.bias_sh;
  const bf16* kb = a.k + bh * Skv * D;
  const bf16* vb = a.v + bh * Skv * D;
  x2::stage_rows<D>(Qs, a.q + (bh * Sq + q0) * D, nq, x2::round_up16(nq), D, tid, kThreads);
  x2::stage_rows<D>(dOs, a.dout + (bh * Sq + q0) * D, nq, x2::round_up16(nq), D, tid, kThreads);
  auto stage_kv = [&](int c0, int s) {
    const int nk = min(kTile, Skv - c0), pad = x2::round_up16(nk);
    bf16* Kd = KV + 2 * s * kTileElems;
    x2::stage_rows<D>(Kd, kb + static_cast<long long>(c0) * D, nk, pad, D, tid, kThreads);
    x2::stage_rows<D>(Kd + kTileElems, vb + static_cast<long long>(c0) * D, nk, pad, D, tid,
                      kThreads);
    BT::stage(Bias + s * BT::kStageWords, a, bbase, q0, nq, c0, tid);
  };
  stage_kv(0, 0);
  x2::cp_async_commit();

  // the lane's two rows: q0 + rr[R], rr = 16 warp + g + 8R
  const int r0 = 16 * warp;
  const bool active = r0 < nq;
  int qr[2], rr[2], shift[2];
  bool live[2];
  float lse2[2], delta[2];
#pragma unroll
  for (int R = 0; R < 2; ++R) {
    rr[R] = r0 + g + 8 * R;
    qr[R] = q0 + rr[R];
    const bool row_ok = qr[R] < Sq;
    const float lse = row_ok ? a.lse[bh * Sq + qr[R]] : 0.f;
    delta[R] = row_ok ? a.delta[bh * Sq + qr[R]] : 0.f;
    live[R] = row_ok && lse >= kDeadLse;  // a dead row's dS is 0
    lse2[R] = lse * kLog2e;
    shift[R] = BT::shift_of(bbase + qr[R] * a.bias_sq);  // + c0, a multiple of 64
  }
  const uint8_t* km = a.key_mask != nullptr ? a.key_mask + static_cast<long long>(b) * Skv : nullptr;
  const float scale2 = a.scale * kLog2e;

  unsigned qa[KS][4], da[KS][4];  // the warp's Q and dO rows as A fragments
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int ntiles = (Skv + kTile - 1) / kTile;
  for (int it = 0; it < ntiles; ++it) {
    x2::cp_async_wait_all();
    // this tile has landed (and, first, Q and dO), and every warp is done
    // with the last tile, whose stage the next one now takes
    __syncthreads();
    if (it + 1 < ntiles) {
      stage_kv((it + 1) * kTile, (it + 1) & 1);
      x2::cp_async_commit();
    }
    if (active) {
      if (it == 0) {
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          x2::ldmatrix_x4(qa[s], Qs + L::off(r0 + (lane & 15), 16 * s + ((lane >> 4) << 3)));
          x2::ldmatrix_x4(da[s], dOs + L::off(r0 + (lane & 15), 16 * s + ((lane >> 4) << 3)));
        }
      }
      const bf16* Ks = KV + 2 * (it & 1) * kTileElems;
      const bf16* Vs = Ks + kTileElems;
      const unsigned* Bt = Bias + (it & 1) * BT::kStageWords;
      const int c0 = it * kTile;
#pragma unroll
      for (int n0 = 0; n0 < kTile; n0 += 16) {
        if (c0 + n0 >= Skv) break;
        float s[8], dp[8];
        mma_abt<D>(s, qa, Ks, n0, lane);
        mma_abt<D>(dp, da, Vs, n0, lane);
#pragma unroll
        for (int T = 0; T < 2; ++T)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = n0 + 8 * T + 2 * t + e;  // key c0 + j
            const int kc = c0 + j;
            const bool kok = kc < Skv && (!kMask || km == nullptr || km[kc] != 0);
#pragma unroll
            for (int R = 0; R < 2; ++R) {
              const int i = 4 * T + 2 * R + e;
              const bool vis =
                  live[R] && kok && (!kMask || !a.causal || kc <= qr[R] + Skv - Sq);
              const float bv = kBias != 0 ? BT::at(Bt, rr[R], j, shift[R]) * kLog2e : 0.f;
              const float p = ex2(fmaf(s[i], scale2, bv) - lse2[R]);
              s[i] = vis ? p * (dp[i] - delta[R]) : 0.f;  // dS
            }
          }
        unsigned dsa[4];
        pack_a(dsa, s);
        mma_ab<D>(acc, dsa, Ks, n0, lane);
      }
    }
  }
  if (active)
    store_rows<D>(acc, a.scale, Qs + r0 * L::kLD, dq + bh * Sq * D, q0 + r0, Sq, lane);
}

// grid (key tiles, H, B); kMask: a key mask or causal masking
template <int D, int kBias, bool kMask>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dkv_kernel(Args<bf16> a, bf16* __restrict__ dk, bf16* __restrict__ dv) {
  using L = x2::TileLayout<D>;
  using BT = BiasTile<kBias>;
  constexpr int KS = D / 16, NT = D / 8, kTileElems = kTile * L::kLD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTileElems;
  bf16* QO = Vs + kTileElems;  // stage s: Q at QO + 2 s kTileElems, dO after it
  unsigned* Bias = reinterpret_cast<unsigned*>(QO + 4 * kTileElems);  // stage s at s kStageWords
  float* LDs = reinterpret_cast<float*>(Bias + 2 * BT::kStageWords);  // stage s: lse, delta at 2 s kTile

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const int Sq = a.Sq, Skv = a.Skv;
  const int nk = min(kTile, Skv - k0);
  const long long bbase = b * a.bias_sb + h * a.bias_sh;
  x2::stage_rows<D>(Ks, a.k + (bh * Skv + k0) * D, nk, x2::round_up16(nk), D, tid, kThreads);
  x2::stage_rows<D>(Vs, a.v + (bh * Skv + k0) * D, nk, x2::round_up16(nk), D, tid, kThreads);
  const bf16* qb = a.q + bh * Sq * D;
  const bf16* ob = a.dout + bh * Sq * D;
  const float* lseb = a.lse + bh * Sq;
  const float* deltab = a.delta + bh * Sq;
  auto stage_q = [&](int q0, int s) {
    const int nq = min(kTile, Sq - q0), pad = x2::round_up16(nq);
    bf16* Qd = QO + 2 * s * kTileElems;
    x2::stage_rows<D>(Qd, qb + static_cast<long long>(q0) * D, nq, pad, D, tid, kThreads);
    x2::stage_rows<D>(Qd + kTileElems, ob + static_cast<long long>(q0) * D, nq, pad, D, tid,
                      kThreads);
    BT::stage(Bias + s * BT::kStageWords, a, bbase, q0, nq, k0, tid);
    float* Ld = LDs + 2 * s * kTile;
    for (int i = tid; i < kTile; i += kThreads) {  // rows past Sq: zeros
      const bool ok = i < nq;
      x2::cp_async4(Ld + i, lseb + (ok ? q0 + i : 0), ok ? 4 : 0);
      x2::cp_async4(Ld + kTile + i, deltab + (ok ? q0 + i : 0), ok ? 4 : 0);
    }
  };
  stage_q(0, 0);
  x2::cp_async_commit();

  // the lane's two keys: k0 + kj[R], kj = 16 warp + g + 8R
  const int r0 = 16 * warp;
  const bool active = r0 < nk;
  int kc[2], kj[2];
  bool kin[2], kok[2];
#pragma unroll
  for (int R = 0; R < 2; ++R) {
    kj[R] = r0 + g + 8 * R;
    kc[R] = k0 + kj[R];
    kin[R] = kc[R] < Skv;
    kok[R] = kin[R] && (a.key_mask == nullptr ||
                        a.key_mask[static_cast<long long>(b) * Skv + kc[R]] != 0);
  }
  // the shift of bias row qr is that of bbase + qr sq + k0
  const int shift0 = BT::shift_of(bbase + k0);
  const int sq_mod = BT::shift_of(a.bias_sq);
  const float scale2 = a.scale * kLog2e;
  const float inv_skv = 1.f / static_cast<float>(Skv);

  unsigned ka[KS][4], va[KS][4];  // the warp's K and V rows as A fragments
  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int ntiles = (Sq + kTile - 1) / kTile;
  for (int it = 0; it < ntiles; ++it) {
    x2::cp_async_wait_all();
    // this tile has landed (and, first, K and V), and every warp is done
    // with the last tile, whose stage the next one now takes
    __syncthreads();
    if (it + 1 < ntiles) {
      stage_q((it + 1) * kTile, (it + 1) & 1);
      x2::cp_async_commit();
    }
    if (active) {
      if (it == 0) {
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          x2::ldmatrix_x4(ka[s], Ks + L::off(r0 + (lane & 15), 16 * s + ((lane >> 4) << 3)));
          x2::ldmatrix_x4(va[s], Vs + L::off(r0 + (lane & 15), 16 * s + ((lane >> 4) << 3)));
        }
      }
      const bf16* Qs = QO + 2 * (it & 1) * kTileElems;
      const bf16* dOs = Qs + kTileElems;
      const unsigned* Bt = Bias + (it & 1) * BT::kStageWords;
      const float* Ls = LDs + 2 * (it & 1) * kTile;
      const int q0 = it * kTile;
#pragma unroll
      for (int n0 = 0; n0 < kTile; n0 += 16) {
        if (q0 + n0 >= Sq) break;
        float s[8], dp[8];
        mma_abt<D>(s, ka, Qs, n0, lane);   // S^T: keys x queries
        mma_abt<D>(dp, va, dOs, n0, lane);  // dP^T
#pragma unroll
        for (int T = 0; T < 2; ++T) {
          const int j0 = n0 + 8 * T + 2 * t;
          const float2 lse = *reinterpret_cast<const float2*>(Ls + j0);
          const float2 delta = *reinterpret_cast<const float2*>(Ls + kTile + j0);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + e, qr = q0 + j;
            const float lse_r = e ? lse.y : lse.x, delta_r = e ? delta.y : delta.x;
            const bool row_ok = qr < Sq;
            const bool dead = row_ok && lse_r < kDeadLse;  // the forward averaged V
            const int shift = (shift0 + qr * sq_mod) & (BT::kPerChunk - 1);
#pragma unroll
            for (int R = 0; R < 2; ++R) {
              const int i = 4 * T + 2 * R + e;
              const bool vis = row_ok && !dead && kok[R] &&
                               (!kMask || !a.causal || kc[R] <= qr + Skv - Sq);
              const float bv = kBias != 0 ? BT::at(Bt, j, kj[R], shift) * kLog2e : 0.f;
              const float p = ex2(fmaf(s[i], scale2, bv) - lse_r * kLog2e);
              const float pv = vis ? p : (dead && kin[R] ? inv_skv : 0.f);
              dp[i] = vis ? p * (dp[i] - delta_r) : 0.f;  // dS^T
              s[i] = pv;                                  // P^T
            }
          }
        }
        unsigned pa[4], dsa[4];
        pack_a(pa, s);
        pack_a(dsa, dp);
        mma_ab<D>(dv_acc, pa, dOs, n0, lane);
        mma_ab<D>(dk_acc, dsa, Qs, n0, lane);
      }
    }
  }
  if (active) {
    store_rows<D>(dk_acc, a.scale, Ks + r0 * L::kLD, dk + bh * Skv * D, k0 + r0, Skv, lane);
    store_rows<D>(dv_acc, 1.f, Vs + r0 * L::kLD, dv + bh * Skv * D, k0 + r0, Skv, lane);
  }
}

template <int D, int kBias, bool kMask>
cudaError_t launch_kind(int which, const Args<bf16>& a, int B, void* out0, void* out1,
                        cudaStream_t stream) {
  const bool dq = which == kDQ;
  const size_t smem = dq ? dq_smem(D, kBias) : dkv_smem(D, kBias);
  const void* kernel = dq ? reinterpret_cast<const void*>(dq_kernel<D, kBias, kMask>)
                          : reinterpret_cast<const void*>(dkv_kernel<D, kBias, kMask>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // as much of the SM's 228 KB as shared memory as it takes: 3 blocks an SM
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int n = dq ? a.Sq : a.Skv;
  const dim3 grid((n + kTile - 1) / kTile, a.H, B);
  if (dq)
    dq_kernel<D, kBias, kMask><<<grid, kThreads, smem, stream>>>(a, static_cast<bf16*>(out0));
  else
    dkv_kernel<D, kBias, kMask><<<grid, kThreads, smem, stream>>>(
        a, static_cast<bf16*>(out0), static_cast<bf16*>(out1));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int which, const Args<bf16>& a, int B, void* out0, void* out1,
                   cudaStream_t stream) {
  // the bias tile's 16-byte copies need a 16-byte aligned bias
  if (a.bias != nullptr && reinterpret_cast<uintptr_t>(a.bias) % 16 != 0)
    return cudaErrorInvalidValue;
  const int kind = a.bias == nullptr ? 0 : a.bias_kind;
  const bool masked = a.key_mask != nullptr || a.causal;
#define X2_TC_LAUNCH(K, M) \
  if (kind == (K) && masked == (M)) return launch_kind<D, K, M>(which, a, B, out0, out1, stream);
  X2_TC_LAUNCH(0, false)
  X2_TC_LAUNCH(0, true)
  X2_TC_LAUNCH(x2::kOperandF32, false)
  X2_TC_LAUNCH(x2::kOperandF32, true)
  X2_TC_LAUNCH(x2::kOperandBF16, false)
  X2_TC_LAUNCH(x2::kOperandBF16, true)
#undef X2_TC_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace tc

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
cudaError_t dispatch(int which, int route, const void* q, const void* k, const void* v,
                     const void* bias, int bias_kind, long long sb, long long sh, long long sq,
                     const void* key_mask, const void* dout, const void* lse,
                     const void* delta, void* out0, void* out1, int bias_b, int B, int H,
                     int Sq, int Skv, int D, int causal, float scale, cudaStream_t stream) {
  Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
            static_cast<const T*>(dout), static_cast<const float*>(lse),
            static_cast<const float*>(delta), bias, bias_kind, sb, sh, sq,
            static_cast<const uint8_t*>(key_mask), H, Sq, Skv, causal, scale};
  if (route == x2::kRouteTensorCore) {  // x2::flash_bwd_route: bf16, D = 64
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      if (D == 64) return tc::launch<64>(which, a, B, out0, out1, stream);
    }
    return cudaErrorInvalidValue;
  }
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
  const int route = which == kDBias ? x2::kRouteCudaCore : x2::flash_bwd_route(dtype, D);
  if (dtype == x2::kF32)
    return static_cast<int>(dispatch<float>(which, route, q, k, v, bias, bias_kind, sb, sh, sq,
                                            key_mask, dout, lse, delta, out0, out1, bias_b, B,
                                            H, Sq, Skv, D, causal, scale, st));
  if (dtype == x2::kBF16)
    return static_cast<int>(dispatch<__nv_bfloat16>(which, route, q, k, v, bias, bias_kind, sb,
                                                    sh, sq, key_mask, dout, lse, delta, out0,
                                                    out1, bias_b, B, H, Sq, Skv, D, causal,
                                                    scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory (bytes) of one block of kernel `which` (kDQ, kDKV, kDBias)
// at head dim D on `route` with a bias of `bias_kind` (x2::OperandKind; the
// CUDA-core kernels do not stage the bias), for the CUDA-core kernels' head dims (64, 128,
// 192, 256); -1 for another D. ops/flash_attention.py `bwd_smem_bytes`
// keeps the same formulas.
long long smem_bytes(int which, int D, int route, int bias_kind) {
  if (route == x2::kRouteTensorCore && which != kDBias)
    return static_cast<long long>(which == kDQ ? tc::dq_smem(D, bias_kind)
                                               : tc::dkv_smem(D, bias_kind));
  auto pick = [&](auto tile) -> long long {
    constexpr int DD = decltype(tile)::value;
    return static_cast<long long>(which == kDQ ? dq_smem<DD>()
                                  : which == kDKV ? dkv_smem<DD>() : dbias_smem<DD>());
  };
  switch (D) {
    case 64: return pick(std::integral_constant<int, 64>{});
    case 128: return pick(std::integral_constant<int, 128>{});
    case 192: return pick(std::integral_constant<int, 192>{});
    case 256: return pick(std::integral_constant<int, 256>{});
    default: return -1;
  }
}

}  // namespace

// The route (x2::TinyRoute codes) that dQ and dK/dV take for q/k/v of
// `dtype` at head dim D; ops/flash_attention.py `flash_bwd_route` keeps the
// same rule (dBias always runs on the CUDA cores).
extern "C" int x2_flash_attention_bwd_route(int dtype, int D) {
  return x2::flash_bwd_route(dtype, D);
}

// Shared memory (bytes) of one block of kernel `which` (0 dQ, 1 dK/dV, 2
// dBias) at head dim D on `route` with a bias of `bias_kind`.
extern "C" long long x2_flash_attention_bwd_smem_bytes(int which, int D, int route,
                                                        int bias_kind) {
  return smem_bytes(which, D, route, bias_kind);
}

// q, dout, dq: (B, H, Sq, D); k, v, dk, dv: (B, H, Skv, D); all contiguous,
// dtype `dtype` (x2::DType). lse, delta: (B, H, Sq) f32. bias: null or
// (.., Sq, Skv) with unit stride on the last dim and element strides
// sb / sh / sq (0 where the dim broadcasts), f32 or bf16 per bias_kind; on
// the tensor-core route q, k, v, dout and the bias 16-byte aligned.
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
