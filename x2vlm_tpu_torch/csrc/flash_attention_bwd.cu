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
// lse, delta and the bias in, dQ out; bound 0.0149 ms at 3.35 TB/s), dK/dV
// ~60 MB (0.0178 ms) and dBias ~42 MB (0.0126 ms) against 5.7, 7.6 and 3.8
// GFLOP of bf16 products (0.0058, 0.0077 and 0.0038 ms at 989 TFLOP/s):
// with the products on the tensor cores all three are bound by bytes. What
// keeps the tensor-core dQ and dK/dV at 3.5 and 4x their bound is mostly
// mma and staging latency: with P and dS cut to one multiply they took dQ
// 0.0445 and dK/dV 0.0545 ms against 0.0525 and 0.0709
// (tools/flash_bwd_variants.py, no_elementwise; H100). dBias walks 64 x 64
// tiles of Q, dO, K and V, so each is read 4 times from L2 at S=197.
//
// Two routes for each of dQ, dK/dV and dBias, chosen by x2::flash_route
// (ops/flash_attention.py `flash_route`), the forward's rule too; a
// dispatch, not a fallback:
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
//   - dBias (K4): the (1, H, Sq, Skv) rel-pos bias is shared by every batch
//     row, so dBias is a sum over the batch: a reduction across what would
//     be separate blocks. One block per (64-query tile, 64-key tile, h,
//     batch group): the batch is split into G groups (tc::dbias_groups), so
//     that the grid has about 384 blocks, one wave of 3 blocks on each of
//     the 132 SMs (G = 2 at the main shape). With the bf16 bias G = 1, 2, 4
//     and 8 took 0.0697, 0.0545, 0.0571 and 0.0638 ms (192 blocks leave
//     half the card idle; more groups add partial sums to write and read;
//     tools/flash_bwd_variants.py dbias_blocks_*). The block stages its
//     bias tile once, then walks its group's batch rows with Q, dO, K, V
//     and lse / delta double-buffered, recomputes S and dP by mma and sums
//     dS = P (dP - delta) in fp32 registers (32 a thread). Each group writes its
//     partial sum; tc::dbias_sum_kernel adds the G partials in the fixed
//     order g = 0 .. G-1, so dBias is the same bit for bit from run to run
//     (no atomics). A per-batch bias is G = B, each block its own output.
//     On an H100 (700 W): 0.0545 ms against 0.63 for the CUDA-core design
//     and 0.27 for SDPA's whole backward with the bias gradient.
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
//   - dBias (K4): one block per (query tile, key tile, h) loops over the
//     batch rows and writes its tile once, deterministic without atomics
//     (fp32; the caller sums heads for a head-broadcast bias and casts). A
//     per-batch bias gets one block per (tile, tile, h, b).
// Keys past Skv are not keys (P = 0); rows past Sq have no lse, so their P
// is forced to 0 (zero-filled tiles alone would not do it) and they add
// nothing to dK / dV. No causal tile skipping: a fully hidden row still
// feeds dV.

#include <algorithm>
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
// Tensor-core route (bf16, D = 64): dQ, dK/dV and dBias
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using x2::BiasTile;
using x2::ex2;
using x2::kLog2e;
using x2::mma_ab;
using x2::mma_abt;
using x2::pack_a;
using x2::store_rows;
constexpr int kThreads = x2::kTcThreads;  // 4 warps, 16 rows (dQ, dBias) or keys (dK/dV) each
// blocks an SM: at most 170 registers a thread (dK/dV spills up to 40
// bytes); on an H100 at the main shape with a bf16 bias, 2 blocks (207
// registers, no spill) took dK/dV from 0.071 to 0.077 ms and 4 (128
// registers, ~300 bytes of spills) to 0.104 (tools/flash_bwd_variants.py,
// min_blocks_2 / min_blocks_4)
constexpr int kMinBlocks = 3;
constexpr int kTile = x2::kTcTile;  // rows of a block's own tile and of a walked tile
// blocks the dBias grid aims at for a batch-shared bias (ops/flash_attention.py
// `_DBIAS_BLOCKS`), by splitting the batch into groups
constexpr int kDBiasBlocks = 384;

// Shared memory of one block: dQ holds Q and dO (one tile each) and two
// stages of K | V | the bias tile; dK/dV holds K and V and two stages of Q
// | dO | the bias tile | lse and delta (fp32); dBias two stages of Q | dO |
// K | V | lse and delta, and one bias tile (staged once a block).
size_t dq_smem(int D, int bias_kind) {
  return sizeof(bf16) * (2 + 2 * 2) * kTile * x2::tile_ld(D) +
         4 * 2 * x2::bias_tile_words(bias_kind);
}
size_t dkv_smem(int D, int bias_kind) {
  return dq_smem(D, bias_kind) + sizeof(float) * 2 * 2 * kTile;
}
size_t dbias_smem(int D, int bias_kind) {
  return sizeof(bf16) * 2 * 4 * kTile * x2::tile_ld(D) + sizeof(float) * 2 * 2 * kTile +
         4 * x2::bias_tile_words(bias_kind);
}

// Batch groups of the dBias kernel for a batch-shared bias: enough that
// the grid (tiles x H x groups) has about kDBiasBlocks blocks, at most one
// group a batch row (ops/flash_attention.py `dbias_groups`).
int dbias_groups(int B, int tiles, int H) {
  const int per_group = tiles * H;
  return std::max(1, std::min(B, (kDBiasBlocks + per_group - 1) / per_group));
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
    BT::stage(Bias + s * BT::kStageWords, a.bias, a.bias_sq, Skv, bbase, q0, nq, c0, tid);
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
    BT::stage(Bias + s * BT::kStageWords, a.bias, a.bias_sq, Skv, bbase, q0, nq, k0, tid);
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

// grid (query tiles, key tiles, H * G); block (qt, kt, h + H grp) sums dS
// of its 64 x 64 tile over the batch rows [grp B / G, (grp + 1) B / G) in
// fp32 registers and writes it to out (G, H, Sq, Skv). A per-batch bias has
// G = B (one row a block); a batch-shared bias is staged once a block.
// kMask: a key mask or causal masking
template <int D, int kBias, bool kMask>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dbias_kernel(Args<bf16> a, float* __restrict__ out, int B, int G) {
  using L = x2::TileLayout<D>;
  using BT = BiasTile<kBias>;
  constexpr int KS = D / 16, NG = kTile / 16, kTileElems = kTile * L::kLD;
  constexpr int kStageElems = 4 * kTileElems;  // Q | dO | K | V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Tiles = reinterpret_cast<bf16*>(smem_raw);  // stage s at s kStageElems
  // stage s: lse, delta at 2 s kTile
  float* LDs = reinterpret_cast<float*>(Tiles + 2 * kStageElems);
  unsigned* Bias = reinterpret_cast<unsigned*>(LDs + 4 * kTile);

  const int q0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const int h = blockIdx.z % a.H, grp = blockIdx.z / a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int Sq = a.Sq, Skv = a.Skv;
  const int nq = min(kTile, Sq - q0), nk = min(kTile, Skv - c0);
  const int b0 = static_cast<int>(static_cast<long long>(grp) * B / G);
  const int b1 = static_cast<int>(static_cast<long long>(grp + 1) * B / G);
  const long long bbase = b0 * a.bias_sb + h * a.bias_sh;
  BT::stage(Bias, a.bias, a.bias_sq, Skv, bbase, q0, nq, c0, tid);
  auto stage_b = [&](int b, int s) {
    const long long bh = static_cast<long long>(b) * a.H + h;
    bf16* Td = Tiles + s * kStageElems;
    const int pq = x2::round_up16(nq), pk = x2::round_up16(nk);
    x2::stage_rows<D>(Td, a.q + (bh * Sq + q0) * D, nq, pq, D, tid, kThreads);
    x2::stage_rows<D>(Td + kTileElems, a.dout + (bh * Sq + q0) * D, nq, pq, D, tid, kThreads);
    x2::stage_rows<D>(Td + 2 * kTileElems, a.k + (bh * Skv + c0) * D, nk, pk, D, tid, kThreads);
    x2::stage_rows<D>(Td + 3 * kTileElems, a.v + (bh * Skv + c0) * D, nk, pk, D, tid, kThreads);
    float* Ld = LDs + 2 * s * kTile;
    for (int i = tid; i < kTile; i += kThreads) {  // rows past Sq: zeros
      const bool ok = i < nq;
      x2::cp_async4(Ld + i, a.lse + bh * Sq + (ok ? q0 + i : 0), ok ? 4 : 0);
      x2::cp_async4(Ld + kTile + i, a.delta + bh * Sq + (ok ? q0 + i : 0), ok ? 4 : 0);
    }
  };
  stage_b(b0, 0);
  x2::cp_async_commit();

  // the lane's two rows: q0 + rr[R], rr = 16 warp + g + 8R; its keys
  // c0 + 16 gi + 8T + 2t + e
  const int r0 = 16 * warp;
  const bool active = r0 < nq;
  int qr[2], rr[2], shift[2];
#pragma unroll
  for (int R = 0; R < 2; ++R) {
    rr[R] = r0 + g + 8 * R;
    qr[R] = q0 + rr[R];
    shift[R] = BT::shift_of(bbase + qr[R] * a.bias_sq);  // + c0, a multiple of 64
  }
  const float scale2 = a.scale * kLog2e;
  float acc[NG][8], bl[NG][8];  // the dS sums; the bias * log2e
#pragma unroll
  for (int gi = 0; gi < NG; ++gi)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[gi][i] = bl[gi][i] = 0.f;

  for (int b = b0; b < b1; ++b) {
    const int s = (b - b0) & 1;
    x2::cp_async_wait_all();
    // this row's tiles have landed (and, first, the bias), and every warp
    // is done with the last row's, whose stage the next row now takes
    __syncthreads();
    if (b + 1 < b1) {
      stage_b(b + 1, s ^ 1);
      x2::cp_async_commit();
    }
    if (!active) continue;
    if (kBias != 0 && b == b0) {  // the bias tile in the C layout, once a block
#pragma unroll
      for (int gi = 0; gi < NG; ++gi)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int R = (i >> 1) & 1, j = 16 * gi + 8 * (i >> 2) + 2 * t + (i & 1);
          bl[gi][i] = BT::at(Bias, rr[R], j, shift[R]) * kLog2e;
        }
    }
    const bf16* Qs = Tiles + s * kStageElems;
    const bf16* dOs = Qs + kTileElems;
    const bf16* Ks = Qs + 2 * kTileElems;
    const bf16* Vs = Qs + 3 * kTileElems;
    const float* Ls = LDs + 2 * s * kTile;
    unsigned qa[KS][4], da[KS][4];  // the warp's Q and dO rows as A fragments
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      x2::ldmatrix_x4(qa[ks], Qs + L::off(r0 + (lane & 15), 16 * ks + ((lane >> 4) << 3)));
      x2::ldmatrix_x4(da[ks], dOs + L::off(r0 + (lane & 15), 16 * ks + ((lane >> 4) << 3)));
    }
    float lse2[2], delta[2];
    bool live[2];
#pragma unroll
    for (int R = 0; R < 2; ++R) {
      const float lse = Ls[rr[R]];
      delta[R] = Ls[kTile + rr[R]];
      live[R] = qr[R] < Sq && lse >= kDeadLse;  // a dead row's dS is 0
      lse2[R] = lse * kLog2e;
    }
    const uint8_t* km =
        kMask && a.key_mask != nullptr ? a.key_mask + static_cast<long long>(b) * Skv : nullptr;
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      if (c0 + 16 * gi >= Skv) break;
      float sv[8], dp[8];
      mma_abt<D>(sv, qa, Ks, 16 * gi, lane);
      mma_abt<D>(dp, da, Vs, 16 * gi, lane);
#pragma unroll
      for (int T = 0; T < 2; ++T)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = c0 + 16 * gi + 8 * T + 2 * t + e;
          const bool kok = kc < Skv && (!kMask || km == nullptr || km[kc] != 0);
#pragma unroll
          for (int R = 0; R < 2; ++R) {
            const int i = 4 * T + 2 * R + e;
            const bool vis = live[R] && kok && (!kMask || !a.causal || kc <= qr[R] + Skv - Sq);
            const float p = ex2(fmaf(sv[i], scale2, bl[gi][i]) - lse2[R]);
            acc[gi][i] += vis ? p * (dp[i] - delta[R]) : 0.f;
          }
        }
    }
  }
  if (active) {
    float* o = out + (static_cast<long long>(grp) * a.H + h) * Sq * Skv;
#pragma unroll
    for (int gi = 0; gi < NG; ++gi)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int R = (i >> 1) & 1, kc = c0 + 16 * gi + 8 * (i >> 2) + 2 * t + (i & 1);
        if (qr[R] < Sq && kc < Skv) o[static_cast<long long>(qr[R]) * Skv + kc] = acc[gi][i];
      }
  }
}

// out[i] = sum over g = 0 .. G-1 in that order of part[g n + i]: the dBias
// groups' partial sums, added in a fixed order, so dBias is the same bit
// for bit from run to run (no atomics)
__global__ void __launch_bounds__(256) dbias_sum_kernel(const float* __restrict__ part,
                                                        float* __restrict__ out, long long n,
                                                        int G) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n; i += 256LL * gridDim.x) {
    float s = part[i];
    for (int g = 1; g < G; ++g) s += part[g * n + i];
    out[i] = s;
  }
}

template <int D, int kBias, bool kMask>
cudaError_t launch_kind(int which, const Args<bf16>& a, int B, void* out0, void* out1,
                        int groups, cudaStream_t stream) {
  const size_t smem = which == kDQ    ? dq_smem(D, kBias)
                      : which == kDKV ? dkv_smem(D, kBias)
                                      : dbias_smem(D, kBias);
  const void* kernel =
      which == kDQ    ? reinterpret_cast<const void*>(dq_kernel<D, kBias, kMask>)
      : which == kDKV ? reinterpret_cast<const void*>(dkv_kernel<D, kBias, kMask>)
                      : reinterpret_cast<const void*>(dbias_kernel<D, kBias, kMask>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // as much of the SM's 228 KB as shared memory as it takes: 3 blocks an SM
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int nq = (a.Sq + kTile - 1) / kTile, nk = (a.Skv + kTile - 1) / kTile;
  if (which == kDQ) {
    dq_kernel<D, kBias, kMask><<<dim3(nq, a.H, B), kThreads, smem, stream>>>(
        a, static_cast<bf16*>(out0));
  } else if (which == kDKV) {
    dkv_kernel<D, kBias, kMask><<<dim3(nk, a.H, B), kThreads, smem, stream>>>(
        a, static_cast<bf16*>(out0), static_cast<bf16*>(out1));
  } else {
    // out1: the groups' partial sums (groups, H, Sq, Skv), summed into out0;
    // null when each group is its own output row (one group, or a per-batch bias)
    float* dst = static_cast<float*>(out1 != nullptr ? out1 : out0);
    dbias_kernel<D, kBias, kMask><<<dim3(nq, nk, a.H * groups), kThreads, smem, stream>>>(
        a, dst, B, groups);
    if (out1 != nullptr) {
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      const long long n = static_cast<long long>(a.H) * a.Sq * a.Skv;
      const int blocks = static_cast<int>(std::min<long long>((n + 255) / 256, 132 * 8));
      dbias_sum_kernel<<<blocks, 256, 0, stream>>>(dst, static_cast<float*>(out0), n, groups);
    }
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int which, const Args<bf16>& a, int B, void* out0, void* out1, int groups,
                   cudaStream_t stream) {
  // the bias tile's 16-byte copies need a 16-byte aligned bias
  if (a.bias != nullptr && reinterpret_cast<uintptr_t>(a.bias) % 16 != 0)
    return cudaErrorInvalidValue;
  const int kind = a.bias == nullptr ? 0 : a.bias_kind;
  const bool masked = a.key_mask != nullptr || a.causal;
#define X2_TC_LAUNCH(K, M)                                                               \
  if (kind == (K) && masked == (M))                                                      \
    return launch_kind<D, K, M>(which, a, B, out0, out1, groups, stream);
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
                     const void* delta, void* out0, void* out1, int groups, int bias_b, int B,
                     int H, int Sq, int Skv, int D, int causal, float scale,
                     cudaStream_t stream) {
  Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
            static_cast<const T*>(dout), static_cast<const float*>(lse),
            static_cast<const float*>(delta), bias, bias_kind, sb, sh, sq,
            static_cast<const uint8_t*>(key_mask), H, Sq, Skv, causal, scale};
  if (route == x2::kRouteTensorCore) {  // x2::flash_route: bf16, D = 64
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      if (D == 64) return tc::launch<64>(which, a, B, out0, out1, groups, stream);
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

// The batch groups the dBias kernel of `route` writes for a bias of batch
// dim bias_b: B for a per-batch bias (a group is its batch row's dBias),
// on the tensor cores tc::dbias_groups for a batch-shared one (partial
// sums, then added in order), else 1 (the CUDA-core kernel sums the whole
// batch in a block). ops/flash_attention.py `_dbias_launch_groups` keeps
// the same rule.
int dbias_groups_of(int route, int B, int H, int Sq, int Skv, int bias_b) {
  if (bias_b == B) return B;
  if (route != x2::kRouteTensorCore) return 1;
  const int tiles = ((Sq + tc::kTile - 1) / tc::kTile) * ((Skv + tc::kTile - 1) / tc::kTile);
  return tc::dbias_groups(B, tiles, H);
}

int entry(int which, const void* q, const void* k, const void* v, const void* bias,
          int bias_kind, long long sb, long long sh, long long sq, const void* key_mask,
          const void* dout, const void* lse, const void* delta, void* out0, void* out1,
          int groups, int bias_b, int B, int H, int Sq, int Skv, int D, int dtype, int causal,
          float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0) return cudaErrorInvalidValue;
  if (bias != nullptr && bias_kind != x2::kOperandF32 && bias_kind != x2::kOperandBF16)
    return cudaErrorInvalidValue;
  const int route = x2::flash_route(dtype, D);
  if (which == kDBias) {
    // the caller sized the partial sums (out1) by the same group rule
    if (bias == nullptr || (bias_b != 1 && bias_b != B) ||
        groups != dbias_groups_of(route, B, H, Sq, Skv, bias_b) ||
        (out1 != nullptr) != (groups > bias_b))
      return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == x2::kF32)
    return static_cast<int>(dispatch<float>(which, route, q, k, v, bias, bias_kind, sb, sh, sq,
                                            key_mask, dout, lse, delta, out0, out1, groups,
                                            bias_b, B, H, Sq, Skv, D, causal, scale, st));
  if (dtype == x2::kBF16)
    return static_cast<int>(dispatch<__nv_bfloat16>(which, route, q, k, v, bias, bias_kind, sb,
                                                    sh, sq, key_mask, dout, lse, delta, out0,
                                                    out1, groups, bias_b, B, H, Sq, Skv, D,
                                                    causal, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory (bytes) of one block of kernel `which` (kDQ, kDKV, kDBias)
// at head dim D on `route` with a bias of `bias_kind` (x2::OperandKind; the
// CUDA-core kernels do not stage the bias), for the head dims each route
// runs (tensor cores 64; CUDA cores 64, 128, 192, 256); -1 for another D.
// ops/flash_attention.py `bwd_smem_bytes` keeps the same formulas.
long long smem_bytes(int which, int D, int route, int bias_kind) {
  if (route == x2::kRouteTensorCore && D != 64) return -1;
  if (route == x2::kRouteTensorCore)
    return static_cast<long long>(which == kDQ    ? tc::dq_smem(D, bias_kind)
                                  : which == kDKV ? tc::dkv_smem(D, bias_kind)
                                                  : tc::dbias_smem(D, bias_kind));
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

// The route (x2::TinyRoute codes) that dQ, dK/dV and dBias take for q/k/v
// of `dtype` at head dim D; ops/flash_attention.py `flash_route` keeps the
// same rule.
extern "C" int x2_flash_attention_bwd_route(int dtype, int D) {
  return x2::flash_route(dtype, D);
}

// Shared memory (bytes) of one block of kernel `which` (0 dQ, 1 dK/dV, 2
// dBias) at head dim D on `route` with a bias of `bias_kind`.
extern "C" long long x2_flash_attention_bwd_smem_bytes(int which, int D, int route,
                                                        int bias_kind) {
  return smem_bytes(which, D, route, bias_kind);
}

// The batch groups of the tensor-core dBias kernel for a batch-shared bias
// at B batch rows, `tiles` (64-row query tiles x 64-key tiles) and H heads.
extern "C" int x2_flash_attention_bwd_dbias_groups(int B, int tiles, int H) {
  return tc::dbias_groups(B, tiles, H);
}

// q, dout, dq: (B, H, Sq, D); k, v, dk, dv: (B, H, Skv, D); all contiguous,
// dtype `dtype` (x2::DType). lse, delta: (B, H, Sq) f32. bias: null or
// (.., Sq, Skv) with unit stride on the last dim and element strides
// sb / sh / sq (0 where the dim broadcasts), f32 or bf16 per bias_kind; on
// the tensor-core route q, k, v, dout and the bias 16-byte aligned.
// key_mask: null or (B, Skv) uint8, 0 = masked. dbias: (bias_b, H, Sq, Skv)
// f32, bias_b = 1 (summed over the batch) or B; partial: null, or scratch
// of (groups, H, Sq, Skv) f32 when groups (the rule of `dbias_groups_of`)
// exceeds bias_b. Each entry returns cudaGetLastError() after its launch.
extern "C" int x2_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                         const void* bias, int bias_kind, long long sb,
                                         long long sh, long long sq, const void* key_mask,
                                         const void* dout, const void* lse, const void* delta,
                                         void* dq, int B, int H, int Sq, int Skv, int D,
                                         int dtype, int causal, float scale, void* stream) {
  return entry(kDQ, q, k, v, bias, bias_kind, sb, sh, sq, key_mask, dout, lse, delta, dq,
               nullptr, 1, 1, B, H, Sq, Skv, D, dtype, causal, scale, stream);
}

extern "C" int x2_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                          const void* bias, int bias_kind, long long sb,
                                          long long sh, long long sq, const void* key_mask,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dk, void* dv, int B, int H, int Sq, int Skv,
                                          int D, int dtype, int causal, float scale,
                                          void* stream) {
  return entry(kDKV, q, k, v, bias, bias_kind, sb, sh, sq, key_mask, dout, lse, delta, dk, dv,
               1, 1, B, H, Sq, Skv, D, dtype, causal, scale, stream);
}

extern "C" int x2_flash_attention_bwd_dbias(const void* q, const void* k, const void* v,
                                            const void* bias, int bias_kind, long long sb,
                                            long long sh, long long sq, const void* key_mask,
                                            const void* dout, const void* lse,
                                            const void* delta, void* dbias, void* partial,
                                            int groups, int bias_b, int B, int H, int Sq,
                                            int Skv, int D, int dtype, int causal, float scale,
                                            void* stream) {
  return entry(kDBias, q, k, v, bias, bias_kind, sb, sh, sq, key_mask, dout, lse, delta,
               dbias, partial, groups, bias_b, B, H, Sq, Skv, D, dtype, causal, scale, stream);
}
