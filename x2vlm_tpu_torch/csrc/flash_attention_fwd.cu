// Flash attention forward for Hopper (sm_90a): online-softmax attention over
// (B, H, S, D) tensors that never materializes the (Sq, Skv) logits in
// device memory.
//
// Replaces: x2vlm_tpu/ops/flash_attention.py `_fwd_kernel` (launched by
// `_flash_forward` through `pl.pallas_call`). Same contract: pre-scaled q
// (an extra `scale` multiplies the fp32 logits; the main path passes 1.0),
// an optional additive bias broadcast to (B, H, Sq, Skv) whose batch and
// head dims may be 1 (strides passed in; 0 for a broadcast dim), an
// optional key mask (B, Skv) applied as a -1e30 logit, causal masking
// (key c visible to query r iff c <= r + Skv - Sq), Sq != Skv. Writes `out`
// in q's dtype and the per-row log-sum-exp `lse` in fp32, which the
// backward (csrc/flash_attention_bwd.cu) reads.
//
// What bounds it on the H100: at the main path's shape (BEiT-2 base,
// B=128, H=12, S=197, D=64, bias (1,12,197,197) bf16) the work is ~15 GFLOP
// of bf16 products against ~155 MB of q/k/v/out traffic, so on the tensor
// cores it is bound by bytes (0.0469 ms at 3.35 TB/s; 0.0119 at the
// step's B=32). Two kernels, chosen by x2::flash_route
// (ops/flash_attention.py `flash_route`); a dispatch, not a fallback:
//
// - Tensor cores (bf16, D = 64; the main path), namespace tc, built like
//   the backward's tc::dq_kernel. Blocks of 4 warps, one per (b, h, 64-row
//   query tile); each warp owns 16 query rows, held as mma A fragments
//   (ldmatrix from the staged Q tile). 64-key tiles of K and V and the
//   64 x 64 bias tile (x2::BiasTile: 16-byte cp.async of 394-byte rows
//   that start anywhere in a chunk) come in double-buffered, so the next
//   tile's copies fly while this one computes. Per 16-key group: S = Q.K^T
//   (mma.sync m16n8k16, fp32 sums), x = (S scale + bias) log2e in the C
//   layout, the online max / sum reduced across the quad by two shuffles,
//   P = 2^(x - m) (ex2.approx) rounded to bf16 and packed straight into
//   the A fragment of O += P.V (ldmatrix.trans on V): P never leaves
//   registers. Keys past Skv get -inf, hidden keys the -1e30 logit; an
//   instance per bias kind and with or without masking (kMask), so the
//   main path tests neither per element. O / l leaves through the warp's
//   own Q rows as 16-byte rows; lse = m + log l in natural-log units, fp32.
//   3 blocks of 4 warps an SM (154 registers, no spill; 59,392 B of shared
//   memory with a bf16 bias). On an H100 (700 W): 0.176 ms at B=128 against
//   1.22 for the CUDA-core design and 0.252 for SDPA; 0.050 at B=32
//   (chip_smoke.py).
// - CUDA cores (fp32 at any D, bf16 at D 128, 192, 256): the first design,
//   in fp32, so shared-memory bandwidth and FMA issue set its time. One
//   block of 256 threads per (b, h, 64-row query tile); a loop over 64-key
//   tiles keeps the running max / sum / accumulator of each row in
//   registers; each thread owns a 4x4 register tile of the logits (rows
//   ty+16i, cols tx+16j) and the same 4 rows of the output, so the
//   online-softmax rescale needs no exchange beyond a 16-lane shuffle. K and
//   Q tiles sit in shared memory with a row stride of D+1 floats, so the 16
//   lanes that read 16 different key rows hit 16 different banks.
//
// The ragged edge (197 is not a multiple of 64) is masked in-kernel: keys
// past Skv are not keys at all, query rows past Sq are computed and not
// written. A row whose every key is hidden averages V (every logit is
// -1e30), with lse ~ -1e30, which the backward's dead-row test reads. The
// TPU kernel's %8/%128 padding and batch blocking are Mosaic devices and
// are not carried over.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;   // query rows per block
constexpr int kBKV = 64;  // keys per tile

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         static_cast<size_t>(kBQ * (D + 1) + kBKV * (D + 1) + kBKV * D + kBQ * (kBKV + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const void* __restrict__ bias, int bias_kind, long long bias_sb,
                 long long bias_sh, long long bias_sq, const uint8_t* __restrict__ key_mask,
                 T* __restrict__ out, float* __restrict__ lse, int H, int Sq, int Skv,
                 int causal, float scale) {
  constexpr int LD = D + 1;     // row stride of the Q and K tiles (floats)
  constexpr int LP = kBKV + 1;  // row stride of the probability tile
  constexpr int ND = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // kBQ x LD
  float* Ks = Qs + kBQ * LD;    // kBKV x LD
  float* Vs = Ks + kBKV * LD;   // kBKV x D
  float* Ps = Vs + kBKV * D;    // kBQ x LP

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // this thread's rows: ty + 16 i
  const int tx = tid & 15;  // this thread's key columns: tx + 16 j; output columns tx + 16 j
  const long long bh = static_cast<long long>(b) * H + h;
  const T* qp = q + bh * Sq * D;
  const T* kp = k + bh * Skv * D;
  const T* vp = v + bh * Skv * D;
  const int causal_off = Skv - Sq;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int qr = q0 + r;
    Qs[r * LD + d] = qr < Sq ? x2::to_f(qp[static_cast<long long>(qr) * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }

  for (int c0 = 0; c0 < Skv; c0 += kBKV) {
    __syncthreads();  // the previous tile's K/V/P are no longer read
    for (int i = tid; i < kBKV * D; i += kThreads) {
      const int c = i / D, d = i - c * D;
      const int kc = c0 + c;
      const bool real = kc < Skv;
      Ks[c * LD + d] = real ? x2::to_f(kp[static_cast<long long>(kc) * D + d]) : 0.f;
      Vs[c * D + d] = real ? x2::to_f(vp[static_cast<long long>(kc) * D + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qr = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = c0 + tx + 16 * j;
        float x;
        if (kc >= Skv) {
          x = -INFINITY;  // past the ragged edge: not a key
        } else {
          x = s[i][j] * scale;
          if (bias != nullptr && qr < Sq)
            x += x2::load_operand(bias, bias_kind,
                                  b * bias_sb + h * bias_sh + qr * bias_sq + kc);
          if (key_mask != nullptr && key_mask[static_cast<long long>(b) * Skv + kc] == 0)
            x = x2::kNegInf;
          if (causal && kc > qr + causal_off) x = x2::kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 lanes tx = 0..15 of this half-warp hold row r
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      // lane tx = 0 holds key c0 < Skv, so mx >= -1e30 and m_new is finite
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[r * LP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBKV; ++c) {
      float pv[4], vv[ND];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < ND; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr < Sq) {
      const float ls = fmaxf(l[i], 1e-30f);
      T* op = out + (bh * Sq + qr) * D;
#pragma unroll
      for (int j = 0; j < ND; ++j) op[tx + 16 * j] = x2::from_f<T>(acc[i][j] / ls);
      if (tx == 0) lse[bh * Sq + qr] = m[i] + logf(ls);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   int bias_kind, long long bias_sb, long long bias_sh, long long bias_sq,
                   const void* key_mask, void* out, void* lse, int B, int H, int Sq, int Skv,
                   int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      bias_kind, bias_sb, bias_sh, bias_sq, static_cast<const uint8_t*>(key_mask),
      static_cast<T*>(out), static_cast<float*>(lse), H, Sq, Skv, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, const void* bias,
                       int bias_kind, long long bias_sb, long long bias_sh, long long bias_sq,
                       const void* key_mask, void* out, void* lse, int B, int H, int Sq,
                       int Skv, int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, bias, bias_kind, bias_sb, bias_sh, bias_sq, key_mask, out,
                           lse, B, H, Sq, Skv, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, bias, bias_kind, bias_sb, bias_sh, bias_sq, key_mask, out,
                            lse, B, H, Sq, Skv, causal, scale, stream);
    case 192:
      return launch<T, 192>(q, k, v, bias, bias_kind, bias_sb, bias_sh, bias_sq, key_mask, out,
                            lse, B, H, Sq, Skv, causal, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, bias, bias_kind, bias_sb, bias_sh, bias_sq, key_mask, out,
                            lse, B, H, Sq, Skv, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Tensor-core route (bf16, D = 64)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using x2::kLog2e;
constexpr int kThreads = x2::kTcThreads;  // 4 warps, 16 query rows each
// blocks an SM: at most 170 registers a thread
constexpr int kMinBlocks = 3;
constexpr int kTile = x2::kTcTile;  // query rows of a block; keys of a walked tile

// Shared memory of one block: the Q tile and two stages of K | V | the bias tile.
size_t smem_bytes(int D, int bias_kind) {
  return sizeof(bf16) * (1 + 2 * 2) * kTile * x2::tile_ld(D) +
         4 * 2 * x2::bias_tile_words(bias_kind);
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const void* bias;
  long long bias_sb, bias_sh, bias_sq;
  const uint8_t* key_mask;
  bf16* out;
  float* lse;
  int H, Sq, Skv, causal;
  float scale;
};

// grid (query tiles, H, B); kMask: a key mask or causal masking
template <int D, int kBias, bool kMask>
__global__ void __launch_bounds__(kThreads, kMinBlocks) flash_fwd_kernel(Args a) {
  using L = x2::TileLayout<D>;
  using BT = x2::BiasTile<kBias>;
  constexpr int KS = D / 16, NT = D / 8, NG = kTile / 16, kTileElems = kTile * L::kLD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KV = Qs + kTileElems;  // stage s: K at KV + 2 s kTileElems, V after it
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
#pragma unroll
  for (int R = 0; R < 2; ++R) {
    rr[R] = r0 + g + 8 * R;
    qr[R] = q0 + rr[R];
    shift[R] = BT::shift_of(bbase + qr[R] * a.bias_sq);  // + c0, a multiple of 64
  }
  const uint8_t* km = kMask && a.key_mask != nullptr
                          ? a.key_mask + static_cast<long long>(b) * Skv
                          : nullptr;
  const float scale2 = a.scale * kLog2e;
  constexpr float kHidden = x2::kNegInf * kLog2e;  // a masked logit, in log2 units

  unsigned qa[KS][4];  // the warp's Q rows as A fragments
  float acc[NT][4];
  // the rows' running max (log2 units) and this lane's share of their sums
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int ntiles = (Skv + kTile - 1) / kTile;
  for (int it = 0; it < ntiles; ++it) {
    x2::cp_async_wait_all();
    // this tile has landed (and, first, Q), and every warp is done with the
    // last tile, whose stage the next one now takes
    __syncthreads();
    if (it + 1 < ntiles) {
      stage_kv((it + 1) * kTile, (it + 1) & 1);
      x2::cp_async_commit();
    }
    if (!active) continue;
    if (it == 0) {
#pragma unroll
      for (int s = 0; s < KS; ++s)
        x2::ldmatrix_x4(qa[s], Qs + L::off(r0 + (lane & 15), 16 * s + ((lane >> 4) << 3)));
    }
    const bf16* Ks = KV + 2 * (it & 1) * kTileElems;
    const bf16* Vs = Ks + kTileElems;
    const unsigned* Bt = Bias + (it & 1) * BT::kStageWords;
    const int c0 = it * kTile;
    // x = (S scale + bias) log2e for the tile's 64 keys, in the C layout
    float x[NG][8];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      if (c0 + 16 * gi >= Skv) break;
      x2::mma_abt<D>(x[gi], qa, Ks, 16 * gi, lane);
#pragma unroll
      for (int T = 0; T < 2; ++T)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 16 * gi + 8 * T + 2 * t + e;  // key c0 + j
          const int kc = c0 + j;
          const bool kin = kc < Skv;
          const bool kok = !kMask || km == nullptr || !kin || km[kc] != 0;
#pragma unroll
          for (int R = 0; R < 2; ++R) {
            const int i = 4 * T + 2 * R + e;
            const bool vis = kok && (!kMask || !a.causal || kc <= qr[R] + Skv - Sq);
            const float bv = kBias != 0 ? BT::at(Bt, rr[R], j, shift[R]) * kLog2e : 0.f;
            // past Skv: not a key (P = 0); hidden: the -1e30 logit
            const float xv = !kin ? -INFINITY : vis ? fmaf(x[gi][i], scale2, bv) : kHidden;
            x[gi][i] = xv;
            mx[R] = fmaxf(mx[R], xv);
          }
        }
    }
    // the row max over the quad's lanes (key c0 < Skv, so it is finite)
    float alpha[2];
#pragma unroll
    for (int R = 0; R < 2; ++R) {
      mx[R] = fmaxf(mx[R], __shfl_xor_sync(0xffffffffu, mx[R], 1));
      mx[R] = fmaxf(mx[R], __shfl_xor_sync(0xffffffffu, mx[R], 2));
      const float m_new = fmaxf(m[R], mx[R]);
      alpha[R] = x2::ex2(m[R] - m_new);
      m[R] = m_new;
      l[R] *= alpha[R];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    // P = 2^(x - m), rounded to bf16 as the A fragment of O += P.V
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      if (c0 + 16 * gi >= Skv) break;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = x2::ex2(x[gi][i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += p;
        x[gi][i] = p;
      }
      unsigned pa[4];
      x2::pack_a(pa, x[gi]);
      x2::mma_ab<D>(acc, pa, Vs, 16 * gi, lane);
    }
  }
  if (active) {
    float inv[2];
#pragma unroll
    for (int R = 0; R < 2; ++R) {
      l[R] += __shfl_xor_sync(0xffffffffu, l[R], 1);
      l[R] += __shfl_xor_sync(0xffffffffu, l[R], 2);
      l[R] = fmaxf(l[R], 1e-30f);
      inv[R] = 1.f / l[R];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] *= inv[0];
      acc[nt][1] *= inv[0];
      acc[nt][2] *= inv[1];
      acc[nt][3] *= inv[1];
    }
    // out through the warp's own (dead) Q rows; lse in natural-log units
    x2::store_rows<D>(acc, 1.f, Qs + r0 * L::kLD, a.out + bh * Sq * D, q0 + r0, Sq, lane);
    if (t == 0) {
#pragma unroll
      for (int R = 0; R < 2; ++R)
        if (qr[R] < Sq) a.lse[bh * Sq + qr[R]] = m[R] / kLog2e + logf(l[R]);
    }
  }
}

template <int D, int kBias, bool kMask>
cudaError_t launch_kind(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, kBias);
  const void* kernel = reinterpret_cast<const void*>(flash_fwd_kernel<D, kBias, kMask>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // as much of the SM's 228 KB as shared memory as it takes: 3 blocks an SM
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kTile - 1) / kTile, a.H, B);
  flash_fwd_kernel<D, kBias, kMask><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, int bias_kind, int B, cudaStream_t stream) {
  // the bias tile's 16-byte copies need a 16-byte aligned bias
  if (a.bias != nullptr && reinterpret_cast<uintptr_t>(a.bias) % 16 != 0)
    return cudaErrorInvalidValue;
  const int kind = a.bias == nullptr ? 0 : bias_kind;
  const bool masked = a.key_mask != nullptr || a.causal;
#define X2_TC_LAUNCH(K, M) \
  if (kind == (K) && masked == (M)) return launch_kind<64, K, M>(a, B, stream);
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

// Shared memory (bytes) of one forward block at head dim D on `route` with
// a bias of `bias_kind` (the CUDA-core kernel does not stage the bias), for
// the head dims each route runs (tensor cores 64; CUDA cores 64, 128, 192,
// 256); -1 for another D. ops/flash_attention.py `fwd_smem_bytes` keeps
// the same formulas.
long long fwd_smem(int D, int route, int bias_kind) {
  if (route == x2::kRouteTensorCore)
    return D == 64 ? static_cast<long long>(tc::smem_bytes(D, bias_kind)) : -1;
  switch (D) {
    case 64: return static_cast<long long>(smem_bytes<64>());
    case 128: return static_cast<long long>(smem_bytes<128>());
    case 192: return static_cast<long long>(smem_bytes<192>());
    case 256: return static_cast<long long>(smem_bytes<256>());
    default: return -1;
  }
}

}  // namespace

// The route (x2::TinyRoute codes) the forward takes for q/k/v of `dtype`
// at head dim D; ops/flash_attention.py `flash_route` keeps the same rule.
extern "C" int x2_flash_attention_fwd_route(int dtype, int D) {
  return x2::flash_route(dtype, D);
}

// Shared memory (bytes) of one forward block at head dim D on `route` with
// a bias of `bias_kind`.
extern "C" long long x2_flash_attention_fwd_smem_bytes(int D, int route, int bias_kind) {
  return fwd_smem(D, route, bias_kind);
}

// q, k, v, out: (B, H, S, D) contiguous, dtype `dtype` (x2::DType); on the
// tensor-core route q, k, v and the bias 16-byte aligned. bias:
// null or (.., Sq, Skv) with unit stride on the last dim and element strides
// bias_sb / bias_sh / bias_sq (0 where the dim broadcasts), f32 or bf16 per
// bias_kind (x2::OperandKind). key_mask: null or (B, Skv) uint8, 0 = masked.
// lse: (B, H, Sq) f32. Returns cudaGetLastError() after the launch.
extern "C" int x2_flash_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* bias, int bias_kind, long long bias_sb,
                                      long long bias_sh, long long bias_sq,
                                      const void* key_mask, void* out, void* lse, int B, int H,
                                      int Sq, int Skv, int D, int dtype, int causal,
                                      float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0) return cudaErrorInvalidValue;
  if (bias != nullptr && bias_kind != x2::kOperandF32 && bias_kind != x2::kOperandBF16)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x2::flash_route(dtype, D) == x2::kRouteTensorCore) {  // bf16, D = 64
    const tc::Args a{static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
                     static_cast<const tc::bf16*>(v), bias, bias_sb, bias_sh, bias_sq,
                     static_cast<const uint8_t*>(key_mask), static_cast<tc::bf16*>(out),
                     static_cast<float*>(lse), H, Sq, Skv, causal, scale};
    return static_cast<int>(tc::launch(a, bias_kind, B, st));
  }
  if (dtype == x2::kF32)
    return static_cast<int>(dispatch_d<float>(D, q, k, v, bias, bias_kind, bias_sb, bias_sh,
                                              bias_sq, key_mask, out, lse, B, H, Sq, Skv,
                                              causal, scale, st));
  if (dtype == x2::kBF16)
    return static_cast<int>(dispatch_d<__nv_bfloat16>(D, q, k, v, bias, bias_kind, bias_sb,
                                                       bias_sh, bias_sq, key_mask, out, lse, B,
                                                       H, Sq, Skv, causal, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
