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
// against ~155 MB of q/k/v/out traffic, so at the tensor-core rate it would
// be memory-bound (~0.047 ms at 3.35 TB/s). This first version is not: it
// computes in fp32 on the CUDA cores (no wgmma/mma), so its time is set by
// shared-memory bandwidth and FMA issue. Design: one block of 256 threads
// per (b, h, 64-row query tile); a loop over 64-key tiles keeps the running
// max / sum / accumulator of each row in registers (fp32); each thread owns
// a 4x4 register tile of the logits (rows ty+16i, cols tx+16j) and the same
// 4 rows of the output, so the online-softmax rescale needs no exchange
// beyond a 16-lane shuffle. K and Q tiles sit in shared memory with a row
// stride of D+1 floats, so the 16 lanes that read 16 different key rows hit
// 16 different banks. The ragged edge (197 is not a multiple of 64) is masked
// in-kernel: keys past Skv get -inf (they are not keys at all), query rows
// past Sq are computed and not written. The TPU kernel's %8/%128 padding
// and batch blocking are Mosaic devices and are not carried over; tensor
// cores, TMA and a warp-specialised pipeline are later work.

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

}  // namespace

// q, k, v, out: (B, H, S, D) contiguous, dtype `dtype` (x2::DType). bias:
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
