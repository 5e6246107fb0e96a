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
// skips that write.
//
// What bounds it on the H100: at the main path's shapes (B=128, H=12, D=64;
// text self-attention 40x40, fusion cross-attention 40x200) it moves
// 31-94 MB for 1-4 GFLOP, so it is memory-bound at the tensor-core rate
// (~0.009 / ~0.028 ms at 3.35 TB/s). This first version computes in fp32
// on the CUDA cores. Design: one block per (head h, batch row b), so every
// K/V byte is read from device memory once; that head's K and V slices
// (Skv x D, 2 x 51 KB in fp32 at Skv=200) are staged in shared memory, K with
// a row stride of D+1 floats so the 32 lanes that each take one key read 32
// different banks. Each warp takes one query row at a time: lanes over keys
// for the logits, warp shuffles for the row max and sum, lanes over the
// head dim for P @ V. The TPU kernel's block-diagonal K/V scratch (it cut
// MXU dispatches), its H*D >= 256 gate and head chunking are Mosaic devices
// and are not carried over.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

size_t smem_bytes(int Skv, int D) {
  return sizeof(float) * (static_cast<size_t>(Skv) * (D + 1) + static_cast<size_t>(Skv) * D +
                          static_cast<size_t>(kWarps) * Skv + static_cast<size_t>(kWarps) * D);
}

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

}  // namespace

// Shared memory (bytes) one block needs; ops/tiny_attention.py keeps the
// same formula for its dispatch rule and refuses larger shapes before launch.
extern "C" long long x2_tiny_attention_smem_bytes(int Skv, int D) {
  return static_cast<long long>(smem_bytes(Skv, D));
}

// q, out: (B, Sq, H*D); k, v: (B, Skv, H*D); all contiguous, dtype `dtype`
// (x2::DType). key_mask: null or (B, Skv) uint8, 0 = masked. dmask: null or
// (B, Sq, H*Skv), f32 or bf16 per dmask_kind (x2::OperandKind). probs: null
// or (B, Sq, H*Skv) f32. Returns cudaGetLastError() after the launch.
extern "C" int x2_tiny_attention_fwd(const void* q, const void* k, const void* v,
                                     const void* key_mask, const void* dmask, int dmask_kind,
                                     void* out, void* probs, int B, int Sq, int Skv, int H,
                                     int D, int dtype, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || D <= 0) return cudaErrorInvalidValue;
  if (dmask != nullptr && dmask_kind != x2::kOperandF32 && dmask_kind != x2::kOperandBF16)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == x2::kF32)
    return static_cast<int>(launch<float>(q, k, v, key_mask, dmask, dmask_kind, out, probs, B,
                                          Sq, Skv, H, D, scale, st));
  if (dtype == x2::kBF16)
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, key_mask, dmask, dmask_kind, out,
                                                  probs, B, Sq, Skv, H, D, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
