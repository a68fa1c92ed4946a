// K10: the training criterion's plane norms, forward and backward,
// hand-written for Hopper (sm_90a).
//
// Replaces bubbleformer_tpu/ops/lp_loss.py:_norms_kernel and _dpred_kernel
// (built by _make_norms, custom VJP :115, entries relative_l2_planes and
// training_lp_loss).  For pred and target (B, T, C, H, W) seen as m = B*T*C
// planes of n = H*W values:
//   forward:   out[i] = (sum (p - t)^2, sum t^2) over plane i, in float32;
//   backward:  dpred = dtype(coef[i] * (p - t)), coef = 2 g_d2 from the
//              caller (the sqrt/ratio/mean/mean/sum epilogue stays in
//              PyTorch, as it stayed in XLA, lp_loss.py:133-147).
// The target gets no gradient.
//
// The TPU kernel gave each grid step whole planes (their (H, W) tiles in
// VMEM) because its grid runs in order on one core.  Here a plane is split
// across blocks of kChunk values, each writing its two partial sums, and a
// second launch adds every plane's partials in a fixed order: no atomics,
// so the loss repeats bit for bit.  Loads are four values a thread (16 bytes
// of a float32 target, 8 of a bfloat16 prediction) where n % 4 == 0 and the
// tensors are 16-byte aligned.
//
// What bounds it at FiLMAViT-small's bf16 step (pred (8, 5, 4, 512, 512)
// bf16, target float32): the bytes, 83.9 MB of pred and 167.8 MB of target
// read forward (0.075 ms at 3.35 TB/s), and those plus 83.9 MB of dpred
// written backward (0.100 ms); ~4 flop a value.
#include <cstdint>

#include "common.cuh"

namespace bft {
namespace {

constexpr int kLossThreads = 256;
constexpr int kLossWarps = kLossThreads / 32;
constexpr int kPerThread = 32;                     // values a thread
constexpr int kChunk = kLossThreads * kPerThread;  // values a block

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&a.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&a.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 a;
  *reinterpret_cast<__nv_bfloat162*>(&a.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&a.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = a;
}

// grid (splits, m): block (s, i) sums values [s * kChunk, (s + 1) * kChunk)
// of plane i into partial[(i * splits + s) * 2 + {0, 1}].  kVec: four values
// a thread (vec_ok).
template <typename P, typename T, bool kVec>
__global__ void __launch_bounds__(kLossThreads) norms_partial_kernel(
    const P* __restrict__ pred, const T* __restrict__ tgt, float* __restrict__ partial, int n) {
  __shared__ float red[kLossWarps][2];
  const int splits = gridDim.x, s = blockIdx.x, i = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t base = (size_t)i * n;
  const int lo = s * kChunk, hi = min(n, lo + kChunk);
  float d2 = 0.f, t2 = 0.f;
  if constexpr (kVec) {
    for (int e = lo + 4 * tid; e < hi; e += 4 * kLossThreads) {
      float p[4], t[4];
      load4(pred + base + e, p);
      load4(tgt + base + e, t);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float d = p[u] - t[u];
        d2 += d * d;
        t2 += t[u] * t[u];
      }
    }
  } else {
    for (int e = lo + tid; e < hi; e += kLossThreads) {
      const float t = to_f32(tgt[base + e]);
      const float d = to_f32(pred[base + e]) - t;
      d2 += d * d;
      t2 += t * t;
    }
  }
  d2 = warp_sum(d2);
  t2 = warp_sum(t2);
  if (lane == 0) {
    red[warp][0] = d2;
    red[warp][1] = t2;
  }
  __syncthreads();
  if (tid < 2) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kLossWarps; ++w) a += red[w][tid];
    partial[((size_t)i * splits + s) * 2 + tid] = a;
  }
}

// out[i * 2 + c] = sum over s of partial[(i * splits + s) * 2 + c], in order.
__global__ void norms_finish_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                    int m, int splits) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 2 * m) return;
  const int i = e / 2, c = e % 2;
  float a = 0.f;
  for (int s = 0; s < splits; ++s) a += partial[((size_t)i * splits + s) * 2 + c];
  out[e] = a;
}

// grid (splits, m): dpred = dtype(coef[i] * (p - t)) over the block's values.
template <typename P, typename T, bool kVec>
__global__ void __launch_bounds__(kLossThreads) dpred_kernel(
    const P* __restrict__ pred, const T* __restrict__ tgt, const float* __restrict__ coef,
    P* __restrict__ dpred, int n) {
  const int s = blockIdx.x, i = blockIdx.y;
  const size_t base = (size_t)i * n;
  const int lo = s * kChunk, hi = min(n, lo + kChunk);
  const float k = coef[i];
  if constexpr (kVec) {
    for (int e = lo + 4 * threadIdx.x; e < hi; e += 4 * kLossThreads) {
      float p[4], t[4];
      load4(pred + base + e, p);
      load4(tgt + base + e, t);
#pragma unroll
      for (int u = 0; u < 4; ++u) p[u] = k * (p[u] - t[u]);
      store4(dpred + base + e, p);
    }
  } else {
    for (int e = lo + threadIdx.x; e < hi; e += kLossThreads)
      dpred[base + e] = from_f32<P>(k * (to_f32(pred[base + e]) - to_f32(tgt[base + e])));
  }
}

int splits_of(int n) { return (n + kChunk - 1) / kChunk; }

// Four values a thread: whole groups of four per plane, 16-byte aligned.
bool vec_ok(int n, const void* a, const void* b, const void* c = nullptr) {
  auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return n % 4 == 0 && al(a) && al(b) && al(c);
}

template <typename P, typename T>
int run_norms(const void* pred, const void* tgt, float* partial, float* out, int m, int n,
              cudaStream_t stream) {
  const int splits = splits_of(n);
  const dim3 grid(splits, m);
  if (vec_ok(n, pred, tgt))
    norms_partial_kernel<P, T, true><<<grid, kLossThreads, 0, stream>>>(
        static_cast<const P*>(pred), static_cast<const T*>(tgt), partial, n);
  else
    norms_partial_kernel<P, T, false><<<grid, kLossThreads, 0, stream>>>(
        static_cast<const P*>(pred), static_cast<const T*>(tgt), partial, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  norms_finish_kernel<<<(2 * m + 255) / 256, 256, 0, stream>>>(partial, out, m, splits);
  return cudaGetLastError();
}

template <typename P, typename T>
int run_dpred(const void* pred, const void* tgt, const float* coef, void* dpred, int m, int n,
              cudaStream_t stream) {
  const dim3 grid(splits_of(n), m);
  if (vec_ok(n, pred, tgt, dpred))
    dpred_kernel<P, T, true><<<grid, kLossThreads, 0, stream>>>(
        static_cast<const P*>(pred), static_cast<const T*>(tgt), coef, static_cast<P*>(dpred), n);
  else
    dpred_kernel<P, T, false><<<grid, kLossThreads, 0, stream>>>(
        static_cast<const P*>(pred), static_cast<const T*>(tgt), coef, static_cast<P*>(dpred), n);
  return cudaGetLastError();
}

bool loss_shape_ok(int m, int n) { return m >= 1 && m <= 65535 && n >= 1; }

}  // namespace
}  // namespace bft

// The number of partial sums a plane of n values takes (the scratch of
// bf_lp_norms_fwd is (m, splits, 2) float32).
extern "C" int bf_lp_norm_splits(int n) { return bft::splits_of(n); }

// pred (m, n) in p_dtype, tgt (m, n) in t_dtype (codes of common.cuh), both
// contiguous; partial (m, splits, 2) float32 scratch; out (m, 2) float32 =
// (sum (p - t)^2, sum t^2) per plane.  m at most 65535.  Returns a
// cudaError_t.
extern "C" int bf_lp_norms_fwd(int p_dtype, int t_dtype, const void* pred, const void* tgt,
                               float* partial, float* out, int m, int n, void* stream) {
  if (!bft::loss_shape_ok(m, n)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (p_dtype == bft::kF32 && t_dtype == bft::kF32)
    return bft::run_norms<float, float>(pred, tgt, partial, out, m, n, s);
  if (p_dtype == bft::kBF16 && t_dtype == bft::kF32)
    return bft::run_norms<bf16, float>(pred, tgt, partial, out, m, n, s);
  if (p_dtype == bft::kF32 && t_dtype == bft::kBF16)
    return bft::run_norms<float, bf16>(pred, tgt, partial, out, m, n, s);
  if (p_dtype == bft::kBF16 && t_dtype == bft::kBF16)
    return bft::run_norms<bf16, bf16>(pred, tgt, partial, out, m, n, s);
  return cudaErrorInvalidValue;
}

// pred, tgt as for bf_lp_norms_fwd; coef (m,) float32; dpred (m, n) in
// p_dtype.  Returns a cudaError_t.
extern "C" int bf_lp_norms_bwd(int p_dtype, int t_dtype, const void* pred, const void* tgt,
                               const float* coef, void* dpred, int m, int n, void* stream) {
  if (!bft::loss_shape_ok(m, n)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (p_dtype == bft::kF32 && t_dtype == bft::kF32)
    return bft::run_dpred<float, float>(pred, tgt, coef, dpred, m, n, s);
  if (p_dtype == bft::kBF16 && t_dtype == bft::kF32)
    return bft::run_dpred<bf16, float>(pred, tgt, coef, dpred, m, n, s);
  if (p_dtype == bft::kF32 && t_dtype == bft::kBF16)
    return bft::run_dpred<float, bf16>(pred, tgt, coef, dpred, m, n, s);
  if (p_dtype == bft::kBF16 && t_dtype == bft::kBF16)
    return bft::run_dpred<bf16, bf16>(pred, tgt, coef, dpred, m, n, s);
  return cudaErrorInvalidValue;
}
