// Shared device helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bft {

// dtype codes passed from Python (bubbleformer_tpu_torch/_build.py).
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// A float rounded through T and back: the dtype casts of the JAX kernels.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Row-major offset of a byte count rounded up to 128 bytes (keeps every
// shared-memory region aligned for WMMA's 32-byte rule).
__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// The epsilon of every InstanceNorm and LayerNorm of the models.
constexpr float kNormEps = 1e-5f;

// The head dims of the repo's configs: 64 (every model but the tiny ones) and
// 16 (avit_tiny, film_avit_tiny: 6 heads of 16).
template <int D>
__host__ __device__ constexpr float head_scaling() {
  static_assert(D == 16 || D == 64, "head dim 16 or 64");
  return D == 64 ? 0.125f : 0.25f;  // D ** -0.5
}

// Lanes d = lane + 32 u of a head row of D values, held by one warp: u < kPer.
template <int D>
struct HeadRow {
  static constexpr int kPer = (D + 31) / 32;
  float v[kPer];
};

// sum_d x_d y_d over a head row held by a warp (lanes beyond D hold 0).
template <int D>
__device__ __forceinline__ float row_dot(const HeadRow<D>& x, const HeadRow<D>& y) {
  float a = 0.f;
#pragma unroll
  for (int u = 0; u < HeadRow<D>::kPer; ++u) a += x.v[u] * y.v[u];
  return warp_sum(a);
}

}  // namespace bft
