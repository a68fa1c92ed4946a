// The kernels around the attention of a whole-branch block, shared by K1
// (temporal_block.cu, temporal_block_bwd.cu), K3, K5 (axial_block_mega.cu)
// and K9 (axial_lane_px.cu):
// InstanceNorm statistics over the tokens of a plane, the two projections with
// the InstanceNorm applied while the activations are staged, and the backward
// products and sums.  Every product runs on block_gemm.cuh's tile (WMMA for
// bf16, an FMA loop for float32).  A plane is the N tokens of one image (K1,
// K3: one (b, t); K5: one of the BT images); tensors are token-major (G, N,
// C).  Included by each .cu that launches them: every translation unit keeps
// its own copy (internal linkage).
#pragma once

#include "block_gemm.cuh"
#include "common.cuh"

namespace bft {
namespace {

constexpr int kTileM = 64;  // rows of the gemm_nt / wgrad tiles
constexpr int kProjMTiles = 4;  // rows of a projection block: 64

// Mean and rstd over the N rows of each (plane, channel) of a (G, N, C) tensor;
// single pass E[x^2] - E[x]^2 in float32, as the TPU kernels' InstanceNorm, but
// on the values shifted by the plane's first row.  Unshifted, the difference
// cancels wherever a channel's mean is far above its spread (FiLM with |beta|
// >> |gamma|); shifted by a sample of the plane, the sums are of deviations
// and the cancellation is gone.  Block (32 channels, 8 row phases), grid
// (ceil(C / 32), G).
template <typename T>
__global__ void plane_stats_kernel(const T* __restrict__ x, int N, int C,
                                   float* __restrict__ mean, float* __restrict__ rstd) {
  __shared__ float sh_s[8][33];
  __shared__ float sh_ss[8][33];
  const int g = blockIdx.y;
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f, ss = 0.f, shift = 0.f;
  if (c < C) {
    const T* p = x + (size_t)g * N * C + c;
    shift = to_f32(p[0]);
    for (int r = threadIdx.y; r < N; r += 8) {
      const float v = to_f32(p[(size_t)r * C]) - shift;
      s += v;
      ss += v * v;
    }
  }
  sh_s[threadIdx.y][threadIdx.x] = s;
  sh_ss[threadIdx.y][threadIdx.x] = ss;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float ts = 0.f, tss = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ts += sh_s[i][threadIdx.x];
      tss += sh_ss[i][threadIdx.x];
    }
    const float mu = ts / N;
    const float var = fmaxf(tss / N - mu * mu, 0.f);
    mean[(size_t)g * C + c] = shift + mu;
    rstd[(size_t)g * C + c] = 1.f / sqrtf(var + kNormEps);
  }
}

// out[r, n] = T(sum_k T(IN(a)[r, k]) * w[n, k] + bias[n]): a projection of
// the InstanceNorm of a (R, K) activation a (in S: the activation dtype, or
// float32), IN(a) = (a - mean[g, k]) * rstd[g, k] * in_w[k] + in_b[k] with
// g = r / N, rounded to T while it is staged; w (Nout, K) in T, torch (out,
// in) layout; bias float32.  K1's output projection of IN2(ao), K5's QKV
// projection of IN1(x) and its output projection of IN2(ao).  Without kNorm,
// a is staged as it is and mean, rstd, in_w, in_b are unused: K9's QKV
// projection of x.  Grid (ceil(R / 64), ceil(Nout / kBN)); K a multiple of
// kKC, Nout of 16.
template <typename T, typename S, bool kNorm = true>
__global__ void __launch_bounds__(kGemmThreads) norm_proj_kernel(
    const S* __restrict__ a, const float* __restrict__ mean, const float* __restrict__ rstd,
    const float* __restrict__ in_w, const float* __restrict__ in_b, const T* __restrict__ w,
    const float* __restrict__ bias, T* __restrict__ out, int R, int N, int K, int Nout) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int r0 = blockIdx.x * 16 * kProjMTiles, n0 = blockIdx.y * kBN;
  const int n_tiles = min(kBN, Nout - n0) / 16;

  auto aload = [&](int m, int k) -> T {
    const int r = r0 + m;
    if (r >= R) return from_f32<T>(0.f);
    if constexpr (!kNorm) return from_f32<T>(to_f32(a[(size_t)r * K + k]));
    const int s = (r / N) * K + k;
    return from_f32<T>((to_f32(a[(size_t)r * K + k]) - mean[s]) * rstd[s] * in_w[k] + in_b[k]);
  };
  auto bload = [&](int n, int k) -> T { return w[(size_t)(n0 + n) * K + k]; };
  block_gemm<T, false>(kProjMTiles, n_tiles, K, aload, bload, smem);
  const float* Cs = gemm_out<T>(smem, kProjMTiles);
  __syncthreads();

  const int cols = 16 * n_tiles;
  for (int e = threadIdx.x; e < 16 * kProjMTiles * cols; e += kGemmThreads) {
    const int m = e / cols, j = e % cols, r = r0 + m;
    if (r < R) out[(size_t)r * Nout + n0 + j] = from_f32<T>(Cs[m * kLDC + j] + bias[n0 + j]);
  }
}

// out[r, n] = sum_k A[r, k] * Bt[n, k]; A (M, K), Bt (Nc, K) in T, out (M, Nc)
// in O (float32 for a scratch, the activation dtype for K3's dxn).  With
// kAdd, out[r, n] = O(out[r, n] + O(sum)): the sum rounded, then added to
// what out holds (K9's dx of the column pass onto the row pass's).  Grid
// (ceil(M / 64), ceil(Nc / 192)).
template <typename T, typename O, bool kAdd = false>
__global__ void __launch_bounds__(kGemmThreads) gemm_nt_kernel(const T* __restrict__ A,
                                                               const T* __restrict__ Bt,
                                                               O* __restrict__ out, int M, int Nc,
                                                               int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int r0 = blockIdx.x * kTileM, n0 = blockIdx.y * kBN;
  const int n_tiles = min(kBN, Nc - n0) / 16;
  auto aload = [&](int m, int k) -> T {
    const int r = r0 + m;
    return r < M ? A[(size_t)r * K + k] : from_f32<T>(0.f);
  };
  auto bload = [&](int n, int k) -> T { return Bt[(size_t)(n0 + n) * K + k]; };
  block_gemm<T, false>(kTileM / 16, n_tiles, K, aload, bload, smem);
  const float* Cs = gemm_out<T>(smem, kTileM / 16);
  __syncthreads();
  const int cols = 16 * n_tiles;
  for (int e = threadIdx.x; e < kTileM * cols; e += kGemmThreads) {
    const int m = e / cols, j = e % cols, r = r0 + m;
    if (r >= M) continue;
    O* o = out + (size_t)r * Nc + n0 + j;
    *o = from_f32<O>(kAdd ? to_f32(*o) + round_to<O>(Cs[m * kLDC + j]) : Cs[m * kLDC + j]);
  }
}

// dW[m, n] += sum_{r in chunk} D[r, m] * norm(src[r, n]), with
// norm(v) = T((v - mean[g, n]) * rstd[g, n] * w[n] + b[n]), g = r / N: the
// forward's rounded IN output recomputed while it is staged.  D (R, M) in T,
// src (R, Nc) in S, dW (M, Nc) float32.  Grid (ceil(M / 64), ceil(Nc / 192),
// ceil(R / chunk)); chunk a multiple of kKC.  Without kNorm, src is read as
// it is (K3: it already is the rounded IN output) and mean, rstd, w, b are
// unused.
template <typename T, typename S, bool kNorm>
__global__ void __launch_bounds__(kGemmThreads) wgrad_kernel(
    const T* __restrict__ D, int M, const S* __restrict__ src, const float* __restrict__ mean,
    const float* __restrict__ rstd, const float* __restrict__ w, const float* __restrict__ b,
    int Nc, int R, int N, int chunk, float* __restrict__ dW) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kBN, k0 = blockIdx.z * chunk;
  const int m_tiles = min(kTileM, M - m0) / 16, n_tiles = min(kBN, Nc - n0) / 16;
  const int K = (min(chunk, R - k0) + kKC - 1) / kKC * kKC;
  auto aload = [&](int m, int k) -> T {
    const int r = k0 + k;
    return r < R ? D[(size_t)r * M + m0 + m] : from_f32<T>(0.f);
  };
  auto bload = [&](int n, int k) -> T {
    const int r = k0 + k, c = n0 + n;
    if (r >= R) return from_f32<T>(0.f);
    const float v = to_f32(src[(size_t)r * Nc + c]);
    if constexpr (!kNorm) return from_f32<T>(v);
    const int s = (r / N) * Nc + c;
    return from_f32<T>((v - mean[s]) * rstd[s] * w[c] + b[c]);
  };
  block_gemm<T, true>(m_tiles, n_tiles, K, aload, bload, smem);
  const float* Cs = gemm_out<T>(smem, m_tiles);
  __syncthreads();
  const int cols = 16 * n_tiles;
  for (int e = threadIdx.x; e < 16 * m_tiles * cols; e += kGemmThreads) {
    const int m = e / cols, j = e % cols;
    atomicAdd(&dW[(size_t)(m0 + m) * Nc + n0 + j], Cs[m * kLDC + j]);
  }
}

// Per (plane g, channel c) of a (G, N, C) tensor a, s0 = sum_n a and, when src
// is given, s1 = sum_n a * xhat with xhat = (src - mean) * rstd.  Writes sums
// (2, G, C) = [s0; s1] when given, and adds s0 into dbias[c] and s1 into
// dscale[c] when given.  Block (32 channels, 8 row phases), grid
// (ceil(C / 32), G).
template <typename A, typename S>
__global__ void plane_sums_kernel(const A* __restrict__ a, const S* __restrict__ src,
                                  const float* __restrict__ mean, const float* __restrict__ rstd,
                                  int N, int C, float* __restrict__ sums,
                                  float* __restrict__ dscale, float* __restrict__ dbias) {
  __shared__ float sh0[8][33];
  __shared__ float sh1[8][33];
  const int g = blockIdx.y, G = gridDim.y;
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s0 = 0.f, s1 = 0.f;
  if (c < C) {
    const size_t base = (size_t)g * N * C + c;
    const float mu = src ? mean[g * C + c] : 0.f, rs = src ? rstd[g * C + c] : 0.f;
    for (int r = threadIdx.y; r < N; r += 8) {
      const float v = to_f32(a[base + (size_t)r * C]);
      s0 += v;
      if (src) s1 += v * ((to_f32(src[base + (size_t)r * C]) - mu) * rs);
    }
  }
  sh0[threadIdx.y][threadIdx.x] = s0;
  sh1[threadIdx.y][threadIdx.x] = s1;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t0 = 0.f, t1 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      t0 += sh0[i][threadIdx.x];
      t1 += sh1[i][threadIdx.x];
    }
    if (sums) {
      sums[(size_t)g * C + c] = t0;
      sums[(size_t)(G + g) * C + c] = t1;
    }
    if (dbias) atomicAdd(&dbias[c], t0);
    if (dscale) atomicAdd(&dscale[c], t1);
  }
}

// The InstanceNorm backward: dx = T(rstd * w * (dy - s0 / N - xhat * s1 / N))
// over (G, N, C), xhat = (x - mean) * rstd, x in S, the sums from
// plane_sums_kernel.
template <typename T, typename S>
__global__ void in_apply_kernel(const float* __restrict__ dy, const S* __restrict__ x,
                                const float* __restrict__ mean, const float* __restrict__ rstd,
                                const float* __restrict__ w, const float* __restrict__ sums,
                                T* __restrict__ dx, int G, int N, int C) {
  const size_t total = (size_t)G * N * C;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int c = e % C;
    const int g = e / ((size_t)N * C);
    const int s = g * C + c;
    const float xh = (to_f32(x[e]) - mean[s]) * rstd[s];
    dx[e] = from_f32<T>(rstd[s] * w[c] *
                        (dy[e] - sums[s] / N - xh * (sums[(size_t)G * C + s] / N)));
  }
}

// The launches of these kernels, each returning its cudaError_t.  Tokens R =
// G * N; C the channels.
template <typename T>
cudaError_t launch_plane_stats(const T* x, int G, int N, int C, float* stats,
                               cudaStream_t stream) {
  plane_stats_kernel<T><<<dim3((C + 31) / 32, G), dim3(32, 8), 0, stream>>>(
      x, N, C, stats, stats + (size_t)G * C);
  return cudaGetLastError();
}

template <typename T, typename S, bool kNorm = true>
cudaError_t launch_norm_proj(const S* a, const float* stats, const float* in_w,
                             const float* in_b, const T* w, const float* bias, T* out, int G,
                             int N, int K, int Nout, cudaStream_t stream) {
  const size_t smem = gemm_smem_bytes<T>(kProjMTiles);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(norm_proj_kernel<T, S, kNorm>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return e;
  const int R = G * N;
  norm_proj_kernel<T, S, kNorm><<<dim3((R + 16 * kProjMTiles - 1) / (16 * kProjMTiles),
                                       (Nout + kBN - 1) / kBN),
                                  kGemmThreads, smem, stream>>>(
      a, stats, stats ? stats + (size_t)G * K : nullptr, in_w, in_b, w, bias, out, R, N, K, Nout);
  return cudaGetLastError();
}

template <typename T, typename O, bool kAdd = false>
cudaError_t launch_gemm_nt(const T* A, const T* Bt, O* out, int M, int Nc, int K,
                           cudaStream_t stream) {
  const size_t smem = gemm_smem_bytes<T>(kTileM / 16);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(gemm_nt_kernel<T, O, kAdd>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return e;
  gemm_nt_kernel<T, O, kAdd><<<dim3((M + kTileM - 1) / kTileM, (Nc + kBN - 1) / kBN),
                               kGemmThreads, smem, stream>>>(A, Bt, out, M, Nc, K);
  return cudaGetLastError();
}

// dW (M, Nc) += D^T . norm(src) over R tokens in ~32 chunks per tile.
template <typename T, typename S, bool kNorm>
cudaError_t launch_wgrad(const T* D, int M, const S* src, const float* stats, const float* w,
                         const float* b, int Nc, int G, int N, float* dW, cudaStream_t stream) {
  const int R = G * N;
  const int chunk = (((R + 31) / 32 + kKC - 1) / kKC * kKC);
  const int ck = chunk < kKC ? kKC : chunk;
  const size_t smem = gemm_smem_bytes<T>(kTileM / 16);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(wgrad_kernel<T, S, kNorm>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return e;
  wgrad_kernel<T, S, kNorm><<<dim3((M + kTileM - 1) / kTileM, (Nc + kBN - 1) / kBN,
                                   (R + ck - 1) / ck),
                              kGemmThreads, smem, stream>>>(
      D, M, src, stats, stats ? stats + (size_t)G * Nc : nullptr, w, b, Nc, R, N, ck, dW);
  return cudaGetLastError();
}

template <typename A, typename S>
cudaError_t launch_plane_sums(const A* a, const S* src, const float* stats, int G, int N, int C,
                              float* sums, float* dscale, float* dbias, cudaStream_t stream) {
  plane_sums_kernel<A, S><<<dim3((C + 31) / 32, G), dim3(32, 8), 0, stream>>>(
      a, src, stats, stats ? stats + (size_t)G * C : nullptr, N, C, sums, dscale, dbias);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_in_apply(const float* dy, const S* x, const float* stats, const float* w,
                            const float* sums, T* dx, int G, int N, int C, cudaStream_t stream) {
  in_apply_kernel<T, S><<<1024, 256, 0, stream>>>(dy, x, stats, stats + (size_t)G * C, w, sums,
                                                  dx, G, N, C);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bft
