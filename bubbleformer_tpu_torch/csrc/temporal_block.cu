// K1: the whole temporal-attention branch, forward, hand-written for Hopper
// (sm_90a).
//
// Replaces bubbleformer_tpu/ops/temporal_block_mega.py:_fwd_kernel (built by
// _make_temporal_block, entry mega_temporal_block): InstanceNorm1 -> QKV
// projection (C -> 3C, heads-major [q|k|v]) -> per-head qk-LayerNorm -> T x T
// softmax attention with the T5 bias and the attn_scale blend
// s*P@V + (1-s)*mean_t V -> InstanceNorm2 -> output projection (LayerScale
// gamma folded into W_out and b_out by the caller).  The residual add stays
// outside, as on the TPU.
//
// Split.  The TPU kernel held a whole (C, T*N) image slab in VMEM; the
// InstanceNorm statistics span all N tokens of a (b, t) plane, which no SM
// can hold, so the branch runs as four launches:
//   (a) plane_stats_kernel: per-(b, t, c) mean and rstd of x over N (IN1);
//   (b) qkv_attention_kernel: one block per (16 spatial positions x all T
//       steps, head): normalise the x rows, multiply by that head's
//       contiguous 192-column slice of W_qkv, add the bias, qk-LN, the T x T
//       attention, and write the attention output `ao` in float32 (the TPU
//       kernel's f32 ao scratch) and the rounded raw qkv, which the backward
//       reads instead of redoing the product;
//   (c) plane_stats_kernel over ao (IN2);
//   (d) out_proj_kernel: IN2 apply, multiply by (W_out * gamma), add
//       (b_out * gamma).
// Rounding follows the TPU kernel (temporal_block_mega.py:246-266): xn, qkv,
// q/k (after LN) and v, y2 and out are rounded to the activation dtype; ao
// and every statistic stay float32.
//
// What bounds it at the slice shape (B=1, T=5, 32x32 tokens, C=384, 6 heads,
// per block per window): the QKV product is ~4.5 GFLOP and the output
// product ~1.5 GFLOP; activations are ~4 MB in bf16 (x, out) plus 7.9 MB of
// f32 ao and 11.8 MB of bf16 qkv kept for the backward.  Both products run in bf16 on the tensor cores through WMMA
// (16x16x16, f32 accumulate) and in float32 as an FMA loop; at these sizes
// the kernel is bound by latency and the x re-reads (each of the 6 head
// blocks of a tile normalises the same x rows), not by either roofline.
// The GEMM tile is block_gemm.cuh's, shared with the backward kernels
// (temporal_block_bwd.cu).  Left for later: wgmma/TMA pipelining, one block
// for all heads of a tile (x read once), keeping ao on chip (a thread-block
// cluster holding a whole plane) instead of its f32 round trip through
// device memory.
#include <cmath>

#include "block_gemm.cuh"
#include "common.cuh"

namespace bft {
namespace {

constexpr int kD = 64;              // head dim
constexpr int kP = 16;              // spatial positions per attention block
constexpr int kMaxT = 8;            // time steps (GEMM rows = 16 * T <= 128)
constexpr int kThreads = kGemmThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kOutMTiles = 4;       // out-projection rows per block: 64
constexpr float kEps = 1e-5f;
constexpr float kScaling = 0.125f;  // kD ** -0.5
static_assert(kMaxT <= kMaxMTiles && 3 * kD == kBN, "one head's q|k|v is one GEMM tile");

// (a), (c): mean and rstd over the N rows of each (plane, channel) of a
// (G, N, C) tensor; single pass E[x^2] - E[x]^2 in float32, as the TPU
// kernel's _in_fwd_t, but on the values shifted by the plane's first row.
// Unshifted, the difference cancels wherever a channel's mean is far above
// its spread (FiLM with |beta| >> |gamma|); shifted by a sample of the
// plane, the sums are of deviations and the cancellation is gone.
// Block (32 channels, 8 row phases).
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
    rstd[(size_t)g * C + c] = 1.f / sqrtf(var + kEps);
  }
}

// (b): grid (N / kP, heads, B).  GEMM rows are m = t * kP + p.
template <typename T>
__global__ void __launch_bounds__(kThreads) qkv_attention_kernel(
    const T* __restrict__ x, const float* __restrict__ mean1, const float* __restrict__ rstd1,
    const float* __restrict__ in1_w, const float* __restrict__ in1_b,
    const T* __restrict__ wqkv, const float* __restrict__ bqkv, const float* __restrict__ ln,
    const float* __restrict__ bias, const float* __restrict__ scale, T* __restrict__ qkv,
    float* __restrict__ ao, int steps, int N, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * kP, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = kP * steps;

  auto aload = [&](int m, int k) -> T {
    const int g = b * steps + m / kP;
    const float v = to_f32(x[((size_t)g * N + n0 + m % kP) * C + k]);
    const int s = g * C + k;
    return from_f32<T>((v - mean1[s]) * rstd1[s] * in1_w[k] + in1_b[k]);
  };
  const T* w = wqkv + (size_t)h * kBN * C;
  auto bload = [&](int n, int k) -> T { return w[(size_t)n * C + k]; };
  block_gemm<T, false>(steps, kBN / 16, C, aload, bload, smem);
  float* Cs = gemm_out<T>(smem, steps);
  __syncthreads();

  // qkv = dtype(acc + b_qkv), also written out for the backward.
  for (int e = tid; e < rows * kBN; e += kThreads) {
    const int m = e / kBN, j = e % kBN;
    const float v = round_to<T>(Cs[m * kLDC + j] + bqkv[h * kBN + j]);
    Cs[m * kLDC + j] = v;
    qkv[((size_t)(b * steps + m / kP) * N + n0 + m % kP) * 3 * C + h * kBN + j] = from_f32<T>(v);
  }
  __syncthreads();

  // qk-LayerNorm over d (ln rows: q scale, q bias, k scale, k bias).
  for (int task = warp; task < 2 * rows; task += kWarps) {
    const int m = task >> 1, comp = task & 1;
    float* r = Cs + m * kLDC + comp * kD;
    const float a0 = r[lane], a1 = r[lane + 32];
    const float mu = warp_sum(a0 + a1) * (1.f / kD);
    const float var = fmaxf(warp_sum(a0 * a0 + a1 * a1) * (1.f / kD) - mu * mu, 0.f);
    const float inv = 1.f / sqrtf(var + kEps);
    const float* g = ln + comp * 2 * kD;
    const float* bb = g + kD;
    r[lane] = round_to<T>((a0 - mu) * inv * g[lane] + bb[lane]);
    r[lane + 32] = round_to<T>((a1 - mu) * inv * g[lane + 32] + bb[lane + 32]);
  }
  __syncthreads();

  // T x T attention: one warp per spatial position, lanes over d.
  const float s_h = scale[h];
  const float inv_t = 1.f / steps;
  for (int p = warp; p < kP; p += kWarps) {
    for (int i = 0; i < steps; ++i) {
      const float* q = Cs + (i * kP + p) * kLDC;
      float l[kMaxT];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kMaxT; ++j) {
        if (j < steps) {
          const float* k = Cs + (j * kP + p) * kLDC + kD;
          l[j] = warp_sum(q[lane] * k[lane] + q[lane + 32] * k[lane + 32]) * kScaling +
                 bias[(h * steps + i) * steps + j];
          mx = fmaxf(mx, l[j]);
        }
      }
      float z = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxT; ++j) {
        if (j < steps) {
          l[j] = expf(l[j] - mx);
          z += l[j];
        }
      }
      const float inv_z = 1.f / z;
      float o0 = 0.f, o1 = 0.f, m0 = 0.f, m1 = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxT; ++j) {
        if (j < steps) {
          const float* v = Cs + (j * kP + p) * kLDC + 2 * kD;
          const float pj = l[j] * inv_z;
          o0 += pj * v[lane];
          o1 += pj * v[lane + 32];
          m0 += v[lane];
          m1 += v[lane + 32];
        }
      }
      float* dst = ao + ((size_t)(b * steps + i) * N + n0 + p) * C + h * kD;
      dst[lane] = s_h * o0 + (1.f - s_h) * (m0 * inv_t);
      dst[lane + 32] = s_h * o1 + (1.f - s_h) * (m1 * inv_t);
    }
  }
}

// (d): grid (ceil(rows / 64), ceil(C / kBN)).
template <typename T>
__global__ void __launch_bounds__(kThreads) out_proj_kernel(
    const float* __restrict__ ao, const float* __restrict__ mean2, const float* __restrict__ rstd2,
    const float* __restrict__ in2_w, const float* __restrict__ in2_b,
    const T* __restrict__ wout, const float* __restrict__ bout, T* __restrict__ out,
    int rows_total, int N, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int r0 = blockIdx.x * 16 * kOutMTiles, n0 = blockIdx.y * kBN;
  const int n_tiles = min(kBN, C - n0) / 16;

  auto aload = [&](int m, int k) -> T {
    const int r = r0 + m;
    if (r >= rows_total) return from_f32<T>(0.f);
    const int s = (r / N) * C + k;
    return from_f32<T>((ao[(size_t)r * C + k] - mean2[s]) * rstd2[s] * in2_w[k] + in2_b[k]);
  };
  auto bload = [&](int n, int k) -> T { return wout[(size_t)(n0 + n) * C + k]; };
  block_gemm<T, false>(kOutMTiles, n_tiles, C, aload, bload, smem);
  const float* Cs = gemm_out<T>(smem, kOutMTiles);
  __syncthreads();

  const int cols = 16 * n_tiles;
  for (int e = threadIdx.x; e < 16 * kOutMTiles * cols; e += kThreads) {
    const int m = e / cols, j = e % cols, r = r0 + m;
    if (r < rows_total) out[(size_t)r * C + n0 + j] = from_f32<T>(Cs[m * kLDC + j] + bout[n0 + j]);
  }
}

template <typename T>
int run_temporal_block(const void* x, const float* in1_w, const float* in1_b, const void* wqkv,
                       const float* bqkv, const float* ln, const float* in2_w, const float* in2_b,
                       const void* wout, const float* bout, const float* bias, const float* scale,
                       float* stats1, void* qkv, float* ao, float* stats2, void* out, int B,
                       int steps, int N, int C, int heads, cudaStream_t stream) {
  const int G = B * steps;
  const dim3 sgrid((C + 31) / 32, G), sblock(32, 8);
  cudaError_t e;

  plane_stats_kernel<T><<<sgrid, sblock, 0, stream>>>(static_cast<const T*>(x), N, C, stats1,
                                                      stats1 + (size_t)G * C);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t smem_b = gemm_smem_bytes<T>(steps);
  if ((e = cudaFuncSetAttribute(qkv_attention_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b)) !=
      cudaSuccess)
    return e;
  qkv_attention_kernel<T><<<dim3(N / kP, heads, B), kThreads, smem_b, stream>>>(
      static_cast<const T*>(x), stats1, stats1 + (size_t)G * C, in1_w, in1_b,
      static_cast<const T*>(wqkv), bqkv, ln, bias, scale, static_cast<T*>(qkv), ao, steps, N,
      C);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  plane_stats_kernel<float><<<sgrid, sblock, 0, stream>>>(ao, N, C, stats2,
                                                          stats2 + (size_t)G * C);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t smem_d = gemm_smem_bytes<T>(kOutMTiles);
  if ((e = cudaFuncSetAttribute(out_proj_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_d)) != cudaSuccess)
    return e;
  const int rows = G * N;
  out_proj_kernel<T><<<dim3((rows + 16 * kOutMTiles - 1) / (16 * kOutMTiles), (C + kBN - 1) / kBN),
                       kThreads, smem_d, stream>>>(ao, stats2, stats2 + (size_t)G * C, in2_w,
                                                   in2_b, static_cast<const T*>(wout), bout,
                                                   static_cast<T*>(out), rows, N, C);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bft

// x, out: (B, T, N, C) in dtype; wqkv (3C, C) and wout (C, C) in dtype, torch
// (out, in) layout; ln (4, 64) = [q scale; q bias; k scale; k bias]; bias
// (heads, T, T); scale (heads,).  Also written, for the backward: stats1 and
// stats2 (2, B*T, C) and ao (B*T*N, C) in float32, and the rounded raw qkv
// (B*T*N, 3C) in dtype.  The wrapper checks head_dim == 64, T <= 8,
// N % 16 == 0 and C % 32 == 0.  Returns a cudaError_t.
extern "C" int bf_temporal_block_fwd(int dtype, const void* x, const float* in1_w,
                                     const float* in1_b, const void* wqkv, const float* bqkv,
                                     const float* ln, const float* in2_w, const float* in2_b,
                                     const void* wout, const float* bout, const float* bias,
                                     const float* scale, float* stats1, void* qkv, float* ao,
                                     float* stats2, void* out, int B, int steps, int N, int C,
                                     int heads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bft::kF32)
    return bft::run_temporal_block<float>(x, in1_w, in1_b, wqkv, bqkv, ln, in2_w, in2_b, wout,
                                          bout, bias, scale, stats1, qkv, ao, stats2, out, B,
                                          steps, N, C, heads, s);
  if (dtype == bft::kBF16)
    return bft::run_temporal_block<__nv_bfloat16>(x, in1_w, in1_b, wqkv, bqkv, ln, in2_w, in2_b,
                                                  wout, bout, bias, scale, stats1, qkv, ao,
                                                  stats2, out, B, steps, N, C, heads, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* bf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
