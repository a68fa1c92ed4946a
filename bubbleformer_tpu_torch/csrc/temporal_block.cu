// K1: the whole temporal-attention branch, forward, hand-written for Hopper
// (sm_90a); and K3, its streamed core (bf_core_temporal_fwd, at the end): in
// bf16 the QKV product and the attention pass of K1's bf16 chain, in float32
// launch (b) alone.  Head dims 16 and 64 (template D).
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
// can hold, so the branch runs as a chain of launches.
//
// bf16 (the training dtype) runs K1's math on Hopper's own units
// (run_temporal_block_hopper): IN1's statistics (plane_stats_kernel), xn =
// bf16(IN1(x)) written once (in_norm_kernel, temporal_hopper.cuh), the QKV
// product on the hand-written TMA + wgmma GEMM (hopper_gemm.cuh) with the
// bias added and the rounded qkv stored (the backward's residual), the
// attention pass (temporal_attention_kernel: qk-LN, T x T softmax with the
// T5 bias and the blend, writing ao in float32 and rounded), IN2's
// statistics of the float32 ao, y2 = bf16(IN2(ao)), and the output product
// on the GEMM with (gamma W_out, gamma b_out).  What bounds it at
// FiLMAViT-small's training shape (B=8, T=5, 32x32 tokens, C=384): 48.3
// GFLOP of products (0.05 ms at the bf16 peak) against ~0.63 GB of traffic
// (0.19 ms): bytes.  The products run at a quarter to a half of the tensor
// cores' peak; the passes around them at about a third of the memory rate.
//
// float32 keeps the first version's four launches (run_temporal_block),
// its products on block_gemm.cuh's FMA tile (no TF32):
//   (a) plane_stats_kernel (block_ops.cuh): per-(b, t, c) mean and rstd of x
//       over N (IN1);
//   (b) qkv_attention_kernel: one block per (16 spatial positions x all T
//       steps, group of heads): normalise the x rows, multiply by the group's
//       contiguous slice of W_qkv (HeadGroup below), add the bias, qk-LN, the
//       T x T attention, and write the attention output `ao` in float32 (the
//       TPU kernel's f32 ao scratch), a copy of it rounded to the activation
//       dtype (the TPU kernel's ao_ref, the residual its backward recomputes
//       IN2 from, temporal_block_mega.py:259, :325) and the rounded raw qkv,
//       which the backward reads instead of redoing the product;
//   (c) plane_stats_kernel over ao (IN2);
//   (d) norm_proj_kernel (block_ops.cuh): IN2 apply, multiply by
//       (W_out * gamma), add (b_out * gamma).
// Rounding follows the TPU kernel (temporal_block_mega.py:246-266) in both:
// xn, qkv, q/k (after LN) and v, y2 and out are rounded to the activation
// dtype; ao and every statistic stay float32.
#include <cmath>

#include "block_ops.cuh"
#include "common.cuh"
#include "hopper_gemm.cuh"
#include "temporal_hopper.cuh"

namespace bft {
namespace {

constexpr int kP = 16;              // spatial positions per attention block
constexpr int kMaxT = 8;            // time steps (GEMM rows = 16 * T <= 128)
constexpr int kThreads = kGemmThreads;
constexpr int kWarps = kThreads / 32;
static_assert(kMaxT <= kMaxMTiles, "16 * T rows fit one GEMM tile");

// The heads of one attention block: their q|k|v columns (3D each, contiguous
// in the heads-major W_qkv) are one GEMM tile of at most kBN = 192 columns.
// d = 64: one head, 192 columns.  d = 16: three heads, 144 columns.  Four
// would fill the tile, but 6 (AViT-tiny's heads) is not a multiple of 4;
// three divide 6 and 12, and each group re-reads and normalises the tile's x
// rows, so fewer, wider groups read x fewer times (two per tile at 6 heads,
// where one head per block would read it six times).
template <int D>
struct HeadGroup {
  static constexpr int kHeads = D == 64 ? 1 : 3;
  static constexpr int kCols = 3 * D * kHeads;
  static_assert(kCols <= kBN && kCols % 16 == 0, "a head group is one GEMM tile");
};

// (b) at head dim 64, one head per block (grid (N / kP, heads, B)).  The
// head-group kernel below computes the same at d = 64, but ran K3's forward
// 10% slower at AViT-big's width (the same work, scheduled otherwise by
// ptxas), so d = 64 keeps its own kernel.
constexpr int kD = 64;
template <typename T, typename O, bool kNorm>
__global__ void __launch_bounds__(kThreads) qkv_attention64_kernel(
    const T* __restrict__ x, const float* __restrict__ mean1, const float* __restrict__ rstd1,
    const float* __restrict__ in1_w, const float* __restrict__ in1_b,
    const T* __restrict__ wqkv, const float* __restrict__ bqkv, const float* __restrict__ ln,
    const float* __restrict__ bias, const float* __restrict__ scale, T* __restrict__ qkv,
    O* __restrict__ ao, T* __restrict__ ao_r, int steps, int N, int C, int Cin) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * kP, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = kP * steps;

  auto aload = [&](int m, int k) -> T {
    const int g = b * steps + m / kP;
    const T v = x[((size_t)g * N + n0 + m % kP) * Cin + k];
    if constexpr (!kNorm) return v;
    const int s = g * Cin + k;
    return from_f32<T>((to_f32(v) - mean1[s]) * rstd1[s] * in1_w[k] + in1_b[k]);
  };
  const T* w = wqkv + (size_t)h * kBN * Cin;
  auto bload = [&](int n, int k) -> T { return w[(size_t)n * Cin + k]; };
  block_gemm<T, false>(steps, kBN / 16, Cin, aload, bload, smem);
  float* Cs = gemm_out<T>(smem, steps);
  __syncthreads();

  // qkv = dtype(acc + b_qkv), also written out for the backward.
  for (int e = tid; e < rows * kBN; e += kThreads) {
    const int m = e / kBN, j = e % kBN;
    const float v = round_to<T>(Cs[m * kLDC + j] + bqkv[h * kBN + j]);
    Cs[m * kLDC + j] = v;
    if (qkv)
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
    const float inv = 1.f / sqrtf(var + kNormEps);
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
          l[j] = warp_sum(q[lane] * k[lane] + q[lane + 32] * k[lane + 32]) *
                     head_scaling<kD>() +
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
      const size_t at = ((size_t)(b * steps + i) * N + n0 + p) * C + h * kD;
      const float a0 = s_h * o0 + (1.f - s_h) * (m0 * inv_t);
      const float a1 = s_h * o1 + (1.f - s_h) * (m1 * inv_t);
      ao[at + lane] = from_f32<O>(a0);
      ao[at + lane + 32] = from_f32<O>(a1);
      if constexpr (kNorm) {
        ao_r[at + lane] = from_f32<T>(a0);
        ao_r[at + lane + 32] = from_f32<T>(a1);
      }
    }
  }
}

// (b) at head dim 16: grid (N / kP, heads / kHeads, B).  GEMM rows are m = t * kP + p.
// kNorm: the rows of x are normalised by IN1 while staged (K1); without it x
// is already the IN1 output and is read as it is (K3).  ao is written in O:
// float32 for K1's IN2, the activation dtype for K3.  K1 (kNorm) also writes
// ao rounded to the activation dtype into ao_r, the residual its backward
// reads (K3 passes null).  qkv may be null (no backward will read it).
template <typename T, typename O, bool kNorm, int D>
__global__ void __launch_bounds__(kThreads) qkv_attention_kernel(
    const T* __restrict__ x, const float* __restrict__ mean1, const float* __restrict__ rstd1,
    const float* __restrict__ in1_w, const float* __restrict__ in1_b,
    const T* __restrict__ wqkv, const float* __restrict__ bqkv, const float* __restrict__ ln,
    const float* __restrict__ bias, const float* __restrict__ scale, T* __restrict__ qkv,
    O* __restrict__ ao, T* __restrict__ ao_r, int steps, int N, int C, int Cin) {
  using G = HeadGroup<D>;
  constexpr int kPer = HeadRow<D>::kPer;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * kP, h0 = blockIdx.y * G::kHeads, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = kP * steps;
  const int col0 = h0 * 3 * D;  // the group's first column of qkv

  auto aload = [&](int m, int k) -> T {
    const int g = b * steps + m / kP;
    const T v = x[((size_t)g * N + n0 + m % kP) * Cin + k];
    if constexpr (!kNorm) return v;
    const int s = g * Cin + k;
    return from_f32<T>((to_f32(v) - mean1[s]) * rstd1[s] * in1_w[k] + in1_b[k]);
  };
  const T* w = wqkv + (size_t)col0 * Cin;
  auto bload = [&](int n, int k) -> T { return w[(size_t)n * Cin + k]; };
  block_gemm<T, false>(steps, G::kCols / 16, Cin, aload, bload, smem);
  float* Cs = gemm_out<T>(smem, steps);
  __syncthreads();

  // qkv = dtype(acc + b_qkv), also written out for the backward.
  for (int e = tid; e < rows * G::kCols; e += kThreads) {
    const int m = e / G::kCols, j = e % G::kCols;
    const float v = round_to<T>(Cs[m * kLDC + j] + bqkv[col0 + j]);
    Cs[m * kLDC + j] = v;
    if (qkv)
      qkv[((size_t)(b * steps + m / kP) * N + n0 + m % kP) * 3 * C + col0 + j] = from_f32<T>(v);
  }
  __syncthreads();

  // qk-LayerNorm over d (ln rows: q scale, q bias, k scale, k bias), one warp
  // per (row, head, q or k); lanes over d (lane + 32 u).
  auto in_row = [&](int u) { return lane + 32 * u < D; };
  for (int task = warp; task < 2 * G::kHeads * rows; task += kWarps) {
    const int m = task / (2 * G::kHeads), hh = (task / 2) % G::kHeads, comp = task & 1;
    float* r = Cs + m * kLDC + hh * 3 * D + comp * D;
    float a[kPer], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      a[u] = in_row(u) ? r[lane + 32 * u] : 0.f;
      s1 += a[u];
      s2 += a[u] * a[u];
    }
    const float mu = warp_sum(s1) * (1.f / D);
    const float var = fmaxf(warp_sum(s2) * (1.f / D) - mu * mu, 0.f);
    const float inv = 1.f / sqrtf(var + kNormEps);
    const float* g = ln + comp * 2 * D;
    const float* bb = g + D;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int d = lane + 32 * u;
      if (in_row(u)) r[d] = round_to<T>((a[u] - mu) * inv * g[d] + bb[d]);
    }
  }
  __syncthreads();

  // T x T attention: one warp per (spatial position, head), lanes over d,
  // q, k and v read from the shared tile as they are needed.  (Every lane
  // but the first D idles at d = 16: a first version.)
  const float inv_t = 1.f / steps;
  for (int task = warp; task < kP * G::kHeads; task += kWarps) {
    const int p = task / G::kHeads, hh = task % G::kHeads, h = h0 + hh;
    const float s_h = scale[h];
    const float* row0 = Cs + p * kLDC + hh * 3 * D;  // (t = 0, p); step t at t * kP * kLDC
    for (int i = 0; i < steps; ++i) {
      const float* q = row0 + i * kP * kLDC;
      float l[kMaxT];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kMaxT; ++j) {
        if (j < steps) {
          const float* k = row0 + j * kP * kLDC + D;
          float a = 0.f;
#pragma unroll
          for (int u = 0; u < kPer; ++u)
            if (in_row(u)) a += q[lane + 32 * u] * k[lane + 32 * u];
          l[j] = warp_sum(a) * head_scaling<D>() + bias[(h * steps + i) * steps + j];
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
      float o[kPer] = {}, mv[kPer] = {};
#pragma unroll
      for (int j = 0; j < kMaxT; ++j) {
        if (j < steps) {
          const float* v = row0 + j * kP * kLDC + 2 * D;
          const float pj = l[j] * inv_z;
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            if (in_row(u)) {
              o[u] += pj * v[lane + 32 * u];
              mv[u] += v[lane + 32 * u];
            }
          }
        }
      }
      const size_t at = ((size_t)(b * steps + i) * N + n0 + p) * C + h * D;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        if (in_row(u)) {
          const float a = s_h * o[u] + (1.f - s_h) * (mv[u] * inv_t);
          ao[at + lane + 32 * u] = from_f32<O>(a);
          if constexpr (kNorm) ao_r[at + lane + 32 * u] = from_f32<T>(a);
        }
      }
    }
  }
}

// The kernel of launch (b) at head dim D.
template <typename T, typename O, bool kNorm, int D>
auto qkv_attention() {
  if constexpr (D == 64) {
    return qkv_attention64_kernel<T, O, kNorm>;
  } else {
    return qkv_attention_kernel<T, O, kNorm, D>;
  }
}

template <typename T, int D>
int run_temporal_block(const void* x, const float* in1_w, const float* in1_b, const void* wqkv,
                       const float* bqkv, const float* ln, const float* in2_w, const float* in2_b,
                       const void* wout, const float* bout, const float* bias, const float* scale,
                       float* stats1, void* qkv, float* ao, void* ao_r, float* stats2,
                       void* out, int B, int steps, int N, int C, int heads, int Cin,
                       cudaStream_t stream) {
  const int G = B * steps;
  cudaError_t e;
  if ((e = launch_plane_stats<T>(static_cast<const T*>(x), G, N, Cin, stats1, stream)) !=
      cudaSuccess)
    return e;

  auto kernel = qkv_attention<T, float, true, D>();
  const size_t smem_b = gemm_smem_bytes<T>(steps);
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_b)) != cudaSuccess)
    return e;
  kernel<<<dim3(N / kP, heads / HeadGroup<D>::kHeads, B), kThreads, smem_b, stream>>>(
      static_cast<const T*>(x), stats1, stats1 + (size_t)G * Cin, in1_w, in1_b,
      static_cast<const T*>(wqkv), bqkv, ln, bias, scale, static_cast<T*>(qkv), ao,
      static_cast<T*>(ao_r), steps, N, C, Cin);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  if ((e = launch_plane_stats<float>(ao, G, N, C, stats2, stream)) != cudaSuccess) return e;
  return launch_norm_proj<T, float>(ao, stats2, in2_w, in2_b, static_cast<const T*>(wout), bout,
                                    static_cast<T*>(out), G, N, C, Cin, stream);
}

// K1's bf16 forward as a chain of launches, its two products on the Hopper
// GEMM (hopper_gemm.cuh), rounding where the TPU kernel rounds:
//   (a)  plane_stats: IN1's statistics of x;
//   (a') in_norm: xn = bf16(IN1(x)) into the scratch xs;
//   (b1) gemm_nt: qkv = bf16(xn . W_qkv^T + b_qkv), the backward's residual;
//   (b2) temporal_attention: qk-LN, T x T softmax, blend: ao (float32) and
//        ao_r (bf16);
//   (c)  plane_stats: IN2's statistics of the float32 ao;
//   (d') in_norm: y2 = bf16(IN2(ao)) into xs;
//   (d)  gemm_nt: out = bf16(y2 . (gamma W_out)^T + gamma b_out); with
//        partial, out = y2 . (gamma W_out)^T in float32 and no bias (one
//        rank's share of a row-parallel projection).
// x, xn and out are Cin wide; qkv 3C, ao and y2 C (C = heads * D: Cin
// unsharded, Cin / m for one rank's heads).  launch_ms, when given,
// receives each launch's device time (LaunchTimer).
template <int D>
int run_temporal_block_hopper(const __nv_bfloat16* x, const float* in1_w, const float* in1_b,
                              const __nv_bfloat16* wqkv, const float* bqkv, const float* ln,
                              const float* in2_w, const float* in2_b, const __nv_bfloat16* wout,
                              const float* bout, const float* bias, const float* scale,
                              float* stats1, __nv_bfloat16* qkv, float* ao, __nv_bfloat16* ao_r,
                              float* stats2, void* out, __nv_bfloat16* xs, int B, int steps,
                              int N, int C, int heads, int Cin, bool partial,
                              cudaStream_t stream, float* launch_ms) {
  const int G = B * steps, R = G * N;
  LaunchTimer timer(launch_ms, stream);
  cudaError_t e;
#define BFT_TRY(call)                           \
  if ((e = (call)) != cudaSuccess) return e;    \
  timer.mark()
  BFT_TRY(launch_plane_stats<__nv_bfloat16>(x, G, N, Cin, stats1, stream));
  BFT_TRY(launch_in_norm(x, stats1, in1_w, in1_b, xs, G, N, Cin, stream));
  BFT_TRY(hg::gemm_nt<hg::kBiasRound>(xs, Cin, wqkv, Cin, R, 3 * C, Cin, qkv, 3 * C, bqkv,
                                      stream));
  BFT_TRY(launch_temporal_attention<D>(qkv, ln, bias, scale, ao, ao_r, B, steps, N, C, heads,
                                       stream));
  BFT_TRY(launch_plane_stats<float>(ao, G, N, C, stats2, stream));
  BFT_TRY(launch_in_norm(static_cast<const float*>(ao), stats2, in2_w, in2_b, xs, G, N, C,
                         stream));
  BFT_TRY(partial
              ? hg::gemm_nt<hg::kStoreF32>(xs, C, wout, C, R, Cin, C, out, Cin, nullptr, stream)
              : hg::gemm_nt<hg::kBiasRound>(xs, C, wout, C, R, Cin, C, out, Cin, bout, stream));
#undef BFT_TRY
  return timer.finish();
}

// K3 in float32: qkv_attention_kernel alone, on the IN1 output, ao in dtype.
template <typename T, int D>
int run_core_temporal(const void* xn, const void* wqkv, const float* bqkv, const float* ln,
                      const float* bias, const float* scale, void* ao, int B, int steps,
                      int N, int C, int heads, int Cin, cudaStream_t stream) {
  auto kernel = qkv_attention<T, T, false, D>();
  const size_t smem_b = gemm_smem_bytes<T>(steps);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_b)) != cudaSuccess)
    return e;
  kernel<<<dim3(N / kP, heads / HeadGroup<D>::kHeads, B), kThreads, smem_b, stream>>>(
      static_cast<const T*>(xn), nullptr, nullptr, nullptr, nullptr, static_cast<const T*>(wqkv),
      bqkv, ln, bias, scale, nullptr, static_cast<T*>(ao), nullptr, steps, N, C, Cin);
  return cudaGetLastError();
}

// K3's bf16 forward as K1's middle launches, rounding where the TPU kernel
// rounds:
//   (1) gemm_nt: qkv = bf16(xn . W_qkv^T + b_qkv) into the scratch qkv;
//   (2) temporal_attention: qk-LN, T x T softmax, blend; ao rounded to bf16
//       straight into the output (no float32 copy: K3 has no IN2).
// launch_ms, when given, receives each launch's device time (LaunchTimer).
template <int D>
int run_core_temporal_hopper(const __nv_bfloat16* xn, const __nv_bfloat16* wqkv,
                             const float* bqkv, const float* ln, const float* bias,
                             const float* scale, __nv_bfloat16* qkv, __nv_bfloat16* ao, int B,
                             int steps, int N, int C, int heads, int Cin, cudaStream_t stream,
                             float* launch_ms) {
  const int R = B * steps * N;
  LaunchTimer timer(launch_ms, stream);
  cudaError_t e;
#define BFT_TRY(call)                        \
  if ((e = (call)) != cudaSuccess) return e; \
  timer.mark()
  BFT_TRY(hg::gemm_nt<hg::kBiasRound>(xn, Cin, wqkv, Cin, R, 3 * C, Cin, qkv, 3 * C, bqkv,
                                      stream));
  BFT_TRY(launch_temporal_attention<D>(qkv, ln, bias, scale, nullptr, ao, B, steps, N, C, heads,
                                       stream));
#undef BFT_TRY
  return timer.finish();
}

// The kernels' envelope, checked again here (the wrappers check it first):
// head dim 16 or 64, whole head groups, T <= 8, N % 16 == 0, the attention
// width C (heads * head_dim) and the projection width Cin multiples of 32.
bool temporal_shape_ok(int head_dim, int steps, int N, int C, int heads, int Cin) {
  const int group = head_dim == 64 ? HeadGroup<64>::kHeads : HeadGroup<16>::kHeads;
  return (head_dim == 64 || head_dim == 16) && C == heads * head_dim && heads % group == 0 &&
         steps >= 1 && steps <= kMaxT && N % kP == 0 && C % kKC == 0 && Cin > 0 &&
         Cin % kKC == 0;
}

}  // namespace
}  // namespace bft

// x, out: (B, T, N, Cin) in dtype (out float32 with partial); wqkv (3C, Cin)
// and wout (Cin, C) in dtype, torch (out, in) layout, C = heads * head_dim the
// attention width (Cin unsharded; Cin / m for one rank's heads of m under
// tensor parallelism); in1_w, in1_b, bout (Cin); in2_w, in2_b (C); ln (4,
// head_dim) = [q scale; q bias; k scale; k bias]; bias (heads, T, T); scale
// (heads,).  Also written: the float32 scratch of IN2, ao (B*T*N, C) and
// stats2 (2, B*T, C); and for the backward stats1 (2, B*T, Cin) in float32,
// ao_r (B*T*N, C) (ao rounded) and the rounded raw qkv (B*T*N, 3C) in dtype.
// partial: out is the output projection's float32 product without b_out
// (bf16: the GEMM's float32 epilogue; float32: the caller passes zeros as
// bout).  bf16 runs the launch chain above (xs: a (B*T*N, max(C, Cin)) bf16
// scratch; every base 16-byte aligned); float32 runs launches (a)-(d) on
// block_gemm.cuh's FMA tile (xs unused; launch_ms must be null).
// launch_ms: null, or a host array of 7 floats for the bf16 chain's
// per-launch milliseconds (the call then waits for the card).  head_dim 16
// (heads a multiple of 3) or 64, T <= 8, N % 16 == 0 and C % 32 == 0.
// Returns a cudaError_t.
extern "C" int bf_temporal_block_fwd(int dtype, int head_dim, const void* x, const float* in1_w,
                                     const float* in1_b, const void* wqkv, const float* bqkv,
                                     const float* ln, const float* in2_w, const float* in2_b,
                                     const void* wout, const float* bout, const float* bias,
                                     const float* scale, float* stats1, void* qkv, float* ao,
                                     void* ao_r, float* stats2, void* out, void* xs,
                                     float* launch_ms, int B, int steps, int N, int C, int heads,
                                     int Cin, int partial, void* stream) {
  if (!bft::temporal_shape_ok(head_dim, steps, N, C, heads, Cin)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define BFT_RUN(D)                                                                              \
  return bft::run_temporal_block_hopper<D>(                                                     \
      static_cast<const bf16*>(x), in1_w, in1_b, static_cast<const bf16*>(wqkv), bqkv, ln,      \
      in2_w, in2_b, static_cast<const bf16*>(wout), bout, bias, scale, stats1,                  \
      static_cast<bf16*>(qkv), ao, static_cast<bf16*>(ao_r), stats2, out,                       \
      static_cast<bf16*>(xs), B, steps, N, C, heads, Cin, partial != 0, s, launch_ms)
  if (dtype == bft::kBF16 && head_dim == 64) BFT_RUN(64);
  if (dtype == bft::kBF16 && head_dim == 16) BFT_RUN(16);
#undef BFT_RUN
  if (launch_ms != nullptr) return cudaErrorInvalidValue;
#define BFT_RUN(T, D)                                                                           \
  return bft::run_temporal_block<T, D>(x, in1_w, in1_b, wqkv, bqkv, ln, in2_w, in2_b, wout, bout, \
                                       bias, scale, stats1, qkv, ao, ao_r, stats2, out, B,      \
                                       steps, N, C, heads, Cin, s)
  if (dtype == bft::kF32 && head_dim == 64) BFT_RUN(float, 64);
  if (dtype == bft::kF32 && head_dim == 16) BFT_RUN(float, 16);
#undef BFT_RUN
  return cudaErrorInvalidValue;
}

// K3, the streamed temporal core (replaces
// bubbleformer_tpu/ops/temporal_block_mega.py:_core_fwd_kernel, built by
// _make_temporal_core, entry core_temporal_attention): the QKV projection of
// the IN1 output xn, qk-LN and the T x T attention, writing ao (B, T, N, C)
// (B, T, N, C) in dtype and nothing else: as on the TPU, the backward
// projects again.  xn (B, T, N, Cin) in dtype; wqkv (3C, Cin) in dtype (C =
// heads * head_dim, as for bf_temporal_block_fwd); head_dim, ln, bias and
// scale as there.
//
// What bounds it at AViT-big's training shape (B=8, T=5, 32x32 tokens,
// C=768, 12 heads): the QKV product, 2*R*C*3C = 145 GFLOP for R = 40960
// tokens, against ~63 MB of xn and ao in bf16: the tensor cores, 0.15 ms
// at the bf16 peak.  bf16 runs run_core_temporal_hopper: the product on the
// Hopper GEMM into qkv, a (B*T*N, 3C) bf16 scratch (189 MB there, written
// once and read once by the attention pass, ~0.11 ms of traffic), then the
// attention pass.  float32 runs launch (b) above without IN1, its product on
// block_gemm.cuh's FMA tile (qkv unused; launch_ms must be null).
// launch_ms: null, or a host array of 2 floats for the bf16 chain's
// per-launch milliseconds (the call then waits for the card).  Every base
// 16-byte aligned.  Returns a cudaError_t.
extern "C" int bf_core_temporal_fwd(int dtype, int head_dim, const void* xn, const void* wqkv,
                                    const float* bqkv, const float* ln, const float* bias,
                                    const float* scale, void* qkv, void* ao, float* launch_ms,
                                    int B, int steps, int N, int C, int heads, int Cin,
                                    void* stream) {
  if (!bft::temporal_shape_ok(head_dim, steps, N, C, heads, Cin)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define BFT_RUN(D)                                                                             \
  return bft::run_core_temporal_hopper<D>(                                                     \
      static_cast<const bf16*>(xn), static_cast<const bf16*>(wqkv), bqkv, ln, bias, scale,     \
      static_cast<bf16*>(qkv), static_cast<bf16*>(ao), B, steps, N, C, heads, Cin, s,        \
      launch_ms)
  if (dtype == bft::kBF16 && head_dim == 64) BFT_RUN(64);
  if (dtype == bft::kBF16 && head_dim == 16) BFT_RUN(16);
#undef BFT_RUN
  if (launch_ms != nullptr) return cudaErrorInvalidValue;
#define BFT_RUN(D)                                                                            \
  return bft::run_core_temporal<float, D>(xn, wqkv, bqkv, ln, bias, scale, ao, B, steps, N, C, \
                                          heads, Cin, s)
  if (dtype == bft::kF32 && head_dim == 64) BFT_RUN(64);
  if (dtype == bft::kF32 && head_dim == 16) BFT_RUN(16);
#undef BFT_RUN
  return cudaErrorInvalidValue;
}

extern "C" const char* bf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
