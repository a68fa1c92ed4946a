// K1: the whole temporal-attention branch, backward, hand-written for Hopper
// (sm_90a); and K3's backward, launches (5)-(8) alone (bf_core_temporal_bwd,
// at the end).
//
// Replaces bubbleformer_tpu/ops/temporal_block_mega.py:_bwd_kernel (built by
// _make_temporal_block, custom VJP fused_bwd): every gradient of the branch
// IN1 -> QKV -> qk-LN -> T x T attention (T5 bias, s*P + (1-s)/T) -> IN2 ->
// output projection, from the output gradient `do` and the forward kernel's
// residuals (the rounded raw qkv, the float32 attention output `ao` and both
// InstanceNorms' statistics, temporal_block.cu).
//
// Split.  The InstanceNorm backward needs plane-wide means of dy and
// dy * xhat over all N tokens of a (b, t) plane, and every parameter
// gradient is a sum over all B*T*N tokens, so the TPU kernel's one grid
// step per image becomes ten launches on one stream:
//   (1) gemm_nt:       dy2 = do . W_out                       (float32 scratch)
//   (2) wgrad:         dW_out += do^T . y2, y2 = IN2(ao) recomputed while staged
//   (3) plane_sums:    db_out = sum do
//   (4) plane_sums:    per plane sum dy2 and sum dy2 * xhat2; d(in2 scale, bias)
//   (5) attention_bwd: one block per (16 positions x all T, head): stage the
//       head's raw q|k|v as the forward wrote it, redo the qk-LN, dao =
//       IN2-backward of dy2 (rounded to the activation dtype), then per
//       position and head the
//       TPU kernel's row algebra (w_ij = dao_i . v_j, dp = s w, dl = p (dp -
//       sum p dp), dq, dk, dv), the qk-LN backward, and dqkv in the
//       activation dtype; d(T5 table), d(attn scale), d(qk-LN) summed in the
//       block, then added atomically;
//   (6) wgrad:         dW_qkv += dqkv^T . xn, xn = IN1(x) recomputed
//   (7) plane_sums:    db_qkv = sum dqkv
//   (8) gemm_nt:       dxn = dqkv . W_qkv                     (float32 scratch)
//   (9) plane_sums:    per plane sum dxn and sum dxn * xhat1; d(in1 scale, bias)
//   (10) in_apply:     dx = rstd1 * w1 * (dxn - mean(dxn) - xhat1 mean(dxn xhat1))
// The four products the TPU kernel computes in VMEM (dy2, dW_out, dxn,
// dW_qkv) run on block_gemm.cuh's tile: WMMA for bf16, FMA for float32.
// Reductions across blocks are float32 atomicAdd into zeroed outputs (the
// weight gradients split the token axis into ~32 chunks per tile), so their
// last bits vary from run to run; a second, ordered pass would fix them at
// the price of a partial buffer per chunk.
//
// Rounding follows the TPU kernel (temporal_block_mega.py:324-449): dao,
// s*dao and the raw-component dqkv in the activation dtype, dx returned in
// it, everything else float32.  The IN2 recompute reads the float32 ao the
// forward wrote (the TPU kernel re-reads a rounded copy), and the attention
// pass reads the forward's rounded qkv where the TPU kernel redoes IN1 and
// the QKV product: the same values, for 4.5 of 16.6 GFLOP less per block at
// batch 1 and one residual of B*T*N*3C activation-dtype values more.
//
// What bounds it at the rollout shape (B=1, T=5, 32x32 tokens, C=384, 6
// heads): ~12.1 GFLOP (dy2 and dW_out 1.5 each, dxn and dW_qkv 4.5 each)
// against ~35 MB of bf16/f32 traffic, so the tensor cores bound it; this
// first version is bound by its simple staging (no cp.async or wgmma,
// transposed loads for the weight gradients) and the float32 dy2/dxn round
// trips.
#include <algorithm>
#include <cmath>

#include "block_gemm.cuh"
#include "common.cuh"

namespace bft {
namespace {

constexpr int kD = 64;
constexpr int kP = 16;              // spatial positions per attention block
constexpr int kMaxT = 8;
constexpr int kThreads = kGemmThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kTileM = 64;          // rows of the gemm_nt / wgrad tiles
constexpr float kEps = 1e-5f;
constexpr float kScaling = 0.125f;  // kD ** -0.5

// (1), (8): out[r, n] = sum_k A[r, k] * Bt[n, k]; A (M, K), Bt (Nc, K) in T,
// out (M, Nc) in O (float32 for K1's scratch, the activation dtype for K3's
// dxn).  Grid (ceil(M / 64), ceil(Nc / 192)).
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads) gemm_nt_kernel(const T* __restrict__ A,
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
  for (int e = threadIdx.x; e < kTileM * cols; e += kThreads) {
    const int m = e / cols, j = e % cols, r = r0 + m;
    if (r < M) out[(size_t)r * Nc + n0 + j] = from_f32<O>(Cs[m * kLDC + j]);
  }
}

// (2), (6): dW[m, n] += sum_{r in chunk} D[r, m] * norm(src[r, n]), with
// norm(v) = T((v - mean[g, n]) * rstd[g, n] * w[n] + b[n]), g = r / N: the
// forward's rounded IN output recomputed while it is staged.  D (R, M) in T,
// src (R, Nc) in S, dW (M, Nc) float32.  Grid (ceil(M / 64), ceil(Nc / 192),
// ceil(R / chunk)); chunk a multiple of kKC.  Without kNorm, src is read as
// it is (K3: it already is the rounded IN output) and mean, rstd, w, b are
// unused.
template <typename T, typename S, bool kNorm>
__global__ void __launch_bounds__(kThreads) wgrad_kernel(
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
  for (int e = threadIdx.x; e < 16 * m_tiles * cols; e += kThreads) {
    const int m = e / cols, j = e % cols;
    atomicAdd(&dW[(size_t)(m0 + m) * Nc + n0 + j], Cs[m * kLDC + j]);
  }
}

// (3), (4), (7), (9): per (plane g, channel c) of a (G, N, C) tensor a,
// s0 = sum_n a and, when src is given, s1 = sum_n a * xhat with
// xhat = (src - mean) * rstd.  Writes sums (2, G, C) = [s0; s1] when given,
// and adds s0 into dbias[c] and s1 into dscale[c] when given.  Block (32
// channels, 8 row phases), grid (ceil(C / 32), G).
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

// Two lanes' values of one 64-wide head row: d = lane and lane + 32.
struct Pair {
  float a, b;
};

__device__ __forceinline__ float dot64(Pair x, Pair y) { return warp_sum(x.a * y.a + x.b * y.b); }

// (5): grid (N / kP, heads, B), kThreads threads, kP * steps * kLDC floats of
// dynamic shared memory; tile rows m = t * kP + p.  kDirect: dao is read
// from dao_in (K3, the output gradient in dtype) instead of being the IN2
// backward of dy2 (K1; dy2, ao, mean2, rstd2, in2_w and sums2 are then
// unused).
template <typename T, bool kDirect>
__global__ void __launch_bounds__(kThreads) attention_bwd_kernel(
    const T* __restrict__ qkv, const float* __restrict__ ln, const float* __restrict__ bias,
    const float* __restrict__ scale, const float* __restrict__ dy2, const float* __restrict__ ao,
    const float* __restrict__ mean2, const float* __restrict__ rstd2,
    const float* __restrict__ in2_w, const float* __restrict__ sums2,
    const T* __restrict__ dao_in, T* __restrict__ dqkv,
    float* __restrict__ dln, float* __restrict__ dbias, float* __restrict__ dscale, int steps,
    int N, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float dbias_s[kMaxT * kMaxT];
  __shared__ float dln_s[4 * kD];
  __shared__ float dscale_s;
  const int n0 = blockIdx.x * kP, h = blockIdx.y, b = blockIdx.z;
  const int G = gridDim.z * steps;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = kP * steps;

  for (int e = tid; e < kMaxT * kMaxT; e += kThreads) dbias_s[e] = 0.f;
  for (int e = tid; e < 4 * kD; e += kThreads) dln_s[e] = 0.f;
  if (tid == 0) dscale_s = 0.f;

  // Stage this head's raw q|k|v rows of the tile, as the forward wrote them.
  float* Cs = reinterpret_cast<float*>(smem);
  for (int e = tid; e < rows * kBN; e += kThreads) {
    const int m = e / kBN, j = e % kBN;
    Cs[m * kLDC + j] =
        to_f32(qkv[((size_t)(b * steps + m / kP) * N + n0 + m % kP) * 3 * C + h * kBN + j]);
  }
  __syncthreads();

  // qk-LayerNorm of a raw row: xhat and the rounded output.
  auto layer_norm = [&](const float* r, int comp, Pair& xhat, float& inv) -> Pair {
    const float a0 = r[lane], a1 = r[lane + 32];
    const float mu = warp_sum(a0 + a1) * (1.f / kD);
    const float var = fmaxf(warp_sum(a0 * a0 + a1 * a1) * (1.f / kD) - mu * mu, 0.f);
    inv = 1.f / sqrtf(var + kEps);
    xhat = {(a0 - mu) * inv, (a1 - mu) * inv};
    const float* g = ln + comp * 2 * kD;
    const float* bb = g + kD;
    return {round_to<T>(xhat.a * g[lane] + bb[lane]),
            round_to<T>(xhat.b * g[lane + 32] + bb[lane + 32])};
  };

  const float s_h = scale[h];
  const float inv_t = 1.f / steps;
  Pair dln_acc[4] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
  float dscale_acc = 0.f;
  for (int p = warp; p < kP; p += kWarps) {
    Pair q[kMaxT], k[kMaxT], v[kMaxT], dao[kMaxT];
    Pair bsum = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      if (t < steps) {
        const float* r = Cs + (t * kP + p) * kLDC;
        Pair xh;
        float inv;
        q[t] = layer_norm(r, 0, xh, inv);
        k[t] = layer_norm(r + kD, 1, xh, inv);
        v[t] = {r[2 * kD + lane], r[2 * kD + lane + 32]};
        // dao = IN2 backward of dy2 at this token, rounded (K1), or as given (K3).
        const int g = b * steps + t;
        const size_t row = (size_t)g * N + n0 + p;
        float dv2[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = h * kD + lane + 32 * u;
          if constexpr (kDirect) {
            dv2[u] = to_f32(dao_in[row * C + c]);
          } else {
            const int s = g * C + c;
            const float xh2 = (ao[row * C + c] - mean2[s]) * rstd2[s];
            dv2[u] = round_to<T>(rstd2[s] * in2_w[c] *
                                 (dy2[row * C + c] - sums2[s] / N -
                                  xh2 * (sums2[(size_t)G * C + s] / N)));
          }
        }
        dao[t] = {dv2[0], dv2[1]};
        bsum.a += (1.f - s_h) * dao[t].a * inv_t;
        bsum.b += (1.f - s_h) * dao[t].b * inv_t;
      }
    }

    Pair dq[kMaxT], dk[kMaxT], dv[kMaxT];
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) dq[t] = dk[t] = dv[t] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kMaxT; ++i) {
      if (i < steps) {
        float pr[kMaxT], wv[kMaxT];
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kMaxT; ++j) {
          if (j < steps) {
            pr[j] = dot64(q[i], k[j]) * kScaling + bias[(h * steps + i) * steps + j];
            mx = fmaxf(mx, pr[j]);
            wv[j] = dot64(dao[i], v[j]);
          }
        }
        float z = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxT; ++j) {
          if (j < steps) {
            pr[j] = expf(pr[j] - mx);
            z += pr[j];
          }
        }
        const float inv_z = 1.f / z;
        float inner = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxT; ++j) {
          if (j < steps) {
            pr[j] *= inv_z;
            inner += pr[j] * (s_h * wv[j]);
            dscale_acc += (pr[j] - inv_t) * wv[j];
          }
        }
        const Pair sdao = {round_to<T>(s_h * dao[i].a), round_to<T>(s_h * dao[i].b)};
#pragma unroll
        for (int j = 0; j < kMaxT; ++j) {
          if (j < steps) {
            const float dl = pr[j] * (s_h * wv[j] - inner);
            if (lane == 0) atomicAdd(&dbias_s[i * steps + j], dl);
            dq[i].a += dl * k[j].a * kScaling;
            dq[i].b += dl * k[j].b * kScaling;
            dk[j].a += dl * q[i].a * kScaling;
            dk[j].b += dl * q[i].b * kScaling;
            dv[j].a += pr[j] * sdao.a;
            dv[j].b += pr[j] * sdao.b;
          }
        }
      }
    }

    // qk-LayerNorm backward, then dqkv = [dq_raw | dk_raw | dv] in T.
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      if (t < steps) {
        const float* r = Cs + (t * kP + p) * kLDC;
        T* dst = dqkv + ((size_t)(b * steps + t) * N + n0 + p) * 3 * C + h * kBN;
#pragma unroll
        for (int comp = 0; comp < 2; ++comp) {
          Pair xh;
          float inv;
          layer_norm(r + comp * kD, comp, xh, inv);
          const Pair dy = comp == 0 ? dq[t] : dk[t];
          const float* g = ln + comp * 2 * kD;
          const float g0 = dy.a * g[lane], g1 = dy.b * g[lane + 32];
          const float m1 = warp_sum(g0 + g1) * (1.f / kD);
          const float m2 = warp_sum(g0 * xh.a + g1 * xh.b) * (1.f / kD);
          dst[comp * kD + lane] = from_f32<T>(inv * (g0 - m1 - xh.a * m2));
          dst[comp * kD + lane + 32] = from_f32<T>(inv * (g1 - m1 - xh.b * m2));
          dln_acc[2 * comp].a += dy.a * xh.a;
          dln_acc[2 * comp].b += dy.b * xh.b;
          dln_acc[2 * comp + 1].a += dy.a;
          dln_acc[2 * comp + 1].b += dy.b;
        }
        dst[2 * kD + lane] = from_f32<T>(dv[t].a + bsum.a);
        dst[2 * kD + lane + 32] = from_f32<T>(dv[t].b + bsum.b);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    atomicAdd(&dln_s[i * kD + lane], dln_acc[i].a);
    atomicAdd(&dln_s[i * kD + lane + 32], dln_acc[i].b);
  }
  if (lane == 0) atomicAdd(&dscale_s, dscale_acc);
  __syncthreads();
  for (int e = tid; e < steps * steps; e += kThreads)
    atomicAdd(&dbias[h * steps * steps + e], dbias_s[e]);
  for (int e = tid; e < 4 * kD; e += kThreads) atomicAdd(&dln[e], dln_s[e]);
  if (tid == 0) atomicAdd(&dscale[h], dscale_s);
}

// (10): dx = T(rstd1 * w1 * (dxn - s0 / N - xhat1 * s1 / N)) over (G, N, C).
template <typename T>
__global__ void in_apply_kernel(const float* __restrict__ dxn, const T* __restrict__ x,
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
                        (dxn[e] - sums[s] / N - xh * (sums[(size_t)G * C + s] / N)));
  }
}

template <typename T>
int run_temporal_block_bwd(const T* x, const T* dout, const T* qkv, const float* in1_w,
                           const float* in1_b, const T* wqkv_t, const float* ln,
                           const float* in2_w, const float* in2_b, const T* wout_t,
                           const float* bias, const float* scale, const float* stats1,
                           const float* ao, const float* stats2, float* work, float* sums,
                           T* dqkv, T* dx, float* din1, float* dwqkv, float* dbqkv, float* dln,
                           float* din2, float* dwout, float* dbout, float* dbias, float* dscale,
                           int B, int steps, int N, int C, int heads, cudaStream_t stream) {
  const int G = B * steps, R = G * N;
  const float *mean1 = stats1, *rstd1 = stats1 + (size_t)G * C;
  const float *mean2 = stats2, *rstd2 = stats2 + (size_t)G * C;
  const int chunk = std::max(kKC, ((R + 31) / 32 + kKC - 1) / kKC * kKC);  // ~32 chunks of tokens
  const size_t smem_tile = gemm_smem_bytes<T>(kTileM / 16);
  const dim3 sblock(32, 8);
  cudaError_t e;
#define BFT_CHECK()                                      \
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  if ((e = cudaFuncSetAttribute(gemm_nt_kernel<T, float>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_tile)) !=
      cudaSuccess)
    return e;
  if ((e = cudaFuncSetAttribute(wgrad_kernel<T, float, true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_tile)) !=
      cudaSuccess)
    return e;
  if ((e = cudaFuncSetAttribute(wgrad_kernel<T, T, true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_tile)) !=
      cudaSuccess)
    return e;
  const size_t smem_att = sizeof(float) * kP * steps * kLDC;
  if ((e = cudaFuncSetAttribute(attention_bwd_kernel<T, false>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_att)) !=
      cudaSuccess)
    return e;

  // (1) dy2 = do . W_out
  gemm_nt_kernel<T, float><<<dim3((R + kTileM - 1) / kTileM, (C + kBN - 1) / kBN), kThreads,
                             smem_tile, stream>>>(dout, wout_t, work, R, C, C);
  BFT_CHECK();
  // (2) dW_out += do^T . IN2(ao)
  wgrad_kernel<T, float, true><<<dim3((C + kTileM - 1) / kTileM, (C + kBN - 1) / kBN,
                                      (R + chunk - 1) / chunk),
                                 kThreads, smem_tile, stream>>>(dout, C, ao, mean2, rstd2, in2_w,
                                                                in2_b, C, R, N, chunk, dwout);
  BFT_CHECK();
  // (3) db_out
  plane_sums_kernel<T, float><<<dim3((C + 31) / 32, G), sblock, 0, stream>>>(
      dout, nullptr, nullptr, nullptr, N, C, nullptr, nullptr, dbout);
  BFT_CHECK();
  // (4) IN2 backward sums; d(in2 scale, bias)
  plane_sums_kernel<float, float><<<dim3((C + 31) / 32, G), sblock, 0, stream>>>(
      work, ao, mean2, rstd2, N, C, sums, din2, din2 + C);
  BFT_CHECK();
  // (5) attention backward -> dqkv, dln, dbias, dscale
  attention_bwd_kernel<T, false><<<dim3(N / kP, heads, B), kThreads, smem_att, stream>>>(
      qkv, ln, bias, scale, work, ao, mean2, rstd2, in2_w, sums, nullptr, dqkv, dln, dbias,
      dscale, steps, N, C);
  BFT_CHECK();
  // (6) dW_qkv += dqkv^T . IN1(x)
  wgrad_kernel<T, T, true><<<dim3((3 * C + kTileM - 1) / kTileM, (C + kBN - 1) / kBN,
                                  (R + chunk - 1) / chunk),
                             kThreads, smem_tile, stream>>>(dqkv, 3 * C, x, mean1, rstd1, in1_w,
                                                            in1_b, C, R, N, chunk, dwqkv);
  BFT_CHECK();
  // (7) db_qkv
  plane_sums_kernel<T, float><<<dim3((3 * C + 31) / 32, G), sblock, 0, stream>>>(
      dqkv, nullptr, nullptr, nullptr, N, 3 * C, nullptr, nullptr, dbqkv);
  BFT_CHECK();
  // (8) dxn = dqkv . W_qkv (into the dy2 scratch, dead since (5))
  gemm_nt_kernel<T, float><<<dim3((R + kTileM - 1) / kTileM, (C + kBN - 1) / kBN), kThreads,
                             smem_tile, stream>>>(dqkv, wqkv_t, work, R, C, 3 * C);
  BFT_CHECK();
  // (9) IN1 backward sums; d(in1 scale, bias)
  plane_sums_kernel<float, T><<<dim3((C + 31) / 32, G), sblock, 0, stream>>>(
      work, x, mean1, rstd1, N, C, sums, din1, din1 + C);
  BFT_CHECK();
  // (10) dx
  in_apply_kernel<T><<<1024, 256, 0, stream>>>(work, x, mean1, rstd1, in1_w, sums, dx, G, N, C);
  BFT_CHECK();
#undef BFT_CHECK
  return cudaSuccess;
}

// K3's backward: launches (5)-(8) of K1's backward, with dao read as it is
// instead of IN2's backward, xn read as it is instead of IN1 recomputed, and
// dxn written rounded to T as dx.
template <typename T>
int run_core_temporal_bwd(const T* xn, const T* dao, const T* qkv, const T* wqkv_t,
                          const float* ln, const float* bias, const float* scale, T* dqkv, T* dx,
                          float* dwqkv, float* dbqkv, float* dln, float* dbias, float* dscale,
                          int B, int steps, int N, int C, int heads, cudaStream_t stream) {
  const int G = B * steps, R = G * N;
  const int chunk = std::max(kKC, ((R + 31) / 32 + kKC - 1) / kKC * kKC);  // ~32 chunks of tokens
  const size_t smem_tile = gemm_smem_bytes<T>(kTileM / 16);
  const size_t smem_att = sizeof(float) * kP * steps * kLDC;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(attention_bwd_kernel<T, true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_att)) !=
      cudaSuccess)
    return e;
  if ((e = cudaFuncSetAttribute(wgrad_kernel<T, T, false>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_tile)) !=
      cudaSuccess)
    return e;
  if ((e = cudaFuncSetAttribute(gemm_nt_kernel<T, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_tile)) != cudaSuccess)
    return e;
  // (5) attention backward -> dqkv, dln, dbias, dscale
  attention_bwd_kernel<T, true><<<dim3(N / kP, heads, B), kThreads, smem_att, stream>>>(
      qkv, ln, bias, scale, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, dao, dqkv, dln,
      dbias, dscale, steps, N, C);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // (6) dW_qkv += dqkv^T . xn
  wgrad_kernel<T, T, false><<<dim3((3 * C + kTileM - 1) / kTileM, (C + kBN - 1) / kBN,
                                   (R + chunk - 1) / chunk),
                              kThreads, smem_tile, stream>>>(dqkv, 3 * C, xn, nullptr, nullptr,
                                                             nullptr, nullptr, C, R, N, chunk,
                                                             dwqkv);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // (7) db_qkv
  plane_sums_kernel<T, float><<<dim3((3 * C + 31) / 32, G), dim3(32, 8), 0, stream>>>(
      dqkv, nullptr, nullptr, nullptr, N, 3 * C, nullptr, nullptr, dbqkv);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // (8) dx = T(dqkv . W_qkv)
  gemm_nt_kernel<T, T><<<dim3((R + kTileM - 1) / kTileM, (C + kBN - 1) / kBN), kThreads,
                         smem_tile, stream>>>(dqkv, wqkv_t, dx, R, C, 3 * C);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bft

// x, dout, dx: (B, T, N, C) in dtype; wqkv_t (C, 3C) and wout_t (C, C) in
// dtype (transposes of the torch (out, in) weights); ln (4, 64); bias (heads,
// T, T); scale (heads,); stats1/stats2 (2, B*T, C), qkv (B*T*N, 3C) and ao
// (B*T*N, C) from bf_temporal_block_fwd; work (B*T*N, C) and sums (2, B*T, C)
// float32 scratch, dqkv (B*T*N, 3C) dtype scratch.  Outputs, float32 and
// zeroed by the caller except dx: din1 (2, C) = [scale; bias], dwqkv (3C, C),
// dbqkv (3C), dln (4, 64), din2 (2, C), dwout (C, C), dbout (C), dbias
// (heads, T, T), dscale (heads).  The wrapper checks head_dim == 64,
// T <= 8, N % 16 == 0 and C % 32 == 0.  Returns a cudaError_t.
extern "C" int bf_temporal_block_bwd(int dtype, const void* x, const void* dout, const void* qkv,
                                     const float* in1_w, const float* in1_b, const void* wqkv_t,
                                     const float* ln, const float* in2_w, const float* in2_b,
                                     const void* wout_t,
                                     const float* bias, const float* scale, const float* stats1,
                                     const float* ao, const float* stats2, float* work,
                                     float* sums, void* dqkv, void* dx, float* din1, float* dwqkv,
                                     float* dbqkv, float* dln, float* din2, float* dwout,
                                     float* dbout, float* dbias, float* dscale, int B, int steps,
                                     int N, int C, int heads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BFT_ARGS(T)                                                                           \
  static_cast<const T*>(x), static_cast<const T*>(dout), static_cast<const T*>(qkv), in1_w,   \
      in1_b, static_cast<const T*>(wqkv_t), ln, in2_w, in2_b,                                 \
      static_cast<const T*>(wout_t), bias, scale, stats1, ao, stats2, work, sums,             \
      static_cast<T*>(dqkv), static_cast<T*>(dx), din1, dwqkv, dbqkv, dln, din2, dwout, dbout, \
      dbias, dscale, B, steps, N, C, heads, s
  if (dtype == bft::kF32) return bft::run_temporal_block_bwd<float>(BFT_ARGS(float));
  if (dtype == bft::kBF16) return bft::run_temporal_block_bwd<__nv_bfloat16>(BFT_ARGS(__nv_bfloat16));
#undef BFT_ARGS
  return cudaErrorInvalidValue;
}

// K3's backward (replaces bubbleformer_tpu/ops/temporal_block_mega.py:
// _core_bwd_kernel and fused_bwd of _make_temporal_core): every gradient of
// bf_core_temporal_fwd from the output gradient dao, in four launches of
// the kernels above — the attention backward reading dao as it is and the
// forward's rounded raw qkv (the TPU kernel recomputes the projection: the
// same values), dW_qkv += dqkv^T . xn, db_qkv = sum dqkv, and
// dx = dtype(dqkv . W_qkv).  Rounding as the TPU kernel's (:538, :574-595):
// s*dao and the raw dqkv in dtype, dx in dtype, the rest float32.
//
// What bounds it at AViT-big's training shape (B=8, T=5, 32x32 tokens,
// C=768): two products of 2*R*C*3C = 145 GFLOP each (dW_qkv, dx) for
// R = 40960 tokens: the tensor cores, 0.29 ms at the bf16 peak.  The weight
// gradient stages the token-major dqkv and xn with scalar, transposed
// loads and adds ~32 token chunks per tile with float32 atomics, as K1's
// does; it is left slow here.
//
// xn, dao, dx: (B, T, N, C) in dtype; qkv (B*T*N, 3C) from
// bf_core_temporal_fwd; wqkv_t (C, 3C) in dtype; ln (4, 64); bias (heads,
// T, T); scale (heads,); dqkv (B*T*N, 3C) dtype scratch.  Outputs, float32
// and zeroed by the caller except dx: dwqkv (3C, C), dbqkv (3C), dln
// (4, 64), dbias (heads, T, T), dscale (heads).  Returns a cudaError_t.
extern "C" int bf_core_temporal_bwd(int dtype, const void* xn, const void* dao, const void* qkv,
                                    const void* wqkv_t, const float* ln, const float* bias,
                                    const float* scale, void* dqkv, void* dx, float* dwqkv,
                                    float* dbqkv, float* dln, float* dbias, float* dscale, int B,
                                    int steps, int N, int C, int heads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BFT_ARGS(T)                                                                            \
  static_cast<const T*>(xn), static_cast<const T*>(dao), static_cast<const T*>(qkv),           \
      static_cast<const T*>(wqkv_t), ln, bias, scale, static_cast<T*>(dqkv), static_cast<T*>(dx), \
      dwqkv, dbqkv, dln, dbias, dscale, B, steps, N, C, heads, s
  if (dtype == bft::kF32) return bft::run_core_temporal_bwd<float>(BFT_ARGS(float));
  if (dtype == bft::kBF16) return bft::run_core_temporal_bwd<__nv_bfloat16>(BFT_ARGS(__nv_bfloat16));
#undef BFT_ARGS
  return cudaErrorInvalidValue;
}
