// K1: the whole temporal-attention branch, backward, hand-written for Hopper
// (sm_90a); and K3's backward (bf_core_temporal_bwd, at the end): in bf16
// the projection again and the middle of K1's bf16 chain, in float32
// launches (5)-(8) below alone.  Head dims 16 and 64 (template D), heads in
// the forward's groups (temporal_block.cu, HeadGroup).
//
// Replaces bubbleformer_tpu/ops/temporal_block_mega.py:_bwd_kernel (built by
// _make_temporal_block, custom VJP fused_bwd): every gradient of the branch
// IN1 -> QKV -> qk-LN -> T x T attention (T5 bias, s*P + (1-s)/T) -> IN2 ->
// output projection, from the output gradient `do` and the forward kernel's
// residuals (the rounded raw qkv, the attention output `ao` rounded to the
// activation dtype and InstanceNorm1's statistics, temporal_block.cu).
//
// Split.  The InstanceNorm backward needs plane-wide means of dy and
// dy * xhat over all N tokens of a (b, t) plane, and every parameter
// gradient is a sum over all B*T*N tokens, so the TPU kernel's one grid
// step per image becomes a chain of launches on one stream.  bf16 (the
// training dtype) runs run_temporal_block_bwd_hopper below: its four
// products on the hand-written TMA + wgmma GEMM (hopper_gemm.cuh), the
// weight gradients split over tokens and their partials added in a fixed
// order, the attention pass one (position, head) per lane group
// (temporal_hopper.cuh), and every other parameter gradient summed in a
// fixed order too: bit for bit from run to run.  float32 keeps the first
// version's eleven launches:
//   (0) plane_stats:   IN2's statistics again, from the rounded ao
//   (1) gemm_nt:       dy2 = do . W_out                       (float32 scratch)
//   (2) wgrad:         dW_out += do^T . y2, y2 = IN2(ao) recomputed while staged
//   (3) plane_sums:    db_out = sum do
//   (4) plane_sums:    per plane sum dy2 and sum dy2 * xhat2; d(in2 scale, bias)
//   (5) attention_bwd: one block per (16 positions x all T, head group):
//       stage the group's raw q|k|v as the forward wrote it, redo the qk-LN, dao =
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
// There the four products run on block_gemm.cuh's FMA tile; they and the
// sums are block_ops.cuh's, which K3 and K5 share.  Reductions across blocks
// are float32 atomicAdd into zeroed outputs (the weight gradients split the
// token axis into ~32 chunks per tile), so their last bits vary from run to
// run.
//
// Rounding follows the TPU kernel (temporal_block_mega.py:324-449): dao,
// s*dao and the raw-component dqkv in the activation dtype, dx returned in
// it, everything else float32.  IN2 is recomputed from ao rounded to the
// activation dtype, as the TPU kernel recomputes it from its ao_ref (:259,
// :325), where the forward normalised the float32 ao: in bfloat16 this
// backward is the TPU kernel's, not exactly the gradient of the forward (as
// K5's, axial_block_mega.cu).  The attention pass reads the forward's
// rounded qkv where the TPU kernel redoes IN1 and the QKV product: the same
// values, for 4.5 of 16.6 GFLOP less per block at batch 1 and one residual
// of B*T*N*3C activation-dtype values more.
//
// What bounds it at FiLMAViT-small's training shape (B=8, T=5, 32x32
// tokens, C=384, 6 heads): 96.6 GFLOP of products (dy2 and dW_out 12.1
// each, dxn and dW_qkv 36.2 each; 0.10 ms at the bf16 peak) against ~1.3 GB
// that the bf16 chain's launches move (0.39 ms at 3.35 TB/s): bytes.  The
// attention pass is its largest launch, then the products and the float32
// dy2/dxn round trips.
#include <cmath>

#include "block_ops.cuh"
#include "common.cuh"
#include "hopper_gemm.cuh"
#include "temporal_hopper.cuh"

namespace bft {
namespace {

constexpr int kP = 16;              // spatial positions per attention block
constexpr int kMaxT = 8;
constexpr int kThreads = kGemmThreads;
constexpr int kWarps = kThreads / 32;

// The forward's head groups (temporal_block.cu): one head at d = 64, three
// at d = 16, whose q|k|v columns are contiguous.
template <int D>
struct HeadGroup {
  static constexpr int kHeads = D == 64 ? 1 : 3;
  static constexpr int kCols = 3 * D * kHeads;
};

// (5): grid (N / kP, heads / kHeads, B), kThreads threads, kP * steps * kLDC
// floats of dynamic shared memory; tile rows m = t * kP + p.  kDirect: dao is
// read from dao_in (K3, the output gradient in dtype) instead of being the
// IN2 backward of dy2 at the rounded ao (K1; dy2, ao, mean2, rstd2, in2_w and
// sums2 are then unused).
template <typename T, bool kDirect, int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_kernel(
    const T* __restrict__ qkv, const float* __restrict__ ln, const float* __restrict__ bias,
    const float* __restrict__ scale, const float* __restrict__ dy2, const T* __restrict__ ao,
    const float* __restrict__ mean2, const float* __restrict__ rstd2,
    const float* __restrict__ in2_w, const float* __restrict__ sums2,
    const T* __restrict__ dao_in, T* __restrict__ dqkv,
    float* __restrict__ dln, float* __restrict__ dbias, float* __restrict__ dscale, int steps,
    int N, int C) {
  using G = HeadGroup<D>;
  using Row = HeadRow<D>;
  constexpr int kPer = Row::kPer;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float dbias_s[G::kHeads][kMaxT * kMaxT];
  __shared__ float dln_s[4 * D];
  __shared__ float dscale_s[G::kHeads];
  const int n0 = blockIdx.x * kP, h0 = blockIdx.y * G::kHeads, b = blockIdx.z;
  const int Gp = gridDim.z * steps;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = kP * steps;
  const int col0 = h0 * 3 * D;

  for (int e = tid; e < G::kHeads * kMaxT * kMaxT; e += kThreads) (&dbias_s[0][0])[e] = 0.f;
  for (int e = tid; e < 4 * D; e += kThreads) dln_s[e] = 0.f;
  if (tid < G::kHeads) dscale_s[tid] = 0.f;

  // Stage the group's raw q|k|v rows of the tile, as the forward wrote them.
  float* Cs = reinterpret_cast<float*>(smem);
  for (int e = tid; e < rows * G::kCols; e += kThreads) {
    const int m = e / G::kCols, j = e % G::kCols;
    Cs[m * kLDC + j] =
        to_f32(qkv[((size_t)(b * steps + m / kP) * N + n0 + m % kP) * 3 * C + col0 + j]);
  }
  __syncthreads();

  auto raw_row = [&](const float* r) {
    Row out;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int d = lane + 32 * u;
      out.v[u] = d < D ? r[d] : 0.f;
    }
    return out;
  };
  // qk-LayerNorm of a raw row: xhat, inv and the rounded output.
  auto layer_norm = [&](const float* r, int comp, Row& xhat, float& inv) -> Row {
    const Row a = raw_row(r);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      s1 += a.v[u];
      s2 += a.v[u] * a.v[u];
    }
    const float mu = warp_sum(s1) * (1.f / D);
    const float var = fmaxf(warp_sum(s2) * (1.f / D) - mu * mu, 0.f);
    inv = 1.f / sqrtf(var + kNormEps);
    const float* g = ln + comp * 2 * D;
    const float* bb = g + D;
    Row y;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int d = lane + 32 * u;
      xhat.v[u] = d < D ? (a.v[u] - mu) * inv : 0.f;
      y.v[u] = d < D ? round_to<T>(xhat.v[u] * g[d] + bb[d]) : 0.f;
    }
    return y;
  };

  const float inv_t = 1.f / steps;
  Row dln_acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < kPer; ++u) dln_acc[i].v[u] = 0.f;
  float dscale_acc[G::kHeads] = {};
  for (int task = warp; task < kP * G::kHeads; task += kWarps) {
    const int p = task / G::kHeads, hh = task % G::kHeads, h = h0 + hh;
    const float s_h = scale[h];
    Row q[kMaxT], k[kMaxT], v[kMaxT], dao[kMaxT];
    Row bsum;
#pragma unroll
    for (int u = 0; u < kPer; ++u) bsum.v[u] = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      if (t < steps) {
        const float* r = Cs + (t * kP + p) * kLDC + hh * 3 * D;
        Row xh;
        float inv;
        q[t] = layer_norm(r, 0, xh, inv);
        k[t] = layer_norm(r + D, 1, xh, inv);
        v[t] = raw_row(r + 2 * D);
        // dao = IN2 backward of dy2 at this token, rounded (K1), or as given (K3).
        const int g = b * steps + t;
        const size_t row = (size_t)g * N + n0 + p;
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int d = lane + 32 * u;
          float dv2 = 0.f;
          if (d < D) {
            const int c = h * D + d;
            if constexpr (kDirect) {
              dv2 = to_f32(dao_in[row * C + c]);
            } else {
              const int s = g * C + c;
              const float xh2 = (to_f32(ao[row * C + c]) - mean2[s]) * rstd2[s];
              dv2 = round_to<T>(rstd2[s] * in2_w[c] *
                                (dy2[row * C + c] - sums2[s] / N -
                                 xh2 * (sums2[(size_t)Gp * C + s] / N)));
            }
          }
          dao[t].v[u] = dv2;
          bsum.v[u] += (1.f - s_h) * dv2 * inv_t;
        }
      }
    }

    Row dq[kMaxT], dk[kMaxT], dv[kMaxT];
#pragma unroll
    for (int t = 0; t < kMaxT; ++t)
#pragma unroll
      for (int u = 0; u < kPer; ++u) dq[t].v[u] = dk[t].v[u] = dv[t].v[u] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxT; ++i) {
      if (i < steps) {
        float pr[kMaxT], wv[kMaxT];
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kMaxT; ++j) {
          if (j < steps) {
            pr[j] = row_dot<D>(q[i], k[j]) * head_scaling<D>() + bias[(h * steps + i) * steps + j];
            mx = fmaxf(mx, pr[j]);
            wv[j] = row_dot<D>(dao[i], v[j]);
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
            dscale_acc[hh] += (pr[j] - inv_t) * wv[j];
          }
        }
        Row sdao;
#pragma unroll
        for (int u = 0; u < kPer; ++u) sdao.v[u] = round_to<T>(s_h * dao[i].v[u]);
#pragma unroll
        for (int j = 0; j < kMaxT; ++j) {
          if (j < steps) {
            const float dl = pr[j] * (s_h * wv[j] - inner);
            if (lane == 0) atomicAdd(&dbias_s[hh][i * steps + j], dl);
#pragma unroll
            for (int u = 0; u < kPer; ++u) {
              dq[i].v[u] += dl * k[j].v[u] * head_scaling<D>();
              dk[j].v[u] += dl * q[i].v[u] * head_scaling<D>();
              dv[j].v[u] += pr[j] * sdao.v[u];
            }
          }
        }
      }
    }

    // qk-LayerNorm backward, then dqkv = [dq_raw | dk_raw | dv] in T.
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      if (t < steps) {
        const float* r = Cs + (t * kP + p) * kLDC + hh * 3 * D;
        T* dst = dqkv + ((size_t)(b * steps + t) * N + n0 + p) * 3 * C + h * 3 * D;
#pragma unroll
        for (int comp = 0; comp < 2; ++comp) {
          Row xh;
          float inv;
          layer_norm(r + comp * D, comp, xh, inv);
          const Row dy = comp == 0 ? dq[t] : dk[t];
          const float* g = ln + comp * 2 * D;
          float gg[kPer], m1 = 0.f, m2 = 0.f;
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int d = lane + 32 * u;
            gg[u] = d < D ? dy.v[u] * g[d] : 0.f;
            m1 += gg[u];
            m2 += gg[u] * xh.v[u];
          }
          m1 = warp_sum(m1) * (1.f / D);
          m2 = warp_sum(m2) * (1.f / D);
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int d = lane + 32 * u;
            if (d < D) dst[comp * D + d] = from_f32<T>(inv * (gg[u] - m1 - xh.v[u] * m2));
            dln_acc[2 * comp].v[u] += dy.v[u] * xh.v[u];
            dln_acc[2 * comp + 1].v[u] += dy.v[u];
          }
        }
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int d = lane + 32 * u;
          if (d < D) dst[2 * D + d] = from_f32<T>(dv[t].v[u] + bsum.v[u]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int d = lane + 32 * u;
      if (d < D) atomicAdd(&dln_s[i * D + d], dln_acc[i].v[u]);
    }
  if (lane == 0)
#pragma unroll
    for (int hh = 0; hh < G::kHeads; ++hh) atomicAdd(&dscale_s[hh], dscale_acc[hh]);
  __syncthreads();
  for (int e = tid; e < G::kHeads * steps * steps; e += kThreads) {
    const int hh = e / (steps * steps), ij = e % (steps * steps);
    atomicAdd(&dbias[(h0 + hh) * steps * steps + ij], dbias_s[hh][ij]);
  }
  for (int e = tid; e < 4 * D; e += kThreads) atomicAdd(&dln[e], dln_s[e]);
  if (tid < G::kHeads) atomicAdd(&dscale[h0 + tid], dscale_s[tid]);
}

template <typename T, bool kDirect, int D>
cudaError_t launch_attention_bwd(const T* qkv, const float* ln, const float* bias,
                                 const float* scale, const float* dy2, const T* ao,
                                 const float* stats2, const float* in2_w, const float* sums2,
                                 const T* dao, T* dqkv, float* dln, float* dbias, float* dscale,
                                 int B, int steps, int N, int C, int heads, cudaStream_t stream) {
  auto kernel = attention_bwd_kernel<T, kDirect, D>;
  const size_t smem = sizeof(float) * kP * steps * kLDC;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return e;
  const size_t G = (size_t)B * steps;
  kernel<<<dim3(N / kP, heads / HeadGroup<D>::kHeads, B), kThreads, smem, stream>>>(
      qkv, ln, bias, scale, dy2, ao, stats2, stats2 ? stats2 + G * C : nullptr, in2_w, sums2, dao,
      dqkv, dln, dbias, dscale, steps, N, C);
  return cudaGetLastError();
}

template <typename T, int D>
int run_temporal_block_bwd(const T* x, const T* dout, const T* qkv, const float* in1_w,
                           const float* in1_b, const T* wqkv_t, const float* ln,
                           const float* in2_w, const float* in2_b, const T* wout_t,
                           const float* bias, const float* scale, const float* stats1,
                           const T* ao, float* stats2, float* work, float* sums,
                           T* dqkv, T* dx, float* din1, float* dwqkv, float* dbqkv, float* dln,
                           float* din2, float* dwout, float* dbout, float* dbias, float* dscale,
                           int B, int steps, int N, int C, int heads, int Cin,
                           cudaStream_t stream) {
  const int G = B * steps, R = G * N;
  cudaError_t e;
#define BFT_TRY(call) \
  if ((e = (call)) != cudaSuccess) return e
  // (0) IN2's statistics of the rounded ao
  BFT_TRY((launch_plane_stats<T>(ao, G, N, C, stats2, stream)));
  // (1) dy2 = do . W_out
  BFT_TRY((launch_gemm_nt<T, float>(dout, wout_t, work, R, C, Cin, stream)));
  // (2) dW_out += do^T . IN2(ao)
  BFT_TRY((launch_wgrad<T, T, true>(dout, Cin, ao, stats2, in2_w, in2_b, C, G, N, dwout,
                                    stream)));
  // (3) db_out
  BFT_TRY((launch_plane_sums<T, float>(dout, nullptr, nullptr, G, N, Cin, nullptr, nullptr,
                                       dbout, stream)));
  // (4) IN2 backward sums; d(in2 scale, bias)
  BFT_TRY((launch_plane_sums<float, T>(work, ao, stats2, G, N, C, sums, din2, din2 + C,
                                       stream)));
  // (5) attention backward -> dqkv, dln, dbias, dscale
  BFT_TRY((launch_attention_bwd<T, false, D>(qkv, ln, bias, scale, work, ao, stats2, in2_w, sums,
                                             nullptr, dqkv, dln, dbias, dscale, B, steps, N, C,
                                             heads, stream)));
  // (6) dW_qkv += dqkv^T . IN1(x)
  BFT_TRY((launch_wgrad<T, T, true>(dqkv, 3 * C, x, stats1, in1_w, in1_b, Cin, G, N, dwqkv,
                                    stream)));
  // (7) db_qkv
  BFT_TRY((launch_plane_sums<T, float>(dqkv, nullptr, nullptr, G, N, 3 * C, nullptr, nullptr,
                                       dbqkv, stream)));
  // (8) dxn = dqkv . W_qkv (into the dy2 scratch, dead since (5))
  BFT_TRY((launch_gemm_nt<T, float>(dqkv, wqkv_t, work, R, Cin, 3 * C, stream)));
  // (9) IN1 backward sums; d(in1 scale, bias)
  BFT_TRY((launch_plane_sums<float, T>(work, x, stats1, G, N, Cin, sums, din1, din1 + Cin,
                                       stream)));
  // (10) dx
  BFT_TRY((launch_in_apply<T, T>(work, x, stats1, in1_w, sums, dx, G, N, Cin, stream)));
#undef BFT_TRY
  return cudaSuccess;
}

// Per-plane sums of a (G, N, C) tensor into sums (2, G, C), then their totals
// in plane order: out0[c] = sum of a, out1[c] = sum of a * xhat (src given),
// either null.  No atomics, so they repeat bit for bit (K5's chain does the
// same, axial_block_mega.cu).
template <typename A, typename S>
cudaError_t plane_totals_of(const A* a, const S* src, const float* stats, int G, int N, int C,
                            float* sums, float* out0, float* out1, cudaStream_t stream) {
  const cudaError_t e = launch_plane_sums<A, S>(a, src, stats, G, N, C, sums, nullptr, nullptr,
                                                stream);
  if (e != cudaSuccess) return e;
  return launch_plane_totals(sums, G, C, out0, out1, stream);
}

// K1's bf16 backward: the launches of run_temporal_block_bwd with its four
// products on the Hopper GEMM (hopper_gemm.cuh) and the normalised operand
// of each weight gradient written once in bf16 before it, as the forward
// rounded it:
//   (0)  plane_stats:   IN2's statistics of the rounded ao
//   (1)  gemm_nt:       dy2 = do . W_out                    (float32 work)
//   (2)  in_norm:       y2 = bf16(IN2(ao)) into the scratch xs
//   (3)  gemm_tn:       dW_out = do^T . y2, split-K over tokens (plan_out),
//                       partials added in range order
//   (4)  plane sums and totals: db_out
//   (5)  plane sums and totals: IN2 backward sums (kept in sums); d(in2
//        scale, bias)
//   (6)  temporal_attention_bwd and its totals (temporal_hopper.cuh): dqkv,
//        dln, dbias, dscale, from the IN2 backward of dy2 at the rounded ao
//        (the per-block partials in part)
//   (7)  in_norm:       xn = bf16(IN1(x)) into xs
//   (8)  gemm_tn:       dW_qkv = dqkv^T . xn, split-K (plan_qkv)
//   (9)  plane sums and totals: db_qkv
//   (10) gemm_nt:       dxn = dqkv . W_qkv                  (float32 work)
//   (11) plane sums and totals: IN1 backward sums (kept); d(in1 scale, bias)
//   (12) in_apply:      dx
// Every gradient repeats bit for bit from run to run: the weight gradients'
// split-K ranges, the plane sums and the attention pass's per-block
// partials are all added in a fixed order.  x, dout, dx and xn are Cin wide,
// qkv 3C, ao and y2 C (as the forward).  launch_ms, when given, receives
// each launch's device time.
template <int D>
int run_temporal_block_bwd_hopper(
    const __nv_bfloat16* x, const __nv_bfloat16* dout, const __nv_bfloat16* qkv,
    const float* in1_w, const float* in1_b, const __nv_bfloat16* wqkv_t, const float* ln,
    const float* in2_w, const float* in2_b, const __nv_bfloat16* wout_t, const float* bias,
    const float* scale, const float* stats1, const __nv_bfloat16* ao, float* stats2,
    float* work, float* sums, __nv_bfloat16* dqkv, __nv_bfloat16* dx, float* din1, float* dwqkv,
    float* dbqkv, float* dln, float* din2, float* dwout, float* dbout, float* dbias,
    float* dscale, __nv_bfloat16* xs, float* part, const int* plan_out, int splits_out,
    const int* plan_qkv, int splits_qkv, int B, int steps, int N, int C, int heads, int Cin,
    cudaStream_t stream, float* launch_ms) {
  using bf16 = __nv_bfloat16;
  const int G = B * steps, R = G * N;
  LaunchTimer timer(launch_ms, stream);
  cudaError_t e;
#define BFT_TRY(call)                        \
  if ((e = (call)) != cudaSuccess) return e; \
  timer.mark()
  BFT_TRY((launch_plane_stats<bf16>(ao, G, N, C, stats2, stream)));
  BFT_TRY((hg::gemm_nt<hg::kStoreF32>(dout, Cin, wout_t, Cin, R, C, Cin, work, C, nullptr,
                                      stream)));
  BFT_TRY((launch_in_norm(ao, stats2, in2_w, in2_b, xs, G, N, C, stream)));
  BFT_TRY((hg::gemm_tn_splitk(dout, xs, R, Cin, C, plan_out, splits_out, part, dwout, stream)));
  BFT_TRY((plane_totals_of<bf16, float>(dout, nullptr, nullptr, G, N, Cin, sums, dbout, nullptr,
                                        stream)));
  BFT_TRY((plane_totals_of<float, bf16>(work, ao, stats2, G, N, C, sums, din2 + C, din2,
                                        stream)));
  BFT_TRY((launch_temporal_attention_bwd<D, false>(qkv, ln, bias, scale, nullptr, work, ao,
                                                   stats2, in2_w, sums, dqkv, part, dln, dbias,
                                                   dscale, B, steps, N, C, heads, stream)));
  BFT_TRY((launch_in_norm(x, stats1, in1_w, in1_b, xs, G, N, Cin, stream)));
  BFT_TRY((hg::gemm_tn_splitk(dqkv, xs, R, 3 * C, Cin, plan_qkv, splits_qkv, part, dwqkv,
                              stream)));
  BFT_TRY((plane_totals_of<bf16, float>(dqkv, nullptr, nullptr, G, N, 3 * C, sums, dbqkv,
                                        nullptr, stream)));
  BFT_TRY((hg::gemm_nt<hg::kStoreF32>(dqkv, 3 * C, wqkv_t, 3 * C, R, Cin, 3 * C, work, Cin,
                                      nullptr, stream)));
  BFT_TRY((plane_totals_of<float, bf16>(work, x, stats1, G, N, Cin, sums, din1 + Cin, din1,
                                        stream)));
  BFT_TRY((launch_in_apply<bf16, bf16>(work, x, stats1, in1_w, sums, dx, G, N, Cin, stream)));
#undef BFT_TRY
  return timer.finish();
}

// K3's float32 backward: the forward's qkv projected again from xn, then
// launches (5)-(8) of K1's backward, with dao read as it is instead of IN2's
// backward, xn read as it is instead of IN1 recomputed, and dxn written
// rounded to T as dx.
template <typename T, int D>
int run_core_temporal_bwd(const T* xn, const T* dao, const T* wqkv, const float* bqkv,
                          const T* wqkv_t, const float* ln, const float* bias, const float* scale,
                          T* qkv, T* dqkv, T* dx, float* dwqkv, float* dbqkv, float* dln,
                          float* dbias, float* dscale, int B, int steps, int N, int C, int heads,
                          int Cin, cudaStream_t stream) {
  const int G = B * steps, R = G * N;
  cudaError_t e;
#define BFT_TRY(call) \
  if ((e = (call)) != cudaSuccess) return e
  // (4) qkv = T(xn . W_qkv^T + b), as the forward's
  BFT_TRY((launch_norm_proj<T, T, false>(xn, nullptr, nullptr, nullptr, wqkv, bqkv, qkv, G, N,
                                         Cin, 3 * C, stream)));
  // (5) attention backward -> dqkv, dln, dbias, dscale
  BFT_TRY((launch_attention_bwd<T, true, D>(qkv, ln, bias, scale, nullptr, nullptr, nullptr,
                                            nullptr, nullptr, dao, dqkv, dln, dbias, dscale, B,
                                            steps, N, C, heads, stream)));
  // (6) dW_qkv += dqkv^T . xn
  BFT_TRY((launch_wgrad<T, T, false>(dqkv, 3 * C, xn, nullptr, nullptr, nullptr, Cin, G, N,
                                     dwqkv, stream)));
  // (7) db_qkv
  BFT_TRY((launch_plane_sums<T, float>(dqkv, nullptr, nullptr, G, N, 3 * C, nullptr, nullptr,
                                       dbqkv, stream)));
  // (8) dx = T(dqkv . W_qkv)
  BFT_TRY((launch_gemm_nt<T, T>(dqkv, wqkv_t, dx, R, Cin, 3 * C, stream)));
#undef BFT_TRY
  return cudaSuccess;
}

// K3's bf16 backward on the Hopper GEMM and K1's attention pass, rounding
// where the TPU kernel rounds (temporal_block_mega.py:538, :574-595):
//   (1) gemm_nt:                qkv = bf16(xn . W_qkv^T + b_qkv), the
//                               forward's, into the scratch qkv;
//   (2) temporal_attention_bwd: the direct-dao flavour: dqkv (bf16; s*dao
//                               rounded), and its totals dln, dbias, dscale
//                               (the per-block partials in part);
//   (3) gemm_tn:                dW_qkv = dqkv^T . xn, split-K over token
//                               ranges (plan), partials added in range order;
//   (4) plane sums and totals:  db_qkv = sum dqkv (the plane sums in part);
//   (5) gemm_nt:                dx = bf16(dqkv . W_qkv) (wqkv_t: (Cin, 3C)).
// Every gradient repeats bit for bit from run to run (fixed-order sums, no
// atomics).  launch_ms, when given, receives each launch's device time.
template <int D>
int run_core_temporal_bwd_hopper(const __nv_bfloat16* xn, const __nv_bfloat16* dao,
                                 const __nv_bfloat16* wqkv, const float* bqkv,
                                 const __nv_bfloat16* wqkv_t, const float* ln, const float* bias,
                                 const float* scale, __nv_bfloat16* qkv, __nv_bfloat16* dqkv,
                                 __nv_bfloat16* dx, float* dwqkv, float* dbqkv, float* dln,
                                 float* dbias, float* dscale, float* part, const int* plan,
                                 int splits, int B, int steps, int N, int C, int heads, int Cin,
                                 cudaStream_t stream, float* launch_ms) {
  using bf16 = __nv_bfloat16;
  const int G = B * steps, R = G * N;
  LaunchTimer timer(launch_ms, stream);
  cudaError_t e;
#define BFT_TRY(call)                        \
  if ((e = (call)) != cudaSuccess) return e; \
  timer.mark()
  BFT_TRY((hg::gemm_nt<hg::kBiasRound>(xn, Cin, wqkv, Cin, R, 3 * C, Cin, qkv, 3 * C, bqkv,
                                       stream)));
  BFT_TRY((launch_temporal_attention_bwd<D, true>(qkv, ln, bias, scale, dao, nullptr, nullptr,
                                                  nullptr, nullptr, nullptr, dqkv, part, dln,
                                                  dbias, dscale, B, steps, N, C, heads,
                                                  stream)));
  BFT_TRY((hg::gemm_tn_splitk(dqkv, xn, R, 3 * C, Cin, plan, splits, part, dwqkv, stream)));
  BFT_TRY((plane_totals_of<bf16, float>(dqkv, nullptr, nullptr, G, N, 3 * C, part, dbqkv,
                                        nullptr, stream)));
  BFT_TRY((hg::gemm_nt<hg::kRound>(dqkv, 3 * C, wqkv_t, 3 * C, R, Cin, 3 * C, dx, Cin, nullptr,
                                   stream)));
#undef BFT_TRY
  return timer.finish();
}

bool temporal_shape_ok(int head_dim, int steps, int N, int C, int heads, int Cin) {
  const int group = head_dim == 64 ? HeadGroup<64>::kHeads : HeadGroup<16>::kHeads;
  return (head_dim == 64 || head_dim == 16) && C == heads * head_dim && heads % group == 0 &&
         steps >= 1 && steps <= kMaxT && N % kP == 0 && C % kKC == 0 && Cin > 0 &&
         Cin % kKC == 0;
}

}  // namespace
}  // namespace bft

// x, dout, dx: (B, T, N, Cin) in dtype; wqkv_t (Cin, 3C) and wout_t (C, Cin)
// in dtype (transposes of the torch (out, in) weights; C = heads * head_dim,
// as for bf_temporal_block_fwd); ln (4, head_dim); bias (heads, T, T); scale
// (heads,); stats1 (2, B*T, Cin) and, in dtype, qkv (B*T*N, 3C) and ao_r
// (B*T*N, C) from bf_temporal_block_fwd; work (B*T*N, max(C, Cin)), sums (2,
// B*T, max(3C, Cin)) and stats2 (2, B*T, C) float32 scratch, dqkv (B*T*N,
// 3C) dtype scratch.  Outputs, float32 and zeroed by the caller except dx:
// din1 (2, Cin) = [scale; bias], dwqkv (3C, Cin), dbqkv (3C), dln (4,
// head_dim), din2 (2, C), dwout (Cin, C), dbout (Cin), dbias (heads, T, T),
// dscale (heads).  bf16 runs the launch chain above: xs a (B*T*N, max(C,
// Cin)) bf16 scratch, part a float32 scratch of max(splits_out, 3
// splits_qkv) * C * Cin values and at least the attention pass's partials
// (heads * attention_bwd_blocks of attention_partial_size), plan_out and
// plan_qkv host arrays of splits + 1 token bounds (0, multiples of 64, B*T*N)
// for dW_out and dW_qkv, launch_ms null or a host array of 13 floats; every
// base 16-byte aligned.  float32 runs the launches of
// run_temporal_block_bwd (those five unused; launch_ms must be null).  The
// envelope of bf_temporal_block_fwd.  Returns a cudaError_t.
extern "C" int bf_temporal_block_bwd(int dtype, int head_dim, const void* x, const void* dout,
                                     const void* qkv, const float* in1_w, const float* in1_b,
                                     const void* wqkv_t, const float* ln, const float* in2_w,
                                     const float* in2_b, const void* wout_t, const float* bias,
                                     const float* scale, const float* stats1, const void* ao_r,
                                     float* stats2, float* work, float* sums, void* dqkv,
                                     void* dx, float* din1, float* dwqkv, float* dbqkv,
                                     float* dln, float* din2, float* dwout, float* dbout,
                                     float* dbias, float* dscale, void* xs, float* part,
                                     const int* plan_out, int splits_out, const int* plan_qkv,
                                     int splits_qkv, float* launch_ms, int B, int steps, int N,
                                     int C, int heads, int Cin, void* stream) {
  if (!bft::temporal_shape_ok(head_dim, steps, N, C, heads, Cin)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BFT_ARGS(T)                                                                           \
  static_cast<const T*>(x), static_cast<const T*>(dout), static_cast<const T*>(qkv), in1_w,   \
      in1_b, static_cast<const T*>(wqkv_t), ln, in2_w, in2_b,                                 \
      static_cast<const T*>(wout_t), bias, scale, stats1, static_cast<const T*>(ao_r), stats2,  \
      work, sums,                                                                             \
      static_cast<T*>(dqkv), static_cast<T*>(dx), din1, dwqkv, dbqkv, dln, din2, dwout, dbout, \
      dbias, dscale
  using bf16 = __nv_bfloat16;
#define BFT_HOPPER(D)                                                                         \
  return bft::run_temporal_block_bwd_hopper<D>(BFT_ARGS(bf16), static_cast<bf16*>(xs), part,  \
                                               plan_out, splits_out, plan_qkv, splits_qkv, B, \
                                               steps, N, C, heads, Cin, s, launch_ms)
  if (dtype == bft::kBF16 && head_dim == 64) BFT_HOPPER(64);
  if (dtype == bft::kBF16 && head_dim == 16) BFT_HOPPER(16);
#undef BFT_HOPPER
  if (launch_ms != nullptr) return cudaErrorInvalidValue;
  if (dtype == bft::kF32 && head_dim == 64)
    return bft::run_temporal_block_bwd<float, 64>(BFT_ARGS(float), B, steps, N, C, heads, Cin,
                                                  s);
  if (dtype == bft::kF32 && head_dim == 16)
    return bft::run_temporal_block_bwd<float, 16>(BFT_ARGS(float), B, steps, N, C, heads, Cin,
                                                  s);
#undef BFT_ARGS
  return cudaErrorInvalidValue;
}

// K3's backward (replaces bubbleformer_tpu/ops/temporal_block_mega.py:
// _core_bwd_kernel and fused_bwd of _make_temporal_core): every gradient of
// bf_core_temporal_fwd from the output gradient dao.  As the TPU kernel's
// backward does, it projects xn again into the scratch qkv (the forward
// keeps nothing of its own), then runs the attention backward reading dao
// as it is, dW_qkv = dqkv^T . xn, db_qkv = sum dqkv and dx = dtype(dqkv .
// W_qkv).  Rounding as the TPU kernel's (:538, :574-595): the raw qkv,
// s*dao and the raw dqkv in dtype, dx in dtype, the rest float32.
//
// What bounds it at AViT-big's training shape (B=8, T=5, 32x32 tokens,
// C=768): three products of 2*R*C*3C = 145 GFLOP each (qkv, dW_qkv, dx) for
// R = 40960 tokens: the tensor cores, 0.44 ms at the bf16 peak.  bf16 runs
// run_core_temporal_bwd_hopper above (the products on the Hopper GEMM, the
// attention pass of K1's chain in its direct-dao flavour); float32 keeps
// the first version's launches, its products on block_gemm.cuh's FMA tile
// and its weight gradient by float32 atomics (last bits vary from run to
// run).
//
// xn, dx: (B, T, N, Cin) and dao (B, T, N, C) in dtype (C = heads *
// head_dim); wqkv (3C, Cin) and wqkv_t (Cin, 3C), its transpose, in dtype;
// bqkv (3C) float32; ln (4, head_dim); bias (heads, T, T); scale (heads,);
// qkv and dqkv (B*T*N, 3C) dtype scratch.  Outputs, float32 and zeroed by the
// caller except dx: dwqkv (3C, Cin), dbqkv (3C), dln (4, head_dim), dbias
// (heads, T, T), dscale (heads).  bf16 only: part a float32 scratch of the
// most of splits * 3C * Cin values, the plane sums' 2 * B*T * 3C and the
// attention pass's partials (as for bf_temporal_block_bwd), plan a host
// array of splits + 1
// token bounds (0, multiples of 64, B*T*N), launch_ms null or a host array
// of 5 floats; every base 16-byte aligned.  float32: those unused, launch_ms
// null.  Returns a cudaError_t.
extern "C" int bf_core_temporal_bwd(int dtype, int head_dim, const void* xn, const void* dao,
                                    const void* wqkv, const float* bqkv, const void* wqkv_t,
                                    const float* ln, const float* bias, const float* scale,
                                    void* qkv, void* dqkv, void* dx, float* dwqkv, float* dbqkv,
                                    float* dln, float* dbias, float* dscale, float* part,
                                    const int* plan, int splits, float* launch_ms, int B,
                                    int steps, int N, int C, int heads, int Cin, void* stream) {
  if (!bft::temporal_shape_ok(head_dim, steps, N, C, heads, Cin)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BFT_ARGS(T)                                                                           \
  static_cast<const T*>(xn), static_cast<const T*>(dao), static_cast<const T*>(wqkv), bqkv,   \
      static_cast<const T*>(wqkv_t), ln, bias, scale, static_cast<T*>(qkv),                   \
      static_cast<T*>(dqkv), static_cast<T*>(dx), dwqkv, dbqkv, dln, dbias, dscale
  using bf16 = __nv_bfloat16;
  if (dtype == bft::kBF16 && head_dim == 64)
    return bft::run_core_temporal_bwd_hopper<64>(BFT_ARGS(bf16), part, plan, splits, B, steps,
                                                 N, C, heads, Cin, s, launch_ms);
  if (dtype == bft::kBF16 && head_dim == 16)
    return bft::run_core_temporal_bwd_hopper<16>(BFT_ARGS(bf16), part, plan, splits, B, steps,
                                                 N, C, heads, Cin, s, launch_ms);
  if (launch_ms != nullptr) return cudaErrorInvalidValue;
  if (dtype == bft::kF32 && head_dim == 64)
    return bft::run_core_temporal_bwd<float, 64>(BFT_ARGS(float), B, steps, N, C, heads, Cin,
                                                 s);
  if (dtype == bft::kF32 && head_dim == 16)
    return bft::run_core_temporal_bwd<float, 16>(BFT_ARGS(float), B, steps, N, C, heads, Cin,
                                                 s);
#undef BFT_ARGS
  return cudaErrorInvalidValue;
}
