// The passes around K1's, K3's, K5's and K9's products in their bf16 launch
// chains (temporal_block.cu, temporal_block_bwd.cu, axial_block_mega.cu,
// axial_lane_px.cu), where the products run on hopper_gemm.cuh: the
// InstanceNorm apply that writes a normalised activation in bf16 for a GEMM
// to load by TMA (K1, K5), K5's InstanceNorm backward, the fixed-order totals of per-plane sums (K5's
// and K9's bias and InstanceNorm gradients), the T x T attention of the
// forward and of the backward (K1, K3), and a timer that records a CUDA
// event after each launch of a chain.  Included by each .cu that launches
// them (internal linkage).
#pragma once

#include <algorithm>
#include <cmath>

#include "common.cuh"

namespace bft {
namespace {

template <typename S>
__device__ __forceinline__ void load8(const S* p, float (&v)[8]);
template <>
__device__ __forceinline__ void load8<float>(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

// out = bf16((x - mean[g, c]) * rstd[g, c] * w[c] + b[c]) over a (G, N, C)
// tensor, g = token / N: the TPU kernel's rounded InstanceNorm output (xn of
// IN1, y2 of IN2), eight channels a thread, 16-byte loads and stores (C a
// multiple of 8, bases 16-byte aligned, G * N * C / 8 < 2^32).  stats =
// [mean; rstd], (2, G, C).
template <typename S>
__global__ void __launch_bounds__(256) in_norm_kernel(const S* __restrict__ x,
                                                      const float* __restrict__ stats,
                                                      const float* __restrict__ w,
                                                      const float* __restrict__ b,
                                                      __nv_bfloat16* __restrict__ out, int G,
                                                      int N, int C) {
  const uint32_t c8 = C / 8, n8 = static_cast<uint32_t>(G) * N * c8;
  const float* rstd = stats + static_cast<size_t>(G) * C;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n8; i += gridDim.x * blockDim.x) {
    const uint32_t row = i / c8, c = (i - row * c8) * 8;
    const size_t s = static_cast<size_t>(row / N) * C + c;
    float v[8], mu[8], rs[8], ww[8], bb[8];
    load8(x + static_cast<size_t>(i) * 8, v);
    load8(stats + s, mu);
    load8(rstd + s, rs);
    load8(w + c, ww);
    load8(b + c, bb);
    __align__(16) __nv_bfloat16 o[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) o[u] = __float2bfloat16((v[u] - mu[u]) * rs[u] * ww[u] + bb[u]);
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(i) * 8) =
        *reinterpret_cast<const uint4*>(o);
  }
}

template <typename S>
cudaError_t launch_in_norm(const S* x, const float* stats, const float* w, const float* b,
                           __nv_bfloat16* out, int G, int N, int C, cudaStream_t stream) {
  const size_t n8 = static_cast<size_t>(G) * N * C / 8;
  if (n8 >= (size_t{1} << 32)) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>(std::min<size_t>((n8 + 255) / 256, 132 * 16));
  in_norm_kernel<S><<<blocks, 256, 0, stream>>>(x, stats, w, b, out, G, N, C);
  return cudaGetLastError();
}

// The InstanceNorm backward of a (G, N, C) plane stack, eight channels a
// thread (16-byte loads and stores): dx = bf16(rstd w (dy - s0 / N - xhat
// s1 / N)), xhat = (x - mean) rstd, from the float32 dy, the bf16 x, stats =
// [mean; rstd] and sums = [s0; s1] (2, G, C) of plane_sums_kernel (K5's bf16
// chain: dao and dx; C a multiple of 8, bases 16-byte aligned).
__global__ void __launch_bounds__(256) in_apply8_kernel(const float* __restrict__ dy,
                                                        const __nv_bfloat16* __restrict__ x,
                                                        const float* __restrict__ stats,
                                                        const float* __restrict__ w,
                                                        const float* __restrict__ sums,
                                                        __nv_bfloat16* __restrict__ dx, int G,
                                                        int N, int C) {
  const uint32_t c8 = C / 8, n8 = static_cast<uint32_t>(G) * N * c8;
  const float* rstd = stats + static_cast<size_t>(G) * C;
  const float* s1 = sums + static_cast<size_t>(G) * C;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n8; i += gridDim.x * blockDim.x) {
    const uint32_t row = i / c8, c = (i - row * c8) * 8;
    const size_t s = static_cast<size_t>(row / N) * C + c;
    float v[8], xv[8], mu[8], rs[8], ww[8], a0[8], a1[8];
    load8(dy + static_cast<size_t>(i) * 8, v);
    load8(x + static_cast<size_t>(i) * 8, xv);
    load8(stats + s, mu);
    load8(rstd + s, rs);
    load8(w + c, ww);
    load8(sums + s, a0);
    load8(s1 + s, a1);
    __align__(16) __nv_bfloat16 o[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float xh = (xv[u] - mu[u]) * rs[u];
      o[u] = __float2bfloat16(rs[u] * ww[u] * (v[u] - a0[u] / N - xh * (a1[u] / N)));
    }
    *reinterpret_cast<uint4*>(dx + static_cast<size_t>(i) * 8) =
        *reinterpret_cast<const uint4*>(o);
  }
}

inline cudaError_t launch_in_apply8(const float* dy, const __nv_bfloat16* x, const float* stats,
                                    const float* w, const float* sums, __nv_bfloat16* dx, int G,
                                    int N, int C, cudaStream_t stream) {
  const size_t n8 = static_cast<size_t>(G) * N * C / 8;
  if (n8 >= (size_t{1} << 32)) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>(std::min<size_t>((n8 + 255) / 256, 132 * 16));
  in_apply8_kernel<<<blocks, 256, 0, stream>>>(dy, x, stats, w, sums, dx, G, N, C);
  return cudaGetLastError();
}

// out0[c] = sum_g sums[g, c] and out1[c] = sum_g sums[G + g, c] over the G
// planes of (2, G, C) per-plane sums (block_ops.cuh: plane_sums_kernel), in
// plane order, each written when given: a Dense's bias gradient, or an
// InstanceNorm's bias (out0) and scale (out1) gradients, with no atomics, so
// they repeat bit for bit.
__global__ void plane_totals_kernel(const float* __restrict__ sums, int G, int C,
                                    float* __restrict__ out0, float* __restrict__ out1) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
  for (int g = 0; g < G; ++g) {
    a += sums[(size_t)g * C + c];
    b += sums[(size_t)(G + g) * C + c];
  }
  if (out0) out0[c] = a;
  if (out1) out1[c] = b;
}

inline cudaError_t launch_plane_totals(const float* sums, int G, int C, float* out0, float* out1,
                                       cudaStream_t stream) {
  plane_totals_kernel<<<(C + 255) / 256, 256, 0, stream>>>(sums, G, C, out0, out1);
  return cudaGetLastError();
}

// The forward's attention pass, from the rounded raw qkv (B*T*N, 3C),
// heads-major [q|k|v]: per (position, head), the qk-LayerNorm of each step
// (ln rows: q scale, q bias, k scale, k bias; q and k rounded to bf16 after
// it), the T x T softmax with the T5 bias (heads, T, T), and the blend
// s*P@V + (1-s)*mean_t V; writes ao rounded to bf16 into ao_r (K1's
// backward residual, K3's output) and, unless ao is null (K3), in float32
// (K1's IN2 input).  A (position, head) is a group of D / 2 lanes, two
// adjacent channels each (one per warp at D = 64, four at D = 16); its kT
// steps of k and v stay in registers, q_i for its own step.  Bound by bytes:
// it reads the qkv once and writes ao once or twice.
template <int D, int kT>
__global__ void __launch_bounds__(256) temporal_attention_kernel(
    const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ ln,
    const float* __restrict__ bias, const float* __restrict__ scale, float* __restrict__ ao,
    __nv_bfloat16* __restrict__ ao_r, int N, int C, int heads, int tasks) {
  constexpr int kLanes = D / 2;
  constexpr int kGroups = 32 / kLanes;
  const int lane = threadIdx.x % 32;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int task = warp * kGroups + lane / kLanes;
  const bool live = task < tasks;
  const int tk = live ? task : tasks - 1;  // an idle group recomputes the last task, stores nothing
  const int pos = tk / heads, h = tk % heads;
  const int b = pos / N, n = pos % N;
  const int e = (lane % kLanes) * 2;
  auto seg_sum = [](float v) {
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  auto raw = [&](int t, int comp) {  // comp 0, 1, 2: q, k, v of step t
    const __nv_bfloat16* r = qkv + (static_cast<size_t>(b * kT + t) * N + n) * 3 * C +
                             h * 3 * D + comp * D + e;
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(r));
  };
  // qk-LayerNorm of one raw pair (comp 0: q, 1: k), rounded to bf16.
  auto layer_norm = [&](float2 a, int comp) {
    const float mu = seg_sum(a.x + a.y) * (1.f / D);
    const float var = fmaxf(seg_sum(a.x * a.x + a.y * a.y) * (1.f / D) - mu * mu, 0.f);
    const float inv = 1.f / sqrtf(var + kNormEps);
    const float* g = ln + comp * 2 * D;
    const float* bb = g + D;
    return make_float2(round_to<__nv_bfloat16>((a.x - mu) * inv * g[e] + bb[e]),
                       round_to<__nv_bfloat16>((a.y - mu) * inv * g[e + 1] + bb[e + 1]));
  };
  float2 k[kT], v[kT];
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    k[t] = layer_norm(raw(t, 1), 1);
    v[t] = raw(t, 2);
  }
  const float s_h = scale[h], inv_t = 1.f / kT;
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const float2 q = layer_norm(raw(i, 0), 0);
    float l[kT];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      l[j] = seg_sum(q.x * k[j].x + q.y * k[j].y) * head_scaling<D>() +
             bias[(h * kT + i) * kT + j];
      mx = fmaxf(mx, l[j]);
    }
    float z = 0.f;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      l[j] = expf(l[j] - mx);
      z += l[j];
    }
    const float inv_z = 1.f / z;
    float o0 = 0.f, o1 = 0.f, m0 = 0.f, m1 = 0.f;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const float pj = l[j] * inv_z;
      o0 += pj * v[j].x;
      o1 += pj * v[j].y;
      m0 += v[j].x;
      m1 += v[j].y;
    }
    const float a0 = s_h * o0 + (1.f - s_h) * (m0 * inv_t);
    const float a1 = s_h * o1 + (1.f - s_h) * (m1 * inv_t);
    if (live) {
      const size_t at = (static_cast<size_t>(b * kT + i) * N + n) * C + h * D + e;
      if (ao) *reinterpret_cast<float2*>(ao + at) = make_float2(a0, a1);
      *reinterpret_cast<__nv_bfloat162*>(ao_r + at) = __floats2bfloat162_rn(a0, a1);
    }
  }
}

// The kernels below are compiled for each T of K1's and K3's envelope (1-8): their
// per-step arrays then hold exactly T entries.
#define BFT_FOR_EACH_T(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

template <int D>
cudaError_t launch_temporal_attention(const __nv_bfloat16* qkv, const float* ln,
                                      const float* bias, const float* scale, float* ao,
                                      __nv_bfloat16* ao_r, int B, int steps, int N, int C,
                                      int heads, cudaStream_t stream) {
  const int tasks = B * N * heads;
  const int warps = (tasks + 32 / (D / 2) - 1) / (32 / (D / 2));
  switch (steps) {
#define BFT_CASE(T)                                                               \
  case T:                                                                         \
    temporal_attention_kernel<D, T><<<(warps + 7) / 8, 256, 0, stream>>>(         \
        qkv, ln, bias, scale, ao, ao_r, N, C, heads, tasks);                      \
    break;
    BFT_FOR_EACH_T(BFT_CASE)
#undef BFT_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The backward's attention pass, K1's launch (6) and K3's launch (2) in
// bf16: per (position, head), dao = bf16(IN2 backward of dy2) at the rounded
// ao (K1: stats2 = [mean; rstd] of ao_r, sums2 = [sum dy2; sum dy2 * xhat2],
// both (2, B*T, C)), or read as it is from dao_in (kDirect, K3: the output
// gradient in bf16; dy2, ao, stats2, in2_w and sums2 unused), then the TPU
// kernel's row algebra (temporal_block_mega.py:354-388; the same
// formulas as temporal_block_bwd.cu's attention_bwd_kernel): w_ij = dao_i .
// v_j, dp = s w, dl = p (dp - sum p dp), dq_i = sum_j dl k_j / sqrt(d), dk_j
// += dl q_i / sqrt(d), dv_j += p bf16(s dao_i) + (1-s)/T sum_i dao_i; the
// qk-LayerNorm backward; dqkv = [dq_raw | dk_raw | dv] in bf16.  A block
// holds one head (blockIdx.y) and strides over the positions, a group of
// D / 2 lanes on each; q_i and dao_i live for their own step only, k, v and
// the dk, dv sums for all kT steps.  d(T5 table), d(attn scale) and d(qk-LN)
// are summed in registers (the table's T x T entries spread over the lanes
// of a group), then across a warp's groups, then over the block's warps in
// warp order, and each block writes its sums to part (attention_partial_size
// floats a block, blocks of head h at h * gridDim.x + blockIdx.x); the totals
// kernel below adds the blocks in a fixed order.  No atomics, so the
// gradients repeat bit for bit.  Bound by bytes: it reads qkv and either dy2
// (float32) and ao (K1) or dao (K3) once, and writes dqkv.
template <int D, int kT>
__host__ __device__ constexpr int attention_partial_size() {
  return 4 * D + kT * kT + 1;  // d(qk-LN) rows, the T5 table, d(attn scale)
}

template <int D, int kT, bool kDirect>
__global__ void __launch_bounds__(256, 2) temporal_attention_bwd_kernel(
    const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ ln,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const __nv_bfloat16* __restrict__ dao_in,
    const float* __restrict__ dy2, const __nv_bfloat16* __restrict__ ao,
    const float* __restrict__ stats2, const float* __restrict__ in2_w,
    const float* __restrict__ sums2, __nv_bfloat16* __restrict__ dqkv, float* __restrict__ part,
    int N, int C, int positions) {
  constexpr int kLanes = D / 2;
  constexpr int kGroups = 32 / kLanes;
  constexpr int kTT = kT * kT;                       // the T5 table, (i, j) at i * kT + j
  constexpr int kOwn = (kTT + kLanes - 1) / kLanes;  // table entries a lane of a group sums
  constexpr int kWarps = 256 / 32;
  __shared__ float dbias_w[kWarps][kOwn * kLanes];
  __shared__ float dln_w[kWarps][4 * D];
  __shared__ float dscale_w[kWarps];
  const int tid = threadIdx.x, lane = tid % 32, gl = lane % kLanes, h = blockIdx.y;
  const int warp = tid / 32;

  const int e = gl * 2, c = h * D + e;
  const size_t GC = static_cast<size_t>(positions / N) * kT * C;
  const float inv_n = 1.f / N, inv_t = 1.f / kT, s_h = scale[h];
  constexpr float kScaling = head_scaling<D>();
  auto seg_sum = [](float v) {
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  auto load2 = [](const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  };
  // qk-LayerNorm of a raw pair (comp 0: q, 1: k): xhat and inv; returns the
  // rounded output.
  auto layer_norm = [&](float2 a, int comp, float2& xhat, float& inv) {
    const float mu = seg_sum(a.x + a.y) * (1.f / D);
    const float var = fmaxf(seg_sum(a.x * a.x + a.y * a.y) * (1.f / D) - mu * mu, 0.f);
    inv = 1.f / sqrtf(var + kNormEps);
    xhat = make_float2((a.x - mu) * inv, (a.y - mu) * inv);
    const float* g = ln + comp * 2 * D;
    return make_float2(round_to<__nv_bfloat16>(xhat.x * g[e] + g[D + e]),
                       round_to<__nv_bfloat16>(xhat.y * g[e + 1] + g[D + e + 1]));
  };

  // Sums over the block's positions, in registers until the end: the
  // qk-LN gradients, d(attn scale), and the T5 table's entries, entry
  // (i, j) on lane (i * kT + j) % kLanes of each group.
  float2 dq_s = make_float2(0.f, 0.f), dq_b = dq_s, dk_s = dq_s, dk_b = dq_s;
  float dscale_acc = 0.f, dbias_acc[kOwn] = {};
  // Blocks walk the positions in strides (fewer blocks, fewer atomic adds
  // of their sums); each group of D / 2 lanes takes one position a stride.
  const int per_block = (blockDim.x / 32) * kGroups;
  for (int base = blockIdx.x * per_block; base < positions; base += gridDim.x * per_block) {
    const int task = base + (tid / 32) * kGroups + lane / kLanes;
    const bool live = task < positions;
    const int pos = live ? task : positions - 1;  // an idle group recomputes, adds nothing
    const int b = pos / N, n = pos % N;
    auto row_of = [&](int t) { return static_cast<size_t>(b * kT + t) * N + n; };
    // LayerNorm backward of dy at (xhat, inv), written to dst in bf16; adds
    // the scale and bias gradients into ds, db.
    auto layer_norm_bwd = [&](float2 dy, float2 xhat, float inv, int comp, __nv_bfloat16* dst,
                              float2& ds, float2& db) {
      const float* g = ln + comp * 2 * D;
      const float2 gg = make_float2(dy.x * g[e], dy.y * g[e + 1]);
      const float m1 = seg_sum(gg.x + gg.y) * (1.f / D);
      const float m2 = seg_sum(gg.x * xhat.x + gg.y * xhat.y) * (1.f / D);
      if (live) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
            inv * (gg.x - m1 - xhat.x * m2), inv * (gg.y - m1 - xhat.y * m2));
        ds.x += dy.x * xhat.x, ds.y += dy.y * xhat.y;
        db.x += dy.x, db.y += dy.y;
      }
    };

    float2 k[kT], v[kT], dk[kT], dv[kT];
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const __nv_bfloat16* r = qkv + row_of(t) * 3 * C + h * 3 * D + e;
      float2 xh;
      float inv;
      k[t] = layer_norm(load2(r + D), 1, xh, inv);
      v[t] = load2(r + 2 * D);
      dk[t] = dv[t] = make_float2(0.f, 0.f);
    }
    float2 bsum = make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      const size_t row = row_of(i);
      float2 qhat;
      float qinv;
      const float2 q = layer_norm(load2(qkv + row * 3 * C + h * 3 * D + e), 0, qhat, qinv);
      // dao_i: as given (K3), or the IN2 backward of dy2 at this token,
      // rounded (K1).
      float2 dao;
      if constexpr (kDirect) {
        dao = load2(dao_in + row * C + c);
      } else {
        const size_t st = static_cast<size_t>(b * kT + i) * C + c;
        const float2 dy = *reinterpret_cast<const float2*>(dy2 + row * C + c);
        const float2 ar = load2(ao + row * C + c);
        const float2 mean = *reinterpret_cast<const float2*>(stats2 + st);
        const float2 rstd = *reinterpret_cast<const float2*>(stats2 + GC + st);
        const float2 s0 = *reinterpret_cast<const float2*>(sums2 + st);
        const float2 s1 = *reinterpret_cast<const float2*>(sums2 + GC + st);
        const float xh0 = (ar.x - mean.x) * rstd.x, xh1 = (ar.y - mean.y) * rstd.y;
        dao = make_float2(round_to<__nv_bfloat16>(rstd.x * in2_w[c] *
                                                  (dy.x - s0.x * inv_n - xh0 * (s1.x * inv_n))),
                          round_to<__nv_bfloat16>(rstd.y * in2_w[c + 1] *
                                                  (dy.y - s0.y * inv_n - xh1 * (s1.y * inv_n))));
      }
      bsum.x += (1.f - s_h) * dao.x * inv_t, bsum.y += (1.f - s_h) * dao.y * inv_t;
      float pr[kT], wv[kT];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        pr[j] = seg_sum(q.x * k[j].x + q.y * k[j].y) * kScaling + bias[(h * kT + i) * kT + j];
        mx = fmaxf(mx, pr[j]);
        wv[j] = seg_sum(dao.x * v[j].x + dao.y * v[j].y);
      }
      float z = 0.f;
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        pr[j] = expf(pr[j] - mx);
        z += pr[j];
      }
      const float inv_z = 1.f / z;
      float inner = 0.f, dsc = 0.f;
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        pr[j] *= inv_z;
        inner += pr[j] * (s_h * wv[j]);
        dsc += (pr[j] - inv_t) * wv[j];
      }
      if (live) dscale_acc += dsc;
      const float2 sdao = make_float2(round_to<__nv_bfloat16>(s_h * dao.x),
                                      round_to<__nv_bfloat16>(s_h * dao.y));
      float2 dq = make_float2(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        const float dl = pr[j] * (s_h * wv[j] - inner);
        if (live && gl == (i * kT + j) % kLanes) dbias_acc[(i * kT + j) / kLanes] += dl;
        dq.x += dl * k[j].x * kScaling, dq.y += dl * k[j].y * kScaling;
        dk[j].x += dl * q.x * kScaling, dk[j].y += dl * q.y * kScaling;
        dv[j].x += pr[j] * sdao.x, dv[j].y += pr[j] * sdao.y;
      }
      layer_norm_bwd(dq, qhat, qinv, 0, dqkv + row * 3 * C + h * 3 * D + e, dq_s, dq_b);
    }
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const size_t row = row_of(t);
      float2 khat;
      float kinv;
      layer_norm(load2(qkv + row * 3 * C + h * 3 * D + D + e), 1, khat, kinv);
      __nv_bfloat16* dst = dqkv + row * 3 * C + h * 3 * D + e;
      layer_norm_bwd(dk[t], khat, kinv, 1, dst + D, dk_s, dk_b);
      if (live)
        *reinterpret_cast<__nv_bfloat162*>(dst + 2 * D) =
            __floats2bfloat162_rn(dv[t].x + bsum.x, dv[t].y + bsum.y);
    }
  }

  // The warp's sums across its groups (a fixed butterfly), each warp's into
  // its own slot, then the block's over its warps in warp order, written to
  // the block's partials.
  float acc[8] = {dq_s.x, dq_s.y, dq_b.x, dq_b.y, dk_s.x, dk_s.y, dk_b.x, dk_b.y};
#pragma unroll
  for (int o = kLanes; o < 32; o <<= 1) {
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
#pragma unroll
    for (int u = 0; u < kOwn; ++u) dbias_acc[u] += __shfl_xor_sync(0xffffffffu, dbias_acc[u], o);
    dscale_acc += __shfl_xor_sync(0xffffffffu, dscale_acc, o);
  }
  if (lane < kLanes) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      dln_w[warp][r * D + e] = acc[2 * r];
      dln_w[warp][r * D + e + 1] = acc[2 * r + 1];
    }
#pragma unroll
    for (int u = 0; u < kOwn; ++u) dbias_w[warp][u * kLanes + lane] = dbias_acc[u];
  }
  if (lane == 0) dscale_w[warp] = dscale_acc;
  __syncthreads();
  float* out = part + (static_cast<size_t>(h) * gridDim.x + blockIdx.x) *
                          attention_partial_size<D, kT>();
  for (int i = tid; i < attention_partial_size<D, kT>(); i += blockDim.x) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w)
      t += i < 4 * D ? dln_w[w][i] : i < 4 * D + kTT ? dbias_w[w][i - 4 * D] : dscale_w[w];
    out[i] = t;
  }
}

// The totals of temporal_attention_bwd_kernel's per-block partials (blocks
// per head, heads): d(qk-LN) over every block of every head, the table's
// and the scale's over each head's blocks, in block order, written (not
// added) to dln (4, D), dbias (heads, T, T) and dscale (heads).
template <int D, int kT>
__global__ void attention_totals_kernel(const float* __restrict__ part, int blocks, int heads,
                                        float* __restrict__ dln, float* __restrict__ dbias,
                                        float* __restrict__ dscale) {
  constexpr int kP = attention_partial_size<D, kT>(), kTT = kT * kT;
  const int outputs = 4 * D + heads * (kTT + 1);
  for (int o = blockIdx.x * blockDim.x + threadIdx.x; o < outputs; o += gridDim.x * blockDim.x) {
    float t = 0.f;
    if (o < 4 * D) {
      for (int b = 0; b < heads * blocks; ++b) t += part[static_cast<size_t>(b) * kP + o];
      dln[o] = t;
    } else if (o < 4 * D + heads * kTT) {
      const int h = (o - 4 * D) / kTT, ij = (o - 4 * D) % kTT;
      for (int b = 0; b < blocks; ++b)
        t += part[(static_cast<size_t>(h) * blocks + b) * kP + 4 * D + ij];
      dbias[h * kTT + ij] = t;
    } else {
      const int h = o - 4 * D - heads * kTT;
      for (int b = 0; b < blocks; ++b)
        t += part[(static_cast<size_t>(h) * blocks + b) * kP + 4 * D + kTT];
      dscale[h] = t;
    }
  }
}

// The most blocks a head launch_temporal_attention_bwd takes: about four
// blocks an SM of an H100 (132) over all heads, each striding over
// positions.  The partials' scratch holds heads * this many blocks of
// attention_partial_size floats (the wrappers size it: ops/
// temporal_block_mega.py:ATTENTION_PARTIAL).
inline int attention_bwd_blocks(int positions, int per_block, int heads) {
  return std::max(1, std::min((positions + per_block - 1) / per_block,
                              (4 * 132 + heads - 1) / heads));
}

// kDirect: K3's flavour (dao_in given; dy2, ao, stats2, in2_w, sums2 null).
// The attention pass, then the totals of its per-block partials (part: a
// float32 scratch of heads * attention_bwd_blocks(...) partials) into dln,
// dbias and dscale.
template <int D, bool kDirect>
cudaError_t launch_temporal_attention_bwd(const __nv_bfloat16* qkv, const float* ln,
                                          const float* bias, const float* scale,
                                          const __nv_bfloat16* dao_in, const float* dy2,
                                          const __nv_bfloat16* ao, const float* stats2,
                                          const float* in2_w, const float* sums2,
                                          __nv_bfloat16* dqkv, float* part, float* dln,
                                          float* dbias, float* dscale, int B, int steps, int N,
                                          int C, int heads, cudaStream_t stream) {
  constexpr int kPerBlock = 8 * (32 / (D / 2));  // positions a block a stride
  const int positions = B * N;
  const int blocks = attention_bwd_blocks(positions, kPerBlock, heads);
  const dim3 grid(blocks, heads);
  switch (steps) {
#define BFT_CASE(T)                                                                        \
  case T:                                                                                  \
    temporal_attention_bwd_kernel<D, T, kDirect><<<grid, 256, 0, stream>>>(                \
        qkv, ln, bias, scale, dao_in, dy2, ao, stats2, in2_w, sums2, dqkv, part, N, C,     \
        positions);                                                                        \
    if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return e;              \
    attention_totals_kernel<D, T><<<(4 * D + heads * (T * T + 1) + 255) / 256, 256, 0,     \
                                    stream>>>(part, blocks, heads, dln, dbias, dscale);    \
    break;
    BFT_FOR_EACH_T(BFT_CASE)
#undef BFT_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

#undef BFT_FOR_EACH_T

// Device time of each launch of a chain: with an output array, an event is
// recorded before the first launch and after each mark(); finish() waits
// for the last and writes the i-th launch's milliseconds to out[i].  Without
// one it records nothing.
class LaunchTimer {
 public:
  static constexpr int kMax = 16;
  LaunchTimer(float* out, cudaStream_t stream) : out_(out), stream_(stream) {
    if (out_) record();
  }
  ~LaunchTimer() {
    for (int i = 0; i < n_; ++i) cudaEventDestroy(ev_[i]);
  }
  void mark() {
    if (out_ && n_ <= kMax) record();
  }
  cudaError_t finish() {
    if (!out_) return cudaSuccess;
    cudaError_t e = cudaEventSynchronize(ev_[n_ - 1]);
    for (int i = 1; i < n_ && e == cudaSuccess; ++i)
      e = cudaEventElapsedTime(&out_[i - 1], ev_[i - 1], ev_[i]);
    return e;
  }

 private:
  void record() {
    cudaEventCreate(&ev_[n_]);
    cudaEventRecord(ev_[n_], stream_);
    ++n_;
  }
  float* out_;
  cudaStream_t stream_;
  cudaEvent_t ev_[kMax + 1];
  int n_ = 0;
};

}  // namespace
}  // namespace bft
