// K2 and K4: the axial row + column attention core, forward and backward,
// hand-written for Hopper (sm_90a).  One kernel family with two rounding
// flavours (template flag kFused) and the head dim as a template parameter
// (16 or 64, the head dims of the repo's configs).
//
// Replaces, with kFused = false (the lane flavour, K2),
// bubbleformer_tpu/ops/axial_lane.py:_fwd_kernel and _bwd_kernel (built by
// _make_lane_axial, entry lane_axial_attention_from_x), and with kFused =
// true (the fused_block flavour, K4) bubbleformer_tpu/ops/
// axial_fused_block.py:_fwd_kernel and _bwd_kernel (built by
// _make_fused_block, entry fused_block_attention).  Both compute, from the
// interleaved (BT, H, W, 3C) QKV tensor (per head [q|k|v], d values each):
// per-head qk-LayerNorm, attention along each image row (over W, T5 table
// bias_x, attn scale s_x) and along each column (over H, bias_y, s_y), and
// the mean of the two directions.  Per direction, with P = softmax(q k^T /
// sqrt(d) + bias) over a line of L tokens:
//   lane:        o = dtype(s P + (1-s)/L) v,  out = dtype(0.5 (dtype(o_r) +
//                dtype(o_c)))                          (axial_lane.py:_axis_fwd)
//   fused_block: o = s (dtype(P) v) + (1-s) mean(v),  out = dtype(0.5 o_r +
//                0.5 o_c), o and the sum in float32   (axial_fused_block.py:
//                103-135)
// The QKV projection stays outside (K2: a float32 addmm; K4: the dtype Dense),
// as it stayed in XLA on the TPU.  The TPU kernels' chunk tables, -1e9 block
// masks, packed heads and dual layouts were TPU answers and have no
// counterpart; h != w is supported and the two directions are independent
// launches over their own lines.
//
// Forward, launched once per direction on one stream: pass 0 (rows) writes
// its float32 output, pass 1 (columns) reads it and writes the result.
// Lines of at most 64 tokens take line_short_fwd_kernel, one block per
// line holding the whole line (29 KB of shared memory at d = 64, L = 32).
// Longer lines take line_fwd_kernel, one block per (query tile of 64 tokens,
// line, head, BT); keys stream through shared memory in tiles of 64, so
// shared memory does not grow with L (84 KB at d = 64).  Both flavours round
// the probabilities after normalisation, so the block makes two passes over
// the key tiles rather than an online-softmax rescale of the output:
//   1. logits of each key tile; the row max m and the sum z = sum exp(l - m)
//      with the running rescale z <- z exp(m_old - m_new) + sum_tile;
//   2. logits again, P = exp(l - m) / z exactly, rounded as the flavour
//      says, times the value tile, summed in float32 in shared memory; the
//      fused flavour also sums v for its window mean.
// For a line of one tile the two give the same P bit for bit.  No block
// keeps arrays of partial sums in registers, so that several blocks share an
// SM.
//
// Backward, per direction, the flash-attention backward shape.  With G =
// dao v^T (dao = dtype(0.5 dout)):
//   dscale += sum (P - 1/L) G,  D_i = s sum_j P_ij G_ij,
//   dS = P (s G - D)  (the T5 table's gradient),
//   dq = dtype(dS) k / sqrt(d),  dk = dtype(dS)^T q / sqrt(d),
//   lane:        dv = dtype(s P + (1-s)/L)^T dao       (axial_lane.py:_axis_bwd)
//   fused_block: dv = dtype(P)^T dtype(s dao) + (1-s) sum_i dao_i / L
//                                                     (axial_fused_packed.py:192)
// then the qk-LN backward (flax LayerNorm, fast variance).
//   line_bwd_q_kernel, one block per query tile: over the key tiles, m, z and
//     sum_j e_ij G_ij (rescaled like z) give D_i and dscale in one pass; a
//     second pass forms dS (table gradient by float32 atomics) and dq.  A line
//     of one tile also takes dk and dv here, so short lines need one launch
//     per direction; longer lines save (m, z, D) per query for
//   line_bwd_kv_kernel, one block per key tile: over the query tiles, dk and
//     dv.
// Rounding of dqkv.  Lane: each direction's LN-backward gradient is rounded
// to the activation dtype; the row pass writes dqkv and the column pass adds
// its own rounded gradient into it (the TPU package projected once per
// direction and summed the two; the port's QKV is one tensor).  fused_block:
// the row pass keeps its dq, dk (w.r.t. the LN outputs) and dv in a float32
// scratch; the column pass adds its own, runs the LN backward on the sum and
// rounds once (axial_fused_block.py:217-250).  Each (token, head) belongs to
// one block per launch, and launches run in order on one stream, so there is
// no race.  The table, scale and LN gradients are sums over all lines, added
// with float32 atomics: their last bits vary from run to run.
//
// What bounds it.  At FiLMAViT-small's training shape (BT = 40, 32x32 tokens,
// C = 384) ~1.3 GFLOP forward and ~3.2 backward against ~38 MB read and
// written in bf16: memory bounds it on paper, but the L x L products run on
// the CUDA cores from shared memory (a d-long dot product per logit, one
// block of 256 threads per tile) and they set its time.  At the 32x128 flow-
// boiling grid the rows' 128-token lines cost four times the per-token work
// of the columns'.  Left for later: tensor-core (wgmma) tiles for the
// products, bf16 staging, the row output kept on chip.
#include <cmath>

#include "common.cuh"

namespace bft {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // tokens of a query or key tile
constexpr float kEps = 1e-5f;

template <int D>
__host__ __device__ constexpr float head_scaling() {
  static_assert(D == 16 || D == 64, "head dim 16 or 64");
  return D == 64 ? 0.125f : 0.25f;  // D ** -0.5
}

// Where a block sits: direction (pass 0 rows, L = W; pass 1 columns, L = H),
// line, tile of the line, head and batch element.
struct LineCtx {
  int pass, bt, line, h, H, W, C;
  int L, lines, ntile, tile, tl;

  __device__ LineCtx(int H_, int W_, int C_, int pass_)
      : pass(pass_), bt(blockIdx.z), h(blockIdx.y), H(H_), W(W_), C(C_) {
    L = pass == 0 ? W : H;
    lines = pass == 0 ? H : W;
    ntile = (L + kTile - 1) / kTile;
    line = blockIdx.x / ntile;
    tile = blockIdx.x % ntile;
    tl = L < kTile ? L : kTile;
  }
  // Token index of sequence position i of this line.
  __device__ size_t token(int i) const {
    return pass == 0 ? ((size_t)bt * H + line) * W + i : ((size_t)bt * H + i) * W + line;
  }
  // Offset of component comp (0 q, 1 k, 2 v) of this head in the qkv row.
  template <int D>
  __device__ size_t qkv_at(int i, int comp) const {
    return token(i) * 3 * C + (size_t)h * 3 * D + comp * D;
  }
};

// Rows r0 .. r0 + n of component comp into dst (row stride D + 1, float32).
template <typename T, int D>
__device__ void stage(float* dst, const T* __restrict__ qkv, const LineCtx& c, int comp, int r0,
                      int n) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int i = e / D, j = e % D;
    dst[i * (D + 1) + j] = to_f32(qkv[c.qkv_at<D>(r0 + i, comp) + j]);
  }
}

// dao = dtype(0.5 * dout) of rows r0 .. r0 + n.
template <typename T, int D>
__device__ void stage_dao(float* dst, const T* __restrict__ dout, const LineCtx& c, int r0,
                          int n) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int i = e / D, j = e % D;
    dst[i * (D + 1) + j] = round_to<T>(0.5f * to_f32(dout[c.token(r0 + i) * c.C + c.h * D + j]));
  }
}

// Fast-variance LayerNorm statistics of one row, by one warp.
template <int D>
__device__ __forceinline__ void row_stats(const float* r, float& mu, float& inv) {
  const int lane = threadIdx.x % 32;
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) {
    const float a = r[d];
    s += a;
    s2 += a * a;
  }
  mu = warp_sum(s) * (1.f / D);
  const float var = fmaxf(warp_sum(s2) * (1.f / D) - mu * mu, 0.f);
  inv = 1.f / sqrtf(var + kEps);
}

// dst = dtype(LN(src) * g + b) for n rows, one warp per row; dst may be src.
template <typename T, int D>
__device__ void ln_rows(float* dst, const float* src, int n, const float* g, const float* b) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < n; i += kWarps) {
    const float* r = src + i * (D + 1);
    float mu, inv;
    row_stats<D>(r, mu, inv);
    float* o = dst + i * (D + 1);
#pragma unroll
    for (int d = lane; d < D; d += 32) o[d] = round_to<T>((r[d] - mu) * inv * g[d] + b[d]);
  }
}

// ps[i][j] = q_i . k_j / sqrt(D) + bias[i][j] (bias rows of stride L) for
// i < nq, j < nk; with kWithG also gs[i][j] = dao_i . v_j.
template <int D, bool kWithG>
__device__ void logits_tile(const float* qs, const float* ks, const float* ds, const float* vs,
                            float* ps, float* gs, int nq, int nk, int ldp,
                            const float* __restrict__ bias, int L) {
  constexpr int LDS = D + 1;
  for (int e = threadIdx.x; e < nq * nk; e += kThreads) {
    const int i = e / nk, j = e % nk;
    const float* q = qs + i * LDS;
    const float* k = ks + j * LDS;
    float acc = 0.f, gacc = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      acc += q[d] * k[d];
      if (kWithG) gacc += ds[i * LDS + d] * vs[j * LDS + d];
    }
    ps[i * ldp + j] = acc * head_scaling<D>() + bias[(size_t)i * L + j];
    if (kWithG) gs[i * ldp + j] = gacc;
  }
}

// ---------------------------------------------------------------- forward

// One output of a query token at `at`: the fused flavour's blend with the
// window mean of v, then pass 0's float32 row output or, in pass 1, the mean
// of both directions in the flavour's rounding.
template <typename T, bool kFused>
__device__ __forceinline__ void emit_out(float* row_out, T* out, size_t at, float o, float s,
                                         float vmean, int pass) {
  if (kFused) o = s * o + (1.f - s) * vmean;
  if (pass == 0) {
    row_out[at] = o;
  } else if (kFused) {
    out[at] = from_f32<T>(0.5f * row_out[at] + 0.5f * o);
  } else {
    out[at] = from_f32<T>(0.5f * (round_to<T>(row_out[at]) + round_to<T>(o)));
  }
}

template <int D>
size_t short_fwd_smem_bytes(int L) {
  return sizeof(float) * (3 * L * (D + 1) + L * (L + 1) + D);
}

// A line of one tile (L <= 64: FiLMAViT-small's 32x32 grid, the columns of
// the 32x128 flow-boiling grid), one block per (line, head, BT): the line's
// q|k|v staged together (3D contiguous values a token), qk-LN, its L x L
// logits, softmax and the flavour's rounding, times V.  Its block is small
// (29 KB of shared memory at d = 64, L = 32, no launch bound on registers),
// so several share an SM; the streaming kernel below, which holds a 64-token
// tile's buffers, its running statistics and its partial sums, ran such
// lines 15% slower.
// grid (lines, heads, BT).
template <typename T, int D, bool kFused>
__global__ void __launch_bounds__(kThreads) line_short_fwd_kernel(
    const T* __restrict__ qkv, const float* __restrict__ ln, const float* __restrict__ bias,
    const float* __restrict__ scale, float* __restrict__ row_out, T* __restrict__ out, int H,
    int W, int C, int pass) {
  constexpr int LDS = D + 1;
  extern __shared__ float sm[];
  const LineCtx c(H, W, C, pass);
  const int L = c.L, ldp = L + 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* qs = sm;
  float* ks = qs + L * LDS;
  float* vs = ks + L * LDS;
  float* ps = vs + L * LDS;    // (L, L + 1)
  float* vsum = ps + L * ldp;  // (D): sum of v over the line (fused flavour)
  const float s = scale[c.h * 2 + pass];
  const float uniform = (1.f - s) * (1.f / L);

  for (int e = tid; e < L * 3 * D; e += kThreads) {
    const int i = e / (3 * D), j = e % (3 * D);
    (j < D ? qs : j < 2 * D ? ks : vs)[i * LDS + j % D] = to_f32(qkv[c.qkv_at<D>(i, 0) + j]);
  }
  __syncthreads();
  ln_rows<T, D>(qs, qs, L, ln, ln + D);
  ln_rows<T, D>(ks, ks, L, ln + 2 * D, ln + 3 * D);
  if (kFused && tid < D) {
    float a = 0.f;
    for (int j = 0; j < L; ++j) a += vs[j * LDS + tid];
    vsum[tid] = a;
  }
  __syncthreads();
  logits_tile<D, false>(qs, ks, nullptr, nullptr, ps, nullptr, L, L, ldp,
                        bias + (size_t)c.h * L * L, L);
  __syncthreads();
  // Softmax, one warp per query: P = exp(l - m) / z, rounded as the flavour
  // says.
  for (int i = warp; i < L; i += kWarps) {
    float* r = ps + i * ldp;
    const float l0 = lane < L ? r[lane] : -INFINITY;
    const float l1 = lane + 32 < L ? r[lane + 32] : -INFINITY;
    const float m = warp_max(fmaxf(l0, l1));
    const float e0 = lane < L ? expf(l0 - m) : 0.f;
    const float e1 = lane + 32 < L ? expf(l1 - m) : 0.f;
    const float z = warp_sum(e0 + e1);
    if (lane < L) r[lane] = kFused ? round_to<T>(e0 / z) : round_to<T>(s * (e0 / z) + uniform);
    if (lane + 32 < L) {
      r[lane + 32] = kFused ? round_to<T>(e1 / z) : round_to<T>(s * (e1 / z) + uniform);
    }
  }
  __syncthreads();
  for (int e = tid; e < L * D; e += kThreads) {
    const int i = e / D, d = e % D;
    const float* p = ps + i * ldp;
    float a = 0.f;
    for (int j = 0; j < L; ++j) a += p[j] * vs[j * LDS + d];
    emit_out<T, kFused>(row_out, out, c.token(i) * C + (size_t)c.h * D + d, a, s,
                        kFused ? vsum[d] / L : 0.f, pass);
  }
}

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * (kTile + 1) + 2 * kTile + D);
}

// A line of more than one tile, one block per (query tile of <= 64 tokens,
// line, head, BT), streaming the key tiles in the two passes of the file
// comment.  At most 64 registers a thread: four blocks an SM.
// grid (lines * tiles, heads, BT).
template <typename T, int D, bool kFused>
__global__ void __launch_bounds__(kThreads, 4) line_fwd_kernel(
    const T* __restrict__ qkv, const float* __restrict__ ln, const float* __restrict__ bias,
    const float* __restrict__ scale, float* __restrict__ row_out, T* __restrict__ out, int H,
    int W, int C, int pass) {
  constexpr int LDS = D + 1, ldp = kTile + 1;
  extern __shared__ float sm[];
  const LineCtx c(H, W, C, pass);
  const int L = c.L;
  const int q0 = c.tile * kTile, nq = min(kTile, L - q0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* qs = sm;
  float* ks = qs + kTile * LDS;
  float* vs = ks + kTile * LDS;
  float* ps = vs + kTile * LDS;  // (kTile, kTile + 1)
  float* stat_m = ps + kTile * ldp;
  float* stat_z = stat_m + kTile;
  float* vsum = stat_z + kTile;  // (D): sum of v over the line (fused flavour)
  float* os = vsum + D;          // (kTile, D + 1): P V summed over the key tiles
  const float* bh = bias + (size_t)c.h * L * L + (size_t)q0 * L;
  const float s = scale[c.h * 2 + pass];
  const float uniform = (1.f - s) * (1.f / L);

  stage<T, D>(qs, qkv, c, 0, q0, nq);
  for (int i = tid; i < kTile; i += kThreads) {
    stat_m[i] = -INFINITY;
    stat_z[i] = 0.f;
  }
  for (int d = tid; d < D; d += kThreads) vsum[d] = 0.f;
  __syncthreads();
  ln_rows<T, D>(qs, qs, nq, ln, ln + D);

  // 1. Row max and sum over the key tiles.
  for (int k0 = 0; k0 < L; k0 += kTile) {
    const int nk = min(kTile, L - k0);
    stage<T, D>(ks, qkv, c, 1, k0, nk);
    __syncthreads();
    ln_rows<T, D>(ks, ks, nk, ln + 2 * D, ln + 3 * D);
    __syncthreads();
    logits_tile<D, false>(qs, ks, nullptr, nullptr, ps, nullptr, nq, nk, ldp, bh + k0, L);
    __syncthreads();
    for (int i = warp; i < nq; i += kWarps) {
      const float* r = ps + i * ldp;
      const float l0 = lane < nk ? r[lane] : -INFINITY;
      const float l1 = lane + 32 < nk ? r[lane + 32] : -INFINITY;
      const float m_old = stat_m[i];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(l0, l1)));
      const float e = (lane < nk ? expf(l0 - m_new) : 0.f) +
                      (lane + 32 < nk ? expf(l1 - m_new) : 0.f);
      const float zt = warp_sum(e);
      if (lane == 0) {
        stat_z[i] = stat_z[i] * expf(m_old - m_new) + zt;
        stat_m[i] = m_new;
      }
    }
    __syncthreads();
  }

  // 2. The exact probabilities, rounded as the flavour says, times V, added
  // up in os.
  for (int k0 = 0; k0 < L; k0 += kTile) {
    const int nk = min(kTile, L - k0);
    stage<T, D>(ks, qkv, c, 1, k0, nk);
    stage<T, D>(vs, qkv, c, 2, k0, nk);
    __syncthreads();
    ln_rows<T, D>(ks, ks, nk, ln + 2 * D, ln + 3 * D);
    __syncthreads();
    logits_tile<D, false>(qs, ks, nullptr, nullptr, ps, nullptr, nq, nk, ldp, bh + k0, L);
    __syncthreads();
    for (int i = warp; i < nq; i += kWarps) {
      float* r = ps + i * ldp;
      const float m = stat_m[i], z = stat_z[i];
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(r[j] - m) / z;
        r[j] = kFused ? round_to<T>(p) : round_to<T>(s * p + uniform);
      }
    }
    if (kFused && tid < D) {
      float a = 0.f;
      for (int j = 0; j < nk; ++j) a += vs[j * LDS + tid];
      vsum[tid] += a;
    }
    __syncthreads();
    for (int e = tid; e < nq * D; e += kThreads) {
      const int i = e / D, d = e % D;
      const float* p = ps + i * ldp;
      float a = 0.f;
      for (int j = 0; j < nk; ++j) a += p[j] * vs[j * LDS + d];
      float* o = os + i * LDS + d;
      *o = (k0 == 0 ? 0.f : *o) + a;
    }
    __syncthreads();
  }
  for (int e = tid; e < nq * D; e += kThreads) {
    const int i = e / D, d = e % D;
    emit_out<T, kFused>(row_out, out, c.token(q0 + i) * C + (size_t)c.h * D + d,
                        os[i * LDS + d], s, kFused ? vsum[d] / L : 0.f, pass);
  }
}

// --------------------------------------------------------------- backward

// dv of one (token, head, d): see the file comment for the two flavours.
template <typename T, bool kFused>
__device__ __forceinline__ void emit_dv(T* dqkv, float* dacc, size_t at, float v, int pass) {
  if (kFused) {
    if (pass == 0) {
      dacc[at] = v;
    } else {
      dqkv[at] = from_f32<T>(dacc[at] + v);
    }
  } else if (pass == 0) {
    dqkv[at] = from_f32<T>(v);
  } else {
    dqkv[at] = from_f32<T>(to_f32(dqkv[at]) + round_to<T>(v));
  }
}

// The qk-LN backward of n rows of component comp (0 q, 1 k) from r0, one warp
// per row: raw rows `raw`, gradients w.r.t. the LN outputs `dy` (both of
// stride D + 1).  Writes the raw-component gradient into dqkv as the flavour
// says and adds (dy xhat, dy) into dln_s[2 comp], dln_s[2 comp + 1]; the
// fused flavour's row pass only keeps dy in dacc.
template <typename T, int D, bool kFused>
__device__ void ln_bwd_rows(const float* raw, const float* dy, int n, int r0, int comp,
                            const float* __restrict__ ln, const LineCtx& c, T* dqkv, float* dacc,
                            float* dln_s) {
  constexpr int kPer = (D + 31) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool keep = kFused && c.pass == 0;
  const float* g = ln + comp * 2 * D;
  float dg[kPer] = {}, db[kPer] = {};
  for (int i = warp; i < n; i += kWarps) {
    const float* r = raw + i * (D + 1);
    const float* y = dy + i * (D + 1);
    const size_t base = c.qkv_at<D>(r0 + i, comp);
    if (keep) {
      for (int d = lane; d < D; d += 32) dacc[base + d] = y[d];
      continue;
    }
    float mu, inv;
    row_stats<D>(r, mu, inv);
    float xh[kPer], gg[kPer];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int d = lane + 32 * u;
      xh[u] = gg[u] = 0.f;
      if (d < D) {
        const float yv = kFused ? y[d] + dacc[base + d] : y[d];
        xh[u] = (r[d] - mu) * inv;
        gg[u] = yv * g[d];
        m1 += gg[u];
        m2 += gg[u] * xh[u];
        dg[u] += yv * xh[u];
        db[u] += yv;
      }
    }
    m1 = warp_sum(m1) * (1.f / D);
    m2 = warp_sum(m2) * (1.f / D);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int d = lane + 32 * u;
      if (d >= D) continue;
      const float v = inv * (gg[u] - m1 - xh[u] * m2);
      T* o = dqkv + base + d;
      *o = (kFused || c.pass == 0) ? from_f32<T>(v) : from_f32<T>(to_f32(*o) + round_to<T>(v));
    }
  }
  if (keep) return;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int d = lane + 32 * u;
    if (d < D) {
      atomicAdd(&dln_s[2 * comp * D + d], dg[u]);
      atomicAdd(&dln_s[(2 * comp + 1) * D + d], db[u]);
    }
  }
}

// dk and dv of a key tile from one query tile: gs holds dtype(dS), ps the
// flavour's rounded probabilities, qs and ds the query tile's q and dao.
template <typename T, int D, bool kFused>
__device__ __forceinline__ void accumulate_dkdv(float (&dk)[kTile * D / kThreads],
                                                float (&dv)[kTile * D / kThreads],
                                                const float* gs, const float* ps, const float* qs,
                                                const float* ds, float* dsum, int nq, int nk,
                                                int ldp, float s) {
  constexpr int LDS = D + 1;
  constexpr int kAcc = kTile * D / kThreads;
  const int tid = threadIdx.x;
#pragma unroll
  for (int u = 0; u < kAcc; ++u) {
    const int e = tid + u * kThreads;
    const int j = e / D, d = e % D;
    if (j < nk) {
      float ak = 0.f, av = 0.f;
      for (int i = 0; i < nq; ++i) {
        ak += gs[i * ldp + j] * qs[i * LDS + d];
        const float a = ds[i * LDS + d];
        av += ps[i * ldp + j] * (kFused ? round_to<T>(s * a) : a);
      }
      dk[u] += ak;
      dv[u] += av;
    }
  }
  if (kFused && tid < D) {
    float a = 0.f;
    for (int i = 0; i < nq; ++i) a += (1.f - s) * ds[i * LDS + tid];
    dsum[tid] += a;
  }
}

template <int D>
size_t bwd_q_smem_bytes(int tl) {
  return sizeof(float) * (6 * tl * (D + 1) + 2 * tl * (tl + 1) + 4 * tl + D);
}

template <int D>
size_t bwd_kv_smem_bytes(int tl) {
  return sizeof(float) * (5 * tl * (D + 1) + 2 * tl * (tl + 1) + 3 * tl + D);
}

// grid (lines * tiles, heads, BT).  stats: (BT, heads, lines, L, 3) = (m, z,
// D) per query, written only when the line has more than one tile.
template <typename T, int D, bool kFused>
__global__ void __launch_bounds__(kThreads) line_bwd_q_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dout, const float* __restrict__ ln,
    const float* __restrict__ bias, const float* __restrict__ scale, T* dqkv, float* dacc,
    float* __restrict__ stats, float* __restrict__ dln, float* __restrict__ dbias,
    float* __restrict__ dscale, int H, int W, int C, int heads, int pass) {
  constexpr int LDS = D + 1;
  extern __shared__ float sm[];
  __shared__ float dln_s[4 * D];
  __shared__ float dscale_s;
  const LineCtx c(H, W, C, pass);
  const int L = c.L, tl = c.tl, ldp = tl + 1;
  const int q0 = c.tile * kTile, nq = min(kTile, L - q0);
  const bool one = L <= kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* qr = sm;               // raw q (tl, D + 1)
  float* qs = qr + tl * LDS;    // q after LN, rounded
  float* ds = qs + tl * LDS;    // dao; later dk (one-tile lines)
  float* kr = ds + tl * LDS;    // raw k (one-tile lines), else the dq sums
  float* ks = kr + tl * LDS;    // k after LN, rounded
  float* vs = ks + tl * LDS;    // v; later dq (one-tile lines)
  float* ps = vs + tl * LDS;    // logits, then the rounded probabilities (tl, tl + 1)
  float* gs = ps + tl * ldp;    // G, then dtype(dS)
  float* st_m = gs + tl * ldp;
  float* st_z = st_m + tl;
  float* st_a = st_z + tl;      // sum e G, then D
  float* st_g = st_a + tl;      // sum G
  float* dsum = st_g + tl;      // (D) sum (1-s) dao (fused flavour)
  const float* bh = bias + (size_t)c.h * L * L + (size_t)q0 * L;
  float* dbh = dbias + (size_t)c.h * L * L + (size_t)q0 * L;
  const float s = scale[c.h * 2 + pass];
  const float uniform = (1.f - s) * (1.f / L);

  for (int e = tid; e < 4 * D; e += kThreads) dln_s[e] = 0.f;
  if (tid == 0) dscale_s = 0.f;
  for (int i = tid; i < tl; i += kThreads) {
    st_m[i] = -INFINITY;
    st_z[i] = st_a[i] = st_g[i] = 0.f;
  }
  stage<T, D>(qr, qkv, c, 0, q0, nq);
  stage_dao<T, D>(ds, dout, c, q0, nq);
  __syncthreads();
  ln_rows<T, D>(qs, qr, nq, ln, ln + D);

  auto load_keys = [&](int k0, int nk) {
    float* raw = one ? kr : ks;
    stage<T, D>(raw, qkv, c, 1, k0, nk);
    stage<T, D>(vs, qkv, c, 2, k0, nk);
    __syncthreads();
    ln_rows<T, D>(ks, raw, nk, ln + 2 * D, ln + 3 * D);
    __syncthreads();
    logits_tile<D, true>(qs, ks, ds, vs, ps, gs, nq, nk, ldp, bh + k0, L);
    __syncthreads();
  };

  // 1. m, z, sum e G (rescaled with z) and sum G over the key tiles.
  for (int k0 = 0; k0 < L; k0 += kTile) {
    const int nk = min(kTile, L - k0);
    load_keys(k0, nk);
    for (int i = warp; i < nq; i += kWarps) {
      const float* r = ps + i * ldp;
      const float* gr = gs + i * ldp;
      const bool in0 = lane < nk, in1 = lane + 32 < nk;
      const float l0 = in0 ? r[lane] : -INFINITY, l1 = in1 ? r[lane + 32] : -INFINITY;
      const float g0 = in0 ? gr[lane] : 0.f, g1 = in1 ? gr[lane + 32] : 0.f;
      const float m_old = st_m[i];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(l0, l1)));
      const float e0 = in0 ? expf(l0 - m_new) : 0.f, e1 = in1 ? expf(l1 - m_new) : 0.f;
      const float zt = warp_sum(e0 + e1);
      const float at = warp_sum(e0 * g0 + e1 * g1);
      const float gt = warp_sum(g0 + g1);
      if (lane == 0) {
        const float r_old = expf(m_old - m_new);
        st_z[i] = st_z[i] * r_old + zt;
        st_a[i] = st_a[i] * r_old + at;
        st_g[i] += gt;
        st_m[i] = m_new;
      }
    }
    __syncthreads();
  }
  // D_i = s sum_j P_ij G_ij; dscale += sum_j (P_ij - 1/L) G_ij.
  for (int i = tid; i < nq; i += kThreads) {
    const float pg = st_a[i] / st_z[i];
    st_a[i] = s * pg;
    atomicAdd(&dscale_s, pg - st_g[i] * (1.f / L));
    if (!one) {
      float* o = stats + ((((size_t)c.bt * heads + c.h) * c.lines + c.line) * L + q0 + i) * 3;
      o[0] = st_m[i];
      o[1] = st_z[i];
      o[2] = st_a[i];
    }
  }
  __syncthreads();

  // 2. dS (the table gradient), then dq: a longer line adds dq up over its
  // key tiles in kr (free there: its keys' LN runs in place in ks).
  for (int k0 = 0; k0 < L; k0 += kTile) {
    const int nk = min(kTile, L - k0);
    if (!one) load_keys(k0, nk);
    for (int i = warp; i < nq; i += kWarps) {
      float* r = ps + i * ldp;
      float* gr = gs + i * ldp;
      const float m = st_m[i], z = st_z[i], dd = st_a[i];
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(r[j] - m) / z;
        const float dS = p * (s * gr[j] - dd);
        atomicAdd(&dbh[(size_t)i * L + k0 + j], dS);
        gr[j] = round_to<T>(dS);
        if (one) r[j] = kFused ? round_to<T>(p) : round_to<T>(s * p + uniform);
      }
    }
    if (kFused && one && tid < D) {
      float a = 0.f;
      for (int i = 0; i < nq; ++i) a += (1.f - s) * ds[i * LDS + tid];
      dsum[tid] = a;
    }
    __syncthreads();
    if (one) break;
    for (int e = tid; e < nq * D; e += kThreads) {
      const int i = e / D, d = e % D;
      const float* g = gs + i * ldp;
      float a = 0.f;
      for (int j = 0; j < nk; ++j) a += g[j] * ks[j * LDS + d];
      float* o = kr + i * LDS + d;
      *o = (k0 == 0 ? 0.f : *o) + a * head_scaling<D>();
    }
    __syncthreads();
  }

  if (one) {
    // The whole line is this tile: dq into vs (v is spent), dv out, then dk
    // into ds (dao is spent), each from shared memory in one sweep.
    for (int e = tid; e < nq * D; e += kThreads) {
      const int i = e / D, d = e % D;
      const float* g = gs + i * ldp;
      float aq = 0.f, av = 0.f;
      for (int j = 0; j < nq; ++j) aq += g[j] * ks[j * LDS + d];
      for (int r = 0; r < nq; ++r) {
        const float a = ds[r * LDS + d];
        av += ps[r * ldp + i] * (kFused ? round_to<T>(s * a) : a);
      }
      vs[i * LDS + d] = aq * head_scaling<D>();
      emit_dv<T, kFused>(dqkv, dacc, c.qkv_at<D>(i, 2) + d, kFused ? av + dsum[d] / L : av,
                         pass);
    }
    __syncthreads();
    for (int e = tid; e < nq * D; e += kThreads) {
      const int j = e / D, d = e % D;
      float a = 0.f;
      for (int i = 0; i < nq; ++i) a += gs[i * ldp + j] * qs[i * LDS + d];
      ds[j * LDS + d] = a * head_scaling<D>();
    }
    __syncthreads();
    ln_bwd_rows<T, D, kFused>(qr, vs, nq, 0, 0, ln, c, dqkv, dacc, dln_s);
    ln_bwd_rows<T, D, kFused>(kr, ds, nq, 0, 1, ln, c, dqkv, dacc, dln_s);
  } else {
    ln_bwd_rows<T, D, kFused>(qr, kr, nq, q0, 0, ln, c, dqkv, dacc, dln_s);
  }
  __syncthreads();
  if (!(kFused && pass == 0)) {
    for (int e = tid; e < 4 * D; e += kThreads) atomicAdd(&dln[e], dln_s[e]);
  }
  if (tid == 0) atomicAdd(&dscale[c.h * 2 + pass], dscale_s);
}

// grid (lines * tiles, heads, BT), lines of more than one tile only.
template <typename T, int D, bool kFused>
__global__ void __launch_bounds__(kThreads) line_bwd_kv_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dout, const float* __restrict__ ln,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ stats, T* dqkv, float* dacc, float* __restrict__ dln, int H,
    int W, int C, int heads, int pass) {
  constexpr int LDS = D + 1;
  constexpr int kAcc = kTile * D / kThreads;
  extern __shared__ float sm[];
  __shared__ float dln_s[4 * D];
  const LineCtx c(H, W, C, pass);
  const int L = c.L, tl = c.tl, ldp = tl + 1;
  const int k0 = c.tile * kTile, nk = min(kTile, L - k0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* kr = sm;             // raw k
  float* ks = kr + tl * LDS;  // k after LN, rounded; later dk
  float* vs = ks + tl * LDS;
  float* qs = vs + tl * LDS;  // a query tile's q after LN, rounded
  float* ds = qs + tl * LDS;  // its dao
  float* ps = ds + tl * LDS;
  float* gs = ps + tl * ldp;
  float* st = gs + tl * ldp;  // (tl, 3): m, z, D of the query tile
  float* dsum = st + 3 * tl;
  const float* bh = bias + (size_t)c.h * L * L + k0;
  const float* sth = stats + (((size_t)c.bt * heads + c.h) * c.lines + c.line) * L * 3;
  const float s = scale[c.h * 2 + pass];
  const float uniform = (1.f - s) * (1.f / L);

  for (int e = tid; e < 4 * D; e += kThreads) dln_s[e] = 0.f;
  for (int d = tid; d < D; d += kThreads) dsum[d] = 0.f;
  stage<T, D>(kr, qkv, c, 1, k0, nk);
  stage<T, D>(vs, qkv, c, 2, k0, nk);
  __syncthreads();
  ln_rows<T, D>(ks, kr, nk, ln + 2 * D, ln + 3 * D);

  float dk[kAcc] = {}, dv[kAcc] = {};
  for (int q0 = 0; q0 < L; q0 += kTile) {
    const int nq = min(kTile, L - q0);
    stage<T, D>(qs, qkv, c, 0, q0, nq);
    stage_dao<T, D>(ds, dout, c, q0, nq);
    for (int e = tid; e < 3 * nq; e += kThreads) st[e] = sth[(size_t)q0 * 3 + e];
    __syncthreads();
    ln_rows<T, D>(qs, qs, nq, ln, ln + D);
    __syncthreads();
    logits_tile<D, true>(qs, ks, ds, vs, ps, gs, nq, nk, ldp, bh + (size_t)q0 * L, L);
    __syncthreads();
    for (int i = warp; i < nq; i += kWarps) {
      float* r = ps + i * ldp;
      float* gr = gs + i * ldp;
      const float m = st[3 * i], z = st[3 * i + 1], dd = st[3 * i + 2];
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(r[j] - m) / z;
        gr[j] = round_to<T>(p * (s * gr[j] - dd));
        r[j] = kFused ? round_to<T>(p) : round_to<T>(s * p + uniform);
      }
    }
    __syncthreads();
    accumulate_dkdv<T, D, kFused>(dk, dv, gs, ps, qs, ds, dsum, nq, nk, ldp, s);
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < kAcc; ++u) {
    const int e = tid + u * kThreads;
    const int j = e / D, d = e % D;
    if (j >= nk) continue;
    ks[j * LDS + d] = dk[u] * head_scaling<D>();
    const float v = kFused ? dv[u] + dsum[d] / L : dv[u];
    emit_dv<T, kFused>(dqkv, dacc, c.qkv_at<D>(k0 + j, 2) + d, v, pass);
  }
  __syncthreads();
  ln_bwd_rows<T, D, kFused>(kr, ks, nk, k0, 1, ln, c, dqkv, dacc, dln_s);
  __syncthreads();
  if (!(kFused && pass == 0)) {
    for (int e = tid; e < 4 * D; e += kThreads) atomicAdd(&dln[e], dln_s[e]);
  }
}

// ------------------------------------------------------------- launchers

struct AxialArgs {
  const void* qkv;
  const void* dout;
  const float* ln;
  const float* bias_x;
  const float* bias_y;
  const float* scale;
  float* row_out;
  void* out;
  void* dqkv;
  float* dacc;
  float* stats;
  float* dln;
  float* dbias_x;
  float* dbias_y;
  float* dscale;
  int BT, H, W, C, heads;
  cudaStream_t stream;
};

struct Fwd {
  template <typename T, int D, bool kFused>
  static int run(const AxialArgs& a) {
    cudaError_t e;
    auto short_kernel = line_short_fwd_kernel<T, D, kFused>;
    auto kernel = line_fwd_kernel<T, D, kFused>;
    if ((e = cudaFuncSetAttribute(short_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)short_fwd_smem_bytes<D>(kTile))) != cudaSuccess)
      return e;
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)fwd_smem_bytes<D>())) != cudaSuccess)
      return e;
    for (int pass = 0; pass < 2; ++pass) {
      const int L = pass == 0 ? a.W : a.H, lines = pass == 0 ? a.H : a.W;
      const T* qkv = static_cast<const T*>(a.qkv);
      const float* bias = pass == 0 ? a.bias_x : a.bias_y;
      T* out = static_cast<T*>(a.out);
      if (L <= kTile) {
        short_kernel<<<dim3(lines, a.heads, a.BT), kThreads, short_fwd_smem_bytes<D>(L),
                       a.stream>>>(qkv, a.ln, bias, a.scale, a.row_out, out, a.H, a.W, a.C,
                                   pass);
      } else {
        kernel<<<dim3(lines * ((L + kTile - 1) / kTile), a.heads, a.BT), kThreads,
                 fwd_smem_bytes<D>(), a.stream>>>(qkv, a.ln, bias, a.scale, a.row_out, out, a.H,
                                                  a.W, a.C, pass);
      }
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    return cudaSuccess;
  }
};

struct Bwd {
  template <typename T, int D, bool kFused>
  static int run(const AxialArgs& a) {
    cudaError_t e;
    auto qk = line_bwd_q_kernel<T, D, kFused>;
    auto kvk = line_bwd_kv_kernel<T, D, kFused>;
    if ((e = cudaFuncSetAttribute(qk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bwd_q_smem_bytes<D>(kTile))) != cudaSuccess)
      return e;
    if ((e = cudaFuncSetAttribute(kvk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bwd_kv_smem_bytes<D>(kTile))) != cudaSuccess)
      return e;
    const T* qkv = static_cast<const T*>(a.qkv);
    const T* dout = static_cast<const T*>(a.dout);
    T* dqkv = static_cast<T*>(a.dqkv);
    for (int pass = 0; pass < 2; ++pass) {
      const int L = pass == 0 ? a.W : a.H, lines = pass == 0 ? a.H : a.W;
      const int tl = L < kTile ? L : kTile, nt = (L + kTile - 1) / kTile;
      const dim3 grid(lines * nt, a.heads, a.BT);
      const float* bias = pass == 0 ? a.bias_x : a.bias_y;
      qk<<<grid, kThreads, bwd_q_smem_bytes<D>(tl), a.stream>>>(
          qkv, dout, a.ln, bias, a.scale, dqkv, a.dacc, a.stats, a.dln,
          pass == 0 ? a.dbias_x : a.dbias_y, a.dscale, a.H, a.W, a.C, a.heads, pass);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
      if (L > kTile) {
        kvk<<<grid, kThreads, bwd_kv_smem_bytes<D>(tl), a.stream>>>(
            qkv, dout, a.ln, bias, a.scale, a.stats, dqkv, a.dacc, a.dln, a.H, a.W, a.C,
            a.heads, pass);
        if ((e = cudaGetLastError()) != cudaSuccess) return e;
      }
    }
    return cudaSuccess;
  }
};

template <typename Op, typename T>
int by_head_dim(int head_dim, int fused, const AxialArgs& a) {
  if (head_dim == 64)
    return fused ? Op::template run<T, 64, true>(a) : Op::template run<T, 64, false>(a);
  if (head_dim == 16)
    return fused ? Op::template run<T, 16, true>(a) : Op::template run<T, 16, false>(a);
  return cudaErrorInvalidValue;
}

template <typename Op>
int dispatch(int dtype, int head_dim, int fused, const AxialArgs& a) {
  if (a.H > 512 || a.W > 512 || a.C != a.heads * head_dim) return cudaErrorInvalidValue;
  if (dtype == kF32) return by_head_dim<Op, float>(head_dim, fused, a);
  if (dtype == kBF16) return by_head_dim<Op, __nv_bfloat16>(head_dim, fused, a);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace bft

// qkv: (BT, H, W, 3C) in dtype, heads-major [q|k|v] columns; ln (4, head_dim)
// = q scale, q bias, k scale, k bias; bias_x (heads, W, W), bias_y (heads, H,
// H); scale (heads, 2) = [s_x, s_y]; row_out (BT, H, W, C) float32 scratch;
// out (BT, H, W, C) in dtype.  fused: 0 the lane flavour (K2), 1 the
// fused_block flavour (K4).  head_dim 16 or 64, H and W at most 512.
// Returns a cudaError_t.
extern "C" int bf_axial_attention_fwd(int dtype, int head_dim, int fused, const void* qkv,
                                      const float* ln, const float* bias_x, const float* bias_y,
                                      const float* scale, float* row_out, void* out, int BT,
                                      int H, int W, int C, int heads, void* stream) {
  bft::AxialArgs a{};
  a.qkv = qkv;
  a.ln = ln;
  a.bias_x = bias_x;
  a.bias_y = bias_y;
  a.scale = scale;
  a.row_out = row_out;
  a.out = out;
  a.BT = BT;
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  a.stream = static_cast<cudaStream_t>(stream);
  return bft::dispatch<bft::Fwd>(dtype, head_dim, fused, a);
}

// qkv: (BT, H, W, 3C) and dout (BT, H, W, C) in dtype; ln, bias_x, bias_y,
// scale, fused, head_dim as for bf_axial_attention_fwd.  Outputs: dqkv (BT,
// H, W, 3C) in dtype; float32 and zeroed by the caller: dln (4, head_dim),
// dbias_x (heads, W, W), dbias_y (heads, H, H), dscale (heads, 2).  Scratch:
// dacc float32 (BT, H, W, 3C) for fused (else unused), stats float32 (BT,
// heads, H, W, 3) where max(H, W) > 64 (else unused).  Returns a cudaError_t.
extern "C" int bf_axial_attention_bwd(int dtype, int head_dim, int fused, const void* qkv,
                                      const void* dout, const float* ln, const float* bias_x,
                                      const float* bias_y, const float* scale, void* dqkv,
                                      float* dacc, float* stats, float* dln, float* dbias_x,
                                      float* dbias_y, float* dscale, int BT, int H, int W, int C,
                                      int heads, void* stream) {
  bft::AxialArgs a{};
  a.qkv = qkv;
  a.dout = dout;
  a.ln = ln;
  a.bias_x = bias_x;
  a.bias_y = bias_y;
  a.scale = scale;
  a.dqkv = dqkv;
  a.dacc = dacc;
  a.stats = stats;
  a.dln = dln;
  a.dbias_x = dbias_x;
  a.dbias_y = dbias_y;
  a.dscale = dscale;
  a.BT = BT;
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  a.stream = static_cast<cudaStream_t>(stream);
  return bft::dispatch<bft::Bwd>(dtype, head_dim, fused, a);
}
