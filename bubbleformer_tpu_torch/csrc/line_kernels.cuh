// The line kernels: axial row + column attention, forward and backward,
// hand-written for Hopper (sm_90a).  One kernel family; the TPU kernels it
// replaces differ in their boundary and where they round, which the template
// parameter Flavour selects (Rounding below), and the head dim is a template
// parameter (16 or 64, the head dims of the repo's configs).
//
//   Flavour      TPU kernel (bubbleformer_tpu/ops/)                 C entries
//   kLane        K2 axial_lane.py:_fwd_kernel, _bwd_kernel         axial_attention.cu
//   kFusedBlock  K4 axial_fused_block.py:_fwd_kernel, _bwd_kernel  axial_attention.cu
//   kPacked      K6 axial_fused_packed.py:_fwd_kernel, _bwd_chunk  axial_fused.cu
//   kFused       K7 axial_fused.py:_fwd_kernel, _bwd_chunk         axial_fused.cu
//   kMega        K5's attention, axial_block_mega.py:_attn_chunks_fwd
//                (its backward is kFusedBlock's)                    axial_block_mega.cu
//   kFlash       K8 axial_pallas.py:_fwd_kernel, _bwd_kernel        axial_flash.cu
//   kLanePx      K9's backward, axial_lane.py:_bwd_kernel_px        axial_lane_px.cu
//                (its forward is kLane's)
// kLane, kMega and kLanePx are built in float32 alone: K2, K5 and K9 run
// in bf16 on lane_hopper.cuh.
//
// All compute, per head, attention along each image row (over W, T5 table
// bias_x, attn scale s_x) and along each column (over H, bias_y, s_y), and
// the mean of the two directions.  K2, K4 and K5 read the interleaved (BT, H,
// W, 3C) QKV tensor (per head [q|k|v], d values each) and run the per-head
// qk-LayerNorm in the kernel; K6 and K7 read q, k and v already normalised,
// as one (3, BT, H, W, C) tensor (Planes).  Per direction, with P = softmax(q
// k^T / sqrt(d) + bias) over a line of L tokens:
//   fold (K2, K7):  o = R(s P + (1-s)/L) v,  out = dtype(0.5 (dtype(o_r) +
//                   dtype(o_c))); R rounds to dtype in K2, not in K7
//                   (axial_lane.py:_axis_fwd; axial_fused.py:92-147)
//   no fold (K4, K6, K5): o = s (dtype(P) v) + (1-s) mean(v),  o and the sum
//                   0.5 o_r + 0.5 o_c in float32, rounded once (K4, K6) or
//                   kept in float32 (K5's ao)  (axial_fused_block.py:103-135,
//                   axial_fused_packed.py:133-190, axial_block_mega.py:108-140)
// The TPU kernels' chunk tables, -1e9 block masks, packed heads, kron bias
// spreads and dual layouts were TPU answers and have no counterpart: those
// masks make the packed products exactly per-line attention, which is what
// this computes; h != w is supported and the two directions are independent
// launches over their own lines.
//
// K8 (kFlash) is one direction only: M independent lines of n tokens per
// head, read from and written to (heads, M, n, d) planes (the launchers get
// BT = 1, H = M, W = n and run the row pass alone).  Its function is K7's
// without the second direction: o = dtype(P_eff v) with P_eff = s P +
// (1-s)/n in float32, rounded once (axial_pallas.py:66-79); the backward
// takes dao = dout as it is, keeps dS and P_eff in float32 and rounds dq,
// dk and dv once (:82-152).
//
// Forward, launched once per direction on one stream: pass 0 (rows) writes
// its float32 output, pass 1 (columns) reads it and writes the result.
// Lines of at most 64 tokens take line_short_fwd_kernel, one block per
// line holding the whole line (29 KB of shared memory at d = 64, L = 32).
// Longer lines take line_fwd_kernel, one block per (query tile of 64 tokens,
// line, head, BT); keys stream through shared memory in tiles of 64, so
// shared memory does not grow with L (84 KB at d = 64).  Every flavour's
// probabilities are exact after normalisation (and rounded in all but K7),
// so the block makes two passes over the key tiles rather than an
// online-softmax rescale of the output:
//   1. logits of each key tile; the row max m and the sum z = sum exp(l - m)
//      with the running rescale z <- z exp(m_old - m_new) + sum_tile;
//   2. logits again, P = exp(l - m) / z exactly, rounded as the flavour
//      says, times the value tile, summed in float32 in shared memory; the
//      no-fold flavours also sum v for their window mean.
// For a line of one tile the two give the same P bit for bit.  No block
// keeps arrays of partial sums in registers, so that several blocks share an
// SM.
//
// Backward, per direction, the flash-attention backward shape.  With G =
// dao v^T (dao = R(0.5 dout)):
//   dscale += sum (P - 1/L) G,  D_i = s sum_j P_ij G_ij,
//   dS = P (s G - D)  (the T5 table's gradient),
//   dq = R(dS) k / sqrt(d),  dk = R(dS)^T q / sqrt(d),
//   fold:     dv = R(s P + (1-s)/L)^T dao          (axial_lane.py:_axis_bwd,
//                                                   axial_fused.py:150)
//   no fold:  dv = dtype(P)^T dtype(s dao) + (1-s) sum_i dao_i / L
//                                                  (axial_fused_packed.py:192)
// then, where the kernel normalises q and k, the qk-LN backward (flax
// LayerNorm, fast variance).
//   line_bwd_q_kernel, one block per query tile of a line: over the key
//     tiles, m, z and sum_j e_ij G_ij (rescaled like z) give D_i and dscale
//     in one pass; a second pass forms dS (the table gradient) and dq.  A
//     line of one tile also takes dk and dv here, so short lines need no
//     second kernel; longer lines save (m, z, D) per query for
//   line_bwd_kv_kernel, one block per key tile of a line: over the query
//     tiles, dk and dv.
// Rounding of the input gradients.  K2, K7: each direction's gradient (after
// the LN backward in K2) is rounded to the activation dtype; the row pass
// writes it and the column pass adds its own rounded gradient into it (K7:
// dq_ref += dtype(dq), axial_fused.py:228; the TPU K2 projected once per
// direction and summed the two; the port's QKV is one tensor).  K9
// (kLanePx): each pass writes its own rounded gradient over the last, and
// the caller projects it back before the next pass (the TPU kernel's
// per-direction dqkv, axial_lane.py:462-480).  K4, K6: the
// row pass keeps its dq, dk (w.r.t. the LN outputs) and dv in a float32
// scratch; the column pass adds its own, runs the LN backward on the sum (K4)
// and rounds once (axial_fused_block.py:217-250, axial_fused_packed.py:
// 292-300).  Each (token, head) belongs to one block per launch, and launches
// run in order on one stream, so there is no race.  The table, scale and LN
// gradients are sums over all lines, in a fixed order: the lines of a pass
// fall into groups of consecutive runs (the host's plan, ops/axial_lane.py:
// line_bwd_scratch), launch k takes the k-th line of every run, and a block
// writes (k = 0) or adds its dS into its group's slot of a partial table, and
// its dscale and LN sums (per warp in shared memory, then in warp order) into
// its group's unit; a last launch adds the partials in group order
// (param_sums.cuh), so every parameter gradient repeats bit for bit from run
// to run.  The kernels stay one line a block: a block looping over its run
// took 170-242 registers a thread where one line takes 64-128 (ptxas,
// sm_90a; the compiler kept each line's index math live across the loop) and
// ran the float32 K4 backward at half its speed (NVIDIA H100 80GB HBM3,
// 700.00 W).
//
// What bounds them.  At FiLMAViT-small's training shape (BT = 40, 32x32
// tokens, C = 384) ~1.3 GFLOP forward and ~3.2 backward against ~38 MB read
// and written in bf16: memory bounds them on paper, but the L x L products run
// on the CUDA cores from shared memory (a d-long dot product per logit, one
// block of 256 threads per tile) and they set their time.  At the 32x128
// flow-boiling grid the rows' 128-token lines cost four times the per-token
// work of the columns'.  Left for later: tensor-core (wgmma) tiles for the
// products, bf16 staging, the row output kept on chip.
#pragma once

#include <cmath>

#include "common.cuh"
#include "param_sums.cuh"

namespace bft {
namespace {

constexpr int kLineThreads = 256;
constexpr int kLineWarps = kLineThreads / 32;
constexpr int kTile = 64;  // tokens of a query or key tile

enum class Flavour { kLane, kFusedBlock, kPacked, kFused, kMega, kFlash, kLanePx };

template <Flavour F>
struct Rounding {
  // q and k normalised in the kernel, from the interleaved (BT, H, W, 3C) qkv.
  static constexpr bool ln = F == Flavour::kLane || F == Flavour::kFusedBlock ||
                             F == Flavour::kMega || F == Flavour::kLanePx;
  // The attn_scale blend folded into the probabilities: o = P_eff v.
  static constexpr bool fold = F == Flavour::kLane || F == Flavour::kFused ||
                               F == Flavour::kFlash || F == Flavour::kLanePx;
  // P (P_eff), dS and dao rounded to the activation dtype.
  static constexpr bool round = F != Flavour::kFused && F != Flavour::kFlash;
  // The two directions summed in float32 (output, and q, k, v gradients).
  static constexpr bool f32_sum = F == Flavour::kFusedBlock || F == Flavour::kPacked ||
                                  F == Flavour::kMega;
  // The output kept in float32, in place of the row pass's scratch (and a
  // rounded copy written).
  static constexpr bool f32_out = F == Flavour::kMega;
  // One direction over (heads, M, n, d) planes (K8): the row pass alone
  // writes the rounded output and its gradients, dao = dout.
  static constexpr bool one_pass = F == Flavour::kFlash;
  // Each pass writes its own rounded input gradient (K9: the caller takes
  // the row pass's before the column pass overwrites it).
  static constexpr bool split = F == Flavour::kLanePx;
};

template <typename T, bool kRound>
__device__ __forceinline__ float maybe_round(float v) {
  return kRound ? round_to<T>(v) : v;
}

// Where the values of component c (0 q, 1 k, 2 v) of a token and head start:
// base + c * comp + token * row + head * head_stride.  Interleaved (BT, H, W,
// 3C) qkv: comp = D, row = 3C, head_stride = 3D; separate (3, BT, H, W, C)
// planes: comp = BT*H*W*C, row = C, head_stride = D.
template <typename P>
struct Planes {
  P base;
  long long comp;
  int row, head_stride;
  __device__ P at(size_t token, int h, int c) const {
    return base + c * comp + token * row + (size_t)h * head_stride;
  }
};

// The flavour's layout: interleaved qkv (qk-LN flavours), (3, BT, H, W, C)
// planes (K6, K7), or (3, heads, M, n, d) planes (K8: BT = 1, H = M, W = n).
template <Flavour F, typename P>
Planes<P> make_planes(P base, int D, int BT, int H, int W, int C) {
  if (Rounding<F>::ln) return Planes<P>{base, D, 3 * C, 3 * D};
  if (Rounding<F>::one_pass) return Planes<P>{base, (long long)BT * H * W * C, D, H * W * D};
  return Planes<P>{base, (long long)BT * H * W * C, C, D};
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
  // Line li (= bt * lines + line) of the pass, tile `tile_`, head `h_`.
  __device__ LineCtx(int H_, int W_, int C_, int pass_, int li, int tile_, int h_)
      : pass(pass_), h(h_), H(H_), W(W_), C(C_), tile(tile_) {
    L = pass == 0 ? W : H;
    lines = pass == 0 ? H : W;
    ntile = (L + kTile - 1) / kTile;
    bt = li / lines;
    line = li % lines;
    tl = L < kTile ? L : kTile;
  }
  // Token index of sequence position i of this line.
  __device__ size_t token(int i) const {
    return pass == 0 ? ((size_t)bt * H + line) * W + i : ((size_t)bt * H + i) * W + line;
  }
};

// Where element d of a (token, head) row of the output, and of its gradient,
// lies: (BT, H, W, C), or K8's (heads, M, n, d) planes.
template <Flavour F, int D>
__device__ __forceinline__ size_t out_at(const LineCtx& c, size_t token, int d) {
  if (Rounding<F>::one_pass) return ((size_t)c.h * c.H * c.W + token) * D + d;
  return token * c.C + (size_t)c.h * D + d;
}

// Rows r0 .. r0 + n of component comp into dst (row stride D + 1, float32).
template <typename T, int D>
__device__ void stage(float* dst, const Planes<const T*>& src, const LineCtx& c, int comp,
                      int r0, int n) {
  for (int e = threadIdx.x; e < n * D; e += kLineThreads) {
    const int i = e / D, j = e % D;
    dst[i * (D + 1) + j] = to_f32(src.at(c.token(r0 + i), c.h, comp)[j]);
  }
}

// dao = R(0.5 * dout) of rows r0 .. r0 + n (K8: dout itself).
template <typename T, int D, Flavour F>
__device__ void stage_dao(float* dst, const T* __restrict__ dout, const LineCtx& c, int r0,
                          int n) {
  using R = Rounding<F>;
  for (int e = threadIdx.x; e < n * D; e += kLineThreads) {
    const int i = e / D, j = e % D;
    const float g = to_f32(dout[out_at<F, D>(c, c.token(r0 + i), j)]);
    dst[i * (D + 1) + j] = maybe_round<T, R::round>(R::one_pass ? g : 0.5f * g);
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
  inv = 1.f / sqrtf(var + kNormEps);
}

// dst = dtype(LN(src) * g + b) for n rows, one warp per row; dst may be src.
template <typename T, int D>
__device__ void ln_rows(float* dst, const float* src, int n, const float* g, const float* b) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < n; i += kLineWarps) {
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
  for (int e = threadIdx.x; e < nq * nk; e += kLineThreads) {
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

// The probability the value product takes, from the exact P: the blended
// s P + (1-s)/L (fold) or P, rounded as the flavour says.
template <typename T, Flavour F>
__device__ __forceinline__ float value_weight(float p, float s, float uniform) {
  using R = Rounding<F>;
  return maybe_round<T, R::round>(R::fold ? s * p + uniform : p);
}

// ---------------------------------------------------------------- forward

// One output of a query token at `at`: the no-fold flavours' blend with the
// window mean of v, then pass 0's float32 row output or, in pass 1, the mean
// of both directions in the flavour's rounding (kMega: in place, in float32,
// and rounded into `out`, the backward's residual); K8's one pass rounds its
// output once.
template <typename T, Flavour F>
__device__ __forceinline__ void emit_out(float* row_out, T* out, size_t at, float o, float s,
                                         float vmean, int pass) {
  using R = Rounding<F>;
  if (!R::fold) o = s * o + (1.f - s) * vmean;
  if (R::one_pass) {
    out[at] = from_f32<T>(o);
  } else if (pass == 0) {
    row_out[at] = o;
  } else if (R::f32_out) {
    const float v = 0.5f * row_out[at] + 0.5f * o;
    row_out[at] = v;
    out[at] = from_f32<T>(v);
  } else if (R::f32_sum) {
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
// q, k and v staged (interleaved qkv: together, 3D contiguous values a
// token), qk-LN where the flavour has it, its L x L logits, softmax and the
// flavour's rounding, times V.  Its block is small (29 KB of shared memory at
// d = 64, L = 32, no launch bound on registers), so several share an SM; the
// streaming kernel below, which holds a 64-token tile's buffers, its running
// statistics and its partial sums, ran such lines 15% slower.
// grid (lines, heads, BT).
template <typename T, int D, Flavour F>
__global__ void __launch_bounds__(kLineThreads) line_short_fwd_kernel(
    Planes<const T*> src, const float* __restrict__ ln, const float* __restrict__ bias,
    const float* __restrict__ scale, float* __restrict__ row_out, T* __restrict__ out, int H,
    int W, int C, int pass) {
  using R = Rounding<F>;
  constexpr int LDS = D + 1;
  extern __shared__ float sm[];
  const LineCtx c(H, W, C, pass);
  const int L = c.L, ldp = L + 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* qs = sm;
  float* ks = qs + L * LDS;
  float* vs = ks + L * LDS;
  float* ps = vs + L * LDS;    // (L, L + 1)
  float* vsum = ps + L * ldp;  // (D): sum of v over the line (no-fold flavours)
  const float s = scale[c.h * 2 + pass];
  const float uniform = (1.f - s) * (1.f / L);

  if constexpr (R::ln) {
    for (int e = tid; e < L * 3 * D; e += kLineThreads) {
      const int i = e / (3 * D), j = e % (3 * D);
      (j < D ? qs : j < 2 * D ? ks : vs)[i * LDS + j % D] = to_f32(src.at(c.token(i), c.h, 0)[j]);
    }
    __syncthreads();
    ln_rows<T, D>(qs, qs, L, ln, ln + D);
    ln_rows<T, D>(ks, ks, L, ln + 2 * D, ln + 3 * D);
  } else {
    stage<T, D>(qs, src, c, 0, 0, L);
    stage<T, D>(ks, src, c, 1, 0, L);
    stage<T, D>(vs, src, c, 2, 0, L);
    __syncthreads();
  }
  if (!R::fold && tid < D) {
    float a = 0.f;
    for (int j = 0; j < L; ++j) a += vs[j * LDS + tid];
    vsum[tid] = a;
  }
  __syncthreads();
  logits_tile<D, false>(qs, ks, nullptr, nullptr, ps, nullptr, L, L, ldp,
                        bias + (size_t)c.h * L * L, L);
  __syncthreads();
  // Softmax, one warp per query: P = exp(l - m) / z, weighted and rounded as
  // the flavour says.
  for (int i = warp; i < L; i += kLineWarps) {
    float* r = ps + i * ldp;
    const float l0 = lane < L ? r[lane] : -INFINITY;
    const float l1 = lane + 32 < L ? r[lane + 32] : -INFINITY;
    const float m = warp_max(fmaxf(l0, l1));
    const float e0 = lane < L ? expf(l0 - m) : 0.f;
    const float e1 = lane + 32 < L ? expf(l1 - m) : 0.f;
    const float z = warp_sum(e0 + e1);
    if (lane < L) r[lane] = value_weight<T, F>(e0 / z, s, uniform);
    if (lane + 32 < L) r[lane + 32] = value_weight<T, F>(e1 / z, s, uniform);
  }
  __syncthreads();
  for (int e = tid; e < L * D; e += kLineThreads) {
    const int i = e / D, d = e % D;
    const float* p = ps + i * ldp;
    float a = 0.f;
    for (int j = 0; j < L; ++j) a += p[j] * vs[j * LDS + d];
    emit_out<T, F>(row_out, out, out_at<F, D>(c, c.token(i), d), a, s,
                   R::fold ? 0.f : vsum[d] / L, pass);
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
template <typename T, int D, Flavour F>
__global__ void __launch_bounds__(kLineThreads, 4) line_fwd_kernel(
    Planes<const T*> src, const float* __restrict__ ln, const float* __restrict__ bias,
    const float* __restrict__ scale, float* __restrict__ row_out, T* __restrict__ out, int H,
    int W, int C, int pass) {
  using R = Rounding<F>;
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
  float* vsum = stat_z + kTile;  // (D): sum of v over the line (no-fold flavours)
  float* os = vsum + D;          // (kTile, D + 1): P V summed over the key tiles
  const float* bh = bias + (size_t)c.h * L * L + (size_t)q0 * L;
  const float s = scale[c.h * 2 + pass];
  const float uniform = (1.f - s) * (1.f / L);

  stage<T, D>(qs, src, c, 0, q0, nq);
  for (int i = tid; i < kTile; i += kLineThreads) {
    stat_m[i] = -INFINITY;
    stat_z[i] = 0.f;
  }
  for (int d = tid; d < D; d += kLineThreads) vsum[d] = 0.f;
  __syncthreads();
  if constexpr (R::ln) ln_rows<T, D>(qs, qs, nq, ln, ln + D);

  // 1. Row max and sum over the key tiles.
  for (int k0 = 0; k0 < L; k0 += kTile) {
    const int nk = min(kTile, L - k0);
    stage<T, D>(ks, src, c, 1, k0, nk);
    __syncthreads();
    if constexpr (R::ln) {
      ln_rows<T, D>(ks, ks, nk, ln + 2 * D, ln + 3 * D);
      __syncthreads();
    }
    logits_tile<D, false>(qs, ks, nullptr, nullptr, ps, nullptr, nq, nk, ldp, bh + k0, L);
    __syncthreads();
    for (int i = warp; i < nq; i += kLineWarps) {
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

  // 2. The exact probabilities, weighted and rounded as the flavour says,
  // times V, added up in os.
  for (int k0 = 0; k0 < L; k0 += kTile) {
    const int nk = min(kTile, L - k0);
    stage<T, D>(ks, src, c, 1, k0, nk);
    stage<T, D>(vs, src, c, 2, k0, nk);
    __syncthreads();
    if constexpr (R::ln) {
      ln_rows<T, D>(ks, ks, nk, ln + 2 * D, ln + 3 * D);
      __syncthreads();
    }
    logits_tile<D, false>(qs, ks, nullptr, nullptr, ps, nullptr, nq, nk, ldp, bh + k0, L);
    __syncthreads();
    for (int i = warp; i < nq; i += kLineWarps) {
      float* r = ps + i * ldp;
      const float m = stat_m[i], z = stat_z[i];
      for (int j = lane; j < nk; j += 32) r[j] = value_weight<T, F>(expf(r[j] - m) / z, s, uniform);
    }
    if (!R::fold && tid < D) {
      float a = 0.f;
      for (int j = 0; j < nk; ++j) a += vs[j * LDS + tid];
      vsum[tid] += a;
    }
    __syncthreads();
    for (int e = tid; e < nq * D; e += kLineThreads) {
      const int i = e / D, d = e % D;
      const float* p = ps + i * ldp;
      float a = 0.f;
      for (int j = 0; j < nk; ++j) a += p[j] * vs[j * LDS + d];
      float* o = os + i * LDS + d;
      *o = (k0 == 0 ? 0.f : *o) + a;
    }
    __syncthreads();
  }
  for (int e = tid; e < nq * D; e += kLineThreads) {
    const int i = e / D, d = e % D;
    emit_out<T, F>(row_out, out, out_at<F, D>(c, c.token(q0 + i), d), os[i * LDS + d], s,
                   R::fold ? 0.f : vsum[d] / L, pass);
  }
}

// --------------------------------------------------------------- backward

// One input-gradient value v of component comp at element `j` of a (token,
// head) row, as the flavour combines the two directions: the f32-sum
// flavours keep pass 0's in dacc and round the sum in pass 1; the others
// round each direction's and add pass 1's into pass 0's (K9: write it).  For
// the LN flavours, q and k take ln_bwd_rows instead.
template <typename T, Flavour F>
__device__ __forceinline__ void emit_grad(const Planes<T*>& dst, const Planes<float*>& dacc,
                                          size_t token, int h, int comp, int j, float v,
                                          int pass) {
  T* o = dst.at(token, h, comp) + j;
  if (Rounding<F>::f32_sum) {
    float* a = dacc.at(token, h, comp) + j;
    if (pass == 0) {
      *a = v;
    } else {
      *o = from_f32<T>(*a + v);
    }
  } else if (pass == 0 || Rounding<F>::split) {
    *o = from_f32<T>(v);
  } else {
    *o = from_f32<T>(to_f32(*o) + round_to<T>(v));
  }
}

// The gradients of n rows of component comp (0 q, 1 k) from r0, one warp per
// row, from `dy`, their gradients w.r.t. the attention's q or k (stride
// D + 1).  LN flavours: the qk-LN backward of the raw rows `raw` (stride
// D + 1) into dqkv as the flavour says, adding (dy xhat, dy) into the
// warp's LN sums dln_w[warp][2 comp], dln_w[warp][2 comp + 1]; the K4
// flavour's row pass only keeps dy in dacc.
// The others: dy is the gradient itself (emit_grad).
template <typename T, int D, Flavour F>
__device__ void ln_bwd_rows(const float* raw, const float* dy, int n, int r0, int comp,
                            const float* __restrict__ ln, const LineCtx& c,
                            const Planes<T*>& dst, const Planes<float*>& dacc, float* dln_w) {
  using R = Rounding<F>;
  constexpr int kPer = (D + 31) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if constexpr (!R::ln) {
    for (int i = warp; i < n; i += kLineWarps) {
      const float* y = dy + i * (D + 1);
      for (int d = lane; d < D; d += 32) emit_grad<T, F>(dst, dacc, c.token(r0 + i), c.h, comp,
                                                         d, y[d], c.pass);
    }
    return;
  }
  const bool keep = R::f32_sum && c.pass == 0;
  const float* g = ln + comp * 2 * D;
  float dg[kPer] = {}, db[kPer] = {};
  for (int i = warp; i < n; i += kLineWarps) {
    const float* r = raw + i * (D + 1);
    const float* y = dy + i * (D + 1);
    const size_t token = c.token(r0 + i);
    T* o = dst.at(token, c.h, comp);
    float* a = R::f32_sum ? dacc.at(token, c.h, comp) : nullptr;
    if (keep) {
      for (int d = lane; d < D; d += 32) a[d] = y[d];
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
        const float yv = R::f32_sum ? y[d] + a[d] : y[d];
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
      o[d] = (R::f32_sum || R::split || c.pass == 0)
                 ? from_f32<T>(v)
                 : from_f32<T>(to_f32(o[d]) + round_to<T>(v));
    }
  }
  if (keep) return;
  float* slot = dln_w + warp * 4 * D;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int d = lane + 32 * u;
    if (d < D) {
      slot[2 * comp * D + d] += dg[u];
      slot[(2 * comp + 1) * D + d] += db[u];
    }
  }
}

// Where a backward block's line and partials lie, for one pass: launch k's
// block (blockIdx.x = grp * tiles + tile, blockIdx.y = head) takes tile
// `tile` of line grp * per + k of the pass (line li = bt * lines-per-image +
// line), if that line is below min((grp + 1) * per, lines); launches 0 to
// per - 1 run in order, so group grp's lines are summed in line order.
struct BwdPlan {
  int groups, per, lines;
  int scale_units, ln_units;  // tiles * groups; kernels * tiles * groups * heads
  float* part_bias;   // (groups, heads, L, L): dS summed over the group's lines
  float* part_scale;  // (heads, scale_units): the query blocks' dscale
  float* part_ln;     // (4 D, ln_units): LN flavours
};

// The end of a backward block: its LN sums (the warps' in warp order) into
// column `unit` of the LN partials and, with `with_scale`, its dscale (the
// threads' `dsc`, a fixed tree) into column `su` of head h's scale partials,
// each written (`first`, the run's first line) or added.
template <int D, bool kLn>
__device__ void line_partials(const BwdPlan& plan, int su, int h, int unit, bool first,
                              bool with_scale, float dsc, const float* dln_w, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  if (with_scale) {
    dsc = warp_sum(dsc);
    if (lane == 0) red[warp] = dsc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = 0.f;
      for (int w = 0; w < kLineWarps; ++w) v += red[w];
      float* o = plan.part_scale + (size_t)h * plan.scale_units + su;
      *o = first ? v : *o + v;
    }
  }
  if constexpr (kLn) {
    for (int e = threadIdx.x; e < 4 * D; e += kLineThreads) {
      float v = 0.f;
      for (int w = 0; w < kLineWarps; ++w) v += dln_w[w * 4 * D + e];
      float* o = plan.part_ln + (size_t)e * plan.ln_units + unit;
      *o = first ? v : *o + v;
    }
  }
}

// dk and dv of a key tile from one query tile: gs holds R(dS), ps the
// flavour's value weights, qs and ds the query tile's q and dao.
template <typename T, int D, Flavour F>
__device__ __forceinline__ void accumulate_dkdv(float (&dk)[kTile * D / kLineThreads],
                                                float (&dv)[kTile * D / kLineThreads],
                                                const float* gs, const float* ps, const float* qs,
                                                const float* ds, float* dsum, int nq, int nk,
                                                int ldp, float s) {
  using R = Rounding<F>;
  constexpr int LDS = D + 1;
  constexpr int kAcc = kTile * D / kLineThreads;
  const int tid = threadIdx.x;
#pragma unroll
  for (int u = 0; u < kAcc; ++u) {
    const int e = tid + u * kLineThreads;
    const int j = e / D, d = e % D;
    if (j < nk) {
      float ak = 0.f, av = 0.f;
      for (int i = 0; i < nq; ++i) {
        ak += gs[i * ldp + j] * qs[i * LDS + d];
        const float a = ds[i * LDS + d];
        av += ps[i * ldp + j] * (R::fold ? a : round_to<T>(s * a));
      }
      dk[u] += ak;
      dv[u] += av;
    }
  }
  if (!R::fold && tid < D) {
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

// Blocks an SM must hold of the query kernel and of the key kernel: the
// register budgets the kernels of PR 4-11 compiled to (64 and 128 a thread
// at head dim 64; 64-100 and 64-80 at 16), which the partials' bookkeeping
// otherwise pushes to 80-100 and up to 175: a block fewer an SM, and K6's,
// K7's and K8's backward 13-56% slower (NVIDIA H100 80GB HBM3, 700.00 W).
template <int D>
constexpr int kQBlocks = D == 64 ? 4 : 3;
template <int D>
constexpr int kKvBlocks = D == 64 ? 2 : 3;

// grid (tiles * groups, heads): the plan's blocks.  stats: (BT, heads, lines,
// L, 3) = (m, z, D) per query, written only when the line has more than one
// tile.
template <typename T, int D, Flavour F>
__global__ void __launch_bounds__(kLineThreads, kQBlocks<D>) line_bwd_q_kernel(
    Planes<const T*> src, const T* __restrict__ dout, const float* __restrict__ ln,
    const float* __restrict__ bias, const float* __restrict__ scale, Planes<T*> dst,
    Planes<float*> dacc, float* __restrict__ stats, BwdPlan plan, int H, int W, int C,
    int heads, int pass, int k) {
  using R = Rounding<F>;
  constexpr int LDS = D + 1;
  extern __shared__ float sm[];
  __shared__ float dln_w[kLineWarps * 4 * D];  // each warp's LN sums
  __shared__ float red[kLineWarps];
  const int nt = ((pass == 0 ? W : H) + kTile - 1) / kTile;
  const int tile = blockIdx.x % nt, grp = blockIdx.x / nt, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float s = scale[h * 2 + pass];

  const int li = grp * plan.per + k;
  if (li >= min((grp + 1) * plan.per, plan.lines)) return;  // the run has no k-th line
  const bool first = k == 0;
  for (int e = tid; e < kLineWarps * 4 * D; e += kLineThreads) dln_w[e] = 0.f;
  float dsc = 0.f;  // this thread's queries' d(attn scale)
  const int L = pass == 0 ? W : H;
  const int tl = L < kTile ? L : kTile, ldp = tl + 1;
  const int q0 = tile * kTile, nq = min(kTile, L - q0);
  const bool one = L <= kTile;
  float* qr = sm;               // raw q (tl, D + 1)
  float* qs = qr + tl * LDS;    // q after LN, rounded (LN flavours; else q)
  float* ds = qs + tl * LDS;    // dao; later dk (one-tile lines)
  float* kr = ds + tl * LDS;    // raw k (one-tile lines), else the dq sums
  float* ks = kr + tl * LDS;    // k after LN, rounded (LN flavours; else k)
  float* vs = ks + tl * LDS;    // v; later dq (one-tile lines)
  float* ps = vs + tl * LDS;    // logits, then the value weights (tl, tl + 1)
  float* gs = ps + tl * ldp;    // G, then R(dS)
  float* st_m = gs + tl * ldp;
  float* st_z = st_m + tl;
  float* st_a = st_z + tl;      // sum e G, then D
  float* st_g = st_a + tl;      // sum G
  float* dsum = st_g + tl;      // (D) sum (1-s) dao (no-fold flavours)
  const float* bh = bias + (size_t)h * L * L + (size_t)q0 * L;
  float* slot = plan.part_bias + ((size_t)(grp * heads + h) * L + q0) * L;  // rows q0 ..
  const float uniform = (1.f - s) * (1.f / L);
  const LineCtx c(H, W, C, pass, li, tile, h);
  for (int i = tid; i < tl; i += kLineThreads) {
    st_m[i] = -INFINITY;
    st_z[i] = st_a[i] = st_g[i] = 0.f;
  }
  stage<T, D>(R::ln ? qr : qs, src, c, 0, q0, nq);
  stage_dao<T, D, F>(ds, dout, c, q0, nq);
  __syncthreads();
  if constexpr (R::ln) ln_rows<T, D>(qs, qr, nq, ln, ln + D);

  auto load_keys = [&](int k0, int nk) {
    float* raw = R::ln && one ? kr : ks;
    stage<T, D>(raw, src, c, 1, k0, nk);
    stage<T, D>(vs, src, c, 2, k0, nk);
    __syncthreads();
    if constexpr (R::ln) {
      ln_rows<T, D>(ks, raw, nk, ln + 2 * D, ln + 3 * D);
      __syncthreads();
    }
    logits_tile<D, true>(qs, ks, ds, vs, ps, gs, nq, nk, ldp, bh + k0, L);
    __syncthreads();
  };

  // 1. m, z, sum e G (rescaled with z) and sum G over the key tiles.
  for (int k0 = 0; k0 < L; k0 += kTile) {
    const int nk = min(kTile, L - k0);
    load_keys(k0, nk);
    for (int i = warp; i < nq; i += kLineWarps) {
      const float* r = ps + i * ldp;
      const float* gr = gs + i * ldp;
      const bool in0 = lane < nk, in1 = lane + 32 < nk;
      const float l0v = in0 ? r[lane] : -INFINITY, l1v = in1 ? r[lane + 32] : -INFINITY;
      const float g0 = in0 ? gr[lane] : 0.f, g1 = in1 ? gr[lane + 32] : 0.f;
      const float m_old = st_m[i];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(l0v, l1v)));
      const float e0 = in0 ? expf(l0v - m_new) : 0.f, e1 = in1 ? expf(l1v - m_new) : 0.f;
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
  for (int i = tid; i < nq; i += kLineThreads) {
    const float pg = st_a[i] / st_z[i];
    st_a[i] = s * pg;
    dsc += pg - st_g[i] * (1.f / L);
    if (!one) {
      float* o = stats + ((((size_t)c.bt * heads + h) * c.lines + c.line) * L + q0 + i) * 3;
      o[0] = st_m[i];
      o[1] = st_z[i];
      o[2] = st_a[i];
    }
  }
  __syncthreads();

  // 2. dS (into the block's table sum), then dq: a longer line adds dq up
  // over its key tiles in kr (free there: its keys' LN runs in place in ks).
  for (int k0 = 0; k0 < L; k0 += kTile) {
    const int nk = min(kTile, L - k0);
    if (!one) load_keys(k0, nk);
    for (int i = warp; i < nq; i += kLineWarps) {
      float* r = ps + i * ldp;
      float* gr = gs + i * ldp;
      const float m = st_m[i], z = st_z[i], dd = st_a[i];
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(r[j] - m) / z;
        const float dS = p * (s * gr[j] - dd);
        // The block's own cell, one thread's in every line: a store,
        // then reductions that need no load and apply in program order.
        float* cell = slot + (size_t)i * L + k0 + j;
        if (first) {
          *cell = dS;
        } else {
          atomicAdd(cell, dS);
        }
        gr[j] = maybe_round<T, R::round>(dS);
        if (one) r[j] = value_weight<T, F>(p, s, uniform);
      }
    }
    if (!R::fold && one && tid < D) {
      float a = 0.f;
      for (int i = 0; i < nq; ++i) a += (1.f - s) * ds[i * LDS + tid];
      dsum[tid] = a;
    }
    __syncthreads();
    if (one) break;
    for (int e = tid; e < nq * D; e += kLineThreads) {
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
    for (int e = tid; e < nq * D; e += kLineThreads) {
      const int i = e / D, d = e % D;
      const float* g = gs + i * ldp;
      float aq = 0.f, av = 0.f;
      for (int j = 0; j < nq; ++j) aq += g[j] * ks[j * LDS + d];
      for (int r = 0; r < nq; ++r) {
        const float a = ds[r * LDS + d];
        av += ps[r * ldp + i] * (R::fold ? a : round_to<T>(s * a));
      }
      vs[i * LDS + d] = aq * head_scaling<D>();
      emit_grad<T, F>(dst, dacc, c.token(i), h, 2, d, R::fold ? av : av + dsum[d] / L, pass);
    }
    __syncthreads();
    for (int e = tid; e < nq * D; e += kLineThreads) {
      const int j = e / D, d = e % D;
      float a = 0.f;
      for (int i = 0; i < nq; ++i) a += gs[i * ldp + j] * qs[i * LDS + d];
      ds[j * LDS + d] = a * head_scaling<D>();
    }
    __syncthreads();
    ln_bwd_rows<T, D, F>(qr, vs, nq, 0, 0, ln, c, dst, dacc, dln_w);
    ln_bwd_rows<T, D, F>(kr, ds, nq, 0, 1, ln, c, dst, dacc, dln_w);
  } else {
    ln_bwd_rows<T, D, F>(qr, kr, nq, q0, 0, ln, c, dst, dacc, dln_w);
  }
  line_partials<D, R::ln>(plan, tile * plan.groups + grp, h,
                          (tile * plan.groups + grp) * heads + h, first, true, dsc, dln_w, red);
}

// grid (tiles * groups, heads), lines of more than one tile only: the key
// tiles of the plan's lines; its LN partials follow the query blocks'.
template <typename T, int D, Flavour F>
__global__ void __launch_bounds__(kLineThreads, kKvBlocks<D>) line_bwd_kv_kernel(
    Planes<const T*> src, const T* __restrict__ dout, const float* __restrict__ ln,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ stats, Planes<T*> dst, Planes<float*> dacc, BwdPlan plan, int H,
    int W, int C, int heads, int pass, int k) {
  using R = Rounding<F>;
  constexpr int LDS = D + 1;
  constexpr int kAcc = kTile * D / kLineThreads;
  extern __shared__ float sm[];
  __shared__ float dln_w[kLineWarps * 4 * D];
  __shared__ float red[kLineWarps];
  const int nt = ((pass == 0 ? W : H) + kTile - 1) / kTile;
  const int tile = blockIdx.x % nt, grp = blockIdx.x / nt, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float s = scale[h * 2 + pass];

  const int li = grp * plan.per + k;
  if (li >= min((grp + 1) * plan.per, plan.lines)) return;  // the run has no k-th line
  for (int e = tid; e < kLineWarps * 4 * D; e += kLineThreads) dln_w[e] = 0.f;
  const int L = pass == 0 ? W : H;
  const int tl = L < kTile ? L : kTile, ldp = tl + 1;
  const int k0 = tile * kTile, nk = min(kTile, L - k0);
  float* kr = sm;             // raw k
  float* ks = kr + tl * LDS;  // k after LN, rounded (LN flavours; else k); later dk
  float* vs = ks + tl * LDS;
  float* qs = vs + tl * LDS;  // a query tile's q after LN, rounded
  float* ds = qs + tl * LDS;  // its dao
  float* ps = ds + tl * LDS;
  float* gs = ps + tl * ldp;
  float* st = gs + tl * ldp;  // (tl, 3): m, z, D of the query tile
  float* dsum = st + 3 * tl;
  const float* bh = bias + (size_t)h * L * L + k0;
  const float uniform = (1.f - s) * (1.f / L);
  const LineCtx c(H, W, C, pass, li, tile, h);
  const float* sth = stats + (((size_t)c.bt * heads + h) * c.lines + c.line) * L * 3;
  for (int d = tid; d < D; d += kLineThreads) dsum[d] = 0.f;
  stage<T, D>(R::ln ? kr : ks, src, c, 1, k0, nk);
  stage<T, D>(vs, src, c, 2, k0, nk);
  __syncthreads();
  if constexpr (R::ln) ln_rows<T, D>(ks, kr, nk, ln + 2 * D, ln + 3 * D);

  float dk[kAcc] = {}, dv[kAcc] = {};
  for (int q0 = 0; q0 < L; q0 += kTile) {
    const int nq = min(kTile, L - q0);
    stage<T, D>(qs, src, c, 0, q0, nq);
    stage_dao<T, D, F>(ds, dout, c, q0, nq);
    for (int e = tid; e < 3 * nq; e += kLineThreads) st[e] = sth[(size_t)q0 * 3 + e];
    __syncthreads();
    if constexpr (R::ln) {
      ln_rows<T, D>(qs, qs, nq, ln, ln + D);
      __syncthreads();
    }
    logits_tile<D, true>(qs, ks, ds, vs, ps, gs, nq, nk, ldp, bh + (size_t)q0 * L, L);
    __syncthreads();
    for (int i = warp; i < nq; i += kLineWarps) {
      float* r = ps + i * ldp;
      float* gr = gs + i * ldp;
      const float m = st[3 * i], z = st[3 * i + 1], dd = st[3 * i + 2];
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(r[j] - m) / z;
        gr[j] = maybe_round<T, R::round>(p * (s * gr[j] - dd));
        r[j] = value_weight<T, F>(p, s, uniform);
      }
    }
    __syncthreads();
    accumulate_dkdv<T, D, F>(dk, dv, gs, ps, qs, ds, dsum, nq, nk, ldp, s);
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < kAcc; ++u) {
    const int e = tid + u * kLineThreads;
    const int j = e / D, d = e % D;
    if (j >= nk) continue;
    ks[j * LDS + d] = dk[u] * head_scaling<D>();
    const float v = R::fold ? dv[u] : dv[u] + dsum[d] / L;
    emit_grad<T, F>(dst, dacc, c.token(k0 + j), h, 2, d, v, pass);
  }
  __syncthreads();
  ln_bwd_rows<T, D, F>(kr, ks, nk, k0, 1, ln, c, dst, dacc, dln_w);
  line_partials<D, R::ln>(plan, 0, h, (plan.groups * nt + tile * plan.groups + grp) * heads + h,
                          k == 0, false, 0.f, dln_w, red);
}

// ------------------------------------------------------------- launchers

struct AxialArgs {
  const void* qkv;  // interleaved (BT, H, W, 3C) or planes (3, BT, H, W, C)
  const void* dout;
  const float* ln;
  const float* bias_x;
  const float* bias_y;
  const float* scale;
  float* row_out;
  void* out;
  void* dqkv;  // as qkv
  float* dacc;  // as qkv, float32 (f32-sum flavours)
  float* stats;
  float* dln;
  float* dbias_x;
  float* dbias_y;
  float* dscale;
  // The backward's plan and partials: pass p's BT x (H or W) lines go to
  // groups[p] blocks of per[p] lines a head and tile; part holds both
  // passes' partials (line_bwd_plans).
  float* part;
  int groups[2], per[2];
  int BT, H, W, C, heads;
  cudaStream_t stream;
};

template <typename T, int D, Flavour F>
int line_attention_fwd(const AxialArgs& a) {
  using R = Rounding<F>;
  cudaError_t e;
  auto short_kernel = line_short_fwd_kernel<T, D, F>;
  auto kernel = line_fwd_kernel<T, D, F>;
  if ((e = cudaFuncSetAttribute(short_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)short_fwd_smem_bytes<D>(kTile))) != cudaSuccess)
    return e;
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)fwd_smem_bytes<D>())) != cudaSuccess)
    return e;
  const Planes<const T*> src =
      make_planes<F>(static_cast<const T*>(a.qkv), D, a.BT, a.H, a.W, a.C);
  for (int pass = 0; pass < (R::one_pass ? 1 : 2); ++pass) {
    const int L = pass == 0 ? a.W : a.H, lines = pass == 0 ? a.H : a.W;
    const float* bias = pass == 0 ? a.bias_x : a.bias_y;
    T* out = static_cast<T*>(a.out);
    if (L <= kTile) {
      short_kernel<<<dim3(lines, a.heads, a.BT), kLineThreads, short_fwd_smem_bytes<D>(L),
                     a.stream>>>(src, a.ln, bias, a.scale, a.row_out, out, a.H, a.W, a.C, pass);
    } else {
      kernel<<<dim3(lines * ((L + kTile - 1) / kTile), a.heads, a.BT), kLineThreads,
               fwd_smem_bytes<D>(), a.stream>>>(src, a.ln, bias, a.scale, a.row_out, out, a.H,
                                                a.W, a.C, pass);
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Both passes' plans, carved from a.part in this order for each pass: the
// table partials (groups, heads, L, L), the scale partials (heads, tiles *
// groups) and, for the LN flavours, the LN partials (4 D, kernels * tiles *
// groups * heads), kernels 2 for lines of more than one tile, else 1 (the
// layout ops/axial_lane.py:line_bwd_scratch allocates); and the sum's
// arguments.  False if a plan does not give every line to one block.
template <Flavour F>
bool line_bwd_plans(const AxialArgs& a, int D, BwdPlan (&plan)[2], ParamSumArgs& sum) {
  using R = Rounding<F>;
  sum = ParamSumArgs{};
  float* at = a.part;
  for (int p = 0; p < 2; ++p) {
    plan[p] = BwdPlan{};
    if (p == 1 && R::one_pass) break;
    const int L = p == 0 ? a.W : a.H, lines = a.BT * (p == 0 ? a.H : a.W);
    const int nt = (L + kTile - 1) / kTile, kernels = L > kTile ? 2 : 1;
    const int g = a.groups[p];
    if (!plan_ok(lines, g, a.per[p])) return false;
    plan[p] = BwdPlan{g, a.per[p], lines, nt * g, R::ln ? kernels * nt * g * a.heads : 0, at,
                      nullptr, nullptr};
    at += (size_t)g * a.heads * L * L;
    plan[p].part_scale = at;
    at += (size_t)nt * g * a.heads;
    if (R::ln) {
      plan[p].part_ln = at;
      at += (size_t)kernels * nt * g * a.heads * 4 * D;
    }
    sum.part_bias[p] = plan[p].part_bias;
    sum.part_scale[p] = plan[p].part_scale;
    sum.part_ln[p] = plan[p].part_ln;
    sum.bias_groups[p] = g;
    sum.scale_units[p] = plan[p].scale_units;
    sum.ln_units[p] = plan[p].ln_units;
    sum.L[p] = L;
  }
  sum.dbias[0] = a.dbias_x;
  sum.dbias[1] = a.dbias_y;
  sum.dscale = a.dscale;
  sum.dln = R::ln ? a.dln : nullptr;
  sum.heads = a.heads;
  sum.D = D;
  return true;
}

// One direction of the backward (pass 0 rows, 1 columns) on its plan: per
// launches of the query kernel (a line of each group's run each), and as many
// of the key kernel for lines of more than 64 tokens.
template <typename T, int D, Flavour F>
int line_attention_bwd_pass(const AxialArgs& a, const BwdPlan& plan, int pass) {
  cudaError_t e;
  auto qk = line_bwd_q_kernel<T, D, F>;
  auto kvk = line_bwd_kv_kernel<T, D, F>;
  if ((e = cudaFuncSetAttribute(qk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bwd_q_smem_bytes<D>(kTile))) != cudaSuccess)
    return e;
  if ((e = cudaFuncSetAttribute(kvk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bwd_kv_smem_bytes<D>(kTile))) != cudaSuccess)
    return e;
  const Planes<const T*> src =
      make_planes<F>(static_cast<const T*>(a.qkv), D, a.BT, a.H, a.W, a.C);
  const Planes<T*> dst = make_planes<F>(static_cast<T*>(a.dqkv), D, a.BT, a.H, a.W, a.C);
  const Planes<float*> dacc = make_planes<F>(a.dacc, D, a.BT, a.H, a.W, a.C);
  const T* dout = static_cast<const T*>(a.dout);
  const int L = pass == 0 ? a.W : a.H;
  const int tl = L < kTile ? L : kTile, nt = (L + kTile - 1) / kTile;
  const dim3 grid(nt * plan.groups, a.heads);
  const float* bias = pass == 0 ? a.bias_x : a.bias_y;
  for (int k = 0; k < plan.per; ++k) {
    qk<<<grid, kLineThreads, bwd_q_smem_bytes<D>(tl), a.stream>>>(
        src, dout, a.ln, bias, a.scale, dst, dacc, a.stats, plan, a.H, a.W, a.C, a.heads, pass,
        k);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  for (int k = 0; L > kTile && k < plan.per; ++k) {
    kvk<<<grid, kLineThreads, bwd_kv_smem_bytes<D>(tl), a.stream>>>(
        src, dout, a.ln, bias, a.scale, a.stats, dst, dacc, plan, a.H, a.W, a.C, a.heads, pass,
        k);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Both directions (K8: one), then the fixed-order sum of their partials
// into dbias_x, dbias_y, dscale and dln, written whole.
template <typename T, int D, Flavour F>
int line_attention_bwd(const AxialArgs& a) {
  BwdPlan plan[2];
  ParamSumArgs sum;
  if (!line_bwd_plans<F>(a, D, plan, sum)) return cudaErrorInvalidValue;
  for (int pass = 0; pass < (Rounding<F>::one_pass ? 1 : 2); ++pass) {
    const int e = line_attention_bwd_pass<T, D, F>(a, plan[pass], pass);
    if (e != cudaSuccess) return e;
  }
  return launch_param_sum(sum, a.stream);
}

// The line kernels' envelope: head dim 16 or 64, lines of at most 512 tokens.
inline bool line_shape_ok(int head_dim, const AxialArgs& a) {
  return (head_dim == 16 || head_dim == 64) && a.H <= 512 && a.W <= 512 &&
         a.C == a.heads * head_dim;
}

}  // namespace
}  // namespace bft
