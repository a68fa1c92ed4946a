// K8 in bfloat16, redesigned for Hopper (sm_90a): attention over M
// independent lines of n tokens a head with a bias table and the attn_scale
// blend, forward and backward, on tensor cores.
//
// Replaces bubbleformer_tpu/ops/axial_pallas.py:_make_flash (pl.pallas_call
// :155; bodies _fwd_kernel :66 and _bwd_kernel :82, custom VJP :195-208),
// entry flash_packed_attention, for bf16 activations: the `flash` route of
// both attention branches.  float32 K8 stays on line_kernels.cuh (kFlash).
//
// What it computes, per line of head h (q, k, v (heads, M, n, d) bf16):
//   P = softmax(q k^T / sqrt(d) + bias_h),  P_eff = s_h P + (1 - s_h) / n,
//   out = R(P_eff v)                                  (R: round to bf16)
// and backward, G = dout v^T:  dscale_h += sum (P - 1/n) G,  D_i = s
// sum_j P_ij G_ij,  dS = P (s G - D)  (dbias_h += dS),  dq = R(dS k /
// sqrt(d)),  dk = R(dS^T q / sqrt(d)),  dv = R(P_eff^T dout).  The TPU
// kernel keeps P_eff and dS in float32 and rounds only the outputs, so where
// they are an operand of a product (P_eff v, dS k, dS^T q, P_eff^T dout) each
// is split into a pair of bf16 values, hi = R(x) and lo = R(x - hi), and
// the product runs twice on the bf16 tensor cores (mma.sync.m16n8k16, float32
// accumulation): within ~2^-16 of float32, for twice those products' work.
// q k^T and dout v^T take bf16 operands exactly.
//
// What bounds it on an H100: bytes.  At FiLMAViT-small's training shapes
// (the temporal lines (6, 8192, 5, 64), the axial rows and columns (6, 1280,
// 32, 64)) each of q, k, v, out is 31.5 MB: the forward moves 126 MB (0.038
// ms at 3.35 TB/s), the backward 220 MB (0.066 ms), against ~1.3 and ~3.6
// GFLOP with the split (a few microseconds on the tensor cores).  The design
// moves only those bytes, once:
//   - lines are contiguous rows of their (heads, M, n, d) planes, so a block
//     stages its rows with 16-byte loads into swizzled bf16 tiles (the
//     ldmatrix layout of lane_hopper.cuh, whose mma.sync tiles this reuses);
//   - short lines are packed: n <= 16 puts floor(16 / n) lines in a 16-row
//     tile (n = 5: three; n = 8: two), the keys of a 32-row unit (two tiles)
//     masked block-diagonally (-inf, so a masked logit's exp is exactly 0, as
//     the TPU kernel's -1e9 gives), and a block stages 128 rows: 24 lines of
//     5, 16 of 8, 4 of 32, 2 of 64; longer lines take a unit of their own;
//   - P is normalised exactly before it is split (two passes over the key
//     chunks: max and sum, then P), P stays in registers between its two
//     products (the accumulator fragment of S is the A fragment of P V);
//   - the backward recomputes S and G over the key tiles from per-query
//     statistics (m, z, D) in shared memory instead of keeping dS and P_eff:
//     a block's shared memory is then its staged rows alone (87 KB at n = 32,
//     d = 64; its registers, 247 a thread at d = 64, hold an SM to one
//     block);
//   - the parameter gradients never touch a global atomic: a backward block
//     owns a run of segments of one head (the host's plan, ops/axial_pallas.py:
//     flash_bwd_plan) and sums dS over them in shared memory (lines of at
//     most 64 tokens: a slot a warp, the lines of a tile added one after
//     another) or in its own slot of the partials, with dscale, into one
//     partial a block: the first level of param_sums.cuh's fixed-order sum,
//     whose last launch adds the blocks' partials in order; both repeat bit
//     for bit.
// Lines of 1 to 512 tokens forward; the backward stages four (rows, d) tiles
// and takes lines while they fit in 128 KB (d = 16: all; d = 64: n <= 256).
//
// K7 in bfloat16 (kPlane; replaces bubbleformer_tpu/ops/axial_fused.py:
// _make_fused, pl.pallas_call :273 forward, :284 backward; _attn_chunk :92,
// _bwd_chunk :150) is K8 over the rows and then the columns of q, k, v
// (BT, H, W, heads, d), read in place: a line is a row (tokens 1 apart) or a
// column (tokens W apart) of the plane, so a staged row's token comes from
// seg_rows' offset function and its head's d values are one 16-byte-aligned
// run wherever the tensor's strides put it (v is a strided view of the
// Dense's output).  Each direction keeps K8's rounding (P_eff and dS in
// float32, split into bf16 pairs) at its own table and scale; the row pass
// writes R(0.5 P_eff v), the column pass adds its own R(0.5 P_eff v) and
// rounds the sum (axial_fused.py:134, :147).  The backward runs K8's on
// dao = 0.5 dout (exact in bf16) a direction at a time; each direction's
// dq, dk, dv is rounded, and the column pass adds its own to the row
// pass's and rounds again (:210-233).
#pragma once

#include <type_traits>

#include "lane_hopper.cuh"

namespace bft {
namespace flash {
namespace {

using namespace lane;

constexpr int kMaxRows = 512;             // staged rows of the longest line
constexpr int kBwdStageBytes = 128 << 10;  // the backward's four staged tiles at most
constexpr int kWarpSlotMax = 64;          // lines up to this long sum dS in shared memory

// How a block's staged rows map onto lines: `units` units of `ru` rows (a
// key chunk of 32 or more).  n <= 16: a unit is two 16-row tiles of lp16 =
// floor(16 / n) lines each; longer lines: a line a unit.  A segment is the
// lps lines a block stages at once.
struct Geo {
  int n, M, lp16, ru, units, lpu, lps, rows;
  __host__ __device__ Geo(int n_, int M_) : n(n_), M(M_) {
    lp16 = n <= 16 ? 16 / n : 0;
    ru = n <= 16 ? kChunk : round_up(n, kChunk);
    units = ru >= 128 ? 1 : 128 / ru;
    lpu = n <= 16 ? 2 * lp16 : 1;
    lps = units * lpu;
    rows = units * ru;
  }
  __host__ __device__ int segments() const { return (M + lps - 1) / lps; }
  __host__ __device__ int tiles() const { return rows / 16; }
  __host__ __device__ int warps() const { return tiles() < kMaxWarps ? tiles() : kMaxWarps; }
  // The line within the segment of staged row r (-1: an empty row), and its
  // position.
  __device__ int line_of(int r, int* pos) const {
    const int u = r / ru, rr = r % ru;
    if (lp16) {
      const int w = rr & 15, a = w / n;
      if (a >= lp16) return -1;
      *pos = w - a * n;
      return u * lpu + (rr >> 4) * lp16 + a;
    }
    if (rr >= n) return -1;
    *pos = rr;
    return u;
  }
};

struct FlashArgs {
  const bf16 *q, *k, *v;  // (heads, M, n, D) each
  const bf16* dout;   // (heads, M, n, D)
  const float* bias;  // (heads, n, n)
  const float* scale; // (heads, 2): the attn scale in column 0
  bf16* out;          // (heads, M, n, D)
  bf16 *dq, *dk, *dv; // (heads, M, n, D) each
  float* part_bias;   // (groups, heads, n, n): dS summed over each block's segments
  float* part_scale;  // (heads, groups)
  int M, n, heads, groups, per;
};

// K7's (kPlane; q, k, v and dout unused): pass 0 the BT H rows (n = W),
// pass 1 the BT W columns (n = H) of (BT, H, W, heads, D) planes; q, k, v
// (src) and dout (tdo, hdo) read in place; out, half, dq, dk, dv (BT, H, W,
// C) written.  Its own type, so that K8's kernels keep their argument
// layout, on which their register counts depend.
struct PlaneArgs : FlashArgs {
  Src3 src;
  size_t tdo, hdo;
  bf16* half;         // forward: the row pass's R(0.5 P_eff v)
  int pass, H, W, C;
};

template <bool kPlane>
using FlashArgsOf = std::conditional_t<kPlane, PlaneArgs, FlashArgs>;

// K7: the token of position pos of line `line` of the pass (a row, or a
// column of its frame).
__device__ __forceinline__ int plane_token(const PlaneArgs& a, int line, int pos) {
  return a.pass == 0 ? line * a.W + pos : (line / a.W) * a.H * a.W + pos * a.W + line % a.W;
}

// Rows of segment `seg`: rl[r] the line within the segment (-1: an empty
// row, or a line at or past M), rp[r] its position, ro[r] the element offset
// of its token in the head's (M, n, D) plane (-1: none).
template <int D>
__device__ void seg_rows(const Geo& g, int seg, int* rl, int* rp, int* ro) {
  for (int r = threadIdx.x; r < g.rows; r += blockDim.x) {
    int pos = 0;
    int li = g.line_of(r, &pos);
    const int gl = seg * g.lps + li;
    if (li >= 0 && gl >= g.M) li = -1;
    rl[r] = li;
    rp[r] = li >= 0 ? pos : 0;
    ro[r] = li >= 0 ? (gl * g.n + pos) * D : -1;
  }
}

// The staged rows of one plane into a swizzled (rows, D) tile, zero where
// ro is -1; kStageBatch 16-byte loads in flight a thread.
template <int D>
__device__ void stage_plane(bf16* dst, const bf16* __restrict__ src, const int* ro, int rows) {
  constexpr int kV = D / 8;
  const int total = rows * kV;
  for (int e0 = threadIdx.x; e0 < total; e0 += blockDim.x * kStageBatch) {
    uint4 raw[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * blockDim.x;
      raw[u] = make_uint4(0, 0, 0, 0);
      if (e < total) {
        const int o = ro[e / kV];
        if (o >= 0) raw[u] = ldg16(src + o + (e % kV) * 8);
      }
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < total) *reinterpret_cast<uint4*>(dst + sw<D>(e / kV, (e % kV) * 8)) = raw[u];
    }
  }
}

// K7: segment seg's rows as seg_rows places them, each one's offset then
// turned into its token in the (BT, H, W) grid (plane_token).
template <int D>
__device__ void plane_rows(const Geo& g, int seg, int* rl, int* rp, int* ro, const PlaneArgs& a) {
  seg_rows<D>(g, seg, rl, rp, ro);
  for (int r = threadIdx.x; r < g.rows; r += blockDim.x) {  // the rows this thread placed
    if (ro[r] < 0) continue;
    const int i = ro[r] / D;
    ro[r] = plane_token(a, i / g.n, i % g.n);
  }
}

// K7: stage_plane of a tensor read in place, ro holding tokens `ts`
// elements apart in src (src at the head's first value); kHalf: each value
// halved (dao = 0.5 dout, exact in bf16).  stage_plane's twin, kept apart so
// that K8's code stays as it was.
template <int D, bool kHalf>
__device__ void stage_plane_at(bf16* dst, const bf16* __restrict__ src, size_t ts, const int* ro,
                               int rows) {
  constexpr int kV = D / 8;
  const int total = rows * kV;
  for (int e0 = threadIdx.x; e0 < total; e0 += blockDim.x * kStageBatch) {
    uint4 raw[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * blockDim.x;
      raw[u] = make_uint4(0, 0, 0, 0);
      if (e < total) {
        const int o = ro[e / kV];
        if (o >= 0) raw[u] = ldg16(src + (size_t)o * ts + (e % kV) * 8);
      }
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e >= total) continue;
      if constexpr (kHalf) {
        float x[8];
        unpack8(raw[u], x);
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] *= 0.5f;
        raw[u] = pack8(x);
      }
      *reinterpret_cast<uint4*>(dst + sw<D>(e / kV, (e % kV) * 8)) = raw[u];
    }
  }
}

// K7: a segment's q, k and v (and, backward, dao = 0.5 dout) of head h, read
// in place.
template <int D>
__device__ void stage_plane_qkv(bf16* qs, bf16* ks, bf16* vs, bf16* ds, const PlaneArgs& a,
                                int h, const int* ro, int rows) {
  stage_plane_at<D, false>(qs, a.src.q + h * a.src.hq, a.src.tq, ro, rows);
  stage_plane_at<D, false>(ks, a.src.k + h * a.src.hk, a.src.tk, ro, rows);
  stage_plane_at<D, false>(vs, a.src.v + h * a.src.hv, a.src.tv, ro, rows);
  if (ds != nullptr) stage_plane_at<D, true>(ds, a.dout + h * a.hdo, a.tdo, ro, rows);
}

// The table of head h where the kernels read it: lines of at most
// kWarpSlotMax tokens copy it into shared memory (rows n + 1 apart), longer
// ones read it in global memory (rows n apart).
__device__ const float* stage_table(const float* __restrict__ bias, int h, int n, float* tb,
                                    int* ldt) {
  const float* src = bias + (size_t)h * n * n;
  if (n > kWarpSlotMax) {
    *ldt = n;
    return src;
  }
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) tb[e / n * (n + 1) + e % n] = src[e];
  *ldt = n + 1;
  return tb;
}

// A 16 x 32 chunk of logits of the query tile from q0 against the keys
// from k0: q k^T / sqrt(d) + bias[pos_i][pos_j] where both are positions of
// one line, -inf where they are not, 0 across an empty query row (dropped);
// returns which were kept, bit 4 nt + e.
template <int D>
__device__ __forceinline__ uint32_t line_logits(float (&sc)[4][4], const uint32_t (&qa)[D / 16][4],
                                                const bf16* ks, int q0, int k0, const int* rl,
                                                const int* rp, const float* bias, int ldt,
                                                int lane) {
  rows_product<D>(sc, qa, ks, k0, lane);
  const int g = lane >> 2, t = lane & 3;
  const int ql[2] = {rl[q0 + g], rl[q0 + g + 8]}, qp[2] = {rp[q0 + g], rp[q0 + g + 8]};
  uint32_t keep = 0;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, j = k0 + nt * 8 + 2 * t + (e & 1);
      const bool on = ql[r] >= 0 && rl[j] == ql[r];
      sc[nt][e] = on ? sc[nt][e] * head_scaling<D>() + bias[qp[r] * ldt + rp[j]]
                     : (ql[r] < 0 ? 0.f : -INFINITY);
      keep |= (uint32_t)on << (4 * nt + e);
    }
  }
  return keep;
}

// acc (16 x D) += x (16 x 32, accumulator layout, float32) times the rows r0
// .. r0 + 31 of `tile` (k = token, n = D), x as the bf16 pair hi = R(x), lo
// = R(x - hi): two products on the tensor cores, within ~2^-16 of float32.
template <int D>
__device__ __forceinline__ void split_product(float (&acc)[D / 8][4], const float (&x)[4][4],
                                              const bf16* tile, int r0, int lane) {
  float lo[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) lo[nt][e] = x[nt][e] - __bfloat162float(__float2bfloat16(x[nt][e]));
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    uint32_t ah[4], al[4];
    acc_to_a(ah, x, m);
    acc_to_a(al, lo, m);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      load_b_cols<D>(b, tile, r0 + 16 * m, np * 16, lane);
      mma(acc[2 * np], ah, b[0], b[1]);
      mma(acc[2 * np + 1], ah, b[2], b[3]);
      mma(acc[2 * np], al, b[0], b[1]);
      mma(acc[2 * np + 1], al, b[2], b[3]);
    }
  }
}

// The tile's rows r0 + g, r0 + g + 8 of acc times mul, rounded, into a
// head's plane at the rows' offsets (none where ro is -1).
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4], int r0,
                                           const int* ro, float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int o = ro[r0 + g + 8 * r];
    if (o < 0) continue;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      *reinterpret_cast<uint32_t*>(dst + o + n8 * 8 + 2 * t) =
          pack(mul * acc[n8][2 * r], mul * acc[n8][2 * r + 1]);
  }
}

// K7: the tile's rows r0 + g, r0 + g + 8 of acc times mul, rounded, into
// (BT, H, W, C) dst at the rows' tokens and head h (none where ro is -1);
// with prev (which may be dst), each added to prev's value there and the
// sum rounded again.  prev's values are all loaded before the first store:
// interleaved, a store could alias the next load, and each load would wait
// out the last one's latency.
template <int D>
__device__ __forceinline__ void store_plane(bf16* dst, const bf16* prev,
                                            const float (&acc)[D / 8][4], int r0, const int* ro,
                                            int h, int C, float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
  size_t at[2];
  uint32_t old[2][D / 8];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int o = ro[r0 + g + 8 * r];
    at[r] = o < 0 ? 0 : (size_t)o * C + (size_t)h * D + 2 * t;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8) {
      old[r][n8] = prev != nullptr && o >= 0
                       ? *reinterpret_cast<const uint32_t*>(prev + at[r] + n8 * 8) : 0u;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (ro[r0 + g + 8 * r] < 0) continue;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8) {
      uint32_t v = pack(mul * acc[n8][2 * r], mul * acc[n8][2 * r + 1]);
      if (prev != nullptr) {
        const float2 x = unpack(old[r][n8]), y = unpack(v);
        v = pack(x.x + y.x, x.y + y.y);
      }
      *reinterpret_cast<uint32_t*>(dst + at[r] + n8 * 8) = v;
    }
  }
}

// ---------------------------------------------------------------- forward

template <int D>
size_t flash_fwd_smem(int n) {
  const Geo g(n, 1);
  return (size_t)3 * g.rows * D * sizeof(bf16) + (size_t)3 * g.rows * 4 +
         (n <= kWarpSlotMax ? (size_t)n * (n + 1) * 4 : 0);
}

// One segment of one head a block (blockIdx.x = head + heads * segment), a
// warp a 16-query tile at a time: the exact P over its unit's key chunks
// (max and sum, then P), P_eff split and times v, rounded once (kPlane:
// half of it, into half or added to half's into out).
template <int D, bool kPlane>
__global__ void __launch_bounds__(kMaxWarps * 32) flash_fwd_kernel(FlashArgsOf<kPlane> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geo geo(a.n, a.M);
  const int h = blockIdx.x % a.heads, seg = blockIdx.x / a.heads, rows = geo.rows, n = a.n;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + rows * D;
  bf16* vs = ks + rows * D;
  int* rl = reinterpret_cast<int*>(vs + rows * D);
  int* rp = rl + rows;
  int* ro = rp + rows;
  float* tb = reinterpret_cast<float*>(ro + rows);
  const size_t hb = (size_t)h * a.M * n * D;
  if constexpr (kPlane) {
    plane_rows<D>(geo, seg, rl, rp, ro, a);
  } else {
    seg_rows<D>(geo, seg, rl, rp, ro);
  }
  int ldt;
  const float* bias = stage_table(a.bias, h, n, tb, &ldt);
  __syncthreads();
  if constexpr (kPlane) {
    stage_plane_qkv<D>(qs, ks, vs, nullptr, a, h, ro, rows);
  } else {
    stage_plane<D>(qs, a.q + hb, ro, rows);
    stage_plane<D>(ks, a.k + hb, ro, rows);
    stage_plane<D>(vs, a.v + hb, ro, rows);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int nchunk = geo.ru / kChunk;
  const float s = a.scale[h * 2], uniform = (1.f - s) / n;
  for (int tile = warp; tile < geo.tiles(); tile += nw) {
    const int q0 = tile * 16, kb = q0 / geo.ru * geo.ru;
    uint32_t qa[D / 16][4];
    load_a_rows<D>(qa, qs, q0, lane);
    float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.f, 0.f}, unused[2];
    for (int c = 0; c < nchunk; ++c) {
      float sc[4][4];
      line_logits<D>(sc, qa, ks, q0, kb + c * kChunk, rl, rp, bias, ldt, lane);
      running_stats<false>(m, z, unused, sc, sc);
    }
    float o[D / 8][4] = {};
    for (int c = 0; c < nchunk; ++c) {
      float sc[4][4];
      const uint32_t keep = line_logits<D>(sc, qa, ks, q0, kb + c * kChunk, rl, rp, bias, ldt,
                                           lane);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(sc[nt][e] - m[e >> 1]) / z[e >> 1];
          sc[nt][e] = (keep >> (4 * nt + e)) & 1 ? s * p + uniform : 0.f;
        }
      }
      split_product<D>(o, sc, vs, kb + c * kChunk, lane);
    }
    if constexpr (kPlane) {
      store_plane<D>(a.pass == 0 ? a.half : a.out, a.pass == 0 ? nullptr : a.half, o, q0, ro, h,
                     a.C, 0.5f, lane);
    } else {
      store_rows<D>(a.out + hb, o, q0, ro, 1.f, lane);
    }
  }
}

// --------------------------------------------------------------- backward

// Per-warp table sums (lines of at most kWarpSlotMax tokens): a warp's
// slot holds the dS of its tile's query positions, n x n floats for n <= 16
// (a tile holds whole lines) and 16 x n for longer lines (a tile's 16
// positions of one line).
__host__ __device__ inline int slot_rows(int n) { return n <= 16 ? n : 16; }

template <int D>
size_t flash_bwd_smem(int n) {
  const Geo g(n, 1);
  size_t b = (size_t)4 * g.rows * D * sizeof(bf16) + (size_t)3 * g.rows * 4 +
             (size_t)3 * g.rows * 4 + kMaxWarps * 4;
  if (n <= kWarpSlotMax) b += (size_t)n * (n + 1) * 4 + (size_t)g.warps() * slot_rows(n) * n * 4;
  return b;
}

// Whether the backward stages a line of n tokens (its four tiles fit).
template <int D>
__host__ __device__ bool flash_bwd_fits(int n) {
  return n >= 1 && n <= kMaxRows && (size_t)8 * round_up(n, kChunk) * D <= kBwdStageBytes;
}

// A block owns the segments [grp * per, (grp + 1) * per) of one head
// (blockIdx.x = head + heads * grp) and takes them one after another; per
// segment, a warp a 16-row tile at a time:
//   1. query tiles: m, z and D_i = s sum_j P_ij G_ij over the unit's key
//      chunks (into shared memory), then S and G again (once for lines of
//      one chunk), dS into the table sums, dscale, dq = R(dS k / sqrt(d));
//   2. key tiles, two sweeps over the unit's query chunks (one accumulator
//      live at a time): S^T and G^T, dk = R(dS^T q / sqrt(d)); then S^T,
//      dv = R(P_eff^T dout).
// At the end the block writes its partials: the table sum (the warps' slots
// added in warp order, or already in its global slot) and dscale (a shuffle
// tree a warp, then the warps in order).  kPlane: dao = 0.5 dout, and the
// column pass adds its rounded dq, dk, dv to the row pass's.
template <int D, bool kPlane>
__global__ void __launch_bounds__(kMaxWarps * 32) flash_bwd_kernel(FlashArgsOf<kPlane> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geo geo(a.n, a.M);
  const int h = blockIdx.x % a.heads, grp = blockIdx.x / a.heads, rows = geo.rows, n = a.n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3, nchunk = geo.ru / kChunk;
  const bool wslots = n <= kWarpSlotMax;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + rows * D;
  bf16* vs = ks + rows * D;
  bf16* ds = vs + rows * D;  // dout
  int* rl = reinterpret_cast<int*>(ds + rows * D);
  int* rp = rl + rows;
  int* ro = rp + rows;
  float* st_m = reinterpret_cast<float*>(ro + rows);
  float* st_z = st_m + rows;
  float* st_d = st_z + rows;
  float* red = st_d + rows;       // (kMaxWarps)
  float* tb = red + kMaxWarps;    // (n, n + 1): the table
  float* wsl = tb + (wslots ? n * (n + 1) : 0);  // (warps, slot_rows, n)
  const int srows = slot_rows(n);
  float* mine = wsl + warp * srows * n;
  float* slot = a.part_bias + (size_t)(grp * a.heads + h) * n * n;  // longer lines
  const size_t hb = (size_t)h * a.M * n * D;
  int ldt;
  const float* bias = stage_table(a.bias, h, n, tb, &ldt);
  if (wslots) {
    for (int e = threadIdx.x; e < nw * srows * n; e += blockDim.x) wsl[e] = 0.f;
  }
  const float s = a.scale[h * 2], uniform = (1.f - s) / n, inv_n = 1.f / n;
  float dsc = 0.f;
  const int s0 = grp * a.per, s1 = min(s0 + a.per, geo.segments());
  for (int seg = s0; seg < s1; ++seg) {
    const bool first = seg == s0;
    __syncthreads();  // the last segment's reads of shared memory are done
    if constexpr (kPlane) {
      plane_rows<D>(geo, seg, rl, rp, ro, a);
    } else {
      seg_rows<D>(geo, seg, rl, rp, ro);
    }
    __syncthreads();
    if constexpr (kPlane) {
      stage_plane_qkv<D>(qs, ks, vs, ds, a, h, ro, rows);
    } else {
      stage_plane<D>(qs, a.q + hb, ro, rows);
      stage_plane<D>(ks, a.k + hb, ro, rows);
      stage_plane<D>(vs, a.v + hb, ro, rows);
      stage_plane<D>(ds, a.dout + hb, ro, rows);
    }
    __syncthreads();

    // 1. Query tiles.
    for (int tile = warp; tile < geo.tiles(); tile += nw) {
      const int q0 = tile * 16, kb = q0 / geo.ru * geo.ru;
      uint32_t qa[D / 16][4], da[D / 16][4];
      load_a_rows<D>(qa, qs, q0, lane);
      load_a_rows<D>(da, ds, q0, lane);
      float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.f, 0.f}, ag[2] = {0.f, 0.f};
      float sc[4][4], gm[4][4];
      uint32_t keep = 0;
      for (int c = 0; c < nchunk; ++c) {
        keep = line_logits<D>(sc, qa, ks, q0, kb + c * kChunk, rl, rp, bias, ldt, lane);
        rows_product<D>(gm, da, vs, kb + c * kChunk, lane);
        running_stats<true>(m, z, ag, sc, gm);
      }
      const float dr[2] = {s * ag[0] / z[0], s * ag[1] / z[1]};
      if (t == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          st_m[q0 + g + 8 * r] = m[r];
          st_z[q0 + g + 8 * r] = z[r];
          st_d[q0 + g + 8 * r] = dr[r];
        }
      }
      const int ql[2] = {rl[q0 + g], rl[q0 + g + 8]}, qp[2] = {rp[q0 + g], rp[q0 + g + 8]};
      float dq[D / 8][4] = {};
      for (int c = 0; c < nchunk; ++c) {
        const int k0 = kb + c * kChunk;
        if (nchunk > 1) {
          keep = line_logits<D>(sc, qa, ks, q0, k0, rl, rp, bias, ldt, lane);
          rows_product<D>(gm, da, vs, k0, lane);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            float dS = 0.f;
            if ((keep >> (4 * nt + e)) & 1) {
              const float p = expf(sc[nt][e] - m[r]) / z[r];
              dS = p * (s * gm[nt][e] - dr[r]);
              dsc += (p - inv_n) * gm[nt][e];
            }
            sc[nt][e] = dS;
          }
        }
        // dS into the table sums: a warp's slot (its tile's lines one after
        // another), or the block's slot in the partials; each cell is one
        // thread's, in a fixed order.
        const int rounds = geo.lp16 > 0 ? geo.lp16 : 1;
        for (int a16 = 0; a16 < rounds; ++a16) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, j = k0 + nt * 8 + 2 * t + (e & 1);
              if (!((keep >> (4 * nt + e)) & 1)) continue;
              if (geo.lp16 > 0 && ql[r] % geo.lp16 != a16) continue;
              if (wslots) {
                mine[(geo.lp16 > 0 ? qp[r] : qp[r] & 15) * n + rp[j]] += sc[nt][e];
              } else {
                float* cell = slot + (size_t)qp[r] * n + rp[j];
                *cell = first ? sc[nt][e] : *cell + sc[nt][e];
              }
            }
          }
          __syncwarp();
        }
        split_product<D>(dq, sc, ks, k0, lane);
      }
      if constexpr (kPlane) {
        store_plane<D>(a.dq, a.pass == 0 ? nullptr : a.dq, dq, q0, ro, h, a.C,
                       head_scaling<D>(), lane);
      } else {
        store_rows<D>(a.dq + hb, dq, q0, ro, head_scaling<D>(), lane);
      }
    }
    __syncthreads();

    // 2. Key tiles.
    for (int tile = warp; tile < geo.tiles(); tile += nw) {
      const int k0 = tile * 16, kb = k0 / geo.ru * geo.ru;
      const int kl[2] = {rl[k0 + g], rl[k0 + g + 8]}, kp[2] = {rp[k0 + g], rp[k0 + g + 8]};
#pragma unroll 1
      for (int which = 0; which < 2; ++which) {
        float acc[D / 8][4] = {};
        for (int c = 0; c < nchunk; ++c) {
          const int i0 = kb + c * kChunk;
          float sc[4][4], gm[4][4];
          {
            uint32_t ka[D / 16][4];
            load_a_rows<D>(ka, ks, k0, lane);
            rows_product<D>(sc, ka, qs, i0, lane);
          }
          if (which == 0) {
            uint32_t va[D / 16][4];
            load_a_rows<D>(va, vs, k0, lane);
            rows_product<D>(gm, va, ds, i0, lane);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, i = i0 + nt * 8 + 2 * t + (e & 1);
              float x = 0.f;
              if (kl[r] >= 0 && rl[i] == kl[r]) {
                const float l = sc[nt][e] * head_scaling<D>() + bias[rp[i] * ldt + kp[r]];
                const float p = expf(l - st_m[i]) / st_z[i];
                x = which == 0 ? p * (s * gm[nt][e] - st_d[i]) : s * p + uniform;
              }
              sc[nt][e] = x;  // dS^T, or P_eff^T
            }
          }
          split_product<D>(acc, sc, which == 0 ? qs : ds, i0, lane);
        }
        if constexpr (kPlane) {
          bf16* dst = which == 0 ? a.dk : a.dv;
          store_plane<D>(dst, a.pass == 0 ? nullptr : dst, acc, k0, ro, h, a.C,
                         which == 0 ? head_scaling<D>() : 1.f, lane);
        } else if (which == 0) {
          store_rows<D>(a.dk + hb, acc, k0, ro, head_scaling<D>(), lane);
        } else {
          store_rows<D>(a.dv + hb, acc, k0, ro, 1.f, lane);
        }
      }
    }
  }

  // The block's partials.
  __syncthreads();
  if (wslots) {
    const int tpu = geo.ru / 16;  // tiles a unit: warp w holds tile w's slot
    for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
      const int i = e / n, j = e % n;
      float v = 0.f;
      if (geo.lp16 > 0) {
        for (int w = 0; w < nw; ++w) v += wsl[(w * srows + i) * n + j];
      } else {
        for (int w = i / 16; w < nw; w += tpu) v += wsl[(w * srows + (i & 15)) * n + j];
      }
      slot[e] = v;
    }
  }
  dsc = warp_sum(dsc);
  if (lane == 0) red[warp] = dsc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.f;
    for (int w = 0; w < nw; ++w) v += red[w];
    a.part_scale[(size_t)h * a.groups + grp] = v;
  }
}

// ------------------------------------------------------------- launchers

template <int D>
int flash_fwd(const FlashArgs& a, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D, false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)flash_fwd_smem<D>(kMaxRows));
  if (e != cudaSuccess) return e;
  const Geo geo(a.n, a.M);
  flash_fwd_kernel<D, false><<<geo.segments() * a.heads, geo.warps() * 32,
                               flash_fwd_smem<D>(a.n), stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool kPlane>
cudaError_t flash_bwd_attr() {
  int most = 1;
  for (int n = 1; n <= kMaxRows; ++n) {
    if (flash_bwd_fits<D>(n)) most = n;
  }
  size_t top = 0;
  for (int n = 1; n <= most; ++n) top = flash_bwd_smem<D>(n) > top ? flash_bwd_smem<D>(n) : top;
  return cudaFuncSetAttribute(flash_bwd_kernel<D, kPlane>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)top);
}

// Blocks of the backward (K8's, or kPlane K7's) for lines of n tokens one
// SM holds at once.
template <int D, bool kPlane = false>
int flash_bwd_resident(int n, int* blocks) {
  if (!flash_bwd_fits<D>(n)) return cudaErrorInvalidValue;
  const cudaError_t e = flash_bwd_attr<D, kPlane>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, flash_bwd_kernel<D, kPlane>,
                                                       Geo(n, 1).warps() * 32,
                                                       flash_bwd_smem<D>(n));
}

// The backward (groups blocks of per segments a head; the partials carved
// from `part`: (groups, heads, n, n) table sums, then (heads, groups) scale
// sums), then the fixed-order sum of the partials into dbias (heads, n, n)
// and dscale (heads, 2), column 1 zero.
template <int D>
int flash_bwd(FlashArgs a, float* part, float* dbias, float* dscale, cudaStream_t stream) {
  const Geo geo(a.n, a.M);
  if (!flash_bwd_fits<D>(a.n) || !plan_ok(geo.segments(), a.groups, a.per))
    return cudaErrorInvalidValue;
  cudaError_t e = flash_bwd_attr<D, false>();
  if (e != cudaSuccess) return e;
  a.part_bias = part;
  a.part_scale = part + (size_t)a.groups * a.heads * a.n * a.n;
  flash_bwd_kernel<D, false><<<a.groups * a.heads, geo.warps() * 32, flash_bwd_smem<D>(a.n),
                               stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ParamSumArgs sum{};
  sum.part_bias[0] = a.part_bias;
  sum.part_scale[0] = a.part_scale;
  sum.bias_groups[0] = sum.scale_units[0] = a.groups;
  sum.L[0] = a.n;
  sum.dbias[0] = dbias;
  sum.dscale = dscale;
  sum.heads = a.heads;
  sum.D = D;
  return launch_param_sum(sum, stream);
}

// K7's pass p (0 rows, 1 columns) of BT frames: its lines, its table and
// its scale column (the kernels read column 0 of (heads, 2) from `scale`).
inline void plane_pass(PlaneArgs* a, int pass, int BT, const float* bias_x, const float* bias_y,
                       const float* scale) {
  a->pass = pass;
  a->n = pass == 0 ? a->W : a->H;
  a->M = BT * (pass == 0 ? a->H : a->W);
  a->bias = pass == 0 ? bias_x : bias_y;
  a->scale = scale + pass;
}

// K7's forward: the rows into a.half, then the columns into a.out.
template <int D>
int plane_fwd(PlaneArgs a, int BT, const float* bias_x, const float* bias_y, const float* scale,
              cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D, true>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)flash_fwd_smem<D>(kMaxRows));
  if (e != cudaSuccess) return e;
  for (int pass = 0; pass < 2; ++pass) {
    plane_pass(&a, pass, BT, bias_x, bias_y, scale);
    const Geo geo(a.n, a.M);
    flash_fwd_kernel<D, true><<<geo.segments() * a.heads, geo.warps() * 32,
                                flash_fwd_smem<D>(a.n), stream>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// K7's backward: the rows, then the columns (pass p's blocks groups[p] of
// per[p] segments a head, its partials carved from `part` in turn: the
// (groups, heads, n, n) table sums, then the (heads, groups) scale sums),
// then the fixed-order sum of both passes' partials into dbias_x, dbias_y
// and dscale (heads, 2).
template <int D>
int plane_bwd(PlaneArgs a, int BT, const float* bias_x, const float* bias_y, const float* scale,
              const int (&groups)[2], const int (&per)[2], float* part, float* dbias_x,
              float* dbias_y, float* dscale, cudaStream_t stream) {
  cudaError_t e = flash_bwd_attr<D, true>();
  if (e != cudaSuccess) return e;
  ParamSumArgs sum{};
  for (int pass = 0; pass < 2; ++pass) {
    plane_pass(&a, pass, BT, bias_x, bias_y, scale);
    const Geo geo(a.n, a.M);
    if (!flash_bwd_fits<D>(a.n) || !plan_ok(geo.segments(), groups[pass], per[pass]))
      return cudaErrorInvalidValue;
    a.groups = groups[pass];
    a.per = per[pass];
    a.part_bias = part;
    a.part_scale = part + (size_t)a.groups * a.heads * a.n * a.n;
    part = a.part_scale + (size_t)a.heads * a.groups;
    flash_bwd_kernel<D, true><<<a.groups * a.heads, geo.warps() * 32, flash_bwd_smem<D>(a.n),
                                stream>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    sum.part_bias[pass] = a.part_bias;
    sum.part_scale[pass] = a.part_scale;
    sum.bias_groups[pass] = sum.scale_units[pass] = a.groups;
    sum.L[pass] = a.n;
  }
  sum.dbias[0] = dbias_x;
  sum.dbias[1] = dbias_y;
  sum.dscale = dscale;
  sum.heads = a.heads;
  sum.D = D;
  return launch_param_sum(sum, stream);
}

}  // namespace
}  // namespace flash
}  // namespace bft
