// K2 in bfloat16, redesigned for Hopper (sm_90a): the axial row + column
// attention core of the lane route, forward and backward, on tensor cores.
//
// Replaces bubbleformer_tpu/ops/axial_lane.py:_make_lane_axial (pl.pallas_call
// :676 forward, :690 backward; bodies _fwd_kernel :236 with _axis_fwd :198,
// _bwd_kernel :370 with _axis_bwd :254 and _qkln_bwd :320), entry
// lane_axial_attention_from_x :852, for bf16 activations.  K2's float32 path
// and the line-kernel flavours of K4, K6, K7 and K8 stay on line_kernels.cuh.
// Two more bf16 kernels run these kernels in their own rounding (Mode):
//   kLanePx  K9's backward (axial_lane.py:_bwd_kernel_px :426): each pass
//            writes its own rounded dqkv (the TPU kernel's bm=True,
//            :462-470), which the caller projects back before the next pass
//            (axial_lane_px.cu); its forward is K2's;
//   kMega    K5's attention (axial_block_mega.py:_attn_chunks_fwd :108):
//            P itself rounded as the operand of P v, o = s pv + (1 - s)
//            mean(v) and the directions' sum 0.5 o_r + 0.5 o_c in float32
//            (the float32 ao, and ao rounded: K5's residual); its backward
//            is K4's (axial_fused_block.py:116-135): dv = R(P)^T R(s dao) +
//            (1 - s)/L sum_i dao_i, the row pass's d(q, k, v) before the
//            qk-LN kept in a float32 scratch, the column pass adding its own,
//            running the qk-LN backward once and rounding dqkv once.
//
// What it computes, per head and direction (rows: L = W, table bias_x, scale
// s_x; columns: L = H, bias_y, s_y), R rounding to bf16:
//   q = R(LN_q(q_raw)), k = R(LN_k(k_raw))        (fast-variance qk-LN)
//   P = softmax(q k^T / sqrt(d) + bias), exactly normalised (e / z)
//   o = R(s P + (1 - s)/L) v,  out = R(0.5 (R(o_rows) + R(o_cols)))
// and backward, with dao = R(0.5 dout), G = dao v^T:
//   dscale += sum (P - 1/L) G,  D_i = s sum_j P_ij G_ij,  dS = P (s G - D)
//   dbias += dS,  dq = R(dS) k / sqrt(d),  dk = R(dS)^T q / sqrt(d),
//   dv = R(s P + (1 - s)/L)^T dao, then the qk-LN backward; each direction's
//   dqkv rounded, the column pass adding its own into the row pass's and
//   rounding once more.
// Every rounding of the TPU kernel is a bf16 operand of one of these
// products (q, k, v, dao, R(P_eff), R(dS)), so the products run on bf16
// tensor cores (mma.sync.m16n8k16, float32 accumulation) and round exactly
// where the TPU kernel rounds; only the order of float32 sums changes.
//
// What bounds it on an H100: bytes.  Per direction the forward reads qkv
// once and writes its output (the column pass also reads the row pass's bf16
// output); the backward reads qkv and dout and writes dqkv (the column pass
// also reads the row pass's).  At FiLMAViT-small's training shape (qkv (40,
// 32, 32, 1152)) that is 283 MB forward and 534 MB backward, 0.085 and 0.16
// ms at 3.35 TB/s, against ~1.3 and ~3.2 GFLOP (0.003 ms on the tensor
// cores).  The design moves only those bytes:
//   - a block stages one line of one head (blocks of one line run the heads
//     side by side, so a token's 3C values are read together) into shared
//     memory in bf16, by 16-byte loads, the qk-LN done in registers in
//     float32 and rounded on the way, where K2 rounds;
//   - S = q k^T, G = dao v^T, O = P_eff v, dQ = R(dS) k, dK = R(dS)^T q and
//     dV = P_eff^T dao on the tensor cores; P stays in registers between
//     its two products (the accumulator fragment of S is the A fragment of
//     P V, FlashAttention-2's layout trick);
//   - P is normalised exactly before it is rounded: the key chunks of 32 are
//     passed twice (row max and sum, then P), no online rescale of O;
//   - one backward launch per direction whatever the line's length, no
//     global stats scratch: lines of up to 128 tokens keep R(dS) and R(P_eff)
//     (L x L each, bf16) in shared memory after the query tiles' pass, so
//     the key tiles' dK and dV are two products from there; longer lines
//     (up to 512) keep only the per-query statistics and compute S and G
//     again over the key tiles;
//   - the row pass's output goes to a bf16 scratch (the TPU kernel rounds it
//     there), half the bytes of a float32 one;
//   - the parameter gradients never touch a global atomic: a backward block
//     owns a fixed run of lines of one head (the host's plan, ops/axial_
//     lane.py:lane_bwd_plan) and sums dS over them in shared memory (lines
//     of at most 64 tokens) or in its own slot of the partial buffer, with
//     the scale and qk-LN gradients, into one partial per block; a last
//     launch adds the partials in a fixed order, so the table, scale and LN
//     gradients repeat bit for bit.
// Lines of 1 to 512 tokens, head dims 16 and 64; ragged lines are padded to
// the 32-token chunk (keys masked with -inf, rows beyond L dropped).
#pragma once

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "param_sums.cuh"

namespace bft {
namespace lane {
namespace {

using bf16 = __nv_bfloat16;

// The rounding a kernel follows (file comment).
enum class Mode { kLane, kLanePx, kMega };

constexpr int kMaxWarps = 8;
constexpr int kChunk = 32;        // keys (query passes) or queries (key pass) a chunk
constexpr int kSmemBiasMax = 64;  // lines up to this length sum dS in shared memory

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }
// Warps of a block: one per 16-token tile of the line, at most 8.
__host__ __device__ inline int line_warps(int L) {
  const int t = (L + 15) / 16;
  return t < kMaxWarps ? t : kMaxWarps;
}
// Rows of q, k and v staged for a line (the 32-token chunk's multiple).
__host__ __device__ inline int staged_rows(int L) { return round_up(L, kChunk); }
// Longest line whose probabilities a backward block keeps in shared memory;
// longer lines hold dao kLongDaoRows rows at a time.
constexpr int kShortMax = 128;
constexpr int kLongDaoRows = 128;

// Element offset of (row, col) in a (rows, D) bf16 tile in shared memory
// whose 16-byte chunks are XOR-swizzled by the row: eight rows read at one
// column (ldmatrix) hit eight different bank groups.
template <int D>
__device__ __forceinline__ int sw(int row, int col) {
  static_assert(D == 16 || D == 64, "head dim 16 or 64");
  constexpr int kC = D / 8;
  const int s = kC == 8 ? (row & 7) : ((row >> 2) & 1);
  return row * D + (((col >> 3) ^ s) << 3) + (col & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c += a b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col), c f32.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even) in one register, lo first.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// A fragment (16 rows from r0, columns k0 .. k0 + 15) of a swizzled tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int r0, int k0,
                                       int lane) {
  ldsm4(a, tile + sw<D>(r0 + (lane & 15), k0 + ((lane >> 4) << 3)));
}

// B fragments of every 16-deep step over D of the n-tile of rows n0 .. n0 + 7
// of a (tokens, D) tile: the tile read as B = tile^T (k = D, n = token).
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[D / 16][2], const bf16* tile, int n0,
                                            int lane) {
  if constexpr (D == 16) {
    ldsm2(b[0], tile + sw<D>(n0 + (lane & 7), ((lane >> 3) & 1) << 3));
  } else {
#pragma unroll
    for (int k = 0; k < D / 32; ++k) {
      uint32_t r[4];
      ldsm4(r, tile + sw<D>(n0 + (lane & 7), k * 32 + ((lane >> 3) << 3)));
      b[2 * k][0] = r[0];
      b[2 * k][1] = r[1];
      b[2 * k + 1][0] = r[2];
      b[2 * k + 1][1] = r[3];
    }
  }
}

// B fragments of the n-tiles n0 and n0 + 8 of the 16-deep step of rows r0 ..
// r0 + 15 of a (tokens, D) tile: the tile read as B = tile (k = token, n = D).
// r[0], r[1] serve n-tile n0; r[2], r[3] n-tile n0 + 8.
template <int D>
__device__ __forceinline__ void load_b_cols(uint32_t (&r)[4], const bf16* tile, int r0, int n0,
                                            int lane) {
  ldsm4t(r, tile + sw<D>(r0 + (lane & 15), n0 + ((lane >> 4) << 3)));
}

// The A fragment of the 16-deep step m (columns 16m .. 16m + 15) of a 16 x 32
// block held in the accumulator layout (four n-tiles of 8), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&x)[4][4], int m) {
  a[0] = pack(x[2 * m][0], x[2 * m][1]);
  a[1] = pack(x[2 * m][2], x[2 * m][3]);
  a[2] = pack(x[2 * m + 1][0], x[2 * m + 1][1]);
  a[3] = pack(x[2 * m + 1][2], x[2 * m + 1][3]);
}

// The A fragments of 16 rows from r0 over all of D.
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[D / 16][4], const bf16* tile, int r0,
                                            int lane) {
#pragma unroll
  for (int k = 0; k < D / 16; ++k) load_a<D>(a[k], tile, r0, k * 16, lane);
}

// out (16 x 32) = A rows (16 x D) times the rows n0 .. n0 + 31 of `tile`,
// transposed: a chunk of logits (q k^T) or of G (dao v^T).
template <int D>
__device__ __forceinline__ void rows_product(float (&out)[4][4], const uint32_t (&a)[D / 16][4],
                                             const bf16* tile, int n0, int lane) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    uint32_t b[D / 16][2];
    load_b_rows<D>(b, tile, n0 + nt * 8, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[nt][e] = 0.f;
#pragma unroll
    for (int k = 0; k < D / 16; ++k) mma(out[nt], a[k], b[k][0], b[k][1]);
  }
}

// Each of a register's two bf16 values times s, rounded again.
__device__ __forceinline__ uint32_t scale_pair(uint32_t w, float s) {
  const float2 f = unpack(w);
  return pack(s * f.x, s * f.y);
}

// acc (16 x D) += R(x) (16 x 32, accumulator layout) times the rows r0 ..
// r0 + 31 of `tile` (k = token, n = D): P V, dS K, dS^T Q, P^T dao; with
// kScaleB, times R(bs tile) (kMega's R(P)^T R(s dao)).
template <int D, bool kScaleB = false>
__device__ __forceinline__ void chunk_product(float (&acc)[D / 8][4], const float (&x)[4][4],
                                              const bf16* tile, int r0, int lane,
                                              float bs = 1.f) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    uint32_t a[4];
    acc_to_a(a, x, m);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      load_b_cols<D>(b, tile, r0 + 16 * m, np * 16, lane);
      if constexpr (kScaleB) {
#pragma unroll
        for (int e = 0; e < 4; ++e) b[e] = scale_pair(b[e], bs);
      }
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Where a line's positions lie: pass 0 (rows) position i of row `line` of
// frame bt, pass 1 (columns) position i of column `line`.
struct Line {
  size_t base, step;
  int L;
  __device__ size_t token(int i) const { return base + (size_t)i * step; }
};

__device__ __forceinline__ Line make_line(int pass, int H, int W, int li) {
  Line l;
  if (pass == 0) {
    l.base = (size_t)li * W;  // li = bt * H + row
    l.step = 1;
    l.L = W;
  } else {
    const int bt = li / W, col = li % W;
    l.base = (size_t)bt * H * W + col;
    l.step = W;
    l.L = H;
  }
  return l;
}

__device__ __forceinline__ uint4 ldg16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

constexpr int kStageBatch = 8;  // 16-byte loads a thread keeps in flight while staging

__device__ __forceinline__ void unpack8(const uint4& raw, float (&x)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = unpack(w[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  return make_uint4(pack(x[0], x[1]), pack(x[2], x[3]), pack(x[4], x[5]), pack(x[6], x[7]));
}

// q (LN'd, rounded), k (LN'd, rounded) and v of the `rows` positions of a
// line for head h into swizzled tiles; positions at or beyond L are zero.
// Each thread keeps one 16-byte vector of a token's 3D values (so one set
// of LN weights) and loads kStageBatch tokens' before it uses any; the LN
// statistics are sums over the D/8 lanes of a component.
template <int D>
__device__ void stage_qkv(bf16* qs, bf16* ks, bf16* vs, const bf16* __restrict__ qkv,
                          const Line& line, int h, int C3, const float* __restrict__ ln,
                          int rows) {
  constexpr int kVpc = D / 8, kVpt = 3 * kVpc;
  const int tpi = blockDim.x / kVpt;  // tokens an iteration
  const int tin = threadIdx.x / kVpt, vec = threadIdx.x % kVpt;
  const int comp = vec / kVpc, col = (vec % kVpc) * 8;
  const bool on = tin < tpi;
  float g[8], b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    g[e] = comp < 2 ? ln[comp * 2 * D + col + e] : 1.f;
    b[e] = comp < 2 ? ln[(comp * 2 + 1) * D + col + e] : 0.f;
  }
  bf16* dst = comp == 0 ? qs : comp == 1 ? ks : vs;
  const bf16* src = qkv + (size_t)h * 3 * D + vec * 8;
  for (int t0 = 0; t0 < rows; t0 += tpi * kStageBatch) {
    uint4 raw[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int tok = t0 + u * tpi + tin;
      raw[u] = make_uint4(0, 0, 0, 0);
      if (on && tok < line.L) raw[u] = ldg16(src + line.token(tok) * C3);
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int tok = t0 + u * tpi + tin;
      float x[8];
      unpack8(raw[u], x);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s1 += x[e];
        s2 += x[e] * x[e];
      }
#pragma unroll
      for (int o = 1; o < kVpc; o <<= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      const float mu = s1 * (1.f / D);
      const float inv = 1.f / sqrtf(fmaxf(s2 * (1.f / D) - mu * mu, 0.f) + kNormEps);
      if (comp < 2) {
        const bool valid = tok < line.L;
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = valid ? (x[e] - mu) * inv * g[e] + b[e] : 0.f;
      }
      if (on && tok < rows) *reinterpret_cast<uint4*>(dst + sw<D>(tok, col)) = pack8(x);
    }
  }
}

// dao = R(0.5 dout) of the positions r0 .. r0 + n of a line for head h into
// a swizzled tile; positions at or beyond L are zero.  kStageBatch loads in
// flight a thread, as stage_qkv.
template <int D>
__device__ void stage_dao(bf16* ds, const bf16* __restrict__ dout, const Line& line, int h,
                          int C, int r0, int n) {
  constexpr int kVpr = D / 8;
  const int rpi = blockDim.x / kVpr, rin = threadIdx.x / kVpr, col = (threadIdx.x % kVpr) * 8;
  const bf16* src = dout + (size_t)h * D + col;
  for (int t0 = 0; t0 < n; t0 += rpi * kStageBatch) {
    uint4 raw[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int r = t0 + u * rpi + rin;
      raw[u] = make_uint4(0, 0, 0, 0);
      if (r < n && r0 + r < line.L) raw[u] = ldg16(src + line.token(r0 + r) * C);
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int r = t0 + u * rpi + rin;
      if (r >= n) continue;
      float x[8];
      unpack8(raw[u], x);
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] *= 0.5f;
      *reinterpret_cast<uint4*>(ds + sw<D>(r, col)) = pack8(x);
    }
  }
}

// A 16 x 32 chunk of logits, q k^T / sqrt(d) + bias, of the query tile from
// q0 and the keys from k0 (the table's rows `ldt` apart, in global or shared
// memory): -inf for keys at or beyond L; rows at or beyond L read no table
// (they are dropped).
template <int D>
__device__ __forceinline__ void logits(float (&sc)[4][4], const uint32_t (&qa)[D / 16][4],
                                       const bf16* ks, int q0, int k0, const float* bias,
                                       int ldt, int L, int lane) {
  rows_product<D>(sc, qa, ks, k0, lane);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = q0 + g + ((e >> 1) << 3), j = k0 + nt * 8 + 2 * t + (e & 1);
      const float b = i < L && j < L ? bias[(size_t)i * ldt + j] : 0.f;
      sc[nt][e] = j < L ? sc[nt][e] * head_scaling<D>() + b : -INFINITY;
    }
  }
}

// Row max m and sum z of exp(s - m) (rows g and g + 8 of the tile) after one
// more chunk of logits; with G, also the sum of exp(s - m) G, rescaled alike.
template <bool kWithG>
__device__ __forceinline__ void running_stats(float (&m)[2], float (&z)[2], float (&a)[2],
                                              const float (&sc)[4][4], const float (&gm)[4][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mx = fmaxf(mx, fmaxf(sc[nt][2 * r], sc[nt][2 * r + 1]));
    const float mn = fmaxf(m[r], quad_max(mx));
    float zt = 0.f, at = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = expf(sc[nt][2 * r + e] - mn);
        zt += x;
        if (kWithG) at += x * gm[nt][2 * r + e];
      }
    }
    const float corr = expf(m[r] - mn);
    z[r] = z[r] * corr + quad_sum(zt);
    if (kWithG) a[r] = a[r] * corr + quad_sum(at);
    m[r] = mn;
  }
}

// ---------------------------------------------------------------- forward

struct FwdArgs {
  const bf16* qkv;     // (BT, H, W, 3C), heads-major [q|k|v]
  const float* ln;     // (4, D): q scale, q bias, k scale, k bias
  const float* bias_x; // (heads, W, W)
  const float* bias_y; // (heads, H, H)
  const float* scale;  // (heads, 2): s_x, s_y
  bf16* row_out;       // (BT, H, W, C): the row pass's rounded output (K2)
  bf16* out;           // (BT, H, W, C); kMega: ao rounded
  float* ao;           // kMega: (BT, H, W, C) float32, 0.5 o_r + 0.5 o_c
  int H, W, C, heads;
};

template <int D, Mode M>
size_t fwd_smem_bytes(int L) {
  return (size_t)3 * staged_rows(L) * D * sizeof(bf16) + (M == Mode::kMega ? D * 4 : 0);
}

// kMega: sum_j v_j over the line's L staged tokens into vsum (D floats), a
// thread a column (a block of one warp, lines of up to 16 tokens, takes two
// at D = 64).
template <int D>
__device__ __forceinline__ void line_column_sum(float* vsum, const bf16* vs, int L) {
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float a = 0.f;
    for (int r = 0; r < L; ++r) a += __bfloat162float(vs[sw<D>(r, c)]);
    vsum[c] = a;
  }
}

// One line of one head a block (blockIdx.x = head + heads * line), a warp a
// 16-query tile: the exact P over the key chunks (max and sum, then P), its
// blend R(s P + (1 - s)/L) times v, rounded; pass 0 writes it to row_out,
// pass 1 the mean of both directions to out.  kMega: R(P) times v, blended
// with the window mean in float32; pass 0 writes half of it to ao, pass 1
// adds its half and writes ao and ao rounded (out).
template <int D, Mode M>
__global__ void __launch_bounds__(kMaxWarps * 32) lane_fwd_kernel(FwdArgs a, int pass) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x % a.heads;
  const Line line = make_line(pass, a.H, a.W, blockIdx.x / a.heads);
  const int L = line.L, rows = staged_rows(L), nchunk = rows / kChunk;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + rows * D;
  bf16* vs = ks + rows * D;
  float* vsum = reinterpret_cast<float*>(vs + rows * D);  // kMega: (D)
  stage_qkv<D>(qs, ks, vs, a.qkv, line, h, 3 * a.C, a.ln, rows);
  __syncthreads();
  if constexpr (M == Mode::kMega) {
    line_column_sum<D>(vsum, vs, L);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float s = a.scale[h * 2 + pass], uniform = (1.f - s) * (1.f / L);
  const float* bias = (pass == 0 ? a.bias_x : a.bias_y) + (size_t)h * L * L;
  const int ldt = L;
  for (int q0 = warp * 16; q0 < L; q0 += nw * 16) {
    uint32_t qa[D / 16][4];
    load_a_rows<D>(qa, qs, q0, lane);
    float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.f, 0.f}, unused[2];
    for (int c = 0; c < nchunk; ++c) {
      float sc[4][4];
      logits<D>(sc, qa, ks, q0, c * kChunk, bias, ldt, L, lane);
      running_stats<false>(m, z, unused, sc, sc);
    }
    float o[D / 8][4] = {};
    for (int c = 0; c < nchunk; ++c) {
      float sc[4][4];
      logits<D>(sc, qa, ks, q0, c * kChunk, bias, ldt, L, lane);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, j = c * kChunk + nt * 8 + 2 * t + (e & 1);
          const float p = expf(sc[nt][e] - m[r]) / z[r];
          sc[nt][e] = j >= L ? 0.f : M == Mode::kMega ? p : s * p + uniform;
        }
      }
      chunk_product<D>(o, sc, vs, c * kChunk, lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + g + 8 * r;
      if (i >= L) continue;
      const size_t at = line.token(i) * a.C + (size_t)h * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        if constexpr (M == Mode::kMega) {
          const int col = n * 8 + 2 * t;
          const float o0 = s * o[n][2 * r] + (1.f - s) * (vsum[col] / L);
          const float o1 = s * o[n][2 * r + 1] + (1.f - s) * (vsum[col + 1] / L);
          float2* f = reinterpret_cast<float2*>(a.ao + at + n * 8);
          if (pass == 0) {
            *f = make_float2(0.5f * o0, 0.5f * o1);
          } else {
            const float2 rw = *f;
            const float2 v = make_float2(rw.x + 0.5f * o0, rw.y + 0.5f * o1);
            *f = v;
            *reinterpret_cast<uint32_t*>(a.out + at + n * 8) = pack(v.x, v.y);
          }
          continue;
        }
        const uint32_t o_r = pack(o[n][2 * r], o[n][2 * r + 1]);
        if (pass == 0) {
          *reinterpret_cast<uint32_t*>(a.row_out + at + n * 8) = o_r;
        } else {
          const float2 x = unpack(*reinterpret_cast<const uint32_t*>(a.row_out + at + n * 8));
          const float2 y = unpack(o_r);
          *reinterpret_cast<uint32_t*>(a.out + at + n * 8) =
              pack(0.5f * (x.x + y.x), 0.5f * (x.y + y.y));
        }
      }
    }
  }
}

// --------------------------------------------------------------- backward

struct BwdArgs {
  const bf16* qkv;
  const bf16* dout;    // (BT, H, W, C)
  const float* ln;
  const float* bias_x;
  const float* bias_y;
  const float* scale;
  bf16* dqkv;          // (BT, H, W, 3C)
  float* dacc;         // kMega: (BT, H, W, 3C) float32, the row pass's d(q, k, v)
  float* part_bias;    // (groups, heads, L, L): dS summed over each block's lines
  float* part_scale;   // (heads, groups)
  float* part_ln;      // (4, D, groups, heads): (dy xhat, dy) of q, then k
  int H, W, C, heads;
  int lines, per;      // lines of the pass (BT x H or BT x W); lines a block
};

template <int D, Mode M>
size_t bwd_long_smem_bytes(int L) {
  const int rows = staged_rows(L), nw = line_warps(L);
  return (size_t)(3 * rows + kLongDaoRows) * D * sizeof(bf16) + (size_t)3 * rows * 4 +
         (size_t)nw * 4 * D * 4 + kMaxWarps * 4 + (M == Mode::kMega ? D * 4 : 0);
}

// A 16-row tile's gradient w.r.t. the LN'd q (comp 0) or k (comp 1), `y_in`
// in the accumulator layout: the qk-LN backward of the raw rows, rounded into
// dqkv (K2: pass 0 writes it, pass 1 adds its rounded gradient to the row
// pass's and rounds again; kLanePx: each pass writes its own), and (y xhat,
// y) summed over the tile into the warp's LN slots.  kMega: pass 0 keeps
// y_in in dacc (float32) and does nothing else; pass 1 adds it to its own
// and runs the rest on the sum, writing dqkv.  A row's D values lie on one
// quad: its sums are quad sums.
template <int D, Mode M>
__device__ __forceinline__ void emit_ln_grad(const float (&y_in)[D / 8][4], int r0, int comp,
                                             const Line& line, int h, int C3,
                                             const bf16* __restrict__ qkv,
                                             const float* __restrict__ ln,
                                             bf16* __restrict__ dqkv, float* __restrict__ dacc,
                                             float* wslot, int pass, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float y[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) y[n][e] = y_in[n][e];
  }
  if constexpr (M == Mode::kMega) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + g + 8 * r;
      if (i >= line.L) continue;
      float* f = dacc + line.token(i) * C3 + (size_t)h * 3 * D + comp * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        float2* v = reinterpret_cast<float2*>(f + n * 8);
        if (pass == 0) {
          *v = make_float2(y[n][2 * r], y[n][2 * r + 1]);
        } else {
          const float2 kept = *v;
          y[n][2 * r] += kept.x;
          y[n][2 * r + 1] += kept.y;
        }
      }
    }
    if (pass == 0) return;
  }
  const float* gam = ln + comp * 2 * D;
  float dg[D / 8][2], db[D / 8][2];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dg[n][0] = dg[n][1] = db[n][0] = db[n][1] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + g + 8 * r;
    const bool valid = i < line.L;
    const size_t off = valid ? line.token(i) * C3 + (size_t)h * 3 * D + comp * D + 2 * t : 0;
    float x[D / 8][2], gg[D / 8][2];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float2 f = valid ? unpack(*reinterpret_cast<const uint32_t*>(qkv + off + n * 8))
                             : make_float2(0.f, 0.f);
      x[n][0] = f.x;
      x[n][1] = f.y;
      s1 += f.x + f.y;
      s2 += f.x * f.x + f.y * f.y;
    }
    const float mu = quad_sum(s1) * (1.f / D);
    const float inv = 1.f / sqrtf(fmaxf(quad_sum(s2) * (1.f / D) - mu * mu, 0.f) + kNormEps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[n][e] = (x[n][e] - mu) * inv;
        gg[n][e] = y[n][2 * r + e] * gam[n * 8 + 2 * t + e];
        m1 += gg[n][e];
        m2 += gg[n][e] * x[n][e];
      }
    }
    m1 = quad_sum(m1) * (1.f / D);
    m2 = quad_sum(m2) * (1.f / D);
    if (!valid) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t* o = reinterpret_cast<uint32_t*>(dqkv + off + n * 8);
      const uint32_t v = pack(inv * (gg[n][0] - m1 - x[n][0] * m2),
                              inv * (gg[n][1] - m1 - x[n][1] * m2));
      if (pass == 0 || M != Mode::kLane) {
        *o = v;
      } else {
        const float2 old = unpack(*o), add = unpack(v);
        *o = pack(old.x + add.x, old.y + add.y);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dg[n][e] += y[n][2 * r + e] * x[n][e];
        db[n][e] += y[n][2 * r + e];
      }
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        dg[n][e] += __shfl_xor_sync(0xffffffffu, dg[n][e], o);
        db[n][e] += __shfl_xor_sync(0xffffffffu, db[n][e], o);
      }
      if (g == 0) {
        wslot[comp * 2 * D + n * 8 + 2 * t + e] += dg[n][e];
        wslot[(comp * 2 + 1) * D + n * 8 + 2 * t + e] += db[n][e];
      }
    }
  }
}

// A 16-row tile's v gradient into dqkv, rounded as emit_ln_grad rounds
// (kMega: pass 0 keeps it in dacc, pass 1 rounds the sum).
template <int D, Mode M>
__device__ __forceinline__ void emit_v_grad(const float (&y)[D / 8][4], int r0, const Line& line,
                                            int h, int C3, bf16* __restrict__ dqkv,
                                            float* __restrict__ dacc, int pass, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + g + 8 * r;
    if (i >= line.L) continue;
    const size_t off = line.token(i) * C3 + (size_t)h * 3 * D + 2 * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t* o = reinterpret_cast<uint32_t*>(dqkv + off + n * 8);
      if constexpr (M == Mode::kMega) {
        float2* f = reinterpret_cast<float2*>(dacc + off + n * 8);
        if (pass == 0) {
          *f = make_float2(y[n][2 * r], y[n][2 * r + 1]);
        } else {
          const float2 kept = *f;
          *o = pack(y[n][2 * r] + kept.x, y[n][2 * r + 1] + kept.y);
        }
        continue;
      }
      const uint32_t v = pack(y[n][2 * r], y[n][2 * r + 1]);
      if (pass == 0 || M == Mode::kLanePx) {
        *o = v;
      } else {
        const float2 old = unpack(*o), add = unpack(v);
        *o = pack(old.x + add.x, old.y + add.y);
      }
    }
  }
}

// The end of a backward block: its partials, each summed in a fixed order —
// the table sum (from shared memory when `accb` is given; else it is in the
// slot already), the scale sum (the threads' `dsc`) and the LN sums (the
// warps' slots).
template <int D>
__device__ void write_partials(const BwdArgs& a, int grp, int h, int L, const float* accb,
                               int ldb, float* slot, float dsc, const float* wln, float* red) {
  const int groups = (a.lines + a.per - 1) / a.per;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();
  if (accb != nullptr) {
    for (int e = threadIdx.x; e < L * L; e += blockDim.x) slot[e] = accb[(e / L) * ldb + e % L];
  }
  dsc = warp_sum(dsc);
  if (lane == 0) red[warp] = dsc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.f;
    for (int w = 0; w < nw; ++w) v += red[w];
    a.part_scale[(size_t)h * groups + grp] = v;
  }
  for (int e = threadIdx.x; e < 4 * D; e += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < nw; ++w) v += wln[w * 4 * D + e];
    a.part_ln[(size_t)e * groups * a.heads + grp * a.heads + h] = v;
  }
}

// kMega's dv: y (16 x D, accumulator layout) += u * dsum[column].
template <int D>
__device__ __forceinline__ void add_mean_grad(float (&y)[D / 8][4], const float* dsum, float u,
                                              int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) y[n][e] += u * dsum[n * 8 + 2 * t + (e & 1)];
  }
}

// Lines of more than kShortMax tokens (their probabilities do not fit in
// shared memory): a block owns the lines [grp * per, (grp + 1) * per) of one
// head (blockIdx.x = head + heads * grp) and takes them one after another, a
// warp a 16-token tile, in three passes over each line:
//   1. query tiles: m, z and D_i = s sum_j P_ij G_ij over the key chunks
//      (into shared memory);
//   2. key tiles: S^T and G^T over the query chunks, dK += R(dS)^T q, then
//      S^T again for dV += R(P_eff)^T dao; the k part of dqkv through the
//      qk-LN backward, the v part;
//   3. query tiles: S and G again, dS into the block's table sum, dscale,
//      dQ += R(dS) k; the q part through the qk-LN backward.
// dao is staged kLongDaoRows rows at a time; dS is summed in the block's own
// slot of the partials.  At the end the block writes its other partials:
// the scale sum and the LN sums, each added in a fixed order.  kMega also
// sums dao over the line in pass 1 (each window is staged once there, in
// order) for dv's (1 - s)/L sum_i dao_i.
template <int D, Mode M, int kMinBlocks>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks) lane_bwd_long_kernel(BwdArgs a,
                                                                                 int pass) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x % a.heads, grp = blockIdx.x / a.heads;
  const int L = pass == 0 ? a.W : a.H, rows = staged_rows(L), drows = kLongDaoRows;
  const int nchunk = rows / kChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3, span = nw * 16, C3 = 3 * a.C;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + rows * D;
  bf16* vs = ks + rows * D;
  bf16* ds = vs + rows * D;
  float* st_m = reinterpret_cast<float*>(ds + drows * D);
  float* st_z = st_m + rows;
  float* st_d = st_z + rows;
  float* wln = st_d + rows;          // (nw, 4, D)
  float* red = wln + nw * 4 * D;     // (kMaxWarps)
  float* dsum = red + kMaxWarps;     // kMega: (D) sum_i dao_i of the line
  float* slot = a.part_bias + (size_t)(grp * a.heads + h) * L * L;  // dS summed over the lines
  float* wslot = wln + warp * 4 * D;
  const float s = a.scale[h * 2 + pass], uniform = (1.f - s) * (1.f / L), inv_l = 1.f / L;
  const float* bias = (pass == 0 ? a.bias_x : a.bias_y) + (size_t)h * L * L;
  const int ldt = L;
  for (int e = threadIdx.x; e < nw * 4 * D; e += blockDim.x) wln[e] = 0.f;
  float dsc = 0.f;
  const int l0 = grp * a.per, l1 = min(l0 + a.per, a.lines);
  for (int li = l0; li < l1; ++li) {
    const Line line = make_line(pass, a.H, a.W, li);
    const bool first = li == l0;
    __syncthreads();  // the last line's reads of shared memory are done
    if (M == Mode::kMega && threadIdx.x < D) dsum[threadIdx.x] = 0.f;
    stage_qkv<D>(qs, ks, vs, a.qkv, line, h, C3, a.ln, rows);
    int dao0 = -1;
    // Every thread calls it with the same row: dao rows [r0, r0 + drows)
    // held, r0 the multiple of drows at or below `row`.
    auto ensure_dao = [&](int row) {
      const int r0 = row / drows * drows;
      if (r0 == dao0) return;
      __syncthreads();
      stage_dao<D>(ds, a.dout, line, h, a.C, r0, drows);
      __syncthreads();
      dao0 = r0;
    };

    // 1. m, z and D_i per query.
    for (int q00 = 0; q00 < L; q00 += span) {
      ensure_dao(q00);
      if (M == Mode::kMega && threadIdx.x < D) {
        float acc = 0.f;
        for (int r = 0; r < min(drows, L - q00); ++r)
          acc += __bfloat162float(ds[sw<D>(r, threadIdx.x)]);
        dsum[threadIdx.x] += acc;
      }
      const int q0 = q00 + warp * 16;
      if (q0 >= L) continue;
      uint32_t qa[D / 16][4], da[D / 16][4];
      load_a_rows<D>(qa, qs, q0, lane);
      load_a_rows<D>(da, ds, q0 - dao0, lane);
      float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.f, 0.f}, ag[2] = {0.f, 0.f};
      for (int c = 0; c < nchunk; ++c) {
        float sc[4][4], gm[4][4];
        logits<D>(sc, qa, ks, q0, c * kChunk, bias, ldt, L, lane);
        rows_product<D>(gm, da, vs, c * kChunk, lane);
        running_stats<true>(m, z, ag, sc, gm);
      }
      if (t == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = q0 + g + 8 * r;
          st_m[i] = m[r];
          st_z[i] = z[r];
          st_d[i] = s * ag[r] / z[r];
        }
      }
    }
    __syncthreads();

    // 2. dK, then dV, per key tile (two sweeps over the query chunks, so
    // that one accumulator is live at a time).
    for (int k00 = 0; k00 < L; k00 += span) {
      const int k0 = k00 + warp * 16;
      const bool active = k0 < L;
#pragma unroll 1
      for (int which = 0; which < 2; ++which) {
        float acc[D / 8][4] = {};
        for (int c = 0; c < nchunk; ++c) {
          ensure_dao(c * kChunk);
          if (!active) continue;
          float sc[4][4], gm[4][4];
          {
            uint32_t ka[D / 16][4];
            load_a_rows<D>(ka, ks, k0, lane);
            rows_product<D>(sc, ka, qs, c * kChunk, lane);
          }
          if (which == 0) {
            uint32_t va[D / 16][4];
            load_a_rows<D>(va, vs, k0, lane);
            rows_product<D>(gm, va, ds, c * kChunk - dao0, lane);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = k0 + g + ((e >> 1) << 3), i = c * kChunk + nt * 8 + 2 * t + (e & 1);
              float x = 0.f;
              if (i < L && j < L) {
                const float l = sc[nt][e] * head_scaling<D>() + bias[(size_t)i * ldt + j];
                const float p = expf(l - st_m[i]) / st_z[i];
                x = which == 0 ? p * (s * gm[nt][e] - st_d[i])
                               : M == Mode::kMega ? p : s * p + uniform;
              }
              sc[nt][e] = x;  // dS, or the value weight
            }
          }
          if (which == 0) {
            chunk_product<D>(acc, sc, qs, c * kChunk, lane);
          } else if constexpr (M == Mode::kMega) {
            chunk_product<D, true>(acc, sc, ds, c * kChunk - dao0, lane, s);
          } else {
            chunk_product<D>(acc, sc, ds, c * kChunk - dao0, lane);
          }
        }
        if (!active) continue;
        if (which == 0) {
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] *= head_scaling<D>();
          }
          emit_ln_grad<D, M>(acc, k0, 1, line, h, C3, a.qkv, a.ln, a.dqkv, a.dacc, wslot, pass,
                             lane);
        } else {
          if constexpr (M == Mode::kMega) add_mean_grad<D>(acc, dsum, (1.f - s) / L, lane);
          emit_v_grad<D, M>(acc, k0, line, h, C3, a.dqkv, a.dacc, pass, lane);
        }
      }
    }

    // 3. dS, dscale and dQ per query tile.
    for (int q00 = 0; q00 < L; q00 += span) {
      ensure_dao(q00);
      const int q0 = q00 + warp * 16;
      if (q0 >= L) continue;
      float mr[2], zr[2], dr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = q0 + g + 8 * r;
        mr[r] = st_m[i];
        zr[r] = st_z[i];
        dr[r] = st_d[i];
      }
      float dq[D / 8][4] = {};
      for (int c = 0; c < nchunk; ++c) {
        float sc[4][4], gm[4][4];
        {
          uint32_t qa[D / 16][4], da[D / 16][4];
          load_a_rows<D>(qa, qs, q0, lane);
          load_a_rows<D>(da, ds, q0 - dao0, lane);
          logits<D>(sc, qa, ks, q0, c * kChunk, bias, ldt, L, lane);
          rows_product<D>(gm, da, vs, c * kChunk, lane);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, i = q0 + g + 8 * r, j = c * kChunk + nt * 8 + 2 * t + (e & 1);
            float dS = 0.f;
            if (i < L && j < L) {
              const float p = expf(sc[nt][e] - mr[r]) / zr[r];
              dS = p * (s * gm[nt][e] - dr[r]);
              dsc += (p - inv_l) * gm[nt][e];
              float* cell = slot + (size_t)i * L + j;
              *cell = first ? dS : *cell + dS;
            }
            sc[nt][e] = dS;
          }
        }
        chunk_product<D>(dq, sc, ks, c * kChunk, lane);
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] *= head_scaling<D>();
      }
      emit_ln_grad<D, M>(dq, q0, 0, line, h, C3, a.qkv, a.ln, a.dqkv, a.dacc, wslot, pass,
                         lane);
    }
  }

  write_partials<D>(a, grp, h, L, nullptr, 0, slot, dsc, wln, red);
}

// Lines of at most kShortMax tokens: the line's q, k, v, dao and, once
// computed, its R(dS) and R(P_eff) (L x L each) stay in shared memory.  A block owns
// the lines [grp * per, (grp + 1) * per) of one head (blockIdx.x = head +
// heads * grp) and takes them one after another, a warp a 16-token tile:
//   1. query tiles: m, z and D_i over the key chunks, then (S and G kept when
//      the line is one chunk, else again) dS into the block's table sum,
//      dscale, dQ += R(dS) k, R(dS) and R(P_eff) into shared memory; the q
//      part of dqkv through the qk-LN backward;
//   2. key tiles: dK = R(dS)^T q and dV = R(P_eff)^T dao from shared memory;
//      the k part through the qk-LN backward, the v part.
template <int D, Mode M>
size_t bwd_short_smem_bytes(int L) {
  const int rows = staged_rows(L), nw = line_warps(L);
  size_t b = (size_t)4 * rows * D * sizeof(bf16) + (size_t)2 * rows * (rows + 8) * sizeof(bf16) +
             (size_t)nw * 4 * D * 4 + kMaxWarps * 4 + (M == Mode::kMega ? D * 4 : 0);
  if (L <= kSmemBiasMax) b += ((size_t)nw * 16 * (rows + 8) + (size_t)L * (L + 1)) * 4;
  return b;
}

template <int D, Mode M>
__global__ void __launch_bounds__(kMaxWarps * 32) lane_bwd_short_kernel(BwdArgs a, int pass) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x % a.heads, grp = blockIdx.x / a.heads;
  const int L = pass == 0 ? a.W : a.H, rows = staged_rows(L), nchunk = rows / kChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3, span = nw * 16, C3 = 3 * a.C, ldp = rows + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + rows * D;
  bf16* vs = ks + rows * D;
  bf16* ds = vs + rows * D;
  bf16* p_ds = ds + rows * D;       // (rows, rows + 8): R(dS), query-major
  bf16* p_pe = p_ds + rows * ldp;   // (rows, rows + 8): R(P_eff)
  float* wln = reinterpret_cast<float*>(p_pe + rows * ldp);  // (nw, 4, D)
  float* red = wln + nw * 4 * D;                              // (kMaxWarps)
  float* dsum = red + kMaxWarps;     // kMega: (D) sum_i dao_i of the line
  const bool smem_acc = L <= kSmemBiasMax;  // the table and its gradient sum in shared memory
  const int ldb = rows + 8;
  float* accb = dsum + (M == Mode::kMega ? D : 0);  // (nw * 16, rows + 8): dS over the lines
  float* tbs = accb + span * ldb;    // (L, L + 1): the table
  float* slot = a.part_bias + (size_t)(grp * a.heads + h) * L * L;
  float* wslot = wln + warp * 4 * D;
  const float s = a.scale[h * 2 + pass], uniform = (1.f - s) * (1.f / L), inv_l = 1.f / L;
  const float* bias = (pass == 0 ? a.bias_x : a.bias_y) + (size_t)h * L * L;
  for (int e = threadIdx.x; e < nw * 4 * D; e += blockDim.x) wln[e] = 0.f;
  if (smem_acc) {
    for (int e = threadIdx.x; e < span * ldb; e += blockDim.x) accb[e] = 0.f;
    for (int e = threadIdx.x; e < L * L; e += blockDim.x) tbs[e / L * (L + 1) + e % L] = bias[e];
    bias = tbs;
  }
  const int ldt = smem_acc ? L + 1 : L;
  float dsc = 0.f;
  const int l0 = grp * a.per, l1 = min(l0 + a.per, a.lines);
  for (int li = l0; li < l1; ++li) {
    const Line line = make_line(pass, a.H, a.W, li);
    const bool first = li == l0;
    __syncthreads();  // the last line's reads of shared memory are done
    stage_qkv<D>(qs, ks, vs, a.qkv, line, h, C3, a.ln, rows);
    stage_dao<D>(ds, a.dout, line, h, a.C, 0, rows);
    __syncthreads();
    if constexpr (M == Mode::kMega) line_column_sum<D>(dsum, ds, L);  // read after step 1

    // 1. Query tiles.
    const int q0 = warp * 16;
    if (q0 < L) {
      uint32_t qa[D / 16][4], da[D / 16][4];
      load_a_rows<D>(qa, qs, q0, lane);
      load_a_rows<D>(da, ds, q0, lane);
      float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.f, 0.f}, ag[2] = {0.f, 0.f};
      float sc[4][4], gm[4][4];
      for (int c = 0; c < nchunk; ++c) {
        logits<D>(sc, qa, ks, q0, c * kChunk, bias, ldt, L, lane);
        rows_product<D>(gm, da, vs, c * kChunk, lane);
        running_stats<true>(m, z, ag, sc, gm);
      }
      const float dr[2] = {s * ag[0] / z[0], s * ag[1] / z[1]};
      float dq[D / 8][4] = {};
      for (int c = 0; c < nchunk; ++c) {
        if (nchunk > 1) {
          logits<D>(sc, qa, ks, q0, c * kChunk, bias, ldt, L, lane);
          rows_product<D>(gm, da, vs, c * kChunk, lane);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, i = q0 + g + 8 * r, j = c * kChunk + nt * 8 + 2 * t + (e & 1);
            float dS = 0.f, pe = 0.f;
            if (i < L && j < L) {
              const float p = expf(sc[nt][e] - m[r]) / z[r];
              dS = p * (s * gm[nt][e] - dr[r]);
              pe = M == Mode::kMega ? p : s * p + uniform;
              dsc += (p - inv_l) * gm[nt][e];
              float* cell = smem_acc ? accb + i * ldb + j : slot + (size_t)i * L + j;
              *cell = (first && !smem_acc) ? dS : *cell + dS;
            }
            sc[nt][e] = dS;
            gm[nt][e] = pe;
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int at = (q0 + g + 8 * r) * ldp + c * kChunk + nt * 8 + 2 * t;
            *reinterpret_cast<uint32_t*>(p_ds + at) = pack(sc[nt][2 * r], sc[nt][2 * r + 1]);
            *reinterpret_cast<uint32_t*>(p_pe + at) = pack(gm[nt][2 * r], gm[nt][2 * r + 1]);
          }
        }
        chunk_product<D>(dq, sc, ks, c * kChunk, lane);
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] *= head_scaling<D>();
      }
      emit_ln_grad<D, M>(dq, q0, 0, line, h, C3, a.qkv, a.ln, a.dqkv, a.dacc, wslot, pass,
                         lane);
    }
    __syncthreads();

    // 2. Key tiles: dK and dV from the line's R(dS) and R(P_eff) (kMega:
    // R(P) and R(s dao)).
    const int k0 = warp * 16;
    if (k0 < L) {
      float dk[D / 8][4] = {}, dv[D / 8][4] = {};
      const int lq = round_up(L, 16);
      for (int i0 = 0; i0 < lq; i0 += 16) {
        const int at = (i0 + (lane & 7) + ((lane >> 4) << 3)) * ldp + k0 + (((lane >> 3) & 1) << 3);
        uint32_t a_ds[4], a_pe[4];
        ldsm4t(a_ds, p_ds + at);
        ldsm4t(a_pe, p_pe + at);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t b[4];
          load_b_cols<D>(b, qs, i0, np * 16, lane);
          mma(dk[2 * np], a_ds, b[0], b[1]);
          mma(dk[2 * np + 1], a_ds, b[2], b[3]);
          load_b_cols<D>(b, ds, i0, np * 16, lane);
          if constexpr (M == Mode::kMega) {
#pragma unroll
            for (int e = 0; e < 4; ++e) b[e] = scale_pair(b[e], s);
          }
          mma(dv[2 * np], a_pe, b[0], b[1]);
          mma(dv[2 * np + 1], a_pe, b[2], b[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[n][e] *= head_scaling<D>();
      }
      emit_ln_grad<D, M>(dk, k0, 1, line, h, C3, a.qkv, a.ln, a.dqkv, a.dacc, wslot, pass,
                         lane);
      if constexpr (M == Mode::kMega) add_mean_grad<D>(dv, dsum, (1.f - s) / L, lane);
      emit_v_grad<D, M>(dv, k0, line, h, C3, a.dqkv, a.dacc, pass, lane);
    }
  }
  write_partials<D>(a, grp, h, L, smem_acc ? accb : nullptr, ldb, slot, dsc, wln, red);
}

// ------------------------------------------------------------- launchers

template <int D, Mode M>
int lane_fwd(const FwdArgs& a, int BT, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(lane_fwd_kernel<D, M>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)fwd_smem_bytes<D, M>(512));
  if (e != cudaSuccess) return e;
  for (int pass = 0; pass < 2; ++pass) {
    const int L = pass == 0 ? a.W : a.H, lines = BT * (pass == 0 ? a.H : a.W);
    lane_fwd_kernel<D, M><<<lines * a.heads, line_warps(L) * 32, fwd_smem_bytes<D, M>(L),
                            stream>>>(a, pass);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

using BwdKernel = void (*)(BwdArgs, int);

// The backward kernel for lines of L tokens and its dynamic shared memory,
// each kernel's shared-memory limit set for its longest line.  The launches
// and the host's plan of blocks (lane_bwd_resident) both take it from here.
template <int D, Mode M>
cudaError_t bwd_kernel(int L, BwdKernel* kernel, size_t* smem) {
  // At head dim 64 the backward needs more registers than two blocks of 8
  // warps an SM leave: capped at 128 they spilled and ran ~1.6x slower (both
  // kernels; NVIDIA H100 80GB HBM3, 700.00 W).  At head dim 16 the cap costs
  // the long kernel nothing and doubles its blocks.
  const BwdKernel long_kernel = lane_bwd_long_kernel<D, M, D == 64 ? 1 : 2>;
  const BwdKernel short_kernel = lane_bwd_short_kernel<D, M>;
  cudaError_t e = cudaFuncSetAttribute(long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bwd_long_smem_bytes<D, M>(512));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(short_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bwd_short_smem_bytes<D, M>(kShortMax));
  if (e != cudaSuccess) return e;
  *kernel = L <= kShortMax ? short_kernel : long_kernel;
  *smem = L <= kShortMax ? bwd_short_smem_bytes<D, M>(L) : bwd_long_smem_bytes<D, M>(L);
  return cudaSuccess;
}

// Blocks of the backward kernel for lines of L tokens that one SM of the
// current device holds at once (its registers, shared memory and block size).
template <int D, Mode M>
int lane_bwd_resident(int L, int* blocks) {
  BwdKernel kernel;
  size_t smem;
  const cudaError_t e = bwd_kernel<D, M>(L, &kernel, &smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, line_warps(L) * 32, smem);
}

// lane_bwd_resident at head_dim 16 or 64 and lines of 1 to 512 tokens.
template <Mode M>
int bwd_resident(int head_dim, int L, int* blocks) {
  if ((head_dim != 16 && head_dim != 64) || L < 1 || L > 512) return cudaErrorInvalidValue;
  return head_dim == 64 ? lane_bwd_resident<64, M>(L, blocks)
                        : lane_bwd_resident<16, M>(L, blocks);
}

// The partials of both passes: pass p's (groups[p], heads, L, L) table sums,
// (heads, groups[p]) scale sums and (4, D, groups[p], heads) LN sums.
struct Partials {
  float* bias[2];
  float* scale[2];
  float* ln[2];
};

// The partials carved from one float32 buffer, pass 0 then pass 1, each
// pass's table, scale and LN sums in that order (the layout
// ops/axial_lane.py:lane_bwd_scratch allocates); lines of L_p = W, H.
inline Partials carve_partials(float* part, const int (&groups)[2], int heads, int H, int W,
                               int D) {
  Partials p{};
  for (int pass = 0; pass < 2; ++pass) {
    const int L = pass == 0 ? W : H;
    p.bias[pass] = part;
    part += (size_t)groups[pass] * heads * L * L;
    p.scale[pass] = part;
    part += (size_t)groups[pass] * heads;
    p.ln[pass] = part;
    part += (size_t)groups[pass] * heads * 4 * D;
  }
  return p;
}

// One pass (groups blocks of per lines a head) into its partials.
template <int D, Mode M>
int lane_bwd_pass(const BwdArgs& base, int BT, int pass, int groups, int per,
                  const Partials& part, cudaStream_t stream) {
  BwdArgs a = base;
  const int L = pass == 0 ? a.W : a.H;
  a.lines = BT * (pass == 0 ? a.H : a.W);
  if (!plan_ok(a.lines, groups, per)) return cudaErrorInvalidValue;
  a.per = per;
  a.part_bias = part.bias[pass];
  a.part_scale = part.scale[pass];
  a.part_ln = part.ln[pass];
  BwdKernel kernel;
  size_t smem;
  cudaError_t e = bwd_kernel<D, M>(L, &kernel, &smem);
  if (e != cudaSuccess) return e;
  kernel<<<groups * a.heads, line_warps(L) * 32, smem, stream>>>(a, pass);
  return cudaGetLastError();
}

// The sums of both passes' partials into dbias_x, dbias_y, dscale and dln,
// written whole.
template <int D>
cudaError_t lane_bwd_sum(const BwdArgs& base, const int (&groups)[2], const Partials& part,
                         float* dbias_x, float* dbias_y, float* dscale, float* dln,
                         cudaStream_t stream) {
  ParamSumArgs s{};
  for (int pass = 0; pass < 2; ++pass) {
    s.part_bias[pass] = part.bias[pass];
    s.part_scale[pass] = part.scale[pass];
    s.part_ln[pass] = part.ln[pass];
    s.bias_groups[pass] = s.scale_units[pass] = groups[pass];
    s.ln_units[pass] = groups[pass] * base.heads;
    s.L[pass] = pass == 0 ? base.W : base.H;
  }
  s.dbias[0] = dbias_x;
  s.dbias[1] = dbias_y;
  s.dscale = dscale;
  s.dln = dln;
  s.heads = base.heads;
  s.D = D;
  return launch_param_sum(s, stream);
}

// Both passes (groups[p] blocks of per[p] lines a head), then the sums.
template <int D, Mode M>
int lane_bwd(const BwdArgs& base, int BT, const int (&groups)[2], const int (&per)[2],
             const Partials& part, float* dbias_x, float* dbias_y, float* dscale, float* dln,
             cudaStream_t stream) {
  for (int pass = 0; pass < 2; ++pass) {
    const int e = lane_bwd_pass<D, M>(base, BT, pass, groups[pass], per[pass], part, stream);
    if (e != cudaSuccess) return e;
  }
  return lane_bwd_sum<D>(base, groups, part, dbias_x, dbias_y, dscale, dln, stream);
}

}  // namespace

// bwd_resident of each mode, defined by the source that launches that mode's
// kernels, so that no kernel is built twice; the one C entry,
// bf_lane_bwd_resident (axial_lane_hopper.cu), takes the mode.
int resident_lane(int head_dim, int L, int* blocks);     // axial_lane_hopper.cu
int resident_lane_px(int head_dim, int L, int* blocks);  // axial_lane_px.cu
int resident_mega(int head_dim, int L, int* blocks);     // axial_block_mega.cu

}  // namespace lane
}  // namespace bft
