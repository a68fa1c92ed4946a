// P2: the chunk-matmul axial attention probe, hand-written for Hopper
// (sm_90a), bfloat16.
//
// Replaces the three Pallas kernels of scripts/probe_chunk_axial.py:
//   (a) probe_dot_combos' kernel (pallas_call :83): S = q^T k over the rows of
//       two slab slices, then pv = v . bf16(softmax(S))^T;
//   (b) probe_perm_matmul's kernel (:124): bf16(x . P) for a 0/1 permutation
//       P, which the probe asks to be bit-exact;
//   (c) bench_core's kernel (:260, bodies _core_kernel :176, _axis_pass :140):
//       per frame of channel-major q (BT, C, N), kv (BT, 2C, N), per (head,
//       chunk of ch tokens) S = q^T k * d^-1/2 + bias (per-head (ch, ch)
//       tables, -1e9 off the line blocks), softmax in float32,
//       pb = bf16(s_h p + (1 - s_h) Mblk), pv = v . pb^T; the row pass on the
//       slabs as they are, the column pass on bf16(x . P) slabs, its output
//       rounded to bf16 and multiplied by P^T; out = bf16((o_row + o_col) / 2).
// Two kernels serve all three:
//   chunk_attention_kernel, one block per (chunk, head, frame) ((a) is one
//       block of it, with no scale, bias or blend, writing S as well);
//   the permutation product on hopper_gemm.cuh (TMA + wgmma): out = bf16(x .
//       P) as its NN layout (P stored (K, N), read MN-major), on 64-row tiles
//       where 128-row ones would leave SMs idle (the probe's 384 rows: 48
//       blocks, not 24); or bf16((addend + x . P^T) / 2) for (c)'s last
//       product as its NT layout (P is P^T read K-major) with the kHalfAdd
//       epilogue (o_row added in float32).  P stays an input read as a
//       dense operand: no gather.  One nonzero term a sum makes it exact in
//       any order of the float32 sum.
// The chunk kernel, from the math: the q, k and v tiles of a (chunk, head,
// frame) are (d x ch) boxes of the channel-major slabs, tokens contiguous,
// which TMA reads as they are (64 tokens x d rows a box, 128-byte swizzle; a
// 4-D view (N, d, heads, frames) zero-fills d to a multiple of 16 and the
// tokens past the slab).  S = q^T k is a wgmma with both operands MN-major
// (one warpgroup a 64-query slice, n = ch rounded up to 64; the keys past
// ch masked), kept in registers: scale, the head's bias table (its rows
// staged through shared memory, below) and the softmax in float32 on the
// accumulators (a row's values on four lanes; exp on ex2.approx, one
// reciprocal a row), the
// blend with Mblk rounded as the plain version rounds it, then the
// accumulators become pb's A fragments (FlashAttention-3's register reuse)
// for pv^T(i, dd) = sum_j pb(i, j) v(dd, j), a register-A wgmma with v
// K-major as stored.  The output tile goes through shared memory to 16-byte
// stores along the tokens.  (a)'s S output is a template value, so the core
// passes pay nothing for it.
// Bound at (b)'s shape ((384, 1024) . (1024, 1024)): its 3.7 MB of operands
// and output, 0.0011 ms at 3.35 TB/s, above its 0.8 GFLOP (0.0008 ms).
// Bound at (c)'s shape (BT = 20, C = 384, 32 x 32 tokens, ch = 128), counting
// P as the dense operand it is: the four relayout products (2*384*1024^2
// FLOP each per frame, the kv one twice as tall) and the chunk products,
// 72 GFLOP, on the tensor cores: 0.073 ms at 989 TFLOP/s, above its 65 MB of
// slabs (0.020 ms).  A chunk pass alone is bound by its bytes: 47 MB of q, k
// and v and its output, 31 MB of float32 rows or 16 MB of bf16 columns
// (0.024 and 0.019 ms); its 4 GFLOP take 0.004 ms.
#include <atomic>
#include <cmath>

#include "hopper_gemm.cuh"

namespace bft {
namespace {

using bf16 = __nv_bfloat16;

struct ChunkArgs {
  const float* bias;      // (heads * ch, ch); unread by (a)
  const float* mblk;      // (ch, ch); unread by (a)
  const float* sc;        // (heads, 2); unread by (a)
  int sc_col;
  float scaling;
  float* s_out;           // kDots: (frames, heads, nchunks, ch, ch) raw q^T k
  void* out;              // out[f * out_fs + (h * d + dd) * out_ld + ci * ch + i]
  int out_bf16;
  long long out_fs;
  int out_ld;
  int heads, d, ch;
};

// The smem of a (kN, kD) block: q, k and v as kN / 64 boxes of kD rows x 128
// bytes each (the output tile reuses them), two barriers, then (but for (a))
// each warp's 8 table rows of kN + 8 floats; alignment slack first.
__host__ __device__ constexpr int chunk_box_bytes(int kD) { return kD * 128; }
__host__ __device__ constexpr size_t chunk_smem_bytes(int kN, int kD, bool dots) {
  return 1024 + 3 * size_t(kN / 64) * chunk_box_bytes(kD) + 16 +
         (dots ? 0 : size_t(kN / 16) * 8 * (kN + 8) * 4);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Grid (nchunks, heads, frames), 2 kN threads: warpgroup w takes the queries
// [64 w, 64 w + 64) of the chunk; kN = ch rounded up to 64, kD = d rounded
// up to 16, 32, 64 or 128.  A block of 256 threads takes the registers it
// needs (capped at 128 for two an SM, the softmax with the table rows in
// flight spilled); those of 128 threads fit four an SM.
template <int kN, int kD, bool kDots>
__global__ void __launch_bounds__(2 * kN, kN == 128 ? 1 : 4)
    chunk_attention_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const ChunkArgs a) {
  constexpr int kBoxes = kN / 64, kBox = chunk_box_bytes(kD);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* const stile = reinterpret_cast<float*>(smem_raw + (base - raw));
  const uint32_t sq = base, sk = sq + kBoxes * kBox, sv = sk + kBoxes * kBox;
  const uint32_t bar_qk = sv + kBoxes * kBox, bar_v = bar_qk + 8;
  const int ci = blockIdx.x, hd = blockIdx.y, f = blockIdx.z, ch = a.ch;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32, g = lane / 4, q4 = lane % 4;

  // The bias and Mblk tables through shared memory, a warp's 8 query rows of
  // one table at a time: fetched from L2 16 bytes a lane along the rows
  // (a warp's load a whole row), put into the warp's padded rows (kTLd
  // floats: a half-warp's 8-byte fragment reads hit 32 banks), then read in
  // the accumulators' pairs.  (Reading the pairs from L2 touched 8 cache
  // lines for a warp's 256 bytes.)
  constexpr int kTLd = kN + 8, kPer = kN / 16;  // a lane's float4 of 8 rows of kN
  float* const trows = reinterpret_cast<float*>(smem_raw + (base - raw) + 3 * kBoxes * kBox +
                                                16) + (tid / 32) * 8 * kTLd;
  const int rows0 = 64 * wg + 16 * ((tid % 128) / 32);  // the warp's first query row
  float4 pre[kDots ? 1 : kPer];
  auto fetch = [&](const float* table, int r0) {  // rows r0 .. r0 + 7 of a (ch, ch) table
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = lane + 32 * u, r = e / (kN / 4), c4 = e % (kN / 4);
      pre[u] = r0 + r < ch && 4 * c4 < ch
                   ? __ldg(reinterpret_cast<const float4*>(table + (size_t)(r0 + r) * ch) + c4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto put = [&]() {  // after every lane's reads of the rows put before
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = lane + 32 * u, r = e / (kN / 4), c4 = e % (kN / 4);
      *reinterpret_cast<float4*>(trows + r * kTLd + 4 * c4) = pre[u];
    }
    __syncwarp();
  };
  if (tid == 0) {
    hg::mbar_init(bar_qk, 1);
    hg::mbar_init(bar_v, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    hg::mbar_expect_tx(bar_qk, 2 * kBoxes * kBox);
    hg::mbar_expect_tx(bar_v, kBoxes * kBox);
#pragma unroll
    for (int b = 0; b < kBoxes; ++b) {
      const int tok = ci * ch + 64 * b;
      hg::tma_load_4d(sq + b * kBox, &tq, bar_qk, tok, 0, hd, f);
      hg::tma_load_4d(sk + b * kBox, &tk, bar_qk, tok, 0, hd, f);
      hg::tma_load_4d(sv + b * kBox, &tv, bar_v, tok, 0, hd, f);
    }
  }
  const float* const bias_h = kDots ? nullptr : a.bias + (size_t)hd * ch * ch;
  if constexpr (!kDots) fetch(bias_h, rows0);  // in flight while q and k land
  __syncthreads();

  // S(i, j) = sum_dd q(dd, i) k(dd, j): both operands MN-major, 16 rows of
  // dd (2 KB of a box) a step.
  float s[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) s[i] = 0.f;
  hg::mbar_wait(bar_qk, 0);
  hg::fence_regs(s);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint64_t da = hg::sw128_desc(sq + wg * kBox + kk * 2048, kBox, 1024);
    const uint64_t db = hg::sw128_desc(sk + kk * 2048, kBox, 1024);
    if constexpr (kN == 64)
      hg::wgmma_m64n64k16<1, 1>(s, da, db);
    else
      hg::wgmma_m64n128k16<1, 1>(s, da, db);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  hg::fence_regs(s);

  // The accumulator layout: this thread holds queries i0 (h = 0) and i0 + 8
  // (h = 1), keys 8 jj + 2 q4 + {0, 1} as s[4 jj + 2 h + {0, 1}]; a query's
  // row lies on the four lanes of one g, row g of the warp's 8 table rows.
  const int i0 = rows0 + g;
  const float s_h = kDots ? 1.f : a.sc[hd * 2 + a.sc_col];
  const float one_minus = 1.f - s_h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + 8 * h;
    if constexpr (!kDots) {
      put();                               // the bias rows of h
      fetch(a.mblk, rows0 + 8 * h);        // Mblk's, in flight during the softmax
    }
    float m = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kN / 8; ++jj) {
      const int j = 8 * jj + 2 * q4;
      float& v0 = s[4 * jj + 2 * h];
      float& v1 = s[4 * jj + 2 * h + 1];
      if (j < ch) {  // ch is a multiple of 32: j + 1 < ch too
        if constexpr (kDots) {
          if (i < ch)
            *reinterpret_cast<float2*>(a.s_out + ((((size_t)f * a.heads + hd) * gridDim.x + ci) *
                                                      ch + i) * ch + j) = make_float2(v0, v1);
          v0 *= a.scaling;
          v1 *= a.scaling;
        } else {
          const float2 bv = *reinterpret_cast<const float2*>(trows + g * kTLd + j);
          v0 = v0 * a.scaling + bv.x;
          v1 = v1 * a.scaling + bv.y;
        }
        m = fmaxf(m, fmaxf(v0, v1));
      } else {
        v0 = v1 = -INFINITY;
      }
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float z = 0.f;
#pragma unroll
    for (int jj = 0; jj < kN / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = s[4 * jj + 2 * h + e];
        v = __expf(v - m);
        z += v;
      }
    }
    z += __shfl_xor_sync(0xffffffffu, z, 1);
    z += __shfl_xor_sync(0xffffffffu, z, 2);
    const float rz = __frcp_rn(z);
    if constexpr (!kDots) {
      put();                                            // the Mblk rows of h
      if (h == 0) fetch(bias_h, rows0 + 8);             // in flight during the blend
    }
#pragma unroll
    for (int jj = 0; jj < kN / 8; ++jj) {
      const int j = 8 * jj + 2 * q4;
      float& v0 = s[4 * jj + 2 * h];
      float& v1 = s[4 * jj + 2 * h + 1];
      v0 *= rz;
      v1 *= rz;
      if constexpr (!kDots) {
        // pb = s_h p + (1 - s_h) Mblk, each product and the sum rounded as
        // the plain version's float32 ops; no blend past ch (no Mblk there).
        const float2 mb = *reinterpret_cast<const float2*>(trows + g * kTLd + j);
        v0 = j < ch ? __fadd_rn(__fmul_rn(s_h, v0), __fmul_rn(mb.x, one_minus)) : 0.f;
        v1 = j < ch ? __fadd_rn(__fmul_rn(s_h, v1), __fmul_rn(mb.y, one_minus)) : 0.f;
      }
    }
  }

  // pb as the A fragments of 16-key steps: step t's keys 16 t + 2 q4 (+8) are
  // s[8 t ..] (jj = 2 t) and s[8 t + 4 ..] (jj = 2 t + 1).
  uint32_t pa[kN / 16][4];
#pragma unroll
  for (int t = 0; t < kN / 16; ++t) {
    pa[t][0] = pack_bf16(s[8 * t], s[8 * t + 1]);
    pa[t][1] = pack_bf16(s[8 * t + 2], s[8 * t + 3]);
    pa[t][2] = pack_bf16(s[8 * t + 4], s[8 * t + 5]);
    pa[t][3] = pack_bf16(s[8 * t + 6], s[8 * t + 7]);
  }
  // pv^T(i, dd) = sum_j pb(i, j) v(dd, j): v K-major, 16 keys (32 bytes of a
  // row) a step.
  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
  hg::mbar_wait(bar_v, 0);
  hg::fence_regs(o);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int t = 0; t < kN / 16; ++t)
    hg::wgmma_rs<kD>(o, pa[t], hg::sw128_desc(sv + (t / 4) * kBox + (t % 4) * 32, 16, 1024));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  hg::fence_regs(o);

  // The tile (dd, i) in float32 through shared memory (every warpgroup past
  // its products first: the tile overwrites q, k and v), then 16 bytes a
  // thread along the tokens.
  constexpr int kLd = kN + 4;
  __syncthreads();
#pragma unroll
  for (int jj = 0; jj < kD / 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        stile[(8 * jj + 2 * q4 + e) * kLd + i0 + 8 * h] = o[4 * jj + 2 * h + e];
  __syncthreads();
  const size_t obase = f * a.out_fs + (size_t)hd * a.d * a.out_ld + (size_t)ci * ch;
  if (a.out_bf16) {
    const int per = ch / 8;
    for (int e = tid; e < a.d * per; e += 2 * kN) {
      const int dd = e / per, c8 = e % per;
      const float4 x = *reinterpret_cast<const float4*>(stile + dd * kLd + 8 * c8);
      const float4 y = *reinterpret_cast<const float4*>(stile + dd * kLd + 8 * c8 + 4);
      const uint4 v = make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w), pack_bf16(y.x, y.y),
                                 pack_bf16(y.z, y.w));
      *reinterpret_cast<uint4*>(static_cast<bf16*>(a.out) + obase + (size_t)dd * a.out_ld +
                                8 * c8) = v;
    }
  } else {
    const int per = ch / 4;
    for (int e = tid; e < a.d * per; e += 2 * kN) {
      const int dd = e / per, c4 = e % per;
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + obase + (size_t)dd * a.out_ld +
                                 4 * c4) =
          *reinterpret_cast<const float4*>(stile + dd * kLd + 4 * c4);
    }
  }
}

bool chunk_shape_ok(int frames, int heads, int d, int nchunks, int ch) {
  return frames >= 1 && frames <= 65535 && heads >= 1 && heads <= 65535 && d >= 1 && d <= 128 &&
         ch >= 32 && ch <= 128 && ch % 32 == 0 && nchunks >= 1;
}

template <int kN, int kD, bool kDots>
cudaError_t launch_chunk(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                         const ChunkArgs& a, int nchunks, int frames, cudaStream_t stream) {
  auto kernel = chunk_attention_kernel<kN, kD, kDots>;
  constexpr size_t smem = chunk_smem_bytes(kN, kD, kDots);
  static std::atomic<uint64_t> opted{0};
  cudaError_t e;
  if ((e = hg::opt_in_smem(reinterpret_cast<const void*>(kernel), (int)smem, &opted)) !=
      cudaSuccess)
    return e;
  kernel<<<dim3(nchunks, a.heads, frames), 2 * kN, smem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

template <int kN, bool kDots>
cudaError_t launch_chunk_d(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                           const ChunkArgs& a, int nchunks, int frames, cudaStream_t stream) {
  if (a.d <= 16) return launch_chunk<kN, 16, kDots>(tq, tk, tv, a, nchunks, frames, stream);
  if (a.d <= 32) return launch_chunk<kN, 32, kDots>(tq, tk, tv, a, nchunks, frames, stream);
  if (a.d <= 64) return launch_chunk<kN, 64, kDots>(tq, tk, tv, a, nchunks, frames, stream);
  return launch_chunk<kN, 128, kDots>(tq, tk, tv, a, nchunks, frames, stream);
}

}  // namespace
}  // namespace bft

// The chunk attention of bench_core's _axis_pass (and, with s_out set and
// scaling 1, probe_dot_combos' kernel, which reads no bias, mblk or sc): q,
// k, v bf16 with row stride ld, frame strides q_fs and kv_fs (0 for one
// frame), head h at rows [h d, h d + d) of a frame; out float32 (out_bf16 =
// 0) or bf16 at
// out[f * out_fs + (h * d + dd) * out_ld + ci * ch + i].  ch a multiple of 32
// up to 128, d up to 128; q, k, v, out 16-byte aligned, ld, q_fs, kv_fs and
// out_ld multiples of 8 (TMA's rule and the 16-byte stores; the wrappers
// check).  Returns a cudaError_t.
extern "C" int bf_probe_chunk_attention(const void* q, const void* k, const void* v,
                                        long long q_fs, long long kv_fs, int ld,
                                        const float* bias, const float* mblk, const float* sc,
                                        int sc_col, float scaling, float* s_out, void* out,
                                        int out_bf16, long long out_fs, int out_ld, int frames,
                                        int heads, int d, int nchunks, int ch, void* stream) {
  using namespace bft;
  if (!chunk_shape_ok(frames, heads, d, nchunks, ch) || ld % 8 || q_fs % 8 || kv_fs % 8 ||
      out_ld % 8 || (s_out == nullptr && (bias == nullptr || mblk == nullptr || sc == nullptr)))
    return cudaErrorInvalidValue;
  const int kd = d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
  const long long dense = (long long)heads * d * ld;  // the frame stride of one frame
  CUtensorMap tq, tk, tv;
  cudaError_t e;
  const int box[4] = {64, kd, 1, 1};
  const long long dims[4] = {(long long)nchunks * ch, d, heads, frames};
  const long long qs[3] = {ld, (long long)d * ld, q_fs ? q_fs : dense};
  const long long kvs[3] = {ld, (long long)d * ld, kv_fs ? kv_fs : dense};
  if ((e = hg::encode_map_nd(&tq, q, 4, dims, qs, box)) != cudaSuccess) return e;
  if ((e = hg::encode_map_nd(&tk, k, 4, dims, kvs, box)) != cudaSuccess) return e;
  if ((e = hg::encode_map_nd(&tv, v, 4, dims, kvs, box)) != cudaSuccess) return e;
  const ChunkArgs a{bias, mblk, sc, sc_col, scaling, s_out, out, out_bf16, out_fs, out_ld,
                    heads, d, ch};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (s_out)
    return ch <= 64 ? launch_chunk_d<64, true>(tq, tk, tv, a, nchunks, frames, s)
                    : launch_chunk_d<128, true>(tq, tk, tv, a, nchunks, frames, s);
  return ch <= 64 ? launch_chunk_d<64, false>(tq, tk, tv, a, nchunks, frames, s)
                  : launch_chunk_d<128, false>(tq, tk, tv, a, nchunks, frames, s);
}

// x (rows, n) and p (n, n) bf16, row-major, every base 16-byte aligned and
// n a multiple of 8 (TMA's rule; the wrapper checks); out (rows, n) bf16 =
// bf16(x . P), or with transpose_p bf16((addend + x . P^T) / 2), addend
// (rows, n) float32.  Returns a cudaError_t.
extern "C" int bf_probe_perm_product(const void* x, const void* p, int transpose_p,
                                     const float* addend, void* out, int rows, int n,
                                     void* stream) {
  namespace hg = bft::hg;
  using bf16 = __nv_bfloat16;
  if (rows < 1 || rows > 65535 * 64 || n < 8 || n % 8 || (transpose_p && !addend))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* pb = static_cast<const bf16*>(p);
  if (transpose_p) return hg::gemm_nt<hg::kHalfAdd>(xb, n, pb, n, rows, n, n, out, n, addend, s);
  return hg::gemm_nn_fit<hg::kRound>(xb, n, pb, n, rows, n, n, out, n, nullptr, s);
}
