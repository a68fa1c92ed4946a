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
//   chunk_attention_kernel, one block per (chunk, head, frame): both products
//       on block_gemm.cuh's WMMA tile, the softmax and the blend in between
//       from shared memory ((a) is one block of it, with no scale, bias or
//       blend, writing S as well);
//   the permutation product on hopper_gemm.cuh (TMA + wgmma): out = bf16(x .
//       P) as its NN layout (P stored (K, N), read MN-major), on 64-row tiles
//       where 128-row ones would leave SMs idle (the probe's 384 rows: 48
//       blocks, not 24); or bf16((addend + x . P^T) / 2) for (c)'s last
//       product as its NT layout (P is P^T read K-major) with the kHalfAdd
//       epilogue (o_row added in float32).  P stays an input read as a
//       dense operand: no gather.  One nonzero term a sum makes it exact in
//       any order of the float32 sum.
// Bound at (b)'s shape ((384, 1024) . (1024, 1024)): its 3.7 MB of operands
// and output, 0.0011 ms at 3.35 TB/s, above its 0.8 GFLOP (0.0008 ms).
// Bound at (c)'s shape (BT = 20, C = 384, 32 x 32 tokens, ch = 128), counting
// P as the dense operand it is: the four relayout products (2*384*1024^2
// FLOP each per frame, the kv one twice as tall) and the chunk products,
// 72 GFLOP, on the tensor cores: 0.073 ms at 989 TFLOP/s, above its 65 MB of
// slabs (0.020 ms).  The chunk kernel's WMMA tile runs far below that peak;
// the relayouts folded into its staging are left for later.
#include <cmath>

#include "block_gemm.cuh"
#include "hopper_gemm.cuh"

namespace bft {
namespace {

using bf16 = __nv_bfloat16;

struct ChunkArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  long long q_fs, kv_fs;  // frame strides (elements)
  int ld;                 // row stride of q, k, v (elements)
  const float* bias;      // (heads * ch, ch) or null (0)
  const float* mblk;      // (ch, ch) or null (no blend: pb = bf16(p))
  const float* sc;        // (heads, 2) or null
  int sc_col;
  float scaling;
  float* s_out;           // (frames, heads, nchunks, ch, ch) raw q^T k, or null
  void* out;              // out[f * out_fs + (h * d + dd) * out_ld + ci * ch + i]
  int out_bf16;
  long long out_fs;
  int out_ld;
  int heads, d, nchunks, ch;
};

__device__ __forceinline__ bf16 bf_zero() { return __float2bfloat16(0.f); }
__host__ __device__ constexpr int round32(int n) { return (n + 31) / 32 * 32; }

// The probabilities pb (ch, ch + 8) sit past the largest tile block_gemm uses.
__host__ __device__ size_t pb_offset() {
  return a_bytes<bf16>(kMaxMTiles) + b_bytes<bf16>() +
         align128(sizeof(float) * 16 * kMaxMTiles * kLDC);
}

size_t chunk_smem_bytes(int ch) { return pb_offset() + align128(sizeof(bf16) * ch * (ch + 8)); }

__global__ void __launch_bounds__(kGemmThreads) chunk_attention_kernel(ChunkArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ci = blockIdx.x, hd = blockIdx.y, f = blockIdx.z;
  const int ch = a.ch, d = a.d, ld = a.ld, pld = ch + 8;
  const size_t head_off = (size_t)hd * d * ld + (size_t)ci * ch;
  const bf16* q = a.q + f * a.q_fs + head_off;
  const bf16* k = a.k + f * a.kv_fs + head_off;
  const bf16* v = a.v + f * a.kv_fs + head_off;
  bf16* pb = reinterpret_cast<bf16*>(smem + pb_offset());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // S[i][j] = sum_dd q[dd, i] k[dd, j]: both operands stored k-major.
  block_gemm<bf16, true>(
      ch / 16, ch / 16, round32(d),
      [&](int i, int dd) { return dd < d ? q[(size_t)dd * ld + i] : bf_zero(); },
      [&](int j, int dd) { return dd < d ? k[(size_t)dd * ld + j] : bf_zero(); }, smem);
  __syncthreads();
  const float* S = gemm_out<bf16>(smem, ch / 16);
  const float s_h = a.sc ? a.sc[hd * 2 + a.sc_col] : 1.f;
  const float one_minus = 1.f - s_h;
  float* s_out = a.s_out ? a.s_out + (((size_t)f * a.heads + hd) * a.nchunks + ci) * ch * ch
                         : nullptr;
  // One warp a row: lanes hold j = lane + 32 u (ch <= 128: u < 4).
  for (int i = warp; i < ch; i += kGemmThreads / 32) {
    float s[4];
    float m = -INFINITY;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = lane + 32 * u;
      if (j < ch) {
        const float raw = S[i * kLDC + j];
        if (s_out) s_out[(size_t)i * ch + j] = raw;
        s[u] = raw * a.scaling + (a.bias ? a.bias[((size_t)hd * ch + i) * ch + j] : 0.f);
        m = fmaxf(m, s[u]);
      }
    }
    m = warp_max(m);
    float z = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (lane + 32 * u < ch) {
        s[u] = expf(s[u] - m);
        z += s[u];
      }
    z = warp_sum(z);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = lane + 32 * u;
      if (j < ch) {
        const float p = s[u] / z;
        const float t = a.mblk ? __fadd_rn(__fmul_rn(s_h, p),
                                           __fmul_rn(a.mblk[(size_t)i * ch + j], one_minus))
                               : p;
        pb[i * pld + j] = __float2bfloat16(t);
      }
    }
  }
  __syncthreads();
  // pv[dd][i] = sum_j v[dd, j] pb[i][j]: both operands k-fastest.
  const int m_tiles = (d + 15) / 16;
  block_gemm<bf16, false>(
      m_tiles, ch / 16, ch,
      [&](int dd, int j) { return dd < d ? v[(size_t)dd * ld + j] : bf_zero(); },
      [&](int i, int j) { return pb[i * pld + j]; }, smem);
  __syncthreads();
  const float* pv = gemm_out<bf16>(smem, m_tiles);
  const size_t obase = f * a.out_fs + (size_t)hd * d * a.out_ld + (size_t)ci * ch;
  for (int e = tid; e < d * ch; e += kGemmThreads) {
    const int dd = e / ch, i = e % ch;
    const float val = pv[dd * kLDC + i];
    const size_t o = obase + (size_t)dd * a.out_ld + i;
    if (a.out_bf16)
      static_cast<bf16*>(a.out)[o] = __float2bfloat16(val);
    else
      static_cast<float*>(a.out)[o] = val;
  }
}

bool chunk_shape_ok(int frames, int heads, int d, int nchunks, int ch) {
  return frames >= 1 && frames <= 65535 && heads >= 1 && heads <= 65535 && d >= 1 && d <= 128 &&
         ch >= 32 && ch <= 128 && ch % 32 == 0 && nchunks >= 1;
}

}  // namespace
}  // namespace bft

// The chunk attention of bench_core's _axis_pass (and, with null bias, mblk
// and sc, scaling 1 and s_out set, probe_dot_combos' kernel): q, k, v bf16
// with row stride ld, frame strides q_fs and kv_fs; out float32 (out_bf16 =
// 0) or bf16 at out[f * out_fs + (h * d + dd) * out_ld + ci * ch + i].
// ch a multiple of 32 up to 128, d up to 128.  Returns a cudaError_t.
extern "C" int bf_probe_chunk_attention(const void* q, const void* k, const void* v,
                                        long long q_fs, long long kv_fs, int ld,
                                        const float* bias, const float* mblk, const float* sc,
                                        int sc_col, float scaling, float* s_out, void* out,
                                        int out_bf16, long long out_fs, int out_ld, int frames,
                                        int heads, int d, int nchunks, int ch, void* stream) {
  using namespace bft;
  if (!chunk_shape_ok(frames, heads, d, nchunks, ch)) return cudaErrorInvalidValue;
  const ChunkArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), q_fs, kv_fs, ld, bias, mblk, sc, sc_col,
                    scaling, s_out, out, out_bf16, out_fs, out_ld, heads, d, nchunks, ch};
  const size_t smem = chunk_smem_bytes(ch);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(chunk_attention_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return e;
  chunk_attention_kernel<<<dim3(nchunks, heads, frames), kGemmThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
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
