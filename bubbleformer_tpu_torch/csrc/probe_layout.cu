// P4: the layout probes, hand-written for Hopper (sm_90a).
//
// Replaces the kernels that scripts/probe_mosaic.py runs through its one
// pallas_call (_run :36), 14 bodies (:44-:310) asking whether Mosaic lowers
// reshapes, slices, transposes and per-head views.  On Hopper a view is a
// shape and strides, so the bodies reduce to three kernels that take any
// strided view of up to 5 dimensions:
//   gram_tc_kernel    out = a . a^T in float32 for a (rows, cols) view of
//                     float32 or bf16 (the rows are the view's leading
//                     dimensions): reshape_col, reshape_row,
//                     sliced_block_dot, bf16_dot.  out is symmetric, so a
//                     block computes one 32 x 32 tile (i, j) with i <= j
//                     and writes it to out[i, j] and, transposed, to
//                     out[j, i] from the same sums (a diagonal tile writes
//                     each pair from the one at or above its diagonal):
//                     out equals out^T bit for bit, and at 256 rows 36
//                     blocks run where 64 tiles exist.  32-row tiles, not
//                     64: at the probes' (256, 64) the call is its launch
//                     and its loads' latency, and 36 blocks of a quarter
//                     of the work each finish sooner than 10 big ones.
//                     The products run on the tensor cores (mma.sync),
//                     four warps a block, each a 16 x 16 quarter of the
//                     tile, in a fixed order (repeated calls agree bit for
//                     bit):
//                     - bf16: m16n8k16 with float32 sums, the exact
//                       products of the JAX body's
//                       preferred_element_type=f32, on lane_hopper.cuh's
//                       swizzled tiles and ldmatrix fragments;
//                     - float32: 3xTF32, a = hi + lo with hi = tf32(a) and
//                       lo = tf32(a - hi) (round to nearest, ties away:
//                       probes/mosaic.py:tf32_round), and a . a^T as
//                       lo . hi^T + hi . lo^T + hi . hi^T on m16n8k8 .tf32,
//                       within ~2^-21 of float32 where one TF32 pass
//                       (~2^-11) misses the JAX probe's 1e-3 at D = 64.
//                     A view whose rows fold to one stride with a
//                     contiguous contraction (probes/mosaic.py:
//                     gram_operands; all four bodies: (256, 64), stride 64)
//                     is staged by 16-byte cp.async copies, 64 columns at a
//                     time; any other view one element a thread;
//   view_copy_kernel  dst = dtype(scale * src), or dtype(dst + scale * src)
//                     with accumulate, between two views of one shape:
//                     transpose, split, concat0, concat1,
//                     write_strided_slice (with its read-modify-write),
//                     transpose_full, merge_full, head_slice_bf16.  The
//                     wrapper folds the views (probes/mosaic.py:
//                     fold_views) and hands over one packed descriptor;
//                     a thread moves 16 bytes of the innermost run where
//                     both views allow it, else one element;
//   chunk_gram_hopper_kernel (bf16) and chunk_gram_kernel (float32) per
//                     chunk c (rows x D) of a (B, H, W, heads, D) tensor,
//                     o = (c . c^T) . c in float32, written as dtype(o) or
//                     added as dtype(out + dtype(o)) (the TPU body's bf16
//                     `+=`): head_slice_dot_bf16 (row chunks) and
//                     chunked_ref_reads_bf16 (row chunks, then column
//                     chunks added).  The bf16 kernel stages its chunk once
//                     a block, in bf16 with 16-byte loads (a token's D
//                     values are one run), into lane_hopper.cuh's swizzled
//                     tiles; a warp takes 16 rows: S = c_tile . c^T on the
//                     tensor cores (exact products, float32 sums) a 32-row
//                     chunk at a time, then S . c with S split into a bf16
//                     pair (flash::split_product, within ~2^-16 of float32),
//                     so S never leaves registers.  The float32 kernel
//                     stages the chunk again for each block of 32 rows, as
//                     float32, with scalar products.
// The probes' arrays are at most 0.8 MB: every kernel is bound by its launch.
#include <climits>

#include "flash_hopper.cuh"

namespace bft {
namespace {

constexpr int kMaxDims = 5;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(lane::smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A copy between two folded views of one shape, as probes/mosaic.py packs
// it (copy_descriptor): no dimension of size 1, no two adjacent dimensions
// contiguous in both views; every offset below 2^31 elements.
struct CopyDesc {
  int ndim;  // 1 to kMaxDims
  int vec;   // elements a thread moves: 16 bytes of the wider type, or 1
  int src_dtype, dst_dtype;
  int accumulate;
  float scale;
  int shape[kMaxDims];  // shape[ndim - 1] a multiple of vec
  int sstride[kMaxDims], dstride[kMaxDims];  // elements; the innermost 1 where vec > 1
};

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// n vectors of kVec elements: thread e moves vector e % inner of the
// innermost run, whose outer index e / inner is split over the outer
// dimensions by 32-bit divisions by the launch's shapes.  The product and
// sum are rounded one at a time (no fused multiply-add), as the plain
// version's float32 operations are.
template <typename S, typename D, int kVec>
__global__ void __launch_bounds__(256) view_copy_kernel(const S* __restrict__ src,
                                                        D* __restrict__ dst,
                                                        const __grid_constant__ CopyDesc c,
                                                        int n) {
  const int last = c.ndim - 1, inner = c.shape[last] / kVec;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
    int o = e / inner;
    const int i = (e - o * inner) * kVec;
    int so = i * c.sstride[last], d_o = i * c.dstride[last];
#pragma unroll
    for (int k = kMaxDims - 2; k >= 0; --k) {
      if (k < last) {
        const int q = o / c.shape[k];
        const int idx = o - q * c.shape[k];
        so += idx * c.sstride[k];
        d_o += idx * c.dstride[k];
        o = q;
      }
    }
    const Pack<S, kVec> a = *reinterpret_cast<const Pack<S, kVec>*>(src + so);
    Pack<D, kVec> r;
    if (c.accumulate) r = *reinterpret_cast<const Pack<D, kVec>*>(dst + d_o);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float v = __fmul_rn(to_f32(a.v[j]), c.scale);
      if (c.accumulate) v = __fadd_rn(to_f32(r.v[j]), v);
      r.v[j] = from_f32<D>(v);
    }
    *reinterpret_cast<Pack<D, kVec>*>(dst + d_o) = r;
  }
}

// ------------------------------------------------------------------ gram

constexpr int kGramTile = 32;     // rows (and columns) of an output tile
constexpr int kGramCols = 64;     // columns of a staged chunk of the operands
constexpr int kGramThreads = 128;  // 4 warps: a 16 x 16 quarter of the tile each
constexpr int kGramRowDims = kMaxDims - 1;
// The most rows a launch takes (as the first kernel's grid allowed).
constexpr int kMaxGramRows = 65535 * 32;

// A Gram operand: element (r, k) at row_offset(r) + k * col_stride, the row
// index r split over row_dims dimensions (row-major; one for a view whose
// rows fold to one stride).
struct GramView {
  int rows, cols, row_dims;
  int row_shape[kGramRowDims];
  long long row_stride[kGramRowDims];
  long long col_stride;
};

__device__ __forceinline__ long long gram_row_offset(const GramView& v, int r) {
  if (v.row_dims == 1) return r * v.row_stride[0];
  long long off = 0;
#pragma unroll
  for (int i = kGramRowDims - 1; i >= 0; --i) {  // unrolled: v stays in parameter space
    if (i < v.row_dims) {
      const int q = r / v.row_shape[i];
      off += (r - q * v.row_shape[i]) * v.row_stride[i];
      r = q;
    }
  }
  return off;
}

// A staged operand tile: kGramTile rows of kGramCols columns.  float32 rows
// are padded to 68 values, so the 8 rows x 4 columns of a TF32 fragment hit
// 32 different banks; bf16 rows are lane_hopper.cuh's swizzled 64-wide rows
// (ldmatrix conflict-free).
template <typename T>
struct GramTile;
template <>
struct GramTile<float> {
  static constexpr int kStride = kGramCols + 4;
  static constexpr int kElems = kGramTile * kStride;
  __device__ static int at(int r, int c) { return r * kStride + c; }
};
template <>
struct GramTile<__nv_bfloat16> {
  static constexpr int kElems = kGramTile * kGramCols;
  __device__ static int at(int r, int c) { return lane::sw<kGramCols>(r, c); }
};

// Rows r0 .. r0 + 31 and columns k0 .. k0 + 63 of the operand into a tile,
// zero past its rows and columns: 16-byte cp.async copies with kVec (a row
// stride and cols multiples of 16 bytes, col_stride 1, a aligned), else one
// element a thread.  The caller waits for the copies.
template <typename T, bool kVec>
__device__ __forceinline__ void gram_stage(T* tile, const T* __restrict__ a, const GramView& v,
                                           int r0, int k0) {
  if constexpr (kVec) {
    constexpr int kV = 16 / sizeof(T), kChunks = kGramCols / kV;
    for (int e = threadIdx.x; e < kGramTile * kChunks; e += kGramThreads) {
      const int r = e / kChunks, c = (e % kChunks) * kV;
      T* dst = tile + GramTile<T>::at(r, c);
      if (r0 + r < v.rows && k0 + c < v.cols)
        cp_async16(dst, a + (long long)(r0 + r) * v.row_stride[0] + k0 + c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int e = threadIdx.x; e < kGramTile * kGramCols; e += kGramThreads) {
      const int r = e / kGramCols, c = e % kGramCols;
      const bool in = r0 + r < v.rows && k0 + c < v.cols;
      tile[GramTile<T>::at(r, c)] =
          in ? a[gram_row_offset(v, r0 + r) + (k0 + c) * v.col_stride] : from_f32<T>(0.f);
    }
  }
}

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero
// (cvt.rna's rounding; probes/mosaic.py:tf32_round), as a float32 bit
// pattern whose 13 low bits are zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a b on the tensor cores: a 16x8 TF32 (row), b 8x8 TF32 (col), c f32.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nt] (rows r0 .. r0 + 15 of tile A, columns n0 + 8 nt .. + 7: rows of
// tile B) += over the chunk's 64 columns.  float32: per 8-deep step the
// small products first, lo . hi^T, hi . lo^T, then hi . hi^T.
__device__ __forceinline__ void gram_products(float (&acc)[2][4], const float* As,
                                              const float* Bs, int r0, int n0, int lane_id) {
  constexpr int S = GramTile<float>::kStride;
  const int g = lane_id >> 2, t = lane_id & 3;
#pragma unroll
  for (int k = 0; k < kGramCols; k += 8) {
    uint32_t ah[4], al[4];
    const float* ar = As + (r0 + g) * S + k + t;
    tf32_split(ar[0], ah[0], al[0]);
    tf32_split(ar[8 * S], ah[1], al[1]);
    tf32_split(ar[4], ah[2], al[2]);
    tf32_split(ar[8 * S + 4], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float* br = Bs + (n0 + 8 * nt + g) * S + k + t;
      uint32_t bh0, bl0, bh1, bl1;
      tf32_split(br[0], bh0, bl0);
      tf32_split(br[4], bh1, bl1);
      mma_tf32(acc[nt], al, bh0, bh1);
      mma_tf32(acc[nt], ah, bl0, bl1);
      mma_tf32(acc[nt], ah, bh0, bh1);
    }
  }
}

__device__ __forceinline__ void gram_products(float (&acc)[2][4], const __nv_bfloat16* As,
                                              const __nv_bfloat16* Bs, int r0, int n0,
                                              int lane_id) {
  uint32_t a[kGramCols / 16][4];
  lane::load_a_rows<kGramCols>(a, As, r0, lane_id);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    uint32_t b[kGramCols / 16][2];
    lane::load_b_rows<kGramCols>(b, Bs, n0 + 8 * nt, lane_id);
#pragma unroll
    for (int k = 0; k < kGramCols / 16; ++k) lane::mma(acc[nt], a[k], b[k][0], b[k][1]);
  }
}

// Grid (T (T + 1) / 2), T = ceil(rows / 32), kGramThreads threads: block p
// the tile (ti, tj), ti <= tj, p = tj (tj + 1) / 2 + ti, of out[i, j] =
// sum_k a(i, k) a(j, k).  The operands' 32-row tiles are staged 64 columns
// at a time (a diagonal tile stages one); warp w sums rows 16 (w / 2) and
// columns 16 (w % 2) of the tile (on a diagonal tile the warp below the
// diagonal idles); the sums go through shared memory to coalesced stores of
// out[i, j] and out[j, i].
template <typename T, bool kVec>
__global__ void __launch_bounds__(kGramThreads) gram_tc_kernel(const T* __restrict__ a,
                                                               const GramView v,
                                                               float* __restrict__ out) {
  constexpr int kOut = kGramTile + 1;  // floats a row of the staged sums
  constexpr size_t kBytes = 2 * GramTile<T>::kElems * sizeof(T) > kGramTile * kOut * 4
                                ? 2 * GramTile<T>::kElems * sizeof(T)
                                : kGramTile * kOut * 4;
  __shared__ __align__(16) unsigned char smem[kBytes];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + GramTile<T>::kElems;
  float* Cs = reinterpret_cast<float*>(smem);
  const long long p = blockIdx.x;
  long long tj = static_cast<long long>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
  while (tj * (tj + 1) / 2 > p) --tj;
  while ((tj + 1) * (tj + 2) / 2 <= p) ++tj;
  const int ti = static_cast<int>(p - tj * (tj + 1) / 2);
  const bool diag = ti == tj;
  const int i0 = ti * kGramTile, j0 = static_cast<int>(tj) * kGramTile;
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const bool active = !(diag && wm > wn);
  float acc[2][4] = {};
  for (int k0 = 0; k0 < v.cols; k0 += kGramCols) {
    if (k0) __syncthreads();  // the previous chunk's fragments are read
    gram_stage<T, kVec>(As, a, v, i0, k0);
    if (!diag) gram_stage<T, kVec>(Bs, a, v, j0, k0);
    if constexpr (kVec) cp_async_wait_all();
    __syncthreads();
    if (active) gram_products(acc, As, diag ? As : Bs, 16 * wm, 16 * wn, lane_id);
  }
  __syncthreads();  // Cs reuses the operands' shared memory
  if (active) {
    const int g = lane_id >> 2, t = lane_id & 3;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        Cs[(16 * wm + g + 8 * (e >> 1)) * kOut + 16 * wn + 8 * nt + 2 * t + (e & 1)] = acc[nt][e];
  }
  __syncthreads();
  const int rows = v.rows;
  for (int e = threadIdx.x; e < kGramTile * kGramTile; e += kGramThreads) {
    const int r = e / kGramTile, c = e % kGramTile;
    if (diag) {
      if (i0 + r < rows && i0 + c < rows)
        out[(size_t)(i0 + r) * rows + i0 + c] = r <= c ? Cs[r * kOut + c] : Cs[c * kOut + r];
      continue;
    }
    if (i0 + r < rows && j0 + c < rows) out[(size_t)(i0 + r) * rows + j0 + c] = Cs[r * kOut + c];
    if (j0 + r < rows && i0 + c < rows) out[(size_t)(j0 + r) * rows + i0 + c] = Cs[c * kOut + r];
  }
}

// One chunk of R rows of D values: the chunk's element (r, dd) lies at
// base + r1 * s1 + r2 * s2 + dd * sd, r = r1 * n2 + r2, in x and in out alike.
struct Chunks {
  int n1, n2, D;
  long long s1, s2, sd;
  long long chunk_stride;  // between chunks
  long long b_stride, h_stride;
  int heads;
};

constexpr int kGramRowTile = 32;

__host__ __device__ size_t chunk_gram_smem(int R, int D) {
  return sizeof(float) * ((size_t)R * (D + 1) + (size_t)kGramRowTile * R);
}

// Grid (ceil(R / 32), chunks, B * heads), 256 threads: rows [32 t, 32 t + 32)
// of o = (c . c^T) . c for one chunk; the whole chunk c (float32) and the 32
// rows of s = c . c^T in shared memory.
template <typename T>
__global__ void __launch_bounds__(256) chunk_gram_kernel(const T* __restrict__ x,
                                                         T* __restrict__ out, Chunks g,
                                                         int accumulate) {
  extern __shared__ float sm[];
  const int R = g.n1 * g.n2, D = g.D, DP = D + 1;
  const int i0 = blockIdx.x * kGramRowTile;
  const int b = blockIdx.z / g.heads, h = blockIdx.z % g.heads;
  const long long base = blockIdx.y * g.chunk_stride + b * g.b_stride + h * g.h_stride;
  auto at = [&](int r, int dd) {
    return base + (long long)(r / g.n2) * g.s1 + (long long)(r % g.n2) * g.s2 + dd * g.sd;
  };
  float* c = sm;
  float* s = sm + (size_t)R * DP;
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int r = e / D, dd = e % D;
    c[r * DP + dd] = to_f32(x[at(r, dd)]);
  }
  __syncthreads();
  const int tr = min(kGramRowTile, R - i0);
  for (int j = threadIdx.x; j < R; j += blockDim.x)
    for (int ii = 0; ii < tr; ++ii) {
      float acc = 0.f;
      for (int dd = 0; dd < D; ++dd) acc += c[(i0 + ii) * DP + dd] * c[j * DP + dd];
      s[ii * R + j] = acc;
    }
  __syncthreads();
  for (int e = threadIdx.x; e < tr * D; e += blockDim.x) {
    const int ii = e / D, dd = e % D;
    float acc = 0.f;
    for (int j = 0; j < R; ++j) acc += s[ii * R + j] * c[j * DP + dd];
    const long long o = at(i0 + ii, dd);
    out[o] = accumulate ? from_f32<T>(to_f32(out[o]) + round_to<T>(acc)) : from_f32<T>(acc);
  }
}

constexpr int kGramWarps = 4;  // 16-row tiles a block of chunk_gram_hopper_kernel

// Grid (ceil(R / 64), chunks, B * heads), kGramWarps warps: the chunk (R
// rows of D, zero past R) staged once into a swizzled bf16 tile; warp w
// takes rows 16 (4 blockIdx.x + w) .. + 15 of o = (c . c^T) . c, S a 32-row
// chunk at a time on the tensor cores, S . c with S as a bf16 pair; o
// written as bf16(o) or added as bf16(out + bf16(o)).  vec: 16-byte loads
// and 4-byte stores (x and out aligned, every stride a multiple of 8).
template <int D>
__global__ void __launch_bounds__(kGramWarps * 32) chunk_gram_hopper_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out, Chunks g,
    int accumulate, int vec) {
  using lane::bf16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* cs = reinterpret_cast<bf16*>(smem);
  const int R = g.n1 * g.n2, rows = lane::staged_rows(R);
  const int b = blockIdx.z / g.heads, h = blockIdx.z % g.heads;
  const long long base = blockIdx.y * g.chunk_stride + b * g.b_stride + h * g.h_stride;
  auto at = [&](int r, int dd) {
    return base + (long long)(r / g.n2) * g.s1 + (long long)(r % g.n2) * g.s2 + dd * g.sd;
  };
  if (vec) {
    for (int e = threadIdx.x; e < rows * (D / 8); e += blockDim.x) {
      const int r = e / (D / 8), c8 = e % (D / 8) * 8;
      *reinterpret_cast<uint4*>(cs + lane::sw<D>(r, c8)) =
          r < R ? lane::ldg16(x + at(r, c8)) : make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
      const int r = e / D, dd = e % D;
      cs[lane::sw<D>(r, dd)] = r < R ? x[at(r, dd)] : __float2bfloat16(0.f);
    }
  }
  __syncthreads();
  const int lane_id = threadIdx.x & 31, i0 = (blockIdx.x * kGramWarps + (threadIdx.x >> 5)) * 16;
  if (i0 >= R) return;
  uint32_t a[D / 16][4];
  lane::load_a_rows<D>(a, cs, i0, lane_id);
  float o[D / 8][4] = {};
  for (int k0 = 0; k0 < rows; k0 += lane::kChunk) {
    float s[4][4];
    lane::rows_product<D>(s, a, cs, k0, lane_id);
    flash::split_product<D>(o, s, cs, k0, lane_id);
  }
  const int gr = lane_id >> 2, t = lane_id & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + gr + 8 * r;
    if (i >= R) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const long long off = at(i, n * 8 + 2 * t);
      float v0 = o[n][2 * r], v1 = o[n][2 * r + 1];
      if (vec) {
        uint32_t* p = reinterpret_cast<uint32_t*>(out + off);
        if (accumulate) {
          const float2 old = lane::unpack(*p), add = lane::unpack(lane::pack(v0, v1));
          v0 = old.x + add.x;
          v1 = old.y + add.y;
        }
        *p = lane::pack(v0, v1);
      } else {
        __nv_bfloat16* p0 = out + off;
        __nv_bfloat16* p1 = out + off + g.sd;
        if (accumulate) {
          v0 = __bfloat162float(*p0) + round_to<__nv_bfloat16>(v0);
          v1 = __bfloat162float(*p1) + round_to<__nv_bfloat16>(v1);
        }
        *p0 = __float2bfloat16(v0);
        *p1 = __float2bfloat16(v1);
      }
    }
  }
}

// The chunks of bf_probe_chunk_gram's arguments; false where they do not
// describe chunks (axis 1 or 2, a chunk length dividing that axis).
bool make_chunks(const long long* shape, const long long* stride, int axis, int chunk,
                 Chunks* g) {
  if ((axis != 1 && axis != 2) || chunk < 1 || shape[axis] % chunk) return false;
  g->n1 = axis == 1 ? chunk : (int)shape[1];
  g->n2 = axis == 1 ? (int)shape[2] : chunk;
  g->D = (int)shape[4];
  g->s1 = stride[1];
  g->s2 = stride[2];
  g->sd = stride[4];
  g->chunk_stride = chunk * stride[axis];
  g->b_stride = stride[0];
  g->h_stride = stride[3];
  g->heads = (int)shape[3];
  const long long groups = shape[0] * shape[3], nchunks = shape[axis] / chunk;
  return g->n1 * g->n2 >= 1 && g->D >= 1 && groups >= 1 && groups <= 65535 && nchunks <= 65535;
}

template <typename T>
int run_gram(const void* a, const GramView& v, bool vec, float* out, cudaStream_t stream) {
  const long long tiles = (v.rows + kGramTile - 1) / kGramTile;
  const unsigned blocks = static_cast<unsigned>(tiles * (tiles + 1) / 2);
  const T* x = static_cast<const T*>(a);
  if (vec)
    gram_tc_kernel<T, true><<<blocks, kGramThreads, 0, stream>>>(x, v, out);
  else
    gram_tc_kernel<T, false><<<blocks, kGramThreads, 0, stream>>>(x, v, out);
  return cudaGetLastError();
}

int launch_gram(int dtype, const void* a, const GramView& v, bool vec, float* out, void* stream) {
  if (v.rows < 1 || v.cols < 1 || v.rows > kMaxGramRows) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return run_gram<float>(a, v, vec, out, s);
  if (dtype == kBF16) return run_gram<__nv_bfloat16>(a, v, vec, out, s);
  return cudaErrorInvalidValue;
}

int grid_for(long long n) {
  const long long blocks = (n + 255) / 256;
  return static_cast<int>(blocks < 65535 ? blocks : 65535);
}

template <typename S, typename D>
int run_view_copy(const CopyDesc& c, const void* src, void* dst, int n, cudaStream_t stream) {
  constexpr int kWide = 16 / (sizeof(S) > sizeof(D) ? sizeof(S) : sizeof(D));
  const S* s = static_cast<const S*>(src);
  D* d = static_cast<D*>(dst);
  if (c.vec == kWide)
    view_copy_kernel<S, D, kWide><<<grid_for(n), 256, 0, stream>>>(s, d, c, n);
  else if (c.vec == 1)
    view_copy_kernel<S, D, 1><<<grid_for(n), 256, 0, stream>>>(s, d, c, n);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace
}  // namespace bft

// dst = dst_dtype(scale * src), or dst_dtype(dst + scale * src) with
// accumulate, over two views of one shape described by desc, a host
// CopyDesc (src and dst point at the views' first elements, each aligned to
// the desc's vectors).  Returns a cudaError_t.
extern "C" int bf_probe_view_copy(const void* desc, const void* src, void* dst, void* stream) {
  using namespace bft;
  const CopyDesc& c = *static_cast<const CopyDesc*>(desc);
  if (c.ndim < 1 || c.ndim > kMaxDims || c.vec < 1) return cudaErrorInvalidValue;
  long long n = 1;
  for (int i = 0; i < c.ndim; ++i) n *= c.shape[i];
  if (n < 1 || n > INT_MAX || c.shape[c.ndim - 1] % c.vec) return cudaErrorInvalidValue;
  const int nv = static_cast<int>(n / c.vec);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (c.src_dtype == kF32 && c.dst_dtype == kF32)
    return run_view_copy<float, float>(c, src, dst, nv, s);
  if (c.src_dtype == kF32 && c.dst_dtype == kBF16)
    return run_view_copy<float, bf16>(c, src, dst, nv, s);
  if (c.src_dtype == kBF16 && c.dst_dtype == kF32)
    return run_view_copy<bf16, float>(c, src, dst, nv, s);
  if (c.src_dtype == kBF16 && c.dst_dtype == kBF16)
    return run_view_copy<bf16, bf16>(c, src, dst, nv, s);
  return cudaErrorInvalidValue;
}

// out (rows, rows) float32 = a . a^T for the 2-D view a whose element (r,
// k) lies at a + r * row_stride + k * col_stride (elements).  vec: 16-byte
// copies (probes/mosaic.py:gram_operands), refused unless col_stride is 1,
// cols and row_stride are multiples of 16 bytes and a is 16-byte aligned.
// Returns a cudaError_t.
extern "C" int bf_probe_gram(int dtype, const void* a, int rows, int cols, long long row_stride,
                             long long col_stride, int vec, float* out, void* stream) {
  using namespace bft;
  GramView v{};
  v.rows = rows;
  v.cols = cols;
  v.row_dims = 1;
  v.row_shape[0] = rows;
  v.row_stride[0] = row_stride;
  v.col_stride = col_stride;
  if (vec) {
    const int kv = 16 / (dtype == kF32 ? 4 : 2);
    if (col_stride != 1 || cols % kv || row_stride % kv || reinterpret_cast<uintptr_t>(a) % 16)
      return cudaErrorInvalidValue;
  }
  return launch_gram(dtype, a, v, vec != 0, out, stream);
}

// As bf_probe_gram for any view of 2 to 5 dimensions (shape and strides in
// elements, host arrays of ndim; the last dimension is the contraction, the
// others the rows), one element a thread.  Returns a cudaError_t.
extern "C" int bf_probe_gram_view(int dtype, const void* a, const long long* shape,
                                  const long long* stride, int ndim, float* out, void* stream) {
  using namespace bft;
  if (ndim < 2 || ndim > kMaxDims) return cudaErrorInvalidValue;
  GramView v{};
  long long rows = 1;
  for (int i = 0; i < ndim - 1; ++i) {
    rows *= shape[i];
    v.row_shape[i] = static_cast<int>(shape[i]);
    v.row_stride[i] = stride[i];
  }
  if (rows > kMaxGramRows || shape[ndim - 1] > INT_MAX) return cudaErrorInvalidValue;
  v.rows = static_cast<int>(rows);
  v.cols = static_cast<int>(shape[ndim - 1]);
  v.row_dims = ndim - 1;
  v.col_stride = stride[ndim - 1];
  return launch_gram(dtype, a, v, false, out, stream);
}

// float32 (chunk_gram_kernel): x and out (B, H, W, heads, D) with the same
// strides (stride, host array of 5): for each (b, head) and each of the
// nchunks chunks of `chunk` rows (axis 1) or columns (axis 2), o = (c . c^T)
// . c in float32 over the chunk's rows (its (row, column) positions in
// raster order), written as o or, with accumulate, added to out.  A chunk's
// c and 32 rows of c . c^T must fit in 227 KB of shared memory.  Returns a
// cudaError_t.
extern "C" int bf_probe_chunk_gram(const float* x, float* out, const long long* shape,
                                   const long long* stride, int axis, int chunk, int accumulate,
                                   void* stream) {
  using namespace bft;
  Chunks g{};
  if (!make_chunks(shape, stride, axis, chunk, &g)) return cudaErrorInvalidValue;
  const int R = g.n1 * g.n2;
  const size_t smem = chunk_gram_smem(R, g.D);
  if (smem > 232448) return cudaErrorInvalidValue;
  const dim3 grid((R + kGramRowTile - 1) / kGramRowTile, (unsigned)(shape[axis] / chunk),
                  (unsigned)(shape[0] * shape[3]));
  cudaError_t e = cudaFuncSetAttribute(chunk_gram_kernel<float>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  chunk_gram_kernel<float><<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, g, accumulate);
  return cudaGetLastError();
}

// bf16 (chunk_gram_hopper_kernel): as bf_probe_chunk_gram, x and out bf16,
// o written as bf16(o) or added as bf16(out + bf16(o)).  head_dim (the last
// dim) 16 or 64, a chunk's rows (rounded up to 32) within 227 KB of shared
// memory.  Returns a cudaError_t.
extern "C" int bf_probe_chunk_gram_hopper(int head_dim, const void* x, void* out,
                                          const long long* shape, const long long* stride,
                                          int axis, int chunk, int accumulate, void* stream) {
  using namespace bft;
  Chunks g{};
  if ((head_dim != 16 && head_dim != 64) || shape[4] != head_dim ||
      !make_chunks(shape, stride, axis, chunk, &g))
    return cudaErrorInvalidValue;
  const int R = g.n1 * g.n2;
  const size_t smem = (size_t)lane::staged_rows(R) * head_dim * sizeof(__nv_bfloat16);
  if (smem > 232448) return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  const int vec = ptrs % 16 == 0 && g.sd == 1 && g.s1 % 8 == 0 && g.s2 % 8 == 0 &&
                  g.chunk_stride % 8 == 0 && g.b_stride % 8 == 0 && g.h_stride % 8 == 0;
  const dim3 grid((R + 16 * kGramWarps - 1) / (16 * kGramWarps), (unsigned)(shape[axis] / chunk),
                  (unsigned)(shape[0] * shape[3]));
  const auto kernel =
      head_dim == 64 ? chunk_gram_hopper_kernel<64> : chunk_gram_hopper_kernel<16>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kGramWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), g, accumulate,
      vec);
  return cudaGetLastError();
}
