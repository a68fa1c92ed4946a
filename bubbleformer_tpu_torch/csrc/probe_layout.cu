// P4: the layout probes, hand-written for Hopper (sm_90a).
//
// Replaces the kernels that scripts/probe_mosaic.py runs through its one
// pallas_call (_run :36), 14 bodies (:44-:310) asking whether Mosaic lowers
// reshapes, slices, transposes and per-head views.  On Hopper a view is a
// shape and strides, so the bodies reduce to three kernels that take any
// strided view of up to 5 dimensions:
//   gram_kernel       out = a . a^T in float32 for a (rows, cols) view of
//                     float32 or bf16 (the rows are the view's leading
//                     dimensions): reshape_col, reshape_row,
//                     sliced_block_dot, bf16_dot;
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

struct View {
  long long shape[kMaxDims];
  long long stride[kMaxDims];
  int ndim;
};

// Offset of the e-th element (row-major over the shape) of a view.
__device__ __forceinline__ long long view_offset(const View& v, long long e) {
  long long off = 0;
  for (int i = v.ndim - 1; i >= 0; --i) {
    off += (e % v.shape[i]) * v.stride[i];
    e /= v.shape[i];
  }
  return off;
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

// Grid (ceil(rows / 32), ceil(rows / 32)), 256 threads: a 32 x 32 tile of
// out[i, j] = sum_k a(i, k) a(j, k), a(r, k) the view's element r * cols + k.
template <typename T>
__global__ void __launch_bounds__(256) gram_kernel(const T* __restrict__ a, View v, int rows,
                                                   int cols, float* __restrict__ out) {
  __shared__ float As[32][33];
  __shared__ float Bs[32][33];
  const int i0 = blockIdx.y * 32, j0 = blockIdx.x * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < cols; k0 += 32) {
    for (int e = threadIdx.x; e < 32 * 32; e += 256) {
      const int r = e / 32, kk = e % 32, k = k0 + kk;
      As[r][kk] = i0 + r < rows && k < cols ? to_f32(a[view_offset(v, (long long)(i0 + r) * cols + k)]) : 0.f;
      Bs[r][kk] = j0 + r < rows && k < cols ? to_f32(a[view_offset(v, (long long)(j0 + r) * cols + k)]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < 32; ++kk) {
      const float b = Bs[tx][kk];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] += As[ty + 8 * u][kk] * b;
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty + 8 * u, j = j0 + tx;
    if (i < rows && j < rows) out[(size_t)i * rows + j] = acc[u];
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

View make_view(const long long* shape, const long long* stride, int ndim) {
  View v{};
  v.ndim = ndim;
  for (int i = 0; i < ndim; ++i) {
    v.shape[i] = shape[i];
    v.stride[i] = stride[i];
  }
  return v;
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

// out (rows, rows) float32 = a . a^T for the view a (shape and strides as for
// bf_probe_view_copy; its last dimension is the contraction, the others are
// the rows).  Returns a cudaError_t.
extern "C" int bf_probe_gram(int dtype, const void* a, const long long* stride,
                             const long long* shape, int ndim, float* out, void* stream) {
  using namespace bft;
  if (ndim < 2 || ndim > kMaxDims) return cudaErrorInvalidValue;
  long long rows = 1;
  for (int i = 0; i < ndim - 1; ++i) rows *= shape[i];
  const long long cols = shape[ndim - 1];
  if (rows < 1 || cols < 1 || rows > 65535LL * 32 || cols > 2147483647LL)
    return cudaErrorInvalidValue;
  const View v = make_view(shape, stride, ndim);
  const dim3 grid((rows + 31) / 32, (rows + 31) / 32);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    gram_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(a), v, (int)rows,
                                            (int)cols, out);
  else if (dtype == kBF16)
    gram_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(a), v,
                                                    (int)rows, (int)cols, out);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
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
