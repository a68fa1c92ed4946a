// P1: the lane-roll axial attention probe, hand-written for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of scripts/probe_lane_axial.py:
//   (a) probe_within_roll's kernel (pallas_call :86, helper _within_roll :62):
//       a circular roll by r within each block of lanes of a (rows, total)
//       slab, rows (block W, r = 5) and columns (block H*W, r = 3W) into two
//       outputs, o[.., g*block + w] = x[.., g*block + (w + r) % block].
//       Bound by its bytes (one read, two writes; 48 KB at the probe's (16,
//       512) float32 slab, 0.0000147 ms in bf16): the launch and one load's
//       latency are the cost.  One launch writes both rolls, into one (2,
//       rows, total) buffer.  within_roll_vec_kernel: a block takes a run of
//       rows, stages each once into shared memory by 16-byte cp.async copies,
//       then writes both rolls from there, 16 bytes a thread and output; a
//       vector's source lanes come from one % (its first lane's place in its
//       block, or a mask where the block is a power of two), the next lanes
//       by a wrap test, so any block size b dividing total and any 0 <= r <
//       b.  Rows that are not a multiple of 16 bytes, misaligned bases and
//       rows past 48 KB (probes/lane_axial.py:within_roll_operands) take
//       within_roll_kernel: one element a thread of both outputs, read from
//       device memory.
//   (b) bench_core's kernel (pallas_call :193, body _core_kernel :104): per
//       frame of channel-major q (BT, C, N) and kv (BT, 2C, N), N = H*W, the
//       row and the column attention over all W (H) circular offsets of a
//       line.  For query position p of head h and key (i + r) mod L of its
//       line, logit = sum_d q k * d^-1/2 + table[r*heads + h, p]; softmax in
//       float32; o = s_c pv + (1 - s_c) mean_line(v), s_c per channel
//       (sc (C, 2): rows | columns); out = dtype((o_row + o_col) / 2).
//       The TPU kernel rolled whole lane slabs (one offset at a time, VPU
//       only).  Here every query meets its L keys directly, so no roll
//       exists.  Bound at the probe's shape (BT = 20, C = 384, 32 x 32
//       tokens) by its 64 MB of q, kv, tables and out (0.019 ms at 3.35
//       TB/s); the attention is 2 GFLOP.  Two kernels:
//       - bfloat16, core_kernel (built from lane_hopper.cuh's mma.sync
//         fragments; P1b's Hopper design): a block owns a band of up to 8
//         adjacent lines of one head over a run of frames, a warp a
//         16-query tile.
//         * Channel-major staging: a band of 8 columns makes each (channel,
//           token) one 16-byte run; cp.async copies the next frame's raw
//           slab while this frame computes, then a thread transposes 8
//           channels of 8 positions in registers (transpose8) into the
//           swizzled (token, d) tiles the fragments read.
//         * Tables: each line's (query, key) slice of its offset table is
//           staged once a block (the frames share it) in (i, j) order
//           (probes/lane_axial.py:line_table is the map), read by
//           lane::logits<D> with a row stride of L + 1.
//         * P stays float32: normalised exactly (one chunk of 32 keys keeps
//           its logits; longer lines pass the chunks twice) and split into a
//           bf16 pair for P v (core_pv), within ~2^-16 of float32; mean(v)
//           is a ones row times v on the tensor cores (float32 sums).
//         * The directions: the column pass runs first and keeps its o in a
//           float32 scratch laid out by column band, (BT, heads, W / 8, D,
//           H, 8), which it writes and the row pass reads in runs of 256
//           bytes or more; the row pass adds it, halves and rounds once,
//           writing out in runs along the rows (addition commutes: the TPU
//           kernel's (o_row + o_col) / 2 exactly), and takes the frames in
//           reverse order to start on those still in L2.  The scratch (31.5
//           MB) costs one write and one read between the launches.
//         Head dims 16 and 64, lines of 1 to MAX_LINE = 128 tokens; the
//         16-byte path where W is a multiple of 8 and a column band holds 8
//         lines, else one element a thread and the scratch as (BT, C, N).
//       - float32, lane_core_kernel: a block of 256 threads owns one (line,
//         head, frame); q, k, v as float32 in shared memory, one element a
//         thread, the logits and P v as scalar loops; the row pass writes
//         o_row in float32 scratch and the column pass adds it and rounds.
#include <algorithm>
#include <cmath>

#include "lane_hopper.cuh"

namespace bft {
namespace {

constexpr int kLaneThreads = 256;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(lane::smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Both rolls of a P1a call, as probes/lane_axial.py:within_roll_plan packs
// them: x (rows, total) of dtype; roll i by r_i in blocks of b_i lanes; vec
// 1 for within_roll_vec_kernel, 0 for within_roll_kernel.
struct RollDesc {
  int dtype, rows, total, r1, b1, r2, b2, vec;
};

// Bytes of x a block of within_roll_vec_kernel stages at most.
constexpr int kRollSmem = 48 * 1024;
constexpr int kRollThreads = 256;

template <typename T>
struct alignas(16) Vec16 {
  T v[16 / sizeof(T)];
};

// Lane l's place in its block of b lanes.
__device__ __forceinline__ int roll_place(int l, int b) {
  return (b & (b - 1)) == 0 ? l & (b - 1) : l % b;
}

// One element a thread: o1 = out[0], o2 = out[1] (rows * total apart).
template <typename T>
__global__ void within_roll_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
                                   int total, int r1, int b1, int r2, int b2) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int l = static_cast<int>(e % total);
    const long long row = e - l;
    int w = roll_place(l, b1), s = w + r1;
    out[e] = x[row + l - w + (s >= b1 ? s - b1 : s)];
    w = roll_place(l, b2);
    s = w + r2;
    out[n + e] = x[row + l - w + (s >= b2 ? s - b2 : s)];
  }
}

// The 16 bytes of lanes l, l + 1, .. of one roll of a staged row xr.
template <typename T>
__device__ __forceinline__ Vec16<T> roll_vector(const T* xr, int l, int r, int b) {
  int w = roll_place(l, b), g = l - w, s = w + r;
  if (s >= b) s -= b;
  Vec16<T> p;
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i) {
    p.v[i] = xr[g + s];
    if (++w == b) {  // the next lane starts the next block
      w = 0;
      g += b;
      s = r;
    } else if (++s == b) {
      s = 0;
    }
  }
  return p;
}

// Grid (ceil(rows / rpb)), kRollThreads threads, rpb * total * sizeof(T)
// bytes of shared memory: rows rpb b .. of x, each staged once, then both
// rolls written from shared memory, a 16-byte vector a thread and output.
// total a multiple of 16 bytes, x and out 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kRollThreads) within_roll_vec_kernel(
    const T* __restrict__ x, T* __restrict__ out, int rows, int total, int rpb, int r1, int b1,
    int r2, int b2) {
  constexpr int kV = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char roll_smem[];
  T* xs = reinterpret_cast<T*>(roll_smem);
  const int row0 = blockIdx.x * rpb, nv = total / kV;
  const int n = min(rpb, rows - row0) * nv;  // vectors of the block's rows
  const size_t base = (size_t)row0 * total;
  for (int e = threadIdx.x; e < n; e += kRollThreads)
    cp_async16(xs + e * kV, x + base + (size_t)e * kV);
  cp_async_wait_all();
  __syncthreads();
  Vec16<T>* o1 = reinterpret_cast<Vec16<T>*>(out + base);
  Vec16<T>* o2 = reinterpret_cast<Vec16<T>*>(out + (size_t)rows * total + base);
  for (int e = threadIdx.x; e < n; e += kRollThreads) {
    const int row = e / nv, l = (e - row * nv) * kV;
    const T* xr = xs + row * total;
    o1[e] = roll_vector(xr, l, r1, b1);
    o2[e] = roll_vector(xr, l, r2, b2);
  }
}

// Grid (lines, heads, BT): rows (kCol = false, H lines of W) or columns (W
// lines of H).  Shared memory: q, k, v of the line (d x L float32 each) and
// the (L, L + 1) logits.
template <typename T, bool kCol>
__global__ void __launch_bounds__(kLaneThreads) lane_core_kernel(
    const T* __restrict__ q, const T* __restrict__ kv, const float* __restrict__ table,
    const float* __restrict__ sc, float* __restrict__ row_out, T* __restrict__ out, int heads,
    int d, int H, int W, float scaling) {
  extern __shared__ float sm[];
  const int line = blockIdx.x, hd = blockIdx.y, f = blockIdx.z;
  const int L = kCol ? H : W, LP = L + 1;
  const int N = H * W, C = heads * d;
  auto pos = [&](int a) { return kCol ? a * W + line : line * W + a; };
  float* qs = sm;
  float* ks = qs + d * L;
  float* vs = ks + d * L;
  float* S = vs + d * L;
  const T* qf = q + ((size_t)f * C + (size_t)hd * d) * N;
  const T* kf = kv + ((size_t)f * 2 * C + (size_t)hd * d) * N;
  const T* vf = kf + (size_t)C * N;
  for (int e = threadIdx.x; e < d * L; e += blockDim.x) {
    const size_t off = (size_t)(e / L) * N + pos(e % L);
    qs[e] = to_f32(qf[off]);
    ks[e] = to_f32(kf[off]);
    vs[e] = to_f32(vf[off]);
  }
  __syncthreads();
  // Logits of query a and key b, at offset r = (b - a) mod L.
  for (int e = threadIdx.x; e < L * L; e += blockDim.x) {
    const int a = e / L, b = e % L;
    float s = 0.f;
    for (int dd = 0; dd < d; ++dd) s += qs[dd * L + a] * ks[dd * L + b];
    const int r = (b - a + L) % L;
    S[a * LP + b] = s * scaling + table[(size_t)(r * heads + hd) * N + pos(a)];
  }
  __syncthreads();
  for (int a = threadIdx.x; a < L; a += blockDim.x) {
    float m = -INFINITY;
    for (int b = 0; b < L; ++b) m = fmaxf(m, S[a * LP + b]);
    float z = 0.f;
    for (int b = 0; b < L; ++b) {
      const float ex = expf(S[a * LP + b] - m);
      S[a * LP + b] = ex;
      z += ex;
    }
    const float inv_z = 1.f / z;
    for (int b = 0; b < L; ++b) S[a * LP + b] *= inv_z;
  }
  __syncthreads();
  const float inv_l = 1.f / L;
  for (int e = threadIdx.x; e < d * L; e += blockDim.x) {
    const int dd = e / L, a = e % L;
    float pv = 0.f, vm = 0.f;
    for (int r = 0; r < L; ++r) {  // keys in the TPU kernel's offset order
      const int b = (a + r) % L;
      const float v = vs[dd * L + b];
      pv += S[a * LP + b] * v;
      vm += v;
    }
    const float s_c = sc[(hd * d + dd) * 2 + (kCol ? 1 : 0)];
    const float o = s_c * pv + (1.f - s_c) * (vm * inv_l);
    const size_t idx = ((size_t)f * C + (size_t)hd * d + dd) * N + pos(a);
    if (kCol)
      out[idx] = from_f32<T>((row_out[idx] + o) * 0.5f);
    else
      row_out[idx] = o;
  }
}

size_t lane_core_smem(int d, int L) { return sizeof(float) * (3 * (size_t)d * L + (size_t)L * (L + 1)); }

template <typename T>
int run_within_roll(const RollDesc& d, const void* x, void* out, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (d.vec) {
    constexpr int kV = 16 / sizeof(T);
    if (d.total % kV || (long long)d.total * sizeof(T) > kRollSmem ||
        (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16)
      return cudaErrorInvalidValue;
    const int row_bytes = d.total * static_cast<int>(sizeof(T));
    const int rpb =
        std::max(1, std::min({d.rows, kRollThreads / (d.total / kV), kRollSmem / row_bytes}));
    within_roll_vec_kernel<T><<<(d.rows + rpb - 1) / rpb, kRollThreads, (size_t)rpb * row_bytes,
                                stream>>>(xp, op, d.rows, d.total, rpb, d.r1, d.b1, d.r2, d.b2);
  } else {
    const long long n = (long long)d.rows * d.total;
    const int blocks = static_cast<int>(std::min<long long>((n + 255) / 256, 65535));
    within_roll_kernel<T><<<blocks, 256, 0, stream>>>(xp, op, n, d.total, d.r1, d.b1, d.r2,
                                                       d.b2);
  }
  return cudaGetLastError();
}

template <typename T>
int run_lane_core(const T* q, const T* kv, const float* bx, const float* by, const float* sc,
                  float* row_out, T* out, int BT, int H, int W, int C, int heads, float scaling,
                  cudaStream_t stream) {
  const int d = C / heads;
  auto rows = lane_core_kernel<T, false>;
  auto cols = lane_core_kernel<T, true>;
  const size_t s_rows = lane_core_smem(d, W), s_cols = lane_core_smem(d, H);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s_rows)) !=
      cudaSuccess)
    return e;
  if ((e = cudaFuncSetAttribute(cols, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s_cols)) !=
      cudaSuccess)
    return e;
  rows<<<dim3(H, heads, BT), kLaneThreads, s_rows, stream>>>(q, kv, bx, sc, row_out, nullptr,
                                                             heads, d, H, W, scaling);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  cols<<<dim3(W, heads, BT), kLaneThreads, s_cols, stream>>>(q, kv, by, sc, row_out, out, heads,
                                                             d, H, W, scaling);
  return cudaGetLastError();
}

}  // namespace

// ------------------------------------------------- P1b in bfloat16 (core_kernel)

namespace core {
namespace {

using lane::bf16;

constexpr int kWarps = 16;  // warps a block at most: a 16-query tile each
constexpr int kBand = 8;    // lines a block where they fit (a 16-byte run of positions)
constexpr size_t kSmemMax = 232448;

struct CoreArgs {
  const bf16* q;       // (BT, C, N), N = H W
  const bf16* kv;      // (BT, 2C, N): k, then v
  const float* table;  // the pass's (L heads, N): bx (rows) or by (columns)
  const float* sc;     // (C, 2): s_c of the rows, of the columns
  float* col_out;      // the column pass's o: (BT, heads, W / 8, D, H, 8) with vec, else (BT, C, N)
  bf16* out;           // (BT, C, N)
  int BT, H, W, C, heads;
  int band;            // lines a block
  int vec;             // 16-byte loads through the raw buffer, both passes (core_vec)
};

// Shared memory of a block of `band` lines of L tokens: each line's q, k, v
// (staged rows x D bf16 each), with vec the raw channel-major slab of the
// next frame (3 D band L bf16), each line's (L, L + 1) table slice and its
// column sums of v.
template <int D>
size_t core_smem(int band, int L, bool vec) {
  const size_t rows = lane::staged_rows(L);
  return (size_t)band * (3 * rows * D * sizeof(bf16) + (vec ? 3 * (size_t)L * D * sizeof(bf16) : 0) +
                         (size_t)L * (L + 1) * 4 + D * 4);
}

// Lines a block for lines of L tokens: at most kBand, a warp a 16-query tile
// (at most kWarps), within the shared memory.
template <int D>
int core_band(int L, bool vec) {
  int band = std::min(kBand, kWarps / ((L + 15) / 16));
  while (band > 1 && core_smem<D>(band, L, vec) > kSmemMax) --band;
  return band;
}

// 8 x 8 bf16 values, x[k] holding row k, transposed in registers: x[e] then
// holds column e (the pair in each word swapped with the next row's).
__device__ __forceinline__ void transpose8(uint4 (&x)[8]) {
  uint32_t w[8][4], t[8][4];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    w[k][0] = x[k].x;
    w[k][1] = x[k].y;
    w[k][2] = x[k].z;
    w[k][3] = x[k].w;
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      t[2 * c][m] = __byte_perm(w[2 * m][c], w[2 * m + 1][c], 0x5410);
      t[2 * c + 1][m] = __byte_perm(w[2 * m][c], w[2 * m + 1][c], 0x7632);
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = make_uint4(t[e][0], t[e][1], t[e][2], t[e][3]);
}

// Row max m and sum z of exp(s - m) (rows g and g + 8 of the tile) after one
// more chunk of logits, exp on ex2.approx (__expf).
__device__ __forceinline__ void core_stats(float (&m)[2], float (&z)[2], const float (&s)[4][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
    const float mn = fmaxf(m[r], lane::quad_max(mx));
    float zt = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) zt += __expf(s[nt][2 * r] - mn) + __expf(s[nt][2 * r + 1] - mn);
    z[r] = z[r] * __expf(m[r] - mn) + lane::quad_sum(zt);
    m[r] = mn;
  }
}

// o (16 x D) += p (16 x 32, accumulator layout) times the rows r0 .. r0 +
// 31 of `tile`, p as the bf16 pair hi = R(p), lo = R(p - hi): two products
// on the tensor cores (flash::split_product's, each half's lo taken from
// its packed hi, so that no float copy of lo stays live).
template <int D>
__device__ __forceinline__ void core_pv(float (&o)[D / 8][4], const float (&p)[4][4],
                                        const bf16* tile, int r0, int lane_id) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    uint32_t ah[4], al[4];
    lane::acc_to_a(ah, p, m);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 hi = lane::unpack(ah[k]);
      const float* x = &p[2 * m + (k >> 1)][(k & 1) * 2];
      al[k] = lane::pack(x[0] - hi.x, x[1] - hi.y);
    }
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      lane::load_b_cols<D>(b, tile, r0 + 16 * m, np * 16, lane_id);
      lane::mma(o[2 * np], ah, b[0], b[1]);
      lane::mma(o[2 * np + 1], ah, b[2], b[3]);
      lane::mma(o[2 * np], al, b[0], b[1]);
      lane::mma(o[2 * np + 1], al, b[2], b[3]);
    }
  }
}

// Grid (bands, heads, G), band * ceil(L / 16) warps: the lines l0 .. l0 +
// nb - 1 of head h, rows (kCol = false: H lines of W) or columns (W lines of
// H), in frames f = blockIdx.z, + G, ...  The block stages each line's table
// slice once, tab[l][i][(i + r) mod L] = table[r heads + h][pos(l, i)], then
// for each frame its q, k, v into swizzled (token, D) tiles (zero past L):
// with vec from a raw channel-major slab that cp.async filled while the
// previous frame computed (16-byte chunks, 8 positions each, swizzled by
// channel group), 8 channels of 8 positions a thread, transposed in
// registers; else one element a thread from device memory.  A warp takes
// one 16-query tile: the exact P over the key chunks, P v with P split into
// a bf16 pair, o = s_c pv + (1 - s_c) mean(v) into a (D, band L + 4)
// float32 stage over the tiles (line l's token i at l L + i); then the
// block writes o (columns, the first pass, into col_out: with vec the
// band's (D, H, 8) slab, one run) or dtype((col_out + o) / 2) (rows, into
// out; the TPU kernel's (o_row + o_col) / 2, addition commuting) in runs
// along the positions.  The row pass takes the frames in reverse order.
template <int D, bool kCol>
__global__ void __launch_bounds__(kWarps * 32, 1) core_kernel(CoreArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = a.H * a.W, L = kCol ? a.H : a.W, nlines = kCol ? a.W : a.H;
  const int rows = lane::staged_rows(L), ldt = L + 1, tiles = (L + 15) / 16;
  const int l0 = blockIdx.x * a.band, nb = min(a.band, nlines - l0);
  const int h = blockIdx.y;
  const size_t tile_elems = (size_t)rows * D;
  constexpr int kG = D / 8;  // 16-byte channel groups
  // Raw slab: (3, D, nch) 16-byte chunks of 8 positions (rows: line l's
  // tokens i .. i + 7 at chunk (l L + i) / 8; columns: token i of the band's
  // 8 lines at chunk i), chunk c of channel dd at c ^ (dd / 8 & swz).
  const int nch = a.band * L / 8, swz = nch % 8 == 0 ? 7 : 0;
  bf16* qkv = reinterpret_cast<bf16*>(smem);  // (band, 3, rows, D)
  bf16* raw = qkv + (size_t)a.band * 3 * tile_elems;
  float* tab = reinterpret_cast<float*>(raw + (a.vec ? (size_t)3 * D * nch * 8 : 0));
  float* vsum = tab + (size_t)a.band * L * ldt;  // (band, D)
  float* stage = reinterpret_cast<float*>(smem);  // (D, sd), once q, k, v are read
  const int sd = a.band * L + 4;
  const size_t head0 = (size_t)h * D * N;
  auto src = [&](int f, int comp) {
    return (comp == 0 ? a.q + (size_t)f * a.C * N : a.kv + ((size_t)f * 2 + comp - 1) * a.C * N) +
           head0;
  };
  auto tile = [&](int l, int comp) { return qkv + ((size_t)l * 3 + comp) * tile_elems; };
  auto pos = [&](int l, int i) { return kCol ? i * a.W + l0 + l : (l0 + l) * a.W + i; };
  // The valid chunks of a raw channel row, and chunk c's first position.
  const int nvalid = kCol ? L : nb * L / 8;
  auto chunk_pos = [&](int c) { return kCol ? pos(0, c) : pos(c * 8 / L, c * 8 % L); };
  auto raw_at = [&](int comp, int dd, int c) {
    return raw + (((size_t)comp * D + dd) * nch + (c ^ ((dd >> 3) & swz))) * 8;
  };
  // The frame of step f: the row pass walks the frames backwards, so that
  // it starts on those the column pass left in L2.
  auto frame = [&](int f) { return kCol ? f : a.BT - 1 - f; };
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  // Lanes over a channel row's chunks, warps over the 3 D channel rows.
  auto prefetch = [&](int f) {
    f = frame(f);
    for (int c = lane_id; c < nvalid; c += 32) {
      const int cp = chunk_pos(c);
#pragma unroll 4
      for (int r = warp; r < 3 * D; r += nw)
        cp_async16(raw_at(r / D, r % D, c), src(f, r / D) + (size_t)(r % D) * N + cp);
    }
    cp_async_commit();
  };

  if (a.vec && blockIdx.z < a.BT) prefetch(blockIdx.z);
  // A warp an offset r, lanes along the positions (runs of nb on a column).
  for (int r = warp; r < L; r += nw) {
    const float* tr = a.table + ((size_t)r * a.heads + h) * N;
#pragma unroll 4
    for (int e = lane_id; e < nb * L; e += 32) {
      const int l = kCol ? e % nb : e / L, i = kCol ? e / nb : e % L;
      const int j = i + r < L ? i + r : i + r - L;
      tab[((size_t)l * L + i) * ldt + j] = __ldg(tr + pos(l, i));
    }
  }
  const int g = lane_id >> 2, t = lane_id & 3;
  const int wl = warp / tiles, q0 = (warp % tiles) * 16;
  const bool active = wl < nb;
  for (int f = blockIdx.z; f < a.BT; f += gridDim.z) {
    if (a.vec) {
      cp_async_wait_all();
      __syncthreads();  // the raw slab landed; the last frame's stage is read
      // A unit: 8 channels (group g8) of one chunk, transposed into the
      // chunk's 8 positions of 8 channels each.
      const int g8 = threadIdx.x % kG;
      for (int cc = threadIdx.x / kG; cc < 3 * nvalid; cc += blockDim.x / kG) {
        const int comp = cc / nvalid, c = cc - comp * nvalid;
        uint4 x[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) x[k] = *reinterpret_cast<const uint4*>(raw_at(comp, g8 * 8 + k, c));
        transpose8(x);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          bf16* dst = kCol ? tile(e, comp) + lane::sw<D>(c, g8 * 8)
                           : tile(c * 8 / L, comp) + lane::sw<D>(c * 8 % L + e, g8 * 8);
          *reinterpret_cast<uint4*>(dst) = x[e];
        }
      }
    } else {
      __syncthreads();  // the last frame's stage is read
      const int total = 3 * nb * D * L;
      for (int e = threadIdx.x; e < total; e += blockDim.x) {
        int i, l, r;
        if (kCol) {
          l = e % nb;
          r = e / nb;
          i = r % L;
          r /= L;
        } else {
          i = e % L;
          r = e / L;
          l = r % nb;
          r /= nb;
        }
        const int dd = r % D, comp = r / D;
        tile(l, comp)[lane::sw<D>(i, dd)] = src(frame(f), comp)[(size_t)dd * N + pos(l, i)];
      }
    }
    if (rows > L) {  // zero the rows past the line
      const int pad = rows - L, total = nb * 3 * pad * kG;
      for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int v8 = e % kG, r = e / kG;
        *reinterpret_cast<uint4*>(qkv + (size_t)(r / pad) * tile_elems +
                                  lane::sw<D>(L + r % pad, v8 * 8)) = make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();
    if (a.vec && f + gridDim.z < a.BT) prefetch(f + gridDim.z);  // the raw slab is free
    float o[D / 8][4] = {};
    if (active) {
      const bf16 *qs = tile(wl, 0), *ks = tile(wl, 1), *vs = tile(wl, 2);
      const float* bias = tab + (size_t)wl * L * ldt;
      const int nchunk = rows / lane::kChunk;
      if (q0 == 0) {  // the line's column sums of v: a row of ones times v (rows past L are 0)
        float acc[D / 8][4] = {};
        const uint32_t ones[4] = {0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u};
        for (int r0 = 0; r0 < rows; r0 += 16) {
#pragma unroll
          for (int np = 0; np < D / 16; ++np) {
            uint32_t b[4];
            lane::load_b_cols<D>(b, vs, r0, np * 16, lane_id);
            lane::mma(acc[2 * np], ones, b[0], b[1]);
            lane::mma(acc[2 * np + 1], ones, b[2], b[3]);
          }
        }
        if (g == 0) {
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            vsum[wl * D + n * 8 + 2 * t] = acc[n][0];
            vsum[wl * D + n * 8 + 2 * t + 1] = acc[n][1];
          }
        }
      }
      uint32_t qa[D / 16][4];
      lane::load_a_rows<D>(qa, qs, q0, lane_id);
      float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.f, 0.f}, s[4][4];
      for (int c = 0; c < nchunk; ++c) {
        lane::logits<D>(s, qa, ks, q0, c * lane::kChunk, bias, ldt, L, lane_id);
        core_stats(m, z, s);
      }
      const float iz[2] = {1.f / z[0], 1.f / z[1]};
      for (int c = 0; c < nchunk; ++c) {
        // A line of one key chunk keeps its logits from the first pass.
        if (nchunk > 1) lane::logits<D>(s, qa, ks, q0, c * lane::kChunk, bias, ldt, L, lane_id);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, j = c * lane::kChunk + nt * 8 + 2 * t + (e & 1);
            s[nt][e] = j < L ? __expf(s[nt][e] - m[r]) * iz[r] : 0.f;
          }
        }
        core_pv<D>(o, s, vs, c * lane::kChunk, lane_id);
      }
    }
    __syncthreads();  // q, k, v read (and vsum written): the stage takes their place
    if (active) {
      const float inv_l = 1.f / L;
      const int i0 = q0 + g, i1 = i0 + 8;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int dd = n * 8 + 2 * t + e;
          const float s_c = __ldg(a.sc + (size_t)(h * D + dd) * 2 + (kCol ? 1 : 0));
          const float mean = (1.f - s_c) * (vsum[wl * D + dd] * inv_l);
          float* st = stage + (size_t)dd * sd + wl * L;
          if (i0 < L) st[i0] = s_c * o[n][e] + mean;
          if (i1 < L) st[i1] = s_c * o[n][2 + e] + mean;
        }
      }
    }
    __syncthreads();
    const size_t plane = (size_t)frame(f) * a.C * N + head0;  // channel h D of the frame
    if (a.vec && kCol) {  // the band's slab of col_out: (D, H, 8), one run
      float* dst = a.col_out + (((size_t)frame(f) * a.heads + h) * gridDim.x + blockIdx.x) * D * L * 8;
      for (int i = lane_id; i < L; i += 32) {
        for (int dd = warp; dd < D; dd += nw) {
          const float* sv = stage + (size_t)dd * sd + i;  // line l at sv[l L]
          float4* d4 = reinterpret_cast<float4*>(dst + ((size_t)dd * L + i) * 8);
          d4[0] = make_float4(sv[0], sv[L], sv[2 * L], sv[3 * L]);
          d4[1] = make_float4(sv[4 * L], sv[5 * L], sv[6 * L], sv[7 * L]);
        }
      }
    } else if (a.vec) {  // 8 columns of a row a lane: 8 values of col_out, 16 bytes of out
      const int nbc = L / 8;
      const float* cf = a.col_out + ((size_t)frame(f) * a.heads + h) * nbc * D * a.H * 8;
      for (int pc = lane_id; pc < nb * nbc; pc += 32) {
        const int l = pc / nbc, bc = pc - l * nbc;
        for (int dd = warp; dd < D; dd += nw) {
          const float4* c4 =
              reinterpret_cast<const float4*>(cf + (((size_t)bc * D + dd) * a.H + l0 + l) * 8);
          const float4* s4 = reinterpret_cast<const float4*>(stage + (size_t)dd * sd + l * L + bc * 8);
          const float4 r0 = __ldg(c4), r1 = __ldg(c4 + 1), o0 = s4[0], o1 = s4[1];
          *reinterpret_cast<uint4*>(a.out + plane + (size_t)dd * N + (size_t)(l0 + l) * a.W +
                                    bc * 8) =
              make_uint4(lane::pack((r0.x + o0.x) * 0.5f, (r0.y + o0.y) * 0.5f),
                         lane::pack((r0.z + o0.z) * 0.5f, (r0.w + o0.w) * 0.5f),
                         lane::pack((r1.x + o1.x) * 0.5f, (r1.y + o1.y) * 0.5f),
                         lane::pack((r1.z + o1.z) * 0.5f, (r1.w + o1.w) * 0.5f));
        }
      }
    } else {
      const int total = D * nb * L;
      for (int e = threadIdx.x; e < total; e += blockDim.x) {
        int i, ll, dd;
        if (kCol) {
          ll = e % nb;
          const int r = e / nb;
          i = r % L;
          dd = r / L;
        } else {
          i = e % L;
          const int r = e / L;
          ll = r % nb;
          dd = r / nb;
        }
        const float v = stage[(size_t)dd * sd + ll * L + i];
        const size_t gi = plane + (size_t)dd * N + pos(ll, i);
        if (kCol)
          a.col_out[gi] = v;
        else
          a.out[gi] = __float2bfloat16((a.col_out[gi] + v) * 0.5f);
      }
    }
  }
}

// 16-byte loads and stores, both passes: positions in runs of 8 (W a
// multiple of 8), column bands of 8 lines, every tensor 16-byte aligned.
template <int D>
bool core_vec(const CoreArgs& a) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.kv) |
                        reinterpret_cast<uintptr_t>(a.col_out) |
                        reinterpret_cast<uintptr_t>(a.out);
  return a.W % 8 == 0 && any % 16 == 0 && core_band<D>(a.H, true) == kBand;
}

// The column pass, then the row pass; a block keeps its lines' tables over
// G frames, G the SMs over the (band, head) pairs (at least 1, at most BT).
template <int D>
int run_core(CoreArgs a, const float* bx, const float* by, cudaStream_t stream) {
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  a.vec = core_vec<D>(a);
  for (int pass = 0; pass < 2; ++pass) {
    const bool col = pass == 0;
    const int L = col ? a.H : a.W, lines = col ? a.W : a.H;
    a.table = col ? by : bx;
    a.band = core_band<D>(L, a.vec);
    const size_t smem = core_smem<D>(a.band, L, a.vec);
    if (smem > kSmemMax) return cudaErrorInvalidValue;
    const int bands = (lines + a.band - 1) / a.band;
    const int G = std::max(1, std::min(a.BT, sms / (bands * a.heads)));
    const auto kernel = col ? core_kernel<D, true> : core_kernel<D, false>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(bands, a.heads, G), a.band * ((L + 15) / 16) * 32, smem, stream>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace core
}  // namespace bft

// Both rolls of x (rows, total) in dtype, contiguous, into out (2, rows,
// total) alike: out[i] = within-block roll of x by r_i in blocks of b_i
// lanes (total % b_i == 0, 0 <= r_i < b_i), as desc (a host RollDesc,
// probes/lane_axial.py:within_roll_plan) describes them.  vec: the staged
// 16-byte path, refused unless total is a multiple of 16 bytes of at most
// 48 KB and x and out are 16-byte aligned.  Returns a cudaError_t.
extern "C" int bf_probe_within_roll(const void* desc, const void* x, void* out, void* stream) {
  const bft::RollDesc& d = *static_cast<const bft::RollDesc*>(desc);
  if (d.rows < 1 || d.total < 1 || d.b1 < 1 || d.b2 < 1 || d.total % d.b1 || d.total % d.b2 ||
      d.r1 < 0 || d.r1 >= d.b1 || d.r2 < 0 || d.r2 >= d.b2)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d.dtype == bft::kF32) return bft::run_within_roll<float>(d, x, out, s);
  if (d.dtype == bft::kBF16) return bft::run_within_roll<__nv_bfloat16>(d, x, out, s);
  return cudaErrorInvalidValue;
}

// float32 (lane_core_kernel): q (BT, C, H*W), kv (BT, 2C, H*W) and out (BT,
// C, H*W); bx (W*heads, H*W), by (H*heads, H*W), sc (C, 2) and the scratch
// row_out (BT, C, H*W); all contiguous.  C = heads * d; lines of at most 128
// tokens and a line's q, k, v within 227 KB of shared memory.  Returns a
// cudaError_t.
extern "C" int bf_probe_lane_core(const float* q, const float* kv, const float* bx,
                                  const float* by, const float* sc, float* row_out, float* out,
                                  int BT, int H, int W, int C, int heads, float scaling,
                                  void* stream) {
  if (BT < 1 || BT > 65535 || heads < 1 || heads > 65535 || C % heads || H < 1 || W < 1 ||
      H > 128 || W > 128 || bft::lane_core_smem(C / heads, H > W ? H : W) > 232448)
    return cudaErrorInvalidValue;
  return bft::run_lane_core<float>(q, kv, bx, by, sc, row_out, out, BT, H, W, C, heads, scaling,
                                   static_cast<cudaStream_t>(stream));
}

// bfloat16 (core_kernel): q (BT, C, H*W), kv (BT, 2C, H*W) and out (BT, C,
// H*W) bf16; bx, by, sc as for bf_probe_lane_core and a float32 scratch of
// BT*C*H*W values (the column pass's o); all contiguous.  C = heads * head_dim, head_dim 16 or
// 64, lines of 1 to 128 tokens.  Returns a cudaError_t.
extern "C" int bf_probe_lane_core_hopper(int head_dim, const void* q, const void* kv,
                                         const float* bx, const float* by, const float* sc,
                                         float* scratch, void* out, int BT, int H, int W, int C,
                                         int heads, void* stream) {
  if ((head_dim != 16 && head_dim != 64) || heads < 1 || heads > 65535 ||
      C != heads * head_dim || BT < 1 || BT > 65535 || H < 1 || W < 1 || H > 128 || W > 128)
    return cudaErrorInvalidValue;
  bft::core::CoreArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kv = static_cast<const __nv_bfloat16*>(kv);
  a.sc = sc;
  a.col_out = scratch;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.BT = BT;
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  const auto s = static_cast<cudaStream_t>(stream);
  return head_dim == 64 ? bft::core::run_core<64>(a, bx, by, s)
                        : bft::core::run_core<16>(a, bx, by, s);
}
