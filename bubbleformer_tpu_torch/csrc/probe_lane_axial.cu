// P1: the lane-roll axial attention probe, hand-written for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of scripts/probe_lane_axial.py:
//   (a) probe_within_roll's kernel (pallas_call :86, helper _within_roll :62):
//       a circular roll by r within each block of lanes of a (rows, total)
//       slab, rows (block W, r = 5) and columns (block H*W, r = 3W) into two
//       outputs.  Here one gather launch writes both:
//         o[.., g*block + w] = x[.., g*block + (w + r) % block].
//       Bound by its bytes (one read, two writes); at the probe's (16, 512)
//       slab the launch itself is the cost.
//   (b) bench_core's kernel (pallas_call :193, body _core_kernel :104): per
//       frame of channel-major q (BT, C, N) and kv (BT, 2C, N), N = H*W, the
//       row and the column attention over all W (H) circular offsets of a
//       line.  For query position p of head h and key (i + r) mod L of its
//       line, logit = sum_d q k * d^-1/2 + table[r*heads + h, p]; softmax in
//       float32; o = s_c pv + (1 - s_c) mean_line(v), s_c per channel
//       (sc (C, 2): rows | columns); out = dtype((o_row + o_col) / 2).
//       The TPU kernel rolled whole lane slabs (one offset at a time, VPU
//       only).  Here a block owns one (frame, head, line): the line's q, k, v
//       (d x L, float32) sit in shared memory and every query meets its L keys
//       directly, so no roll exists.  The row pass writes o_row in float32
//       scratch; the column pass adds it and rounds once, as the TPU kernel's
//       float32 `out` is rounded once.
//       Bound at the probe's shape (BT = 20, C = 384, 32 x 32 tokens): its
//       64 MB of q, kv, tables and out (0.019 ms at 3.35 TB/s); the attention
//       is 2 GFLOP.  This first version adds the float32 scratch round trip
//       (63 MB) and reads column lines with a stride of W.
#include <algorithm>
#include <cmath>

#include "common.cuh"

namespace bft {
namespace {

constexpr int kLaneThreads = 256;

template <typename T>
__global__ void within_roll_kernel(const T* __restrict__ x, T* __restrict__ o1,
                                   T* __restrict__ o2, long long n, int total, int r1, int b1,
                                   int r2, int b2) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int lane = static_cast<int>(e % total);
    const long long row = e - lane;
    const int w1 = lane % b1, w2 = lane % b2;
    o1[e] = x[row + lane - w1 + (w1 + r1) % b1];
    o2[e] = x[row + lane - w2 + (w2 + r2) % b2];
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
int run_within_roll(const void* x, void* o1, void* o2, int rows, int total, int r1, int b1,
                    int r2, int b2, cudaStream_t stream) {
  const long long n = (long long)rows * total;
  const int blocks = static_cast<int>(std::min<long long>((n + 255) / 256, 65535));
  within_roll_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(o1),
                                                    static_cast<T*>(o2), n, total, r1, b1, r2, b2);
  return cudaGetLastError();
}

template <typename T>
int run_lane_core(const void* q, const void* kv, const float* bx, const float* by,
                  const float* sc, float* row_out, void* out, int BT, int H, int W, int C,
                  int heads, float scaling, cudaStream_t stream) {
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
  const T* qt = static_cast<const T*>(q);
  const T* kvt = static_cast<const T*>(kv);
  rows<<<dim3(H, heads, BT), kLaneThreads, s_rows, stream>>>(qt, kvt, bx, sc, row_out, nullptr,
                                                             heads, d, H, W, scaling);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  cols<<<dim3(W, heads, BT), kLaneThreads, s_cols, stream>>>(
      qt, kvt, by, sc, row_out, static_cast<T*>(out), heads, d, H, W, scaling);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bft

// x (rows, total) in dtype, contiguous; o1, o2 alike: o_i = within-block roll
// of x by r_i in blocks of b_i lanes (total % b_i == 0, 0 <= r_i < b_i).
// Returns a cudaError_t.
extern "C" int bf_probe_within_roll(int dtype, const void* x, void* o1, void* o2, int rows,
                                    int total, int r1, int b1, int r2, int b2, void* stream) {
  if (rows < 1 || total < 1 || b1 < 1 || b2 < 1 || total % b1 || total % b2 || r1 < 0 ||
      r1 >= b1 || r2 < 0 || r2 >= b2)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bft::kF32) return bft::run_within_roll<float>(x, o1, o2, rows, total, r1, b1, r2, b2, s);
  if (dtype == bft::kBF16)
    return bft::run_within_roll<__nv_bfloat16>(x, o1, o2, rows, total, r1, b1, r2, b2, s);
  return cudaErrorInvalidValue;
}

// q (BT, C, H*W), kv (BT, 2C, H*W) and out (BT, C, H*W) in dtype; bx (W*heads,
// H*W), by (H*heads, H*W), sc (C, 2) and the scratch row_out (BT, C, H*W)
// float32; all contiguous.  C = heads * d; lines of at most 128 tokens and a
// line's q, k, v within 227 KB of shared memory.  Returns a cudaError_t.
extern "C" int bf_probe_lane_core(int dtype, const void* q, const void* kv, const float* bx,
                                  const float* by, const float* sc, float* row_out, void* out,
                                  int BT, int H, int W, int C, int heads, float scaling,
                                  void* stream) {
  if (BT < 1 || BT > 65535 || heads < 1 || heads > 65535 || C % heads || H < 1 || W < 1 ||
      H > 128 || W > 128 || bft::lane_core_smem(C / heads, H > W ? H : W) > 232448)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bft::kF32)
    return bft::run_lane_core<float>(q, kv, bx, by, sc, row_out, out, BT, H, W, C, heads,
                                     scaling, s);
  if (dtype == bft::kBF16)
    return bft::run_lane_core<__nv_bfloat16>(q, kv, bx, by, sc, row_out, out, BT, H, W, C,
                                             heads, scaling, s);
  return cudaErrorInvalidValue;
}
