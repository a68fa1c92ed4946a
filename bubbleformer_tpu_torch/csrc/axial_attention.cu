// K2: axial row + column attention core, forward, hand-written for Hopper
// (sm_90a).
//
// Replaces bubbleformer_tpu/ops/axial_lane.py:_fwd_kernel (built by
// _make_lane_axial, entry lane_axial_attention_from_x): from the QKV of the
// InstanceNorm1 output, per-head qk-LayerNorm, then attention along each
// image row (over W, T5 bias_x, attn scale s_x) and along each column (over
// H, bias_y, s_y), each with the attn_scale blend folded into the
// probabilities, pb = dtype(s*softmax(...) + (1-s)/L), and the mean of the
// two directions.  The QKV projection stays outside (torch.matmul), as it
// stayed in XLA on the TPU.
//
// Two launches of one kernel on natural-layout (BT, H, W, 3C) QKV:
//   pass 0, rows: one block per (row, head, bt) loads the W tokens' q|k|v of
//     that head (192 contiguous values per token), applies qk-LN, computes
//     the W x W logits + bias, softmax and blend, multiplies by V and writes
//     the row output in float32;
//   pass 1, columns: the same over the H tokens of a column, then writes
//     dtype(0.5 * (dtype(row) + dtype(col))) (axial_lane.py:844-848).
// The lane kernel's chunk tables, -1e9 block masks and dual layouts
// (_build_table, _pick_chunk) were TPU answers and have no counterpart; h != w
// is supported.
//
// What bounds it at the slice shape (BT=5, 32x32 tokens, C=384, 6 heads):
// ~0.25 GFLOP in all, so it is bound by reading the 11.8 MB bf16 QKV tensor
// twice (once per direction) plus the 7.9 MB float32 row output round trip.
// The small L x L products run on the CUDA cores from shared memory.
// Left for later: one pass that keeps a tile of rows and columns on chip
// (the row output never leaves the SM), tensor-core products for long
// lines, and the backward kernel.
#include <cmath>

#include "common.cuh"

namespace bft {
namespace {

constexpr int kD = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 64;           // longest line (max(H, W)) handled
constexpr int kLDS = kD + 1;        // padded q/k/v row stride (no bank conflicts)
constexpr float kEps = 1e-5f;
constexpr float kScaling = 0.125f;  // kD ** -0.5

size_t line_smem_bytes(int L) { return sizeof(float) * (3 * L * kLDS + L * (L + 1)); }

// grid (lines, heads, BT); pass 0: lines = H, L = W; pass 1: lines = W, L = H.
template <typename T>
__global__ void __launch_bounds__(kThreads) axial_line_kernel(
    const T* __restrict__ qkv, const float* __restrict__ ln, const float* __restrict__ bias,
    const float* __restrict__ scale, float* __restrict__ row_out, T* __restrict__ out, int H,
    int W, int C, int pass) {
  extern __shared__ float sm[];
  const int line = blockIdx.x, h = blockIdx.y, bt = blockIdx.z;
  const int L = pass == 0 ? W : H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* qs = sm;
  float* ks = qs + L * kLDS;
  float* vs = ks + L * kLDS;
  float* ps = vs + L * kLDS;  // (L, L + 1)
  const int ldp = L + 1;
  // Token index of sequence position i of this line.
  auto token = [&](int i) -> size_t {
    return pass == 0 ? ((size_t)bt * H + line) * W + i : ((size_t)bt * H + i) * W + line;
  };

  for (int e = tid; e < L * 3 * kD; e += kThreads) {
    const int i = e / (3 * kD), j = e % (3 * kD);
    const float v = to_f32(qkv[token(i) * 3 * C + h * 3 * kD + j]);
    (j < kD ? qs : j < 2 * kD ? ks : vs)[i * kLDS + j % kD] = v;
  }
  __syncthreads();

  // qk-LayerNorm over d (ln rows: q scale, q bias, k scale, k bias).
  for (int task = warp; task < 2 * L; task += kWarps) {
    const int i = task >> 1, comp = task & 1;
    float* r = (comp == 0 ? qs : ks) + i * kLDS;
    const float a0 = r[lane], a1 = r[lane + 32];
    const float mu = warp_sum(a0 + a1) * (1.f / kD);
    const float var = fmaxf(warp_sum(a0 * a0 + a1 * a1) * (1.f / kD) - mu * mu, 0.f);
    const float inv = 1.f / sqrtf(var + kEps);
    const float* g = ln + comp * 2 * kD;
    const float* bb = g + kD;
    r[lane] = round_to<T>((a0 - mu) * inv * g[lane] + bb[lane]);
    r[lane + 32] = round_to<T>((a1 - mu) * inv * g[lane + 32] + bb[lane + 32]);
  }
  __syncthreads();

  // Logits.
  const float* bh = bias + (size_t)h * L * L;
  for (int e = tid; e < L * L; e += kThreads) {
    const int i = e / L, j = e % L;
    const float* q = qs + i * kLDS;
    const float* k = ks + j * kLDS;
    float acc = 0.f;
#pragma unroll 16
    for (int d = 0; d < kD; ++d) acc += q[d] * k[d];
    ps[i * ldp + j] = acc * kScaling + bh[i * L + j];
  }
  __syncthreads();

  // Softmax and the attn_scale blend, one warp per query row.
  const float s = scale[h * 2 + pass];
  const float uniform = (1.f - s) * (1.f / L);
  for (int i = warp; i < L; i += kWarps) {
    float* r = ps + i * ldp;
    const float l0 = lane < L ? r[lane] : -INFINITY;
    const float l1 = lane + 32 < L ? r[lane + 32] : -INFINITY;
    const float mx = warp_max(fmaxf(l0, l1));
    const float e0 = lane < L ? expf(l0 - mx) : 0.f;
    const float e1 = lane + 32 < L ? expf(l1 - mx) : 0.f;
    const float z = warp_sum(e0 + e1);
    if (lane < L) r[lane] = round_to<T>(s * (e0 / z) + uniform);
    if (lane + 32 < L) r[lane + 32] = round_to<T>(s * (e1 / z) + uniform);
  }
  __syncthreads();

  // pb @ V, then write.
  for (int e = tid; e < L * kD; e += kThreads) {
    const int i = e / kD, d = e % kD;
    const float* p = ps + i * ldp;
    float acc = 0.f;
    for (int j = 0; j < L; ++j) acc += p[j] * vs[j * kLDS + d];
    const size_t o = token(i) * C + h * kD + d;
    if (pass == 0) {
      row_out[o] = acc;
    } else {
      out[o] = from_f32<T>(0.5f * (round_to<T>(row_out[o]) + round_to<T>(acc)));
    }
  }
}

template <typename T>
int run_axial(const void* qkv, const float* ln, const float* bias_x, const float* bias_y,
              const float* scale, float* row_out, void* out, int BT, int H, int W, int C,
              int heads, cudaStream_t stream) {
  const T* q = static_cast<const T*>(qkv);
  T* o = static_cast<T*>(out);
  cudaError_t e;
  const size_t smem_max = line_smem_bytes(kMaxL);
  if ((e = cudaFuncSetAttribute(axial_line_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_max)) != cudaSuccess)
    return e;
  axial_line_kernel<T><<<dim3(H, heads, BT), kThreads, line_smem_bytes(W), stream>>>(
      q, ln, bias_x, scale, row_out, o, H, W, C, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  axial_line_kernel<T><<<dim3(W, heads, BT), kThreads, line_smem_bytes(H), stream>>>(
      q, ln, bias_y, scale, row_out, o, H, W, C, 1);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bft

// qkv: (BT, H, W, 3C) in dtype, heads-major [q|k|v] columns; ln (4, 64);
// bias_x (heads, W, W), bias_y (heads, H, H); scale (heads, 2) = [s_x, s_y];
// row_out (BT, H, W, C) float32 scratch; out (BT, H, W, C) in dtype.  The
// wrapper checks head_dim == 64 and max(H, W) <= 64.  Returns a cudaError_t.
extern "C" int bf_axial_attention_fwd(int dtype, const void* qkv, const float* ln,
                                      const float* bias_x, const float* bias_y,
                                      const float* scale, float* row_out, void* out, int BT, int H,
                                      int W, int C, int heads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bft::kF32)
    return bft::run_axial<float>(qkv, ln, bias_x, bias_y, scale, row_out, out, BT, H, W, C, heads,
                                 s);
  if (dtype == bft::kBF16)
    return bft::run_axial<__nv_bfloat16>(qkv, ln, bias_x, bias_y, scale, row_out, out, BT, H, W,
                                         C, heads, s);
  return cudaErrorInvalidValue;
}
