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
// lines.
//
// Backward (axial_line_bwd_kernel), replacing axial_lane.py:_bwd_kernel
// (custom VJP fused_bwd): the same two passes over the same blocks.  A block
// restages its line's q|k|v, redoes qk-LN and the softmax P, takes its
// direction's output gradient dao = dtype(0.5 * dout), and computes
// (_axis_bwd): G = dao v^T, dscale += sum (P - 1/L) G,
// dS = P (s G - rowsum(s G P)) (the T5 table's gradient), dq = dtype(dS) k
// / sqrt(d), dk = dtype(dS)^T q / sqrt(d), dv = dtype(s P + (1-s)/L)^T dao,
// then the qk-LN backward (_qkln_bwd).  Pass 0 (rows) writes dqkv in the
// activation dtype; pass 1 (columns) runs after it on the same stream and
// adds its own rounded dqkv into it: each (token, head) belongs to one block
// per pass, so there is no race.  The table, scale and LN gradients are
// summed in the block and added with float32 atomics (last bits vary from
// run to run).  It reads qkv and dout once per direction and writes dqkv
// twice: ~40 MB at the rollout shape in bf16 against ~0.8 GFLOP, so memory
// bounds it.
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

size_t line_bwd_smem_bytes(int L) { return sizeof(float) * (8 * L * kLDS + 2 * L * (L + 1)); }

// grid (lines, heads, BT); pass 0: lines = H, L = W; pass 1: lines = W, L = H.
template <typename T>
__global__ void __launch_bounds__(kThreads) axial_line_bwd_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dout, const float* __restrict__ ln,
    const float* __restrict__ bias, const float* __restrict__ scale, T* __restrict__ dqkv,
    float* __restrict__ dln, float* __restrict__ dbias, float* __restrict__ dscale, int H, int W,
    int C, int pass) {
  extern __shared__ float sm[];
  __shared__ float dln_s[4 * kD];
  __shared__ float dscale_s;
  const int line = blockIdx.x, h = blockIdx.y, bt = blockIdx.z;
  const int L = pass == 0 ? W : H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* qr = sm;               // raw q, k (L, kLDS)
  float* kr = qr + L * kLDS;
  float* qs = kr + L * kLDS;    // q, k after LN, rounded
  float* ks = qs + L * kLDS;
  float* vs = ks + L * kLDS;
  float* ds = vs + L * kLDS;    // dao
  float* dq = ds + L * kLDS;
  float* dk = dq + L * kLDS;
  float* ps = dk + L * kLDS;    // P, then the blended dtype(s P + (1-s)/L)  (L, L + 1)
  float* gs = ps + L * (L + 1);  // G, then dS
  const int ldp = L + 1;
  auto token = [&](int i) -> size_t {
    return pass == 0 ? ((size_t)bt * H + line) * W + i : ((size_t)bt * H + i) * W + line;
  };

  for (int e = tid; e < 4 * kD; e += kThreads) dln_s[e] = 0.f;
  if (tid == 0) dscale_s = 0.f;
  for (int e = tid; e < L * 3 * kD; e += kThreads) {
    const int i = e / (3 * kD), j = e % (3 * kD);
    const float v = to_f32(qkv[token(i) * 3 * C + h * 3 * kD + j]);
    (j < kD ? qr : j < 2 * kD ? kr : vs)[i * kLDS + j % kD] = v;
  }
  for (int e = tid; e < L * kD; e += kThreads) {
    const int i = e / kD, d = e % kD;
    ds[i * kLDS + d] = round_to<T>(0.5f * to_f32(dout[token(i) * C + h * kD + d]));
  }
  __syncthreads();

  // qk-LayerNorm statistics of a raw row.
  auto ln_stats = [&](const float* r, float& mu, float& inv) {
    const float a0 = r[lane], a1 = r[lane + 32];
    mu = warp_sum(a0 + a1) * (1.f / kD);
    const float var = fmaxf(warp_sum(a0 * a0 + a1 * a1) * (1.f / kD) - mu * mu, 0.f);
    inv = 1.f / sqrtf(var + kEps);
  };
  for (int task = warp; task < 2 * L; task += kWarps) {
    const int i = task >> 1, comp = task & 1;
    const float* r = (comp == 0 ? qr : kr) + i * kLDS;
    float* o = (comp == 0 ? qs : ks) + i * kLDS;
    float mu, inv;
    ln_stats(r, mu, inv);
    const float* g = ln + comp * 2 * kD;
    const float* bb = g + kD;
    o[lane] = round_to<T>((r[lane] - mu) * inv * g[lane] + bb[lane]);
    o[lane + 32] = round_to<T>((r[lane + 32] - mu) * inv * g[lane + 32] + bb[lane + 32]);
  }
  __syncthreads();

  // Logits and G = dao v^T.
  const float* bh = bias + (size_t)h * L * L;
  for (int e = tid; e < L * L; e += kThreads) {
    const int i = e / L, j = e % L;
    const float* q = qs + i * kLDS;
    const float* k = ks + j * kLDS;
    const float* a = ds + i * kLDS;
    const float* v = vs + j * kLDS;
    float acc = 0.f, gacc = 0.f;
#pragma unroll 16
    for (int d = 0; d < kD; ++d) {
      acc += q[d] * k[d];
      gacc += a[d] * v[d];
    }
    ps[i * ldp + j] = acc * kScaling + bh[i * L + j];
    gs[i * ldp + j] = gacc;
  }
  __syncthreads();

  // Per query row (one warp): softmax, dscale, dS; then the blend for dv.
  const float s = scale[h * 2 + pass];
  const float uniform = (1.f - s) * (1.f / L);
  float dscale_acc = 0.f;
  float* dbh = dbias + (size_t)h * L * L;
  for (int i = warp; i < L; i += kWarps) {
    float* pr = ps + i * ldp;
    float* gr = gs + i * ldp;
    const bool in0 = lane < L, in1 = lane + 32 < L;
    const float l0 = in0 ? pr[lane] : -INFINITY;
    const float l1 = in1 ? pr[lane + 32] : -INFINITY;
    const float mx = warp_max(fmaxf(l0, l1));
    const float e0 = in0 ? expf(l0 - mx) : 0.f;
    const float e1 = in1 ? expf(l1 - mx) : 0.f;
    const float z = warp_sum(e0 + e1);
    const float p0 = e0 / z, p1 = e1 / z;
    const float g0 = in0 ? gr[lane] : 0.f, g1 = in1 ? gr[lane + 32] : 0.f;
    dscale_acc += (in0 ? (p0 - 1.f / L) * g0 : 0.f) + (in1 ? (p1 - 1.f / L) * g1 : 0.f);
    const float rowsum = warp_sum(s * g0 * p0 + s * g1 * p1);
    if (in0) {
      const float dS = p0 * (s * g0 - rowsum);
      gr[lane] = dS;
      atomicAdd(&dbh[i * L + lane], dS);
      pr[lane] = round_to<T>(s * p0 + uniform);
    }
    if (in1) {
      const float dS = p1 * (s * g1 - rowsum);
      gr[lane + 32] = dS;
      atomicAdd(&dbh[i * L + lane + 32], dS);
      pr[lane + 32] = round_to<T>(s * p1 + uniform);
    }
  }
  dscale_acc = warp_sum(dscale_acc);
  if (lane == 0) atomicAdd(&dscale_s, dscale_acc);
  __syncthreads();

  // dq, dk (w.r.t. the LN outputs) into shared memory; dv straight out.
  for (int e = tid; e < L * kD; e += kThreads) {
    const int i = e / kD, d = e % kD;
    float aq = 0.f, ak = 0.f, av = 0.f;
    for (int j = 0; j < L; ++j) {
      aq += round_to<T>(gs[i * ldp + j]) * ks[j * kLDS + d];
      ak += round_to<T>(gs[j * ldp + i]) * qs[j * kLDS + d];
      av += ps[j * ldp + i] * ds[j * kLDS + d];
    }
    dq[i * kLDS + d] = aq * kScaling;
    dk[i * kLDS + d] = ak * kScaling;
    T* o = dqkv + token(i) * 3 * C + h * 3 * kD + 2 * kD + d;
    *o = pass == 0 ? from_f32<T>(av) : from_f32<T>(to_f32(*o) + round_to<T>(av));
  }
  __syncthreads();

  // qk-LN backward per (row, component): the raw-component gradient.
  float dl[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
  for (int task = warp; task < 2 * L; task += kWarps) {
    const int i = task >> 1, comp = task & 1;
    const float* r = (comp == 0 ? qr : kr) + i * kLDS;
    const float* dy = (comp == 0 ? dq : dk) + i * kLDS;
    float mu, inv;
    ln_stats(r, mu, inv);
    const float xh0 = (r[lane] - mu) * inv, xh1 = (r[lane + 32] - mu) * inv;
    const float* g = ln + comp * 2 * kD;
    const float y0 = dy[lane], y1 = dy[lane + 32];
    const float g0 = y0 * g[lane], g1 = y1 * g[lane + 32];
    const float m1 = warp_sum(g0 + g1) * (1.f / kD);
    const float m2 = warp_sum(g0 * xh0 + g1 * xh1) * (1.f / kD);
    T* o = dqkv + token(i) * 3 * C + h * 3 * kD + comp * kD;
    const float r0 = inv * (g0 - m1 - xh0 * m2), r1 = inv * (g1 - m1 - xh1 * m2);
    if (pass == 0) {
      o[lane] = from_f32<T>(r0);
      o[lane + 32] = from_f32<T>(r1);
    } else {
      o[lane] = from_f32<T>(to_f32(o[lane]) + round_to<T>(r0));
      o[lane + 32] = from_f32<T>(to_f32(o[lane + 32]) + round_to<T>(r1));
    }
    // dl[2 comp] += dy * xhat, dl[2 comp + 1] += dy; constant indices keep
    // dl in registers.
    if (comp == 0) {
      dl[0][0] += y0 * xh0;
      dl[0][1] += y1 * xh1;
      dl[1][0] += y0;
      dl[1][1] += y1;
    } else {
      dl[2][0] += y0 * xh0;
      dl[2][1] += y1 * xh1;
      dl[3][0] += y0;
      dl[3][1] += y1;
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    atomicAdd(&dln_s[u * kD + lane], dl[u][0]);
    atomicAdd(&dln_s[u * kD + lane + 32], dl[u][1]);
  }
  __syncthreads();
  for (int e = tid; e < 4 * kD; e += kThreads) atomicAdd(&dln[e], dln_s[e]);
  if (tid == 0) atomicAdd(&dscale[h * 2 + pass], dscale_s);
}

template <typename T>
int run_axial_bwd(const void* qkv, const void* dout, const float* ln, const float* bias_x,
                  const float* bias_y, const float* scale, void* dqkv, float* dln,
                  float* dbias_x, float* dbias_y, float* dscale, int BT, int H, int W, int C,
                  int heads, cudaStream_t stream) {
  const T* q = static_cast<const T*>(qkv);
  const T* d = static_cast<const T*>(dout);
  T* dq = static_cast<T*>(dqkv);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(axial_line_bwd_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)line_bwd_smem_bytes(kMaxL))) != cudaSuccess)
    return e;
  axial_line_bwd_kernel<T><<<dim3(H, heads, BT), kThreads, line_bwd_smem_bytes(W), stream>>>(
      q, d, ln, bias_x, scale, dq, dln, dbias_x, dscale, H, W, C, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  axial_line_bwd_kernel<T><<<dim3(W, heads, BT), kThreads, line_bwd_smem_bytes(H), stream>>>(
      q, d, ln, bias_y, scale, dq, dln, dbias_y, dscale, H, W, C, 1);
  return cudaGetLastError();
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

// qkv: (BT, H, W, 3C) and dout (BT, H, W, C) in dtype; ln, bias_x, bias_y,
// scale as for bf_axial_attention_fwd.  Outputs: dqkv (BT, H, W, 3C) in
// dtype; float32 and zeroed by the caller: dln (4, 64), dbias_x (heads, W,
// W), dbias_y (heads, H, H), dscale (heads, 2).  The wrapper checks
// head_dim == 64 and max(H, W) <= 64.  Returns a cudaError_t.
extern "C" int bf_axial_attention_bwd(int dtype, const void* qkv, const void* dout,
                                      const float* ln, const float* bias_x, const float* bias_y,
                                      const float* scale, void* dqkv, float* dln, float* dbias_x,
                                      float* dbias_y, float* dscale, int BT, int H, int W, int C,
                                      int heads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == bft::kF32)
    return bft::run_axial_bwd<float>(qkv, dout, ln, bias_x, bias_y, scale, dqkv, dln, dbias_x,
                                     dbias_y, dscale, BT, H, W, C, heads, s);
  if (dtype == bft::kBF16)
    return bft::run_axial_bwd<__nv_bfloat16>(qkv, dout, ln, bias_x, bias_y, scale, dqkv, dln,
                                             dbias_x, dbias_y, dscale, BT, H, W, C, heads, s);
  return cudaErrorInvalidValue;
}
