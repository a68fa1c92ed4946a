// K8: attention over M independent short lines per head with a bias table
// and the attn_scale blend, forward and backward, hand-written for Hopper
// (sm_90a): the line kernels of line_kernels.cuh in their kFlash flavour,
// head dims 16 and 64, lines of up to 512 tokens.
//
// Replaces bubbleformer_tpu/ops/axial_pallas.py:_fwd_kernel and _bwd_kernel
// (built by _make_flash, custom VJP :195-208, entry flash_packed_attention),
// the `flash` route of both attention branches.  Per line of n tokens of
// head h, with q, k, v (heads, M, n, d) in the activation dtype:
//   P = softmax(q k^T / sqrt(d) + bias_h)  in float32,
//   P_eff = s_h P + (1 - s_h) / n,  out = dtype(P_eff v);
// backward, G = dout v^T:  dscale_h += sum (P - 1/n) G,  dS = P (s G -
// rowsum(s G P))  (dbias_h += dS),  dq = dS k / sqrt(d),  dk = dS^T q /
// sqrt(d),  dv = P_eff^T dout, all float32, dq, dk, dv rounded once.
// The TPU kernel packed G = pick_flash_group lines into one G*n super-line
// with a block-diagonal -1e9 mask and a segment-mean matrix, to fill its
// 128x128 matrix unit; exp(-1e9) is exactly 0 in float32, so that is
// per-line attention, which is what this computes, with no G*n x G*n
// logits.  The bias and scale gradients are sums over the M lines in a
// fixed order (per-block partials, line_kernels.cuh): they repeat bit for
// bit.
//
// What bounds it at FiLMAViT-small's training shapes (temporal: 6 heads,
// M = 8192 lines of 5 tokens; rows and columns: M = 1280 lines of 32, d =
// 64): ~31.5 MB per tensor in bf16, so 4 tensors forward (0.038 ms at 3.35
// TB/s) and 7 backward (0.066 ms) against ~2 GFLOP: memory, on paper.  This
// first version is bound by the line kernels' design (one block of 256
// threads per line of at most 64 tokens, CUDA-core products from shared
// memory), which at n = 5 leaves most of a block's threads idle.  Left for
// later: several lines per block at short n, wgmma tiles at n = 32.
#include "line_kernels.cuh"

namespace bft {
namespace {

template <typename T>
int flash_fwd(int head_dim, const AxialArgs& a) {
  return head_dim == 64 ? line_attention_fwd<T, 64, Flavour::kFlash>(a)
                        : line_attention_fwd<T, 16, Flavour::kFlash>(a);
}

template <typename T>
int flash_bwd(int head_dim, const AxialArgs& a) {
  return head_dim == 64 ? line_attention_bwd<T, 64, Flavour::kFlash>(a)
                        : line_attention_bwd<T, 16, Flavour::kFlash>(a);
}

// K8's envelope: head dim 16 or 64, lines of 1 to 512 tokens, and each of
// q, k, v small enough for the line kernels' int head stride.
bool flash_shape_ok(int head_dim, int M, int n, int heads) {
  return (head_dim == 16 || head_dim == 64) && n >= 1 && n <= 512 && M >= 1 && heads >= 1 &&
         (long long)M * n * head_dim < (1LL << 31);
}

// The line kernels' arguments for K8: one image of M lines of n tokens.
AxialArgs flash_args(const void* qkv3, const float* bias, const float* scale, int M, int n,
                     int head_dim, int heads, void* stream) {
  AxialArgs a{};
  a.qkv = qkv3;
  a.bias_x = bias;
  a.bias_y = bias;
  a.scale = scale;
  a.BT = 1;
  a.H = M;
  a.W = n;
  a.C = heads * head_dim;
  a.heads = heads;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace
}  // namespace bft

// qkv3: (3, heads, M, n, head_dim) in dtype = q, k, v; bias (heads, n, n);
// scale (heads, 2), the attn scale in column 0; out (heads, M, n, head_dim)
// in dtype.  head_dim 16 or 64, n at most 512.  Returns a cudaError_t.
extern "C" int bf_axial_flash_fwd(int dtype, int head_dim, const void* qkv3, const float* bias,
                                  const float* scale, void* out, int M, int n, int heads,
                                  void* stream) {
  if (!bft::flash_shape_ok(head_dim, M, n, heads)) return cudaErrorInvalidValue;
  bft::AxialArgs a = bft::flash_args(qkv3, bias, scale, M, n, head_dim, heads, stream);
  a.out = out;
  if (dtype == bft::kF32) return bft::flash_fwd<float>(head_dim, a);
  if (dtype == bft::kBF16) return bft::flash_fwd<__nv_bfloat16>(head_dim, a);
  return cudaErrorInvalidValue;
}

// qkv3 (3, heads, M, n, head_dim) and dout (heads, M, n, head_dim) in dtype;
// bias, scale as for bf_axial_flash_fwd.  Outputs: dqkv3 (3, heads, M, n,
// head_dim) in dtype; float32, written whole: dbias (heads, n, n) and dscale
// (heads, 2), the scale's gradient in column 0 (column 1 zero).  Scratch:
// stats float32 (heads, M, n, 3) where n > 64 (else unused), part the
// partials of the plan (groups, per) for the M lines (line_kernels.cuh:
// line_bwd_plans, one pass).  Returns a cudaError_t.
extern "C" int bf_axial_flash_bwd(int dtype, int head_dim, const void* qkv3, const void* dout,
                                  const float* bias, const float* scale, void* dqkv3,
                                  float* stats, float* dbias, float* dscale, float* part,
                                  int groups, int per, int M, int n, int heads, void* stream) {
  if (!bft::flash_shape_ok(head_dim, M, n, heads)) return cudaErrorInvalidValue;
  bft::AxialArgs a = bft::flash_args(qkv3, bias, scale, M, n, head_dim, heads, stream);
  a.dout = dout;
  a.dqkv = dqkv3;
  a.stats = stats;
  a.dbias_x = dbias;
  a.dbias_y = dbias;
  a.dscale = dscale;
  a.part = part;
  a.groups[0] = groups;
  a.per[0] = per;
  if (dtype == bft::kF32) return bft::flash_bwd<float>(head_dim, a);
  if (dtype == bft::kBF16) return bft::flash_bwd<__nv_bfloat16>(head_dim, a);
  return cudaErrorInvalidValue;
}
