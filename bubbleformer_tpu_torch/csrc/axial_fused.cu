// K6 and K7 in float32: the axial row + column attention of the
// fused_packed and fused routes, from q, k and v already qk-normalised,
// forward and backward, hand-written for Hopper (sm_90a): the line kernels
// of line_kernels.cuh in their kPacked (K6) and kFused (K7) flavours, head
// dims 16 and 64.  bfloat16 K6 and K7 run lane_hopper.cuh and
// flash_hopper.cuh (axial_lane_hopper.cu, axial_flash_hopper.cu), but for
// K7's bf16 backward on lines those do not stage (head dim 64, more than 256
// tokens), which is this file's kFused backward in bf16.
//
// Replaces bubbleformer_tpu/ops/axial_fused_packed.py:_fwd_kernel,
// _bwd_chunk and _bwd_kernel (built by _make_fused_packed, entry
// fused_axial_attention_packed) and bubbleformer_tpu/ops/axial_fused.py:
// _attn_chunk, _fwd_kernel, _bwd_chunk and _bwd_kernel (built by _make_fused,
// entry fused_axial_attention).  K6 rounds as K4 does without its LayerNorm:
// P rounded before its product with v, o and the two directions' sum in
// float32, one rounding (axial_fused_packed.py:176-186, :371).  K7 keeps P
// and the blended P_eff in float32 and rounds each direction's 0.5 o before
// adding them in the activation dtype (axial_fused.py:92-100, :134, :147);
// its backward does not round dS, and each direction's dq, dk, dv are
// rounded before they are added (:210-233).  The TPU kernels' block-diagonal
// -1e9 tables, head packing and R bias R^T spreads (and K7's kron packing of
// the tables outside the kernel) have no counterpart: the tables' gradients
// come out as (heads, L, L) sums.  What bounds them: line_kernels.cuh (the
// work of K4's attention, without the qk-LN).
#include "line_kernels.cuh"

namespace bft {
namespace {

int fused_fwd(int head_dim, int packed, const AxialArgs& a) {
  if (head_dim == 64)
    return packed ? line_attention_fwd<float, 64, Flavour::kPacked>(a)
                  : line_attention_fwd<float, 64, Flavour::kFused>(a);
  return packed ? line_attention_fwd<float, 16, Flavour::kPacked>(a)
                : line_attention_fwd<float, 16, Flavour::kFused>(a);
}

int fused_bwd(int head_dim, int packed, const AxialArgs& a) {
  if (head_dim == 64)
    return packed ? line_attention_bwd<float, 64, Flavour::kPacked>(a)
                  : line_attention_bwd<float, 64, Flavour::kFused>(a);
  return packed ? line_attention_bwd<float, 16, Flavour::kPacked>(a)
                : line_attention_bwd<float, 16, Flavour::kFused>(a);
}

}  // namespace
}  // namespace bft

// qkv3: (3, BT, H, W, C) float32 = q, k, v (per head d contiguous values);
// bias_x (heads, W, W), bias_y (heads, H, H); scale (heads, 2) = [s_x, s_y];
// row_out (BT, H, W, C) float32 scratch; out (BT, H, W, C) float32.  dtype:
// float32 alone.  packed: 1 K6, 0 K7.  head_dim 16 or 64, H and W at most
// 512.  Returns a cudaError_t.
extern "C" int bf_axial_fused_fwd(int dtype, int head_dim, int packed, const void* qkv3,
                                  const float* bias_x, const float* bias_y, const float* scale,
                                  float* row_out, void* out, int BT, int H, int W, int C,
                                  int heads, void* stream) {
  bft::AxialArgs a{};
  a.qkv = qkv3;
  a.bias_x = bias_x;
  a.bias_y = bias_y;
  a.scale = scale;
  a.row_out = row_out;
  a.out = out;
  a.BT = BT;
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!bft::line_shape_ok(head_dim, a) || dtype != bft::kF32) return cudaErrorInvalidValue;
  return bft::fused_fwd(head_dim, packed, a);
}

// qkv3 (3, BT, H, W, C) and dout (BT, H, W, C) in dtype (float32; bfloat16
// for K7 at head_dim 64 alone); bias_x, bias_y, scale, packed, head_dim as
// for bf_axial_fused_fwd.  Outputs: dqkv3 (3, BT,
// H, W, C) in dtype; float32, written whole: dbias_x (heads, W, W), dbias_y
// (heads, H, H), dscale (heads, 2).  Scratch: dacc float32 (3, BT, H, W, C)
// for K6 (else unused), stats float32 (BT, heads, H, W, 3) where max(H, W) >
// 64 (else unused), part and the plan as for bf_axial_attention_bwd.
// Returns a cudaError_t.
extern "C" int bf_axial_fused_bwd(int dtype, int head_dim, int packed, const void* qkv3,
                                  const void* dout, const float* bias_x, const float* bias_y,
                                  const float* scale, void* dqkv3, float* dacc, float* stats,
                                  float* dbias_x, float* dbias_y, float* dscale, float* part,
                                  int groups_r, int per_r, int groups_c, int per_c, int BT,
                                  int H, int W, int C, int heads, void* stream) {
  bft::AxialArgs a{};
  a.qkv = qkv3;
  a.dout = dout;
  a.bias_x = bias_x;
  a.bias_y = bias_y;
  a.scale = scale;
  a.dqkv = dqkv3;
  a.dacc = dacc;
  a.stats = stats;
  a.dbias_x = dbias_x;
  a.dbias_y = dbias_y;
  a.dscale = dscale;
  a.part = part;
  a.groups[0] = groups_r;
  a.per[0] = per_r;
  a.groups[1] = groups_c;
  a.per[1] = per_c;
  a.BT = BT;
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!bft::line_shape_ok(head_dim, a)) return cudaErrorInvalidValue;
  if (dtype == bft::kF32) return bft::fused_bwd(head_dim, packed, a);
  if (dtype == bft::kBF16 && head_dim == 64 && !packed)
    return bft::line_attention_bwd<__nv_bfloat16, 64, bft::Flavour::kFused>(a);
  return cudaErrorInvalidValue;
}
