// K2 and K4: the axial row + column attention core from the interleaved QKV
// tensor, forward and backward, hand-written for Hopper (sm_90a): the line
// kernels of line_kernels.cuh in their lane (K2, float32 only: bf16 K2 runs
// on lane_hopper.cuh, axial_lane_hopper.cu) and fused_block (K4, both
// dtypes) flavours, head dims 16 and 64.
//
// Replaces bubbleformer_tpu/ops/axial_lane.py:_fwd_kernel and _bwd_kernel
// (built by _make_lane_axial, entry lane_axial_attention_from_x) and
// bubbleformer_tpu/ops/axial_fused_block.py:_fwd_kernel and _bwd_kernel
// (built by _make_fused_block, entry fused_block_attention).  What each
// computes and rounds, and what bounds it: line_kernels.cuh.  The QKV
// projection stays outside (K2: a float32 addmm; K4: the dtype Dense), as it
// stayed in XLA on the TPU.
#include <type_traits>

#include "line_kernels.cuh"

namespace bft {
namespace {

// The flavour's kernels at the head dim: fused_block in either dtype, lane
// in float32 alone (no route launches it in bf16).
template <typename T>
int axial_fwd(int head_dim, int fused, const AxialArgs& a) {
  if (!fused) {
    if constexpr (std::is_same_v<T, float>) {
      return head_dim == 64 ? line_attention_fwd<T, 64, Flavour::kLane>(a)
                            : line_attention_fwd<T, 16, Flavour::kLane>(a);
    }
    return cudaErrorInvalidValue;
  }
  return head_dim == 64 ? line_attention_fwd<T, 64, Flavour::kFusedBlock>(a)
                        : line_attention_fwd<T, 16, Flavour::kFusedBlock>(a);
}

template <typename T>
int axial_bwd(int head_dim, int fused, const AxialArgs& a) {
  if (!fused) {
    if constexpr (std::is_same_v<T, float>) {
      return head_dim == 64 ? line_attention_bwd<T, 64, Flavour::kLane>(a)
                            : line_attention_bwd<T, 16, Flavour::kLane>(a);
    }
    return cudaErrorInvalidValue;
  }
  return head_dim == 64 ? line_attention_bwd<T, 64, Flavour::kFusedBlock>(a)
                        : line_attention_bwd<T, 16, Flavour::kFusedBlock>(a);
}

}  // namespace
}  // namespace bft

// qkv: (BT, H, W, 3C) in dtype, heads-major [q|k|v] columns; ln (4, head_dim)
// = q scale, q bias, k scale, k bias; bias_x (heads, W, W), bias_y (heads, H,
// H); scale (heads, 2) = [s_x, s_y]; row_out (BT, H, W, C) float32 scratch;
// out (BT, H, W, C) in dtype.  fused: 0 the lane flavour (K2, float32
// only), 1 the fused_block flavour (K4).  head_dim 16 or 64, H and W at
// most 512.
// Returns a cudaError_t.
extern "C" int bf_axial_attention_fwd(int dtype, int head_dim, int fused, const void* qkv,
                                      const float* ln, const float* bias_x, const float* bias_y,
                                      const float* scale, float* row_out, void* out, int BT,
                                      int H, int W, int C, int heads, void* stream) {
  bft::AxialArgs a{};
  a.qkv = qkv;
  a.ln = ln;
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
  if (!bft::line_shape_ok(head_dim, a)) return cudaErrorInvalidValue;
  if (dtype == bft::kF32) return bft::axial_fwd<float>(head_dim, fused, a);
  if (dtype == bft::kBF16) return bft::axial_fwd<__nv_bfloat16>(head_dim, fused, a);
  return cudaErrorInvalidValue;
}

// qkv: (BT, H, W, 3C) and dout (BT, H, W, C) in dtype; ln, bias_x, bias_y,
// scale, fused, head_dim as for bf_axial_attention_fwd.  Outputs: dqkv (BT,
// H, W, 3C) in dtype; float32, written whole: dln (4, head_dim), dbias_x
// (heads, W, W), dbias_y (heads, H, H), dscale (heads, 2).  Scratch: dacc
// float32 (BT, H, W, 3C) for fused (else unused), stats float32 (BT, heads,
// H, W, 3) where max(H, W) > 64 (else unused), part float32 the partials of
// the plan (groups_r, per_r) for the BT * H rows and (groups_c, per_c) for
// the BT * W columns (line_kernels.cuh: line_bwd_plans).  Returns a
// cudaError_t.
extern "C" int bf_axial_attention_bwd(int dtype, int head_dim, int fused, const void* qkv,
                                      const void* dout, const float* ln, const float* bias_x,
                                      const float* bias_y, const float* scale, void* dqkv,
                                      float* dacc, float* stats, float* dln, float* dbias_x,
                                      float* dbias_y, float* dscale, float* part, int groups_r,
                                      int per_r, int groups_c, int per_c, int BT, int H, int W,
                                      int C, int heads, void* stream) {
  bft::AxialArgs a{};
  a.qkv = qkv;
  a.dout = dout;
  a.ln = ln;
  a.bias_x = bias_x;
  a.bias_y = bias_y;
  a.scale = scale;
  a.dqkv = dqkv;
  a.dacc = dacc;
  a.stats = stats;
  a.dln = dln;
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
  if (dtype == bft::kF32) return bft::axial_bwd<float>(head_dim, fused, a);
  if (dtype == bft::kBF16) return bft::axial_bwd<__nv_bfloat16>(head_dim, fused, a);
  return cudaErrorInvalidValue;
}
