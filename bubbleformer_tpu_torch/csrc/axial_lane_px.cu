// K9: the lane axial attention with the QKV projection inside the kernels,
// forward and backward, hand-written for Hopper (sm_90a), head dims 16 and 64.
//
// Replaces bubbleformer_tpu/ops/axial_lane.py:_fwd_kernel_px and
// _bwd_kernel_px (built by _make_lane_axial_px, custom VJP fused_fwd /
// fused_bwd, entry lane_axial_attention_from_x with proj="kernel" or
// BUBBLEFORMER_LANE_PROJ=kernel): K2 from the block's InstanceNorm1 output x
// (BT, H, W, C) and the QKV weight instead of a projected qkv.  Its point is
// memory: nothing 3C wide outlives a call.  The qkv is scratch of each call;
// the backward keeps only x, the weights and the tables from the forward and
// recomputes the projection, as the TPU kernel does (:452-460).
//
// Composed of the port's kernels, on one stream:
//   forward  (a) norm_proj_kernel without the InstanceNorm (block_ops.cuh):
//                qkv = dtype(x . dtype(W)^T + b), float32 sums; one
//                token-major qkv serves both directions, where the TPU kernel
//                projected once per token layout (the same values);
//            (b) the line kernels in K2's lane flavour (line_kernels.cuh),
//                rows then columns: out = dtype(0.5 (dtype(o_r) + dtype(o_c))).
//   backward (0) (a) again;
//            then per direction (rows, then columns):
//            (1) the line kernels' backward in the kLanePx flavour: that
//                direction's dqkv, qk-LN backward included, rounded to dtype
//                (the TPU kernel's bm=True dqkv over its qkv scratch,
//                :462-470), and the LN, table and scale gradients;
//            (2) wgrad_kernel: dW += dqkv^T . x, float32, never rounded
//                (:473-475: the TPU kernel hands its float32 accumulator to
//                the float32 parameter, where the XLA route rounds dW to the
//                activation dtype);
//            (3) plane_sums_kernel: db += sum dqkv, float32;
//            (4) gemm_nt_kernel: dx_dir = dtype(dqkv . W), written by the row
//                pass and added by the column pass in dtype (:477-480: each
//                layout's dx rounded, their sum in the activation dtype).
// Parameter gradients are float32 atomic sums: their last bits vary from run
// to run.
//
// What bounds it at FiLMAViT-small's training shape (BT = 40 images of 32x32
// tokens, C = 384): the projection 2*R*C*3C = 36 GFLOP forward (R = 40960
// tokens) and three such products backward (recompute, dW, dx), 109 GFLOP,
// beside K2's attention work (4 and 10 GFLOP), against 63 MB of x and out
// forward and 94 MB of x, dout and dx backward in bf16: the tensor cores,
// ~0.04 ms forward and ~0.12 ms backward at the bf16 peak.  This first
// version is far from that: the products run on block_gemm.cuh's WMMA tile
// from plainly staged operands and the attention on the CUDA cores, and the
// qkv scratch makes a round trip through device memory between them.  Left
// for later: the projection fused into the line kernels' staging (a line's
// qkv on chip), wgmma tiles, and one float32 sum of the two directions' dqkv
// for dW and db in place of two products.
#include "block_ops.cuh"
#include "line_kernels.cuh"

namespace bft {
namespace {

template <typename T, int D>
int run_lane_px_fwd(const T* x, const T* wqkv, const float* bqkv, const float* ln,
                    const float* bias_x, const float* bias_y, const float* scale, T* qkv,
                    float* row_out, T* out, int BT, int H, int W, int C, int heads,
                    cudaStream_t stream) {
  cudaError_t e;
  if ((e = launch_norm_proj<T, T, false>(x, nullptr, nullptr, nullptr, wqkv, bqkv, qkv, BT, H * W,
                                         C, 3 * C, stream)) != cudaSuccess)
    return e;
  AxialArgs a{};
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
  a.stream = stream;
  return line_attention_fwd<T, D, Flavour::kLane>(a);
}

template <typename T, int D>
int run_lane_px_bwd(const T* x, const T* dout, const T* wqkv, const T* wqkv_t, const float* bqkv,
                    const float* ln, const float* bias_x, const float* bias_y, const float* scale,
                    T* qkv, T* dqkv, float* stats, T* dx, float* dwqkv, float* dbqkv, float* dln,
                    float* dbias_x, float* dbias_y, float* dscale, int BT, int H, int W, int C,
                    int heads, cudaStream_t stream) {
  const int N = H * W, R = BT * N;
  cudaError_t e;
#define BFT_TRY(call) \
  if ((e = static_cast<cudaError_t>(call)) != cudaSuccess) return e
  // (0) the forward's qkv again
  BFT_TRY((launch_norm_proj<T, T, false>(x, nullptr, nullptr, nullptr, wqkv, bqkv, qkv, BT, N, C,
                                         3 * C, stream)));
  AxialArgs a{};
  a.qkv = qkv;
  a.dout = dout;
  a.ln = ln;
  a.bias_x = bias_x;
  a.bias_y = bias_y;
  a.scale = scale;
  a.dqkv = dqkv;
  a.stats = stats;
  a.dln = dln;
  a.dbias_x = dbias_x;
  a.dbias_y = dbias_y;
  a.dscale = dscale;
  a.BT = BT;
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  a.stream = stream;
  for (int pass = 0; pass < 2; ++pass) {
    // (1) this direction's dqkv
    BFT_TRY((line_attention_bwd_pass<T, D, Flavour::kLanePx>(a, pass)));
    // (2) dW += dqkv^T . x
    BFT_TRY((launch_wgrad<T, T, false>(dqkv, 3 * C, x, nullptr, nullptr, nullptr, C, BT, N, dwqkv,
                                       stream)));
    // (3) db += sum dqkv
    BFT_TRY((launch_plane_sums<T, float>(dqkv, nullptr, nullptr, BT, N, 3 * C, nullptr, nullptr,
                                         dbqkv, stream)));
    // (4) dx (=|+=) dtype(dqkv . W)
    if (pass == 0) {
      BFT_TRY((launch_gemm_nt<T, T, false>(dqkv, wqkv_t, dx, R, C, 3 * C, stream)));
    } else {
      BFT_TRY((launch_gemm_nt<T, T, true>(dqkv, wqkv_t, dx, R, C, 3 * C, stream)));
    }
  }
#undef BFT_TRY
  return cudaSuccess;
}

// The envelope: the line kernels' (head dim 16 or 64, lines of at most 512
// tokens) and the GEMM tile's (C a multiple of kKC).
bool px_shape_ok(int head_dim, int H, int W, int C, int heads) {
  return (head_dim == 16 || head_dim == 64) && C == heads * head_dim && H <= 512 && W <= 512 &&
         C % kKC == 0;
}

}  // namespace
}  // namespace bft

// x, out: (BT, H, W, C) in dtype; wqkv (3C, C) in dtype, torch (out, in)
// layout, heads-major [q|k|v] rows; bqkv (3C), ln (4, head_dim) = [q scale; q
// bias; k scale; k bias], bias_x (heads, W, W), bias_y (heads, H, H), scale
// (heads, 2) = [s_x, s_y], all float32.  Scratch: qkv (BT*H*W, 3C) in dtype,
// row_out (BT*H*W, C) float32.  head_dim 16 or 64, H and W at most 512,
// C % 32 == 0.  Returns a cudaError_t.
extern "C" int bf_axial_lane_px_fwd(int dtype, int head_dim, const void* x, const void* wqkv,
                                    const float* bqkv, const float* ln, const float* bias_x,
                                    const float* bias_y, const float* scale, void* qkv,
                                    float* row_out, void* out, int BT, int H, int W, int C,
                                    int heads, void* stream) {
  if (!bft::px_shape_ok(head_dim, H, W, C, heads)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BFT_RUN(T, D)                                                                          \
  return bft::run_lane_px_fwd<T, D>(static_cast<const T*>(x), static_cast<const T*>(wqkv), bqkv, \
                                    ln, bias_x, bias_y, scale, static_cast<T*>(qkv), row_out,   \
                                    static_cast<T*>(out), BT, H, W, C, heads, s)
  if (dtype == bft::kF32 && head_dim == 64) BFT_RUN(float, 64);
  if (dtype == bft::kF32 && head_dim == 16) BFT_RUN(float, 16);
  if (dtype == bft::kBF16 && head_dim == 64) BFT_RUN(__nv_bfloat16, 64);
  if (dtype == bft::kBF16 && head_dim == 16) BFT_RUN(__nv_bfloat16, 16);
#undef BFT_RUN
  return cudaErrorInvalidValue;
}

// x, dout, dx: (BT, H, W, C) in dtype; wqkv (3C, C) and wqkv_t (C, 3C), its
// transpose, in dtype; bqkv, ln, bias_x, bias_y, scale as for
// bf_axial_lane_px_fwd.  Scratch: qkv and dqkv (BT*H*W, 3C) in dtype, stats
// float32 (BT, heads, H, W, 3) where max(H, W) > 64 (else unused).  Outputs,
// float32 and zeroed by the caller except dx: dwqkv (3C, C), dbqkv (3C), dln
// (4, head_dim), dbias_x (heads, W, W), dbias_y (heads, H, H), dscale (heads,
// 2).  Returns a cudaError_t.
extern "C" int bf_axial_lane_px_bwd(int dtype, int head_dim, const void* x, const void* dout,
                                    const void* wqkv, const void* wqkv_t, const float* bqkv,
                                    const float* ln, const float* bias_x, const float* bias_y,
                                    const float* scale, void* qkv, void* dqkv, float* stats,
                                    void* dx, float* dwqkv, float* dbqkv, float* dln,
                                    float* dbias_x, float* dbias_y, float* dscale, int BT, int H,
                                    int W, int C, int heads, void* stream) {
  if (!bft::px_shape_ok(head_dim, H, W, C, heads)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BFT_RUN(T, D)                                                                           \
  return bft::run_lane_px_bwd<T, D>(                                                            \
      static_cast<const T*>(x), static_cast<const T*>(dout), static_cast<const T*>(wqkv),       \
      static_cast<const T*>(wqkv_t), bqkv, ln, bias_x, bias_y, scale, static_cast<T*>(qkv),     \
      static_cast<T*>(dqkv), stats, static_cast<T*>(dx), dwqkv, dbqkv, dln, dbias_x, dbias_y,   \
      dscale, BT, H, W, C, heads, s)
  if (dtype == bft::kF32 && head_dim == 64) BFT_RUN(float, 64);
  if (dtype == bft::kF32 && head_dim == 16) BFT_RUN(float, 16);
  if (dtype == bft::kBF16 && head_dim == 64) BFT_RUN(__nv_bfloat16, 64);
  if (dtype == bft::kBF16 && head_dim == 16) BFT_RUN(__nv_bfloat16, 16);
#undef BFT_RUN
  return cudaErrorInvalidValue;
}
