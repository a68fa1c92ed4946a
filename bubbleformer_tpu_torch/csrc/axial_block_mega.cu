// K5: the whole axial-attention branch, forward and backward, hand-written
// for Hopper (sm_90a), head dims 16 and 64.
//
// Replaces bubbleformer_tpu/ops/axial_block_mega.py:_fwd_kernel and
// _bwd_kernel (built by _make_mega_block, custom VJP fused_bwd, entry
// mega_axial_block): InstanceNorm1 -> QKV projection (C -> 3C, heads-major
// [q|k|v]) -> per-head qk-LayerNorm -> row and column attention (T5 tables,
// attn scales, mean of the two) -> InstanceNorm2 -> output projection, for
// each of the BT images.  The residual and the block's epilogue stay outside,
// as on the TPU.
//
// Split.  The TPU kernel held one whole image (H*W tokens x 3C) per grid step
// in VMEM; here the InstanceNorm statistics span a plane of H*W tokens and
// the attention spans whole rows and columns, so the branch runs as five
// launches of the kernels K1 and K4 already have:
//   (a) plane_stats_kernel (block_ops.cuh) over x: IN1's mean and rstd;
//   (b) norm_proj_kernel: IN1 applied and rounded while x is staged, times
//       dtype(W_qkv) on the GEMM tile, + b_qkv, rounded: the raw qkv, which
//       the backward reads again;
//   (c) the line kernels (line_kernels.cuh) in the kMega flavour, rows then
//       columns: K4's attention (qk-LN in the kernel, dtype(P), pv, the
//       window mean and the direction sum in float32), ao kept in float32
//       and also written rounded, the residual the backward reads (as the
//       TPU kernel's ao_ref, :182);
//   (d) plane_stats_kernel over ao: IN2's statistics;
//   (e) norm_proj_kernel: IN2 applied and rounded, times dtype(W_out),
//       + b_out, rounded.
// Rounding follows the TPU kernel (axial_block_mega.py:159-190): xn, qkv,
// q/k after their LN, P, y2 and out in the activation dtype; ao and every
// statistic in float32.
//
// Backward, twelve launches on one stream, K1's backward with K4's attention
// backward in its middle: (0) IN2's statistics again, from the rounded ao
// residual, (1) dy2 = do . W_out, (2) dW_out += do^T . IN2(ao), (3) db_out,
// (4) IN2's backward sums and d(in2 scale, bias), (5) dao = dtype(IN2
// backward of dy2), (6) the line kernels' backward in the fused_block flavour
// from the forward's qkv (K4's: f32 sums of both directions, the qk-LN
// backward, dqkv rounded once; the tables', scales' and LN gradients), (7)
// dW_qkv += dqkv^T . IN1(x), (8) db_qkv, (9) dxn = dqkv . W_qkv, (10) IN1's
// backward sums and d(in1 scale, bias), (11) dx.  IN2 is recomputed from the
// rounded ao, as the TPU kernel does (:182, :236), where the forward
// normalised the float32 one: in bfloat16 this backward is the TPU
// kernel's, not exactly the gradient of the forward (ROADMAP.md, Queue 3).
// Parameter gradients are float32 atomic sums: their last bits vary from run
// to run.
//
// What bounds it at FiLMAViT-small's training shape (BT = 40 images of 32x32
// tokens, C = 384): the two products 2*R*C*4C = 9.7 GFLOP forward and twice
// that backward for R = 40960 tokens, the attention ~1.3 and ~3.2 GFLOP, and
// ~140 MB of activations, residuals and gradients in bf16 and float32: the
// tensor cores and memory about equally on paper (~0.03 ms each).  This
// first version is far from both: its products run on WMMA from plainly
// staged tiles (as K1's do) and the attention on the CUDA cores (as K4's
// does).  Left for later: wgmma/TMA tiles, IN2 fused into the attention's
// column pass, ao kept on chip.
#include "block_ops.cuh"
#include "line_kernels.cuh"

namespace bft {
namespace {

template <typename T, int D>
int run_mega_axial_fwd(const T* x, const float* in1_w, const float* in1_b, const T* wqkv,
                       const float* bqkv, const float* ln, const float* in2_w,
                       const float* in2_b, const T* wout, const float* bout,
                       const float* bias_x, const float* bias_y, const float* scale,
                       float* stats1, T* qkv, float* ao, T* ao_r, float* stats2, T* out, int BT,
                       int H, int W, int C, int heads, cudaStream_t stream) {
  const int N = H * W;
  cudaError_t e;
#define BFT_TRY(call) \
  if ((e = static_cast<cudaError_t>(call)) != cudaSuccess) return e
  // (a), (b): IN1 statistics, then qkv = dtype(IN1(x) . W_qkv^T + b_qkv).
  BFT_TRY((launch_plane_stats<T>(x, BT, N, C, stats1, stream)));
  BFT_TRY((launch_norm_proj<T, T>(x, stats1, in1_w, in1_b, wqkv, bqkv, qkv, BT, N, C, 3 * C,
                                  stream)));
  // (c): the attention, ao in float32 (row pass, then the column pass in place).
  AxialArgs a{};
  a.qkv = qkv;
  a.ln = ln;
  a.bias_x = bias_x;
  a.bias_y = bias_y;
  a.scale = scale;
  a.row_out = ao;
  a.out = ao_r;
  a.BT = BT;
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  a.stream = stream;
  BFT_TRY((line_attention_fwd<T, D, Flavour::kMega>(a)));
  // (d), (e): IN2 statistics, then out = dtype(IN2(ao) . W_out^T + b_out).
  BFT_TRY((launch_plane_stats<float>(ao, BT, N, C, stats2, stream)));
  BFT_TRY((launch_norm_proj<T, float>(ao, stats2, in2_w, in2_b, wout, bout, out, BT, N, C, C,
                                      stream)));
#undef BFT_TRY
  return cudaSuccess;
}

template <typename T, int D>
int run_mega_axial_bwd(const T* x, const T* dout, const T* qkv, const float* in1_w,
                       const float* in1_b, const T* wqkv_t, const float* ln, const float* in2_w,
                       const float* in2_b, const T* wout_t, const float* bias_x,
                       const float* bias_y, const float* scale, const float* stats1,
                       const T* ao_r, float* stats2, float* work, float* sums, T* dao,
                       T* dqkv, float* dacc, float* lstats, T* dx, float* din1, float* dwqkv,
                       float* dbqkv, float* dln, float* din2, float* dwout, float* dbout,
                       float* dbias_x, float* dbias_y, float* dscale, int BT, int H, int W,
                       int C, int heads, cudaStream_t stream) {
  const int N = H * W, R = BT * N;
  cudaError_t e;
#define BFT_TRY(call) \
  if ((e = static_cast<cudaError_t>(call)) != cudaSuccess) return e
  // (0) IN2's statistics of the rounded ao
  BFT_TRY((launch_plane_stats<T>(ao_r, BT, N, C, stats2, stream)));
  // (1) dy2 = do . W_out
  BFT_TRY((launch_gemm_nt<T, float>(dout, wout_t, work, R, C, C, stream)));
  // (2) dW_out += do^T . IN2(ao)
  BFT_TRY((launch_wgrad<T, T, true>(dout, C, ao_r, stats2, in2_w, in2_b, C, BT, N, dwout,
                                    stream)));
  // (3) db_out
  BFT_TRY((launch_plane_sums<T, float>(dout, nullptr, nullptr, BT, N, C, nullptr, nullptr, dbout,
                                       stream)));
  // (4) IN2 backward sums; d(in2 scale, bias)
  BFT_TRY((launch_plane_sums<float, T>(work, ao_r, stats2, BT, N, C, sums, din2, din2 + C,
                                       stream)));
  // (5) dao = dtype(IN2 backward of dy2)
  BFT_TRY((launch_in_apply<T, T>(work, ao_r, stats2, in2_w, sums, dao, BT, N, C, stream)));
  // (6) the attention backward -> dqkv, dln, the tables' and scales' gradients
  AxialArgs a{};
  a.qkv = qkv;
  a.dout = dao;
  a.ln = ln;
  a.bias_x = bias_x;
  a.bias_y = bias_y;
  a.scale = scale;
  a.dqkv = dqkv;
  a.dacc = dacc;
  a.stats = lstats;
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
  BFT_TRY((line_attention_bwd<T, D, Flavour::kFusedBlock>(a)));
  // (7) dW_qkv += dqkv^T . IN1(x)
  BFT_TRY((launch_wgrad<T, T, true>(dqkv, 3 * C, x, stats1, in1_w, in1_b, C, BT, N, dwqkv,
                                    stream)));
  // (8) db_qkv
  BFT_TRY((launch_plane_sums<T, float>(dqkv, nullptr, nullptr, BT, N, 3 * C, nullptr, nullptr,
                                       dbqkv, stream)));
  // (9) dxn = dqkv . W_qkv
  BFT_TRY((launch_gemm_nt<T, float>(dqkv, wqkv_t, work, R, C, 3 * C, stream)));
  // (10) IN1 backward sums; d(in1 scale, bias)
  BFT_TRY((launch_plane_sums<float, T>(work, x, stats1, BT, N, C, sums, din1, din1 + C, stream)));
  // (11) dx
  BFT_TRY((launch_in_apply<T, T>(work, x, stats1, in1_w, sums, dx, BT, N, C, stream)));
#undef BFT_TRY
  return cudaSuccess;
}

bool mega_shape_ok(int head_dim, int H, int W, int C, int heads) {
  return (head_dim == 16 || head_dim == 64) && C == heads * head_dim && H <= 512 && W <= 512 &&
         C % kKC == 0;
}

}  // namespace
}  // namespace bft

// x, out: (BT, H, W, C) in dtype; wqkv (3C, C) and wout (C, C) in dtype, torch
// (out, in) layout; in1_w, in1_b, in2_w, in2_b (C), bqkv (3C), bout (C), ln
// (4, head_dim) = [q scale; q bias; k scale; k bias], bias_x (heads, W, W),
// bias_y (heads, H, H), scale (heads, 2) = [s_x, s_y], all float32.  Also
// written, for the backward: stats1 (2, BT, C) in float32, the rounded raw
// qkv (BT*H*W, 3C) and the rounded attention output ao_r (BT*H*W, C) in
// dtype.  Scratch: ao (BT*H*W, C) and stats2 (2, BT, C) float32.  head_dim 16
// or 64, H and W at most 512, C % 32 == 0.  Returns a cudaError_t.
extern "C" int bf_axial_block_mega_fwd(int dtype, int head_dim, const void* x,
                                       const float* in1_w, const float* in1_b, const void* wqkv,
                                       const float* bqkv, const float* ln, const float* in2_w,
                                       const float* in2_b, const void* wout, const float* bout,
                                       const float* bias_x, const float* bias_y,
                                       const float* scale, float* stats1, void* qkv, float* ao,
                                       void* ao_r, float* stats2, void* out, int BT, int H,
                                       int W, int C, int heads, void* stream) {
  if (!bft::mega_shape_ok(head_dim, H, W, C, heads)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BFT_ARGS(T)                                                                          \
  static_cast<const T*>(x), in1_w, in1_b, static_cast<const T*>(wqkv), bqkv, ln, in2_w, in2_b, \
      static_cast<const T*>(wout), bout, bias_x, bias_y, scale, stats1, static_cast<T*>(qkv),  \
      ao, static_cast<T*>(ao_r), stats2, static_cast<T*>(out), BT, H, W, C, heads, s
  using bf16 = __nv_bfloat16;
  if (dtype == bft::kF32 && head_dim == 64)
    return bft::run_mega_axial_fwd<float, 64>(BFT_ARGS(float));
  if (dtype == bft::kF32 && head_dim == 16)
    return bft::run_mega_axial_fwd<float, 16>(BFT_ARGS(float));
  if (dtype == bft::kBF16 && head_dim == 64)
    return bft::run_mega_axial_fwd<bf16, 64>(BFT_ARGS(bf16));
  if (dtype == bft::kBF16 && head_dim == 16)
    return bft::run_mega_axial_fwd<bf16, 16>(BFT_ARGS(bf16));
#undef BFT_ARGS
  return cudaErrorInvalidValue;
}

// x, dout, dx: (BT, H, W, C) in dtype; stats1, qkv and ao_r from
// bf_axial_block_mega_fwd; wqkv_t (C, 3C) and wout_t (C, C) in dtype
// (transposes of the torch weights); the other parameters as for
// bf_axial_block_mega_fwd.  Scratch: stats2 (2, BT, C), work (BT*H*W, C) and
// sums (2, BT, C) float32, dao (BT*H*W, C) and dqkv (BT*H*W, 3C) in dtype,
// dacc (BT*H*W, 3C) float32, lstats float32 (BT, heads, H, W, 3) where
// max(H, W) > 64 (else unused).  Outputs, float32 and zeroed by the caller
// except dx: din1 (2, C) = [scale; bias], dwqkv (3C, C), dbqkv (3C), dln (4,
// head_dim), din2 (2, C), dwout (C, C), dbout (C), dbias_x (heads, W, W),
// dbias_y (heads, H, H), dscale (heads, 2).  Returns a cudaError_t.
extern "C" int bf_axial_block_mega_bwd(
    int dtype, int head_dim, const void* x, const void* dout, const void* qkv,
    const float* in1_w, const float* in1_b, const void* wqkv_t, const float* ln,
    const float* in2_w, const float* in2_b, const void* wout_t, const float* bias_x,
    const float* bias_y, const float* scale, const float* stats1, const void* ao_r,
    float* stats2, float* work, float* sums, void* dao, void* dqkv, float* dacc,
    float* lstats, void* dx, float* din1, float* dwqkv, float* dbqkv, float* dln, float* din2,
    float* dwout, float* dbout, float* dbias_x, float* dbias_y, float* dscale, int BT, int H,
    int W, int C, int heads, void* stream) {
  if (!bft::mega_shape_ok(head_dim, H, W, C, heads)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BFT_ARGS(T)                                                                            \
  static_cast<const T*>(x), static_cast<const T*>(dout), static_cast<const T*>(qkv), in1_w,    \
      in1_b, static_cast<const T*>(wqkv_t), ln, in2_w, in2_b, static_cast<const T*>(wout_t),   \
      bias_x, bias_y, scale, stats1, static_cast<const T*>(ao_r), stats2, work, sums,         \
      static_cast<T*>(dao),                                                                    \
      static_cast<T*>(dqkv), dacc, lstats, static_cast<T*>(dx), din1, dwqkv, dbqkv, dln, din2, \
      dwout, dbout, dbias_x, dbias_y, dscale, BT, H, W, C, heads, s
  using bf16 = __nv_bfloat16;
  if (dtype == bft::kF32 && head_dim == 64)
    return bft::run_mega_axial_bwd<float, 64>(BFT_ARGS(float));
  if (dtype == bft::kF32 && head_dim == 16)
    return bft::run_mega_axial_bwd<float, 16>(BFT_ARGS(float));
  if (dtype == bft::kBF16 && head_dim == 64)
    return bft::run_mega_axial_bwd<bf16, 64>(BFT_ARGS(bf16));
  if (dtype == bft::kBF16 && head_dim == 16)
    return bft::run_mega_axial_bwd<bf16, 16>(BFT_ARGS(bf16));
#undef BFT_ARGS
  return cudaErrorInvalidValue;
}
