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
// the attention spans whole rows and columns, so the branch runs as a chain
// of launches on one stream.  Rounding follows the TPU kernel
// (axial_block_mega.py:159-190): xn, qkv, q/k after their LN, P, y2 and out
// in the activation dtype; ao and every statistic in float32.
//
// bf16 (the training dtype) is K1's Hopper chain (temporal_block.cu:
// run_temporal_block_hopper) with the axial attention in its middle:
//   (a)  plane_stats: IN1's statistics of x;
//   (a') in_norm: xn = bf16(IN1(x)) into the scratch xs;
//   (b)  gemm_nt, kBiasRound (hopper_gemm.cuh): qkv = bf16(xn . W_qkv^T +
//        b_qkv), the backward's residual;
//   (c)  the attention on lane_hopper.cuh's tensor-core kernels in their
//        kMega rounding (P rounded as the operand of P v, o = s pv + (1 - s)
//        mean(v) in float32), rows then columns: the row pass writes 0.5 o_r
//        into the float32 ao, the column pass adds 0.5 o_c and writes ao and
//        ao rounded, the residual the backward reads (the TPU kernel's
//        ao_ref, :182);
//   (d)  plane_stats: IN2's statistics of the float32 ao;
//   (d') in_norm: y2 = bf16(IN2(ao)) into xs;
//   (e)  gemm_nt, kBiasRound: out = bf16(y2 . W_out^T + b_out).
// Backward, K1's Hopper backward (temporal_block_bwd.cu:
// run_temporal_block_bwd_hopper) with the axial attention's in its middle:
//   (0)  plane_stats: IN2's statistics again, from the rounded ao;
//   (1)  gemm_nt, kStoreF32: dy2 = do . W_out (float32 work);
//   (2)  in_norm: y2 = bf16(IN2(ao)) into xs;
//   (3)  gemm_tn_splitk: dW_out = do^T . y2, token ranges summed in order;
//   (4)  db_out: per-plane sums of do, then their totals in plane order;
//   (5)  IN2's backward sums per plane, d(in2 scale, bias) their totals;
//   (6)  in_apply8: dao = bf16(IN2 backward of dy2), eight channels a thread;
//   (7)  the attention backward on lane_hopper.cuh in the kMega rounding
//        (K4's, axial_fused_block.py:116-135): the row pass keeps its d(q,
//        k, v) before the qk-LN in the float32 scratch dacc, the column pass
//        adds its own, runs the qk-LN backward once and rounds dqkv once;
//        the table, scale and LN gradients from per-block partials added in
//        a fixed order;
//   (8)  in_norm: xn = bf16(IN1(x)) into xs;
//   (9)  gemm_tn_splitk: dW_qkv = dqkv^T . xn;
//   (10) db_qkv: per-plane sums, then their totals;
//   (11) gemm_nt, kStoreF32: dxn = dqkv . W_qkv (float32 work);
//   (12) IN1's backward sums per plane, d(in1 scale, bias) their totals;
//   (13) in_apply8: dx.
// No parameter gradient of the bf16 chain touches an atomic: every one
// repeats bit for bit from run to run.  IN2 is recomputed from the rounded
// ao, as the TPU kernel does (:182, :236), where the forward normalised the
// float32 one: in bfloat16 this backward is the TPU kernel's, not exactly
// the gradient of the forward (ROADMAP.md, Queue 3).
//
// float32 keeps the first version's chain: plane_stats and norm_proj_kernel
// (block_ops.cuh) for IN1 and the QKV product, the line kernels
// (line_kernels.cuh) in the kMega flavour, plane_stats and norm_proj for IN2
// and the output product; backward the same twelve launches with the line
// kernels' fused_block backward, the products on block_gemm.cuh's FMA tile
// and the weight, bias and InstanceNorm gradients float32 atomic sums (the
// table, scale and LN gradients are the line kernels' fixed-order sums).
//
// What bounds it at FiLMAViT-small's training shape (BT = 40 images of 32x32
// tokens, C = 384): the two products 2*R*C*4C = 9.7 GFLOP forward and twice
// that backward for R = 40960 tokens, the attention ~1.3 and ~3.2 GFLOP, and
// ~140 MB of activations, residuals and gradients in bf16 and float32: the
// tensor cores and memory about equally on paper (~0.03 ms each).  The bf16
// chain moves more than that: xs, qkv, the float32 ao and dacc, dy2 and dxn
// make round trips through device memory between its launches (~0.6 GB
// backward); fusing IN2 into the attention's column pass and keeping ao on
// chip is left for later.
#include "block_ops.cuh"
#include "hopper_gemm.cuh"
#include "lane_hopper.cuh"
#include "line_kernels.cuh"
#include "temporal_hopper.cuh"

namespace bft {
namespace {

using bf16 = __nv_bfloat16;

template <int D>
int run_mega_axial_fwd(const float* x, const float* in1_w, const float* in1_b, const float* wqkv,
                       const float* bqkv, const float* ln, const float* in2_w,
                       const float* in2_b, const float* wout, const float* bout,
                       const float* bias_x, const float* bias_y, const float* scale,
                       float* stats1, float* qkv, float* ao, float* ao_r, float* stats2,
                       float* out, int BT, int H, int W, int C, int heads, cudaStream_t stream) {
  const int N = H * W;
  cudaError_t e;
#define BFT_TRY(call) \
  if ((e = static_cast<cudaError_t>(call)) != cudaSuccess) return e
  // IN1 statistics, then qkv = IN1(x) . W_qkv^T + b_qkv.
  BFT_TRY((launch_plane_stats<float>(x, BT, N, C, stats1, stream)));
  BFT_TRY((launch_norm_proj<float, float>(x, stats1, in1_w, in1_b, wqkv, bqkv, qkv, BT, N, C,
                                          3 * C, stream)));
  // The attention, ao in float32 (row pass, then the column pass in place).
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
  BFT_TRY((line_attention_fwd<float, D, Flavour::kMega>(a)));
  // IN2 statistics, then out = IN2(ao) . W_out^T + b_out.
  BFT_TRY((launch_plane_stats<float>(ao, BT, N, C, stats2, stream)));
  BFT_TRY((launch_norm_proj<float, float>(ao, stats2, in2_w, in2_b, wout, bout, out, BT, N, C, C,
                                          stream)));
#undef BFT_TRY
  return cudaSuccess;
}

template <int D>
int run_mega_axial_bwd(const float* x, const float* dout, const float* qkv, const float* in1_w,
                       const float* in1_b, const float* wqkv_t, const float* ln,
                       const float* in2_w, const float* in2_b, const float* wout_t,
                       const float* bias_x, const float* bias_y, const float* scale,
                       const float* stats1, const float* ao_r, float* stats2, float* work,
                       float* sums, float* dao, float* dqkv, float* dacc, float* lstats,
                       float* part, const int (&groups)[2], const int (&per)[2], float* dx,
                       float* din1, float* dwqkv, float* dbqkv, float* dln, float* din2,
                       float* dwout, float* dbout, float* dbias_x, float* dbias_y, float* dscale,
                       int BT, int H, int W, int C, int heads, cudaStream_t stream) {
  const int N = H * W, R = BT * N;
  cudaError_t e;
#define BFT_TRY(call) \
  if ((e = static_cast<cudaError_t>(call)) != cudaSuccess) return e
  // IN2's statistics of the rounded ao
  BFT_TRY((launch_plane_stats<float>(ao_r, BT, N, C, stats2, stream)));
  // dy2 = do . W_out
  BFT_TRY((launch_gemm_nt<float, float>(dout, wout_t, work, R, C, C, stream)));
  // dW_out += do^T . IN2(ao)
  BFT_TRY((launch_wgrad<float, float, true>(dout, C, ao_r, stats2, in2_w, in2_b, C, BT, N, dwout,
                                            stream)));
  // db_out
  BFT_TRY((launch_plane_sums<float, float>(dout, nullptr, nullptr, BT, N, C, nullptr, nullptr,
                                           dbout, stream)));
  // IN2 backward sums; d(in2 scale, bias)
  BFT_TRY((launch_plane_sums<float, float>(work, ao_r, stats2, BT, N, C, sums, din2, din2 + C,
                                           stream)));
  // dao = IN2 backward of dy2
  BFT_TRY((launch_in_apply<float, float>(work, ao_r, stats2, in2_w, sums, dao, BT, N, C,
                                         stream)));
  // the attention backward -> dqkv, dln, the tables' and scales' gradients
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
  a.part = part;
  for (int p = 0; p < 2; ++p) {
    a.groups[p] = groups[p];
    a.per[p] = per[p];
  }
  a.BT = BT;
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  a.stream = stream;
  BFT_TRY((line_attention_bwd<float, D, Flavour::kFusedBlock>(a)));
  // dW_qkv += dqkv^T . IN1(x)
  BFT_TRY((launch_wgrad<float, float, true>(dqkv, 3 * C, x, stats1, in1_w, in1_b, C, BT, N,
                                            dwqkv, stream)));
  // db_qkv
  BFT_TRY((launch_plane_sums<float, float>(dqkv, nullptr, nullptr, BT, N, 3 * C, nullptr,
                                           nullptr, dbqkv, stream)));
  // dxn = dqkv . W_qkv
  BFT_TRY((launch_gemm_nt<float, float>(dqkv, wqkv_t, work, R, C, 3 * C, stream)));
  // IN1 backward sums; d(in1 scale, bias)
  BFT_TRY((launch_plane_sums<float, float>(work, x, stats1, BT, N, C, sums, din1, din1 + C,
                                           stream)));
  // dx
  BFT_TRY((launch_in_apply<float, float>(work, x, stats1, in1_w, sums, dx, BT, N, C, stream)));
#undef BFT_TRY
  return cudaSuccess;
}

// K5's bf16 forward, launches (a)-(e) of the file comment.
template <int D>
int run_mega_hopper_fwd(const bf16* x, const float* in1_w, const float* in1_b, const bf16* wqkv,
                        const float* bqkv, const float* ln, const float* in2_w,
                        const float* in2_b, const bf16* wout, const float* bout,
                        const float* bias_x, const float* bias_y, const float* scale,
                        float* stats1, bf16* qkv, float* ao, bf16* ao_r, float* stats2, bf16* xs,
                        bf16* out, int BT, int H, int W, int C, int heads, cudaStream_t stream) {
  const int N = H * W, R = BT * N;
  cudaError_t e;
#define BFT_TRY(call) \
  if ((e = static_cast<cudaError_t>(call)) != cudaSuccess) return e
  BFT_TRY(launch_plane_stats<bf16>(x, BT, N, C, stats1, stream));
  BFT_TRY(launch_in_norm(x, stats1, in1_w, in1_b, xs, BT, N, C, stream));
  BFT_TRY(hg::gemm_nt<hg::kBiasRound>(xs, C, wqkv, C, R, 3 * C, C, qkv, 3 * C, bqkv, stream));
  lane::FwdArgs a{};
  a.qkv = qkv;
  a.ln = ln;
  a.bias_x = bias_x;
  a.bias_y = bias_y;
  a.scale = scale;
  a.out = ao_r;
  a.ao = ao;
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  BFT_TRY((lane::lane_fwd<D, lane::Mode::kMega>(a, BT, stream)));
  BFT_TRY(launch_plane_stats<float>(ao, BT, N, C, stats2, stream));
  BFT_TRY(launch_in_norm(static_cast<const float*>(ao), stats2, in2_w, in2_b, xs, BT, N, C,
                         stream));
  BFT_TRY(hg::gemm_nt<hg::kBiasRound>(xs, C, wout, C, R, C, C, out, C, bout, stream));
#undef BFT_TRY
  return cudaSuccess;
}

// K5's bf16 backward, launches (0)-(13) of the file comment.
template <int D>
int run_mega_hopper_bwd(const bf16* x, const bf16* dout, const bf16* qkv, const float* in1_w,
                        const float* in1_b, const bf16* wqkv_t, const float* ln,
                        const float* in2_w, const float* in2_b, const bf16* wout_t,
                        const float* bias_x, const float* bias_y, const float* scale,
                        const float* stats1, const bf16* ao_r, float* stats2, float* work,
                        float* sums, bf16* dao, bf16* dqkv, float* dacc, bf16* xs,
                        float* part_w, const int* bounds_out, int splits_out,
                        const int* bounds_qkv, int splits_qkv, float* lane_part,
                        const int (&groups)[2], const int (&per)[2], bf16* dx, float* din1,
                        float* dwqkv, float* dbqkv, float* dln, float* din2, float* dwout,
                        float* dbout, float* dbias_x, float* dbias_y, float* dscale, int BT,
                        int H, int W, int C, int heads, cudaStream_t stream) {
  const int N = H * W, R = BT * N;
  cudaError_t e;
#define BFT_TRY(call) \
  if ((e = static_cast<cudaError_t>(call)) != cudaSuccess) return e
  BFT_TRY((launch_plane_stats<bf16>(ao_r, BT, N, C, stats2, stream)));
  BFT_TRY((hg::gemm_nt<hg::kStoreF32>(dout, C, wout_t, C, R, C, C, work, C, nullptr, stream)));
  BFT_TRY((launch_in_norm(ao_r, stats2, in2_w, in2_b, xs, BT, N, C, stream)));
  BFT_TRY((hg::gemm_tn_splitk(dout, xs, R, C, C, bounds_out, splits_out, part_w, dwout, stream)));
  BFT_TRY((launch_plane_sums<bf16, float>(dout, nullptr, nullptr, BT, N, C, sums, nullptr,
                                          nullptr, stream)));
  BFT_TRY((launch_plane_totals(sums, BT, C, dbout, nullptr, stream)));
  BFT_TRY((launch_plane_sums<float, bf16>(work, ao_r, stats2, BT, N, C, sums, nullptr, nullptr,
                                          stream)));
  BFT_TRY((launch_plane_totals(sums, BT, C, din2 + C, din2, stream)));
  BFT_TRY((launch_in_apply8(work, ao_r, stats2, in2_w, sums, dao, BT, N, C, stream)));
  lane::BwdArgs a{};
  a.qkv = qkv;
  a.dout = dao;
  a.ln = ln;
  a.bias_x = bias_x;
  a.bias_y = bias_y;
  a.scale = scale;
  a.dqkv = dqkv;
  a.dacc = dacc;
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  BFT_TRY((lane::lane_bwd<D, lane::Mode::kMega>(
      a, BT, groups, per, lane::carve_partials(lane_part, groups, heads, H, W, D), dbias_x,
      dbias_y, dscale, dln, stream)));
  BFT_TRY((launch_in_norm(x, stats1, in1_w, in1_b, xs, BT, N, C, stream)));
  BFT_TRY((hg::gemm_tn_splitk(dqkv, xs, R, 3 * C, C, bounds_qkv, splits_qkv, part_w, dwqkv,
                              stream)));
  BFT_TRY((launch_plane_sums<bf16, float>(dqkv, nullptr, nullptr, BT, N, 3 * C, sums, nullptr,
                                          nullptr, stream)));
  BFT_TRY((launch_plane_totals(sums, BT, 3 * C, dbqkv, nullptr, stream)));
  BFT_TRY((hg::gemm_nt<hg::kStoreF32>(dqkv, 3 * C, wqkv_t, 3 * C, R, C, 3 * C, work, C, nullptr,
                                      stream)));
  BFT_TRY((launch_plane_sums<float, bf16>(work, x, stats1, BT, N, C, sums, nullptr, nullptr,
                                          stream)));
  BFT_TRY((launch_plane_totals(sums, BT, C, din1 + C, din1, stream)));
  BFT_TRY((launch_in_apply8(work, x, stats1, in1_w, sums, dx, BT, N, C, stream)));
#undef BFT_TRY
  return cudaSuccess;
}

bool mega_shape_ok(int head_dim, int H, int W, int C, int heads) {
  return (head_dim == 16 || head_dim == 64) && C == heads * head_dim && H >= 1 && W >= 1 &&
         H <= 512 && W <= 512 && C % kKC == 0;
}

}  // namespace
}  // namespace bft

// float32.  x, out: (BT, H, W, C); wqkv (3C, C) and wout (C, C), torch (out,
// in) layout; in1_w, in1_b, in2_w, in2_b (C), bqkv (3C), bout (C), ln (4,
// head_dim) = [q scale; q bias; k scale; k bias], bias_x (heads, W, W),
// bias_y (heads, H, H), scale (heads, 2) = [s_x, s_y].  Also written, for the
// backward: stats1 (2, BT, C), the raw qkv (BT*H*W, 3C) and the attention
// output ao_r (BT*H*W, C).  Scratch: ao (BT*H*W, C) and stats2 (2, BT, C).
// head_dim 16 or 64, H and W at most 512, C % 32 == 0.  Returns a
// cudaError_t.
extern "C" int bf_axial_block_mega_fwd(int head_dim, const float* x, const float* in1_w,
                                       const float* in1_b, const float* wqkv, const float* bqkv,
                                       const float* ln, const float* in2_w, const float* in2_b,
                                       const float* wout, const float* bout, const float* bias_x,
                                       const float* bias_y, const float* scale, float* stats1,
                                       float* qkv, float* ao, float* ao_r, float* stats2,
                                       float* out, int BT, int H, int W, int C, int heads,
                                       void* stream) {
  if (!bft::mega_shape_ok(head_dim, H, W, C, heads)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BFT_RUN(D)                                                                             \
  return bft::run_mega_axial_fwd<D>(x, in1_w, in1_b, wqkv, bqkv, ln, in2_w, in2_b, wout, bout, \
                                    bias_x, bias_y, scale, stats1, qkv, ao, ao_r, stats2, out, \
                                    BT, H, W, C, heads, s)
  if (head_dim == 64) BFT_RUN(64);
  BFT_RUN(16);
#undef BFT_RUN
}

// float32.  x, dout, dx: (BT, H, W, C); stats1, qkv and ao_r from
// bf_axial_block_mega_fwd; wqkv_t (C, 3C) and wout_t (C, C) (transposes of
// the torch weights); the other parameters as for bf_axial_block_mega_fwd.
// Scratch: stats2 (2, BT, C), work (BT*H*W, C), sums (2, BT, C), dao (BT*H*W,
// C), dqkv (BT*H*W, 3C), dacc (BT*H*W, 3C), lstats (BT, heads, H, W, 3) where
// max(H, W) > 64 (else unused), part the line kernels' partials of the plan
// (groups_r, per_r) and (groups_c, per_c) (line_kernels.cuh:
// line_bwd_plans).  Outputs: din1 (2, C) = [scale; bias], dwqkv (3C, C),
// dbqkv (3C), din2 (2, C), dwout (C, C), dbout (C), zeroed by the caller;
// dln (4, head_dim), dbias_x (heads, W, W), dbias_y (heads, H, H), dscale
// (heads, 2), written whole.  Returns a cudaError_t.
extern "C" int bf_axial_block_mega_bwd(
    int head_dim, const float* x, const float* dout, const float* qkv, const float* in1_w,
    const float* in1_b, const float* wqkv_t, const float* ln, const float* in2_w,
    const float* in2_b, const float* wout_t, const float* bias_x, const float* bias_y,
    const float* scale, const float* stats1, const float* ao_r, float* stats2, float* work,
    float* sums, float* dao, float* dqkv, float* dacc, float* lstats, float* part, int groups_r,
    int per_r, int groups_c, int per_c, float* dx, float* din1, float* dwqkv, float* dbqkv,
    float* dln, float* din2, float* dwout, float* dbout, float* dbias_x, float* dbias_y,
    float* dscale, int BT, int H, int W, int C, int heads, void* stream) {
  if (!bft::mega_shape_ok(head_dim, H, W, C, heads)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups[2] = {groups_r, groups_c}, per[2] = {per_r, per_c};
#define BFT_RUN(D)                                                                              \
  return bft::run_mega_axial_bwd<D>(x, dout, qkv, in1_w, in1_b, wqkv_t, ln, in2_w, in2_b,       \
                                    wout_t, bias_x, bias_y, scale, stats1, ao_r, stats2, work,  \
                                    sums, dao, dqkv, dacc, lstats, part, groups, per, dx, din1, \
                                    dwqkv, dbqkv, dln, din2, dwout, dbout, dbias_x, dbias_y,    \
                                    dscale, BT, H, W, C, heads, s)
  if (head_dim == 64) BFT_RUN(64);
  BFT_RUN(16);
#undef BFT_RUN
}

// bf16.  x, out (BT, H, W, C), wqkv (3C, C) and wout (C, C) bf16; the float32
// parameters, stats1, ao and stats2 as for bf_axial_block_mega_fwd; qkv
// (BT*H*W, 3C) and ao_r (BT*H*W, C) bf16 (the backward's residuals with
// stats1); xs a (BT*H*W, C) bf16 scratch.  Every base 16-byte aligned.
// Returns a cudaError_t.
extern "C" int bf_mega_hopper_fwd(int head_dim, const void* x, const float* in1_w,
                                  const float* in1_b, const void* wqkv, const float* bqkv,
                                  const float* ln, const float* in2_w, const float* in2_b,
                                  const void* wout, const float* bout, const float* bias_x,
                                  const float* bias_y, const float* scale, float* stats1,
                                  void* qkv, float* ao, void* ao_r, float* stats2, void* xs,
                                  void* out, int BT, int H, int W, int C, int heads,
                                  void* stream) {
  using bf16 = __nv_bfloat16;
  if (!bft::mega_shape_ok(head_dim, H, W, C, heads)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BFT_RUN(D)                                                                              \
  return bft::run_mega_hopper_fwd<D>(                                                           \
      static_cast<const bf16*>(x), in1_w, in1_b, static_cast<const bf16*>(wqkv), bqkv, ln,      \
      in2_w, in2_b, static_cast<const bf16*>(wout), bout, bias_x, bias_y, scale, stats1,        \
      static_cast<bf16*>(qkv), ao, static_cast<bf16*>(ao_r), stats2, static_cast<bf16*>(xs),    \
      static_cast<bf16*>(out), BT, H, W, C, heads, s)
  if (head_dim == 64) BFT_RUN(64);
  BFT_RUN(16);
#undef BFT_RUN
}

// bf16.  x, dout, dx (BT, H, W, C), qkv and ao_r from bf_mega_hopper_fwd,
// wqkv_t (C, 3C) and wout_t (C, C) bf16; the float32 parameters and stats1
// as for bf_mega_hopper_fwd.  Scratch: stats2 (2, BT, C), work (BT*H*W, C),
// sums (2, BT, 3C), dacc (BT*H*W, 3C), part_w (max(splits_out * C,
// splits_qkv * 3C) * C) and lane_part (lane_hopper.cuh: carve_partials, for
// the plan (groups_r, per_r) of the BT * H rows and (groups_c, per_c) of the
// BT * W columns) float32; dao and xs (BT*H*W, C) and dqkv (BT*H*W, 3C)
// bf16; bounds_out and bounds_qkv host arrays of splits + 1 token bounds (0,
// multiples of 64, BT*H*W) for dW_out and dW_qkv.  Outputs, float32, written
// whole: din1 (2, C) = [scale; bias], dwqkv (3C, C), dbqkv (3C), dln (4,
// head_dim), din2 (2, C), dwout (C, C), dbout (C), dbias_x (heads, W, W),
// dbias_y (heads, H, H), dscale (heads, 2).  Every base 16-byte aligned.
// Returns a cudaError_t.
extern "C" int bf_mega_hopper_bwd(
    int head_dim, const void* x, const void* dout, const void* qkv, const float* in1_w,
    const float* in1_b, const void* wqkv_t, const float* ln, const float* in2_w,
    const float* in2_b, const void* wout_t, const float* bias_x, const float* bias_y,
    const float* scale, const float* stats1, const void* ao_r, float* stats2, float* work,
    float* sums, void* dao, void* dqkv, float* dacc, void* xs, float* part_w,
    const int* bounds_out, int splits_out, const int* bounds_qkv, int splits_qkv,
    float* lane_part, int groups_r, int per_r, int groups_c, int per_c, void* dx, float* din1,
    float* dwqkv, float* dbqkv, float* dln, float* din2, float* dwout, float* dbout,
    float* dbias_x, float* dbias_y, float* dscale, int BT, int H, int W, int C, int heads,
    void* stream) {
  using bf16 = __nv_bfloat16;
  if (!bft::mega_shape_ok(head_dim, H, W, C, heads)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups[2] = {groups_r, groups_c}, per[2] = {per_r, per_c};
#define BFT_RUN(D)                                                                              \
  return bft::run_mega_hopper_bwd<D>(                                                           \
      static_cast<const bf16*>(x), static_cast<const bf16*>(dout),                              \
      static_cast<const bf16*>(qkv), in1_w, in1_b, static_cast<const bf16*>(wqkv_t), ln, in2_w, \
      in2_b, static_cast<const bf16*>(wout_t), bias_x, bias_y, scale, stats1,                   \
      static_cast<const bf16*>(ao_r), stats2, work, sums, static_cast<bf16*>(dao),              \
      static_cast<bf16*>(dqkv), dacc, static_cast<bf16*>(xs), part_w, bounds_out, splits_out,   \
      bounds_qkv, splits_qkv, lane_part, groups, per, static_cast<bf16*>(dx), din1, dwqkv,      \
      dbqkv, dln, din2, dwout, dbout, dbias_x, dbias_y, dscale, BT, H, W, C, heads, s)
  if (head_dim == 64) BFT_RUN(64);
  BFT_RUN(16);
#undef BFT_RUN
}

int bft::lane::resident_mega(int head_dim, int L, int* blocks) {
  return bwd_resident<Mode::kMega>(head_dim, L, blocks);
}
