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
// bf16 (the training dtype) runs on Hopper's own units: the products on the
// TMA + wgmma GEMM (hopper_gemm.cuh), the attention on K2's tensor-core
// kernels (lane_hopper.cuh):
//   forward  (1) gemm_nt, kBiasRound: qkv = bf16(x . bf16(W)^T + b) into a
//                bf16 scratch; one token-major qkv serves both directions,
//                where the TPU kernel projected once per token layout (the
//                same values, :414-420);
//            (2) K2's forward as it is (lane_fwd, kLane), rounding for rounding.
//   backward (0) (1) again;
//            then per direction (rows, then columns), on one dqkv scratch:
//            (1) K2's backward pass in the kLanePx rounding: the direction's
//                dqkv, qk-LN backward included, rounded on its own (the TPU
//                kernel's bm=True, :462-470), and its block partials of the
//                table, scale and LN gradients;
//            (2) tn_partials: its token ranges of dW = dqkv^T x, float32;
//            (3) plane_sums: its per-plane sums of dqkv (db);
//            (4) gemm_nt: dx = bf16(dqkv_r . W) (kRound), then dx = bf16(dx +
//                bf16(dqkv_c . W)) (kRoundAdd) (:477-480: each layout's dx
//                rounded, their sum in bf16);
//            and last (5) splitk_sum: dW = both directions' ranges added in
//            one fixed order, never rounded (:473-476); plane_totals: db,
//            both directions' planes in order; param_sum: the table, scale
//            and LN gradients from both passes' partials.
// Every bf16 parameter gradient repeats bit for bit from run to run.
//
// float32 keeps the first version's chain: (a) norm_proj_kernel without the
// InstanceNorm (block_ops.cuh) for qkv, the line kernels (line_kernels.cuh)
// in K2's lane flavour forward; backward the projection again, then per
// direction the line kernels' kLanePx backward, wgrad_kernel (dW +=
// dqkv^T . x, float32 atomics), plane_sums_kernel (db, atomics) and
// gemm_nt_kernel (dx written by the row pass, added by the column pass), on
// block_gemm.cuh's FMA tile; its table, scale and LN gradients are the line
// kernels' fixed-order sums, dW and db vary in their last bits.
//
// What bounds it at FiLMAViT-small's training shape (BT = 40 images of 32x32
// tokens, C = 384): the projection 2*R*C*3C = 36 GFLOP forward (R = 40960
// tokens) and three such products backward (recompute, dW, dx), 109 GFLOP,
// beside K2's attention work (4 and 10 GFLOP), against 63 MB of x and out
// forward and 94 MB of x, dout and dx backward in bf16: the tensor cores,
// ~0.04 ms forward and ~0.12 ms backward at the bf16 peak.  The bf16 chain
// runs each product on the GEMM and keeps the qkv round trip through device
// memory (283 MB forward: the qkv written and read, both directions' output;
// ~0.09 ms at 3.35 TB/s); fusing the projection into the attention's
// staging is left for later.
#include "block_ops.cuh"
#include "hopper_gemm.cuh"
#include "lane_hopper.cuh"
#include "line_kernels.cuh"
#include "temporal_hopper.cuh"

namespace bft {
namespace {

using bf16 = __nv_bfloat16;

template <int D>
int run_lane_px_fwd(const float* x, const float* wqkv, const float* bqkv, const float* ln,
                    const float* bias_x, const float* bias_y, const float* scale, float* qkv,
                    float* row_out, float* out, int BT, int H, int W, int C, int heads,
                    cudaStream_t stream) {
  cudaError_t e;
  if ((e = launch_norm_proj<float, float, false>(x, nullptr, nullptr, nullptr, wqkv, bqkv, qkv,
                                                 BT, H * W, C, 3 * C, stream)) != cudaSuccess)
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
  return line_attention_fwd<float, D, Flavour::kLane>(a);
}

template <int D>
int run_lane_px_bwd(const float* x, const float* dout, const float* wqkv, const float* wqkv_t,
                    const float* bqkv, const float* ln, const float* bias_x, const float* bias_y,
                    const float* scale, float* qkv, float* dqkv, float* stats, float* part,
                    const int (&groups)[2], const int (&per)[2], float* dx, float* dwqkv,
                    float* dbqkv, float* dln, float* dbias_x, float* dbias_y, float* dscale,
                    int BT, int H, int W, int C, int heads, cudaStream_t stream) {
  const int N = H * W, R = BT * N;
  cudaError_t e;
#define BFT_TRY(call) \
  if ((e = static_cast<cudaError_t>(call)) != cudaSuccess) return e
  // (0) the forward's qkv again
  BFT_TRY((launch_norm_proj<float, float, false>(x, nullptr, nullptr, nullptr, wqkv, bqkv, qkv,
                                                 BT, N, C, 3 * C, stream)));
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
  BwdPlan plan[2];
  ParamSumArgs sum;
  if (!line_bwd_plans<Flavour::kLanePx>(a, D, plan, sum)) return cudaErrorInvalidValue;
  for (int pass = 0; pass < 2; ++pass) {
    // (1) this direction's dqkv
    BFT_TRY((line_attention_bwd_pass<float, D, Flavour::kLanePx>(a, plan[pass], pass)));
    // (2) dW += dqkv^T . x
    BFT_TRY((launch_wgrad<float, float, false>(dqkv, 3 * C, x, nullptr, nullptr, nullptr, C, BT,
                                               N, dwqkv, stream)));
    // (3) db += sum dqkv
    BFT_TRY((launch_plane_sums<float, float>(dqkv, nullptr, nullptr, BT, N, 3 * C, nullptr,
                                             nullptr, dbqkv, stream)));
    // (4) dx (=|+=) dqkv . W
    if (pass == 0) {
      BFT_TRY((launch_gemm_nt<float, float, false>(dqkv, wqkv_t, dx, R, C, 3 * C, stream)));
    } else {
      BFT_TRY((launch_gemm_nt<float, float, true>(dqkv, wqkv_t, dx, R, C, 3 * C, stream)));
    }
  }
  // (5) the table, scale and LN gradients from both passes' partials
  BFT_TRY(launch_param_sum(sum, stream));
#undef BFT_TRY
  return cudaSuccess;
}

// K9's bf16 forward: the QKV product on the Hopper GEMM, then K2's forward.
template <int D>
int run_lane_px_fwd_hopper(const bf16* x, const bf16* wqkv, const float* bqkv, const float* ln,
                           const float* bias_x, const float* bias_y, const float* scale, bf16* qkv,
                           bf16* row_out, bf16* out, int BT, int H, int W, int C, int heads,
                           cudaStream_t stream) {
  const int R = BT * H * W;
  cudaError_t e;
  if ((e = hg::gemm_nt<hg::kBiasRound>(x, C, wqkv, C, R, 3 * C, C, qkv, 3 * C, bqkv, stream)) !=
      cudaSuccess)
    return e;
  lane::FwdArgs a{};
  a.qkv = qkv;
  a.ln = ln;
  a.bias_x = bias_x;
  a.bias_y = bias_y;
  a.scale = scale;
  a.row_out = row_out;
  a.out = out;
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  return lane::lane_fwd<D, lane::Mode::kLane>(a, BT, stream);
}

// K9's bf16 backward, launches (0)-(5) of the file comment.
template <int D>
int run_lane_px_bwd_hopper(const bf16* x, const bf16* dout, const bf16* wqkv, const bf16* wqkv_t,
                           const float* bqkv, const float* ln, const float* bias_x,
                           const float* bias_y, const float* scale, bf16* qkv, bf16* dqkv,
                           float* sums, float* part_w, const int* bounds, int splits,
                           float* lane_part, const int (&groups)[2], const int (&per)[2],
                           bf16* dx, float* dwqkv, float* dbqkv, float* dln, float* dbias_x,
                           float* dbias_y, float* dscale, int BT, int H, int W, int C, int heads,
                           cudaStream_t stream) {
  const int N = H * W, R = BT * N;
  hg::SplitPlan plan;
  if (!hg::make_plan(bounds, splits, R, &plan)) return cudaErrorInvalidValue;
  cudaError_t e;
#define BFT_TRY(call) \
  if ((e = static_cast<cudaError_t>(call)) != cudaSuccess) return e
  BFT_TRY((hg::gemm_nt<hg::kBiasRound>(x, C, wqkv, C, R, 3 * C, C, qkv, 3 * C, bqkv, stream)));
  lane::BwdArgs a{};
  a.qkv = qkv;
  a.dout = dout;
  a.ln = ln;
  a.bias_x = bias_x;
  a.bias_y = bias_y;
  a.scale = scale;
  a.dqkv = dqkv;
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  const lane::Partials part = lane::carve_partials(lane_part, groups, heads, H, W, D);
  for (int pass = 0; pass < 2; ++pass) {
    BFT_TRY((lane::lane_bwd_pass<D, lane::Mode::kLanePx>(a, BT, pass, groups[pass], per[pass],
                                                         part, stream)));
    BFT_TRY((hg::tn_partials(dqkv, x, R, 3 * C, C, plan,
                             part_w + (size_t)pass * splits * 3 * C * C, stream)));
    BFT_TRY((launch_plane_sums<bf16, float>(dqkv, nullptr, nullptr, BT, N, 3 * C,
                                            sums + (size_t)pass * BT * 3 * C, nullptr, nullptr,
                                            stream)));
    if (pass == 0) {
      BFT_TRY((hg::gemm_nt<hg::kRound>(dqkv, 3 * C, wqkv_t, 3 * C, R, C, 3 * C, dx, C, nullptr,
                                       stream)));
    } else {
      BFT_TRY((hg::gemm_nt<hg::kRoundAdd>(dqkv, 3 * C, wqkv_t, 3 * C, R, C, 3 * C, dx, C,
                                          nullptr, stream)));
    }
  }
  BFT_TRY((hg::splitk_sum(part_w, dwqkv, 3 * C, C, 2 * splits, stream)));
  BFT_TRY((launch_plane_totals(sums, 2 * BT, 3 * C, dbqkv, nullptr, stream)));
  BFT_TRY((lane::lane_bwd_sum<D>(a, groups, part, dbias_x, dbias_y, dscale, dln, stream)));
#undef BFT_TRY
  return cudaSuccess;
}

// The envelope: the line kernels' (head dim 16 or 64, lines of at most 512
// tokens) and the GEMM tiles' (C a multiple of kKC).
bool px_shape_ok(int head_dim, int H, int W, int C, int heads) {
  return (head_dim == 16 || head_dim == 64) && C == heads * head_dim && H >= 1 && W >= 1 &&
         H <= 512 && W <= 512 && C % kKC == 0;
}

}  // namespace
}  // namespace bft

// float32.  x, out: (BT, H, W, C); wqkv (3C, C), torch (out, in) layout,
// heads-major [q|k|v] rows; bqkv (3C), ln (4, head_dim) = [q scale; q bias;
// k scale; k bias], bias_x (heads, W, W), bias_y (heads, H, H), scale
// (heads, 2) = [s_x, s_y].  Scratch: qkv (BT*H*W, 3C), row_out (BT*H*W, C).
// head_dim 16 or 64, H and W at most 512, C % 32 == 0.  Returns a
// cudaError_t.
extern "C" int bf_axial_lane_px_fwd(int head_dim, const float* x, const float* wqkv,
                                    const float* bqkv, const float* ln, const float* bias_x,
                                    const float* bias_y, const float* scale, float* qkv,
                                    float* row_out, float* out, int BT, int H, int W, int C,
                                    int heads, void* stream) {
  if (!bft::px_shape_ok(head_dim, H, W, C, heads)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head_dim == 64 ? bft::run_lane_px_fwd<64>(x, wqkv, bqkv, ln, bias_x, bias_y, scale, qkv,
                                                   row_out, out, BT, H, W, C, heads, s)
                        : bft::run_lane_px_fwd<16>(x, wqkv, bqkv, ln, bias_x, bias_y, scale, qkv,
                                                   row_out, out, BT, H, W, C, heads, s);
}

// float32.  x, dout, dx: (BT, H, W, C); wqkv (3C, C) and wqkv_t (C, 3C), its
// transpose; bqkv, ln, bias_x, bias_y, scale as for bf_axial_lane_px_fwd.
// Scratch: qkv and dqkv (BT*H*W, 3C), stats (BT, heads, H, W, 3) where
// max(H, W) > 64 (else unused), part the line kernels' partials of the
// plan (groups_r, per_r) and (groups_c, per_c) (line_kernels.cuh:
// line_bwd_plans).  Outputs: dwqkv (3C, C) and dbqkv (3C), zeroed by the
// caller; dln (4, head_dim), dbias_x (heads, W, W), dbias_y (heads, H, H),
// dscale (heads, 2), written whole.  Returns a cudaError_t.
extern "C" int bf_axial_lane_px_bwd(int head_dim, const float* x, const float* dout,
                                    const float* wqkv, const float* wqkv_t, const float* bqkv,
                                    const float* ln, const float* bias_x, const float* bias_y,
                                    const float* scale, float* qkv, float* dqkv, float* stats,
                                    float* part, int groups_r, int per_r, int groups_c,
                                    int per_c, float* dx, float* dwqkv, float* dbqkv, float* dln,
                                    float* dbias_x, float* dbias_y, float* dscale, int BT, int H,
                                    int W, int C, int heads, void* stream) {
  if (!bft::px_shape_ok(head_dim, H, W, C, heads)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups[2] = {groups_r, groups_c}, per[2] = {per_r, per_c};
#define BFT_RUN(D)                                                                             \
  return bft::run_lane_px_bwd<D>(x, dout, wqkv, wqkv_t, bqkv, ln, bias_x, bias_y, scale, qkv,  \
                                 dqkv, stats, part, groups, per, dx, dwqkv, dbqkv, dln,        \
                                 dbias_x, dbias_y, dscale, BT, H, W, C, heads, s)
  if (head_dim == 64) BFT_RUN(64);
  BFT_RUN(16);
#undef BFT_RUN
}

// bf16.  x, out (BT, H, W, C), wqkv (3C, C) bf16, the rest as for
// bf_axial_lane_px_fwd; scratch qkv (BT*H*W, 3C) and row_out (BT*H*W, C)
// bf16.  Every base 16-byte aligned.  Returns a cudaError_t.
extern "C" int bf_lane_px_hopper_fwd(int head_dim, const void* x, const void* wqkv,
                                     const float* bqkv, const float* ln, const float* bias_x,
                                     const float* bias_y, const float* scale, void* qkv,
                                     void* row_out, void* out, int BT, int H, int W, int C,
                                     int heads, void* stream) {
  using bf16 = __nv_bfloat16;
  if (!bft::px_shape_ok(head_dim, H, W, C, heads)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BFT_RUN(D)                                                                            \
  return bft::run_lane_px_fwd_hopper<D>(                                                      \
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv), bqkv, ln, bias_x, bias_y,  \
      scale, static_cast<bf16*>(qkv), static_cast<bf16*>(row_out), static_cast<bf16*>(out),   \
      BT, H, W, C, heads, s)
  if (head_dim == 64) BFT_RUN(64);
  BFT_RUN(16);
#undef BFT_RUN
}

// bf16.  x, dout, dx (BT, H, W, C), wqkv (3C, C) and wqkv_t (C, 3C) bf16; the
// rest as for bf_axial_lane_px_bwd.  Scratch: qkv and dqkv (BT*H*W, 3C)
// bf16; sums (2, 2*BT, 3C), part_w (2 * splits * 3C * C) and
// lane_part (lane_hopper.cuh: carve_partials, for the plan (groups_r, per_r)
// of the BT * H rows and (groups_c, per_c) of the BT * W columns) float32;
// bounds a host array of splits + 1 token bounds (0, multiples of 64,
// BT*H*W) for dW.  Outputs, float32, written whole: dwqkv (3C, C), dbqkv
// (3C), dln (4, head_dim), dbias_x (heads, W, W), dbias_y (heads, H, H),
// dscale (heads, 2).  Every base 16-byte aligned.  Returns a cudaError_t.
extern "C" int bf_lane_px_hopper_bwd(int head_dim, const void* x, const void* dout,
                                     const void* wqkv, const void* wqkv_t, const float* bqkv,
                                     const float* ln, const float* bias_x, const float* bias_y,
                                     const float* scale, void* qkv, void* dqkv, float* sums,
                                     float* part_w, const int* bounds, int splits,
                                     float* lane_part, int groups_r, int per_r, int groups_c,
                                     int per_c, void* dx, float* dwqkv, float* dbqkv, float* dln,
                                     float* dbias_x, float* dbias_y, float* dscale, int BT,
                                     int H, int W, int C, int heads, void* stream) {
  using bf16 = __nv_bfloat16;
  if (!bft::px_shape_ok(head_dim, H, W, C, heads)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups[2] = {groups_r, groups_c}, per[2] = {per_r, per_c};
#define BFT_RUN(D)                                                                            \
  return bft::run_lane_px_bwd_hopper<D>(                                                      \
      static_cast<const bf16*>(x), static_cast<const bf16*>(dout),                            \
      static_cast<const bf16*>(wqkv), static_cast<const bf16*>(wqkv_t), bqkv, ln, bias_x,     \
      bias_y, scale, static_cast<bf16*>(qkv), static_cast<bf16*>(dqkv), sums, part_w, bounds,  \
      splits, lane_part, groups, per, static_cast<bf16*>(dx), dwqkv, dbqkv, dln, dbias_x,     \
      dbias_y, dscale, BT, H, W, C, heads, s)
  if (head_dim == 64) BFT_RUN(64);
  BFT_RUN(16);
#undef BFT_RUN
}

int bft::lane::resident_lane_px(int head_dim, int L, int* blocks) {
  return bwd_resident<Mode::kLanePx>(head_dim, L, blocks);
}
