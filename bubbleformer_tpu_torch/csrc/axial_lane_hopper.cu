// K2, K4 and K6 in bfloat16 on Hopper: the C entries of lane_hopper.cuh's
// kernels in K2's rounding (Mode::kLane), in K4's (Mode::kFusedBlock) and
// in K6's (Mode::kFusedPacked).
//
// Replaces bubbleformer_tpu/ops/axial_lane.py:_make_lane_axial (_fwd_kernel
// :236, _bwd_kernel :370; entry lane_axial_attention_from_x :852) for bf16
// activations; the float32 path stays on line_kernels.cuh
// (axial_attention.cu).  What bounds it on an H100 (bytes) and what the
// design does about it: lane_hopper.cuh.  At the main path's shapes, moving
// each byte once at 3.35 TB/s takes (forward, backward):
//   FiLMAViT-small qkv (40, 32, 32, 1152): 283 MB, 534 MB -> 0.085, 0.16 ms;
//   AViT-big (40, 32, 32, 2304): 566 MB, 1068 MB -> 0.17, 0.32 ms;
//   flow boiling (20, 32, 128, 1152): 566 MB, 1068 MB -> 0.17, 0.32 ms;
//   AViT-tiny at 512x2048 (20, 64, 256, 288): 566 MB, 1068 MB -> 0.17, 0.32 ms
// (per direction qkv read once, dout twice in all, the row output written
// and read again forward, dqkv written and then added to backward).
#include "lane_hopper.cuh"

namespace {

bool lane_shape_ok(int head_dim, int H, int W, int C, int heads) {
  return (head_dim == 16 || head_dim == 64) && H >= 1 && W >= 1 && H <= 512 && W <= 512 &&
         C == heads * head_dim;
}

}  // namespace

// qkv: (BT, H, W, 3C) bf16, heads-major [q|k|v] columns; ln (4, head_dim) =
// q scale, q bias, k scale, k bias; bias_x (heads, W, W), bias_y (heads, H,
// H); scale (heads, 2) = [s_x, s_y]; row_out (BT, H, W, C) bf16 scratch; out
// (BT, H, W, C) bf16.  head_dim 16 or 64, H and W at most 512; qkv, row_out
// and out 16-byte aligned.  Returns a cudaError_t.
extern "C" int bf_lane_hopper_fwd(int head_dim, const void* qkv, const float* ln,
                                  const float* bias_x, const float* bias_y, const float* scale,
                                  void* row_out, void* out, int BT, int H, int W, int C,
                                  int heads, void* stream) {
  if (!lane_shape_ok(head_dim, H, W, C, heads) || BT < 1) return cudaErrorInvalidValue;
  bft::lane::FwdArgs a{};
  a.qkv = static_cast<const __nv_bfloat16*>(qkv);
  a.ln = ln;
  a.bias_x = bias_x;
  a.bias_y = bias_y;
  a.scale = scale;
  a.row_out = static_cast<__nv_bfloat16*>(row_out);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  const auto st = static_cast<cudaStream_t>(stream);
  using bft::lane::Mode;
  return head_dim == 64 ? bft::lane::lane_fwd<64, Mode::kLane>(a, BT, st)
                        : bft::lane::lane_fwd<16, Mode::kLane>(a, BT, st);
}

// qkv as for bf_lane_hopper_fwd; dout (BT, H, W, C) bf16.  Outputs: dqkv (BT,
// H, W, 3C) bf16; float32 dln (4, head_dim), dbias_x (heads, W, W), dbias_y
// (heads, H, H), dscale (heads, 2), all written whole.  Scratch: lane_part
// float32 (lane_hopper.cuh: carve_partials, for the plan (groups_r, per_r)
// of the BT * H rows and (groups_c, per_c) of the BT * W columns).
// Returns a cudaError_t.
extern "C" int bf_lane_hopper_bwd(int head_dim, const void* qkv, const void* dout,
                                  const float* ln, const float* bias_x, const float* bias_y,
                                  const float* scale, void* dqkv, float* lane_part, float* dln,
                                  float* dbias_x, float* dbias_y, float* dscale, int BT, int H,
                                  int W, int C, int heads, int groups_r, int per_r,
                                  int groups_c, int per_c, void* stream) {
  if (!lane_shape_ok(head_dim, H, W, C, heads) || BT < 1) return cudaErrorInvalidValue;
  bft::lane::BwdArgs a{};
  a.qkv = static_cast<const __nv_bfloat16*>(qkv);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.ln = ln;
  a.bias_x = bias_x;
  a.bias_y = bias_y;
  a.scale = scale;
  a.dqkv = static_cast<__nv_bfloat16*>(dqkv);
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  const int groups[2] = {groups_r, groups_c}, per[2] = {per_r, per_c};
  const bft::lane::Partials part =
      bft::lane::carve_partials(lane_part, groups, heads, H, W, head_dim);
  const auto st = static_cast<cudaStream_t>(stream);
  using bft::lane::Mode;
  return head_dim == 64 ? bft::lane::lane_bwd<64, Mode::kLane>(a, BT, groups, per, part, dbias_x,
                                                               dbias_y, dscale, dln, st)
                        : bft::lane::lane_bwd<16, Mode::kLane>(a, BT, groups, per, part, dbias_x,
                                                               dbias_y, dscale, dln, st);
}

int bft::lane::resident_lane(int head_dim, int L, int* blocks) {
  return bwd_resident<Mode::kLane>(head_dim, L, blocks);
}

// K4 (replaces bubbleformer_tpu/ops/axial_fused_block.py:_make_fused_block,
// pl.pallas_call :275; _fwd_kernel :85, _bwd_kernel :138; entry
// fused_block_attention :361) for bf16 activations: K2's kernels in K5's
// rounding (lane_hopper.cuh, Mode::kFusedBlock).  It moves K2's bytes plus
// the row pass's float32 half of the output (forward) and the row pass's
// float32 d(q, k, v) (backward): at AViT-small's training shape (qkv (40,
// 32, 32, 1152)) 346 MB and 722 MB, 0.10 and 0.22 ms at 3.35 TB/s.
//
// qkv, ln, bias_x, bias_y, scale as for bf_lane_hopper_fwd; half (BT, H, W,
// C) float32 scratch (the row pass's half of the output); out (BT, H, W, C)
// bf16, dtype(0.5 o_rows + 0.5 o_cols).  Returns a cudaError_t.
extern "C" int bf_fused_block_hopper_fwd(int head_dim, const void* qkv, const float* ln,
                                         const float* bias_x, const float* bias_y,
                                         const float* scale, float* half, void* out, int BT,
                                         int H, int W, int C, int heads, void* stream) {
  if (!lane_shape_ok(head_dim, H, W, C, heads) || BT < 1) return cudaErrorInvalidValue;
  bft::lane::FwdArgs a{};
  a.qkv = static_cast<const __nv_bfloat16*>(qkv);
  a.ln = ln;
  a.bias_x = bias_x;
  a.bias_y = bias_y;
  a.scale = scale;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ao = half;
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  const auto st = static_cast<cudaStream_t>(stream);
  using bft::lane::Mode;
  return head_dim == 64 ? bft::lane::lane_fwd<64, Mode::kFusedBlock>(a, BT, st)
                        : bft::lane::lane_fwd<16, Mode::kFusedBlock>(a, BT, st);
}

// K4's backward: as bf_lane_hopper_bwd, with dacc (BT, H, W, 3C) float32
// scratch (the row pass's d(q, k, v)); dqkv rounded once.  Returns a
// cudaError_t.
extern "C" int bf_fused_block_hopper_bwd(int head_dim, const void* qkv, const void* dout,
                                         const float* ln, const float* bias_x,
                                         const float* bias_y, const float* scale, void* dqkv,
                                         float* dacc, float* lane_part, float* dln,
                                         float* dbias_x, float* dbias_y, float* dscale, int BT,
                                         int H, int W, int C, int heads, int groups_r, int per_r,
                                         int groups_c, int per_c, void* stream) {
  if (!lane_shape_ok(head_dim, H, W, C, heads) || BT < 1) return cudaErrorInvalidValue;
  bft::lane::BwdArgs a{};
  a.qkv = static_cast<const __nv_bfloat16*>(qkv);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.ln = ln;
  a.bias_x = bias_x;
  a.bias_y = bias_y;
  a.scale = scale;
  a.dqkv = static_cast<__nv_bfloat16*>(dqkv);
  a.dacc = dacc;
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  const int groups[2] = {groups_r, groups_c}, per[2] = {per_r, per_c};
  const bft::lane::Partials part =
      bft::lane::carve_partials(lane_part, groups, heads, H, W, head_dim);
  const auto st = static_cast<cudaStream_t>(stream);
  using bft::lane::Mode;
  return head_dim == 64
             ? bft::lane::lane_bwd<64, Mode::kFusedBlock>(a, BT, groups, per, part, dbias_x,
                                                          dbias_y, dscale, dln, st)
             : bft::lane::lane_bwd<16, Mode::kFusedBlock>(a, BT, groups, per, part, dbias_x,
                                                          dbias_y, dscale, dln, st);
}

int bft::lane::resident_fused_block(int head_dim, int L, int* blocks) {
  return bwd_resident<Mode::kFusedBlock>(head_dim, L, blocks);
}

// K6 (replaces bubbleformer_tpu/ops/axial_fused_packed.py:_make_fused_packed,
// pl.pallas_call :365 forward, :377 backward; _fwd_kernel :133, _bwd_chunk
// :192, _bwd_kernel :230; entry fused_axial_attention_packed :418) for bf16
// activations: K4's kernels without the qk-LN (lane_hopper.cuh,
// Mode::kFusedPacked), q, k and v read in place.  At AViT-small's training
// shape (q (40, 32, 32, 6, 64)) it moves 346 MB forward (q, k, v read a
// pass, the row pass's float32 half written and read, out written) and 722
// MB backward (q, k, v and dout read a pass, the row pass's float32 d(q, k,
// v) written and read, dq, dk, dv written): 0.10 and 0.22 ms at 3.35 TB/s.
//
// q, k, v: (BT, H, W, heads, head_dim) bf16, each token's head h at token *
// t + h * hd elements, strides = (t_q, hd_q, t_k, hd_k, t_v, hd_v) (the
// bases and strides 16-byte multiples, a head's values contiguous);
// bias_x, bias_y, scale as for bf_lane_hopper_fwd; half (BT, H, W, C)
// float32 scratch; out (BT, H, W, C) bf16, dtype(0.5 o_rows + 0.5 o_cols).
// Returns a cudaError_t.
extern "C" int bf_fused_packed_hopper_fwd(int head_dim, const void* q, const void* k,
                                          const void* v, const long long* strides,
                                          const float* bias_x, const float* bias_y,
                                          const float* scale, float* half, void* out, int BT,
                                          int H, int W, int C, int heads, void* stream) {
  bft::lane::PackedFwdArgs a{};
  if (!lane_shape_ok(head_dim, H, W, C, heads) || BT < 1 ||
      !bft::lane::make_src3(&a.src, q, k, v, strides))
    return cudaErrorInvalidValue;
  a.bias_x = bias_x;
  a.bias_y = bias_y;
  a.scale = scale;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ao = half;
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  const auto st = static_cast<cudaStream_t>(stream);
  using bft::lane::Mode;
  return head_dim == 64 ? bft::lane::lane_fwd<64, Mode::kFusedPacked>(a, BT, st)
                        : bft::lane::lane_fwd<16, Mode::kFusedPacked>(a, BT, st);
}

// K6's backward: q, k, v as for bf_fused_packed_hopper_fwd, dout (BT, H, W,
// heads, head_dim) bf16 read in place alike (strides: q's, k's, v's, then
// dout's token and head strides).  Outputs: dq, dk, dv (BT, H, W, C) bf16,
// the two directions' sum rounded once; float32, written whole: dbias_x
// (heads, W, W), dbias_y (heads, H, H), dscale (heads, 2).  Scratch: dacc
// (BT, H, W, 3C) float32 (the row pass's d(q, k, v)); lane_part float32
// (carve_partials without LN sums, for the plans (groups_r, per_r) and
// (groups_c, per_c)).  Returns a cudaError_t.
extern "C" int bf_fused_packed_hopper_bwd(int head_dim, const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const long long* strides, const float* bias_x,
                                          const float* bias_y, const float* scale, void* dq,
                                          void* dk, void* dv, float* dacc, float* lane_part,
                                          float* dbias_x, float* dbias_y, float* dscale, int BT,
                                          int H, int W, int C, int heads, int groups_r,
                                          int per_r, int groups_c, int per_c, void* stream) {
  bft::lane::PackedBwdArgs a{};
  if (!lane_shape_ok(head_dim, H, W, C, heads) || BT < 1 ||
      !bft::lane::make_src3(&a.src, q, k, v, strides) ||
      !bft::lane::in_place_ok(dout, strides[6], strides[7]))
    return cudaErrorInvalidValue;
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.tdo = strides[6];
  a.hdo = strides[7];
  a.bias_x = bias_x;
  a.bias_y = bias_y;
  a.scale = scale;
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.dacc = dacc;
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  const int groups[2] = {groups_r, groups_c}, per[2] = {per_r, per_c};
  const bft::lane::Partials part = bft::lane::carve_partials(lane_part, groups, heads, H, W, 0);
  const auto st = static_cast<cudaStream_t>(stream);
  using bft::lane::Mode;
  return head_dim == 64
             ? bft::lane::lane_bwd<64, Mode::kFusedPacked>(a, BT, groups, per, part, dbias_x,
                                                           dbias_y, dscale, nullptr, st)
             : bft::lane::lane_bwd<16, Mode::kFusedPacked>(a, BT, groups, per, part, dbias_x,
                                                           dbias_y, dscale, nullptr, st);
}

int bft::lane::resident_fused_packed(int head_dim, int L, int* blocks) {
  return bwd_resident<Mode::kFusedPacked>(head_dim, L, blocks);
}

// Blocks of a bf16 backward kernel of lane_hopper.cuh for lines of L tokens
// (1 to 512) at head_dim 16 or 64 that one multiprocessor of the current
// device holds at once, into *blocks: the host plans one wave of them
// (ops/axial_lane.py:lane_bwd_plan).  mode: 0 K2's kernel (Mode::kLane), 1
// K9's (kLanePx), 2 K5's (kMega), 3 K4's (kFusedBlock), 4 K6's
// (kFusedPacked).  Returns a cudaError_t.
extern "C" int bf_lane_bwd_resident(int mode, int head_dim, int L, int* blocks) {
  switch (mode) {
    case 0:
      return bft::lane::resident_lane(head_dim, L, blocks);
    case 1:
      return bft::lane::resident_lane_px(head_dim, L, blocks);
    case 2:
      return bft::lane::resident_mega(head_dim, L, blocks);
    case 3:
      return bft::lane::resident_fused_block(head_dim, L, blocks);
    case 4:
      return bft::lane::resident_fused_packed(head_dim, L, blocks);
    default:
      return cudaErrorInvalidValue;
  }
}
