// K2 in bfloat16 on Hopper: the C entries of lane_hopper.cuh's kernels.
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

// Every line of a pass in exactly one block: groups * per >= lines and no
// block without a line.
bool plan_ok(int lines, int groups, int per) {
  return groups >= 1 && per >= 1 && (long long)groups * per >= lines &&
         (long long)(groups - 1) * per < lines;
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
  return head_dim == 64 ? bft::lane::lane_fwd<64>(a, BT, st) : bft::lane::lane_fwd<16>(a, BT, st);
}

// qkv as for bf_lane_hopper_fwd; dout (BT, H, W, C) bf16.  Outputs: dqkv (BT,
// H, W, 3C) bf16; float32 dln (4, head_dim), dbias_x (heads, W, W), dbias_y
// (heads, H, H), dscale (heads, 2), all written whole.  Scratch (float32):
// part_bias_r (groups_r, heads, W, W), part_bias_c (groups_c, heads, H, H),
// part_scale_r/_c (groups, heads), part_ln_r/_c (groups, heads, 4,
// head_dim).  The row pass's BT * H lines go to groups_r blocks of per_r
// lines a head, the column pass's BT * W lines to groups_c of per_c.
// Returns a cudaError_t.
extern "C" int bf_lane_hopper_bwd(int head_dim, const void* qkv, const void* dout,
                                  const float* ln, const float* bias_x, const float* bias_y,
                                  const float* scale, void* dqkv, float* part_bias_r,
                                  float* part_bias_c, float* part_scale_r, float* part_scale_c,
                                  float* part_ln_r, float* part_ln_c, float* dln,
                                  float* dbias_x, float* dbias_y, float* dscale, int BT, int H,
                                  int W, int C, int heads, int groups_r, int per_r,
                                  int groups_c, int per_c, void* stream) {
  if (!lane_shape_ok(head_dim, H, W, C, heads) || BT < 1 ||
      !plan_ok(BT * H, groups_r, per_r) || !plan_ok(BT * W, groups_c, per_c))
    return cudaErrorInvalidValue;
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
  float* const pb[2] = {part_bias_r, part_bias_c};
  float* const ps[2] = {part_scale_r, part_scale_c};
  float* const pl[2] = {part_ln_r, part_ln_c};
  const auto st = static_cast<cudaStream_t>(stream);
  return head_dim == 64
             ? bft::lane::lane_bwd<64>(a, BT, groups, per, pb, ps, pl, dbias_x, dbias_y, dscale,
                                       dln, st)
             : bft::lane::lane_bwd<16>(a, BT, groups, per, pb, ps, pl, dbias_x, dbias_y, dscale,
                                       dln, st);
}

// Blocks of bf_lane_hopper_bwd's kernel for lines of L tokens (1 to 512) at
// head_dim 16 or 64 that one multiprocessor of the current device holds at
// once, into *blocks: the host plans one wave of them (ops/axial_lane.py:
// lane_bwd_plan).  Returns a cudaError_t.
extern "C" int bf_lane_hopper_bwd_resident(int head_dim, int L, int* blocks) {
  if ((head_dim != 16 && head_dim != 64) || L < 1 || L > 512) return cudaErrorInvalidValue;
  return head_dim == 64 ? bft::lane::lane_bwd_resident<64>(L, blocks)
                        : bft::lane::lane_bwd_resident<16>(L, blocks);
}
