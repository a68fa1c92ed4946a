// K8 and K7 in bfloat16 on Hopper: the C entries of flash_hopper.cuh's
// kernels, over lines of (heads, M, n, d) planes (K8) and over the rows and
// columns of (BT, H, W, heads, d) planes read in place (K7, kPlane).
//
// Replaces bubbleformer_tpu/ops/axial_pallas.py:_make_flash (_fwd_kernel
// :66, _bwd_kernel :82; entry flash_packed_attention) for bf16 q, k, v; the
// float32 path, and bf16 backward lines longer than the Hopper backward
// stages (d = 64, n > 256), stay on line_kernels.cuh (axial_flash.cu).  What
// bounds it on an H100 (bytes) and what the design does about it:
// flash_hopper.cuh.
#include "flash_hopper.cuh"

namespace {

bool flash_hopper_ok(int head_dim, int M, int n, int heads) {
  return (head_dim == 16 || head_dim == 64) && n >= 1 && n <= bft::flash::kMaxRows && M >= 1 &&
         heads >= 1 && (long long)M * n * head_dim < (1LL << 31);
}

bft::flash::FlashArgs flash_args(const void* q, const void* k, const void* v, const float* bias,
                                 const float* scale, int M, int n, int heads) {
  bft::flash::FlashArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.bias = bias;
  a.scale = scale;
  a.M = M;
  a.n = n;
  a.heads = heads;
  return a;
}

}  // namespace

// q, k, v: (heads, M, n, head_dim) bf16 each; bias (heads, n, n); scale
// (heads, 2), the attn scale in column 0; out (heads, M, n, head_dim) bf16.
// head_dim 16 or 64, n at most 512; q, k, v and out 16-byte aligned.
// Returns a cudaError_t.
extern "C" int bf_flash_hopper_fwd(int head_dim, const void* q, const void* k, const void* v,
                                   const float* bias, const float* scale, void* out, int M,
                                   int n, int heads, void* stream) {
  if (!flash_hopper_ok(head_dim, M, n, heads)) return cudaErrorInvalidValue;
  bft::flash::FlashArgs a = flash_args(q, k, v, bias, scale, M, n, heads);
  a.out = static_cast<__nv_bfloat16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  return head_dim == 64 ? bft::flash::flash_fwd<64>(a, st) : bft::flash::flash_fwd<16>(a, st);
}

// q, k, v as for bf_flash_hopper_fwd; dout (heads, M, n, head_dim) bf16.
// Outputs: dq, dk, dv (heads, M, n, head_dim) bf16; float32, written whole:
// dbias (heads, n, n) and dscale (heads, 2), the scale's gradient in column
// 0 (column 1 zero).  Scratch: part float32, the (groups, heads, n, n) table
// and (heads, groups) scale partials of the plan (groups, per) of the
// segments (ops/axial_pallas.py:flash_bwd_plan).  n within
// bf_flash_hopper_bwd_fits.  Returns a cudaError_t.
extern "C" int bf_flash_hopper_bwd(int head_dim, const void* q, const void* k, const void* v,
                                   const void* dout, const float* bias, const float* scale,
                                   void* dq, void* dk, void* dv, float* part, float* dbias,
                                   float* dscale, int groups, int per, int M, int n, int heads,
                                   void* stream) {
  if (!flash_hopper_ok(head_dim, M, n, heads)) return cudaErrorInvalidValue;
  bft::flash::FlashArgs a = flash_args(q, k, v, bias, scale, M, n, heads);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.groups = groups;
  a.per = per;
  const auto st = static_cast<cudaStream_t>(stream);
  return head_dim == 64 ? bft::flash::flash_bwd<64>(a, part, dbias, dscale, st)
                        : bft::flash::flash_bwd<16>(a, part, dbias, dscale, st);
}

// Blocks of the bf16 backward for lines of n tokens at head_dim 16 or 64 that
// one multiprocessor of the current device holds at once, into *blocks (the
// host plans one wave of them).  Returns a cudaError_t (cudaErrorInvalidValue
// where the backward does not stage such lines).
extern "C" int bf_flash_hopper_resident(int head_dim, int n, int* blocks) {
  if (head_dim != 16 && head_dim != 64) return cudaErrorInvalidValue;
  return head_dim == 64 ? bft::flash::flash_bwd_resident<64>(n, blocks)
                        : bft::flash::flash_bwd_resident<16>(n, blocks);
}

namespace {

// K7's shape: head_dim 16 or 64, lines of 1 to 512 tokens, a token's
// offset in K8's (M, n, head_dim) planes an int (flash_hopper.cuh:
// plane_rows).
bool plane_ok(int head_dim, int BT, int H, int W, int C, int heads) {
  return (head_dim == 16 || head_dim == 64) && BT >= 1 && H >= 1 && W >= 1 &&
         H <= bft::flash::kMaxRows && W <= bft::flash::kMaxRows && C == heads * head_dim &&
         (long long)BT * H * W * head_dim < (1LL << 31);
}

bft::flash::PlaneArgs plane_args(int BT, int H, int W, int C, int heads) {
  bft::flash::PlaneArgs a{};
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  return a;
}

}  // namespace

// K7 (replaces bubbleformer_tpu/ops/axial_fused.py:_make_fused, pl.pallas_call
// :273 forward, :284 backward; _attn_chunk :92, _bwd_chunk :150; entry
// fused_axial_attention :325) for bf16 activations: K8's kernels over the
// rows, then the columns, of q, k, v read in place (flash_hopper.cuh,
// kPlane).  At AViT-small's training shape (q (40, 32, 32, 6, 64)) it moves
// 283 MB forward (q, k, v read a pass, the row pass's bf16 half written and
// read, out written) and 535 MB backward (q, k, v and dout read a pass, the
// row pass's rounded dq, dk, dv written and read, the sums written): 0.085
// and 0.16 ms at 3.35 TB/s.
//
// q, k, v: (BT, H, W, heads, head_dim) bf16, each token's head h at token *
// t + h * hd elements, strides = (t_q, hd_q, t_k, hd_k, t_v, hd_v) (the
// bases and strides 16-byte multiples, a head's values contiguous); bias_x
// (heads, W, W), bias_y (heads, H, H); scale (heads, 2) = [s_x, s_y]; half
// (BT, H, W, C) bf16 scratch; out (BT, H, W, C) bf16, dtype(dtype(0.5 o_r)
// + dtype(0.5 o_c)).  H and W at most 512.  Returns a cudaError_t.
extern "C" int bf_fused_hopper_fwd(int head_dim, const void* q, const void* k, const void* v,
                                   const long long* strides, const float* bias_x,
                                   const float* bias_y, const float* scale, void* half, void* out,
                                   int BT, int H, int W, int C, int heads, void* stream) {
  bft::flash::PlaneArgs a = plane_args(BT, H, W, C, heads);
  if (!plane_ok(head_dim, BT, H, W, C, heads) ||
      !bft::lane::make_src3(&a.src, q, k, v, strides))
    return cudaErrorInvalidValue;
  a.half = static_cast<__nv_bfloat16*>(half);
  a.out = static_cast<__nv_bfloat16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  return head_dim == 64 ? bft::flash::plane_fwd<64>(a, BT, bias_x, bias_y, scale, st)
                        : bft::flash::plane_fwd<16>(a, BT, bias_x, bias_y, scale, st);
}

// K7's backward: q, k, v as for bf_fused_hopper_fwd, dout (BT, H, W, heads,
// head_dim) bf16 read in place alike (strides: q's, k's, v's, then dout's
// token and head strides).  Outputs: dq, dk, dv (BT, H, W, C) bf16, each
// direction's rounded and the two added in bf16; float32, written whole:
// dbias_x (heads, W, W), dbias_y (heads, H, H), dscale (heads, 2).
// Scratch: part float32, pass by pass the (groups, heads, n, n) table and
// (heads, groups) scale partials of the plans (groups_r, per_r) of the rows'
// segments and (groups_c, per_c) of the columns'
// (ops/axial_fused.py:fused_bwd_layout).  Both line lengths within
// bf_flash_hopper_resident's.  Returns a cudaError_t.
extern "C" int bf_fused_hopper_bwd(int head_dim, const void* q, const void* k, const void* v,
                                   const void* dout, const long long* strides,
                                   const float* bias_x, const float* bias_y, const float* scale,
                                   void* dq, void* dk, void* dv, float* part, float* dbias_x,
                                   float* dbias_y, float* dscale, int BT, int H, int W, int C,
                                   int heads, int groups_r, int per_r, int groups_c, int per_c,
                                   void* stream) {
  bft::flash::PlaneArgs a = plane_args(BT, H, W, C, heads);
  if (!plane_ok(head_dim, BT, H, W, C, heads) ||
      !bft::lane::make_src3(&a.src, q, k, v, strides) ||
      !bft::lane::in_place_ok(dout, strides[6], strides[7]))
    return cudaErrorInvalidValue;
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.tdo = strides[6];
  a.hdo = strides[7];
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  const int groups[2] = {groups_r, groups_c}, per[2] = {per_r, per_c};
  const auto st = static_cast<cudaStream_t>(stream);
  return head_dim == 64 ? bft::flash::plane_bwd<64>(a, BT, bias_x, bias_y, scale, groups, per,
                                                    part, dbias_x, dbias_y, dscale, st)
                        : bft::flash::plane_bwd<16>(a, BT, bias_x, bias_y, scale, groups, per,
                                                    part, dbias_x, dbias_y, dscale, st);
}

// Blocks of K7's bf16 backward for lines of n tokens at head_dim 16 or 64
// that one multiprocessor of the current device holds at once, into
// *blocks.  Returns a cudaError_t (cudaErrorInvalidValue where the backward
// does not stage such lines).
extern "C" int bf_fused_hopper_resident(int head_dim, int n, int* blocks) {
  if (head_dim != 16 && head_dim != 64) return cudaErrorInvalidValue;
  return head_dim == 64 ? bft::flash::flash_bwd_resident<64, true>(n, blocks)
                        : bft::flash::flash_bwd_resident<16, true>(n, blocks);
}
