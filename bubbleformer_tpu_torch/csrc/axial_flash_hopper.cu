// K8 in bfloat16 on Hopper: the C entries of flash_hopper.cuh's kernels.
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
