// The Hopper GEMM of hopper_gemm.cuh on its own, for the tests and the
// measurements (bubbleformer_tpu_torch/ops/hopper_gemm.py); K1 and K3
// launch it from temporal_block.cu and temporal_block_bwd.cu.
#include "hopper_gemm.cuh"

// tn = 0: out(M, N) = a(M, K) . b(N, K)^T, out bf16 = bf16(sum + bias)
// (epilogue 0), float32 (epilogue 1) or bf16 = bf16(sum) (epilogue 3).
// tn = 1: out(M, N) float32 = sum_r a(r, m) b(r, n) over K = R tokens, a
// (R, M) and b (R, N), split at the host array bounds[0..splits] into the
// float32 scratch part (splits * M * N) and added in range order.  bf16
// operands, row-major, every base and row 16-byte aligned.  Returns a
// cudaError_t.
extern "C" int bf_hopper_gemm(int tn, int epilogue, const void* a, const void* b, void* out,
                              const float* bias, float* part, int M, int N, int K,
                              const int* bounds, int splits, void* stream) {
  namespace hg = bft::hg;
  using bf16 = __nv_bfloat16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  if (M < 1 || N < 1 || K < 1 || N % 8) return cudaErrorInvalidValue;
  if (tn) {
    if (M % 8) return cudaErrorInvalidValue;
    return hg::gemm_tn_splitk(A, B, K, M, N, bounds, splits, part, static_cast<float*>(out), s);
  }
  if (K % 8) return cudaErrorInvalidValue;
  if (epilogue == hg::kBiasRound)
    return hg::gemm_nt<hg::kBiasRound>(A, K, B, K, M, N, K, out, N, bias, s);
  if (epilogue == hg::kStoreF32)
    return hg::gemm_nt<hg::kStoreF32>(A, K, B, K, M, N, K, out, N, nullptr, s);
  if (epilogue == hg::kRound)
    return hg::gemm_nt<hg::kRound>(A, K, B, K, M, N, K, out, N, nullptr, s);
  return cudaErrorInvalidValue;
}
