// P3: the fused pyramid stage probe, hand-written for Hopper (sm_90a),
// bfloat16.
//
// Replaces scripts/probe_pyramid_pallas.py's stage kernel (pallas_call :103
// in _make_stage :85, body _stage_kernel :50, entry stage_pallas :120): for
// y (bt, H, W, C), per image InstanceNorm-apply and tanh-GELU,
//   yn = bf16(gelu_tanh((y - mean) * inv)),
// the 2x2 space-to-depth fold and the stage product with k (2, 2, C, F),
//   acc[oy, ox, f] = sum_{dy, dx, c} yn[2oy + dy, 2ox + dx, c] k[dy, dx, c, f]
// in float32, out = bf16(acc), and the statistics of the next stage from the
// unrounded acc: mu = sum acc / n, var = max(sum acc^2 / n - mu^2, 0) over the
// n = (H/2)(W/2) pixels of each image.  tanh-GELU because the probe chose it
// (Mosaic has no erf, :63-67); the models' embed uses exact GELU, so this
// kernel is not a layer of the models.
//
// The TPU kernel summed the statistics across its sequential grid in one
// accumulator.  Hopper's blocks run in no order, so each block (128 output
// pixels of one image) writes its partial sums and a second launch adds them
// in a fixed order, as K10 (lp_loss.cu) does: the statistics repeat bit for
// bit.  The fold is the product's staging: the A loader reads each input
// value once, normalises, applies GELU and rounds it as it lands in shared
// memory; the product runs on block_gemm.cuh's WMMA tile.
//
// Bound at the probe's shape (bt = 20, 256 x 256 x 96 -> 128 x 128 x 96):
// its bytes, 252 MB of y and 63 MB of out (0.094 ms at 3.35 TB/s); the
// product is 24 GFLOP (0.024 ms on the tensor cores).
#include <cmath>

#include "block_gemm.cuh"

namespace bft {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kStageRows = 16 * kMaxMTiles;  // output pixels a block: 128

// jax.nn.gelu(x, approximate=True), term for term.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  const float cdf = 0.5f * (1.f + tanhf(k * (x + 0.044715f * (x * x * x))));
  return x * cdf;
}

// Grid (tiles, bt): block (t, b) takes output pixels [128 t, 128 t + 128) of
// image b in raster order; partial[(b * tiles + t) * 2 + {0, 1}][f] holds the
// tile's sums of acc and acc^2.
__global__ void __launch_bounds__(kGemmThreads) stage_kernel(
    const bf16* __restrict__ y, const float* __restrict__ mean, const float* __restrict__ inv,
    const bf16* __restrict__ kw, bf16* __restrict__ out, float* __restrict__ partial, int H,
    int W, int C, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = blockIdx.x, b = blockIdx.y, tiles = gridDim.x;
  const int Wo = W / 2, P = (H / 2) * Wo, p0 = t * kStageRows, K = 4 * C;
  const bf16* yb = y + (size_t)b * H * W * C;
  const float* mb = mean + (size_t)b * C;
  const float* ib = inv + (size_t)b * C;
  auto aload = [&](int m, int k) {
    const int p = p0 + m;
    if (p >= P || k >= K) return __float2bfloat16(0.f);
    const int fold = k / C, c = k % C;  // fold = dy * 2 + dx, as k.reshape(4C, F)
    const int oy = p / Wo, ox = p % Wo;
    const size_t at = ((size_t)(2 * oy + (fold >> 1)) * W + 2 * ox + (fold & 1)) * C + c;
    return __float2bfloat16(gelu_tanh((__bfloat162float(yb[at]) - mb[c]) * ib[c]));
  };
  auto bload = [&](int f, int k) {
    return f < F && k < K ? kw[(size_t)k * F + f] : __float2bfloat16(0.f);
  };
  // A k-fastest (channels), B f-fastest.
  block_gemm<bf16, false, true>(kMaxMTiles, (F + 15) / 16, (K + 31) / 32 * 32, aload, bload,
                                smem);
  __syncthreads();
  const float* acc = gemm_out<bf16>(smem, kMaxMTiles);
  const int rows = min(kStageRows, P - p0);
  bf16* ob = out + ((size_t)b * P + p0) * F;
  for (int e = threadIdx.x; e < rows * F; e += kGemmThreads)
    ob[e] = __float2bfloat16(acc[(e / F) * kLDC + e % F]);
  float* part = partial + ((size_t)b * tiles + t) * 2 * F;
  for (int f = threadIdx.x; f < F; f += kGemmThreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int m = 0; m < rows; ++m) {
      const float a = acc[m * kLDC + f];
      s1 += a;
      s2 += a * a;
    }
    part[f] = s1;
    part[F + f] = s2;
  }
}

// mu, var (bt, F) from the tiles' partial sums, added in tile order.
__global__ void stage_stats_kernel(const float* __restrict__ partial, float* __restrict__ mu,
                                   float* __restrict__ var, int bt, int tiles, int F, int P) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= bt * F) return;
  const int b = e / F, f = e % F;
  float s1 = 0.f, s2 = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const float* part = partial + ((size_t)b * tiles + t) * 2 * F;
    s1 += part[f];
    s2 += part[F + f];
  }
  const float m = s1 / P;
  mu[e] = m;
  var[e] = fmaxf(s2 / P - m * m, 0.f);
}

}  // namespace
}  // namespace bft

// The tiles of 128 output pixels an image: the scratch of bf_probe_stage is
// (bt, tiles, 2, F) float32.
extern "C" int bf_probe_stage_tiles(int H, int W) {
  return ((H / 2) * (W / 2) + bft::kStageRows - 1) / bft::kStageRows;
}

// y (bt, H, W, C) bf16, mean and inv (bt, C) float32, k (2, 2, C, F) bf16, all
// contiguous; out (bt, H/2, W/2, F) bf16, partial (bt, tiles, 2, F) float32
// scratch, mu and var (bt, F) float32.  H and W even, F at most 192.
// Returns a cudaError_t.
extern "C" int bf_probe_stage(const void* y, const float* mean, const float* inv, const void* k,
                              void* out, float* partial, float* mu, float* var, int bt, int H,
                              int W, int C, int F, void* stream) {
  using namespace bft;
  if (bt < 1 || bt > 65535 || H < 2 || W < 2 || H % 2 || W % 2 || C < 1 || F < 1 ||
      F > kBN || 4LL * C > 2147483647LL)
    return cudaErrorInvalidValue;
  const int tiles = bf_probe_stage_tiles(H, W);
  const size_t smem = gemm_smem_bytes<bf16>(kMaxMTiles);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return e;
  stage_kernel<<<dim3(tiles, bt), kGemmThreads, smem, s>>>(
      static_cast<const bf16*>(y), mean, inv, static_cast<const bf16*>(k),
      static_cast<bf16*>(out), partial, H, W, C, F);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  stage_stats_kernel<<<(bt * F + 255) / 256, 256, 0, s>>>(partial, mu, var, bt, tiles, F,
                                                          (H / 2) * (W / 2));
  return cudaGetLastError();
}
