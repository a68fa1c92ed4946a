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
// The fold needs no gather.  For one image, one output row oy and one dy,
// the K slice [2C dy, 2C dy + 2C) of output pixel ox is y[b, 2oy + dy, 2ox :
// 2ox + 2, :], 2C contiguous values, and k.reshape(4C, F) orders K as dy 2C +
// dx C + c.  So a tile of output pixels is read by TMA as boxes of a 5-D
// view of y, (2C, W/2, 2, H/2, bt) innermost first: 64 columns of one dy x bx
// pixels of a row x by rows (bx by <= 128; by > 1 where W/2 < 128), the
// product's A operand as hopper_gemm.cuh's NT layout stages it (K-major,
// 128-byte swizzle).  B is k as a (F, 2C, 2) tensor, read as the NN layout
// reads its B (64 K rows x 64 columns, MN-major); TMA's zero fill pads 2C to
// the 64-column stage and F to the 128-wide tile.  The bound is the bytes
// (below), so the kernel keeps hopper_gemm.cuh's shape: a producer warp
// keeps three stages of loads in flight, two consumer warpgroups multiply
// with wgmma.  Between a stage landing and its product each warpgroup
// rewrites its 64 rows in place: 16 bytes (8 channels, found through the
// swizzle) a thread, normalised with the image's (mean, inv) staged once a
// block, GELU, rounded; then fence.proxy.async and the shared-memory wgmma.
// GELU's tanh is 1 - 2 / (exp(2u) + 1) on ex2.approx and rcp.approx (two
// MUFU operations a value instead of tanhf's longer sequence), within about
// 1e-6 of tanhf, far below the bf16 rounding that follows.
//
// The TPU kernel summed the statistics across its sequential grid in one
// accumulator.  Hopper's blocks run in no order, so each tile writes the
// column sums of its acc and acc^2 (its rows in a fixed order: a thread's
// two rows, the warp's butterfly, the eight warps in order) and a second
// launch adds the tiles in order, as K10 (lp_loss.cu) does: the statistics
// repeat bit for bit.  out is staged through shared memory and stored 16
// bytes a thread.
//
// Bound at the probe's shape (bt = 20, 256 x 256 x 96 -> 128 x 128 x 96):
// its bytes, 252 MB of y and 63 MB of out (0.094 ms at 3.35 TB/s); the
// product is 24 GFLOP (0.024 ms on the tensor cores), GELU two MUFU
// operations on each of 126 M values.
#include <atomic>
#include <cmath>

#include "hopper_gemm.cuh"

namespace bft {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kTileRows = 128;              // output pixels a tile: two warpgroups of 64
constexpr int kTileCols = 128;              // output channels a tile (wgmma n)
constexpr int kStageK = 64;                 // K of a stage: 64 columns of one dy
constexpr int kStages = 3;
constexpr int kABytes = kTileRows * kStageK * 2;  // 16 KB
constexpr int kBBox = kStageK * 64 * 2;           // one 64-column box of B: 8 KB
constexpr int kStageBytes = kABytes + 2 * kBBox;  // 32 KB
constexpr int kThreads = 256 + 32;                // two consumer warpgroups and the producer
constexpr int kOutLd = kTileCols + 8;             // bf16 row stride of the staged out tile
constexpr int kMaxSmem = 232448;                  // a block's shared memory on Hopper

// The stage's geometry and pointers; the tensor maps travel beside it.
struct StageArgs {
  const float* mean;  // (bt, C)
  const float* inv;   // (bt, C)
  bf16* out;          // (bt, H/2, W/2, F)
  float* partial;     // (bt, tiles, 2, F)
  int C, F, Ho, Wo;
  int bx, by;         // a tile: bx pixels of a row x by rows
  int tiles_x, tiles;
  int kch;            // 64-column chunks of a dy's 2C columns
};

__host__ __device__ constexpr size_t stage_smem_bytes(int kch) {
  // alignment slack, the stages, the (mean, inv) table of a dy's columns,
  // 2 kStages barriers
  return 1024 + size_t(kStages) * kStageBytes + size_t(kch) * kStageK * 8 + 2 * kStages * 8;
}

// The most input channels C: the chunks of 2C columns whose table still
// fits, kStageK / 2 channels a chunk (a multiple of 4).
constexpr int kMaxChannels =
    int((kMaxSmem - stage_smem_bytes(0)) / (kStageK * 8)) * (kStageK / 2);

// jax.nn.gelu(x, approximate=True) = x (1 + tanh(u)) / 2 with u = sqrt(2 /
// pi) (x + 0.044715 x^3), as x (1 - 1 / (e + 1)), e = exp(2u) = 2^(x (c1 +
// c2 x^2)).  e = inf gives x, e = 0 gives 0, as tanh's +-1 do.
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float c1 = 2.f * 0.7978845608028654f * 1.4426950408889634f;
  constexpr float c2 = c1 * 0.044715f;
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(x * fmaf(c2, x * x, c1)));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(e + 1.f));
  return fmaf(-x, r, x);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Grid (tiles, ceil(F / 128), bt): block (t, n, b) computes the output
// channels [128 n, 128 n + 128) of tile t of image b, pixels (oy0 + m / bx,
// ox0 + m % bx) for m < bx by; partial[((b tiles + t) 2 + {0, 1}) F + f]
// holds the tile's sums of acc and acc^2.
__global__ void __launch_bounds__(kThreads, 2)
    stage_kernel(const __grid_constant__ CUtensorMap ty, const __grid_constant__ CUtensorMap tk,
                 const StageArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1 KB
  uint8_t* const sbase = smem_raw + (base - raw);
  const int kch = a.kch, nk = 2 * kch;
  float2* const table = reinterpret_cast<float2*>(sbase + kStages * kStageBytes);
  const uint32_t bars = base + kStages * kStageBytes + kch * kStageK * 8;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  const int tid = threadIdx.x, warp = tid / 32;
  const int t = blockIdx.x, n0 = blockIdx.y * kTileCols, b = blockIdx.z;
  const int ox0 = (t % a.tiles_x) * a.bx, oy0 = (t / a.tiles_x) * a.by;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hg::mbar_init(full(s), 1);
      hg::mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Column j of a dy's 2C is channel j mod C; past 2C (the zero fill) the
  // pair (0, 0) maps the fill to GELU(0) = 0.
  for (int j = tid; j < kch * kStageK; j += kThreads) {
    const int c = j < a.C ? j : j - a.C;
    table[j] = j < 2 * a.C ? make_float2(a.mean[(size_t)b * a.C + c], a.inv[(size_t)b * a.C + c])
                           : make_float2(0.f, 0.f);
  }
  __syncthreads();

  if (warp == 8) {
    if (tid % 32 == 0) {
      const bool b1 = n0 + 64 < a.F;  // the tile's second 64-column box of B
      const uint32_t tx = a.bx * a.by * 128 + (1 + b1) * kBBox;
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % kStages, dy = kb / kch, c0 = (kb % kch) * kStageK;
        hg::mbar_wait(empty(s), ((kb / kStages) & 1) ^ 1);
        hg::mbar_expect_tx(full(s), tx);
        const uint32_t sa = base + s * kStageBytes, sb = sa + kABytes;
        hg::tma_load_5d(sa, &ty, full(s), c0, ox0, dy, oy0, b);
        hg::tma_load_3d(sb, &tk, full(s), n0, c0, dy);
        if (b1) hg::tma_load_3d(sb + kBBox, &tk, full(s), n0 + 64, c0, dy);
      }
    }
    return;
  }

  const int wg = warp / 4, tw = tid % 128;
  const int chunk = tw % 8, r0 = 64 * wg + tw / 8;  // 16-byte chunk and first row of a thread
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % kStages;
    const float4* tab = reinterpret_cast<const float4*>(table + (kb % kch) * kStageK + 8 * chunk);
    float4 mi[4];  // (mean, inv) of the chunk's 8 columns, two a float4
#pragma unroll
    for (int e = 0; e < 4; ++e) mi[e] = tab[e];
    hg::mbar_wait(full(s), (kb / kStages) & 1);
    uint8_t* const sa = sbase + s * kStageBytes;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 16 * i;
      uint4* const p = reinterpret_cast<uint4*>(sa + r * 128 + ((chunk ^ (r & 7)) << 4));
      uint4 v = *p;
      uint32_t* const w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        const __nv_bfloat162 o = __floats2bfloat162_rn(gelu_tanh((f.x - mi[e].x) * mi[e].y),
                                                       gelu_tanh((f.y - mi[e].z) * mi[e].w));
        w[e] = *reinterpret_cast<const uint32_t*>(&o);
      }
      *p = v;
    }
    // The rewritten rows to the async proxy that wgmma reads through, then
    // the warpgroup's 64 rows complete before its product.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1 + wg, 128);
    const uint32_t ua = base + s * kStageBytes, ub = ua + kABytes;
    hg::fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kStageK / 16; ++kk)
      hg::wgmma_m64n128k16<0, 1>(acc, hg::sw128_desc(ua + wg * 64 * 128 + kk * 32, 16, 1024),
                                 hg::sw128_desc(ub + kk * 2048, kBBox, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    hg::fence_regs(acc);
    if (tw == 0) hg::mbar_arrive(empty(s));
  }

  // Both warpgroups past their last product: the stages become the out
  // tile (bf16, kOutLd a row) and the warps' column sums.
  bar_sync(3, 256);
  bf16* const ot = reinterpret_cast<bf16*>(sbase);
  float* const red = reinterpret_cast<float*>(sbase + kTileRows * kOutLd * 2);  // [8][2][128]
  const int lane = tid % 32, g = lane / 4, q = lane % 4;
  auto pixel_ok = [&](int m) {
    return m < a.bx * a.by && ox0 + m % a.bx < a.Wo && oy0 + m / a.bx < a.Ho;
  };
  const int m_lo = 64 * wg + 16 * (warp % 4) + g;  // the thread's rows m_lo, m_lo + 8
  const bool ok0 = pixel_ok(m_lo), ok1 = pixel_ok(m_lo + 8);
#pragma unroll
  for (int j = 0; j < kTileCols / 8; ++j) {
    const int col = 8 * j + 2 * q;
    float s1x = 0.f, s1y = 0.f, s2x = 0.f, s2y = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (h ? ok1 : ok0) {
        s1x += v0;
        s1y += v1;
        s2x += v0 * v0;
        s2y += v1 * v1;
      }
      *reinterpret_cast<__nv_bfloat162*>(ot + (m_lo + 8 * h) * kOutLd + col) =
          __floats2bfloat162_rn(v0, v1);
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s1x += __shfl_xor_sync(0xffffffffu, s1x, o);
      s1y += __shfl_xor_sync(0xffffffffu, s1y, o);
      s2x += __shfl_xor_sync(0xffffffffu, s2x, o);
      s2y += __shfl_xor_sync(0xffffffffu, s2y, o);
    }
    if (g == 0) {
      float* const r = red + warp * 2 * kTileCols;
      r[col] = s1x;
      r[col + 1] = s1y;
      r[kTileCols + col] = s2x;
      r[kTileCols + col + 1] = s2y;
    }
  }
  bar_sync(3, 256);
  {
    const int which = tid / kTileCols, col = tid % kTileCols;  // 256 threads: both sums
    if (n0 + col < a.F) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) sum += red[(w * 2 + which) * kTileCols + col];
      a.partial[(((size_t)b * a.tiles + t) * 2 + which) * a.F + n0 + col] = sum;
    }
  }
  const int chunks = min(kTileCols, a.F - n0) / 8;  // 16-byte chunks of an out row
  for (int e = tid; e < kTileRows * chunks; e += 256) {
    const int m = e / chunks, c8 = e % chunks;
    if (!pixel_ok(m)) continue;
    const size_t pix = ((size_t)b * a.Ho + oy0 + m / a.bx) * a.Wo + ox0 + m % a.bx;
    *reinterpret_cast<uint4*>(a.out + pix * a.F + n0 + 8 * c8) =
        *reinterpret_cast<const uint4*>(ot + m * kOutLd + 8 * c8);
  }
}

// mu, var (bt, F) from the tiles' partial sums, added in tile order.  Grid
// (bt), kStatsThreads threads: the image's partials go through shared
// memory kStatsTiles tiles at a time, every thread's loads in flight at
// once, then thread f adds its column's in tile order.  (A thread a column
// reading its own partials one tile after another took 26 us at the probe's
// 128 tiles: one load latency a tile.)
constexpr int kStatsThreads = 256;  // at least F
constexpr int kStatsTiles = 32;     // 48 KB of partials at F = 192

__global__ void __launch_bounds__(kStatsThreads)
    stage_stats_kernel(const float* __restrict__ partial, float* __restrict__ mu,
                       float* __restrict__ var, int tiles, int F, int P) {
  __shared__ float buf[kStatsTiles * 2 * 192];
  const int b = blockIdx.x, f = threadIdx.x;
  const float* part = partial + (size_t)b * tiles * 2 * F;
  float s1 = 0.f, s2 = 0.f;
  for (int t0 = 0; t0 < tiles; t0 += kStatsTiles) {
    const int nt = min(kStatsTiles, tiles - t0);
    for (int e = threadIdx.x; e < nt * 2 * F; e += kStatsThreads)
      buf[e] = part[(size_t)t0 * 2 * F + e];
    __syncthreads();
    if (f < F)
      for (int u = 0; u < nt; ++u) {
        s1 += buf[u * 2 * F + f];
        s2 += buf[u * 2 * F + F + f];
      }
    __syncthreads();
  }
  if (f < F) {
    const float m = s1 / P;
    mu[(size_t)b * F + f] = m;
    var[(size_t)b * F + f] = fmaxf(s2 / P - m * m, 0.f);
  }
}

}  // namespace
}  // namespace bft

// The most input channels C the stage takes, a multiple of 4: the largest
// whose (mean, inv) table fits beside the stages in a block's shared memory.
extern "C" int bf_probe_stage_max_channels() { return bft::kMaxChannels; }

// y (bt, H, W, C) bf16, mean and inv (bt, C) float32, k (2, 2, C, F) bf16, all
// contiguous, y and k 16-byte aligned; out (bt, H/2, W/2, F) bf16, partial
// (bt, tiles, 2, F) float32 scratch with tiles = ceil((W/2) / bx) ceil((H/2)
// / by), mu and var (bt, F) float32.  H and W even, C a multiple of 4 and F
// of 8 (TMA's 16-byte rows), F at most 192, bx by <= 128 (the tile; the
// wrapper's pyramid.stage_tiles picks it).  Returns a cudaError_t.
extern "C" int bf_probe_stage(const void* y, const float* mean, const float* inv, const void* k,
                              void* out, float* partial, float* mu, float* var, int bt, int H,
                              int W, int C, int F, int bx, int by, void* stream) {
  using namespace bft;
  const int Ho = H / 2, Wo = W / 2, kch = (2 * C + kStageK - 1) / kStageK;
  if (bt < 1 || bt > 65535 || H < 2 || W < 2 || H % 2 || W % 2 || C < 4 || C % 4 || F < 8 ||
      F % 8 || F > 192 || bx < 1 || by < 1 || bx * by > kTileRows || bx > Wo || by > Ho ||
      C > bf_probe_stage_max_channels())
    return cudaErrorInvalidValue;
  const int tiles_x = (Wo + bx - 1) / bx, tiles = tiles_x * ((Ho + by - 1) / by);
  CUtensorMap ty, tk;
  cudaError_t e;
  {
    const long long dims[5] = {2LL * C, Wo, 2, Ho, bt};
    const long long strides[4] = {2LL * C, (long long)W * C, 2LL * W * C, (long long)H * W * C};
    const int box[5] = {kStageK, bx, 1, by, 1};
    if ((e = hg::encode_map_nd(&ty, y, 5, dims, strides, box)) != cudaSuccess) return e;
  }
  {
    const long long dims[3] = {F, 2LL * C, 2};
    const long long strides[2] = {F, 2LL * C * F};
    const int box[3] = {64, kStageK, 1};
    if ((e = hg::encode_map_nd(&tk, k, 3, dims, strides, box)) != cudaSuccess) return e;
  }
  static std::atomic<uint64_t> opted{0};  // opted in at the most a block may have
  if ((e = hg::opt_in_smem(reinterpret_cast<const void*>(stage_kernel), kMaxSmem, &opted)) !=
      cudaSuccess)
    return e;
  const StageArgs a{mean, inv, static_cast<bf16*>(out), partial, C, F, Ho, Wo, bx, by,
                    tiles_x, tiles, kch};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  stage_kernel<<<dim3(tiles, (F + kTileCols - 1) / kTileCols, bt), kThreads,
                 stage_smem_bytes(kch), s>>>(ty, tk, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  stage_stats_kernel<<<bt, kStatsThreads, 0, s>>>(partial, mu, var, tiles, F, Ho * Wo);
  return cudaGetLastError();
}
