// A bf16 GEMM for Hopper (sm_90a), written by hand: TMA loads into a ring of
// shared-memory stages, each guarded by a pair of mbarriers, one producer
// warp that keeps the loads in flight, and two consumer warpgroups that
// multiply with wgmma.mma_async (m64n128k16, float32 accumulators in
// registers).  K1's, K3's, K5's and K9's bf16 products run on it
// (temporal_block.cu, temporal_block_bwd.cu, axial_block_mega.cu,
// axial_lane_px.cu); hopper_gemm.cu exposes it alone for the tests.
//
// Two operand layouts, both row-major bf16 in device memory:
//   NT  out(M, N) = A(M, K) . B(N, K)^T: activations times a torch (out, in)
//       weight, both K-major.  TMA boxes of 64 K x 128 rows, 128-byte
//       swizzle, read by wgmma as K-major operands.
//   TN  out(M, N) = sum_r D(r, M) . S(r, N): a weight gradient over tokens
//       r, both operands token-major.  TMA boxes of 64 columns x 64 tokens,
//       128-byte swizzle, read by wgmma as MN-major ("transposed") operands,
//       so nothing is staged by threads.  The tokens are split into ranges
//       (SplitPlan, computed by the caller): each range writes its float32
//       partial tile, and splitk_sum_kernel adds the partials in range order,
//       so the sum repeats bit for bit from run to run (no atomics).
//       K9 runs tn_partials once per direction into consecutive partials
//       and adds both directions' ranges in one splitk_sum.
// Epilogues: float32 bias added and the sum rounded to bf16 (kBiasRound),
// the sum rounded to bf16 without a bias (kRound), the sum rounded to bf16
// and added to the bf16 output in bf16 (kRoundAdd), float32 stored
// (kStoreF32), float32 partial of a token range (kPartialF32).  Rows and
// columns beyond M, N are masked; the ragged end of K is zero-filled by TMA.
//
// Tile 128 x 128 x 64, three stages of 32 KB: two blocks fit one SM, so one
// block's epilogue overlaps the other's loads.  Tensor maps are encoded on
// the host (cuTensorMapEncodeTiled, fetched from the libcuda the CUDA
// runtime has loaded) and passed as __grid_constant__ kernel parameters.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

#include "common.cuh"

namespace bft {
namespace {
namespace hg {

constexpr int kBM = 128;  // rows of a tile: two warpgroups of 64
constexpr int kBN = 128;  // columns of a tile (wgmma n)
constexpr int kBK = 64;   // K of a stage: 64 bf16 = one 128-byte swizzle row
constexpr int kStages = 3;
constexpr int kConsumers = 256;                // two warpgroups
constexpr int kThreads = kConsumers + 32;      // and the producer warp
constexpr int kOperandBytes = kBM * kBK * 2;   // 16 KB (kBN == kBM)
constexpr int kStageBytes = 2 * kOperandBytes; // A then B
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + barriers, align
constexpr int kMaxSplits = 64;
static_assert(kBN == kBM, "one operand stage size for A and B");

enum Epilogue { kBiasRound = 0, kStoreF32 = 1, kPartialF32 = 2, kRound = 3, kRoundAdd = 4 };

// Token ranges of a split-K product: range z is [begin[z], begin[z + 1]),
// every begin but the last a multiple of kBK.  One range [0, K) for NT.
struct SplitPlan {
  int splits;
  int begin[kMaxSplits + 1];
};

struct EpilogueArgs {
  void* out;          // bf16 (kBiasRound, kRound, kRoundAdd) or float32; partials at
                      // out + z * M * N
  const float* bias;  // kBiasRound only
  int ldo;            // row stride of out, elements
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits until the barrier's phase of the given parity has completed.  A
// wait of more than ten seconds is a broken pipeline: it traps (the launch
// then fails and the wrapper raises) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  for (uint32_t spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin % 1024 == 0) {
      const uint64_t now = global_ns();
      if (spin == 0) start = now;
      else if (now - start > 10000000000ull) __trap();
    }
  }
}

// One box of a 2-D tensor map into shared memory; completion counts bytes on bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128).
// K-major: sbo = 1024 (eight 128-byte rows), lbo unused.  MN-major: sbo =
// 1024 (eight K rows), lbo = the stride between 64-wide MN blocks.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d(64 x 128) += A(64 x 16) . B(16 x 128); kTrans: both operands MN-major.
template <int kTrans>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTrans));
}

// Grid (ceil(N / kBN), ceil(M / kBM), plan.splits), kThreads threads,
// kSmemBytes of dynamic shared memory.  Warps 0-7 (two warpgroups) compute
// rows [64 w, 64 w + 64) of the tile; warp 8 lane 0 issues the loads.
template <bool kTN, int kEpi>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                int M, int N, const __grid_constant__ SplitPlan plan, EpilogueArgs ep) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1 KB
  const uint32_t bars = base + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  const int tid = threadIdx.x, warp = tid / 32;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int k_begin = plan.begin[blockIdx.z], k_end = plan.begin[blockIdx.z + 1];
  const int nk = (k_end - k_begin + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // Producer: keeps up to kStages stages of loads in flight.  A box that
    // lies wholly beyond M or N is not loaded (its rows or columns of the
    // product are masked in the epilogue); the ragged end of K is zero-filled.
    if (tid % 32 == 0) {
      const bool a1 = m0 + 64 < M, b1 = n0 + 64 < N;  // TN: the tile's second 64-wide box
      const uint32_t tx = kTN ? (2 + a1 + b1) * (kOperandBytes / 2) : kStageBytes;
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % kStages;
        mbar_wait(empty(s), ((kb / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), tx);
        const uint32_t a = base + s * kStageBytes, b = a + kOperandBytes;
        const int k = k_begin + kb * kBK;
        if constexpr (kTN) {
          tma_load_2d(a, &ta, full(s), m0, k);
          if (a1) tma_load_2d(a + kOperandBytes / 2, &ta, full(s), m0 + 64, k);
          tma_load_2d(b, &tb, full(s), n0, k);
          if (b1) tma_load_2d(b + kOperandBytes / 2, &tb, full(s), n0 + 64, k);
        } else {
          tma_load_2d(a, &ta, full(s), k, m0);
          tma_load_2d(b, &tb, full(s), k, n0);
        }
      }
    }
  } else {
    const int wg = warp / 4;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % kStages;
      mbar_wait(full(s), (kb / kStages) & 1);
      const uint32_t a = base + s * kStageBytes, b = a + kOperandBytes;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        if constexpr (kTN) {
          // 16 tokens = 16 swizzled rows of 128 bytes; B's two 64-wide
          // column blocks are kOperandBytes / 2 apart.
          wgmma_m64n128k16<1>(acc, sw128_desc(a + wg * (kOperandBytes / 2) + kk * 2048, 8192, 1024),
                              sw128_desc(b + kk * 2048, kOperandBytes / 2, 1024));
        } else {
          // 16 K values = 32 bytes along each swizzled row.
          wgmma_m64n128k16<0>(acc, sw128_desc(a + wg * 64 * 128 + kk * 32, 16, 1024),
                              sw128_desc(b + kk * 32, 16, 1024));
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      if (tid % 128 == 0) mbar_arrive(empty(s));
    }

    // Accumulator layout of m64nNk16: thread (warp wi, lane l) of the
    // warpgroup holds rows 16 wi + l / 4 (+ 8) and columns 8 j + 2 (l % 4)
    // (+ 1) as acc[4 j + {0, 1}] (+ 8 rows: acc[4 j + {2, 3}]).
    const int lane = tid % 32, wi = (tid % 128) / 32;
    const int row0 = m0 + wg * 64 + wi * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + j * 8 + (lane % 4) * 2;
      if (col >= N) continue;  // N is even: col + 1 < N too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= M) continue;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        const size_t at = static_cast<size_t>(row) * ep.ldo + col;
        if constexpr (kEpi == kRoundAdd) {
          auto* o = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(ep.out) + at);
          const float2 old = __bfloat1622float2(*o);
          const float2 add = __bfloat1622float2(__floats2bfloat162_rn(v0, v1));
          *o = __floats2bfloat162_rn(old.x + add.x, old.y + add.y);
        } else if constexpr (kEpi == kBiasRound || kEpi == kRound) {
          const float b0 = kEpi == kBiasRound ? ep.bias[col] : 0.f;
          const float b1 = kEpi == kBiasRound ? ep.bias[col + 1] : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(ep.out) + at) =
              __floats2bfloat162_rn(v0 + b0, v1 + b1);
        } else {
          float* o = static_cast<float*>(ep.out);
          if constexpr (kEpi == kPartialF32) o += static_cast<size_t>(blockIdx.z) * M * N;
          *reinterpret_cast<float2*>(o + at) = make_float2(v0, v1);
        }
      }
    }
  }
}

// dW = sum_z part[z] over the split-K ranges, in range order; n4 = M * N / 4.
__global__ void splitk_sum_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                                  int n4, int splits) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += gridDim.x * blockDim.x) {
    float4 a = part[i];
    for (int z = 1; z < splits; ++z) {
      const float4 v = part[static_cast<size_t>(z) * n4 + i];
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    out[i] = a;
  }
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda the CUDA runtime has
// loaded (the library links no -lcuda).
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A tensor map of a row-major bf16 (rows, cols) matrix with row stride ld
// (elements), boxes of box_cols x box_rows, 128-byte swizzle, zero fill.
cudaError_t encode_map(CUtensorMap* map, const void* ptr, int rows, int cols, int ld,
                       int box_cols, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool kTN, int kEpi>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb, int M, int N,
                   const SplitPlan& plan, EpilogueArgs ep, cudaStream_t stream) {
  auto kernel = gemm_kernel<kTN, kEpi>;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemBytes)) != cudaSuccess)
    return e;
  kernel<<<dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, plan.splits), kThreads, kSmemBytes,
           stream>>>(ta, tb, M, N, plan, ep);
  return cudaGetLastError();
}

// out(M, N) = A(M, K) . B(N, K)^T with epilogue kEpi (kBiasRound: out bf16,
// out = bf16(sum + bias); kRound: out = bf16(sum), bias unused; kRoundAdd:
// out = bf16(out + bf16(sum)), bias unused; kStoreF32: out float32).  A, B bf16 with row
// strides lda, ldb; every base and row stride 16-byte aligned (the callers
// check), N even.
template <int kEpi>
cudaError_t gemm_nt(const __nv_bfloat16* A, int lda, const __nv_bfloat16* B, int ldb, int M,
                    int N, int K, void* out, int ldo, const float* bias, cudaStream_t stream) {
  static_assert(kEpi != kPartialF32, "NT runs over all of K");
  CUtensorMap ta, tb;
  cudaError_t e;
  if ((e = encode_map(&ta, A, M, K, lda, kBK, kBM)) != cudaSuccess) return e;
  if ((e = encode_map(&tb, B, N, K, ldb, kBK, kBN)) != cudaSuccess) return e;
  SplitPlan plan{};
  plan.splits = 1;
  plan.begin[1] = K;
  return launch<false, kEpi>(ta, tb, M, N, plan, EpilogueArgs{out, bias, ldo}, stream);
}

// The split plan of token bounds[0..splits] (bounds[0] = 0, bounds[splits]
// = R, the inner ones increasing multiples of kBK); false if it is not one.
inline bool make_plan(const int* bounds, int splits, int R, SplitPlan* plan) {
  if (splits < 1 || splits > kMaxSplits || bounds[0] != 0 || bounds[splits] != R) return false;
  *plan = SplitPlan{};
  plan->splits = splits;
  for (int z = 0; z <= splits; ++z) {
    plan->begin[z] = bounds[z];
    if (z > 0 && (bounds[z] <= bounds[z - 1] || (z < splits && bounds[z] % kBK))) return false;
  }
  return true;
}

// The float32 partials of D^T S over the plan's token ranges into part.
cudaError_t tn_partials(const __nv_bfloat16* D, const __nv_bfloat16* S, int R, int M, int N,
                        const SplitPlan& plan, float* part, cudaStream_t stream) {
  CUtensorMap ta, tb;
  cudaError_t e;
  if ((e = encode_map(&ta, D, R, M, M, 64, kBK)) != cudaSuccess) return e;
  if ((e = encode_map(&tb, S, R, N, N, 64, kBK)) != cudaSuccess) return e;
  return launch<true, kPartialF32>(ta, tb, M, N, plan, EpilogueArgs{part, nullptr, N}, stream);
}

cudaError_t splitk_sum(const float* part, float* dW, int M, int N, int splits,
                       cudaStream_t stream) {
  const int n4 = M * N / 4;
  splitk_sum_kernel<<<(n4 + 255) / 256, 256, 0, stream>>>(reinterpret_cast<const float4*>(part),
                                                         reinterpret_cast<float4*>(dW), n4,
                                                         splits);
  return cudaGetLastError();
}

// dW(M, N) = sum_{r < R} D(r, m) S(r, n), by token ranges: bounds[0..splits]
// (bounds[0] = 0, bounds[splits] = R, the inner ones multiples of kBK).
// D (R, M) and S (R, N) bf16 row-major; part holds splits * M * N floats; M,
// N multiples of 8.
cudaError_t gemm_tn_splitk(const __nv_bfloat16* D, const __nv_bfloat16* S, int R, int M, int N,
                           const int* bounds, int splits, float* part, float* dW,
                           cudaStream_t stream) {
  SplitPlan plan;
  if (!make_plan(bounds, splits, R, &plan)) return cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = tn_partials(D, S, R, M, N, plan, part, stream)) != cudaSuccess) return e;
  return splitk_sum(part, dW, M, N, splits, stream);
}

}  // namespace hg
}  // namespace
}  // namespace bft
