// The fixed-order sum of the attention kernels' parameter gradients: the
// backward blocks of the line kernels (line_kernels.cuh) and of the bf16
// Hopper kernels (lane_hopper.cuh) each own a fixed set of lines and write
// one partial of the T5 tables', the attn scales' and the qk-LN vectors'
// gradients; this last launch adds the partials in block order.  No global
// atomic touches a parameter gradient, so every one of them repeats bit for
// bit from run to run.  Included by each .cu that launches it (internal
// linkage).
#pragma once

#include "common.cuh"

namespace bft {
namespace {

// The partials of both passes (p = 0 rows, 1 columns; a pass with L[p] = 0
// has no table and no units):
//   part_bias[p]  (bias_groups[p], heads, L[p], L[p]): the table's gradient;
//   part_scale[p] (heads, scale_units[p]): the attn scale's;
//   part_ln[p]    (4 D, ln_units[p]): (dy xhat, dy) of q, then of k;
// the last two element-major, so that each output's partials are one
// contiguous row.  Outputs, written whole: dbias[p] (heads, L[p], L[p]);
// dscale (heads, 2) = [rows, columns]; dln (4, D) = rows + columns, or
// nothing when dln is null.
struct ParamSumArgs {
  const float* part_bias[2];
  const float* part_scale[2];
  const float* part_ln[2];
  int bias_groups[2], scale_units[2], ln_units[2], L[2];
  float* dbias[2];
  float* dscale;
  float* dln;
  int heads, D;
};

// The 256 threads' values summed in a fixed order (a shuffle tree a warp,
// then the warps in order); the result in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red's last use is done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < 8; ++w) t += red[w];
  }
  return t;
}

// Blocks of 256 threads, in three ranges: the tables, a block 32 elements (a
// lane each) and eight slices of their partials (a warp each: groups g =
// warp, warp + 8, ...), the slices' sums added in warp order; then an
// element of dln a block, then one of dscale a block: the threads stride
// its row of partials (both passes' for dln), and block_sum adds them.
__global__ void __launch_bounds__(256) param_sum_kernel(ParamSumArgs a) {
  __shared__ float red[8];
  const int nb0 = a.heads * a.L[0] * a.L[0], nb1 = a.heads * a.L[1] * a.L[1];
  const int nl = a.dln ? 4 * a.D : 0;
  const int table_blocks = (nb0 + nb1 + 31) / 32;
  if ((int)blockIdx.x < table_blocks) {
    __shared__ float slice[8][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int e = blockIdx.x * 32 + lane;
    const bool in = e < nb0 + nb1;
    const int p = e < nb0 ? 0 : 1, nb = p ? nb1 : nb0, x = p ? e - nb0 : e;
    float v = 0.f;
    if (in) {
      for (int g = warp; g < a.bias_groups[p]; g += 8) v += a.part_bias[p][(size_t)g * nb + x];
    }
    slice[warp][lane] = v;
    __syncthreads();
    if (warp == 0 && in) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) t += slice[w][lane];
      a.dbias[p][x] = t;
    }
    return;
  }
  const int b = (int)blockIdx.x - table_blocks;
  if (b < nl) {
    float v[2] = {0.f, 0.f};
    for (int p = 0; p < 2; ++p) {
      const float* row = a.part_ln[p] + (size_t)b * a.ln_units[p];
      for (int u = threadIdx.x; u < a.ln_units[p]; u += 256) v[p] += row[u];
    }
    const float s0 = block_sum(v[0], red), s1 = block_sum(v[1], red);
    if (threadIdx.x == 0) a.dln[b] = s0 + s1;
    return;
  }
  const int w = b - nl, hd = w / 2, p = w % 2;
  float v = 0.f;
  const float* row = a.part_scale[p] + (size_t)hd * a.scale_units[p];
  for (int u = threadIdx.x; u < a.scale_units[p]; u += 256) v += row[u];
  v = block_sum(v, red);
  if (threadIdx.x == 0) a.dscale[w] = v;
}

cudaError_t launch_param_sum(const ParamSumArgs& a, cudaStream_t stream) {
  const int tables = a.heads * (a.L[0] * a.L[0] + a.L[1] * a.L[1]);
  const int lns = a.dln ? 4 * a.D : 0;
  param_sum_kernel<<<(tables + 31) / 32 + lns + 2 * a.heads, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

// Every line of a pass in exactly one block: groups * per >= lines and no
// block without a line.
inline bool plan_ok(int lines, int groups, int per) {
  return groups >= 1 && per >= 1 && (long long)groups * per >= lines &&
         (long long)(groups - 1) * per < lines;
}

}  // namespace
}  // namespace bft
