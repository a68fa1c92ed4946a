// One thread block's GEMM tile, shared by K1's forward and backward kernels.
//
// Cs[m][n] = sum_k A(m, k) * B(n, k) for m < 16 * m_tiles (<= 128) and
// n < 16 * n_tiles (<= 192), accumulated in float32 into the tile at
// gemm_out().  A and B come from loader callables, already rounded to T, so
// a caller can normalise, transpose or mask while it stages.  K runs in
// chunks of kKC through shared memory.  bf16 runs on the tensor cores
// through WMMA (16x16x16, float32 accumulate); float32 runs as an FMA loop.
//
// Staging order: KMajor = false reads A(m, k0..k0+31) with k fastest (the
// operand's rows are contiguous in k, as for activations times a weight);
// KMajor = true reads with m fastest (the operand is stored k-major, as the
// token-major activations of a weight gradient, where k is the token).
// BKMajor sets B's order alike; it defaults to A's.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace bft {

constexpr int kKC = 32;           // K chunk staged in shared memory
constexpr int kBN = 192;          // widest tile: 12 column tiles (one head's q|k|v)
constexpr int kMaxMTiles = 8;     // tallest tile: 128 rows
constexpr int kLDC = kBN + 4;     // float32 output tile row stride
constexpr int kGemmThreads = 256;

// Shared-memory row strides of the staged A / B chunks: bf16 rows of 40
// elements (WMMA needs a multiple of 8), float rows of 33 (odd: no bank
// conflicts in the FMA loop).
template <typename T>
struct Tile {
  static constexpr int ld = kKC + 8;
};
template <>
struct Tile<float> {
  static constexpr int ld = kKC + 1;
};

template <typename T>
__host__ __device__ size_t a_bytes(int m_tiles) {
  return align128(sizeof(T) * 16 * m_tiles * Tile<T>::ld);
}
template <typename T>
__host__ __device__ size_t b_bytes() {
  return align128(sizeof(T) * kBN * Tile<T>::ld);
}
template <typename T>
size_t gemm_smem_bytes(int m_tiles) {
  return a_bytes<T>(m_tiles) + b_bytes<T>() + sizeof(float) * 16 * m_tiles * kLDC;
}
template <typename T>
__device__ float* gemm_out(unsigned char* smem, int m_tiles) {
  return reinterpret_cast<float*>(smem + a_bytes<T>(m_tiles) + b_bytes<T>());
}

// Must be called by all kGemmThreads threads of the block; K a multiple of
// kKC.  The caller synchronises before reading the tile.
template <typename T, bool KMajor, bool BKMajor = KMajor, typename ALoad, typename BLoad>
__device__ void block_gemm(int m_tiles, int n_tiles, int K, ALoad aload, BLoad bload,
                           unsigned char* smem) {
  constexpr int LD = Tile<T>::ld;
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + a_bytes<T>(m_tiles));
  float* Cs = gemm_out<T>(smem, m_tiles);
  const int tid = threadIdx.x;
  const int rows = 16 * m_tiles, cols = 16 * n_tiles;

  auto stage = [&](int k0) {
    for (int e = tid; e < rows * kKC; e += kGemmThreads) {
      const int m = KMajor ? e % rows : e / kKC, kk = KMajor ? e / rows : e % kKC;
      As[m * LD + kk] = aload(m, k0 + kk);
    }
    for (int e = tid; e < cols * kKC; e += kGemmThreads) {
      const int n = BKMajor ? e % cols : e / kKC, kk = BKMajor ? e / cols : e % kKC;
      Bs[n * LD + kk] = bload(n, k0 + kk);
    }
  };

  if constexpr (std::is_same<T, float>::value) {
    // float32: each thread owns rows tm + 16 i and columns tn + 16 j.
    const int tm = tid % 16, tn = tid / 16;
    float acc[kMaxMTiles][12];
#pragma unroll
    for (int i = 0; i < kMaxMTiles; ++i)
#pragma unroll
      for (int j = 0; j < 12; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kKC) {
      stage(k0);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKC; ++kk) {
        float a[kMaxMTiles];
#pragma unroll
        for (int i = 0; i < kMaxMTiles; ++i) a[i] = i < m_tiles ? As[(tm + 16 * i) * LD + kk] : 0.f;
#pragma unroll
        for (int j = 0; j < 12; ++j) {
          if (j < n_tiles) {
            const float bv = Bs[(tn + 16 * j) * LD + kk];
#pragma unroll
            for (int i = 0; i < kMaxMTiles; ++i) acc[i][j] += a[i] * bv;
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kMaxMTiles; ++i)
#pragma unroll
      for (int j = 0; j < 12; ++j)
        if (i < m_tiles && j < n_tiles) Cs[(tm + 16 * i) * kLDC + tn + 16 * j] = acc[i][j];
  } else {
    // bf16: WMMA 16x16x16 tiles, float32 accumulators; warp w owns the
    // fragments w, w + 8, ...
    using namespace nvcuda;
    constexpr int kWarpsG = kGemmThreads / 32;
    constexpr int kMaxFrags = (kMaxMTiles * 12 + kWarpsG - 1) / kWarpsG;
    const int warp = tid / 32;
    const int nfrag = m_tiles * n_tiles;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxFrags];
#pragma unroll
    for (int i = 0; i < kMaxFrags; ++i) wmma::fill_fragment(acc[i], 0.f);
    for (int k0 = 0; k0 < K; k0 += kKC) {
      stage(k0);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kMaxFrags; ++i) {
        const int f = warp + i * kWarpsG;
        if (f < nfrag) {
          const int mt = f / n_tiles, nt = f % n_tiles;
#pragma unroll
          for (int kk = 0; kk < kKC; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
            wmma::load_matrix_sync(fa, As + mt * 16 * LD + kk, LD);
            wmma::load_matrix_sync(fb, Bs + nt * 16 * LD + kk, LD);
            wmma::mma_sync(acc[i], fa, fb, acc[i]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kMaxFrags; ++i) {
      const int f = warp + i * kWarpsG;
      if (f < nfrag) {
        const int mt = f / n_tiles, nt = f % n_tiles;
        wmma::store_matrix_sync(Cs + mt * 16 * kLDC + nt * 16, acc[i], kLDC, wmma::mem_row_major);
      }
    }
  }
}

}  // namespace bft
