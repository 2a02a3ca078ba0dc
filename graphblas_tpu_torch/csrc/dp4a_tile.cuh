// The int8 tile product that the band ring and window count (window.cu:
// K1, K2) share: one CUDA block of NT threads accumulates a 128x64 int32
// tile of A.B or A.B^T with __dp4a (4 int8 multiply-accumulates per
// instruction), staging 32-byte slices of both operands through shared
// memory packed as 4-byte words.  The window product (K3) and the BSR
// tile-triple kernel's counting form (K7) run on the int8 tensor-core tile
// of mma_s8_tile.cuh; K1 and K2 may take it in turn.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 128;        // rows per tile (and band block width)
constexpr int TN = 64;        // output columns per CUDA block
constexpr int KC = 32;        // contraction bytes per shared-memory stage
constexpr int KW = KC / 4;    // packed 4-byte words per stage
constexpr int NT = 256;       // threads: 16 x 16, each 8 rows x 4 columns

// Adds to acc the block's 128x64 int32 tile of the product, contraction
// length K (a multiple of KC): thread (tx, ty) = (t % 16, t / 16) holds
// acc[i][j] += (product)[ty + 16*i, tx + 16*j].  A: row r at A + r*lda (k
// contiguous).  B_KMAJOR: B row k at B + k*ldb (c contiguous), the product
// A.B.  Otherwise B row c at B + c*ldb (k contiguous), the product A.B^T,
// and B's words read as A's do.  A, lda, ldb (when !B_KMAJOR) and every
// stage offset are multiples of 4, so those reads are whole words.
template <bool B_KMAJOR>
__device__ void tile_accumulate(const int8_t* __restrict__ A, long lda,
                                const int8_t* __restrict__ B, long ldb,
                                int K, int (&acc)[8][4]) {
  // As[kw][r]: 4 consecutive k of row r; Bs[kw][c]: 4 consecutive k of
  // column c.  The +4 pads spread the transposing stores over all banks.
  __shared__ int As[KW][T + 4];
  __shared__ int Bs[KW][TN + 4];

  const int t = threadIdx.x;
  const int tx = t % 16;      // columns tx + 16*j
  const int ty = t / 16;      // rows ty + 16*i

  for (int k0 = 0; k0 < K; k0 += KC) {
#pragma unroll
    for (int p = 0; p < (T * KW) / NT; ++p) {
      const int idx = t + NT * p;
      const int r = idx / KW, kw = idx % KW;
      As[kw][r] = *reinterpret_cast<const int*>(A + r * lda + k0 + 4 * kw);
    }
#pragma unroll
    for (int p = 0; p < (TN * KW) / NT; ++p) {
      const int idx = t + NT * p;
      if (B_KMAJOR) {
        const int kw = idx / TN, c = idx % TN;
        const int8_t* b = B + (long)(k0 + 4 * kw) * ldb + c;
        const uint32_t w = (uint32_t)(uint8_t)b[0]
                         | ((uint32_t)(uint8_t)b[ldb] << 8)
                         | ((uint32_t)(uint8_t)b[2 * ldb] << 16)
                         | ((uint32_t)(uint8_t)b[3 * ldb] << 24);
        Bs[kw][c] = (int)w;
      } else {
        const int c = idx / KW, kw = idx % KW;
        Bs[kw][c] =
            *reinterpret_cast<const int*>(B + c * ldb + k0 + 4 * kw);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      int a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kw][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kw][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The block's 128x64 int32 tile of A.B (B k-major), from zero.
__device__ void tile_product(const int8_t* __restrict__ A, long lda,
                             const int8_t* __restrict__ B, long ldb, int K,
                             int (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  tile_accumulate<true>(A, lda, B, ldb, K, acc);
}

}  // namespace
