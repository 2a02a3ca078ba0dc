// Masked int8 panel products on banded graphs: per 128-row block i, the
// masked count sum_{r,c} (A.B)[r,c] * M[r,c] as an int32 partial (SandiaDot
// triangle counting), or the masked product panel (A.B) * M itself.
//
// Replaces the TPU kernels of graphblas_tpu/sparse/pallas_window.py:
//   gb_tri_band_ring  <- _tri_ring_launch / _make_tri_ring_kernel (band-ring)
//   gb_window_count   <- _count_launch / _count_kernel (window-panel count)
//   gb_window_mm      <- _mm_launch / _mm_kernel (window-panel product, K3)
//
// What bounds it on the card: int8 multiply-accumulate work on the padded
// band, (Wb*(Wb+1)/2) * 128^3 MACs per block-row for the band ring; the
// panels themselves (L and U once, a few MB to ~1 GB) stream from memory
// once per (block, offset) pair and stay mostly in L2.
//
// What this simple design does about it: one CUDA block per (block-row,
// band offset, 64-column half) for the band ring and per (block-row,
// 64-column tile) for the window count and product, so blocks run in
// parallel where the TPU walked its grid in order; the TPU's VMEM ring that
// streamed U once becomes direct reads of Ut[J] (L2-resident).  Each block
// stages 32-byte slices of both operands through shared memory packed as
// 4-byte words and accumulates a 128x64 int32 tile with __dp4a (4 int8 MACs
// per instruction), multiplies it by the mask tile and either reduces it in
// the block and atomically adds it to partials[i] or writes it to the
// panel.  Integer sums are exact in any order.  The product panel is 4 bytes
// an entry against the operands' 1, so K3 is bound by writing it.
// Tensor-core mma/wgmma and TMA staging are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 128;        // rows per plan block (and band block width)
constexpr int TN = 64;        // output columns per CUDA block
constexpr int KC = 32;        // contraction bytes per shared-memory stage
constexpr int KW = KC / 4;    // packed 4-byte words per stage
constexpr int NT = 256;       // threads: 16 x 16, each 8 rows x 4 columns

// The block's 128x64 int32 tile of A.B, contraction length K (a multiple of
// KC): thread (tx, ty) = (t % 16, t / 16) holds acc[i][j] = (A.B)[ty + 16*i,
// tx + 16*j].  A: row r at A + r*lda (k contiguous).  B: row k at B + k*ldb
// (c contiguous).  A, lda and every stage offset are multiples of 4, so A
// reads as words.
__device__ void tile_product(const int8_t* __restrict__ A, long lda,
                             const int8_t* __restrict__ B, long ldb, int K,
                             int (&acc)[8][4]) {
  // As[kw][r]: 4 consecutive k of row r; the +4 pad spreads the
  // transposing stores over all banks.  Bs[kw][c]: 4 consecutive k of
  // column c.
  __shared__ int As[KW][T + 4];
  __shared__ int Bs[KW][TN];

  const int t = threadIdx.x;
  const int tx = t % 16;      // columns tx + 16*j
  const int ty = t / 16;      // rows ty + 16*i
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

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
      const int kw = idx / TN, c = idx % TN;
      const int8_t* b = B + (long)(k0 + 4 * kw) * ldb + c;
      const uint32_t w = (uint32_t)(uint8_t)b[0]
                       | ((uint32_t)(uint8_t)b[ldb] << 8)
                       | ((uint32_t)(uint8_t)b[2 * ldb] << 16)
                       | ((uint32_t)(uint8_t)b[3 * ldb] << 24);
      Bs[kw][c] = (int)w;
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

// Block-wide sum over r < 128, c < 64 of (A.B)[r,c] * Msk[r,c] (operands as
// for tile_product; Msk: row r at Msk + r*ldm).  The result is valid in
// thread 0.
__device__ int masked_tile_sum(const int8_t* __restrict__ A, long lda,
                               const int8_t* __restrict__ B, long ldb,
                               const int8_t* __restrict__ Msk, long ldm,
                               int K) {
  __shared__ int red[NT / 32];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  int acc[8][4];
  tile_product(A, lda, B, ldb, K, acc);
  int s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s += acc[i][j] * (int)Msk[(long)(ty + 16 * i) * ldm + tx + 16 * j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if (t % 32 == 0) red[t / 32] = s;
  __syncthreads();
  if (t < 32) {
    s = t < NT / 32 ? red[t] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
  }
  return s;
}

// Grid (nI, Wb, 2): block-row i, band offset s (J = i - s), column half h.
// P (nI, T, Wb*T): L block-row i over column blocks [i-Wb+1, i].
// Ut (nI, Wb*T, T): U block-row J transposed, over column blocks [J, J+Wb).
// The pair's contraction runs over the (s+1)*T columns [J*T, (i+1)*T): P's
// columns from jj*T (jj = Wb-1-s) against Ut[J]'s first (s+1)*T rows; the
// mask is P's own column block jj.
__global__ void __launch_bounds__(NT)
tri_band_ring_kernel(const int8_t* __restrict__ P,
                     const int8_t* __restrict__ Ut, int* partials, int Wb) {
  const int i = blockIdx.x, s = blockIdx.y, h = blockIdx.z;
  if (i < s) return;  // J < 0: warm-up rows contribute nothing
  const int J = i - s;
  const int jj = Wb - 1 - s;
  const long W = (long)Wb * T;
  const int8_t* Pi = P + (long)i * T * W;
  const int sum = masked_tile_sum(Pi + (long)jj * T, W,
                                  Ut + (long)J * W * T + h * TN, T,
                                  Pi + (long)jj * T + h * TN, W,
                                  (s + 1) * T);
  if (threadIdx.x == 0 && sum != 0) atomicAdd(partials + i, sum);
}

// Grid (nI, nJ/TN): block-row i, output column tile c.
// P (nI, T, W), Q (nI, W, nJ), M (nI, T, nJ).
__global__ void __launch_bounds__(NT)
window_count_kernel(const int8_t* __restrict__ P,
                    const int8_t* __restrict__ Q,
                    const int8_t* __restrict__ M, int* partials, int W,
                    int nJ) {
  const int i = blockIdx.x;
  const long c0 = (long)blockIdx.y * TN;
  const int sum = masked_tile_sum(P + (long)i * T * W, W,
                                  Q + (long)i * W * nJ + c0, nJ,
                                  M + (long)i * T * nJ + c0, nJ, W);
  if (threadIdx.x == 0 && sum != 0) atomicAdd(partials + i, sum);
}

// Grid (nI, nJ/TN): block-row i, output column tile c.  Same operands as
// window_count_kernel; out (nI, T, nJ) int32 gets (P[i].Q[i]) * M[i].
__global__ void __launch_bounds__(NT)
window_mm_kernel(const int8_t* __restrict__ P, const int8_t* __restrict__ Q,
                 const int8_t* __restrict__ M, int* __restrict__ out, int W,
                 int nJ) {
  const int i = blockIdx.x;
  const long c0 = (long)blockIdx.y * TN;
  int acc[8][4];
  tile_product(P + (long)i * T * W, W, Q + (long)i * W * nJ + c0, nJ, W,
               acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int8_t* Mi = M + (long)i * T * nJ + c0;
  int* Oi = out + (long)i * T * nJ + c0;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long e = (long)(ty + 16 * r) * nJ + tx + 16 * j;
      Oi[e] = acc[r][j] * (int)Mi[e];
    }
}

}  // namespace

// partials (nI,) int32 must be zeroed by the caller.  Wb*T and T are the
// panel widths; the wrapper checks shapes, dtype (int8) and contiguity.
extern "C" int gb_tri_band_ring(const void* P, const void* Ut, void* partials,
                                int nI, int Wb, void* stream) {
  if (nI > 0) {
    tri_band_ring_kernel<<<dim3(nI, Wb, T / TN), NT, 0,
                           (cudaStream_t)stream>>>(
        (const int8_t*)P, (const int8_t*)Ut, (int*)partials, Wb);
  }
  return (int)cudaGetLastError();
}

// W and nJ are multiples of T (the plan's 128-blocks).
extern "C" int gb_window_count(const void* P, const void* Q, const void* M,
                               void* partials, int nI, int W, int nJ,
                               void* stream) {
  if (nI > 0 && W > 0 && nJ > 0) {
    window_count_kernel<<<dim3(nI, nJ / TN), NT, 0, (cudaStream_t)stream>>>(
        (const int8_t*)P, (const int8_t*)Q, (const int8_t*)M, (int*)partials,
        W, nJ);
  }
  return (int)cudaGetLastError();
}

// Same panels as gb_window_count; out (nI, T, nJ) int32, every element
// written.
extern "C" int gb_window_mm(const void* P, const void* Q, const void* M,
                            void* out, int nI, int W, int nJ, void* stream) {
  if (nI > 0 && W > 0 && nJ > 0) {
    window_mm_kernel<<<dim3(nI, nJ / TN), NT, 0, (cudaStream_t)stream>>>(
        (const int8_t*)P, (const int8_t*)Q, (const int8_t*)M, (int*)out, W,
        nJ);
  }
  return (int)cudaGetLastError();
}
