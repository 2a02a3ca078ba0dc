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
// once per (block, offset) pair and stay mostly in L2.  K3 writes a 4-byte
// product per entry against the operands' 1, so it is bound by bytes: at
// the Wathen 128 plan 350 MB, 127 MB of it the int32 output.
//
// K1 and K2: one CUDA block per (block-row, band offset, 64-column half)
// for the band ring and per (block-row, 64-column tile) for the window
// count, so blocks run in parallel where the TPU walked its grid in order;
// the TPU's VMEM ring that streamed U once becomes direct reads of Ut[J]
// (L2-resident).  Each block accumulates a 128x64 int32 tile with the
// shared __dp4a tile (dp4a_tile.cuh), multiplies it by the mask tile,
// reduces it in the block and atomically adds it to partials[i].  Integer
// sums are exact in any order.
//
// K3: one block per (block-row, 128-column tile) on the int8 tensor-core
// tile (mma_s8_tile.cuh: mma.sync m16n8k32, a three-stage cp.async ring,
// Q's k-major tiles transposed in registers with prmt between shared
// memory and the mma); the column tile runs fastest, so the blocks of one block-row
// read P[i] from L2 and Q is read once.  The epilogue pairs neighbouring
// lanes' accumulators with one shuffle so that each lane multiplies four
// consecutive outputs by a 4-byte mask word and writes them with one
// 16-byte store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dp4a_tile.cuh"    // T, TN, NT and the __dp4a tile_product
#include "mma_s8_tile.cuh"  // mma_s8::tile_product (K3)

namespace {

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

// Grid nI * (nJ / 128): block b is block-row b / (nJ / 128), column tile
// b % (nJ / 128).  Same operands as window_count_kernel; out (nI, T, nJ)
// int32 gets (P[i].Q[i]) * M[i].
__global__ void __launch_bounds__(mma_s8::NT, 2)
window_mm_kernel(const int8_t* __restrict__ P, const int8_t* __restrict__ Q,
                 const int8_t* __restrict__ M, int* __restrict__ out, int W,
                 int nJ) {
  const int nct = nJ / mma_s8::BN;
  const long i = blockIdx.x / nct;
  const long c0 = (long)(blockIdx.x % nct) * mma_s8::BN;
  extern __shared__ __align__(16) uint32_t mm_smem[];
  int acc[2][8][4];
  mma_s8::tile_product(P + i * T * W, W, Q + i * W * nJ + c0, nJ, W,
                       mm_smem, acc);
  // lane pairs (tq, tq^1) swap halves: the even lane then holds row g's
  // four columns 8*ni + 2*tq .. +3, the odd lane row g+8's four columns
  // 8*ni + 2*(tq-1) .. +3
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const bool odd = tq & 1;
  const int8_t* Mi = M + i * T * nJ + c0;
  int* Oi = out + i * T * nJ + c0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int* c = acc[mi][ni];
      const int x0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
      const int x1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
      int4 v = odd ? make_int4(x0, x1, c[2], c[3])
                   : make_int4(c[0], c[1], x0, x1);
      const long e = (long)(32 * (warp & 3) + 16 * mi + g + (odd ? 8 : 0))
                         * nJ + 64 * (warp >> 2) + 8 * ni + 4 * (tq >> 1);
      const uint32_t m = *reinterpret_cast<const uint32_t*>(Mi + e);
      v.x *= (int)(signed char)(m & 0xff);
      v.y *= (int)(signed char)((m >> 8) & 0xff);
      v.z *= (int)(signed char)((m >> 16) & 0xff);
      v.w *= (int)(signed char)(m >> 24);
      *reinterpret_cast<int4*>(Oi + e) = v;
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
// written.  The panels' base pointers must be 16-byte aligned (the
// wrapper's fresh contiguous tensors are).
extern "C" int gb_window_mm(const void* P, const void* Q, const void* M,
                            void* out, int nI, int W, int nJ, void* stream) {
  if (nI > 0 && W > 0 && nJ > 0) {
    const cudaError_t rc = cudaFuncSetAttribute(
        window_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        mma_s8::SMEM_BYTES);
    if (rc != cudaSuccess) return (int)rc;
    window_mm_kernel<<<(unsigned)((long)nI * (nJ / mma_s8::BN)),
                       mma_s8::NT, mma_s8::SMEM_BYTES,
                       (cudaStream_t)stream>>>(
        (const int8_t*)P, (const int8_t*)Q, (const int8_t*)M, (int*)out, W,
        nJ);
  }
  return (int)cudaGetLastError();
}
