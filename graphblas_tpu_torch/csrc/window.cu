// Masked int8 panel products on banded graphs: per 128-row block i, the
// masked count sum_{r,c} (A.B)[r,c] * M[r,c] as an int32 partial (SandiaDot
// triangle counting), or the masked product panel (A.B) * M itself.
//
// Replaces the TPU kernels of graphblas_tpu/sparse/pallas_window.py:
//   gb_tri_band_ring  <- _tri_ring_launch / _make_tri_ring_kernel (band-ring)
//   gb_window_count   <- _count_launch / _count_kernel (window-panel count)
//   gb_window_mm      <- _mm_launch / _mm_kernel (window-panel product, K3)
//
// Every kernel here runs on the int8 tensor-core tile of mma_s8_tile.cuh
// (mma.sync m16n8k32, a three-stage cp.async ring, B's k-major tiles
// transposed in registers with prmt between shared memory and the mma),
// one CUDA block of 256 threads per 128x128 output tile.
//
// K1 and K2: what bounds them on the card is the nonempty 128x128 tiles.
// The TPU multiplied the whole padded band (K1: (Wb*(Wb+1)/2) tile
// products per block-row) or window, empty tiles included; on a banded
// graph most of those tiles are empty (Wathen 384: 228,448 padded tile
// products against 52,820 whose three tiles are all nonempty).  So each
// kernel runs over a schedule (sparse/window.py, built once per plan on
// the card from the panels and cached on the plan): the output tiles
// whose mask tile is nonempty, heaviest first, each with the k-blocks
// whose A and B tiles are both nonempty.  One block per scheduled output
// tile starts copying its mask tile into shared memory (copy_mask, in the
// first stage's commit group, so its latency hides behind the products),
// runs the A.B list form over its k-blocks through one cp.async ring,
// multiplies the C fragment by the mask bytes (masked_sum), reduces it in
// the block and adds it to partials[i] with one atomicAdd.  The bytes are
// then each nonempty tile read about once from device memory (re-reads
// hit L2), and the operations 2 * 128^3 per scheduled tile triple.
// Integer sums are exact in any order.
//
// K3: one block per (block-row, 128-column tile); the column tile runs
// fastest, so the blocks of one block-row read P[i] from L2 and Q is read
// once.  It writes a 4-byte product per entry against the operands' 1, so
// it is bound by bytes: at the Wathen 128 plan 350 MB, 127 MB of it the
// int32 output.  The epilogue pairs neighbouring lanes' accumulators with
// one shuffle so that each lane multiplies four consecutive outputs by a
// 4-byte mask word and writes them with one 16-byte store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8_tile.cuh"  // the int8 tensor-core tile and masked_sum

namespace {

constexpr int T = 128;  // panel block width (rows and columns of a tile)

// The body of both count kernels for schedule entry o = blockIdx.x of
// block-row i: stages the output's k-blocks kblk[kptr[o] .. kptr[o+1]) (at
// most NT) in shared memory, starts the mask tile's copy, sums A_kb . B_kb
// over them (``pair(kb, a, b)`` sets k-block kb's tiles; lda, ldb their
// leading dimensions), and adds the masked block sum to partials[i].  The
// mask lands with the first stage, before the tile's first barrier: every
// scheduled output has a k-block.
template <class Pair>
__device__ __forceinline__ void masked_count(
    const int* __restrict__ kptr, const int* __restrict__ kblk, long i,
    const Pair& pair, long lda, long ldb, const int8_t* __restrict__ Msk,
    long ldm, int* partials) {
  extern __shared__ __align__(16) uint32_t mm_smem[];
  __shared__ int kb[mma_s8::NT];
  const int o = blockIdx.x;
  const int k0 = kptr[o], npairs = kptr[o + 1] - k0;
  if (threadIdx.x < npairs) kb[threadIdx.x] = kblk[k0 + threadIdx.x];
  __syncthreads();
  uint32_t* const Ms = mm_smem + mma_s8::SMEM_BYTES / 4;
  mma_s8::copy_mask(Msk, ldm, Ms);
  int acc[2][8][4];
  mma_s8::tile_accumulate_nn(
      [&](int q, const int8_t*& a, const int8_t*& b) { pair(kb[q], a, b); },
      npairs, lda, ldb, T, mm_smem, acc);
  const int sum = mma_s8::masked_sum(acc, Ms);
  if (threadIdx.x == 0 && sum != 0) atomicAdd(partials + i, sum);
}

// Grid nout: schedule entry o is block-row i = rows[o] and band offset s =
// cols[o] (J = i - s, jj = Wb-1-s).  P (nI, T, Wb*T): L block-row i over
// column blocks [i-Wb+1, i].  Ut (nI, Wb*T, T): U block-row J transposed,
// over column blocks [J, J+Wb).  K-block kb is P[i]'s column block jj+kb
// against Ut[J]'s row block kb; the mask is P[i]'s column block jj.
__global__ void __launch_bounds__(mma_s8::NT, 2)
tri_band_ring_kernel(const int8_t* __restrict__ P,
                     const int8_t* __restrict__ Ut,
                     const int* __restrict__ rows,
                     const int* __restrict__ cols,
                     const int* __restrict__ kptr,
                     const int* __restrict__ kblk, int* partials, int Wb) {
  const long i = rows[blockIdx.x];
  const int s = cols[blockIdx.x];
  const long W = (long)Wb * T;
  const int8_t* Pi = P + i * T * W + (long)(Wb - 1 - s) * T;  // block jj
  const int8_t* UtJ = Ut + (i - s) * W * T;
  masked_count(
      kptr, kblk, i,
      [&](int kb, const int8_t*& a, const int8_t*& b) {
        a = Pi + (long)kb * T;
        b = UtJ + (long)kb * T * T;
      },
      W, T, Pi, W, partials);
}

// Grid nout: schedule entry o is block-row i = rows[o] and output column
// tile c = cols[o].  P (nI, T, W), Q (nI, W, nJ), M (nI, T, nJ).  K-block
// kb is P[i]'s column block kb against Q[i]'s tile (kb, c); the mask is
// M[i]'s tile c.
__global__ void __launch_bounds__(mma_s8::NT, 2)
window_count_kernel(const int8_t* __restrict__ P,
                    const int8_t* __restrict__ Q,
                    const int8_t* __restrict__ M,
                    const int* __restrict__ rows,
                    const int* __restrict__ cols,
                    const int* __restrict__ kptr,
                    const int* __restrict__ kblk, int* partials, int W,
                    int nJ) {
  const long i = rows[blockIdx.x], c0 = (long)cols[blockIdx.x] * T;
  const int8_t* Pi = P + i * T * W;
  const int8_t* Qi = Q + i * W * nJ + c0;
  masked_count(
      kptr, kblk, i,
      [&](int kb, const int8_t*& a, const int8_t*& b) {
        a = Pi + (long)kb * T;
        b = Qi + (long)kb * T * nJ;
      },
      W, nJ, M + i * T * nJ + c0, nJ, partials);
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

// dynamic shared memory of the count kernels: the tile, then the mask
constexpr int COUNT_SMEM = mma_s8::SMEM_BYTES + mma_s8::MASK_BYTES;

// Lets ``kernel`` take ``bytes`` of dynamic shared memory; 0 or the CUDA
// error.
template <class Kernel>
int allow_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// partials (nI,) int32 must be zeroed by the caller.  rows, cols, kptr
// (nout + 1), kblk: the int32 schedule (sparse/window.py), every output
// with 1 to 256 k-blocks.  The wrapper checks shapes, dtype (int8),
// contiguity and 16-byte aligned panels.
extern "C" int gb_tri_band_ring(const void* P, const void* Ut,
                                const void* rows, const void* cols,
                                const void* kptr, const void* kblk,
                                void* partials, int nout, int Wb,
                                void* stream) {
  if (nout > 0) {
    const int rc = allow_smem(tri_band_ring_kernel, COUNT_SMEM);
    if (rc) return rc;
    tri_band_ring_kernel<<<nout, mma_s8::NT, COUNT_SMEM,
                           (cudaStream_t)stream>>>(
        (const int8_t*)P, (const int8_t*)Ut, (const int*)rows,
        (const int*)cols, (const int*)kptr, (const int*)kblk,
        (int*)partials, Wb);
  }
  return (int)cudaGetLastError();
}

// W and nJ are multiples of T (the plan's 128-blocks); the schedule as for
// gb_tri_band_ring.
extern "C" int gb_window_count(const void* P, const void* Q, const void* M,
                               const void* rows, const void* cols,
                               const void* kptr, const void* kblk,
                               void* partials, int nout, int W, int nJ,
                               void* stream) {
  if (nout > 0) {
    const int rc = allow_smem(window_count_kernel, COUNT_SMEM);
    if (rc) return rc;
    window_count_kernel<<<nout, mma_s8::NT, COUNT_SMEM,
                          (cudaStream_t)stream>>>(
        (const int8_t*)P, (const int8_t*)Q, (const int8_t*)M,
        (const int*)rows, (const int*)cols, (const int*)kptr,
        (const int*)kblk, (int*)partials, W, nJ);
  }
  return (int)cudaGetLastError();
}

// Same panels as gb_window_count; out (nI, T, nJ) int32, every element
// written.  The panels' base pointers must be 16-byte aligned (the
// wrapper's fresh contiguous tensors are).
extern "C" int gb_window_mm(const void* P, const void* Q, const void* M,
                            void* out, int nI, int W, int nJ, void* stream) {
  if (nI > 0 && W > 0 && nJ > 0) {
    const int rc = allow_smem(window_mm_kernel, mma_s8::SMEM_BYTES);
    if (rc) return rc;
    window_mm_kernel<<<(unsigned)((long)nI * (nJ / mma_s8::BN)),
                       mma_s8::NT, mma_s8::SMEM_BYTES,
                       (cudaStream_t)stream>>>(
        (const int8_t*)P, (const int8_t*)Q, (const int8_t*)M, (int*)out, W,
        nJ);
  }
  return (int)cudaGetLastError();
}
