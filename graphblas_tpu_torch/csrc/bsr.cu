// BSR tile-triple masked product (K7): for every output tile o of a
// schedule,
//   C[o] = (sum over s in [starts[o], starts[o+1]) of A[ta[s]] . B[tb[s]]^T)
//          * (M[mslot[o]] != 0)
// with 128x128 tiles stacked in A (ntA, T, T), B (ntB, T, T) and M (ntM, T,
// T).  Two forms: counting, int8 0/1 tiles into int32 (exact), and values,
// float32 tiles into float32 (true float32 fused multiply-adds, never TF32).
//
// Replaces graphblas_tpu/sparse/pallas_bsr.py::_launch (the Pallas kernel
// _kernel, pallas_call at pallas_bsr.py:95).  The TPU walked a sequential
// (output tile, K-slot) grid padded to the longest output's slot count, with
// the schedule scalar-prefetched so the pipeline could DMA the next A and B
// tiles, and carried the accumulator in its revisited VMEM output block.
// Here each CUDA block reads its own schedule entries and loops over its
// own K-slots only (no padded steps), keeps the accumulator in registers
// across the loop, masks it once and stores it once: no atomics, nothing
// carried between blocks.  The mask is read through its slot, so the
// caller passes M's own tiles rather than a gathered copy.
//
// What bounds it on the card: bytes, on the graphs it runs on (a few tile
// triples per output).  Each output tile is written as 64 KB of int32 or
// float32 against 16 KB (int8) or 64 KB (float32) per input tile read;
// the int8 multiply-accumulates (2 * 128^3 operations per triple) sit far
// below the tensor cores' 1,979 TOP/s.
//
// What the design does about it.  The counting form: one block of 256
// threads owns a whole 128x128 output tile and runs the int8 tensor-core
// tile (mma_s8_tile.cuh, mma.sync m16n8k32) in its A.B^T form: both tiles
// are k contiguous, the native layout of the mma's row.col operands, so
// no byte transpose is needed.  One three-stage cp.async ring of 64-k
// stages runs across the output's triples (two stages per triple), so it
// does not drain between them; the epilogue pairs lanes with one shuffle
// and masks four outputs per 4-byte mask read and 16-byte store.  Sums are
// exact: each product is at most 2^14 in magnitude and K = 128 * triples.
// The values form: a register-blocked float32 tile, one block per 64-
// column half of the output tile, 8x4 outputs per thread, k staged 16 at
// a time through shared memory; TF32 is never used.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8_tile.cuh"  // mma_s8::tile_accumulate_nt

namespace {

constexpr int T = 128;         // tile rows and columns
constexpr int TN = 64;         // output columns per block (values form)
constexpr int NT = 256;        // threads per block
constexpr int BK = 16;         // float32 k per shared-memory stage

// Grid nout: output tile o, the sum over its triples of A[ta[s]] .
// B[tb[s]]^T, kept where the mask tile's byte is nonzero.
__global__ void __launch_bounds__(mma_s8::NT, 2)
bsr_count_kernel(const int* __restrict__ starts, const int* __restrict__ ta,
                 const int* __restrict__ tb, const int* __restrict__ mslot,
                 const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                 const int8_t* __restrict__ M, int* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t mm_smem[];
  const long o = blockIdx.x;
  const int s0 = starts[o];
  int acc[2][8][4];
  const auto pair = [&](int i, const int8_t*& a, const int8_t*& b) {
    a = A + (long)ta[s0 + i] * T * T;
    b = B + (long)tb[s0 + i] * T * T;
  };
  mma_s8::tile_accumulate_nt(pair, starts[o + 1] - s0, T, T, mm_smem, acc);
  // lane pairs (tq, tq^1) swap halves: the even lane then holds row g's
  // four columns 8*ni + 2*tq .. +3, the odd lane row g+8's four columns
  // 8*ni + 2*(tq-1) .. +3 (as in window.cu's K3 epilogue)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const bool odd = tq & 1;
  const int8_t* Mo = M + (long)mslot[o] * T * T;
  int* Co = out + o * T * T;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int* c = acc[mi][ni];
      const int x0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
      const int x1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
      int4 v = odd ? make_int4(x0, x1, c[2], c[3])
                   : make_int4(c[0], c[1], x0, x1);
      const int e = (32 * (warp & 3) + 16 * mi + g + (odd ? 8 : 0)) * T
                    + 64 * (warp >> 2) + 8 * ni + 4 * (tq >> 1);
      const uint32_t m = *reinterpret_cast<const uint32_t*>(Mo + e);
      if (!(m & 0xffu)) v.x = 0;
      if (!(m & 0xff00u)) v.y = 0;
      if (!(m & 0xff0000u)) v.z = 0;
      if (!(m & 0xff000000u)) v.w = 0;
      *reinterpret_cast<int4*>(Co + e) = v;
    }
}

// Same grid and schedule; float32 tiles.  The mask multiplies (as the TPU
// kernel's out * (m != 0) does), so a NaN accumulator stays NaN under a 0.
__global__ void __launch_bounds__(NT)
bsr_f32_kernel(const int* __restrict__ starts, const int* __restrict__ ta,
               const int* __restrict__ tb, const int* __restrict__ mslot,
               const float* __restrict__ A, const float* __restrict__ B,
               const int8_t* __restrict__ M, float* __restrict__ out) {
  // As[kk][r] = a[r][k0 + kk]; Bs[kk][c] = b[h*64 + c][k0 + kk]
  __shared__ __align__(16) float As[BK][T + 4];
  __shared__ __align__(16) float Bs[BK][TN + 4];
  const long o = blockIdx.x;
  const int h = blockIdx.y;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int s1 = starts[o + 1];
  for (int s = starts[o]; s < s1; ++s) {
    const float* a = A + (long)ta[s] * T * T;
    const float* b = B + (long)tb[s] * T * T + (long)h * TN * T;
    for (int k0 = 0; k0 < T; k0 += BK) {
      // a: 128 rows x 16 k as 512 float4, two per thread; b: 64 rows x 16 k
      // as 256 float4, one per thread
#pragma unroll
      for (int p = 0; p < (T * BK / 4) / NT; ++p) {
        const int idx = t + NT * p;
        const int r = idx / (BK / 4), q = idx % (BK / 4);
        const float4 v =
            *reinterpret_cast<const float4*>(a + r * T + k0 + 4 * q);
        As[4 * q][r] = v.x;
        As[4 * q + 1][r] = v.y;
        As[4 * q + 2][r] = v.z;
        As[4 * q + 3][r] = v.w;
      }
      {
        const int c = t / (BK / 4), q = t % (BK / 4);
        const float4 v =
            *reinterpret_cast<const float4*>(b + c * T + k0 + 4 * q);
        Bs[4 * q][c] = v.x;
        Bs[4 * q + 1][c] = v.y;
        Bs[4 * q + 2][c] = v.z;
        Bs[4 * q + 3][c] = v.w;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  const int8_t* Mo = M + (long)mslot[o] * T * T + h * TN;
  float* Co = out + o * T * T + h * TN;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = (ty + 16 * i) * T + tx + 16 * j;
      Co[e] = acc[i][j] * (Mo[e] != 0 ? 1.f : 0.f);
    }
}

}  // namespace

// starts (nout+1,), ta, tb (starts[nout],), mslot (nout,): int32 schedule.
// A, B: stacked int8 (is_float 0) or float32 (is_float 1) tiles; M: stacked
// int8 mask tiles; out (nout, T, T) int32 or float32, every element written.
// Every base pointer 16-byte aligned.  More than 2^31 - 1 output tiles
// returns cudaErrorInvalidValue unlaunched.
extern "C" int gb_bsr_masked_mm(const void* starts, const void* ta,
                                const void* tb, const void* mslot,
                                const void* A, const void* B, const void* M,
                                void* out, int nout, int is_float,
                                void* stream) {
  if (nout < 0) return (int)cudaErrorInvalidValue;
  if (nout > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (is_float) {
      bsr_f32_kernel<<<dim3(nout, T / TN), NT, 0, s>>>(
          (const int*)starts, (const int*)ta, (const int*)tb,
          (const int*)mslot, (const float*)A, (const float*)B,
          (const int8_t*)M, (float*)out);
    } else {
      const cudaError_t rc = cudaFuncSetAttribute(
          bsr_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          mma_s8::SMEM_NT_BYTES);
      if (rc != cudaSuccess) return (int)rc;
      bsr_count_kernel<<<nout, mma_s8::NT, mma_s8::SMEM_NT_BYTES, s>>>(
          (const int*)starts, (const int*)ta, (const int*)tb,
          (const int*)mslot, (const int8_t*)A, (const int8_t*)B,
          (const int8_t*)M, (int*)out);
    }
  }
  return (int)cudaGetLastError();
}
