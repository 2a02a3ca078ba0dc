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
// Here one CUDA block owns one 64-column half of an output tile, reads its
// own schedule entries and loops over its own K-slots only (no padded
// steps), keeps the accumulator in registers across the loop, multiplies it
// by the mask once and stores it once: no atomics, nothing carried between
// blocks.  The mask is read through its slot, so the caller passes M's own
// tiles rather than a gathered copy.
//
// What bounds it on the card: bytes, on the graphs it runs on (a few tile
// triples per output).  Each output tile is written as 64 KB of int32 or
// float32 against 16 KB (int8) or 64 KB (float32) per input tile read;
// the int8 multiply-accumulates (2 * 128^3 operations per triple) sit far
// below the tensor cores' 1,979 TOP/s.
//
// What this simple design does about it: the counting form runs the __dp4a
// tile product that K1-K3 share (dp4a_tile.cuh), with B's tile staged as
// A's is (k contiguous: the A.B^T form); the values form is a register-
// blocked float32 tile, 8x4 outputs per thread, k staged 16 at a time
// through shared memory.  Tensor cores, TMA and pipelining are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dp4a_tile.cuh"  // T, TN, NT and tile_accumulate

namespace {

constexpr int BK = 16;         // float32 k per shared-memory stage

// Grid (nout, 2): output tile o, column half h (output columns h*64 + c are
// rows h*64 + c of each B tile).
__global__ void __launch_bounds__(NT)
bsr_count_kernel(const int* __restrict__ starts, const int* __restrict__ ta,
                 const int* __restrict__ tb, const int* __restrict__ mslot,
                 const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                 const int8_t* __restrict__ M, int* __restrict__ out) {
  const long o = blockIdx.x;
  const int h = blockIdx.y;
  int acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  const int s1 = starts[o + 1];
  for (int s = starts[o]; s < s1; ++s) {
    tile_accumulate<false>(A + (long)ta[s] * T * T, T,
                           B + (long)tb[s] * T * T + (long)h * TN * T, T, T,
                           acc);
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int8_t* Mo = M + (long)mslot[o] * T * T + h * TN;
  int* Co = out + o * T * T + h * TN;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = (ty + 16 * i) * T + tx + 16 * j;
      Co[e] = Mo[e] != 0 ? acc[i][j] : 0;
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
// More than 2^31 - 1 output tiles returns cudaErrorInvalidValue unlaunched.
extern "C" int gb_bsr_masked_mm(const void* starts, const void* ta,
                                const void* tb, const void* mslot,
                                const void* A, const void* B, const void* M,
                                void* out, int nout, int is_float,
                                void* stream) {
  if (nout < 0) return (int)cudaErrorInvalidValue;
  if (nout > 0) {
    const dim3 grid(nout, T / TN);
    cudaStream_t s = (cudaStream_t)stream;
    if (is_float) {
      bsr_f32_kernel<<<grid, NT, 0, s>>>(
          (const int*)starts, (const int*)ta, (const int*)tb,
          (const int*)mslot, (const float*)A, (const float*)B,
          (const int8_t*)M, (float*)out);
    } else {
      bsr_count_kernel<<<grid, NT, 0, s>>>(
          (const int*)starts, (const int*)ta, (const int*)tb,
          (const int*)mslot, (const int8_t*)A, (const int8_t*)B,
          (const int8_t*)M, (int*)out);
    }
  }
  return (int)cudaGetLastError();
}
