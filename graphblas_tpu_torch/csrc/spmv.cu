// BSR SpMV over dense 128x128 float32 tiles: for each row-block rb,
//   y[rb*128 + r] = sum over the row-block's triples t with valid[t] != 0
//                   of sum_c tiles[slot[t]][r][c] * x[cb[t]*128 + c]
// where the triples of row-block rb are rbptr[rb] .. rbptr[rb+1]-1 (the
// plan sorts them by row-block and gives every empty row-block one
// invalid dummy triple).  x is padded to ncb*128 floats, y has nrb*128.
//
// Replaces graphblas_tpu/sparse/pallas_spmv.py::_launch (the Pallas
// kernel _kernel, pallas_call at pallas_spmv.py:103).  The TPU kernel
// walked the triples on a sequential grid and zeroed the y block at a
// row-block's first tile, then accumulated into it across consecutive
// grid steps; CUDA blocks run in no order, so here each row-block has one
// owner, a block that loops over its own triples and writes its 128 y
// values once, with no atomics: the result is deterministic, and empty
// row-blocks and invalid triples leave zeros.  The TPU's (nb, 1, 128)
// x/y layout was a Mosaic alignment shim; here x and y are flat.
//
// What bounds it on the card: bytes.  Every occupied tile is read whole
// (64 KB, mostly zeros for a FEM matrix), so the compulsory traffic is
// ntiles * 64 KB plus the triple arrays, x and y, over 3.35 TB/s; the
// 2 * ntiles * 128 * 128 operations are far below the 67 TFLOP/s of
// float32 on the CUDA cores.
//
// What this simple design does about it: one block of 8 warps per
// row-block, each warp owning 16 rows.  A lane keeps the 4 x values of
// its columns (one 16-byte load; the block's warps share the x block
// through L1) and, for each tile, makes 16 independent 16-byte loads,
// one per row, so a warp sweeps each 512-byte tile row in one coalesced
// load and a block has the whole 64 KB tile in flight.  Partial sums
// stay in registers across the row-block's tiles (true float32 FMA on
// the CUDA cores, never TF32), and each row is reduced once at the end
// by warp shuffles.  Skipping the zero tiles' interiors, TMA staging and
// wgmma are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 128;            // tile edge
constexpr int V = T / 4;          // float4 per tile row
constexpr int NT = 256;           // threads per block
constexpr int WARPS = NT / 32;
constexpr int ROWS = T / WARPS;   // rows per warp

__global__ void __launch_bounds__(NT)
bsr_spmv_kernel(const int* __restrict__ rbptr, const int* __restrict__ cb,
                const int* __restrict__ slot, const int* __restrict__ valid,
                const float4* __restrict__ tiles,
                const float4* __restrict__ x, float* __restrict__ y) {
  const int rb = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * ROWS;
  float acc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = 0.f;
  const int t1 = rbptr[rb + 1];
  for (int t = rbptr[rb]; t < t1; ++t) {
    if (valid[t] == 0) continue;  // uniform across the block
    const float4 xv = x[(int64_t)cb[t] * V + lane];
    const float4* a = tiles + ((int64_t)slot[t] * T + r0) * V + lane;
    float4 av[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) av[i] = a[i * V];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float s = acc[i];
      s = fmaf(av[i].x, xv.x, s);
      s = fmaf(av[i].y, xv.y, s);
      s = fmaf(av[i].z, xv.z, s);
      s = fmaf(av[i].w, xv.w, s);
      acc[i] = s;
    }
  }
  // reduce each row over the warp's 32 lanes; lane i < ROWS keeps row i
  float mine = 0.f;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == i) mine = v;
  }
  if (lane < ROWS) y[(int64_t)rb * T + r0 + lane] = mine;
}

}  // namespace

// rbptr (nrb+1,), cb, slot, valid (ntriples,): int32 plan arrays;
// tiles (ntiles, 128, 128) float32; x (ncb*128,) float32; y (nrb*128,)
// float32, every element written.
extern "C" int gb_bsr_spmv(const void* rbptr, const void* cb,
                           const void* slot, const void* valid,
                           const void* tiles, const void* x, void* y,
                           int nrb, void* stream) {
  if (nrb > 0) {
    bsr_spmv_kernel<<<nrb, NT, 0, (cudaStream_t)stream>>>(
        (const int*)rbptr, (const int*)cb, (const int*)slot,
        (const int*)valid, (const float4*)tiles, (const float4*)x,
        (float*)y);
  }
  return (int)cudaGetLastError();
}
