// Gather + AND + popcount over bitpacked panels: per mask entry e = (i, j),
//   out[e] = sum_w popc(Apack[amap[i], w] & Bpack[bmap[j], w])
// with 0 for entries at or past nvals and for rows whose map is -1.
//
// Replaces graphblas_tpu/sparse/bitdot.py::_bitdot_jit (a plain-XLA
// gather+AND+popcount pass on the TPU, streamed in lax.map chunks so the
// gathered panels stayed bounded).  Torch has no popcount op.
//
// What bounds it on the card: two random row reads of 4*W bytes per mask
// entry (plus the map and index reads); the arithmetic is negligible.
//
// What this simple design does about it: one warp per mask entry, its
// lanes striding over the W words, so each row read is one coalesced
// 128-byte sweep and no gathered row is ever written to device memory
// (the TPU's chunking is unnecessary); a shuffle reduction leaves the
// count in lane 0.  Packing several short rows per warp and vector loads
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;             // threads per block
constexpr int WARPS = NT / 32;      // mask entries per block

__global__ void __launch_bounds__(NT)
bitdot_popcount_kernel(const uint32_t* __restrict__ Apack,
                       const uint32_t* __restrict__ Bpack,
                       const int* __restrict__ amap,
                       const int* __restrict__ bmap,
                       const int* __restrict__ rowids,
                       const int* __restrict__ indices, int* out,
                       int64_t nzmax, int64_t nvals, int na, int nb, int W,
                       int amap_len, int bmap_len) {
  const int64_t e = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (e >= nzmax) return;  // whole warp: e is uniform across its lanes
  int ii = -1, jj = -1;
  if (e < nvals) {
    ii = rowids[e];
    jj = indices[e];
    if (amap) ii = amap[min(max(ii, 0), amap_len - 1)];
    if (bmap) jj = bmap[min(max(jj, 0), bmap_len - 1)];
  }
  int acc = 0;
  if (ii >= 0 && jj >= 0) {
    const uint32_t* a = Apack + (int64_t)min(ii, na - 1) * W;
    const uint32_t* b = Bpack + (int64_t)min(jj, nb - 1) * W;
    for (int w = lane; w < W; w += 32) acc += __popc(a[w] & b[w]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) out[e] = acc;
}

}  // namespace

// Apack (na, W), Bpack (nb, W): int32 tensors holding the uint32 words.
// amap (amap_len,) / bmap (bmap_len,): row -> panel row or -1, or NULL.
// rowids, indices, out: (nzmax,) int32.
extern "C" int gb_bitdot_popcount(const void* Apack, const void* Bpack,
                                  const void* amap, const void* bmap,
                                  const void* rowids, const void* indices,
                                  void* out, int64_t nzmax, int64_t nvals,
                                  int na, int nb, int W, int amap_len,
                                  int bmap_len, void* stream) {
  if (nzmax > 0) {
    const int64_t blocks = (nzmax + WARPS - 1) / WARPS;
    bitdot_popcount_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)Apack, (const uint32_t*)Bpack, (const int*)amap,
        (const int*)bmap, (const int*)rowids, (const int*)indices, (int*)out,
        nzmax, nvals, na, nb, W, amap_len, bmap_len);
  }
  return (int)cudaGetLastError();
}
