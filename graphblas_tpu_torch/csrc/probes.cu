// The two gather probes: what the card does with the access patterns the
// TPU probes asked about.
//
// gb_row_gather (P1) replaces tools/gather_probe.py's Pallas kernels
// (probe_lane_shuffle, pallas_call at gather_probe.py:68, and the forms of
// probe_unsupported_forms, gather_probe.py:108): out[r, l] = x[r, idx[r,
// l]], a gather inside each row's window of Wx values.  Mosaic offered only
// a 128-lane shuffle and an 8-row tile gather; here one warp stages its row
// window in shared memory (coalesced) and each lane reads its entries from
// there, so any window up to MAX_WINDOW values and any number of indices
// per row take the same path.  Bound: bytes (x, idx and out once each).
//
// gb_gatherdot_async (P2) replaces tools/gatherdot_probe.py::pallas_gatherdot
// (pallas_call at gatherdot_probe.py:122): acc[e] = sum_s A[ai[e], s] *
// B[bj[e], s].  The TPU probe asked whether a double-buffered DMA
// row-gather beats the compiler's own gather; its counterpart here stages
// both gathered rows of the next entry into a two-slot shared-memory ring
// with cp.async (16 bytes per copy, L1 bypassed) while the block reduces the
// current entry.  The gather-dot kernel K4 (valdot.cu) computes the same
// function with synchronous loads, one warp per entry.  Bound: bytes (each
// distinct row once, the indices and the output).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GATHER_WARPS = 8;      // rows per block of the row gather
constexpr int MAX_WINDOW = 1536;     // 8 windows of floats in 48 KB
constexpr int GD_THREADS = 128;      // threads per block of the gather-dot

__global__ void __launch_bounds__(GATHER_WARPS * 32)
row_gather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                  float* __restrict__ out, int R, int Wx, int L) {
  extern __shared__ float win[];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long r = (long)blockIdx.x * GATHER_WARPS + w;
  if (r >= R) return;  // the whole warp; only __syncwarp follows
  float* row = win + w * Wx;
  for (int c = lane; c < Wx; c += 32) row[c] = x[r * Wx + c];
  __syncwarp();
  for (int l = lane; l < L; l += 32) {
    int i = idx[r * L + l];
    i = i < 0 ? 0 : (i >= Wx ? Wx - 1 : i);
    out[r * L + l] = row[i];
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ int clip_row(int r, int n) {
  return r < 0 ? 0 : (r >= n ? n - 1 : r);
}

// Entries e = blockIdx.x, + gridDim.x, ...: slot buf holds entry e's two
// rows while the other slot receives the next entry's.
__global__ void __launch_bounds__(GD_THREADS)
gatherdot_async_kernel(const float* __restrict__ A,
                       const float* __restrict__ B,
                       const int* __restrict__ ai, const int* __restrict__ bj,
                       float* __restrict__ out, int E, int na, int nb,
                       int S) {
  extern __shared__ float4 ring[];   // [2 slots][A row, B row] of S/4 float4
  __shared__ float red[GD_THREADS / 32];
  const int S4 = S / 4;
  const int t = threadIdx.x;

  auto issue = [&](int e, float4* dst) {
    const float4* a =
        reinterpret_cast<const float4*>(A + (long)clip_row(ai[e], na) * S);
    const float4* b =
        reinterpret_cast<const float4*>(B + (long)clip_row(bj[e], nb) * S);
    for (int c = t; c < S4; c += GD_THREADS) {
      cp_async16(dst + c, a + c);
      cp_async16(dst + S4 + c, b + c);
    }
  };

  int e = blockIdx.x;
  if (e < E) issue(e, ring);
  cp_async_commit();
  int buf = 0;
  for (; e < E; e += gridDim.x) {
    const int nxt = e + gridDim.x;
    if (nxt < E) issue(nxt, ring + (buf ^ 1) * 2 * S4);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_one();
    __syncthreads();    // every thread's copies of entry e have landed
    const float4* x = ring + buf * 2 * S4;
    const float4* y = x + S4;
    float acc = 0.f;
    for (int c = t; c < S4; c += GD_THREADS) {
      const float4 u = x[c], v = y[c];
      acc = fmaf(u.x, v.x, acc);
      acc = fmaf(u.y, v.y, acc);
      acc = fmaf(u.z, v.z, acc);
      acc = fmaf(u.w, v.w, acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (t % 32 == 0) red[t / 32] = acc;
    __syncthreads();    // red is complete and slot buf is free again
    if (t == 0) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < GD_THREADS / 32; ++w) s += red[w];
      out[e] = s;
    }
    buf ^= 1;
  }
}

}  // namespace

// x (R, Wx), idx (R, L) int32, out (R, L): contiguous; indices are clamped
// into [0, Wx).  Wx above MAX_WINDOW returns cudaErrorInvalidValue.
extern "C" int gb_row_gather(const void* x, const void* idx, void* out,
                             int R, int Wx, int L, void* stream) {
  if (Wx <= 0 || Wx > MAX_WINDOW) return (int)cudaErrorInvalidValue;
  if (R > 0 && L > 0) {
    const int blocks = (R + GATHER_WARPS - 1) / GATHER_WARPS;
    row_gather_kernel<<<blocks, GATHER_WARPS * 32,
                        GATHER_WARPS * Wx * sizeof(float),
                        (cudaStream_t)stream>>>(
        (const float*)x, (const int*)idx, (float*)out, R, Wx, L);
  }
  return (int)cudaGetLastError();
}

// A (na, S), B (nb, S) float32 with S % 4 == 0 and S <= 2048 (the 16 * S
// bytes of ring stay within 48 KB); ai, bj (E,) int32 rows (clamped); out (E,)
// float32, every element written.  blocks: the grid (entries are strided
// over it).
extern "C" int gb_gatherdot_async(const void* A, const void* B,
                                  const void* ai, const void* bj, void* out,
                                  int E, int na, int nb, int S, int blocks,
                                  void* stream) {
  if (S <= 0 || S % 4 || S > 2048 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (E > 0) {
    gatherdot_async_kernel<<<blocks, GD_THREADS, 16 * S,
                             (cudaStream_t)stream>>>(
        (const float*)A, (const float*)B, (const int*)ai, (const int*)bj,
        (float*)out, E, na, nb, S);
  }
  return (int)cudaGetLastError();
}
