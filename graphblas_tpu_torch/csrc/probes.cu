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
// row-gather beats the compiler's own gather.  The gather-dot kernel K4
// (valdot.cu) computes the same function with synchronous loads, one warp
// per entry, and reads both rows of every entry.  What bounds it: bytes
// (each distinct row once, the indices and the output); 65,536 random
// pairs of 4 KB rows gather 537 MB, against about 233 MB of distinct rows.
// This kernel reads each A row once per run of entries that share it and
// keeps many B rows in flight: the wrapper sorts the entries by ai (the
// grouping pass; perm maps them back), each block takes a contiguous
// chunk, and one producer warp walks it, copying each B row (and, where
// a run of equal ai starts, the A row) into a ring of GD_STAGES stages
// with Hopper's bulk asynchronous copy (cp.async.bulk: one thread issues a
// whole row; an mbarrier counts its bytes).  Consumer warps each reduce
// one entry against the A row in its slot and release the stage to the
// producer through the stage's empty mbarrier: no block-wide barrier per
// entry.  A rows take a ring of GD_STAGES slots, one per run: when the
// producer takes the stage of a run's first entry, every entry
// GD_STAGES or more places back has been released, and so has the run
// GD_STAGES runs back (each run holds at least one entry), so its slot is
// free.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GATHER_WARPS = 8;      // rows per block of the row gather
constexpr int MAX_WINDOW = 1536;     // 8 windows of floats in 48 KB
constexpr int GD_STAGES = 8;         // gather-dot: B rows in flight a block
constexpr int GD_CONSUMERS = 4;      // gather-dot: consumer warps a block
constexpr int GD_THREADS = 32 * (GD_CONSUMERS + 1);  // and one producer

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

__device__ __forceinline__ int clip_row(int r, int n) {
  return r < 0 ? 0 : (r >= n ? n - 1 : r);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// one arrival that also expects ``bytes`` of copies to land
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// bytes (a multiple of 16, both ends 16-byte aligned) from global to shared
// memory; the barrier's transaction count takes them as they land
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared memory: GD_STAGES A slots and GD_STAGES B stages of S floats, then
// the full, empty and A-slot barriers and each stage's (run, output) pair
__host__ __device__ constexpr size_t gd_smem_bytes(int S) {
  return 2 * (size_t)GD_STAGES * S * 4 + 3 * GD_STAGES * 8 + GD_STAGES * 8;
}

// Block b: the entries [b * chunk, min(E, (b + 1) * chunk)), chunk =
// ceil(E / gridDim.x); local entry i goes to stage i % GD_STAGES, its run
// r (counted in the block, from 0) to A slot r % GD_STAGES.
__global__ void __launch_bounds__(GD_THREADS)
gatherdot_async_kernel(const float* __restrict__ A,
                       const float* __restrict__ B,
                       const int* __restrict__ ai, const int* __restrict__ bj,
                       const int* __restrict__ perm, float* __restrict__ out,
                       int E, int na, int nb, int S) {
  extern __shared__ __align__(16) float4 gd_smem[];
  const int S4 = S / 4;
  float4* Arow = gd_smem;
  float4* Brow = Arow + GD_STAGES * S4;
  uint64_t* full = reinterpret_cast<uint64_t*>(Brow + GD_STAGES * S4);
  uint64_t* empty = full + GD_STAGES;
  uint64_t* afull = empty + GD_STAGES;
  int2* meta = reinterpret_cast<int2*>(afull + GD_STAGES);
  const long chunk = ((long)E + gridDim.x - 1) / gridDim.x;
  const long first = (long)blockIdx.x * chunk;
  if (first >= E) return;  // the whole block
  const int p0 = (int)first;
  const int n = (int)(E - first < chunk ? E - first : chunk);
  if (threadIdx.x == 0) {
    for (int i = 0; i < GD_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 32);  // every lane of the consuming warp
      mbar_init(&afull[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned row_bytes = (unsigned)S * 4;
  if (warp == GD_CONSUMERS) {
    // the producer: the warp reads 32 entries' indices at a time, lane 0
    // issues their copies in order
    int run = -1, prev = 0;
    for (int base = 0; base < n; base += 32) {
      const int p = p0 + base + lane;
      int a = 0, b = 0, o = 0;
      if (base + lane < n) {
        a = clip_row(ai[p], na);
        b = clip_row(bj[p], nb);
        o = perm ? perm[p] : p;
      }
      const int m = min(32, n - base);
      for (int j = 0; j < m; ++j) {
        const int aj = __shfl_sync(0xffffffffu, a, j);
        const int bjj = __shfl_sync(0xffffffffu, b, j);
        const int oj = __shfl_sync(0xffffffffu, o, j);
        if (lane == 0) {
          const int i = base + j;
          const int st = i % GD_STAGES;
          // the stage's previous entry (i - GD_STAGES) has been released
          mbar_wait(&empty[st], ((i / GD_STAGES) & 1) ^ 1);
          if (i == 0 || aj != prev) {
            ++run;
            prev = aj;
            const int as = run % GD_STAGES;
            mbar_expect(&afull[as], row_bytes);
            bulk_copy(Arow + as * S4, A + (long)aj * S, row_bytes,
                      &afull[as]);
          }
          meta[st] = make_int2(run, oj);
          mbar_expect(&full[st], row_bytes);
          bulk_copy(Brow + st * S4, B + (long)bjj * S, row_bytes, &full[st]);
        }
        __syncwarp();
      }
    }
  } else {
    // a consumer: entries warp, warp + GD_CONSUMERS, ...
    for (int i = warp; i < n; i += GD_CONSUMERS) {
      const int st = i % GD_STAGES;
      mbar_wait(&full[st], (i / GD_STAGES) & 1);
      const int2 mt = meta[st];
      const int as = mt.x % GD_STAGES;
      mbar_wait(&afull[as], (mt.x / GD_STAGES) & 1);
      const float4* x = Arow + as * S4;
      const float4* y = Brow + st * S4;
      float acc = 0.f;
      for (int c = lane; c < S4; c += 32) {
        const float4 u = x[c], v = y[c];
        acc = fmaf(u.x, v.x, acc);
        acc = fmaf(u.y, v.y, acc);
        acc = fmaf(u.z, v.z, acc);
        acc = fmaf(u.w, v.w, acc);
      }
      mbar_arrive(&empty[st]);  // this lane's reads of the stage are done
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) out[mt.y] = acc;
    }
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

// A (na, S), B (nb, S) float32 with S % 4 == 0 and S <= 2048 (the ring's
// 64 * S bytes stay within a block's shared memory), 16-byte aligned; ai,
// bj (E,) int32 rows (clamped); perm (E,) int32, a permutation of 0..E-1,
// or null for the identity: entry e's result goes to out[perm[e]]; out
// (E,) float32, every element written.  Entries with equal ai next to each
// other share one read of the A row.  blocks: the grid (each block takes a
// contiguous chunk of entries).
extern "C" int gb_gatherdot_async(const void* A, const void* B,
                                  const void* ai, const void* bj,
                                  const void* perm, void* out, int E, int na,
                                  int nb, int S, int blocks, void* stream) {
  if (S <= 0 || S % 4 || S > 2048 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (E > 0) {
    const size_t smem = gd_smem_bytes(S);
    const cudaError_t rc = cudaFuncSetAttribute(
        gatherdot_async_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
    gatherdot_async_kernel<<<blocks, GD_THREADS, smem,
                             (cudaStream_t)stream>>>(
        (const float*)A, (const float*)B, (const int*)ai, (const int*)bj,
        (const int*)perm, (float*)out, E, na, nb, S);
  }
  return (int)cudaGetLastError();
}
