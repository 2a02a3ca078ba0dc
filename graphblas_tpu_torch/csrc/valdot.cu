// Gather-dot over value panels: per live lane t < nlive,
//   out[t] = sum_s Av[clip(ai[t]), s] * Bv[clip(bj[t]), s]
// with one S-wide panel row gathered per side; clip() clamps an index to
// the panel's rows (a -1 or a pad reads row 0, as in the JAX package).
// Two kernels compute it: the dense one reads the panels as they are
// (gb_valdot_gatherdot; lanes at or past nlive are not written, the
// wrapper zeroes the output), the compacted one reads each panel's rows
// compacted to their entries (gb_valdot_gatherdot_rows; it writes 0 past
// nlive itself).  The masked valued product runs the compacted one; the
// dense one serves dense tables (the gather-dot probe).
//
// Replaces graphblas_tpu/sparse/valdot.py::_gd_jit (the fused Pallas
// gather-dot _gd_kernel, pallas_call at valdot.py:481), which DMA'd one
// panel row per side per lane into a double-buffered VMEM ring and reduced
// it there.  The DMA ring, its semaphores and the _GD_SEG segmentation
// (a 1 MB scalar-prefetch limit) are TPU-only: these kernels take any S
// that is a multiple of 4 and any number of lanes in one launch.
// float32 accumulates in float32 (as jnp.sum does); int32 accumulates in
// uint32 arithmetic, so wraparound is defined and equals the JAX
// package's int32 wrap.
//
// The dense kernel.  What bounds it on the card: bytes.  Each lane reads
// 2*S*4 bytes of rows, but the compulsory traffic is each distinct panel
// row read once plus the (ai, bj) index pairs and the output, over 3.35
// TB/s; the arithmetic (2*S operations per lane) is far below the 67
// TFLOP/s of float32 on the CUDA cores.  Its design: one warp per live
// lane, each thread loading 16 bytes (float4 / int4) per step so a warp
// sweeps 512 contiguous bytes of each row per step, multiply-accumulate in
// registers and a shuffle reduction; L1/L2 serve the repeated rows.
//
// The compacted kernel.  The panels of the masked product are almost
// empty (2.9 % of slab 0's slots at R-MAT 18, fewer later), so the dense
// kernel reads mostly zeros, and re-reads each lane's 16 KB B row from
// L2.  What bounds the work the inputs define: bytes, each distinct row's
// (slot, value) pairs read once (8 B each) plus 12 B per lane; its
// operations are 2 per (lane, B entry).  Its design: live lanes are mask
// entries in CSR order, so runs of consecutive lanes share their A row.
// A block takes CH consecutive lanes and finds the runs (a ballot scan).
// For a run of at least RUN_MIN lanes it scatters the A row's entries
// into a zeroed S-slot row in shared memory, its lanes walk their B rows'
// entries and read A's value at each slot from there, and the A row's
// slots are zeroed again: a run costs 2 * nnz(A row) shared stores, not
// S.  Lanes of shorter runs (and every lane when S exceeds the shared
// row, SMEM_SLOTS) find A's value by a binary search of A's compacted row
// instead, with no barrier.  A lane's B row is walked by a group of G
// threads, G a power of two up to 32 chosen per block from its lanes'
// mean B row length (about half of it), so short rows do not idle a
// whole warp; a shuffle reduction within the group leaves the sum in its
// first thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int WARPS = NT / 32;   // live lanes per block (dense kernel)
constexpr int CH = NT;           // live lanes per block (compacted kernel)
// the staged A row: up to 44 KB of 4-byte slots, so that with the static
// arrays it stays under the 48 KB a block takes without opting in
constexpr int SMEM_SLOTS = 11264;
// runs of fewer lanes search A's compacted row instead of staging it
constexpr int RUN_MIN = 4;

__device__ __forceinline__ int clip_row(int r, int n) {
  return r < 0 ? 0 : (r >= n ? n - 1 : r);
}

__global__ void __launch_bounds__(NT)
gatherdot_f32_kernel(const float* __restrict__ Av,
                     const float* __restrict__ Bv,
                     const int* __restrict__ ai, const int* __restrict__ bj,
                     float* __restrict__ out, int64_t nlive, int na, int nb,
                     int S) {
  const int64_t t = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (t >= nlive) return;  // whole warp: t is uniform across its lanes
  const float4* a = reinterpret_cast<const float4*>(
      Av + (int64_t)clip_row(ai[t], na) * S);
  const float4* b = reinterpret_cast<const float4*>(
      Bv + (int64_t)clip_row(bj[t], nb) * S);
  float acc = 0.f;
  for (int v = lane; v < S / 4; v += 32) {
    const float4 x = a[v];
    const float4 y = b[v];
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[t] = acc;
}

__global__ void __launch_bounds__(NT)
gatherdot_i32_kernel(const int4* __restrict__ Av4,
                     const int4* __restrict__ Bv4,
                     const int* __restrict__ ai, const int* __restrict__ bj,
                     uint32_t* __restrict__ out, int64_t nlive, int na,
                     int nb, int S) {
  const int64_t t = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (t >= nlive) return;
  const int S4 = S / 4;
  const int4* a = Av4 + (int64_t)clip_row(ai[t], na) * S4;
  const int4* b = Bv4 + (int64_t)clip_row(bj[t], nb) * S4;
  uint32_t acc = 0u;
  for (int v = lane; v < S4; v += 32) {
    const int4 x = a[v];
    const int4 y = b[v];
    acc += (uint32_t)x.x * (uint32_t)y.x;
    acc += (uint32_t)x.y * (uint32_t)y.y;
    acc += (uint32_t)x.z * (uint32_t)y.z;
    acc += (uint32_t)x.w * (uint32_t)y.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[t] = acc;
}

__device__ __forceinline__ float madd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ uint32_t madd(uint32_t a, uint32_t b,
                                         uint32_t c) {
  return c + a * b;
}

// A's value at slot s in its compacted row [a0, a1) (slots ascending), or 0
template <typename V>
__device__ __forceinline__ V find_slot(const int* __restrict__ aslot,
                                       const V* __restrict__ aval, int a0,
                                       int a1, int s) {
  int lo = a0, hi = a1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(aslot + mid) < s) lo = mid + 1;
    else hi = mid;
  }
  return lo < a1 && __ldg(aslot + lo) == s ? __ldg(aval + lo) : V(0);
}

// One thread's share of a lane's dot: B entries q0, q0 + G, ... < q1, A's
// value from the staged row (STAGED) or by search in A's row [a0, a1).
template <typename V, bool STAGED>
__device__ __forceinline__ V row_dot(const int* __restrict__ bslot,
                                     const V* __restrict__ bval, int q0,
                                     int q1, int G, const V* arow,
                                     const int* __restrict__ aslot,
                                     const V* __restrict__ aval, int a0,
                                     int a1) {
  V acc = V(0);
#pragma unroll 4
  for (int q = q0; q < q1; q += G) {
    const int s = __ldg(bslot + q);
    const V a = STAGED ? arow[s] : find_slot(aslot, aval, a0, a1, s);
    acc = madd(a, __ldg(bval + q), acc);
  }
  return acc;
}

// Sum over each group of G consecutive threads, in its first thread.
template <typename V>
__device__ __forceinline__ V group_sum(V x, int G) {
  for (int off = G >> 1; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off, G);
  return x;
}

// A row r: values aval[q] at slots aslot[q], q in [aptr[r], aptr[r+1]),
// slots ascending; B likewise.  SMEM: S <= SMEM_SLOTS, with S*4 bytes of
// dynamic shared memory for the staged A row.  One block per CH lanes of
// the E; lanes at or past nlive get 0.
template <typename V, bool SMEM>
__global__ void __launch_bounds__(NT)
gatherdot_rows_kernel(const int* __restrict__ aptr,
                      const int* __restrict__ aslot,
                      const V* __restrict__ aval,
                      const int* __restrict__ bptr,
                      const int* __restrict__ bslot,
                      const V* __restrict__ bval, const int* __restrict__ ai,
                      const int* __restrict__ bj, V* __restrict__ out,
                      int64_t E, int64_t nlive, int na, int nb, int S) {
  extern __shared__ uint4 arow_v[];
  V* arow = reinterpret_cast<V*>(arow_v);
  __shared__ int ii_s[CH], jj_s[CH], run_s[CH + 1];
  __shared__ bool short_s[CH];
  __shared__ int warp_runs[WARPS];
  __shared__ float warp_len[WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t e0 = (int64_t)blockIdx.x * CH;
  const int64_t e = e0 + t;
  const int64_t left = nlive - e0;   // valid lanes from e0 on
  const int nvalid = left <= 0 ? 0 : (left < CH ? (int)left : CH);
  if (nvalid == 0) {               // the whole block is past nlive
    if (e < E) out[e] = V(0);
    return;
  }
  int ii = -1, jj = -1, len = 0;
  if (t < nvalid) {
    ii = clip_row(ai[e], na);
    jj = clip_row(bj[e], nb);
    len = bptr[jj + 1] - bptr[jj];
  } else if (e < E) {
    out[e] = V(0);
  }
  ii_s[t] = ii;
  jj_s[t] = jj;
  if (SMEM)
    for (int q = t; q < S / 4; q += NT) arow_v[q] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  // runs: maximal stretches of one A row among the block's valid lanes
  const bool start = t < nvalid && (t == 0 || ii_s[t - 1] != ii);
  const unsigned bal = __ballot_sync(0xffffffffu, start);
  float lsum = (float)len;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
  if (lane == 0) {
    warp_runs[warp] = __popc(bal);
    warp_len[warp] = lsum;
  }
  __syncthreads();
  int before = 0, nruns = 0;
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    before += w < warp ? warp_runs[w] : 0;
    nruns += warp_runs[w];
    total += warp_len[w];
  }
  if (start) run_s[before + __popc(bal & ((1u << lane) - 1))] = t;
  if (t == 0) run_s[nruns] = nvalid;
  __syncthreads();
  if (t < nvalid) {
    const int r = before + __popc(bal & (0xffffffffu >> (31 - lane))) - 1;
    short_s[t] = run_s[r + 1] - run_s[r] < RUN_MIN;
  }
  // the group size: a power of two near half the mean B row length
  int G = 1;
  while (G < 32 && 2.f * G < total / nvalid) G <<= 1;
  const int gl = t & (G - 1), gs = t / G, NG = NT / G;
  __syncthreads();
  // lanes of short runs (every lane without the staged row): search
  for (int base = 0; base < nvalid; base += NG) {
    const int k = base + gs;
    const bool mine = k < nvalid && (!SMEM || short_s[k]);
    V acc = V(0);
    if (mine) {
      const int row = ii_s[k], j = jj_s[k];
      acc = row_dot<V, false>(bslot, bval, bptr[j] + gl, bptr[j + 1], G,
                              arow, aslot, aval, aptr[row], aptr[row + 1]);
    }
    acc = group_sum(acc, G);
    if (mine && gl == 0) out[e0 + k] = acc;
  }
  // runs of RUN_MIN lanes or more: stage the A row, then its lanes
  if constexpr (SMEM) for (int r = 0; r < nruns; ++r) {
    const int rs = run_s[r], re = run_s[r + 1];
    if (re - rs < RUN_MIN) continue;            // uniform across the block
    const int row = ii_s[rs];
    const int a0 = aptr[row], a1 = aptr[row + 1];
    for (int q = a0 + t; q < a1; q += NT)
      arow[__ldg(aslot + q)] = __ldg(aval + q);
    __syncthreads();
    for (int base = rs; base < re; base += NG) {
      const int k = base + gs;
      V acc = V(0);
      if (k < re) {
        const int j = jj_s[k];
        acc = row_dot<V, true>(bslot, bval, bptr[j] + gl, bptr[j + 1], G,
                               arow, aslot, aval, a0, a1);
      }
      acc = group_sum(acc, G);
      if (k < re && gl == 0) out[e0 + k] = acc;
    }
    __syncthreads();                 // every lane of the run is done
    for (int q = a0 + t; q < a1; q += NT) arow[__ldg(aslot + q)] = V(0);
    __syncthreads();                 // the row is zero again
  }
}

}  // namespace

// Av (na, S), Bv (nb, S): float32 (is_int 0) or int32 (is_int 1) panels,
// rows 16-byte aligned (S % 4 == 0).  ai, bj: (>= nlive,) int32 panel rows.
// out: (>= nlive,) of the panels' dtype.
extern "C" int gb_valdot_gatherdot(const void* Av, const void* Bv,
                                   const void* ai, const void* bj, void* out,
                                   int64_t nlive, int na, int nb, int S,
                                   int is_int, void* stream) {
  if (nlive > 0) {
    const int64_t blocks = (nlive + WARPS - 1) / WARPS;
    if (is_int) {
      gatherdot_i32_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
          (const int4*)Av, (const int4*)Bv, (const int*)ai, (const int*)bj,
          (uint32_t*)out, nlive, na, nb, S);
    } else {
      gatherdot_f32_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
          (const float*)Av, (const float*)Bv, (const int*)ai, (const int*)bj,
          (float*)out, nlive, na, nb, S);
    }
  }
  return (int)cudaGetLastError();
}

// aptr (na+1,), aslot, aval (aptr[na],): the A panel's rows compacted to
// their entries, slots ascending in each row; bptr, bslot, bval likewise
// for B (nb rows).  ai, bj: (E,) int32 panel rows; out: (E,) of the
// values' dtype, every element written (0 at and past nlive).  S: the
// slot count, a multiple of 4.
extern "C" int gb_valdot_gatherdot_rows(const void* aptr, const void* aslot,
                                        const void* aval, const void* bptr,
                                        const void* bslot, const void* bval,
                                        const void* ai, const void* bj,
                                        void* out, int64_t E, int64_t nlive,
                                        int na, int nb, int S, int is_int,
                                        void* stream) {
  if (E > 0) {
    const unsigned blocks = (unsigned)((E + CH - 1) / CH);
    const bool smem = S <= SMEM_SLOTS;
    const size_t bytes = smem ? (size_t)S * 4 : 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_int) {
      auto kernel = smem ? gatherdot_rows_kernel<uint32_t, true>
                         : gatherdot_rows_kernel<uint32_t, false>;
      kernel<<<blocks, NT, bytes, st>>>(
          (const int*)aptr, (const int*)aslot, (const uint32_t*)aval,
          (const int*)bptr, (const int*)bslot, (const uint32_t*)bval,
          (const int*)ai, (const int*)bj, (uint32_t*)out, E, nlive, na, nb,
          S);
    } else {
      auto kernel = smem ? gatherdot_rows_kernel<float, true>
                         : gatherdot_rows_kernel<float, false>;
      kernel<<<blocks, NT, bytes, st>>>(
          (const int*)aptr, (const int*)aslot, (const float*)aval,
          (const int*)bptr, (const int*)bslot, (const float*)bval,
          (const int*)ai, (const int*)bj, (float*)out, E, nlive, na, nb, S);
    }
  }
  return (int)cudaGetLastError();
}
