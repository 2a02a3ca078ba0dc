// Gather + AND + popcount over bitpacked panels: per mask entry e = (i, j),
//   out[e] = sum_w popc(Apack[amap[i], w] & Bpack[bmap[j], w])
// with 0 for entries at or past nvals and for rows whose map is -1.  B is
// given compacted: row j's nonzero words are word[q] at column widx[q] for
// q in [bptr[j], bptr[j+1]) (a CSR of B's nonzero words).
//
// Replaces graphblas_tpu/sparse/bitdot.py::_bitdot_jit (a plain-XLA
// gather+AND+popcount pass on the TPU, streamed in lax.map chunks so the
// gathered panels stayed bounded).  Torch has no popcount op.
//
// What bounds it on the card: the words it reads.  Most panel words are
// zero (about 5 % are not at R-MAT 16), so reading both full rows per
// entry, 8*W bytes, is mostly wasted traffic; the work the inputs define
// is one AND + popcount + add per (entry, nonzero B word), with each
// distinct A row read once and each distinct compacted B row once.
//
// What the design does about it: mask entries come in CSR order, so runs
// of consecutive entries share their A row.  Each block takes a chunk of
// CH consecutive entries (a long mask row is split across chunks), finds
// the runs of equal mapped A row (any order of rowids is right; unsorted
// entries just make runs of one), and for each run stages the A row once
// in shared memory with 16-byte loads (4-byte loads when W is not a
// multiple of 4; through L1 when the row exceeds the shared memory a block
// may take without opting in).  The block's warps then take the run's
// entries, one each: lanes stride over B's compacted words with coalesced
// loads, AND each with A[widx] from shared memory, popcount, and a shuffle
// reduction leaves the count in lane 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;             // threads per block
constexpr int CH = NT;              // mask entries per block (one per thread)
constexpr int WARPS = NT / 32;
// A rows staged in up to 44 KB: with the static arrays below, under the
// 48 KB a block takes without opting in
constexpr int SMEM_WORDS = 11264;

template <bool SMEM>
__global__ void __launch_bounds__(NT)
bitdot_popcount_kernel(const uint32_t* __restrict__ Apack,
                       const int* __restrict__ bptr,
                       const int* __restrict__ bwidx,
                       const uint32_t* __restrict__ bword,
                       const int* __restrict__ amap,
                       const int* __restrict__ bmap,
                       const int* __restrict__ rowids,
                       const int* __restrict__ indices, int* out,
                       int64_t nzmax, int64_t nvals, int na, int nb, int W,
                       int amap_len, int bmap_len) {
  extern __shared__ uint4 arow_v[];
  uint32_t* arow = reinterpret_cast<uint32_t*>(arow_v);
  __shared__ int ii_s[CH], jj_s[CH], run_s[CH];
  __shared__ int warp_runs[WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t e0 = (int64_t)blockIdx.x * CH;
  const int64_t e = e0 + t;
  int ii = -1, jj = -1;
  if (e < nvals) {
    ii = rowids[e];
    jj = indices[e];
    if (amap) ii = amap[min(max(ii, 0), amap_len - 1)];
    if (bmap) jj = bmap[min(max(jj, 0), bmap_len - 1)];
    if (ii >= 0) ii = min(ii, na - 1);
    if (jj >= 0) jj = min(jj, nb - 1);
  }
  if (e < nzmax && (ii < 0 || jj < 0)) out[e] = 0;
  ii_s[t] = ii;
  jj_s[t] = jj;
  __syncthreads();
  // runs: maximal stretches of one A row; entries with no A row start none
  const bool start = ii >= 0 && (t == 0 || ii_s[t - 1] != ii);
  const unsigned bal = __ballot_sync(0xffffffffu, start);
  if (lane == 0) warp_runs[warp] = __popc(bal);
  __syncthreads();
  int idx = __popc(bal & ((1u << lane) - 1));
  int nruns = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    idx += w < warp ? warp_runs[w] : 0;
    nruns += warp_runs[w];
  }
  if (start) run_s[idx] = t;
  __syncthreads();
  const bool vec = (W & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(Apack) & 15) == 0;
  for (int r = 0; r < nruns; ++r) {
    const int rs = run_s[r];
    const int re = r + 1 < nruns ? run_s[r + 1] : CH;
    const int row = ii_s[rs];
    const uint32_t* a = Apack + (int64_t)row * W;
    if (SMEM) {
      if (vec) {
        const uint4* av = reinterpret_cast<const uint4*>(a);
        for (int q = t; q < W / 4; q += NT) arow_v[q] = __ldg(av + q);
      } else {
        for (int q = t; q < W; q += NT) arow[q] = __ldg(a + q);
      }
      __syncthreads();
      a = arow;
    }
    // entries of [rs, re) off the run's row have no A row (ii = -1)
    for (int k = rs + warp; k < re; k += WARPS) {
      const int j = jj_s[k];
      if (ii_s[k] != row || j < 0) continue;   // uniform across the warp
      int acc = 0;
      const int q1 = bptr[j + 1];
      for (int q = bptr[j] + lane; q < q1; q += 32)
        acc += __popc(__ldg(bword + q) & a[__ldg(bwidx + q)]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) out[e0 + k] = acc;
    }
    if (SMEM) __syncthreads();   // the next run overwrites the staged row
  }
}

}  // namespace

// Apack (na, W): int32 tensor holding the uint32 words.  bptr (nb+1,),
// bwidx and bword (bptr[nb],): B's rows compacted to their nonzero words,
// int32.  amap (amap_len,) / bmap (bmap_len,): row -> panel row or -1, or
// NULL.  rowids, indices, out: (nzmax,) int32.
extern "C" int gb_bitdot_popcount(const void* Apack, const void* bptr,
                                  const void* bwidx, const void* bword,
                                  const void* amap, const void* bmap,
                                  const void* rowids, const void* indices,
                                  void* out, int64_t nzmax, int64_t nvals,
                                  int na, int nb, int W, int amap_len,
                                  int bmap_len, void* stream) {
  if (nzmax > 0) {
    const unsigned blocks = (unsigned)((nzmax + CH - 1) / CH);
    const bool smem = W <= SMEM_WORDS;
    const size_t bytes = smem ? (size_t)((W + 3) / 4) * 16 : 0;
    auto kernel = smem ? bitdot_popcount_kernel<true>
                       : bitdot_popcount_kernel<false>;
    kernel<<<blocks, NT, bytes, (cudaStream_t)stream>>>(
        (const uint32_t*)Apack, (const int*)bptr, (const int*)bwidx,
        (const uint32_t*)bword, (const int*)amap, (const int*)bmap,
        (const int*)rowids, (const int*)indices, (int*)out, nzmax, nvals, na,
        nb, W, amap_len, bmap_len);
  }
  return (int)cudaGetLastError();
}
