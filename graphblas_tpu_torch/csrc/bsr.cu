// BSR tile-triple masked product (K7): for every output tile o of a
// schedule,
//   C[o] = (sum over s in [starts[o], starts[o+1]) of A[ta[s]] . B[tb[s]]^T)
//          * (M[mslot[o]] != 0)
// with 128x128 tiles stacked in A (ntA, T, T), B (ntB, T, T) and M (ntM, T,
// T).  Two forms: counting, int8 0/1 tiles into int32 (exact), and values,
// float32 tiles into float32 (float32 accuracy from split TF32 products on
// the tensor cores, below).
//
// Replaces graphblas_tpu/sparse/pallas_bsr.py::_launch (the Pallas kernel
// _kernel, pallas_call at pallas_bsr.py:95).  The TPU walked a sequential
// (output tile, K-slot) grid padded to the longest output's slot count, with
// the schedule scalar-prefetched so the pipeline could DMA the next A and B
// tiles, and carried the accumulator in its revisited VMEM output block;
// its float32 products ran at Precision.HIGHEST (multi-pass bf16 products
// on the MXU, float32 accumulation).  Here each CUDA block reads its own
// schedule entries and loops over its own K-slots only (no padded steps),
// keeps the accumulator in registers across the loop, masks it once and
// stores it once: no atomics, nothing carried between blocks.  The mask is
// read through its slot, so the caller passes M's own tiles rather than a
// gathered copy.
//
// Both forms share one structure: one block of 256 threads owns a whole
// 128x128 output tile and multiplies on the tensor cores in the A.B^T
// form: both tiles are k contiguous, the native (K-major) layout of the
// tensor cores' operands, so nothing is transposed.  One cp.async ring of
// 64-byte k stages runs across the output's triples, so it does not drain
// between them; the stages are swizzled by row (mma_s8_tile.cuh's layout,
// which is also wgmma's 64-byte-swizzle K-major layout); the epilogue pairs
// lanes with one shuffle and masks four outputs per 4-byte mask read and
// 16-byte store.
//
// The counting form runs mma.sync m16n8k32 s8 (mma_s8_tile.cuh), three
// stages of 64 k.  What bounds it: bytes (each output tile 64 KB of int32
// against 16 KB per int8 input tile; the int8 operations sit far below
// the tensor cores' 1,979 TOP/s).  Sums are exact: each product is at most
// 2^14 in magnitude and K = 128 * triples.
//
// The values form: what bounds it is operations.  At Wathen 384 (52,820
// triples) it is 2 * 128^3 * 52,820 = 221.5 G float32 multiply-adds: 3.31
// ms on the CUDA cores (67 TFLOP/s), where the form this kernel replaced
// ran (7.16 ms on an NVIDIA H100 80GB HBM3, 700.00 W power limit); three
// TF32 products a term on the tensor cores (495 TFLOP/s) take 1.34 ms,
// against about 4.0 GB of compulsory bytes (1.2 ms).  A TF32 operand keeps
// 10 of float32's 23 mantissa bits, so each operand is split as x = hi +
// lo + d: hi is x with its low 13 mantissa bits cleared (a truncation: no
// x rounds up to inf), lo is x - hi (exact) rounded to TF32, and |d| <=
// 2^-21 |x|.  The three products hi_a hi_b + hi_a lo_b + lo_a hi_b are
// exact on the tensor cores and sum in float32; the dropped lo_a lo_b and
// the d terms leave each term within 2^-19 of a b, so an output stays
// within K * 2^-24 * sum |a b| (K = 128 * triples) of the float64 sum, as
// a float32 FMA loop does.  Small products go first into the accumulator.
// The products run as wgmma m64n128k8 tf32, each warpgroup 64 rows: the
// threads that copied a stage of B split it in shared memory (hi in place,
// lo beside it), the only operand wgmma reads there; each warp splits its
// A fragments (ldmatrix) in registers.  mma.sync m16n8k8 with both
// operands split in registers, each B value by four warps, did not reach
// half the bound: it was bound by instruction issue and latency.  Four stages of
// 16 k (80 KB with two lo buffers) keep two blocks an SM.  At Wathen 384
// this form takes 2.60-2.61 ms (NVIDIA H100 80GB HBM3, 700.00 W power
// limit; chip_smoke.py phase 17), 1.94x its TF32 bound.  Non-finite
// operands: an inf or NaN leaves a non-finite sum in every output of its
// row or column (inf * 0 = NaN), so a tile whose sums come out non-finite
// is computed again on mma.sync with a split that takes them: hi = x, lo
// = 0, and 0 for x in the cross products, so only hi_a hi_b meets the inf
// or NaN and the sum has the float32 product's infinities and NaNs, never
// inf - inf or inf * 0 where the plain version has inf.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8_tile.cuh"  // mma_s8: the int8 tile, its layout and copies

namespace {

constexpr int T = 128;         // tile rows and columns

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

// ---------------------------------------------------------------------------
// The values form: float32 tiles, split TF32 products on wgmma

constexpr int F_STAGES = 4;                 // ring depth of 16-k stages
constexpr int F_WORDS = T * mma_s8::KW;     // one operand's stage: 8 KB
constexpr int F_NKC = T * 4 / mma_s8::KC;   // stages per triple: 8
// the ring (A, B), then two buffers of B's lo parts, and room to align
// the whole to 1,024 bytes
constexpr int F_SMEM_BYTES = 4 * (2 * F_STAGES + 2) * F_WORDS + 1024;
constexpr uint32_t TF32_HI = 0xffffe000u;   // sign, exponent, 10 bits

__device__ __forceinline__ bool finite(float f) {
  return fabsf(f) < __uint_as_float(0x7f800000u);  // false for NaN too
}

// x (float32 bits) -> hi, lo and hc, the hi of the cross products.
// Finite x: hi = x truncated to TF32, lo = x - hi rounded to TF32
// (nearest, ties away: the carry of bit 12 rounds the magnitude), hc = hi.
// SAFE also takes non-finite x: hi = x (a NaN as the quiet NaN of its
// sign, whose payload survives the tensor cores' 10 mantissa bits), lo =
// hc = 0, so only hi * hi sees the inf or NaN and the cross products of a
// TF32-exact partner (lo = 0) add 0, not inf * 0.
template <bool SAFE>
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo, uint32_t& hc) {
  hi = x & TF32_HI;
  const float r = __uint_as_float(x) - __uint_as_float(hi);
  lo = (__float_as_uint(r) + 0x1000u) & TF32_HI;
  hc = hi;
  if (SAFE) {
    const float f = __uint_as_float(x);
    if (!finite(f)) {
      if (f != f) hi = (x & 0x80000000u) | 0x7fc00000u;
      lo = 0u;
      hc = 0u;
    }
  }
}

__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The wgmma descriptor of a 128-row stage in mma_s8::a_off's layout
// (rows of 64 bytes, 16-byte groups XOR-swizzled by (row / 2) % 4): that
// is the K-major 64-byte-swizzle layout, 8-row groups 512 bytes apart,
// given a 512-byte aligned stage.  LBO is unused by swizzled K-major.
__device__ __forceinline__ uint64_t sw64_desc(const void* p) {
  const uint64_t a = (uint32_t)__cvta_generic_to_shared(p);
  return ((a & 0x3ffffu) >> 4) | (1ull << 16) | ((512ull >> 4) << 32)
         | (2ull << 62);
}

// d (the warpgroup's 64 x 128 float32 tile) += a (the warp's 16 x 8 tf32
// fragment, mma.m16n8k8's A layout) . B (128 x 8 tf32, K-major at desc).
__device__ __forceinline__ void wgmma_tf32(float (&d)[16][4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Fragment ownership, both paths: warp w (of 8) owns output rows 16 w ..
// 16 w + 15 and all 128 columns; d[i][*] is the m16n8 C fragment of
// columns 8 i .. 8 i + 7 (rows 16 w + lane / 4 (+ 8), columns 8 i + 2
// (lane % 4) (+ 1)), which is also wgmma m64n128's per-warp layout.

// The warp's A fragments of one 16-k stage (rows 16 w .., ldmatrix from
// the swizzled stage as mma_s8::multiply_stage does), split: a[kk] the
// k8 step kk's hi, lo and hc.
template <bool SAFE>
__device__ __forceinline__ void a_fragments(const uint32_t* As,
                                            uint32_t (&ah)[2][4],
                                            uint32_t (&al)[2][4],
                                            uint32_t (&ac)[2][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ra = 16 * warp + (lane & 15), ka = 4 * (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t a[4];
    mma_s8::ldsm4(a, As + mma_s8::a_off(ra, 8 * kk + ka));
#pragma unroll
    for (int j = 0; j < 4; ++j)
      split_tf32<SAFE>(a[j], ah[kk][j], al[kk][j], ac[kk][j]);
  }
}

// The fast path's stage: this thread's own copies of B (copy_stage_nt's
// chunks t and t + 256) split in place into hi, their lo parts into Blo
// at the same offsets.  Its own cp.async copies are visible to it once
// waited for; the wgmma reads the two through the async proxy.
__device__ __forceinline__ void split_own_b(uint32_t* Bs, uint32_t* Blo) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int id = threadIdx.x + mma_s8::NT * p;
    const int off = mma_s8::a_off(id >> 2, 4 * (id & 3));
    uint4 v = *reinterpret_cast<const uint4*>(Bs + off);
    uint4 h, l;
    uint32_t c;
    split_tf32<false>(v.x, h.x, l.x, c);
    split_tf32<false>(v.y, h.y, l.y, c);
    split_tf32<false>(v.z, h.z, l.z, c);
    split_tf32<false>(v.w, h.w, l.w, c);
    *reinterpret_cast<uint4*>(Bs + off) = h;
    *reinterpret_cast<uint4*>(Blo + off) = l;
  }
}

// The safe path's stage on mma.sync: B's fragments split in registers
// (ldmatrix.x4 of (n 0-7, k 0-3), (n 0-7, k 4-7) and the next eight n:
// b0, b1 of two n8 tiles).
__device__ __forceinline__ void multiply_stage_safe(const uint32_t* As,
                                                    const uint32_t* Bs,
                                                    float (&d)[16][4]) {
  uint32_t ah[2][4], al[2][4], ac[2][4];
  a_fragments<true>(As, ah, al, ac);
  const int lane = threadIdx.x & 31;
  const int nb = (lane & 7) + 8 * (lane >> 4), kb = 4 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int np = 0; np < 8; ++np) {
      uint32_t b[4], bh[4], bl[4], bc[4];
      mma_s8::ldsm4(b, Bs + mma_s8::a_off(nb + 16 * np, 8 * kk + kb));
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32<true>(b[j], bh[j], bl[j], bc[j]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float (&c)[4] = d[2 * np + h];
        mma1688(c, ac[kk], bl[2 * h], bl[2 * h + 1]);
        mma1688(c, al[kk], bc[2 * h], bc[2 * h + 1]);
        mma1688(c, ah[kk], bh[2 * h], bh[2 * h + 1]);
      }
    }
}

// The block's 128x128 float32 tile of sum_i A_i . B_i^T over npairs pairs
// of float32 tiles (row r of a tile at X + r*T), from zero.  One ring of
// F_STAGES 16-k stages runs across the pairs (stage g: pair g / F_NKC,
// byte k0 = (g % F_NKC) * 64), loaded by mma_s8::copy_stage_nt (bytes are
// bytes), as mma_s8::tile_accumulate_nt's; each pair's tile pointers are
// read a pair ahead, so no stage waits on the schedule.  Fast path: B's
// stage split into hi (in place) and lo (Blo[g % 2]) by the threads that
// copied it, A's fragments split in registers, and the three products of
// each k8 step as wgmma m64n128k8 (both warpgroups, 64 rows each); SAFE:
// mma.sync on fragments split in registers, non-finite values taken.
template <bool SAFE, class Pair>
__device__ void tile_accumulate_f32(const Pair& pair, int npairs,
                                    uint32_t* smem, float (&d)[16][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int h = 0; h < 4; ++h) d[i][h] = 0.f;
  uint32_t* const lo_buf = smem + 2 * F_STAGES * F_WORDS;
  const int nst = npairs * F_NKC;
  const float *ca = nullptr, *cb = nullptr, *na = nullptr, *nb = nullptr;
  if (npairs > 0) pair(0, na, nb);
  auto issue = [&](int g) {
    if (g % F_NKC == 0) {
      ca = na;
      cb = nb;
      if (g / F_NKC + 1 < npairs) pair(g / F_NKC + 1, na, nb);
    }
    uint32_t* st = smem + (g % F_STAGES) * 2 * F_WORDS;
    mma_s8::copy_stage_nt(reinterpret_cast<const int8_t*>(ca),
                          reinterpret_cast<const int8_t*>(cb), T * 4,
                          (g % F_NKC) * mma_s8::KC, st, st + F_WORDS);
  };
#pragma unroll
  for (int g = 0; g < F_STAGES - 1; ++g) {
    if (g < nst) issue(g);
    mma_s8::commit();
  }
  for (int g = 0; g < nst; ++g) {
    uint32_t* As = smem + (g % F_STAGES) * 2 * F_WORDS;
    uint32_t* Bs = As + F_WORDS;
    uint32_t* Blo = lo_buf + (g & 1) * F_WORDS;
    mma_s8::wait_groups<F_STAGES - 2>();
    if (!SAFE) {
      split_own_b(Bs, Blo);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    // stage g has landed and (fast path) is split, every thread's part,
    // after the barrier; every warp is done with stage g-1, whose slot
    // the next copy takes (its wgmmas were waited for)
    __syncthreads();
    if (g + F_STAGES - 1 < nst) issue(g + F_STAGES - 1);
    mma_s8::commit();
    if (SAFE) {
      multiply_stage_safe(As, Bs, d);
    } else {
      uint32_t ah[2][4], al[2][4], ac[2][4];
      a_fragments<false>(As, ah, al, ac);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        // k8 step kk: 32 bytes into each 64-byte row
        wgmma_tf32(d, al[kk], sw64_desc(Bs + 8 * kk));
        wgmma_tf32(d, ah[kk], sw64_desc(Blo + 8 * kk));
        wgmma_tf32(d, ah[kk], sw64_desc(Bs + 8 * kk));
      }
      wgmma_commit();
      wgmma_wait_all();
    }
  }
  mma_s8::wait_groups<0>();  // no copy of this thread outlives the call
}

// Same grid and schedule; float32 tiles.  The mask multiplies (as the TPU
// kernel's out * (m != 0) does), so a NaN or inf accumulator becomes NaN
// under a 0, as in the plain version.
__global__ void __launch_bounds__(mma_s8::NT, 2)
bsr_f32_kernel(const int* __restrict__ starts, const int* __restrict__ ta,
               const int* __restrict__ tb, const int* __restrict__ mslot,
               const float* __restrict__ A, const float* __restrict__ B,
               const int8_t* __restrict__ M, float* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t f_raw[];
  uint32_t* const f_smem = reinterpret_cast<uint32_t*>(
      (reinterpret_cast<uintptr_t>(f_raw) + 1023) & ~uintptr_t(1023));
  const long o = blockIdx.x;
  const int s0 = starts[o];
  float d[16][4];
  const auto pair = [&](int i, const float*& a, const float*& b) {
    a = A + (long)ta[s0 + i] * T * T;
    b = B + (long)tb[s0 + i] * T * T;
  };
  const int npairs = starts[o + 1] - s0;
  tile_accumulate_f32<false>(pair, npairs, f_smem, d);
  // An inf or NaN operand leaves a non-finite sum in every output of its
  // row (or column): inf * 0 = NaN, and inf and NaN stay in a float sum.
  // So a tile whose sums are all finite met no non-finite operand, and a
  // tile with one is computed again on the path that takes them.
  bool fin = true;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int h = 0; h < 4; ++h) fin &= finite(d[i][h]);
  if (__syncthreads_or(!fin))
    tile_accumulate_f32<true>(pair, npairs, f_smem, d);
  // the count form's epilogue, in float32, on the warp's 16 x 128 rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const bool odd = tq & 1;
  const int8_t* Mo = M + (long)mslot[o] * T * T;
  float* Co = out + o * T * T;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float* c = d[i];
    const float x0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
    const float x1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
    float4 v = odd ? make_float4(x0, x1, c[2], c[3])
                   : make_float4(c[0], c[1], x0, x1);
    const int e = (16 * warp + g + (odd ? 8 : 0)) * T + 8 * i
                  + 4 * (tq >> 1);
    const uint32_t m = *reinterpret_cast<const uint32_t*>(Mo + e);
    v.x *= (m & 0xffu) ? 1.f : 0.f;
    v.y *= (m & 0xff00u) ? 1.f : 0.f;
    v.z *= (m & 0xff0000u) ? 1.f : 0.f;
    v.w *= (m & 0xff000000u) ? 1.f : 0.f;
    *reinterpret_cast<float4*>(Co + e) = v;
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
      const cudaError_t rc = cudaFuncSetAttribute(
          bsr_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          F_SMEM_BYTES);
      if (rc != cudaSuccess) return (int)rc;
      bsr_f32_kernel<<<nout, mma_s8::NT, F_SMEM_BYTES, s>>>(
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
