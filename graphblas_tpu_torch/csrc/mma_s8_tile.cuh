// The int8 tensor-core tile: one CUDA block of 256 threads (8 warps)
// accumulates a 128x128 int32 tile on mma.sync.m16n8k32.s8.s8.s32, in two
// forms.  A.B (tile_product), with A row-major (k contiguous) and B
// k-major (n contiguous): the window product kernel (window.cu: K3).
// A.B^T summed over a list of tile pairs (tile_accumulate_nt), both
// operands k contiguous: the BSR tile-triple kernel's counting form
// (bsr.cu: K7).  K1 and K2 still run the __dp4a tile of dp4a_tile.cuh.
//
// Why mma.sync and not wgmma: K3 at the Wathen 128 plan moves 350 MB of
// compulsory bytes (0.105 ms at 3.35 TB/s) for 40.8 G int8 operations,
// which mma.sync's int8 rate covers in ~0.04 ms, so the tile is bound by
// bytes and the warpgroup path would buy nothing the loads can use.
//
// B's layout: the "col" B fragment of the int8 mma wants 4 consecutive k of
// one column in a 32-bit register, but B is k-major, and ldmatrix.trans
// moves only 16-bit elements.  B's stage therefore lands in shared memory
// as it lies; each thread then reads a 4 (k) x 8 (n) byte block of it,
// transposes the two 4x4 byte blocks in registers with __byte_perm
// (prmt), and stores eight 4-k words, n-major, into the tile the mma
// reads.  The A tile and the transposed B tile are XOR-swizzled by row so
// that the fragment reads (8 rows x 4 words per warp) hit 32 distinct
// banks.
//
// A.B^T needs none of that: a row of B^T's tile is 128 consecutive k of
// one output column, which is the "col" fragment's own layout, so B's
// stage is loaded and swizzled as A's is and its fragment reads mirror
// A's (four 4-k words of one column per thread).
//
// Pipeline: every global read is a 16-byte cp.async copy straight into
// shared memory, three stages of 64 k in a ring with two in flight while
// one is transposed and multiplied, so no register holds a load in flight
// and each block keeps 32 KB of reads outstanding.  Integer sums are
// exact: each product is at most 2^14 in magnitude, so K <= 2^16 fits
// int32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace mma_s8 {

constexpr int BM = 128;         // tile rows
constexpr int BN = 128;         // tile columns
constexpr int KC = 64;          // contraction bytes per shared-memory stage
constexpr int KW = KC / 4;      // 4-byte words per tile row per stage
constexpr int NT = 256;         // threads: 8 warps, 4 (rows) x 2 (columns)
constexpr int WM = 32;          // rows per warp: two m16 tiles
constexpr int WN = 64;          // columns per warp: eight n8 tiles

// word offset of (row r, word kw) in a swizzled [128][KW] stage; A keeps
// the low two bits of kw, so its 16-byte groups stay whole
__device__ __forceinline__ int a_off(int r, int kw) {
  return r * KW + (kw ^ (((r >> 1) & 3) << 2));
}
__device__ __forceinline__ int b_off(int n, int kw) {
  return n * KW + (kw ^ ((((n >> 1) & 3) << 2) ^ ((n >> 3) & 15)));
}

// 4x4 byte transpose: y[j] byte r = x[r] byte j
__device__ __forceinline__ void transpose4x4(uint32_t x0, uint32_t x1,
                                             uint32_t x2, uint32_t x3,
                                             uint32_t* y) {
  const uint32_t t0 = __byte_perm(x0, x1, 0x5140);
  const uint32_t t1 = __byte_perm(x0, x1, 0x7362);
  const uint32_t t2 = __byte_perm(x2, x3, 0x5140);
  const uint32_t t3 = __byte_perm(x2, x3, 0x7362);
  y[0] = __byte_perm(t0, t2, 0x5410);
  y[1] = __byte_perm(t0, t2, 0x7632);
  y[2] = __byte_perm(t1, t3, 0x5410);
  y[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void mma16832(int (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

// One stage's copies, in flight as one commit group: A's 128 x 64 bytes
// into the swizzled tile As (rows (t + 256p) / 4, 16-byte group t % 4);
// B's 64 x 128 bytes as they lie (row k at Braw + 128 k).
__device__ __forceinline__ void copy_stage(const int8_t* __restrict__ A,
                                           long lda,
                                           const int8_t* __restrict__ B,
                                           long ldb, int k0, uint32_t* As,
                                           uint32_t* Braw) {
  const int t = threadIdx.x;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int id = t + NT * p;
    cp_async16(As + a_off(id >> 2, 4 * (id & 3)),
               A + (long)(id >> 2) * lda + k0 + 16 * (id & 3));
    cp_async16(Braw + 32 * (id >> 3) + 4 * (id & 7),
               B + (long)(k0 + (id >> 3)) * ldb + 16 * (id & 7));
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's commit groups are in flight.
template <int n>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

// Braw -> Bs: thread t takes k rows 4*(t / 16) + r (r < 4) and columns
// 8*(t % 16) .. +8, two 4x4 byte blocks, and stores eight 4-k words.
__device__ __forceinline__ void transpose_b(const uint32_t* Braw,
                                            uint32_t* Bs) {
  const int t = threadIdx.x;
  const int ng = t & 15, kg = t >> 4;
  uint2 b[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    b[r] = *reinterpret_cast<const uint2*>(Braw + 32 * (4 * kg + r) + 2 * ng);
  uint32_t y[8];
  transpose4x4(b[0].x, b[1].x, b[2].x, b[3].x, y);
  transpose4x4(b[0].y, b[1].y, b[2].y, b[3].y, y + 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) Bs[b_off(8 * ng + j, kg)] = y[j];
}

// acc[mi][ni][*] += this warp's m16n8 tiles of one 64-k stage
__device__ __forceinline__ void multiply_stage(const uint32_t* As,
                                               const uint32_t* Bs,
                                               int (&acc)[2][8][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = (warp & 3) * WM, n0 = (warp >> 2) * WN;
#pragma unroll
  for (int ks = 0; ks < KW; ks += 8) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = r0 + 16 * mi + g;
      a[mi][0] = As[a_off(r, ks + tq)];
      a[mi][1] = As[a_off(r + 8, ks + tq)];
      a[mi][2] = As[a_off(r, ks + 4 + tq)];
      a[mi][3] = As[a_off(r + 8, ks + 4 + tq)];
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int n = n0 + 8 * ni + g;
      const uint32_t b0 = Bs[b_off(n, ks + tq)];
      const uint32_t b1 = Bs[b_off(n, ks + 4 + tq)];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma16832(acc[mi][ni], a[mi], b0, b1);
    }
  }
}

// shared memory of the tile: STAGES raw stages (A swizzled, B as it
// lies) and one transposed B tile, 56 KB
constexpr int STAGES = 3;
constexpr int SMEM_BYTES = 4 * (STAGES * (BM * KW + KC * BN / 4) + BN * KW);

// The block's 128x128 tile of A.B, from zero, K a multiple of KC: A row r
// at A + r*lda, B row k at B + k*ldb (columns 0..127 of it), both 16-byte
// aligned with lda, ldb multiples of 16; ``smem``: SMEM_BYTES of dynamic
// shared memory, 16-byte aligned.  Thread (warp w, lane) holds, for
// mi < 2, ni < 8: acc[mi][ni][h] at row 32*(w%4) + 16*mi + lane/4 + 8*(h/2),
// column 64*(w/4) + 8*ni + 2*(lane%4) + h%2 (the mma C fragment).
__device__ void tile_product(const int8_t* __restrict__ A, long lda,
                             const int8_t* __restrict__ B, long ldb, int K,
                             uint32_t* smem, int (&acc)[2][8][4]) {
  constexpr int A_WORDS = BM * KW, B_WORDS = KC * BN / 4;
  uint32_t* const Bs = smem + STAGES * (A_WORDS + B_WORDS);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[mi][ni][h] = 0;
  const int nk = K / KC;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      uint32_t* st = smem + s * (A_WORDS + B_WORDS);
      copy_stage(A, lda, B, ldb, s * KC, st, st + A_WORDS);
    }
    commit();
  }
  for (int kk = 0; kk < nk; ++kk) {
    // stage kk has landed (every thread's copies, after the barrier), and
    // every warp is done with stage kk-1: its slot and Bs are free
    wait_groups<STAGES - 2>();
    __syncthreads();
    const int nxt = kk + STAGES - 1;
    if (nxt < nk) {
      uint32_t* st = smem + (nxt % STAGES) * (A_WORDS + B_WORDS);
      copy_stage(A, lda, B, ldb, nxt * KC, st, st + A_WORDS);
    }
    commit();
    uint32_t* cur = smem + (kk % STAGES) * (A_WORDS + B_WORDS);
    transpose_b(cur + A_WORDS, Bs);
    __syncthreads();
    multiply_stage(cur, Bs, acc);
  }
}

// ---------------------------------------------------------------------------
// A.B^T over a list of tile pairs (K7's counting form)

// One stage's copies for A.B^T: A's and B's 128 rows x 64 bytes (k
// contiguous, row r at X + r*ld) into the swizzled tiles As and Bs.
__device__ __forceinline__ void copy_stage_nt(const int8_t* __restrict__ A,
                                              const int8_t* __restrict__ B,
                                              long ld, int k0, uint32_t* As,
                                              uint32_t* Bs) {
  const int t = threadIdx.x;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int id = t + NT * p;
    const int r = id >> 2, c = id & 3;
    cp_async16(As + a_off(r, 4 * c), A + (long)r * ld + k0 + 16 * c);
    cp_async16(Bs + a_off(r, 4 * c), B + (long)r * ld + k0 + 16 * c);
  }
}

// acc[mi][ni][*] += this warp's m16n8 tiles of one 64-k stage of A.B^T:
// B's fragment is four consecutive k of column n, word (n, ks + tq) of
// the tile, swizzled as A's rows are.
__device__ __forceinline__ void multiply_stage_nt(const uint32_t* As,
                                                  const uint32_t* Bs,
                                                  int (&acc)[2][8][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = (warp & 3) * WM, n0 = (warp >> 2) * WN;
#pragma unroll
  for (int ks = 0; ks < KW; ks += 8) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = r0 + 16 * mi + g;
      a[mi][0] = As[a_off(r, ks + tq)];
      a[mi][1] = As[a_off(r + 8, ks + tq)];
      a[mi][2] = As[a_off(r, ks + 4 + tq)];
      a[mi][3] = As[a_off(r + 8, ks + 4 + tq)];
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int n = n0 + 8 * ni + g;
      const uint32_t b0 = Bs[a_off(n, ks + tq)];
      const uint32_t b1 = Bs[a_off(n, ks + 4 + tq)];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma16832(acc[mi][ni], a[mi], b0, b1);
    }
  }
}

// shared memory of the A.B^T tile: STAGES stages of A and B, 48 KB
constexpr int SMEM_NT_BYTES = 4 * STAGES * (BM * KW + BN * KW);

// The block's 128x128 tile of sum_i A_i . B_i^T over npairs pairs of
// 128 x K int8 tiles (K a multiple of KC; row r of a tile at X + r*ld,
// 16-byte aligned, ld a multiple of 16), from zero.  ``pair(i, a, b)``
// sets the i-th pair's base pointers.  The stages of every pair run
// through one ring of STAGES: stage g is pair g / (K / KC), k0 = (g %
// (K / KC)) * KC, so the ring does not drain between pairs.  ``smem``:
// SMEM_NT_BYTES of dynamic shared memory, 16-byte aligned.  acc's layout
// is tile_product's.
template <class Pair>
__device__ void tile_accumulate_nt(const Pair& pair, int npairs, long ld,
                                   int K, uint32_t* smem,
                                   int (&acc)[2][8][4]) {
  constexpr int WORDS = BM * KW;          // one operand's stage (BN == BM)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[mi][ni][h] = 0;
  const int nkc = K / KC;
  const int nst = npairs * nkc;
  auto issue = [&](int g) {
    const int8_t* a;
    const int8_t* b;
    pair(g / nkc, a, b);
    uint32_t* st = smem + (g % STAGES) * 2 * WORDS;
    copy_stage_nt(a, b, ld, (g % nkc) * KC, st, st + WORDS);
  };
#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g) {
    if (g < nst) issue(g);
    commit();
  }
  for (int g = 0; g < nst; ++g) {
    // stage g has landed (every thread's copies, after the barrier), and
    // every warp is done with stage g-1, whose slot the next copy takes
    wait_groups<STAGES - 2>();
    __syncthreads();
    if (g + STAGES - 1 < nst) issue(g + STAGES - 1);
    commit();
    const uint32_t* cur = smem + (g % STAGES) * 2 * WORDS;
    multiply_stage_nt(cur, cur + WORDS, acc);
  }
}

}  // namespace mma_s8
}  // namespace
