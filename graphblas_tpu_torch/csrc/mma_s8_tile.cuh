// The int8 tensor-core tile: one CUDA block of 256 threads (8 warps)
// accumulates a 128x128 int32 tile on mma.sync.m16n8k32.s8.s8.s32, in two
// forms.  A.B summed over a list of tile pairs (tile_accumulate_nn; one
// pair of any K is tile_product), with A row-major (k contiguous) and B
// k-major (n contiguous): the band ring (K1), the window count (K2) and
// the window product (K3), all in window.cu.  A.B^T summed over a list of
// tile pairs (tile_accumulate_nt), both operands k contiguous: the BSR
// tile-triple kernel's counting form (bsr.cu: K7).  masked_sum, the
// epilogue of K1 and K2, reduces the C fragment against an int8 mask tile
// to one block-wide integer.
//
// Why mma.sync and not wgmma: K3 at the Wathen 128 plan moves 350 MB of
// compulsory bytes (0.105 ms at 3.35 TB/s) for 40.8 G int8 operations,
// which mma.sync's int8 rate covers in ~0.04 ms, so the tile is bound by
// bytes and the warpgroup path would buy nothing the loads can use.
//
// Fragments: the mma wants four consecutive k of one row of A, or of one
// column of B, in a 32-bit register, which is what ldmatrix (b16, not
// transposed) gives from a tile whose rows hold k: one ldmatrix.x4 loads
// a warp's whole A fragment of one m16 x k32, or B's of two n8 x k32.
// Both tiles are n- (or m-) major with 64 k a row, their 16-byte groups
// XOR-swizzled by row so that each ldmatrix hits distinct banks.
//
// B's layout: in A.B, B is k-major, and ldmatrix.trans moves only 16-bit
// elements.  B's stage therefore lands in shared memory k-major (its
// 16-byte groups swizzled); each thread then reads a 4 (k) x 8 (n) byte
// block of it, transposes the two 4x4 byte blocks in registers with
// __byte_perm (prmt), and stores eight 4-k words, n-major, into the tile
// the mma reads.  A.B^T needs none of that: a row of B^T's tile is 128
// consecutive k of one output column, so B's stage is loaded and
// swizzled as A's is.  Both forms then multiply the same way.
//
// Pipeline: every global read is a 16-byte cp.async copy straight into
// shared memory, three stages of 64 k in a ring with two in flight while
// one is transposed and multiplied, so no register holds a load in flight
// and each block keeps 32 KB of reads outstanding.  In both list forms the
// ring runs across the pairs' stages and does not drain between pairs.
// Integer sums are exact: each product is at most 2^14 in magnitude, so
// K <= 2^16 fits int32.

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

// word offset of (row r, word kw) in a swizzled [128][KW] stage (A's
// tile, and B's as the mma reads it: n-major): the 16-byte group kw / 4
// moves to group (kw / 4) ^ ((r / 2) % 4) and stays whole, so the eight
// rows an ldmatrix reads hit eight distinct bank groups
__device__ __forceinline__ int a_off(int r, int kw) {
  return r * KW + (kw ^ (((r >> 1) & 3) << 2));
}
// word offset of (row k, word w) in B's raw k-major stage of 64 rows x 32
// words: the 16-byte group w / 4 moves to group (w / 4) ^ ((k / 4) % 8),
// so that transpose_b's reads of one row group spread over the banks
__device__ __forceinline__ int braw_off(int k, int w) {
  return 32 * k + ((((w >> 2) ^ (k >> 2)) & 7) << 2) + (w & 3);
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

// The four 8x8 b16 matrices at the rows the lanes address (lanes 8m ..
// 8m+7 give matrix m's rows, 16-byte aligned): r[m] is lane l's 4 bytes
// 4 (l % 4) .. +3 of matrix m's row l / 4.  On int8 tiles that is the mma
// fragment layout: four consecutive k of one row (A) or column (B).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const uint32_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((unsigned)__cvta_generic_to_shared(p)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

// One stage's copies, in flight as one commit group: A's 128 x 64 bytes
// into the swizzled tile As (rows (t + 256p) / 4, 16-byte group t % 4);
// B's 64 x 128 bytes k-major, row k's 16-byte groups swizzled (braw_off).
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
    cp_async16(Braw + braw_off(id >> 3, 4 * (id & 7)),
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

// Braw -> Bs: thread t takes k rows 4*(t % 16) + r (r < 4) and columns
// 8*(t / 16) .. +8, two 4x4 byte blocks, and stores eight 4-k words into
// the n-major tile Bs (swizzled as A's).  Both the 8-byte reads and the
// stores see at most two threads of a warp on one bank.
__device__ __forceinline__ void transpose_b(const uint32_t* Braw,
                                            uint32_t* Bs) {
  const int t = threadIdx.x;
  const int kg = t & 15, ng = t >> 4;
  uint2 b[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    b[r] = *reinterpret_cast<const uint2*>(Braw + braw_off(4 * kg + r,
                                                           2 * ng));
  uint32_t y[8];
  transpose4x4(b[0].x, b[1].x, b[2].x, b[3].x, y);
  transpose4x4(b[0].y, b[1].y, b[2].y, b[3].y, y + 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) Bs[a_off(8 * ng + j, kg)] = y[j];
}

// acc[mi][ni][*] += this warp's m16n8 tiles of one 64-k stage, from the
// swizzled tiles As (row r: 64 k of A's row r) and Bs (row n: 64 k of B's
// column n).  Each ldmatrix.x4 brings a whole fragment: A's m16 x k32 for
// one mi (matrices: rows 0-7 and 8-15, k 0-15 and 16-31), or B's k32 x
// n8 for two ni (matrices: k 0-15 and 16-31 of columns 8 ni .. +7, then
// of the next eight).
__device__ __forceinline__ void multiply_stage(const uint32_t* As,
                                               const uint32_t* Bs,
                                               int (&acc)[2][8][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ra = (warp & 3) * WM + (lane & 15), ka = 4 * (lane >> 4);
  const int nb = (warp >> 2) * WN + (lane & 7) + 8 * (lane >> 4);
  const int kb = 4 * ((lane >> 3) & 1);
#pragma unroll
  for (int ks = 0; ks < KW; ks += 8) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldsm4(a[mi], As + a_off(ra + 16 * mi, ks + ka));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm4(b, Bs + a_off(nb + 16 * np, ks + kb));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma16832(acc[mi][2 * np], a[mi], b[0], b[1]);
        mma16832(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// shared memory of the tile: STAGES raw stages (A swizzled, B k-major)
// and one transposed B tile, 56 KB
constexpr int STAGES = 3;
constexpr int SMEM_BYTES = 4 * (STAGES * (BM * KW + KC * BN / 4) + BN * KW);

// The block's 128x128 tile of sum_q A_q . B_q over npairs pairs, from
// zero: A_q (128 x K, row r at A_q + r*lda) and B_q (K x 128, row k at B_q
// + k*ldb), K a multiple of KC, every base 16-byte aligned and lda, ldb
// multiples of 16.  ``pair(q, a, b)`` sets the q-th pair's base pointers.
// Stage g is pair g / (K / KC) at k0 = (g % (K / KC)) * KC, and every
// pair's stages run through one ring of STAGES.  ``smem``: SMEM_BYTES of
// dynamic shared memory, 16-byte aligned.  Thread (warp w, lane) holds,
// for mi < 2, ni < 8: acc[mi][ni][h] at row 32*(w%4) + 16*mi + lane/4 +
// 8*(h/2), column 64*(w/4) + 8*ni + 2*(lane%4) + h%2 (the mma C fragment).
template <class Pair>
__device__ void tile_accumulate_nn(const Pair& pair, int npairs, long lda,
                                   long ldb, int K, uint32_t* smem,
                                   int (&acc)[2][8][4]) {
  constexpr int A_WORDS = BM * KW, B_WORDS = KC * BN / 4;
  uint32_t* const Bs = smem + STAGES * (A_WORDS + B_WORDS);
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
    uint32_t* st = smem + (g % STAGES) * (A_WORDS + B_WORDS);
    copy_stage(a, lda, b, ldb, (g % nkc) * KC, st, st + A_WORDS);
  };
#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g) {
    if (g < nst) issue(g);
    commit();
  }
  for (int g = 0; g < nst; ++g) {
    // stage g has landed (every thread's copies, after the barrier), and
    // every warp is done with stage g-1: its slot and Bs are free
    wait_groups<STAGES - 2>();
    __syncthreads();
    if (g + STAGES - 1 < nst) issue(g + STAGES - 1);
    commit();
    uint32_t* cur = smem + (g % STAGES) * (A_WORDS + B_WORDS);
    transpose_b(cur + A_WORDS, Bs);
    __syncthreads();
    multiply_stage(cur, Bs, acc);
  }
  wait_groups<0>();  // no copy of this thread outlives the call
}

// The block's 128x128 tile of A.B, from zero: tile_accumulate_nn over the
// one pair (A, B) of contraction length K (the window product, K3).
__device__ void tile_product(const int8_t* __restrict__ A, long lda,
                             const int8_t* __restrict__ B, long ldb, int K,
                             uint32_t* smem, int (&acc)[2][8][4]) {
  const auto one = [&](int, const int8_t*& a, const int8_t*& b) {
    a = A;
    b = B;
  };
  tile_accumulate_nn(one, 1, lda, ldb, K, smem, acc);
}

// shared memory of an int8 mask tile, after the tile's SMEM_BYTES
constexpr int MASK_BYTES = BM * BN;

// Starts copying the int8 mask tile Msk (row r at Msk + r*ldm; Msk 16-byte
// aligned, ldm a multiple of 16) into Ms (MASK_BYTES of shared memory,
// 16-byte aligned): row r at byte 128 r, its 16-byte chunk c at chunk c ^
// (r % 8), so that masked_sum's reads hit distinct banks.  The copies
// join the next commit group, so a mask started before
// tile_accumulate_nn lands with the first stage.
__device__ __forceinline__ void copy_mask(const int8_t* __restrict__ Msk,
                                          long ldm, uint32_t* Ms) {
#pragma unroll
  for (int p = 0; p < MASK_BYTES / 16 / NT; ++p) {
    const int id = threadIdx.x + NT * p;
    const int r = id >> 3, c = id & 7;
    cp_async16(Ms + 32 * r + 4 * (c ^ (r & 7)), Msk + (long)r * ldm + 16 * c);
  }
}

// Block-wide sum over the 128x128 tile of acc (the C fragment above) times
// the int8 mask tile that copy_mask put in Ms, each accumulator
// multiplied by its mask byte as a signed integer.  A thread's two
// accumulators of one row sit in adjacent columns, so it reads their mask
// bytes as one 2-byte word.  Then a shuffle sum in each warp and a sum
// across the 8 warps in shared memory; every thread must call it after
// the mask's copies have landed and a barrier, and the result is valid in
// thread 0.  Integer sums are exact in any order.
__device__ __forceinline__ int masked_sum(const int (&acc)[2][8][4],
                                          const uint32_t* Ms) {
  __shared__ int red[NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned char* mb = reinterpret_cast<const unsigned char*>(Ms);
  const int c0 = 64 * (warp >> 2) + 2 * (lane & 3);
  int s = 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 32 * (warp & 3) + 16 * mi + 8 * hh + (lane >> 2);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int c = c0 + 8 * ni;
        const unsigned w = *reinterpret_cast<const unsigned short*>(
            mb + 128 * r + 16 * ((c >> 4) ^ (r & 7)) + (c & 15));
        s += acc[mi][ni][2 * hh] * (int)(signed char)(w & 0xffu)
           + acc[mi][ni][2 * hh + 1] * (int)(signed char)(w >> 8);
      }
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  s = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += red[w];
  }
  return s;
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
    multiply_stage(cur, cur + WORDS, acc);
  }
}

}  // namespace mma_s8
}  // namespace
