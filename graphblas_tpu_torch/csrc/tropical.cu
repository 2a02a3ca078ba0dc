// Dense tropical (min/max-semiring) matrix product over float32:
//   c[i][j] = ADD over k of MULT(a[i][k], b[k][j])
// for row-major a (m, k), b (k, n), c (m, n), with ADD in {min, max} and
// MULT in {plus, times, min, max}: the six pairs of TROPICAL_PAIRS.
//
// Replaces graphblas_tpu/sparse/pallas_tropical.py::_tropical_launch (the
// Pallas kernel _make_kernel, pallas_call at pallas_tropical.py:116).  The
// TPU kernel walked a sequential (i, j, k) grid of 128^3 tile triples and
// carried the accumulator tile across the k steps in its revisited output
// block, with inputs padded to whole tiles by values that yield the add
// identity.  Here one CUDA block owns a 128x128 output tile and loops over
// k itself, so nothing carries between blocks, and no input is padded: the
// block guards m, k and n and stages NaN for every element past an edge.
//
// Semantics.  ADD is fminf/fmaxf, and MIN/MAX as MULT are fminf/fmaxf too:
// C's NaN-ignoring minimum and maximum (PTX min.f32/max.f32), never a
// NaN-propagating compare.  The accumulator starts at the add identity
// (+inf for min, -inf for max) and a NaN term leaves it as it is, so:
// an absent entry that the caller filled with the add identity contributes
// either the identity or NaN (+inf + -inf), and both are ignored; a NaN
// stored value is ignored, as the reference's fminf-based monoids ignore it;
// and the NaN staged past an edge is ignored.  PLUS and TIMES are single
// correctly rounded float32 adds and multiplies (__fadd_rn/__fmul_rn: no
// contraction into an FMA, which could not happen anyway since nothing is
// accumulated by addition).  Min and max are exact, so the result equals
// any other order of the same fold, bit for bit up to the sign of a zero.
//
// What bounds it on the card: operations.  Every (i, j, k) costs one MULT
// and one ADD instruction on the CUDA cores (no tensor core computes a
// min-plus product); the bytes (a, b read once, c written once) are far
// below that at any square size past a few hundred.  Min and max have a
// lower throughput than float add on the CUDA cores, so a bound that
// prices both at the float32 rate is optimistic.
//
// What this simple design does about it: the classic register-blocked
// SGEMM shape.  256 threads per 128x128 output tile, each thread an 8x8
// register micro-tile (64 accumulators), k staged 16 at a time through
// shared memory (a transposed, b as is) so each thread reads 8 a values
// and 8 b values per k as four 16-byte shared loads and does 128
// operations with them.  Double buffering, cp.async or TMA staging and a
// persistent schedule are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // output rows per block
constexpr int BN = 128;          // output columns per block
constexpr int BK = 16;           // k per shared-memory stage
constexpr int NT = 256;          // threads: 16 x 16, each 8 rows x 8 cols
constexpr int APAD = 4;          // keeps the transposing stores spread

enum Mult { kPlus = 0, kTimes = 1, kMin = 2, kMax = 3 };

template <bool ADD_MAX>
__device__ __forceinline__ float add_op(float x, float y) {
  return ADD_MAX ? fmaxf(x, y) : fminf(x, y);
}

template <int MULT>
__device__ __forceinline__ float mult_op(float x, float y) {
  if (MULT == kPlus) return __fadd_rn(x, y);
  if (MULT == kTimes) return __fmul_rn(x, y);
  if (MULT == kMin) return fminf(x, y);
  return fmaxf(x, y);
}

template <bool ADD_MAX, int MULT>
__global__ void __launch_bounds__(NT)
tropical_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ c, int m, int k, int n) {
  // As[kk][r] = a[row0 + r][k0 + kk]; Bs[kk][col] = b[k0 + kk][col0 + col]
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int64_t row0 = (int64_t)blockIdx.y * BM;
  const int64_t col0 = (int64_t)blockIdx.x * BN;
  const float ident = ADD_MAX ? -INFINITY : INFINITY;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = ident;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // a: thread t stages column kk = t % 16 of rows t/16 + 16*p (a warp
    // reads two 64-byte row segments per load)
#pragma unroll
    for (int p = 0; p < (BM * BK) / NT; ++p) {
      const int r = t / BK + (NT / BK) * p, kk = t % BK;
      const int64_t gr = row0 + r;
      const int gk = k0 + kk;
      As[kk][r] = (gr < m && gk < k) ? a[gr * k + gk] : NAN;
    }
    // b: thread t stages column t % 128 of k rows t/128 + 2*p (a warp
    // reads one 128-byte row segment per load)
#pragma unroll
    for (int p = 0; p < (BN * BK) / NT; ++p) {
      const int kk = t / BN + (NT / BN) * p, cc = t % BN;
      const int gk = k0 + kk;
      const int64_t gc = col0 + cc;
      Bs[kk][cc] = (gk < k && gc < n) ? b[(int64_t)gk * n + gc] : NAN;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      // rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; columns likewise by tx
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = add_op<ADD_MAX>(acc[i][j], mult_op<MULT>(av[i], bv[j]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t gr = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t gc = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gc < n) c[gr * n + gc] = acc[i][j];
    }
  }
}

template <bool ADD_MAX, int MULT>
void launch(const float* a, const float* b, float* c, int m, int k, int n,
            cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  tropical_kernel<ADD_MAX, MULT><<<grid, NT, 0, stream>>>(a, b, c, m, k, n);
}

}  // namespace

// a (m, k), b (k, n), c (m, n): contiguous float32, every element of c
// written.  add_max: 0 for MIN, 1 for MAX; mult: 0 PLUS, 1 TIMES, 2 MIN,
// 3 MAX, one of the six pairs MIN_PLUS, MIN_TIMES, MIN_MAX, MAX_PLUS,
// MAX_TIMES, MAX_MIN.  Another pair, or more than 65535 row tiles, returns
// cudaErrorInvalidValue without a launch.
extern "C" int gb_tropical_mm(const void* a, const void* b, void* c, int m,
                              int k, int n, int add_max, int mult,
                              void* stream) {
  if (add_max < 0 || add_max > 1 || mult < 0 || mult > 3 ||
      (m + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (m > 0 && n > 0) {
    const float* A = (const float*)a;
    const float* B = (const float*)b;
    float* C = (float*)c;
    cudaStream_t s = (cudaStream_t)stream;
    switch (add_max * 4 + mult) {
      case 0: launch<false, kPlus>(A, B, C, m, k, n, s); break;
      case 1: launch<false, kTimes>(A, B, C, m, k, n, s); break;
      case 3: launch<false, kMax>(A, B, C, m, k, n, s); break;
      case 4: launch<true, kPlus>(A, B, C, m, k, n, s); break;
      case 5: launch<true, kTimes>(A, B, C, m, k, n, s); break;
      case 6: launch<true, kMin>(A, B, C, m, k, n, s); break;
      default: return (int)cudaErrorInvalidValue;  // MIN_MIN, MAX_MAX
    }
  }
  return (int)cudaGetLastError();
}
