// K1: read-summed class log-likelihoods of the posterior engine.
//
//     out[n, u] = sum_d log( w * a[n,d] + (1 - w) * r[n,d] + m[n,d] ),
//     w         = clip( psa[n,d] * nu[u] + kappa[u] * (1 - psa[n,d]), 0, 1 )
//
// Replaces varlociraptor_tpu/ops/pallas_kernels.py:_ll_classes_kernel (the
// Pallas TPU kernel behind ll_classes_pallas).  Rows n are (locus x bias
// combo); classes u are the unique (nu, kappa) points of the contaminated
// allele-frequency plane (or the plain grid, nu = af, kappa = [af == 1]).
// Masked reads arrive folded to (a, r, m) = (1, 1, 0), so they add log 1;
// the class-independent per-read scale is added by the caller.
//
// What bounds it on an H100: instruction issue, not memory.  At the bench
// shape (N = 131072 rows, U = 711 classes, D = 64 reads) it evaluates 6e9
// cells against 134 MB of inputs and 373 MB of output, and it never
// materialises the [N, U, D] cube (24 GB).  An accurate logf per cell (a
// MUFU lg2 plus range reduction), a float -> double conversion, a DADD and
// four shared-memory loads cost ~30 instructions per cell, which is what
// the first version of this kernel spent.
//
// Design, per cell ~7 instructions:
// * Register tiling over classes: a thread owns C classes x R rows; the 32
//   lanes of a warp own 32 C classes of the same R rows, so every staged
//   (a, r, m, psa) value is a shared-memory broadcast, read as float4 over
//   four reads, and serves C classes from registers.
// * One log per K reads: each term t is split into its biased exponent
//   (integer shift, summed exactly in an int) and its mantissa in [1, 2)
//   (integer mask), the K mantissas are multiplied (< 2^K, no overflow),
//   and one lg2.approx of the product is added per group.  The exponent sum
//   is folded into the sum once per staged chunk.
// * The read sum stays in double, promoted once per K-group: at depth 64
//   the sums reach ~600, where one float ulp is 6e-5.
// * The split needs every t to be a positive normal float.  w and 1 - w
//   are both in [0, 1] and one of them is >= 1/2, so t >= m and
//   t >= min(a, r) / 2: a chunk is taken on this path when every staged
//   read has m >= 2^-126 or min(a, r) >= 2^-125, and no input is negative,
//   NaN or above 2^120.  Otherwise (zero or denormal terms, which give -inf
//   or need the denormal range) the whole block takes the chunk on the
//   per-cell accurate logf path of the first version.  The choice is
//   block-uniform (__syncthreads_and), so no warp diverges.
// Accuracy: the K-1 float products round by up to (K-1) 6e-8 relative and
// lg2.approx is off by ~2^-22 absolute, so a group of 16 reads is within
// ~1.1e-6 of the exact sum and a depth-64 row within ~5e-6; the card no
// longer agrees with the CPU bit for bit (the limit is 5e-5 x max(1, |x|)).

#include <climits>
#include <cuda_runtime.h>

namespace {

// The tile: the fastest of the variants timed on an H100 (PERF.md, PR 4).
constexpr int C = 8;      // classes per thread
constexpr int R = 2;      // rows per thread
constexpr int K = 16;     // reads per log
constexpr int WARPS = 4;  // per block; each owns R rows of the row tile
constexpr int TILE_N = WARPS * R;
constexpr int TILE_U = 32 * C;
constexpr int D_CHUNK = 64;  // reads staged per pass
constexpr int LD = D_CHUNK + 4;  // staged row stride: keeps float4 alignment
constexpr float MIN_M = 1.17549435e-38f;    // 2^-126
constexpr float MIN_AR = 2.35098870e-38f;   // 2^-125
constexpr float MAX_IN = 1.32922800e+36f;   // 2^120
constexpr double LN2 = 0.69314718055994530942;

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one 16-byte shared-memory load into four registers
__device__ __forceinline__ void load4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ bool split_safe(float a, float r, float m, float p) {
  return a >= 0.0f && r >= 0.0f && m >= 0.0f && a <= MAX_IN && r <= MAX_IN &&
         m <= MAX_IN && fabsf(p) <= MAX_IN && (m >= MIN_M || fminf(a, r) >= MIN_AR);
}

__global__ void __launch_bounds__(32 * WARPS)
ll_classes_kernel(const float* __restrict__ a, const float* __restrict__ r,
                  const float* __restrict__ m, const float* __restrict__ psa,
                  const float* __restrict__ nu, const float* __restrict__ kappa,
                  float* __restrict__ out, int N, int U, int D, int u_tiles,
                  int mant_mask, int exp_one) {
  static_assert(K % 4 == 0 && D_CHUNK % K == 0, "K: multiple of 4 dividing D_CHUNK");
  __shared__ __align__(16) float s_a[TILE_N * LD];
  __shared__ __align__(16) float s_r[TILE_N * LD];
  __shared__ __align__(16) float s_m[TILE_N * LD];
  __shared__ __align__(16) float s_p[TILE_N * LD];

  // the class tile varies fastest: blocks of one row tile run together and
  // find its rows in L2
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = (blockIdx.x / u_tiles) * TILE_N;
  const int u0 = (blockIdx.x % u_tiles) * TILE_U;

  // w = clip(psa * (nu - kappa) + kappa, 0, 1)
  float dnk[C], kap[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int u = u0 + lane + 32 * c;
    const float nv = u < U ? nu[u] : 0.0f;
    kap[c] = u < U ? kappa[u] : 0.0f;
    dnk[c] = nv - kap[c];
  }

  double acc[R][C];
  int esum[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[i][c] = 0.0;
      esum[i][c] = 0;
    }

  for (int d0 = 0; d0 < D; d0 += D_CHUNK) {
    const int dlen = min(D_CHUNK, D - d0);
    __syncthreads();  // previous chunk fully consumed
    int safe = 1;
    for (int e = threadIdx.x; e < TILE_N * D_CHUNK; e += 32 * WARPS) {
      const int row = e / D_CHUNK;
      const int dd = e % D_CHUNK;
      const int n = n0 + row;
      float va = 1.0f, vr = 1.0f, vm = 0.0f, vp = 0.0f;  // log 1 = 0 padding
      if (n < N && dd < dlen) {
        const long long idx = (long long)n * D + d0 + dd;
        va = a[idx];
        vr = r[idx];
        vm = m[idx];
        vp = psa[idx];
        safe &= split_safe(va, vr, vm, vp);
      }
      s_a[row * LD + dd] = va;
      s_r[row * LD + dd] = vr;
      s_m[row * LD + dd] = vm;
      s_p[row * LD + dd] = vp;
    }
    if (__syncthreads_and(safe)) {
      // padding reads give t = 1 exactly: mantissa 1, biased exponent 127
      const int glen = (dlen + K - 1) / K * K;
      for (int g = 0; g < glen; g += K) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int base = (warp * R + i) * LD + g;
          float prod[C];
#pragma unroll
          for (int c = 0; c < C; ++c) prod[c] = 1.0f;
#pragma unroll
          for (int q = 0; q < K; q += 4) {
            float pa[4], pr[4], pm[4], pp[4];
            load4(pa, s_a + base + q);
            load4(pr, s_r + base + q);
            load4(pm, s_m + base + q);
            load4(pp, s_p + base + q);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int c = 0; c < C; ++c) {
                const float w = __saturatef(fmaf(pp[j], dnk[c], kap[c]));
                const float t = fmaf(w, pa[j], fmaf(1.0f - w, pr[j], pm[j]));
                const int bits = __float_as_int(t);
                esum[i][c] += bits >> 23;
                prod[c] *= __int_as_float((bits & mant_mask) | exp_one);
              }
          }
#pragma unroll
          for (int c = 0; c < C; ++c) acc[i][c] += (double)lg2_approx(prod[c]);
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          // acc holds log2 of the mantissas until here; ln at the end
          acc[i][c] += (double)(esum[i][c] - 127 * glen);
          esum[i][c] = 0;
        }
    } else {
      for (int dd = 0; dd < dlen; ++dd) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int k = (warp * R + i) * LD + dd;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float w = __saturatef(fmaf(s_p[k], dnk[c], kap[c]));
            const float t = fmaf(w, s_a[k], fmaf(1.0f - w, s_r[k], s_m[k]));
            acc[i][c] += (double)logf(t) * (1.0 / LN2);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int n = n0 + warp * R + i;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int u = u0 + lane + 32 * c;
      if (n < N && u < U) out[(long long)n * U + u] = (float)(acc[i][c] * LN2);
    }
  }
}

}  // namespace

// Plain C entry for ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  All pointers are device pointers to
// contiguous float32 arrays: a, r, m, psa [N, D]; nu, kappa [U]; out [N, U].
extern "C" int vlt_ll_classes(const float* a, const float* r, const float* m,
                              const float* psa, const float* nu,
                              const float* kappa, float* out, int N, int U,
                              int D, void* stream) {
  if (N <= 0 || U <= 0) return (int)cudaSuccess;
  const int u_tiles = (U + TILE_U - 1) / TILE_U;
  const long long blocks = (long long)((N + TILE_N - 1) / TILE_N) * u_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  ll_classes_kernel<<<(unsigned)blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      a, r, m, psa, nu, kappa, out, N, U, D, u_tiles,
      // the mantissa mask and the exponent of 1.0f as arguments: with both
      // in registers ptxas keeps (bits & mask) | one as one LOP3 per cell;
      // as immediates it splits it into two
      0x007fffff, 0x3f800000);
  return (int)cudaGetLastError();
}
