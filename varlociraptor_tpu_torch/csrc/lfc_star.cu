// The posterior engine's star l2fc integral: two samples a and b, both
// contaminated by one root p, under the log mask lm of an l2fc predicate on
// (a, b), for every (l, b) of one branch in one launch.
//
//     total[l,b] = log sum_{g, ga, gb} exp( fa[l,b,ga,g] + fb[l,b,gb,g]
//                                           + lm[ga,gb] + rp[l,b,g] )
//     fa = pa[l,b,ga,g] + wa[l,ga],  fb = pb[l,b,gb,g] + wb[l,gb]
//
// It stands in for the lax.scan over the parent grid of the JAX package's
// PosteriorEngine (varlociraptor_tpu/ops/posterior.py:1228-1280), which XLA
// compiles: no Pallas kernel exists for it, so this replaces none.  In eager
// PyTorch the scan was a loop of Gp steps, each building and reducing an
// [L, B, Ga, Gb] slab (ops/lfc_star.py:lfc_star_reference, its plain twin).
//
// What bounds it on an H100: the exponentials, one a joint cell, masked
// cells included, at 16 an SM a clock (measured 15.4-16.0 with nothing
// else to do).  The l2fc call's branch is 8,192 items (l, b) of 11 x 101 x
// 101 cells, 0.92e9 exponentials, 0.22 ms; this design takes ~0.355 ms
// there (PERF.md).  The inputs are read once; nothing of the joint grid
// is written.
//
// Design:
// * A block is resident for the whole launch (three an SM) and walks over
//   groups of R items.  The mask is staged once a block as weights exp(lm)
//   (0 where lm is -inf), padded with zeros.
// * Per group, the raw rows fa[.., g] and fb[.., g] go from pa, wa, pb and
//   wb (fa and fb are never built in device memory) into shared memory, a
//   thread an (item, x) with its g values in flight.  A half warp then
//   takes a row's maximum (sa[g], sb[g]) and leaves the row less it in
//   log2 units; a warp an item takes c[g] = rp[g] + sa[g] + sb[g] and the
//   shift max_g c[g], a bound on every cell when lm <= 0, and keeps the
//   offsets (c[g] - shift) log2 e of its a rows.  Values are <= 0, -inf
//   where a factor is -inf and past the grid (Ga and Gb padded to TILE).
// * A thread owns a TILE x TILE register tile of (ga, gb) of one item, a
//   "unit", with its 16 mask weights, and walks the g rows: per g two
//   16-byte loads and one offset, then a cell is one add, one ex2.approx
//   and one FMA with its weight, so shared memory serves a sixteenth of a
//   float a cell.  Units (item, tile) are flattened across the block's
//   threads: the 676 tiles of 101 x 101 fill 2,028 of 2,048 slots of three
//   items, where 128-wide padding would idle 21% of the lanes.
// * Each thread adds its units into its slot of its item; a warp an item
//   sums the slots in a fixed order: total = shift + log(sum).  Where the
//   cheap shift leaves the sum below 2^-60 (the mask cut the cells near the
//   bound) or overflows, or any lm is above 0, the item is redone by the
//   whole block with the exact maximum of its cells and accurate expf, so
//   that no term the plain version keeps underflows.
// * Shapes that do not fit three blocks an SM: g in chunks (the sums of
//   earlier chunks rescaled when a later chunk raises the shift), and the
//   mask in strips of TILE rows, re-staged per group.  Float32 throughout;
//   the order of summation and ex2.approx (2 ulp) are the only differences
//   from the plain version.
// * Tried on the card and slower: the bounds pass reading device memory
//   directly (0.48 ms), a thread a row for the maxima (0.40), more rows in
//   flight a thread when staging (register spills, 0.36-0.37).

#include <algorithm>
#include <cfloat>
#include <climits>
#include <cstddef>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 4;                  // a thread's (ga, gb) register tile
constexpr int RMAX = 8;                  // items a block stages at most
constexpr int OFFS = 5;                  // an item's row offsets: pa, wa, pb, wb, rp
constexpr int GB = 12;                   // g values a thread loads in flight
constexpr int MB = 8;                    // mask values a thread loads in flight
constexpr int XR = 7;                    // row values a lane keeps in registers
constexpr int SMEM_MAX = 75 * 1024;      // three blocks an SM
constexpr float LOG2E = 1.4426950408889634f;
constexpr float REDO_BELOW = 8.6736174e-19f;  // 2^-60
constexpr unsigned FULL = 0xffffffffu;
static_assert(RMAX <= WARPS, "a warp an item in the closing sums");

struct Plane {  // one sample's pair plane p[l, b, x, g] + w[l, x]
  const float* p;
  const float* w;
  long long pl, pb, px, pg, wl, wx;  // strides, in elements
  int G;                             // x's size
  int Gpad;                          // G rounded up to TILE
};

struct Args {
  Plane A, Bq;
  const float* lm;
  const float* rp;
  float* out;
  long long lma, lmb;        // lm [Ga, Gb] strides
  long long rpl, rpb, rpg;   // rp [L, B, Gp] strides
  long long rows;            // L * B
  long long groups;          // ceil(rows / R)
  int B, Gp;
  int TA, TB;                // tiles along ga and gb
  // the tiling (tiling() below)
  int R;                     // items a group
  int gc, gchunks;           // g rows staged a chunk, and chunks
  int mt, mchunks;           // mask strips (TILE rows each) a chunk, and chunks
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float plane_at(const Plane& P, long long l, long long b, int x,
                                          int g) {
  return P.p[l * P.pl + b * P.pb + x * P.px + g * P.pg] + P.w[l * P.wl + x * P.wx];
}

__device__ __forceinline__ float mask_at(const Args& a, int x, int y) {
  return a.lm[x * a.lma + y * a.lmb];
}

// the max (op: 1) or the sum (op: 0) over a warp, in a fixed order; every
// lane gets it
__device__ __forceinline__ float warp_reduce(float v, int op) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float w = __shfl_xor_sync(FULL, v, o);
    v = op ? fmaxf(v, w) : v + w;
  }
  return v;
}

// the max (op: 1) or the sum (op: 0) of one value a thread over the block,
// in a fixed order; every thread gets it.  sRed: WARPS floats.
__device__ float block_reduce(float v, float* sRed, int op) {
  v = warp_reduce(v, op);
  if ((threadIdx.x & 31) == 0) sRed[threadIdx.x >> 5] = v;
  __syncthreads();
  v = sRed[0];
  for (int w = 1; w < WARPS; ++w) v = op ? fmaxf(v, sRed[w]) : v + sRed[w];
  __syncthreads();
  return v;
}

// One item by the whole block, from the inputs in device memory: the exact
// maximum of its cells, then the sum of expf over it (as _lse does)
__device__ void exact_item(const Args& a, long long row, float* sRed) {
  const long long l = row / a.B, b = row - l * a.B;
  const int Ga = a.A.G, Gb = a.Bq.G;
  const long long n = (long long)a.Gp * Ga * Gb;
  auto cell = [&](long long i) {
    const int g = (int)(i / ((long long)Ga * Gb));
    const int rem = (int)(i - (long long)g * Ga * Gb), x = rem / Gb, y = rem - x * Gb;
    return plane_at(a.A, l, b, x, g) + plane_at(a.Bq, l, b, y, g) + mask_at(a, x, y) +
           a.rp[l * a.rpl + b * a.rpb + g * a.rpg];
  };
  float m = -CUDART_INF_F;
  for (long long i = threadIdx.x; i < n; i += THREADS) m = fmaxf(m, cell(i));
  m = block_reduce(m, sRed, 1);
  float res = m;  // every cell -inf (or one +inf): the max itself
  if (m > -CUDART_INF_F && m < CUDART_INF_F) {
    float s = 0.0f;
    for (long long i = threadIdx.x; i < n; i += THREADS) s += expf(cell(i) - m);
    res = m + logf(block_reduce(s, sRed, 0));
  }
  if (threadIdx.x == 0) a.out[row] = res;
}

// Mask strips [mc * mt, mc * mt + mt) as weights exp(lm), zero past the
// grid, MB loads a thread in flight (the addresses clamped into the mask);
// returns whether any lm it read is above 0 (or NaN)
__device__ int stage_mask(const Args& a, float* sM, int mc) {
  const int Gbp = a.Bq.Gpad, x0 = mc * a.mt * TILE, n = a.mt * TILE * Gbp;
  int bad = 0;
  for (int i0 = threadIdx.x; i0 < n; i0 += THREADS * MB) {
    float v[MB];
#pragma unroll
    for (int k = 0; k < MB; ++k) {
      const int i = min(i0 + k * THREADS, n - 1), lr = i / Gbp, y = i - lr * Gbp;
      v[k] = mask_at(a, min(x0 + lr, a.A.G - 1), min(y, a.Bq.G - 1));
    }
#pragma unroll
    for (int k = 0; k < MB; ++k) {
      const int i = i0 + k * THREADS, lr = i / Gbp, y = i - lr * Gbp;
      if (i >= n) break;
      const float m = (x0 + lr < a.A.G && y < a.Bq.G) ? v[k] : -CUDART_INF_F;
      bad |= !(m <= 0.0f);
      sM[i] = m <= 0.0f ? expf(m) : 0.0f;  // bad sends every item to exact_item
    }
  }
  return __syncthreads_or(bad);
}

// One side's raw rows of a chunk, f = p + w for x < G and -inf past it,
// from device memory into s [R, gc, Gpad]: a thread an (item, x), its
// gn values of g GB at a time, all GB loads in flight (the addresses
// clamped into the plane); neighbouring threads on neighbouring x
__device__ __forceinline__ void stage_rows(const Plane& P, const long long* sOff, int side,
                                           float* s, int gc, int nr, int g0, int gn) {
  for (int t = threadIdx.x; t < nr * P.Gpad; t += THREADS) {
    const int r = t / P.Gpad, x = t - r * P.Gpad;
    float* dst = s + r * gc * P.Gpad + x;
    if (x >= P.G) {
      for (int gi = 0; gi < gn; ++gi) dst[gi * P.Gpad] = -CUDART_INF_F;
      continue;
    }
    const float* src = P.p + sOff[r * OFFS + 2 * side] + x * P.px + g0 * P.pg;
    const float w = P.w[sOff[r * OFFS + 2 * side + 1] + x * P.wx];
    for (int gb = 0; gb < gn; gb += GB) {
      float v[GB];
#pragma unroll
      for (int k = 0; k < GB; ++k) v[k] = src[min(gb + k, gn - 1) * P.pg];
#pragma unroll
      for (int k = 0; k < GB; ++k)
        if (gb + k < gn) dst[(gb + k) * P.Gpad] = v[k] + w;
    }
  }
}

// the TILE x TILE cells of one unit over gn staged g rows; k: the item's
// offsets of its a rows, one a g
__device__ __forceinline__ float unit_sum(const float* pa, const float* pb, const float* m,
                                          const float* k, int Gap, int Gbp, int gn) {
  const float4 m0 = ld4(m), m1 = ld4(m + Gbp), m2 = ld4(m + 2 * Gbp), m3 = ld4(m + 3 * Gbp);
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  for (int gi = 0; gi < gn; ++gi) {
    const float4 y = ld4(pb + gi * Gbp);
    float4 x = ld4(pa + gi * Gap);
    const float kg = k[gi];
    x.x += kg;
    x.y += kg;
    x.z += kg;
    x.w += kg;
    s0 = fmaf(ex2(x.x + y.x), m0.x, s0);
    s0 = fmaf(ex2(x.x + y.y), m0.y, s0);
    s0 = fmaf(ex2(x.x + y.z), m0.z, s0);
    s0 = fmaf(ex2(x.x + y.w), m0.w, s0);
    s1 = fmaf(ex2(x.y + y.x), m1.x, s1);
    s1 = fmaf(ex2(x.y + y.y), m1.y, s1);
    s1 = fmaf(ex2(x.y + y.z), m1.z, s1);
    s1 = fmaf(ex2(x.y + y.w), m1.w, s1);
    s2 = fmaf(ex2(x.z + y.x), m2.x, s2);
    s2 = fmaf(ex2(x.z + y.y), m2.y, s2);
    s2 = fmaf(ex2(x.z + y.z), m2.z, s2);
    s2 = fmaf(ex2(x.z + y.w), m2.w, s2);
    s3 = fmaf(ex2(x.w + y.x), m3.x, s3);
    s3 = fmaf(ex2(x.w + y.y), m3.y, s3);
    s3 = fmaf(ex2(x.w + y.z), m3.z, s3);
    s3 = fmaf(ex2(x.w + y.w), m3.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

__global__ void __launch_bounds__(THREADS, 3) lfc_star_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int Gap = a.A.Gpad, Gbp = a.Bq.Gpad, gc = a.gc, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, half = lane >> 4, hl = lane & 15;
  float* sA = smem;                               // [R, gc, Gap]
  float* sB = sA + a.R * gc * Gap;                // [R, gc, Gbp]
  float* sM = sB + a.R * gc * Gbp;                // [mt * TILE, Gbp]
  float* sPart = sM + a.mt * TILE * Gbp;          // [R, THREADS]
  long long* sOff = reinterpret_cast<long long*>(sPart + a.R * THREADS);  // [R, OFFS]
  float* sMaxA = reinterpret_cast<float*>(sOff + a.R * OFFS);  // [R, gc]
  float* sMaxB = sMaxA + a.R * gc;                // [R, gc]
  float* sC = sMaxB + a.R * gc;                   // [R, gc]
  float* sShift = sC + a.R * gc;                  // [R]
  float* sScale = sShift + a.R;                   // [R]
  int* sRedo = reinterpret_cast<int*>(sScale + a.R);  // [R]

  int bad = 0;  // an lm above 0 (or NaN): the shift is no bound
  if (a.mchunks == 1) {
    bad = stage_mask(a, sM, 0);
  } else {
    for (int x = warp; x < a.A.G; x += WARPS)
      for (int y = lane; y < a.Bq.G; y += 32) bad |= !(mask_at(a, x, y) <= 0.0f);
    bad = __syncthreads_or(bad);
  }

  for (long long grp = blockIdx.x; grp < a.groups; grp += gridDim.x) {
    const long long row0 = grp * a.R;
    const int nr = (int)min((long long)a.R, a.rows - row0);
    if (tid < nr) {
      const long long row = row0 + tid, l = row / a.B, b = row - l * a.B;
      long long* o = sOff + tid * OFFS;
      o[0] = l * a.A.pl + b * a.A.pb;
      o[1] = l * a.A.wl;
      o[2] = l * a.Bq.pl + b * a.Bq.pb;
      o[3] = l * a.Bq.wl;
      o[4] = l * a.rpl + b * a.rpb;
      sShift[tid] = -CUDART_INF_F;
    }
    for (int r = 0; r < nr; ++r) sPart[r * THREADS + tid] = 0.0f;
    __syncthreads();

    for (int g0 = 0; g0 < a.Gp; g0 += gc) {
      const int gn = min(gc, a.Gp - g0);
      // the chunk's raw rows and rp
      stage_rows(a.A, sOff, 0, sA, gc, nr, g0, gn);
      stage_rows(a.Bq, sOff, 1, sB, gc, nr, g0, gn);
      for (int t = tid; t < nr * gn; t += THREADS) {
        const int r = t / gn, gi = t - r * gn;
        sC[r * gc + gi] = a.rp[sOff[r * OFFS + 4] + (g0 + gi) * a.rpg];
      }
      __syncthreads();
      // each row's maximum over x (sa[g] of fa, sb[g] of fb), then the row
      // less it in log2 units, in place: a half warp a row, its values in
      // registers, so that a warp reduces two rows at once
      for (int q0 = 2 * warp; q0 < 2 * nr * gn; q0 += 2 * WARPS) {
        const bool live = q0 + half < 2 * nr * gn;
        const int q = live ? q0 + half : q0;
        const int side = q / (nr * gn), rg = q - side * nr * gn, r = rg / gn,
                  i = r * gc + rg - r * gn, G = side ? Gbp : Gap;
        float* row = side ? sB + i * Gbp : sA + i * Gap;
        float f[XR];
        float m = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < XR; ++j) {
          const int x = hl + 16 * j;
          f[j] = x < G ? row[x] : -CUDART_INF_F;
          m = fmaxf(m, f[j]);
        }
        for (int x = hl + 16 * XR; x < G; x += 16) m = fmaxf(m, row[x]);
#pragma unroll
        for (int o = 8; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
        if (!live) continue;
        const bool fin = m > -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < XR; ++j) {
          const int x = hl + 16 * j;
          if (x < G) row[x] = (fin && f[j] > -CUDART_INF_F) ? (f[j] - m) * LOG2E : -CUDART_INF_F;
        }
        for (int x = hl + 16 * XR; x < G; x += 16) {
          const float v = row[x];
          row[x] = (fin && v > -CUDART_INF_F) ? (v - m) * LOG2E : -CUDART_INF_F;
        }
        if (hl == 0) (side ? sMaxB : sMaxA)[i] = m;
      }
      __syncthreads();
      // c[g] = rp[g] + sa[g] + sb[g], the running shift, and the a rows'
      // offsets (c[g] - shift) log2 e, a warp an item; the item's slots of
      // earlier chunks are scaled to the new shift
      if (warp < nr) {
        float m = -CUDART_INF_F;
        for (int gi = lane; gi < gn; gi += 32) {
          const int i = warp * gc + gi;
          sC[i] = sC[i] + sMaxA[i] + sMaxB[i];
          m = fmaxf(m, sC[i]);
        }
        m = warp_reduce(m, 1);
        const float old = sShift[warp], now = fmaxf(old, m);
        for (int gi = lane; gi < gn; gi += 32) {
          const int i = warp * gc + gi;
          sC[i] = sC[i] > -CUDART_INF_F ? (sC[i] - now) * LOG2E : -CUDART_INF_F;
        }
        if (lane == 0) {
          sScale[warp] =
              (old > -CUDART_INF_F && now > old) ? exp2f((old - now) * LOG2E) : 1.0f;
          sShift[warp] = now;
        }
      }
      __syncthreads();
      for (int r = 0; r < nr; ++r)
        if (sScale[r] != 1.0f) sPart[r * THREADS + tid] *= sScale[r];
      for (int mc = 0; mc < a.mchunks; ++mc) {
        if (a.mchunks > 1) stage_mask(a, sM, mc);
        const int ta0 = mc * a.mt, tn = min(a.mt, a.TA - ta0) * a.TB;
        int cur = -1;
        float acc = 0.0f;
        for (int u = tid; u < nr * tn; u += THREADS) {
          const int r = u / tn, t = u - r * tn, ta = t / a.TB, tb = t - ta * a.TB;
          if (r != cur) {
            if (cur >= 0) sPart[cur * THREADS + tid] += acc;
            cur = r;
            acc = 0.0f;
          }
          acc += unit_sum(sA + r * gc * Gap + (ta0 + ta) * TILE,
                          sB + r * gc * Gbp + tb * TILE, sM + ta * TILE * Gbp + tb * TILE,
                          sC + r * gc, Gap, Gbp, gn);
        }
        if (cur >= 0) sPart[cur * THREADS + tid] += acc;
        __syncthreads();  // the strips and rows are free again
      }
    }

    // each item's slots summed in a fixed order, a warp an item
    if (warp < nr) {
      float sum = 0.0f;
      for (int j = lane; j < THREADS; j += 32) sum += sPart[warp * THREADS + j];
      sum = warp_reduce(sum, 0);
      if (lane == 0) {
        const float shift = sShift[warp];
        int redo = bad || !(shift < CUDART_INF_F) || !(sum >= REDO_BELOW) || !(sum <= FLT_MAX);
        float res = shift + logf(sum);
        if (!bad && shift == -CUDART_INF_F) {  // every cell is -inf
          redo = 0;
          res = -CUDART_INF_F;
        }
        sRedo[warp] = redo;
        if (!redo) a.out[row0 + warp] = res;
      }
    }
    __syncthreads();
    for (int r = 0; r < nr; ++r)  // sPart is free: the scratch of the exact sums
      if (sRedo[r]) exact_item(a, row0 + r, sPart);
  }
}

size_t smem_bytes(const Args& a, int R, int gc, int mt) {
  return sizeof(float) * ((size_t)R * gc * (a.A.Gpad + a.Bq.Gpad) +
                          (size_t)mt * TILE * a.Bq.Gpad + (size_t)R * THREADS +
                          3 * (size_t)R * gc + 2 * (size_t)R) +
         sizeof(int) * (size_t)R + sizeof(long long) * OFFS * (size_t)R;
}

// The tiling, from the shapes alone: the whole mask and every g row staged
// with the number of items a group that leaves the fewest thread slots of
// its units idle (more items on a tie); else one item, the whole mask and
// g in chunks; else one item, g rows and mask strips in chunks.
bool tiling(Args& a, size_t* bytes) {
  a.TA = (a.A.G + TILE - 1) / TILE;
  a.TB = (a.Bq.G + TILE - 1) / TILE;
  const long long T = (long long)a.TA * a.TB;
  a.R = 0;
  long long best_units = 0, best_slots = 1;
  for (int R = 1; R <= RMAX; ++R) {
    if (smem_bytes(a, R, a.Gp, a.TA) > SMEM_MAX) break;
    const long long units = R * T, slots = (units + THREADS - 1) / THREADS * THREADS;
    if (units * best_slots >= best_units * slots) {
      a.R = R;
      best_units = units;
      best_slots = slots;
    }
  }
  a.gc = a.Gp;
  a.mt = a.TA;
  if (a.R == 0) {
    a.R = 1;
    if (smem_bytes(a, 1, 1, a.TA) <= SMEM_MAX) {
      while (smem_bytes(a, 1, a.gc, a.TA) > SMEM_MAX) --a.gc;
    } else {
      a.gc = 1;
      while (2 * a.gc <= a.Gp && smem_bytes(a, 1, 2 * a.gc, 1) <= SMEM_MAX / 2) a.gc *= 2;
      while (a.mt > 0 && smem_bytes(a, 1, a.gc, a.mt) > SMEM_MAX) --a.mt;
      if (a.mt == 0) return false;
    }
  }
  a.gchunks = (a.Gp + a.gc - 1) / a.gc;
  a.mchunks = (a.TA + a.mt - 1) / a.mt;
  a.groups = (a.rows + a.R - 1) / a.R;
  *bytes = smem_bytes(a, a.R, a.gc, a.mt);
  return true;
}

}  // namespace

// Plain C entry for ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a shape the
// kernel does not take.  Device pointers, float32 at the given strides
// (elements): pa [L, B, Ga, Gp], wa [L, Ga], pb [L, B, Gb, Gp], wb [L, Gb],
// lm [Ga, Gb], rp [L, B, Gp]; out [L, B] contiguous.
extern "C" int vlt_lfc_star(const float* pa, const float* wa, const float* pb,
                            const float* wb, const float* lm, const float* rp, float* out,
                            int L, int B, int Ga, int Gb, int Gp, long long pal,
                            long long pab, long long pax, long long pag, long long wal,
                            long long wax, long long pbl, long long pbb, long long pbx,
                            long long pbg, long long wbl, long long wbx, long long lma,
                            long long lmb, long long rpl, long long rpb, long long rpg,
                            void* stream) {
  if (L < 0 || B <= 0 || Ga <= 0 || Gb <= 0 || Gp <= 0 || (long long)Ga * Gb > INT_MAX / TILE)
    return (int)cudaErrorInvalidValue;
  if (L == 0) return (int)cudaSuccess;
  Args a{};
  a.A = Plane{pa, wa, pal, pab, pax, pag, wal, wax, Ga, (Ga + TILE - 1) / TILE * TILE};
  a.Bq = Plane{pb, wb, pbl, pbb, pbx, pbg, wbl, wbx, Gb, (Gb + TILE - 1) / TILE * TILE};
  a.lm = lm;
  a.rp = rp;
  a.out = out;
  a.lma = lma;
  a.lmb = lmb;
  a.rpl = rpl;
  a.rpb = rpb;
  a.rpg = rpg;
  a.rows = (long long)L * B;
  a.B = B;
  a.Gp = Gp;
  size_t bytes = 0;
  if (!tiling(a, &bytes)) return (int)cudaErrorInvalidValue;
  // the kernel's attributes and its blocks an SM, once a device and size
  static thread_local int last_dev = -1, sms = 0, per_sm = 0;
  static thread_local size_t last_bytes = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != last_dev || bytes != last_bytes) {
    if ((e = cudaFuncSetAttribute(lfc_star_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes)) != cudaSuccess ||
        (e = cudaFuncSetAttribute(lfc_star_kernel,
                                  cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lfc_star_kernel, THREADS,
                                                           bytes)) != cudaSuccess) {
      last_dev = -1;
      return (int)e;
    }
    last_dev = dev;
    last_bytes = bytes;
  }
  const long long grid = std::min(a.groups, (long long)sms * std::max(per_sm, 1));
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  lfc_star_kernel<<<(unsigned)grid, THREADS, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
