// The posterior engine's grid contraction: one sample's allele-frequency
// grid eliminated into its neighbour's, for every spectrum-support class of
// the eliminated sample in one launch.
//
//     out[l,b,n,u] = log( sum_{v in class(n)} exp(F[l,b,v,u] - mF[l,b,k,u])
//                                            * exp(S[l,b,n,v] - mS[l,b,n]) )
//                    + mF[l,b,k,u] + mS[l,b,n]
//
// k = class(n); mS is the max of S over all v and mF the max of F over the
// v of class k, each 0 where it is not finite; a branch in no class gets 0.
// This is the shift scheme of the plain version
// (ops/lse_contract.py:lse_contract_reference, the JAX package's
// PosteriorEngine._lse_contract), so the card underflows where the CPU does.
// It replaces no Pallas kernel: the JAX package leaves this contraction to
// XLA, and in eager PyTorch it was ~60 generic launches per class, each
// writing a copy of the [L, B, Gv, Gu] slab.
//
// What bounds it on an H100: bytes.  At the tumor-normal call's shapes
// (F [1024, 8, 101, 15], S expanded over B) a window reads ~72 MB once
// against ~0.2 GFLOP and ~25 M expf, ~22 us at 3.35 TB/s.  This design takes
// ~0.16 ms a window (PERF.md): a block stages its rows, then computes,
// and the blocks of a wave do both in step, at a low issue rate.  Two
// buffers with persistent blocks, rows owned by one warp, groups sharing
// their barriers and capped registers were each slower on the card.
//
// Design:
// * A block stages `rb` rows (l, b) of one tile of `ut` columns u into
//   shared memory with cp.async, every element in flight at once: F's
//   [Gv, ut] tiles, S's [NB, Gv] rows (one per locus where S is expanded
//   over B) and the class masks.  F and S are read through their strides,
//   in the order of the smaller stride, so a swapped F is read as coalesced
//   as a plain one.  S becomes Q = exp(S - mS) in place.  When a row's
//   tiles do not fit the block's shared memory, v runs in chunks of `vc`
//   and each pass re-stages them.
// * The work is split into groups of up to GROUP branches of one class
//   (built on the host from the class table).  A lane owns one (row, u),
//   `32 / ut` rows a warp; the block's warps split v, in blocks of four
//   points, so every warp has the same share of every group.  For each
//   group a warp takes the max of F over its points of the class, the
//   block reduces it to mF, then one exp per (v, u) serves every branch of
//   the group from registers: GROUP FMAs against Q, read four points at a
//   time as a broadcast from shared memory.  A block of four points outside
//   the class is skipped; the block sums the warps' partial sums in a fixed
//   order.
// * Float32 throughout, with the accurate expf and logf (no fast math):
//   only the order of summation differs from the plain version's einsum.

#include <climits>
#include <cstddef>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int GROUP = 8;                  // branches per group
constexpr int GW = 2 + GROUP;             // group row: class, count, branches
constexpr int VB = 4;                     // points per block of v
constexpr int SMEM_MAX = 96 * 1024;       // bytes a block stages at most
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* F;
  const float* S;
  const int* groups;
  const unsigned char* masks;
  float* out;
  long long fl, fb, fv, fu;  // F [L, B, Gv, Gu] strides, in elements
  long long sl, sb, sn, sv;  // S [L, B, NB, Gv]
  long long rows;            // L * B
  int B, Gv, Gu, NB, K, G;
  // the tiling (tiling() below)
  int ut;      // columns per tile: a power of two up to 32
  int rpw;     // rows a warp covers: 32 / ut
  int passes;  // row passes per block: rb = passes * rpw rows
  int shareQ;  // every block's rows lie in one locus and S is expanded over B
  int vc;      // points v per chunk
  int vcp;     // vc rounded up to a block of VB
  int chunks;
  int vs;      // staged F: stride of v (ut + 1)
  int frs;     // staged F: floats per row
};

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Visit every (r, a, c) of an [nr, na, nc] box, c fastest, spread over the
// block's threads in flat order; one division per thread, not per element.
template <class Fn>
__device__ __forceinline__ void walk(int nr, int na, int nc, Fn fn) {
  if (nr <= 0 || na <= 0 || nc <= 0) return;
  const int q = THREADS / nc, rem = THREADS - q * nc;
  int a = threadIdx.x / nc, c = threadIdx.x - a * nc, r = 0;
  while (a >= na) { a -= na; ++r; }
  while (r < nr) {
    fn(r, a, c);
    c += rem;
    a += q;
    if (c >= nc) { c -= nc; ++a; }
    while (a >= na) { a -= na; ++r; }
  }
}

__device__ __forceinline__ float finite_or_zero(float m, bool nan) {
  return (!nan && isfinite(m)) ? m : 0.0f;
}

// mS of one (row, branch) over n values at stride `st`, by one warp
__device__ __forceinline__ float warp_max_shift(const float* s, long long st, int n) {
  const int lane = threadIdx.x & 31;
  float m = -CUDART_INF_F;
  bool nan = false;
  for (int v = lane; v < n; v += 32) {
    const float x = s[v * st];
    m = fmaxf(m, x);
    nan |= x != x;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  return finite_or_zero(m, __any_sync(FULL, nan));
}

__global__ void __launch_bounds__(THREADS)
lse_contract_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rb = a.passes * a.rpw, nq = a.shareQ ? 1 : rb;
  const int qrs = a.NB * a.vcp;  // Q floats per row
  // (every offset a multiple of 16 bytes up to rowS, of 4 after it)
  float* sQ = reinterpret_cast<float*>(smem);                   // [nq, NB, vcp]
  float* sRed = sQ + nq * qrs;                                  // [WARPS, GROUP, 32]
  long long* rowF = reinterpret_cast<long long*>(sRed + WARPS * GROUP * 32);  // [rb]
  long long* rowS = rowF + rb;                                  // [nq]
  float* sF = reinterpret_cast<float*>(rowS + nq);              // [rb, frs]
  float* sMS = sF + rb * a.frs;                                 // [nq, NB]
  unsigned char* sMk = reinterpret_cast<unsigned char*>(sMS + nq * a.NB);  // [K, vcp]

  const long long row0 = (long long)blockIdx.x * rb;
  const int nrows = (int)min((long long)rb, a.rows - row0);
  const int nqr = a.shareQ ? 1 : nrows;
  const int u0 = blockIdx.y * a.ut;
  const int uw = min(a.ut, a.Gu - u0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int r = threadIdx.x; r < nrows; r += THREADS) {
    const long long row = row0 + r, l = row / a.B, b = row - l * a.B;
    rowF[r] = l * a.fl + b * a.fb;
    if (r < nq) rowS[r] = l * a.sl + b * a.sb;
  }
  __syncthreads();

  // chunk [v0, v0 + vlen) into shared memory: F and the masks always, and
  // Q = exp(S - mS) when asked; masks and Q are zero from vlen to vcp
  auto stage = [&](int v0, int vlen, bool withQ) {
    auto f = [&](int r, int vv, int uu) {
      copy_async(sF + r * a.frs + vv * a.vs + uu,
                 a.F + rowF[r] + (v0 + vv) * a.fv + (u0 + uu) * a.fu);
    };
    if (a.fu <= a.fv)
      walk(nrows, vlen, uw, f);
    else
      walk(nrows, uw, vlen, [&](int r, int uu, int vv) { f(r, vv, uu); });
    if (withQ)
      walk(nqr, a.NB, vlen, [&](int r, int n, int vv) {
        copy_async(sQ + r * qrs + n * a.vcp + vv,
                   a.S + rowS[r] + n * a.sn + (v0 + vv) * a.sv);
      });
    for (int i = threadIdx.x; i < a.K * a.vcp; i += THREADS) {
      const int k = i / a.vcp, vv = i - k * a.vcp;
      sMk[i] = vv < vlen ? a.masks[(long long)k * a.Gv + v0 + vv] : 0;
    }
    copy_wait();
    __syncthreads();
    if (!withQ) return;
    if (a.chunks == 1) {  // mS from the staged rows; else the pre-pass's
      for (int p = warp; p < nqr * a.NB; p += WARPS)
        sMS[p] = warp_max_shift(sQ + p * a.vcp, 1, vlen);
      __syncthreads();
    }
    walk(nqr, a.NB, a.vcp, [&](int r, int n, int vv) {
      float* q = sQ + r * qrs + n * a.vcp + vv;
      *q = vv < vlen ? expf(*q - sMS[r * a.NB + n]) : 0.0f;
    });
    __syncthreads();
  };

  const bool whole = a.chunks == 1;
  if (whole) {
    stage(0, a.Gv, true);
  } else {  // mS over all v before any chunk's Q
    for (int p = warp; p < nqr * a.NB; p += WARPS)
      sMS[p] = warp_max_shift(a.S + rowS[p / a.NB] + (p % a.NB) * a.sn, a.sv, a.Gv);
    __syncthreads();
  }

  const int rr = lane / a.ut, uu = lane - rr * a.ut;
  for (int pass = 0; pass < a.passes; ++pass) {
    const int r = pass * a.rpw + rr;
    const int qr = a.shareQ ? 0 : r;
    const bool active = r < nrows && uu < uw;
    const float* sf = sF + r * a.frs + uu;
    const float* sq = sQ + qr * qrs;
    float* o = a.out + (row0 + r) * a.NB * a.Gu + u0 + uu;
    for (int g = 0; g < a.G; ++g) {
      const int* grp = a.groups + g * GW;
      const int k = grp[0], cnt = grp[1];
      if (k < 0) {  // branches in no class
        if (warp == 0 && active)
          for (int i = 0; i < cnt; ++i) o[(long long)grp[2 + i] * a.Gu] = 0.0f;
        continue;
      }
      int qoff[GROUP];
#pragma unroll
      for (int i = 0; i < GROUP; ++i) qoff[i] = (i < cnt ? grp[2 + i] : 0) * a.vcp;
      const unsigned* mk = reinterpret_cast<const unsigned*>(sMk + k * a.vcp);

      // pass 1: this warp's share of the max of F over the class's points
      float m = -CUDART_INF_F;
      bool nan = false;
      for (int c = 0; c < a.chunks; ++c) {
        const int vlen = min(a.vc, a.Gv - c * a.vc);
        if (!whole) {
          __syncthreads();
          stage(c * a.vc, vlen, false);
        }
        for (int v0 = warp * VB; v0 < vlen; v0 += WARPS * VB) {
          const unsigned bits = mk[v0 / VB];
          if (!bits) continue;
#pragma unroll
          for (int j = 0; j < VB; ++j) {
            const float x = (bits >> 8 * j & 0xffu) ? sf[(v0 + j) * a.vs] : -CUDART_INF_F;
            m = fmaxf(m, x);
            nan |= x != x;
          }
        }
      }
      sRed[warp * 32 + lane] = nan ? CUDART_NAN_F : m;
      __syncthreads();
      float mx = -CUDART_INF_F;
      nan = false;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float x = sRed[w * 32 + lane];
        mx = fmaxf(mx, x);
        nan |= x != x;
      }
      const float mF = finite_or_zero(mx, nan);

      // pass 2: this warp's share of the sums, one exp per (v, u) for the
      // whole group
      float acc[GROUP];
#pragma unroll
      for (int i = 0; i < GROUP; ++i) acc[i] = 0.0f;
      for (int c = 0; c < a.chunks; ++c) {
        const int vlen = min(a.vc, a.Gv - c * a.vc);
        if (!whole) {
          __syncthreads();
          stage(c * a.vc, vlen, true);
        }
        for (int v0 = warp * VB; v0 < vlen; v0 += WARPS * VB) {
          const unsigned bits = mk[v0 / VB];
          if (!bits) continue;
          float p[VB];
#pragma unroll
          for (int j = 0; j < VB; ++j)
            p[j] = expf((bits >> 8 * j & 0xffu) ? sf[(v0 + j) * a.vs] - mF : -CUDART_INF_F);
#pragma unroll
          for (int i = 0; i < GROUP; ++i) {
            if (i < cnt) {
              const float4 q = *reinterpret_cast<const float4*>(sq + qoff[i] + v0);
              acc[i] = fmaf(p[0], q.x, acc[i]);
              acc[i] = fmaf(p[1], q.y, acc[i]);
              acc[i] = fmaf(p[2], q.z, acc[i]);
              acc[i] = fmaf(p[3], q.w, acc[i]);
            }
          }
        }
      }
      __syncthreads();  // every warp has read sRed
#pragma unroll
      for (int i = 0; i < GROUP; ++i)
        if (i < cnt) sRed[(warp * GROUP + i) * 32 + lane] = acc[i];
      __syncthreads();
      for (int i = warp; i < cnt; i += WARPS) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += sRed[(w * GROUP + i) * 32 + lane];
        const int n = grp[2 + i];
        if (active) o[(long long)n * a.Gu] = (logf(sum) + mF) + sMS[qr * a.NB + n];
      }
      __syncthreads();  // sRed is free again
    }
  }
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared bytes a block of `passes` row passes takes at vc points per chunk.
size_t smem_bytes(Args& a, int passes, int vc) {
  const int rb = passes * a.rpw;
  a.shareQ = a.sb == 0 && a.B % rb == 0;
  const int nq = a.shareQ ? 1 : rb;
  a.vcp = round_up(vc, VB);
  a.vs = a.ut + 1;
  // rows of one warp start ut banks apart, so its lanes meet no conflict
  a.frs = a.rpw > 1 ? round_up(a.vcp * a.vs, 32) + a.ut : a.vcp * a.vs;
  return sizeof(float) * ((size_t)nq * a.NB * a.vcp + WARPS * GROUP * 32 +
                          (size_t)rb * a.frs + (size_t)nq * a.NB) +
         sizeof(long long) * (size_t)(rb + nq) + (size_t)a.K * a.vcp;
}

// The tiling, from the shapes alone: two row passes where S is shared over
// them and they fit, whole rows in shared memory where they fit, else
// chunks of v for one row pass.
bool tiling(Args& a, size_t* bytes) {
  a.ut = 1;
  while (a.ut < a.Gu && a.ut < 32) a.ut <<= 1;
  a.rpw = 32 / a.ut;
  a.vc = a.Gv;
  a.passes = 2;
  if (smem_bytes(a, 2, a.vc) > SMEM_MAX || !a.shareQ) a.passes = 1;
  if (smem_bytes(a, a.passes, a.vc) > SMEM_MAX) {
    int lo = 0, hi = a.Gv;  // the largest vc that fits
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (smem_bytes(a, 1, mid) <= SMEM_MAX) lo = mid; else hi = mid - 1;
    }
    if (lo < 1) return false;
    a.vc = lo;
  }
  a.chunks = (a.Gv + a.vc - 1) / a.vc;
  *bytes = smem_bytes(a, a.passes, a.vc);
  return true;
}

}  // namespace

// Plain C entry for ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a shape the
// kernel does not take.  Device pointers: F [L, B, Gv, Gu] and S [L, B, NB,
// Gv] float32 at the given strides (elements); groups [G, 2 + group] int32
// (class or -1, count, branches); masks [K, Gv] uint8; out [L, B, NB, Gu]
// float32, contiguous.
extern "C" int vlt_lse_contract(const float* F, const float* S, const int* groups,
                                const unsigned char* masks, float* out, int L, int B,
                                int Gv, int Gu, int NB, int K, int G, int group,
                                long long fl, long long fb, long long fv, long long fu,
                                long long sl, long long sb, long long sn, long long sv,
                                void* stream) {
  if (group != GROUP || L < 0 || B <= 0 || Gv <= 0 || Gu <= 0 || NB <= 0 || K <= 0 ||
      G <= 0)
    return (int)cudaErrorInvalidValue;
  if (L == 0) return (int)cudaSuccess;
  Args a{F, S, groups, masks, out, fl, fb, fv, fu, sl, sb, sn, sv,
         (long long)L * B, B, Gv, Gu, NB, K, G};
  size_t bytes = 0;
  if (!tiling(a, &bytes)) return (int)cudaErrorInvalidValue;
  const long long rb = (long long)a.passes * a.rpw;
  const long long bx = (a.rows + rb - 1) / rb;
  const int by = (Gu + a.ut - 1) / a.ut;
  if (bx > INT_MAX || by > 65535) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lse_contract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  lse_contract_kernel<<<dim3((unsigned)bx, (unsigned)by), THREADS, bytes,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
