// The banded log-space pair-HMM wavefronts: banded, positional and hop-state.
//
// Replaces the XLA anti-diagonal scans of varlociraptor_tpu/ops/pairhmm.py,
// which have no Pallas kernel: _forward_impl (:55-189, constant gaps),
// _forward_hp_impl (:193-336, per-position gap panels) and _forward_hop_impl
// (:340-502, the hop-state homopolymer model with the HX and HY lanes).  On
// the TPU, XLA runs each scan step as one fused loop body; an eager torch
// loop launches some 50-70 small operators per diagonal.  This kernel
// computes exactly what the plain versions of ops/pairhmm_wavefront.py
// compute, in the same order of float32 operations (expf, logf, log1pf).
//
// Model (cell (i, j) on diagonal k = i + j; allele axis i with free start and
// end, the read axis j consumed in full), in log space:
//   M(i,j) = e_m + lse2(lse3(t_mm + M(i-1,j-1), t_dm + D(i-1,j-1),
//                            t_im + I(i-1,j-1)) [hop: lse2 with
//                       hxclose_j + HX(i-1,j-1), hyclose_i + HY(i-1,j-1)],
//                       start_m)
//   D(i,j) = lse2(t_md + M(i-1,j), t_dd + D(i-1,j))
//   I(i,j) = miscall_j + lse2(lse2(t_mi + M(i,j-1), t_ii + I(i,j-1)), start_i)
//   HX(i,j) = lse2(match ? hox_j + M(i,j-1), same_read_j ? hex_j + HX(i,j-1))
//   HY(i,j) = same_allele_i ? lse2(hoy_i + M(i-1,j), hey_i + HY(i-1,j))
// with the int32 edit-distance DP of rust-bio's banded PairHMM carried on the
// same diagonals (a cell whose predecessors all exceed max_edit is pruned;
// max_edit < 0: no band; column 0 anchors distance 0 while k <= allele_len),
// and the end cells j == read_len summed over the diagonals.  The
// positional flavour reads t_mi, t_ii per read column and t_md, t_dd per
// allele row from LOG panels; the hop flavour reads the per-base hop rates
// of hop16 [16] (seq open, seq extend, ref open, ref extend; A, C, G, T).
//
// What bounds it on an H100: the diagonal chain.  An item has allele_len +
// read_len dependent steps of ~60-110 float32 operations per cell (12-19
// exp / log); the bytes (the panels, read once) are no limit.  Design: one
// block per item, one thread per read column j (C contiguous columns per
// thread when the read panel is wider than 1023 columns), each column's
// cells of diagonals k-1 and k-2 in registers (in local memory past 4
// columns per thread, reads over 4095 bases).  The j-1 neighbours of a
// thread's first column come from the thread before it: __shfl_up_sync
// within a warp, and one shared slot per warp boundary (double-buffered by
// the diagonal's parity) with one __syncthreads() per diagonal.  The allele
// bytes and the deletion panels sit in shared memory, indexed by i-1 = k-1-j
// (and i-2 for the hop flavour); the read byte, miscall and insertion
// panels of a column, and the hop rates per base, sit in registers.  Only
// the thread of column read_len sums the end cells, so no reduction is
// needed, and the march stops at allele_len + read_len, past which no end
// cell is valid (adding -1e30 leaves the sum as it is).  Columns past
// read_len never feed one at or before it and are not computed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr float HALF_NEG_INF = -0.5e30f;
constexpr int EINF = 1 << 29;
constexpr float LN_CONFUSION = -1.0987122886681098f;  // log(0.3333)
constexpr float LN_QUARTER = -1.3862943611198906f;    // log(0.25)
constexpr unsigned FULL = 0xffffffffu;

enum Flavour { BANDED = 0, POSITIONAL = 1, HOP = 2 };

__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(a, b);
  const float out = m + log1pf(expf(-fabsf(a - b)));
  return m <= HALF_NEG_INF ? NEG_INF : out;
}

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float out = m + logf(expf(a - m) + expf(b - m) + expf(c - m));
  return m <= HALF_NEG_INF ? NEG_INF : out;
}

// log(max(1 - exp(x), 1e-12)): the probability of leaving a state
__device__ __forceinline__ float close_p(float x) {
  return logf(fmaxf(1.0f - expf(x), 1e-12f));
}

// a per-base value of the hop tables: A, C, G, T, else -1e30
__device__ __forceinline__ float per_base(const float* v, uint8_t b) {
  switch (b) {
    case 'A': return v[0];
    case 'C': return v[1];
    case 'G': return v[2];
    case 'T': return v[3];
    default: return NEG_INF;
  }
}

// a cell of one diagonal: the three states, the hop lanes and the edit
// distance
struct Cell {
  float m, d, i, hx, hy;
  int e;
};

__device__ __forceinline__ Cell empty_cell() { return Cell{NEG_INF, NEG_INF, NEG_INF, NEG_INF, NEG_INF, EINF}; }

template <int C, int F>
__global__ void __launch_bounds__(1024)
pairhmm_wavefront_kernel(const uint8_t* __restrict__ allele, const int* __restrict__ alen_p,
                         const uint8_t* __restrict__ read, const float* __restrict__ mis,
                         const int* __restrict__ rlen_p, const int* __restrict__ max_edit,
                         const float* __restrict__ gaps, const float* __restrict__ hop16,
                         const float* __restrict__ io, const float* __restrict__ ie,
                         const float* __restrict__ dop, const float* __restrict__ dep,
                         float* __restrict__ out, int X, int Y) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Cell slots[2][32];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int alen = alen_p[b];
  const int rlen = rlen_p[b];
  const int me_raw = max_edit[b];
  const int me = me_raw < 0 ? EINF : me_raw;

  // the item's allele bytes (and deletion panels) in shared memory
  float* do_s = reinterpret_cast<float*>(smem);
  float* de_s = do_s + (F == POSITIONAL ? X : 0);
  uint8_t* a_s = reinterpret_cast<uint8_t*>(de_s + (F == POSITIONAL ? X : 0));
  for (int x = t; x < X; x += blockDim.x) {
    a_s[x] = allele[(size_t)b * X + x];
    if constexpr (F == POSITIONAL) {
      do_s[x] = dop[(size_t)b * X + x];
      de_s[x] = dep[(size_t)b * X + x];
    }
  }

  // the constant transitions (banded, hop) and the hop rates per base
  float t_mi = 0.f, t_md = 0.f, t_ii = 0.f, t_dd = 0.f, t_mm = 0.f, t_im = 0.f, t_dm = 0.f;
  if constexpr (F != POSITIONAL) {
    t_mi = gaps[0];
    t_md = gaps[1];
    t_ii = gaps[2];
    t_dd = gaps[3];
    t_mm = logf(fmaxf(1.0f - expf(t_mi) - expf(t_md), 1e-12f));
    t_im = close_p(t_ii);
    t_dm = close_p(t_dd);
  }
  float hox[4], hex[4], hoy[4], hey[4], hyc[5];
  if constexpr (F == HOP) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      hox[q] = hop16[q];
      hex[q] = hop16[4 + q];
      hoy[q] = hop16[8 + q];
      hey[q] = hop16[12 + q];
      hyc[q] = close_p(hey[q]);
    }
    hyc[4] = close_p(NEG_INF);
  }

  // per column: the read byte, miscall and the insertion side; state of
  // diagonals k-1 (c1) and k-2 (c2)
  uint8_t rj[C];
  float mis_j[C], noc_j[C], io_j[C], ie_j[C], tim_j[C];
  float hox_r[C], hex_r[C], hxclose[C];
  bool same_read[C];
  Cell c1[C], c2[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = t * C + c;
    const bool in = j >= 1 && j <= Y;
    rj[c] = in ? read[(size_t)b * Y + j - 1] : 0;
    mis_j[c] = in ? mis[(size_t)b * Y + j - 1] : NEG_INF;
    noc_j[c] = in ? log1pf(-expf(mis_j[c])) : NEG_INF;
    if constexpr (F == POSITIONAL) {
      io_j[c] = in ? io[(size_t)b * Y + j - 1] : NEG_INF;
      ie_j[c] = in ? ie[(size_t)b * Y + j - 1] : NEG_INF;
      tim_j[c] = close_p(ie_j[c]);
    }
    if constexpr (F == HOP) {
      const uint8_t rp = (j >= 2 && j <= Y) ? read[(size_t)b * Y + j - 2] : 0;
      hox_r[c] = per_base(hox, rj[c]);
      hex_r[c] = per_base(hex, rj[c]);
      same_read[c] = rj[c] == rp && rj[c] != 0;
      hxclose[c] = close_p(per_base(hex, rp));
    }
    c1[c] = empty_cell();
    c1[c].e = j == 0 ? 0 : EINF;
    c2[c] = empty_cell();
  }
  // the left neighbour (column t*C - 1) on diagonals k-1 and k-2
  Cell l1 = empty_cell(), l2 = empty_cell();
  l1.e = t * C - 1 == 0 ? 0 : EINF;
  __syncthreads();

  float acc = NEG_INF;
  const int kmax = alen + rlen;
  for (int k = 1; k <= kmax; ++k) {
    // unrolled (the columns in registers) up to 4 columns per thread; wider
    // reads keep them in local memory, and a rolled loop keeps the build short
#pragma unroll (C <= 4 ? C : 1)
    for (int c = C - 1; c >= 0; --c) {
      const int j = t * C + c;
      if (j > rlen) continue;  // never feeds a column at or before read_len
      const Cell L1 = c > 0 ? c1[c > 0 ? c - 1 : 0] : l1;
      const Cell L2 = c > 0 ? c2[c > 0 ? c - 1 : 0] : l2;
      Cell n = empty_cell();
      if (j == 0) {
        n.e = k <= alen ? 0 : EINF;  // column 0 anchors a free start
      } else {
        const int i = k - j;
        const bool valid = i >= 1 && i <= alen;
        const bool valid_i0 = i == 0;
        const uint8_t ab = (i >= 1 && i <= X) ? a_s[i - 1] : 0;
        const bool match = ab == rj[c];
        // edit-distance DP + banded skip (rust-bio PairHMM min_edit_dist)
        const int pred_min = min(min(L2.e, L1.e), c1[c].e);
        const bool skip = pred_min > me;
        if ((valid || valid_i0) && !skip) {
          const int sub = match ? L2.e : min(L2.e + 1, EINF);
          n.e = min(sub, min(min(L1.e, c1[c].e) + 1, EINF));
          float tmi = t_mi, tii = t_ii;
          if constexpr (F == POSITIONAL) {
            tmi = io_j[c];
            tii = ie_j[c];
          }
          const float start_i = j == 1 ? tmi : NEG_INF;
          n.i = mis_j[c] + lse2(lse2(tmi + L1.m, tii + L1.i), start_i);
          if (valid) {
            const float e_m = match ? noc_j[c]
                                    : (rj[c] == 'N' ? LN_QUARTER : mis_j[c] + LN_CONFUSION);
            float tmm = t_mm, tdm = t_dm, tim = t_im, tmd = t_md, tdd = t_dd;
            if constexpr (F == POSITIONAL) {
              const float d_open = do_s[i - 1];
              const float d_ext = de_s[i - 1];
              tmm = logf(fmaxf(1.0f - expf(io_j[c]) - expf(d_open), 1e-12f));
              tdm = close_p(d_ext);
              tim = tim_j[c];
              tmd = d_open;
              tdd = d_ext;
            }
            float inner = lse3(tmm + L2.m, tdm + L2.d, tim + L2.i);
            if constexpr (F == HOP) {
              const uint8_t abp = i >= 2 ? a_s[i - 2] : 0;
              const int bi = abp == 'A' ? 0 : abp == 'C' ? 1 : abp == 'G' ? 2 : abp == 'T' ? 3 : 4;
              inner = lse2(inner, lse2(hxclose[c] + L2.hx, hyc[bi] + L2.hy));
              const float hx_entry = match ? hox_r[c] + L1.m : NEG_INF;
              const float hx_ext = same_read[c] ? hex_r[c] + L1.hx : NEG_INF;
              n.hx = lse2(hx_entry, hx_ext);
              if (ab == abp && ab != 0)
                n.hy = lse2(per_base(hoy, ab) + c1[c].m, per_base(hey, ab) + c1[c].hy);
            }
            const float start_m = j == 1 ? 0.0f : NEG_INF;
            n.m = e_m + lse2(inner, start_m);
            n.d = lse2(tmd + c1[c].m, tdd + c1[c].d);
          }
        }
        if (j == rlen) {
          // the end cell of this diagonal (free end gap in x)
          float fin = lse2(n.m, n.i);
          if constexpr (F == HOP) fin = lse2(fin, n.hx);
          acc = lse2(acc, fin);
        }
      }
      c2[c] = c1[c];
      c1[c] = n;
    }
    // hand the last column's new cell to the next thread
    const Cell mine = c1[C - 1];
    Cell left;
    left.m = __shfl_up_sync(FULL, mine.m, 1);
    left.d = __shfl_up_sync(FULL, mine.d, 1);
    left.i = __shfl_up_sync(FULL, mine.i, 1);
    if constexpr (F == HOP) {
      left.hx = __shfl_up_sync(FULL, mine.hx, 1);
      left.hy = __shfl_up_sync(FULL, mine.hy, 1);
    } else {
      left.hx = left.hy = NEG_INF;
    }
    left.e = __shfl_up_sync(FULL, mine.e, 1);
    if (lane == 31) slots[k & 1][warp] = mine;
    __syncthreads();
    if (lane == 0) left = warp == 0 ? empty_cell() : slots[k & 1][warp - 1];
    l2 = l1;
    l1 = left;
  }
  if (rlen >= t * C && rlen < (t + 1) * C) out[b] = acc;
}

template <int F>
int launch_flavour(const uint8_t* allele, const int* alen, const uint8_t* read,
                   const float* mis, const int* rlen, const int* max_edit, const float* gaps,
                   const float* hop16, const float* io, const float* ie, const float* dop,
                   const float* dep, float* out, int B, int X, int Y, cudaStream_t st) {
  const int W = Y + 1;
  const size_t smem = (F == POSITIONAL ? 8 * (size_t)X : 0) + (((size_t)X + 15) / 16) * 16;
#define VLT_COLS(c)                                                                      \
  if (1024 * (c) >= W) {                                                                 \
    const int threads = 32 * ((W + 32 * (c) - 1) / (32 * (c)));                         \
    auto kern = pairhmm_wavefront_kernel<c, F>;                                          \
    if (smem > 48 * 1024) {                                                              \
      cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                           (int)smem);                                   \
      if (e != cudaSuccess) return (int)e;                                               \
    }                                                                                    \
    kern<<<B, threads, smem, st>>>(allele, alen, read, mis, rlen, max_edit, gaps, hop16, \
                                   io, ie, dop, dep, out, X, Y);                         \
    return (int)cudaGetLastError();                                                      \
  }
  VLT_COLS(1)
  VLT_COLS(2)
  VLT_COLS(4)
  VLT_COLS(8)
  VLT_COLS(16)
  VLT_COLS(32)
#undef VLT_COLS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry for ctypes.  It launches on `stream` and returns
// cudaGetLastError() (0 = launched).  flavour: 0 banded, 1 positional, 2
// hop.  Device pointers: allele [B, X] uint8 (upper-case, 0 padding), alen
// [B] int32, read [B, Y] uint8, mis [B, Y] float32 LOG miscall, rlen [B]
// int32 (0 <= rlen <= Y), max_edit [B] int32 (< 0: no band); gaps [4] float32
// LOG (t_mi, t_md, t_ii, t_dd; banded, hop); hop16 [16] float32 LOG (hop);
// io, ie [B, Y] and do, de [B, X] float32 LOG (positional); out [B] float32.
// Pointers a flavour does not read may be null.  X and Y are multiples of
// 32 with Y + 1 <= 32768.
extern "C" int vlt_pairhmm_wavefront(int flavour, const uint8_t* allele, const int* alen,
                                     const uint8_t* read, const float* mis, const int* rlen,
                                     const int* max_edit, const float* gaps,
                                     const float* hop16, const float* io, const float* ie,
                                     const float* dop, const float* dep, float* out, int B,
                                     int X, int Y, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (X <= 0 || Y <= 0 || Y + 1 > 32 * 1024) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (flavour) {
    case BANDED:
      return launch_flavour<BANDED>(allele, alen, read, mis, rlen, max_edit, gaps, hop16, io,
                                    ie, dop, dep, out, B, X, Y, st);
    case POSITIONAL:
      return launch_flavour<POSITIONAL>(allele, alen, read, mis, rlen, max_edit, gaps, hop16,
                                        io, ie, dop, dep, out, B, X, Y, st);
    case HOP:
      return launch_flavour<HOP>(allele, alen, read, mis, rlen, max_edit, gaps, hop16, io, ie,
                                 dop, dep, out, B, X, Y, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
