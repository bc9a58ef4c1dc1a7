// K2, K3 and K4: the exact semiglobal pair-HMM forward as a column recurrence.
//
// K2 (vlt_pairhmm_exact) replaces varlociraptor_tpu/ops/pallas_pairhmm.py:_kernel,
// the zero-gap-extension model collapsed to one state and three terms:
//
//     M(i,j) = e_m(i,j) * [ t_mm * M(i-1,j-1) + t_dm*t_md * M(i-2,j-1)
//                           + t_im*t_mi*m_{j-1} * M(i-1,j-2) ]
//
// K3 (vlt_pairhmm_general) replaces pallas_pairhmm.py:_kernel_general
// (_general_body): three states M/I/D with constant finite extensions; the
// within-column recurrence D(i) = t_md*M(i-1) + t_dd*D(i-1) is a prefix scan.
//
// K4 (vlt_pairhmm_positional) replaces pallas_pairhmm.py:_kernel_positional
// (_general_body with per-position gaps): K3 with the insertion open / extend
// of read base j (io_j, ie_j) and the deletion open / extend of allele row k
// (do_k, de_k) in place of the constants, as the TPU kernel indexes them:
// t_mm = max(1 - io_j - do_k, 1e-12), t_dm = 1 - de_k (times D(k-1) of the
// previous column), t_im = 1 - ie_j, t_mi = io_j, t_ii = ie_j, and
// D(k) = do_k*M(k-1) + de_k*D(k-1) within the column.
//
// All three: linear-space float32, each work item rescaled by 1e16 when its
// column maximum falls below 1e-16 (its log scale kept aside), free start and
// end on the allele axis, the read consumed in full.  The result is
// log(sum of the last column) - scale, or -1e30 when that sum is 0.  The
// caller masks empty reads (packed as one pad column) to -1e30.
//
// Inputs are the host's row-major uint8 panels: allele [B, Xp], read and
// PHRED qual [B, Yp]; alen / rlen [B] int32 (1 <= rlen <= Yp); coef [4] or [7]
// float32 on the device (K2, K3); io / ie [B, Yp] and do / de [B, Xp] LINEAR
// float32 (K4, zero past each item's length).  The uppercase fold and PHRED ->
// miscall happen here.
//
// What bounds it on an H100: the dependency chain of the column loop.  A
// work item is ~X*Y cells of ~10 flops each, and its columns are sequential,
// so the card is filled by running many items at once; bytes are no limit
// (the panels are read once, ~1 byte per cell row/column).
//
// Design up to Xp = 1024 (pairhmm_exact_tiled_kernel,
// pairhmm_general_tiled_kernel, pairhmm_positional_tiled_kernel; one body,
// tiled_forward, over a tile type: ExactTile for K2, GeneralTile with a POS
// flag for K3 and K4): L = 8, 16 or 32 lanes per item and 32/L items per
// warp, one warp per block, R rows per lane, the tile (L, R) chosen by the
// caller (ops/pairhmm_column.py:exact_tile, general_tile, positional_tile)
// so that L*R covers Xp with little padding and R is large: the per-column
// cost (shuffles, the group maximum, K3's and K4's D scan carries, log2 L
// steps each) is shared by more rows.  Every shuffle has width L, so the
// items of a warp stay apart; the warp runs to its longest read and each
// item keeps its sums at its own rlen.  What is the same for every column
// (allele bytes, the rows' validity, the D scan's in-lane and carry
// factors, K4's do / de and 1 - de) is set once per item, what is the same
// for every row of a column (the emission's two candidates, K2's
// c_ins*m_{j-1}, K4's io_j, ie_j, 1 - io_j, 1 - ie_j) once per column, and
// the free-start terms have columns of their own (K2: columns 1 and 2; K3
// and K4: column 1).  K2's cell is then w * e * (t_mm*M(i-1,j-1) +
// c_del*M(i-2,j-1) + c_im*M(i-1,j-2)), its lane keeps M of two columns,
// three shuffles per column bring the left lane's last two rows of column
// j-1 and last row of column j-2, and the loop takes two columns per step,
// so that the two column arrays trade places without register copies.  K4's cell adds two instructions to K3's:
// t_mm = max((1 - io_j) - do_k, 1e-12).  The item's maximum is tested for
// the rescale in every column.
//
// Over 1024 rows a work item is one block of W = ceil(Xp/1024) warps, 32
// rows per lane (tile (32, 32)): the i-1 and i-2 shifts are register moves
// plus one __shfl_up_sync at the lane boundary and shared memory at a warp
// boundary; the read base and miscall of a column are broadcast from the
// lane that loaded them (32 columns per coalesced load); the column maximum
// and the last column's sums are reductions over the warps.  The D scan of
// K3 and K4 runs sequentially inside a lane and as a Kogge-Stone scan of
// affine carries over lanes (and over warps, in order), which is exact up
// to float rounding, as the TPU kernel's log-shift scan is.  The carry
// factors are products of the extension over the rows spanned (t_dd^n for
// K3, products of de for K4); they do not change from column to column, so
// each lane computes its factors once per item and each column scans only
// the carried values.  The column loop stops at the item's own rlen, which
// gives what the TPU kernel's frozen output gives.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float RESCALE_THRESH = 1e-16f;
constexpr float RESCALE = 1e16f;
constexpr float LOG_RESCALE = 36.841361487904734f;  // log(1e16)
constexpr float EMPTY = -1e30f;
constexpr float NEG_LN10_10 = -0.23025850929940458f;  // -ln(10)/10
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 32;        // warps of one item: Xp <= 32*32*32

// Shared scratch of the multi-warp items (Xp > 1024).
struct Scratch {
  float bnd[3][MAX_WARPS];   // lane 31's last values of each warp, previous column
  float mx[MAX_WARPS];       // per-warp column maxima
  float sum[2][MAX_WARPS];   // per-warp sums of the last column
  float carry[MAX_WARPS];    // K3, K4: per-warp D-scan totals of the column
  float carry_a[MAX_WARPS];  // K3, K4: per-warp carry factors (set once)
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Maximum over the item's warps.
__device__ __forceinline__ float item_max(float v, Scratch& s, int w, int W,
                                          int lane) {
  v = warp_max(v);
  if (lane == 0) s.mx[w] = v;
  __syncthreads();
  float r = s.mx[0];
  for (int k = 1; k < W; ++k) r = fmaxf(r, s.mx[k]);
  return r;
}

// Sums of two values over the item's warps (warp partials added in order).
__device__ __forceinline__ void item_sum2(float& a, float& b, Scratch& s, int w,
                                          int W, int lane) {
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    s.sum[0][w] = a;
    s.sum[1][w] = b;
  }
  __syncthreads();
  a = 0.0f;
  b = 0.0f;
  for (int k = 0; k < W; ++k) {
    a += s.sum[0][k];
    b += s.sum[1][k];
  }
}

// The value of the lane to the left (allele positions below p0): within the
// warp by shuffle, across a warp boundary from the previous column's shared
// copy, and `edge` for the item's first lane.
__device__ __forceinline__ float from_left(float mine, const float* bnd, int w,
                                           int lane, float edge) {
  float v = __shfl_up_sync(FULL, mine, 1);
  if (lane == 0) v = w > 0 ? bnd[w - 1] : edge;
  return v;
}

// Publish lane 31's last values for the next column's left neighbours.
__device__ __forceinline__ void publish(Scratch& s, int w, int lane, float b0,
                                        float b1, float b2) {
  if (lane == 31) {
    s.bnd[0][w] = b0;
    s.bnd[1][w] = b1;
    s.bnd[2][w] = b2;
  }
  __syncthreads();
}

__device__ __forceinline__ float emission(uint8_t a, bool valid, uint8_t rj,
                                          float mj) {
  if (!valid) return 0.0f;
  if (a == rj) return 1.0f - mj;
  return rj == 'N' ? 0.25f : mj * (1.0f / 3.0f);
}

// Read base and miscall of column j (1-based), and with POS (K4) the
// column's insertion open / extend, broadcast from the lane that holds them;
// every 32 columns the warp loads the next 32 with one access per panel.
template <bool POS>
struct ReadCursor {
  const uint8_t* read;
  const uint8_t* qual;
  const float* io;  // POS only
  const float* ie;
  int Yp;
  int base = 0;
  float mis = 0.0f, o = 0.0f, e = 0.0f;

  __device__ __forceinline__ void get(int j, int lane, uint8_t& rj, float& mj) {
    const int idx = j - 1;
    if ((idx & 31) == 0) {
      const int c = idx + lane;
      base = c < Yp ? (read[c] & 0xDF) : 0;
      mis = expf((c < Yp ? (float)qual[c] : 0.0f) * NEG_LN10_10);
      if (POS) {
        o = c < Yp ? io[c] : 0.0f;
        e = c < Yp ? ie[c] : 0.0f;
      }
    }
    rj = (uint8_t)__shfl_sync(FULL, base, idx & 31);
    mj = __shfl_sync(FULL, mis, idx & 31);
  }

  // io_j, ie_j of the column last passed to get()
  __device__ __forceinline__ void gaps(int j, float& oj, float& ej) const {
    oj = __shfl_sync(FULL, o, (j - 1) & 31);
    ej = __shfl_sync(FULL, e, (j - 1) & 31);
  }
};

struct ItemIndex {
  int item, w, lane, p0;
};

// One block of W warps per item.  Lane `lane` of warp `w` holds allele rows
// p0 .. p0+R-1 (row k is allele position k+1).
template <int R>
__device__ __forceinline__ ItemIndex item_index() {
  ItemIndex ix;
  ix.lane = threadIdx.x & 31;
  ix.item = blockIdx.x;
  ix.w = threadIdx.x >> 5;
  ix.p0 = (ix.w * 32 + ix.lane) * R;
  return ix;
}

template <int R>
__device__ __forceinline__ void load_allele(const uint8_t* row, int Xp, int p0,
                                            uint8_t (&al)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = p0 + r;
    al[r] = p < Xp ? (row[p] & 0xDF) : 0;
  }
}

// ---------------------------------------------------------------------------
// K2 over 1024 rows: zero gap extension, W warps per item
// ---------------------------------------------------------------------------

template <int R>
__global__ void __launch_bounds__(1024)
pairhmm_exact_kernel(const uint8_t* __restrict__ allele,
                     const uint8_t* __restrict__ read,
                     const uint8_t* __restrict__ qual,
                     const int* __restrict__ alen_p,
                     const int* __restrict__ rlen_p,
                     const float* __restrict__ coef, float* __restrict__ out,
                     int B, int Xp, int Yp, int W) {
  __shared__ Scratch s;
  const ItemIndex ix = item_index<R>();
  const long long item = ix.item;  // the grid is exact
  const float t_mm = coef[0], c_del = coef[1], c_ins = coef[2], t_mi = coef[3];
  const int alen = alen_p[item];
  const int rlen = min(max(rlen_p[item], 1), Yp);

  uint8_t al[R];
  load_allele<R>(allele + item * Xp, Xp, ix.p0, al);
  float p1[R], p2[R];  // M of column j-1, and of column j-2 (scaled)
#pragma unroll
  for (int r = 0; r < R; ++r) p1[r] = p2[r] = 0.0f;
  publish(s, ix.w, ix.lane, 0.0f, 0.0f, 0.0f);

  ReadCursor<false> rc{read + item * Yp, qual + item * Yp, nullptr, nullptr, Yp};
  float scale = 0.0f, mprev = 0.0f, m1 = 0.0f;
  for (int j = 1; j <= rlen; ++j) {
    uint8_t rj;
    float mj;
    rc.get(j, ix.lane, rj, mj);
    if (j == 1) m1 = mj;
    const float up1 = from_left(p1[R - 1], s.bnd[0], ix.w, ix.lane, 0.0f);
    const float up2 = from_left(p1[R - 2], s.bnd[1], ix.w, ix.lane, 0.0f);
    const float uq1 = from_left(p2[R - 1], s.bnd[2], ix.w, ix.lane, 0.0f);
    // free start: M at column 1, and the insertion at column 1 into column 2
    const float start = (j == 1) ? expf(-scale)
                        : (j == 2 ? c_ins * m1 * expf(-scale) : 0.0f);
    const float c_im = c_ins * mprev;
    float cmax = 0.0f;
    // descending, so that rows r-1 and r-2 still hold column j-1
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
      const int r1 = r >= 1 ? r - 1 : 0;
      const int r2 = r >= 2 ? r - 2 : 0;
      const float sh1 = r >= 1 ? p1[r1] : up1;
      const float sh2 = r >= 2 ? p1[r2] : (r == 1 ? up1 : up2);
      const float ins1 = r >= 1 ? p2[r1] : uq1;
      const float bracket = t_mm * sh1 + c_del * sh2 + c_im * ins1;
      const float col = emission(al[r], ix.p0 + r < alen, rj, mj) * (bracket + start);
      p2[r] = p1[r];
      p1[r] = col;
      cmax = fmaxf(cmax, col);
    }
    cmax = item_max(cmax, s, ix.w, W, ix.lane);
    if (cmax > 0.0f && cmax < RESCALE_THRESH) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        p1[r] *= RESCALE;
        p2[r] *= RESCALE;
      }
      scale += LOG_RESCALE;
    }
    if (j == rlen) {
      // free end on the allele axis: all M and I cells of the last column
      float m_sum = 0.0f, p_sum = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        m_sum += p1[r];
        p_sum += p2[r];
      }
      item_sum2(m_sum, p_sum, s, ix.w, W, ix.lane);
      const float i_sum = (j == 1)
          ? mj * t_mi * ((float)alen + 1.0f) * expf(-scale)
          : mj * t_mi * p_sum;
      const float fin = m_sum + i_sum;
      if (ix.w == 0 && ix.lane == 0)
        out[item] = (fin > 0.0f ? logf(fin) : EMPTY) - scale;
    }
    mprev = mj;
    publish(s, ix.w, ix.lane, p1[R - 1], p1[R - 2], p2[R - 1]);
  }
}

// ---------------------------------------------------------------------------
// K3: constant finite extensions, three states; K4 (POS): positional gaps
// ---------------------------------------------------------------------------

// K4's gap panels (LINEAR): io / ie [B, Yp] per read base, do / de [B, Xp]
// per allele row; all null for K2 and K3.
struct GapPanels {
  const float* io;
  const float* ie;
  const float* dop;
  const float* dep;
};

template <int R, bool POS>
__global__ void __launch_bounds__(1024)
pairhmm_general_kernel(const uint8_t* __restrict__ allele,
                       const uint8_t* __restrict__ read,
                       const uint8_t* __restrict__ qual,
                       const int* __restrict__ alen_p,
                       const int* __restrict__ rlen_p,
                       const float* __restrict__ coef, const GapPanels gp,
                       float* __restrict__ out, int B, int Xp, int Yp, int W) {
  __shared__ Scratch s;
  const ItemIndex ix = item_index<R>();
  const long long item = ix.item;
  // K3's constants.  K4 sets t_im, t_mi, t_ii per column from io_j / ie_j,
  // and t_mm, t_dm and the scan's t_md, t_dd per row from do / de.
  float t_mm = 0.0f, t_dm = 0.0f, t_im = 0.0f, t_mi = 0.0f;
  float t_md = 0.0f, t_ii = 0.0f, t_dd = 0.0f;
  if (!POS) {
    t_mm = coef[0], t_dm = coef[1], t_im = coef[2], t_mi = coef[3];
    t_md = coef[4], t_ii = coef[5], t_dd = coef[6];
  }
  const int alen = alen_p[item];
  const int rlen = min(max(rlen_p[item], 1), Yp);

  // K4: deletion open / extend of rows p0 .. p0+R.  Row p0+R is the next
  // lane's first: this lane's E(p0+R-1) = D(p0+R) closes with it.
  float dop[R + 1], dex[R + 1];  // unused (and dropped) for K3
  if (POS) {
#pragma unroll
    for (int r = 0; r <= R; ++r) {
      const int p = ix.p0 + r;
      dop[r] = p < Xp ? gp.dop[item * Xp + p] : 0.0f;
      dex[r] = p < Xp ? gp.dep[item * Xp + p] : 0.0f;
    }
  }
  // Carry factors of the D scan, the same in every column: ks[k], the factor
  // of this lane's carry at Kogge-Stone step k (the product over the 2^k
  // lanes it spans then); a_left, from the warp's first row to this lane's
  // first; s.carry_a[w], across warp w.  K3: powers of t_dd^R.  K4: products
  // of de, scanned once.
  float ks[5], a_left;
  if (POS) {
    float a = 1.0f;
#pragma unroll
    for (int r = 1; r <= R; ++r) a *= dex[r];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      ks[k] = a;
      const float v = __shfl_up_sync(FULL, a, 1 << k);
      if (ix.lane >= (1 << k)) a *= v;
    }
    a_left = __shfl_up_sync(FULL, a, 1);
    if (ix.lane == 31) s.carry_a[ix.w] = a;
  } else {
    const float a_lane = powf(t_dd, (float)R);
    float a = a_lane;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      ks[k] = a;
      a *= a;
    }
    a_left = powf(a_lane, (float)ix.lane);
    if (ix.lane == 31) s.carry_a[ix.w] = powf(t_dd, (float)(32 * R));
  }

  uint8_t al[R];
  load_allele<R>(allele + item * Xp, Xp, ix.p0, al);
  float m[R], ip[R], d[R];  // M, I, D of the previous column
#pragma unroll
  for (int r = 0; r < R; ++r) m[r] = ip[r] = d[r] = 0.0f;
  publish(s, ix.w, ix.lane, 0.0f, 0.0f, 0.0f);  // also publishes carry_a

  ReadCursor<POS> rc{read + item * Yp, qual + item * Yp,
                     POS ? gp.io + item * Yp : nullptr,
                     POS ? gp.ie + item * Yp : nullptr, Yp};
  float scale = 0.0f, i0 = 0.0f;  // i0: I before allele position 1
  for (int j = 1; j <= rlen; ++j) {
    uint8_t rj;
    float mj, io_j = 0.0f;
    rc.get(j, ix.lane, rj, mj);
    if (POS) {
      float ie_j;
      rc.gaps(j, io_j, ie_j);
      t_im = 1.0f - ie_j;
      t_mi = io_j;
      t_ii = ie_j;
    }
    const float um = from_left(m[R - 1], s.bnd[0], ix.w, ix.lane, 0.0f);
    const float ud = from_left(d[R - 1], s.bnd[1], ix.w, ix.lane, 0.0f);
    const float ui = from_left(ip[R - 1], s.bnd[2], ix.w, ix.lane, i0);
    const float startm = (j == 1) ? expf(-scale) : 0.0f;
    const float start_i = (j == 1) ? mj * t_mi : 0.0f;
    float cmax = 0.0f;
    // descending, so that row r-1 still holds column j-1
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
      const int r1 = r >= 1 ? r - 1 : 0;
      const float ms = r >= 1 ? m[r1] : um;
      const float ds = r >= 1 ? d[r1] : ud;
      const float is = r >= 1 ? ip[r1] : ui;
      const bool valid = ix.p0 + r < alen;
      const float tmm = POS ? fmaxf(1.0f - io_j - dop[r], 1e-12f) : t_mm;
      const float tdm = POS ? 1.0f - dex[r] : t_dm;
      const float mc = emission(al[r], valid, rj, mj) *
                       (tmm * ms + tdm * ds + t_im * is + startm);
      const float ic = mj * (t_mi * m[r] + t_ii * ip[r]) + (valid ? start_i : 0.0f);
      m[r] = mc;
      ip[r] = ic;
      cmax = fmaxf(cmax, fmaxf(mc, ic));
    }
    float i0c = mj * t_ii * i0 + start_i;
    cmax = item_max(cmax, s, ix.w, W, ix.lane);
    if (cmax > 0.0f && cmax < RESCALE_THRESH) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        m[r] *= RESCALE;
        ip[r] *= RESCALE;
      }
      i0c *= RESCALE;
      scale += LOG_RESCALE;
    }

    // D of this column.  E(k) = D(k+1) = t_md(k+1)*M(k) + t_dd(k+1)*E(k-1)
    // needs no neighbour's M: scan E inside the lane from a zero carry, then
    // carry in E(p0-1) from the lanes (and warps) to the left.
    float e_loc[R];
    e_loc[0] = (POS ? dop[1] : t_md) * m[0];
#pragma unroll
    for (int r = 1; r < R; ++r)
      e_loc[r] = (POS ? dop[r + 1] : t_md) * m[r] + (POS ? dex[r + 1] : t_dd) * e_loc[r - 1];
    float incl = e_loc[R - 1];  // inclusive over lanes, zero carry into lane 0
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float v = __shfl_up_sync(FULL, incl, 1 << k);
      if (ix.lane >= (1 << k)) incl += ks[k] * v;
    }
    float c_warp = 0.0f;  // E at the last row of the previous warp
    if (ix.lane == 31) s.carry[ix.w] = incl;
    __syncthreads();
    for (int k = 0; k < ix.w; ++k) c_warp = s.carry[k] + s.carry_a[k] * c_warp;
    const float left = __shfl_up_sync(FULL, incl, 1);
    const float c_in = ix.lane == 0 ? c_warp : left + a_left * c_warp;  // E(p0-1)
    float t_pow = 1.0f;  // the extension's product over rows p0+1 .. p0+r
    d[0] = c_in;
#pragma unroll
    for (int r = 1; r < R; ++r) {
      t_pow *= POS ? dex[r] : t_dd;
      d[r] = e_loc[r - 1] + t_pow * c_in;
    }

    if (j == rlen) {
      float m_sum = 0.0f, i_sum = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        m_sum += m[r];
        i_sum += ip[r];
      }
      item_sum2(m_sum, i_sum, s, ix.w, W, ix.lane);
      const float fin = m_sum + i_sum + i0c;
      if (ix.w == 0 && ix.lane == 0)
        out[item] = (fin > 0.0f ? logf(fin) : EMPTY) - scale;
    }
    i0 = i0c;
    publish(s, ix.w, ix.lane, m[R - 1], d[R - 1], ip[R - 1]);
  }
}

// ---------------------------------------------------------------------------
// K3 at L lanes per item (Xp <= 1024): 32/L items share a warp
// ---------------------------------------------------------------------------

// Reductions, shifts and broadcasts over the L lanes of one item: the
// `width` argument keeps every shuffle inside its group, so the groups of a
// warp never see each other's values.
template <int L>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o, L));
  return v;
}

template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o, L);
  return v;
}

// The value of the group's lane to the left, `edge` for its first lane.
template <int L>
__device__ __forceinline__ float group_left(float mine, int g, float edge) {
  const float v = __shfl_up_sync(FULL, mine, 1, L);
  return g == 0 ? edge : v;
}

// Read base and miscall of column j (1-based) of the group's item, and with
// POS (K4) the column's insertion open / extend: every L columns each lane
// loads one column, then the group broadcasts them.
template <int L, bool POS>
struct GroupCursor {
  const uint8_t* read;
  const uint8_t* qual;
  const float* io;  // POS only
  const float* ie;
  int Yp;
  int base = 0;
  float mis = 0.0f, o = 0.0f, e = 0.0f;

  __device__ __forceinline__ void get(int j, int g, int& rj, float& mj, float& oj,
                                      float& ej) {
    const int idx = j - 1;
    if ((idx & (L - 1)) == 0) {
      const int c = idx + g;
      base = c < Yp ? (read[c] & 0xDF) : 0;
      mis = expf((c < Yp ? (float)qual[c] : 0.0f) * NEG_LN10_10);
      if (POS) {
        o = c < Yp ? io[c] : 0.0f;
        e = c < Yp ? ie[c] : 0.0f;
      }
    }
    rj = __shfl_sync(FULL, base, idx & (L - 1), L);
    mj = __shfl_sync(FULL, mis, idx & (L - 1), L);
    if (POS) {
      oj = __shfl_sync(FULL, o, idx & (L - 1), L);
      ej = __shfl_sync(FULL, e, idx & (L - 1), L);
    }
  }
};

// One lane of a K3 (or, POS, K4) item at L lanes x R rows: allele rows
// p0 .. p0+R-1, the item's constants and what the lane needs of them, and
// the column step.  Everything that does not change along the read is set
// once per item: the upper-cased allele bytes, the rows' validity as a
// weight (0 past alen), the D scan's in-lane factors (K3 t_dd^r, K4 the
// prefix products of de) and its Kogge-Stone carry factors, and K4's do /
// de of the lane's rows and 1 - de.  Per column, the emission's two
// candidates and mj*t_mi, mj*t_ii (K4 also t_im = 1 - ie_j and 1 - io_j)
// are taken once for all rows; column 1 is its own instantiation, so the
// free-start terms leave the loop.
template <int L, int R, bool POS>
struct GeneralTile {
  static constexpr int LOG_L = L == 8 ? 3 : (L == 16 ? 4 : 5);
  float t_mm, t_dm, t_im, t_mi, t_md, t_ii, t_dd;  // K4: t_im, t_mi, t_ii per column
  float ks[LOG_L];  // factor of the carry at Kogge-Stone step k: K3 t_dd^(R*2^k),
                    // K4 the product of de over the 2^k lanes it spans
  float tpow[R];    // K3 t_dd^r, K4 de(p0+1) * ... * de(p0+r)
  float dop[R + 1], dex[R + 1];  // K4: do, de of rows p0 .. p0+R (the next lane's first)
  float tdm[R];     // K4: 1 - de of rows p0 .. p0+R-1
  float c_io = 0.0f;  // K4: 1 - io_j of the column
  float w[R];       // 1 on the item's allele rows, 0 past alen
  int al[R];        // allele bytes, upper case
  int g;
  float m[R], ip[R], d[R];  // M, I, D of the previous column
  float i0 = 0.0f, scale = 0.0f;  // i0: I before allele position 1
  float fin_m = 0.0f, fin_i = 0.0f, fin_i0 = 0.0f, fin_scale = 0.0f;  // at j = rlen

  // coef: K3's [7] constants; gdo / gde: K4's do / de rows of the item
  __device__ __forceinline__ void init(const float* coef, const float* gdo, const float* gde,
                                       const uint8_t* row, int Xp, int alen, int lane) {
    g = lane;
    const int p0 = g * R;
    if constexpr (POS) {
#pragma unroll
      for (int r = 0; r <= R; ++r) {
        const int p = p0 + r;
        dop[r] = p < Xp ? gdo[p] : 0.0f;
        dex[r] = p < Xp ? gde[p] : 0.0f;
      }
      tpow[0] = 1.0f;
#pragma unroll
      for (int r = 1; r < R; ++r) tpow[r] = tpow[r - 1] * dex[r];
      float a = tpow[R - 1] * dex[R];  // the lane's product of de
#pragma unroll
      for (int k = 0; k < LOG_L; ++k) {
        ks[k] = a;
        const float v = __shfl_up_sync(FULL, a, 1 << k, L);
        if (g >= (1 << k)) a *= v;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) tdm[r] = 1.0f - dex[r];
    } else {
      t_mm = coef[0], t_dm = coef[1], t_im = coef[2], t_mi = coef[3];
      t_md = coef[4], t_ii = coef[5], t_dd = coef[6];
      float a = powf(t_dd, (float)R);
#pragma unroll
      for (int k = 0; k < LOG_L; ++k) {
        ks[k] = a;
        a *= a;
      }
      tpow[0] = 1.0f;
#pragma unroll
      for (int r = 1; r < R; ++r) tpow[r] = tpow[r - 1] * t_dd;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = p0 + r;
      al[r] = p < Xp ? (row[p] & 0xDF) : 0;
      w[r] = p < alen ? 1.0f : 0.0f;
      m[r] = ip[r] = d[r] = 0.0f;
    }
  }

  // oj, ej: K4's io_j, ie_j of the column
  template <bool FIRST>
  __device__ __forceinline__ void column(int j, int rlen, int rj, float mj, float oj,
                                         float ej) {
    if constexpr (POS) {
      t_mi = oj;
      t_ii = ej;
      t_im = 1.0f - ej;
      c_io = 1.0f - oj;
    }
    const float em_match = 1.0f - mj;
    const float em_mis = rj == 'N' ? 0.25f : mj * (1.0f / 3.0f);
    const float mi = mj * t_mi, ii = mj * t_ii;
    float mx[R];
    if (FIRST) {
      // nothing before column 1: M = e_m (free start), I = mj*t_mi
#pragma unroll
      for (int r = 0; r < R; ++r) {
        m[r] = w[r] * (al[r] == rj ? em_match : em_mis);
        ip[r] = w[r] * mi;
        mx[r] = fmaxf(m[r], ip[r]);
      }
    } else {
      const float um = group_left<L>(m[R - 1], g, 0.0f);
      const float ud = group_left<L>(d[R - 1], g, 0.0f);
      const float ui = group_left<L>(ip[R - 1], g, i0);
      // descending, so that row r-1 still holds column j-1
#pragma unroll
      for (int r = R - 1; r >= 0; --r) {
        const float ms = r >= 1 ? m[r > 0 ? r - 1 : 0] : um;
        const float ds = r >= 1 ? d[r > 0 ? r - 1 : 0] : ud;
        const float is = r >= 1 ? ip[r > 0 ? r - 1 : 0] : ui;
        const float e = w[r] * (al[r] == rj ? em_match : em_mis);
        // K4: t_mm = max(1 - io_j - do_k, 1e-12) rounded as the plain version
        // rounds it, t_dm = 1 - de_k
        const float tmm = POS ? fmaxf(c_io - dop[r], 1e-12f) : t_mm;
        const float tdm_r = POS ? tdm[r] : t_dm;
        const float mc = e * (tmm * ms + tdm_r * ds + t_im * is);
        const float ic = mi * m[r] + ii * ip[r];
        m[r] = mc;
        ip[r] = ic;
        mx[r] = fmaxf(mc, ic);
      }
    }
    float i0c = FIRST ? mi : ii * i0;
#pragma unroll
    for (int s = 1; s < R; s *= 2)
#pragma unroll
      for (int r = 0; r + s < R; r += 2 * s) mx[r] = fmaxf(mx[r], mx[r + s]);
    const float cmax = group_max<L>(mx[0]);
    if (cmax > 0.0f && cmax < RESCALE_THRESH) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        m[r] *= RESCALE;
        ip[r] *= RESCALE;
      }
      i0c *= RESCALE;
      scale += LOG_RESCALE;
    }

    // D of this column: E(k) = D(k+1) = t_md*M(k) + t_dd*E(k-1) (K4:
    // do(k+1), de(k+1)), scanned in the lane from a zero carry, then E(p0-1)
    // carried in from the lanes to the left
    float e_loc[R];
    e_loc[0] = (POS ? dop[1] : t_md) * m[0];
#pragma unroll
    for (int r = 1; r < R; ++r)
      e_loc[r] = (POS ? dop[r + 1] : t_md) * m[r] + (POS ? dex[r + 1] : t_dd) * e_loc[r - 1];
    float incl = e_loc[R - 1];
#pragma unroll
    for (int k = 0; k < LOG_L; ++k) {
      const float v = __shfl_up_sync(FULL, incl, 1 << k, L);
      if (g >= (1 << k)) incl += ks[k] * v;
    }
    const float c_in = group_left<L>(incl, g, 0.0f);  // E(p0-1)
    d[0] = c_in;
#pragma unroll
    for (int r = 1; r < R; ++r) d[r] = e_loc[r - 1] + tpow[r] * c_in;

    if (j == rlen) {  // the item's last column; the group sums after the loop
      fin_m = fin_i = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        fin_m += m[r];
        fin_i += ip[r];
      }
      fin_i0 = i0c;
      fin_scale = scale;
    }
    i0 = i0c;
  }

  // columns 1 .. jmax of the read, the warp's longest
  __device__ __forceinline__ void columns(GroupCursor<L, POS>& rc, int rlen, int jmax) {
    int rj;
    float mj, oj = 0.0f, ej = 0.0f;
    rc.get(1, g, rj, mj, oj, ej);
    column<true>(1, rlen, rj, mj, oj, ej);
    for (int j = 2; j <= jmax; ++j) {
      rc.get(j, g, rj, mj, oj, ej);
      column<false>(j, rlen, rj, mj, oj, ej);
    }
  }

  // the item's final sum, on every lane of the group
  __device__ __forceinline__ float finish() const {
    const float m_sum = group_sum<L>(fin_m);
    const float i_sum = group_sum<L>(fin_i);
    return m_sum + i_sum + fin_i0;
  }
};

// One lane of a K2 item at L lanes x R rows: allele rows p0 .. p0+R-1 of
// the columns j-1 and j-2, and the column step.  Set once per item: the
// upper-cased allele bytes and the rows' validity as a weight (0 past
// alen).  Per column, the emission's two candidates and c_ins*m_{j-1} are
// taken once for all rows, and three width-L shuffles bring M(p0-1) and
// M(p0-2) of column j-1 and M(p0-1) of column j-2; a cell is then
// w * e * (t_mm*M(i-1,j-1) + c_del*M(i-2,j-1) + c_im*M(i-1,j-2)).  Columns
// 1 and 2 are their own instantiations, so the free-start terms (e^-scale
// at column 1, the insertion c_ins*m_1*e^-scale at column 2) leave the
// loop.  The two columns kept trade places: column j overwrites column j-2
// in pm[(j-1) & 1] (rows in descending order, so each row's old value has
// been read by the row above), and columns() steps two columns at a time,
// so no register is copied from one column to the next.
template <int L, int R>
struct ExactTile {
  static_assert(R >= 2, "the i-2 shift needs two rows per lane");
  float t_mm, c_del, c_ins, t_mi;
  float w[R];    // 1 on the item's allele rows, 0 past alen
  int al[R];     // allele bytes, upper case
  int g, alen;
  float pm[2][R];  // M of columns j-1 and j-2 (scaled); column j in pm[(j-1) & 1]
  float scale = 0.0f, mprev = 0.0f, m1 = 0.0f;  // m1, mprev: miscall of columns 1, j-1
  // at j = rlen: the lane's sums of M(j) and M(j-1), mj*t_mi, and the
  // item's free-end insertion of a one-base read
  float fin_m = 0.0f, fin_p = 0.0f, fin_c = 0.0f, fin_i0 = 0.0f, fin_scale = 0.0f;

  // coef: K2's [4] constants; the gap rows are K4's and unused here
  __device__ __forceinline__ void init(const float* coef, const float*, const float*,
                                       const uint8_t* row, int Xp, int alen_, int lane) {
    g = lane;
    alen = alen_;
    t_mm = coef[0], c_del = coef[1], c_ins = coef[2], t_mi = coef[3];
    const int p0 = g * R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = p0 + r;
      al[r] = p < Xp ? (row[p] & 0xDF) : 0;
      w[r] = p < alen ? 1.0f : 0.0f;
      pm[0][r] = pm[1][r] = 0.0f;
    }
  }

  // COL 1 or 2: that column, 0: any later one; CUR: the array column j
  // goes to, (j-1) & 1
  template <int COL, int CUR = COL == 2>
  __device__ __forceinline__ void column(int j, int rlen, int rj, float mj) {
    static_assert(COL == 0 || CUR == (COL == 2), "column 1 goes to pm[0], column 2 to pm[1]");
    float(&p1)[R] = pm[1 - CUR];  // column j-1
    float(&p2)[R] = pm[CUR];      // column j-2, then column j
    const float em_match = 1.0f - mj;
    const float em_mis = rj == 'N' ? 0.25f : mj * (1.0f / 3.0f);
    float mx[R];
    if constexpr (COL == 1) {
      // nothing before column 1: M = e_m (free start, e^-0)
      m1 = mj;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        p2[r] = w[r] * (al[r] == rj ? em_match : em_mis);
        mx[r] = p2[r];
      }
    } else {
      const float up1 = group_left<L>(p1[R - 1], g, 0.0f);
      const float up2 = group_left<L>(p1[R - 2], g, 0.0f);
      // column 2: M of column 0 is 0, and the free-start insertion at
      // column 1 enters every row
      float uq1 = 0.0f;
      if constexpr (COL == 0) uq1 = group_left<L>(p2[R - 1], g, 0.0f);
      const float start = COL == 2 ? c_ins * m1 * expf(-scale) : 0.0f;
      const float c_im = c_ins * mprev;
      // descending, so that rows r-1 and r-2 still hold columns j-1 and j-2
#pragma unroll
      for (int r = R - 1; r >= 0; --r) {
        const float sh1 = r >= 1 ? p1[r >= 1 ? r - 1 : 0] : up1;
        const float sh2 = r >= 2 ? p1[r >= 2 ? r - 2 : 0] : (r == 1 ? up1 : up2);
        const float e = w[r] * (al[r] == rj ? em_match : em_mis);
        const float b = t_mm * sh1 + c_del * sh2;
        const float col = COL == 0 ? e * (b + c_im * (r >= 1 ? p2[r >= 1 ? r - 1 : 0] : uq1))
                                   : e * (b + start);
        p2[r] = col;
        mx[r] = col;
      }
    }
#pragma unroll
    for (int s = 1; s < R; s *= 2)
#pragma unroll
      for (int r = 0; r + s < R; r += 2 * s) mx[r] = fmaxf(mx[r], mx[r + s]);
    const float cmax = group_max<L>(mx[0]);
    if (cmax > 0.0f && cmax < RESCALE_THRESH) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        p1[r] *= RESCALE;
        p2[r] *= RESCALE;
      }
      scale += LOG_RESCALE;
    }
    if (j == rlen) {  // the item's last column; the group sums after the loop
      fin_m = fin_p = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        fin_m += p2[r];
        fin_p += p1[r];
      }
      fin_c = mj * t_mi;
      // free end: a one-base read's insertion after any of alen + 1 positions
      fin_i0 = COL == 1 ? mj * t_mi * ((float)alen + 1.0f) * expf(-scale) : 0.0f;
      fin_scale = scale;
    }
    mprev = mj;
  }

  // columns 1 .. jmax of the read, the warp's longest: 1 and 2, then two
  // per step, their arrays trading places
  __device__ __forceinline__ void columns(GroupCursor<L, false>& rc, int rlen, int jmax) {
    int rj;
    float mj, unused;
    rc.get(1, g, rj, mj, unused, unused);
    column<1>(1, rlen, rj, mj);
    if (jmax >= 2) {
      rc.get(2, g, rj, mj, unused, unused);
      column<2>(2, rlen, rj, mj);
    }
    for (int j = 3; j <= jmax; j += 2) {
      rc.get(j, g, rj, mj, unused, unused);
      column<0, 0>(j, rlen, rj, mj);
      if (j == jmax) break;
      rc.get(j + 1, g, rj, mj, unused, unused);
      column<0, 1>(j + 1, rlen, rj, mj);
    }
  }

  // the item's final sum, on every lane of the group
  __device__ __forceinline__ float finish() const {
    const float m_sum = group_sum<L>(fin_m);
    const float p_sum = group_sum<L>(fin_p);
    return m_sum + fin_c * p_sum + fin_i0;
  }
};

// K2, K3 or K4 (POS) for Xp <= L*R <= 1024, one lane of `Tile`
// (ExactTile or GeneralTile, which steps the columns): L lanes per item,
// 32/L items per warp, one warp per block.  The warp runs to its longest
// read; each item's sums are taken at its own rlen and written after the
// loop.  A group past B repeats the last item and writes nothing.
template <int L, bool POS, class Tile>
__device__ __forceinline__ void tiled_forward(const uint8_t* __restrict__ allele,
                                              const uint8_t* __restrict__ read,
                                              const uint8_t* __restrict__ qual,
                                              const int* __restrict__ alen_p,
                                              const int* __restrict__ rlen_p,
                                              const float* __restrict__ coef,
                                              const GapPanels& gp,
                                              float* __restrict__ out, int B, int Xp,
                                              int Yp) {
  const int g = threadIdx.x & (L - 1);
  const int slot = blockIdx.x * (32 / L) + threadIdx.x / L;
  const long long item = min(slot, B - 1);
  Tile t;
  t.init(coef, POS ? gp.dop + item * Xp : nullptr, POS ? gp.dep + item * Xp : nullptr,
         allele + item * Xp, Xp, alen_p[item], g);
  const int rlen = min(max(rlen_p[item], 1), Yp);
  const int jmax = __reduce_max_sync(FULL, rlen);
  GroupCursor<L, POS> rc{read + item * Yp, qual + item * Yp,
                         POS ? gp.io + item * Yp : nullptr,
                         POS ? gp.ie + item * Yp : nullptr, Yp};
  t.columns(rc, rlen, jmax);
  const float fin = t.finish();
  if (g == 0 && slot < B) out[item] = (fin > 0.0f ? logf(fin) : EMPTY) - t.fin_scale;
}

template <int L, int R>
__global__ void __launch_bounds__(32)
pairhmm_exact_tiled_kernel(const uint8_t* __restrict__ allele,
                           const uint8_t* __restrict__ read,
                           const uint8_t* __restrict__ qual,
                           const int* __restrict__ alen_p,
                           const int* __restrict__ rlen_p,
                           const float* __restrict__ coef,
                           float* __restrict__ out, int B, int Xp, int Yp) {
  tiled_forward<L, false, ExactTile<L, R>>(allele, read, qual, alen_p, rlen_p, coef,
                                           GapPanels{}, out, B, Xp, Yp);
}

template <int L, int R>
__global__ void __launch_bounds__(32)
pairhmm_general_tiled_kernel(const uint8_t* __restrict__ allele,
                             const uint8_t* __restrict__ read,
                             const uint8_t* __restrict__ qual,
                             const int* __restrict__ alen_p,
                             const int* __restrict__ rlen_p,
                             const float* __restrict__ coef,
                             float* __restrict__ out, int B, int Xp, int Yp) {
  tiled_forward<L, false, GeneralTile<L, R, false>>(allele, read, qual, alen_p, rlen_p,
                                                    coef, GapPanels{}, out, B, Xp, Yp);
}

template <int L, int R>
__global__ void __launch_bounds__(32)
pairhmm_positional_tiled_kernel(const uint8_t* __restrict__ allele,
                                const uint8_t* __restrict__ read,
                                const uint8_t* __restrict__ qual,
                                const int* __restrict__ alen_p,
                                const int* __restrict__ rlen_p, const GapPanels gp,
                                float* __restrict__ out, int B, int Xp, int Yp) {
  tiled_forward<L, true, GeneralTile<L, R, true>>(allele, read, qual, alen_p, rlen_p,
                                                  nullptr, gp, out, B, Xp, Yp);
}

// The tiles (lanes per item, rows per lane) of the K2, K3 and K4 kernels
// above; ops/pairhmm_column.py:GENERAL_TILES lists the same pairs.
#define VLT_GENERAL_TILES(X)                                                 \
  X(8, 4) X(8, 8) X(8, 12) X(8, 16) X(16, 6) X(16, 8) X(16, 10) X(16, 12)    \
  X(16, 16) X(32, 5) X(32, 6) X(32, 8) X(32, 12) X(32, 16) X(32, 24) X(32, 32)

enum Kind { EXACT, GENERAL, POSITIONAL };

// K2, K3 and K4: the tile (lanes, rows) is the caller's; Xp > 1024 takes the
// multi-warp kernels above, W warps of 32 rows per lane, as tile (32, 32).
template <Kind K>
int launch_tiled(const uint8_t* allele, const uint8_t* read, const uint8_t* qual,
                 const int* alen, const int* rlen, const float* coef,
                 const GapPanels& gp, float* out, int B, int Xp, int Yp, int lanes,
                 int rows, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Xp <= 0 || Yp <= 0 || Xp > MAX_WARPS * 32 * 32)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (Xp > 32 * 32) {
    if (lanes != 32 || rows != 32) return (int)cudaErrorInvalidValue;
    const int W = (Xp + 32 * 32 - 1) / (32 * 32);
    if constexpr (K == EXACT)
      pairhmm_exact_kernel<32><<<B, 32 * W, 0, st>>>(allele, read, qual, alen, rlen, coef,
                                                      out, B, Xp, Yp, W);
    else
      pairhmm_general_kernel<32, K == POSITIONAL><<<B, 32 * W, 0, st>>>(
          allele, read, qual, alen, rlen, coef, gp, out, B, Xp, Yp, W);
    return (int)cudaGetLastError();
  }
  if (lanes * rows < Xp) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + 32 / lanes - 1) / (32 / lanes));
#define VLT_TILE(l, r)                                                      \
  if (lanes == l && rows == r) {                                            \
    if constexpr (K == EXACT)                                               \
      pairhmm_exact_tiled_kernel<l, r><<<grid, 32, 0, st>>>(                \
          allele, read, qual, alen, rlen, coef, out, B, Xp, Yp);            \
    else if constexpr (K == POSITIONAL)                                     \
      pairhmm_positional_tiled_kernel<l, r><<<grid, 32, 0, st>>>(           \
          allele, read, qual, alen, rlen, gp, out, B, Xp, Yp);              \
    else                                                                    \
      pairhmm_general_tiled_kernel<l, r><<<grid, 32, 0, st>>>(              \
          allele, read, qual, alen, rlen, coef, out, B, Xp, Yp);            \
    return (int)cudaGetLastError();                                         \
  }
  VLT_GENERAL_TILES(VLT_TILE)
#undef VLT_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entries for ctypes.  They launch on `stream` and return
// cudaGetLastError() (0 = launched).  Device pointers: allele [B, Xp], read
// and qual [B, Yp] uint8 row-major; alen, rlen [B] int32; coef [4] (K2:
// t_mm, t_dm*t_md, t_im*t_mi, t_mi) or [7] (K3: t_mm, t_dm, t_im, t_mi, t_md,
// t_ii, t_dd) float32; K4: io, ie [B, Yp] and do, de [B, Xp] float32
// LINEAR; out [B] float32.  Each takes its tile: lanes per item and allele
// rows per lane, one of VLT_GENERAL_TILES with lanes*rows >= Xp, or (32, 32)
// for Xp > 1024.
extern "C" int vlt_pairhmm_exact(const uint8_t* allele, const uint8_t* read,
                                 const uint8_t* qual, const int* alen,
                                 const int* rlen, const float* coef, float* out,
                                 int B, int Xp, int Yp, int lanes, int rows,
                                 void* stream) {
  return launch_tiled<EXACT>(allele, read, qual, alen, rlen, coef, GapPanels{}, out, B, Xp,
                             Yp, lanes, rows, stream);
}

extern "C" int vlt_pairhmm_general(const uint8_t* allele, const uint8_t* read,
                                   const uint8_t* qual, const int* alen,
                                   const int* rlen, const float* coef,
                                   float* out, int B, int Xp, int Yp,
                                   int lanes, int rows, void* stream) {
  return launch_tiled<GENERAL>(allele, read, qual, alen, rlen, coef, GapPanels{}, out, B,
                               Xp, Yp, lanes, rows, stream);
}

extern "C" int vlt_pairhmm_positional(const uint8_t* allele,
                                      const uint8_t* read, const uint8_t* qual,
                                      const int* alen, const int* rlen,
                                      const float* io, const float* ie,
                                      const float* dop, const float* dep,
                                      float* out, int B, int Xp, int Yp,
                                      int lanes, int rows, void* stream) {
  return launch_tiled<POSITIONAL>(allele, read, qual, alen, rlen, nullptr,
                                  GapPanels{io, ie, dop, dep}, out, B, Xp, Yp, lanes, rows,
                                  stream);
}
