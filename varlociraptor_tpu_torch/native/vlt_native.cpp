// Native host runtime: parallel BGZF decompression + BAM record scanning.
//
// The reference links htslib for BAM/BCF decode (Cargo.toml:65); at pod scale
// the host-side decode must keep TPU chips fed (SURVEY.md §7.3), so the hot
// byte-level work lives here: multi-threaded BGZF block inflation and a
// single-pass BAM record scanner emitting a columnar index (offset, tid, pos,
// end_pos, flag, mapq) that Python queries with numpy searchsorted.
//
// Exposed via a plain C ABI consumed through ctypes (no pybind11 in image).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// BGZF
// ---------------------------------------------------------------------------

// Scan BGZF blocks; fills offsets/csizes/usizes (caller-allocated, cap
// max_blocks). Returns number of blocks, or -1 on error.
int64_t vlt_bgzf_index(const uint8_t* data, int64_t len, int64_t* offsets,
                       int32_t* csizes, int32_t* usizes, int64_t max_blocks) {
  int64_t pos = 0;
  int64_t n = 0;
  while (pos + 18 <= len && n < max_blocks) {
    if (data[pos] != 0x1f || data[pos + 1] != 0x8b) return -1;
    uint16_t xlen;
    std::memcpy(&xlen, data + pos + 10, 2);
    int64_t epos = pos + 12;
    int64_t eend = epos + xlen;
    int32_t bsize = -1;
    while (epos + 4 <= eend) {
      uint8_t si1 = data[epos], si2 = data[epos + 1];
      uint16_t slen;
      std::memcpy(&slen, data + epos + 2, 2);
      if (si1 == 66 && si2 == 67 && slen == 2) {
        uint16_t bs;
        std::memcpy(&bs, data + epos + 4, 2);
        bsize = (int32_t)bs + 1;
        break;
      }
      epos += 4 + slen;
    }
    if (bsize < 0) return -1;
    uint32_t isize;
    std::memcpy(&isize, data + pos + bsize - 4, 4);
    offsets[n] = pos;
    csizes[n] = bsize;
    usizes[n] = (int32_t)isize;
    ++n;
    pos += bsize;
    if ((int32_t)isize == 0 && bsize == 28) {
      // EOF block; keep scanning in case of concatenated files
    }
  }
  return n;
}

// Decompress all blocks (offsets/csizes/usizes from vlt_bgzf_index) into out
// at out_offsets, using nthreads. Returns 0 on success.
int32_t vlt_bgzf_inflate(const uint8_t* data, const int64_t* offsets,
                         const int32_t* csizes, const int32_t* usizes,
                         const int64_t* out_offsets, int64_t n_blocks,
                         uint8_t* out, int32_t nthreads) {
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> threads;
  std::vector<int32_t> errs(nthreads, 0);
  auto work = [&](int t) {
    for (int64_t i = t; i < n_blocks; i += nthreads) {
      const uint8_t* src = data + offsets[i];
      uint16_t xlen;
      std::memcpy(&xlen, src + 10, 2);
      const uint8_t* cdata = src + 12 + xlen;
      int64_t clen = csizes[i] - 12 - xlen - 8;
      z_stream zs;
      std::memset(&zs, 0, sizeof(zs));
      if (inflateInit2(&zs, -15) != Z_OK) {
        errs[t] = 1;
        return;
      }
      zs.next_in = const_cast<uint8_t*>(cdata);
      zs.avail_in = (uInt)clen;
      zs.next_out = out + out_offsets[i];
      zs.avail_out = (uInt)usizes[i];
      int r = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (r != Z_STREAM_END && !(r == Z_OK && usizes[i] == 0) &&
          !(r == Z_BUF_ERROR && usizes[i] == 0)) {
        errs[t] = 2;
        return;
      }
    }
  };
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
  for (int t = 0; t < nthreads; ++t)
    if (errs[t]) return errs[t];
  return 0;
}

// ---------------------------------------------------------------------------
// BAM record scan
// ---------------------------------------------------------------------------

static const uint32_t kConsumesRef = (1u << 0) | (1u << 2) | (1u << 3) |
                                     (1u << 7) | (1u << 8);  // M D N = X

// Scan BAM records starting at `pos` (just after header+refs). Emits columnar
// arrays. Returns record count, or -1 on error.
int64_t vlt_bam_scan(const uint8_t* data, int64_t len, int64_t start,
                     int64_t* rec_offsets, int32_t* tids, int32_t* positions,
                     int32_t* end_positions, uint16_t* flags, uint8_t* mapqs,
                     int64_t max_records) {
  int64_t pos = start;
  int64_t n = 0;
  while (pos + 4 <= len && n < max_records) {
    int32_t block_size;
    std::memcpy(&block_size, data + pos, 4);
    if (block_size < 32 || pos + 4 + block_size > len) return -1;
    const uint8_t* r = data + pos + 4;
    int32_t tid, p;
    std::memcpy(&tid, r, 4);
    std::memcpy(&p, r + 4, 4);
    uint8_t l_read_name = r[8];
    uint8_t mapq = r[9];
    uint16_t n_cigar, flag;
    std::memcpy(&n_cigar, r + 12, 2);
    std::memcpy(&flag, r + 14, 2);
    const uint8_t* cigar = r + 32 + l_read_name;
    int64_t ref_len = 0;
    for (uint16_t c = 0; c < n_cigar; ++c) {
      uint32_t op;
      std::memcpy(&op, cigar + 4 * c, 4);
      uint32_t kind = op & 0xF;
      if (kConsumesRef & (1u << kind)) ref_len += op >> 4;
    }
    rec_offsets[n] = pos;
    tids[n] = tid;
    positions[n] = p;
    end_positions[n] = p + (int32_t)ref_len;
    flags[n] = flag;
    mapqs[n] = mapq;
    ++n;
    pos += 4 + block_size;
  }
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Semiglobal edit distance with traceback (hot host kernel of the
// realignment pre-pass; mirrors the vectorized numpy DP in
// evidence/edit_distance.py::semiglobal_edit — free start/end gaps on the
// allele axis, read fully consumed). ops codes: 0=M 1=S 2=I 3=D.
// ---------------------------------------------------------------------------
static int32_t semiglobal_edit_core(
    const uint8_t* allele, int32_t x_len,
    const uint8_t* read, int32_t y_len,
    int32_t* out_start,
    uint8_t* out_ops,      // caller-provided buffer, >= x_len + y_len
    int32_t* out_n_ops,
    int32_t* out_last_start) {  // traceback start of the LAST co-optimal end
  if (x_len <= 0 || y_len <= 0) return -1;
  const int32_t W = y_len + 1;
  std::vector<int32_t> dp((size_t)(x_len + 1) * W);
  std::vector<uint8_t> a(x_len), r(y_len);
  for (int32_t i = 0; i < x_len; i++) a[i] = allele[i] & ~0x20;
  for (int32_t j = 0; j < y_len; j++) r[j] = read[j] & ~0x20;
  for (int32_t j = 0; j <= y_len; j++) dp[j] = j;  // leading read inserts
  for (int32_t i = 1; i <= x_len; i++) {
    int32_t* row = &dp[(size_t)i * W];
    const int32_t* prev = &dp[(size_t)(i - 1) * W];
    row[0] = 0;  // free start gap on allele axis
    const uint8_t ai = a[i - 1];
    for (int32_t j = 1; j <= y_len; j++) {
      int32_t best = prev[j - 1] + (ai != r[j - 1]);
      const int32_t del = prev[j] + 1;
      if (del < best) best = del;
      const int32_t ins = row[j - 1] + 1;
      if (ins < best) best = ins;
      row[j] = best;
    }
  }
  // best end over allele axis; also track the LAST co-optimal end
  // (the reference's hit window spans first..last placements,
  // edit_distance.rs:225-240)
  int32_t best_i = 0, dist = dp[y_len];
  for (int32_t i = 1; i <= x_len; i++) {
    const int32_t v = dp[(size_t)i * W + y_len];
    if (v < dist) { dist = v; best_i = i; }
  }
  int32_t last_i = best_i;
  for (int32_t i = x_len; i > best_i; i--) {
    if (dp[(size_t)i * W + y_len] == dist) { last_i = i; break; }
  }
  // traceback (same preference order as the python DP: diag, del, ins)
  int32_t i = best_i, j = y_len, n = 0;
  while (j > 0) {
    const int32_t cur = dp[(size_t)i * W + j];
    if (i > 0 && cur == dp[(size_t)(i - 1) * W + (j - 1)] + (a[i - 1] != r[j - 1])) {
      out_ops[n++] = (a[i - 1] == r[j - 1]) ? 0 : 1;
      i--; j--;
    } else if (i > 0 && cur == dp[(size_t)(i - 1) * W + j] + 1) {
      out_ops[n++] = 3;
      i--;
    } else if (cur == dp[(size_t)i * W + (j - 1)] + 1) {
      out_ops[n++] = 2;
      j--;
    } else {
      out_ops[n++] = 1;
      if (i > 0) i--;
      j--;
    }
  }
  // reverse ops in place
  for (int32_t k = 0; k < n / 2; k++) {
    const uint8_t t = out_ops[k];
    out_ops[k] = out_ops[n - 1 - k];
    out_ops[n - 1 - k] = t;
  }
  *out_start = i;
  *out_n_ops = n;
  if (out_last_start) {
    // start of the traceback from the last co-optimal end (ops discarded)
    int32_t li = last_i, lj = y_len;
    while (lj > 0) {
      const int32_t cur = dp[(size_t)li * W + lj];
      if (li > 0 && cur == dp[(size_t)(li - 1) * W + (lj - 1)] + (a[li - 1] != r[lj - 1])) {
        li--; lj--;
      } else if (li > 0 && cur == dp[(size_t)(li - 1) * W + lj] + 1) {
        li--;
      } else if (cur == dp[(size_t)li * W + (lj - 1)] + 1) {
        lj--;
      } else {
        if (li > 0) li--;
        lj--;
      }
    }
    *out_last_start = li;
  }
  return dist;
}

extern "C" int32_t vlt_semiglobal_edit(
    const uint8_t* allele, int32_t x_len,
    const uint8_t* read, int32_t y_len,
    int32_t* out_start, uint8_t* out_ops, int32_t* out_n_ops,
    int32_t* out_last_start) {
  return semiglobal_edit_core(allele, x_len, read, y_len,
                              out_start, out_ops, out_n_ops, out_last_start);
}

// ---------------------------------------------------------------------------
// Diagonally-banded semiglobal edit DP with compact band-only storage.
//
// Cells with i - j outside [dlo, dhi] are +INF.  When the band comes from a
// Myers scan with distance d < y_len (every <=d-edit path to a known end
// stays within d diagonals of that end, and every traceback-condition
// neighbor of an optimal cell is itself on an optimal path — hence in-band
// with its exact full-DP value), dist, the first/last co-optimal ends AND
// the tie-broken traceback are identical to the full DP's.  The d < y_len
// caller gate excludes the all-insert i=0 tie (full DP would tie-break to
// placement i=0 at dist == y_len, which no banded end can represent).
// Storage: (x_len+1) rows of bw = dhi - dlo + 1 slots; slot 0 of row i is
// j = i - dhi, so the (i-1, j-1) / (i-1, j) predecessors sit at constant
// offsets 0 / +1.  Returns -2 when the band missed every end.
// ---------------------------------------------------------------------------
static inline int32_t band_get(const int32_t* dp, int32_t bw, int32_t dhi,
                               int32_t y_len, int32_t i, int32_t j) {
  if (j == 0) return i == 0 ? 0 : 0;  // free start gap (row 0: dp[0][0]=0 too)
  if (i == 0) return j;               // leading read inserts
  const int32_t k = j - (i - dhi);
  if (k < 0 || k >= bw || j > y_len) return 1 << 28;
  return dp[(size_t)i * bw + k];
}

static int32_t semiglobal_edit_banded(
    const uint8_t* allele, int32_t x_len,
    const uint8_t* read, int32_t y_len,
    int32_t dlo, int32_t dhi,
    int32_t* out_start, uint8_t* out_ops, int32_t* out_n_ops,
    int32_t* out_last_start) {
  if (x_len <= 0 || y_len <= 0) return -1;
  const int32_t INF = 1 << 28;
  const int32_t bw = dhi - dlo + 1;
  if (bw <= 0) return -2;
  std::vector<int32_t> dp((size_t)(x_len + 1) * bw, INF);
  std::vector<uint8_t> a(x_len), r(y_len);
  for (int32_t i = 0; i < x_len; i++) a[i] = allele[i] & ~0x20;
  for (int32_t j = 0; j < y_len; j++) r[j] = read[j] & ~0x20;
  // row 0: dp[0][j] = j for the in-band slots (j = -dhi + k)
  for (int32_t k = 0; k < bw; k++) {
    const int32_t j = k - dhi;
    if (j >= 1 && j <= y_len) dp[k] = j;
  }
  for (int32_t i = 1; i <= x_len; i++) {
    int32_t* row = &dp[(size_t)i * bw];
    const int32_t* prev = &dp[(size_t)(i - 1) * bw];
    const uint8_t ai = a[i - 1];
    const int32_t base = i - dhi;           // j at slot 0
    int32_t klo = 1 - base > 0 ? 1 - base : 0;
    int32_t khi = y_len - base < bw - 1 ? y_len - base : bw - 1;
    for (int32_t k = klo; k <= khi; k++) {
      const int32_t j = base + k;
      // (i-1, j-1) -> prev slot k; (i-1, j) -> prev slot k+1
      int32_t tl = (j == 1) ? 0 : prev[k];           // j-1 == 0: free col
      if (i == 1) tl = j - 1;                        // row 0 value
      int32_t best = tl + (ai != r[j - 1]);
      const int32_t tp = (i == 1) ? j
                         : (k + 1 < bw ? prev[k + 1] : INF);
      if (tp + 1 < best) best = tp + 1;
      const int32_t lf = (j == 1) ? 0 : (k > 0 ? row[k - 1] : INF);
      if (lf + 1 < best) best = lf + 1;
      row[k] = best;
    }
  }
  // best end over the allele axis at column y_len (in-band rows only; the
  // d < y_len caller gate makes the i=0 all-insert placement non-minimal)
  int32_t best_i = -1, dist = INF, last_i = -1;
  const int32_t ilo = y_len + dlo > 1 ? y_len + dlo : 1;
  const int32_t ihi = y_len + dhi < x_len ? y_len + dhi : x_len;
  for (int32_t i = ilo; i <= ihi; i++) {
    const int32_t v = band_get(dp.data(), bw, dhi, y_len, i, y_len);
    if (v < dist) { dist = v; best_i = i; }
  }
  if (best_i < 0 || dist >= INF) return -2;
  for (int32_t i = ihi; i > best_i; i--) {
    if (band_get(dp.data(), bw, dhi, y_len, i, y_len) == dist) { last_i = i; break; }
  }
  if (last_i < 0) last_i = best_i;
  // traceback (identical preference order: diag, del, ins)
  int32_t i = best_i, j = y_len, n = 0;
  while (j > 0) {
    const int32_t cur = band_get(dp.data(), bw, dhi, y_len, i, j);
    if (i > 0 && cur == band_get(dp.data(), bw, dhi, y_len, i - 1, j - 1) +
                            (a[i - 1] != r[j - 1])) {
      out_ops[n++] = (a[i - 1] == r[j - 1]) ? 0 : 1;
      i--; j--;
    } else if (i > 0 &&
               cur == band_get(dp.data(), bw, dhi, y_len, i - 1, j) + 1) {
      out_ops[n++] = 3;
      i--;
    } else if (cur == band_get(dp.data(), bw, dhi, y_len, i, j - 1) + 1) {
      out_ops[n++] = 2;
      j--;
    } else {
      out_ops[n++] = 1;
      if (i > 0) i--;
      j--;
    }
  }
  for (int32_t k = 0; k < n / 2; k++) {
    const uint8_t t = out_ops[k];
    out_ops[k] = out_ops[n - 1 - k];
    out_ops[n - 1 - k] = t;
  }
  *out_start = i;
  *out_n_ops = n;
  if (out_last_start) {
    int32_t li = last_i, lj = y_len;
    while (lj > 0) {
      const int32_t cur = band_get(dp.data(), bw, dhi, y_len, li, lj);
      if (li > 0 && cur == band_get(dp.data(), bw, dhi, y_len, li - 1, lj - 1) +
                              (a[li - 1] != r[lj - 1])) {
        li--; lj--;
      } else if (li > 0 &&
                 cur == band_get(dp.data(), bw, dhi, y_len, li - 1, lj) + 1) {
        li--;
      } else if (cur == band_get(dp.data(), bw, dhi, y_len, li, lj - 1) + 1) {
        lj--;
      } else {
        if (li > 0) li--;
        lj--;
      }
    }
    *out_last_start = li;
  }
  return dist;
}

// ---------------------------------------------------------------------------
// Semiglobal pair-HMM forward (linear space, per-row rescaling).
//
// Exact port of the JAX wavefront kernel (ops/pairhmm.py::_forward_impl /
// _forward_hp_impl) for the CPU preprocess path: free start/end gaps on the
// allele axis (x), read axis (y) fully consumed; per-base miscall emissions
// with 1/3 confusion; N read bases emit 1/4.  Linear-space f64 with
// per-row rescaling replaces the log-space lse chains (~10 flops/cell
// instead of ~8 transcendentals/cell).  Mirrors the reference model of
// bio::stats::pairhmm invoked at realignment/mod.rs:526-543.
//
// Positional-gap (homopolymer) variant: ins_open/ins_ext are per read base
// (j axis), del_open/del_ext per allele base (i axis); pass nullptr for the
// global-gap exact mode.  All gap params are LINEAR probabilities here.
// ---------------------------------------------------------------------------

static double vlt_pairhmm_one(
    const uint8_t* a, int32_t x_len,
    const uint8_t* r, int32_t y_len,
    const float* miscall,           // [y_len] LOG miscall per read base
    const float gaps[4],            // log t_mi, t_md, t_ii, t_dd
    const float* ins_open,          // [y_len] log, or nullptr
    const float* ins_ext,
    const float* del_open,          // [x_len] log, or nullptr
    const float* del_ext,
    int32_t max_edit) {             // banding: skip cells whose min edit
                                    // distance exceeds this; < 0 disables.
                                    // Mirrors rust-bio PairHMM::prob_related
                                    // (max_edit_dist = hit.dist + EDIT_BAND,
                                    // realignment/mod.rs:526-543).
  // Column-major (read axis j outer): the DP's dynamic range grows along j
  // (each consumed read base multiplies in its emission), so per-COLUMN
  // rescaling keeps every column representable in f64; the free-end-gap sum
  // only reads the last column, so no cross-scale mixing occurs.
  const int32_t H = x_len + 1;
  // per-thread scratch (the batch driver calls this in a tight loop:
  // malloc/free per item would dominate the banded fast path)
  struct Scratch {
    std::vector<double> M0, D0, I0, M1, D1, I1, dop, dex, tdm;
    std::vector<uint8_t> au;
    std::vector<int32_t> E0, E1;
  };
  thread_local Scratch sc;
  sc.M0.assign(H, 0.0); sc.D0.assign(H, 0.0); sc.I0.assign(H, 0.0);
  sc.M1.assign(H, 0.0); sc.D1.assign(H, 0.0); sc.I1.assign(H, 0.0);
  auto &M0 = sc.M0, &D0 = sc.D0, &I0 = sc.I0;
  auto &M1 = sc.M1, &D1 = sc.D1, &I1 = sc.I1;
  auto &dop = sc.dop, &dex = sc.dex, &tdm = sc.tdm;
  auto &au = sc.au;
  // banded-pruning edit-distance DP (rust-bio PairHMM min_edit_dist):
  // E[i] over the allele axis for the previous (E0) / current (E1) read
  // column; column j=0 is all zeros (free start gap in x anchors every
  // allele offset at distance 0).
  const int32_t EINF = 1 << 29;
  auto &E0 = sc.E0, &E1 = sc.E1;
  const bool banded = max_edit >= 0;
  if (banded) {
    E0.assign(H, 0);
    E1.assign(H, EINF);
  }
  const double g_mi = std::exp((double)gaps[0]);
  const double g_md = std::exp((double)gaps[1]);
  const double g_ii = std::exp((double)gaps[2]);
  const double g_dd = std::exp((double)gaps[3]);
  double t0_ = 1.0 - g_dd;
  const double tdm_c = t0_ > 1e-12 ? t0_ : 1e-12;
  // positional gap arrays exist only in homopolymer mode; the exact-mode
  // default uses batch-constant gaps (no per-item exp() precompute)
  const bool posgaps = del_open || del_ext;
  if (posgaps) {
    dop.resize(H); dex.resize(H); tdm.resize(H);
    for (int32_t i = 1; i <= x_len; i++) {
      dop[i] = del_open ? std::exp((double)del_open[i - 1]) : g_md;
      dex[i] = del_ext ? std::exp((double)del_ext[i - 1]) : g_dd;
      double t = 1.0 - dex[i];
      tdm[i] = t > 1e-12 ? t : 1e-12;
    }
  }
  au.resize(H);
  for (int32_t i = 1; i <= x_len; i++) au[i] = a[i - 1] & ~0x20;
  double log_scale = 0.0;
  // Live-interval tracking (banded only): the band-DP-live set per column
  // is bounded below by a monotone floor (cells below never revive: all
  // their predecessors are pruned) and above by the previous column's
  // ceiling + an E-chained extension; cells outside the visited interval
  // are virtually pruned.  Sentinel cells (one beyond each end) carry the
  // pruned representation (M/D/I = 0, E = EINF) so the next column's reads
  // see exactly what the full scan would have written.  Arithmetic per
  // visited cell is unchanged -> results are bit-identical to the full
  // scan; only provably-pruned cell visits are skipped.
  int32_t lv_lo = 0, lv_hi = x_len;  // E0-live bounds (col 0: all live)
  int32_t sum_lo = 1, sum_hi = x_len;  // visited bounds of the last column
  bool i0_live = true;
  for (int32_t j = 1; j <= y_len; j++) {
    const uint8_t rj = r[j - 1] & ~0x20;
    const double m = std::exp((double)miscall[j - 1]);
    const double noc = 1.0 - m;
    const double io = ins_open ? std::exp((double)ins_open[j - 1]) : g_mi;
    const double ie = ins_ext ? std::exp((double)ins_ext[j - 1]) : g_ii;
    double tim = 1.0 - ie;
    if (tim < 1e-12) tim = 1e-12;
    // the free-start contribution enters every M/I cell of column 1 at the
    // CURRENT scale, so it must be expressed in the accumulated scale
    const double start_w = (j == 1) ? std::exp(-log_scale) : 0.0;
    // i = 0: leading pure insertion
    M1[0] = 0.0; D1[0] = 0.0;
    if (banded && E0[0] > max_edit) {
      I1[0] = 0.0;
      E1[0] = EINF;
      i0_live = false;
    } else {
      I1[0] = m * (ie * I0[0] + start_w * io);
      if (banded) E1[0] = E0[0] >= EINF ? EINF : E0[0] + 1;
    }
    double colmax = I1[0];
    int32_t istart = 1, iend = x_len;
    if (banded) {
      // while the i=0 free-start cell is live, low cells can chain alive
      // through E1[i-1] regardless of the E0 floor — scan from 1 then
      istart = i0_live ? 1 : (lv_lo > 1 ? lv_lo : 1);
      iend = lv_hi + 1 < x_len ? lv_hi + 1 : x_len;
      if (iend < istart - 1) iend = istart - 1;
      if (istart - 1 >= 1) {
        // pre-loop lower sentinel: the full scan prunes every cell below
        // the floor at THIS column, and i=istart's in-column D/E chain
        // reads position istart-1 during the loop
        M1[istart - 1] = 0.0; D1[istart - 1] = 0.0; I1[istart - 1] = 0.0;
        E1[istart - 1] = EINF;
      }
    }
    int32_t nlo = x_len + 1, nhi = 0;  // live bounds of THIS column
    int32_t i = istart;
    // banded: iterate the E0-derived range, then keep going while the
    // in-column E1 chain stays live (exactly the cells the full scan
    // would not prune); physical state above/below the visited range is
    // maintained pruned (zeros / EINF), so all reads see full-scan values
    for (; i <= x_len && (i <= iend || (banded && E1[i - 1] <= max_edit));
         i++) {
      if (banded) {
        // skip cells whose best-path edit distance exceeds the band
        // (rust-bio pairhmm: min over topleft/top/left predecessors)
        const int32_t tl = E0[i - 1], tp = E0[i], lf = E1[i - 1];
        int32_t mn = tl < tp ? tl : tp;
        if (lf < mn) mn = lf;
        if (mn > max_edit) {
          M1[i] = 0.0; D1[i] = 0.0; I1[i] = 0.0;
          E1[i] = EINF;
          continue;
        }
        const int32_t sub = (au[i] == rj) ? tl : (tl >= EINF ? EINF : tl + 1);
        int32_t e = sub;
        if (tp < EINF && tp + 1 < e) e = tp + 1;
        if (lf < EINF && lf + 1 < e) e = lf + 1;
        E1[i] = e;
        if (e <= max_edit) { if (i < nlo) nlo = i; if (i > nhi) nhi = i; }
      }
      double e_m;
      if (au[i] == rj) e_m = noc;
      else if (rj == 'N') e_m = 0.25;
      else e_m = m * (1.0 / 3.0);
      const double dop_i = posgaps ? dop[i] : g_md;
      const double dex_i = posgaps ? dex[i] : g_dd;
      const double tdm_i = posgaps ? tdm[i] : tdm_c;
      double t_mm = 1.0 - io - dop_i;
      if (t_mm < 1e-12) t_mm = 1e-12;
      const double Mv = e_m * (t_mm * M0[i - 1] + tdm_i * D0[i - 1] +
                               tim * I0[i - 1] + start_w);
      const double Iv = m * (io * M0[i] + ie * I0[i] + start_w * io);
      M1[i] = Mv; I1[i] = Iv;
      // D depends on current column at i-1 (gap in read)
      const double Dv = dop_i * M1[i - 1] + dex_i * D1[i - 1];
      D1[i] = Dv;
      double mx = Mv > Dv ? Mv : Dv;
      if (Iv > mx) mx = Iv;
      if (mx > colmax) colmax = mx;
    }
    if (banded) {
      const int32_t vhi = i - 1;  // last visited row this column
      // keep the physical state pruned for max_edit+2 cells above the
      // ceiling: the next column's visited range (E0 range + the strictly
      // incrementing E1 chain, <= max_edit steps) plus its one-cell read
      // margin provably stays inside the maintained region, so every read
      // above this column's ceiling sees exactly the full scan's values
      const int32_t zhi = vhi + max_edit + 2;
      for (int32_t k = vhi + 1; k <= zhi && k <= x_len; k++) {
        M1[k] = 0.0; D1[k] = 0.0; I1[k] = 0.0;
        E1[k] = EINF;
      }
      sum_lo = istart; sum_hi = vhi;
      if (nlo > nhi && !i0_live) {
        // everything pruned: later columns are all zeros, so P = 0 —
        // unless this IS the last column, whose visited (pruned-band-edge)
        // cells still carry mass that the full scan would sum
        if (j < y_len) return -1e30;
      }
      lv_lo = nlo > nhi ? 1 : nlo;
      lv_hi = nlo > nhi ? 0 : nhi;
      if (colmax > 0.0 && colmax < 1e-120) {
        const double s = 1e120;
        M1[0] *= s; D1[0] *= s; I1[0] *= s;
        for (int32_t k = istart; k <= vhi; k++) {
          M1[k] *= s; D1[k] *= s; I1[k] *= s;
        }
        log_scale -= std::log(s);
      }
    } else if (colmax > 0.0 && colmax < 1e-120) {
      const double s = 1e120;
      for (int32_t k = 0; k <= x_len; k++) { M1[k] *= s; D1[k] *= s; I1[k] *= s; }
      log_scale -= std::log(s);
    }
    M0.swap(M1); D0.swap(D1); I0.swap(I1);
    if (banded) E0.swap(E1);
  }
  double total = M0[0] + I0[0];
  if (banded) {
    for (int32_t i = sum_lo; i <= sum_hi; i++) total += M0[i] + I0[i];
  } else {
    for (int32_t i = 1; i <= x_len; i++) total += M0[i] + I0[i];
  }
  if (total <= 0.0 || y_len == 0) return -1e30;
  return std::log(total) + log_scale;
}

// f64 LOG-space sequential profile (rust-bio bio::stats::pairhmm keeps every
// cell as a LogProb and combines predecessors with per-cell ln_sum_exp —
// a different rounding profile from the rescaled linear-space kernel above;
// docs/calibration_failures.md shows the golden-testcase posteriors are
// sensitive at the ±1 PHRED level to exactly this choice).  Same recurrence,
// same banding; max-shift ln_sum_exp per cell, terms ordered (M, D, I,
// start) like the match-state transition list.
static inline double lse2d(double a, double b) {
  const double m = a > b ? a : b;
  if (m == -std::numeric_limits<double>::infinity()) return m;
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}
static inline double lse3d(double a, double b, double c) {
  double m = a > b ? a : b;
  if (c > m) m = c;
  if (m == -std::numeric_limits<double>::infinity()) return m;
  return m + std::log(std::exp(a - m) + std::exp(b - m) + std::exp(c - m));
}
static inline double lse4d(double a, double b, double c, double d) {
  double m = a > b ? a : b;
  if (c > m) m = c;
  if (d > m) m = d;
  if (m == -std::numeric_limits<double>::infinity()) return m;
  return m + std::log(std::exp(a - m) + std::exp(b - m) + std::exp(c - m) +
                      std::exp(d - m));
}

static double vlt_pairhmm_one_log(
    const uint8_t* a, int32_t x_len,
    const uint8_t* r, int32_t y_len,
    const float* miscall,
    const float gaps[4],
    const float* ins_open, const float* ins_ext,
    const float* del_open, const float* del_ext,
    int32_t max_edit) {
  const double NEGINF = -std::numeric_limits<double>::infinity();
  const int32_t H = x_len + 1;
  std::vector<double> M0(H, NEGINF), D0(H, NEGINF), I0(H, NEGINF);
  std::vector<double> M1(H, NEGINF), D1(H, NEGINF), I1(H, NEGINF);
  std::vector<double> dop(H), dex(H), tdm(H);
  std::vector<uint8_t> au(H);
  const int32_t EINF = 1 << 29;
  std::vector<int32_t> E0, E1;
  const bool banded = max_edit >= 0;
  if (banded) {
    E0.assign(H, 0);
    E1.assign(H, EINF);
  }
  auto ln1m = [](double lx) {  // log(1 - exp(lx)), lx <= 0
    if (lx == -std::numeric_limits<double>::infinity()) return 0.0;
    const double lin = 1.0 - std::exp(lx);
    return lin > 1e-12 ? std::log(lin) : std::log(1e-12);
  };
  const double g_mi = (double)gaps[0];
  const double g_md = (double)gaps[1];
  const double g_ii = (double)gaps[2];
  const double g_dd = (double)gaps[3];
  for (int32_t i = 1; i <= x_len; i++) {
    au[i] = a[i - 1] & ~0x20;
    dop[i] = del_open ? (double)del_open[i - 1] : g_md;
    dex[i] = del_ext ? (double)del_ext[i - 1] : g_dd;
    tdm[i] = ln1m(dex[i]);
  }
  for (int32_t j = 1; j <= y_len; j++) {
    const uint8_t rj = r[j - 1] & ~0x20;
    const double m = (double)miscall[j - 1];
    const double noc = ln1m(m);
    const double io = ins_open ? (double)ins_open[j - 1] : g_mi;
    const double ie = ins_ext ? (double)ins_ext[j - 1] : g_ii;
    const double tim = ln1m(ie);
    const double start = (j == 1) ? 0.0 : NEGINF;
    M1[0] = NEGINF; D1[0] = NEGINF;
    if (banded && E0[0] > max_edit) {
      I1[0] = NEGINF;
      E1[0] = EINF;
    } else {
      I1[0] = m + lse2d(ie + I0[0], start + io);
      if (banded) E1[0] = E0[0] >= EINF ? EINF : E0[0] + 1;
    }
    for (int32_t i = 1; i <= x_len; i++) {
      if (banded) {
        const int32_t tl = E0[i - 1], tp = E0[i], lf = E1[i - 1];
        int32_t mn = tl < tp ? tl : tp;
        if (lf < mn) mn = lf;
        if (mn > max_edit) {
          M1[i] = NEGINF; D1[i] = NEGINF; I1[i] = NEGINF;
          E1[i] = EINF;
          continue;
        }
        const int32_t sub = (au[i] == rj) ? tl : (tl >= EINF ? EINF : tl + 1);
        int32_t e = sub;
        if (tp < EINF && tp + 1 < e) e = tp + 1;
        if (lf < EINF && lf + 1 < e) e = lf + 1;
        E1[i] = e;
      }
      double e_m;
      if (au[i] == rj) e_m = noc;
      else if (rj == 'N') e_m = std::log(0.25);
      else e_m = m + std::log(1.0 / 3.0);
      double t_mm_lin = 1.0 - std::exp(io) - std::exp(dop[i]);
      const double t_mm =
          std::log(t_mm_lin > 1e-12 ? t_mm_lin : 1e-12);
      M1[i] = e_m + lse4d(t_mm + M0[i - 1], tdm[i] + D0[i - 1],
                          tim + I0[i - 1], start);
      I1[i] = m + lse3d(io + M0[i], ie + I0[i], start + io);
      D1[i] = lse2d(dop[i] + M1[i - 1], dex[i] + D1[i - 1]);
    }
    M0.swap(M1); D0.swap(D1); I0.swap(I1);
    if (banded) E0.swap(E1);
  }
  if (y_len == 0) return -1e30;
  // free end gap in x: ln_sum_exp over the last column's M and I states
  double mx = NEGINF;
  for (int32_t i = 0; i <= x_len; i++) {
    if (M0[i] > mx) mx = M0[i];
    if (I0[i] > mx) mx = I0[i];
  }
  if (mx == NEGINF) return -1e30;
  double s = 0.0;
  for (int32_t i = 0; i <= x_len; i++) {
    s += std::exp(M0[i] - mx) + std::exp(I0[i] - mx);
  }
  const double total = mx + std::log(s);
  return total > -1e30 ? total : -1e30;
}

extern "C" int32_t vlt_pairhmm_forward_batch_log(
    const uint8_t* alleles, const int64_t* allele_off, const int32_t* allele_len,
    const uint8_t* reads, const int64_t* read_off, const int32_t* read_len,
    const float* miscalls, const float* gaps,
    const float* ins_open, const float* ins_ext,
    const float* del_open, const float* del_ext,
    const int32_t* max_edit,
    int32_t n_items, int32_t n_threads, double* out) {
  auto work = [&](int32_t lo, int32_t hi) {
    for (int32_t b = lo; b < hi; b++) {
      out[b] = vlt_pairhmm_one_log(
          alleles + allele_off[b], allele_len[b],
          reads + read_off[b], read_len[b],
          miscalls + read_off[b], gaps,
          ins_open ? ins_open + read_off[b] : nullptr,
          ins_ext ? ins_ext + read_off[b] : nullptr,
          del_open ? del_open + allele_off[b] : nullptr,
          del_ext ? del_ext + allele_off[b] : nullptr,
          max_edit ? max_edit[b] : -1);
    }
  };
  if (n_threads <= 1 || n_items < 8) {
    work(0, n_items);
  } else {
    std::vector<std::thread> ts;
    const int32_t chunk = (n_items + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; t++) {
      const int32_t lo = t * chunk;
      const int32_t hi = lo + chunk < n_items ? lo + chunk : n_items;
      if (lo >= hi) break;
      ts.emplace_back(work, lo, hi);
    }
    for (auto& th : ts) th.join();
  }
  return 0;
}

extern "C" int32_t vlt_pairhmm_forward_batch(
    const uint8_t* alleles, const int64_t* allele_off, const int32_t* allele_len,
    const uint8_t* reads, const int64_t* read_off, const int32_t* read_len,
    const float* miscalls,          // concatenated, read offsets
    const float* gaps,              // [4] log
    const float* ins_open, const float* ins_ext,   // concatenated per read, or nullptr
    const float* del_open, const float* del_ext,   // concatenated per allele, or nullptr
    const int32_t* max_edit,        // [n_items] band per item (<0 = full), or nullptr
    int32_t n_items, int32_t n_threads, double* out) {
  auto work = [&](int32_t lo, int32_t hi) {
    for (int32_t b = lo; b < hi; b++) {
      out[b] = vlt_pairhmm_one(
          alleles + allele_off[b], allele_len[b],
          reads + read_off[b], read_len[b],
          miscalls + read_off[b], gaps,
          ins_open ? ins_open + read_off[b] : nullptr,
          ins_ext ? ins_ext + read_off[b] : nullptr,
          del_open ? del_open + allele_off[b] : nullptr,
          del_ext ? del_ext + allele_off[b] : nullptr,
          max_edit ? max_edit[b] : -1);
    }
  };
  if (n_threads <= 1 || n_items < 8) {
    work(0, n_items);
  } else {
    std::vector<std::thread> ts;
    const int32_t chunk = (n_items + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; t++) {
      const int32_t lo = t * chunk;
      const int32_t hi = lo + chunk < n_items ? lo + chunk : n_items;
      if (lo >= hi) break;
      ts.emplace_back(work, lo, hi);
    }
    for (auto& th : ts) th.join();
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Myers bit-parallel semiglobal edit distance (edit_distance.rs:132-158
// parity: patterns <= 128 in one unsigned __int128 word, Hyyro's search
// formulation -- free start/end gaps in the text, pattern fully consumed).
// Returns the minimum distance and the FIRST and LAST co-optimal end
// columns (1-based text positions); the caller runs the O(nm) traceback DP
// only on those hit windows.
// ---------------------------------------------------------------------------

typedef unsigned __int128 u128;

extern "C" int32_t vlt_myers_semiglobal(
    const uint8_t* pattern, int32_t m,
    const uint8_t* text, int32_t n,
    int32_t* out_first_end, int32_t* out_last_end) {
  if (m <= 0 || n <= 0 || m > 128) return -1;
  u128 Peq[256];
  std::memset(Peq, 0, sizeof(Peq));
  for (int32_t i = 0; i < m; i++) {
    Peq[pattern[i] & ~0x20] |= (u128)1 << i;
  }
  u128 PV = ~(u128)0;
  u128 MV = 0;
  const u128 hibit = (u128)1 << (m - 1);
  int32_t score = m;
  int32_t best = m + 1, first_end = 0, last_end = 0;
  for (int32_t j = 0; j < n; j++) {
    const u128 Eq = Peq[text[j] & ~0x20];
    const u128 Xv = Eq | MV;
    const u128 Xh = (((Eq & PV) + PV) ^ PV) | Eq;
    u128 Ph = MV | ~(Xh | PV);
    u128 Mh = PV & Xh;
    if (Ph & hibit) score++;
    else if (Mh & hibit) score--;
    Ph <<= 1;
    Mh <<= 1;
    PV = Mh | ~(Xv | Ph);
    MV = Ph & Xv;
    if (score < best) {
      best = score;
      first_end = j + 1;
      last_end = j + 1;
    } else if (score == best) {
      last_end = j + 1;
    }
  }
  *out_first_end = first_end;
  *out_last_end = last_end;
  return best;
}

// ---------------------------------------------------------------------------
// Batched hybrid edit-distance hits (one library call per allele set instead
// of one ctypes crossing per allele): per item runs the Myers bit-parallel
// end-column scan on long windows + the windowed O(nm) traceback DP (exact
// mirror of io/native.py::semiglobal_edit_hybrid), plus — when the last
// co-optimal placement differs from the first — the suffix alignment that
// calc_hit (edit_distance.py) evaluates for co-optimal edit-op counting.
// ---------------------------------------------------------------------------

struct HybridHit {
  int32_t dist, start, last_start, n_ops;
  int32_t dist2, start2, n_ops2;  // suffix placement; dist2 = -1 when absent
};

static void vlt_hybrid_one(const uint8_t* allele, int32_t a_len,
                           const uint8_t* read, int32_t r_len,
                           uint8_t* ops, uint8_t* ops2, HybridHit* h) {
  h->dist2 = -1;
  h->start2 = 0;
  h->n_ops2 = 0;
  int32_t ls = 0;
  // Myers scan + diagonally-banded window DP whenever the read fits one
  // u128 word (the band is exactness-preserving — see semiglobal_edit_core;
  // previously gated on a_len >= 256, but the banded DP beats the full
  // O(a_len * r_len) DP already at realignment-window sizes ~100-200)
  if (a_len >= 24 && r_len <= 128) {
    int32_t fe = 0, le = 0;
    const int32_t d = vlt_myers_semiglobal(read, r_len, allele, a_len, &fe, &le);
    // d == r_len would tie the i=0 all-insert placement, which the full DP
    // tie-breaks to but no banded end can represent — take the full path
    if (d >= 0 && d < r_len) {
      const int32_t lo1 = std::max(0, fe - r_len - d);
      const int32_t w1 = fe - lo1;
      const int32_t delta1 = w1 - r_len;
      int32_t s1 = 0, n1 = 0, ls1 = 0;
      int32_t d1 = semiglobal_edit_banded(allele + lo1, w1, read, r_len,
                                          delta1 - d, delta1 + d,
                                          &s1, ops, &n1, &ls1);
      if (d1 != d)  // band missed (should not happen): exact fallback
        d1 = vlt_semiglobal_edit(allele + lo1, w1, read, r_len,
                                 &s1, ops, &n1, &ls1);
      if (d1 >= 0) {
        h->dist = d;
        h->start = lo1 + s1;
        h->n_ops = n1;
        if (le > fe) {
          const int32_t lo2 = std::max(0, le - r_len - d);
          const int32_t w2 = le - lo2;
          const int32_t delta2 = w2 - r_len;
          int32_t s2 = 0, n2 = 0, ls2 = 0;
          std::vector<uint8_t> scratch(w2 + r_len + 2);
          // band must cover paths to every co-optimal end in [fe, le]
          int32_t dd = (le - fe) <= r_len
              ? semiglobal_edit_banded(allele + lo2, w2, read, r_len,
                                       delta2 - d - (le - fe), delta2 + d,
                                       &s2, scratch.data(), &n2, &ls2)
              : -2;
          if (dd != d)
            dd = vlt_semiglobal_edit(allele + lo2, w2, read, r_len, &s2,
                                     scratch.data(), &n2, &ls2);
          h->last_start = dd >= 0 ? lo2 + ls2 : h->start;
        } else {
          h->last_start = lo1 + s1;
        }
        goto suffix;
      }
    }
  }
  h->dist = vlt_semiglobal_edit(allele, a_len, read, r_len, &h->start, ops,
                                &h->n_ops, &ls);
  h->last_start = ls;
suffix:
  if (h->last_start != h->start && h->last_start < a_len) {
    // co-optimal-placement alignment at the LAST start (calc_hit's second
    // placement, edit_distance.py); hybrid again on the suffix
    HybridHit tail;
    // recursion depth is 1: the suffix call always has start == last_start
    // == 0 for its own suffix check only if co-optimal ends differ again,
    // but we only need its first placement -> call the plain parts inline.
    const uint8_t* suf = allele + h->last_start;
    const int32_t s_len = a_len - h->last_start;
    int32_t fe = 0, le = 0, done = 0;
    if (s_len >= 24 && r_len <= 128) {
      const int32_t d = vlt_myers_semiglobal(read, r_len, suf, s_len, &fe, &le);
      if (d >= 0 && d < r_len) {
        const int32_t lo1 = std::max(0, fe - r_len - d);
        const int32_t w1 = fe - lo1;
        const int32_t delta1 = w1 - r_len;
        int32_t s1 = 0, n1 = 0, ls1 = 0;
        int32_t d1 = semiglobal_edit_banded(suf + lo1, w1, read, r_len,
                                            delta1 - d, delta1 + d,
                                            &s1, ops2, &n1, &ls1);
        if (d1 != d)
          d1 = vlt_semiglobal_edit(suf + lo1, w1, read, r_len,
                                   &s1, ops2, &n1, &ls1);
        if (d1 >= 0) {
          tail.dist = d;
          tail.start = lo1 + s1;
          tail.n_ops = n1;
          done = 1;
        }
      }
    }
    if (!done) {
      int32_t ls2 = 0;
      tail.dist = vlt_semiglobal_edit(suf, s_len, read, r_len, &tail.start,
                                      ops2, &tail.n_ops, &ls2);
    }
    if (tail.dist >= 0) {
      h->dist2 = tail.dist;
      h->start2 = tail.start;
      h->n_ops2 = tail.n_ops;
    }
  }
}

extern "C" int32_t vlt_hybrid_hits_batch(
    const uint8_t* alleles, const int64_t* a_off, const int32_t* a_len,
    const uint8_t* reads, const int64_t* r_off, const int32_t* r_len,
    int32_t n_items, int32_t n_threads,
    int32_t* out_dist, int32_t* out_start, int32_t* out_last_start,
    int32_t* out_n_ops, uint8_t* out_ops, const int64_t* ops_off,
    int32_t* out_dist2, int32_t* out_start2, int32_t* out_n_ops2,
    uint8_t* out_ops2) {
  auto work = [&](int32_t lo, int32_t hi) {
    for (int32_t b = lo; b < hi; b++) {
      HybridHit h;
      vlt_hybrid_one(alleles + a_off[b], a_len[b], reads + r_off[b], r_len[b],
                     out_ops + ops_off[b], out_ops2 + ops_off[b], &h);
      out_dist[b] = h.dist;
      out_start[b] = h.start;
      out_last_start[b] = h.last_start;
      out_n_ops[b] = h.n_ops;
      out_dist2[b] = h.dist2;
      out_start2[b] = h.start2;
      out_n_ops2[b] = h.n_ops2;
    }
  };
  if (n_threads <= 1 || n_items < 8) {
    work(0, n_items);
  } else {
    std::vector<std::thread> ts;
    const int32_t chunk = (n_items + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; t++) {
      const int32_t lo = t * chunk;
      const int32_t hi = lo + chunk < n_items ? lo + chunk : n_items;
      if (lo >= hi) break;
      ts.emplace_back(work, lo, hi);
    }
    for (auto& th : ts) th.join();
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Hop-state homopolymer pair-HMM forward (bio::stats::pairhmm::HomopolyPairHMM
// reconstruction; reference call site realignment/mod.rs:679-731, params
// pairhmm.rs:208-294).  States: M, D (allele gap), I (read gap) as in the
// plain kernel, plus HX (read homopolymer hop: extra read copies of the
// last matched allele base) and HY (allele homopolymer hop: skipped allele
// copies of a homopolymer run).  Hop entry/extension probabilities are
// per-base (A,C,G,T) from the alignment-properties MLE (the 15-state
// transition model of estimation/alignment_properties.rs:535-560 — Match(b)
// -> Hop(b) open, Hop(b) -> Hop(b) extend).  Hop states carry no emission
// term: the per-base hop rates are MLE frequencies of observed hops per
// aligned base, so they already contain the event probability (a miscall
// factor would double-count).  rust-bio's exact emission convention is
// unverifiable in this image (source absent); divergence is documented in
// docs/calibration_failures.md and gated by the homopolymer testcase sweep.
// ---------------------------------------------------------------------------

static inline int hop_base_idx(uint8_t b) {
  switch (b) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    default: return -1;
  }
}

static double vlt_pairhmm_hop_one(
    const uint8_t* a, int32_t x_len,
    const uint8_t* r, int32_t y_len,
    const float* miscall,           // [y_len] LOG miscall per read base
    const float gaps[4],            // log t_mi, t_md, t_ii, t_dd
    const float hop[16],            // log: seq open[4], seq ext[4],
                                    //      ref open[4], ref ext[4]
    int32_t hop_emit,               // 1: HX pays the read-base miscall
                                    //    emission like the I lane
    int32_t max_edit) {
  const int32_t H = x_len + 1;
  std::vector<double> M0(H, 0.0), D0(H, 0.0), I0(H, 0.0), HX0(H, 0.0), HY0(H, 0.0);
  std::vector<double> M1(H, 0.0), D1(H, 0.0), I1(H, 0.0), HX1(H, 0.0), HY1(H, 0.0);
  std::vector<uint8_t> au(H);
  const int32_t EINF = 1 << 29;
  std::vector<int32_t> E0, E1;
  const bool banded = max_edit >= 0;
  if (banded) { E0.assign(H, 0); E1.assign(H, EINF); }
  const double g_mi = std::exp((double)gaps[0]);
  const double g_md = std::exp((double)gaps[1]);
  const double g_ii = std::exp((double)gaps[2]);
  const double g_dd = std::exp((double)gaps[3]);
  double hox[4], hex_[4], hoy[4], hey[4];
  for (int b = 0; b < 4; b++) {
    hox[b] = std::exp((double)hop[b]);
    hex_[b] = std::exp((double)hop[4 + b]);
    hoy[b] = std::exp((double)hop[8 + b]);
    hey[b] = std::exp((double)hop[12 + b]);
  }
  const double t_dm = std::max(1.0 - g_dd, 1e-12);
  const double t_im = std::max(1.0 - g_ii, 1e-12);
  // per-allele-base: no-gap-no-hop continuation and HY gates
  std::vector<double> tmm(H), hoyv(H, 0.0), heyv(H, 0.0), hyclose(H, 1.0);
  std::vector<uint8_t> hygate(H, 0);
  for (int32_t i = 1; i <= x_len; i++) {
    au[i] = a[i - 1] & ~0x20;
    const int b = hop_base_idx(au[i]);
    const double hy = b >= 0 ? hoy[b] : 0.0;
    // Match->Match continuation: hops are ADDITIVE channels (subtracting
    // the per-base hop mass would penalize longer homopolymer alleles one
    // continuation factor per extra base, systematically tilting ref/alt
    // ratios toward the shorter allele; calibrated against the reference's
    // nanopore/pcr/giab homopolymer testcases)
    tmm[i] = std::max(1.0 - g_mi - g_md, 1e-12);
    hoyv[i] = hy;
    heyv[i] = b >= 0 ? hey[b] : 0.0;
    // closing prob out of an HY run whose last skipped base is au[i]
    hyclose[i] = std::max(1.0 - (b >= 0 ? hey[b] : 0.0), 1e-12);
    hygate[i] = (i >= 2 && au[i] == au[i - 1]) ? 1 : 0;
  }
  double log_scale = 0.0;
  uint8_t rj_prev = 0;
  for (int32_t j = 1; j <= y_len; j++) {
    const uint8_t rj = r[j - 1] & ~0x20;
    const int rb = hop_base_idx(rj);
    const double m = std::exp((double)miscall[j - 1]);
    const double noc = 1.0 - m;
    const double hex_rj = rb >= 0 ? hex_[rb] : 0.0;
    // closing prob out of an HX run whose last hopped base was y_{j-2}
    const int rbp = hop_base_idx(rj_prev);
    const double hxclose_prev = std::max(1.0 - (rbp >= 0 ? hex_[rbp] : 0.0), 1e-12);
    const double start_w = (j == 1) ? std::exp(-log_scale) : 0.0;
    M1[0] = 0.0; D1[0] = 0.0; HX1[0] = 0.0; HY1[0] = 0.0;
    if (banded && E0[0] > max_edit) {
      I1[0] = 0.0;
      E1[0] = EINF;
    } else {
      I1[0] = m * (g_ii * I0[0] + start_w * g_mi);
      if (banded) E1[0] = E0[0] >= EINF ? EINF : E0[0] + 1;
    }
    double colmax = I1[0];
    for (int32_t i = 1; i <= x_len; i++) {
      if (banded) {
        const int32_t tl = E0[i - 1], tp = E0[i], lf = E1[i - 1];
        int32_t mn = tl < tp ? tl : tp;
        if (lf < mn) mn = lf;
        if (mn > max_edit) {
          M1[i] = 0.0; D1[i] = 0.0; I1[i] = 0.0; HX1[i] = 0.0; HY1[i] = 0.0;
          E1[i] = EINF;
          continue;
        }
        const int32_t sub = (au[i] == rj) ? tl : (tl >= EINF ? EINF : tl + 1);
        int32_t e = sub;
        if (tp < EINF && tp + 1 < e) e = tp + 1;
        if (lf < EINF && lf + 1 < e) e = lf + 1;
        E1[i] = e;
      }
      double e_m;
      if (au[i] == rj) e_m = noc;
      else if (rj == 'N') e_m = 0.25;
      else e_m = m * (1.0 / 3.0);
      const double tmm_src = tmm[i];
      const double Mv = e_m * (tmm_src * M0[i - 1] + t_dm * D0[i - 1] +
                               t_im * I0[i - 1] + hxclose_prev * HX0[i - 1] +
                               hyclose[i - 1] * HY0[i - 1] + start_w);
      const double Iv = m * (g_mi * M0[i] + g_ii * I0[i] + start_w * g_mi);
      // HX: consume read base rj without advancing the allele; entry
      // requires rj to repeat the LAST MATCHED allele base (au[i]),
      // extension requires rj to repeat the previously hopped read base
      double HXv = 0.0;
      if (rj == au[i]) HXv += (rb >= 0 ? hox[rb] : 0.0) * M0[i];
      if (rj == rj_prev) HXv += hex_rj * HX0[i];
      if (hop_emit) HXv *= noc;
      M1[i] = Mv; I1[i] = Iv; HX1[i] = HXv;
      // D / HY depend on the current column at i-1 (consume allele only)
      const double Dv = g_md * M1[i - 1] + g_dd * D1[i - 1];
      // HY: skip allele base au[i]; entry from M requires au[i] to repeat
      // au[i-1] (a homopolymer run continuation), extension likewise
      double HYv = 0.0;
      if (hygate[i]) HYv = hoyv[i] * M1[i - 1] + heyv[i] * HY1[i - 1];
      D1[i] = Dv; HY1[i] = HYv;
      double mx = Mv > Dv ? Mv : Dv;
      if (Iv > mx) mx = Iv;
      if (HXv > mx) mx = HXv;
      if (HYv > mx) mx = HYv;
      if (mx > colmax) colmax = mx;
    }
    if (colmax > 0.0 && colmax < 1e-120) {
      const double s = 1e120;
      for (int32_t i = 0; i <= x_len; i++) {
        M1[i] *= s; D1[i] *= s; I1[i] *= s; HX1[i] *= s; HY1[i] *= s;
      }
      log_scale -= std::log(s);
    }
    M0.swap(M1); D0.swap(D1); I0.swap(I1); HX0.swap(HX1); HY0.swap(HY1);
    if (banded) E0.swap(E1);
    rj_prev = rj;
  }
  double total = 0.0;
  for (int32_t i = 0; i <= x_len; i++) total += M0[i] + I0[i] + HX0[i];
  if (total <= 0.0 || y_len == 0) return -1e30;
  return std::log(total) + log_scale;
}

extern "C" int32_t vlt_pairhmm_hop_batch(
    const uint8_t* alleles, const int64_t* allele_off, const int32_t* allele_len,
    const uint8_t* reads, const int64_t* read_off, const int32_t* read_len,
    const float* miscalls,          // concatenated, read offsets
    const float* gaps,              // [4] log
    const float* hop,               // [16] log (see vlt_pairhmm_hop_one)
    const int32_t* max_edit,        // [n_items] band per item, or nullptr
    int32_t hop_emit,
    int32_t n_items, int32_t n_threads, double* out) {
  auto work = [&](int32_t lo, int32_t hi) {
    for (int32_t b = lo; b < hi; b++) {
      out[b] = vlt_pairhmm_hop_one(
          alleles + allele_off[b], allele_len[b],
          reads + read_off[b], read_len[b],
          miscalls + read_off[b], gaps, hop, hop_emit,
          max_edit ? max_edit[b] : -1);
    }
  };
  if (n_threads <= 1 || n_items < 8) {
    work(0, n_items);
  } else {
    std::vector<std::thread> ts;
    const int32_t chunk = (n_items + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; t++) {
      const int32_t lo = t * chunk;
      const int32_t hi = lo + chunk < n_items ? lo + chunk : n_items;
      if (lo >= hi) break;
      ts.emplace_back(work, lo, hi);
    }
    for (auto& th : ts) th.join();
  }
  return 0;
}
