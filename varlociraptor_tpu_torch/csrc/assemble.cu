// The posterior engine's event and MAP / AFD pass (PosteriorEngine._assemble,
// ops/assemble.py), as two kernels around the contractions of the pass:
//
//   head: per locus, each event's value from the branch values bv [L, B, NB]
//         (a non-artifact event: log 0.5 + lse of its branches at slot 0; an
//         artifact event: log 0.5 - log n_art + lse over the slots b >= 1 of
//         the lse of its branches at b), the joint [L, E], the marginal (lse
//         over the events), the posteriors, the artifact mass a combination
//         slot combo [L, B] (slot 0 at -inf), the MAP non-artifact event
//         best [L], and each sample's selection wsel [L, NB, Gi]: 0 where
//         the branch belongs to best, is gated on and has a finite weight.
//   tail: per (locus, sample), the density over the sample's grid,
//         dens[g] = lse over the branches of d_own[l, 0, nb, g] + rest[nb]
//         (rest: the other contamination components' sums U0), the MAP
//         index (the first maximum) and its log-parabola refinement into af,
//         and the deci-PHRED int16 of dens - marginal at the top-K points
//         (exact ties to the lower index, as a stable sort) and at the
//         sample's static backbone, with the top-K indices.
//
// They stand in for the torch body of _assemble (its plain twins
// assemble_head_reference and assemble_tail_reference), about 430 small
// launches a window of the tumor/normal call.  No Pallas kernel exists for
// the pass: the JAX package leaves it to XLA
// (varlociraptor_tpu/ops/posterior.py:1531-1705), so this replaces none.
//
// What bounds it on an H100: the bytes.  Each input is read once and each
// output written once (the head's w [L, NB, Gi] in and wsel out per sample,
// the tail's d_own [L, 1, NB, Gi] in per sample); the arithmetic is a few
// exponentials an element.  At the tumor/normal window that is a few MB,
// about a microsecond at 3.35 TB/s, so the launches' own latency and the
// loci's dependent steps (events, then the MAP event, then the masks; the
// density, then its top-K, then the parabola) set the time.
//
// Design:
// * head: a block a locus.  Its first warp computes the events, a lane an
//   event, the marginal and the MAP event by warp reductions, and the
//   combination masses, a lane a slot; then the whole block writes the
//   selections of every sample, coalesced along (nb, g).
// * tail: a warp a (locus, sample).  The warp walks the grid in chunks of
//   32 x V points, a lane V of them, each density a two-pass lse over the
//   branches (loads coalesced along g); it merges each chunk into a running
//   top-K list held one entry a lane, by K rounds of a warp argmax over the
//   list and the chunk.  Nothing of the density is written: the parabola's
//   three points and the backbone are recomputed from d_own by the same
//   code, so they equal the values the ranking saw.  Any strides of d_own
//   and U0; the four warps' other-component sums (NB floats each) sit in
//   shared memory, opted in past 48 KB.
// * Limits (ops/assemble.py): MAX_SAMPLES samples and components, whose
//   tables travel in the launch's parameters; NB up to the card's opt-in
//   shared memory / 16 bytes; G <= 32,767 (the int16 indices); any number
//   of events (the head keeps them in the joint it writes).
// * The order of the event and branch sums is the plain version's; the sums
//   over the warp's lanes (the marginal) and over the branches are taken in
//   another association than torch's reductions, so values differ from the
//   plain version by a few ulp.  The parabola and the deci-PHRED scaling are
//   written with explicit rounding (no contraction into FMAs), as torch's
//   separate elementwise launches round.

#include <climits>
#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_SAMPLES = 16;  // ops/assemble.py:MAX_SAMPLES
constexpr int HEAD_THREADS = 128;
constexpr int TAIL_WARPS = 4;
constexpr int TAIL_THREADS = 32 * TAIL_WARPS;
constexpr int V = 4;             // grid points a lane holds a chunk
constexpr int SMEM_MAX = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -__builtin_huge_valf();
// torch casts its Python scalars to float32: log(0.5), -10 / log(10)
constexpr float PROB05 = (float)-0.6931471805599453;
constexpr float DPHRED = (float)(-10.0 / 2.302585092994046);

struct HeadSample {
  const float* w;  // [L, NB, G]
  float* wsel;     // [L, NB, G]
  int G;
};

struct HeadArgs {
  const float* bv;             // [L, B, NB]
  const unsigned char* gates;  // [L, NB]
  const float* n_art;          // [L] or null
  float ln_n_art;              // log n_art where n_art is null
  // the tables, indices int64: event e's branches ev_br[ev_ptr[e]:ev_ptr[e+1]]
  const long long* ev_ptr;      // [E + 1]
  const long long* ev_br;
  const unsigned char* ev_art;  // [E]
  const long long* art_br;      // the artifact events' branches
  int n_art_br;
  const long long* br_ev;  // [NB]: each branch's event
  int L, B, NB, E, S;
  float* joint;  // [L, E]
  float* marginal;
  float* post;  // [L, E]
  float* combo;  // [L, B]
  long long* best;
  HeadSample s[MAX_SAMPLES];
};

struct TailSample {
  const float* d;       // d_own [L, 1, NB, G] at strides dl, dnb, dg
  long long dl, dnb, dg;
  int G, comp;          // grid size, the sample's component
  const float* vals;    // [G]
  const long long* bb;  // the backbone [nbb]
  int nbb, K;           // backbone and top-K lengths
  int off_v, off_i;     // the sample's first column in dph and idx
};

struct TailComp {
  const float* u;  // U0 [L, 1, NB] at strides ul, unb
  long long ul, unb;
};

struct TailArgs {
  const float* marginal;  // [L]
  float* af;              // [L, S]
  short* dph;             // [L, wv]
  short* idx;             // [L, wi]
  int L, NB, S, C, wv, wi;
  TailSample s[MAX_SAMPLES];
  TailComp c[MAX_SAMPLES];
};

// the larger, NaN if either is NaN (torch.amax)
__device__ __forceinline__ float nanmax(float a, float b) { return (a != a || a > b) ? a : b; }

// whether (a, ia) comes before (b, ib) in a descending order that puts NaN
// first and breaks ties to the lower index (torch.argmax, a stable
// descending sort); an index < 0 (no candidate) comes last
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  if ((ia < 0) != (ib < 0)) return ib < 0;
  const bool na = a != a, nb = b != b;
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

// the first of the warp's (v, i) in that order, in every lane
__device__ __forceinline__ void warp_first(float& v, int& i) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, o);
    const int oi = __shfl_xor_sync(FULL, i, o);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float warp_nanmax(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = nanmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// logsumexp of at(0..n-1), two passes (ops/likelihood.py:_lse): -inf where
// every term is -inf (and where n is 0), the maximum where it is not finite
template <class At>
__device__ float lse_of(int n, At at) {
  float m = NEG_INF;
  for (int k = 0; k < n; ++k) m = nanmax(m, at(k));
  if (!isfinite(m)) return m;
  float s = 0.f;
  for (int k = 0; k < n; ++k) s += expf(at(k) - m);
  return logf(s) + m;
}

__device__ float event_value(const HeadArgs& a, int l, int e, float ln_art) {
  const long long lo = a.ev_ptr[e];
  const int n = (int)(a.ev_ptr[e + 1] - lo);
  if (n == 0) return NEG_INF;  // an event compiled to False
  const float* row = a.bv + (long long)l * a.B * a.NB;
  const long long* br = a.ev_br + lo;
  auto at_slot = [&](int b) {
    const float* r = row + (long long)b * a.NB;
    return lse_of(n, [&](int k) { return r[br[k]]; });
  };
  if (!a.ev_art[e]) return PROB05 + at_slot(0);
  if (a.B == 1) return NEG_INF;  // no artifact combination slot in the batch
  const float bias_prior = PROB05 - ln_art;
  return bias_prior + lse_of(a.B - 1, [&](int j) { return at_slot(j + 1); });
}

__global__ void __launch_bounds__(HEAD_THREADS) assemble_head_kernel(const __grid_constant__ HeadArgs a) {
  __shared__ int s_best;
  const int l = blockIdx.x;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    float ln_art = a.ln_n_art;
    if (a.n_art) {
      const float n = a.n_art[l];
      ln_art = logf(n < 1.f ? 1.f : n);  // clamp(min=1) keeps NaN
    }
    const long long je = (long long)l * a.E;
    // the locus's event values, each lane reading back only the ones it
    // wrote: no shared row, so any number of events
    float* sj = a.joint + je;
    for (int e = lane; e < a.E; e += 32) sj[e] = event_value(a, l, e, ln_art);
    __syncwarp();
    float m = NEG_INF;
    for (int e = lane; e < a.E; e += 32) m = nanmax(m, sj[e]);
    m = warp_nanmax(m);
    float marg = m;
    if (isfinite(m)) {
      float s = 0.f;
      for (int e = lane; e < a.E; e += 32) s += expf(sj[e] - m);
      marg = logf(warp_sum(s)) + m;
    }
    float bv = NEG_INF;
    int bi = -1;
    for (int e = lane; e < a.E; e += 32) {
      a.post[je + e] = sj[e] - marg;
      const float v = a.ev_art[e] ? NEG_INF : sj[e];
      if (before(v, e, bv, bi)) {
        bv = v;
        bi = e;
      }
    }
    warp_first(bv, bi);
    if (lane == 0) {
      a.marginal[l] = marg;
      a.best[l] = bi;
      s_best = bi;
    }
    const float* row = a.bv + (long long)l * a.B * a.NB;
    for (int b = lane; b < a.B; b += 32) {
      float v = NEG_INF;
      if (b > 0 && a.n_art_br > 0) {
        const float* r = row + (long long)b * a.NB;
        v = lse_of(a.n_art_br, [&](int k) { return r[a.art_br[k]]; });
      }
      a.combo[(long long)l * a.B + b] = v;
    }
  }
  __syncthreads();
  const int best = s_best;
  const unsigned char* gates = a.gates + (long long)l * a.NB;
  for (int si = 0; si < a.S; ++si) {
    const int G = a.s[si].G;
    const long long n = (long long)a.NB * G;
    const float* w = a.s[si].w + l * n;
    float* o = a.s[si].wsel + l * n;
    for (long long i = threadIdx.x; i < n; i += HEAD_THREADS) {
      const int nb = (int)(i / G);
      const bool sel = a.br_ev[nb] == best && gates[nb];
      o[i] = (sel && w[i] > NEG_INF) ? 0.f : NEG_INF;
    }
  }
}

__global__ void __launch_bounds__(TAIL_THREADS) assemble_tail_kernel(const __grid_constant__ TailArgs a) {
  extern __shared__ float s_rest[];  // TAIL_WARPS x NB
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l = blockIdx.x * TAIL_WARPS + warp;
  const int si = blockIdx.y;
  if (l >= a.L) return;  // a whole warp; the kernel has no block barrier
  const TailSample& t = a.s[si];
  float* rest = s_rest + warp * a.NB;
  for (int nb = lane; nb < a.NB; nb += 32) {
    float r = 0.f;  // 0 + the other components in order, as the plain version
    for (int c = 0; c < a.C; ++c)
      if (c != t.comp) r += a.c[c].u[l * a.c[c].ul + nb * a.c[c].unb];
    rest[nb] = r;
  }
  __syncwarp();
  const float* d = t.d + l * t.dl;
  const long long dnb = t.dnb;
  const int NB = a.NB;
  auto dens = [&](int g) {
    const float* p = d + g * t.dg;
    return lse_of(NB, [&](int nb) { return p[nb * dnb] + rest[nb]; });
  };

  // the running top-K: lane k < K holds the k-th (tv at ti)
  const int G = t.G, K = t.K;
  float tv = NEG_INF;
  int ti = -1;
  for (int base = 0; base < G; base += 32 * V) {
    float cv[V];
    int ci[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int g = base + v * 32 + lane;
      ci[v] = g < G ? g : -1;
      cv[v] = g < G ? dens(g) : NEG_INF;
    }
    bool live = ti >= 0;  // the lane's list entry is still to place
    float nv = NEG_INF;
    int ni = -1;
    for (int r = 0; r < K; ++r) {
      float bv = live ? tv : NEG_INF;
      int bi = live ? ti : -1;
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (ci[v] >= 0 && before(cv[v], ci[v], bv, bi)) {
          bv = cv[v];
          bi = ci[v];
        }
      warp_first(bv, bi);
      if (live && ti == bi) live = false;
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (ci[v] == bi) ci[v] = -1;
      if (lane == r) {
        nv = bv;
        ni = bi;
      }
    }
    tv = nv;
    ti = ni;
  }

  // the MAP point (the first maximum) and its log-parabola refinement
  const int gi = __shfl_sync(FULL, ti, 0);
  float dx = NEG_INF;
  int gc = 0;
  if (G >= 3) {
    gc = min(max(gi, 1), G - 2);
    if (lane < 3) dx = dens(gc - 1 + lane);
  }
  const float dm = __shfl_sync(FULL, dx, 0);
  const float d0 = __shfl_sync(FULL, dx, 1);
  const float dp = __shfl_sync(FULL, dx, 2);
  if (lane == 0) {
    const float* vals = t.vals;
    float af = vals[gi];
    if (G >= 3) {
      const float g_at = vals[gc], vm = vals[gc - 1], vp = vals[gc + 1];
      const float left = __fsub_rn(g_at, vm), right = __fsub_rn(vp, g_at);
      const float t1 = __fsub_rn(dm, d0), t2 = __fsub_rn(dp, d0);
      const float num = __fsub_rn(__fmul_rn(__fmul_rn(t1, right), right),
                                  __fmul_rn(__fmul_rn(t2, left), left));
      const float den = __fadd_rn(__fmul_rn(t1, right), __fmul_rn(t2, left));
      const bool neg = den < -1e-12f;
      const float off = neg ? __fdiv_rn(__fmul_rn(0.5f, num), den) : 0.f;
      const float af_ref = fminf(fmaxf(__fadd_rn(g_at, off), vm), vp);
      const bool ok = gi >= 1 && gi <= G - 2 && isfinite(dm) && isfinite(dp) &&
                      fabsf(off) <= fmaxf(left, right) && neg;
      if (ok) af = af_ref;
    }
    a.af[(long long)l * a.S + si] = af;
  }

  // deci-PHRED of dens - marginal: round half to even, clamp, 32767 where
  // not finite
  const float marg = a.marginal[l];
  auto dphred = [&](float v) -> short {
    const float rel = v - marg;
    if (!isfinite(rel)) return 32767;
    const float x = rintf(__fmul_rn(__fmul_rn(DPHRED, rel), 10.f));
    return (short)fminf(fmaxf(x, -32767.f), 32766.f);
  };
  short* dph = a.dph + (long long)l * a.wv + t.off_v;
  if (lane < K) {
    dph[lane] = dphred(tv);
    a.idx[(long long)l * a.wi + t.off_i + lane] = (short)ti;
  }
  if (lane < t.nbb) dph[K + lane] = dphred(dens(t.bb[lane]));
}

}  // namespace

// Plain C entries for ctypes.  Each launches on `stream` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a shape the
// kernel does not take.  Device pointers, contiguous unless strides are given.

// per: S rows of (w, wsel, G) on the host, w and wsel [L, NB, G] float32.
extern "C" int vlt_assemble_head(const float* bv, const unsigned char* gates, const float* n_art,
                                 float ln_n_art, const long long* ev_ptr,
                                 const long long* ev_br, const unsigned char* ev_art,
                                 const long long* art_br, int n_art_br, const long long* br_ev,
                                 int L, int B, int NB, int E, int S,
                                 const long long* per, float* joint, float* marginal, float* post,
                                 float* combo, long long* best, void* stream) {
  if (L < 0 || B <= 0 || NB <= 0 || E <= 0 || S < 0 || S > MAX_SAMPLES || n_art_br < 0)
    return (int)cudaErrorInvalidValue;
  HeadArgs a{};
  a.bv = bv;
  a.gates = gates;
  a.n_art = n_art;
  a.ln_n_art = ln_n_art;
  a.ev_ptr = ev_ptr;
  a.ev_br = ev_br;
  a.ev_art = ev_art;
  a.art_br = art_br;
  a.n_art_br = n_art_br;
  a.br_ev = br_ev;
  a.L = L;
  a.B = B;
  a.NB = NB;
  a.E = E;
  a.S = S;
  a.joint = joint;
  a.marginal = marginal;
  a.post = post;
  a.combo = combo;
  a.best = best;
  for (int s = 0; s < S; ++s) {
    const long long* r = per + 3 * s;
    if (r[2] <= 0 || r[2] > INT_MAX / NB) return (int)cudaErrorInvalidValue;
    a.s[s] = HeadSample{(const float*)r[0], (float*)r[1], (int)r[2]};
  }
  if (L == 0) return (int)cudaSuccess;
  assemble_head_kernel<<<(unsigned)L, HEAD_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// per: S rows of (d_own, its strides l, nb, g, G, component, vals, backbone,
// its length, K, first dph column, first idx column) on the host; comps: C
// rows of (U0, its strides l, nb).  d_own [L, 1, NB, G] and U0 [L, 1, NB]
// float32, vals [G] float32, backbone int64; af [L, S] float32, dph [L, wv]
// and idx [L, wi] int16.
extern "C" int vlt_assemble_tail(const long long* per, int S, const long long* comps, int C,
                                 int L, int NB, const float* marginal, float* af, short* dph,
                                 int wv, short* idx, int wi, void* stream) {
  const size_t bytes = (size_t)TAIL_WARPS * NB * sizeof(float);
  if (L < 0 || NB <= 0 || S < 0 || S > MAX_SAMPLES || C < 1 || C > MAX_SAMPLES ||
      bytes > INT_MAX)
    return (int)cudaErrorInvalidValue;
  TailArgs a{};
  a.marginal = marginal;
  a.af = af;
  a.dph = dph;
  a.idx = idx;
  a.L = L;
  a.NB = NB;
  a.S = S;
  a.C = C;
  a.wv = wv;
  a.wi = wi;
  for (int s = 0; s < S; ++s) {
    const long long* r = per + 12 * s;
    TailSample& t = a.s[s];
    t = TailSample{(const float*)r[0], r[1], r[2], r[3], (int)r[4], (int)r[5],
                   (const float*)r[6], (const long long*)r[7], (int)r[8], (int)r[9],
                   (int)r[10], (int)r[11]};
    if (r[4] <= 0 || r[4] > 32767 || t.comp < 0 || t.comp >= C || t.K < 1 || t.K > 32 ||
        t.K > t.G || t.nbb < 0 || t.nbb > 32 || t.off_v + t.K + t.nbb > wv ||
        t.off_i + t.K > wi)
      return (int)cudaErrorInvalidValue;
  }
  for (int c = 0; c < C; ++c) a.c[c] = TailComp{(const float*)comps[3 * c], comps[3 * c + 1],
                                                comps[3 * c + 2]};
  if (L == 0 || S == 0) return (int)cudaSuccess;
  if (bytes > SMEM_MAX) {  // past 48 KB (NB > 3,072) the card's larger shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        assemble_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((L + TAIL_WARPS - 1) / TAIL_WARPS), (unsigned)S);
  assemble_tail_kernel<<<grid, TAIL_THREADS, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
