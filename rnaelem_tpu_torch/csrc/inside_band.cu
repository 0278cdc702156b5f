// K2 and K10: the band stages of one inside DP column j: the ST_L chain
// (L), pair cells (P), the multiloop 2-chain (T2), bifurcations (B) with T1,
// the sequential multiloop M chain, and E from its hairpin, multiloop and
// internal-loop (K3 / K11) terms.  K2 is the sum DP (log-sum-exp), K10 the
// CYK tables (max): every kernel is a template on the semiring policy
// (common.cuh SumSR / MaxSR), so the two DPs share the index maths.
//
// Replaces (rnaelem_tpu, XLA-compiled jnp programs): K2 ops/dp.py
// cols_fn's chain / p_col / T2 / b_col / T1 / m_col / E (row E of the
// kernel table, ops/dp.py:352-475 and 656-712); K10 the same pieces of
// ops/dp_maxb.py build_max_tables (row L, chain :122, p_col :137, b_col
// :177, m_col :193 and the E/T1/T2 maxima of cols_fn :378).
//
// Bound on the H100: bytes.  Per column it must read the cells of the T1
// window that the splits reach, (row j-dk, width w-dk) for 1 <= dk <= w
// <= Wp at parsable w (at most Wp(Wp+1)/2 of the Wp x (Wp+1) cells), rows
// j-1 of LL, E, P, T2 in the states their transitions read, and write
// seven rows (about 27 MB at B=128 random 100-nt reads in f32, 8 us at
// 3.35 TB/s; chip_smoke.py counts it for its batch); the arithmetic,
// mostly the B = 1 x 2 splits (for each (w, target, read) cell a sum
// over the target's (a, c) split tuples and dk = 1..w: n_b12 * Wp^2 / 2
// terms per read, n_b12 = 71 for pattern (.....)), is about 0.02 GFLOP.
// The M chain is a band-deep sequential dependency.  Design: the read
// index is the fastest thread index everywhere, so every table read and
// write is coalesced in the batch-minor layout; sums are direct log-space
// online log-sum-exps (maxima for K10) over the grammar's sparse lists
// (right/left transitions and split tuples in CSR by target: no dense S x
// S work, no max-shift underflow).  The B sum gives each (w, target, read)
// cell two threads, each a contiguous slice of dk whose loads go out in
// chunks, merged in order.  The M chain (csrc/mchain.cuh) runs one block
// per group of reads, one cell per (state, read), a thread's cells' inputs
// staged by cp.async a few steps ahead, one barrier per step.  The
// scanner's pin set (common.cuh Aux: the end pass's start
// pin, CYK's start, end and tail pins) vetoes transitions at the pinned
// bases: the L/T2 chains and P skip the vetoed transitions that emit
// them, the M chain likewise (base j-w).  The pin test is a template flag
// chosen at launch, so an evaluation without a pin runs the loops without
// it.
#include "mchain.cuh"

#define TIDX(r, w, s, b) ((((long long)(r) * W1 + (w)) * S + (s)) * B + (b))

struct BandIdx {  // grammar index lists (int32 unless noted)
  const int* rt_off;  // [S+1] CSR of right transitions by target
  const int* rt_s;    //       source states
  const void* rt_w;   //       log weights (scalar type)
  const int* lt_off;  // [S+1] CSR of left transitions by target
  const int* lt_s;
  const void* lt_w;
  const void* pt_lt;  // [S, S] log tau of pair transitions (scalar type)
  const int* diag;    // [S]
  const int* loopm;   // [S]
  const int* bucket;  // [S] lambda bucket
  const int* pt_code; // [S, S] -1 none, -2 background, else pair table
  const int* pt_wl;   // [S, S]
  const int* pt_wr;   // [S, S]
  const int* b12_off; // [S+1] CSR of (a, c) split tuples by target
  const int* b12_a;
  const int* b12_c;
};

// ---- L, P and T2 of column j: one thread per (w, t, b)
template <typename T, class SR, bool kPin>
__global__ void band_front_kernel(DPDims D, BandIdx ix, Aux ax, T* LL, T* P,
                                  T* T2,
                                  const T* E, const T* eR, const T* bg2,
                                  const T* pv, const T* alphaP, const T* wsp,
                                  const T* lam, const T* stk, const T* ml2,
                                  const T* gate_O2, const bool* okP,
                                  const bool* okB) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, Lp = D.Lp, j = D.j;
  const unsigned n = (unsigned)W1 * S * B;
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int b = idx % B;
  const int t = (idx / B) % S;
  const int w = idx / (B * S);
  const int r = j + D.PAD, rp = r - 1;
  const T* rtw = static_cast<const T*>(ix.rt_w);
  const T* ptl = static_cast<const T*>(ix.pt_lt);
  const T eRt = eR[((long long)(j - 1) * S + t) * B + b];
  const long long cell = ((long long)j * W1 + w) * B + b;  // [Lp+1,W1,B]
  const T lam_t = lam[ix.bucket[t]];
  const int k0 = ix.rt_off[t], k1 = ix.rt_off[t + 1];
  const int pinR = kPin ? pin_req(ax, b, j - 1, kAuxR) : 0;
  const int pinPR = kPin ? pin_req(ax, b, j - 1, kAuxPR) : 0;

  // U1: ST_L chain (motif_model.hpp:243-257); width 0 is the diagonal
  T Lv;
  if (w == 0) {
    Lv = ix.diag[t] ? (T)0 : ninf<T>();
  } else {
    typename SR::Acc acc;
    for (int k = k0; k < k1; ++k) {
      if (vetoed(ax, pinR, kAuxR, t, ix.rt_s[k], S)) continue;
      acc.add(rtw[k] + LL[TIDX(rp, w - 1, ix.rt_s[k], b)]);
    }
    Lv = acc.result() + eRt;
  }

  // U2: P <- pair emission * (E | P) of the inner span (TT_P_E / TT_P_P)
  T Pv = ninf<T>();
  if (okP[cell]) {
    int iw = j - w;
    iw = iw < 0 ? 0 : (iw > Lp - 1 ? Lp - 1 : iw);
    const T bgsum = bg2[(long long)iw * B + b] + bg2[(long long)(j - 1) * B + b];
    const T wl = wsp[(long long)iw * B + b];
    const T wr = wsp[(long long)(j - 1) * B + b];
    typename SR::Acc ape, app;
    const int pinPL = kPin ? pin_req(ax, b, iw, kAuxPL) : 0;
    if (w >= 2) {
      for (int s = 0; s < S; ++s) {
        const int code = ix.pt_code[t * S + s];
        if (code == -1 || vetoed(ax, pinPL, kAuxPL, t, s, S) ||
            vetoed(ax, pinPR, kAuxPR, t, s, S))
          continue;
        T pem;
        if (code == -2) {
          pem = bgsum;
        } else {
          pem = pv[(((long long)j * W1 + w) * D.Tp + code) * B + b];
          if (ix.pt_wl[t * S + s]) pem += wl;
          if (ix.pt_wr[t * S + s]) pem += wr;
        }
        pem += ptl[t * S + s];
        ape.add(pem + E[TIDX(rp, w - 2, s, b)]);
        app.add(pem + P[TIDX(rp, w - 2, s, b)]);
      }
    }
    const T a_pp = app.result() + lam_mul(lam_t, stk[cell]);
    Pv = SR::plus(ape.result(), a_pp) + alphaP[cell];
  }

  // U3: 2 (TT_2_2 / TT_2_P)
  T T2v = ninf<T>();
  if (okB[cell]) {
    T ch = ninf<T>();
    if (w >= 1) {
      typename SR::Acc acc;
      for (int k = k0; k < k1; ++k) {
        if (vetoed(ax, pinR, kAuxR, t, ix.rt_s[k], S)) continue;
        acc.add(rtw[k] + T2[TIDX(rp, w - 1, ix.rt_s[k], b)]);
      }
      ch = acc.result() + eRt + gate_O2[(long long)(j - 1) * B + b];
    }
    T2v = SR::plus(ch, Pv + lam_mul(lam_t, ml2[cell]));
  }
  LL[TIDX(r, w, t, b)] = Lv;
  P[TIDX(r, w, t, b)] = Pv;
  T2[TIDX(r, w, t, b)] = T2v;
}

// ---- B (TT_B_12) and T1 of column j: kBifHalves threads per (w, t, b)
// cell, each taking one contiguous slice of dk = 1..w, the block 32 reads
// x kBifWidths consecutive widths of one target t (the widest first).  A
// thread walks its slice tuple by tuple in chunks of BifChunk<SR> dk: a
// chunk's loads go out together, and its log-sum-exp takes one rescale;
// the cell's first thread merges the slices in order (the T2 row of a dk
// is the same for every width: the block shares it in L1).  The chunk is
// 8 dk for the sum DP, whose masks leave few live cells, and 32 (one per
// tuple at the default span) for the CYK tables, whose cells are dense:
// the faster of 8, 16 and 32 for each (PERF.md, the launch constants).
// B(i, j) = sum over split tuples (t, a, c) and dk of
// T1(i, j-dk)[a] * T2(j-dk, j)[c]; dk = 0 and 2-cells of width 0 excluded.
static const int kBifWidths = 4;
static const int kBifHalves = 2;
template <class SR>
struct BifChunk {
  static const int n = 8;
};
template <typename T>
struct BifChunk<MaxSR<T>> {
  static const int n = 32;
};

template <typename T, class SR>
__global__ void __launch_bounds__(32 * kBifWidths * kBifHalves)
band_bif_kernel(DPDims D, BandIdx ix, T* __restrict__ Bt, T* __restrict__ T1,
                const T* __restrict__ T2, const bool* __restrict__ okB) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, j = D.j;
  const int nbx = (B + 31) / 32, blk = blockIdx.x;
  const int b = (blk % nbx) * 32 + threadIdx.x;
  const int t = (blk / nbx) % S;
  const int wl = threadIdx.y / kBifHalves, half = threadIdx.y % kBifHalves;
  const int w = D.Wp - ((blk / (nbx * S)) * kBifWidths + wl);
  const int r = j + D.PAD;
  __shared__ T part[kBifWidths * kBifHalves][32];
  const bool ok = b < B && w >= 0 && okB[((long long)j * W1 + w) * B + b];
  constexpr int CH = BifChunk<SR>::n;
  typename SR::Acc acc;
  if (ok && w >= 1) {
    const long long s1 = (long long)(W1 + 1) * S * B, s2 = (long long)S * B;
    const int per = (w + kBifHalves - 1) / kBifHalves, lo = half * per;
    const int n = (lo + per < w ? lo + per : w) - lo;  // dk = lo+1 .. lo+n
    for (int k = ix.b12_off[t]; n > 0 && k < ix.b12_off[t + 1]; ++k) {
      const T* p1 = T1 + TIDX(r - 1 - lo, w - 1 - lo, ix.b12_a[k], b);
      const T* p2 = T2 + TIDX(r, 1 + lo, ix.b12_c[k], b);
      for (int d0 = 0; d0 < n; d0 += CH) {
        T x[CH];
#pragma unroll
        for (int i = 0; i < CH; ++i, p1 -= s1, p2 += s2)
          x[i] = d0 + i < n ? *p1 + *p2 : ninf<T>();
        acc.add_n(x);
      }
    }
  }
  part[threadIdx.y][threadIdx.x] = acc.result();
  __syncthreads();
  if (half != 0 || b >= B || w < 0) return;
  T Bv = ninf<T>(), T1v = ninf<T>();
  if (ok) {
    typename SR::Acc all;
    for (int h = 0; h < kBifHalves; ++h)
      all.add(part[wl * kBifHalves + h][threadIdx.x]);
    Bv = all.result();
    T1v = SR::plus(T2[TIDX(r, w, t, b)], Bv);
  }
  Bt[TIDX(r, w, t, b)] = Bv;
  T1[TIDX(r, w, t, b)] = T1v;
}

// ---- M chain (TT_M_M / TT_M_B), sequential over w within column j
// (motif_model.hpp:346-366): one block per group of G reads, cell (s, g)
// the cell of state s of read g, NC cells a thread (csrc/mchain.cuh).
// Step w: each thread takes its cells' ring stages (Bt, eL, gate_M, okM
// of step w, copied R - 1 steps ahead), publishes y = M(w-1)[s] and eL[s]
// of each, and after the step's barrier takes for each cell the
// log-sum-exp (K10: the max) of Bt and ((y[s'] + TL[s, s']) + eL[s']) +
// gate over its left-transition sources s' (their y and eL in the
// published row) in one pass: the terms' exps do not wait on each other.
// The terms keep the plain versions' association, so K10 equals the plain
// max DP bit for bit.  kDev: the layout in the block's slice of ws.
template <typename T, class SR, bool kPin, int G, int R, int NC, bool kDev>
__global__ void __launch_bounds__(1024)
band_m_kernel(DPDims D, BandIdx ix, Aux ax, T* M, const T* Bt, const T* eL,
              const T* gate_M, const bool* okM, unsigned char* ws) {
  static_assert((R & (R - 1)) == 0, "the ring's stages: a power of 2");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = D.S, B = D.B, W1 = D.Wp + 1, Lp = D.Lp, j = D.j;
  const MLayout lay(S, G, R, 2, 3, sizeof(T));
  unsigned char* base = mchain_base<kDev>(smem_raw, ws, lay.total);
  const int n = (int)lay.n;
  T* ybuf = reinterpret_cast<T*>(base + lay.buf);     // [2][2][n]
  T* ring = reinterpret_cast<T*>(base + lay.ring);    // [R][3][n]
  int* rok = reinterpret_cast<int*>(base + lay.ok);   // [R][n]
  const int g = threadIdx.x % G;
  const int b = blockIdx.x * G + g;
  const long long SB = (long long)S * B;
  const bool* oks = okM + (long long)j * W1 * B + b;
  const T* ltw = static_cast<const T*>(ix.lt_w);
  // this thread's cells c (state c / G): their rows (w, s, b) of the
  // column's tables at w = 0 and their left-transition sources, the first
  // kMSrc in registers
  int cid[NC], k0[NC], k1[NC], src[NC][kMSrc];
  bool live[NC];
  long long cell0[NC];
  T wt[NC][kMSrc], x[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    cid[k] = threadIdx.x + k * blockDim.x;
    const int s = cid[k] / G;
    live[k] = s < S && b < B;
    cell0[k] = TIDX(j + D.PAD, 0, s, b);
    k0[k] = live[k] ? ix.lt_off[s] : 0;
    k1[k] = live[k] ? ix.lt_off[s + 1] : 0;
#pragma unroll
    for (int q = 0; q < kMSrc; ++q) {
      src[k][q] = k0[k] + q < k1[k] ? ix.lt_s[k0[k] + q] * G + g : 0;
      wt[k][q] = k0[k] + q < k1[k] ? ltw[k0[k] + q] : (T)0;
    }
    x[k] = ninf<T>();
  }
  auto issue = [&](int w) {
    if (w < W1) {
      const int q = w & (R - 1), iw = clip_row(j - w, Lp);
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        if (!live[k]) continue;
        T* st = ring + q * 3 * n + cid[k];
        mchain_copy<kDev>(st, Bt + cell0[k] + w * SB);
        mchain_copy<kDev>(st + n, eL + iw * SB + (cid[k] / G) * (long long)B +
                                      b);
        mchain_copy<kDev>(st + 2 * n, gate_M + (long long)iw * B + b);
        mchain_copy_word<kDev>(rok + q * n + cid[k],
                               ok_word(oks + (long long)w * B));
      }
    }
    mchain_commit<kDev>();
  };
  for (int w = 0; w < R - 1; ++w) issue(w);
  PinRegs pr;
  if (kPin && b < B) pr = pin_regs(ax, b, kAuxL);
  for (int w = 0; w < W1; ++w) {
    issue(w + R - 1);
    mchain_wait<kDev, R - 1>();
    T* y = ybuf + (w & 1) * 2 * n;   // [n] M(w-1), then [n] eL of step w
    T* eLw = y + n;
    T bt[NC], gt[NC];
    bool ok[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      bt[k] = ninf<T>();
      gt[k] = (T)0;
      ok[k] = false;
      if (live[k]) {
        const T* st = ring + (w & (R - 1)) * 3 * n + cid[k];
        bt[k] = st[0];
        gt[k] = st[2 * n];
        y[cid[k]] = x[k];
        eLw[cid[k]] = st[n];
        ok[k] = ok_byte(rok[(w & (R - 1)) * n + cid[k]],
                        oks + (long long)w * B);
      } else if (cid[k] < n) {
        y[cid[k]] = ninf<T>();
        eLw[cid[k]] = ninf<T>();
      }
    }
    mchain_sync();
    const int pinL = kPin && b < B ? pin_req_reg(ax, pr, clip_row(j - w, Lp))
                                   : 0;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (!live[k]) continue;
      const int s = cid[k] / G;
      T cur = ninf<T>();
      if (ok[k]) {
        T terms[kMSrc + 1];
        terms[0] = bt[k];
#pragma unroll
        for (int q = 0; q < kMSrc; ++q)
          terms[q + 1] =
              k0[k] + q < k1[k] &&
                      !(kPin && vetoed(ax, pinL, kAuxL, s, src[k][q] / G, S))
                  ? ((y[src[k][q]] + wt[k][q]) + eLw[src[k][q]]) + gt[k]
                  : ninf<T>();
        typename SR::Acc acc;
        acc.add_n(terms);
        for (int kk = k0[k] + kMSrc; kk < k1[k]; ++kk) {
          if (kPin && vetoed(ax, pinL, kAuxL, s, ix.lt_s[kk], S)) continue;
          const int c = ix.lt_s[kk] * G + g;
          acc.add(((y[c] + ltw[kk]) + eLw[c]) + gt[k]);
        }
        cur = acc.result();
      }
      x[k] = cur;
      M[cell0[k] + w * SB] = cur;
    }
  }
}

// ---- E (TT_E_H / TT_E_M / TT_E_P) of column j: one thread per (w, t, b)
template <typename T, class SR>
__global__ void band_e_kernel(DPDims D, BandIdx ix, T* E, const T* LL,
                              const T* M, const T* ep, const T* lam,
                              const T* hp, const T* mlE, const bool* okE) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, j = D.j;
  const unsigned n = (unsigned)W1 * S * B;
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int b = idx % B;
  const int t = (idx / B) % S;
  const int w = idx / (B * S);
  const int r = j + D.PAD;
  const long long cell = ((long long)j * W1 + w) * B + b;
  T Ev = ninf<T>();
  if (okE[cell]) {
    const T lam_t = lam[ix.bucket[t]];
    const T h = ix.loopm[t] ? LL[TIDX(r, w, t, b)] + lam_mul(lam_t, hp[cell])
                            : ninf<T>();
    const T m = M[TIDX(r, w, t, b)] + lam_mul(lam_t, mlE[cell]);
    Ev = SR::plus(SR::plus(h, m), ep[idx]);
  }
  E[TIDX(r, w, t, b)] = Ev;
}

static const int kThreads = 256;

static bool too_big(const DPDims& D) {
  return (long long)(D.Wp + 1) * D.S * D.B >= (1LL << 31);
}

template <typename T, class SR>
static int front(DPDims D, BandIdx ix, Aux ax, T* LL, T* P, T* T2, const T* E,
                 const T* eR, const T* bg2, const T* pv, const T* alphaP,
                 const T* wsp, const T* lam, const T* stk, const T* ml2,
                 const T* gate_O2, const bool* okP, const bool* okB,
                 cudaStream_t st) {
  if (too_big(D)) return static_cast<int>(cudaErrorInvalidValue);
  long long n = (long long)(D.Wp + 1) * D.S * D.B;
  auto kern = has_pin(ax) ? band_front_kernel<T, SR, true>
                          : band_front_kernel<T, SR, false>;
  kern<<<ceil_div(n, kThreads), kThreads, 0, st>>>(
      D, ix, ax, LL, P, T2, E, eR, bg2, pv, alphaP, wsp, lam, stk, ml2, gate_O2,
      okP, okB);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, class SR>
static int bif(DPDims D, BandIdx ix, T* Bt, T* T1, const T* T2,
               const bool* okB, cudaStream_t st) {
  const long long n = (long long)((D.B + 31) / 32) * D.S *
                      ((D.Wp + kBifWidths) / kBifWidths);
  if (n >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  band_bif_kernel<T, SR><<<(int)n, dim3(32, kBifWidths * kBifHalves), 0,
                           st>>>(D, ix, Bt, T1, T2, okB);
  return static_cast<int>(cudaGetLastError());
}

// the M chain in blocks of G reads with a ring of R stages, NC cells a
// thread, in shared memory or (ws not null) in ws (the plan's)
template <typename T, class SR>
static int mchain(DPDims D, BandIdx ix, Aux ax, T* M, const T* Bt, const T* eL,
                  const T* gate_M, const bool* okM, unsigned char* ws, int G_,
                  int R_, int NC_, cudaStream_t st) {
  if (!mchain_fits(D.S, G_, NC_))
    return static_cast<int>(cudaErrorInvalidValue);
  return mchain_dispatch(G_, R_, NC_, ws != nullptr, [&](auto g, auto r,
                                                         auto nc, auto dv) {
    constexpr int G = decltype(g)::value, R = decltype(r)::value;
    constexpr int NC = decltype(nc)::value;
    constexpr bool kDev = decltype(dv)::value;
    const long long bytes =
        kDev ? 0 : mchain_layout(0, D.S, G, R, sizeof(T)).total;
    auto kern = has_pin(ax) ? band_m_kernel<T, SR, true, G, R, NC, kDev>
                            : band_m_kernel<T, SR, false, G, R, NC, kDev>;
    const int rc = allow_smem((const void*)kern, bytes);
    if (rc) return rc;
    kern<<<(D.B + G - 1) / G, mchain_threads(D.S, G, NC), bytes, st>>>(
        D, ix, ax, M, Bt, eL, gate_M, okM, ws);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T, class SR>
static int ecol(DPDims D, BandIdx ix, T* E, const T* LL, const T* M,
                const T* ep, const T* lam, const T* hp, const T* mlE,
                const bool* okE, cudaStream_t st) {
  if (too_big(D)) return static_cast<int>(cudaErrorInvalidValue);
  long long n = (long long)(D.Wp + 1) * D.S * D.B;
  band_e_kernel<T, SR><<<ceil_div(n, kThreads), kThreads, 0, st>>>(
      D, ix, E, LL, M, ep, lam, hp, mlE, okE);
  return static_cast<int>(cudaGetLastError());
}

// rnaelem_band_<stage>_<type> (K2, sum) and rnaelem_band_<stage>_max_<type>
// (K10, max)
#define BAND_EXPORTS(SUF, T, SR)                                             \
  RNAELEM_EXPORT int rnaelem_band_front_##SUF(                               \
      DPDims D, BandIdx ix, Aux ax, T* LL, T* P, T* T2, const T* E,          \
      const T* eR,                                                           \
      const T* bg2, const T* pv, const T* alphaP, const T* wsp,              \
      const T* lam, const T* stk, const T* ml2, const T* gate_O2,            \
      const bool* okP, const bool* okB, cudaStream_t st) {                   \
    return front<T, SR>(D, ix, ax, LL, P, T2, E, eR, bg2, pv, alphaP, wsp,   \
                        lam, stk, ml2, gate_O2, okP, okB, st);               \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_band_bif_##SUF(DPDims D, BandIdx ix, T* Bt,     \
                                            T* T1, const T* T2,              \
                                            const bool* okB,                 \
                                            cudaStream_t st) {               \
    return bif<T, SR>(D, ix, Bt, T1, T2, okB, st);                           \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_band_m_##SUF(                                   \
      DPDims D, BandIdx ix, Aux ax, T* M, const T* Bt, const T* eL,          \
      const T* gate_M, const bool* okM, unsigned char* ws, int G, int R,     \
      int NC, cudaStream_t st) {                                             \
    return mchain<T, SR>(D, ix, ax, M, Bt, eL, gate_M, okM, ws, G, R, NC,    \
                         st);                                                \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_band_e_##SUF(                                   \
      DPDims D, BandIdx ix, T* E, const T* LL, const T* M, const T* ep,      \
      const T* lam, const T* hp, const T* mlE, const bool* okE,              \
      cudaStream_t st) {                                                     \
    return ecol<T, SR>(D, ix, E, LL, M, ep, lam, hp, mlE, okE, st);          \
  }

BAND_EXPORTS(f32, float, SumSR<float>)
BAND_EXPORTS(f64, double, SumSR<double>)
BAND_EXPORTS(max_f32, float, MaxSR<float>)
BAND_EXPORTS(max_f64, double, MaxSR<double>)
