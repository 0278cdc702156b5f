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
// S work, no max-shift underflow).  The B sum gives each (w, target, 32
// reads) a block whose eight warps split dk and merge in shared memory, so
// the longest serial chain is w/8 steps.  The M chain runs one block per
// read, one thread per target state, with the previous cell in shared
// memory and the next step's loads issued before the current step's
// arithmetic.  The scanner's pin set (common.cuh Aux: the end pass's start
// pin, CYK's start, end and tail pins) vetoes transitions at the pinned
// bases: the L/T2 chains and P skip the vetoed transitions that emit
// them, the M chain likewise (base j-w).  The pin test is a template flag
// chosen at launch, so an evaluation without a pin runs the loops without
// it.
#include "common.cuh"

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

// ---- B (TT_B_12) and T1 of column j: one block per (32 reads, t, w),
// the eight warps splitting dk = 1..w.
// B(i, j) = sum over split tuples (t, a, c) and dk of
// T1(i, j-dk)[a] * T2(j-dk, j)[c]; dk = 0 and 2-cells of width 0 excluded.
template <typename T, class SR>
__global__ void band_bif_kernel(DPDims D, BandIdx ix, T* Bt, T* T1,
                                const T* T2, const bool* okB) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, j = D.j;
  const int b = blockIdx.x * 32 + threadIdx.x;
  const int t = blockIdx.y, w = blockIdx.z;
  const int r = j + D.PAD;
  __shared__ T part[8][32];
  const bool ok = b < B && okB[((long long)j * W1 + w) * B + b];
  typename SR::Acc acc;
  if (ok) {
    const int k0 = ix.b12_off[t], k1 = ix.b12_off[t + 1];
    for (int dk = 1 + threadIdx.y; dk <= w; dk += blockDim.y) {
      for (int k = k0; k < k1; ++k) {
        const T x1 = T1[TIDX(r - dk, w - dk, ix.b12_a[k], b)];
        if (!(x1 > ninf<T>())) continue;
        acc.add(x1 + T2[TIDX(r, dk, ix.b12_c[k], b)]);
      }
    }
  }
  part[threadIdx.y][threadIdx.x] = acc.result();
  __syncthreads();
  if (threadIdx.y != 0 || b >= B) return;
  T Bv = ninf<T>(), T1v = ninf<T>();
  if (ok) {
    typename SR::Acc all;
    for (int y = 0; y < blockDim.y; ++y) all.add(part[y][threadIdx.x]);
    Bv = all.result();
    T1v = SR::plus(T2[TIDX(r, w, t, b)], Bv);
  }
  Bt[TIDX(r, w, t, b)] = Bv;
  T1[TIDX(r, w, t, b)] = T1v;
}

// ---- M chain (TT_M_M / TT_M_B), sequential over w within column j
// (motif_model.hpp:346-366): one block per read, one thread per target.
// Each step thread s publishes y[s] = M(w-1)[s] + eL[s] + gate in shared
// memory, then thread t takes the log-sum-exp of y + TL[t, :] over its
// left-transition sources.
template <typename T, class SR, bool kPin>
__global__ void band_m_kernel(DPDims D, BandIdx ix, Aux ax, T* M, const T* Bt,
                              const T* eL, const T* gate_M, const bool* okM) {
  extern __shared__ unsigned char smem_raw[];
  T* y = reinterpret_cast<T*>(smem_raw);  // [S]
  const int S = D.S, B = D.B, W1 = D.Wp + 1, Lp = D.Lp, j = D.j;
  const int b = blockIdx.x, t = threadIdx.x;
  const int r = j + D.PAD;
  const T* ltw = static_cast<const T*>(ix.lt_w);
  const int k0 = t < S ? ix.lt_off[t] : 0, k1 = t < S ? ix.lt_off[t + 1] : 0;
  // loads of step w, issued one step ahead
  T bt_n = ninf<T>(), el_n = ninf<T>(), gm_n = (T)0;
  bool ok_n = false;
  auto fetch = [&](int w) {
    int iw = j - w;
    iw = iw < 0 ? 0 : (iw > Lp - 1 ? Lp - 1 : iw);
    ok_n = okM[((long long)j * W1 + w) * B + b];
    gm_n = gate_M[(long long)iw * B + b];
    if (t < S) {
      bt_n = Bt[TIDX(r, w, t, b)];
      el_n = eL[((long long)iw * S + t) * B + b];
    }
  };
  fetch(0);
  T x = ninf<T>();
  for (int w = 0; w < W1; ++w) {
    const T bt = bt_n, el = el_n, gm = gm_n;
    const bool ok = ok_n;
    if (w + 1 < W1) fetch(w + 1);
    if (t < S) y[t] = x + el + gm;
    __syncthreads();
    T cur = ninf<T>();
    if (t < S && ok) {
      const int iw = j - w < 0 ? 0 : (j - w > Lp - 1 ? Lp - 1 : j - w);
      const int pinL = kPin ? pin_req(ax, b, iw, kAuxL) : 0;
      typename SR::Acc acc;
      for (int k = k0; k < k1; ++k) {
        if (vetoed(ax, pinL, kAuxL, t, ix.lt_s[k], S)) continue;
        acc.add(y[ix.lt_s[k]] + ltw[k]);
      }
      cur = SR::plus(bt, acc.result());
    }
    __syncthreads();
    if (t < S) {
      x = cur;
      M[TIDX(r, w, t, b)] = cur;
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
  dim3 block(32, 8);
  dim3 grid((D.B + 31) / 32, D.S, D.Wp + 1);
  band_bif_kernel<T, SR><<<grid, block, 0, st>>>(D, ix, Bt, T1, T2, okB);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, class SR>
static int mchain(DPDims D, BandIdx ix, Aux ax, T* M, const T* Bt, const T* eL,
                  const T* gate_M, const bool* okM, cudaStream_t st) {
  int threads = ((D.S + 31) / 32) * 32;
  auto kern = has_pin(ax) ? band_m_kernel<T, SR, true>
                          : band_m_kernel<T, SR, false>;
  kern<<<D.B, threads, D.S * sizeof(T), st>>>(D, ix, ax, M, Bt, eL, gate_M,
                                              okM);
  return static_cast<int>(cudaGetLastError());
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
  RNAELEM_EXPORT int rnaelem_band_m_##SUF(DPDims D, BandIdx ix, Aux ax,      \
                                          T* M, const T* Bt, const T* eL,    \
                                          const T* gate_M, const bool* okM,  \
                                          cudaStream_t st) {                 \
    return mchain<T, SR>(D, ix, ax, M, Bt, eL, gate_M, okM, st);             \
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
