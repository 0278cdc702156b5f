// K5: the adjoint of K2 for one column j: E (TT_E_H / TT_E_M / TT_E_P),
// the sequential multiloop M chain, B (TT_B_12) with T1, and the L chain,
// P (TT_P_E / TT_P_P) and T2 (TT_2_2 / TT_2_P) of the front stage, in the
// reverse of K2's order.  E runs before K6 (it hands K6 the internal-loop
// term's cotangent); M, B/T1 and the front run after it.
//
// Replaces (rnaelem_tpu, XLA-compiled jnp program): the column-body part
// of ops/dp.py dp_bwd, the custom VJP of dp_parts (row H of the kernel
// table, ops/dp.py:788-946, reverse of ops/dp.py:352-475 and 656-712).
//
// Bound on the H100: bytes.  Per column it reads what K2 reads (the T1
// triangle the splits reach, rows j-1 of LL, E, P, T2, the column's rows)
// plus the cotangents of the same cells, and writes those cotangents:
// about twice K2's traffic (chip_smoke.py counts it for its batch).  The
// arithmetic is K2's again, one exp per term.  Design: gather form
// throughout.  One thread per (w, state, read), read fastest, owns the
// cotangent cells it adds to: for the chains and pair cells the source
// cells (row j-1) gather over their targets through reverse CSR lists; the
// B sum's adjoint gives one thread per T1 cell (j-dk, w-dk, a) and one per
// T2 cell (j, dk, c).  The M chain runs backwards over w, one block per
// read and one thread per state, the targets' cotangents in shared memory;
// thread s owns eL's cotangent at every row for state s, so the rows that
// clip(j - w) sends to row 0 add up in one thread.  Sums across threads
// (eR row j-1 over w, bg2, pv, alphaP, lambda) are per-cell partials that
// the last kernel of the column reduces in a fixed order: no atomics.
// Under the scanner's pin (common.cuh Aux) every term skips the vetoed
// transitions, as K2 did, and the posterior of each transition the
// kernels form (a share) also goes to the class partials of the base it
// emits: the M chain's (L kind, base j-w) in m_adj, the L/T2 chains' (R,
// base j-1) and P's (PL at j-w, PR at j-1) in front_adj_s, each in the
// slot of the thread that owns it; cls_red, the column's last function,
// sums them per (class, base, read) in a fixed order.
#include "outside.cuh"

// pair emission of the pair transition t <- s at (j, w) (log space)
template <typename T>
__device__ __forceinline__ T pem_of(const DPDims& D, const AdjIdx& ix,
                                    int code, int t, int s, T bgsum, T wl,
                                    T wr, const T* pvw) {
  const T* ptl = static_cast<const T*>(ix.pt_lt);
  T pem;
  if (code == -2) {
    pem = bgsum;
  } else {
    pem = pvw[(long long)code * D.B];
    if (ix.pt_wl[t * D.S + s]) pem += wl;
    if (ix.pt_wr[t * D.S + s]) pem += wr;
  }
  return pem + ptl[t * D.S + s];
}

struct Cell {  // (w, state, read) of a one-thread-per-cell kernel
  int w, s, b;
};

__device__ __forceinline__ bool cell_of(const DPDims& D, Cell& c) {
  const long long n = (long long)(D.Wp + 1) * D.S * D.B;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return false;
  c.b = idx % D.B;
  c.s = (idx / D.B) % D.S;
  c.w = idx / ((long long)D.B * D.S);
  return true;
}

__device__ __forceinline__ int clip_row(int i, int Lp) {
  return i < 0 ? 0 : (i > Lp - 1 ? Lp - 1 : i);
}

// ---- E: cotangents of LL row j, the M column and the ep column
template <typename T>
__global__ void e_adj_kernel(DPDims D, AdjIdx ix, const T* E, const T* LL,
                             const T* M, const T* EP, const T* lam,
                             const T* hp, const T* mlE, const T* gE, T* gLL,
                             T* gM, T* gEP, T* DL) {
  Cell q;
  if (!cell_of(D, q)) return;
  const int S = D.S, B = D.B, W1 = D.Wp + 1, j = D.j, w = q.w, t = q.s,
            b = q.b;
  const int r = j + D.PAD;
  const long long cell = ((long long)j * W1 + w) * B + b;
  const long long col = ((long long)w * S + t) * B + b;
  const T g = gE[TIDX(r, w, t, b)], Ev = E[TIDX(r, w, t, b)];
  T gm = (T)0, ge = (T)0;
  if (g != (T)0 && Ev > ninf<T>()) {
    const T lam_t = lam[ix.bucket[t]];
    const T h = ix.loopm[t] ? LL[TIDX(r, w, t, b)] + lam_mul(lam_t, hp[cell])
                            : ninf<T>();
    const T gh = share(g, h, Ev);
    gm = share(g, M[TIDX(r, w, t, b)] + lam_mul(lam_t, mlE[cell]), Ev);
    ge = share(g, EP[TIDX(r, w, t, b)], Ev);
    gLL[TIDX(r, w, t, b)] += gh;
    DL[TIDX(j, w, t, b)] += gh * xfac(hp[cell]) + gm * xfac(mlE[cell]);
  }
  gM[col] = gm;
  gEP[col] = ge;
}

// ---- M chain backwards over w: one block per read, one thread per state.
// Thread t holds the chain's carried cotangent of M(w-1)[t]; per step it
// publishes its cell's cotangent and value, then gathers as a source.
template <typename T>
__global__ void m_adj_kernel(DPDims D, AdjIdx ix, Aux ax, const T* M,
                             const T* Bt,
                             const T* eL, const T* gate_M, const bool* okM,
                             const T* gM, T* gB, T* geL) {
  extern __shared__ unsigned char smem_raw[];
  T* coef = reinterpret_cast<T*>(smem_raw);  // [S]
  T* curv = coef + D.S;                       // [S]
  const int S = D.S, B = D.B, W1 = D.Wp + 1, Lp = D.Lp, j = D.j;
  const int b = blockIdx.x, t = threadIdx.x;
  const int r = j + D.PAD;
  const T* ltrw = static_cast<const T*>(ix.ltr_w);
  T carry = (T)0;
  for (int w = W1 - 1; w >= 0; --w) {
    const int iw = clip_row(j - w, Lp);
    if (t < S) {
      const T cur = M[TIDX(r, w, t, b)];
      const bool ok = okM[((long long)j * W1 + w) * B + b];
      const T gc = gM[((long long)w * S + t) * B + b] + carry;
      const bool live = ok && cur > ninf<T>() && gc != (T)0;
      gB[((long long)w * S + t) * B + b] =
          live ? share(gc, Bt[TIDX(r, w, t, b)], cur) : (T)0;
      coef[t] = live ? gc : (T)0;
      curv[t] = cur;
    }
    __syncthreads();
    if (t < S) {
      T gy = (T)0, cls[4] = {0, 0, 0, 0};
      if (w >= 1) {
        const T y = M[TIDX(r, w - 1, t, b)] + eL[((long long)iw * S + t) * B + b]
                    + gate_M[(long long)iw * B + b];
        const int pinL = pin_req(ax, b, iw, kAuxL);
        if (y > ninf<T>())
          for (int k = ix.ltr_off[t]; k < ix.ltr_off[t + 1]; ++k) {
            const int tt = ix.ltr_t[k];
            if (vetoed(ax, pinL, kAuxL, tt, t, S)) continue;
            const T x = share(coef[tt], y + ltrw[k], curv[tt]);
            gy += x;
            if (ax.cpL) add_classes(ax, kAuxL, tt, t, S, x, cls);
          }
      }
      carry = gy;
      geL[((long long)iw * S + t) * B + b] += gy;
      if (ax.cpL) {
        T* cp = static_cast<T*>(ax.cpL);
        for (int c = 0; c < 4; ++c) cp[TIDX(c, w, t, b)] += cls[c];
      }
    }
    __syncthreads();
  }
}

// ---- T1 = T2 + B (elementwise): cotangents of T2 and B of column j
template <typename T>
__global__ void t1_adj_kernel(DPDims D, const T* T1, const T* T2,
                              const T* Bt, const T* gT1, T* gT2, T* gB) {
  Cell q;
  if (!cell_of(D, q)) return;
  const int S = D.S, B = D.B, W1 = D.Wp + 1, w = q.w, t = q.s, b = q.b;
  const int r = D.j + D.PAD;
  const T g = gT1[TIDX(r, w, t, b)], v = T1[TIDX(r, w, t, b)];
  if (g == (T)0 || !(v > ninf<T>())) return;
  gT2[TIDX(r, w, t, b)] += share(g, T2[TIDX(r, w, t, b)], v);
  gB[((long long)w * S + t) * B + b] += share(g, Bt[TIDX(r, w, t, b)], v);
}

// ---- B's splits, T1 side: one thread per T1 cell (j-dk, v, a), v = w-dk,
// kZLanes (dk, v) cells per block
static const int kZLanes = 8;

template <typename T>
__global__ void bif_adj_t1_kernel(DPDims D, AdjIdx ix, const T* T1,
                                  const T* T2, const T* Bt, const T* gB,
                                  T* gT1) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1;
  const int b = blockIdx.x * 32 + threadIdx.x;
  const int a = blockIdx.y;
  const int z = blockIdx.z * kZLanes + threadIdx.y;
  const int dk = z / W1 + 1, v = z % W1;
  const int w = v + dk;
  if (b >= B || dk > D.Wp || w > D.Wp) return;
  const int r = D.j + D.PAD;
  const T x1 = T1[TIDX(r - dk, v, a, b)];
  if (!(x1 > ninf<T>())) return;
  T acc = (T)0;
  for (int k = ix.b12a_off[a]; k < ix.b12a_off[a + 1]; ++k) {
    const int t = ix.b12a_t[k];
    acc += share(gB[((long long)w * S + t) * B + b],
                 x1 + T2[TIDX(r, dk, ix.b12a_c[k], b)], Bt[TIDX(r, w, t, b)]);
  }
  gT1[TIDX(r - dk, v, a, b)] += acc;
}

// ---- B's splits, T2 side: one thread per T2 cell (j, dk, c), dk >= 1
template <typename T>
__global__ void bif_adj_t2_kernel(DPDims D, AdjIdx ix, const T* T1,
                                  const T* T2, const T* Bt, const T* gB,
                                  T* gT2) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1;
  const int b = blockIdx.x * 32 + threadIdx.x;
  const int c = blockIdx.y, dk = blockIdx.z + 1;
  if (b >= B) return;
  const int r = D.j + D.PAD;
  const T x2 = T2[TIDX(r, dk, c, b)];
  if (!(x2 > ninf<T>())) return;
  T acc = (T)0;
  for (int w = dk; w < W1; ++w)
    for (int k = ix.b12c_off[c]; k < ix.b12c_off[c + 1]; ++k) {
      const int t = ix.b12c_t[k];
      acc += share(gB[((long long)w * S + t) * B + b],
                   T1[TIDX(r - dk, w - dk, ix.b12c_a[k], b)] + x2,
                   Bt[TIDX(r, w, t, b)]);
    }
  gT2[TIDX(r, dk, c, b)] += acc;
}

// ---- front, target side (w, t, b): T2's P term into P's cotangent, the
// lambda terms of ml2 and stk, and eR's per-(w, t) partial
template <typename T>
__global__ void front_adj_t_kernel(DPDims D, AdjIdx ix, Aux ax, const T* LL,
                                   const T* P, const T* T2, const T* eR,
                                   const T* bg2, const T* pv,
                                   const T* alphaP, const T* wsp,
                                   const T* lam, const T* stk, const T* ml2,
                                   const T* gate_O2, const T* gLL, T* gP,
                                   const T* gT2, T* DL, T* ePart) {
  Cell q;
  if (!cell_of(D, q)) return;
  const int S = D.S, B = D.B, W1 = D.Wp + 1, Lp = D.Lp, j = D.j, w = q.w,
            t = q.s, b = q.b;
  const int r = j + D.PAD;
  const long long cell = ((long long)j * W1 + w) * B + b;
  const T* rtw = static_cast<const T*>(ix.rt_w);
  const T lam_t = lam[ix.bucket[t]];
  const T eRt = eR[((long long)(j - 1) * S + t) * B + b];
  const T gate = gate_O2[(long long)(j - 1) * B + b];
  const T Pv = P[TIDX(r, w, t, b)];
  const int pinR = pin_req(ax, b, j - 1, kAuxR);
  const int pinPR = pin_req(ax, b, j - 1, kAuxPR);
  T epart = (T)0;
  // T2 = logadd(chain, P + ml2)
  const T g2 = gT2[TIDX(r, w, t, b)], T2v = T2[TIDX(r, w, t, b)];
  T gPt = gP[TIDX(r, w, t, b)];
  if (g2 != (T)0 && T2v > ninf<T>()) {
    const T c = share(g2, Pv + lam_mul(lam_t, ml2[cell]), T2v);
    gPt += c;
    DL[TIDX(j, w, t, b)] += c * xfac(ml2[cell]);
    if (w >= 1) {
      LSE<T> acc;
      for (int k = ix.rt_off[t]; k < ix.rt_off[t + 1]; ++k) {
        if (vetoed(ax, pinR, kAuxR, t, ix.rt_s[k], S)) continue;
        acc.add(rtw[k] + T2[TIDX(r - 1, w - 1, ix.rt_s[k], b)]);
      }
      epart += share(g2, acc.result() + eRt + gate, T2v);
    }
    gP[TIDX(r, w, t, b)] = gPt;
  }
  // P's stacking term
  if (gPt != (T)0 && Pv > ninf<T>() && w >= 2) {
    const int iw = clip_row(j - w, Lp);
    const T bgsum = bg2[(long long)iw * B + b] + bg2[(long long)(j - 1) * B + b];
    const T wl = wsp[(long long)iw * B + b], wr = wsp[(long long)(j - 1) * B + b];
    const T* pvw = pv + ((long long)j * W1 + w) * D.Tp * B + b;
    const int pinPL = pin_req(ax, b, iw, kAuxPL);
    LSE<T> app;
    for (int s = 0; s < S; ++s) {
      const int code = ix.pt_code[t * S + s];
      if (code == -1 || vetoed(ax, pinPL, kAuxPL, t, s, S) ||
          vetoed(ax, pinPR, kAuxPR, t, s, S))
        continue;
      app.add(pem_of(D, ix, code, t, s, bgsum, wl, wr, pvw) +
              P[TIDX(r - 1, w - 2, s, b)]);
    }
    const T xs = app.result() + lam_mul(lam_t, stk[cell]) + alphaP[cell];
    DL[TIDX(j, w, t, b)] += share(gPt, xs, Pv) * xfac(stk[cell]);
  }
  // the L chain adds eR once per live cell
  const T Lv = LL[TIDX(r, w, t, b)];
  if (w >= 1 && Lv > ninf<T>()) epart += gLL[TIDX(r, w, t, b)];
  ePart[((long long)w * S + t) * B + b] = epart;
}

// the pair cells' sources E, P at (j-1, w-2, s) of front_adj_s (w >= 2)
template <typename T>
__device__ __forceinline__ void front_adj_s_pair(
    const DPDims& D, const AdjIdx& ix, const Aux& ax, const T* P, const T* E,
    const T* bg2, const T* pv, const T* alphaP, const T* wsp, const T* lam,
    const T* stk, const T* gP_r, T* gP, T* gE, int w, int s, int b,
    int pinPR, T clsR[4], T clsL[4]) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, Lp = D.Lp, j = D.j;
  const int r = j + D.PAD;
  const long long cell = ((long long)j * W1 + w) * B + b;
  const int iw = clip_row(j - w, Lp);
  const int pinPL = pin_req(ax, b, iw, kAuxPL);
  const T bgsum = bg2[(long long)iw * B + b] + bg2[(long long)(j - 1) * B + b];
  const T wl = wsp[(long long)iw * B + b], wr = wsp[(long long)(j - 1) * B + b];
  const T* pvw = pv + ((long long)j * W1 + w) * D.Tp * B + b;
  const T xe = E[TIDX(r - 1, w - 2, s, b)], xp = P[TIDX(r - 1, w - 2, s, b)];
  const T ap = alphaP[cell];
  T ge = (T)0, gp = (T)0;
  for (int t = 0; t < S; ++t) {
    const int code = ix.pt_code[t * S + s];
    if (code == -1 || vetoed(ax, pinPL, kAuxPL, t, s, S) ||
        vetoed(ax, pinPR, kAuxPR, t, s, S))
      continue;
    const T Pt = P[TIDX(r, w, t, b)], g = gP_r[TIDX(r, w, t, b)];
    if (g == (T)0 || !(Pt > ninf<T>())) continue;
    const T pem = pem_of(D, ix, code, t, s, bgsum, wl, wr, pvw);
    const T xe_ = share(g, pem + xe + ap, Pt);
    const T xp_ = share(g, pem + xp + lam_mul(lam[ix.bucket[t]], stk[cell]) +
                               ap, Pt);
    ge += xe_;
    gp += xp_;
    if (ax.cpR) {
      add_classes(ax, kAuxPL, t, s, S, xe_ + xp_, clsL);
      add_classes(ax, kAuxPR, t, s, S, xe_ + xp_, clsR);
    }
  }
  gE[TIDX(r - 1, w - 2, s, b)] += ge;
  gP[TIDX(r - 1, w - 2, s, b)] += gp;
}

// ---- front, source side (w, s, b): the L and T2 chains' sources at
// (j-1, w-1, s) and the pair cells' sources E, P at (j-1, w-2, s)
template <typename T>
__global__ void front_adj_s_kernel(DPDims D, AdjIdx ix, Aux ax, const T* LL,
                                   const T* P, const T* T2, const T* E,
                                   const T* eR, const T* bg2, const T* pv,
                                   const T* alphaP, const T* wsp,
                                   const T* lam, const T* stk,
                                   const T* gate_O2, T* gLL, const T* gP_r,
                                   T* gP, T* gT2, T* gE) {
  Cell q;
  if (!cell_of(D, q)) return;
  const int S = D.S, B = D.B, W1 = D.Wp + 1, j = D.j, w = q.w, s = q.s,
            b = q.b;
  const int r = j + D.PAD;
  if (w == 0) return;
  const T* rtrw = static_cast<const T*>(ix.rtr_w);
  const T gate = gate_O2[(long long)(j - 1) * B + b];
  const T xl = LL[TIDX(r - 1, w - 1, s, b)];
  const T x2 = T2[TIDX(r - 1, w - 1, s, b)];
  const int pinR = pin_req(ax, b, j - 1, kAuxR);
  const int pinPR = pin_req(ax, b, j - 1, kAuxPR);
  // class partials: R and PR at base j-1, PL at base j-w
  T clsR[4] = {0, 0, 0, 0}, clsL[4] = {0, 0, 0, 0};
  T al = (T)0, a2 = (T)0;
  for (int k = ix.rtr_off[s]; k < ix.rtr_off[s + 1]; ++k) {
    const int t = ix.rtr_t[k];
    if (vetoed(ax, pinR, kAuxR, t, s, S)) continue;
    const T e = rtrw[k] + eR[((long long)(j - 1) * S + t) * B + b];
    const T xL = share(gLL[TIDX(r, w, t, b)], xl + e, LL[TIDX(r, w, t, b)]);
    const T x2t = share(gT2[TIDX(r, w, t, b)], x2 + e + gate,
                        T2[TIDX(r, w, t, b)]);
    al += xL;
    a2 += x2t;
    if (ax.cpR) add_classes(ax, kAuxR, t, s, S, xL + x2t, clsR);
  }
  gLL[TIDX(r - 1, w - 1, s, b)] += al;
  gT2[TIDX(r - 1, w - 1, s, b)] += a2;
  if (w >= 2) front_adj_s_pair(D, ix, ax, P, E, bg2, pv, alphaP, wsp, lam,
                               stk, gP_r, gP, gE, w, s, b, pinPR, clsR, clsL);
  if (ax.cpR) {
    T* cpR = static_cast<T*>(ax.cpR);
    T* cpL = static_cast<T*>(ax.cpL);
    for (int c = 0; c < 4; ++c) {
      cpR[TIDX(c, w, s, b)] += clsR[c];
      cpL[TIDX(c, w, s, b)] += clsL[c];
    }
  }
}

// ---- front, per (w, b): alphaP, the pair-table emissions pv and the
// background partial bgp[w] (reduced into bg2 by front_adj_red)
template <typename T>
__global__ void front_adj_wb_kernel(DPDims D, AdjIdx ix, Aux ax, const T* P,
                                    const T* E, const T* bg2, const T* pv,
                                    const T* alphaP, const T* wsp,
                                    const T* lam, const T* stk, const T* gP,
                                    T* gpv, T* galphaP, T* bgp) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, Lp = D.Lp, j = D.j;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= W1 * B) return;
  const int b = idx % B, w = idx / B;
  const int r = j + D.PAD;
  const long long cell = ((long long)j * W1 + w) * B + b;
  T gap = (T)0, bga = (T)0;
  for (int t = 0; t < S; ++t)
    if (P[TIDX(r, w, t, b)] > ninf<T>()) gap += gP[TIDX(r, w, t, b)];
  if (w >= 2 && gap != (T)0) {
    const int iw = clip_row(j - w, Lp);
    const T bgsum = bg2[(long long)iw * B + b] + bg2[(long long)(j - 1) * B + b];
    const T wl = wsp[(long long)iw * B + b], wr = wsp[(long long)(j - 1) * B + b];
    const T* pvw = pv + ((long long)j * W1 + w) * D.Tp * B + b;
    T* gpvw = gpv + ((long long)j * W1 + w) * D.Tp * B + b;
    const T ap = alphaP[cell];
    const int pinPL = pin_req(ax, b, iw, kAuxPL);
    const int pinPR = pin_req(ax, b, j - 1, kAuxPR);
    for (int k = 0; k < D.n_pt; ++k) {
      const int t = ix.ptl_t[k], s = ix.ptl_s[k];
      if (vetoed(ax, pinPL, kAuxPL, t, s, S) ||
          vetoed(ax, pinPR, kAuxPR, t, s, S))
        continue;
      const int code = ix.pt_code[t * S + s];
      const T Pt = P[TIDX(r, w, t, b)], g = gP[TIDX(r, w, t, b)];
      if (g == (T)0 || !(Pt > ninf<T>())) continue;
      const T pem = pem_of(D, ix, code, t, s, bgsum, wl, wr, pvw);
      const T c = share(g, pem + E[TIDX(r - 1, w - 2, s, b)] + ap, Pt) +
                  share(g, pem + P[TIDX(r - 1, w - 2, s, b)] +
                               lam_mul(lam[ix.bucket[t]], stk[cell]) + ap,
                        Pt);
      if (code == -2)
        bga += c;
      else
        gpvw[(long long)code * B] += c;
    }
  }
  galphaP[cell] += gap;
  bgp[idx] = bga;
}

// ---- the column's reductions in a fixed order: eR row j-1 over w (one
// thread per (t, b)) and bg2 (thread t = 0 of each read: row j-1 and the
// rows clip(j - w) of the left bases)
template <typename T>
__global__ void front_adj_red_kernel(DPDims D, const T* ePart, const T* bgp,
                                     T* geR, T* gbg2) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, Lp = D.Lp, j = D.j;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= S * B) return;
  const int b = idx % B, t = idx / B;
  T acc = (T)0;
  for (int w = 0; w < W1; ++w) acc += ePart[((long long)w * S + t) * B + b];
  geR[((long long)(j - 1) * S + t) * B + b] += acc;
  if (t != 0) return;
  T tot = (T)0;
  for (int w = 0; w < W1; ++w) {
    const T v = bgp[(long long)w * B + b];
    tot += v;
    gbg2[(long long)clip_row(j - w, Lp) * B + b] += v;
  }
  gbg2[(long long)(j - 1) * B + b] += tot;
}

// ---- the class sums of column j (scanner, common.cuh Aux): one block per
// (32 reads, class), warp y taking widths w = y, y+8, ...; each thread
// sums the partials of its widths over the states, adds the base-(j-w)
// sums (w >= 2) to cls[class, j-w] and keeps those of base j-1 (all of
// cpR, and cpL at w = 1); warp 0 merges the eight in a fixed order.  The
// partials it read are zeroed for the next column.  Widths w > j lie
// outside the read: every partial there is 0.
template <typename T>
__global__ void cls_red_kernel(DPDims D, Aux ax, T* cls) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, j = D.j;
  const int b = blockIdx.x * 32 + threadIdx.x, c = blockIdx.y;
  __shared__ T part[8][32];
  T* cpR = static_cast<T*>(ax.cpR);
  T* cpL = static_cast<T*>(ax.cpL);
  T atj = (T)0;
  if (b < B) {
    for (int w = threadIdx.y; w < W1 && w <= j; w += blockDim.y) {
      T sr = (T)0, sl = (T)0;
      for (int s = 0; s < S; ++s) {
        const long long q = TIDX(c, w, s, b);
        sr += cpR[q];
        sl += cpL[q];
        cpR[q] = (T)0;
        cpL[q] = (T)0;
      }
      atj += sr;
      if (w == 1)
        atj += sl;
      else if (w >= 2)
        cls[((long long)c * D.Lp + (j - w)) * B + b] += sl;
    }
  }
  part[threadIdx.y][threadIdx.x] = atj;
  __syncthreads();
  if (threadIdx.y != 0 || b >= B) return;
  T tot = (T)0;
  for (int y = 0; y < blockDim.y; ++y) tot += part[y][threadIdx.x];
  cls[((long long)c * D.Lp + (j - 1)) * B + b] += tot;
}

static bool too_big(const DPDims& D) {
  return (long long)(D.Wp + 1) * D.S * D.B >= (1LL << 31);
}

// one thread per (w, state, read) of the column
#define CELL_LAUNCH(T, kern, ...)                                            \
  if (too_big(D)) return static_cast<int>(cudaErrorInvalidValue);            \
  const long long n = (long long)(D.Wp + 1) * D.S * D.B;                    \
  kern<T><<<n_blocks(n, kAdjThreads), kAdjThreads, 0, st>>>(__VA_ARGS__);   \
  return static_cast<int>(cudaGetLastError())

#define BAND_ADJ_EXPORTS(SUF, T)                                             \
  RNAELEM_EXPORT int rnaelem_e_adj_##SUF(                                    \
      DPDims D, AdjIdx ix, const T* E, const T* LL, const T* M, const T* EP, \
      const T* lam, const T* hp, const T* mlE, const T* gE, T* gLL, T* gM,   \
      T* gEP, T* DL, cudaStream_t st) {                                      \
    CELL_LAUNCH(T, e_adj_kernel, D, ix, E, LL, M, EP, lam, hp, mlE, gE, gLL,    \
                gM, gEP, DL);                                                \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_m_adj_##SUF(                                    \
      DPDims D, AdjIdx ix, Aux ax, const T* M, const T* Bt, const T* eL,     \
      const T* gate_M, const bool* okM, const T* gM, T* gB, T* geL,          \
      cudaStream_t st) {                                                     \
    const int threads = ((D.S + 31) / 32) * 32;                              \
    m_adj_kernel<T><<<D.B, threads, 2 * D.S * sizeof(T), st>>>(             \
        D, ix, ax, M, Bt, eL, gate_M, okM, gM, gB, geL);                     \
    return static_cast<int>(cudaGetLastError());                             \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_t1_adj_##SUF(DPDims D, const T* T1,             \
                                          const T* T2, const T* Bt,          \
                                          const T* gT1, T* gT2, T* gB,       \
                                          cudaStream_t st) {                 \
    CELL_LAUNCH(T, t1_adj_kernel, D, T1, T2, Bt, gT1, gT2, gB);                 \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_bif_adj_t1_##SUF(                               \
      DPDims D, AdjIdx ix, const T* T1, const T* T2, const T* Bt,            \
      const T* gB, T* gT1, cudaStream_t st) {                                \
    dim3 grid((D.B + 31) / 32, D.S,                                          \
              ceil_div((long long)D.Wp * (D.Wp + 1), kZLanes));              \
    bif_adj_t1_kernel<T><<<grid, dim3(32, kZLanes), 0, st>>>(                \
        D, ix, T1, T2, Bt, gB, gT1);                                         \
    return static_cast<int>(cudaGetLastError());                             \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_bif_adj_t2_##SUF(                               \
      DPDims D, AdjIdx ix, const T* T1, const T* T2, const T* Bt,            \
      const T* gB, T* gT2, cudaStream_t st) {                                \
    dim3 grid((D.B + 31) / 32, D.S, D.Wp);                                   \
    bif_adj_t2_kernel<T><<<grid, 32, 0, st>>>(D, ix, T1, T2, Bt, gB, gT2);   \
    return static_cast<int>(cudaGetLastError());                             \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_front_adj_t_##SUF(                              \
      DPDims D, AdjIdx ix, Aux ax, const T* LL, const T* P, const T* T2,     \
      const T* eR, const T* bg2, const T* pv, const T* alphaP,               \
      const T* wsp, const T* lam, const T* stk, const T* ml2,                \
      const T* gate_O2, const T* gLL, T* gP, const T* gT2, T* DL,            \
      T* ePart, cudaStream_t st) {                                           \
    CELL_LAUNCH(T, front_adj_t_kernel, D, ix, ax, LL, P, T2, eR, bg2, pv,       \
                alphaP,                                                      \
                wsp, lam, stk, ml2, gate_O2, gLL, gP, gT2, DL, ePart);       \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_front_adj_s_##SUF(                              \
      DPDims D, AdjIdx ix, Aux ax, const T* LL, const T* P, const T* T2,     \
      const T* E, const T* eR, const T* bg2, const T* pv, const T* alphaP,   \
      const T* wsp, const T* lam, const T* stk, const T* gate_O2, T* gLL,    \
      const T* gP_r, T* gP, T* gT2, T* gE, cudaStream_t st) {                \
    CELL_LAUNCH(T, front_adj_s_kernel, D, ix, ax, LL, P, T2, E, eR, bg2, pv,    \
                alphaP, wsp, lam, stk, gate_O2, gLL, gP_r, gP, gT2, gE);     \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_front_adj_wb_##SUF(                             \
      DPDims D, AdjIdx ix, Aux ax, const T* P, const T* E, const T* bg2,     \
      const T* pv, const T* alphaP, const T* wsp, const T* lam,              \
      const T* stk, const T* gP, T* gpv, T* galphaP, T* bgp,                 \
      cudaStream_t st) {                                                     \
    const long long n = (long long)(D.Wp + 1) * D.B;                        \
    front_adj_wb_kernel<T><<<n_blocks(n, kAdjThreads), kAdjThreads, 0,      \
                             st>>>(D, ix, ax, P, E, bg2, pv, alphaP, wsp,   \
                                   lam,                                      \
                                   stk, gP, gpv, galphaP, bgp);              \
    return static_cast<int>(cudaGetLastError());                             \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_front_adj_red_##SUF(                            \
      DPDims D, const T* ePart, const T* bgp, T* geR, T* gbg2,               \
      cudaStream_t st) {                                                     \
    const long long n = (long long)D.S * D.B;                               \
    front_adj_red_kernel<T><<<n_blocks(n, kAdjThreads), kAdjThreads, 0,     \
                              st>>>(D, ePart, bgp, geR, gbg2);               \
    return static_cast<int>(cudaGetLastError());                             \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_cls_red_##SUF(DPDims D, Aux ax, T* cls,         \
                                           cudaStream_t st) {                \
    if (!ax.cpR || !ax.cpL) return static_cast<int>(cudaErrorInvalidValue);  \
    cls_red_kernel<T><<<dim3((D.B + 31) / 32, 4), dim3(32, 8), 0, st>>>(     \
        D, ax, cls);                                                         \
    return static_cast<int>(cudaGetLastError());                             \
  }

BAND_ADJ_EXPORTS(f32, float)
BAND_ADJ_EXPORTS(f64, double)
