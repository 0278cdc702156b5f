// K5: the adjoint of K2 for one column j: E (TT_E_H / TT_E_M / TT_E_P),
// the sequential multiloop M chain, B (TT_B_12) with T1, and the L chain,
// P (TT_P_E / TT_P_P) and T2 (TT_2_2 / TT_2_P) of the front stage, in the
// reverse of K2's order.  E runs before K6 (it hands K6 the internal-loop
// term's cotangent); M with T1, B and the front run after it: five
// launches per column (e_adj, m_adj, bif_adj, front_adj_t, front_adj_sw),
// six with the class probe (cls_red).
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
// B sum's adjoint gives one thread per T1 cell (j-dk, w-dk, a) and chunk
// of dk, and one block per T2 cell row (j, dk, c) whose warps split w and
// merge in a fixed order, in one launch.  The M chain (csrc/mchain.cuh)
// runs backwards over w, one block per group of reads, its inputs staged
// by cp.async a few steps ahead; it also takes T1 = T2 + B's share of B
// (front_adj_t takes T1's share of T2), and each thread owns eL's
// cotangent of its state at every row (the rows that clip(j - w) sends to
// row 0 add up in a register).  It needs only e_adj's gM, so the outside
// pass runs it on a side stream beside K6 (ops/dp.py).  Sums across
// threads (eR row j-1 over w, bg2, pv, alphaP, lambda) are per-cell
// partials reduced in a fixed order inside the column's last launch (the
// eR rows by blocks of their own, bg2's shared rows by the last block of
// its range to finish): no float atomics.  Under the scanner's pin
// (common.cuh Aux) every term skips the vetoed transitions, as K2 did,
// and the posterior of each transition the kernels form (a share) also
// goes to the class partials of the base it emits: the M chain's (L kind,
// base j-w) in m_adj, the L/T2 chains' (R, base j-1) and P's (PL at j-w,
// PR at j-1) in front_adj_sw, each in the slot of the thread that owns
// it; cls_red, the column's last function, sums them per (class, base,
// read) in a fixed order.
#include "mchain.cuh"
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

__device__ __forceinline__ bool cell_at(const DPDims& D, long long idx,
                                        Cell& c) {
  const long long n = (long long)(D.Wp + 1) * D.S * D.B;
  if (idx >= n) return false;
  c.b = idx % D.B;
  c.s = (idx / D.B) % D.S;
  c.w = idx / ((long long)D.B * D.S);
  return true;
}

__device__ __forceinline__ bool cell_of(const DPDims& D, Cell& c) {
  return cell_at(D, (long long)blockIdx.x * blockDim.x + threadIdx.x, c);
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


// ---- M chain backwards over w: one block per group of G reads, cell
// (s, g) the cell of state s of read g, NC cells a thread
// (csrc/mchain.cuh).  Step w takes each cell's ring stage (copied R - 1
// steps ahead), forms the cotangent gc of M(w)[s] (gM plus the carry from
// step w+1), writes gB (the M chain's share plus T1 = T2 + B's;
// front_adj_t adds T1's share of T2), publishes gc and M(w)[s], and after
// the step's barrier gathers, as a source, the cotangent of M(w-1)[s]
// over its targets.  The thread owns eL's cotangent of its cells' states
// at every row: the rows that clip(j - w) sends to one row add up in a
// register, and each row is written once.  With the class probe it writes
// the L-class partials of slot (w, s): it is the column's first writer of
// cpL (cls_red zeroes what it sums).  kDev: the layout in the block's
// slice of ws.
template <typename T, bool kPin, int G, int R, int NC, bool kDev>
__global__ void __launch_bounds__(1024)
m_adj_kernel(DPDims D, AdjIdx ix, Aux ax, const T* M, const T* Bt,
             const T* eL, const T* gate_M, const bool* okM, const T* gM,
             const T* T1, const T* gT1, T* gB, T* geL, unsigned char* ws) {
  static_assert((R & (R - 1)) == 0, "the ring's stages: a power of 2");
  constexpr int NR = 9;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = D.S, B = D.B, W1 = D.Wp + 1, Lp = D.Lp, j = D.j;
  const MLayout lay(S, G, R, 2, NR, sizeof(T));
  unsigned char* base = mchain_base<kDev>(smem_raw, ws, lay.total);
  const int n = (int)lay.n;
  T* buf = reinterpret_cast<T*>(base + lay.buf);      // [2][2][n]
  T* ring = reinterpret_cast<T*>(base + lay.ring);    // [R][NR][n]
  int* rok = reinterpret_cast<int*>(base + lay.ok);   // [R][n]
  const int g = threadIdx.x % G;
  const int b = blockIdx.x * G + g;
  const long long SB = (long long)S * B;
  const bool* oks = okM + (long long)j * W1 * B + b;
  const T* ltrw = static_cast<const T*>(ix.ltr_w);
  // this thread's cells c (source state c / G): their rows at w = 0,
  // (w, s, b) of the column's tables and of the column cotangents gM, gB
  // (col0; the eL rows and its cotangent's are col0 + row * SB), and
  // their left-transition targets, the first kMSrc (and their class
  // codes) in registers
  int cid[NC], k0[NC], k1[NC], tgt[NC][kMSrc], code[NC][kMSrc];
  bool live[NC];
  long long cell0[NC], col0[NC];
  T wt[NC][kMSrc], carry[NC], acc_eL[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    cid[k] = threadIdx.x + k * blockDim.x;
    const int s = cid[k] / G;
    live[k] = s < S && b < B;
    cell0[k] = TIDX(j + D.PAD, 0, s, b);
    col0[k] = (long long)s * B + b;
    k0[k] = live[k] ? ix.ltr_off[s] : 0;
    k1[k] = live[k] ? ix.ltr_off[s + 1] : 0;
#pragma unroll
    for (int q = 0; q < kMSrc; ++q) {
      const int tq = k0[k] + q < k1[k] ? ix.ltr_t[k0[k] + q] : 0;
      tgt[k][q] = tq * G + g;
      wt[k][q] = k0[k] + q < k1[k] ? ltrw[k0[k] + q] : (T)0;
      code[k][q] = k0[k] + q < k1[k] ? ax.code[(kAuxL * S + tq) * S + s] : 0;
    }
    carry[k] = (T)0;
    acc_eL[k] = (T)0;
  }
  // stage i holds step w = W1-1-i: 0 M(w), 1 gM, 2 Bt, 3 M(w-1), 4 eL,
  // 5 gate_M, 6 the eL cotangent (rows clip(j - w)), 7 T1, 8 gT1
  auto issue = [&](int i) {
    if (i < W1) {
      const int w = W1 - 1 - i, iw = clip_row(j - w, Lp);
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        if (!live[k]) continue;
        T* st = ring + (i & (R - 1)) * NR * n + cid[k];
        const long long cell = cell0[k] + w * SB, colw = col0[k] + w * SB;
        const long long row = col0[k] + iw * SB;
        mchain_copy<kDev>(st, M + cell);
        mchain_copy<kDev>(st + n, gM + colw);
        mchain_copy<kDev>(st + 2 * n, Bt + cell);
        if (w >= 1) mchain_copy<kDev>(st + 3 * n, M + cell - SB);
        mchain_copy<kDev>(st + 4 * n, eL + row);
        mchain_copy<kDev>(st + 5 * n, gate_M + (long long)iw * B + b);
        mchain_copy<kDev>(st + 6 * n, geL + row);
        mchain_copy<kDev>(st + 7 * n, T1 + cell);
        mchain_copy<kDev>(st + 8 * n, gT1 + cell);
        mchain_copy_word<kDev>(rok + (i & (R - 1)) * n + cid[k],
                               ok_word(oks + (long long)w * B));
      }
    }
    mchain_commit<kDev>();
  };
  for (int i = 0; i < R - 1; ++i) issue(i);
  PinRegs pr;
  if (kPin && b < B) pr = pin_regs(ax, b, kAuxL);
  T* cpL = static_cast<T*>(ax.cpL);
  int row_eL = -1;
  for (int i = 0; i < W1; ++i) {
    const int w = W1 - 1 - i, iw = clip_row(j - w, Lp);
    issue(i + R - 1);
    mchain_wait<kDev, R - 1>();
    T* coef = buf + (i & 1) * 2 * n;  // [n] cotangents of M(w)
    T* curv = coef + n;               // [n] values of M(w)
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const T* st = ring + (i & (R - 1)) * NR * n + cid[k];
      if (live[k]) {
        const T cur = st[0];
        const bool ok = ok_byte(rok[(i & (R - 1)) * n + cid[k]],
                                oks + (long long)w * B);
        const T gc = st[n] + carry[k];
        const bool lv = ok && cur > ninf<T>() && gc != (T)0;
        coef[cid[k]] = lv ? gc : (T)0;
        curv[cid[k]] = cur;
        gB[col0[k] + w * SB] = (lv ? share_sel(gc, st[2 * n], cur) : (T)0) +
                               share_sel(st[8 * n], st[2 * n], st[7 * n]);
      } else if (cid[k] < n) {
        coef[cid[k]] = (T)0;
        curv[cid[k]] = ninf<T>();
      }
    }
    mchain_sync();
    const int pinL = kPin && b < B && w >= 1 ? pin_req_reg(ax, pr, iw) : 0;
    const bool new_row = iw != row_eL;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (!live[k]) continue;
      const int s = cid[k] / G;
      const T* st = ring + (i & (R - 1)) * NR * n + cid[k];
      T gy = (T)0, cls[4] = {0, 0, 0, 0};
      if (w >= 1) {
        const T y = st[3 * n] + st[4 * n] + st[5 * n];
        if (y > ninf<T>()) {
#pragma unroll
          for (int q = 0; q < kMSrc; ++q) {
            if (k0[k] + q >= k1[k]) break;
            if (kPin && pinL != 0 && (code[k][q] & pinL) != pinL) continue;
            const T x = share_sel(coef[tgt[k][q]], y + wt[k][q],
                                  curv[tgt[k][q]]);
            gy += x;
            if (cpL)
              for (int c = 0; c < 4; ++c)
                if (code[k][q] & (1 << c)) cls[c] += x;
          }
          for (int kk = k0[k] + kMSrc; kk < k1[k]; ++kk) {
            const int tt = ix.ltr_t[kk];
            if (kPin && vetoed(ax, pinL, kAuxL, tt, s, S)) continue;
            const T x =
                share(coef[tt * G + g], y + ltrw[kk], curv[tt * G + g]);
            gy += x;
            if (cpL) add_classes(ax, kAuxL, tt, s, S, x, cls);
          }
        }
      }
      carry[k] = gy;
      if (new_row) {
        if (row_eL >= 0) geL[col0[k] + row_eL * SB] = acc_eL[k];
        acc_eL[k] = st[6 * n];
      }
      acc_eL[k] += gy;
      if (cpL)
        for (int c = 0; c < 4; ++c) cpL[TIDX(c, w, s, b)] = cls[c];
    }
    if (new_row) row_eL = iw;
  }
  if (row_eL >= 0) {
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (live[k]) geL[col0[k] + row_eL * SB] = acc_eL[k];
  }
}

// ---- B's splits (TT_B_12), one launch of two block ranges.  T1 side:
// one thread per T1 cell (j-dk, v, a) and chunk of kBifChunk dk (w = v +
// dk), the block 32 reads x kBifWarps consecutive v of one state a and
// one chunk: the chunk's T1 values and cotangents as they stand load
// together, then each split tuple by a adds its terms for the whole chunk
// (their loads independent of each other).  T2 side: one block per T2
// row (j, dk, c) of 32 reads, its kBifWarps warps splitting w = dk..Wp
// (a warp's widths in chunks of kBifChunk, tuple by tuple) and merging
// their partials in warp order in shared memory.  Every sum keeps the
// order of the read's own tuples and widths.
static const int kBifWarps = 4;
static const int kBifChunk = 8;

template <typename T>
__device__ __forceinline__ void bif_adj_t1_block(
    const DPDims& D, const AdjIdx& ix, const T* __restrict__ T1,
    const T* __restrict__ T2, const T* __restrict__ Bt,
    const T* __restrict__ gB, T* __restrict__ gT1, int blk) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1;
  const int nbx = (B + 31) / 32, ndc = (D.Wp + kBifChunk - 1) / kBifChunk;
  const int b = (blk % nbx) * 32 + threadIdx.x;
  const int a = (blk / nbx) % S;
  const int d0 = ((blk / (nbx * S)) % ndc) * kBifChunk;  // dk = d0 + 1 ...
  const int v = (blk / (nbx * S * ndc)) * kBifWarps + threadIdx.y;
  const int ndk = W1 - 1 - v - d0;   // dk up to Wp - v
  if (b >= B || ndk <= 0) return;
  const int r = D.j + D.PAD, k0 = ix.b12a_off[a], k1 = ix.b12a_off[a + 1];
  if (k0 == k1) return;
  const long long SB = (long long)S * B, s1 = (long long)W1 * SB;
  // dk = d0 + 1: T1 cell (j-dk, v, a), gB and Bt at w = v + dk, T2 (j, dk)
  const T* p1 = T1 + TIDX(r - 1 - d0, v, a, b);
  T* q1 = gT1 + TIDX(r - 1 - d0, v, a, b);
  const long long gw = (long long)(v + 1 + d0) * SB + b;
  const long long bw = TIDX(r, v + 1 + d0, 0, b), t2 = TIDX(r, 1 + d0, 0, b);
  T x1[kBifChunk], acc[kBifChunk];
#pragma unroll
  for (int i = 0; i < kBifChunk; ++i) {
    x1[i] = i < ndk ? p1[-i * s1] : ninf<T>();
    acc[i] = (T)0;
  }
  for (int k = k0; k < k1; ++k) {
    const long long tB = (long long)ix.b12a_t[k] * B;
    const long long cT = (long long)ix.b12a_c[k] * B;
#pragma unroll
    for (int i = 0; i < kBifChunk; ++i)
      if (i < ndk && x1[i] > ninf<T>())
        acc[i] += share(gB[gw + i * SB + tB], x1[i] + T2[t2 + i * SB + cT],
                        Bt[bw + i * SB + tB]);
  }
#pragma unroll
  for (int i = 0; i < kBifChunk; ++i)
    if (i < ndk && x1[i] > ninf<T>()) q1[-i * s1] += acc[i];
}

template <typename T>
__device__ __forceinline__ void bif_adj_t2_block(
    const DPDims& D, const AdjIdx& ix, const T* __restrict__ T1,
    const T* __restrict__ T2, const T* __restrict__ Bt,
    const T* __restrict__ gB, T* __restrict__ gT2, int blk,
    T (*part)[32]) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1;
  const int nbx = (B + 31) / 32;
  const int b = (blk % nbx) * 32 + threadIdx.x;
  const int c = (blk / nbx) % S, dk = blk / (nbx * S) + 1;
  const int r = D.j + D.PAD;
  T x2 = ninf<T>(), acc = (T)0;
  if (b < B) {
    x2 = T2[TIDX(r, dk, c, b)];
    if (x2 > ninf<T>()) {
      const long long SB = (long long)S * B, s8 = kBifWarps * SB;
      // this warp's widths w = dk + y + kBifWarps m: gB and Bt at (w, 0),
      // T1 at (j - dk, w - dk, 0)
      const int w0 = dk + threadIdx.y;
      const long long gw = (long long)w0 * SB + b, bw = TIDX(r, w0, 0, b);
      const long long tw = TIDX(r - dk, w0 - dk, 0, b);
      const int nw = w0 < W1 ? (W1 - w0 + kBifWarps - 1) / kBifWarps : 0;
      for (int m0 = 0; m0 < nw; m0 += kBifChunk)
        for (int k = ix.b12c_off[c]; k < ix.b12c_off[c + 1]; ++k) {
          const long long tB = (long long)ix.b12c_t[k] * B;
          const long long aT = (long long)ix.b12c_a[k] * B;
#pragma unroll
          for (int i = 0; i < kBifChunk; ++i)
            if (m0 + i < nw)
              acc += share(gB[gw + (m0 + i) * s8 + tB],
                           T1[tw + (m0 + i) * s8 + aT] + x2,
                           Bt[bw + (m0 + i) * s8 + tB]);
        }
    }
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y != 0 || b >= B || !(x2 > ninf<T>())) return;
  T tot = (T)0;
  for (int y = 0; y < kBifWarps; ++y) tot += part[y][threadIdx.x];
  gT2[TIDX(r, dk, c, b)] += tot;
}

// the T1 side's blocks (the heaviest, v = 0, first), then the T2 side's
__host__ __device__ __forceinline__ int bif_t1_blocks(const DPDims& D) {
  return ((D.B + 31) / 32) * D.S * ((D.Wp + kBifChunk - 1) / kBifChunk) *
         ((D.Wp + kBifWarps) / kBifWarps);
}

template <typename T>
__global__ void __launch_bounds__(32 * kBifWarps)
bif_adj_kernel(DPDims D, AdjIdx ix, const T* __restrict__ T1,
               const T* __restrict__ T2, const T* __restrict__ Bt,
               const T* __restrict__ gB, T* __restrict__ gT1,
               T* __restrict__ gT2) {
  __shared__ T part[kBifWarps][32];
  const int n1 = bif_t1_blocks(D);
  if ((int)blockIdx.x < n1)
    bif_adj_t1_block(D, ix, T1, T2, Bt, gB, gT1, blockIdx.x);
  else
    bif_adj_t2_block(D, ix, T1, T2, Bt, gB, gT2, blockIdx.x - n1, part);
}

// ---- front, target side (w, t, b): T1's share of T2's cotangent (T1 =
// T2 + B), T2's P term into P's cotangent, the lambda terms of ml2 and
// stk, and eR's per-(w, t) partial
template <typename T>
__global__ void front_adj_t_kernel(DPDims D, AdjIdx ix, Aux ax, const T* LL,
                                   const T* P, const T* T2, const T* eR,
                                   const T* bg2, const T* pv,
                                   const T* alphaP, const T* wsp,
                                   const T* lam, const T* stk, const T* ml2,
                                   const T* gate_O2, const T* T1,
                                   const T* gT1, const T* gLL, T* gP,
                                   T* gT2, T* DL, T* ePart) {
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
  // T1 = T2 + B: T1's share completes T2's cotangent
  T g2 = gT2[TIDX(r, w, t, b)];
  const T T2v = T2[TIDX(r, w, t, b)], g1 = gT1[TIDX(r, w, t, b)],
          t1 = T1[TIDX(r, w, t, b)];
  if (g1 != (T)0 && t1 > ninf<T>()) {
    g2 += share(g1, T2v, t1);
    gT2[TIDX(r, w, t, b)] = g2;
  }
  // T2 = logadd(chain, P + ml2)
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
__device__ __forceinline__ void front_adj_s_cell(
    const DPDims& D, const AdjIdx& ix, const Aux& ax, const T* LL,
    const T* P, const T* T2, const T* E, const T* eR, const T* bg2,
    const T* pv, const T* alphaP, const T* wsp, const T* lam, const T* stk,
    const T* gate_O2, T* gLL, const T* gP_r, T* gP, T* gT2, T* gE,
    long long idx) {
  Cell q;
  if (!cell_at(D, idx, q)) return;
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
// background's cotangent v of pair cell (w, b), added to bg2 row clip(j -
// w) at once where no other width reaches that row, else kept in bgp[w]
// for the fixed-order sums of bg2_rows
template <typename T>
__device__ __forceinline__ void front_adj_wb_cell(
    const DPDims& D, const AdjIdx& ix, const Aux& ax, const T* __restrict__ P,
    const T* __restrict__ E, const T* __restrict__ bg2,
    const T* __restrict__ pv, const T* __restrict__ alphaP,
    const T* __restrict__ wsp, const T* __restrict__ lam,
    const T* __restrict__ stk, const T* __restrict__ gP,
    T* __restrict__ gpv, T* __restrict__ galphaP, T* __restrict__ bgp,
    T* __restrict__ gbg2, int idx) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, Lp = D.Lp, j = D.j;
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
  const int row = clip_row(j - w, Lp);
  if (row != j - 1 && row != 0) gbg2[(long long)row * B + b] += bga;
}


// bg2's rows that several widths reach, row j-1 (w = 1, w = 0 at j = Lp,
// and the row total) and row 0 (w >= j), in the order of the widths, from
// the bgp row the wb cells left (read through L2: other blocks wrote it)
template <typename T>
__device__ __forceinline__ void bg2_rows(const DPDims& D, const T* bgp,
                                         T* gbg2) {
  constexpr int CH = 16;  // widths whose loads go out together
  const int B = D.B, W1 = D.Wp + 1, Lp = D.Lp, j = D.j;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    T tot = (T)0, a = gbg2[(long long)(j - 1) * B + b];
    T z = j - 1 != 0 ? gbg2[b] : (T)0;
    for (int w0 = 0; w0 < W1; w0 += CH) {
      T v[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i)
        v[i] = w0 + i < W1 ? __ldcg(bgp + (long long)(w0 + i) * B + b) : (T)0;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        if (w0 + i >= W1) continue;
        tot += v[i];
        const int row = clip_row(j - w0 - i, Lp);
        if (row == j - 1)
          a += v[i];
        else if (row == 0)
          z += v[i];
      }
    }
    gbg2[(long long)(j - 1) * B + b] = a + tot;
    if (j - 1 != 0) gbg2[b] = z;
  }
}

// ---- the front's source side and the column's reductions, one launch of
// three block ranges: front_adj_wb cells (w, b), first, the last of their
// blocks to finish (an integer counter, reset for the next launch) taking
// bg2_rows; front_adj_s cells (w, s, b); and eR row j-1 summed over w in
// order, one thread per (t, b) (ePart is front_adj_t's)
template <typename T>
__global__ void __launch_bounds__(kAdjThreads)
front_adj_sw_kernel(DPDims D, AdjIdx ix, Aux ax, const T* LL, const T* P,
                    const T* T2, const T* E, const T* eR, const T* bg2,
                    const T* pv, const T* alphaP, const T* wsp, const T* lam,
                    const T* stk, const T* gate_O2, T* gLL, T* gP, T* gT2,
                    T* gE, T* gpv, T* galphaP, T* bgp, const T* ePart,
                    T* geR, T* gbg2, int* done, int n_s, int n_wb) {
  const int blk = blockIdx.x;
  if (blk < n_wb) {
    __shared__ bool last;
    front_adj_wb_cell(D, ix, ax, P, E, bg2, pv, alphaP, wsp, lam, stk, gP,
                      gpv, galphaP, bgp, gbg2, blk * blockDim.x + threadIdx.x);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(done, 1) == n_wb - 1;
    __syncthreads();
    if (!last) return;
    bg2_rows(D, bgp, gbg2);
    if (threadIdx.x == 0) *done = 0;
    return;
  }
  if (blk < n_wb + n_s) {
    front_adj_s_cell(D, ix, ax, LL, P, T2, E, eR, bg2, pv, alphaP, wsp, lam,
                     stk, gate_O2, gLL, gP, gP, gT2, gE,
                     (long long)(blk - n_wb) * blockDim.x + threadIdx.x);
    return;
  }
  const int S = D.S, B = D.B, W1 = D.Wp + 1, j = D.j;
  const int idx = (blk - n_s - n_wb) * blockDim.x + threadIdx.x;
  if (idx >= S * B) return;
  const int b = idx % B, t = idx / B;
  T acc = (T)0;
  for (int w = 0; w < W1; ++w) acc += ePart[((long long)w * S + t) * B + b];
  geR[((long long)(j - 1) * S + t) * B + b] += acc;
}

// ---- the class sums of column j (scanner, common.cuh Aux): one block per
// (32 reads, class), warp y taking widths w = y, y+kClsWarps, ...; each
// thread sums the partials of its widths over the states, adds the
// base-(j-w) sums (w >= 2) to cls[class, j-w] and keeps those of base j-1
// (all of cpR, and cpL at w = 1); warp 0 merges the warps' in a fixed
// order.  The partials it read are zeroed for the next column, after the
// sums (so the loads of a width go out together).  Widths w > j lie
// outside the read: every partial there is 0.
static const int kClsWarps = 16;

template <typename T>
__global__ void __launch_bounds__(32 * kClsWarps)
cls_red_kernel(DPDims D, Aux ax, T* cls) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1, j = D.j;
  const int b = blockIdx.x * 32 + threadIdx.x, c = blockIdx.y;
  __shared__ T part[kClsWarps][32];
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
      }
      for (int s = 0; s < S; ++s) {
        const long long q = TIDX(c, w, s, b);
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

// K5's M chain in blocks of G reads with a ring of R stages, NC cells a
// thread, in shared memory or (ws not null) in ws (the plan's)
template <typename T>
static int m_adj(DPDims D, AdjIdx ix, Aux ax, const T* M, const T* Bt,
                 const T* eL, const T* gate_M, const bool* okM, const T* gM,
                 const T* T1, const T* gT1, T* gB, T* geL, unsigned char* ws,
                 int G_, int R_, int NC_, cudaStream_t st) {
  if (!mchain_fits(D.S, G_, NC_))
    return static_cast<int>(cudaErrorInvalidValue);
  return mchain_dispatch(G_, R_, NC_, ws != nullptr, [&](auto g, auto r,
                                                         auto nc, auto dv) {
    constexpr int G = decltype(g)::value, R = decltype(r)::value;
    constexpr int NC = decltype(nc)::value;
    constexpr bool kDev = decltype(dv)::value;
    const long long bytes =
        kDev ? 0 : mchain_layout(1, D.S, G, R, sizeof(T)).total;
    auto kern = has_pin(ax) ? m_adj_kernel<T, true, G, R, NC, kDev>
                            : m_adj_kernel<T, false, G, R, NC, kDev>;
    const int rc = allow_smem((const void*)kern, bytes);
    if (rc) return rc;
    kern<<<(D.B + G - 1) / G, mchain_threads(D.S, G, NC), bytes, st>>>(
        D, ix, ax, M, Bt, eL, gate_M, okM, gM, T1, gT1, gB, geL, ws);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
static int front_adj_sw(DPDims D, AdjIdx ix, Aux ax, const T* LL,
                        const T* P, const T* T2, const T* E, const T* eR,
                        const T* bg2, const T* pv, const T* alphaP,
                        const T* wsp, const T* lam, const T* stk,
                        const T* gate_O2, T* gLL, T* gP, T* gT2, T* gE,
                        T* gpv, T* galphaP, T* bgp, const T* ePart, T* geR,
                        T* gbg2, int* done, cudaStream_t st) {
  if (too_big(D)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_s = n_blocks((long long)(D.Wp + 1) * D.S * D.B, kAdjThreads);
  const int n_wb = n_blocks((long long)(D.Wp + 1) * D.B, kAdjThreads);
  const int n_r = n_blocks((long long)D.S * D.B, kAdjThreads);
  front_adj_sw_kernel<T><<<n_s + n_wb + n_r, kAdjThreads, 0, st>>>(
      D, ix, ax, LL, P, T2, E, eR, bg2, pv, alphaP, wsp, lam, stk, gate_O2,
      gLL, gP, gT2, gE, gpv, galphaP, bgp, ePart, geR, gbg2, done, n_s,
      n_wb);
  return static_cast<int>(cudaGetLastError());
}

#define BAND_ADJ_EXPORTS(SUF, T)                                             \
  RNAELEM_EXPORT int rnaelem_e_adj_##SUF(                                    \
      DPDims D, AdjIdx ix, const T* E, const T* LL, const T* M, const T* EP, \
      const T* lam, const T* hp, const T* mlE, const T* gE, T* gLL, T* gM,   \
      T* gEP, T* DL, cudaStream_t st) {                                      \
    CELL_LAUNCH(T, e_adj_kernel, D, ix, E, LL, M, EP, lam, hp, mlE, gE, gLL, \
                gM, gEP, DL);                                                \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_m_adj_##SUF(                                    \
      DPDims D, AdjIdx ix, Aux ax, const T* M, const T* Bt, const T* eL,     \
      const T* gate_M, const bool* okM, const T* gM, const T* T1,            \
      const T* gT1, T* gB, T* geL, unsigned char* ws, int G, int R, int NC,  \
      cudaStream_t st) {                                                     \
    return m_adj<T>(D, ix, ax, M, Bt, eL, gate_M, okM, gM, T1, gT1, gB, geL, \
                    ws, G, R, NC, st);                                       \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_bif_adj_##SUF(                                  \
      DPDims D, AdjIdx ix, const T* T1, const T* T2, const T* Bt,            \
      const T* gB, T* gT1, T* gT2, cudaStream_t st) {                        \
    const long long n = (long long)bif_t1_blocks(D) +                        \
                        (long long)((D.B + 31) / 32) * D.S * D.Wp;           \
    if (n >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);   \
    bif_adj_kernel<T><<<(int)n, dim3(32, kBifWarps), 0, st>>>(               \
        D, ix, T1, T2, Bt, gB, gT1, gT2);                                    \
    return static_cast<int>(cudaGetLastError());                             \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_front_adj_t_##SUF(                              \
      DPDims D, AdjIdx ix, Aux ax, const T* LL, const T* P, const T* T2,     \
      const T* eR, const T* bg2, const T* pv, const T* alphaP,               \
      const T* wsp, const T* lam, const T* stk, const T* ml2,                \
      const T* gate_O2, const T* T1, const T* gT1, const T* gLL, T* gP,      \
      T* gT2, T* DL, T* ePart, cudaStream_t st) {                            \
    CELL_LAUNCH(T, front_adj_t_kernel, D, ix, ax, LL, P, T2, eR, bg2, pv,    \
                alphaP, wsp, lam, stk, ml2, gate_O2, T1, gT1, gLL, gP, gT2,  \
                DL, ePart);                                                  \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_front_adj_sw_##SUF(                             \
      DPDims D, AdjIdx ix, Aux ax, const T* LL, const T* P, const T* T2,     \
      const T* E, const T* eR, const T* bg2, const T* pv, const T* alphaP,   \
      const T* wsp, const T* lam, const T* stk, const T* gate_O2, T* gLL,    \
      T* gP, T* gT2, T* gE, T* gpv, T* galphaP, T* bgp, const T* ePart,      \
      T* geR, T* gbg2, int* done, cudaStream_t st) {                         \
    return front_adj_sw<T>(D, ix, ax, LL, P, T2, E, eR, bg2, pv, alphaP,     \
                           wsp, lam, stk, gate_O2, gLL, gP, gT2, gE, gpv,    \
                           galphaP, bgp, ePart, geR, gbg2, done, st);        \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_cls_red_##SUF(DPDims D, Aux ax, T* cls,         \
                                           cudaStream_t st) {                \
    if (!ax.cpR || !ax.cpL) return static_cast<int>(cudaErrorInvalidValue);  \
    cls_red_kernel<T><<<dim3((D.B + 31) / 32, 4), dim3(32, kClsWarps), 0,    \
                        st>>>(D, ax, cls);                                   \
    return static_cast<int>(cudaGetLastError());                             \
  }

BAND_ADJ_EXPORTS(f32, float)
BAND_ADJ_EXPORTS(f64, double)

// the M-chain blocks' dynamic shared memory in bytes (csrc/mchain.cuh
// MLayout; ops/kernels.py band_smem_bytes mirrors it): which 0 = K2's
// band_m (K10's too), 1 = K5's m_adj, in blocks of G reads with a ring of
// R stages
RNAELEM_EXPORT long long rnaelem_band_smem_bytes(int which, int S, int G,
                                                 int R, int itemsize) {
  return mchain_layout(which, S, G, R, itemsize).total;
}
