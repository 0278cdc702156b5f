// K13: the CYK/Viterbi traceback of the scanner's alignment on the card.
//
// Replaces (rnaelem_tpu): the Viterbi path of ops/dp_maxb.py marks (row L,
// :459), which reads the path off as max-semiring cotangents, by the exact
// table-based traceback of scan/cyk.py traceback (:367) and _candidates
// (:234), the reference's own (motif_scanner.hpp:262-362), so the CYK
// tables (K10-K12) never leave the card.
//
// One warp per read walks the read's tables from the end-state choice
// (sB iff O[L, sA] < O[L, sB]) with an explicit bounded stack of cells
// (i, j, table, state) in a scratch the wrapper allocates, which lane 0
// owns.  At each cell the warp re-derives the
// cell's candidates in _candidates' order (E_H, E_M, then the internal
// loops by (dl, dk, quadruple); P_E before P_P per source; the splits of
// B and O in loop order; O_O last), 32 at a time, and takes the FIRST
// candidate whose score is within eps * (1 + |stored|) of the cell's
// stored table value: the reference's "first strictly greater" rule, made
// robust to the last-bit rounding of a score recomputed in another
// association order than the DP's.  The internal-loop candidates are
// scored from the factor tensors K11 reads (misA/misB, the size classes'
// log energies SZ, spec_il), not from a second Turner lookup.  Vetoed
// transitions of the pin set (common.cuh Aux) score -inf.  The walk
// writes psihat [B, Lp] (node ids: state_r of the target for the
// right-emitting steps, state_l of the source for the left ones) and the
// pair cells [B, Lp+1, Wp+1] (1 where the path takes a P cell); err [B] is
// 1 when the walk exceeds 40 * (L + 2) steps or its stack, 2 when a cell
// has no candidate within eps (the host raises on either).  A read whose
// best score is -inf gets no path (psihat 0, no pairs).
//
// Bound on the H100: neither bytes nor operations but the walk's
// sequential dependence: a few hundred cells per read, each one to a few
// 32-wide candidate rounds (the internal-loop cells up to 31 x 31 x the
// target's quadruples).  It reads a few KB per read of the tables and
// writes Lp + (Lp+1)(Wp+1) bytes-ish per read; the point is that the
// 0.2-2 GB of tables per chunk stay on the card.
#include "common.cuh"

#define TIDX(r, w, s, b) ((((long long)(r) * W1 + (w)) * S + (s)) * B + (b))

// cell tables of the stack (scan/cyk.py's ids)
enum { kLL = 0, kP = 1, kE = 2, kM = 3, kB = 4, kT1 = 5, kT2 = 6, kO = 7 };
// actions
enum {
  A_L_L, A_O_O, A_2_2, A_E_H, A_E_M, A_M_B, A_2_P, A_1_2, A_1_B, A_P_E,
  A_P_P, A_O_OP, A_E_P, A_B_12, A_M_M
};

struct TbIdx {  // grammar lists (int32 unless noted)
  const int* rt_off;  // [S+1] right transitions by target, sources ascending
  const int* rt_s;
  const void* rt_w;   // log weights (scalar type)
  const int* lt_off;  // [S+1] left transitions by target
  const int* lt_s;
  const void* lt_w;
  const int* pt_code;  // [S, S] -1 none, -2 background, else pair table
  const int* pt_wl;
  const int* pt_wr;
  const void* pt_lt;   // [S, S] log tau of pair transitions
  const int* loopm;    // [S]
  const int* bucket;   // [S] lambda bucket
  const int* end_states;  // [3]
  const int* state_l;  // [S] node ids
  const int* state_r;
  const int* op_off;   // [S+1] (P state, O state) split tuples by target
  const int* op_a;
  const int* op_c;
  const int* b12_off;  // [S+1] (T1 state, T2 state) split tuples by target
  const int* b12_a;
  const int* b12_c;
  const int* ept_off;  // [S+1] internal-loop quadruples by target
  const int* ept_s1;
  const int* ept_s2;
  const int* ept_s3;
};

struct TbData {  // tables [R, W1, S, B] (O [R, S, B]) and factors
  const void *LL, *P, *E, *M, *Bt, *T1, *T2, *O;
  const void *eR, *eL, *bg2, *pv, *wsp, *gate_O2, *gate_M;
  const void *hp, *stk, *ext, *ml2, *mlE;
  const void *misA, *misB, *SZ, *spec_il, *lam;
  const int* C;            // [B]
  const long long* L;      // [B]
  const int* dcum;         // [Lp+1, B]
};

struct TbCfg {
  double eps;  // relative tolerance of the first-within-eps rule
  int cap;     // stack entries per read
};

struct Act {
  int tt, a0, a1, a2, a3, a4;
};

template <typename T>
struct Tb {
  DPDims D;
  TbIdx ix;
  Aux ax;
  TbData d;
  int b;
  T lam[2];

  __device__ T tab(int e, int j, int w, int s) const {
    const int S = D.S, B = D.B, W1 = D.Wp + 1;
    if (w < 0 || w > D.Wp || j < 0 || j > D.Lp) return ninf<T>();
    const void* p = e == kLL ? d.LL : e == kP ? d.P : e == kE ? d.E
                  : e == kM ? d.M : e == kB ? d.Bt : e == kT1 ? d.T1 : d.T2;
    return static_cast<const T*>(p)[TIDX(j + D.PAD, w, s, b)];
  }
  __device__ T O(int j, int s) const {
    if (j < 0 || j > D.Lp) return ninf<T>();
    return static_cast<const T*>(d.O)[((long long)(j + D.PAD) * D.S + s) *
                                          D.B + b];
  }
  __device__ T cellv(const T* a, int j, int w) const {  // [Lp+1, W1, B]
    return a[((long long)j * (D.Wp + 1) + w) * D.B + b];
  }
  __device__ T rowv(const void* a, int p, int s) const {  // [Lp, S, B]
    return static_cast<const T*>(a)[((long long)p * D.S + s) * D.B + b];
  }
  __device__ T basev(const void* a, int p) const {  // [Lp, B]
    return static_cast<const T*>(a)[(long long)p * D.B + b];
  }
  __device__ T lamv(int s) const { return lam[ix.bucket[s]]; }
  __device__ bool veto(int base, int kind, int t, int s) const {
    return vetoed(ax, pin_req(ax, b, base, kind), kind, t, s, D.S);
  }
  __device__ bool dots(int lo, int hi, int n) const {  // bases lo..hi-1
    return !D.fix_rss ||
           d.dcum[(long long)hi * D.B + b] - d.dcum[(long long)lo * D.B + b] ==
               n;
  }

  // pair emission of target s at span (i, j) from source s1 (-inf when
  // vetoed); the caller checked pt_code != -1
  __device__ T pem(int i, int j, int s, int s1) const {
    const int S = D.S, code = ix.pt_code[s * S + s1];
    if (veto(i, kAuxPL, s, s1) || veto(j - 1, kAuxPR, s, s1))
      return ninf<T>();
    T v;
    if (code == -2) {
      v = basev(d.bg2, i) + basev(d.bg2, j - 1);
    } else {
      v = static_cast<const T*>(d.pv)[(((long long)j * (D.Wp + 1) + (j - i)) *
                                           D.Tp + code) * D.B + b];
      if (ix.pt_wl[s * S + s1]) v += basev(d.wsp, i);
      if (ix.pt_wr[s * S + s1]) v += basev(d.wsp, j - 1);
    }
    return v + static_cast<const T*>(ix.pt_lt)[s * S + s1];
  }

  // the internal-loop energy of E cell (j, w) with gaps dk (left), dl
  // (right), from K11's factors (-inf where the loop is not allowed)
  __device__ T il(int j, int w, int dk, int dl) const {
    const int usum = dk + dl, v = w - dk - dl, i = j - w;
    if (usum < 1 || usum > d.C[b] || v < 0) return ninf<T>();
    if (!dots(i, i + dk, dk) || !dots(j - dl, j, dl)) return ninf<T>();
    const int W1 = D.Wp + 1, C1 = D.Cp + 1, B = D.B, Lp = D.Lp;
    if (!D.no_ene) {
      const int dks[6] = {0, 1, 1, 1, 2, 2}, dls[6] = {1, 0, 1, 2, 1, 2};
      for (int ci = 0; ci < 6; ++ci)
        if (dk == dks[ci] && dl == dls[ci])
          return static_cast<const T*>(d.spec_il)[(((long long)ci * (Lp + 1) +
                                                    j) * W1 + w) * B + b];
    }
    const T* mA = static_cast<const T*>(d.misA);
    const T* mB = static_cast<const T*>(d.misB);
    const T* sz = static_cast<const T*>(d.SZ);
    T e = ninf<T>();
    for (int g = 0; g < 4; ++g) {
      const T x = mB[(((long long)g * (Lp + 1) + (j - dl)) * W1 + v) * B + b] +
                  sz[((long long)g * C1 + dl) * C1 + dk] +
                  mA[(((long long)g * (Lp + 1) + j) * W1 + w) * B + b];
      e = x > e ? x : e;
    }
    return e;
  }

  __device__ int n_rt(int s) const { return ix.rt_off[s + 1] - ix.rt_off[s]; }
  __device__ int n_lt(int s) const { return ix.lt_off[s + 1] - ix.lt_off[s]; }

  __device__ int count(int e, int i, int j, int s) const {
    const int w = j - i;
    switch (e) {
      case kO: {
        const int ns = j < D.Wp ? j : D.Wp;
        return ns * (ix.op_off[s + 1] - ix.op_off[s]) + n_rt(s);
      }
      case kLL: return n_rt(s);
      case kP: return 2 * D.S;
      case kT2: return n_rt(s) + 1;
      case kT1: return 2;
      case kB:
        return (w > 1 ? w - 1 : 0) * (ix.b12_off[s + 1] - ix.b12_off[s]);
      case kM: return n_lt(s) + 1;
      default: {  // kE
        const int nd = (D.Cp < w ? D.Cp : w) + 1;
        return 2 + nd * nd * (ix.ept_off[s + 1] - ix.ept_off[s]);
      }
    }
  }

  // candidate q of cell (e, i, j, s): its score, whether it exists (the
  // JAX list holds it), and its action
  __device__ T cand(int e, int i, int j, int s, int q, bool& ex,
                    Act& a) const {
    const int S = D.S, w = j - i;
    const T* rtw = static_cast<const T*>(ix.rt_w);
    const T* ltw = static_cast<const T*>(ix.lt_w);
    ex = true;
    a.tt = -1;
    switch (e) {
      case kO: {
        const int nop = ix.op_off[s + 1] - ix.op_off[s];
        const int ns = j < D.Wp ? j : D.Wp;
        if (q < ns * nop) {
          const int wp = q / nop + 1, k = ix.op_off[s] + q % nop;
          const int isp = j - wp, s1 = ix.op_a[k], s2 = ix.op_c[k];
          a = {A_O_OP, isp, s1, s2, 0, 0};
          return O(isp, s2) + tab(kP, j, wp, s1) +
                 lam_mul(lamv(s), cellv(static_cast<const T*>(d.ext), j, wp));
        }
        const int k = ix.rt_off[s] + q - ns * nop, s1 = ix.rt_s[k];
        a = {A_O_O, s1, 0, 0, 0, 0};
        if (veto(j - 1, kAuxR, s, s1)) return ninf<T>();
        return O(j - 1, s1) + rtw[k] + rowv(d.eR, j - 1, s) +
               basev(d.gate_O2, j - 1);
      }
      case kLL: {
        const int k = ix.rt_off[s] + q, s1 = ix.rt_s[k];
        a = {A_L_L, s1, 0, 0, 0, 0};
        if (veto(j - 1, kAuxR, s, s1)) return ninf<T>();
        return tab(kLL, j - 1, w - 1, s1) + rtw[k] + rowv(d.eR, j - 1, s);
      }
      case kP: {
        const int s1 = q >> 1, pp = q & 1;
        if (ix.pt_code[s * S + s1] == -1) {
          ex = false;
          return ninf<T>();
        }
        a = {pp ? A_P_P : A_P_E, s1, 0, 0, 0, 0};
        const T pe = pem(i, j, s, s1);
        if (!pp) return tab(kE, j - 1, w - 2, s1) + pe;
        return tab(kP, j - 1, w - 2, s1) + pe +
               lam_mul(lamv(s), cellv(static_cast<const T*>(d.stk), j, w));
      }
      case kT2: {
        if (q == n_rt(s)) {
          a = {A_2_P, 0, 0, 0, 0, 0};
          return tab(kP, j, w, s) +
                 lam_mul(lamv(s), cellv(static_cast<const T*>(d.ml2), j, w));
        }
        const int k = ix.rt_off[s] + q, s1 = ix.rt_s[k];
        a = {A_2_2, s1, 0, 0, 0, 0};
        if (veto(j - 1, kAuxR, s, s1)) return ninf<T>();
        return tab(kT2, j - 1, w - 1, s1) + rtw[k] + rowv(d.eR, j - 1, s) +
               basev(d.gate_O2, j - 1);
      }
      case kT1:
        a = {q ? A_1_B : A_1_2, 0, 0, 0, 0, 0};
        return q ? tab(kB, j, w, s) : tab(kT2, j, w, s);
      case kB: {
        const int nb = ix.b12_off[s + 1] - ix.b12_off[s];
        const int k = i + 1 + q / nb, t = ix.b12_off[s] + q % nb;
        const int s1 = ix.b12_a[t], s2 = ix.b12_c[t];
        a = {A_B_12, k, s1, s2, 0, 0};
        return tab(kT1, k, k - i, s1) + tab(kT2, j, j - k, s2);
      }
      case kM: {
        if (q == n_lt(s)) {
          a = {A_M_B, 0, 0, 0, 0, 0};
          return tab(kB, j, w, s);
        }
        const int k = ix.lt_off[s] + q, s1 = ix.lt_s[k];
        a = {A_M_M, s1, 0, 0, 0, 0};
        if (veto(i, kAuxL, s, s1)) return ninf<T>();
        return tab(kM, j, w - 1, s1) + ltw[k] + rowv(d.eL, i, s1) +
               basev(d.gate_M, i);
      }
      default: {  // kE
        if (q == 0) {
          ex = ix.loopm[s] != 0;
          a = {A_E_H, 0, 0, 0, 0, 0};
          return ex ? tab(kLL, j, w, s) +
                          lam_mul(lamv(s),
                                  cellv(static_cast<const T*>(d.hp), j, w))
                    : ninf<T>();
        }
        if (q == 1) {
          a = {A_E_M, 0, 0, 0, 0, 0};
          return tab(kM, j, w, s) +
                 lam_mul(lamv(s), cellv(static_cast<const T*>(d.mlE), j, w));
        }
        const int nq = ix.ept_off[s + 1] - ix.ept_off[s];
        const int nd = (D.Cp < w ? D.Cp : w) + 1;
        const int r = q - 2, qi = r % nq, dk = (r / nq) % nd, dl = r / nq / nd;
        const T e0 = (dk + dl <= w && !(dk == 0 && dl == 0))
                         ? il(j, w, dk, dl) : ninf<T>();
        if (!(e0 > ninf<T>())) {
          ex = false;
          return ninf<T>();
        }
        const int t = ix.ept_off[s] + qi;
        const int s1 = ix.ept_s1[t], s2 = ix.ept_s2[t], s3 = ix.ept_s3[t];
        const int k = i + dk, l = j - dl;
        a = {A_E_P, k, l, s1, s2, s3};
        return tab(kP, l, l - k, s1) + tab(kLL, k, dk, s2) +
               tab(kLL, j, dl, s3) + lam_mul(lamv(s), e0);
      }
    }
  }
};

template <typename T>
__global__ void cyk_traceback_kernel(DPDims D, TbIdx ix, Aux ax, TbData d,
                                     TbCfg cfg, int* psihat,
                                     unsigned char* pairs, int* err,
                                     int4* stack_all) {
  const int b = blockIdx.x, lane = threadIdx.x;
  Tb<T> tb{D, ix, ax, d, b, {static_cast<const T*>(d.lam)[0],
                              static_cast<const T*>(d.lam)[1]}};
  int4* stack = stack_all + (long long)b * cfg.cap;
  int* path = psihat + (long long)b * D.Lp;
  unsigned char* pr = pairs + (long long)b * (D.Lp + 1) * (D.Wp + 1);
  const int L = static_cast<int>(d.L[b]);
  // the stack and the walk's state belong to lane 0; the warp reads the
  // popped cell and the state from shared memory between two barriers
  __shared__ int4 cur;
  __shared__ int state;  // 0 walking, 1 done, 2 step guard or stack, 3 no
                         // candidate within eps
  int top = 0;
  long long steps = 0;
  const long long guard = 40LL * (L + 2);
  if (lane == 0) {
    const int sA = ix.end_states[1], sB = ix.end_states[2];
    const T oA = tb.O(L, sA), oB = tb.O(L, sB);
    state = 0;
    if ((oA < oB ? oB : oA) > ninf<T>())
      stack[top++] = make_int4(0, L, kO, oA < oB ? sB : sA);
  }
  while (true) {
    if (lane == 0 && state == 0) {
      if (top == 0) {
        state = 1;
      } else if (++steps > guard) {
        state = 2;
      } else {
        cur = stack[--top];
      }
    }
    __syncwarp();
    const int run = state;
    const int4 c = cur;
    __syncwarp();
    if (run) break;
    const int i = c.x, j = c.y, e = c.z, s = c.w;
    if ((e == kLL && j <= i) || (e == kO && j <= 0)) continue;
    const int n = tb.count(e, i, j, s);
    if (n == 0) continue;
    const T stored = e == kO ? tb.O(j, s) : tb.tab(e, j, j - i, s);
    const T thr = stored - (T)cfg.eps * ((T)1 + fabs(stored));
    int win = -1;
    for (int base = 0; base < n && win < 0; base += 32) {
      const int q = base + lane;
      bool ex = false;
      Act a;
      T sc = ninf<T>();
      if (q < n) sc = tb.cand(e, i, j, s, q, ex, a);
      const unsigned hit = __ballot_sync(0xffffffffu, ex && sc >= thr);
      if (hit) win = base + __ffs(hit) - 1;
    }
    if (lane != 0) continue;
    if (win < 0) {
      state = 3;
      continue;
    }
    bool ex;
    Act a;
    tb.cand(e, i, j, s, win, ex, a);
    const int* sl = ix.state_l;
    const int* sr = ix.state_r;
    auto push = [&](int pi, int pj, int pe, int ps) {
      if (top >= cfg.cap) {
        state = 2;
      } else {
        stack[top++] = make_int4(pi, pj, pe, ps);
      }
    };
    switch (a.tt) {
      case A_L_L:
        path[j - 1] = sr[s];
        push(i, j - 1, kLL, a.a0);
        break;
      case A_O_O:
        path[j - 1] = sr[s];
        push(0, j - 1, kO, a.a0);
        break;
      case A_2_2:
        path[j - 1] = sr[s];
        push(i, j - 1, kT2, a.a0);
        break;
      case A_E_H: push(i, j, kLL, s); break;
      case A_E_M: push(i, j, kM, s); break;
      case A_M_B: push(i, j, kB, s); break;
      case A_2_P: push(i, j, kP, s); break;
      case A_1_2: push(i, j, kT2, s); break;
      case A_1_B: push(i, j, kB, s); break;
      case A_P_E:
      case A_P_P:
        path[i] = sl[a.a0];
        path[j - 1] = sr[s];
        pr[(long long)j * (D.Wp + 1) + (j - i)] = 1;
        push(i + 1, j - 1, a.tt == A_P_E ? kE : kP, a.a0);
        break;
      case A_O_OP:
        push(a.a0, j, kP, a.a1);
        push(0, a.a0, kO, a.a2);
        break;
      case A_E_P:
        push(a.a1, j, kLL, a.a4);
        push(i, a.a0, kLL, a.a3);
        push(a.a0, a.a1, kP, a.a2);
        break;
      case A_B_12:
        push(a.a0, j, kT2, a.a2);
        push(i, a.a0, kT1, a.a1);
        break;
      case A_M_M:
        path[i] = sl[a.a0];
        push(i + 1, j, kM, a.a0);
        break;
    }
  }
  if (lane == 0) err[b] = state == 1 ? 0 : state == 3 ? 2 : 1;
}

template <typename T>
static int traceback(DPDims D, TbIdx ix, Aux ax, TbData d, TbCfg cfg,
                     int* psihat, unsigned char* pairs, int* err, int* stack,
                     cudaStream_t st) {
  cyk_traceback_kernel<T><<<D.B, 32, 0, st>>>(
      D, ix, ax, d, cfg, psihat, pairs, err, reinterpret_cast<int4*>(stack));
  return static_cast<int>(cudaGetLastError());
}

#define TB_EXPORT(SUF, T)                                                    \
  RNAELEM_EXPORT int rnaelem_cyk_traceback_##SUF(                            \
      DPDims D, TbIdx ix, Aux ax, TbData d, TbCfg cfg, int* psihat,          \
      unsigned char* pairs, int* err, int* stack, cudaStream_t st) {         \
    return traceback<T>(D, ix, ax, d, cfg, psihat, pairs, err, stack, st);   \
  }

TB_EXPORT(f32, float)
TB_EXPORT(f64, double)
