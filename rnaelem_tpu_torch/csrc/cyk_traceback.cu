// K13: the CYK/Viterbi traceback of the scanner's alignment on the card.
//
// Replaces (rnaelem_tpu): the Viterbi path of ops/dp_maxb.py marks (row L,
// :459), which reads the path off as max-semiring cotangents, by the exact
// table-based traceback of scan/cyk.py traceback (:289) and _candidates
// (:190), the reference's own (motif_scanner.hpp:262-362), so the CYK
// tables (K10-K12) never leave the card.
//
// One block per read walks the read's tables from the end-state choice
// (sB iff O[L, sA] < O[L, sB]) with an explicit bounded stack of cells
// (i, j, table, state).  At each cell the block re-derives the cell's
// candidates in _candidates' order (E_H, E_M, then the internal loops by
// (dl, dk, quadruple); P_E before P_P per source; the splits of B and O in
// loop order; O_O last) and takes the FIRST candidate whose score is
// within eps * (1 + |stored|) of the cell's stored table value: the
// reference's "first strictly greater" rule, made robust to the last-bit
// rounding of a score recomputed in another association order than the
// DP's.  The internal-loop candidates are scored from the factor tensors
// K11 reads (misA/misB, the size classes' log energies SZ, spec_il), not
// from a second Turner lookup.  Vetoed transitions of the pin set
// (common.cuh Aux) score -inf.  The walk writes psihat [B, Lp] (node ids:
// state_r of the target for the right-emitting steps, state_l of the
// source for the left ones) and the pair cells [B, Lp+1, Wp+1] (1 where
// the path takes a P cell); err [B] is 1 when the walk exceeds 40 * (L +
// 2) steps or its stack, 2 when a cell has no candidate within eps (the
// host raises on either).  A read whose best score is -inf gets no path
// (psihat 0, no pairs).
//
// Bound on the H100: neither bytes nor operations but the walk's
// dependent path: up to a hundred cells per read (76 on the tRNA scan),
// each waiting for its candidates' table values (a random 8-byte read of
// 0.2-2 GB of tables per chunk, one dependent load) before the next cell
// is known; a cell's chain of dependent instructions on a warp with no
// other work to hide it comes on top (chip_smoke.py --tb-times traces
// the cycles per cell).  It reads a few KB per read of the tables and writes Lp +
// (Lp+1)(Wp+1) bytes-ish per read; the point is that the tables stay on
// the card.  Design (ops/kernels.traceback_plan picks the layout): the
// block's NW warps keep everything else off that path.  The grammar's
// lists (ops/kernels.tb_lists: one int32 and one scalar buffer) are
// staged into shared memory once where they fit; the walk's stack lives
// in shared memory where it fits beside them, else in a device scratch
// (the same code through a generic pointer); the read's running dot
// counts, its cap C and its pin positions are read once.  A cell with at
// most 32 candidates is scored by warp 0 alone (one ballot, the winner's
// action shuffled from the lane that found it, no block barrier); a
// larger one in rounds of 32 NW candidates, each warp's first hit and
// its action written by that lane into shared memory and the lowest hit
// over the warps taken after one barrier: the same first-within-eps
// choice over _candidates' order.  A candidate issues its table and
// energy loads together, after the checks that need no memory, so a
// round waits for one round trip.  The block's state (the kernel's
// arguments, the lists' bases, the pins) stays in registers: no local
// memory on the walk's path.  Thread 0 pushes the winner's cells and pops
// the next one; one barrier hands the cell to the block.  ``trace``, where
// given, gets the walk's counters and clock cycles per read.
#include <limits.h>

#include "common.cuh"

// cell tables of the stack (scan/cyk.py's ids)
enum { kLL = 0, kP = 1, kE = 2, kM = 3, kB = 4, kT1 = 5, kT2 = 6, kO = 7 };
// actions
enum {
  A_L_L, A_O_O, A_2_2, A_E_H, A_E_M, A_M_B, A_2_P, A_1_2, A_1_B, A_P_E,
  A_P_P, A_O_OP, A_E_P, A_B_12, A_M_M
};

// The grammar's lists as K13 takes them (ops/kernels.tb_lists): every
// int32 list in one buffer ``iv`` and the scalar ones in ``tv``, each at
// its offset.  pt[s * S + s1] packs the pair transition s <- s1: ((code
// + 2) << 2) | (wl << 1) | wr, code -1 none, -2 background, else the pair
// table.
struct TbLists {
  const int* iv;
  const void* tv;
  int ni, nt;  // the buffers' lengths
  int rt_off, rt_s, lt_off, lt_s, pt, loopm, bucket, end_states, state_l,
      state_r, op_off, op_a, op_c, b12_off, b12_a, b12_c, ept_off, ept_s1,
      ept_s2, ept_s3;  // offsets into iv
  int rt_w, lt_w, pt_lt;  // offsets into tv
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

// K13's layout (ops/kernels.traceback_plan): NW warps a block, the stack
// in shared memory (1) or the device scratch (0), the lists staged in
// shared memory (1) or read where they lie (0), the dynamic shared bytes
struct TbGrid {
  int NW, stack_smem, lists_smem, smem;
};

static const int kTbMaxWarps = 8;

// every tensor K13 reads has fewer than 2^31 rows of B values: the
// tables [R, W1, S], pv [Lp+1, W1, Tp] and spec_il, misA, misB [<= 6,
// Lp+1, W1]
static bool tb_rows_fit(const DPDims& D) {
  const long long W1 = D.Wp + 1, cells = (D.Lp + 1LL) * W1;
  return (D.Lp + 1LL + D.PAD) * W1 * D.S < (1LL << 31) &&
         cells * (D.Tp > 6 ? D.Tp : 6) < (1LL << 31);
}
// the walk's trace per read: cells scored by warp 0 alone, cells scored
// in block rounds, those rounds, candidate slots up to the choices, the
// clock cycles from a cell's hand-over to its choice in each kind of
// cell, the walk's cycles in all
static const int kTbTrace = 7;

// the dynamic shared memory of a layout: the stack (int4), the scalar
// lists, the int lists, then the read's running dot counts (Lp + 1 ints)
template <typename T>
static long long tb_smem_bytes(const TbLists& li, int cap, int Lp,
                               int stack_smem, int lists_smem) {
  return (stack_smem ? 16LL * cap : 0) +
         (lists_smem ? (long long)sizeof(T) * li.nt + 4LL * li.ni : 0) +
         4LL * (Lp + 1);
}

struct Act {
  int tt, a0, a1, a2, a3, a4;
};

template <typename T>
struct TbIdx {  // the lists where the block reads them (shared or global)
  const int *rt_off, *rt_s, *lt_off, *lt_s, *pt, *loopm, *bucket,
      *state_l, *state_r, *op_off, *op_a, *op_c, *b12_off, *b12_a, *b12_c,
      *ept_off, *ept_s1, *ept_s2, *ept_s3;
  const T *rt_w, *lt_w, *pt_lt;

  __device__ TbIdx(const TbLists& li, const int* iv, const T* tv)
      : rt_off(iv + li.rt_off), rt_s(iv + li.rt_s), lt_off(iv + li.lt_off),
        lt_s(iv + li.lt_s), pt(iv + li.pt), loopm(iv + li.loopm),
        bucket(iv + li.bucket), state_l(iv + li.state_l),
        state_r(iv + li.state_r), op_off(iv + li.op_off),
        op_a(iv + li.op_a), op_c(iv + li.op_c), b12_off(iv + li.b12_off),
        b12_a(iv + li.b12_a), b12_c(iv + li.b12_c),
        ept_off(iv + li.ept_off), ept_s1(iv + li.ept_s1),
        ept_s2(iv + li.ept_s2), ept_s3(iv + li.ept_s3),
        rt_w(tv + li.rt_w), lt_w(tv + li.lt_w), pt_lt(tv + li.pt_lt) {}
};

template <typename T>
struct Tb {
  DPDims D;
  TbIdx<T> ix;
  Aux ax;
  TbData d;
  int b, C;
  const int* dc;   // the read's running dot counts [Lp+1] (shared)
  int npin;        // the pin set's entries
  int pinpos[kMaxPins];  // indexed by constants only: the struct stays in
                         // registers (no local memory on the walk's path)
  T lam0, lam1;

  // the read's value in row ``row`` of a batch-minor tensor [..., B]: a
  // 32-bit row index (the launcher refuses tables whose rows pass it),
  // one widening multiply
  __device__ T at(const void* a, int row) const {
    return static_cast<const T*>(a)[(long long)row * D.B + b];
  }
  __device__ T tab(int e, int j, int w, int s) const {  // [R, W1, S, B]
    if (w < 0 || w > D.Wp || j < 0 || j > D.Lp) return ninf<T>();
    const void* p = e == kLL ? d.LL : e == kP ? d.P : e == kE ? d.E
                  : e == kM ? d.M : e == kB ? d.Bt : e == kT1 ? d.T1 : d.T2;
    return at(p, ((j + D.PAD) * (D.Wp + 1) + w) * D.S + s);
  }
  __device__ T O(int j, int s) const {  // [R, S, B]
    if (j < 0 || j > D.Lp) return ninf<T>();
    return at(d.O, (j + D.PAD) * D.S + s);
  }
  __device__ T cellv(const void* a, int j, int w) const {  // [Lp+1, W1, B]
    return at(a, j * (D.Wp + 1) + w);
  }
  __device__ T rowv(const void* a, int p, int s) const {  // [Lp, S, B]
    return at(a, p * D.S + s);
  }
  __device__ T basev(const void* a, int p) const {  // [Lp, B]
    return at(a, p);
  }
  __device__ T lamv(int s) const { return ix.bucket[s] ? lam1 : lam0; }
  // common.cuh pin_req / vetoed on the read's pin positions, read once
  __device__ bool veto(int base, int kind, int t, int s) const {
    int req = 0;
#pragma unroll
    for (int k = 0; k < kMaxPins; ++k)
      if (k < npin && ((ax.pin_kinds[k] >> kind) & 1) && pinpos[k] == base)
        req |= ax.pin_bit[k];
    return vetoed(ax, req, kind, t, s, D.S);
  }
  __device__ bool dots(int lo, int hi, int n) const {  // bases lo..hi-1
    return !D.fix_rss || dc[hi] - dc[lo] == n;
  }

  // pair emission of target s at span (i, j) from source s1 (-inf when
  // vetoed); pk is pt[s * S + s1], not "none"
  __device__ T pem(int i, int j, int s, int s1, int pk) const {
    const int code = (pk >> 2) - 2;
    T v;
    if (code == -2) {
      v = basev(d.bg2, i) + basev(d.bg2, j - 1);
    } else {
      v = at(d.pv, (j * (D.Wp + 1) + (j - i)) * D.Tp + code);
      if (pk & 2) v += basev(d.wsp, i);
      if (pk & 1) v += basev(d.wsp, j - 1);
    }
    const T r = v + ix.pt_lt[s * D.S + s1];
    return veto(i, kAuxPL, s, s1) || veto(j - 1, kAuxPR, s, s1) ? ninf<T>()
                                                                  : r;
  }

  // the internal-loop energy of E cell (j, w) with gaps dk (left), dl
  // (right), from K11's factors (-inf where the loop is not allowed); its
  // loads do not wait for the dot gates
  __device__ T il(int j, int w, int dk, int dl) const {
    const int usum = dk + dl, v = w - dk - dl, i = j - w;
    if (usum < 1 || usum > C || v < 0) return ninf<T>();
    const bool ok = dots(i, i + dk, dk) && dots(j - dl, j, dl);
    const int W1 = D.Wp + 1, C1 = D.Cp + 1, Lp = D.Lp;
    T e = ninf<T>();
    // spec_il's combination of the gaps (dk, dl) in (0,1), (1,0), (1,1),
    // (1,2), (2,1), (2,2): nibble 3 dk + dl of a literal, 15 for none
    const int ci = D.no_ene || dk > 2 || dl > 2
                       ? 15 : (int)((0x54F321F0FULL >> (4 * (3 * dk + dl))) & 15);
    if (ci != 15) {
      e = at(d.spec_il, (ci * (Lp + 1) + j) * W1 + w);
    } else {
      const T* sz = static_cast<const T*>(d.SZ);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const T x = at(d.misB, (g * (Lp + 1) + (j - dl)) * W1 + v) +
                    sz[(g * C1 + dl) * C1 + dk] +
                    at(d.misA, (g * (Lp + 1) + j) * W1 + w);
        e = x > e ? x : e;
      }
    }
    return ok ? e : ninf<T>();
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
                 lam_mul(lamv(s), cellv(d.ext, j, wp));
        }
        const int k = ix.rt_off[s] + q - ns * nop, s1 = ix.rt_s[k];
        a = {A_O_O, s1, 0, 0, 0, 0};
        const T v = O(j - 1, s1) + ix.rt_w[k] + rowv(d.eR, j - 1, s) +
                    basev(d.gate_O2, j - 1);
        return veto(j - 1, kAuxR, s, s1) ? ninf<T>() : v;
      }
      case kLL: {
        const int k = ix.rt_off[s] + q, s1 = ix.rt_s[k];
        a = {A_L_L, s1, 0, 0, 0, 0};
        const T v = tab(kLL, j - 1, w - 1, s1) + ix.rt_w[k] +
                    rowv(d.eR, j - 1, s);
        return veto(j - 1, kAuxR, s, s1) ? ninf<T>() : v;
      }
      case kP: {
        const int s1 = q >> 1, pp = q & 1;
        const int pk = ix.pt[s * S + s1];
        if ((pk >> 2) - 2 == -1) {
          ex = false;
          return ninf<T>();
        }
        a = {pp ? A_P_P : A_P_E, s1, 0, 0, 0, 0};
        const T pe = pem(i, j, s, s1, pk);
        if (!pp) return tab(kE, j - 1, w - 2, s1) + pe;
        return tab(kP, j - 1, w - 2, s1) + pe +
               lam_mul(lamv(s), cellv(d.stk, j, w));
      }
      case kT2: {
        if (q == n_rt(s)) {
          a = {A_2_P, 0, 0, 0, 0, 0};
          return tab(kP, j, w, s) + lam_mul(lamv(s), cellv(d.ml2, j, w));
        }
        const int k = ix.rt_off[s] + q, s1 = ix.rt_s[k];
        a = {A_2_2, s1, 0, 0, 0, 0};
        const T v = tab(kT2, j - 1, w - 1, s1) + ix.rt_w[k] +
                    rowv(d.eR, j - 1, s) + basev(d.gate_O2, j - 1);
        return veto(j - 1, kAuxR, s, s1) ? ninf<T>() : v;
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
        const T v = tab(kM, j, w - 1, s1) + ix.lt_w[k] + rowv(d.eL, i, s1) +
                    basev(d.gate_M, i);
        return veto(i, kAuxL, s, s1) ? ninf<T>() : v;
      }
      default: {  // kE
        if (q == 0) {
          ex = ix.loopm[s] != 0;
          a = {A_E_H, 0, 0, 0, 0, 0};
          return ex ? tab(kLL, j, w, s) + lam_mul(lamv(s), cellv(d.hp, j, w))
                    : ninf<T>();
        }
        if (q == 1) {
          a = {A_E_M, 0, 0, 0, 0, 0};
          return tab(kM, j, w, s) + lam_mul(lamv(s), cellv(d.mlE, j, w));
        }
        // q - 2 = (dl nd + dk) nq + qi: the loops by (dl, dk, quadruple);
        // il's size bounds before any load
        const int nq = ix.ept_off[s + 1] - ix.ept_off[s];
        const int nd = (D.Cp < w ? D.Cp : w) + 1;
        const int r = q - 2, qi = r % nq, dk = (r / nq) % nd, dl = r / nq / nd;
        if (dk + dl < 1 || dk + dl > C || dk + dl > w) {
          ex = false;
          return ninf<T>();
        }
        const int t = ix.ept_off[s] + qi;
        const int s1 = ix.ept_s1[t], s2 = ix.ept_s2[t], s3 = ix.ept_s3[t];
        const int k = i + dk, l = j - dl;
        // the operands' loads with il's, before its dot gates are known
        const T x1 = tab(kP, l, l - k, s1), x2 = tab(kLL, k, dk, s2),
                x3 = tab(kLL, j, dl, s3);
        const T e0 = il(j, w, dk, dl);
        if (!(e0 > ninf<T>())) {
          ex = false;
          return ninf<T>();
        }
        a = {A_E_P, k, l, s1, s2, s3};
        return x1 + x2 + x3 + lam_mul(lamv(s), e0);
      }
    }
  }
};

template <typename T, bool LS>
__global__ void __launch_bounds__(32 * kTbMaxWarps)
cyk_traceback_kernel(DPDims D, TbLists li, Aux ax, TbData d, TbCfg cfg,
                     TbGrid g, int* psihat, unsigned char* pairs, int* err,
                     int4* stack_dev, long long* trace) {
  extern __shared__ __align__(16) unsigned char tb_smem[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5, NT = blockDim.x;
  // the layout: stack, scalar lists, int lists, dot counts
  unsigned char* sp = tb_smem;
  int4* stack = stack_dev + (long long)b * cfg.cap;
  if (g.stack_smem) {
    stack = reinterpret_cast<int4*>(sp);
    sp += 16 * (size_t)cfg.cap;
  }
  const T* tv = static_cast<const T*>(li.tv);
  const int* iv = li.iv;
  if (LS) {  // the lists staged: the walk reads them from shared memory
    T* ts = reinterpret_cast<T*>(sp);
    int* is = reinterpret_cast<int*>(sp + sizeof(T) * li.nt);
    for (int k = tid; k < li.nt; k += NT) ts[k] = tv[k];
    for (int k = tid; k < li.ni; k += NT) is[k] = iv[k];
    tv = ts;
    iv = is;
    sp += sizeof(T) * li.nt + 4 * (size_t)li.ni;
  }
  int* dc = reinterpret_cast<int*>(sp);
  for (int p = tid; p <= D.Lp; p += NT) dc[p] = d.dcum[(long long)p * D.B + b];
  Tb<T> tb{D, TbIdx<T>(li, iv, tv), ax, d, b, d.C[b], dc, 0, {},
           static_cast<const T*>(d.lam)[0], static_cast<const T*>(d.lam)[1]};
#pragma unroll
  for (int k = 0; k < kMaxPins; ++k)
    if (ax.pin[k] != nullptr && k == tb.npin) {
      tb.pinpos[k] = ax.pin[k][b];
      tb.npin = k + 1;
    }
  int* path = psihat + (long long)b * D.Lp;
  unsigned char* pr = pairs + (long long)b * (D.Lp + 1) * (D.Wp + 1);
  const int L = static_cast<int>(d.L[b]);
  // the popped cell and the walk's state (0 walking, 1 done, 2 step guard
  // or stack, 3 no candidate within eps) by the parity of the step; each
  // warp's first hit and its action by the parity of the round: a buffer
  // is written again only after a barrier that every reader of its last
  // value has passed
  __shared__ int4 s_cur[2];
  __shared__ int s_run[2];
  __shared__ int s_hit[2][kTbMaxWarps];
  __shared__ Act s_act[2][kTbMaxWarps];
  // thread 0 owns the stack, its top, the step count and the state
  int top = 0, state = 0;
  long long steps = 0;
  const long long guard = 40LL * (L + 2);
  __syncthreads();  // the staged lists and dot counts
  if (tid == 0) {
    const int sA = iv[li.end_states + 1], sB = iv[li.end_states + 2];
    const T oA = tb.O(L, sA), oB = tb.O(L, sB);
    if ((oA < oB ? oB : oA) > ninf<T>())
      stack[top++] = make_int4(0, L, kO, oA < oB ? sB : sA);
  }
  int step = 0, round = 0;
  // the walk's trace (thread 0, where ``trace`` is given): kTbTrace
  // counters per read, ops/kernels.TB_TRACE's
  long long tr[kTbTrace] = {};
  const long long t_start = trace ? clock64() : 0;
  long long t_cell = 0;
  while (true) {
    const int par = step & 1;
    ++step;
    if (tid == 0) {
      if (state == 0) {
        if (top == 0) {
          state = 1;
        } else if (++steps > guard) {
          state = 2;
        } else {
          s_cur[par] = stack[--top];
        }
      }
      s_run[par] = state;
    }
    __syncthreads();
    if (s_run[par]) break;
    if (trace && tid == 0) t_cell = clock64();
    const int4 c = s_cur[par];
    const int i = c.x, j = c.y, e = c.z, s = c.w;
    if ((e == kLL && j <= i) || (e == kO && j <= 0)) continue;
    const int n = tb.count(e, i, j, s);
    if (n == 0) continue;
    int win = -1, nr = 0;
    Act wa{};
    if (n <= 32) {
      // one warp's round: the winner's action from the lane that found it
      if (warp != 0) continue;
      const T stored = e == kO ? tb.O(j, s) : tb.tab(e, j, j - i, s);
      bool ex = false;
      Act a{};
      T sc = ninf<T>();
      if (lane < n) sc = tb.cand(e, i, j, s, lane, ex, a);
      const T thr = stored - (T)cfg.eps * ((T)1 + fabs(stored));
      const unsigned hit = __ballot_sync(0xffffffffu, ex && sc >= thr);
      if (hit) {
        const int src = __ffs(hit) - 1;
        win = src;
        wa.tt = __shfl_sync(0xffffffffu, a.tt, src);
        wa.a0 = __shfl_sync(0xffffffffu, a.a0, src);
        wa.a1 = __shfl_sync(0xffffffffu, a.a1, src);
        wa.a2 = __shfl_sync(0xffffffffu, a.a2, src);
        wa.a3 = __shfl_sync(0xffffffffu, a.a3, src);
        wa.a4 = __shfl_sync(0xffffffffu, a.a4, src);
      }
    } else {
      // rounds of 32 NW candidates, candidate base + tid; every thread
      // reaches every barrier (n, base and the outcome are the block's)
      const T stored = e == kO ? tb.O(j, s) : tb.tab(e, j, j - i, s);
      for (int base = 0; base < n; base += NT) {
        const int q = base + tid, rp = round & 1;
        ++round;
        ++nr;
        bool ex = false;
        Act a{};
        T sc = ninf<T>();
        if (q < n) sc = tb.cand(e, i, j, s, q, ex, a);
        const T thr = stored - (T)cfg.eps * ((T)1 + fabs(stored));
        const unsigned hit = __ballot_sync(0xffffffffu, ex && sc >= thr);
        if (lane == 0)
          s_hit[rp][warp] = hit ? base + 32 * warp + __ffs(hit) - 1 : INT_MAX;
        if (hit && lane == __ffs(hit) - 1) s_act[rp][warp] = a;
        __syncthreads();
        int best = INT_MAX, bw = 0;
        for (int w2 = 0; w2 < g.NW; ++w2) {
          const int h = s_hit[rp][w2];
          if (h < best) {
            best = h;
            bw = w2;
          }
        }
        if (best != INT_MAX) {
          win = best;
          if (tid == 0) wa = s_act[rp][bw];
          break;
        }
      }
    }
    if (tid != 0) continue;
    if (trace) {
      const int blk = n > 32;
      tr[blk] += 1;
      tr[2] += nr;
      tr[3] += win + 1;
      tr[4 + blk] += clock64() - t_cell;
    }
    if (win < 0) {
      state = 3;
      continue;
    }
    const int* sl = tb.ix.state_l;
    const int* sr = tb.ix.state_r;
    auto push = [&](int pi, int pj, int pe, int ps) {
      if (top >= cfg.cap) {
        state = 2;
      } else {
        stack[top++] = make_int4(pi, pj, pe, ps);
      }
    };
    switch (wa.tt) {
      case A_L_L:
        path[j - 1] = sr[s];
        push(i, j - 1, kLL, wa.a0);
        break;
      case A_O_O:
        path[j - 1] = sr[s];
        push(0, j - 1, kO, wa.a0);
        break;
      case A_2_2:
        path[j - 1] = sr[s];
        push(i, j - 1, kT2, wa.a0);
        break;
      case A_E_H: push(i, j, kLL, s); break;
      case A_E_M: push(i, j, kM, s); break;
      case A_M_B: push(i, j, kB, s); break;
      case A_2_P: push(i, j, kP, s); break;
      case A_1_2: push(i, j, kT2, s); break;
      case A_1_B: push(i, j, kB, s); break;
      case A_P_E:
      case A_P_P:
        path[i] = sl[wa.a0];
        path[j - 1] = sr[s];
        pr[(long long)j * (D.Wp + 1) + (j - i)] = 1;
        push(i + 1, j - 1, wa.tt == A_P_E ? kE : kP, wa.a0);
        break;
      case A_O_OP:
        push(wa.a0, j, kP, wa.a1);
        push(0, wa.a0, kO, wa.a2);
        break;
      case A_E_P:
        push(wa.a1, j, kLL, wa.a4);
        push(i, wa.a0, kLL, wa.a3);
        push(wa.a0, wa.a1, kP, wa.a2);
        break;
      case A_B_12:
        push(wa.a0, j, kT2, wa.a2);
        push(i, wa.a0, kT1, wa.a1);
        break;
      case A_M_M:
        path[i] = sl[wa.a0];
        push(i + 1, j, kM, wa.a0);
        break;
    }
  }
  if (tid == 0) err[b] = state == 1 ? 0 : state == 3 ? 2 : 1;
  if (trace && tid == 0) {
    tr[6] = clock64() - t_start;
    for (int k = 0; k < kTbTrace; ++k)
      trace[(long long)b * kTbTrace + k] = tr[k];
  }
}

// K13 on the host plan's layout (ops/kernels.traceback_plan), refused
// unless it is the kernel's: 1 to kTbMaxWarps warps, the shared bytes of
// the layout's pieces, a device stack given where the stack is not
// shared, every tensor's rows of B values within 32-bit indices
template <typename T>
static int traceback(DPDims D, TbLists li, Aux ax, TbData d, TbCfg cfg,
                     TbGrid g, int* psihat, unsigned char* pairs, int* err,
                     int* stack, long long* trace, cudaStream_t st) {
  auto kern = cyk_traceback_kernel<T, false>;
  if (g.lists_smem) kern = cyk_traceback_kernel<T, true>;
  if (g.NW < 1 || g.NW > kTbMaxWarps || cfg.cap < 1 ||
      (g.stack_smem != 0 && g.stack_smem != 1) ||
      (g.lists_smem != 0 && g.lists_smem != 1) ||
      (!g.stack_smem && stack == nullptr) ||
      !tb_rows_fit(D) ||
      g.smem != tb_smem_bytes<T>(li, cfg.cap, D.Lp, g.stack_smem,
                                 g.lists_smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_smem((const void*)kern, g.smem);
  if (rc) return rc;
  kern<<<D.B, 32 * g.NW, g.smem, st>>>(D, li, ax, d, cfg, g, psihat, pairs,
                                       err, reinterpret_cast<int4*>(stack),
                                       trace);
  return static_cast<int>(cudaGetLastError());
}

#define TB_EXPORT(SUF, T)                                                    \
  RNAELEM_EXPORT int rnaelem_cyk_traceback_##SUF(                            \
      DPDims D, TbLists li, Aux ax, TbData d, TbCfg cfg, TbGrid g,           \
      int* psihat, unsigned char* pairs, int* err, int* stack,               \
      long long* trace, cudaStream_t st) {                                   \
    return traceback<T>(D, li, ax, d, cfg, g, psihat, pairs, err, stack,     \
                        trace, st);                                          \
  }

TB_EXPORT(f32, float)
TB_EXPORT(f64, double)
