// K3 and K11: the TT_E_P internal-loop term of one inside DP column j,
// plus the six base-coupled small loops (stack-adjacent bulges,
// 1x1/1x2/2x1/2x2).  K3 is the sum DP, K11 the CYK tables (max).
//
// Replaces (rnaelem_tpu, XLA-compiled jnp programs): K3 ops/dp.py ep_col
// and _ep_specials (row F of the kernel table, ops/dp.py:477-599); K11
// ops/dp_maxb.py ep_col, _flipB and _ep_specials (row L, :219-338).
//
// Bound on the H100: bytes.  Per column it must read the band cells that
// feed the sum: P (j-dl, v) with dl <= C, dl + v <= Wp and LL (j-x, u1)
// with u1 <= C, x + u1 <= Wp (1,116 of the 31 x 51 cells each at Wp = 50,
// C = 30), the inner-pair mismatch weights on the P cells and the
// read-independent size weights (about 37 MB at B=128 in f32, 11 us at
// 3.35 TB/s; chip_smoke.py counts it for its batch); its arithmetic,
// chain-factored as in the JAX package (pairs13 (inner pair x right
// flank) -> AR pairs -> the fused energy weight W[dl, x, u1] per lambda
// bucket -> K2 (left flank x AR) -> target), is about 0.35 GFLOP per
// column, dominated by the V contraction
// V_bu[x, u1, ar] = sum_dl T[dl, x, ar] * W_bu[dl, x, u1].
//
// K3 design (two launches per column): ep_fwd gives each (read, range
// of x) a block of kEpThreads threads (ep_col.cuh) that takes the read's
// per-(column, read) exp-space shifts as the JAX package does (maxima of
// P rows j-Cp..j, LL row j and LL rows j-Wp..j up to width Cp: the
// per-row maxima of earlier rows are kept in rowmax, the block reduces
// row j itself), walks its x forming T, W and V in shared memory, and
// sums exLB(j-x, u1)[s2k] * V_bu(k)[u1, ar(k)] into its partial out[w =
// x + u1, t] in shared memory (a ring of Cp+1 widths: step x adds to
// widths x..x+Cp, so width x-1 is written out as step x starts); T, W
// and V never reach device memory.  The first block of a read writes
// its row maxima and its shifts (the state's ep_shift [Lp+1, 3, B],
// which K6 reads).  ep_fwd_red sums the blocks' partials in range order
// and writes ep = log(out) + shifts.  Hazards
// kept: the per-read cap dl + u1 <= C, the x + u1 <= Wp geometry, the
// specials' dk + dl <= C, and the fix_rss dot gating of both flanks.
//
// K11 design (one launch per column, the max semiring in log space: no
// shifts): ep_max gives each (read, range of x) a block of kEpMaxThreads
// threads on ep_col.cuh's walk.  Per step x it forms T[dl, ar] = max_p
// P(j-dl, x-dl)[s1p] + L3(dl)[s3p], W_bu[dl, u1] = lam_bu * max_g ((misB_g
// + SZg[g, dl, u1]) + misA_g) on the triangle dl + u1 <= C_b, V_bu[u1, ar]
// = max_dl T + W_bu, and adds max over the K2 entries k of LB(j-x,
// u1)[s2k] + V_bu(k)[u1, ar(k)] (and the six specials, (LB + T) + lam_bu
// * il, their own association as in the plain version) into a ring of
// Cp+1 output widths; T, W and V never reach device memory.  The step's
// inputs (the P and LL cells, misA, misB, the specials' energies) are
// copied into the second of two stages by cp.async while the step before
// computes.  A thread has a fixed AR pair for T and a fixed target for
// the output, their grammar lists held in registers for the block's life
// (EpList), so a step's loops read no index from device memory.  The
// number of ranges follows B (ep_max_ranges: the device's resident
// blocks divided among the reads, one wave); each range writes its
// widths' partial maxima, and the last block of a read to finish (an integer counter per
// read, reset for the next column) takes the max over the ranges into the
// ep row.  Max is exact and commutes with rounding (fl(max(a, b) + c) =
// max(fl(a + c), fl(b + c))), so any split and any grouping of the maxima
// gives the plain version's bits; the additions inside a candidate keep
// its order.  K11's W is the max over the size classes of log energies
// times lambda: max_c lam * E_c = lam * max_c E_c holds for lam >= 0 only,
// which the caller asserts (the JAX max DP makes the same step).
#include "ep_col.cuh"

// ---- K11: the phases of one step x of a block (ep_max_kernel)

// a stage's copy: cp.async into shared memory, or a plain load and store
// where the stage lies in the device workspace (kDev)
template <bool kDev, typename T>
__device__ __forceinline__ void stage_copy(T* dst, const T* src) {
  if constexpr (kDev)
    *dst = *src;
  else
    cp_async_t(dst, src);
}

// step x's inputs into a stage's buffers (misB rows before 0 and the
// specials' widths beyond Wp are -inf, stored directly)
template <bool kDev, typename T>
__device__ void ep_max_stage(const EpBlock<T, T>& k, int x, const T* P,
                             const T* LL, const T* misA, const T* misB,
                             const T* spec_il, T* Pm, T* LBm, T* mAB,
                             T* il) {
  const int S = k.S, B = k.B, W1 = k.W1, C1 = k.C1, b = k.b, j = k.j;
  const int dmax = x < k.Cp ? x : k.Cp;
  const int umax = k.Cp < k.Wp - x ? k.Cp : k.Wp - x;
  for (int i = threadIdx.x; i < (dmax + 1) * S; i += blockDim.x) {
    const int dl = i / S, s = i % S;
    stage_copy<kDev>(Pm + i, P + TIDX(k.r - dl, x - dl, s, b));
  }
  for (int i = threadIdx.x; i < (umax + 1) * S; i += blockDim.x) {
    const int u1 = i / S, s = i % S;
    stage_copy<kDev>(LBm + i, LL + TIDX(k.r - x, u1, s, b));
  }
  // misA, misB [4, Lp+1, W1, B]
  for (int i = threadIdx.x; i < 4 * (umax + 1); i += blockDim.x) {
    const int g = i / (umax + 1), u1 = i % (umax + 1);
    stage_copy<kDev>(mAB + g * C1 + u1,
               misA + (((long long)g * (k.Lp + 1) + j) * W1 + (x + u1)) * B +
                   b);
  }
  for (int i = threadIdx.x; i < 4 * (dmax + 1); i += blockDim.x) {
    const int g = i / (dmax + 1), dl = i % (dmax + 1);
    T* dst = mAB + (4 + g) * C1 + dl;
    if (j - dl >= 0)
      stage_copy<kDev>(dst, misB + (((long long)g * (k.Lp + 1) + (j - dl)) * W1 +
                              (x - dl)) * B + b);
    else
      *dst = ninf<T>();
  }
  // spec_il [6, Lp+1, W1, B] at width x + dk (ci 0: dk 0; 1-3: 1; 4-5: 2)
  if (threadIdx.x < 6) {
    const int ci = threadIdx.x, w = x + (ci == 0 ? 0 : (ci < 4 ? 1 : 2));
    if (w <= k.Wp)
      stage_copy<kDev>(il + ci, spec_il + (((long long)ci * (k.Lp + 1) + j) * W1 +
                                     w) * B + b);
    else
      il[ci] = ninf<T>();
  }
}

// A thread's fixed list: the pairs13 entries of its AR pair (T) or the
// K2 entries of its target (out), packed, the first kEpMaxList held in
// registers for the block's life; the rest, if any, read at each use.
static const int kEpMaxList = 8;

__device__ __forceinline__ int ep_t_entry(const EpIdx& ix, int q) {
  const int p = ix.ar_p[q];
  return ix.p13_s1[p] | (ix.p13_s3[p] << 16);   // s1, s3
}
__device__ __forceinline__ int ep_k2_entry(const EpIdx& ix, int kk) {
  const int e = ix.k2_idx[kk];
  return ix.k2_s2[e] | (ix.k2_ar[e] << 12) | (ix.k2_bu[e] << 24);  // s2, ar, bu
}

struct EpList {
  int off, n;  // entries off..off+n-1 of the CSR list
  int e[kEpMaxList];
  template <class F>
  __device__ __forceinline__ void load(int off_, int end, F entry) {
    off = off_;
    n = end - off_;
#pragma unroll
    for (int q = 0; q < kEpMaxList; ++q) e[q] = q < n ? entry(off + q) : 0;
  }
  // f(packed entry) over the list, in its order
  template <class F, class G>
  __device__ __forceinline__ void each(F f, G entry) const {
#pragma unroll
    for (int q = 0; q < kEpMaxList; ++q)
      if (q < n) f(e[q]);
    for (int q = kEpMaxList; q < n; ++q) f(entry(off + q));
  }
};

// A thread's role in T (or out): AR pair (target) ``first``, of the
// ``cov`` that the block's threads cover at once (all of them where there
// are at most kEpMaxThreads), at lane ``lane`` of ``lanes``; a grammar
// with more takes first + cov, first + 2 cov, ... too, their lists read
// at that step (only the first is held in registers)
struct EpRole {
  int first, cov, lane, lanes;
};

// T and W of step x (its stage copied, L3 formed); T: thread (ar, lane)
// with ar's list tl takes dl = lane, lane + lanes, ...
template <typename T>
__device__ void ep_max_tw(const EpBlock<T, T>& k, int x, const EpIdx& ix,
                          const EpList& tl, const EpRole& ro, const T* Pm,
                          const T* L3, const T* mAB, const T* SZg, T lam0,
                          T lam1) {
  const int S = k.S, NA = k.NA, C1 = k.C1;
  const int dmax = x < k.Cp ? x : k.Cp;
  const int umax = k.Cp < k.Wp - x ? k.Cp : k.Wp - x;
  auto tent = [&](int q) { return ep_t_entry(ix, q); };
  auto rows = [&](const EpList& l, int ar) {
    for (int dl = ro.lane; dl <= dmax; dl += ro.lanes) {
      T t = ninf<T>();
      l.each([&](int pe) {
        const T v = Pm[dl * S + (pe & 0xffff)] + L3[dl * S + (pe >> 16)];
        t = v > t ? v : t;
      }, tent);
      k.Tm[dl * NA + ar] = t;
    }
  };
  if (ro.first >= 0) rows(tl, ro.first);
  for (int ar = ro.first + ro.cov; ro.first >= 0 && ar < NA; ar += ro.cov) {
    EpList l;
    l.load(ix.ar_off[ar], ix.ar_off[ar + 1], tent);
    rows(l, ar);
  }
  const int nu = umax + 1;
  for (int i = threadIdx.x; i < (dmax + 1) * nu; i += blockDim.x) {
    const int dl = i / nu, u1 = i % nu;
    if (dl + u1 > k.Cp) continue;
    T wr = ninf<T>();
    if (dl + u1 <= k.cap) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const T v = (mAB[(4 + g) * C1 + dl] +
                     SZg[((long long)g * C1 + dl) * C1 + u1]) +
                    mAB[g * C1 + u1];
        wr = v > wr ? v : wr;
      }
    }
    k.W(0, dl, u1) = lam_mul(lam0, wr);
    k.W(1, dl, u1) = lam_mul(lam1, wr);
  }
}

// V of step x (T and W formed): V_bu[u1, ar] = max_dl T[dl, ar] + W_bu
template <typename T>
__device__ void ep_max_v(const EpBlock<T, T>& k, int x) {
  const int NA = k.NA;
  const int dmax = x < k.Cp ? x : k.Cp;
  const int umax = k.Cp < k.Wp - x ? k.Cp : k.Wp - x;
  for (int i = threadIdx.x; i < (umax + 1) * NA; i += blockDim.x) {
    const int u1 = i / NA, ar = i % NA;
    T v0 = ninf<T>(), v1 = ninf<T>();
    const int dend = dmax < k.cap - u1 ? dmax : k.cap - u1;
    for (int dl = 0, t0 = u1; dl <= dend; t0 += k.C1 - dl, ++dl) {
      const T t = k.Tm[dl * NA + ar];   // t0 = tri_index(C1, dl, u1)
      const T a0 = t + k.Wm[t0], a1 = t + k.Wm[k.ntri + t0];
      v0 = a0 > v0 ? a0 : v0;
      v1 = a1 > v1 ? a1 : v1;
    }
    k.V(0, u1, ar) = v0;
    k.V(1, u1, ar) = v1;
  }
}

// ep_max_out for target t and its list ol
template <typename T, class F>
__device__ void ep_max_out_t(const EpBlock<T, T>& k, int x, const EpList& ol,
                             int t, int lane, int lanes, const T* LBm,
                             const T* il, T lam0, T lam1, const int* dcum,
                             T* out, F kent) {
  const int S = k.S, NA = k.NA, C1 = k.C1;
  const int dmax = x < k.Cp ? x : k.Cp;
  const int umax = k.Cp < k.Wp - x ? k.Cp : k.Wp - x;
  const int xs = x % C1;
  for (int u1 = lane; u1 <= umax; u1 += lanes) {
    if (k.fix_rss && !left_dots(dcum, k.j, x, u1, k.B, k.b)) continue;
    const T* lb = LBm + u1 * S;
    T acc = ninf<T>();
    ol.each([&](int pe) {
      const T v = k.V(pe >> 24, u1, (pe >> 12) & 0xfff);
      const T a = lb[pe & 0xfff] + v;
      acc = a > acc ? a : acc;
    }, kent);
    if (!k.no_ene && u1 <= 2) {
      for (int dl = 0; dl <= 2 && dl <= dmax; ++dl) {
        const int ci = spec_ci(u1, dl);
        if (ci < 0 || u1 + dl > k.cap) continue;
        const T e0 = lam_mul(lam0, il[ci]), e1 = lam_mul(lam1, il[ci]);
        const T* tm = k.Tm + dl * NA;
        ol.each([&](int pe) {
          const T a = (lb[pe & 0xfff] + tm[(pe >> 12) & 0xfff]) +
                      ((pe >> 24) ? e1 : e0);
          acc = a > acc ? a : acc;
        }, kent);
      }
    }
    T* o = out + ring_slot(xs, u1, C1) * S + t;
    if (acc > *o) *o = acc;
  }
}

// the ring's widths x..x+umax: out[x + u1, t] = max(out, max over the K2
// entries k of t of LB(j-x, u1)[s2k] + V_bu(k)[u1, ar(k)], and over the
// specials of left gap dk = u1 of (LB + T[dl, ar(k)]) + lam_bu * il);
// thread (t, lane) with t's list ol takes u1 = lane, lane + lanes, ...
template <typename T>
__device__ void ep_max_out(const EpBlock<T, T>& k, int x, const EpIdx& ix,
                           const EpList& ol, const EpRole& ro, const T* LBm,
                           const T* il, T lam0, T lam1, const int* dcum,
                           T* out) {
  auto kent = [&](int q) { return ep_k2_entry(ix, q); };
  if (ro.first >= 0)
    ep_max_out_t(k, x, ol, ro.first, ro.lane, ro.lanes, LBm, il, lam0, lam1,
                 dcum, out, kent);
  for (int t = ro.first + ro.cov; ro.first >= 0 && t < k.S; t += ro.cov) {
    EpList l;
    l.load(ix.k2_off[t], ix.k2_off[t + 1], kent);
    ep_max_out_t(k, x, l, t, ro.lane, ro.lanes, LBm, il, lam0, lam1, dcum,
                 out, kent);
  }
}

static const int kEpMaxThreads = 256;  // K11's threads per block

// the role of thread tid among n items (AR pairs or targets)
__device__ __forceinline__ EpRole ep_role(int tid, int n) {
  EpRole r;
  r.cov = n < kEpMaxThreads ? n : kEpMaxThreads;
  r.lanes = kEpMaxThreads / r.cov;
  r.first = tid < r.lanes * r.cov ? tid % r.cov : -1;
  r.lane = tid / r.cov;
  return r;
}

// ---- K11, fused: one block per (read, range of x) of column j; the last
// block of a read to finish merges the ranges' partial rows into ep.  kDev:
// the layout in the block's slice of the workspace ws
template <typename T, bool kDev>
__global__ void __launch_bounds__(kEpMaxThreads)
ep_max_kernel(DPDims D, EpMaxRanges xq, EpIdx ix, const T* P, const T* LL,
              const T* misA, const T* misB, const T* SZg, const T* spec_il,
              const T* lam, const int* dcum, const int* Cb, T* part,
              int* done, T* ep, unsigned char* ws) {
  extern __shared__ __align__(16) unsigned char ep_smem[];
  __shared__ bool last;
  EpBlock<T, T> k;
  k.init(D, Cb, blockIdx.x);
  const int xr = blockIdx.y, S = k.S, B = k.B, W1 = k.W1, b = k.b;
  const int C1 = k.C1;
  const EpMaxLayout lay(S, k.NA, C1);
  T* sm = reinterpret_cast<T*>(
      ep_base<kDev>(ep_smem, ws, lay.total * (long long)sizeof(T)));
  T* L3 = sm + lay.L3;
  T* out = sm + lay.out;   // ring [C1][S]: width w at slot w % C1
  k.Tm = sm + lay.Tm;
  k.Wm = sm + lay.Wm;
  k.Vm = sm + lay.Vm;
  const T lam0 = lam[0], lam1 = lam[1];
  // the thread's T role (AR pairs) and out role (targets), the lists of
  // its first AR pair and first target in registers
  const EpRole tr = ep_role(threadIdx.x, k.NA), orl = ep_role(threadIdx.x, S);
  const int tar = tr.first, tt = orl.first;
  EpList tl, ol;
  tl.load(tar >= 0 ? ix.ar_off[tar] : 0, tar >= 0 ? ix.ar_off[tar + 1] : 0,
          [&](int q) { return ep_t_entry(ix, q); });
  ol.load(tt >= 0 ? ix.k2_off[tt] : 0, tt >= 0 ? ix.k2_off[tt + 1] : 0,
          [&](int q) { return ep_k2_entry(ix, q); });
  // L3[dl][s] = LL(j, dl)[s], the right-flank dot gate folded in
  for (int i = threadIdx.x; i < C1 * S; i += blockDim.x) {
    const int dl = i / S, s = i % S;
    const bool ok = !k.fix_rss || right_dots(dcum, k.j, dl, B, b);
    L3[i] = ok ? LL[TIDX(k.r, dl, s, b)] : ninf<T>();
    out[i] = ninf<T>();
  }
  const int x0 = xq.x0[xr], x1 = xq.x1[xr];
  const int wend = x1 < x0 ? -1 : (x1 + k.Cp < k.Wp ? x1 + k.Cp : k.Wp);
  // the range's partial row of width w: row w + xr * Cp of part
  T* pb = part + (long long)xr * k.Cp * S * B + b;
  auto flush = [&](int w) {
    T* o = out + (w % C1) * S;
    for (int t = threadIdx.x; t < S; t += blockDim.x) {
      pb[((long long)w * S + t) * B] = o[t];
      o[t] = ninf<T>();
    }
  };
  auto stage = [&](int x, int q) {
    T* s0 = sm + q * lay.stage;
    ep_max_stage<kDev>(k, x, P, LL, misA, misB, spec_il, s0 + lay.Pm,
                 s0 + lay.LBm, s0 + lay.mAB, s0 + lay.il);
  };
  if (x0 <= x1) stage(x0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int x = x0; x <= x1; ++x) {
    const int q = (x - x0) & 1;
    const T* s0 = sm + q * lay.stage;
    // stage q ^ 1 held step x-1's inputs, read before the last barrier
    if (x < x1) stage(x + 1, q ^ 1);
    cp_async_commit();
    if (x > x0) flush(x - 1);   // no later x reaches width x - 1
    ep_max_tw(k, x, ix, tl, tr, s0 + lay.Pm, L3, s0 + lay.mAB, SZg, lam0,
              lam1);
    __syncthreads();
    ep_max_v(k, x);
    __syncthreads();
    ep_max_out(k, x, ix, ol, orl, s0 + lay.LBm, s0 + lay.il, lam0, lam1,
               dcum, out);
    cp_async_wait<0>();
    __syncthreads();
  }
  for (int w = x1; w <= wend; ++w) flush(w);
  // the last block of the read takes the max over the ranges' rows (read
  // through L2: other blocks wrote them)
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done + b, 1) == xq.n - 1;
  __syncthreads();
  if (!last) return;
  for (int i = threadIdx.x; i < W1 * S; i += blockDim.x) {
    const int w = i / S, t = i % S;
    T m = ninf<T>();
    for (int q = 0; q < xq.n; ++q) {
      const int a = xq.x0[q], z = xq.x1[q];
      if (z < a || w < a || w > z + k.Cp) continue;
      const T v = __ldcg(part + ((long long)(q * k.Cp + w) * S + t) * B + b);
      m = v > m ? v : m;
    }
    ep[((long long)w * S + t) * B + b] = m;
  }
  if (threadIdx.x == 0) done[b] = 0;
}

// ---- K3, fused: one block per (read, range of x) of column j.  kDev:
// the layout in the block's slice of the workspace ws
template <typename T, bool kDev>
__global__ void __launch_bounds__(kEpThreads)
ep_fwd_kernel(DPDims D, EpXRanges xq, EpIdx ix, const T* P, const T* LL,
              const T* emisA, const T* emisB, const T* eSZg,
              const T* spec_il, const T* lam, const int* dcum, const int* Cb,
              T* rowmax, T* shift, T* part, unsigned char* ws) {
  extern __shared__ __align__(16) unsigned char ep_smem[];
  EpBlock<T, T> k;
  k.init(D, Cb, blockIdx.x);
  const int xr = blockIdx.y, S = k.S, B = k.B, W1 = k.W1, b = k.b;
  const int C1 = k.C1;
  const EpFwdLayout lay(S, k.NA, C1);
  T* sm = reinterpret_cast<T*>(
      ep_base<kDev>(ep_smem, ws, lay.total * (long long)sizeof(T)));
  k.exP = sm + lay.exP;
  k.exL3 = sm + lay.exL3;
  k.LL = LL;
  k.szg = eSZg;
  k.mAB = sm + lay.mAB;
  k.Tm = sm + lay.Tm;
  k.Wm = sm + lay.Wm;
  k.Vm = sm + lay.Vm;
  T* out = sm + lay.out;   // ring [C1][S]: width w at slot w % C1
  T* red = sm + lay.red;   // [4][kEpThreads]

  // row j's maxima of P (all widths) and of LL (widths <= Cp), and the
  // maxima of the earlier rows of the windows (P rows j-Cp..j-1, LL rows
  // j-Wp..j-1: rowmax [2, R, B]), reduced over the block
  T m[4] = {ninf<T>(), ninf<T>(), ninf<T>(), ninf<T>()};
  for (int i = threadIdx.x; i < W1 * S; i += blockDim.x) {
    const int w = i / S, s = i % S;
    m[0] = fmax(m[0], P[TIDX(k.r, w, s, b)]);
    if (w < k.C1) m[1] = fmax(m[1], LL[TIDX(k.r, w, s, b)]);
  }
  for (int d = 1 + threadIdx.x; d <= k.Cp; d += blockDim.x)
    m[2] = fmax(m[2], rowmax[(long long)(k.r - d) * B + b]);
  for (int d = 1 + threadIdx.x; d <= k.Wp; d += blockDim.x)
    m[3] = fmax(m[3], rowmax[((long long)k.R + k.r - d) * B + b]);
  for (int q = 0; q < 4; ++q) red[q * blockDim.x + threadIdx.x] = m[q];
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h)
      for (int q = 0; q < 4; ++q)
        red[q * blockDim.x + threadIdx.x] =
            fmax(red[q * blockDim.x + threadIdx.x],
                 red[q * blockDim.x + threadIdx.x + h]);
    __syncthreads();
  }
  for (int q = 0; q < 4; ++q) m[q] = red[q * blockDim.x];
  __syncthreads();
  const T mp = fmax(m[0], m[2]), ml = fmax(m[1], m[3]);
  k.mPF = finite_or_zero(mp);
  k.mL3 = finite_or_zero(m[1]);
  k.mLB = finite_or_zero(ml);
  if (xr == 0 && threadIdx.x == 0) {
    rowmax[(long long)k.r * B + b] = m[0];
    rowmax[((long long)k.R + k.r) * B + b] = m[1];
    shift[((long long)k.j * 3 + 0) * B + b] = k.mPF;
    shift[((long long)k.j * 3 + 1) * B + b] = k.mL3;
    shift[((long long)k.j * 3 + 2) * B + b] = k.mLB;
  }
  ep_stage_l3(k, LL, dcum);
  for (int i = threadIdx.x; i < C1 * S; i += blockDim.x) out[i] = (T)0;
  // the block's partial of width w (the ring's row, then zero)
  T* pb = part + (long long)xr * W1 * S * B + b;
  auto flush = [&](int w) {
    T* o = out + (w % C1) * S;
    for (int t = threadIdx.x; t < S; t += blockDim.x) {
      pb[((long long)w * S + t) * B] = o[t];
      o[t] = (T)0;
    }
  };
  // the widths this block's x reach are x0..wend; the others hold 0
  const int x0 = xq.x0[xr], x1 = xq.x1[xr];
  const int wend = x1 < x0 ? -1 : (x1 + k.Cp < k.Wp ? x1 + k.Cp : k.Wp);
  for (int i = threadIdx.x; i < W1 * S; i += blockDim.x)
    if (i / S < x0 || i / S > wend) pb[(long long)i * B] = (T)0;
  __syncthreads();
  for (int x = x0; x <= x1; ++x) {
    const int umax = k.Cp < k.Wp - x ? k.Cp : k.Wp - x;
    const int xs = x % C1;
    if (x > x0) flush(x - 1);   // no later x reaches width x - 1
    ep_stage_x(k, x, P, emisA, emisB);
    __syncthreads();
    ep_form_tw(k, x, ix, spec_il, lam);
    __syncthreads();
    ep_form_v(k, x);
    __syncthreads();
    // out[x + u1, t] += sum over K2 entries k of t of exLB * V
    for (int i = threadIdx.x; i < (umax + 1) * S; i += blockDim.x) {
      const int u1 = i / S, t = i % S;
      if (k.fix_rss && !left_dots(dcum, k.j, x, u1, B, b)) continue;
      T acc = (T)0;
      for (int kk = ix.k2_off[t]; kk < ix.k2_off[t + 1]; ++kk) {
        const int e = ix.k2_idx[kk];
        const T v = k.V(ix.k2_bu[e], u1, ix.k2_ar[e]);
        if (v != (T)0) acc += k.exB(x, u1, ix.k2_s2[e]) * v;
      }
      out[ring_slot(xs, u1, C1) * S + t] += acc;
    }
    __syncthreads();
  }
  for (int w = x1; w <= wend; ++w) flush(w);
}

// ---- K3: ep[j, w, t] = log(sum of the blocks' partials) + shifts
template <typename T>
__global__ void ep_fwd_red_kernel(DPDims D, const T* part, const T* shift,
                                  T* ep) {
  const int S = D.S, B = D.B, W1 = D.Wp + 1;
  const long long n = (long long)W1 * S * B;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int b = idx % B;
  T s = (T)0;
  for (int xr = 0; xr < kEpXSplit; ++xr) s += part[xr * n + idx];
  const T* sh = shift + (long long)D.j * 3 * B + b;
  ep[(long long)(D.j + D.PAD) * n + idx] =
      safe_log_shift(s, sh[0] + sh[B] + sh[2 * B]);
}

static const int kThreads = 256;

// K3 with its layout in shared memory, or (ws not null: the plan's
// device variant) in ws, B x kEpXSplit slices of ep_ws_stride(layout)
template <typename T>
static int ep_fwd(DPDims D, EpIdx ix, const T* P, const T* LL,
                  const T* emisA, const T* emisB, const T* eSZg,
                  const T* spec_il, const T* lam, const int* dcum,
                  const int* Cb, T* rowmax, T* shift, T* part,
                  unsigned char* ws, cudaStream_t st) {
  const long long smem =
      ws ? 0 : EpFwdLayout(D.S, D.n_ar, D.Cp + 1).total * sizeof(T);
  auto kern = ws ? ep_fwd_kernel<T, true> : ep_fwd_kernel<T, false>;
  int rc = allow_smem((const void*)kern, smem);
  if (rc) return rc;
  dim3 grid(D.B, kEpXSplit);
  kern<<<grid, kEpThreads, smem, st>>>(
      D, ep_x_ranges(D.Wp, D.Cp), ix, P, LL, emisA, emisB, eSZg, spec_il,
      lam, dcum, Cb, rowmax, shift, part, ws);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int ep_fwd_red(DPDims D, const T* part, const T* shift, T* ep,
                      cudaStream_t st) {
  const long long n = (long long)(D.Wp + 1) * D.S * D.B;
  ep_fwd_red_kernel<T><<<ceil_div(n, kThreads), kThreads, 0, st>>>(
      D, part, shift, ep);
  return static_cast<int>(cudaGetLastError());
}

// K11's ranges of x for a batch of B reads: the blocks the device holds
// at once (its SMs times the blocks of this size an SM holds), divided
// among the reads and rounded down, so that the grid is one wave (a
// partial second wave costs a whole block's walk); at least kEpMaxMinSplit
// and at most kEpMaxSplit per read
static const int kEpMaxMinSplit = 1;

template <typename T>
static int ep_max_ranges(const DPDims& D, bool dev) {
  const long long smem =
      dev ? 0 : EpMaxLayout(D.S, D.n_ar, D.Cp + 1).total * sizeof(T);
  auto kern = dev ? ep_max_kernel<T, true> : ep_max_kernel<T, false>;
  int per_sm = 1;
  if (allow_smem((const void*)kern, smem) != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kern, kEpMaxThreads, (size_t)smem) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  const int n = D.B > 0 ? per_sm * device_sms() / D.B : kEpMaxSplit;
  return n < kEpMaxMinSplit ? kEpMaxMinSplit
                            : (n > kEpMaxSplit ? kEpMaxSplit : n);
}

// K11 in shared memory, or (ws not null: the plan's device variant) in
// ws, B x ep_max_ranges(D, true) slices of ep_ws_stride(layout)
template <typename T>
static int ep_max(DPDims D, EpIdx ix, const T* P, const T* LL,
                  const T* misA, const T* misB, const T* SZg,
                  const T* spec_il, const T* lam, const int* dcum,
                  const int* Cb, T* part, int* done, T* ep,
                  unsigned char* ws, cudaStream_t st) {
  const long long smem =
      ws ? 0 : EpMaxLayout(D.S, D.n_ar, D.Cp + 1).total * sizeof(T);
  auto kern = ws ? ep_max_kernel<T, true> : ep_max_kernel<T, false>;
  int rc = allow_smem((const void*)kern, smem);
  if (rc) return rc;
  EpMaxRanges xq;
  xq.n = ep_max_ranges<T>(D, ws != nullptr);
  ep_split_x(D.Wp, D.Cp, xq.n, xq.x0, xq.x1);
  dim3 grid(D.B, xq.n);
  kern<<<grid, kEpMaxThreads, smem, st>>>(D, xq, ix, P, LL, misA, misB, SZg,
                                          spec_il, lam, dcum, Cb, part, done,
                                          ep, ws);
  return static_cast<int>(cudaGetLastError());
}

// K3: rnaelem_ep_fwd_<type>, rnaelem_ep_fwd_red_<type>; K11:
// rnaelem_ep_max_<type>
#define EP_EXPORTS(SUF, T)                                                   \
  RNAELEM_EXPORT int rnaelem_ep_fwd_##SUF(                                   \
      DPDims D, EpIdx ix, const T* P, const T* LL, const T* emisA,           \
      const T* emisB, const T* eSZg, const T* spec_il, const T* lam,         \
      const int* dcum, const int* Cb, T* rowmax, T* shift, T* part,          \
      unsigned char* ws, cudaStream_t st) {                                  \
    return ep_fwd<T>(D, ix, P, LL, emisA, emisB, eSZg, spec_il, lam, dcum,  \
                     Cb, rowmax, shift, part, ws, st);                       \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_fwd_red_##SUF(DPDims D, const T* part,       \
                                              const T* shift, T* ep,         \
                                              cudaStream_t st) {             \
    return ep_fwd_red<T>(D, part, shift, ep, st);                            \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_ep_max_##SUF(                                   \
      DPDims D, EpIdx ix, const T* P, const T* LL, const T* misA,            \
      const T* misB, const T* SZg, const T* spec_il, const T* lam,           \
      const int* dcum, const int* Cb, T* part, int* done, T* ep,             \
      unsigned char* ws, cudaStream_t st) {                                  \
    return ep_max<T>(D, ix, P, LL, misA, misB, SZg, spec_il, lam, dcum, Cb, \
                     part, done, ep, ws, st);                                \
  }

EP_EXPORTS(f32, float)
EP_EXPORTS(f64, double)

// dynamic shared memory of K3's, K6's and K11's fused blocks
// (ops/kernels.py ep_smem_bytes mirrors it): which 0 = K3 (ep_fwd), 1 = K6
// (ep_adj), 2 = K11 (ep_max)
RNAELEM_EXPORT long long rnaelem_ep_smem_bytes(int which, DPDims D,
                                               int itemsize) {
  if (which == 0)
    return EpFwdLayout(D.S, D.n_ar, D.Cp + 1).total * itemsize;
  if (which == 2)
    return EpMaxLayout(D.S, D.n_ar, D.Cp + 1).total * itemsize;
  return EpAdjLayout(D.S, D.n_ar, D.Cp + 1).bytes(itemsize);
}

// a device-variant block's slice of the workspace (ep_col.cuh
// ep_ws_stride; ops/kernels.ep_plan's block_bytes mirrors it)
RNAELEM_EXPORT long long rnaelem_ep_ws_bytes(int which, DPDims D,
                                             int itemsize) {
  return ep_ws_stride(rnaelem_ep_smem_bytes(which, D, itemsize));
}

// K11's ranges of x per read for the batch and grammar of D on the
// current device, for the shared (dev 0) or the device variant (the
// wrapper sizes the partial rows and the workspace by it)
RNAELEM_EXPORT int rnaelem_ep_max_ranges(DPDims D, int itemsize, int dev) {
  return itemsize == 8 ? ep_max_ranges<double>(D, dev != 0)
                       : ep_max_ranges<float>(D, dev != 0);
}
