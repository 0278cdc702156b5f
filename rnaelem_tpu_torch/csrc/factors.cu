// K14 and K15: the per-read factors of the DP (row C of the kernel table)
// and their adjoint into the per-read weights.
//
// Replaces (rnaelem_tpu, XLA-compiled jnp programs): model/joint.py
// effective_theta (:178-184), _diff_factors_single (:313-364) and the
// per-read constants of _const_factors_single, vmapped and moved
// batch-minor by factors / _to_batched / batch_factors /
// batch_factors_pr (:377-456); K15 is their reverse-mode derivative
// (jax.vjp through the vmap) into the per-read weights.
//
// K14 (factors_kernel), one launch per batch: from the per-read weights
// singles [B, n_single, 4] and pairs [B, n_pair, 6] (read through a batch
// stride, 0 for the shared weights' expanded copies), the read codes,
// positional weights, lengths and rss dots, and the grammar's slot and
// flag lists, it writes the differentiable factors eR, eL [Lp, S, B],
// bg2 [Lp, B], pv [Lp+1, Wp+1, Tp, B] and alphaP (zero), batch-minor, with
// theta_softmax's log-softmax, the no_theta rule (value 0, the gradient
// kept: K15 passes it through) and no_prf folded in, and the constants
// the score-table kernel K1 and the DP take: the codes int64 [B, Lp] and
// [Lp, B], the lengths int64, the running dot counts [B, Lp+1] and [Lp+1,
// B], the fix_rss gate, the internal-loop cap C and wsp.  Mode 1 writes
// eR alone (the no-rss chain's one input); mode 2 the masks pass's null
// factors (S = 1: zero emissions and wsp, lambda 1).
//
// K15 (factors_adj_kernel), one launch: from the cotangents of eR, eL,
// bg2 and pv (any may be absent), each read's cotangent of singles and
// pairs.  The emission lookups are one-hot contractions (exact: one
// product per cell), so each sum over a read's positions or pair cells
// follows ops/dp.read_sum's order (padded to a power of two, halves added
// elementwise: common.cuh tree_sum), and the per-state sums go to the
// states' slots in ascending state order, bg2's + eL's + eR's: the
// contraction is bitwise the plain version's (model/joint._OneHot and the
// index backward of singles[:, slot]), then the log-softmax's adjoint
// where theta_softmax applies.  Nothing is summed across reads, so a
// read's bits do not depend on the batch.
//
// Bound on the H100: bytes (a few kB of weights, the codes, and the
// factors written once: about 8.9 MB in f32 at B = 128 x 100 nt, S = 29,
// -w 50), and for B of a few hundred, launch latency.  Design: K14 one
// coalesced pass, a thread per output cell with the read fastest, in four
// index ranges of one grid (state cells, pair cells, position cells, and
// a warp per read for the running dot counts); K15 a block of 1024
// threads per group of RL reads (one 32-byte sector: 8 f32, 4 f64) and C
// columns, the read fastest so that every load of a batch-minor
// cotangent is a full sector, the eight sums of a state (eR and eL, four
// bases) in one pass of the columns' tree, a block per pair table beside
// the slots' block.
#include "common.cuh"

struct FacDims {
  int Lp, Wp, S, B, Tp, ns;  // ns: single tables of the weights
  int mode;                  // 0 the DP's factors, 1 eR alone, 2 null
  int theta_softmax, no_theta, no_prf, fix_rss;
  int turn, max_span, max_iloop;
  long long sbs, sbp;        // batch strides of singles, pairs (elements)
};

struct FacIdx {             // the grammar's lists (int32, [S])
  const int* slot_r;        // single table of each state's right node
  const int* slot_l;        // and left node (wrapped into 0..ns-1)
  const int* ws_r;          // 1: the state adds the positional weight
  const int* ws_l;
};

struct FacOut {             // K14's outputs (null: not written)
  void* eR;                 // [Lp, S, B]
  void* eL;                 // [Lp, S, B]
  void* bg2;                // [Lp, B]
  void* pv;                 // [Lp+1, Wp+1, Tp, B]
  void* alphaP;             // [Lp+1, Wp+1, B] zero
  void* lam;                // [2, B] one (mode 2)
  long long* seq64;         // [B, Lp]
  long long* seqT;          // [Lp, B]
  long long* L64;           // [B]
  int* dcum;                // [B, Lp+1]
  int* dcumT;               // [Lp+1, B]
  void* gate;               // [Lp, B] 0 / -inf (fix_rss)
  int* C;                   // [B]
  void* wsp;                // [Lp, B]
};

// pair types: 0 none, 1 CG, 2 GC, 3 GU, 4 UG, 5 AU, 6 UA (alphabet.py BP)
__constant__ int c_fac_bp[25] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 5, 0, 0, 0,
                                 1, 0, 0, 0, 2, 0, 3, 0, 6, 0, 4, 0};

static const int kFacThreads = 256;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// log-sum-exp of a weight row (ops/semiring.lse: the max, 0 where it is
// not finite, then log of the shifted exps' sum)
template <typename T, int K>
__device__ __forceinline__ T row_lse(const T* x) {
  T m = x[0];
  for (int k = 1; k < K; ++k) m = x[k] > m ? x[k] : m;
  m = finite_or_zero(m);
  T s = (T)0;
  for (int k = 0; k < K; ++k) s += ex(x[k] - m);
  return s > (T)0 ? lg(s) + m : ninf<T>();
}

// the effective table value of weight row x (K entries) at entry k
template <typename T, int K>
__device__ __forceinline__ T theta_of(const FacDims& D, const T* x, int k) {
  if (D.no_theta) return (T)0;
  return D.theta_softmax ? x[k] - row_lse<T, K>(x) : x[k];
}

// pair type of the pair cell (j, w) of read b: bases clip(j - w) and
// clip(j - 1)
__device__ __forceinline__ int pair_type(const int* seq, int Lp, int b, int j,
                                         int w) {
  const int i = clampi(j - w, 0, Lp - 1), jj = clampi(j - 1, 0, Lp - 1);
  const int a = seq[(long long)b * Lp + i], c = seq[(long long)b * Lp + jj];
  return c_fac_bp[clampi(a, 0, 4) * 5 + clampi(c, 0, 4)];
}

// ---- K14: one thread per output cell, four index ranges
template <typename T>
__global__ void __launch_bounds__(kFacThreads)
factors_kernel(FacDims D, FacIdx ix, const T* singles, const T* pairs,
               const int* seq, const double* ws, const int* L,
               const bool* dots, FacOut o, long long n1, long long n2,
               long long n3, long long n4pad, long long n4) {
  const int Lp = D.Lp, W1 = D.Wp + 1, S = D.S, B = D.B;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n1) {  // (p, s, b): eR and eL
    const int b = (int)(idx % B), s = (int)((idx / B) % S);
    const int p = (int)(idx / ((long long)B * S));
    const int code = seq[(long long)b * Lp + p];
    const T wsv = (T)ws[(long long)b * Lp + p];
    const int k = clampi(code - 1, 0, 3);
    const T* row = singles + b * D.sbs;
    T vr = (T)0, vl = (T)0;
    if (D.mode != 2 && !D.no_prf && code > 0) {
      vr = theta_of<T, 4>(D, row + 4 * ix.slot_r[s], k);
      vl = theta_of<T, 4>(D, row + 4 * ix.slot_l[s], k);
    }
    if (D.mode == 2) {
      static_cast<T*>(o.eR)[idx] = (T)0;
      static_cast<T*>(o.eL)[idx] = (T)0;
      return;
    }
    static_cast<T*>(o.eR)[idx] = vr + (ix.ws_r[s] ? wsv : (T)0);
    if (D.mode == 0)
      static_cast<T*>(o.eL)[idx] = vl + (ix.ws_l[s] ? wsv : (T)0);
    return;
  }
  idx -= n1;
  if (idx < n2) {  // (j, w, b): alphaP and pv at every table
    const int b = (int)(idx % B), w = (int)((idx / B) % W1);
    const int j = (int)(idx / ((long long)B * W1));
    static_cast<T*>(o.alphaP)[idx] = (T)0;
    const int bt = D.mode == 2 || D.no_prf ? 0 : pair_type(seq, Lp, b, j, w);
    const int k = clampi(bt - 1, 0, 5);
    T* pv = static_cast<T*>(o.pv) + ((long long)j * W1 + w) * D.Tp * B + b;
    for (int t = 0; t < D.Tp; ++t)
      pv[(long long)t * B] =
          bt > 0 ? theta_of<T, 6>(D, pairs + b * D.sbp + 6 * t, k) : (T)0;
    return;
  }
  idx -= n2;
  if (idx < n3) {  // (p, b): bg2, the codes, the gate and wsp
    const int b = (int)(idx % B), p = (int)(idx / B);
    const int code = seq[(long long)b * Lp + p];
    T bg = (T)0;
    if (D.mode != 2 && !D.no_prf && code > 0)
      bg = theta_of<T, 4>(D, singles + b * D.sbs, clampi(code - 1, 0, 3));
    static_cast<T*>(o.bg2)[idx] = bg;
    o.seqT[idx] = code;
    o.seq64[(long long)b * Lp + p] = code;
    static_cast<T*>(o.gate)[idx] =
        D.fix_rss && !dots[(long long)b * Lp + p] ? ninf<T>() : (T)0;
    static_cast<T*>(o.wsp)[idx] =
        D.mode == 2 ? (T)0 : (T)ws[(long long)b * Lp + p];
    return;
  }
  idx -= n3;
  // per read, one warp from a warp-aligned start (idx4 below): the
  // length, the cap C, and the running dot counts by a warp scan
  const long long idx4 = idx - n4pad;
  if (idx4 < 0 || idx4 >= n4) return;
  const int b = (int)(idx4 / 32), lane = (int)(idx4 % 32);
  int carry = 0;
  for (int p0 = 0; p0 < Lp; p0 += 32) {
    const int p = p0 + lane;
    int v = p < Lp && dots[(long long)b * Lp + p] ? 1 : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (p < Lp) {
      o.dcum[(long long)b * (Lp + 1) + p + 1] = carry + v;
      o.dcumT[(long long)(p + 1) * B + b] = carry + v;
    }
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
  if (lane != 0) return;
  o.dcum[(long long)b * (Lp + 1)] = 0;
  o.dcumT[b] = 0;
  const long long Lb = L[b];
  o.L64[b] = Lb;
  const long long W = Lb < D.max_span ? Lb : D.max_span;
  const long long Cb = W - 2 - (D.turn == 0 ? 2 : 5);
  o.C[b] = (int)(Cb < D.max_iloop ? Cb : D.max_iloop);
  if (D.mode == 2) {
    static_cast<T*>(o.lam)[b] = (T)1;
    static_cast<T*>(o.lam)[B + b] = (T)1;
  }
}

// the log-softmax's adjoint at weight row x (K entries) for the
// cotangent g of its output (autograd's g + (-sum g / s) e)
template <typename T, int K>
__device__ __forceinline__ void softmax_adj(const T* x, T g[K]) {
  T m = x[0];
  for (int k = 1; k < K; ++k) m = x[k] > m ? x[k] : m;
  m = finite_or_zero(m);
  T s = (T)0, sg = (T)0;
  for (int k = 0; k < K; ++k) {
    s += ex(x[k] - m);
    sg += -g[k];
  }
  const T gs = s > (T)0 ? sg / s : (T)0;
  for (int k = 0; k < K; ++k) g[k] = g[k] + gs * ex(x[k] - m);
}

struct FacAdjArgs {
  const void* geR;   // [Lp, S, B] or null
  const void* geL;   // [Lp, S, B] or null
  const void* gbg2;  // [Lp, B] or null
  const void* gpv;   // [Lp+1, Wp+1, Tp, B] or null
  void* gs;          // [B, ns, 4]
  void* gp;          // [B, Tp, 6] (pairs blocks only)
};

// ---- K15: block (group, 0) the slots of a group of RL reads, block
// (group, 1 + t) pair table t
template <typename T, int RL, int C>
__global__ void __launch_bounds__(RL * C)
factors_adj_kernel(FacDims D, FacIdx ix, const T* singles, const T* pairs,
                   const int* seq, FacAdjArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);  // [8][C][RL]
  const int Lp = D.Lp, W1 = D.Wp + 1, S = D.S, B = D.B, ns = D.ns;
  const int r = threadIdx.x % RL, c = threadIdx.x / RL;
  const int b = blockIdx.x * RL + r;
  const bool live = b < B;
  if (blockIdx.y == 0) {
    T* accL = red + 8 * C * RL;    // [ns][4][RL] the slots' eL sums
    T* accR = accL + ns * 4 * RL;  // and eR's
    for (int i = threadIdx.x; i < 2 * ns * 4 * RL; i += blockDim.x)
      accL[i] = (T)0;
    const T* g3[3] = {static_cast<const T*>(a.geR),
                      static_cast<const T*>(a.geL),
                      static_cast<const T*>(a.gbg2)};
    // the one-hot product of read b's position p at base k for cotangent
    // g3[which] ([Lp, S, B], or bg2's [Lp, B] at s = 0; null: zero)
    auto term = [&](int which, long long p, int s, int k) -> T {
      const T* g = g3[which];
      const int code = live ? seq[(long long)b * Lp + p] : 0;
      const long long at = (p * (which == 2 ? 1 : S) + s) * B + b;
      const T gv = live && g && code > 0 ? g[at] : (T)0;
      return (k == clampi(code - 1, 0, 3) ? (T)1 : (T)0) * gv;
    };
    const TreeShape t(Lp, C);
    __syncthreads();
    for (int s = 0; s < S; ++s) {
      T loc[8], sum[8];
#pragma unroll
      for (int v = 0; v < 8; ++v)
        loc[v] = tree_local<T>(t, Lp, c, [&](long long p) -> T {
          return term(v / 4, p, s, v % 4);
        });
      tree_cols<T, 8, RL, C>(t, loc, red, sum);
      if (c == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          T* ar = accR + (ix.slot_r[s] * 4 + k) * RL + r;
          T* al = accL + (ix.slot_l[s] * 4 + k) * RL + r;
          *ar = *ar + sum[k];
          *al = *al + sum[4 + k];
        }
      }
    }
    T loc[4], bg[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      loc[k] = tree_local<T>(t, Lp, c, [&](long long p) -> T {
        return term(2, p, 0, k);
      });
    tree_cols<T, 4, RL, C>(t, loc, red, bg);
    if (!live) return;
    T* gs = static_cast<T*>(a.gs) + (long long)b * ns * 4;
    for (int u = c; u < ns; u += C) {
      T g[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        g[k] = ((u == 0 ? bg[k] : (T)0) + accL[(u * 4 + k) * RL + r]) +
               accR[(u * 4 + k) * RL + r];
      if (D.theta_softmax) softmax_adj<T, 4>(singles + b * D.sbs + 4 * u, g);
#pragma unroll
      for (int k = 0; k < 4; ++k) gs[u * 4 + k] = g[k];
    }
    return;
  }
  const int t = blockIdx.y - 1;
  const T* gpv = static_cast<const T*>(a.gpv);
  const long long n = (long long)(Lp + 1) * W1;
  const TreeShape ts(n, C);
  T loc[6], sum[6];
#pragma unroll
  for (int k = 0; k < 6; ++k)
    loc[k] = tree_local<T>(ts, n, c, [&](long long i) -> T {
      const int j = (int)(i / W1), w = (int)(i % W1);
      const int bt = live ? pair_type(seq, Lp, b, j, w) : 0;
      const T g = live && gpv && bt > 0
                      ? gpv[(((long long)j * W1 + w) * D.Tp + t) * B + b]
                      : (T)0;
      return (k == clampi(bt - 1, 0, 5) ? (T)1 : (T)0) * g;
    });
  tree_cols<T, 6, RL, C>(ts, loc, red, sum);
  if (!live || c != 0) return;
  if (D.theta_softmax) softmax_adj<T, 6>(pairs + b * D.sbp + 6 * t, sum);
  T* gp = static_cast<T*>(a.gp) + ((long long)b * D.Tp + t) * 6;
#pragma unroll
  for (int k = 0; k < 6; ++k) gp[k] = sum[k];
}

template <typename T>
static int factors(FacDims D, FacIdx ix, const T* singles, const T* pairs,
                   const int* seq, const double* ws, const int* L,
                   const bool* dots, FacOut o, cudaStream_t st) {
  const long long n1 = (long long)D.Lp * D.S * D.B;
  const long long n2 = D.mode == 1 ? 0 : (long long)(D.Lp + 1) * (D.Wp + 1) *
                                             D.B;
  const long long n3 = D.mode == 1 ? 0 : (long long)D.Lp * D.B;
  // the per-read range starts on a warp boundary, a warp per read
  const long long n4pad = (32 - (n1 + n2 + n3) % 32) % 32;
  const long long n4 = D.mode == 1 ? 0 : 32LL * D.B;
  const long long blocks =
      (n1 + n2 + n3 + n4pad + n4 + kFacThreads - 1) / kFacThreads;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  factors_kernel<T><<<(int)blocks, kFacThreads, 0, st>>>(
      D, ix, singles, pairs, seq, ws, L, dots, o, n1, n2, n3, n4pad, n4);
  return static_cast<int>(cudaGetLastError());
}

// reads per K15 block: one 32-byte sector of a batch-minor row
template <typename T>
struct FacAdjShape {
  static const int RL = 32 / sizeof(T), C = 1024 / RL;
};

template <typename T>
static long long factors_adj_smem(int ns) {
  using Sh = FacAdjShape<T>;
  return (8LL * Sh::C * Sh::RL + 2LL * ns * 4 * Sh::RL) * sizeof(T);
}

template <typename T>
static int factors_adj(FacDims D, FacIdx ix, const T* singles,
                       const T* pairs, const int* seq, FacAdjArgs a,
                       int pair_blocks, cudaStream_t st) {
  using Sh = FacAdjShape<T>;
  auto kern = factors_adj_kernel<T, Sh::RL, Sh::C>;
  const long long bytes = factors_adj_smem<T>(D.ns);
  const int rc = allow_smem((const void*)kern, bytes);
  if (rc) return rc;
  const dim3 grid((D.B + Sh::RL - 1) / Sh::RL, 1 + pair_blocks);
  kern<<<grid, Sh::RL * Sh::C, bytes, st>>>(D, ix, singles, pairs, seq, a);
  return static_cast<int>(cudaGetLastError());
}

#define FACTORS_EXPORTS(SUF, T)                                              \
  RNAELEM_EXPORT int rnaelem_factors_##SUF(                                  \
      FacDims D, FacIdx ix, FacOut o, const T* singles, const T* pairs,      \
      const int* seq, const double* ws, const int* L, const bool* dots,      \
      cudaStream_t st) {                                                     \
    return factors<T>(D, ix, singles, pairs, seq, ws, L, dots, o, st);       \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_factors_adj_##SUF(                              \
      FacDims D, FacIdx ix, FacAdjArgs a, const T* singles, const T* pairs,  \
      const int* seq, int pair_blocks, cudaStream_t st) {                    \
    return factors_adj<T>(D, ix, singles, pairs, seq, a, pair_blocks, st);   \
  }

FACTORS_EXPORTS(f32, float)
FACTORS_EXPORTS(f64, double)
