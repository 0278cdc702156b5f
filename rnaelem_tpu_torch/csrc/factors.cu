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
// elementwise: common.cuh tree_walk, block_tree), and the per-state sums
// go to the states' slots in ascending state order, bg2's + eL's + eR's:
// the contraction is bitwise the plain version's (model/joint._OneHot
// and the index backward of singles[:, slot]), then the log-softmax's
// adjoint where theta_softmax applies.  Nothing is summed across reads,
// so a read's bits do not depend on the batch or on the split.
//
// Bound on the H100: bytes (a few kB of weights, the codes, and the
// factors written once: about 8.9 MB in f32 at B = 128 x 100 nt, S = 29,
// -w 50), and for B of a few hundred, launch latency.  Design: K14 one
// coalesced pass on the host plan's layout (ops/kernels.factors_plan): a
// block takes a group of G reads (a 128-byte line of a float plane: 32
// f32 or 16 f64 reads) and a tile of P positions (P values of j for the
// pair cells) of one of three index ranges, (position, state) rows of eR
// and eL, (j, w) rows of pv and alphaP, position rows of bg2, the codes,
// the gate and wsp; one more block per group writes the running dot
// counts and the per-read constants.  The block first stages its reads'
// codes, positional weights and dots batch-fastest in shared memory (each
// read's run of positions loaded in one coalesced pass) and builds its
// reads' effective weight rows there, each single row (4 entries) and
// pair row (6) softmaxed once per block with the same arithmetic, so
// every output keeps its bits; then TY rows x TX threads along the reads,
// V reads a thread (16-byte stores where B and the pointers allow it),
// write whole rows of B values with 32-bit offsets inside the block from
// a 64-bit base and no division per value.  K15 spreads a read's sums
// over blocks of 8 warps, each warp a row of RL reads (one 32-byte
// sector) x 32 / RL columns, the reads' codes staged in shared memory:
// the state blocks take a state a warp (its eight sums, eR's and eL's at
// the four bases, one load of each cotangent cell per position, the
// columns' levels by shuffles) and bg2 in one more warp; K pair blocks
// per pair table take a residue class of K of its cells each (K from the
// host plan, ops/kernels.factors_adj_plan).  Each writes its sums to a
// workspace; the group's last block (a counter) halves the pair slices
// and adds the states' sums into the slots.
#include "common.cuh"

struct FacDims {
  int Lp, Wp, S, B, Tp, ns;  // ns: single tables of the weights
  int mode;                  // 0 the DP's factors, 1 eR alone, 2 null
  int theta_softmax, no_theta, no_prf, fix_rss;
  int turn, max_span, max_iloop;
  long long sbs, sbp;        // batch strides of singles, pairs (elements)
};

struct FacIdx {             // the grammar's lists (int32)
  const int* slot_r;        // [S] single table of each state's right node
  const int* slot_l;        // and left node (wrapped into 0..ns-1)
  const int* ws_r;          // [S] 1: the state adds the positional weight
  const int* ws_l;
  const int* rs_off;        // [ns+1] each slot's states (right nodes) in
  const int* rs_s;          // [S] ascending order: rs_s[rs_off[u]..]
  const int* ls_off;        // the same for the left nodes
  const int* ls_s;
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

// K15's one-hot rows, literal: the base of codes 0..4 (clip(code - 1, 0,
// 3)), then the index of pair types 0..6 (clip(bt - 1, 0, 5)).  Not
// computed as (k == clampi(x - 1, 0, hi)): the sm_90a build at -O3 takes
// that compare at k == hi from the predicate of the clamp's VIMNMX.RELU,
// which the card sets for every x >= 1 (the PTX is right, and ptxas -O0
// is exact), so base 3 took every base's term; csrc/repro/onehot_select.cu
// reproduces it alone (chip_smoke.py --onehot-repro)
__constant__ int c_fac_onehot[62] = {
    1, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1,
    1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0,
    0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1};

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

// K14's layout (ops/kernels.factors_plan): G = TX V reads a group (the
// grid's y), a block TY rows x TX threads, V reads a thread; tiles of P
// positions (a power of two) in the grid's x: n1 tiles of (position,
// state) rows, n2 of (j, w) rows, n3 of position rows, n4 = 1 block of
// the group's running dot counts and constants (mode 1 launches the n1
// tiles alone); smem the dynamic bytes
struct FacGrid {
  int V, TX, TY, G, P, n1, n2, n3, n4, groups, smem;
};

// K14's dynamic shared memory: the single rows [4 ns][G] and pair rows
// [6 Tp][G] of the block's reads, their positional weights [P][G], their
// codes over the widest window [P + Wp + 1][G], the scan's tile [32][G]
// and the dots [P][G] (bytes)
template <typename T>
static long long factors_smem(const FacDims& D, int G, int P) {
  return (long long)sizeof(T) * G * (4LL * D.ns + 6LL * D.Tp + P) +
         4LL * G * (P + D.Wp + 1) + 4LL * 32 * G + (long long)G * P;
}

// V values of a row in one access (16 bytes when V > 1)
template <typename T, int V>
struct alignas(sizeof(T) * V) FacVec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void fac_st(T* p, const FacVec<T, V>& x) {
  *reinterpret_cast<FacVec<T, V>*>(p) = x;
}

// V int64 values, 16 bytes at a time where V > 1
template <int V>
__device__ __forceinline__ void fac_st_i64(long long* p, const int* c) {
  if constexpr (V == 1) {
    p[0] = c[0];
  } else {
#pragma unroll
    for (int h = 0; h < V; h += 2)
      fac_st<long long, 2>(p + h, FacVec<long long, 2>{{c[h], c[h + 1]}});
  }
}

// the block's reads' effective weight rows (model/joint.effective_theta:
// 0 under no_theta, else the log-softmax of the row where theta_softmax
// applies, row_lse once per row): th[(u K + k) G + r] for rows u < n of
// the per-read weights w (batch stride sb) of read b0 + r
template <typename T, int K>
__device__ __forceinline__ void fac_theta(const FacDims& D, const T* w,
                                          long long sb, int n, int b0,
                                          int nb, int G, int lgG, T* th) {
  for (int e = threadIdx.y * blockDim.x + threadIdx.x; e < n * G;
       e += kFacThreads) {
    const int u = e >> lgG, r = e & (G - 1);
    if (r >= nb) continue;
    const T* x = w + (long long)(b0 + r) * sb + K * u;
    const T lse = D.theta_softmax && !D.no_theta ? row_lse<T, K>(x) : (T)0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      th[(u * K + k) * G + r] = D.no_theta ? (T)0
                                : D.theta_softmax ? x[k] - lse : x[k];
  }
}

// K14's block of per-read values for the group's reads b0 .. b0 + nb - 1:
// the running dot counts, a warp a read and its lanes along the positions
// (a warp scan, a read's run of positions one coalesced load), 32
// positions at a time through the tile so that dcum [B, Lp+1] and dcumT
// [Lp+1, B] are both written coalesced; then the lengths, the cap C and
// the masks pass's lambda
template <typename T>
__device__ __forceinline__ void fac_scan(const FacDims& D, const FacGrid& g,
                                         const bool* dots, const int* L,
                                         const FacOut& o, int b0, int nb,
                                         int lgG, int* tile) {
  const int Lp = D.Lp, B = D.B, G = g.G;
  const int tid = threadIdx.y * g.TX + threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  constexpr int kW = kFacThreads / 32, kRPW = 32 / kW;  // reads a warp
  int carry[kRPW];
#pragma unroll
  for (int k = 0; k < kRPW; ++k) carry[k] = 0;
  for (int p0 = 0; p0 < Lp; p0 += 32) {
    const int p = p0 + lane;
#pragma unroll
    for (int k = 0; k < kRPW; ++k) {
      const int r = warp + kW * k;
      if (r >= nb) continue;  // the warp's condition
      int v = p < Lp && dots[(long long)(b0 + r) * Lp + p] ? 1 : 0;
      for (int h = 1; h < 32; h <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, v, h);
        if (lane >= h) v += y;
      }
      tile[lane * G + r] = carry[k] + v;
      if (p < Lp)
        o.dcum[(long long)(b0 + r) * (Lp + 1) + p + 1] = carry[k] + v;
      carry[k] += __shfl_sync(0xffffffffu, v, 31);
    }
    __syncthreads();
    for (int e = tid; e < 32 * G; e += kFacThreads) {
      const int q = e >> lgG, r = e & (G - 1);
      if (r < nb && p0 + q < Lp)
        o.dcumT[(long long)(p0 + q + 1) * B + b0 + r] = tile[q * G + r];
    }
    __syncthreads();
  }
  if (tid >= nb) return;
  const int b = b0 + tid;
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

// ---- K14: block (tile of one range, group of G reads), thread (row, V
// reads)
template <typename T, int V>
__global__ void __launch_bounds__(kFacThreads)
factors_kernel(FacDims D, FacIdx ix, const T* singles, const T* pairs,
               const int* seq, const double* ws, const int* L,
               const bool* dots, FacOut o, FacGrid g) {
  extern __shared__ __align__(16) unsigned char fac_smem[];
  __shared__ int s_bp[25];
  const int Lp = D.Lp, W1 = D.Wp + 1, S = D.S, B = D.B, G = g.G, P = g.P;
  const int lgG = __ffs(G) - 1, lgP = __ffs(P) - 1;
  const int tid = threadIdx.y * g.TX + threadIdx.x;
  const int ty = threadIdx.y, r0 = threadIdx.x * V;
  const int b0 = blockIdx.y * G, nb = min(G, B - b0);
  const bool prf = D.mode != 2 && !D.no_prf;  // the emissions are not 0
  T* thS = reinterpret_cast<T*>(fac_smem);    // [4 ns][G]
  T* thP = thS + 4 * D.ns * G;                // [6 Tp][G]
  T* wsS = thP + 6 * D.Tp * G;                // [P][G]
  int* cs = reinterpret_cast<int*>(wsS + P * G);  // [P + Wp + 1][G]
  int* tile = cs + (P + W1) * G;              // [32][G]
  unsigned char* ds = reinterpret_cast<unsigned char*>(tile + 32 * G);
  if (tid < 25) s_bp[tid] = c_fac_bp[tid];
  int rb = blockIdx.x;

  // stage the codes, the weights (and the dots) of positions p0 .. p0 +
  // np - 1, each read's run of positions contiguous in the loads
  auto stage = [&](int p0, int np, bool with_dots) {
    for (int e = tid; e < G * P; e += kFacThreads) {
      const int r = e >> lgP, pp = e & (P - 1);
      if (r >= nb || pp >= np) continue;
      const long long at = (long long)(b0 + r) * Lp + p0 + pp;
      cs[pp * G + r] = seq[at];
      wsS[pp * G + r] = (T)ws[at];
      if (with_dots) ds[pp * G + r] = dots[at] ? 1 : 0;
    }
  };
  if (rb < g.n1) {  // (p, s): eR and eL
    const int p0 = rb * P, np = min(P, Lp - p0);
    stage(p0, np, false);
    if (prf)
      fac_theta<T, 4>(D, singles, D.sbs, D.ns, b0, nb, G, lgG, thS);
    __syncthreads();
    if (r0 >= nb) return;
    const long long base = (long long)p0 * S * B + b0 + r0;
    T* eR = static_cast<T*>(o.eR) + base;
    T* eL = static_cast<T*>(o.eL) + base;
    int pp = ty / S, s = ty - pp * S;
    for (; pp < np;) {
      const int ur = __ldg(ix.slot_r + s), ul = __ldg(ix.slot_l + s);
      const bool wr = __ldg(ix.ws_r + s) != 0, wl = __ldg(ix.ws_l + s) != 0;
      FacVec<T, V> yr, yl;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int r = r0 + v, code = cs[pp * G + r];
        const int k = clampi(code - 1, 0, 3);
        const T wsv = wsS[pp * G + r];
        T vr = (T)0, vl = (T)0;
        if (prf && code > 0) {
          vr = thS[(ur * 4 + k) * G + r];
          vl = thS[(ul * 4 + k) * G + r];
        }
        yr.v[v] = D.mode == 2 ? (T)0 : vr + (wr ? wsv : (T)0);
        yl.v[v] = D.mode == 2 ? (T)0 : vl + (wl ? wsv : (T)0);
      }
      const int off = (pp * S + s) * B;
      fac_st<T, V>(eR + off, yr);
      if (D.mode != 1) fac_st<T, V>(eL + off, yl);
      s += g.TY;
      while (s >= S) {
        s -= S;
        ++pp;
      }
    }
    return;
  }
  rb -= g.n1;
  if (rb < g.n2) {  // (j, w): alphaP and pv at every table
    const int j0 = rb * P, nj = min(P, Lp + 1 - j0);
    const int lo = clampi(j0 - max(D.Wp, 1), 0, Lp - 1);
    const int nc = clampi(j0 + nj - 1, 0, Lp - 1) - lo + 1;
    if (prf) {
      const int warp = tid >> 5, lane = tid & 31;
      for (int r = warp; r < nb; r += kFacThreads / 32)
        for (int q = lane; q < nc; q += 32)
          cs[q * G + r] = seq[(long long)(b0 + r) * Lp + lo + q];
      fac_theta<T, 6>(D, pairs, D.sbp, D.Tp, b0, nb, G, lgG, thP);
    }
    __syncthreads();
    if (r0 >= nb) return;
    T* aP = static_cast<T*>(o.alphaP) + (long long)j0 * W1 * B + b0 + r0;
    T* pv = static_cast<T*>(o.pv) + (long long)j0 * W1 * D.Tp * B + b0 + r0;
    int jj = ty / W1, w = ty - jj * W1;
    FacVec<T, V> zero;
#pragma unroll
    for (int v = 0; v < V; ++v) zero.v[v] = (T)0;
    for (; jj < nj;) {
      const int j = j0 + jj;
      int bt[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        bt[v] = 0;
        if (prf) {
          const int r = r0 + v;
          const int a = cs[(clampi(j - w, 0, Lp - 1) - lo) * G + r];
          const int c = cs[(clampi(j - 1, 0, Lp - 1) - lo) * G + r];
          bt[v] = s_bp[clampi(a, 0, 4) * 5 + clampi(c, 0, 4)];
        }
      }
      const int cell = jj * W1 + w;
      fac_st<T, V>(aP + cell * B, zero);
      for (int t = 0; t < D.Tp; ++t) {
        FacVec<T, V> y;
#pragma unroll
        for (int v = 0; v < V; ++v)
          y.v[v] = bt[v] > 0
                       ? thP[(t * 6 + clampi(bt[v] - 1, 0, 5)) * G + r0 + v]
                       : (T)0;
        fac_st<T, V>(pv + (cell * D.Tp + t) * B, y);
      }
      w += g.TY;
      while (w >= W1) {
        w -= W1;
        ++jj;
      }
    }
    return;
  }
  rb -= g.n2;
  if (rb < g.n3) {  // (p, b): bg2, the codes, the gate and wsp
    const int p0 = rb * P, np = min(P, Lp - p0);
    stage(p0, np, true);
    if (prf) fac_theta<T, 4>(D, singles, D.sbs, 1, b0, nb, G, lgG, thS);
    __syncthreads();
    // the codes [B, Lp], each read's run of positions contiguous
    for (int e = tid; e < G * P; e += kFacThreads) {
      const int r = e >> lgP, pp = e & (P - 1);
      if (r < nb && pp < np)
        o.seq64[(long long)(b0 + r) * Lp + p0 + pp] = cs[pp * G + r];
    }
    if (r0 >= nb) return;
    const long long base = (long long)p0 * B + b0 + r0;
    for (int pp = ty; pp < np; pp += g.TY) {
      FacVec<T, V> bg, gt, wp;
      int code[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int r = r0 + v;
        code[v] = cs[pp * G + r];
        bg.v[v] = prf && code[v] > 0
                      ? thS[clampi(code[v] - 1, 0, 3) * G + r] : (T)0;
        gt.v[v] = D.fix_rss && !ds[pp * G + r] ? ninf<T>() : (T)0;
        wp.v[v] = D.mode == 2 ? (T)0 : wsS[pp * G + r];
      }
      const int off = pp * B;
      fac_st<T, V>(static_cast<T*>(o.bg2) + base + off, bg);
      fac_st_i64<V>(o.seqT + base + off, code);
      fac_st<T, V>(static_cast<T*>(o.gate) + base + off, gt);
      fac_st<T, V>(static_cast<T*>(o.wsp) + base + off, wp);
    }
    return;
  }
  fac_scan<T>(D, g, dots, L, o, b0, nb, lgG, tile);
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
  void* gp;          // [B, Tp, 6] (pair blocks only)
  void* ws;          // the blocks' sums: [S+1][8][B], then [Tp][Kp][6][B]
  int* done;         // [read groups] finished blocks (the last resets it)
};

// K15's block: 8 warps, each a row of RL reads (one 32-byte sector) x CW
// columns; the reads' codes staged in shared memory [RL][Lp]
template <typename T>
struct FacAdjShape {
  static const int RL = 32 / sizeof(T), NT = 256, NWARP = NT / 32;
};
static const int kFinBatch = 8;  // states whose sums a finish thread loads
                                 // together

// ---- K15: block (group g of RL reads, y).  y < n_sc: warp w takes the
// task y * NWARP + w: state s < S (eR's and eL's sums at the four bases),
// s == S (bg2's four sums); y >= n_sc: slice k of Kp of pair table t.
// The group's last block adds the states' sums into the slots and halves
// the pair slices (the finish).
template <typename T>
__global__ void __launch_bounds__(FacAdjShape<T>::NT)
factors_adj_kernel(FacDims D, FacIdx ix, const T* singles, const T* pairs,
                   const int* seq, FacAdjArgs a, int pair_blocks, int Kp) {
  constexpr int RL = FacAdjShape<T>::RL, NT = FacAdjShape<T>::NT;
  constexpr int NWARP = FacAdjShape<T>::NWARP, C = NT / RL, CW = 32 / RL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);          // [6][NT]
  int* codes = reinterpret_cast<int*>(red + 6 * NT);  // [RL][Lp]
  __shared__ int bp_s[25];
  // the one-hot rows (c_fac_onehot: base of a code, pair type index) as
  // 0/1 values, so that a term is one product, (0 or 1) x g, as the plain
  // version forms it
  __shared__ T oh4[5][4], oh6[7][6];
  const int Lp = D.Lp, W1 = D.Wp + 1, S = D.S, B = D.B, ns = D.ns;
  const int r = threadIdx.x % RL, c = threadIdx.x / RL;
  const int b = blockIdx.x * RL + r;
  const bool live = b < B;
  const int n_sc = (S + 1 + NWARP - 1) / NWARP;
  T* ws_s = static_cast<T*>(a.ws);
  T* ws_p = ws_s + (long long)(S + 1) * 8 * B;
  const int np = (Lp + 1) * W1;  // pair cells (j, w)
  const int Pp = 1 << log2_pow2(np);
  const int Kt = Kp < Pp ? Kp : Pp;
  for (int i = threadIdx.x; i < RL * Lp; i += NT) {
    const int rr = i / Lp, bb = blockIdx.x * RL + rr;
    codes[i] = bb < B ? seq[(long long)bb * Lp + (i - rr * Lp)] : 0;
  }
  if (threadIdx.x < 25) bp_s[threadIdx.x] = c_fac_bp[threadIdx.x];
  if (threadIdx.x < 20) oh4[threadIdx.x / 4][threadIdx.x % 4] =
      (T)c_fac_onehot[threadIdx.x];
  if (threadIdx.x < 42) oh6[threadIdx.x / 6][threadIdx.x % 6] =
      (T)c_fac_onehot[20 + threadIdx.x];
  __syncthreads();
  const int* code_r = codes + r * Lp;
  if ((int)blockIdx.y < n_sc) {
    const int s = blockIdx.y * NWARP + threadIdx.x / 32;
    const int cw = c % CW;  // the lane's column in its warp
    if (s <= S) {
      // positions p = cw + q Cc (read_sum's order over Lp, padded), eR's
      // and eL's cotangents (bg2's for s == S) loaded once per position
      const int P = 1 << log2_pow2(Lp);
      const int Cc = P < CW ? P : CW;
      const T* gR = static_cast<const T*>(s < S ? a.geR : a.gbg2);
      const T* gL = static_cast<const T*>(s < S ? a.geL : nullptr);
      const long long st = s < S ? S : 1, s0 = s < S ? s : 0;
      T x[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) x[v] = (T)0;
      if (cw < Cc)
        tree_walk<T, 8>(P / Cc, [&](int q, T(&o)[8]) {
          const int p = cw + q * Cc;
          const int code = live && p < Lp ? code_r[p] : 0;
          const long long cell = (p * st + s0) * B + b;
          const T vr = code > 0 && gR ? gR[cell] : (T)0;
          const T vl = code > 0 && gL ? gL[cell] : (T)0;
          const T* oh = oh4[clampi(code, 0, 4)];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            o[k] = oh[k] * vr;
            o[4 + k] = oh[k] * vl;
          }
        }, x);
      const int cc[8] = {Cc, Cc, Cc, Cc, Cc, Cc, Cc, Cc};
      block_tree<T, 8, RL, 32>(cc, x, red);
      if (live && cw == 0) {
#pragma unroll
        for (int v = 0; v < 8; ++v)
          ws_s[((long long)s * 8 + v) * B + b] = x[v];
      }
    }
  } else {
    // pair cells i = k + m Kt of table t: this block's residue class
    const int t = (blockIdx.y - n_sc) / Kp, k = (blockIdx.y - n_sc) % Kp;
    const T* gpv = static_cast<const T*>(a.gpv);
    const int Q = Pp / Kt, Cc = Q < C ? Q : C;
    T x[6];
#pragma unroll
    for (int v = 0; v < 6; ++v) x[v] = (T)0;
    if (k < Kt && c < Cc)
      tree_walk<T, 6>(Q / Cc, [&](int q, T(&o)[6]) {
        const int i = k + (c + q * Cc) * Kt;
        int bt = 0;
        if (live && i < np) {
          const unsigned j = (unsigned)i / (unsigned)W1;
          const int w = i - (int)j * W1;
          const int x0 = code_r[clampi((int)j - w, 0, Lp - 1)];
          const int x1 = code_r[clampi((int)j - 1, 0, Lp - 1)];
          bt = bp_s[clampi(x0, 0, 4) * 5 + clampi(x1, 0, 4)];
        }
        const T g = bt > 0 && gpv
                        ? gpv[((long long)i * D.Tp + t) * B + b] : (T)0;
#pragma unroll
        for (int v = 0; v < 6; ++v) o[v] = oh6[bt][v] * g;
      }, x);
    const int cc[6] = {Cc, Cc, Cc, Cc, Cc, Cc};
    block_tree<T, 6, RL, NT>(cc, x, red);
    if (live && c == 0 && k < Kt) {
#pragma unroll
      for (int v = 0; v < 6; ++v)
        ws_p[(((long long)t * Kp + k) * 6 + v) * B + b] = x[v];
    }
  }
  if (!last_of_group(a.done + blockIdx.x, n_sc + pair_blocks * Kp)) return;
  // the finish, one thread per (read, slot) and per (read, pair table).
  // Slots: the states' sums added in ascending state order, eR's and
  // eL's apart (loaded kFinBatch states at a time), then bg2's + eL's +
  // eR's (singles[:, slot]'s index adjoint); pairs: the Kt slices' sums
  // halved; then the log-softmax's adjoint where theta_softmax applies
  const int n_slot = RL * ns;
  for (int i = threadIdx.x; i < n_slot + RL * pair_blocks; i += NT) {
    if (i >= n_slot) {
      const int rr = (i - n_slot) % RL, t = (i - n_slot) / RL;
      const int bb = blockIdx.x * RL + rr;
      if (bb >= B) continue;
      T g[6];
      tree_walk<T, 6>(Kt, [&](int q, T(&o)[6]) {
#pragma unroll
        for (int v = 0; v < 6; ++v)
          o[v] = __ldcg(ws_p + (((long long)t * Kp + q) * 6 + v) * B + bb);
      }, g);
      if (D.theta_softmax) softmax_adj<T, 6>(pairs + bb * D.sbp + 6 * t, g);
      T* gp = static_cast<T*>(a.gp) + ((long long)bb * D.Tp + t) * 6;
#pragma unroll
      for (int v = 0; v < 6; ++v) gp[v] = g[v];
      continue;
    }
    const int rr = i % RL, u = i / RL, bb = blockIdx.x * RL + rr;
    if (bb >= B) continue;
    const int r0 = ix.rs_off[u], nr = ix.rs_off[u + 1] - r0;
    const int l0 = ix.ls_off[u], nl = ix.ls_off[u + 1] - l0;
    T accR[4] = {0, 0, 0, 0}, accL[4] = {0, 0, 0, 0}, bg[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      bg[k] = u == 0 ? __ldcg(ws_s + ((long long)S * 8 + k) * B + bb)
                     : (T)0;
    for (int e0 = 0; e0 < nr || e0 < nl; e0 += kFinBatch) {
      T vr[kFinBatch][4], vl[kFinBatch][4];
#pragma unroll
      for (int j = 0; j < kFinBatch; ++j) {
        const T* sr = e0 + j < nr
            ? ws_s + (long long)__ldg(ix.rs_s + r0 + e0 + j) * 8 * B + bb
            : nullptr;
        const T* sl = e0 + j < nl
            ? ws_s + ((long long)__ldg(ix.ls_s + l0 + e0 + j) * 8 + 4) * B +
                  bb
            : nullptr;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          vr[j][k] = sr ? __ldcg(sr + k * B) : (T)0;
          vl[j][k] = sl ? __ldcg(sl + k * B) : (T)0;
        }
      }
#pragma unroll
      for (int j = 0; j < kFinBatch; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (e0 + j < nr) accR[k] = accR[k] + vr[j][k];
          if (e0 + j < nl) accL[k] = accL[k] + vl[j][k];
        }
    }
    T g[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) g[k] = (bg[k] + accL[k]) + accR[k];
    if (D.theta_softmax) softmax_adj<T, 4>(singles + bb * D.sbs + 4 * u, g);
    T* gs = static_cast<T*>(a.gs) + ((long long)bb * ns + u) * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) gs[k] = g[k];
  }
  if (threadIdx.x == 0) a.done[blockIdx.x] = 0;
}

// K14 on the host plan's layout (ops/kernels.factors_plan), refused
// unless it is the kernel's: V reads a thread (16 bytes, B a multiple of
// V and every vector-written output aligned) or 1, G = TX V a power of
// two, TX TY = kFacThreads, the tiles of P positions and the groups as
// the plan counts them, 32-bit offsets inside a block, the shared bytes
template <typename T>
static int factors(FacDims D, FacIdx ix, FacGrid g, const T* singles,
                   const T* pairs, const int* seq, const double* ws,
                   const int* L, const bool* dots, FacOut o,
                   cudaStream_t st) {
  const int VW = 16 / (int)sizeof(T);
  auto cdiv = [](long long a, long long b) { return (a + b - 1) / b; };
  auto pow2 = [](int x) { return x > 0 && (x & (x - 1)) == 0; };
  const long long W1 = D.Wp + 1;
  bool ok = (g.V == 1 || g.V == VW) && D.B % g.V == 0 && g.TX > 0 &&
            g.TY > 0 && g.TX * g.TY == kFacThreads && g.G == g.TX * g.V &&
            pow2(g.G) && g.G <= 32 && pow2(g.P) &&
            g.P <= 32 && D.Lp >= 1 && g.n1 == cdiv(D.Lp, g.P) &&
            g.n2 == cdiv(D.Lp + 1, g.P) && g.n3 == cdiv(D.Lp, g.P) &&
            g.n4 == 1 && g.groups == cdiv(D.B, g.G) && g.groups <= 65535 &&
            (long long)g.P * D.S * D.B < (1LL << 31) &&
            (long long)g.P * W1 * D.Tp * D.B < (1LL << 31) &&
            g.smem == factors_smem<T>(D, g.G, g.P);
  if (g.V > 1) {
    const void* ptrs[8] = {o.eR, o.eL, o.bg2, o.pv, o.alphaP, o.seqT,
                           o.gate, o.wsp};
    for (const void* p : ptrs)
      ok = ok && reinterpret_cast<unsigned long long>(p) % 16 == 0;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = factors_kernel<T, 1>;
  if (g.V != 1) kern = factors_kernel<T, 16 / sizeof(T)>;
  const int rc = allow_smem((const void*)kern, g.smem);
  if (rc) return rc;
  const int nx = D.mode == 1 ? g.n1 : g.n1 + g.n2 + g.n3 + g.n4;
  kern<<<dim3(nx, g.groups), dim3(g.TX, g.TY), g.smem, st>>>(
      D, ix, singles, pairs, seq, ws, L, dots, o, g);
  return static_cast<int>(cudaGetLastError());
}

// K15's dynamic shared memory: the block trees' values and the codes
template <typename T>
static long long factors_adj_smem(int Lp) {
  using Sh = FacAdjShape<T>;
  return 6LL * Sh::NT * sizeof(T) + 4LL * Sh::RL * Lp;
}

// K15 on the host plan's layout (ops/kernels.factors_adj_plan: groups of
// rl reads x grid_y blocks, smem bytes), refused unless it is the
// kernel's: RL reads a group, a block per NWARP states and Kp per pair
// table, the block's shared memory
template <typename T>
static int factors_adj(FacDims D, FacIdx ix, const T* singles,
                       const T* pairs, const int* seq, FacAdjArgs a,
                       int pair_blocks, int Kp, int rl, int groups,
                       int grid_y, int smem, cudaStream_t st) {
  using Sh = FacAdjShape<T>;
  auto kern = factors_adj_kernel<T>;
  if (Kp < 1 || (Kp & (Kp - 1)) || rl != Sh::RL ||
      groups != (D.B + Sh::RL - 1) / Sh::RL ||
      grid_y != (D.S + 1 + Sh::NWARP - 1) / Sh::NWARP + pair_blocks * Kp ||
      grid_y > 65535 || smem != factors_adj_smem<T>(D.Lp))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_smem((const void*)kern, smem);
  if (rc) return rc;
  kern<<<dim3(groups, grid_y), Sh::NT, smem, st>>>(D, ix, singles, pairs,
                                                   seq, a, pair_blocks, Kp);
  return static_cast<int>(cudaGetLastError());
}

#define FACTORS_EXPORTS(SUF, T)                                              \
  RNAELEM_EXPORT int rnaelem_factors_##SUF(                                  \
      FacDims D, FacIdx ix, FacOut o, FacGrid g, const T* singles,           \
      const T* pairs, const int* seq, const double* ws, const int* L,        \
      const bool* dots, cudaStream_t st) {                                   \
    return factors<T>(D, ix, g, singles, pairs, seq, ws, L, dots, o, st);    \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_factors_adj_##SUF(                              \
      FacDims D, FacIdx ix, FacAdjArgs a, const T* singles, const T* pairs,  \
      const int* seq, int pair_blocks, int Kp, int rl, int groups,           \
      int grid_y, int smem, cudaStream_t st) {                               \
    return factors_adj<T>(D, ix, singles, pairs, seq, a, pair_blocks, Kp,    \
                          rl, groups, grid_y, smem, st);                     \
  }

FACTORS_EXPORTS(f32, float)
FACTORS_EXPORTS(f64, double)
