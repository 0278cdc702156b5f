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
// coalesced pass, a thread per output cell with the read fastest, in four
// index ranges of one grid (state cells, pair cells, position cells, and
// a warp per read for the running dot counts).  K15 spreads a read's sums
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
      FacDims D, FacIdx ix, FacOut o, const T* singles, const T* pairs,      \
      const int* seq, const double* ws, const int* L, const bool* dots,      \
      cudaStream_t st) {                                                     \
    return factors<T>(D, ix, singles, pairs, seq, ws, L, dots, o, st);       \
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
