// K16 and K17: the hoisted exp-space energy tensors of one evaluation
// (row D of the kernel table) and their adjoint into lambda.
//
// Replaces (rnaelem_tpu, XLA-compiled jnp programs): ops/dp.py hoisted
// (:290-316), the per-evaluation exp(lambda * x) tensors of the internal
// loops, and their share of lambda's cotangent, which JAX's custom VJP
// forms in dp_bwd's lam_chain (:812-843).
//
// K16 (hoisted_kernel), one launch: for lambda [2, B] (read through its
// strides: the DP's per-read copies are a transposed view) it writes
//   eSZ   [2, n_cls, Cp+1 (dl), Cp+1 (u1), B]  exp(lam_b SZ[x, u1, dl])
//         with the per-read cap dl + u1 <= C[b] folded in,
//   eSZg  [2, 4, Cp+1, Cp+1, B]   the uncapped weights summed per
//         misA/misB group grp[x] (in ascending x, as index_add_),
//   emisA [2, 4, Lp+1, Wp+1, B]   exp(lam_b misA),
//   emisB [2, Lp+1+PAD, Wp+1, 4, B] exp(lam_b misB) rows-leading, PAD
//         zero rows in front,
// every exp(lam_mul(lam, x)) keeping -inf energies at 0.
//
// K17 (hoisted_adj_kernel), one launch: from the cotangents of those four
// (any may be absent) it writes lambda's cotangent [2, B]: per read and
// bucket the sum of g * exp(lam x) * x over each tensor (x = -inf counts
// 0, as lam_chain's xfac), each sum in ops/dp.read_sum's order over the
// tensor's leading dims, eSZ's and eSZg's cotangents taken to the
// uncapped weights first (g_eSZ * cap + g_eSZg[grp]), added as autograd
// adds the plain version's three _LamExp terms: (emisB + emisA) + eSZ.
// It recomputes exp(lam x) from lambda and x, so nothing of K16 is kept
// and ops/dp.lam_total runs no forward again.  Nothing is summed across
// reads: a read's bits do not depend on the batch or on the split.
//
// Bound on the H100: bytes.  K16 reads misA and misB and writes about
// 2.5x their size (emisA, emisB: 2 x 2 x 4 x (Lp+1)(Wp+1) x B values,
// 21 MB in f32 at B = 128 x 100 nt -w 50); K17 reads those cotangents and
// misA, misB once (about 72 MB there; not emisB's PAD rows).  Design:
// K16 one coalesced pass, a thread per output cell (the read fastest) in
// three index ranges of one grid.  K17 spreads each read's sums over the
// card: a block per (group of RL reads: a warp's loads one 128-byte line,
// slice k of K) takes residue class k of K of each of the three trees for
// both buckets (one load of misA/misB for the two, misA's and misB's
// trees in one walk), its 256 threads RL reads x C columns walking the
// class with 32-bit indices (common.cuh tree_walk, block_tree); the
// partials go to a workspace and the group's last block halves them (a
// counter) the same way.  K comes from the host plan
// (ops/kernels.hoisted_adj_plan: about 512 blocks), and every K gives
// read_sum's bits.
#include "common.cuh"

struct HoistDims {
  int Lp, Wp, Cp, B, PAD, n_cls;
  long long lam_s0, lam_s1;  // lambda's strides (bucket, read), elements
};

struct HoistIn {
  const void* lam;    // [2, B] strided
  const void* SZT;    // [n_cls, Cp+1 (dl), Cp+1 (u1)] log size weights
  const int* grp;     // [n_cls] misA/misB group of each size class
  const void* misA;   // [4, Lp+1, Wp+1, B]
  const void* misB;   // [4, Lp+1, Wp+1, B]
  const int* C;       // [B] internal-loop cap
};

struct HoistOut {     // K16's outputs, K17's cotangents (null: zero)
  void* eSZ;
  void* eSZg;
  void* emisA;
  void* emisB;
};

static const int kHoistThreads = 256;

template <typename T>
__device__ __forceinline__ T exp_lam(T lam, T x) {
  return ex(lam_mul(lam, x));
}

template <typename T>
__device__ __forceinline__ T lam_of(const HoistDims& D, const T* lam, int bu,
                                    int b) {
  return lam[bu * D.lam_s0 + b * D.lam_s1];
}

// ---- K16
template <typename T>
__global__ void __launch_bounds__(kHoistThreads)
hoisted_kernel(HoistDims D, HoistIn in, HoistOut o, long long n1,
               long long n2, long long n3) {
  const int B = D.B, C1 = D.Cp + 1, W1 = D.Wp + 1, Lp1 = D.Lp + 1;
  const T* lam = static_cast<const T*>(in.lam);
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n1) {  // (bu, dl, u1, b): every class of eSZ and eSZg
    const int b = (int)(idx % B), u1 = (int)((idx / B) % C1);
    const int dl = (int)((idx / ((long long)B * C1)) % C1);
    const int bu = (int)(idx / ((long long)B * C1 * C1));
    const T lb = lam_of(D, lam, bu, b);
    const T cap = dl + u1 <= in.C[b] ? (T)1 : (T)0;
    const T* SZT = static_cast<const T*>(in.SZT);
    T acc[4] = {0, 0, 0, 0};
    T* eSZ = static_cast<T*>(o.eSZ);
    const long long cell = ((long long)dl * C1 + u1) * B + b;
    for (int x = 0; x < D.n_cls; ++x) {
      const T e = exp_lam(lb, SZT[((long long)x * C1 + dl) * C1 + u1]);
      eSZ[((long long)bu * D.n_cls + x) * C1 * C1 * B + cell] = e * cap;
      const int g = in.grp[x];
      acc[g] = acc[g] + e;
    }
    T* eSZg = static_cast<T*>(o.eSZg);
    for (int g = 0; g < 4; ++g)
      eSZg[((long long)bu * 4 + g) * C1 * C1 * B + cell] = acc[g];
    return;
  }
  idx -= n1;
  if (idx < n2) {  // emisA, in its own layout
    const long long per = 4LL * Lp1 * W1 * B;
    const int bu = (int)(idx / per), b = (int)(idx % B);
    static_cast<T*>(o.emisA)[idx] = exp_lam(
        lam_of(D, lam, bu, b), static_cast<const T*>(in.misA)[idx % per]);
    return;
  }
  idx -= n2;
  if (idx < n3) {  // emisB (bu, row, w, g, b)
    const int b = (int)(idx % B), g = (int)((idx / B) % 4);
    const int w = (int)((idx / (4LL * B)) % W1);
    const long long rows = (long long)Lp1 + D.PAD;
    const int row = (int)((idx / (4LL * B * W1)) % rows);
    const int bu = (int)(idx / (4LL * B * W1 * rows));
    T v = (T)0;
    if (row >= D.PAD) {
      const T x = static_cast<const T*>(
          in.misB)[(((long long)g * Lp1 + (row - D.PAD)) * W1 + w) * B + b];
      v = exp_lam(lam_of(D, lam, bu, b), x);
    }
    static_cast<T*>(o.emisB)[idx] = v;
  }
}

// g exp(lam x) x with x = -inf counted 0 ((g * out) * x, as _LamExp)
template <typename T>
__device__ __forceinline__ T lam_term(T g, T lam, T x) {
  const T out = exp_lam(lam, x);
  return (g * out) * (x == ninf<T>() ? (T)0 : x);
}

// ---- K17: block (group of RL reads, slice k of K); both buckets
template <typename T>
struct HoistAdjShape {  // a warp's row of reads: one 128-byte line
  static const int RL = 128 / sizeof(T), NT = 256;
};

template <typename T>
__global__ void __launch_bounds__(HoistAdjShape<T>::NT)
hoisted_adj_kernel(HoistDims D, HoistIn in, HoistOut g, T* glam, T* part,
                   int* done, int K) {
  constexpr int RL = HoistAdjShape<T>::RL, NT = HoistAdjShape<T>::NT;
  constexpr int C = NT / RL;
  __shared__ T red[6 * NT];
  const int B = D.B, C1 = D.Cp + 1, W1 = D.Wp + 1, Lp1 = D.Lp + 1;
  const int r = threadIdx.x % RL, c = threadIdx.x / RL, k = blockIdx.y;
  const int b = blockIdx.x * RL + r;
  const bool live = b < B;
  const T* lamp = static_cast<const T*>(in.lam);
  const T lb[2] = {live ? lam_of(D, lamp, 0, b) : (T)0,
                   live ? lam_of(D, lamp, 1, b) : (T)0};
  const T* gA = static_cast<const T*>(g.emisA);
  const T* gB = static_cast<const T*>(g.emisB);
  const T* gE = static_cast<const T*>(g.eSZ);
  const T* gG = static_cast<const T*>(g.eSZg);
  const T* misA = static_cast<const T*>(in.misA);
  const T* misB = static_cast<const T*>(in.misB);
  const T* SZT = static_cast<const T*>(in.SZT);
  const int nj = Lp1 * W1, nm = 4 * nj;  // (g, j, w) of misA / misB
  const int c2 = C1 * C1, ns = D.n_cls * c2;  // (x, dl, u1)
  const long long bB = (long long)(Lp1 + D.PAD) * W1 * 4 * B;  // emisB's
  // values v = 2 tree + bucket of the trees misB (0), misA (1) and the
  // size classes (2); misB's and misA's share a shape and one walk.
  // Kt blocks of the read's K take a residue class each, cc of a block's
  // columns walk it, Qc values a column
  int Kt[2], Qc[2], cc[6];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int P = 1 << log2_pow2(t ? ns : nm);
    Kt[t] = K < P ? K : P;
    const int Q = P / Kt[t];
    const int cct = Q < C ? Q : C;
    Qc[t] = Q / cct;
    for (int v = (t ? 4 : 0); v < (t ? 6 : 4); ++v) cc[v] = cct;
  }
  T x[6];
#pragma unroll
  for (int v = 0; v < 6; ++v) x[v] = (T)0;
  if (k < Kt[0] && c < cc[0]) {  // misB (emisB rows-leading) and misA
    T y[4];
    tree_walk<T, 4>(Qc[0], [&](int q, T(&o)[4]) {
      const int i = k + (c + q * cc[0]) * Kt[0];
#pragma unroll
      for (int v = 0; v < 4; ++v) o[v] = (T)0;
      if (!live || i >= nm) return;
      const long long at = (long long)i * B + b;
      if (gB) {
        const int gr = (i >= nj) + (i >= 2 * nj) + (i >= 3 * nj);
        const long long cell =
            (((long long)D.PAD * W1 + (i - gr * nj)) * 4 + gr) * B + b;
        const T xv = misB[at];
        o[0] = lam_term(gB[cell], lb[0], xv);
        o[1] = lam_term(gB[bB + cell], lb[1], xv);
      }
      if (gA) {
        const T xv = misA[at];
        o[2] = lam_term(gA[at], lb[0], xv);
        o[3] = lam_term(gA[(long long)nm * B + at], lb[1], xv);
      }
    }, y);
#pragma unroll
    for (int v = 0; v < 4; ++v) x[v] = y[v];
  }
  if (k < Kt[1] && c < cc[4]) {  // the size classes, capped and grouped
    T y[2];
    const int Cb = live ? in.C[b] : 0;
    tree_walk<T, 2>(Qc[1], [&](int q, T(&o)[2]) {
      const int i = k + (c + q * cc[4]) * Kt[1];
      o[0] = o[1] = (T)0;
      if (!live || (!gE && !gG) || i >= ns) return;
      const unsigned xc = (unsigned)i / (unsigned)c2;
      const int cell = i - (int)xc * c2;
      const unsigned dl = (unsigned)cell / (unsigned)C1;
      const int u1 = cell - (int)dl * C1;
      const T cap = (int)dl + u1 <= Cb ? (T)1 : (T)0;
      const int grp = in.grp[xc];
      const T xv = SZT[i];
#pragma unroll
      for (int bu = 0; bu < 2; ++bu) {
        T gv = (T)0;
        if (gE) gv = gE[((long long)bu * ns + i) * B + b] * cap;
        if (gG)
          gv = gv + gG[(((long long)bu * 4 + grp) * c2 + cell) * B + b];
        o[bu] = lam_term(gv, lb[bu], xv);
      }
    }, y);
    x[4] = y[0];
    x[5] = y[1];
  }
  block_tree<T, 6, RL, NT>(cc, x, red);
  // partials [v][K][B]
  if (live && c == 0) {
#pragma unroll
    for (int v = 0; v < 6; ++v)
      if (k < Kt[v / 4]) part[((long long)v * K + k) * B + b] = x[v];
  }
  if (!last_of_group(done + blockIdx.x, K)) return;
  // the group's last block halves each value's Kt partials, cut as a
  // block cuts its class (columns over residue classes, then block_tree),
  // then adds the trees as autograd adds the plain version's three
  // _LamExp terms, (emisB + emisA) + eSZ
  int fc[6];
#pragma unroll
  for (int v = 0; v < 6; ++v) {
    x[v] = (T)0;
    fc[v] = Kt[v / 4] < C ? Kt[v / 4] : C;
  }
  if (live) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int v0 = t ? 4 : 0, nv = t ? 2 : 4;
      if (c >= fc[v0]) continue;
      T y[4];
      tree_walk<T, 4>(Kt[t] / fc[v0], [&](int q, T(&o)[4]) {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          o[v] = v < nv ? __ldcg(part + ((long long)(v0 + v) * K + c +
                                         q * fc[v0]) * B + b)
                        : (T)0;
      }, y);
      for (int v = 0; v < nv; ++v) x[v0 + v] = y[v];
    }
  }
  block_tree<T, 6, RL, NT>(fc, x, red);
  if (live && c == 0) {
    glam[b] = (x[0] + x[2]) + x[4];
    glam[(long long)B + b] = (x[1] + x[3]) + x[5];
  }
  if (threadIdx.x == 0) done[blockIdx.x] = 0;
}

template <typename T>
static int hoisted(HoistDims D, HoistIn in, HoistOut o, cudaStream_t st) {
  const int C1 = D.Cp + 1, W1 = D.Wp + 1, Lp1 = D.Lp + 1;
  const long long n1 = 2LL * C1 * C1 * D.B;
  const long long n2 = 2LL * 4 * Lp1 * W1 * D.B;
  const long long n3 = 2LL * (Lp1 + D.PAD) * W1 * 4 * D.B;
  const long long blocks = (n1 + n2 + n3 + kHoistThreads - 1) / kHoistThreads;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  hoisted_kernel<T><<<(int)blocks, kHoistThreads, 0, st>>>(D, in, o, n1, n2,
                                                           n3);
  return static_cast<int>(cudaGetLastError());
}

// K17 on the host plan's layout (ops/kernels.hoisted_adj_plan: groups
// of rl reads x K slices), refused unless it is the kernel's
template <typename T>
static int hoisted_adj(HoistDims D, HoistIn in, HoistOut g, T* glam, T* part,
                       int* done, int K, int rl, int groups,
                       cudaStream_t st) {
  using Sh = HoistAdjShape<T>;
  if (K < 1 || K > 65535 || (K & (K - 1)) || rl != Sh::RL ||
      groups != (D.B + Sh::RL - 1) / Sh::RL)
    return static_cast<int>(cudaErrorInvalidValue);
  hoisted_adj_kernel<T><<<dim3(groups, K), Sh::NT, 0, st>>>(
      D, in, g, glam, part, done, K);
  return static_cast<int>(cudaGetLastError());
}

#define HOISTED_EXPORTS(SUF, T)                                              \
  RNAELEM_EXPORT int rnaelem_hoisted_##SUF(HoistDims D, HoistIn in,          \
                                           HoistOut o, cudaStream_t st) {    \
    return hoisted<T>(D, in, o, st);                                         \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_hoisted_adj_##SUF(                              \
      HoistDims D, HoistIn in, HoistOut g, T* glam, T* part, int* done,      \
      int K, int rl, int groups, cudaStream_t st) {                          \
    return hoisted_adj<T>(D, in, g, glam, part, done, K, rl, groups, st);    \
  }

HOISTED_EXPORTS(f32, float)
HOISTED_EXPORTS(f64, double)
