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
// and ops/dp.finish_grads runs no forward again.  Nothing is summed across
// reads: a read's bits do not depend on the batch or on the split.
//
// Bound on the H100: bytes.  K16 reads misA and misB and writes about 2.5x
// their size (emisA, emisB: 2 x 2 x 4 x (Lp+1)(Wp+1) x B values, 21 MB in f32
// at B = 128 x 100 nt -w 50); K17 reads those cotangents and misA, misB once
// (about 72 MB there; not emisB's PAD rows).  Design: K16 one coalesced pass
// over rows of B values (every output ends in the read): a block is TY rows x
// TX threads along the reads, a thread V reads of a row (16 bytes where B and
// the pointers allow it, else one), and both buckets from one load of its
// inputs.  The grid's x is the rows' blocks, three ranges of them one after the
// other (eSZ and eSZg by (dl, block of u1), emisA and emisB by block of rows),
// its y the groups of reads, so a thread takes its coordinates from blockIdx
// and threadIdx: no division per value, 32-bit offsets inside a block from a
// 64-bit base (the host plan ops/kernels.hoisted_plan).  K17 spreads each
// read's sums over the card: a block per (group of RL reads: a warp's loads one
// 128-byte line, slice k of K) takes residue class k of K of each of the three
// trees for both buckets (one load of misA/misB for the two, misA's and misB's
// trees in one walk), its 256 threads RL reads x C columns walking the class
// with 32-bit indices (common.cuh tree_walk, block_tree); the partials go to a
// workspace and the group's last block halves them (a counter) the same way.  K
// comes from the host plan (ops/kernels.hoisted_adj_plan: about 512 blocks),
// and every K gives read_sum's bits.
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

// K16's layout (ops/kernels.hoisted_plan): V reads a thread, TX threads
// along the reads and TY rows a block; nb[0..2] the row blocks of the
// three ranges, nub blocks of u1 per dl in the first
struct HoistGrid {
  int V, TX, TY, nub, nb1, nb2, nb3, groups;
};

template <typename T>
__device__ __forceinline__ T exp_lam(T lam, T x) {
  return ex(lam_mul(lam, x));
}

template <typename T>
__device__ __forceinline__ T lam_of(const HoistDims& D, const T* lam, int bu,
                                    int b) {
  return lam[bu * D.lam_s0 + b * D.lam_s1];
}

// V values of a row in one access (16 bytes when V > 1)
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> ld_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void st_vec(T* p, const Vec<T, V>& x) {
  *reinterpret_cast<Vec<T, V>*>(p) = x;
}

// ---- K16: block (row block, group of reads), thread (row, V reads)
template <typename T, int V>
__global__ void __launch_bounds__(kHoistThreads)
hoisted_kernel(HoistDims D, HoistIn in, HoistOut o, HoistGrid g) {
  const int B = D.B, C1 = D.Cp + 1, W1 = D.Wp + 1, Lp1 = D.Lp + 1;
  const int b0 = (blockIdx.y * g.TX + threadIdx.x) * V;
  if (b0 >= B) return;
  const T* lamp = static_cast<const T*>(in.lam);
  T lb[2][V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    lb[0][v] = lam_of(D, lamp, 0, b0 + v);
    lb[1][v] = lam_of(D, lamp, 1, b0 + v);
  }
  const int ty = threadIdx.y;
  int rb = blockIdx.x;
  if (rb < g.nb1) {  // (dl, u1): every class of eSZ and eSZg
    const int dl = rb / g.nub;
    const int u1 = (rb - dl * g.nub) * g.TY + ty;
    if (u1 >= C1) return;
    const long long c2B = (long long)C1 * C1 * B;
    const int cell = (dl * C1 + u1) * B + b0;
    bool cap[V];
#pragma unroll
    for (int v = 0; v < V; ++v) cap[v] = dl + u1 <= in.C[b0 + v];
    const T* SZT = static_cast<const T*>(in.SZT) + dl * C1 + u1;
    T acc[2][4][V];
#pragma unroll
    for (int bu = 0; bu < 2; ++bu)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[bu][k][v] = (T)0;
    T* eSZ = static_cast<T*>(o.eSZ) + cell;
    for (int x = 0; x < D.n_cls; ++x) {
      const T s = SZT[x * C1 * C1];
      const int gr = in.grp[x];
#pragma unroll
      for (int bu = 0; bu < 2; ++bu) {
        Vec<T, V> y;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const T e = exp_lam(lb[bu][v], s);
          y.v[v] = e * (cap[v] ? (T)1 : (T)0);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k == gr) acc[bu][k][v] = acc[bu][k][v] + e;
        }
        st_vec<T, V>(eSZ + (bu * D.n_cls + x) * c2B, y);
      }
    }
    T* eSZg = static_cast<T*>(o.eSZg) + cell;
#pragma unroll
    for (int bu = 0; bu < 2; ++bu)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        Vec<T, V> y;
#pragma unroll
        for (int v = 0; v < V; ++v) y.v[v] = acc[bu][k][v];
        st_vec<T, V>(eSZg + (bu * 4 + k) * c2B, y);
      }
    return;
  }
  rb -= g.nb1;
  const int off = ty * B + b0;  // inside the block's rows
  if (rb < g.nb2) {  // emisA, in misA's layout (g, j, w)
    const int n = 4 * Lp1 * W1;
    if (rb * g.TY + ty >= n) return;
    const long long base = (long long)rb * g.TY * B;
    const Vec<T, V> x =
        ld_vec<T, V>(static_cast<const T*>(in.misA) + base + off);
    T* out = static_cast<T*>(o.emisA) + base + off;
#pragma unroll
    for (int bu = 0; bu < 2; ++bu) {
      Vec<T, V> y;
#pragma unroll
      for (int v = 0; v < V; ++v) y.v[v] = exp_lam(lb[bu][v], x.v[v]);
      st_vec<T, V>(out + bu * (long long)n * B, y);
    }
    return;
  }
  rb -= g.nb2;  // emisB, row q = (row, w) of [Lp+1+PAD, Wp+1] x its 4 groups
  const int q0 = rb * g.TY, nq = (Lp1 + D.PAD) * W1;
  if (q0 + ty >= nq) return;
  const long long bB = (long long)nq * 4 * B;  // a bucket of emisB
  T* out = static_cast<T*>(o.emisB) + (long long)q0 * 4 * B + ty * 4 * B + b0;
  const int src = q0 + ty - D.PAD * W1;  // (row - PAD, w) of misB
  const long long plane = (long long)Lp1 * W1 * B;
  const T* misB = static_cast<const T*>(in.misB) + (long long)src * B + b0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    Vec<T, V> y0, y1;
    if (src >= 0) {
      const Vec<T, V> x = ld_vec<T, V>(misB + k * plane);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        y0.v[v] = exp_lam(lb[0][v], x.v[v]);
        y1.v[v] = exp_lam(lb[1][v], x.v[v]);
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) y0.v[v] = y1.v[v] = (T)0;
    }
    st_vec<T, V>(out + k * B, y0);
    st_vec<T, V>(out + bB + k * B, y1);
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

// K16 on the host plan's layout (ops/kernels.hoisted_plan), refused
// unless it is the kernel's: V reads a thread (16 bytes, B a multiple of
// V and every row aligned) or 1, TX x TY = kHoistThreads, the ranges'
// row blocks and the groups of reads as the plan counts them
template <typename T>
static int hoisted(HoistDims D, HoistIn in, HoistOut o, HoistGrid g,
                   cudaStream_t st) {
  const int C1 = D.Cp + 1, W1 = D.Wp + 1, Lp1 = D.Lp + 1;
  const int VW = 16 / (int)sizeof(T);
  auto cdiv = [](long long a, long long b) { return (a + b - 1) / b; };
  bool ok = (g.V == 1 || g.V == VW) && D.B % g.V == 0 && g.TX > 0 &&
            g.TY > 0 && (g.TX & (g.TX - 1)) == 0 &&
            g.TX * g.TY == kHoistThreads && g.nub == cdiv(C1, g.TY) &&
            g.nb1 == (long long)C1 * g.nub &&
            g.nb2 == cdiv(4LL * Lp1 * W1, g.TY) &&
            g.nb3 == cdiv((long long)(Lp1 + D.PAD) * W1, g.TY) &&
            g.groups == cdiv(D.B / g.V, g.TX) && g.groups <= 65535 &&
            4LL * g.TY * D.B < (1LL << 31) &&
            (long long)C1 * C1 * D.B < (1LL << 31) &&
            (long long)g.nb1 + g.nb2 + g.nb3 < (1LL << 31);
  if (g.V > 1) {
    const void* ptrs[6] = {in.misA, in.misB, o.eSZ, o.eSZg, o.emisA,
                           o.emisB};
    for (const void* p : ptrs)
      ok = ok && reinterpret_cast<unsigned long long>(p) % 16 == 0;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(g.nb1 + g.nb2 + g.nb3, g.groups), block(g.TX, g.TY);
  if (g.V == 1)
    hoisted_kernel<T, 1><<<grid, block, 0, st>>>(D, in, o, g);
  else
    hoisted_kernel<T, 16 / sizeof(T)><<<grid, block, 0, st>>>(D, in, o, g);
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
                                           HoistOut o, HoistGrid g,          \
                                           cudaStream_t st) {                \
    return hoisted<T>(D, in, o, g, st);                                      \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_hoisted_adj_##SUF(                              \
      HoistDims D, HoistIn in, HoistOut g, T* glam, T* part, int* done,      \
      int K, int rl, int groups, cudaStream_t st) {                          \
    return hoisted_adj<T>(D, in, g, glam, part, done, K, rl, groups, st);    \
  }

HOISTED_EXPORTS(f32, float)
HOISTED_EXPORTS(f64, double)
