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
// reads: a read's bits do not depend on the batch.
//
// Bound on the H100: bytes.  K16 reads misA and misB and writes about
// 2.5x their size (emisA, emisB: 2 x 2 x 4 x (Lp+1)(Wp+1) x B values,
// 21 MB in f32 at B = 128 x 100 nt -w 50); K17 reads those cotangents and
// misA, misB once.  Design: K16 one coalesced pass, a thread per output
// cell (the read fastest) in three index ranges of one grid; K17 a block
// per (bucket, group of RL reads: one 32-byte sector) whose C columns
// walk the tensors with the read fastest, so every load is a full sector.
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

// ---- K17: block (group of RL reads, bucket)
template <typename T, int RL, int C>
__global__ void __launch_bounds__(RL * C)
hoisted_adj_kernel(HoistDims D, HoistIn in, HoistOut g, T* glam) {
  __shared__ T red[C * RL];
  const int B = D.B, C1 = D.Cp + 1, W1 = D.Wp + 1, Lp1 = D.Lp + 1;
  const int r = threadIdx.x % RL, c = threadIdx.x / RL, bu = blockIdx.y;
  const int b = blockIdx.x * RL + r;
  const bool live = b < B;
  const T lb = live ? lam_of(D, static_cast<const T*>(in.lam), bu, b) : (T)0;
  const T* gA = static_cast<const T*>(g.emisA);
  const T* gB = static_cast<const T*>(g.emisB);
  const T* gE = static_cast<const T*>(g.eSZ);
  const T* gG = static_cast<const T*>(g.eSZg);
  const T* misA = static_cast<const T*>(in.misA);
  const T* misB = static_cast<const T*>(in.misB);
  const T* SZT = static_cast<const T*>(in.SZT);
  const long long nm = 4LL * Lp1 * W1;  // (g, j, w) of misA / misB
  const long long ns = (long long)D.n_cls * C1 * C1;  // (x, dl, u1)
  const TreeShape tm(nm, C), ts(ns, C);
  T loc[3];
  loc[0] = tree_local<T>(tm, nm, c, [&](long long i) -> T {
    if (!live || !gB) return (T)0;
    const int w = (int)(i % W1), j = (int)((i / W1) % Lp1);
    const int gr = (int)(i / ((long long)W1 * Lp1));
    const T gv = gB[((((long long)bu * (Lp1 + D.PAD) + D.PAD + j) * W1 + w) *
                         4 + gr) * B + b];
    return lam_term(gv, lb, misB[i * B + b]);
  });
  loc[1] = tree_local<T>(tm, nm, c, [&](long long i) -> T {
    if (!live || !gA) return (T)0;
    return lam_term(gA[((long long)bu * nm + i) * B + b], lb, misA[i * B + b]);
  });
  loc[2] = tree_local<T>(ts, ns, c, [&](long long i) -> T {
    if (!live || (!gE && !gG)) return (T)0;
    const long long cell = i % ((long long)C1 * C1);
    const int x = (int)(i / ((long long)C1 * C1));
    const int dl = (int)(cell / C1), u1 = (int)(cell % C1);
    T gv = (T)0;
    if (gE)
      gv = gE[((long long)bu * ns + i) * B + b] *
           (dl + u1 <= in.C[b] ? (T)1 : (T)0);
    if (gG)
      gv = gv + gG[(((long long)bu * 4 + in.grp[x]) * C1 * C1 + cell) * B + b];
    return lam_term(gv, lb, SZT[i]);
  });
  // the misA/misB trees and the size classes' tree have their own
  // column counts: the shared levels run per tree
  T sum[3];
  {
    T one[1] = {loc[0]}, o[1];
    tree_cols<T, 1, RL, C>(tm, one, red, o);
    sum[0] = o[0];
    one[0] = loc[1];
    tree_cols<T, 1, RL, C>(tm, one, red, o);
    sum[1] = o[0];
    one[0] = loc[2];
    tree_cols<T, 1, RL, C>(ts, one, red, o);
    sum[2] = o[0];
  }
  if (live && c == 0) glam[(long long)bu * B + b] = (sum[0] + sum[1]) + sum[2];
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

template <typename T>
static int hoisted_adj(HoistDims D, HoistIn in, HoistOut g, T* glam,
                       cudaStream_t st) {
  constexpr int RL = 32 / sizeof(T), C = 1024 / RL;
  const dim3 grid((D.B + RL - 1) / RL, 2);
  hoisted_adj_kernel<T, RL, C><<<grid, RL * C, 0, st>>>(D, in, g, glam);
  return static_cast<int>(cudaGetLastError());
}

#define HOISTED_EXPORTS(SUF, T)                                              \
  RNAELEM_EXPORT int rnaelem_hoisted_##SUF(HoistDims D, HoistIn in,          \
                                           HoistOut o, cudaStream_t st) {    \
    return hoisted<T>(D, in, o, st);                                         \
  }                                                                          \
  RNAELEM_EXPORT int rnaelem_hoisted_adj_##SUF(                              \
      HoistDims D, HoistIn in, HoistOut g, T* glam, cudaStream_t st) {       \
    return hoisted_adj<T>(D, in, g, glam, st);                               \
  }

HOISTED_EXPORTS(f32, float)
HOISTED_EXPORTS(f64, double)
