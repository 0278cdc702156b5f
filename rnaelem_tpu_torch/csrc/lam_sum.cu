// K20: lambda's per-read cotangent from the outside pass's per-cell
// partials (row H of the kernel table).
//
// Replaces (rnaelem_tpu, XLA-compiled jnp programs): ops/dp.py dp_bwd's
// lam_chain (:812-843), lambda's direct terms summed per read and bucket,
// and the add of the hoisted exponentials' share (K17's term) that JAX's
// custom VJP returns with them.
//
// lam_sum (one launch): from K5's and K7's per-cell partials DL [Lp+1,
// Wp+1, S, B] (a target state's terms at each cell), per read b
//   DLs[s]  = sum over the (Lp+1)(Wp+1) cells of DL[., ., s, b]
//   out[bu] = (lam[bu, b] + sum over the states s of bucket bu of DLs[s])
//             + extra[bu, b]   (extra: K17's term, or absent)
// every sum in ops/dp.read_sum's order (padded with zeros to a power of
// two, then halves added), and the extra added last: the bits of
// ops/dp.finish_grads' plain composition, for a read in any batch.
//
// Bound on the H100: bytes, DL once (29 states x 5,151 cells x 128 reads,
// 76 MB at f32 on the main path).  Design: a block per (group of RL reads,
// state), the reads fastest so that a warp's loads are whole lines; its
// columns take the residue classes of a state's cells (common.cuh
// tree_walk, block_tree: read_sum's tree cut by residue class), the
// state's sum goes to a workspace, and the group's last block (an int
// counter, reset by it) halves each bucket's states in the grammar's order
// and adds lambda's other terms.
#include "common.cuh"

struct LamSumArgs {
  int n, S, B;                 // cells (Lp+1)(Wp+1), states, reads
  const void* DL;              // [n, S, B]
  const void* lam;             // [2, B] lambda's direct cotangent
  const void* extra;           // [2, B] added last, or null
  const int* states;           // [S] the states by (bucket, index)
  int off[3];                  // bucket bu's states: states[off[bu]..]
  void* out;                   // [2, B]
  void* ws;                    // [S, B] the states' sums
  int* done;                   // [groups] zero between launches
};

template <typename T>
struct LamSumShape {  // a warp's row of reads: one 128-byte line
  static const int RL = 128 / sizeof(T), NT = 512;
};

template <typename T>
__global__ void __launch_bounds__(LamSumShape<T>::NT)
lam_sum_kernel(LamSumArgs a) {
  constexpr int RL = LamSumShape<T>::RL, NT = LamSumShape<T>::NT;
  constexpr int C = NT / RL;
  __shared__ T red[NT];
  const int r = threadIdx.x % RL, c = threadIdx.x / RL, s = blockIdx.y;
  const int b = blockIdx.x * RL + r, B = a.B;
  const bool live = b < B;
  const T* DL = static_cast<const T*>(a.DL);
  T* ws = static_cast<T*>(a.ws);
  const int P = 1 << log2_pow2(a.n);
  int cc[1] = {P < C ? P : C};
  T x[1] = {(T)0};
  if (c < cc[0]) {
    tree_walk<T, 1>(P / cc[0], [&](int q, T(&o)[1]) {
      const int i = c + q * cc[0];
      o[0] = live && i < a.n ? DL[((long long)i * a.S + s) * B + b] : (T)0;
    }, x);
  }
  block_tree<T, 1, RL, NT>(cc, x, red);
  if (live && c == 0) ws[(long long)s * B + b] = x[0];
  if (!last_of_group(a.done + blockIdx.x, a.S)) return;
  if (live && c == 0) {
    const T* lam = static_cast<const T*>(a.lam);
    const T* extra = static_cast<const T*>(a.extra);
    T* out = static_cast<T*>(a.out);
#pragma unroll
    for (int bu = 0; bu < 2; ++bu) {
      const int m = a.off[bu + 1] - a.off[bu];
      T y[1];
      tree_walk<T, 1>(1 << log2_pow2(m), [&](int q, T(&o)[1]) {
        o[0] = q < m ? __ldcg(ws + (long long)a.states[a.off[bu] + q] * B + b)
                     : (T)0;
      }, y);
      T v = lam[(long long)bu * B + b] + y[0];
      if (extra) v = v + extra[(long long)bu * B + b];
      out[(long long)bu * B + b] = v;
    }
  }
  if (threadIdx.x == 0) a.done[blockIdx.x] = 0;
}

template <typename T>
static int lam_sum(LamSumArgs a, int groups, cudaStream_t st) {
  using Sh = LamSumShape<T>;
  if (a.n < 1 || a.S < 1 || a.S > 65535 || a.B < 1 || a.off[0] != 0 ||
      a.off[1] < 0 || a.off[2] != a.S || a.off[1] > a.S ||
      groups != (a.B + Sh::RL - 1) / Sh::RL ||
      (long long)a.n * a.S * a.B >= (1LL << 62))
    return static_cast<int>(cudaErrorInvalidValue);
  lam_sum_kernel<T><<<dim3(groups, a.S), Sh::NT, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

#define LAM_SUM_EXPORTS(SUF, T)                                            \
  RNAELEM_EXPORT int rnaelem_lam_sum_##SUF(LamSumArgs a, int groups,       \
                                           cudaStream_t st) {              \
    return lam_sum<T>(a, groups, st);                                      \
  }

LAM_SUM_EXPORTS(f32, float)
LAM_SUM_EXPORTS(f64, double)
