// A standalone reproducer of the one-hot select that K15's first form
// used: term k of a position is (k == clampi(code - 1, 0, 3) ? 1 : 0) x g,
// the plain version's one-hot contraction (model/joint._OneHot).  It is
// not part of the kernels' library; chip_smoke.py --onehot-repro builds
// it with the library's nvcc flags (and with ptxas optimisation off),
// runs it on codes 0..4 and prints each base's terms against the exact
// ones, with the PTX and SASS lines of the select.
//
// Three kernels, each templated on the scalar type:
//  - onehot_flat_cmp: one thread per position, the compare form;
//  - onehot_flat_tab: the same from a table of 0/1 rows (K15's form now);
//  - onehot_walk_cmp: K15's state warp (a warp of RL reads x CW columns,
//    tree_walk over the positions of a column, block_tree over the
//    columns) with the compare form, eR's and eL's four sums per read.
#include "../common.cuh"

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// out[4 i + k] = (k == base(code[i])) x g[i], n positions
template <typename T>
__global__ void onehot_flat_cmp(const int* code, const T* g, T* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int base = clampi(code[i] - 1, 0, 3);
  const T v = g[i];
#pragma unroll
  for (int k = 0; k < 4; ++k) out[4 * i + k] = (k == base ? (T)1 : (T)0) * v;
}

template <typename T>
__global__ void onehot_flat_tab(const int* code, const T* g, T* out, int n) {
  __shared__ T oh[5][4];
  if (threadIdx.x < 20) {
    const int cd = threadIdx.x / 4, k = threadIdx.x % 4;
    oh[cd][k] = k == clampi(cd - 1, 0, 3) ? (T)1 : (T)0;
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T* row = oh[clampi(code[i], 0, 4)];
  const T v = g[i];
#pragma unroll
  for (int k = 0; k < 4; ++k) out[4 * i + k] = row[k] * v;
}

// codes [B, Lp], gR and gL [Lp, B]; out [8, B]: eR's sums at the four
// bases, then eL's.  One warp per block, block x = a group of RL reads.
template <typename T>
__global__ void onehot_walk_cmp(const int* seq, const T* gR, const T* gL,
                                T* out, int Lp, int B) {
  constexpr int RL = 32 / sizeof(T), CW = 32 / RL;
  const int r = threadIdx.x % RL, cw = threadIdx.x / RL;
  const int b = blockIdx.x * RL + r;
  const bool live = b < B;
  const int P = 1 << log2_pow2(Lp);
  const int Cc = P < CW ? P : CW;
  T x[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) x[v] = (T)0;
  if (cw < Cc)
    tree_walk<T, 8>(P / Cc, [&](int q, T(&o)[8]) {
      const int p = cw + q * Cc;
      const int code = live && p < Lp ? seq[(long long)b * Lp + p] : 0;
      const long long cell = (long long)p * B + b;
      const T vr = code > 0 ? gR[cell] : (T)0;
      const T vl = code > 0 ? gL[cell] : (T)0;
      const int base = clampi(code - 1, 0, 3);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const T e = k == base ? (T)1 : (T)0;
        o[k] = e * vr;
        o[4 + k] = e * vl;
      }
    }, x);
  const int cc[8] = {Cc, Cc, Cc, Cc, Cc, Cc, Cc, Cc};
  block_tree<T, 8, RL, 32>(cc, x, nullptr);
  if (live && cw == 0) {
#pragma unroll
    for (int v = 0; v < 8; ++v) out[(long long)v * B + b] = x[v];
  }
}

#define REPRO_EXPORTS(SUF, T)                                               \
  RNAELEM_EXPORT int repro_flat_cmp_##SUF(const int* code, const T* g,      \
                                          T* out, int n) {                  \
    onehot_flat_cmp<T><<<(n + 127) / 128, 128>>>(code, g, out, n);          \
    return static_cast<int>(cudaGetLastError());                            \
  }                                                                         \
  RNAELEM_EXPORT int repro_flat_tab_##SUF(const int* code, const T* g,      \
                                          T* out, int n) {                  \
    onehot_flat_tab<T><<<(n + 127) / 128, 128>>>(code, g, out, n);          \
    return static_cast<int>(cudaGetLastError());                            \
  }                                                                         \
  RNAELEM_EXPORT int repro_walk_cmp_##SUF(const int* seq, const T* gR,      \
                                          const T* gL, T* out, int Lp,      \
                                          int B) {                          \
    constexpr int RL = 32 / sizeof(T);                                      \
    onehot_walk_cmp<T><<<(B + RL - 1) / RL, 32>>>(seq, gR, gL, out, Lp, B); \
    return static_cast<int>(cudaGetLastError());                            \
  }

REPRO_EXPORTS(f32, float)
REPRO_EXPORTS(f64, double)
