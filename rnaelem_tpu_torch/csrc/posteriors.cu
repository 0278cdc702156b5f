// K21: the scanner's posteriors from the class sums (row K of the kernel
// table).
//
// Replaces (rnaelem_tpu, XLA-compiled jnp programs): scan/scanner.py
// _scan_posteriors_jit's assembly (:147-190) around its two passes: the
// masked start/inside posteriors and their last-maximum argmax (the pin of
// the end pass), then the end posteriors with the tail mass at p = L and
// their argmax.
//
// posteriors pass 1 (one launch), from the class-probe cotangent g [4, Lp,
// B] (start, in, end, tail mass per base, as K5/K7/K9 write it) and L:
//   Pys[b, p] = p < L_b ? g[0, p, b] : 0,  Pyi likewise from g[1],
//   Ys[b] = the last p of the maximum of (p < L_b ? Pys : -1) (max_index,
//   util.hpp:232-241: ties go to the last index, NaN is the maximum),
//   Ys int64 and the same as the end pass's int32 pin position;
// posteriors end pass (one launch), from the end pass's cotangent:
//   Pye[b, p] = (p < L_b ? g[2, p, b] : 0) + [p == L_b] * g[3, L_b - 1, b]
//   for p <= Lp (the last base clamped into the row, as the plain twin
//   gathers it), Ye its last maximum over p <= L_b.
// Every output is a masked copy, one sum of two values or an integer
// argmax: the plain twin's bits.
//
// Bound on the H100: bytes (g read once, [B, Lp] rows written); the launch
// is the cost at a 64-read chunk.  Design: a block per read, its threads
// over the positions, so every output row is written whole and a read's
// loads are in flight together; the argmax is a block reduction under a
// total order on (value, position) that is max_index's rule.
#include "common.cuh"

struct PostArgs {
  int Lp, B, end;
  const void* g;          // [4, Lp, B]
  const long long* L;     // [B]
  void* P0;               // [B, Lp] Pys (pass 1) or [B, Lp+1] Pye (end)
  void* P1;               // [B, Lp] Pyi (pass 1) or null
  long long* arg;         // [B] Ys or Ye
  int* pin;               // [B] Ys as int32 (pass 1) or null
};

static const int kPostThreads = 128;

// does (v, p) come before (bv, bp) under max_index's rule: NaN above every
// number, equal values (and NaN against NaN) to the later index?  A total
// order on distinct positions, so the block's reduction order does not
// matter; (-inf, -1) stands for no position
template <typename T>
__device__ __forceinline__ bool later_max(T v, int p, T bv, int bp) {
  const bool n = isnan(v), bn = isnan(bv);
  if (n || bn) return n && (!bn || p > bp);
  return v > bv || (v == bv && p > bp);
}

// the block's winner of (v, p): warps by shuffles, then warp 0
template <typename T>
__device__ __forceinline__ int block_last_max(T v, int p) {
  __shared__ T sv[kPostThreads / 32];
  __shared__ int sp[kPostThreads / 32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, v, o);
    const int op = __shfl_down_sync(0xffffffffu, p, o);
    if (later_max(ov, op, v, p)) {
      v = ov;
      p = op;
    }
  }
  if (lane == 0) {
    sv[w] = v;
    sp[w] = p;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 1; i < kPostThreads / 32; ++i)
      if (later_max(sv[i], sp[i], v, p)) {
        v = sv[i];
        p = sp[i];
      }
  return p;
}

// a block per read, its threads over the positions (the rows written
// whole), each thread's last maximum over its positions, then the block's
template <typename T>
__global__ void __launch_bounds__(kPostThreads) posteriors_kernel(PostArgs a) {
  const int b = blockIdx.x, Lp = a.Lp, B = a.B;
  const long long L = a.L[b];
  const T* g = static_cast<const T*>(a.g);
  T best = ninf<T>();
  int at = -1;
  if (!a.end) {
    T* Pys = static_cast<T*>(a.P0) + (long long)b * Lp;
    T* Pyi = static_cast<T*>(a.P1) + (long long)b * Lp;
    for (int p = threadIdx.x; p < Lp; p += kPostThreads) {
      const bool in = p < L;
      const T s = in ? g[(long long)p * B + b] : (T)0;
      Pys[p] = s;
      Pyi[p] = in ? g[((long long)Lp + p) * B + b] : (T)0;
      const T v = in ? s : (T)-1;
      if (later_max(v, p, best, at)) {
        best = v;
        at = p;
      }
    }
  } else {
    T* Pye = static_cast<T*>(a.P0) + (long long)b * (Lp + 1);
    const long long last = L - 1 < 0 ? 0 : (L - 1 > Lp - 1 ? Lp - 1 : L - 1);
    const T tail = g[(3LL * Lp + last) * B + b];
    for (int p = threadIdx.x; p <= Lp; p += kPostThreads) {
      const T e = p < L ? g[(2LL * Lp + p) * B + b] : (T)0;
      const T y = e + (p == L ? (T)1 : (T)0) * tail;
      Pye[p] = y;
      const T v = p <= L ? y : (T)-1;
      if (later_max(v, p, best, at)) {
        best = v;
        at = p;
      }
    }
  }
  at = block_last_max(best, at);
  if (threadIdx.x == 0) {
    a.arg[b] = at;
    if (a.pin) a.pin[b] = at;
  }
}

template <typename T>
static int posteriors(PostArgs a, cudaStream_t st) {
  if (a.Lp < 1 || a.B < 1 || !a.g || !a.L || !a.P0 || !a.arg ||
      (!a.end && !a.P1))
    return static_cast<int>(cudaErrorInvalidValue);
  posteriors_kernel<T><<<a.B, kPostThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

#define POST_EXPORTS(SUF, T)                                                \
  RNAELEM_EXPORT int rnaelem_posteriors_##SUF(PostArgs a, cudaStream_t st) { \
    return posteriors<T>(a, st);                                            \
  }

POST_EXPORTS(f32, float)
POST_EXPORTS(f64, double)
