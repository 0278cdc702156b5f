// Shared device helpers for the port's hand-written kernels.
//
// Every kernel is a template on the scalar type (float for production,
// double to hold the algorithm to the plain PyTorch version) and is
// exported through a plain C function per type, loaded with ctypes.  A C
// function launches exactly one kernel on the caller's stream and returns
// cudaGetLastError(), so a refused launch is reported at once.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define RNAELEM_EXPORT extern "C" __attribute__((visibility("default")))

// Column geometry shared by the DP kernels (K2-K4).  Tables are
// [Lp+1+PAD, Wp+1, S, B] with row j at j+PAD; everything is batch-minor.
struct DPDims {
  int Lp, Wp, Cp, S, B, PAD, j;
  int n13, n_ar, n2, n_cls, Tp;
  int fix_rss, no_ene;
  int n_pt;  // pair transitions (t, s) of the grammar (outside kernels)
};

// The scanner's aux transition factors (scan/scanner.py, scan/cyk.py,
// ops/dp.py), as the kernels take them: never dense [Lp, S, S, B] factors,
// but a per-read pin set and the class sums of the transition posteriors.
// Emission kinds: R (right-chain transitions, base j-1), L (M chain, base
// j-w), PL and PR (pair edges, bases j-w and j-1).  code[(kind * S + t) *
// S + s] holds the class bits of transition t <- s: 1 start, 2 in, 4 end,
// 8 tail.  A pin set holds up to kMaxPins entries (the end pass: one, the
// start at Ys; CYK: the start at Ys, the end at Ye and the tail at L-1
// when Ye == L); entry k pins base pin[k][b] of read b (-1: none) for the
// kinds in its mask pin_kinds[k] (bit kind), where only the transitions
// whose class has pin_bit[k] survive.  The vetoes add up: at a base that
// several entries pin, a transition must carry every pinned bit.  Entries
// are filled from 0; pin[0] == null means no pin.  The adjoint kernels
// add each transition's posterior into the class partials of its base:
// cpR [4, Wp+1, S, B] for base j-1 (slot w of the source state's thread,
// slot 0 the O chain's), cpL [4, Wp+1, S, B] for base j-w; the column's
// last K5 function sums them.  For the no-rss chain cpR is the class sums
// [4, Lp, B] themselves.
enum { kAuxR = 0, kAuxL = 1, kAuxPL = 2, kAuxPR = 3 };
#define kMaxPins 3

struct Aux {
  const int* code;              // [4, S, S]
  const int* pin[kMaxPins];     // [B] pinned base of each read (-1: none)
  int pin_bit[kMaxPins];        // the class bit that survives there
  int pin_kinds[kMaxPins];      // bit k: the entry vetoes kind k
  void* cpR;                    // class partials (scalar type), or null
  void* cpL;
};

__host__ __device__ __forceinline__ bool has_pin(const Aux& a) {
  return a.pin[0] != nullptr;
}

// the class bits a transition of the kind emitting base p of read b must
// carry (0: the base is not pinned for the kind); the walk stops at the
// first empty entry, so an unpinned launch pays one test
__device__ __forceinline__ int pin_req(const Aux& a, int b, int p,
                                       int kind) {
  int req = 0;
#pragma unroll
  for (int k = 0; k < kMaxPins; ++k) {
    if (a.pin[k] == nullptr) break;
    if (((a.pin_kinds[k] >> kind) & 1) && a.pin[k][b] == p)
      req |= a.pin_bit[k];
  }
  return req;
}

// does a pin requiring the class bits ``req`` veto transition t <- s of
// the kind?
__device__ __forceinline__ bool vetoed(const Aux& a, int req, int kind,
                                       int t, int s, int S) {
  return req != 0 && (a.code[(kind * S + t) * S + s] & req) != req;
}

template <typename T>
__device__ __forceinline__ T ninf() { return -(T)INFINITY; }

// ---- cp.async (Ampere and later): 4- or 8-byte copies into shared memory
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  static_assert(N == 4 || N == 8, "cp.async.ca takes 4, 8 or 16 bytes");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(N));
}
template <typename T>
__device__ __forceinline__ void cp_async_t(T* smem, const T* gmem) {
  cp_async<sizeof(T)>(smem, gmem);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// add posterior mass x of transition t <- s of the kind to its classes
template <typename T>
__device__ __forceinline__ void add_classes(const Aux& a, int kind, int t,
                                            int s, int S, T x, T acc[4]) {
  const int c = a.code[(kind * S + t) * S + s];
  for (int k = 0; k < 4; ++k)
    if (c & (1 << k)) acc[k] += x;
}

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }

// lambda * x with -inf energies kept at -inf (also for lambda == 0)
template <typename T>
__device__ __forceinline__ T lam_mul(T lam, T x) {
  return x == ninf<T>() ? ninf<T>() : lam * x;
}

template <typename T>
__device__ __forceinline__ T logadd(T a, T b) {
  T m = a > b ? a : b;
  if (m == ninf<T>()) return ninf<T>();
  return m + lg(ex(a - m) + ex(b - m));
}

// Online log-sum-exp: one exp per finite term; an empty or all--inf
// sum gives -inf (never NaN, never log(tiny)).
template <typename T>
struct LSE {
  T m, s;
  __device__ __forceinline__ LSE() : m(ninf<T>()), s((T)0) {}
  // a partial sum kept as (max, scaled sum), as scale() gives it back
  __device__ __forceinline__ LSE(T m_, T s_) : m(m_), s(s_) {}
  __device__ __forceinline__ T scale() const { return s; }
  // add a partial sum; merge(a, b) and merge(b, a) give the same bits
  __device__ __forceinline__ void merge(const LSE& o) {
    if (!(o.s > (T)0)) return;
    if (!(s > (T)0)) {
      m = o.m;
      s = o.s;
      return;
    }
    const T mn = m > o.m ? m : o.m;
    s = s * ex(m - mn) + o.s * ex(o.m - mn);
    m = mn;
  }
  __device__ __forceinline__ void add(T x) {
    if (!(x > ninf<T>())) return;
    if (x > m) {
      s = s * ex(m - x) + (T)1;
      m = x;
    } else {
      s += ex(x - m);
    }
  }
  // N terms at once (in index order): one rescale to the chunk's
  // maximum, then the terms' exps, independent of each other and without
  // branches (exp(-inf) adds 0, a rescale by exp(0) multiplies by 1)
  template <int N>
  __device__ __forceinline__ void add_n(const T (&x)[N]) {
    T mc = ninf<T>();
#pragma unroll
    for (int i = 0; i < N; ++i) mc = x[i] > mc ? x[i] : mc;
    if (!(mc > ninf<T>())) return;
    const T mn = mc > m ? mc : m;
    s = s * ex(m - mn);
    m = mn;
#pragma unroll
    for (int i = 0; i < N; ++i) s += ex(x[i] - m);
  }
  __device__ __forceinline__ T result() const {
    return s > (T)0 ? m + lg(s) : ninf<T>();
  }
};

// Running max, the max semiring's accumulator (the interface of LSE).
template <typename T>
struct MaxAcc {
  T m;
  __device__ __forceinline__ MaxAcc() : m(ninf<T>()) {}
  __device__ __forceinline__ MaxAcc(T m_, T) : m(m_) {}
  __device__ __forceinline__ T scale() const { return (T)0; }
  __device__ __forceinline__ void merge(const MaxAcc& o) {
    if (o.m > m) m = o.m;
  }
  __device__ __forceinline__ void add(T x) {
    if (x > m) m = x;
  }
  template <int N>
  __device__ __forceinline__ void add_n(const T (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) m = x[i] > m ? x[i] : m;
  }
  __device__ __forceinline__ T result() const { return m; }
};

// Semiring policies of the forward column kernels: SumSR for the inside
// DP (K2-K4, log-sum-exp), MaxSR for the CYK tables (K10-K12, max).
// Acc accumulates a sum of log terms, plus() adds two.
template <typename T>
struct SumSR {
  using Acc = LSE<T>;
  __device__ __forceinline__ static T plus(T a, T b) { return logadd(a, b); }
};

template <typename T>
struct MaxSR {
  using Acc = MaxAcc<T>;
  __device__ __forceinline__ static T plus(T a, T b) { return a > b ? a : b; }
};

// log(s) + shift for an exp-space sum; zero sums give -inf
template <typename T>
__device__ __forceinline__ T safe_log_shift(T s, T shift) {
  return s > (T)0 ? lg(s) + shift : ninf<T>();
}

// Atomic max on floats by their ordered bit patterns (the target starts
// at -inf; -inf inputs are skipped by the callers).
__device__ __forceinline__ void atomic_max_t(float* addr, float v) {
  if (v >= 0.0f)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}
__device__ __forceinline__ void atomic_max_t(double* addr, double v) {
  if (v >= 0.0)
    atomicMax(reinterpret_cast<long long*>(addr), __double_as_longlong(v));
  else
    atomicMin(reinterpret_cast<unsigned long long*>(addr),
              static_cast<unsigned long long>(__double_as_longlong(v)));
}

template <typename T>
__device__ __forceinline__ T finite_or_zero(T m) {
  return isfinite(m) ? m : (T)0;
}

static inline int ceil_div(long long a, int b) {
  return static_cast<int>((a + b - 1) / b);
}

static const int kSmemLimit = 232448;  // dynamic shared memory per block

// the current device's number of SMs (read once per device)
static int device_sms() {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev] > 0 ? sms[dev] : 1;
}

// reads per block of a kernel whose block holds G reads of one state (the
// read fastest, so that a row's reads are one sector at G = max_bytes /
// itemsize): the largest of max_bytes' worth, halved down to 1, that
// gives the grid (the reads' groups x S blocks) one block per SM
template <typename T>
static int read_group(int B, int S, int max_bytes) {
  const int sms = device_sms();
  int G = max_bytes / (int)sizeof(T);
  while (G > 1 && (long long)((B + G - 1) / G) * S < sms) G /= 2;
  return G;
}

// raise the dynamic shared memory limit of kernel ``fn`` on the current
// device once (a table keyed by kernel and device)
static int allow_smem(const void* fn, long long bytes) {
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes <= 48 * 1024) return 0;
  struct Entry {
    const void* fn;
    int dev;
    long long bytes;
  };
  static Entry seen[64];
  static int n_seen = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].fn == fn && seen[i].dev == dev && seen[i].bytes >= bytes)
      return 0;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].fn == fn && seen[i].dev == dev) {
      seen[i].bytes = bytes;
      return 0;
    }
  if (n_seen < 64) seen[n_seen++] = {fn, dev, bytes};
  return 0;
}

// ---- ops/dp.read_sum's order, spread over blocks
//
// read_sum adds x[i], i < n, padded with zeros to P = 2^k >= n, by halving
// (x[i] + x[i + P/2], ...) until one value is left: the order of the
// plain versions' per-read sums (K15, K17).  After the levels whose half
// is at least M (any power of two <= P), the partial sum at r < M is the
// halving tree over the residue class {r, r + M, r + 2M, ...}; the last
// log2(M) levels halve those M partials.  So the kernels cut a read's sum
// twice, and keep its bits whatever the cut:
//  - K blocks (a split the host plan picks) take the residue classes of
//    K; block k sums y[m] = x[k + m K], m < P/K, and writes its partial
//    to a workspace, and the last block of the read's group to finish
//    halves the K partials in a fixed order (tree_walk over them, or cut
//    over its columns as a block's class is);
//  - inside a block, Cc = min(P/K, C) columns take the residue classes of
//    Cc of y: column c walks y[c + q Cc] (tree_walk), then block_tree
//    halves the Cc columns, the levels across warps with one barrier, the
//    levels inside a warp by shuffles.
// A thread is (read lane r, column c): lane = r + RL c, RL reads a warp's
// row (32 or 128 bytes), the read fastest so that every batch-minor load
// is whole sectors.
static const int kTreeDepth = 32;  // a walk's stack (2^32 chunks)
static const int kTreeChunk = 8;

static __host__ __device__ __forceinline__ int log2_pow2(long long x) {
  int l = 0;
  while ((1LL << l) < x) ++l;
  return l;
}

// the halving tree over y_v[q], q < Q (Q a power of two), of NV sequences
// at once; f(q, y) fills y[NV] with the values at q.  The walk takes q in
// bit-reversed order (which makes the halving tree the left-to-right
// pairwise tree), kTreeChunk values at a time, their loads in flight
// together: a chunk is a complete subtree, added in registers, and the
// chunks' sums go on a stack.
template <typename T, int NV, class F>
__device__ __forceinline__ void tree_walk(int Q, F f, T (&out)[NV]) {
  const int lq = log2_pow2(Q);
  const int N = Q < kTreeChunk ? Q : kTreeChunk;
  T stk[kTreeDepth][NV];
  int depth = 0;
  for (int q0 = 0, m = 0; q0 < Q; q0 += N, ++m) {
    T xs[kTreeChunk][NV];
#pragma unroll
    for (int u = 0; u < kTreeChunk; ++u) {
      if (u < N) {
        const int q = lq ? (int)(__brev((unsigned)(q0 + u)) >> (32 - lq)) : 0;
        f(q, xs[u]);
      } else {
#pragma unroll
        for (int v = 0; v < NV; ++v) xs[u][v] = (T)0;
      }
    }
#pragma unroll
    for (int w = 1; w < kTreeChunk; w <<= 1)
      if (w < N) {
#pragma unroll
        for (int u = 0; u < kTreeChunk; u += 2 * w)
#pragma unroll
          for (int v = 0; v < NV; ++v) xs[u][v] = xs[u][v] + xs[u + w][v];
      }
    for (int mm = m; mm & 1; mm >>= 1) {
      --depth;
#pragma unroll
      for (int v = 0; v < NV; ++v) xs[0][v] = stk[depth][v] + xs[0][v];
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) stk[depth][v] = xs[0][v];
    ++depth;
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) out[v] = stk[0][v];
}

// the halving tree over a block's columns, value v over its first cc[v]
// columns (a power of two; the rest hold nothing of it): the levels that
// pair columns of two warps in one step after one barrier (warp 0 halves
// the warps' values of its columns), then the levels inside a warp by
// shuffles at lane offsets RL h.  Lanes of column 0 of warp 0 end with
// the sums; every thread of the block calls it (a barrier where some cc
// exceeds a warp's columns), red holds NV x NT values.
template <typename T, int NV, int RL, int NT>
__device__ __forceinline__ void block_tree(const int (&cc)[NV], T (&x)[NV],
                                           T* red) {
  constexpr int CW = 32 / RL, C = NT / RL, NW = C / CW;
  const int r = threadIdx.x % RL, c = threadIdx.x / RL;
  bool cross = false;
#pragma unroll
  for (int v = 0; v < NV; ++v) cross = cross || cc[v] > CW;
  if (cross) {
#pragma unroll
    for (int v = 0; v < NV; ++v) red[(v * C + c) * RL + r] = x[v];
    __syncthreads();
    if (c < CW) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int nw = cc[v] / CW;
        if (nw < 2) continue;
        T w8[NW];
#pragma unroll
        for (int i = 0; i < NW; ++i)
          w8[i] = i < nw ? red[(v * C + c + CW * i) * RL + r] : (T)0;
#pragma unroll
        for (int h = NW / 2; h >= 1; h >>= 1)
          if (h < nw) {
#pragma unroll
            for (int i = 0; i < h; ++i) w8[i] = w8[i] + w8[i + h];
          }
        x[v] = w8[0];
      }
    }
  }
#pragma unroll
  for (int h = CW / 2; h >= 1; h >>= 1)
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (h < cc[v]) x[v] = x[v] + __shfl_xor_sync(0xffffffffu, x[v], RL * h);
}

// the last block of a group of blocks to arrive (after its partials are
// written): true in every thread of that block, which then reads the
// others' partials through L2 (__ldcg) and resets the counter
__device__ __forceinline__ bool last_of_group(int* done, int n) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1) == n - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

RNAELEM_EXPORT const char* rnaelem_error_string(int code);
