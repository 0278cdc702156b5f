// Shared pieces of the outside (adjoint) kernels K5-K7.
//
// The outside pass walks the columns j = Lp..1; for each column it runs
// the adjoint of K4 (K7), of K2's E stage (K5), of K3 (K6) and of K2's M,
// B/T1 and L/P/T2 stages (K5), in that order, on one stream.  Each
// forward output y is a log-sum-exp over terms x_k, so its cotangent g_y
// reaches term k as g_y * exp(x_k - y): the saved inside tables give y,
// the cotangents are linear-space numbers of the order of posteriors and
// need no shift.  A cell whose inside value is -inf (or whose cotangent
// is 0) sends nothing: every term is guarded, never exp(-inf - -inf).
//
// Determinism: no float atomics.  Every kernel is written in gather form,
// one thread owning each cotangent cell it adds to (a plain
// read-add-write), and the kernels of a column and the columns run in
// stream order, so two runs give the same bits.  Sums across threads are
// per-cell partials that a later kernel of the same column reduces.
#pragma once

#include "common.cuh"

#define TIDX(r, w, s, b) ((((long long)(r) * W1 + (w)) * S + (s)) * B + (b))

struct AdjIdx {  // grammar index lists (int32 unless noted)
  const int* rt_off;   // [S+1] right transitions by target
  const int* rt_s;
  const void* rt_w;    // log weights (scalar type)
  const int* rtr_off;  // [S+1] right transitions by source
  const int* rtr_t;
  const void* rtr_w;
  const int* ltr_off;  // [S+1] left transitions by source
  const int* ltr_t;
  const void* ltr_w;
  const void* pt_lt;   // [S, S] log tau of pair transitions (scalar type)
  const int* loopm;    // [S]
  const int* bucket;   // [S]
  const int* pt_code;  // [S, S] -1 none, -2 background, else pair table
  const int* pt_wl;    // [S, S]
  const int* pt_wr;    // [S, S]
  const int* ptl_t;    // [n_pt] pair transitions (t, s) with a code
  const int* ptl_s;
  const int* b12a_off; // [S+1] split tuples (t, a, c) by a: t, c
  const int* b12a_t;
  const int* b12a_c;
  const int* b12c_off; // [S+1] split tuples by c: t, a
  const int* b12c_t;
  const int* b12c_a;
};

// d(lam * x)/d lam for lam_mul: -inf energies carry no lambda term
template <typename T>
__device__ __forceinline__ T xfac(T x) {
  return x == ninf<T>() ? (T)0 : x;
}

// g * exp(x - y): the share of a log-sum-exp output y (cotangent g) that
// reaches its term x; zero for an empty output, a -inf term or g == 0
template <typename T>
__device__ __forceinline__ T share(T g, T x, T y) {
  return (g != (T)0 && y > ninf<T>() && x > ninf<T>()) ? g * ex(x - y)
                                                       : (T)0;
}

// share without a branch around the exp (the same value), for the M
// chain's serial steps
template <typename T>
__device__ __forceinline__ T share_sel(T g, T x, T y) {
  const T e = ex(x - y);
  return (g != (T)0 && y > ninf<T>() && x > ninf<T>()) ? g * e : (T)0;
}

static inline int n_blocks(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

static const int kAdjThreads = 256;
