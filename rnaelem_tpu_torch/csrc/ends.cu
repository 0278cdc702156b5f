// K19: a DP pass's two ends and the per-read objective (rows G, H, O of
// the kernel table).
//
// Replaces (rnaelem_tpu, XLA-compiled jnp programs): ops/dp.py
// _extract_parts (:771-777), the parts' gather at each read's last row;
// dp_bwd's seed of the O cotangent (:806); train/objective.py
// _per_read_terms (:189-205), the per-read objective, which JAX fuses into
// the same XLA program; and the lse / [:, 0] the scanner and the min-BPP
// masks take of the parts.
//
// ends_fwd (one launch): parts[b, k] = O[L_b + PAD, end_states[k], b]
// (or the no-rss chain's parts, given), then per mode
//   kEndsObjective  f[b], eff[b] of _per_read_terms: z_all = lse(parts),
//                   z_ari = lse(parts[1:]), z_nasi = parts[0]; the
//                   lik-ratio form lik_sign (z_ari - z_all) or the
//                   restricted form z_all - (restrict_ari ? z_ari :
//                   z_nasi), each difference as softplus(+-(parts[0] -
//                   z_ari)); f = 0 unless finite (isfinite(z_all) and
//                   isfinite(z_ari), or is_neg in the restricted form) and
//                   valid; eff = valid && !is_neg ? eff_in : 0
//   kEndsLse        z = lse(parts), PyN = exp(parts[0] - z) (the scanner)
//   kEndsNull       z = parts[0] (the masks' motif-free pass)
//   kEndsParts      the parts alone.
// ends_adj (one launch): the parts' cotangent gbar [B, 3] in closed form
// from the per-read cotangent gy of the mode's output (the softmax weights
// of the two lse under the mode's masks, as jax.vjp of the forward: a
// reduction with no finite term passes 0), plus a given parts cotangent;
// written to gbar and/or seeded into the O cotangent's rows L_b + PAD,
// k = 0, 1, 2 in turn (the end states may coincide: S = 1).  No sort, no
// index_put_ and no autograd graph of small ops.
//
// lse is ops/semiring.lse's: m = max (0 where not finite), s = sum exp(x -
// m) in index order, log(s) + m where s > 0, else -inf.
//
// Bound on the H100: bytes, and those are a few per read (3 gathered
// values, a handful of [B] vectors): the launch's latency is the cost.
// Design: one thread per read, no shared memory; the gather's loads are a
// row of B values apart, so a warp's 32 reads share sectors.
#include "common.cuh"

enum { kEndsParts = 0, kEndsObjective = 1, kEndsLse = 2, kEndsNull = 3 };

struct EndsArgs {
  int B, S, PAD, mode, lik_ratio;
  const void* O;                // [Lp+1+PAD, S, B] inside O, or null
  const long long* L;           // [B]
  const int* end_states;        // [3]
  const void* parts_in;         // [B, 3] given parts (no gather), or null
  void* parts;                  // [B, 3] out (ends_fwd), saved (ends_adj)
  void* y;                      // [B] f or z
  void* y2;                     // [B] eff or PyN, or null
  const unsigned char* restrict_ari;  // [B] bool (objective)
  const unsigned char* is_neg;        // [B] bool
  const unsigned char* valid;         // [B] bool
  const void* lik_sign;         // [B]
  const void* eff;              // [B]
  const void* gy;               // [B] cotangent of y, or null
  const void* gparts;           // [B, 3] cotangent of the parts, or null
  void* gbar;                   // [B, 3] out, or null
  void* gO;                     // [Lp+1+PAD, S, B] seeded, or null
};

static const int kEndsThreads = 128;

// lse over the terms k of x with bit k of ``use``, and the softmax weights
// of each term (0 for a term not used, or where no term is finite)
template <typename T>
__device__ __forceinline__ T lse3(const T (&x)[3], int use, T (&w)[3]) {
  T m = ninf<T>();
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if ((use >> k) & 1) m = x[k] > m ? x[k] : m;
  const T m0 = isfinite(m) ? m : (T)0;
  T e[3];
  T s = (T)0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e[k] = (use >> k) & 1 ? ex(x[k] - m0) : (T)0;
    s = s + e[k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) w[k] = s > (T)0 ? e[k] / s : (T)0;
  return s > (T)0 ? lg(s) + m0 : ninf<T>();
}

template <typename T>
struct Terms {
  T f, w[3];   // the mode's output and its gradient in the parts
  T y2;
};

// log(1 + e^y) = max(y, 0) + log1p(e^-|y|), without overflow:
// z_all - z_ari = softplus(parts0 - z_ari)
template <typename T>
__device__ __forceinline__ T softplus(T y) {
  return (y > (T)0 ? y : (T)0) + log1p(ex(-fabs(y)));
}

// the mode's outputs at read b and d y / d parts.  The objective's terms
// are differences of two lse that nearly cancel where the motif dominates
// (or is absent): f and its gradient are formed from softplus and
// products of the softmax weights instead, each a few roundings from
// exact (w_ari,k - w_all,k = w_ari,k w_all,0 for k = 1, 2).
template <typename T>
__device__ __forceinline__ Terms<T> terms(const EndsArgs& a, int b,
                                          const T (&p)[3]) {
  Terms<T> t;
  t.y2 = (T)0;
  T wa[3], wr[3];
  if (a.mode == kEndsObjective) {
    const T z_all = lse3(p, 7, wa);
    const T z_ari = lse3(p, 6, wr);
    const bool fin_all = isfinite(z_all), fin_ari = isfinite(z_ari);
    const bool valid = a.valid[b], neg = a.is_neg[b];
    const T x = fin_all ? p[0] - z_ari : (T)0;
    T f;
    if (a.lik_ratio || a.restrict_ari[b]) {  // z_all - z_ari, its gradient
      const T sg = a.lik_ratio ? -static_cast<const T*>(a.lik_sign)[b]
                               : (T)1;
      f = sg * softplus(x);
      t.w[0] = sg * wa[0];
      t.w[1] = -(sg * (wa[0] * wr[1]));
      t.w[2] = -(sg * (wa[0] * wr[2]));
    } else {  // z_all - z_nasi
      f = softplus(-x);
      t.w[0] = -(wa[1] + wa[2]);
      t.w[1] = wa[1];
      t.w[2] = wa[2];
    }
    const bool ok = valid && fin_all &&
                    (a.lik_ratio ? fin_ari : neg || fin_ari);
    t.f = ok ? f : (T)0;
    if (!ok)
#pragma unroll
      for (int k = 0; k < 3; ++k) t.w[k] = (T)0;
    t.y2 = valid && !neg ? static_cast<const T*>(a.eff)[b] : (T)0;
  } else if (a.mode == kEndsLse) {
    t.f = lse3(p, 7, t.w);
    t.y2 = ex(p[0] - t.f);
  } else {
    t.f = p[0];
    t.w[0] = (T)1;
    t.w[1] = t.w[2] = (T)0;
  }
  return t;
}

__device__ __forceinline__ long long o_cell(const EndsArgs& a, int b, int k) {
  return ((a.L[b] + a.PAD) * a.S + a.end_states[k]) * (long long)a.B + b;
}

template <typename T>
__global__ void __launch_bounds__(kEndsThreads)
ends_fwd_kernel(EndsArgs a) {
  const int b = blockIdx.x * kEndsThreads + threadIdx.x;
  if (b >= a.B) return;
  T p[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    p[k] = a.parts_in ? static_cast<const T*>(a.parts_in)[b * 3 + k]
                      : static_cast<const T*>(a.O)[o_cell(a, b, k)];
  if (a.parts)
#pragma unroll
    for (int k = 0; k < 3; ++k) static_cast<T*>(a.parts)[b * 3 + k] = p[k];
  if (a.mode == kEndsParts) return;
  const Terms<T> t = terms(a, b, p);
  static_cast<T*>(a.y)[b] = t.f;
  if (a.y2) static_cast<T*>(a.y2)[b] = t.y2;
}

template <typename T>
__global__ void __launch_bounds__(kEndsThreads)
ends_adj_kernel(EndsArgs a) {
  const int b = blockIdx.x * kEndsThreads + threadIdx.x;
  if (b >= a.B) return;
  T g[3] = {(T)0, (T)0, (T)0};
  if (a.gy && a.mode != kEndsParts) {
    T p[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      p[k] = static_cast<const T*>(a.parts)[b * 3 + k];
    const Terms<T> t = terms(a, b, p);
    const T gy = static_cast<const T*>(a.gy)[b];
#pragma unroll
    for (int k = 0; k < 3; ++k) g[k] = gy * t.w[k];
  }
  if (a.gparts)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      g[k] = g[k] + static_cast<const T*>(a.gparts)[b * 3 + k];
  if (a.gbar)
#pragma unroll
    for (int k = 0; k < 3; ++k) static_cast<T*>(a.gbar)[b * 3 + k] = g[k];
  if (a.gO) {
    T* gO = static_cast<T*>(a.gO);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const long long at = o_cell(a, b, k);
      gO[at] = gO[at] + g[k];
    }
  }
}

template <typename T>
static int ends(EndsArgs a, bool adj, cudaStream_t st) {
  if (a.B < 1 || a.mode < kEndsParts || a.mode > kEndsNull ||
      (!adj && !a.O && !a.parts_in) || (adj && !a.gbar && !a.gO) ||
      (adj && a.gO && !a.L) || (!adj && a.mode != kEndsParts && !a.y))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.B + kEndsThreads - 1) / kEndsThreads);
  if (adj)
    ends_adj_kernel<T><<<grid, kEndsThreads, 0, st>>>(a);
  else
    ends_fwd_kernel<T><<<grid, kEndsThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

#define ENDS_EXPORTS(SUF, T)                                               \
  RNAELEM_EXPORT int rnaelem_ends_fwd_##SUF(EndsArgs a, cudaStream_t st) { \
    return ends<T>(a, false, st);                                          \
  }                                                                        \
  RNAELEM_EXPORT int rnaelem_ends_adj_##SUF(EndsArgs a, cudaStream_t st) { \
    return ends<T>(a, true, st);                                           \
  }

ENDS_EXPORTS(f32, float)
ENDS_EXPORTS(f64, double)
